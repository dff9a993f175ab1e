"""The port's data pipeline against ``repro.data``: the same batches, bit
for bit, at the same seed, step and shard, from both sources."""
import pytest

pytest.importorskip("torch")

import numpy as np

from repro.data import DataConfig as JDataConfig
from repro.data import Pipeline as JPipeline
from repro.data import make_source as jmake_source
from repro_torch.data import DataConfig, Pipeline, SyntheticSource, make_source


def _kw(**kw):
    base = dict(vocab_size=1000, seq_len=16, global_batch=8, seed=7)
    base.update(kw)
    return base


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("shards,index", [(1, 0), (2, 0), (2, 1), (4, 3)])
@pytest.mark.parametrize("step", [0, 5, 1000])
def test_synthetic_batches_equal_reference(seed, shards, index, step):
    kw = _kw(seed=seed, num_shards=shards, shard_index=index)
    got = make_source(DataConfig(**kw)).batch_at(step)
    want = jmake_source(JDataConfig(**kw)).batch_at(step)
    assert set(got) == set(want) == {"tokens", "mask"}
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("step", [0, 2, 31])
def test_memmap_batches_equal_reference(tmp_path, step):
    path = str(tmp_path / "corpus.bin")
    np.arange(5000, dtype=np.int32).tofile(path)
    kw = _kw(source="memmap", corpus_path=path)
    got = make_source(DataConfig(**kw)).batch_at(step)
    want = jmake_source(JDataConfig(**kw)).batch_at(step)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_pipeline_stream_equals_reference_from_start_step():
    p, jp = Pipeline(DataConfig(**_kw()), start_step=3), JPipeline(JDataConfig(**_kw()), start_step=3)
    try:
        for want_step in (3, 4, 5):
            (step, batch), (jstep, jbatch) = next(p), next(jp)
            assert step == jstep == want_step
            np.testing.assert_array_equal(batch["tokens"], jbatch["tokens"])
    finally:
        p.close()
        jp.close()


def test_tokens_in_range_and_shards_partition():
    batch = SyntheticSource(DataConfig(**_kw())).batch_at(0)
    assert batch["tokens"].min() >= 1 and batch["tokens"].max() < 1000
    assert batch["tokens"].shape == (8, 16)
    with pytest.raises(ValueError):
        Pipeline(DataConfig(**_kw(global_batch=6, num_shards=4)))
