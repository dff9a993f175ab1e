"""The port's workload keys and default schedules equal the reference's.

The reference's kernel instances are recorded at trace time (``eval_shape``
under the Pallas backend, so nothing runs) for the reduced and full prefill
and decode of minitron-4b, rwkv6-1.6b and recurrentgemma-2b (the recurrent
archs at a prime, unbucketed prompt length, as their engine runs them).  For each, the port's ``workload_key()``,
``default_schedule()`` and ``concretize()`` must equal the reference's; at
the reduced size the port's ops, run on the CPU, must emit the same
instances.
"""
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.core.schedule import concretize as jconcretize
from repro.core.schedule import default_schedule as jdefault_schedule
from repro.kernels.ops import use_backend as juse_backend
from repro.models import build_model as jbuild_model
from repro_torch.configs import get_arch, reduced
from repro_torch.convert import params_from_jax
from repro_torch.core.schedule import concretize, default_schedule
from repro_torch.core.workload import KernelInstance
from repro_torch.kernels import ops
from repro_torch.models import build_model

SLOTS = 4


class _Recorder:
    """A reference schedule provider that records every instance it resolves."""

    def __init__(self):
        self.seen = set()

    def get(self, inst):
        self.seen.add(inst)
        return jconcretize(jdefault_schedule(inst), inst)


def _reference_instances(cfg, phase: str, seq: int, max_len: int):
    model = jbuild_model(cfg)
    params = model.abstract_params()
    rec = _Recorder()
    with juse_backend("pallas"):
        if phase == "prefill":
            toks = jax.ShapeDtypeStruct((1, seq), jnp.int32)
            jax.eval_shape(lambda p, t: model.prefill(p, {"tokens": t}, max_len=max_len,
                                                      provider=rec), params, toks)
        else:
            cache = model.abstract_cache(SLOTS, max_len)
            toks = jax.ShapeDtypeStruct((SLOTS,), jnp.int32)
            jax.eval_shape(lambda p, c, t: model.decode_step(p, c, t, provider=rec),
                           params, cache, toks)
    return sorted(rec.seen)


def _cs_fields(cs):
    return cs.schedule.to_json(), cs.tiles, cs.grid, cs.adapted, cs.instance.to_json()


CELLS = [("reduced", "prefill", 16, 32), ("reduced", "decode", 1, 32),
         ("full", "prefill", 128, 512), ("full", "prefill", 512, 512),
         ("full", "decode", 1, 512)]


@pytest.mark.parametrize("size,phase,seq,max_len", CELLS)
def test_keys_and_default_schedules_match_reference(size, phase, seq, max_len):
    jcfg = jget_arch("minitron-4b")
    if size == "reduced":
        jcfg = jreduced(jcfg)
    insts = _reference_instances(jcfg, phase, seq, max_len)
    classes = {i.class_id for i in insts}
    assert {"matmul", "matmul_bias_gelu", "matmul_lmhead"} <= classes
    assert ("flash_attention_causal" in classes) == (phase == "prefill")
    _assert_port_matches(insts)


def _assert_port_matches(insts):
    for jinst in insts:
        inst = KernelInstance.make(jinst.class_id, dtype=jinst.dtype, **dict(jinst.params))
        assert inst.to_json() == jinst.to_json()
        assert inst.workload_key() == jinst.workload_key()
        assert inst == ops.instance(jinst.class_id, getattr(torch, jinst.dtype),
                                    **dict(jinst.params))
        assert default_schedule(inst).to_json() == jdefault_schedule(jinst).to_json()
        assert _cs_fields(concretize(default_schedule(inst), inst)) == \
            _cs_fields(jconcretize(jdefault_schedule(jinst), jinst))


@pytest.fixture(scope="module")
def reduced_pair():
    jcfg = jreduced(jget_arch("minitron-4b"))
    cfg = reduced(get_arch("minitron-4b"))
    jparams = jbuild_model(jcfg).init(jax.random.PRNGKey(0))
    model = build_model(cfg, "cpu")
    return jcfg, cfg, model, params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg)


def _port_instances(monkeypatch, run):
    seen = set()
    resolve = ops.schedule_for

    def recording(inst):
        seen.add(inst)
        return resolve(inst)

    monkeypatch.setattr(ops, "schedule_for", recording)
    run()
    return {(i.class_id, i.params, i.dtype) for i in seen}


def _as_set(insts):
    return {(i.class_id, i.params, i.dtype) for i in insts}


def test_port_prefill_emits_reference_instances(monkeypatch, reduced_pair):
    jcfg, cfg, model, params = reduced_pair
    toks = torch.ones((1, 16), dtype=torch.long)
    got = _port_instances(monkeypatch, lambda: model.prefill(params, {"tokens": toks}, max_len=32))
    assert got == _as_set(_reference_instances(jcfg, "prefill", 16, 32))


def test_port_decode_emits_reference_instances(monkeypatch, reduced_pair):
    jcfg, cfg, model, params = reduced_pair
    cache = model.init_cache(SLOTS, 32)
    toks = torch.ones((SLOTS,), dtype=torch.long)
    got = _port_instances(monkeypatch, lambda: model.decode_step(params, cache, toks))
    assert got == _as_set(_reference_instances(jcfg, "decode", 1, 32))


def test_ragged_tiles_and_glu_rules_match_reference():
    """Maskable axes clamp, strict axes raise, odd GLU tiles raise — as in
    the reference (adaptive mode snaps)."""
    from repro.core.schedule import Schedule as JSchedule
    from repro.core.schedule import ScheduleInvalid as JInvalid
    from repro.core.workload import KernelInstance as JKI
    from repro_torch.core.schedule import Schedule, ScheduleInvalid

    cases = [("matmul", {"M": 256, "N": 48, "K": 32}, dict(M=100, N=200, K=96)),
             ("matmul", {"M": 16, "N": 16, "K": 40}, dict(M=32, N=32, K=96)),
             ("matmul_silu_glu", {"M": 16, "N": 15, "K": 16}, dict(M=32, N=60, K=32)),
             ("flash_attention_causal", {"Q": 48, "KV": 100}, dict(Q=40, KV=90, H=2, D=16, B=1))]
    for cls, tiles, params in cases:
        for mode in ("strict", "adaptive"):
            inst, jinst = KernelInstance.make(cls, **params), JKI.make(cls, **params)
            s, js = Schedule.make(cls, tiles), JSchedule.make(cls, tiles)
            try:
                want = _cs_fields(jconcretize(js, jinst, mode=mode))
            except JInvalid:
                with pytest.raises(ScheduleInvalid):
                    concretize(s, inst, mode=mode)
                continue
            assert _cs_fields(concretize(s, inst, mode=mode)) == want


RECURRENT_CELLS = [(arch, size, phase, seq, max_len)
                   for arch in ("rwkv6-1.6b", "recurrentgemma-2b")
                   for size, phase, seq, max_len in (("reduced", "prefill", 13, 32),
                                                     ("reduced", "decode", 1, 32),
                                                     ("full", "prefill", 397, 512),
                                                     ("full", "decode", 1, 512))]


@pytest.mark.parametrize("arch,size,phase,seq,max_len", RECURRENT_CELLS)
def test_recurrent_keys_and_default_schedules_match_reference(arch, size, phase, seq, max_len):
    jcfg = jget_arch(arch)
    if size == "reduced":
        jcfg = jreduced(jcfg)
    insts = _reference_instances(jcfg, phase, seq, max_len)
    classes = {i.class_id for i in insts}
    scan = "rwkv6_scan" if jcfg.family == "ssm" else "rglru_scan"
    assert scan in classes and "matmul_lmhead" in classes
    assert ("flash_attention_local" in classes) == (jcfg.family == "hybrid" and phase == "prefill")
    _assert_port_matches(insts)


@pytest.fixture(scope="module", params=["rwkv6-1.6b", "recurrentgemma-2b"])
def recurrent_reduced_pair(request):
    jcfg = jreduced(jget_arch(request.param))
    cfg = reduced(get_arch(request.param))
    jparams = jbuild_model(jcfg).init(jax.random.PRNGKey(0))
    model = build_model(cfg, "cpu")
    return jcfg, cfg, model, params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg)


def test_recurrent_port_emits_reference_instances(monkeypatch, recurrent_reduced_pair):
    jcfg, cfg, model, params = recurrent_reduced_pair
    toks = torch.ones((1, 13), dtype=torch.long)
    got = _port_instances(monkeypatch, lambda: model.prefill(params, {"tokens": toks}, max_len=32))
    assert got == _as_set(_reference_instances(jcfg, "prefill", 13, 32))
    cache = model.init_cache(SLOTS, 32)
    toks = torch.ones((SLOTS,), dtype=torch.long)
    got = _port_instances(monkeypatch, lambda: model.decode_step(params, cache, toks))
    assert got == _as_set(_reference_instances(jcfg, "decode", 1, 32))
