"""Sharded serving (``repro_torch.launch.steps.make_sharded_serve_step``) on
the CPU under gloo, against the port's one-process ``Model.prefill`` /
``Model.decode_step`` and the reference's single-device prefill and decode.

One process group per world (1, 2 and 4 ranks, spawned as in
``tests/test_torch_distributed.py``) runs every case of that world: the
meshes 1x2 (world 2), 2x2 and 1x4 (world 4), and (1, 1) (world 1).  Each
case prefills a seeded batch (2 rows of 16 positions, a vision prefix's
among them, the last real token 3 before the end) into a cache of 24 text
positions and decodes 3 teacher-forced steps, under ``fsdp_tp`` and with
the prefill's S split over ``model`` (``seq_parallel``), from the port's
seed-0 init of a reduced arch:

* minitron-4b (dense), gemma2-2b (local and global layers, softcaps, a tied
  head), mixtral-8x22b (expert-parallel MoE), rwkv6-1.6b (K3's state handed
  from rank to rank), recurrentgemma-2b (its one KV head's ``head_dim``
  split over ``model``: decode sums the scores over ``model``),
  whisper-medium (the cross K/V cache; under ``seq_parallel`` its encoder
  frames split over ``model`` too) and internvl2-26b (the vision prefix
  inside S; and with a vocabulary of 511 that no ``model`` axis splits: the
  head whole on every rank).

An S that ``model`` does not split is laid out as GSPMD lays it out, in
blocks of ceil(S/m) (minitron-4b at 18 positions on 1x4; whisper-medium
with 15 frames at 1x2 and 1x4), and one row that no data axis splits puts
each K/V cache's positions (whisper's frames too) over the data axis.

Each case's logits and gathered caches are held within 1e-5 of the largest
|logit| (of the largest |entry| of each cache leaf) to the one-process
steps', and within 2e-4 to the reference's on converted params; every
prefill's and decode step's collectives equal ``plan_serve``'s, op by op,
with bytes and sets of axes.  At (1, 1) logits and caches equal the
unsharded steps' bit for bit.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import get_arch, reduced
from repro_torch.launch.mesh import Mesh
from repro_torch.tree import leaves_with_paths

from test_torch_distributed import run_ranks

#: (arch, config overrides)
FAMILIES = [("minitron-4b", {}), ("gemma2-2b", {}), ("mixtral-8x22b", {}), ("rwkv6-1.6b", {}),
            ("recurrentgemma-2b", {}), ("whisper-medium", {}), ("internvl2-26b", {}),
            ("internvl2-26b", {"vocab_size": 511})]
#: world -> the (data, model) meshes its ranks serve on
MESHES = {1: [(1, 1)], 2: [(1, 2)], 4: [(2, 2), (1, 4)]}
#: one row, which no data axis of 2 splits: every rank holds it and its
#: block of each K/V cache's positions (world -> meshes; the families)
LONG_MESHES = {2: [(2, 1)], 4: [(2, 2)]}
LONG_FAMILIES = [("minitron-4b", {}), ("gemma2-2b", {}), ("recurrentgemma-2b", {}),
                 ("rwkv6-1.6b", {}), ("whisper-medium", {}), ("internvl2-26b", {})]
ROWS, POSITIONS, MAX_LEN, STEPS, PAD = 2, 16, 24, 3, 3
#: an S (or whisper's frames) that model does not split, under seq_parallel:
#: (arch, config overrides, positions, the meshes)
UNEVEN = [("minitron-4b", {}, 18, [(1, 4)]),
          ("whisper-medium", {"encoder_seq": 15}, POSITIONS, [(1, 2), (1, 4)])]
#: sharded against one process: of the largest |logit| (|cache entry|)
ONE_PROCESS_REL = 1e-5
#: sharded against the reference's single-device steps
REF_REL = 2e-4


def _cfg(arch: str, overrides: dict):
    return dataclasses.replace(reduced(get_arch(arch)), **overrides)


def _case_id(arch, over):
    return arch + "".join(f"-{k}{v}" for k, v in over.items())


def _inputs(cfg, rows: int = ROWS, positions: int = POSITIONS) -> tuple[dict, int, np.ndarray]:
    """(the prefill batch, true_len, the decode steps' tokens (STEPS, rows)),
    seeded: the text fills ``positions`` less the vision prefix."""
    rng = np.random.default_rng(7)
    text = positions - cfg.vision_tokens
    batch = {"tokens": rng.integers(1, min(cfg.vocab_size, 500), size=(rows, text)).astype(np.int64)}
    if cfg.family == "audio":
        batch["frames"] = rng.normal(size=(rows, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.vision_tokens:
        batch["patch_embeds"] = rng.normal(size=(rows, cfg.vision_tokens,
                                                 cfg.d_model)).astype(np.float32)
    feed = rng.integers(1, min(cfg.vocab_size, 500), size=(STEPS, rows)).astype(np.int64)
    return batch, text - PAD, feed


def _torch_batch(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _issued(snap: dict) -> dict:
    return {op: ({k: v[k] for k in ("count", "operand_bytes", "result_bytes", "axes")}
                 if isinstance(v, dict) else v) for op, v in snap.items()}


def _serve_run(rank, world):
    """Every case of this world: per mesh, family and mode the gathered
    logits and caches, the collectives beside their plans; on rank 0 the
    one-process steps' too."""
    from repro_torch.distributed.collectives import MeshGroups
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models.build import build_model

    out = {}
    cases = [(shape, arch, over, ROWS, sp, POSITIONS) for shape in MESHES[world]
             for arch, over in FAMILIES for sp in (False, True)]
    cases += [(shape, arch, over, 1, False, POSITIONS) for shape in LONG_MESHES.get(world, [])
              for arch, over in LONG_FAMILIES]
    cases += [(shape, arch, over, ROWS, True, positions) for arch, over, positions, meshes in UNEVEN
              for shape in meshes + [(1, 1)] if shape in MESHES[world]]
    groups = {}
    for shape, arch, over, rows, sp, positions in cases:
        mesh = Mesh(("data", "model"), shape)
        if shape not in groups:
            groups[shape] = MeshGroups(mesh)
        counter = groups[shape].counter
        cfg = _cfg(arch, over)
        model = build_model(cfg, "cpu")
        full = model.init(0)
        batch, true_len, feed = _inputs(cfg, rows, positions)
        key = (shape, _case_id(arch, over), sp, rows, positions)
        step = steps_mod.make_sharded_serve_step(model, mesh, groups[shape], seq_parallel=sp)
        params = step.shard_params(full)
        shape_bs = (rows, batch["tokens"].shape[1])
        counter.reset()
        logits, cache = step.prefill(params, _torch_batch(batch), MAX_LEN, true_len)
        issued = [_issued(counter.snapshot())]
        plans = [step.plan("prefill", shape_bs, MAX_LEN, by_axes=True)]
        got = {"logits": [step.full_logits(logits, rows)],
               "prefill_cache": step.full_cache(cache, rows, MAX_LEN)}
        for t in feed:
            counter.reset()
            logits, cache = step.decode(params, cache, torch.from_numpy(t))
            issued.append(_issued(counter.snapshot()))
            plans.append(step.plan("decode", shape_bs, MAX_LEN, by_axes=True))
            got["logits"].append(step.full_logits(logits, rows))
        got["cache"] = step.full_cache(cache, rows, MAX_LEN)
        got["issued"], got["plans"] = issued, plans
        if rank == 0:
            got["one"] = _one_process(model, full, batch, true_len, feed)
        out[key] = got if rank == 0 else {"issued": issued, "plans": plans}
    return out


def _one_process(model, params, batch, true_len, feed) -> dict:
    with torch.no_grad():
        logits, cache = model.prefill(params, _torch_batch(batch), max_len=MAX_LEN,
                                      true_len=true_len)
        got = {"logits": [logits], "prefill_cache": _clone(cache)}
        for t in feed:
            logits, cache = model.decode_step(params, cache, torch.from_numpy(t))
            got["logits"].append(logits)
        got["cache"] = cache
    return got


def _clone(cache: dict) -> dict:
    from repro_torch.tree import tree_map

    return tree_map(lambda t: t.clone(), cache)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """world -> one process group of that many ranks, run once for every
    case of that world."""
    runs: dict = {}

    def get(world: int) -> dict:
        if world not in runs:
            ranks = run_ranks(_serve_run, world, tmp_path_factory.mktemp(f"world{world}"),
                              timeout=600)
            runs[world] = {"lead": ranks[0], "ranks": ranks}
        return runs[world]

    return get


@functools.lru_cache(maxsize=None)
def _reference(arch: str, overrides: tuple, rows: int = ROWS, positions: int = POSITIONS) -> dict:
    """The reference's single-device prefill and 3 decode steps from the
    port's seed-0 init: logits, and the caches in the port's layout."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_arch as jget_arch
    from repro.configs import reduced as jreduced
    from repro.models import build_model as jbuild_model
    from repro_torch.convert import cache_from_jax
    from repro_torch.models.build import build_model

    from test_torch_tp import _reference_layout

    over = dict(overrides)
    cfg = _cfg(arch, over)
    jcfg = dataclasses.replace(jreduced(jget_arch(arch)), **over)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jparams = jax.tree_util.tree_map(jnp.asarray,
                                     _reference_layout(build_model(cfg, "cpu").init(0), cfg))
    jmodel = jbuild_model(jcfg)
    batch, true_len, feed = _inputs(cfg, rows, positions)
    jbatch = {k: jnp.asarray(v.astype(np.int32) if k == "tokens" else v) for k, v in batch.items()}
    logits, cache = jmodel.prefill(jparams, jbatch, max_len=MAX_LEN, true_len=true_len)
    out = {"logits": [np.asarray(logits)],
           "prefill_cache": cache_from_jax(jax.tree_util.tree_map(np.asarray, cache), cfg)}
    for t in feed:
        logits, cache = jmodel.decode_step(jparams, cache, jnp.asarray(t.astype(np.int32)))
        out["logits"].append(np.asarray(logits))
    out["cache"] = cache_from_jax(jax.tree_util.tree_map(np.asarray, cache), cfg)
    return out


def _assert_near(got: torch.Tensor, want, rel: float, what: str) -> None:
    want = torch.as_tensor(np.array(want)) if not isinstance(want, torch.Tensor) else want
    assert tuple(got.shape) == tuple(want.shape), (what, tuple(got.shape), tuple(want.shape))
    if got.dtype in (torch.int32, torch.int64):
        assert torch.equal(got.long(), want.long()), what
        return
    scale = float(want.float().abs().max())
    err = float((got.float() - want.float()).abs().max())
    assert err <= rel * max(scale, 1e-30), (what, err, scale)


def _assert_caches(got: dict, want: dict, rel: float, what: str) -> None:
    want = dict(leaves_with_paths(want))
    for path, t in leaves_with_paths(got):
        _assert_near(t, want[path], rel, f"{what} {path}")


SHARDED = [(w, shape) for w in (2, 4) for shape in MESHES[w]]


@pytest.mark.parametrize("arch,over", FAMILIES, ids=[_case_id(*f) for f in FAMILIES])
@pytest.mark.parametrize("sp", [False, True], ids=["fsdp_tp", "seq_parallel"])
@pytest.mark.parametrize("world,shape", SHARDED, ids=[f"{d}x{m}" for _, (d, m) in SHARDED])
def test_sharded_serving_matches_one_process_and_reference(worlds, world, shape, sp, arch, over):
    _assert_case(worlds(world), (shape, _case_id(arch, over), sp, ROWS, POSITIONS),
                 _reference(arch, tuple(sorted(over.items()))))


def _assert_case(run: dict, key: tuple, ref: dict) -> None:
    """A case's logits and gathered caches within 1e-5 of one process and
    2e-4 of the reference's steps, every rank's collectives the plan's."""
    got = run["lead"][key]
    one = got["one"]
    for i, logits in enumerate(got["logits"]):
        _assert_near(logits, one["logits"][i], ONE_PROCESS_REL, f"logits {i}")
        _assert_near(logits, ref["logits"][i], REF_REL, f"reference logits {i}")
    for name in ("prefill_cache", "cache"):
        _assert_caches(got[name], one[name], ONE_PROCESS_REL, name)
        _assert_caches(got[name], ref[name], REF_REL, f"reference {name}")
    for r in run["ranks"]:
        for issued, plan in zip(r[key]["issued"], r[key]["plans"]):
            assert issued == plan, (issued, plan)


@pytest.mark.parametrize("arch,over", FAMILIES, ids=[_case_id(*f) for f in FAMILIES])
def test_sharded_serving_at_1x1_is_bit_equal(worlds, arch, over):
    """On a (1, 1) mesh both steps give the unsharded steps' logits and
    caches bit for bit (every gather a copy), and their collectives are the
    plan's."""
    run = worlds(1)
    for sp in (False, True):
        _assert_bit_equal(run["lead"][((1, 1), _case_id(arch, over), sp, ROWS, POSITIONS)])


def _assert_bit_equal(got: dict) -> None:
    one = got["one"]
    for a, b in zip(got["logits"], one["logits"]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for name in ("prefill_cache", "cache"):
        want = dict(leaves_with_paths(one[name]))
        for path, t in leaves_with_paths(got[name]):
            assert t.dtype == want[path].dtype and torch.equal(t, want[path]), (name, path)
    for issued, plan in zip(got["issued"], got["plans"]):
        assert issued == plan


LONG = [(w, shape) for w in (2, 4) for shape in LONG_MESHES[w]]


@pytest.mark.parametrize("arch,over", LONG_FAMILIES, ids=[_case_id(*f) for f in LONG_FAMILIES])
@pytest.mark.parametrize("world,shape", LONG, ids=[f"{d}x{m}" for _, (d, m) in LONG])
def test_unsplit_rows_split_the_caches_positions(worlds, world, shape, arch, over):
    """One row on a data axis of 2 (``long_500k``'s case): every rank holds
    the row and its block of each K/V cache's positions
    (``cache_leaf_sharding``; whisper's cross K/V cache its block of the
    frames); decode merges each attention's softmax over the data axis
    (whisper's cross attention at prefill too).  Logits and caches within
    1e-5 of one process and 2e-4 of the reference's steps, collectives the
    plan's (two all-reduces over data an attention layer a decode step,
    self and cross)."""
    run = worlds(world)
    key = (shape, _case_id(arch, over), False, 1, POSITIONS)
    _assert_case(run, key, _reference(arch, tuple(sorted(over.items())), 1))
    cfg = _cfg(arch, over)
    attention = sum(k != "R" for k in cfg.layer_kinds) * (2 if cfg.family == "audio" else 1)
    for r in run["ranks"]:
        merges = r[key]["issued"][1].get("all_reduce", {}).get("axes", {}).get("data", 0)
        assert merges == 2 * attention


def test_split_head_dim_cache_sums_scores_over_model(worlds):
    """recurrentgemma-2b's one KV head at model 2: each rank holds half of
    its ``head_dim`` in the cache, and a decode step's attention layers
    all-reduce their scores over model (one a layer), where gathering the
    cache would move it whole."""
    from repro_torch.distributed import sharding as shd

    cfg = _cfg("recurrentgemma-2b", {})
    mesh = Mesh(("data", "model"), (1, 2))
    assert shd.cache_leaf_sharding("['layers'][2]['k']", (ROWS, 1, 8, 16), cfg, mesh) == \
        (("data",), None, None, "model")
    got = worlds(2)["lead"][((1, 2), "recurrentgemma-2b", False, ROWS, POSITIONS)]
    attention = sum(k != "R" for k in cfg.layer_kinds)
    decode = got["issued"][1]["all_reduce"]
    assert decode["axes"] == {"model": attention}


UNEVEN_CASES = [(w, shape, arch, over, positions) for arch, over, positions, meshes in UNEVEN
                for w in (2, 4) for shape in meshes if shape in MESHES[w]]


@pytest.mark.parametrize("world,shape,arch,over,positions", UNEVEN_CASES,
                         ids=[f"{_case_id(a, o)}-{d}x{m}" for _, (d, m), a, o, _ in UNEVEN_CASES])
def test_seq_parallel_takes_an_s_that_model_does_not_split(worlds, world, shape, arch, over,
                                                          positions):
    """minitron-4b's 18 positions over model 4 (blocks 5, 5, 5, 3) and
    whisper-medium's 15 frames over model 2 and 4 (8, 7; 4, 4, 4, 3): held
    like the even cases, K/V all-gathered in blocks padded to ceil(S/m),
    and bit-equal to one process at (1, 1)."""
    key = (shape, _case_id(arch, over), True, ROWS, positions)
    _assert_case(worlds(world), key, _reference(arch, tuple(sorted(over.items())), ROWS,
                                                positions))
    _assert_bit_equal(worlds(1)["lead"][((1, 1),) + key[1:]])


def test_seq_parallel_refuses_what_it_cannot_split():
    """A layout of S in blocks of ceil(S/m) that leaves the last rank no
    position (9 over 4: 3, 3, 3, 0), or fewer than griffin's conv window
    reads (13 over 4: 4, 4, 4, 1), is refused on every rank."""
    from repro_torch.distributed.collectives import SequenceParallel

    class _Groups:
        mesh = Mesh(("data", "model"), (1, 4))
        coords = {"data": 0, "model": 1}

    with pytest.raises(ValueError, match="S = 9 .* blocks of 3: the last rank would hold no"):
        SequenceParallel(_Groups(), _cfg("minitron-4b", {}), 9)
    with pytest.raises(ValueError, match="3 positions a rank .* leaves the last rank 1"):
        SequenceParallel(_Groups(), _cfg("recurrentgemma-2b", {}), 13)
    sp = SequenceParallel(_Groups(), _cfg("minitron-4b", {}), 18)
    assert (sp.block, sp.offset, sp.local) == (5, 5, 5)
    assert sp.over(15).local == 4 and sp.over(1500).block == 375


def test_planner_plans_the_serving_steps_on_the_production_mesh():
    """minitron-4b on 16x16: ``prefill_32k`` with ``--seq-parallel`` (S over
    model) gathers every leaf whole, writes no partial sums into the
    residual stream (no reduce-scatter) and all-gathers K and V once each
    per attention layer; ``decode_32k`` (its 8 KV heads do not split over
    16, its ``head_dim`` does) sums each layer's scores over model and
    gathers the outputs' slices, and its memory time reads the cache
    shard; the params' bytes a device holds are unchanged."""
    import math

    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import _cache_like, plan_serve
    from repro_torch.models.build import build_model
    from repro_torch.models.lm import trainable

    cfg, mesh = get_arch("minitron-4b"), make_production_mesh()
    params = trainable(build_model(cfg, "cpu").abstract_params())
    specs = shd.param_shardings(params, cfg, mesh)
    sp = dryrun.run_cell("minitron-4b", "prefill_32k", False, seq_parallel=True)
    assert sp["status"] == "ok" and sp["seq_parallel"] and sp["strategy"] == "fsdp+tp"
    assert sp["param_bytes_per_device"] == shd.sharded_bytes(params, specs, mesh)
    coll = plan_serve(cfg, params, specs, mesh, phase="prefill", batch=(32, 32768),
                      max_len=32768, seq_parallel=True, by_axes=True)
    assert "reduce_scatter" not in coll
    assert coll["all_gather"]["axes"]["model"] == 2 * cfg.n_layers
    kv = 32 // 16 * cfg.n_kv_heads * 32768 // 16 * cfg.head_dim * 2     # a rank's K (or V)
    from repro_torch.tree import flatten_up_to

    shards = sum(math.prod(shd.local_shape(tuple(t.shape), spec, mesh)) * t.element_size()
                 for (_, t), spec in zip(leaves_with_paths(params), flatten_up_to(specs, params))
                 if any(spec))
    assert coll["all_gather"]["operand_bytes"] - 2 * cfg.n_layers * kv == shards   # all whole
    assert sp["collectives"]["all_gather"]["count"] == coll["all_gather"]["count"]
    plain = dryrun.run_cell("minitron-4b", "prefill_32k", False)
    assert plain["collectives"]["reduce_scatter"]["count"] == 2 * cfg.n_layers + 1
    dec = dryrun.run_cell("minitron-4b", "decode_32k", False)
    assert shd.cache_leaf_sharding("['layers'][0]['k']", (128, 8, 32768, 128), cfg, mesh)[3] == \
        "model"
    d_coll = plan_serve(cfg, params, specs, mesh, phase="decode", batch=(128, 32768),
                        max_len=32768, by_axes=True)
    assert d_coll["all_reduce"]["axes"] == {"model": cfg.n_layers}
    rows, size = 128 // 16, 32768
    assert d_coll["all_reduce"]["operand_bytes"] == cfg.n_layers * rows * cfg.n_heads * size * 4
    cache = _cache_like(cfg, 128, 32768)
    kv_bytes = sum(math.prod(t.shape) * t.element_size() for p, t in leaves_with_paths(cache)
                   if p != "['t']")
    assert dec["cache_bytes_per_device"] == kv_bytes // 256 + 128 * 4 // 16   # t: rows over data
    assert dec["roofline"]["memory_s"] > plain["roofline"]["memory_s"]
    assert dec["param_bytes_per_device"] == shd.sharded_bytes(params, specs, mesh)


def test_planner_cells_with_seq_parallel(tmp_path, monkeypatch):
    """``--seq-parallel --shape prefill_32k --mesh single`` plans every arch
    into files ending in ``__sp``, none skipped; whisper-medium's 1500
    frames go over model 16 in blocks of 94 (the last rank's 90): each
    encoder layer all-gathers K and V of 94 frames a rank, and the
    encoder's output is gathered once."""
    import json
    import os

    from repro_torch.configs.base import ARCH_IDS
    from repro_torch.launch import dryrun

    monkeypatch.setattr(dryrun, "RESULTS_DIR", str(tmp_path))
    counts = dryrun.main(["--seq-parallel", "--shape", "prefill_32k", "--mesh", "single"])
    assert counts == {"ok": len(ARCH_IDS), "skipped": 0}
    files = sorted(os.listdir(tmp_path))
    assert len(files) == len(ARCH_IDS) and all(f.endswith("__16x16__sp.json") for f in files)
    with open(tmp_path / "whisper-medium__prefill_32k__16x16__sp.json") as f:
        cell = json.load(f)
    assert cell["status"] == "ok" and cell["seq_parallel"]
    import math

    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import plan_serve
    from repro_torch.models.build import build_model
    from repro_torch.models.lm import trainable
    from repro_torch.tree import flatten_up_to

    cfg, mesh = get_arch("whisper-medium"), make_production_mesh()
    params = trainable(build_model(cfg, "cpu").abstract_params())
    specs = shd.param_shardings(params, cfg, mesh)
    coll = plan_serve(cfg, params, specs, mesh, phase="prefill", batch=(32, 32768),
                      max_len=32768, seq_parallel=True, by_axes=True)
    assert coll["all_gather"]["count"] == cell["collectives"]["all_gather"]["count"]
    rows, frames = 32 // 16, 94
    kv = rows * cfg.n_kv_heads * frames * cfg.head_dim * 2          # a rank's K (or V) frames
    dec_kv = rows * cfg.n_kv_heads * 32768 // 16 * cfg.head_dim * 2
    enc_out = rows * frames * cfg.d_model * 2
    from repro_torch.distributed.collectives import leaf_placement

    over_model = sum(leaf_placement(tuple(t.shape), spec, mesh).gather_axes == ("model",)
                     for (_, t), spec in zip(leaves_with_paths(params),
                                             flatten_up_to(specs, params)))
    assert coll["all_gather"]["axes"]["model"] - over_model == \
        2 * cfg.encoder_layers + 1 + 2 * cfg.n_layers
    shards = sum(math.prod(shd.local_shape(tuple(t.shape), spec, mesh)) * t.element_size()
                 for (_, t), spec in zip(leaves_with_paths(params), flatten_up_to(specs, params))
                 if any(spec))
    assert coll["all_gather"]["operand_bytes"] - shards == \
        2 * cfg.encoder_layers * kv + enc_out + 2 * cfg.n_layers * dec_kv
