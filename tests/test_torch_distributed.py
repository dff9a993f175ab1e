"""Distribution in the port against the reference, on the CPU.

* **Rules**: for every leaf of the ten archs, the port's spec equals the
  reference's ``param_spec`` at six meshes, under both ``dp_only`` values
  (the reference's on ``jax.sharding.AbstractMesh``, which needs no
  devices); the port's per-layer leaves take the reference's stacked spec
  without its leading dim.  Batch and cache specs, the activation, logits
  and internal rules, ``dp_dominant`` and ``moe_expert_parallel`` alike.
* **Bytes and the planner**: ``sharded_bytes`` against the reference's
  ``launch.dryrun._sharded_bytes`` (in a subprocess: importing the
  reference's dry-run sets ``XLA_FLAGS``), for every cell on both
  production meshes; the planner's status, reason and strategy.
* **Multi-rank** (gloo, ranks spawned, ``file://`` rendezvous in
  ``tmp_path``, each case under its own timeout): the sharded step at
  worlds 2 and 4 within 1e-5 of the port's single-process step (the loss
  relative; each f32 param and optimizer leaf relative to its largest
  entry; a tensor-parallel step where the two computations meet:
  ``_assert_near_one_process``) and bit-equal at world 1; each rank's ``wq`` exactly the slice its
  spec gives; the pipeline, the compressed all-reduce and elastic restore
  against the reference (its ``shard_map`` code in a subprocess with host
  devices, as ``tests/test_distributed.py`` runs it); the trainer under a
  2-rank launch against one process, and resumed at another world size.

JAX and the reference are imported inside the tests, so the spawned ranks,
which import this module, load neither.
"""
import contextlib
import datetime
import functools
import json
import os
import re
import subprocess
import sys
import textwrap
import time
import traceback
import warnings
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.configs.base import all_archs, all_cells, get_arch, get_shape, reduced
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import Mesh, make_production_mesh, make_test_mesh
from repro_torch.tree import flatten_up_to, leaves, leaves_with_paths, tree_map

ROOT = Path(__file__).resolve().parents[1]
ARCHS = sorted(all_archs())
#: the meshes of the spec parity: (4, 2), (2, 2), (1, 4), (8, 1) and the
#: reference's two production meshes
MESHES = [(("data", "model"), (4, 2)), (("data", "model"), (2, 2)), (("data", "model"), (1, 4)),
          (("data", "model"), (8, 1)), (("data", "model"), (16, 16)),
          (("pod", "data", "model"), (2, 16, 16))]
MESH_IDS = ["x".join(map(str, s)) for _, s in MESHES]
#: a multi-rank case's limit: a hung collective fails the case
RANK_TIMEOUT = 120
STEP_REL = 1e-5


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _amesh(names, sizes):
    from jax.sharding import AbstractMesh

    return AbstractMesh(tuple(sizes), tuple(names))


def _norm(spec) -> tuple:
    """A spec (the port's tuple or a PartitionSpec) as tuples of axes."""
    return tuple(() if e is None else (e,) if isinstance(e, str) else tuple(e) for e in spec)


def _ref_path(path: str, cfg) -> tuple[str, bool]:
    """The reference's path of a port leaf, and whether the reference
    stacks it along a leading layer dim."""
    m = re.fullmatch(r"(.*?)\['(layers|encoder|decoder)'\]\[(\d+)\](.*)", path)
    if not m:
        return path, False
    pre, key, j, rest = m.group(1), m.group(2), int(m.group(3)), m.group(4)
    if cfg.family == "audio":
        return f"{pre}['{key}']{rest}", True
    pat = len(cfg.layer_pattern)
    reps = cfg.n_layers // pat
    if j < reps * pat:
        return f"{pre}['groups']['{j % pat}']{rest}", True
    return f"{pre}['tail'][{j - reps * pat}]{rest}", False


@functools.lru_cache(maxsize=None)
def _ref_params(arch: str) -> list:
    import jax

    from repro.configs.base import get_arch as jget_arch
    from repro.models.build import build_model as jbuild_model

    ap = jbuild_model(jget_arch(arch)).abstract_params()
    return [(jax.tree_util.keystr(kp), tuple(leaf.shape))
            for kp, leaf in jax.tree_util.tree_flatten_with_path(ap)[0]], ap


@functools.lru_cache(maxsize=None)
def _port_params(arch: str):
    from repro_torch.models.build import build_model
    from repro_torch.models.lm import trainable

    return trainable(build_model(get_arch(arch), "cpu").abstract_params())


def _compare_stacked(port_leaves, ref_by_path, cfg, what):
    """Each port leaf's (shape, spec) against its reference leaf's."""
    seen = set()
    for path, shape, spec in port_leaves:
        rpath, stacked = _ref_path(path, cfg)
        assert rpath in ref_by_path, f"{what}: {path} has no reference leaf {rpath}"
        rshape, rspec = ref_by_path[rpath]
        seen.add(rpath)
        if stacked:
            assert rshape[1:] == shape, (what, path, rshape, shape)
            assert rspec[0] == () and rspec[1:] == spec, (what, path, rspec, spec)
        else:
            assert (rshape, rspec) == (shape, spec), (what, path, rshape, rspec, shape, spec)
    assert seen == set(ref_by_path), f"{what}: reference leaves not reached: {set(ref_by_path) - seen}"


def _run_ref(code: str, n_devices: int = 8, timeout: int = RANK_TIMEOUT) -> str:
    """Reference code in a fresh process with ``n_devices`` host devices."""
    env = dict(os.environ, XLA_FLAGS=f"--xla_force_host_platform_device_count={n_devices}",
               PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)], capture_output=True,
                         text=True, env=env, timeout=timeout)
    assert out.returncode == 0, f"stdout:\n{out.stdout}\nstderr:\n{out.stderr}"
    return out.stdout


#: attempts at a world's gloo set-up: where a rank fails to join its group,
#: every rank is stopped and the world starts afresh on a new rendezvous,
#: each retry said in the test's output (a warning, and printed).  Only the
#: set-up is retried: a rank that fails inside its case fails the test.
SETUP_ATTEMPTS = 3
#: a rank's limit on joining its group, so that a rank whose peer is lost
#: fails with its own traceback well inside the case's limit
SETUP_TIMEOUT = 90
#: every retried set-up of this process: (test, attempt, each rank's fate)
setup_retries: list = []


def _rank_entry(target, rank, world, out_dir, group, args):
    """One spawned rank: join the gloo group (``group``; else ``target``
    joins one itself), run ``target``, save what it returns.  Leaves its fate in ``out_dir``: ``rank{r}.setup`` (the
    traceback of a failed join), ``rank{r}.joined`` (joined, the case
    begun), ``rank{r}.err`` (the case's traceback), ``rank{r}.pt`` (its
    result)."""
    try:
        torch.set_num_threads(1)
        if group:
            try:
                dist.init_process_group("gloo", init_method=f"file://{out_dir}/rendezvous",
                                        rank=rank, world_size=world,
                                        timeout=datetime.timedelta(seconds=SETUP_TIMEOUT))
            except BaseException:
                Path(out_dir, f"rank{rank}.setup").write_text(traceback.format_exc())
                os._exit(3)
        Path(out_dir, f"rank{rank}.joined").touch()
        try:
            result = target(rank, world, *args)
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    except BaseException:
        Path(out_dir, f"rank{rank}.err").write_text(traceback.format_exc())
        raise SystemExit(1)


def _fates(out_dir: Path, procs, hung: list, timeout: float) -> dict:
    """What became of each rank: its set-up or case traceback, a kill at the
    limit (joining its group, or in its case), an exit code without a
    traceback (a signal: the process died hard), or its result."""
    fates = {}
    for r, p in enumerate(procs):
        setup, err = out_dir / f"rank{r}.setup", out_dir / f"rank{r}.err"
        where = "in its case" if (out_dir / f"rank{r}.joined").exists() else "joining its group"
        if setup.exists():
            fates[r] = f"failed joining its group:\n{setup.read_text()}"
        elif err.exists():
            fates[r] = f"failed in its case:\n{err.read_text()}"
        elif r in hung:
            fates[r] = f"still running {where} after {timeout} s: killed"
        elif p.exitcode != 0:
            fates[r] = f"exited with code {p.exitcode} {where}, no traceback"
        else:
            fates[r] = "returned its result"
    return fates


def _spawn_world(target, world: int, out_dir: Path, group: bool, args, timeout: float):
    """One attempt: ``world`` spawned ranks, joined until ``timeout``; the
    ranks still alive are killed.  Returns (procs, hung ranks)."""
    out_dir.mkdir()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_entry, args=(target, r, world, str(out_dir), group, args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    return procs, hung


def run_ranks(target, world: int, tmp_path, *args, timeout: int = RANK_TIMEOUT,
              group: bool = True) -> list:
    """``target(rank, world, *args)`` on ``world`` spawned ranks; returns
    what each returned.  Fails (and kills the ranks) past ``timeout``,
    naming every rank's fate (:func:`_fates`).  Where a rank fails to join
    the gloo group, the world is started afresh, at most
    :data:`SETUP_ATTEMPTS` times in all, each retry said in the output."""
    name = os.environ.get("PYTEST_CURRENT_TEST", target.__name__).split(" ")[0]
    stamp = time.monotonic_ns()
    for attempt in range(1, SETUP_ATTEMPTS + 1):
        out_dir = tmp_path / f"ranks_{world}_{stamp}_{attempt}"
        procs, hung = _spawn_world(target, world, out_dir, group, args, timeout)
        fates = _fates(out_dir, procs, hung, timeout)
        report = "\n".join(f"rank {r}: {f}" for r, f in fates.items())
        if attempt < SETUP_ATTEMPTS and any((out_dir / f"rank{r}.setup").exists()
                                            for r in range(world)):
            setup_retries.append((name, attempt, fates))
            msg = (f"gloo set-up retried ({len(setup_retries)} in this process; attempt "
                   f"{attempt + 1} of {SETUP_ATTEMPTS} for {name}):\n{report}")
            print(msg, flush=True)
            warnings.warn(msg, RuntimeWarning, stacklevel=2)
            continue
        assert not hung and all(p.exitcode == 0 for p in procs), \
            f"{name}, world {world} (attempt {attempt}):\n{report}"
        return [torch.load(out_dir / f"rank{r}.pt", weights_only=False) for r in range(world)]


# ---------------------------------------------------------------------------
# rules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dp_only", [False, True], ids=["fsdp_tp", "dp"])
@pytest.mark.parametrize("mesh_def", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_the_reference(arch, mesh_def, dp_only):
    from repro.configs.base import get_arch as jget_arch
    from repro.distributed import sharding as rshd

    names, sizes = mesh_def
    amesh, mesh = _amesh(names, sizes), Mesh(names, sizes)
    jcfg, cfg = jget_arch(arch), get_arch(arch)
    ref_leaves, _ = _ref_params(arch)
    ref_by_path = {}
    for path, shape in ref_leaves:
        rspec = _norm(rshd.param_spec(path, shape, jcfg, amesh, dp_only))
        # the copy on the reference's own paths and stacked shapes
        assert _norm(shd.param_spec(path, shape, cfg, mesh, dp_only)) == rspec, path
        ref_by_path[path] = (shape, rspec)
    params = _port_params(arch)
    specs = shd.param_shardings(params, cfg, mesh, dp_only)
    port = [(path, tuple(t.shape), _norm(s))
            for (path, t), s in zip(leaves_with_paths(params), flatten_up_to(specs, params))]
    _compare_stacked(port, ref_by_path, cfg, f"{arch} params")
    # every sharded dim divides its axes: shard_leaf never pads
    for (path, t), s in zip(leaves_with_paths(params), flatten_up_to(specs, params)):
        shd.local_shape(tuple(t.shape), s, mesh)


@pytest.mark.parametrize("mesh_def", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_cache_and_activation_specs_match_the_reference(arch, mesh_def):
    import jax

    from repro.configs.base import get_arch as jget_arch
    from repro.configs.base import get_shape as jget_shape
    from repro.configs.base import shape_applicable
    from repro.distributed import sharding as rshd
    from repro.models.build import build_model as jbuild_model
    from repro_torch.models.build import build_model

    names, sizes = mesh_def
    amesh, mesh = _amesh(names, sizes), Mesh(names, sizes)
    jcfg, cfg = jget_arch(arch), get_arch(arch)
    jmodel = jbuild_model(jcfg)
    for shape_name in ("train_4k", "prefill_32k", "decode_32k"):
        shape = jget_shape(shape_name)
        if not shape_applicable(jcfg, shape)[0]:
            continue
        specs = jmodel.input_specs(shape)
        for dp_only in (False, True):
            ref = jax.tree_util.tree_flatten_with_path(
                rshd.batch_shardings(specs, jcfg, amesh, dp_only),
                is_leaf=lambda x: hasattr(x, "spec"))[0]
            ref_by_path = {jax.tree_util.keystr(kp): _norm(s.spec) for kp, s in ref}
            # the batch leaves on the reference's tree; its cache leaves below,
            # against the port's own per-layer cache
            inputs = {k: v for k, v in specs.items() if k != "cache"}
            port = shd.batch_shardings(inputs, cfg, mesh, dp_only)
            got = {path: _norm(s) for (path, _), s in
                   zip(leaves_with_paths(inputs), flatten_up_to(port, inputs))}
            assert got == {p: s for p, s in ref_by_path.items() if "cache" not in p}, \
                (shape_name, dp_only)
        assert (shd.dp_dominant(cfg, mesh, kind=shape.kind, global_batch=shape.global_batch)
                == rshd.dp_dominant(jcfg, amesh, kind=shape.kind, global_batch=shape.global_batch))
        if shape.kind == "decode":
            # the port's own per-layer cache against the reference's stacked one
            shapes = {jax.tree_util.keystr(kp): tuple(leaf.shape)
                      for kp, leaf in jax.tree_util.tree_flatten_with_path(specs)[0]}
            ref_by_path = {p: (shapes[p], s) for p, s in ref_by_path.items() if "cache" in p}
            cache = {"cache": build_model(cfg, "cpu").init_cache(shape.global_batch, shape.seq_len,
                                                                 device="meta")}
            port = shd.batch_shardings(cache, cfg, mesh)
            got = [(path, tuple(t.shape), _norm(s)) for (path, t), s in
                   zip(leaves_with_paths(cache), flatten_up_to(port, cache))]
            _compare_stacked(got, ref_by_path, cfg, f"{arch} cache")
    for dp_only in (False, True):
        for seq in (False, True):
            assert (_norm(shd.activation_sharding(mesh, cfg, dp_only, seq))
                    == _norm(rshd.activation_sharding(amesh, jcfg, dp_only, seq).spec))
    assert _norm(shd.logits_sharding(mesh, cfg)) == _norm(rshd.logits_sharding(amesh, jcfg).spec)
    assert ({k: _norm(v) for k, v in shd.internal_sharding_rules(mesh, cfg).items()}
            == {k: _norm(v.spec) for k, v in rshd.internal_sharding_rules(amesh, jcfg).items()})
    assert shd.moe_expert_parallel(cfg, mesh) == rshd.moe_expert_parallel(jcfg, amesh)
    assert shd.fsdp_axes(mesh) == rshd.fsdp_axes(amesh)


def test_meshes_have_the_reference_shapes():
    assert make_production_mesh().shape == {"data": 16, "model": 16}
    assert make_production_mesh(multi_pod=True).shape == {"pod": 2, "data": 16, "model": 16}
    m = make_test_mesh(8, model=2)
    assert m.shape == {"data": 4, "model": 2} and m.axis_names == ("data", "model")
    assert [m.rank_of(m.coords(r)) for r in range(8)] == list(range(8))
    assert m.coords(5) == {"data": 2, "model": 1}       # row-major, as jax.make_mesh
    with pytest.raises(ValueError):
        make_test_mesh(6, model=4)


def test_shard_leaf_cuts_the_specs_slices():
    mesh = Mesh(("pod", "data", "model"), (2, 2, 2))
    full = torch.arange(8 * 6 * 4).reshape(8, 6, 4)
    spec = (("pod", "data"), None, "model")
    pieces = {}
    for r in range(8):
        c = mesh.coords(r)
        part = shd.shard_leaf(full, spec, mesh, c)
        assert tuple(part.shape) == shd.local_shape((8, 6, 4), spec, mesh) == (2, 6, 2)
        i = c["pod"] * 2 + c["data"]
        assert torch.equal(part, full[2 * i:2 * i + 2, :, 2 * c["model"]:2 * c["model"] + 2])
        pieces[r] = part
    assert sum(p.numel() for p in pieces.values()) == full.numel()


def test_context_records_specs_and_constrains_nothing():
    """Under gathered compute every activation is this rank's batch shard:
    the reference's constraint calls take its specs and change nothing."""
    from repro_torch.distributed import context

    mesh, cfg = make_production_mesh(), get_arch("mixtral-8x22b")   # 8 experts on 16: TP
    x = torch.randn(2, 3, 4)
    with context.activation_sharding(shd.activation_sharding(mesh, cfg)):
        assert context.constrain(x) is x
    context.set_sharding_rules(shd.internal_sharding_rules(mesh, cfg))
    assert context.constrain_named(x, "moe_buf") is x
    assert context.constrain_named(x, "moe_out") is x
    assert context.param_gather() is None


# ---------------------------------------------------------------------------
# bytes and the planner
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def reference_plans():
    """The reference's bytes per device, strategy and status for every cell
    of ``all_cells()`` on both production meshes (``_sharded_bytes`` of
    ``repro.launch.dryrun``, in a subprocess)."""
    out = _run_ref("""
        import json, jax
        from repro.launch.dryrun import _sharded_bytes, make_production_mesh
        from repro.configs.base import all_cells, get_arch, get_shape, shape_applicable
        from repro.distributed import sharding as shd
        from repro.models.build import build_model
        res, cache = {}, {}
        for multi in (False, True):
            mesh = make_production_mesh(multi_pod=multi)
            name = "2x16x16" if multi else "16x16"
            for arch, shape_name, _ok, _why in all_cells():
                cfg, shape = get_arch(arch), get_shape(shape_name)
                ok, why = shape_applicable(cfg, shape)
                key = f"{arch}|{shape_name}|{name}"
                if not ok:
                    res[key] = {"status": "skipped", "reason": why}
                    continue
                if arch not in cache:
                    cache[arch] = build_model(cfg).abstract_params()
                dp = shd.dp_dominant(cfg, mesh, kind=shape.kind, global_batch=shape.global_batch)
                sh = shd.param_shardings(cache[arch], cfg, mesh, dp)
                res[key] = {"status": "ok", "strategy": "dp_only" if dp else "fsdp+tp",
                            "param_bytes_per_device": _sharded_bytes(cache[arch], sh, mesh)}
        print("RESULT", json.dumps(res))
    """, n_devices=512, timeout=600)
    return json.loads(out.split("RESULT", 1)[1])


PLANNER_CELLS = [(a, s, m) for a, s, _ok, _why in all_cells() for m in (False, True)]


@pytest.mark.parametrize("arch,shape,multi", PLANNER_CELLS,
                         ids=[f"{a}-{s}-{'2x16x16' if m else '16x16'}" for a, s, m in PLANNER_CELLS])
def test_planner_matches_the_reference(arch, shape, multi, reference_plans):
    from repro_torch.launch import dryrun

    got = dryrun.run_cell(arch, shape, multi)
    want = reference_plans[f"{arch}|{shape}|{'2x16x16' if multi else '16x16'}"]
    assert got["status"] == want["status"]
    if want["status"] == "skipped":
        assert got["reason"] == want["reason"]
        return
    assert got["strategy"] == want["strategy"]
    assert got["param_bytes_per_device"] == want["param_bytes_per_device"]
    assert got["chips"] == (512 if multi else 256)
    assert not {"lower_s", "compile_s", "memory_analysis", "cost_analysis"} & set(got)
    coll = got["collectives"]
    assert coll["total_operand_bytes"] == sum(v["operand_bytes"] for k, v in coll.items()
                                              if isinstance(v, dict))
    if get_shape(shape).kind == "train":
        assert coll["reduce_scatter"]["count"] > 0
        assert coll["all_gather"]["count"] >= coll["reduce_scatter"]["count"]
    r = got["roofline"]
    assert r["dominant"] in ("compute", "memory", "collective") and r["compute_s"] > 0


def test_planner_writes_its_cells_and_sets_no_xla_flags(tmp_path, monkeypatch):
    from repro_torch.launch import dryrun

    monkeypatch.setattr(dryrun, "RESULTS_DIR", str(tmp_path))
    counts = dryrun.main(["--arch", "gemma2-2b", "--mesh", "single"])
    files = sorted(os.listdir(tmp_path))
    assert counts["ok"] + counts["skipped"] == len(files) == 4
    cell = json.loads((tmp_path / "gemma2-2b__train_4k__16x16.json").read_text())
    assert cell["strategy"] == "dp_only" and cell["status"] == "ok"
    assert "XLA_FLAGS" not in os.environ or "512" not in os.environ["XLA_FLAGS"]


# ---------------------------------------------------------------------------
# the sharded step on gloo
# ---------------------------------------------------------------------------


def _step_batch(cfg, b=8, s=16, seed=1, masked=False):
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(rng.integers(1, cfg.vocab_size, size=(b, s)).astype(np.int64))}
    if masked:
        # uneven: every batch shard of every test mesh keeps its own count
        kept = np.array([3, 5, 2, 16, 16, 12, 9, 16])[:b]
        batch["mask"] = torch.from_numpy((np.arange(s)[None, :] < kept[:, None]).astype(np.int32))
    return batch


def _by_path(tree) -> dict:
    """A tree's leaves by path (trees converted from the reference hold
    their dict keys in another order)."""
    return dict(leaves_with_paths(tree))


def _per_op(snapshot: dict) -> dict:
    """A counter's snapshot as the plan gives it (no bytes per dtype)."""
    return {op: ({k: v[k] for k in ("count", "operand_bytes", "result_bytes")}
                 if isinstance(v, dict) else v) for op, v in snapshot.items()}


#: the orders :func:`_permute_units` stores a network's units in
UNIT_ORDERS = ("reverse", "roll", "stride")


def _permute_units(tree: dict, cfg, order: str, inverse: bool = False) -> dict:
    """A params-shaped tree with each layer's heads and hidden units (d_ff
    units, GLU pairs, recurrent channels) stored in another ``order``
    (``reverse``; ``roll``: shifted by half their count, KV heads by half
    theirs; ``stride``: the even units, then the odd, q heads moving with
    their KV head's group): the same network, whose products sum their
    inner dimensions in another order.  ``inverse`` undoes it."""
    hd = cfg.head_dim
    glu = cfg.mlp_kind in ("swiglu", "geglu")

    def blocks(t, dim, size):
        dim %= t.dim()
        n = t.shape[dim] // size
        if order == "reverse":
            idx = torch.arange(n - 1, -1, -1)
        elif order == "roll":
            idx = torch.roll(torch.arange(n), (n // 2) if inverse else -(n // 2))
        else:
            idx = torch.cat([torch.arange(0, n, 2), torch.arange(1, n, 2)])
            idx = torch.argsort(idx) if inverse else idx
        return t.unflatten(dim, (n, size)).index_select(dim, idx).flatten(dim, dim + 1)

    q = hd * (cfg.n_heads // cfg.n_kv_heads if order == "stride" else 1)
    attn = {"wq": (-1, q), "wk": (-1, hd), "wv": (-1, hd), "wo": (0, q)}
    rules = {"attn": attn, "self_attn": attn, "cross_attn": attn,
             "mlp": {"w_in": (-1, 2 if glu else 1), "b_in": (0, 1), "w_out": (0, 1)},
             "moe": {"w_in": (-1, 2), "w_out": (1, 1)},
             "rnn": {"w_gate": (-1, 1), "w_x": (-1, 1), "conv": (-1, 1), "lambda": (0, 1),
                     "gate_a": (0, 1), "gate_i": (0, 1), "w_out": (0, 1)}}
    rwkv = {"wr": (-1, hd), "wk": (-1, hd), "wv": (-1, hd), "wg": (-1, hd), "wb": (-1, hd),
            "w0": (0, hd), "ln_x": (0, hd), "u": (0, 1), "wo": (0, hd), "ck": (-1, 1),
            "cv": (0, 1)}

    def apply(d, rule):
        return {k: blocks(v, *rule[k]) if k in rule else v for k, v in d.items()}

    def layer(p):
        if cfg.family == "ssm":
            return apply(p, rwkv)
        return {k: apply(v, rules[k]) if k in rules else v for k, v in p.items()}

    return {k: [layer(p) for p in v] if k in ("layers", "encoder", "decoder") else v
            for k, v in tree.items()}


#: AdamW's eps scale, as a multiple of ``AdamWConfig.eps``: the first
#: update is g/(|g| + eps), whose slope eps/(|g| + eps)^2 at |g| = 100·eps
#: turns a 1e-9 rounding of the gradient into 1e-5 of a learning rate
NEAR_EPS = 100


@contextlib.contextmanager
def _recorded_grads(into: list):
    """Each gradient ``adamw.apply_updates`` is handed, appended to ``into``."""
    from repro_torch.optim import adamw

    inner = adamw.apply_updates

    def recording(params, grads, state, cfg, gnorm=None):
        into.append(tree_map(torch.clone, grads))
        return inner(params, grads, state, cfg, gnorm=gnorm)

    adamw.apply_updates = recording
    try:
        yield into
    finally:
        adamw.apply_updates = inner


def _one_process_from(model, opt_cfg, kw, states, batch, inner_orders=False) -> list:
    """Per step of a tensor-parallel run (``states``: the gathered state
    before each step and after the last), the one-process step taken from
    the same state: on the batch (with its gradient and learning rate), on
    the batch's rows in reverse order and, with ``inner_orders``, with the
    network's units stored in the orders of :data:`UNIT_ORDERS`."""
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models.lm import tied_head, trainable

    fn = steps_mod.make_train_step(model, opt_cfg, **kw)
    cfg = model.cfg

    def permute(state, order, inverse=False):
        return {"params": _permute_units(state["params"], cfg, order, inverse),
                "opt": {k: _permute_units(v, cfg, order, inverse) if k in ("m", "v", "master")
                        else v for k, v in state["opt"].items()}}

    def run(state, rows, order=None):
        state = tree_map(torch.clone, state)
        if order:
            state = permute(state, order)
        params = dict(state["params"])
        if cfg.tie_embeddings:
            params["embed_t"] = tied_head(params["embed"])
        params, opt, metrics = fn(params, state["opt"], rows)
        out = {"params": trainable(params), "opt": opt}
        return (permute(out, order, inverse=True) if order else out), metrics

    reversed_rows = {k: v.flip(0) for k, v in batch.items()}
    out = []
    for before, after in zip(states, states[1:]):
        with _recorded_grads([]) as grads:
            one, metrics = run(before, batch)
        out.append({"state": after, "one": one, "grads": grads[-1], "lr": float(metrics["lr"]),
                    "eps": opt_cfg.eps, "reordered": run(before, reversed_rows)[0],
                    "inner": [run(before, batch, o)[0] for o in UNIT_ORDERS]
                    if inner_orders else []})
    return out


def _sharded_run(rank, world, arch, model_axis, strategy, steps, kw, masked=False):
    """``steps`` sharded steps from the port's seed-0 init, each step's collectives and those of one forward under
    the step's gather beside the step's plan; on rank 0 the gathered state
    and the one-process step's (on the batch, and on its rows reversed).  A
    tensor-parallel run (``fsdp_tp``, ``model_axis`` > 1) also gathers its
    state at every step, and rank 0 takes the one-process step from each
    (:func:`_one_process_from`)."""
    from repro_torch.distributed.collectives import ParamGather
    from repro_torch.distributed.context import gathered_params
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models.build import build_model
    from repro_torch.models.lm import trainable
    from repro_torch.optim.adamw import AdamWConfig

    cfg = reduced(get_arch(arch))
    model = build_model(cfg, "cpu")
    opt_cfg = AdamWConfig(warmup_steps=1, total_steps=4)
    batch = _step_batch(cfg, masked=masked)
    mesh = make_test_mesh(model=model_axis)
    step = steps_mod.make_sharded_train_step(model, opt_cfg, mesh, strategy=strategy, **kw)
    params = step.shard_params(model.init(0))
    opt = step.init_opt_state(params)
    counter = step.groups.counter
    losses, per_step = [], []
    tp = strategy == "fsdp_tp" and model_axis > 1
    states = [step.state_sharded(opt).gather({"params": params, "opt": opt})] if tp else []
    for _ in range(steps):
        counter.reset()
        params, opt, metrics = step(params, opt, batch)
        per_step.append(_per_op(counter.snapshot()))
        losses.append(float(metrics["loss"]))
        if tp:
            states.append(step.state_sharded(opt).gather({"params": params, "opt": opt}))
    shape = tuple(batch["tokens"].shape)
    plan = {"step": steps_mod.plan_collectives(cfg, step.params.like, step.specs, mesh,
                                               grad_accum=kw.get("grad_accum", 1),
                                               compress_grads=kw.get("compress_grads", False),
                                               strategy=strategy, batch=shape),
            "forward": steps_mod.plan_collectives(cfg, step.params.like, step.specs, mesh,
                                                  train=False, strategy=strategy, batch=shape)}
    counter.reset()
    gather = ParamGather(step.params, params, step.groups.size(step.batch_axes))
    with torch.no_grad(), gathered_params(gather):
        model.forward(params, step.batch_shard(batch))
    forward = _per_op(counter.snapshot())
    wq_path = next((p for p, _ in leaves_with_paths(params) if p.endswith("['wq']")), None)
    state = step.state_sharded(opt).gather({"params": params, "opt": opt})
    out = {"losses": losses, "coords": step.groups.coords,
           "local": {p: t.clone() for p, t in leaves_with_paths(params)},
           "counter": counter.snapshot(), "per_step": per_step, "forward": forward,
           "plan": plan, "wq_path": wq_path}
    if rank == 0:
        out["state"] = state
        if tp:
            out["tp"] = _one_process_from(model, opt_cfg, kw, states, batch)
        # the oracle: one process on the whole batch; and the same step on the
        # batch's rows in reverse order, which sums the same gradient in
        # another order (the f32 noise floor of the comparison)
        for name, rows in (("ref", batch), ("reordered", {k: v.flip(0) for k, v in batch.items()})):
            ref = model.init(0)
            ref_opt = steps_mod.init_opt_state(ref, compress_grads=kw.get("compress_grads", False))
            fn = steps_mod.make_train_step(model, opt_cfg, **kw)
            ref_losses = []
            for _ in range(steps):
                ref, ref_opt, m = fn(ref, ref_opt, rows)
                ref_losses.append(float(m["loss"]))
            out[name] = {"params": trainable(ref), "opt": ref_opt}
            out[f"{name}_losses"] = ref_losses
    return out


def _assert_near_one_process(lead) -> list:
    """The loss within 1e-5 relative of the one-process step's, each f32
    param and optimizer leaf within 1e-5 of its largest entry or within
    twice the reordered batch's distance, where that is larger.

    A tensor-parallel run (``lead["tp"]``) is held step by step, each step
    against the one-process step taken from the same state, by the same
    bounds; with ``inner_orders`` (:func:`_one_process_from`) also within
    twice the distance the one-process step moves when the network's units
    are stored in another order: the products' inner sums, which tensor
    parallelism splits over ranks, added in other orders.  A param (and
    master) entry whose one-process gradient is within AdamW's eps scale
    (``NEAR_EPS``·eps) may pass these bounds, by up to the step's learning
    rate: AdamW's update there turns a rounding of the gradient into a
    share of the step, and a two-step trajectory would carry that move into
    every entry of the next step's gradient.  Returns those entries: (step,
    path, index, one-process gradient, distance, bound, learning rate)."""
    for got, want in zip(lead["losses"], lead["ref_losses"]):
        assert abs(got - want) <= STEP_REL * abs(want), (lead["losses"], lead["ref_losses"])
    if "tp" in lead:
        return [e for k, s in enumerate(lead["tp"]) for e in _assert_step_near_one_process(k, s)]
    ref, reordered = _by_path(lead["ref"]), _by_path(lead["reordered"])
    assert set(ref) == set(_by_path(lead["state"]))
    for path, a in leaves_with_paths(lead["state"]):
        b, c = ref[path], reordered[path]
        assert a.shape == b.shape, path
        if a.dtype == torch.float32:
            err = float((a - b).abs().max())
            bound = max(STEP_REL * float(b.abs().max()), 2 * float((c - b).abs().max()))
            assert err <= bound, (path, err, bound)
        else:
            assert torch.equal(a, b), path
    return []


def _report_exempt(exempt: list) -> None:
    """Prints the entries :func:`_assert_near_one_process` let pass its
    bounds (pytest shows them with ``-s`` or under ``-rA``)."""
    if exempt:
        print(f"{len(exempt)} param entries within AdamW's eps scale past the 1e-5 bounds:")
    for k, path, index, g, err, bound, lr in exempt:
        print(f"  step {k} {path}{list(index)}: gradient {g:.3g}, off by {err:.3g} "
              f"(bound {bound:.3g}, learning rate {lr:.3g})")


def _assert_step_near_one_process(k: int, s: dict) -> list:
    """Step ``k`` of a tensor-parallel run against the one-process step
    from the same state (see :func:`_assert_near_one_process`)."""
    one, reordered, grads = _by_path(s["one"]), _by_path(s["reordered"]), _by_path(s["grads"])
    inner = [_by_path(t) for t in s["inner"]]
    assert set(one) == set(_by_path(s["state"]))
    exempt = []
    for path, a in leaves_with_paths(s["state"]):
        b = one[path]
        assert a.shape == b.shape, path
        if a.dtype != torch.float32:
            assert torch.equal(a, b), (k, path)
            continue
        err = (a - b).abs()
        bound = max([STEP_REL * float(b.abs().max()), 2 * float((reordered[path] - b).abs().max())]
                    + [2 * float((t[path] - b).abs().max()) for t in inner])
        over = err > bound
        if not over.any():
            continue
        head = next((h for h in ("['params']", "['opt']['master']") if path.startswith(h)), None)
        assert head is not None, (k, path, float(err.max()), bound)
        g = grads[path[len(head):]]
        near = g.abs() <= NEAR_EPS * s["eps"]
        assert not (over & ~near).any(), (k, path, float(err[over & ~near].max()), bound)
        assert float(err[over].max()) <= s["lr"], (k, path, float(err[over].max()), s["lr"])
        exempt += [(k, path, tuple(i), float(g[tuple(i)]), float(err[tuple(i)]), bound, s["lr"])
                   for i in over.nonzero().tolist()]
    return exempt


def _assert_plan_is_the_step(out):
    """Every step issued, per op, the collectives and bytes the step's plan
    (the planner's) gives, and a forward under the gather its forward plan."""
    for got in out["per_step"]:
        assert got == out["plan"]["step"], (got, out["plan"]["step"])
    assert out["forward"] == out["plan"]["forward"], (out["forward"], out["plan"]["forward"])


def _to_reference_layout(params: dict, cfg) -> dict:
    """A decoder-only model's trainable params in the reference's layout
    (numpy): the layers of each pattern position stacked, then the tail
    (the inverse of ``repro_torch.convert.params_from_jax``)."""
    from repro_torch.models.lm import trainable

    pat, layers = len(cfg.layer_pattern), params["layers"]
    reps = cfg.n_layers // pat
    out = {k: tree_map(lambda t: t.numpy(), v) for k, v in trainable(params).items()
           if k != "layers"}
    out["groups"] = {str(i): tree_map(lambda *ts: np.stack([t.numpy() for t in ts]),
                                      *[layers[r * pat + i] for r in range(reps)])
                     for i in range(pat)}
    out["tail"] = [tree_map(lambda t: t.numpy(), layer) for layer in layers[reps * pat:]]
    return out


@functools.lru_cache(maxsize=None)
def _reference_steps(arch: str, steps: int = 2):
    """The reference's single-device ``make_train_step`` (jitted, in this
    process) from the port's seed-0 init, ``steps`` times on the batch of
    :func:`_step_batch`: (its losses, its final {"params", "opt"} in the
    port's layout)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_arch as jget_arch
    from repro.configs import reduced as jreduced
    from repro.launch import steps as jsteps
    from repro.models import build_model as jbuild_model
    from repro.optim.adamw import AdamWConfig as JAdamWConfig
    from repro_torch.convert import opt_state_from_jax, params_from_jax
    from repro_torch.models.build import build_model
    from repro_torch.models.lm import trainable

    cfg = reduced(get_arch(arch))
    jmodel = jbuild_model(jreduced(jget_arch(arch)))
    init = build_model(cfg, "cpu").init(0)
    jparams = jax.tree_util.tree_map(jnp.asarray, _to_reference_layout(init, cfg))
    assert all(torch.equal(a, _by_path(trainable(init))[p]) for p, a in
               leaves_with_paths(trainable(params_from_jax(_np(jparams), cfg))))
    jstep = jax.jit(jsteps.make_train_step(jmodel, JAdamWConfig(warmup_steps=1, total_steps=4),
                                           remat=False))
    jopt = jsteps.init_opt_state(jparams)
    tokens = jnp.asarray(_step_batch(cfg)["tokens"].numpy().astype(np.int32))
    losses = []
    for _ in range(steps):
        jparams, jopt, m = jstep(jparams, jopt, {"tokens": tokens})
        losses.append(float(m["loss"]))
    state = {"params": trainable(params_from_jax(_np(jparams), cfg)),
             "opt": opt_state_from_jax(_np(jopt), cfg)}
    return losses, state


def _np(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, tree)


SHARDED_CASES = [("stablelm-12b", 2, 2, "dp"), ("stablelm-12b", 2, 2, "fsdp_tp"),
                 ("stablelm-12b", 2, 1, "dp"), ("stablelm-12b", 2, 1, "fsdp_tp"),
                 ("stablelm-12b", 4, 2, "dp"), ("stablelm-12b", 4, 2, "fsdp_tp"),
                 ("mixtral-8x22b", 2, 2, "fsdp_tp"), ("mixtral-8x22b", 2, 1, "dp"),
                 ("rwkv6-1.6b", 2, 1, "fsdp_tp"), ("rwkv6-1.6b", 2, 2, "dp")]
#: the reference's single-device step against the port's sharded one: the
#: loss and each f32 state leaf by the bounds ``tests/test_torch_train.py``
#: holds the port's unsharded step to (LOSS_TOL; GRAD_REL of a leaf's
#: largest entry), both sides summing f32 products in other orders
REF_LOSS_REL, REF_STATE_REL = 2e-4, 5e-4


@pytest.mark.parametrize("arch,world,model_axis,strategy", SHARDED_CASES,
                         ids=[f"{a}-w{w}-{w // m}x{m}-{s}" for a, w, m, s in SHARDED_CASES])
def test_sharded_step_matches_one_process(tmp_path, arch, world, model_axis, strategy):
    """Two sharded steps against one process on the whole batch: the loss within 1e-5 relative, each f32 param and
    optimizer leaf within 1e-5 of its largest entry, or within twice the
    distance the one-process step moves when the batch's rows come in
    reverse order, where that is larger: the same gradient summed in
    another order.  Against the reference's own single-device step: the
    loss within 2e-4 relative, each f32 leaf within 5e-4 of its largest
    entry.  Each step's collectives are its plan's.  A tensor-parallel run
    (``fsdp_tp``, ``model`` > 1) meets the 1e-5 bounds step by step, each
    step against the one-process step from the same state, but for the
    param entries whose gradient is within AdamW's eps scale, which may
    move by up to a learning rate; their count is printed
    (:func:`_assert_near_one_process`)."""
    ref_losses, ref_state = _reference_steps(arch)
    out = run_ranks(_sharded_run, world, tmp_path, arch, model_axis, strategy, 2, {})
    lead = out[0]
    _report_exempt(_assert_near_one_process(lead))
    for got, want in zip(lead["losses"], ref_losses):
        assert abs(got - want) <= REF_LOSS_REL * abs(want), (lead["losses"], ref_losses)
    ref_state = _by_path(ref_state)
    for path, a in leaves_with_paths(lead["state"]):
        b = ref_state[path]
        if a.dtype == torch.float32:
            err = float((a - b).abs().max())
            assert err <= REF_STATE_REL * float(b.abs().max()), (path, err)
        else:
            assert torch.equal(a, b), path
    # genuinely distributed: each rank holds exactly its spec's slice of wq
    cfg = get_arch(arch)
    mesh = make_test_mesh(world, model=model_axis)
    full = dict(leaves_with_paths(lead["state"]["params"]))
    wq = lead["wq_path"]
    if wq is not None:
        spec = shd.param_spec(wq, tuple(full[wq].shape), cfg, mesh, strategy == "dp")
        for r in out:
            part = r["local"][wq]
            assert torch.equal(part, full[wq][shd.local_slices(tuple(full[wq].shape), spec, mesh,
                                                               r["coords"])])
            assert part.numel() * world == full[wq].numel()      # its share, no copy
    for r in out:
        _assert_plan_is_the_step(r)
    assert lead["per_step"][0]["all_gather"]["count"] > 0
    assert lead["per_step"][0]["reduce_scatter"]["count"] > 0


def _dots_sharded_run(rank, world, *args):
    """:func:`_sharded_run` under the ``dots`` remat policy (the one-process
    step beside it too)."""
    from repro_torch.distributed.context import using_remat_policy

    with using_remat_policy("dots"):
        return _sharded_run(rank, world, *args)


DOTS_CASES = [("stablelm-12b", 2, 1, "dp"), ("stablelm-12b", 4, 2, "fsdp_tp")]


@pytest.mark.parametrize("arch,world,model_axis,strategy", DOTS_CASES,
                         ids=[f"{a}-w{w}-{w // m}x{m}-{s}" for a, w, m, s in DOTS_CASES])
def test_sharded_step_under_dots_issues_the_plan(tmp_path, arch, world, model_axis, strategy):
    """Under ``dots`` the recompute gathers each layer's weights again (the
    policy saves K1's outputs, never a gathered weight), so every step's
    collectives are ``plan_collectives``' at worlds 2 and 4, as under
    ``full``; the step within the one-process step's bounds (1e-5)."""
    out = run_ranks(_dots_sharded_run, world, tmp_path, arch, model_axis, strategy, 2, {})
    _report_exempt(_assert_near_one_process(out[0]))
    for r in out:
        _assert_plan_is_the_step(r)
    assert out[0]["per_step"][0]["all_gather"]["count"] > out[0]["forward"]["all_gather"]["count"]


MASKED_CASES = [("stablelm-12b", 2, 1, "dp", {}), ("stablelm-12b", 4, 2, "fsdp_tp", {}),
                ("stablelm-12b", 2, 1, "dp", {"grad_accum": 2})]


@pytest.mark.parametrize("arch,world,model_axis,strategy,kw", MASKED_CASES,
                         ids=[f"{a}-w{w}-{w // m}x{m}-{s}{'-accum' if kw else ''}"
                              for a, w, m, s, kw in MASKED_CASES])
def test_sharded_step_takes_the_global_masked_mean(tmp_path, arch, world, model_axis,
                                                   strategy, kw):
    """A mask that keeps a different count on every batch shard: the
    sharded step's loss is the global batch's masked mean, as the
    one-process step's, under the bounds of the unmasked cases."""
    out = run_ranks(_sharded_run, world, tmp_path, arch, model_axis, strategy, 2, kw, True)
    _report_exempt(_assert_near_one_process(out[0]))


@pytest.mark.parametrize("kw", [{}, {"grad_accum": 2}, {"compress_grads": True}],
                         ids=["plain", "grad_accum", "compress"])
def test_sharded_step_at_world_1_is_bit_equal(tmp_path, kw):
    """At world 1 every gather and reduce-scatter is a copy: losses, params
    and optimizer state equal the unsharded step's bit for bit."""
    out = run_ranks(_sharded_run, 1, tmp_path, "gemma2-2b", 1, "dp", 2, kw)[0]
    assert out["losses"] == out["ref_losses"]
    for (path, a), b in zip(leaves_with_paths(out["state"]), leaves(out["ref"])):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    n = len(out["local"])
    # per step and microbatch: each leaf gathered (layers again under remat)
    # and reduce-scattered
    for c in out["per_step"]:
        assert c["reduce_scatter"]["count"] == kw.get("grad_accum", 1) * n
        assert c["all_gather"]["count"] > c["reduce_scatter"]["count"]
    _assert_plan_is_the_step(out)


def test_sharded_step_refuses_an_unsplit_batch(tmp_path):
    out = run_ranks(_unsplit_batch, 2, tmp_path)
    assert all(o == "refused" for o in out)


def _unsplit_batch(rank, world):
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models.build import build_model
    from repro_torch.optim.adamw import AdamWConfig

    cfg = reduced(get_arch("minitron-4b"))
    model = build_model(cfg, "cpu")
    step = steps_mod.make_sharded_train_step(model, AdamWConfig(), make_test_mesh(model=1))
    params = step.shard_params(model.init(0))
    try:
        step(params, step.init_opt_state(params), _step_batch(cfg, b=3))
    except ValueError as e:
        assert "does not split" in str(e)
        return "refused"
    return "ran"


# ---------------------------------------------------------------------------
# pipeline, compressed all-reduce, elastic restore
# ---------------------------------------------------------------------------


def _pipeline_inputs():
    r = np.random.default_rng(0)
    ws = (r.normal(size=(4, 16, 16)) * 0.3).astype(np.float32)
    x = r.normal(size=(8, 16)).astype(np.float32)
    return ws, x


def _pipeline_rank(rank, world):
    from repro_torch.distributed.collectives import CollectiveCounter
    from repro_torch.distributed.pipeline import pipeline_apply

    ws, x = _pipeline_inputs()
    counter = CollectiveCounter()
    y = pipeline_apply(lambda w, h: torch.tanh(h @ w), torch.from_numpy(ws[rank]),
                       torch.from_numpy(x), n_microbatches=4, counter=counter)
    return {"y": y, "counter": counter.snapshot()}


def test_pipeline_matches_the_reference(tmp_path):
    from repro_torch.distributed.pipeline import bubble_fraction

    out = run_ranks(_pipeline_rank, 4, tmp_path)
    ref = _run_ref("""
        import json, jax, jax.numpy as jnp, numpy as np
        from repro.distributed.pipeline import pipeline_apply, bubble_fraction
        r = np.random.default_rng(0)
        ws = (r.normal(size=(4, 16, 16)) * 0.3).astype(np.float32)
        x = r.normal(size=(8, 16)).astype(np.float32)
        mesh = jax.make_mesh((4,), ("pod",))
        y = pipeline_apply(lambda w, h: jnp.tanh(h @ w), jnp.asarray(ws), jnp.asarray(x),
                           mesh=mesh, axis="pod", n_microbatches=4)
        print("RESULT", json.dumps({"y": np.asarray(y).tolist(), "bubble": bubble_fraction(4, 4)}))
    """, n_devices=4)
    ref = json.loads(ref.split("RESULT", 1)[1])
    want = np.asarray(ref["y"], np.float32)
    for o in out:                                   # the outputs reach every rank
        np.testing.assert_allclose(o["y"].numpy(), want, rtol=1e-5, atol=1e-5)
    assert bubble_fraction(4, 4) == ref["bubble"]
    assert out[0]["counter"]["send"]["count"] == 4  # stage 0 sends each microbatch on


def _compress_inputs():
    return np.random.default_rng(3).normal(size=(4, 96)).astype(np.float32) * \
        np.array([[1.0], [0.01], [5.0], [0.3]], np.float32)


def _compress_rank(rank, world):
    from repro_torch.distributed.collectives import MeshGroups
    from repro_torch.optim.compression import compressed_all_reduce

    groups = MeshGroups(make_test_mesh(model=1))
    y = compressed_all_reduce(torch.from_numpy(_compress_inputs()[rank]), groups)
    return {"y": y, "counter": groups.counter.snapshot()}


def test_compressed_all_reduce_matches_the_reference(tmp_path):
    out = run_ranks(_compress_rank, 4, tmp_path)
    ref = _run_ref("""
        import functools, json, jax, jax.numpy as jnp, numpy as np
        from jax.sharding import PartitionSpec as P
        from repro.optim.compression import compressed_psum
        x = np.random.default_rng(3).normal(size=(4, 96)).astype(np.float32) * \\
            np.array([[1.0], [0.01], [5.0], [0.3]], np.float32)
        mesh = jax.make_mesh((4,), ("pod",))
        smap = jax.shard_map if hasattr(jax, "shard_map") else None
        fn = smap(lambda v: compressed_psum(v[0], "pod")[None], mesh=mesh,
                  in_specs=P("pod"), out_specs=P("pod"), check_vma=False)
        y = fn(jnp.asarray(x))
        print("RESULT", json.dumps(np.asarray(y).tolist()))
    """, n_devices=4)
    want = np.asarray(json.loads(ref.split("RESULT", 1)[1]), np.float32)
    for o in out:
        for row in want:
            np.testing.assert_allclose(o["y"].numpy(), row, rtol=1e-6, atol=1e-6)
        gathers = o["counter"]["all_gather"]
        assert gathers["dtypes"] == {"int8": 96, "float32": 4}      # int8 payloads on the wire
        assert gathers["result_bytes"] == 4 * 96 + 4 * 4


def _bf16_minitron():
    """Reduced minitron in bf16: its params bf16, its optimizer state f32."""
    import dataclasses

    return dataclasses.replace(reduced(get_arch("minitron-4b")), dtype="bfloat16")


def _save_world4(rank, world, ckpt):
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models.build import build_model
    from repro_torch.optim.adamw import AdamWConfig

    cfg = _bf16_minitron()
    model = build_model(cfg, "cpu")
    step = steps_mod.make_sharded_train_step(model, AdamWConfig(warmup_steps=1, total_steps=4),
                                             make_test_mesh(model=2), strategy="fsdp_tp")
    params = step.shard_params(model.init(0))
    opt = step.init_opt_state(params)
    params, opt, _ = step(params, opt, _step_batch(cfg))
    bundle = {"params": params, "opt": opt}
    sharded = step.state_sharded(opt)
    CheckpointManager(ckpt).save(1, bundle, sharded=sharded)
    full = sharded.gather(bundle)            # a collective: every rank takes part
    return full if rank == 0 else None


def _restore_world2(rank, world, ckpt):
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.distributed.collectives import MeshGroups
    from repro_torch.distributed.fault import elastic_restore
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models.build import build_model
    from repro_torch.optim.adamw import AdamWConfig

    cfg = _bf16_minitron()
    model = build_model(cfg, "cpu")
    step = steps_mod.make_sharded_train_step(model, AdamWConfig(), make_test_mesh(model=2),
                                             strategy="fsdp_tp")
    opt_like = step.init_opt_state(step.shard_params(model.init(0)))
    sharded = step.state_sharded(opt_like)
    n, restored = elastic_restore(CheckpointManager(ckpt), sharded.like, cfg, step.groups)
    assert isinstance(step.groups, MeshGroups)
    return {"step": n, "local": restored, "full": sharded.gather(restored),
            "slices": sharded.slices()}


def test_elastic_restore_across_world_sizes(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    saved = run_ranks(_save_world4, 4, tmp_path, ckpt)[0]
    out = run_ranks(_restore_world2, 2, tmp_path, ckpt)
    assert {t.dtype for t in leaves(saved["params"])} == {torch.bfloat16}
    assert {t.dtype for t in leaves(saved["opt"]["m"])} == {torch.float32}
    for o in out:
        assert o["step"] == 1
        for (path, a), b in zip(leaves_with_paths(o["full"]), leaves(saved)):
            assert a.dtype == b.dtype and torch.equal(a, b), path
    # each rank of the new mesh holds its slices, read alone
    for o in out:
        idx = dict(leaves_with_paths(saved))
        for (path, part), sl in zip(leaves_with_paths(o["local"]),
                                    flatten_up_to(o["slices"], o["local"])):
            assert torch.equal(part, idx[path][sl]), path


def _restore_reference_ckpt(rank, world, ckpt):
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.distributed.collectives import MeshGroups
    from repro_torch.distributed.fault import elastic_restore

    cfg = reduced(get_arch("minitron-4b"))
    template = {"params": {"embed": torch.empty((512, 64), dtype=torch.bfloat16, device="meta"),
                           "lm_head": torch.empty((64, 512), device="meta"),
                           "final_norm": {"scale": torch.empty(64, device="meta")}},
                "opt": {"step": torch.empty((), dtype=torch.int32, device="meta")}}
    groups = MeshGroups(make_test_mesh(model=2))
    n, restored = elastic_restore(CheckpointManager(ckpt), template, cfg, groups)
    return {"step": n, "coords": groups.coords,
            "local": {p: t.float() if t.dtype == torch.bfloat16 else t
                      for p, t in leaves_with_paths(restored)}}


def test_port_restores_a_reference_sharded_checkpoint(tmp_path):
    """The reference's CheckpointManager saves a tree sharded over 8 host
    devices (4, 2); the port restores it at world 2 (1, 2): each rank's
    leaves are its slices of the reference's, bit for bit."""
    ckpt = tmp_path / "ref_ckpt"
    ref = _run_ref(f"""
        import json, jax, jax.numpy as jnp, numpy as np
        from repro.checkpoint import CheckpointManager
        from repro.configs import get_arch, reduced
        from repro.distributed import sharding as shd
        cfg = reduced(get_arch("minitron-4b"))
        r = np.random.default_rng(7)
        tree = {{"params": {{"embed": jnp.asarray(r.normal(size=(512, 64)), jnp.bfloat16),
                             "lm_head": jnp.asarray(r.normal(size=(64, 512)), jnp.float32),
                             "final_norm": {{"scale": jnp.asarray(r.normal(size=64), jnp.float32)}}}},
                "opt": {{"step": jnp.asarray(5, jnp.int32)}}}}
        mesh = jax.make_mesh((4, 2), ("data", "model"))
        p_sh = shd.param_shardings(jax.eval_shape(lambda: tree["params"]), cfg, mesh)
        tree["params"] = jax.device_put(tree["params"], p_sh)
        assert len(tree["params"]["embed"].sharding.device_set) == 8
        CheckpointManager({str(ckpt)!r}).save(3, tree)
        flat = jax.tree_util.tree_flatten_with_path(tree)[0]
        print("RESULT", json.dumps({{jax.tree_util.keystr(k): np.asarray(v, np.float32).tolist()
                                    for k, v in flat}}))
    """)
    want = {k: torch.tensor(v, dtype=torch.float32) for k, v in
            json.loads(ref.split("RESULT", 1)[1]).items()}
    out = run_ranks(_restore_reference_ckpt, 2, tmp_path, str(ckpt))
    cfg = reduced(get_arch("minitron-4b"))
    mesh = make_test_mesh(2, model=2)
    for o in out:
        assert o["step"] == 3
        for path, got in o["local"].items():
            full = want[path]
            if path.startswith("['params']"):
                spec = shd.param_spec(path, tuple(full.shape), cfg, mesh)
                full = full[shd.local_slices(tuple(full.shape), spec, mesh, o["coords"])]
            assert torch.equal(got.float(), full.reshape(got.shape)), path
    assert out[0]["local"]["['params']['embed']"].shape == (256, 64)   # embed's vocab over model


# ---------------------------------------------------------------------------
# the trainer under a multi-rank launch
# ---------------------------------------------------------------------------


def _train_rank(rank, world, argv, rendezvous):
    """One rank of a torchrun-like launch of the trainer."""
    from repro_torch.launch import train

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    return train.main(argv + ["--dist-init", f"file://{rendezvous}"])


TRAIN_ARGS = ["--device", "cpu", "--preset", "smoke", "--seq", "16", "--batch", "4",
              "--log-every", "0"]


def test_trainer_under_two_ranks_matches_one_process(tmp_path):
    import shutil

    from repro_torch.launch import train

    ckpt = str(tmp_path / "ckpt")
    argv = TRAIN_ARGS + ["--strategy", "dp", "--steps", "3", "--ckpt-dir", ckpt]
    out = run_ranks(_train_rank, 2, tmp_path, argv, str(tmp_path / "rv2"), group=False)
    single = train.main(TRAIN_ARGS + ["--steps", "3"])
    for o in out:
        assert o["steps"] == 3
        for k in ("first_loss", "last_loss"):
            assert abs(o[k] - single[k]) <= STEP_REL * abs(single[k]), (o, single)
    # saved at world 2, resumed at world 1 (sharded) and in one process
    # (unsharded): the same state, so the same next losses
    shutil.copytree(ckpt, str(tmp_path / "ckpt1"))
    one = run_ranks(_train_rank, 1, tmp_path, TRAIN_ARGS + [
        "--strategy", "fsdp_tp", "--steps", "5", "--ckpt-dir", str(tmp_path / "ckpt1"),
        "--resume"], str(tmp_path / "rv1"), group=False)[0]
    plain = train.main(TRAIN_ARGS + ["--steps", "5", "--ckpt-dir", ckpt, "--resume"])
    assert one["steps"] == plain["steps"] == 2
    for k in ("first_loss", "last_loss"):
        assert abs(one[k] - plain[k]) <= STEP_REL * abs(plain[k]), (one, plain)
