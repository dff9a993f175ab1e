"""Distribution planner over the production meshes (the counterpart of
``repro.launch.dryrun``, which lowers and compiles every cell with XLA).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-2b --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun            # every cell, both meshes

A planner, not a compiler: for each (arch × shape × mesh) cell of
``all_cells()`` on the 16x16 and 2x16x16 meshes it builds the model on
``meta`` (no storage), takes the strategy the reference takes
(``dp_dominant``), lays the params out by the reference's rules and reports
these fields of the reference's JSON:

* ``status`` (and a skipped cell's ``reason``), ``arch``, ``shape``,
  ``mesh``, ``chips``, ``strategy`` (``dp_only`` / ``fsdp+tp``);
* ``param_bytes_per_device`` (the reference's ``_sharded_bytes``);
* ``collectives``, from the port's own step plan
  (:func:`~repro_torch.launch.steps.plan_collectives`, read from the leaf
  placements the sharded step takes; a test holds it to the collectives a
  step issues): per op the count, operand and result bytes per device.  A
  train step gathers each layer leaf in the forward and again under remat,
  each other leaf once, reduce-scatters every leaf's gradient, all-reduces
  a gradient over the ranks that hold copies of its shard, all-reduces the
  MoE load-balance means and, once, the metrics and the gradient norm.  A
  leaf whose shards all sit on one rank moves nothing.  An ``fsdp+tp`` cell
  computes tensor-parallel over ``model``: each leaf is gathered over the
  fsdp axes only, its ``model`` shard kept local (attention projections
  whose heads a shard would cut excepted), and the plan adds the residual
  stream's all-gathers and reduce-scatters per layer and pass, the
  vocab-parallel embedding's and the loss's collectives.  Prefill and
  decode cells (always ``fsdp+tp``, as the reference's) are the sharded
  serving steps' own plans (``launch.steps.plan_serve``): a prefill of the
  cell's prompt into a cache of its length, or one decode step of one token
  a row against that cache, with the cache laid out by
  ``cache_leaf_sharding`` and its collectives (rwkv6's ``last_*`` rows;
  where ``model`` splits ``head_dim``, a decode step's scores summed over
  ``model``).  ``--seq-parallel`` plans prefill cells with S split over
  ``model`` in blocks of ceil(S/m) (every leaf gathered whole, K/V
  all-gathers, shifts and scan hand-offs; whisper-medium's encoder frames
  split alike, its output gathered once; the cell file ends in ``__sp``);
* ``roofline``, analytical on ``hw.H100``'s peaks (not a measurement):
  ``compute_analytic_s`` as the reference's (8·N·tokens for a train step
  under full remat, 6·N·tokens under ``--remat-policy dots``, which
  recomputes no matmul, 2·N·tokens otherwise, N the active params, over
  the chips' bf16 peak); ``memory_s``, the weight bytes a device touches
  over its HBM rate (the gathered weights read once per pass, a
  tensor-parallel leaf at its ``model`` shard's size — three
  passes for a train step: forward, recompute, backward; two under
  ``dots``, whose recompute reads no weight — the weight gradient written
  once, and the local AdamW update: 28 bytes per local bf16 param; a
  decode cell also reads the rank's cache shard once, ``cache_bytes_per_
  device``; activations not counted); ``collective_s``, the operand bytes over
  one GPU's NVLink rate (18 links, the NVLink domain's; a 256-chip mesh
  spans many such domains, so this is a lower bound); ``dominant``.

The fields only a compiler gives (``lower_s``, ``compile_s``,
``memory_analysis``, ``cost_analysis``) are left out.  Results go to
``benchmarks/results/dryrun_torch/`` (one JSON per cell, a cache: cells
already there are read back unless ``--force``; a ``dots`` cell's name ends
in ``__dots``).  Each cell records its ``remat_policy``; the collectives
are the same under both, since ``dots`` gathers a layer's weights again in
its recompute.
"""
from __future__ import annotations

import argparse
import json
import math
import os

from repro_torch.configs.base import all_cells, get_arch, get_shape, shape_applicable
from repro_torch.distributed import sharding as shd
from repro_torch.hw.specs import H100
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.distributed.collectives import MODEL_AXIS, leaf_placement
from repro_torch.launch.steps import _cache_like, plan_collectives, plan_serve
from repro_torch.models.build import build_model
from repro_torch.models.lm import trainable
from repro_torch.tree import flatten_up_to, leaves, leaves_with_paths, unflatten

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "benchmarks", "results", "dryrun_torch")
#: the train step's AdamW traffic per local param: the bf16 gradient read,
#: m, v and the f32 master read and written, the bf16 param written
ADAMW_BYTES_PER_PARAM = 2 + 3 * 2 * 4 + 2


def run_cell(arch_name: str, shape_name: str, multi_pod: bool, *, remat: bool = True,
             remat_policy_name: str = "full", grad_accum: int = 1,
             seq_parallel: bool = False) -> dict:
    cfg = get_arch(arch_name)
    shape = get_shape(shape_name)
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {"status": "skipped", "reason": why}
    seq_parallel = seq_parallel and shape.kind == "prefill"

    mesh = make_production_mesh(multi_pod=multi_pod)
    chips = mesh.size
    params = trainable(build_model(cfg, "cpu").abstract_params())
    dp_only = shd.dp_dominant(cfg, mesh, kind=shape.kind, global_batch=shape.global_batch)
    specs = shd.param_shardings(params, cfg, mesh, dp_only)
    train = shape.kind == "train"
    strategy = "dp" if dp_only else "fsdp_tp"
    cache_bytes = 0
    if train:
        coll = plan_collectives(cfg, params, specs, mesh, train=True, remat=remat,
                                grad_accum=grad_accum, strategy=strategy,
                                batch=(shape.global_batch, shape.seq_len))
    else:
        # the reference's prefill tokens: a vision prefix's patches sit inside S
        text = shape.seq_len - cfg.vision_tokens if shape.kind == "prefill" else shape.seq_len
        coll = plan_serve(cfg, params, specs, mesh, phase=shape.kind,
                          batch=(shape.global_batch, text), max_len=shape.seq_len,
                          seq_parallel=seq_parallel)
        if shape.kind == "decode":
            cache = _cache_like(cfg, shape.global_batch, shape.seq_len)
            cache_bytes = shd.sharded_bytes(
                cache, unflatten(cache, [shd.cache_leaf_sharding(p, tuple(t.shape), cfg, mesh)
                                         for p, t in leaves_with_paths(cache)]), mesh)
    param_bytes = shd.sharded_bytes(params, specs, mesh)
    # the bytes of the weights a device gathers: whole leaves, or under
    # fsdp+tp each leaf's model shard where tensor-parallel compute keeps it
    # (a sequence-parallel prefill gathers every leaf whole)
    full_bytes = 0
    for (path, t), s in zip(leaves_with_paths(params), flatten_up_to(specs, params)):
        local = (MODEL_AXIS,) if not (dp_only or seq_parallel) and \
            shd.tp_keeps_local(path, s, cfg, mesh) else ()
        full_bytes += math.prod(leaf_placement(tuple(t.shape), s, mesh, local).full_shape) \
            * t.element_size()
    local_params = sum(math.prod(shd.local_shape(tuple(t.shape), s, mesh))
                       for t, s in zip(leaves(params), flatten_up_to(specs, params)))

    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    n_active = cfg.active_param_count()
    model_flops = (6 if train else 2) * n_active * tokens
    recompute = train and remat and remat_policy_name == "full"   # dots: no matmul recomputed
    analytic_flops = (8 if recompute else 6 if train else 2) * n_active * tokens
    compute_s = analytic_flops / (chips * H100.peak_flops_bf16)
    if train:
        passes = 3 if recompute else 2
        hbm_bytes = ((passes * full_bytes + full_bytes) * grad_accum
                     + ADAMW_BYTES_PER_PARAM * local_params)
    else:
        hbm_bytes = full_bytes + cache_bytes
    memory_s = hbm_bytes / H100.hbm_bandwidth
    collective_s = coll["total_operand_bytes"] / (H100.ici_bandwidth * H100.ici_links)
    return {
        "status": "ok",
        "arch": arch_name,
        "shape": shape_name,
        "mesh": mesh.name,
        "chips": chips,
        "strategy": "dp_only" if dp_only else "fsdp+tp",
        "remat_policy": remat_policy_name,
        "seq_parallel": seq_parallel,
        "collectives": coll,
        "param_bytes_per_device": param_bytes,
        "cache_bytes_per_device": cache_bytes,
        "roofline": {
            "compute_s": compute_s,
            "compute_analytic_s": compute_s,
            "memory_s": memory_s,
            "collective_s": collective_s,
            "dominant": max([("compute", compute_s), ("memory", memory_s),
                             ("collective", collective_s)], key=lambda kv: kv[1])[0],
            "model_flops_total": model_flops,
            "hw": H100.name,
        },
    }


def cell_path(arch: str, shape: str, mesh: str, remat_policy_name: str = "full",
              seq_parallel: bool = False) -> str:
    os.makedirs(RESULTS_DIR, exist_ok=True)
    suffix = "" if remat_policy_name == "full" else f"__{remat_policy_name}"
    if seq_parallel and get_shape(shape).kind == "prefill":
        suffix += "__sp"
    return os.path.join(RESULTS_DIR, f"{arch}__{shape}__{mesh}{suffix}.json")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="distribution planner over the production meshes")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="both")
    ap.add_argument("--force", action="store_true", help="recompute cached cells")
    ap.add_argument("--remat-policy", choices=["full", "dots"], default="full")
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--seq-parallel", action="store_true",
                    help="prefill cells with S split over model (context parallelism)")
    args = ap.parse_args(argv)

    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    cells = [(a, s) for a, s, _ok, _w in all_cells()
             if (args.arch is None or a == args.arch)
             and (args.shape is None or s == args.shape)]
    counts = {"ok": 0, "skipped": 0}
    for arch, shape in cells:
        for multi in meshes:
            mesh_name = make_production_mesh(multi_pod=multi).name
            path = cell_path(arch, shape, mesh_name, args.remat_policy, args.seq_parallel)
            if os.path.exists(path) and not args.force:
                with open(path) as f:
                    res = json.load(f)
                print(f"[cached] {arch} {shape} {mesh_name}: {res['status']}")
            else:
                res = run_cell(arch, shape, multi, remat_policy_name=args.remat_policy,
                               grad_accum=args.grad_accum, seq_parallel=args.seq_parallel)
                with open(path, "w") as f:
                    json.dump(res, f, indent=1)
                if res["status"] == "ok":
                    r = res["roofline"]
                    print(f"[plan] {arch} {shape} {mesh_name}: {res['strategy']} "
                          f"compute={r['compute_s']*1e3:.2f}ms memory={r['memory_s']*1e3:.2f}ms "
                          f"coll={r['collective_s']*1e3:.2f}ms dom={r['dominant']} "
                          f"params/dev={res['param_bytes_per_device']/2**30:.2f}GiB", flush=True)
                else:
                    print(f"[plan] {arch} {shape} {mesh_name}: skipped: {res['reason']}")
            counts[res["status"]] += 1
    print(f"\nplanner summary: ok={counts['ok']} skipped={counts['skipped']}")
    return counts


if __name__ == "__main__":
    main()
