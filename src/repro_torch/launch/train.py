"""Training driver (the counterpart of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b --preset full \
        --batch 4 --seq 512 --steps 6
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --preset smoke
    PYTHONPATH=src torchrun --nproc-per-node 1 -m repro_torch.launch.train --strategy dp \
        --arch gemma2-2b --preset full --batch 4 --seq 512 --steps 6
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train --device cpu \
        --preset smoke --strategy fsdp_tp --mesh-model 2

Loop structure, as the reference's:
  * deterministic data pipeline (the step number is the data cursor, so a
    restart resumes the exact stream);
  * the train step of :mod:`repro_torch.launch.steps`, params and optimizer
    state updated in place;
  * async checkpointing every ``--ckpt-every`` steps (atomic commit) and a
    final save; ``--resume`` restarts from the latest checkpoint;
  * straggler monitor + preemption handler;
  * optional int8 gradient compression and gradient accumulation;
  * transfer-tuned schedules (``--tuning-db``) for the forward's kernels.

It prints and returns the reference's result dict (``first_loss``,
``last_loss``, ``steps``, ``stragglers``).

``--device cuda`` (the default) trains on the card, every op and its
gradient on the port's kernels (K1, K1g, K2, K3 and K4, forward and
backward), for every family.  ``--layers N`` keeps the first N layers
(default: the config's depth; the decoder's for an encoder-decoder arch):
mixtral-8x22b trains at full width with ``--layers 1``, its full depth's
~280 GB of bf16 weights fitting no one card.  The audio and vision archs
take the reference's stub frontend inputs, zero encoder frames or patch
embeddings (:func:`repro_torch.launch.serve.stub_extras`), beside the
tokens.

Sharded training: under ``torchrun`` (``RANK``, ``WORLD_SIZE`` and
``LOCAL_RANK`` in the environment) the trainer joins a process group (NCCL
on ``cuda:LOCAL_RANK`` with ``--device cuda``, gloo on the CPU;
``--dist-init`` overrides torchrun's ``env://``), lays a (world /
``--mesh-model``, ``--mesh-model``) test mesh over it and trains through
:class:`~repro_torch.launch.steps.ShardedTrainStep`, at world 1 too.
``--strategy auto`` follows the reference's ``dp_dominant``; ``dp`` shards
every leaf over the whole mesh and computes on weights gathered whole, one
layer at a time (ZeRO-3); ``fsdp_tp`` takes the reference's layout and
computes tensor-parallel over the ``--mesh-model`` axis: weights gathered
over the fsdp axes only, each rank of a ``model`` row computing its heads,
d_ff slices, channels, experts and vocabulary shard of the row's batch
shard, the residual stream between layers holding D/m columns
(:class:`~repro_torch.distributed.collectives.TensorParallel`).  Each rank
draws the full params from the seed and keeps its shards.  Checkpoints:
rank 0 writes full leaves, and ``--resume`` goes
through :func:`~repro_torch.distributed.fault.elastic_restore`, so a run
resumes at another world size (or in one process).  Rank 0 logs and
prints.  Without ``torchrun`` the trainer runs one process and refuses
``--mesh-model`` above 1 and ``--strategy`` other than ``auto``.

``--tuning-db``: the DB's records for the device's target (``h100`` on the
card, ``tpu-v5e`` on the CPU, the serve launcher's defaults) become the
schedule provider every forward kernel launch resolves through.  The reference
builds this provider and never hands it to its train step, so its tuned
schedules never reach training (ROADMAP §C); here they do.  The backward's
launches take the default schedules of their own instances.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import torch
import torch.distributed as dist

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import get_arch, reduced
from repro_torch.core.database import ScheduleDB
from repro_torch.data import DataConfig, Pipeline
from repro_torch.distributed import PreemptionHandler, StragglerMonitor, elastic_restore
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.context import REMAT_POLICIES, using_remat_policy
from repro_torch.kernels.ops import ScheduleProvider
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.launch.serve import stub_extras
from repro_torch.models.build import build_model
from repro_torch.models.lm import retie, trainable
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.tree import leaves
from repro_torch.targets import DEFAULT_TARGET

#: the target whose tuned records are used, per device
DEFAULT_TARGETS = {"cuda": "h100", "cpu": DEFAULT_TARGET}


def make_provider(path: str, target: str) -> ScheduleProvider | None:
    """The ScheduleDB at ``path``, this target's records, as a static map."""
    if not path:
        return None
    db = ScheduleDB.load(path)
    return ScheduleProvider({r.instance.workload_key(): r.schedule
                             for r in db.records() if r.target == target}, target=target)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="train an assigned architecture")
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--preset", choices=["smoke", "full"], default="smoke")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--tuning-db", default="", help="transfer-tuned ScheduleDB json")
    ap.add_argument("--mesh-model", type=int, default=1)
    ap.add_argument("--strategy", choices=["auto", "dp", "fsdp_tp"], default="auto")
    ap.add_argument("--remat-policy", choices=list(REMAT_POLICIES), default="full")
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--layers", type=int, default=0,
                    help="keep the first N layers (0: the config's depth)")
    ap.add_argument("--dist-init", default="env://",
                    help="init_method of the process group under torchrun")
    args = ap.parse_args(argv)
    distributed = all(k in os.environ for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"))
    if not distributed and (args.mesh_model > 1 or args.strategy != "auto"):
        raise ValueError("sharded training (--mesh-model > 1, --strategy dp/fsdp_tp) runs "
                         "under torchrun (RANK, WORLD_SIZE, LOCAL_RANK)")

    cfg = get_arch(args.arch)
    if args.preset == "smoke":
        cfg = reduced(cfg)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    device = args.device
    if distributed:
        device = _join_group(args)
    try:
        return _train(args, cfg, device, distributed)
    finally:
        if distributed:
            dist.destroy_process_group()


def _join_group(args) -> str:
    """Join torchrun's process group; returns this rank's device."""
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if args.device == "cuda":
        local = int(os.environ["LOCAL_RANK"])
        torch.cuda.set_device(local)
        dist.init_process_group("nccl", init_method=args.dist_init, rank=rank,
                                world_size=world, device_id=torch.device("cuda", local))
        return f"cuda:{local}"
    dist.init_process_group("gloo", init_method=args.dist_init, rank=rank, world_size=world)
    return "cpu"


def _train(args, cfg, device: str, distributed: bool) -> dict:
    model = build_model(cfg, device)
    provider = make_provider(args.tuning_db, DEFAULT_TARGETS[args.device])
    opt_cfg = AdamWConfig(peak_lr=args.lr, warmup_steps=max(args.steps // 10, 2),
                          total_steps=args.steps)
    params = model.init(0)
    lead, sharded = True, None
    if distributed:
        mesh = make_test_mesh(model=args.mesh_model)
        strategy = args.strategy
        if strategy == "auto":
            strategy = ("dp" if shd.dp_dominant(cfg, mesh, kind="train", global_batch=args.batch)
                        else "fsdp_tp")
        step_fn = steps_mod.make_sharded_train_step(
            model, opt_cfg, mesh, strategy=strategy, grad_accum=args.grad_accum,
            compress_grads=args.compress_grads, provider=provider)
        params = step_fn.shard_params(params)
        opt_state = step_fn.init_opt_state(params)
        sharded = step_fn.state_sharded(opt_state)
        lead = step_fn.groups.rank == 0
        if lead:
            print(f"mesh {mesh.name} ({', '.join(mesh.axis_names)}), strategy {strategy}, "
                  f"world {mesh.size}", flush=True)
    else:
        opt_state = steps_mod.init_opt_state(params, compress_grads=args.compress_grads)
        step_fn = steps_mod.make_train_step(model, opt_cfg, grad_accum=args.grad_accum,
                                            compress_grads=args.compress_grads, provider=provider)

    def bundle():
        return {"params": trainable(params), "opt": opt_state}

    start_step = 0
    manager = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    if manager and args.resume and manager.latest_step() is not None:
        if sharded is not None:
            start_step, restored = elastic_restore(manager, sharded.like, cfg, step_fn.groups,
                                                   dp_only=step_fn.dp_only)
            for k in ("params", "opt"):
                _copy_into(bundle()[k], restored[k])
        else:
            start_step, restored = manager.restore(bundle())
            params.update(restored["params"])
            opt_state = restored["opt"]
            retie(params)
        if lead:
            print(f"resumed from step {start_step}")

    data = Pipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                               global_batch=args.batch), start_step=start_step)
    monitor = StragglerMonitor()
    preempt = PreemptionHandler(install_signal=False)

    losses = []
    stubs = {k: torch.from_numpy(v).to(model.device).expand(args.batch, *v.shape).contiguous()
             for k, v in stub_extras(cfg).items()}
    with using_remat_policy(args.remat_policy):
        for step, np_batch in data:
            if step >= args.steps or preempt.requested:
                break
            t0 = time.monotonic()
            batch = {"tokens": torch.from_numpy(np_batch["tokens"]).to(model.device), **stubs}
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            loss = float(metrics["loss"])
            dt = time.monotonic() - t0
            if monitor.record(step, dt) and lead:
                print(f"[straggler] step {step} took {dt:.2f}s (ewma {monitor.ewma:.2f}s)")
            losses.append(loss)
            if args.log_every and step % args.log_every == 0 and lead:
                print(f"step {step:5d} loss {loss:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} {dt*1e3:.0f}ms", flush=True)
            if manager and args.ckpt_every and step and step % args.ckpt_every == 0:
                manager.save(step, bundle(), blocking=sharded is not None, sharded=sharded)
    data.close()
    if manager:
        manager.save(len(losses) + start_step, bundle(), sharded=sharded)
        manager.wait()
    result = {"first_loss": losses[0] if losses else None,
              "last_loss": losses[-1] if losses else None,
              "steps": len(losses), "stragglers": len(monitor.flagged)}
    if lead:
        print(json.dumps(result))
    return result


@torch.no_grad()
def _copy_into(dst, src) -> None:
    """Write a restored tree into the live one, leaf by leaf, in place."""
    for a, b in zip(leaves(dst), leaves(src)):
        a.copy_(b)


if __name__ == "__main__":
    main()
