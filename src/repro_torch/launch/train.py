"""Training driver (the counterpart of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b --preset full \
        --batch 4 --seq 512 --steps 6
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --preset smoke

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

``--device cuda`` (the default) trains on the card, every product and its
gradient on the port's kernels, and raises where there is none.  The MoE,
recurrent and audio archs have no backward kernels on the card yet (ROADMAP
A.8): they train on the CPU.  ``--layers N`` keeps the first N layers
(default: the config's depth).  One process: ``--mesh-model`` above 1 and
``--strategy`` other than ``auto`` raise (ROADMAP A.9).

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
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import get_arch, reduced
from repro_torch.core.database import ScheduleDB
from repro_torch.data import DataConfig, Pipeline
from repro_torch.distributed import PreemptionHandler, StragglerMonitor
from repro_torch.distributed.context import REMAT_POLICIES, set_remat_policy
from repro_torch.kernels.ops import ScheduleProvider
from repro_torch.launch import steps as steps_mod
from repro_torch.models.build import build_model
from repro_torch.models.lm import retie, trainable
from repro_torch.optim.adamw import AdamWConfig
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
    args = ap.parse_args(argv)
    if args.mesh_model > 1 or args.strategy != "auto":
        raise NotImplementedError("sharded training (--mesh-model > 1, --strategy dp/fsdp_tp) "
                                  "waits for the port's distributed training (ROADMAP A.9)")

    cfg = get_arch(args.arch)
    if args.preset == "smoke":
        cfg = reduced(cfg)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    model = build_model(cfg, args.device)
    provider = make_provider(args.tuning_db, DEFAULT_TARGETS[args.device])

    params = model.init(0)
    opt_state = steps_mod.init_opt_state(params, compress_grads=args.compress_grads)
    opt_cfg = AdamWConfig(peak_lr=args.lr, warmup_steps=max(args.steps // 10, 2),
                          total_steps=args.steps)
    step_fn = steps_mod.make_train_step(model, opt_cfg, grad_accum=args.grad_accum,
                                        compress_grads=args.compress_grads, provider=provider)

    start_step = 0
    manager = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    if manager and args.resume and manager.latest_step() is not None:
        start_step, restored = manager.restore({"params": trainable(params), "opt": opt_state})
        params.update(restored["params"])
        opt_state = restored["opt"]
        retie(params)
        print(f"resumed from step {start_step}")

    data = Pipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                               global_batch=args.batch), start_step=start_step)
    monitor = StragglerMonitor()
    preempt = PreemptionHandler(install_signal=False)

    losses = []
    set_remat_policy(args.remat_policy)
    for step, np_batch in data:
        if step >= args.steps or preempt.requested:
            break
        t0 = time.monotonic()
        batch = {"tokens": torch.from_numpy(np_batch["tokens"]).to(model.device)}
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        dt = time.monotonic() - t0
        if monitor.record(step, dt):
            print(f"[straggler] step {step} took {dt:.2f}s (ewma {monitor.ewma:.2f}s)")
        losses.append(loss)
        if args.log_every and step % args.log_every == 0:
            print(f"step {step:5d} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} {dt*1e3:.0f}ms", flush=True)
        if manager and args.ckpt_every and step and step % args.ckpt_every == 0:
            manager.save(step, {"params": trainable(params), "opt": opt_state}, blocking=False)
    data.close()
    if manager:
        manager.save(len(losses) + start_step, {"params": trainable(params), "opt": opt_state})
        manager.wait()
    result = {"first_loss": losses[0] if losses else None,
              "last_loss": losses[-1] if losses else None,
              "steps": len(losses), "stragglers": len(monitor.flagged)}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
