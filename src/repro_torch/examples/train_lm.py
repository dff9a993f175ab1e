"""End-to-end training driver: train a small LM for a few hundred steps
(the counterpart of ``examples/train_lm.py``).

    PYTHONPATH=src python -m repro_torch.examples.train_lm                   # ~10M params, on the card
    PYTHONPATH=src python -m repro_torch.examples.train_lm --preset 100m     # ~100M params
    PYTHONPATH=src python -m repro_torch.examples.train_lm --device cpu --steps 30

Exercises the production loop on real (synthetic-corpus) data: the
deterministic data pipeline, AdamW with f32 masters + clipping + cosine
schedule, a remat'd model, async checkpointing
(``CheckpointManager``), the straggler monitor.  The checkpoints go to
``--out``/ckpt and the loss curve to ``--out``/loss.csv (``--out``: a fresh
temporary directory by default).  It fails unless the loss falls.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_arch, reduced
from repro_torch.data import DataConfig, Pipeline
from repro_torch.distributed import StragglerMonitor
from repro_torch.launch import steps as steps_mod
from repro_torch.models import build_model
from repro_torch.models.lm import trainable
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.tree import leaves

PRESETS = {
    # (d_model, n_layers, n_heads, kv, d_ff, vocab) ≈ params
    "10m": (256, 6, 4, 2, 1024, 4096),
    "100m": (768, 12, 12, 4, 3072, 16384),
}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="train a small LM on the synthetic corpus")
    ap.add_argument("--preset", choices=PRESETS, default="10m")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--out", default="", help="checkpoint and loss-curve directory "
                                              "(default: a fresh one)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    out = args.out or tempfile.mkdtemp(prefix="repro_torch_train_lm_")

    d, nl, h, kv, ff, v = PRESETS[args.preset]
    cfg = dataclasses.replace(
        reduced(get_arch("minitron-4b")),
        d_model=d, n_layers=nl, n_heads=h, n_kv_heads=kv, head_dim=d // h,
        d_ff=ff, vocab_size=v,
    )
    model = build_model(cfg, args.device)
    params = model.init(0)
    n_params = sum(x.numel() for x in leaves(trainable(params)))
    print(f"model: {n_params / 1e6:.1f}M params "
          f"({cfg.n_layers}L d={cfg.d_model} ff={cfg.d_ff} v={cfg.vocab_size})")

    opt_cfg = AdamWConfig(peak_lr=3e-3, warmup_steps=args.steps // 10, total_steps=args.steps)
    step_fn = steps_mod.make_train_step(model, opt_cfg)   # params and state updated in place
    opt_state = steps_mod.init_opt_state(params)
    data = Pipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                               global_batch=args.batch))
    manager = CheckpointManager(os.path.join(out, "ckpt"), keep=2)
    monitor = StragglerMonitor()

    def bundle():
        return {"params": trainable(params), "opt": opt_state}

    losses = []
    t_start = time.monotonic()
    for step, np_batch in data:
        if step >= args.steps:
            break
        t0 = time.monotonic()
        batch = {"tokens": torch.from_numpy(np_batch["tokens"]).to(model.device)}
        params, opt_state, m = step_fn(params, opt_state, batch)
        losses.append(float(m["loss"]))
        monitor.record(step, time.monotonic() - t0)
        if step % 20 == 0:
            print(f"step {step:4d}  loss {losses[-1]:.4f}  lr {float(m['lr']):.2e}  "
                  f"gnorm {float(m['grad_norm']):.2f}")
        if step and step % 100 == 0:
            manager.save(step, bundle(), blocking=False)
    data.close()
    manager.save(len(losses), bundle())
    manager.wait()

    dt = time.monotonic() - t_start
    with open(os.path.join(out, "loss.csv"), "w") as f:
        f.writelines(f"{i},{loss}\n" for i, loss in enumerate(losses))
    print(f"\n{len(losses)} steps in {dt:.0f}s "
          f"({args.batch * args.seq * len(losses) / dt:.0f} tok/s)")
    print(f"loss: {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"(min {min(losses):.4f}); stragglers flagged: {len(monitor.flagged)}")
    assert losses[-1] < losses[0], "training must reduce the loss"
    return {"out": out, "params": n_params, "losses": losses, "seconds": dt,
            "stragglers": len(monitor.flagged), "device": model.device.type}


if __name__ == "__main__":
    main()
