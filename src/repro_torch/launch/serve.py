"""Serving entry point: batched inference with continuous batching (the
counterpart of ``repro.launch.serve``).

Builds a (reduced or full) arch with random weights from ``--seed``'s
``torch.Generator`` on the device, runs a stream of seeded requests through
the slot engine and prints one JSON object: throughput, token counts and each
kernel's launch count.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch minitron-4b --preset full
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b --preset full
    PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-2b --preset full
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --preset smoke
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --preset smoke --arch rwkv6-1.6b

``--device cuda`` (the default) runs on the card and raises where there is
none; ``--backend ref`` runs the plain PyTorch versions instead of the CUDA
kernels.  Schedule-database and tuning-service flags wait for the slice that
ports the resolution pipeline.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs.base import ARCH_IDS, get_arch, reduced
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import matmul as mm
from repro_torch.kernels import rglru_scan as rg
from repro_torch.kernels import rwkv6_scan as rw
from repro_torch.kernels.ops import BACKENDS, use_backend
from repro_torch.models.build import build_model
from repro_torch.serving import ServingEngine, SlotsFull


def sample_prompts(rng: np.random.Generator, n: int, vocab_size: int, *,
                   lo: int = 3, hi: int = 8) -> list[list[int]]:
    """``n`` random-token prompts with uniform[lo, hi] lengths (a copy of
    ``repro.fleet.traffic.sample_prompts``: same seed, same prompts)."""
    return [[int(t) for t in rng.integers(1, vocab_size,
                                          size=int(rng.integers(lo, hi + 1)))]
            for _ in range(n)]


def kernel_launches() -> dict[str, int]:
    return {"matmul": mm.launches, "flash_attention": fa.launches,
            "rwkv6_scan": rw.launches, "rglru_scan": rg.launches}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="serve an architecture on the port")
    ap.add_argument("--arch", default="minitron-4b", choices=list(ARCH_IDS))
    ap.add_argument("--preset", choices=["smoke", "full"], default="smoke")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0,
                    help="request-stream seed (weights come from seed 0, as in the reference)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--backend", choices=list(BACKENDS), default="cuda")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.preset == "smoke":
        cfg = reduced(cfg)
    model = build_model(cfg, args.device)
    params = model.init(seed=0)
    engine = ServingEngine(model, params, slots=args.slots, max_len=args.max_len)

    rng = np.random.default_rng(args.seed)
    pending = sample_prompts(rng, args.requests, cfg.vocab_size)
    launches0 = kernel_launches()
    done, steps = [], 0
    t0 = time.monotonic()
    with use_backend(args.backend):
        while pending or engine.active:
            while pending and engine.free_slots:
                try:
                    req = engine.add_request(pending[0], max_new_tokens=args.new_tokens)
                except SlotsFull:
                    break
                pending.pop(0)
                if req.done:  # finished by the prefill itself
                    done.append(req)
            done.extend(engine.step())
            steps += 1
            if steps > 10_000:
                raise RuntimeError("serving did not converge")
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    dt = time.monotonic() - t0
    toks = sum(len(r.generated) for r in done)
    launches = {k: v - launches0[k] for k, v in kernel_launches().items()}
    result = {"arch": cfg.name, "preset": args.preset, "device": str(model.device),
              "backend": args.backend, "requests": len(done), "decode_steps": steps,
              "tokens": toks, "tok_per_s": toks / dt,
              "prefill_shapes": engine.prefill_shape_count,
              "kernel_launches": launches}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
