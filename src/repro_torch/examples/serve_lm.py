"""Batched serving with continuous batching (the counterpart of
``examples/serve_lm.py``).

    PYTHONPATH=src python -m repro_torch.examples.serve_lm                # on the card
    PYTHONPATH=src python -m repro_torch.examples.serve_lm --device cpu

Runs a stream of variable-length requests through the slot-based engine
(requests join and leave mid-flight), for a dense arch, a sliding-window
arch (ring KV caches) and a hybrid recurrent one, each at the reduced size,
reporting throughput.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import get_arch, reduced
from repro_torch.models import build_model
from repro_torch.serving import ServingEngine


def drive(arch: str, device: str, n_requests: int = 10, slots: int = 4) -> dict:
    cfg = reduced(get_arch(arch))
    model = build_model(cfg, device)
    params = model.init(0)
    engine = ServingEngine(model, params, slots=slots, max_len=96)
    rng = np.random.default_rng(0)
    pending = [
        [int(t) for t in rng.integers(1, cfg.vocab_size, rng.integers(3, 12))]
        for _ in range(n_requests)
    ]
    done = []
    t0 = time.monotonic()
    steps = 0
    while pending or engine.active:
        while pending and engine.free_slots:
            engine.add_request(pending[0], max_new_tokens=int(rng.integers(4, 12)))
            pending.pop(0)
        done.extend(engine.step())
        steps += 1
    dt = time.monotonic() - t0
    toks = sum(len(r.generated) for r in done)
    print(f"{arch:20s} {len(done)} requests, {toks} tokens, {steps} decode steps, "
          f"{toks / dt:.1f} tok/s (slots={slots})")
    return {"arch": arch, "requests": len(done), "tokens": toks, "steps": steps,
            "tok_per_s": toks / dt}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description="continuous batching on the slot engine")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    return [drive("minitron-4b", args.device),        # dense, full KV caches
            drive("mixtral-8x22b", args.device),      # SWA: ring KV caches sized to the window
            drive("recurrentgemma-2b", args.device)]  # hybrid: recurrent states + local attention


if __name__ == "__main__":
    main()
