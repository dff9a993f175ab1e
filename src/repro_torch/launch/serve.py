"""Serving entry point: batched inference with continuous batching (the
counterpart of ``repro.launch.serve``).

Builds a (reduced or full) arch with random weights from ``--seed``'s
``torch.Generator`` on the device, runs a stream of seeded requests through
the slot engine and prints one JSON object: throughput, token counts and each
kernel's launch count.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch minitron-4b --preset full
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b --preset full
    PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-2b --preset full
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x22b --preset smoke
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --preset smoke
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --preset smoke --arch rwkv6-1.6b
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --preset smoke --arch mixtral-8x22b

The MoE archs (mixtral-8x22b, dbrx-132b) run ``--preset smoke`` only: at
full depth their bf16 weights (~280 GB, ~264 GB) fit no one card.

``--device cuda`` (the default) runs on the card and raises where there is
none; ``--backend ref`` runs the plain PyTorch versions instead of the CUDA
kernels.

Schedule resolution, as in the reference (``repro.launch.serve``):

* ``--tuning-db db.json`` — a frozen ScheduleDB, this target's records
  installed as a static map;
* ``--tuning-registry DIR`` — kernels resolve through a
  :class:`~repro_torch.service.TuningService` over a
  :class:`~repro_torch.service.ScheduleRegistry`: exact hits, transfers
  probed from same-class donors, background transfer-tuning jobs that
  publish upgrades the engine adopts at a decode-step boundary.

Either way the engine holds an ExecutionPlan for its serving shapes, and
the result JSON reports per-tier resolution counts, the plan's tiers,
re-plans and the service's stats.  ``--target`` names the hardware
namespace served: ``h100`` by default on ``--device cuda``, whose schedules
are timed on the card by ``CachedRunner(MeasuredRunner())``; ``tpu-v5e`` by
default on the CPU, where a measured target is refused (a CPU time never
wears the card's name).  On a measured target the service runs its jobs
deferred and drains them at exit: ``--tuning-workers`` above 0 is refused
there, because a worker timing kernels on the card while the engine serves
would share the device and skew both its timings and the serve times.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-2b --preset full \
        --tuning-registry /path/to/registry
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --preset smoke \
        --tuning-registry /path/to/registry --target tpu-v5e
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs.base import ARCH_IDS, get_arch, reduced
from repro_torch.core.database import ScheduleDB
from repro_torch.core.measured_runner import target_runner
from repro_torch.core.runner import MEASURED_TARGETS
from repro_torch.fleet.traffic import sample_prompts
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import matmul as mm
from repro_torch.kernels import rglru_scan as rg
from repro_torch.kernels import rwkv6_scan as rw
from repro_torch.kernels.ops import BACKENDS, ScheduleProvider, set_default_provider, use_backend
from repro_torch.models.build import build_model
from repro_torch.serving import ServingEngine, SlotsFull
from repro_torch.targets import DEFAULT_TARGET, list_targets

#: the target served when none is given, per device
DEFAULT_TARGETS = {"cuda": "h100", "cpu": DEFAULT_TARGET}


def make_provider(args) -> tuple[ScheduleProvider, object | None]:
    """Build the schedule provider (and the service, when online) from
    ``args`` (``target``, ``device``, ``tuning_db``, ``tuning_registry``,
    ``tuning_workers``, ``tuning_budget_s``, ``tuning_donor_target``, ``arch``).

    A measured target (``h100``) is served only on the card, by a service
    whose runner times kernels there (``CachedRunner(MeasuredRunner())``) and
    whose jobs are deferred (``max_workers=0``): a background worker timing
    kernels on the card while the engine serves would share the device and
    its stream hold, so both its timings and the serve times would be wrong.
    Drain the jobs between requests or at exit (``service.drain()``)."""
    measured = args.target in MEASURED_TARGETS
    if measured and args.device != "cuda":
        raise ValueError(f"target {args.target!r} is timed on the card: serve it with "
                         "--device cuda, or name a modelled target (e.g. tpu-v5e) on the CPU")
    workers = args.tuning_workers
    if workers is None:
        workers = 0 if measured else 2
    if measured and workers > 0:
        raise ValueError(f"--tuning-workers {workers} on the measured target {args.target!r}: "
                         "a worker timing kernels on the card while the engine serves skews "
                         "both; pass --tuning-workers 0 (jobs drain at exit)")
    service = None
    schedule_map = {}
    if args.tuning_db:
        db = ScheduleDB.load(args.tuning_db)
        # only this target's namespace: a record tuned for another chip never
        # serves here, even through the frozen offline path
        schedule_map = {r.instance.workload_key(): r.schedule
                        for r in db.records() if r.target == args.target}
    if args.tuning_registry:
        from repro_torch.service import ScheduleRegistry, TuningService

        registry = ScheduleRegistry(args.tuning_registry)
        service = TuningService(registry, model_id=f"serve/{args.arch}",
                                runner=target_runner(args.target, args.device),
                                max_workers=workers, budget_s=args.tuning_budget_s,
                                target=args.target, donor_target=args.tuning_donor_target)
    return ScheduleProvider(schedule_map, service=service, target=args.target), service


def kernel_launches() -> dict[str, int]:
    return {"matmul": mm.launches, "grouped_matmul": mm.grouped_launches,
            "flash_attention": fa.launches, "rwkv6_scan": rw.launches, "rglru_scan": rg.launches}


def parse_args(argv=None) -> argparse.Namespace:
    """The entry point's arguments, ``--target`` defaulted per device."""
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
    ap.add_argument("--target", choices=list_targets(), default=None,
                    help="hardware target whose schedules are served (default: h100 on "
                         "--device cuda, tpu-v5e on the CPU); the tuning service reads and "
                         "publishes only this chip's namespace")
    ap.add_argument("--tuning-donor-target", choices=list_targets(), default=None,
                    help="draw transfer donors from another chip's namespace "
                         "(cross-target serving; default: --target)")
    ap.add_argument("--tuning-db", default="")
    ap.add_argument("--tuning-registry", default="",
                    help="schedule-registry dir: serve through a TuningService")
    ap.add_argument("--tuning-workers", type=int, default=None,
                    help="background tuning threads (default 2; 0, jobs deferred and "
                         "drained at exit, on a measured target, which refuses more)")
    ap.add_argument("--tuning-budget-s", type=float, default=float("inf"),
                    help="search seconds for background tuning jobs")
    args = ap.parse_args(argv)
    if args.target is None:
        args.target = DEFAULT_TARGETS[args.device]
    return args


def main(argv=None) -> dict:
    args = parse_args(argv)
    cfg = get_arch(args.arch)
    if args.preset == "smoke":
        cfg = reduced(cfg)
    provider, service = make_provider(args)
    model = build_model(cfg, args.device)
    params = model.init(seed=0)
    prev_provider = set_default_provider(provider)

    rng = np.random.default_rng(args.seed)
    pending = sample_prompts(rng, args.requests, cfg.vocab_size)
    launches0 = kernel_launches()
    done, steps = [], 0
    try:
        # the provider (and so plan building, which runs service lookups and
        # queues tuning jobs) serves the kernels only: the plain versions
        # never consult a schedule
        engine = ServingEngine(model, params, slots=args.slots, max_len=args.max_len,
                               provider=provider if args.backend == "cuda" else None)
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
    finally:
        set_default_provider(prev_provider)
        if service is not None:
            # also on error paths: a live worker pool with queued jobs would
            # keep the process alive after a serving failure
            service.close()
    toks = sum(len(r.generated) for r in done)
    launches = {k: v - launches0[k] for k, v in kernel_launches().items()}
    result = {"arch": cfg.name, "preset": args.preset, "device": str(model.device),
              "backend": args.backend, "requests": len(done), "decode_steps": steps,
              "tokens": toks, "tok_per_s": toks / dt, "target": args.target,
              "schedule_hits": provider.hits, "schedule_misses": provider.misses,
              "resolution": provider.stats(), "replans": engine.replans,
              "prefill_shapes": engine.prefill_trace_count,
              "kernel_launches": launches}
    if engine.plan is not None:
        result["plan"] = {"entries": len(engine.plan), "generation": engine.plan.generation,
                          "tiers": engine.plan.tier_counts()}
    if service is not None:
        result["tuning_service"] = service.stats()
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
