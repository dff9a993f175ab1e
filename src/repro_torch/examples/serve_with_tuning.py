"""Cold-start serving with background schedule upgrades (the counterpart of
``examples/serve_with_tuning.py``).

    PYTHONPATH=src python -m repro_torch.examples.serve_with_tuning
    PYTHONPATH=src python -m repro_torch.examples.serve_with_tuning --registry DIR

Demonstrates the online schedule-registry service end to end:

1. auto-schedule a *donor* arch and publish its records to a segmented
   :class:`~repro_torch.service.ScheduleRegistry` (``--registry``: a fresh
   temporary directory by default);
2. serve a *target* arch's kernel stream cold through a
   :class:`~repro_torch.service.TuningService`: first requests run untuned
   or on probed transfer candidates while background transfer-tuning jobs
   run on a worker pool;
3. watch later requests upgrade to exact hits as jobs publish, and print the
   service telemetry.

Analytical: every time is the cost model's, of the default target (model
milliseconds, virtual search seconds); no device is touched.
"""
from __future__ import annotations

import argparse
import tempfile

from repro_torch.core.runner import AnalyticalRunner, CachedRunner
from repro_torch.core.tuner import arch_uses, tune_arch_registry
from repro_torch.service import ScheduleRegistry, TuningService

DONOR, TARGET = "internvl2-26b", "stablelm-12b"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="cold-start serving with background upgrades")
    ap.add_argument("--registry", default="", help="registry directory (default: a fresh one)")
    args = ap.parse_args(argv)
    root = args.registry or tempfile.mkdtemp(prefix="schedule-registry-")
    registry = ScheduleRegistry(root)

    print(f"tuning donor {DONOR} into registry at {root} ...")
    res = tune_arch_registry(registry, DONOR, dp=16, tp=16, total_trials=512)
    print(f"  {len(res.records)} records published, "
          f"generation {registry.generation}, donor model speedup {res.speedup:.2f}x")

    service = TuningService(registry, model_id=TARGET, donors=[DONOR],
                            runner=CachedRunner(AnalyticalRunner()), max_workers=2)
    uses = arch_uses(TARGET, dp=16, tp=16)
    untuned = sum(u.use_count * service.runner.seconds(u.instance, None) for u in uses)
    print(f"\nserving {TARGET} cold ({len(uses)} kernels, "
          f"untuned {untuned * 1e3:.2f} model-ms):")
    requests = []
    for req in range(4):
        lookups = [service.lookup(u.instance) for u in uses]
        secs = sum(u.use_count * r.seconds for u, r in zip(uses, lookups))
        tiers = {t: sum(1 for r in lookups if r.tier == t)
                 for t in ("exact", "transfer", "default")}
        print(f"  request {req}: {secs * 1e3:.2f} model-ms  tiers={tiers}")
        requests.append({"model_ms": secs * 1e3, "tiers": tiers})
        if req == 1:
            # let the background jobs land mid-stream
            service.drain()
            print("  ... background transfer-tuning jobs drained ...")

    stats = service.stats()
    print(f"\nupgrades published: {stats['upgrades']}  "
          f"exact-hit rate: {stats['exact_hit_rate']:.2f}  "
          f"background search: {stats['search_seconds_spent']:.1f} virtual s  "
          f"registry generation: {stats['generation']}")
    service.close()

    # compaction folds the registry to its steady-state footprint
    before = registry.stats()
    registry.compact()
    after = registry.stats()
    print(f"compaction: {before['records']} records / {before['segments']} segments "
          f"-> {after['records']} records / {after['segments']} segment")
    return {"registry": root, "requests": requests, "stats": stats, "compacted": after}


if __name__ == "__main__":
    main()
