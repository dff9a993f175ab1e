"""Telemetry-driven tuning priority: critical-path seconds x headroom.

A copy of ``repro.fleet.advisor`` (the port imports nothing of ``repro``).

The fleet's original prefetch ordering was demand counts — tune whatever
arrives most.  That conflates *traffic* with *impact*: a hot bucket whose
kernels are already near their attainable speedup outranks a cooler one
whose kernels still run 2x slower than the donor pool suggests they could.
Ansor prioritizes tuning time across subgraphs by estimated end-to-end
impact; the :class:`TuningAdvisor` applies the same idea one level up,
ranking every un-exhausted workload the fleet has actually executed by

    priority = critical-path seconds observed  x  remaining speedup headroom

Critical-path seconds come from the live profiler
(:func:`repro_torch.obs.profiler.live_workload_seconds` — replica cell counters
times plan-derived kernel costs, no tracer required).  Headroom is a *class
prior* estimated from the donor pool: the best donor-record-to-untuned
ratio of the workload's schedule class bounds how much a transfer is likely
to recover, before spending any search on the workload itself (the same
cheap-estimate-steers-expensive-measurement principle as Pruner's
draft stage).  Workloads that already resolved at the exact tier, or whose
background job already ran, are exhausted — the advisor skips them, so
tuning budget always flows to the largest remaining (seconds x headroom)
product.
"""
from __future__ import annotations

import dataclasses

from repro_torch.obs.profiler import live_workload_seconds


@dataclasses.dataclass(frozen=True)
class RankedWorkload:
    """One advisor recommendation, strongest first."""

    instance: object          # KernelInstance to prefetch
    target: str
    critical_s: float         # observed critical-path seconds
    headroom: float           # estimated remaining speedup fraction (0..1)
    priority: float           # critical_s * headroom — the queue priority


class TuningAdvisor:
    """Ranks un-exhausted workloads for :meth:`TuningService.prefetch`.

    ``default_headroom`` is assumed when a class has no donor records to
    estimate from; ``min_headroom`` keeps every candidate's priority
    positive so observed-but-low-headroom work still outranks never-observed
    work instead of dropping to zero (the anti-starvation floor —
    ``TuningService.stats()``'s starvation counters verify it suffices).
    """

    def __init__(self, *, default_headroom: float = 0.5,
                 min_headroom: float = 0.05):
        self.default_headroom = default_headroom
        self.min_headroom = min_headroom
        self._prior_cache: dict[tuple[str, str], float] = {}

    def class_headroom(self, instance, svc, db) -> float:
        """Prior speedup headroom for ``instance``'s schedule class.

        ``1 - min(donor seconds / untuned seconds)`` over the service's
        donor pool for the class: if the best donor of this class reached a
        3x speedup on its own workload, a transfer plausibly recovers most
        of a similar ratio here.  Cached per (class, target) — the donor
        pool is fixed for a service's lifetime.
        """
        key = (instance.class_id, svc.target)
        h = self._prior_cache.get(key)
        if h is None:
            ratios = []
            for rec in db.by_class(instance.class_id,
                                   models=svc.donor_models(db),
                                   target=svc.donor_target):
                untuned = svc.runner.seconds(rec.instance, None)
                if untuned > 0:
                    ratios.append(rec.seconds / untuned)
            h = (1.0 - min(ratios)) if ratios else self.default_headroom
            h = self._prior_cache[key] = min(max(h, self.min_headroom), 1.0)
        return h

    def rank(self, fleet) -> list[RankedWorkload]:
        """Rank every executed, un-exhausted workload, highest priority
        first (ties broken by workload key for determinism)."""
        crit = live_workload_seconds(fleet.live_replicas())
        services = fleet.services
        snaps: dict = {}
        out = []
        for (key, target), row in crit.items():
            svc = services.get(target)
            if svc is None:
                continue
            db = snaps.get(target)
            if db is None:
                db = snaps[target] = svc.registry.snapshot().db(None)
            inst = row["instance"]
            if db.exact(inst, target=svc.target) is not None:
                continue  # exhausted: already serving an exact record
            if svc.attempted(key):
                continue  # exhausted: search ran, found nothing better
            h = self.class_headroom(inst, svc, db)
            out.append(RankedWorkload(inst, target, row["seconds"], h,
                                      row["seconds"] * h))
        out.sort(key=lambda r: (-r.priority, r.instance.workload_key()))
        return out
