"""Speedup ledger: realized vs attainable speedup, per workload, live.

A copy of ``repro.obs.ledger`` (the port imports nothing of ``repro``).

The paper's headline metric is the fraction of the auto-scheduler's maximum
speedup that transfer-tuning realizes.  Offline, ``transfer_arch`` computes
it once per run; this ledger computes it *continuously* over a serving
fleet.  For every (workload, target) pair the fleet actually executes it
tracks three per-execution costs under the shared cost model:

* ``untuned_s`` — the default schedule (the denominator of every speedup);
* ``served_s``  — what the replicas' *current* plans actually charge,
  tagged with the resolution tier and donor that produced it;
* ``best_s``    — the best published registry record re-priced under the
  serving mode (None while the workload has no exact-tier record).

Weighted by observed critical-path executions (the replicas' cell counters
times each kernel's use count), the aggregates answer the closed-loop
question directly::

    realized_speedup   = sum(w * untuned) / sum(w * served)
    attainable_speedup = sum(w * untuned) / sum(w * best-or-served)
    realized_fraction  = sum(w * best-or-served) / sum(w * served)

``realized_fraction`` is the paper's metric: 1.0 means every served kernel
already runs its best known schedule — a fully-drained fleet must land
exactly there, and ``bench_slo`` gates that the ledger's numbers for a
drained fleet match an offline :func:`~repro_torch.core.transfer.transfer_tune`
run against the same donor registry.  All costs are the cost model's
*virtual* seconds — the same seconds the virtual clock charges and the
tuner optimizes, so ledger speedups and serving latency move together by
construction (DESIGN.md §12 discusses why).
"""
from __future__ import annotations

import dataclasses

from .metrics import MetricsRegistry
from .tracer import NULL_TRACER


@dataclasses.dataclass
class LedgerEntry:
    """One (workload, target) row of the ledger."""

    key: str
    target: str
    class_id: str
    tier: str                  # resolution tier currently serving it
    source_model: str          # donor provenance of the served schedule
    untuned_s: float           # per single kernel execution
    served_s: float
    best_s: float | None       # None -> no exact-tier record published yet
    weight: float = 0.0        # observed executions x use_count

    @property
    def realized_speedup(self) -> float:
        return self.untuned_s / self.served_s if self.served_s else 1.0

    @property
    def attainable_speedup(self) -> float:
        best = self.best_s if self.best_s is not None else self.served_s
        return self.untuned_s / best if best else 1.0

    @property
    def headroom_s(self) -> float:
        """Per-execution seconds still on the table vs the best record."""
        best = self.best_s if self.best_s is not None else self.served_s
        return max(0.0, self.served_s - best)


class SpeedupLedger:
    """Tracks realized vs attainable speedup per (workload, target).

    :meth:`update` rebuilds the ledger from the live replicas — every cell
    the fleet has executed (plus the decode cell every request exercises),
    priced under the replicas' current plans and the registry's current
    best records — then samples the aggregate gauges
    (``ledger.realized_speedup`` / ``.attainable_speedup`` /
    ``.realized_fraction`` / ``.workloads`` / ``.tuned_workloads``) and,
    when tracing, emits one ``ledger`` event on the ``ledger`` track.  The
    fleet calls it on the same cadence as its tuning-drain bursts, so the
    gauges move the instant a publish lands.
    """

    TRACK = "ledger"

    def __init__(self, *, metrics: MetricsRegistry | None = None,
                 tracer=None):
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.entries: dict[tuple[str, str], LedgerEntry] = {}
        self._gauges = {
            name: self.metrics.gauge(f"ledger.{name}")
            for name in ("realized_speedup", "attainable_speedup",
                         "realized_fraction", "workloads", "tuned_workloads")}

    # -- building --------------------------------------------------------------
    def update(self, replicas, now: float = 0.0) -> dict:
        """Rebuild from live replica state; returns :meth:`aggregates`."""
        entries: dict[tuple[str, str], LedgerEntry] = {}
        snaps: dict = {}
        for r in replicas:
            svc = r.service
            db = None
            if svc is not None:
                db = snaps.get(r.target)
                if db is None:
                    db = snaps[r.target] = svc.registry.snapshot().db(None)
            cells = set(getattr(r, "cell_counts", ())) | {"decode"}
            for cell in cells:
                execs = r.cell_counts.get(cell, 0)
                for u in r.cell_uses(cell):
                    key = (u.instance.workload_key(), r.target)
                    e = entries.get(key)
                    if e is None:
                        res = r.use_resolution(u.instance)
                        served = r.use_seconds(u.instance, res.schedule)
                        untuned = r.use_seconds(u.instance, None)
                        best_rec = (db.exact(u.instance, target=r.target)
                                    if db is not None else None)
                        best = (r.use_seconds(u.instance, best_rec.schedule)
                                if best_rec is not None else None)
                        e = entries[key] = LedgerEntry(
                            key=key[0], target=r.target,
                            class_id=u.instance.class_id, tier=res.tier,
                            source_model=res.source_model, untuned_s=untuned,
                            served_s=served, best_s=best)
                    e.weight += execs * u.use_count
        self.entries = entries
        agg = self.aggregates()
        for name, g in self._gauges.items():
            g.sample(float(agg[name]), now)
        if self.tracer.enabled:
            self.tracer.event("ledger", self.TRACK, t=now, **agg)
        return agg

    # -- aggregates ------------------------------------------------------------
    def aggregates(self) -> dict:
        """Fleet-wide weighted rollup (weights fall back to 1 per workload
        before any traffic has executed)."""
        rows = list(self.entries.values())
        total_w = sum(e.weight for e in rows)
        w_of = (lambda e: e.weight) if total_w > 0 else (lambda e: 1.0)
        un = sum(w_of(e) * e.untuned_s for e in rows)
        sv = sum(w_of(e) * e.served_s for e in rows)
        bt = sum(w_of(e) * (e.best_s if e.best_s is not None else e.served_s)
                 for e in rows)
        tiers: dict[str, int] = {}
        for e in rows:
            tiers[e.tier] = tiers.get(e.tier, 0) + 1
        return {
            "workloads": len(rows),
            "tuned_workloads": sum(1 for e in rows if e.best_s is not None),
            "realized_speedup": un / sv if sv else 1.0,
            "attainable_speedup": un / bt if bt else 1.0,
            "realized_fraction": bt / sv if sv else 1.0,
            "headroom_s": sum(w_of(e) * e.headroom_s for e in rows),
            "tiers": tiers,
        }

    def speedup_for(self, uses, target: str) -> dict:
        """Ledger-side speedup over an explicit workload set, weighted by
        ``use_count`` — the exact aggregation :func:`~repro_torch.core.transfer.\
transfer_tune` reports, so a drained fleet's number is directly comparable
        to the offline ``TransferResult.speedup`` for the same uses and
        registry (``bench_slo`` gate c)."""
        un = sv = bt = 0.0
        missing = []
        for u in uses:
            e = self.entries.get((u.instance.workload_key(), target))
            if e is None:
                missing.append(u.instance.workload_key())
                continue
            w = u.use_count
            un += w * e.untuned_s
            sv += w * e.served_s
            bt += w * (e.best_s if e.best_s is not None else e.served_s)
        return {
            "untuned_s": un, "served_s": sv, "best_s": bt,
            "realized_speedup": un / sv if sv else 1.0,
            "attainable_speedup": un / bt if bt else 1.0,
            "realized_fraction": bt / sv if sv else 1.0,
            "missing": missing,
        }

    def top_headroom(self, n: int = 5) -> list[LedgerEntry]:
        """Entries with the most weighted seconds left on the table."""
        return sorted(self.entries.values(),
                      key=lambda e: -e.weight * e.headroom_s)[:n]

    def summary(self) -> dict:
        out = self.aggregates()
        out["top_headroom"] = [
            {"key": e.key, "target": e.target, "tier": e.tier,
             "weight": e.weight, "headroom_s": e.weight * e.headroom_s}
            for e in self.top_headroom()]
        return out
