"""Declarative SLOs with multi-window burn-rate alerting.

A copy of ``repro.obs.slo`` (the port imports nothing of ``repro``).

PR 8 made the fleet observable; this module makes the observations
*actionable*.  An :class:`SLO` declares a compliance objective over the
served traffic — "95% of requests finish within 40 ticks", "at most 2% of
requests are shed" — and an :class:`SLOMonitor` evaluates every declared
objective at a fixed cadence over the same :class:`~repro_torch.fleet.metrics.\
FleetMetrics` windows the autoscaler consumes.

Alerting follows the SRE multi-window burn-rate recipe: the error *budget*
of an objective is ``1 - objective`` (the fraction of requests allowed to be
bad), and the *burn rate* of a window is ``bad_fraction / budget`` — burn 1.0
means the budget is being spent exactly as fast as it accrues.  An alert
fires only when **both** a fast window (recent, catches regressions quickly)
and a slow window (longer, rejects one-sample blips) burn above
``burn_alert``; it clears when either stops burning.  Every state transition
is recorded as a trace event on the ``slo`` track, and the current burn
rates / alert state are sampled into registry gauges
(``slo.<name>.burn_fast`` / ``.burn_slow`` / ``.alerting``), so both the
live autoscaler and offline ``trace_report`` read the same signal.

The monitor is deliberately pull-based and windowed — it re-derives
good/bad counts from the request outcomes inside each window rather than
keeping its own counters — so replaying a trace through
:class:`~repro_torch.fleet.ServingFleet` reproduces the alert timeline exactly.
"""
from __future__ import annotations

import dataclasses

from .metrics import MetricsRegistry
from .tracer import NULL_TRACER

#: SLO kinds and the request outcome that counts against the budget.
KINDS = ("latency", "ttft", "shed", "deadline")


@dataclasses.dataclass(frozen=True)
class SLO:
    """One declarative service-level objective.

    ``objective`` is the compliance target (0..1): the fraction of seen
    requests that must be *good*.  What "good" means depends on ``kind``:

    * ``latency`` — finished, with arrival→finish latency <= ``threshold_s``;
    * ``ttft`` — finished, with arrival→first-token time <= ``threshold_s``;
    * ``shed`` — not shed (``threshold_s`` unused);
    * ``deadline`` — finished before its deadline (requests without a
      deadline count good; ``threshold_s`` unused).

    Shed requests count *bad* for every kind — a request the fleet dropped
    never met any latency objective.  ``fast_windows`` / ``slow_windows``
    size the two burn-rate windows in multiples of the monitor's base
    window; ``burn_alert`` is the burn-rate threshold both must exceed.
    """

    name: str
    kind: str
    objective: float = 0.95
    threshold_s: float | None = None
    fast_windows: int = 1
    slow_windows: int = 4
    burn_alert: float = 1.0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown SLO kind {self.kind!r}: one of {KINDS}")
        if not 0.0 < self.objective < 1.0:
            raise ValueError("objective must be in (0, 1)")
        if self.kind in ("latency", "ttft") and self.threshold_s is None:
            raise ValueError(f"SLO kind {self.kind!r} needs threshold_s")
        if self.fast_windows < 1 or self.slow_windows < self.fast_windows:
            raise ValueError("need 1 <= fast_windows <= slow_windows")

    @property
    def budget(self) -> float:
        """Error budget: the allowed bad fraction."""
        return 1.0 - self.objective

    def is_bad(self, req) -> bool:
        """Whether one seen request spends error budget."""
        if req.shed:
            return True
        if self.kind == "latency":
            return (req.latency_s or 0.0) > self.threshold_s
        if self.kind == "ttft":
            first = (req.prefill_done_s if req.prefill_done_s is not None
                     else req.finished_s)
            return first is not None and \
                first - req.arrival_s > self.threshold_s
        if self.kind == "deadline":
            return (req.deadline_s is not None
                    and req.finished_s is not None
                    and req.finished_s > req.deadline_s)
        return False  # kind == "shed": completions are good by definition


@dataclasses.dataclass(frozen=True)
class SLOStatus:
    """One monitor evaluation of one SLO."""

    t: float
    name: str
    burn_fast: float
    burn_slow: float
    seen_fast: int        # requests inside the fast window (0 -> no signal)
    alerting: bool
    changed: bool         # did this evaluation flip the alert state?


class SLOMonitor:
    """Evaluates a set of :class:`SLO` objectives over fleet windows.

    ``fleet_metrics`` supplies the request outcomes (its ``completed`` /
    ``shed`` lists, binned by finish / shed instant — the same binning
    :meth:`~repro_torch.fleet.metrics.FleetMetrics.window` uses); ``window_s`` is
    the base evaluation cadence.  :meth:`evaluate` is called at window
    boundaries by the fleet's serve loop (or by hand over a finished run)
    and returns one :class:`SLOStatus` per objective, recording alert
    transitions as ``slo_alert`` / ``slo_clear`` trace events and sampling
    the burn gauges.
    """

    TRACK = "slo"

    def __init__(self, slos, fleet_metrics, *, window_s: float,
                 metrics: MetricsRegistry | None = None, tracer=None):
        if window_s <= 0:
            raise ValueError("window_s must be positive")
        names = [s.name for s in slos]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO names: {names}")
        self.slos = list(slos)
        self.fleet_metrics = fleet_metrics
        self.window_s = window_s
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self._alerting: dict[str, bool] = {s.name: False for s in self.slos}
        #: Evaluation log: one ``{"t", "slos": {name: status}}`` per call.
        self.history: list[dict] = []
        self._gauges = {
            s.name: (self.metrics.gauge(f"slo.{s.name}.burn_fast"),
                     self.metrics.gauge(f"slo.{s.name}.burn_slow"),
                     self.metrics.gauge(f"slo.{s.name}.alerting"))
            for s in self.slos}
        self._alerts_c = self.metrics.counter("slo.alerts")
        self._clears_c = self.metrics.counter("slo.clears")

    # -- window math -----------------------------------------------------------
    def _seen(self, t0: float, t1: float) -> list:
        """Requests whose outcome landed in ``[t0, t1)`` — completions by
        finish instant, sheds by shed instant (FleetMetrics' binning)."""
        fm = self.fleet_metrics
        done = [r for r in fm.completed
                if r.finished_s is not None and t0 <= r.finished_s < t1]
        shed = [r for r in fm.shed
                if r.shed_s is not None and t0 <= r.shed_s < t1]
        return done + shed

    def burn_rate(self, slo: SLO, t0: float, t1: float) -> tuple[float, int]:
        """(burn rate, requests seen) of ``slo`` over ``[t0, t1)``.

        An empty window burns 0 — no traffic spends no budget, so a quiet
        fleet never alerts.
        """
        seen = self._seen(t0, t1)
        if not seen:
            return 0.0, 0
        bad = sum(1 for r in seen if slo.is_bad(r))
        return (bad / len(seen)) / slo.budget, len(seen)

    # -- evaluation ------------------------------------------------------------
    def evaluate(self, now: float) -> list[SLOStatus]:
        """Evaluate every SLO at instant ``now`` (a window boundary)."""
        out = []
        row: dict = {"t": now, "slos": {}}
        for slo in self.slos:
            fast, seen_fast = self.burn_rate(
                slo, now - slo.fast_windows * self.window_s, now)
            slow, _ = self.burn_rate(
                slo, now - slo.slow_windows * self.window_s, now)
            alerting = fast >= slo.burn_alert and slow >= slo.burn_alert
            changed = alerting != self._alerting[slo.name]
            self._alerting[slo.name] = alerting
            gf, gs, ga = self._gauges[slo.name]
            gf.sample(fast, now)
            gs.sample(slow, now)
            ga.sample(1.0 if alerting else 0.0, now)
            if changed:
                (self._alerts_c if alerting else self._clears_c).inc()
                if self.tracer.enabled:
                    self.tracer.event(
                        "slo_alert" if alerting else "slo_clear", self.TRACK,
                        t=now, slo=slo.name, kind=slo.kind,
                        objective=slo.objective, burn_fast=fast,
                        burn_slow=slow)
            st = SLOStatus(now, slo.name, fast, slow, seen_fast, alerting,
                           changed)
            out.append(st)
            row["slos"][slo.name] = {
                "burn_fast": fast, "burn_slow": slow, "alerting": alerting}
        self.history.append(row)
        return out

    def alerting(self) -> list[str]:
        """Names of SLOs currently in the alerting state."""
        return [n for n, a in self._alerting.items() if a]

    def last_alert_end(self, name: str | None = None) -> float:
        """Latest evaluation instant at which any (or the named) SLO was
        still alerting — 0.0 when it never alerted.  The "time to reach SLO
        compliance" a benchmark reads off a finished run: after this
        instant the monitor never alerted again."""
        t = 0.0
        for row in self.history:
            for n, st in row["slos"].items():
                if st["alerting"] and (name is None or n == name):
                    t = max(t, row["t"])
        return t

    def summary(self) -> dict:
        """Per-SLO rollup for the fleet summary."""
        out = {}
        for slo in self.slos:
            evals = [r["slos"][slo.name] for r in self.history]
            n_alerting = sum(1 for e in evals if e["alerting"])
            out[slo.name] = {
                "kind": slo.kind,
                "objective": slo.objective,
                "threshold_s": slo.threshold_s,
                "evaluations": len(evals),
                "alerting_windows": n_alerting,
                "alert_share": n_alerting / len(evals) if evals else 0.0,
                "alerting_now": self._alerting[slo.name],
                "last_alert_end_s": self.last_alert_end(slo.name),
            }
        return out


def default_slos(tick_s: float) -> list[SLO]:
    """A reasonable default SLO set, sized in ticks (one untuned decode
    step) so it transfers across archs — what ``serve_fleet --slo default``
    installs."""
    return [
        SLO("p95_latency", "latency", objective=0.95,
            threshold_s=40.0 * tick_s),
        SLO("ttft", "ttft", objective=0.90, threshold_s=20.0 * tick_s),
        SLO("shed", "shed", objective=0.98),
        SLO("deadline", "deadline", objective=0.95),
    ]
