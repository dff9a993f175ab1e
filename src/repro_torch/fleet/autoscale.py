"""Elastic-fleet autoscaler: windowed telemetry in, scale decisions out.

A copy of ``repro.fleet.autoscale`` (the port imports nothing of ``repro``).

The paper's economics make *tuning* cheap enough to follow demand
(transfer-tuning produces a serving-grade schedule in seconds, where a full
Ansor search cannot react on-line); the fleet's demand-driven prefetch
already exploits that.  This module closes the remaining loop — *capacity*
following demand: an :class:`Autoscaler` watches the same windowed signal
the metrics pipeline produces (queue depth, shed rate, replica utilization,
p95 trend) and emits scale-up / scale-down decisions that
:class:`~repro_torch.fleet.fleet.ServingFleet` turns into replica lifecycle
actions (warm-join / drain-retire).

The controller is deliberately boring — thresholds with hysteresis — because
the interesting property lives elsewhere: a *joining* replica is cheap only
because the shared :class:`~repro_torch.service.ScheduleRegistry` lets it boot at
the fleet's current schedule tier (its execution plan resolves every shape
the fleet already tuned at the exact tier, the transfer-tuning analogue of
warm-starting search from a donor).  Without that, every scale-up would
serve default-tier schedules until background tuning caught up, and the
elasticity win would be eaten by cold-start latency.

Hysteresis has three guards, each pinned by a test:

* **N-consecutive windows** — one hot window never scales; ``up_windows``
  (resp. ``down_windows``) consecutive windows of pressure must agree, so
  a single burst-edge sample cannot flap the fleet.
* **Cooldown** — after any scale action, decisions hold for ``cooldown_s``
  virtual seconds: the fleet observes the *scaled* system before scaling
  again (a joining replica needs a window to absorb queue backlog).
* **Bounds** — the live replica count is clamped to
  ``[min_replicas, max_replicas]``.
"""
from __future__ import annotations

import dataclasses

from repro_torch.obs import NULL_TRACER, MetricsRegistry


@dataclasses.dataclass(frozen=True)
class ScaleDecision:
    """One autoscaler evaluation: what it decided and why."""

    t: float            # virtual instant the decision was made
    action: str         # "up" | "down" | "hold"
    reason: str         # which signal (or guard) produced the action
    replicas: int       # live replica count when decided
    window: dict        # the metrics window the decision was based on


class Autoscaler:
    """Threshold-with-hysteresis controller over windowed fleet telemetry.

    :meth:`observe` consumes one metrics window
    (:meth:`~repro_torch.fleet.metrics.FleetMetrics.window` dict) per
    ``window_s`` of virtual time and returns a :class:`ScaleDecision`.
    The caller (the fleet's serve loop) applies ``up``/``down`` actions;
    every decision is appended to :attr:`decisions` for the audit trail.

    Scale-up pressure (any one suffices):
      * mean queue depth above ``queue_high`` — work is waiting;
      * shed rate above ``shed_high`` — work is being *lost*;
      * mean utilization above ``util_high`` — no headroom for a burst;
      * p95 latency rose by more than ``p95_rise`` versus the previous
        window — the system is falling behind even before queues show it.

    Scale-down requires a *quiet* window (all must hold): utilization below
    ``util_low``, mean queue depth below ``queue_low``, and zero sheds.
    """

    def __init__(self, *, min_replicas: int = 1, max_replicas: int = 4,
                 window_s: float, cooldown_s: float,
                 up_windows: int = 1, down_windows: int = 2,
                 queue_high: float = 2.0, shed_high: float = 0.0,
                 util_high: float = 0.9, util_low: float = 0.35,
                 queue_low: float = 0.5, p95_rise: float = 0.5,
                 metrics: MetricsRegistry | None = None, tracer=None):
        if not 1 <= min_replicas <= max_replicas:
            raise ValueError("need 1 <= min_replicas <= max_replicas")
        if window_s <= 0 or cooldown_s < 0:
            raise ValueError("window_s must be positive, cooldown_s >= 0")
        if up_windows < 1 or down_windows < 1:
            raise ValueError("up_windows/down_windows must be >= 1")
        self.min_replicas = min_replicas
        self.max_replicas = max_replicas
        self.window_s = window_s
        self.cooldown_s = cooldown_s
        self.up_windows = up_windows
        self.down_windows = down_windows
        self.queue_high = queue_high
        self.shed_high = shed_high
        self.util_high = util_high
        self.util_low = util_low
        self.queue_low = queue_low
        self.p95_rise = p95_rise
        self.decisions: list[ScaleDecision] = []
        self._up_streak = 0
        self._down_streak = 0
        self._last_scale_t: float | None = None
        self._prev_p95 = 0.0
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self._bind_metrics(metrics if metrics is not None
                           else MetricsRegistry())

    def _bind_metrics(self, metrics: MetricsRegistry) -> None:
        self.metrics = metrics
        self._counters = metrics.group(
            "autoscaler", ["evaluations", "scale_ups", "scale_downs",
                           "holds"])

    def bind_obs(self, tracer, metrics: MetricsRegistry) -> None:
        """Re-home telemetry into the owner's tracer/registry.

        Fleets construct their observability sinks after the controller is
        built (``attach_autoscaler``), so the controller's counters move to
        the fleet registry — carrying any evaluations already made.
        """
        self.tracer = tracer
        old = {n: self._counters[n] for n in self._counters}
        self._bind_metrics(metrics)
        for n, v in old.items():
            if v:
                self._counters.inc(n, v)

    # -- pressure classification ----------------------------------------------
    def _up_reason(self, w: dict) -> str | None:
        # SLO burn-rate alerts (windows carry them when the fleet runs an
        # SLOMonitor) outrank the raw-signal thresholds: a burning error
        # budget is the user-facing definition of "falling behind".
        if w.get("slo_alerts", 0) > 0:
            return f"slo burn-rate alert on {w['slo_alerts']} objective(s)"
        if w["queue_depth_mean"] > self.queue_high:
            return f"queue_depth_mean {w['queue_depth_mean']:.2f} > {self.queue_high}"
        if w["shed_rate"] > self.shed_high:
            return f"shed_rate {w['shed_rate']:.2f} > {self.shed_high}"
        if w["utilization_mean"] > self.util_high:
            return f"utilization {w['utilization_mean']:.2f} > {self.util_high}"
        p95 = w["latency_s"]["p95"]
        if self._prev_p95 > 0 and p95 > self._prev_p95 * (1 + self.p95_rise):
            return f"p95 rose {p95 / self._prev_p95:.2f}x"
        return None

    def _down_ok(self, w: dict) -> bool:
        return (w["utilization_mean"] < self.util_low
                and w["queue_depth_mean"] < self.queue_low
                and w["shed"] == 0
                and w.get("slo_alerts", 0) == 0)

    # -- the decision ----------------------------------------------------------
    def observe(self, window: dict, *, now: float, replicas: int
                ) -> ScaleDecision:
        """Fold one telemetry window into the controller state and decide.

        ``replicas`` is the *live* (active + draining) count — the capacity
        that exists, which is what the bounds clamp.
        """
        up_reason = self._up_reason(window)
        if up_reason is not None:
            self._up_streak += 1
            self._down_streak = 0
        elif self._down_ok(window):
            self._down_streak += 1
            self._up_streak = 0
        else:
            self._up_streak = self._down_streak = 0
        self._prev_p95 = window["latency_s"]["p95"]

        action, reason = "hold", "no pressure"
        if self._up_streak >= self.up_windows:
            action, reason = "up", up_reason or "up pressure"
        elif self._down_streak >= self.down_windows:
            action, reason = "down", (
                f"quiet: util {window['utilization_mean']:.2f} < "
                f"{self.util_low}, queue {window['queue_depth_mean']:.2f} < "
                f"{self.queue_low}, 0 sheds")

        # Guards, strongest first: cooldown, then bounds.  Streaks are NOT
        # reset by a guard — pressure observed during cooldown still counts,
        # so a sustained burst acts the instant the cooldown expires.
        if action != "hold":
            in_cooldown = (self._last_scale_t is not None
                           and now - self._last_scale_t < self.cooldown_s)
            if in_cooldown:
                action, reason = "hold", "cooldown"
            elif action == "up" and replicas >= self.max_replicas:
                action, reason = "hold", f"at max_replicas {self.max_replicas}"
            elif action == "down" and replicas <= self.min_replicas:
                action, reason = "hold", f"at min_replicas {self.min_replicas}"
            else:
                self._last_scale_t = now
                self._up_streak = self._down_streak = 0

        decision = ScaleDecision(t=now, action=action, reason=reason,
                                 replicas=replicas, window=window)
        self.decisions.append(decision)
        self._counters["evaluations"] += 1
        self._counters[{"up": "scale_ups", "down": "scale_downs",
                        "hold": "holds"}[action]] += 1
        if self.tracer.enabled:
            self.tracer.event(
                "scale_decision", "autoscaler", t=now, action=action,
                reason=reason, replicas=replicas,
                queue_depth_mean=window["queue_depth_mean"],
                utilization_mean=window["utilization_mean"],
                shed=window["shed"], p95=window["latency_s"]["p95"])
        return decision

    # -- telemetry ------------------------------------------------------------
    def stats(self) -> dict:
        return {
            "evaluations": int(self._counters["evaluations"]),
            "scale_ups": int(self._counters["scale_ups"]),
            "scale_downs": int(self._counters["scale_downs"]),
            "holds": int(self._counters["holds"]),
            "window_s": self.window_s,
            "cooldown_s": self.cooldown_s,
            "min_replicas": self.min_replicas,
            "max_replicas": self.max_replicas,
        }
