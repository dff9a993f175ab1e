"""Fleet metrics: latency percentiles, throughput, queue depth, shed rate.

A copy of ``repro.fleet.metrics`` (the port imports nothing of ``repro``).

All times are *virtual seconds* (the replicas' runner's kernel seconds: the
cost model for a TPU target, times measured on the card for ``h100``);
latencies are also reported in *ticks* (one tick = the untuned decode-step
cost of the reference replica) so numbers are comparable across archs.

Every number lives in a :class:`repro_torch.obs.MetricsRegistry` under the
``fleet.*`` namespace (counters ``fleet.requests_completed`` /
``fleet.requests_shed`` / ``fleet.tokens``, histogram ``fleet.latency_s``,
gauges ``fleet.queue_depth`` / ``fleet.utilization``), so ``--metrics-out``
exports the same values :meth:`FleetMetrics.summary` prints.  Gauge samples
require their timestamp — an unstamped sample cannot be windowed and used
to silently misfile into the first window.

Beyond the whole-run :meth:`FleetMetrics.summary`, metrics are queryable per
time window: :meth:`FleetMetrics.window` summarizes one ``[t0, t1)`` slice
(completions, sheds, p50/p95, queue depth, replica utilization) and
:meth:`window_summaries` buckets the whole run into ``window_s`` slices
through the same code path — the autoscaler's control signal and the
benchmark's per-phase comparison read the identical numbers.
"""
from __future__ import annotations

from repro_torch.fleet.traffic import FleetRequest
from repro_torch.obs import MetricsRegistry, percentile  # noqa: F401  (re-export)


class FleetMetrics:
    """Accumulates per-request outcomes and timestamped gauge samples."""

    def __init__(self, metrics: MetricsRegistry | None = None) -> None:
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.completed: list[FleetRequest] = []
        self.shed: list[FleetRequest] = []
        self._completed_c = self.metrics.counter("fleet.requests_completed")
        self._shed_c = self.metrics.counter("fleet.requests_shed")
        self._tokens_c = self.metrics.counter("fleet.tokens")
        self._latency_h = self.metrics.histogram("fleet.latency_s")
        self._queue_g = self.metrics.gauge("fleet.queue_depth")
        self._util_g = self.metrics.gauge("fleet.utilization")
        self.makespan_s = 0.0
        # padding-waste ledger: prompt tokens the engines actually needed vs
        # tokens they computed (slot-engine prefill buckets pad; the paged
        # engine's chunked prefill holds the two equal)
        self.prefill_true_tokens = 0
        self.prefill_padded_tokens = 0
        # KV capacity samples: (rows holding tokens, rows reserved) per
        # observation — stranded capacity is the gap between the two
        self.capacity_samples: list[tuple[int, int]] = []

    @property
    def tokens(self) -> int:
        return int(self._tokens_c.value)

    @property
    def queue_samples(self) -> list[tuple[float, float]]:
        return self._queue_g.samples

    @property
    def util_samples(self) -> list[tuple[float, float]]:
        return self._util_g.samples

    def record_completion(self, req: FleetRequest, now: float) -> None:
        req.finished_s = now
        self.completed.append(req)
        self._completed_c.inc()
        self._tokens_c.inc(req.tokens)
        if req.latency_s is not None:
            self._latency_h.observe(req.latency_s)
        self.makespan_s = max(self.makespan_s, now)

    def record_shed(self, req: FleetRequest, now: float | None = None) -> None:
        req.shed_s = now if now is not None else req.arrival_s
        self.shed.append(req)
        self._shed_c.inc()

    def sample_queue(self, depth: int, now: float) -> None:
        self._queue_g.sample(depth, now)

    def sample_utilization(self, util: float, now: float) -> None:
        """Sample mean replica utilization (0..1) at an event point."""
        self._util_g.sample(util, now)

    def record_padding(self, true_tokens: int, padded_tokens: int) -> None:
        """Account one prefill: tokens the prompt needed vs tokens computed."""
        self.prefill_true_tokens += true_tokens
        self.prefill_padded_tokens += padded_tokens

    def sample_capacity(self, used_tokens: int, capacity_tokens: int) -> None:
        """Sample KV occupancy (summed across replicas) at an event point."""
        self.capacity_samples.append((used_tokens, capacity_tokens))

    # -- windowed views --------------------------------------------------------
    def window(self, t0: float, t1: float) -> dict:
        """Summary of the ``[t0, t1)`` slice — the autoscaler's signal.

        Completions are binned by finish time, sheds by shed time, queue and
        utilization samples by sample time.  The same dict shape is used by
        :meth:`window_summaries`, so a controller tuned against bench windows
        sees the identical signal live.
        """
        done = [r for r in self.completed
                if r.finished_s is not None and t0 <= r.finished_s < t1]
        shed = [r for r in self.shed
                if r.shed_s is not None and t0 <= r.shed_s < t1]
        lats = [r.latency_s for r in done if r.latency_s is not None]
        qs = self._queue_g.values(t0, t1)
        us = self._util_g.values(t0, t1)
        n_seen = len(done) + len(shed)
        return {
            "t0": t0,
            "t1": t1,
            "completed": len(done),
            "shed": len(shed),
            "shed_rate": len(shed) / n_seen if n_seen else 0.0,
            "tokens": sum(r.tokens for r in done),
            "latency_s": {"p50": percentile(lats, 50),
                          "p95": percentile(lats, 95),
                          "p99": percentile(lats, 99)},
            "queue_depth_mean": sum(qs) / len(qs) if qs else 0.0,
            "queue_depth_max": max(qs) if qs else 0,
            "utilization_mean": sum(us) / len(us) if us else 0.0,
        }

    def window_summaries(self, window_s: float, *,
                         until: float | None = None) -> list[dict]:
        """Bucket the run into ``window_s`` slices (per-phase comparisons)."""
        if window_s <= 0:
            raise ValueError("window_s must be positive")
        end = until if until is not None else self.makespan_s
        out = []
        t0 = 0.0
        while t0 < end or not out:
            out.append(self.window(t0, t0 + window_s))
            t0 += window_s
        return out

    # -- summary ---------------------------------------------------------------
    def latencies(self) -> list[float]:
        return [r.latency_s for r in self.completed if r.latency_s is not None]

    def summary(self, *, tick_s: float = 1.0) -> dict:
        lats = self.latencies()
        n_done, n_shed = len(self.completed), len(self.shed)
        n_seen = n_done + n_shed
        qs = [d for _, d in self.queue_samples]
        out = {
            "completed": n_done,
            "shed": n_shed,
            "shed_rate": n_shed / n_seen if n_seen else 0.0,
            "shed_by_reason": {
                reason: sum(1 for r in self.shed if r.shed == reason)
                for reason in sorted({r.shed for r in self.shed})},
            "tokens": self.tokens,
            "makespan_s": self.makespan_s,
            "throughput_tok_per_s": (self.tokens / self.makespan_s
                                     if self.makespan_s > 0 else 0.0),
            "latency_s": {"p50": percentile(lats, 50),
                          "p95": percentile(lats, 95),
                          "p99": percentile(lats, 99)},
            "latency_ticks": {"p50": percentile(lats, 50) / tick_s,
                              "p95": percentile(lats, 95) / tick_s,
                              "p99": percentile(lats, 99) / tick_s},
            "queue_depth_max": max(qs) if qs else 0,
            "queue_depth_mean": sum(qs) / len(qs) if qs else 0.0,
            # fraction of prefill compute spent on pad tokens (0.0 for the
            # paged engine — chunked prefill never pads)
            "padding_waste_frac": (
                1.0 - self.prefill_true_tokens / self.prefill_padded_tokens
                if self.prefill_padded_tokens else 0.0),
            "kv_utilization_mean": (
                sum(u / c for u, c in self.capacity_samples if c)
                / len(self.capacity_samples) if self.capacity_samples else 0.0),
            # reserved-but-empty KV rows, averaged over samples: capacity the
            # fixed-slot layout strands that a paged pool can re-admit into
            "stranded_capacity_frac": (
                sum(1.0 - u / c for u, c in self.capacity_samples if c)
                / len(self.capacity_samples) if self.capacity_samples else 0.0),
            "exact_share_at_admit_mean": (
                sum(r.exact_share_at_admit for r in self.completed) / n_done
                if n_done else 0.0),
            "tick_s": tick_s,
        }
        return out
