"""Fleet-wide metrics registry: named counters, gauges, and histograms.

A copy of ``repro.obs.metrics`` (the port imports nothing of ``repro``).

Before this module every subsystem kept its own ad-hoc numbers —
``FleetMetrics`` lists, ``TuningService._counters`` dicts,
``ResolutionPipeline`` per-tier counts, ``Autoscaler.stats()`` — each with
its own definition and its own export path.  The registry gives every number
one home:

* :class:`Counter` — monotone event count (requests completed, cache hits);
* :class:`Gauge` — a timestamped sample series (queue depth, utilization) —
  samples carry the *virtual* instant they were taken at, so windowed
  consumers (the autoscaler) and whole-run consumers (summaries) read the
  same data;
* :class:`Histogram` — a value distribution with shared :func:`percentile`
  semantics (latencies, job durations).

:class:`MetricsRegistry` is the get-or-create namespace over all three.
A process-wide default (:func:`default_registry`) exists for drivers that
want one export path; components default to a private registry so parallel
fleets/tests never cross-contaminate.  :class:`CounterGroup` is the
dict-compatibility facade legacy ``stats()`` dicts migrate through: it reads
and writes registry counters but supports ``group["name"] += 1`` and
``dict(group)`` unchanged.
"""
from __future__ import annotations

import threading

import numpy as np


def percentile(xs: "list[float]", q: float) -> float:
    """q-th percentile (0..100, linear interpolation); 0.0 when empty.

    The one shared definition — fleet metrics, benchmarks, and trace
    reports all quote percentiles through this function, so a p95 printed
    by any of them is comparable with any other.  Edge cases are pinned
    (SLO burn-rate math and ledger ratios divide by these): an empty
    series is 0.0 for every q, and a single sample is that sample for
    every q — returned directly, bypassing numpy, so the value round-trips
    bit-exactly rather than through interpolation arithmetic.
    """
    if len(xs) == 0:
        return 0.0
    if len(xs) == 1:
        return float(xs[0])
    return float(np.percentile(xs, q))


class Counter:
    """Monotone event count.  ``+=`` works through :class:`CounterGroup`."""

    kind = "counter"

    def __init__(self, name: str):
        self.name = name
        self.value: float = 0

    def inc(self, n: float = 1) -> None:
        self.value += n

    def set(self, v: float) -> None:
        self.value = v

    def to_json(self):
        return self.value


class Gauge:
    """Timestamped sample series: ``sample(value, t)`` appends ``(t, value)``.

    ``t`` is required — a gauge sample without its instant cannot be
    windowed, and silently defaulting it misfiles the sample into the first
    window (the bug this type exists to prevent).
    """

    kind = "gauge"

    def __init__(self, name: str):
        self.name = name
        self.samples: list[tuple[float, float]] = []

    def sample(self, value: float, t: float) -> None:
        if t is None:
            raise TypeError(f"gauge {self.name!r}: sample timestamp required")
        self.samples.append((float(t), value))

    @property
    def value(self) -> float:
        """Latest sampled value (0.0 when never sampled)."""
        return self.samples[-1][1] if self.samples else 0.0

    def values(self, t0: float = float("-inf"),
               t1: float = float("inf")) -> list[float]:
        """Sample values taken in ``[t0, t1)``."""
        return [v for t, v in self.samples if t0 <= t < t1]

    def to_json(self):
        return {"last": self.value, "samples": len(self.samples)}


class Histogram:
    """Value distribution with :func:`percentile` queries.

    Raw observations are kept (these runs observe thousands of values, not
    millions), so any quantile is exact and :meth:`percentile` agrees with
    every other consumer of the shared definition.
    """

    kind = "histogram"

    def __init__(self, name: str):
        self.name = name
        self.values: list[float] = []
        self.sum = 0.0

    def observe(self, v: float) -> None:
        self.values.append(float(v))
        self.sum += v

    @property
    def count(self) -> int:
        return len(self.values)

    @property
    def mean(self) -> float:
        return self.sum / len(self.values) if self.values else 0.0

    def percentile(self, q: float) -> float:
        return percentile(self.values, q)

    def to_json(self):
        return {"count": self.count, "sum": self.sum, "mean": self.mean,
                "p50": self.percentile(50), "p95": self.percentile(95),
                "p99": self.percentile(99)}


class MetricsRegistry:
    """Get-or-create namespace of named metrics with one export path."""

    _TYPES = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: dict[str, object] = {}

    def _get(self, name: str, kind: str):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = self._TYPES[kind](name)
            elif m.kind != kind:
                raise TypeError(
                    f"metric {name!r} is a {m.kind}, requested {kind}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, "counter")

    def gauge(self, name: str) -> Gauge:
        return self._get(name, "gauge")

    def histogram(self, name: str) -> Histogram:
        return self._get(name, "histogram")

    def group(self, prefix: str, names: "list[str]") -> "CounterGroup":
        return CounterGroup(self, prefix, names)

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._metrics)

    def get(self, name: str):
        with self._lock:
            return self._metrics.get(name)

    def to_json(self) -> dict:
        """``name -> value`` for every metric (the ``--metrics-out`` shape)."""
        with self._lock:
            items = sorted(self._metrics.items())
        return {name: {"kind": m.kind, "value": m.to_json()}
                for name, m in items}


class CounterGroup:
    """Dict-compatible facade over a prefix of registry counters.

    Legacy ``stats()`` dicts migrate through this: ``group["lookups"] += 1``
    and ``dict(group)`` behave exactly like the plain-dict counters they
    replace, but every number is a registry :class:`Counter` — one
    definition, one export path.
    """

    def __init__(self, metrics: MetricsRegistry, prefix: str,
                 names: "list[str]"):
        self.metrics = metrics
        self.prefix = prefix
        self._counters = {n: metrics.counter(f"{prefix}.{n}") for n in names}

    def __getitem__(self, name: str) -> float:
        return self._counters[name].value

    def __setitem__(self, name: str, value: float) -> None:
        self._counters[name].set(value)

    def __contains__(self, name: str) -> bool:
        return name in self._counters

    def __iter__(self):
        return iter(self._counters)

    def keys(self):
        return self._counters.keys()

    def items(self):
        return ((n, c.value) for n, c in self._counters.items())

    def inc(self, name: str, n: float = 1) -> None:
        self._counters[name].inc(n)


_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-wide registry (drivers wanting a single export path)."""
    return _DEFAULT
