"""Observability: the tracer and the metrics registry, copies of
``repro.obs.tracer`` and ``repro.obs.metrics`` (the port imports nothing of
``repro``).  The resolution pipeline and the tuning service record through
them; the rest of ``repro.obs`` (export, SLOs, the speedup ledger, the
profiler report) is not ported yet.
"""
from .metrics import (
    Counter,
    CounterGroup,
    Gauge,
    Histogram,
    MetricsRegistry,
    default_registry,
    percentile,
)
from .tracer import NULL_TRACER, Event, NullTracer, Span, Tracer

__all__ = [
    "Counter", "CounterGroup", "Gauge", "Histogram", "MetricsRegistry",
    "default_registry", "percentile",
    "NULL_TRACER", "Event", "NullTracer", "Span", "Tracer",
]
