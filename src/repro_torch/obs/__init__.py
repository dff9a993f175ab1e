"""Unified observability: virtual-clock tracing, metrics, trace export.

Copies of ``repro.obs``'s modules (the port imports nothing of ``repro``).
Producers record through a :class:`Tracer` (default :data:`NULL_TRACER`, a
no-op costing one attribute check) and a :class:`MetricsRegistry`;
consumers export Chrome trace-event JSON for Perfetto or JSON-lines for
``launch/trace_report.py``.  See DESIGN.md §10 and §12.
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
from .export import (
    chrome_trace,
    load_records,
    read_jsonl,
    write_chrome_trace,
    write_jsonl,
)
from .slo import KINDS, SLO, SLOMonitor, SLOStatus, default_slos
from .ledger import LedgerEntry, SpeedupLedger
from . import report
from . import profiler

__all__ = [
    "Counter", "CounterGroup", "Gauge", "Histogram", "MetricsRegistry",
    "default_registry", "percentile",
    "NULL_TRACER", "Event", "NullTracer", "Span", "Tracer",
    "chrome_trace", "load_records", "read_jsonl", "write_chrome_trace",
    "write_jsonl", "report", "profiler",
    "KINDS", "SLO", "SLOMonitor", "SLOStatus", "default_slos",
    "LedgerEntry", "SpeedupLedger",
]
