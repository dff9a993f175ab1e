"""Virtual-clock tracer: nested spans and point events on named tracks.

A copy of ``repro.obs.tracer`` (the port imports nothing of ``repro``).

The fleet runs on a discrete-event *virtual* clock (step durations are
cost-model kernel seconds), so spans are stamped with whatever clock the
owner binds via :meth:`Tracer.set_clock` — the fleet binds its ``_now``;
standalone engines fall back to wall clock for real jitted steps.  Time is
seconds in both cases; the exporter scales to microseconds.

Tracks are the horizontal lanes of the timeline: one per replica
(``replica-0`` …), plus ``router``, ``autoscaler``, ``tuning/<target>``,
and ``resolution``.  Three record shapes cover everything the fleet does:

* **sync span** (:meth:`add_span` / :meth:`span`) — a ``[t0, t1)`` interval
  that nests properly within its track (an engine step and the chunk/decode
  work inside it);
* **async span** (:meth:`add_async_span`) — an interval that *overlaps*
  others on its track, keyed by ``(cat, id)`` (concurrent request
  lifetimes on one replica, tuning jobs in the shared pool);
* **event** (:meth:`event`) — a zero-width instant (a shed, a publish,
  a scale decision).

Every record carries structured ``attrs`` (workload key, target, tier,
generation, replica id, scale reason, …) — the exporters pass them through
untouched so offline analysis never has to parse span names.

Instrumented code holds a tracer reference unconditionally and gates on
``tracer.enabled`` — the disabled default (:data:`NULL_TRACER`) makes the
hot path pay exactly one attribute check.
"""
from __future__ import annotations

import threading
import time as _time
from dataclasses import dataclass, field


@dataclass
class Span:
    """A recorded interval on a track.  ``parent`` indexes ``Tracer.spans``."""

    name: str
    track: str
    t0: float
    t1: float
    attrs: dict = field(default_factory=dict)
    parent: int | None = None
    # Async spans overlap on their track and are matched by (cat, id);
    # sync spans leave both None and must nest.
    cat: str | None = None
    id: str | None = None


@dataclass
class Event:
    """A recorded instant on a track."""

    name: str
    track: str
    t: float
    attrs: dict = field(default_factory=dict)


class Tracer:
    """Collects :class:`Span`/:class:`Event` records on a bound clock.

    Thread-safe: the tuning pool's worker threads record tune-job spans
    concurrently with the serve loop.
    """

    enabled = True

    def __init__(self, clock=None):
        self._clock = clock if clock is not None else _time.perf_counter
        self._lock = threading.Lock()
        self._tracks: dict[str, int] = {}
        self.spans: list[Span] = []
        self.events: list[Event] = []
        self._stack = threading.local()

    # -- clock ----------------------------------------------------------
    def set_clock(self, clock) -> None:
        """Bind the time source (fleet virtual clock, or wall clock)."""
        self._clock = clock

    def now(self) -> float:
        return float(self._clock())

    # -- tracks ---------------------------------------------------------
    def track(self, name: str) -> str:
        """Register ``name`` (idempotent); registration order fixes the
        exported track order."""
        with self._lock:
            self._tracks.setdefault(name, len(self._tracks))
        return name

    def tracks(self) -> list[str]:
        with self._lock:
            return sorted(self._tracks, key=self._tracks.__getitem__)

    # -- recording ------------------------------------------------------
    def add_span(self, name: str, track: str, t0: float, t1: float,
                 parent: int | None = None, **attrs) -> int:
        """Record a completed sync span; returns its index (a valid
        ``parent`` for children)."""
        if t1 < t0:
            raise ValueError(f"span {name!r}: t1 {t1} < t0 {t0}")
        s = Span(name, self.track(track), float(t0), float(t1), attrs, parent)
        with self._lock:
            self.spans.append(s)
            return len(self.spans) - 1

    def add_async_span(self, name: str, track: str, t0: float, t1: float,
                       cat: str, id: str, **attrs) -> int:
        """Record a completed async span — may overlap others on its track."""
        if t1 < t0:
            raise ValueError(f"span {name!r}: t1 {t1} < t0 {t0}")
        s = Span(name, self.track(track), float(t0), float(t1), attrs,
                 None, cat, str(id))
        with self._lock:
            self.spans.append(s)
            return len(self.spans) - 1

    def event(self, name: str, track: str, t: float | None = None,
              **attrs) -> None:
        e = Event(name, self.track(track), self.now() if t is None else
                  float(t), attrs)
        with self._lock:
            self.events.append(e)

    def span(self, name: str, track: str, **attrs):
        """Context manager timing a live region on the bound clock; nested
        uses (same thread) record parent links automatically."""
        return _LiveSpan(self, name, track, attrs)

    def counts(self) -> dict:
        with self._lock:
            return {"spans": len(self.spans), "events": len(self.events)}


class _LiveSpan:
    def __init__(self, tracer: Tracer, name: str, track: str, attrs: dict):
        self.tracer = tracer
        self.name = name
        self.track = track
        self.attrs = attrs
        self.index: int | None = None

    def __enter__(self):
        self._t0 = self.tracer.now()
        stack = getattr(self.tracer._stack, "open", None)
        if stack is None:
            stack = self.tracer._stack.open = []
        self._parent = stack[-1] if stack else None
        # Reserve the record now so children born inside the region can
        # point at it; t1 is patched on exit.
        self.index = self.tracer.add_span(self.name, self.track, self._t0,
                                          self._t0, self._parent,
                                          **self.attrs)
        stack.append(self.index)
        return self

    def __exit__(self, *exc):
        self.tracer._stack.open.pop()
        with self.tracer._lock:
            self.tracer.spans[self.index].t1 = self.tracer.now()
        return False


class NullTracer(Tracer):
    """Disabled tracer: every recording call is a no-op.

    Instrumentation sites check ``tracer.enabled`` before building attrs,
    so with this default the instrumented hot path costs one attribute
    read per site.
    """

    enabled = False

    def __init__(self):
        super().__init__(clock=lambda: 0.0)

    def add_span(self, *a, **k) -> int:  # noqa: D102
        return -1

    def add_async_span(self, *a, **k) -> int:  # noqa: D102
        return -1

    def event(self, *a, **k) -> None:  # noqa: D102
        pass

    def span(self, name, track, **attrs):  # noqa: D102
        return _NULL_LIVE

    def track(self, name: str) -> str:  # noqa: D102
        return name


class _NullLive:
    index = -1

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_LIVE = _NullLive()

NULL_TRACER = NullTracer()
