"""Fault tolerance on one process: straggler detection and preemption
handling (the counterpart of ``StragglerMonitor`` and ``PreemptionHandler``
in ``repro.distributed.fault``, copied).

* :class:`StragglerMonitor` — EWMA of per-step wall times; steps slower than
  ``threshold×`` the EWMA are flagged.
* :class:`PreemptionHandler` — converts SIGTERM (and a programmatic
  ``request()``) into a "checkpoint now, then exit cleanly" flag the train
  loop polls each step.

``elastic_restore`` (a checkpoint restored onto another mesh) waits for the
port's distributed training (ROADMAP A.9).
"""
from __future__ import annotations

import signal
import threading


class StragglerMonitor:
    def __init__(self, alpha: float = 0.2, threshold: float = 2.0, warmup: int = 3):
        self.alpha = alpha
        self.threshold = threshold
        self.warmup = warmup
        self.ewma: float | None = None
        self.count = 0
        self.flagged: list[tuple[int, float, float]] = []  # (step, dt, ewma)

    def record(self, step: int, dt: float) -> bool:
        """Record one step duration; returns True if flagged as straggler."""
        self.count += 1
        if self.ewma is None:
            self.ewma = dt
            return False
        is_straggler = self.count > self.warmup and dt > self.threshold * self.ewma
        if is_straggler:
            self.flagged.append((step, dt, self.ewma))
        else:
            # stragglers don't poison the baseline
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        return is_straggler


class PreemptionHandler:
    """SIGTERM → graceful 'checkpoint and exit' request."""

    def __init__(self, install_signal: bool = True):
        self._event = threading.Event()
        if install_signal:
            try:
                signal.signal(signal.SIGTERM, lambda *_: self._event.set())
            except ValueError:
                pass  # non-main thread (tests)

    def request(self) -> None:
        self._event.set()

    @property
    def requested(self) -> bool:
        return self._event.is_set()
