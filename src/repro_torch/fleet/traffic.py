"""Synthetic serving traffic: seeded arrivals, mixed request shapes.

A copy of ``repro.fleet.traffic`` (the port imports nothing of ``repro``).

The fleet benchmarks need *reproducible-but-variable* load: the same seed
must replay the identical request stream across routing policies (so policy
comparisons are apples-to-apples on one trace), while different seeds vary
the arrival pattern.  :class:`TrafficGenerator` produces such traces — a
Poisson arrival process (exponential inter-arrival times) over a mixture of
short and long prompts with per-request new-token counts and optional
deadlines.

A stationary Poisson process cannot exercise *capacity* decisions — its
smoothed rate never moves, so an autoscaler watching it would correctly
never scale.  Two non-homogeneous generators (both Lewis–Shedler thinning
over a deterministic rate curve) provide production-shaped load:

* :class:`BurstyTraffic` — a square wave: ``arrival_rate`` between bursts,
  ``burst_rate`` inside periodic bursts (``burst_every_ticks`` period,
  ``burst_len_ticks`` duration).  ``phase_at(t)`` labels each instant so
  benchmarks can compare per-phase windows.
* :class:`DiurnalTraffic` — a sinusoid: rate swings ``±amplitude`` around
  ``arrival_rate`` with period ``period_ticks`` (the day/night curve).

:func:`save_trace` / :func:`load_trace` round-trip any request list through
JSON-lines, so a recorded production log (arrival timestamps + prompt +
token budget) replays through ``ServingFleet.serve`` exactly.

Times are expressed in *ticks* — one tick is the untuned decode-step cost of
a reference replica (the fleet computes it from its runner) — so an
``arrival_rate`` of 0.5 means "one request every two untuned step times"
regardless of the arch being served.

:func:`sample_prompts` is the shared single-engine stream sampler
(``launch/serve.py --seed`` uses it), kept here so serve and fleet runs draw
from the same distribution family.
"""
from __future__ import annotations

import dataclasses
import json
import math

import numpy as np


@dataclasses.dataclass
class FleetRequest:
    """One request flowing through the router; outcome fields are filled in
    by the fleet as the request is queued, dispatched, and completed."""

    uid: int
    prompt: list[int]
    max_new_tokens: int
    arrival_s: float                 # virtual seconds
    deadline_s: float | None = None  # absolute; None -> never shed on age
    eos_id: int | None = None
    request_class: str = ""          # workload class ("chat", "bulk", ...); ""=unclassified
    # -- routing outcome ------------------------------------------------------
    bucket: int = 0                  # prefill bucket the demand tracker keyed
    replica: int | None = None
    admitted_s: float | None = None
    prefill_done_s: float | None = None  # first generated token available
    finished_s: float | None = None
    shed: str = ""                   # "" | "queue_full" | "deadline" | "invalid"
    shed_s: float | None = None      # virtual instant the shed happened
    speculative: bool | None = None  # admit-time spec decision (None: n/a)
    tokens: int = 0
    generated: list[int] | None = None  # the served token ids, for audits
    exact_share_at_admit: float = 0.0

    @property
    def latency_s(self) -> float | None:
        if self.finished_s is None:
            return None
        return self.finished_s - self.arrival_s


def sample_prompts(rng: np.random.Generator, n: int, vocab_size: int, *,
                   lo: int = 3, hi: int = 8) -> list[list[int]]:
    """``n`` random-token prompts with uniform[lo, hi] lengths.

    The single-engine serve driver's stream; the fleet generator's "short"
    mixture component uses the same family.
    """
    return [[int(t) for t in rng.integers(1, vocab_size,
                                          size=int(rng.integers(lo, hi + 1)))]
            for _ in range(n)]


class TrafficGenerator:
    """Seeded synthetic request stream for fleet serving.

    * **Arrivals** — Poisson process: exponential inter-arrival times with
      mean ``tick_s / arrival_rate`` (``arrival_rate`` = expected requests
      per tick).
    * **Prompt lengths** — a two-component mixture: ``long_frac`` of
      requests draw uniform from ``long_lens``, the rest from
      ``short_lens``; lengths are clamped to ``prompt_cap``.  The skew makes
      one prefill bucket *hot*, which is what demand-driven tuning exploits.
    * **New tokens** — uniform from ``new_tokens``; when
      ``long_new_tokens`` is given, requests from the long prompt component
      draw from it instead.  Coupling long prompts with long generations
      makes the footprint distribution *long-tailed*: capacity must be
      provisioned for the rare worst case while the typical request is much
      smaller — the regime where paged KV memory pays off.
    * **Deadlines** — ``deadline_ticks`` ticks after arrival (None: never
      expire).
    * **Classes** — ``class_mix`` (e.g. ``{"chat": 0.7, "bulk": 0.3}``)
      stamps each request with a seeded workload class; the router's
      acceptance-aware speculative policy keys off it.  ``None`` (default)
      draws no extra randomness, so legacy seeded traces are unchanged.
    """

    def __init__(self, *, seed: int = 0, vocab_size: int = 256,
                 arrival_rate: float = 0.5, tick_s: float = 1.0,
                 short_lens: tuple[int, int] = (3, 8),
                 long_lens: tuple[int, int] = (16, 32),
                 long_frac: float = 0.25,
                 new_tokens: tuple[int, int] = (4, 8),
                 long_new_tokens: tuple[int, int] | None = None,
                 deadline_ticks: float | None = None,
                 prompt_cap: int | None = None,
                 class_mix: dict[str, float] | None = None):
        if arrival_rate <= 0:
            raise ValueError("arrival_rate must be positive")
        if class_mix is not None:
            if not class_mix or any(w < 0 for w in class_mix.values()):
                raise ValueError("class_mix needs non-negative weights")
            if sum(class_mix.values()) <= 0:
                raise ValueError("class_mix weights must sum to > 0")
        self.rng = np.random.default_rng(seed)
        self.seed = seed
        self.vocab_size = vocab_size
        self.arrival_rate = arrival_rate
        self.tick_s = tick_s
        self.short_lens = short_lens
        self.long_lens = long_lens
        self.long_frac = long_frac
        self.new_tokens = new_tokens
        self.long_new_tokens = long_new_tokens
        self.deadline_ticks = deadline_ticks
        self.prompt_cap = prompt_cap
        self.class_mix = class_mix
        self._uid = 0
        self._t = 0.0  # stream clock: carried across trace() calls

    def _shape(self) -> tuple[int, int]:
        """(prompt_len, max_new_tokens) for one request."""
        long = self.rng.random() < self.long_frac
        lo, hi = self.long_lens if long else self.short_lens
        n = int(self.rng.integers(lo, hi + 1))
        if self.prompt_cap is not None:
            n = min(n, self.prompt_cap)
        nt = (self.long_new_tokens if long and self.long_new_tokens is not None
              else self.new_tokens)
        mnt = int(self.rng.integers(nt[0], nt[1] + 1))
        return max(n, 1), mnt

    def _next_arrival(self) -> float:
        """Advance the stream clock to the next arrival and return it."""
        self._t += float(self.rng.exponential(self.tick_s / self.arrival_rate))
        return self._t

    def _emit(self, t: float) -> FleetRequest:
        plen, mnt = self._shape()
        prompt = [int(x) for x in
                  self.rng.integers(1, self.vocab_size, size=plen)]
        deadline = (t + self.deadline_ticks * self.tick_s
                    if self.deadline_ticks is not None else None)
        # class_mix=None draws no extra randomness, so existing seeded traces
        # (every bench gate replays one) stay byte-identical.
        cls = ""
        if self.class_mix is not None:
            names = sorted(self.class_mix)
            weights = np.array([self.class_mix[c] for c in names], dtype=float)
            u = self.rng.random() * weights.sum()
            cls = names[int(np.searchsorted(np.cumsum(weights), u, side="right")
                            .clip(0, len(names) - 1))]
        self._uid += 1
        return FleetRequest(uid=self._uid, prompt=prompt, max_new_tokens=mnt,
                            arrival_s=t, deadline_s=deadline, request_class=cls)

    def trace(self, n_requests: int) -> list[FleetRequest]:
        """``n_requests`` arrivals in order; repeated calls continue the
        stream (fresh generator + same seed -> identical trace)."""
        return [self._emit(self._next_arrival()) for _ in range(n_requests)]


class VariableRateTraffic(TrafficGenerator):
    """Non-homogeneous Poisson arrivals over a deterministic rate curve.

    Subclasses define :meth:`rate_at` (expected requests per tick at virtual
    instant ``t``) and :meth:`peak_rate` (its maximum).  Arrivals are drawn
    by Lewis–Shedler thinning: candidate gaps at the peak rate, each kept
    with probability ``rate_at(t) / peak_rate()`` — exact for any bounded
    rate curve, and seed-deterministic like the base generator.
    """

    def rate_at(self, t: float) -> float:
        raise NotImplementedError

    def peak_rate(self) -> float:
        raise NotImplementedError

    def _next_arrival(self) -> float:
        peak = self.peak_rate()
        mean_gap = self.tick_s / peak
        while True:
            self._t += float(self.rng.exponential(mean_gap))
            if self.rng.random() * peak <= self.rate_at(self._t):
                return self._t


class BurstyTraffic(VariableRateTraffic):
    """Square-wave load: a base rate punctuated by periodic bursts.

    Every ``burst_every_ticks`` ticks a burst of ``burst_len_ticks`` begins
    during which the arrival rate jumps from ``arrival_rate`` to
    ``burst_rate``; ``offset_ticks`` delays the first burst.  This is the
    canonical autoscaler workload: sustained spikes a fixed fleet must
    either over-provision for or shed.
    """

    def __init__(self, *, burst_rate: float, burst_every_ticks: float,
                 burst_len_ticks: float, offset_ticks: float = 0.0, **kw):
        super().__init__(**kw)
        if burst_rate < self.arrival_rate:
            raise ValueError("burst_rate must be >= arrival_rate")
        if not 0 < burst_len_ticks <= burst_every_ticks:
            raise ValueError("need 0 < burst_len_ticks <= burst_every_ticks")
        self.burst_rate = burst_rate
        self.burst_every_ticks = burst_every_ticks
        self.burst_len_ticks = burst_len_ticks
        self.offset_ticks = offset_ticks

    def phase_at(self, t: float) -> str:
        """``"burst"`` or ``"base"`` at virtual instant ``t``."""
        ticks = t / self.tick_s - self.offset_ticks
        if ticks < 0:
            return "base"
        return ("burst" if ticks % self.burst_every_ticks < self.burst_len_ticks
                else "base")

    def rate_at(self, t: float) -> float:
        return self.burst_rate if self.phase_at(t) == "burst" else self.arrival_rate

    def peak_rate(self) -> float:
        return self.burst_rate


class DiurnalTraffic(VariableRateTraffic):
    """Sinusoidal load: rate swings ``±amplitude`` around ``arrival_rate``
    with period ``period_ticks`` — the day/night demand curve, for
    predictive-scaling experiments and slow-ramp controller tests."""

    def __init__(self, *, period_ticks: float, amplitude: float | None = None,
                 **kw):
        super().__init__(**kw)
        if period_ticks <= 0:
            raise ValueError("period_ticks must be positive")
        self.period_ticks = period_ticks
        self.amplitude = (amplitude if amplitude is not None
                          else 0.8 * self.arrival_rate)
        if not 0 <= self.amplitude <= self.arrival_rate:
            raise ValueError("amplitude must lie in [0, arrival_rate]")

    def rate_at(self, t: float) -> float:
        phase = 2.0 * math.pi * (t / self.tick_s) / self.period_ticks
        return self.arrival_rate + self.amplitude * math.sin(phase)

    def peak_rate(self) -> float:
        return self.arrival_rate + self.amplitude


# ---------------------------------------------------------------------------
# Recorded-trace replay
# ---------------------------------------------------------------------------


def save_trace(path: str, requests: "list[FleetRequest]") -> None:
    """Write a request trace as JSON-lines (arrival order preserved).

    Only the *workload* fields are recorded — arrival time, prompt, token
    budget, deadline, EOS — so a saved trace replays identically regardless
    of what routing/scaling outcome it had when recorded.
    """
    with open(path, "w") as f:
        for r in requests:
            f.write(json.dumps({
                "uid": r.uid, "arrival_s": r.arrival_s, "prompt": r.prompt,
                "max_new_tokens": r.max_new_tokens,
                "deadline_s": r.deadline_s, "eos_id": r.eos_id,
                "request_class": r.request_class}) + "\n")


def load_trace(path: str) -> "list[FleetRequest]":
    """Load a trace saved by :func:`save_trace` (or a recorded production
    log in the same JSON-lines shape) for replay through a fleet."""
    out: list[FleetRequest] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            d = json.loads(line)
            out.append(FleetRequest(
                uid=int(d["uid"]), prompt=[int(t) for t in d["prompt"]],
                max_new_tokens=int(d["max_new_tokens"]),
                arrival_s=float(d["arrival_s"]),
                deadline_s=(float(d["deadline_s"])
                            if d.get("deadline_s") is not None else None),
                eos_id=(int(d["eos_id"])
                        if d.get("eos_id") is not None else None),
                request_class=str(d.get("request_class", ""))))
    out.sort(key=lambda r: r.arrival_s)
    return out
