"""Demand tracking: per-(prefill-bucket) arrival counts drive tuning order.

A copy of ``repro.fleet.demand`` (the port imports nothing of ``repro``).

The paper's economics are about *where to spend search*: transfer-tuning
makes each tuned schedule cheap, but a fleet still has a bounded background
tuning budget, so the order in which shapes graduate default → transfer →
exact matters.  :class:`DemandTracker` aggregates what the router actually
sees — arrival counts keyed by prefill bucket — and ranks buckets hottest
first, so the fleet can prefetch tuning jobs for the shapes traffic is
hitting *now* while cold shapes never spend budget.

With ``half_life_s`` set, counts decay exponentially in *virtual seconds*
(each arrival's weight halves every ``half_life_s`` of trace time), so the
ranking tracks current traffic: a bucket that was hot an hour ago no longer
outranks the bucket that is hot now.  This is the signal both prefetch
priority and the autoscaler's demand view consume — without decay, a load
shift would keep tuning (and scaling for) yesterday's shapes.
"""
from __future__ import annotations

import collections
from typing import Callable

from repro_torch.fleet.traffic import FleetRequest

#: Decayed weights below this are dropped from the table entirely: a bucket
#: that has not seen traffic for many half-lives stops being demand at all.
_EPS = 1e-9


class DemandTracker:
    """Arrival counts per workload bucket (prefill bucket length).

    ``bucket_for`` maps a prompt length to its bucket — normally the
    reference replica's :meth:`~repro_torch.serving.ServingEngine.bucket_for`, so
    demand is keyed exactly the way the engines pad and the plans resolve.
    Without one, the raw prompt length is the bucket.

    ``half_life_s``: when set, every count decays by ``0.5 ** (dt /
    half_life_s)`` as the stream clock (the latest ``arrival_s`` seen)
    advances ``dt`` virtual seconds.  ``None`` (default) keeps exact integer
    counts that never decay.
    """

    def __init__(self, bucket_for: "Callable[[int], int] | None" = None, *,
                 half_life_s: float | None = None):
        if half_life_s is not None and half_life_s <= 0:
            raise ValueError("half_life_s must be positive")
        self.bucket_for = bucket_for
        self.half_life_s = half_life_s
        self.counts: collections.Counter[int] = collections.Counter()
        self._now = 0.0  # stream clock: the latest arrival time seen

    def _decay_to(self, t: float) -> None:
        """Advance the stream clock to ``t``, decaying every bucket."""
        if self.half_life_s is None or t <= self._now:
            return
        factor = 0.5 ** ((t - self._now) / self.half_life_s)
        self._now = t
        for b in list(self.counts):
            v = self.counts[b] * factor
            if v < _EPS:
                del self.counts[b]
            else:
                self.counts[b] = v

    def record(self, req: FleetRequest) -> int:
        """Count one arrival; stamps and returns the request's bucket."""
        n = len(req.prompt)
        bucket = self.bucket_for(n) if self.bucket_for is not None else n
        req.bucket = bucket
        self._decay_to(req.arrival_s)
        self.counts[bucket] += 1
        return bucket

    @property
    def total(self) -> float:
        return sum(self.counts.values())

    def hottest(self) -> list[tuple[int, float]]:
        """(bucket, count) pairs, hottest first (ties: smaller bucket)."""
        return sorted(self.counts.items(), key=lambda kv: (-kv[1], kv[0]))

    def weighted(self, value_of: Callable[[int], float]) -> float:
        """Traffic-weighted mean of a per-bucket value (0.0 with no demand)."""
        total = self.total
        if total == 0:
            return 0.0
        return sum(c * value_of(b) for b, c in self.counts.items()) / total

    def stats(self) -> dict:
        return {"total": self.total,
                "half_life_s": self.half_life_s,
                "buckets": {str(b): round(c, 4) if self.half_life_s else c
                            for b, c in self.hottest()}}
