"""Per-class speculative acceptance tracking for routing decisions.

A copy of ``repro.fleet.acceptance`` (the port imports nothing of ``repro``).

Speculative decoding only pays when the draft agrees with the target often
enough: the burst commits ``expected_committed_tokens(k, alpha)`` tokens for
a cost of ``(k+1)`` draft steps plus one verify, so the break-even acceptance
rate depends on the measured cost ratio.  ``alpha`` is a *traffic* property,
not a model property — chat-style continuations are easy to draft, bulk
extraction over rare tokens is not — so the fleet tracks it per request
class and decides spec-vs-plain per request at admit time.

:class:`AcceptanceTracker` mirrors :class:`~repro_torch.fleet.demand.DemandTracker`
mechanics: decayed counters in virtual seconds (each observation's weight
halves every ``half_life_s`` of trace time), so a class whose draftability
shifts — a prompt-template change, say — re-converges instead of being
pinned to stale history.  A Beta-style prior (``prior_alpha`` worth of
``prior_weight`` pseudo-tokens) keeps cold classes optimistic enough to
*try* speculation and gather real evidence.
"""
from __future__ import annotations

#: Decayed weights below this drop the class entry entirely.
_EPS = 1e-9


class AcceptanceTracker:
    """Decayed per-class acceptance-rate estimates for speculative routing.

    ``record(cls, proposed, accepted, t)`` folds one burst's outcome in;
    ``alpha(cls)`` returns the current blended estimate.  Classes are plain
    strings; the empty string is the unclassified bucket and works like any
    other class.
    """

    def __init__(self, *, half_life_s: float | None = None,
                 prior_alpha: float = 0.7, prior_weight: float = 8.0):
        if half_life_s is not None and half_life_s <= 0:
            raise ValueError("half_life_s must be positive")
        if not 0.0 <= prior_alpha <= 1.0:
            raise ValueError("prior_alpha must lie in [0, 1]")
        if prior_weight < 0:
            raise ValueError("prior_weight must be non-negative")
        self.half_life_s = half_life_s
        self.prior_alpha = prior_alpha
        self.prior_weight = prior_weight
        self._proposed: dict[str, float] = {}
        self._accepted: dict[str, float] = {}
        self._now = 0.0  # stream clock: latest observation time seen

    def _decay_to(self, t: float) -> None:
        if self.half_life_s is None or t <= self._now:
            return
        factor = 0.5 ** ((t - self._now) / self.half_life_s)
        self._now = t
        for cls in list(self._proposed):
            p = self._proposed[cls] * factor
            if p < _EPS:
                del self._proposed[cls]
                del self._accepted[cls]
            else:
                self._proposed[cls] = p
                self._accepted[cls] *= factor

    def record(self, cls: str, proposed: int, accepted: int,
               t: float = 0.0) -> None:
        """Fold one burst outcome (``accepted`` of ``proposed`` draft tokens
        matched the target) observed at virtual instant ``t``."""
        if proposed < 0 or not 0 <= accepted <= max(proposed, 0):
            raise ValueError("need 0 <= accepted <= proposed")
        self._decay_to(t)
        if proposed == 0:
            return
        self._proposed[cls] = self._proposed.get(cls, 0.0) + proposed
        self._accepted[cls] = self._accepted.get(cls, 0.0) + accepted

    def alpha(self, cls: str = "") -> float:
        """Blended acceptance-rate estimate for ``cls``.

        With no evidence this is exactly ``prior_alpha``; evidence shifts the
        estimate toward the measured rate with weight proportional to the
        (decayed) observed token count.
        """
        p = self._proposed.get(cls, 0.0)
        a = self._accepted.get(cls, 0.0)
        denom = p + self.prior_weight
        if denom <= 0:
            return self.prior_alpha
        return (a + self.prior_alpha * self.prior_weight) / denom

    def observed(self, cls: str = "") -> float:
        """Decayed count of proposed tokens seen for ``cls`` (evidence mass)."""
        return self._proposed.get(cls, 0.0)

    def stats(self) -> dict:
        """Per-class ``{alpha, proposed}`` snapshot, plus the prior."""
        return {"prior_alpha": self.prior_alpha,
                "prior_weight": self.prior_weight,
                "half_life_s": self.half_life_s,
                "classes": {cls: {"alpha": round(self.alpha(cls), 4),
                                  "proposed": round(p, 2)}
                            for cls, p in sorted(self._proposed.items())}}
