"""Request router: bounded admission queue + pluggable dispatch policies.

A copy of ``repro.fleet.router`` (the port imports nothing of ``repro``).

The router is the fleet's front door.  Requests are **submitted** into a
bounded FIFO queue (overflow raises :class:`QueueFull` — the backpressure
signal callers shed on) and **dispatched** to engine replicas at their step
boundaries by a :class:`DispatchPolicy`:

* ``round_robin``   — cycle replicas, skipping ones with no free slot;
* ``least_loaded``  — the replica with the most free decode slots;
* ``plan_aware``    — the replica whose :class:`~repro_torch.core.resolution.\
ExecutionPlan` resolves the request's prefill bucket at the best tier
  (exact > transfer > static > default), ties broken by free slots — route
  work to the replica already holding the best schedules for its shape.
  When a request carries a deadline and replicas expose ``expected_step_s``
  (the paged replicas do), replicas whose projected completion time fits the
  deadline outrank those whose does not, *before* tier quality is compared —
  a fast-enough replica with a weaker plan beats a slow one with exact
  schedules that would blow the deadline anyway.

Requests whose deadline passed while queued are shed at dispatch time
(``shed_deadline``); every arrival is recorded into the optional
:class:`~repro_torch.fleet.demand.DemandTracker` (even shed ones — sheds are
demand too, and exactly the shapes worth tuning for).

Policies see replicas through a tiny surface: ``free_slots`` (property) and
``prefill_tier_score(prompt_len)`` — both the real fleet replica wrapper and
test fakes implement it.  ``register_policy`` adds new policies without
touching the router.
"""
from __future__ import annotations

import collections
from typing import Callable, Sequence

from repro_torch.core.resolution import TIERS
from repro_torch.fleet.traffic import FleetRequest
from repro_torch.obs import NULL_TRACER, MetricsRegistry

#: Tier quality used by plan-aware routing: strongest tier scores highest
#: (exact=3 .. default=0), derived from the resolution pipeline's order.
TIER_SCORE = {t: float(i) for i, t in enumerate(reversed(TIERS))}


class QueueFull(RuntimeError):
    """Admission queue at capacity: the router's backpressure signal."""


class DispatchPolicy:
    """Choose a replica index for a request (None: no eligible replica).

    ``eligible`` is the subset of replica indices the fleet allows right now
    (at a step boundary with a free slot); policies must pick from it.
    """

    name = "policy"

    def select(self, req: FleetRequest, replicas: Sequence,
               eligible: Sequence[int], *, now: float = 0.0) -> int | None:
        raise NotImplementedError


class RoundRobin(DispatchPolicy):
    """Cycle replica indices, skipping ineligible ones."""

    name = "round_robin"

    def __init__(self) -> None:
        self._next = 0

    def select(self, req, replicas, eligible, *, now=0.0):
        if not eligible:
            return None
        pool = set(eligible)
        n = len(replicas)
        for i in range(n):
            idx = (self._next + i) % n
            if idx in pool:
                self._next = (idx + 1) % n
                return idx
        return None


class LeastLoaded(DispatchPolicy):
    """The eligible replica with the most free decode slots."""

    name = "least_loaded"

    def select(self, req, replicas, eligible, *, now=0.0):
        if not eligible:
            return None
        return max(eligible, key=lambda i: (replicas[i].free_slots, -i))


class PlanAware(DispatchPolicy):
    """Prefer the replica whose plan resolves this prompt's prefill bucket
    at the best tier; free slots break ties (then lowest index).

    Deadline fit is the leading key: for a request with ``deadline_s``, a
    replica exposing ``expected_step_s`` (its cost-model estimate for the
    next iteration) is projected forward ``max_new_tokens`` steps from
    ``now`` — replicas that land inside the deadline sort ahead of those
    that do not.  Replicas without the gauge (the slot engine, test fakes)
    are treated as fitting, which degrades to the pre-deadline ordering.

    Speculating replicas commit more than one token per iteration, so a
    per-step projection over-estimates them; when a replica exposes a
    per-class ``expected_token_s(request_class)`` (non-None — the paged
    replica returns one exactly when speculation is on), the projection
    uses the request's class-specific seconds-per-committed-token instead.
    """

    name = "plan_aware"

    @staticmethod
    def _fits(req, replica, now: float) -> float:
        if req.deadline_s is None:
            return 1.0
        horizon = max(1, getattr(req, "max_new_tokens", 1))
        tok_s = getattr(replica, "expected_token_s", None)
        if tok_s is not None:
            per_tok = tok_s(getattr(req, "request_class", ""))
            if per_tok is not None:
                return 1.0 if now + per_tok * horizon <= req.deadline_s else 0.0
        step_s = getattr(replica, "expected_step_s", None)
        if step_s is None:
            return 1.0
        step_s = step_s() if callable(step_s) else step_s
        return 1.0 if now + step_s * horizon <= req.deadline_s else 0.0

    def select(self, req, replicas, eligible, *, now=0.0):
        if not eligible:
            return None
        return max(eligible,
                   key=lambda i: (self._fits(req, replicas[i], now),
                                  replicas[i].prefill_tier_score(len(req.prompt)),
                                  replicas[i].free_slots, -i))


POLICIES: dict[str, type[DispatchPolicy]] = {}


def register_policy(cls: type[DispatchPolicy]) -> type[DispatchPolicy]:
    """Register a policy class under its ``name`` (also usable as a
    decorator for out-of-tree policies)."""
    POLICIES[cls.name] = cls
    return cls


for _cls in (RoundRobin, LeastLoaded, PlanAware):
    register_policy(_cls)


def make_policy(policy: "str | DispatchPolicy") -> DispatchPolicy:
    """Resolve a policy name to a fresh instance (policies are stateful)."""
    if isinstance(policy, DispatchPolicy):
        return policy
    try:
        return POLICIES[policy]()
    except KeyError:
        raise KeyError(f"unknown dispatch policy {policy!r}; "
                       f"registered: {sorted(POLICIES)}") from None


class RequestRouter:
    """Bounded admission queue in front of N replicas.

    ``submit`` enqueues (raising :class:`QueueFull` at ``queue_cap``) and
    records demand; ``dispatch`` drains the queue head-first through the
    policy until no replica is eligible, shedding deadline-expired requests
    as it goes.  The router never touches engines directly — the ``admit``
    callback (the fleet) performs the actual admission, so the router stays
    testable with fake replicas.
    """

    def __init__(self, replicas: Sequence, *,
                 policy: "str | DispatchPolicy" = "round_robin",
                 queue_cap: int = 64, demand=None,
                 metrics: MetricsRegistry | None = None, tracer=None):
        if queue_cap <= 0:
            raise ValueError("queue_cap must be positive")
        self.replicas = list(replicas)
        self.requeued = 0
        self.policy = make_policy(policy)
        self.queue: collections.deque[FleetRequest] = collections.deque()
        self.queue_cap = queue_cap
        self.demand = demand
        self.max_queue_depth = 0
        #: Requests shed for a passed deadline during the latest dispatch
        #: (callers fold them into their metrics after each call).
        self.last_shed_deadline: list[FleetRequest] = []
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.counters = self.metrics.group(
            "router", ["submitted", "shed_queue_full", "shed_deadline",
                       "dispatched"])

    @property
    def depth(self) -> int:
        return len(self.queue)

    # -- dynamic replica set ---------------------------------------------------
    def add_replica(self, replica) -> int:
        """Register a new replica; returns its (stable) index.

        Indices are positional and never reused — a retired replica keeps
        its slot in the list and is excluded from dispatch by the
        ``dispatchable`` flag, so policies and in-flight requests holding an
        index stay valid across the fleet's whole lifetime.
        """
        self.replicas.append(replica)
        return len(self.replicas) - 1

    def requeue(self, reqs: Sequence[FleetRequest]) -> None:
        """Return already-admitted requests to the *front* of the queue.

        Used by drain-retire: requests a draining replica had queued but
        never started go back ahead of new arrivals and are exempt from
        ``queue_cap`` — they were admitted once, so bouncing them now would
        silently drop accepted work.
        """
        for req in reversed(list(reqs)):
            self.queue.appendleft(req)
            self.requeued += 1
        self.max_queue_depth = max(self.max_queue_depth, len(self.queue))

    # -- admission -------------------------------------------------------------
    def submit(self, req: FleetRequest) -> None:
        """Enqueue a request; raises :class:`QueueFull` at capacity.

        Demand is recorded for *every* arrival, shed or not: a shed request
        is still evidence its shape is hot.  Deadlines are enforced at
        :meth:`dispatch` time, not here — an expired request still leaves
        the queue through the shed path so it is accounted exactly once.
        """
        self.counters["submitted"] += 1
        if self.demand is not None:
            self.demand.record(req)
        if len(self.queue) >= self.queue_cap:
            req.shed = "queue_full"
            self.counters["shed_queue_full"] += 1
            if self.tracer.enabled:
                self.tracer.event("shed", "router", uid=req.uid,
                                  reason="queue_full", depth=len(self.queue))
            raise QueueFull(
                f"admission queue at capacity ({self.queue_cap})")
        self.queue.append(req)
        self.max_queue_depth = max(self.max_queue_depth, len(self.queue))
        if self.tracer.enabled:
            self.tracer.event("submit", "router", uid=req.uid,
                              depth=len(self.queue))

    # -- dispatch --------------------------------------------------------------
    def dispatch(self, now: float = 0.0, *,
                 eligible: "Callable[[], Sequence[int]] | Sequence[int] | None" = None,
                 admit: "Callable[[FleetRequest, int], None] | None" = None,
                 ) -> list[tuple[FleetRequest, int]]:
        """Assign queued requests to replicas until the policy finds none.

        ``eligible`` is a callable re-evaluated per assignment (admission
        changes slot occupancy), a static index list, or None (any replica
        with a free slot).  ``admit(req, idx)`` performs the admission;
        without one, ``replicas[idx].admit(req, now)`` is called.  An admit
        that returns ``False`` vetoed the placement (e.g. the engine shed
        the request as invalid) — the request counts as neither queued nor
        dispatched.  Returns the (request, replica index) assignments made.
        """
        shed_deadline: list[FleetRequest] = []
        out: list[tuple[FleetRequest, int]] = []
        while self.queue:
            req = self.queue[0]
            if req.deadline_s is not None and now > req.deadline_s:
                self.queue.popleft()
                req.shed = "deadline"
                self.counters["shed_deadline"] += 1
                if self.tracer.enabled:
                    self.tracer.event("shed", "router", t=now, uid=req.uid,
                                      reason="deadline")
                shed_deadline.append(req)
                continue
            if callable(eligible):
                elig = [i for i in eligible()
                        if self.replicas[i].free_slots > 0]
            elif eligible is not None:
                elig = [i for i in eligible if self.replicas[i].free_slots > 0]
            else:
                # Draining/retired replicas advertise dispatchable=False and
                # never receive new work (fakes without the flag all do).
                elig = [i for i, r in enumerate(self.replicas)
                        if r.free_slots > 0
                        and getattr(r, "dispatchable", True)]
            idx = self.policy.select(req, self.replicas, elig, now=now)
            if idx is None:
                break
            self.queue.popleft()
            if admit is not None:
                placed = admit(req, idx)
            else:
                placed = self.replicas[idx].admit(req, now)
            if placed is False:
                continue
            self.counters["dispatched"] += 1
            if self.tracer.enabled:
                self.tracer.event("dispatch", "router", t=now, uid=req.uid,
                                  replica=idx, policy=self.policy.name)
            out.append((req, idx))
        self.last_shed_deadline = shed_deadline
        return out

    # -- telemetry ------------------------------------------------------------
    def stats(self) -> dict:
        out = dict(self.counters)
        out["policy"] = self.policy.name
        out["queue_depth"] = self.depth
        out["queue_cap"] = self.queue_cap
        out["max_queue_depth"] = self.max_queue_depth
        out["requeued"] = self.requeued
        return out
