"""Serving fleet: N engine replicas behind one router and one registry.

The port of ``repro.fleet.fleet`` onto the port's engines, schedule
provider, tuning service and runners (it imports nothing of ``repro``).
The serve loop, the replicas' pricing, routing, prefetch and the elastic
lifecycle are the reference's, line for line; what differs is the clock's
source and what the engines run on:

* **The runner.**  Each hardware target gets one runner, shared by its
  tuning service and its replicas
  (:func:`~repro_torch.core.measured_runner.target_runner`): the TPU cost model
  for a TPU target, as in the reference, and for a measured target
  (``h100``) the port's kernels timed on the card,
  ``CachedRunner(MeasuredRunner(target=...))``, as
  :func:`repro_torch.launch.serve.make_provider` serves it.  So on the card
  the virtual clock is measured kernel time: each distinct (instance,
  schedule) pair is timed once, and ``tick_s`` is the untuned decode step's
  measured device seconds.  A measured target on engines that are not on
  the card is refused.
* **Timing between steps only.**  The services run ``max_workers=0`` and
  drain their jobs inline between events, so no thread times kernels while
  an engine serves.  On a measured target a replica also resolves the
  instances a step will run before it runs it (:meth:`Replica._warm`), so
  the service's lookups time them between steps, never inside the forward
  pass.
* **The engines** run eager PyTorch over the port's CUDA kernels (the
  reference's are jitted).  ``extras`` (encoder frames, patch embeddings)
  reach every slot engine, as in the reference; the paged engine refuses
  the audio and vision archs, as the reference's does.

This is the layer the ROADMAP's north star asks for — a front-end that
turns a request *stream* into batched work across engine replicas — built
so the paper's economics compose at scale:

* **One registry, N replicas** — every replica resolves through its own
  :class:`~repro_torch.core.resolution.ResolutionPipeline` over a *shared*
  :class:`~repro_torch.service.TuningService` (per hardware target) and the one
  :class:`~repro_torch.service.ScheduleRegistry`.  A background publish triggered
  by traffic on any replica reaches every replica through the existing
  generation check at its next decode-step boundary — no fleet-level
  invalidation protocol, and zero cross-replica schedule divergence
  (:meth:`ServingFleet.schedule_mismatches` asserts it).
* **Demand-driven tuning** — the router's :class:`~repro_torch.fleet.demand.\
DemandTracker` aggregates per-prefill-bucket arrival counts; the fleet
  prefetches tuning jobs for the hottest *unresolved* buckets
  (:meth:`~repro_torch.service.TuningService.prefetch`, priority = arrival
  count), so hot shapes graduate default → transfer → exact first and cold
  shapes never spend budget.
* **Virtual-time simulation** — replica step durations come from the
  runner (the resolved plan's kernel seconds), so schedule quality feeds
  straight into latency/throughput: a replica serving exact-tier schedules
  finishes its steps sooner, drains its queue faster, and sheds less.  The
  engines still run *real* prefill/decode steps — tokens, caches,
  replans, and plan propagation are the production code paths, only the
  clock is simulated.

Heterogeneous fleets are supported by giving replicas different hardware
targets (``targets=[...]`` from :mod:`repro_torch.targets`): replicas sharing a
target share a TuningService (one namespace), targets never leak into each
other, and ``donor_target`` lets e.g. edge replicas transfer from the
server-tuned pool.

The replica set is *elastic* (DESIGN.md §9): :meth:`ServingFleet.\
add_replica` warm-joins a replica whose plan resolves at the current shared
registry generation (it inherits every published exact-tier schedule before
its first request), :meth:`ServingFleet.retire_replica` drain-retires one
(no new dispatch, in-flight work finishes, engine-queued work is re-routed,
pending tuning jobs are cancelled), and an attached
:class:`~repro_torch.fleet.autoscale.Autoscaler` drives both from windowed
telemetry inside :meth:`ServingFleet.serve`.
"""
from __future__ import annotations

import json
from typing import Any, Sequence

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core.extract import extract_kernels
from repro_torch.core.resolution import Resolution, spec_verify_uses
from repro_torch.core.measured_runner import target_runner
from repro_torch.core.runner import MEASURED_TARGETS, CachedRunner
from repro_torch.core.schedule import ScheduleInvalid
from repro_torch.core.workload import KernelInstance, KernelUse
from repro_torch.fleet.acceptance import AcceptanceTracker
from repro_torch.fleet.advisor import TuningAdvisor
from repro_torch.fleet.demand import DemandTracker
from repro_torch.fleet.metrics import FleetMetrics
from repro_torch.fleet.router import TIER_SCORE, QueueFull, RequestRouter
from repro_torch.fleet.traffic import FleetRequest
from repro_torch.kernels.ops import ScheduleProvider
from repro_torch.obs import (NULL_TRACER, MetricsRegistry, SLOMonitor,
                       SpeedupLedger, default_slos)
from repro_torch.serving import PagedServingEngine, ServingEngine
from repro_torch.serving.speculative import expected_committed_tokens
from repro_torch.serving.speculative import spec_gain as _spec_gain
from repro_torch.targets import DEFAULT_TARGET, target_name


class Replica:
    """One :class:`ServingEngine` behind the router, with a virtual clock.

    ``time`` is the virtual instant the replica's current work (a prefill or
    a batched decode step) finishes; ``step_pending`` marks that a decode
    step must actually execute (``engine.step()``) when that instant is
    reached.  Step costs are summed from the engine's execution plan through
    the service's runner and memoized per plan generation — an upgrade that
    lands mid-stream speeds the very next step up.
    """

    def __init__(self, idx: int, cfg: ArchConfig, engine: ServingEngine,
                 service=None, target: str = DEFAULT_TARGET, runner=None):
        self.idx = idx
        self.cfg = cfg
        self.engine = engine
        self.service = service
        self.target = target
        # Observability rides the engine's binding (the fleet sets it before
        # wrapping); bare engines fall back to the no-op tracer.
        self.tracer = getattr(engine, "tracer", NULL_TRACER)
        self.track = getattr(engine, "trace_track", f"replica-{idx}")
        self.time = 0.0
        self.busy = False
        self.step_pending = False
        self._step_t0 = 0.0
        self.requests_admitted = 0
        # Lifecycle: active (serving) -> draining (no new dispatch, in-flight
        # finishing) -> retired (empty, clock stopped).  Indices are stable:
        # a retired replica keeps its slot in the fleet's list.
        self.state = "active"
        self.joined_s = 0.0
        self.retired_s: float | None = None
        if runner is None:
            runner = (service.runner if service is not None
                      else target_runner(target, engine.model.device))
        self._runner = runner
        self._measured = target_name(target) in MEASURED_TARGETS
        self._mode = service.mode if service is not None else "strict"
        self._fleet_reqs: dict[int, FleetRequest] = {}  # engine uid -> request
        self._decode_uses = self._serving_uses()
        self._bucket_uses: dict[int, list[KernelUse]] = {}
        # Plan-derived memos, valid for exactly one plan generation: a
        # re-plan drops them wholesale, so a long-lived replica never
        # accumulates entries for superseded generations.
        self._caches_gen: int | None = None
        self._cost_cache: dict[Any, float] = {}
        self._score_cache: dict[int, tuple[float, float]] = {}
        self._workload_cache: dict[str, list] = {}
        #: Observed cell executions (``prefill:<bucket>``, ``decode``, the
        #: paged spec cells ...) — the live critical-path signal the
        #: profiler, ledger, and TuningAdvisor read without a tracer.
        self.cell_counts: dict[str, float] = {}
        self._cell_emitted: dict[str, int] = {}  # cell -> plan generation

    def _serving_uses(self) -> list[KernelUse]:
        """Kernels of this engine's batched decode cell (subclass hook)."""
        return extract_kernels(
            self.cfg, ShapeConfig("serve_decode", self.engine.max_len,
                                  self.engine.slots, "decode"), dp=1, tp=1)

    # -- surfaces the router sees ---------------------------------------------
    @property
    def free_slots(self) -> int:
        return self.engine.free_slots

    @property
    def dispatchable(self) -> bool:
        """Whether the router may send *new* work here (active only)."""
        return self.state == "active"

    def utilization(self) -> float:
        return self.engine.utilization()

    def bucket_for(self, prompt_len: int) -> int:
        return self.engine.bucket_for(min(prompt_len, self.engine.max_len))

    def prefill_tier_score(self, prompt_len: int) -> float:
        """Mean tier quality (exact=3 .. default=0) of this replica's plan
        over the prompt's prefill-bucket kernels — what plan-aware routing
        ranks replicas by."""
        return self._bucket_quality(self.bucket_for(prompt_len))[0]

    def prefill_exact_share(self, bucket: int) -> float:
        """Fraction of the bucket's kernels resolved at the exact tier."""
        return self._bucket_quality(bucket)[1]

    # -- plan-derived costs ----------------------------------------------------
    def _generation(self) -> int:
        return self.engine.plan.generation if self.engine.plan is not None else -1

    def _resolution(self, inst: KernelInstance) -> Resolution:
        plan = self.engine.plan
        res = plan.lookup(inst) if plan is not None else None
        if res is None:  # outside the plan: the pipeline memo answers
            res = self.engine.provider.pipeline.resolve(inst)
        return res

    def _warm(self, uses: Sequence[KernelUse], head_rows: int | None = None) -> None:
        """Resolve ``uses`` now, before the engine runs them, so a measured
        runner times what their lookups need here, between steps, and never
        inside the forward pass (a no-op on a modelled target).  The ops key
        two instances otherwise than ``extract_kernels`` lists them (ROADMAP
        C.5): global attention with ``window=0``, and a one-shot prefill's
        LM head at its last position only (``head_rows`` rows); those keys
        are resolved too."""
        if not self._measured:
            return
        for u in uses:
            inst = u.instance
            self._resolution(inst)
            p = inst.p
            if inst.family == "attention" and "window" not in p:
                self._resolution(KernelInstance.make(inst.class_id, inst.dtype, **p, window=0))
            elif head_rows is not None and inst.class_id.startswith("matmul_lmhead"):
                self._resolution(KernelInstance.make(inst.class_id, inst.dtype,
                                                     **{**p, "M": head_rows}))

    @property
    def decode_uses(self) -> list[KernelUse]:
        """Kernels of the batched decode step (every request exercises them)."""
        return self._decode_uses

    def prefill_uses(self, bucket: int) -> list[KernelUse]:
        uses = self._bucket_uses.get(bucket)
        if uses is None:
            uses = self._bucket_uses[bucket] = extract_kernels(
                self.cfg, ShapeConfig(f"serve_prefill_{bucket}", bucket, 1,
                                      "prefill"), dp=1, tp=1)
        return uses

    def _fresh_caches(self) -> None:
        gen = self._generation()
        if gen != self._caches_gen:
            self._cost_cache.clear()
            self._score_cache.clear()
            self._workload_cache.clear()
            self._caches_gen = gen

    def _uses_cost(self, uses: Sequence[KernelUse], cache_key: Any) -> float:
        self._fresh_caches()
        cost = self._cost_cache.get(cache_key)
        if cost is None:
            cost = 0.0
            for u in uses:
                sched = self._resolution(u.instance).schedule
                try:
                    secs = self._runner.seconds(u.instance, sched,
                                                mode=self._mode)
                except ScheduleInvalid:
                    secs = self._runner.seconds(u.instance, None)
                cost += u.use_count * secs
            self._cost_cache[cache_key] = cost
        return cost

    def _bucket_quality(self, bucket: int) -> tuple[float, float]:
        self._fresh_caches()
        q = self._score_cache.get(bucket)
        if q is None:
            uses = self.prefill_uses(bucket)
            tiers = [self._resolution(u.instance).tier for u in uses]
            score = sum(TIER_SCORE[t] for t in tiers) / len(tiers)
            exact = sum(1 for t in tiers if t == "exact") / len(tiers)
            q = self._score_cache[bucket] = (score, exact)
        return q

    def decode_cost(self) -> float:
        """Virtual seconds one batched decode step takes under the plan."""
        return self._uses_cost(self._decode_uses, "decode")

    def prefill_cost(self, bucket: int) -> float:
        return self._uses_cost(self.prefill_uses(bucket), ("prefill", bucket))

    def untuned_decode_cost(self) -> float:
        return sum(u.use_count * self._runner.seconds(u.instance, None)
                   for u in self._decode_uses)

    # -- cell accounting (critical-path attribution) ---------------------------
    def cell_uses(self, cell: str) -> list[KernelUse]:
        """Kernel uses of one cost cell, by its counter id."""
        if cell == "decode":
            return self._decode_uses
        kind, _, arg = cell.partition(":")
        if kind == "prefill":
            return self.prefill_uses(int(arg))
        raise KeyError(f"unknown cell {cell!r}")

    def use_resolution(self, inst: KernelInstance) -> Resolution:
        """Public view of the plan's resolution for one kernel instance."""
        return self._resolution(inst)

    def use_seconds(self, inst: KernelInstance, schedule) -> float:
        """Per-call seconds of ``inst`` under ``schedule`` (None/invalid ->
        untuned) — the same pricing ``_uses_cost`` charges the clock."""
        if schedule is not None:
            try:
                return self._runner.seconds(inst, schedule, mode=self._mode)
            except ScheduleInvalid:
                pass
        return self._runner.seconds(inst, None)

    def cell_workload_seconds(self, cell: str) -> "list[tuple[KernelUse, float]]":
        """Per-execution seconds of each workload in ``cell`` under the
        current plan (``use_count`` folded in, so the pairs sum to exactly
        what one execution charges the virtual clock).  Memoized per plan
        generation alongside the cost caches."""
        self._fresh_caches()
        rows = self._workload_cache.get(cell)
        if rows is None:
            rows = self._workload_cache[cell] = [
                (u, u.use_count * self.use_seconds(
                    u.instance, self._resolution(u.instance).schedule))
                for u in self.cell_uses(cell)]
        return rows

    def _note_cell(self, cell: str, n: float, now: float) -> None:
        """Count ``n`` executions of ``cell`` at the instant its cost is
        charged.  When tracing, (re-)emit the cell's workload mapping once
        per plan generation — the ``cell_workloads`` events the offline
        profiler joins replica spans against."""
        self.cell_counts[cell] = self.cell_counts.get(cell, 0) + n
        if self.tracer.enabled:
            gen = self._generation()
            if self._cell_emitted.get(cell) != gen:
                self._cell_emitted[cell] = gen
                self.tracer.event(
                    "cell_workloads", self.track, t=now, cell=cell,
                    generation=gen,
                    workloads=[[u.instance.workload_key(), s]
                               for u, s in self.cell_workload_seconds(cell)])

    # -- lifecycle -------------------------------------------------------------
    def admit(self, req: FleetRequest, now: float):
        """Admit into the engine and charge the prefill to the clock."""
        if len(req.prompt) <= self.engine.max_len:
            self._warm(self.prefill_uses(req.bucket), head_rows=1)
        engine_req = self.engine.add_request(
            req.prompt, max_new_tokens=req.max_new_tokens, eos_id=req.eos_id)
        req.admitted_s = now
        req.replica = self.idx
        req.exact_share_at_admit = self.prefill_exact_share(req.bucket)
        self.requests_admitted += 1
        t0 = max(self.time, now)
        self._note_cell(f"prefill:{req.bucket}", 1, t0)
        self.time = t0 + self.prefill_cost(req.bucket)
        # The slot engine prefills synchronously: the first token exists
        # the instant the prefill's virtual time elapses.
        req.prefill_done_s = self.time
        if self.tracer.enabled:
            self.tracer.add_span("prefill", self.track, t0, self.time,
                                 uid=req.uid, bucket=req.bucket,
                                 target=self.target)
        self.busy, self.step_pending = True, False
        if not engine_req.done:
            self._fleet_reqs[engine_req.uid] = req
        return engine_req

    def complete_step(self, now: float) -> list[FleetRequest]:
        """Run the decode step that virtually ends at ``now``."""
        finished = self.engine.step()
        self.busy = self.step_pending = False
        out = []
        for er in finished:
            fr = self._fleet_reqs.pop(er.uid)
            fr.tokens = len(er.generated)
            fr.generated = list(er.generated)
            out.append(fr)
        if self.tracer.enabled:
            self.tracer.add_span("decode_step", self.track, self._step_t0,
                                 now, active=len(self.engine.active),
                                 finished=len(out))
        return out

    def start_step(self, now: float) -> None:
        self._warm(self._decode_uses)
        self._note_cell("decode", 1, now)
        self.time = now + self.decode_cost()
        self.busy, self.step_pending = True, True
        self._step_t0 = now

    def stats(self) -> dict:
        plan = self.engine.plan
        return {
            "target": self.target,
            "state": self.state,
            "joined_s": self.joined_s,
            "retired_s": self.retired_s,
            "requests": self.requests_admitted,
            "replans": self.engine.replans,
            "utilization": self.utilization(),
            "plan_tiers": plan.tier_counts() if plan is not None else {},
            "plan_generation": plan.generation if plan is not None else None,
            "prefill_traces": self.engine.prefill_trace_count,
        }


class PagedReplica(Replica):
    """A :class:`~repro_torch.serving.PagedServingEngine` behind the router.

    Everything follows from iteration-level admission: ``admit`` only
    enqueues (no synchronous prefill, so no time is charged — the request's
    chunks are billed inside the steps that run them); a step's cost is the
    engine's *planned* work for that iteration — the ``chunk_prefill``
    cells it will run plus the batched decode cell — so prefill and decode
    share the virtual clock exactly the way they share the iteration.
    ``expected_step_s`` exposes the same estimate to deadline-aware routing
    *before* the step starts (the scheduler is pure, so preview and
    execution always agree).

    When the engine speculates, the cost model grows three more cells —
    the draft's chunked prefill (keeping the draft cache in sync), the
    draft's batched decode (k+1 per burst), and the batched ``verify``
    step — and the iteration cost sums exactly what ``planned_work`` says
    will run.  The fleet installs ``acceptance`` (the per-class
    :class:`~repro_torch.fleet.acceptance.AcceptanceTracker`) plus the
    acceptance gauge / committed histogram; ``complete_step`` drains the
    engine's burst events into them.
    """

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        # Fleet-installed speculative collaborators (None: speculation off).
        self.acceptance: AcceptanceTracker | None = None
        self.spec_gauge = None
        self.spec_hist = None
        self.spec_counters = None
        self._verify_uses: list[KernelUse] | None = None
        self._draft_uses: list[KernelUse] | None = None
        self._draft_chunk_uses: dict[int, list[KernelUse]] = {}

    def _serving_uses(self) -> list[KernelUse]:
        e = self.engine
        return extract_kernels(
            self.cfg, ShapeConfig("paged_decode", e.max_ctx, e.decode_batch,
                                  "decode"), dp=1, tp=1)

    def bucket_for(self, prompt_len: int) -> int:
        return self.engine.bucket_for(prompt_len)

    def prefill_uses(self, bucket: int) -> list[KernelUse]:
        # "bucket" is a chunk length here: the same chunk_prefill cell the
        # plan (:func:`plan_serving_paged`) froze for that length.
        uses = self._bucket_uses.get(bucket)
        if uses is None:
            uses = self._bucket_uses[bucket] = extract_kernels(
                self.cfg, ShapeConfig(f"paged_chunk_{bucket}", bucket, 1,
                                      "chunk_prefill",
                                      ctx_len=self.engine.max_ctx), dp=1, tp=1)
        return uses

    # -- speculative cost cells -------------------------------------------------
    @property
    def spec_capable(self) -> bool:
        """Whether the wrapped engine has a draft attached (speculation on)."""
        return bool(getattr(self.engine, "_spec", False))

    def verify_cell_uses(self) -> list[KernelUse]:
        if self._verify_uses is None:
            e = self.engine
            self._verify_uses = spec_verify_uses(
                self.cfg, decode_batch=e.decode_batch, max_ctx=e.max_ctx,
                spec_k=e.spec_k)
        return self._verify_uses

    def draft_decode_uses(self) -> list[KernelUse]:
        if self._draft_uses is None:
            e = self.engine
            self._draft_uses = extract_kernels(
                e.draft_model.cfg,
                ShapeConfig("draft_decode", e.max_ctx, e.decode_batch,
                            "decode"), dp=1, tp=1)
        return self._draft_uses

    def verify_cost(self) -> float:
        """Virtual seconds of one batched verify step (all lanes, k+1 each)."""
        return self._uses_cost(self.verify_cell_uses(), "verify")

    def draft_decode_cost(self) -> float:
        """Virtual seconds of one batched draft decode step."""
        return self._uses_cost(self.draft_decode_uses(), "draft_decode")

    def draft_chunk_uses(self, c: int) -> list[KernelUse]:
        uses = self._draft_chunk_uses.get(c)
        if uses is None:
            uses = self._draft_chunk_uses[c] = extract_kernels(
                self.engine.draft_model.cfg,
                ShapeConfig(f"draft_chunk_{c}", c, 1, "chunk_prefill",
                            ctx_len=self.engine.max_ctx), dp=1, tp=1)
        return uses

    def draft_chunk_cost(self, c: int) -> float:
        return self._uses_cost(self.draft_chunk_uses(c), ("draft_chunk", c))

    def cell_uses(self, cell: str) -> list[KernelUse]:
        if cell == "verify":
            return self.verify_cell_uses()
        if cell == "draft_decode":
            return self.draft_decode_uses()
        kind, _, arg = cell.partition(":")
        if kind == "draft_sync":
            return self.draft_chunk_uses(int(arg))
        return super().cell_uses(cell)

    def spec_gain(self, alpha: float) -> float:
        """Projected speculate-vs-plain throughput ratio at acceptance rate
        ``alpha``, under this replica's *measured* (plan-derived) cell
        costs — the admit-time decision quantity for ``speculative="auto"``."""
        if not self.spec_capable:
            return 1.0
        return _spec_gain(self.engine.spec_k, alpha,
                          draft_cost_s=self.draft_decode_cost(),
                          verify_cost_s=self.verify_cost(),
                          decode_cost_s=self.decode_cost())

    def expected_token_s(self, request_class: str = "") -> float | None:
        """Expected virtual seconds per *committed* token for a request of
        ``request_class`` (None when not speculating — callers fall back to
        per-step projections).  Auto routing takes the better of the spec
        burst rate at the class's current acceptance estimate and plain
        decode, which is exactly what admission will choose."""
        if not self.spec_capable:
            return None
        alpha = (self.acceptance.alpha(request_class)
                 if self.acceptance is not None else 0.7)
        k = self.engine.spec_k
        burst = (k + 1) * self.draft_decode_cost() + self.verify_cost()
        spec_tok = burst / expected_committed_tokens(k, alpha)
        return min(self.decode_cost(), spec_tok)

    @staticmethod
    def _work_cells(work: dict) -> list[str]:
        """The cost cells one iteration of ``work`` runs."""
        cells = [f"prefill:{c}" for c in work["chunk_lens"]]
        cells += [f"draft_sync:{c}" for c in work.get("draft_sync_lens", ())]
        if work.get("spec_lanes"):
            cells += ["draft_decode", "verify"]
        if work["decode"]:
            cells.append("decode")
        return cells

    def _work_cost(self, work: dict) -> float:
        cost = sum(self.prefill_cost(c) for c in work["chunk_lens"])
        cost += sum(self.draft_chunk_cost(c)
                    for c in work.get("draft_sync_lens", ()))
        if work.get("spec_lanes"):
            cost += (work["draft_steps"] * self.draft_decode_cost()
                     + self.verify_cost())
        if work["decode"]:
            cost += self.decode_cost()
        # nothing runnable this instant (e.g. pure preemption step): charge
        # a decode step so the clock always advances
        return cost if cost > 0.0 else self.decode_cost()

    def expected_step_s(self) -> float:
        """Virtual cost of the engine's next iteration under the plan."""
        return self._work_cost(self.engine.planned_work())

    def admit(self, req: FleetRequest, now: float):
        """Enqueue into the engine — O(1), no clock charge, no busy flag:
        the admitted request's first chunk runs inside the next step.

        ``req.speculative`` carries the fleet's admit-time spec decision
        (None defers to the engine default); the workload class rides along
        so burst events can be attributed back to the class."""
        engine_req = self.engine.add_request(
            req.prompt, max_new_tokens=req.max_new_tokens, eos_id=req.eos_id,
            speculative=req.speculative, request_class=req.request_class)
        req.admitted_s = now
        req.replica = self.idx
        req.exact_share_at_admit = self.prefill_exact_share(req.bucket)
        self.requests_admitted += 1
        self._fleet_reqs[engine_req.uid] = req
        return engine_req

    def complete_step(self, now: float) -> list[FleetRequest]:
        """Run the iteration that virtually ends at ``now``.

        The engine's scheduler is pure, so previewing ``planned_work()``
        here sees exactly the chunks and decode lanes the step is about to
        run — the preview lays the iteration's child spans out on the
        virtual clock (chunks sequentially, then the batched decode), and
        marks each request's first-token instant for TTFT accounting.
        """
        tracing = self.tracer.enabled
        work = self.engine.planned_work() if tracing else None
        finished = self.engine.step()
        self.busy = self.step_pending = False
        spec_events = (self.engine.drain_spec_events()
                       if self.spec_capable else [])
        for ev in spec_events:
            if self.acceptance is not None:
                self.acceptance.record(ev["request_class"], ev["proposed"],
                                       ev["accepted"], now)
            if self.spec_hist is not None:
                self.spec_hist.observe(ev["committed"])
            if self.spec_counters is not None:
                self.spec_counters.inc("bursts")
                self.spec_counters.inc("proposed", ev["proposed"])
                self.spec_counters.inc("accepted", ev["accepted"])
                self.spec_counters.inc("committed", ev["committed"])
        if spec_events and self.spec_gauge is not None:
            prop = sum(e["proposed"] for e in spec_events)
            if prop:
                self.spec_gauge.sample(
                    sum(e["accepted"] for e in spec_events) / prop, now)
        out = []
        for er in finished:
            fr = self._fleet_reqs.pop(er.uid)
            fr.tokens = len(er.generated)
            fr.generated = list(er.generated)
            if fr.prefill_done_s is None:
                fr.prefill_done_s = now
            out.append(fr)
        # First generated token for requests still in flight: their prefill
        # chunks all ran inside this iteration.
        active = self.engine.active
        for uid, fr in self._fleet_reqs.items():
            if fr.prefill_done_s is None:
                er = active.get(uid)
                if er is not None and er.generated:
                    fr.prefill_done_s = now
        if tracing:
            parent = self.tracer.add_span(
                "step", self.track, self._step_t0, now,
                chunks=len(work["chunk_lens"]), decode=work["decode"],
                spec_lanes=work.get("spec_lanes", 0),
                active=len(active), finished=len(out))
            # Child spans re-derive the step layout from the same costs
            # start_step charged; clamp to ``now`` against float drift.
            t = self._step_t0
            for c in work["chunk_lens"]:
                t1 = min(t + self.prefill_cost(c), now)
                self.tracer.add_span("chunk", self.track, min(t, t1), t1,
                                     parent=parent, len=c)
                t = t1
            for c in work.get("draft_sync_lens", ()):
                t1 = min(t + self.draft_chunk_cost(c), now)
                self.tracer.add_span("draft_sync", self.track, min(t, t1), t1,
                                     parent=parent, len=c)
                t = t1
            if work.get("spec_lanes"):
                t1 = min(t + work["draft_steps"] * self.draft_decode_cost(),
                         now)
                self.tracer.add_span("draft_burst", self.track, min(t, t1),
                                     t1, parent=parent,
                                     lanes=work["spec_lanes"],
                                     steps=work["draft_steps"])
                t = t1
                t1 = min(t + self.verify_cost(), now)
                self.tracer.add_span("verify", self.track, min(t, t1), t1,
                                     parent=parent,
                                     lanes=work["spec_lanes"],
                                     len=work["verify_len"])
                t = t1
            if work["decode"]:
                t1 = max(t, min(t + self.decode_cost(), now))
                self.tracer.add_span("decode", self.track, t, t1,
                                     parent=parent)
        return out

    def start_step(self, now: float) -> None:
        # Count the iteration's cells at the instant their cost is charged
        # (the scheduler is pure and no admissions land mid-step, so the
        # preview here is exactly what complete_step will run and trace).
        work = self.engine.planned_work()
        self._warm([u for cell in self._work_cells(work) for u in self.cell_uses(cell)])
        for c in work["chunk_lens"]:
            self._note_cell(f"prefill:{c}", 1, now)
        for c in work.get("draft_sync_lens", ()):
            self._note_cell(f"draft_sync:{c}", 1, now)
        if work.get("spec_lanes"):
            self._note_cell("draft_decode", work["draft_steps"], now)
            self._note_cell("verify", 1, now)
        if work["decode"]:
            self._note_cell("decode", 1, now)
        self.time = now + self._work_cost(work)
        self.busy, self.step_pending = True, True
        self._step_t0 = now

    def stats(self) -> dict:
        out = super().stats()
        out["engine"] = "paged"
        out["preemptions"] = self.engine.preemptions
        out["defrags"] = self.engine.defrags
        out["page_utilization"] = self.engine.utilization()
        if self.spec_capable:
            e = self.engine
            out["spec"] = {
                "k": e.spec_k, "bursts": e.spec_bursts,
                "proposed": e.spec_proposed, "accepted": e.spec_accepted,
                "committed": e.spec_committed,
                "alpha": e.spec_accepted / max(e.spec_proposed, 1)}
        return out


class ServingFleet:
    """Router + demand tracker + N plan-aware engine replicas.

    ``registry`` is the shared :class:`~repro_torch.service.ScheduleRegistry`
    (None serves everything untuned — no services, plans stay default-tier).
    ``targets`` assigns one hardware target per replica (a single name
    applies to all); replicas sharing a target share one TuningService.
    Background tuning is deterministic: services run ``max_workers=0`` and
    the fleet drains ``drain_jobs`` jobs every ``drain_every`` events —
    publishes arrive in bursts, so re-plans stay bounded by bursts rather
    than by publishes.

    ``engine`` selects the replica engine: ``"slot"`` (the fixed-slot
    baseline) or ``"paged"`` (iteration-level continuous batching over a
    paged KV pool — ``decode_batch``/``page_size``/``pool_pages``/``chunk``
    parameterize it; ``max_len`` becomes the per-request ``max_ctx``;
    ``slots`` is ignored in favor of ``decode_batch``).
    """

    def __init__(self, cfg: ArchConfig, model, params, *, replicas: int = 2,
                 slots: int = 2, max_len: int = 64,
                 engine: str = "slot", decode_batch: int | None = None,
                 page_size: int = 8, pool_pages: int | None = None,
                 chunk: int = 8, chunks_per_step: int | None = None,
                 admit_cap: int | None = None,
                 defrag_threshold: float | None = None,
                 registry=None, policy: str = "round_robin",
                 queue_cap: int = 32, prefetch: "bool | str" = False,
                 prefetch_buckets: int = 2,
                 targets: "Sequence[str] | str | None" = None,
                 donor_target: str | None = None,
                 donors: Sequence[str] | None = None,
                 tuning_budget_s: float = float("inf"),
                 drain_jobs: int = 2, drain_every: int = 4,
                 autoscaler=None, min_replicas: int = 1,
                 seed: int = 0, extras: dict | None = None,
                 speculative: "bool | str" = False, draft_model=None,
                 draft_params=None, spec_k: int = 4,
                 acceptance: "AcceptanceTracker | None" = None,
                 tracer=None, metrics: MetricsRegistry | None = None,
                 slos=None, slo_window_s: float | None = None,
                 advisor: "TuningAdvisor | None" = None):
        if engine not in ("slot", "paged"):
            raise ValueError(f"unknown engine {engine!r}: 'slot' or 'paged'")
        if prefetch not in (False, True, "advisor"):
            raise ValueError(
                f"prefetch must be False, True, or 'advisor', got {prefetch!r}")
        self.engine_kind = engine
        if replicas <= 0:
            raise ValueError("need at least one replica")
        if speculative not in (False, True, "auto"):
            raise ValueError("speculative must be False, True, or 'auto'")
        if speculative:
            if engine != "paged":
                raise ValueError("speculative serving requires engine='paged'")
            if draft_model is None or draft_params is None:
                raise ValueError(
                    "speculative serving needs draft_model and draft_params")
            if spec_k <= 0:
                raise ValueError("spec_k must be positive when speculating")
        self.spec_mode = speculative
        self.acceptance = ((acceptance if acceptance is not None
                            else AcceptanceTracker()) if speculative else None)
        self.cfg = cfg
        self.registry = registry
        # Observability first: services and replicas constructed below bind
        # to the fleet tracer/registry, and the tracer's clock closes over
        # ``_now`` (the discrete-event virtual instant).
        self._now = 0.0
        self.obs = metrics if metrics is not None else MetricsRegistry()
        self.tracer = tracer if tracer is not None else NULL_TRACER
        if self.tracer.enabled:
            self.tracer.set_clock(lambda: self._now)
            for i in range(replicas):  # display order: replicas first
                self.tracer.track(f"replica-{i}")
            self.tracer.track("router")
            self.tracer.track("autoscaler")
        self.prefetch = prefetch
        self.prefetch_buckets = prefetch_buckets
        self.drain_jobs = drain_jobs
        self.drain_every = drain_every
        self.autoscaler = autoscaler
        self.min_replicas = (autoscaler.min_replicas if autoscaler is not None
                             else max(1, min_replicas))
        # Everything _make_replica needs to construct a warm-joining replica
        # identical (module, engine geometry) to the boot-time ones.
        self._mk = dict(model=model, params=params, slots=slots,
                        max_len=max_len, decode_batch=decode_batch,
                        page_size=page_size, pool_pages=pool_pages,
                        chunk=chunk, chunks_per_step=chunks_per_step,
                        admit_cap=admit_cap,
                        defrag_threshold=defrag_threshold, extras=extras,
                        draft_model=draft_model if speculative else None,
                        draft_params=draft_params if speculative else None,
                        spec_k=spec_k if speculative else 0)
        self.spec_counters = (self.obs.group(
            "spec", ["admit_spec", "admit_plain", "bursts", "proposed",
                     "accepted", "committed"]) if speculative else None)
        self._svc_kw = dict(seed=seed, budget_s=tuning_budget_s,
                            donor_target=donor_target, donors=donors)

        if targets is None:
            targets = [DEFAULT_TARGET] * replicas
        elif isinstance(targets, str):
            targets = [targets] * replicas
        else:
            targets = [target_name(t) for t in targets]
            if len(targets) != replicas:
                raise ValueError(
                    f"targets ({len(targets)}) must match replicas ({replicas})")

        # One TuningService per distinct target, all over the one registry
        # (created on demand — a warm-join may bring a brand-new target),
        # and one runner per target, shared by its service and replicas.
        self._services: dict[str, Any] = {}
        self._runners: dict[str, CachedRunner] = {}
        self.replicas: list[Replica] = []
        for i, t in enumerate(targets):
            self.replicas.append(self._make_replica(i, t))

        self.demand = DemandTracker(bucket_for=self.replicas[0].bucket_for)
        self.router = RequestRouter(self.replicas, policy=policy,
                                    queue_cap=queue_cap, demand=self.demand,
                                    metrics=self.obs, tracer=self.tracer)
        self.metrics = FleetMetrics(metrics=self.obs)
        #: One untuned decode step of the reference replica — the trace's
        #: time unit (TrafficGenerator ``tick_s``).
        self.tick_s = self.replicas[0].untuned_decode_cost()
        self.prefetched: list[str] = []   # workload keys, in prefetch order
        self._prefetched_seen: set[str] = set()
        #: Lifecycle audit trail: one dict per warm-join / retire.
        self.scale_events: list[dict] = []
        self._events = 0
        self._next_eval: float | None = None
        # Closed-loop observability (DESIGN.md §12): the SLO monitor
        # evaluates burn rates at its own window cadence inside serve()
        # (alerts feed the autoscaler window), the ledger tracks realized
        # vs attainable speedup on the tuning-drain cadence, and the
        # advisor replaces demand-count prefetch ordering when
        # ``prefetch="advisor"``.
        if slos == "default":
            slos = default_slos(self.tick_s)
        elif callable(slos):  # tick-relative spec: thresholds need tick_s
            slos = slos(self.tick_s)
        self.slo_monitor = (SLOMonitor(
            slos, self.metrics, window_s=slo_window_s or 4 * self.tick_s,
            metrics=self.obs, tracer=self.tracer) if slos else None)
        self._slo_next = (self.slo_monitor.window_s
                          if self.slo_monitor is not None else None)
        self.ledger = (SpeedupLedger(metrics=self.obs, tracer=self.tracer)
                       if self._services else None)
        self.advisor = advisor if advisor is not None else (
            TuningAdvisor() if prefetch == "advisor" else None)
        if self.tracer.enabled:
            if self.slo_monitor is not None:
                self.tracer.track(SLOMonitor.TRACK)
            if self.ledger is not None:
                self.tracer.track(SpeedupLedger.TRACK)
            if self.advisor is not None:
                self.tracer.track("advisor")
        if autoscaler is not None:
            self.attach_autoscaler(autoscaler)

    def attach_autoscaler(self, autoscaler) -> None:
        """Attach (or replace) the autoscaler driving :meth:`serve`.

        Callers typically construct the fleet first — :attr:`tick_s` (one
        untuned decode step) is only known then — and size the controller's
        ``window_s``/``cooldown_s`` in ticks of it.
        """
        self.autoscaler = autoscaler
        self.min_replicas = autoscaler.min_replicas
        self._next_eval = self._now + autoscaler.window_s
        bind = getattr(autoscaler, "bind_obs", None)
        if bind is not None:  # controller telemetry joins the fleet's sinks
            bind(self.tracer, self.obs)

    def set_slo_window(self, window_s: float) -> None:
        """Retime the SLO evaluation cadence (call before :meth:`serve`).

        Same rationale as :meth:`attach_autoscaler`: callers size windows in
        ticks of :attr:`tick_s`, which is only known post-construction.
        """
        if self.slo_monitor is None:
            raise ValueError("fleet has no SLO monitor (pass slos=)")
        if window_s <= 0:
            raise ValueError("window_s must be positive")
        self.slo_monitor.window_s = window_s
        self._slo_next = self._now + window_s

    # -- replica construction --------------------------------------------------
    def runner_for(self, target: str) -> CachedRunner:
        """The runner ``target``'s service and replicas price kernels with
        (created on first use;
        :func:`~repro_torch.core.measured_runner.target_runner`)."""
        runner = self._runners.get(target)
        if runner is None:
            runner = self._runners[target] = target_runner(target, self._mk["model"].device)
        return runner

    def _service_for(self, target: str):
        """The shared TuningService for ``target`` (created on first use)."""
        if self.registry is None:
            return None
        svc = self._services.get(target)
        if svc is None:
            from repro_torch.service import TuningService  # lazy: optional dep cycle
            svc = self._services[target] = TuningService(
                self.registry, model_id=f"fleet/{self.cfg.name}",
                runner=self.runner_for(target),
                max_workers=0, probe_candidates=0, target=target,
                metrics=self.obs, tracer=self.tracer,
                clock=lambda: self._now,
                **self._svc_kw)
        return svc

    def _make_replica(self, idx: int, target: str) -> Replica:
        """Construct one replica (engine + provider) for ``target``.

        The engine builds its :class:`~repro_torch.core.resolution.ExecutionPlan`
        at the *current* registry generation — for a warm-join this is the
        whole point: every shape the fleet already tuned resolves at the
        exact tier before the replica sees its first request.
        """
        mk = self._mk
        svc = self._service_for(target)
        provider = (ScheduleProvider(service=svc) if svc is not None
                    else ScheduleProvider(target=target))
        pipeline = getattr(provider, "pipeline", None)
        if pipeline is not None:
            pipeline.tracer = self.tracer
        if self.engine_kind == "paged":
            eng = PagedServingEngine(
                mk["model"], mk["params"],
                decode_batch=mk["decode_batch"] or mk["slots"],
                max_ctx=mk["max_len"], page_size=mk["page_size"],
                pool_pages=mk["pool_pages"], chunk=mk["chunk"],
                chunks_per_step=mk["chunks_per_step"],
                admit_cap=mk["admit_cap"],
                defrag_threshold=mk["defrag_threshold"],
                draft_model=mk["draft_model"],
                draft_params=mk["draft_params"], spec_k=mk["spec_k"],
                provider=provider)
            self._bind_engine_obs(eng, idx)
            rep = PagedReplica(idx, self.cfg, eng, svc, target, self.runner_for(target))
            if self.spec_mode:
                rep.acceptance = self.acceptance
                rep.spec_counters = self.spec_counters
                rep.spec_gauge = self.obs.gauge("spec.acceptance_rate")
                rep.spec_hist = self.obs.histogram("spec.committed_per_burst")
            return rep
        eng = ServingEngine(mk["model"], mk["params"], slots=mk["slots"],
                            max_len=mk["max_len"], extras=mk["extras"], provider=provider)
        self._bind_engine_obs(eng, idx)
        return Replica(idx, self.cfg, eng, svc, target, self.runner_for(target))

    def _bind_engine_obs(self, eng, idx: int) -> None:
        """Point the engine at the fleet tracer *before* the Replica wrapper
        reads the binding.  Compute spans are disabled: under the virtual
        clock a wall-clock compute span is noise — the replica emits the
        virtual-time step spans instead."""
        eng.tracer = self.tracer
        eng.trace_track = f"replica-{idx}"
        eng.trace_compute = False

    @property
    def services(self) -> dict:
        """Per-target shared TuningServices (empty without a registry)."""
        return dict(self._services)

    # -- lifecycle views -------------------------------------------------------
    def live_replicas(self) -> list[Replica]:
        """Replicas that still hold or may hold work (active + draining)."""
        return [r for r in self.replicas if r.state != "retired"]

    def active_replicas(self) -> list[Replica]:
        return [r for r in self.replicas if r.state == "active"]

    # -- elastic lifecycle -----------------------------------------------------
    def add_replica(self, target: str | None = None, *,
                    now: float | None = None) -> Replica:
        """Warm-join a new replica and register it with the router.

        The join order is the contract: (1) construct the replica — its
        execution plan resolves at the *current* shared-registry generation,
        so every shape the fleet already tuned is exact-tier from request
        one; (2) prefetch tuning for whatever the demand distribution says
        is hot but still unresolved on this target; (3) only then register
        with the router.  The recorded scale event carries the fleet's
        traffic-weighted exact-tier share just before the join and the new
        replica's share at join, so "warm" is measurable, not asserted.
        """
        now = self._now if now is None else now
        t = target_name(target) if target is not None else self.replicas[0].target
        self.sync_plans()  # compare shares at one registry generation
        pre_share = self._final_exact_share_synced()
        r = self._make_replica(len(self.replicas), t)
        r.joined_s = now
        r.time = now
        if self._services and self.demand.total > 0:
            self._prefetch_uses(r.decode_uses, float(self.demand.total))
            for bucket, count in self.demand.hottest()[:self.prefetch_buckets]:
                self._prefetch_uses(r.prefill_uses(bucket), float(count))
        join_share = (self.demand.weighted(r.prefill_exact_share)
                      if self._services else 0.0)
        self.replicas.append(r)
        self.router.add_replica(r)
        self.scale_events.append({
            "t": now, "action": "join", "replica": r.idx, "target": t,
            "pre_join_exact_share": pre_share,
            "join_exact_share": join_share})
        if self.tracer.enabled:
            self.tracer.track(r.track)
            self.tracer.event("join", "autoscaler", t=now, replica=r.idx,
                              target=t, pre_join_exact_share=pre_share,
                              join_exact_share=join_share)
        return r

    def retire_replica(self, idx: int, *, now: float | None = None) -> Replica:
        """Drain-retire a replica: stop dispatch, finish in-flight work.

        Refused (ValueError) when it would leave fewer than
        ``min_replicas`` active replicas.  Work the engine accepted but has
        not started (the paged engine's waiting queue) is withdrawn and
        requeued at the router front — nothing accepted is ever dropped.
        In-flight requests keep decoding through the normal serve loop; the
        replica finalizes to ``retired`` once empty.
        """
        now = self._now if now is None else now
        r = self.replicas[idx]
        if r.state != "active":
            raise ValueError(f"replica {idx} is {r.state}, not active")
        if len(self.active_replicas()) - 1 < self.min_replicas:
            raise ValueError(
                f"refusing to retire replica {idx}: fleet would drop below "
                f"min_replicas={self.min_replicas}")
        r.state = "draining"
        requeued: list[FleetRequest] = []
        withdraw = getattr(r.engine, "withdraw_waiting", None)
        if withdraw is not None:
            for uid in withdraw():
                fr = r._fleet_reqs.pop(uid, None)
                if fr is not None:
                    fr.replica = None
                    fr.admitted_s = None
                    requeued.append(fr)
            requeued.sort(key=lambda q: q.arrival_s)
            self.router.requeue(requeued)
        self.scale_events.append({
            "t": now, "action": "retire", "replica": idx, "target": r.target,
            "requeued": len(requeued), "in_flight": len(r._fleet_reqs)})
        if self.tracer.enabled:
            self.tracer.event("retire", "autoscaler", t=now, replica=idx,
                              target=r.target, requeued=len(requeued),
                              in_flight=len(r._fleet_reqs))
        if not r.busy and not r.engine.active:
            self._finalize_retire(r, now)
        return r

    def _finalize_retire(self, r: Replica, now: float) -> None:
        r.state = "retired"
        r.retired_s = now
        r.busy = r.step_pending = False
        if self.tracer.enabled:
            self.tracer.event("retired", "autoscaler", t=now, replica=r.idx,
                              target=r.target)
        # Pending tuning jobs for this target are demand the fleet no longer
        # has capacity to exploit — cancel them, but only when no live
        # replica still serves the target (the queue is shared per target).
        svc = self._services.get(r.target)
        if svc is not None and not any(q.target == r.target
                                       for q in self.live_replicas()):
            svc.cancel_pending()

    def _apply_decision(self, decision, now: float) -> None:
        if decision.action == "up":
            self.add_replica(now=now)
        elif decision.action == "down":
            actives = self.active_replicas()
            if len(actives) - 1 < self.min_replicas:
                return  # a drain in progress already took the headroom
            # Victim: fewest in-flight requests (cheapest drain), ties to
            # the youngest replica (keep the fleet's elders warm).
            victim = min(actives, key=lambda r: (len(r._fleet_reqs), -r.idx))
            self.retire_replica(victim.idx, now=now)

    def replica_seconds(self) -> float:
        """Capacity spent: Σ per replica of (retire time − join time), in
        virtual seconds — the equal-cost axis elastic-vs-fixed compares on."""
        end = max(self._now, self.metrics.makespan_s)
        return sum((r.retired_s if r.retired_s is not None else end)
                   - r.joined_s for r in self.replicas)

    # -- demand-driven prefetch ------------------------------------------------
    def _prefetch_uses(self, uses: Sequence[KernelUse], priority: float) -> None:
        for svc in self._services.values():
            db = svc.registry.snapshot().db(None)
            for u in uses:
                if db.exact(u.instance, target=svc.target) is not None:
                    continue
                if svc.prefetch(u.instance, priority=priority):
                    key = u.instance.workload_key()
                    if key not in self._prefetched_seen:
                        self._prefetched_seen.add(key)
                        self.prefetched.append(key)

    def _prefetch_hot(self) -> None:
        """Queue tuning for the hottest unresolved shapes, hottest first.

        The batched decode step is exercised by *every* request, so its
        kernels carry the total demand; after it come the hottest prefill
        buckets by arrival count.  Cold buckets are never touched — their
        jobs stay at the tail of the queue and spend budget only after all
        demanded shapes are tuned.
        """
        total = self.demand.total
        if total == 0:
            return
        self._prefetch_uses(self.replicas[0].decode_uses, float(total))
        for bucket, count in self.demand.hottest()[:self.prefetch_buckets]:
            self._prefetch_uses(self.replicas[0].prefill_uses(bucket),
                                float(count))

    def _prefetch_advised(self) -> None:
        """Advisor-ranked prefetch (``prefetch="advisor"``): queue or
        promote every un-exhausted executed workload at priority
        critical-path-seconds x headroom, so the drain order follows
        end-to-end impact rather than raw arrival counts."""
        ranked = self.advisor.rank(self)
        for rw in ranked:
            svc = self._services.get(rw.target)
            if svc is None or not svc.prefetch(rw.instance,
                                               priority=rw.priority):
                continue
            key = rw.instance.workload_key()
            if key not in self._prefetched_seen:
                self._prefetched_seen.add(key)
                self.prefetched.append(key)
        if ranked and self.tracer.enabled:
            top = ranked[0]
            self.tracer.event(
                "advise", "advisor", t=self._now, candidates=len(ranked),
                top_key=top.instance.workload_key(),
                top_priority=top.priority, top_critical_s=top.critical_s,
                top_headroom=top.headroom)

    def _drain_services(self) -> None:
        for svc in self._services.values():
            svc.drain(max_jobs=self.drain_jobs)

    # -- the serve loop --------------------------------------------------------
    def _complete(self, fr: FleetRequest, now: float) -> None:
        self.metrics.record_completion(fr, now)
        if self.tracer.enabled:
            self._trace_request(fr)

    def _trace_request(self, fr: FleetRequest) -> None:
        """Emit the request's lifecycle as async spans on its replica track.

        Four spans share ``cat="request"`` and ``id=uid`` so Perfetto nests
        them on one async track even when requests overlap: ``request``
        covers arrival→finish, with ``queue``/``prefill``/``decode`` slicing
        it at the admission and first-token instants.  The intervals are the
        exact ones :class:`FleetMetrics` aggregates, so a report computed
        from the trace reproduces the fleet's latency percentiles.
        """
        if fr.admitted_s is None or fr.finished_s is None:
            return
        track = (self.replicas[fr.replica].track if fr.replica is not None
                 else "router")
        uid = str(fr.uid)
        t_arr, t_adm, t_fin = fr.arrival_s, fr.admitted_s, fr.finished_s
        pd = fr.prefill_done_s
        pd = t_adm if pd is None else min(max(pd, t_adm), t_fin)
        add = self.tracer.add_async_span
        add("request", track, t_arr, t_fin, "request", uid, uid=fr.uid,
            bucket=fr.bucket, replica=fr.replica, tokens=fr.tokens,
            latency_s=t_fin - t_arr)
        add("queue", track, t_arr, t_adm, "request", uid, uid=fr.uid)
        add("prefill", track, t_adm, pd, "request", uid, uid=fr.uid)
        add("decode", track, pd, t_fin, "request", uid, uid=fr.uid)

    def _admit(self, req: FleetRequest, idx: int) -> bool:
        replica = self.replicas[idx]
        if self.spec_mode and getattr(replica, "spec_capable", False):
            if self.spec_mode == "auto":
                # Per-request economics: speculate only when the measured
                # per-class acceptance rate projects a throughput win under
                # this replica's plan-derived cell costs.
                alpha = self.acceptance.alpha(req.request_class)
                req.speculative = replica.spec_gain(alpha) > 1.0
            else:
                req.speculative = True
            self.spec_counters.inc(
                "admit_spec" if req.speculative else "admit_plain")
            if self.tracer.enabled:
                self.tracer.event(
                    "spec_route", "router", uid=req.uid,
                    request_class=req.request_class,
                    speculative=req.speculative)
        try:
            engine_req = replica.admit(req, self._now)
        except ValueError:
            # A request the engine can never hold (e.g. prompt > max_len):
            # the router survives it — shed, not crash (False vetoes the
            # placement so it is not counted as dispatched).
            req.shed = "invalid"
            self.metrics.record_shed(req, self._now)
            if self.tracer.enabled:
                self.tracer.event("shed", "router", uid=req.uid,
                                  reason="invalid", replica=idx)
            return False
        if engine_req.done:
            # Finished by the prefill itself (max_new_tokens=0 / prefill
            # EOS): completes when its prefill's virtual time elapses.
            req.tokens = len(engine_req.generated)
            req.generated = list(engine_req.generated)
            self._complete(req, replica.time)
        return True

    def _eligible(self) -> list[int]:
        # Admission happens at step boundaries: a replica mid-(virtual)-step
        # cannot accept work until its clock catches up.  Only *active*
        # replicas take new work — draining ones finish what they hold.
        return [i for i, r in enumerate(self.replicas)
                if r.state == "active" and not r.busy and r.free_slots > 0]

    def serve(self, trace: Sequence[FleetRequest], *,
              max_events: int = 200_000) -> dict:
        """Serve a traffic trace to completion; returns :meth:`summary`."""
        arrivals = sorted(trace, key=lambda r: r.arrival_s)
        ai = 0
        now = 0.0
        while True:
            self._events += 1
            if self._events > max_events:
                raise RuntimeError("fleet serve did not converge")
            next_times = []
            if ai < len(arrivals):
                next_times.append(arrivals[ai].arrival_s)
            busy = [r.time for r in self.replicas if r.busy]
            if busy:
                next_times.append(min(busy))
            if not next_times:
                if not self.router.queue:
                    break
                # Queued work, everything idle: dispatch at the current time.
            else:
                # With an autoscaler (or SLO monitor), window boundaries are
                # events too — the clock never jumps past an evaluation
                # instant.
                if self._next_eval is not None:
                    next_times.append(self._next_eval)
                if self._slo_next is not None:
                    next_times.append(self._slo_next)
                now = max(now, min(next_times))
            self._now = now

            # 1) arrivals up to now enter the admission queue (or shed).
            while ai < len(arrivals) and arrivals[ai].arrival_s <= now:
                req = arrivals[ai]
                ai += 1
                try:
                    self.router.submit(req)
                except QueueFull:
                    self.metrics.record_shed(req, now)

            # 2) work that finishes at now: decode steps run for real.
            for r in self.replicas:
                if r.busy and r.time <= now + 1e-12:
                    if r.step_pending:
                        for fr in r.complete_step(now):
                            self._complete(fr, now)
                    else:
                        r.busy = False  # prefill done; slot batch continues
                if r.state == "draining" and not r.busy \
                        and not r.engine.active:
                    self._finalize_retire(r, now)

            # 3) background tuning in bursts: prefetch ordering (advisor
            #    priority or demand counts), then a bounded drain (publishes
            #    coalesce -> bounded re-plans), then a ledger refresh so the
            #    realized-speedup gauges move the instant publishes land.
            if self._services and self._events % self.drain_every == 0:
                if self.prefetch == "advisor":
                    self._prefetch_advised()
                elif self.prefetch:
                    self._prefetch_hot()
                self._drain_services()
                if self.ledger is not None:
                    self.ledger.update(self.live_replicas(), now=now)

            # 3a) SLO monitor: evaluate burn rates at every window boundary
            #     crossed, *before* the autoscaler folds its window — an
            #     alert raised at a shared boundary is scale-up pressure in
            #     the same instant's decision.
            if self._slo_next is not None:
                while self._slo_next <= now + 1e-12:
                    self.slo_monitor.evaluate(self._slo_next)
                    self._slo_next += self.slo_monitor.window_s

            # 3b) autoscaler: fold the just-closed telemetry window into the
            #     controller and apply its decision *before* dispatch, so a
            #     replica joining now takes requests this same instant.
            if self._next_eval is not None and self.autoscaler is not None:
                while self._next_eval <= now + 1e-12:
                    t1 = self._next_eval
                    w = self.metrics.window(t1 - self.autoscaler.window_s, t1)
                    w["slo_alerts"] = (len(self.slo_monitor.alerting())
                                       if self.slo_monitor is not None else 0)
                    decision = self.autoscaler.observe(
                        w, now=t1, replicas=len(self.live_replicas()))
                    self._apply_decision(decision, t1)
                    self._next_eval += self.autoscaler.window_s

            # 4) route queued requests to replicas at their boundaries.
            self.router.dispatch(now, eligible=self._eligible,
                                 admit=self._admit)
            for fr in self.router.last_shed_deadline:
                self.metrics.record_shed(fr, now)
            live = self.live_replicas()
            self.metrics.sample_queue(self.router.depth, now)
            self.metrics.sample_utilization(
                sum(r.utilization() for r in live) / len(live) if live
                else 0.0, now)
            self.metrics.sample_capacity(
                sum(r.engine.kv_used_tokens() for r in live),
                sum(r.engine.kv_capacity_tokens() for r in live))

            # 5) replicas with active slots begin their next decode step
            #    (draining ones too — that is how they finish their work).
            for r in self.replicas:
                if r.state != "retired" and not r.busy and r.engine.active:
                    r.start_step(now)
        return self.summary()

    # -- cross-replica consistency ---------------------------------------------
    def sync_plans(self) -> None:
        """Bring every replica's plan to the current registry generation
        (the same step-boundary check a live stream would perform; no
        tokens are decoded, so it is safe mid-stream)."""
        for r in self.replicas:
            r.engine.refresh_plan()

    def schedule_mismatches(self) -> int:
        """Byte-level schedule divergence between same-target replicas'
        plans after a sync — shared-registry propagation must make it 0."""
        self.sync_plans()
        return self._schedule_mismatches_synced()

    def _schedule_mismatches_synced(self) -> int:
        groups: dict[str, list[Replica]] = {}
        for r in self.replicas:
            groups.setdefault(r.target, []).append(r)
        mismatches = 0
        for members in groups.values():
            base = members[0].engine.plan
            if base is None:
                continue
            base_bytes = {k: json.dumps(s.to_json(), sort_keys=True)
                          for k, s in base.schedules().items()}
            for other in members[1:]:
                if other.engine.plan is None:
                    continue
                for k, s in other.engine.plan.schedules().items():
                    want = base_bytes.get(k)
                    if want is not None and \
                            json.dumps(s.to_json(), sort_keys=True) != want:
                        mismatches += 1
        return mismatches

    # -- telemetry ------------------------------------------------------------
    def final_exact_share(self) -> float:
        """Traffic-weighted exact-tier share over the demand distribution,
        under the replicas' *current* plans (the end-state quality)."""
        self.sync_plans()
        return self._final_exact_share_synced()

    def _final_exact_share_synced(self) -> float:
        if not self._services:
            return 0.0
        return self.demand.weighted(self.replicas[0].prefill_exact_share)

    def summary(self) -> dict:
        # Padding-waste totals live in the engines (the authoritative
        # ledger); fold them into the metrics before summarizing.
        self.metrics.prefill_true_tokens = sum(
            r.engine.prefill_true_tokens for r in self.replicas)
        self.metrics.prefill_padded_tokens = sum(
            r.engine.prefill_padded_tokens for r in self.replicas)
        out = self.metrics.summary(tick_s=self.tick_s)
        out["engine"] = self.engine_kind
        out["router"] = self.router.stats()
        out["demand"] = self.demand.stats()
        out["replicas"] = [r.stats() for r in self.replicas]
        out["events"] = self._events
        out["prefetched"] = len(self.prefetched)
        out["scale_events"] = list(self.scale_events)
        out["replica_seconds"] = self.replica_seconds()
        if self.spec_mode:
            out["speculative"] = {
                "mode": "auto" if self.spec_mode == "auto" else "all",
                "spec_k": self._mk["spec_k"],
                "counters": dict(self.spec_counters),
                "acceptance": self.acceptance.stats()}
        if self.autoscaler is not None:
            out["autoscaler"] = self.autoscaler.stats()
        self.sync_plans()  # once, for both end-state metrics below
        out["schedule_mismatches"] = self._schedule_mismatches_synced()
        out["final_exact_share"] = self._final_exact_share_synced()
        if self._services:
            out["tuning"] = {t: s.stats() for t, s in self._services.items()}
        if self.slo_monitor is not None:
            out["slo"] = self.slo_monitor.summary()
        if self.ledger is not None:
            # Re-priced after the sync above, so the ledger reflects the
            # end-state plans the other end-state metrics describe.
            self.ledger.update(self.live_replicas(), now=self._now)
            out["speedup_ledger"] = self.ledger.summary()
        return out

    def close(self) -> None:
        """Shut the services down without spending budget on cold shapes:
        queued-but-unstarted background jobs are cancelled, not drained."""
        for svc in self._services.values():
            svc.cancel_pending()
            svc.close()
