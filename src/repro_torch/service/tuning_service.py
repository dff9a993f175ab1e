"""Online tuning service: tiered schedule lookup + background transfer-tuning.

A copy of ``repro.service.tuning_service`` (the port imports nothing of
``repro``).  On a measured target (``h100``) its runner times kernels on
the card, so run it deferred (``max_workers=0``) and drain between
requests: see :func:`repro_torch.launch.serve.make_provider`.

The serving path asks one question — "what schedule should this kernel
instance run with, *right now*?" — and must never block on search.
:class:`TuningService` answers it with a tiered policy over a
:class:`~repro_torch.service.registry.ScheduleRegistry` snapshot:

1. **exact** — a published record for this exact workload (Ansor's
   workload-ID reuse; includes upgrades this service published earlier);
2. **transfer** — the best same-class donor candidate, probed through the
   injected :class:`~repro_torch.core.runner.MeasureRunner` (bounded to
   ``probe_candidates`` strongest donors; a shared :class:`CachedRunner`
   makes repeat probes and the later background job free);
3. **default** — the untuned schedule.

Every non-exact lookup enqueues a **background transfer-tuning job** for the
missed workload: deduplicated by workload key, run on a bounded worker pool,
bounded by a total *virtual search seconds* budget, and published atomically
to the registry — so subsequent lookups for that workload upgrade to tier 1.
A published schedule is never downgraded: a job's result is only published
when it beats the best record already visible for that workload.

The background job is exactly the offline pipeline
(:func:`repro_torch.core.transfer.transfer_tune` over the full donor pool with the
service's mode/seed), so a drained service converges to the same schedules an
offline ``transfer_arch`` run would produce for the same workloads, donors,
and budget — the online path trades *when* search happens, not *what* it
finds.
"""
from __future__ import annotations

import dataclasses
import threading
from concurrent.futures import Future, ThreadPoolExecutor, wait
from typing import Sequence

from repro_torch.core.database import Record, ScheduleDB
from repro_torch.core.runner import MeasureRunner, resolve_runner
from repro_torch.core.schedule import Schedule, ScheduleInvalid
from repro_torch.core.transfer import _strongest_first, transfer_tune
from repro_torch.core.workload import KernelInstance, KernelUse
from repro_torch.obs import NULL_TRACER, MetricsRegistry
from repro_torch.targets import target_name


@dataclasses.dataclass(frozen=True)
class LookupResult:
    """Answer to one serving-path schedule query."""

    schedule: Schedule | None    # None -> run the untuned default
    tier: str                    # "exact" | "transfer" | "default"
    seconds: float               # noise-free kernel seconds under the answer
    untuned_seconds: float
    source_model: str = ""       # provenance of the chosen schedule
    generation: int = 0          # registry generation the answer was read at

    @property
    def speedup(self) -> float:
        return self.untuned_seconds / self.seconds if self.seconds else 1.0


@dataclasses.dataclass
class _Job:
    instance: KernelInstance
    future: Future | None = None   # None -> deferred (drained inline)
    started: bool = False
    priority: float = 0.0          # higher drains first (deferred mode)
    seq: int = 0                   # FIFO tiebreak within a priority
    enqueued_t: float = 0.0        # virtual instant the job entered the queue
    skips: int = 0                 # times a later-enqueued job was claimed first
    starved: bool = False          # skips crossed the starvation threshold


class TuningService:
    """Schedule lookups now, transfer-tuning upgrades in the background.

    ``max_workers > 0`` runs jobs on a thread pool as they are enqueued;
    ``max_workers = 0`` defers them until :meth:`drain` — deterministic, used
    by tests and the benchmark's stepwise stream.  ``budget_s`` bounds the
    total virtual search seconds background jobs may charge (probe-tier
    measurement is accounted separately in ``probe_search_s``).  ``donors``
    restricts the candidate pool to the given model ids; by default every
    model in the registry except ``model_id`` (this service's own published
    upgrades) is a donor, which keeps background jobs equivalent to an
    offline run against the donor-only store.

    ``target`` names the chip this service serves: the exact tier only reads
    that target's namespace, every published upgrade lands in it, and the
    donor pool comes from ``donor_target`` (default: ``target``).  Setting
    ``donor_target`` to a different chip is the explicit cross-target serving
    setup — e.g. an edge service transfer-tuning from a server-tuned store —
    with every donor re-validated under ``target``'s spec before it can win.
    """

    #: A queued job passed over by this many later-enqueued, higher-priority
    #: claims is counted as starved (once) — the telemetry that verifies a
    #: priority source (demand counts, the TuningAdvisor) is not freezing
    #: out cold workloads indefinitely.
    STARVATION_SKIPS = 8

    def __init__(self, registry, *, model_id: str = "serving",
                 runner: MeasureRunner | None = None, mode: str = "strict",
                 seed: int = 0, noise_sigma: float = 0.05,
                 donors: Sequence[str] | None = None,
                 budget_s: float = float("inf"), max_workers: int = 2,
                 probe_candidates: int | None = 4,
                 target=None, donor_target=None,
                 metrics: MetricsRegistry | None = None, tracer=None,
                 clock=None):
        self.registry = registry
        self.model_id = model_id
        self.runner, self.target = resolve_runner(runner, target)
        self.donor_target = (target_name(donor_target)
                             if donor_target is not None else self.target)
        self.mode = mode
        self.seed = seed
        self.noise_sigma = noise_sigma
        self.donors = list(donors) if donors is not None else None
        self.budget_s = budget_s
        self.probe_candidates = probe_candidates
        self._pool = ThreadPoolExecutor(max_workers) if max_workers > 0 else None
        self._lock = threading.Lock()
        # Separate from _lock: serializes the check-then-publish pair without
        # making lookups' counter bumps wait on registry fsyncs.
        self._publish_lock = threading.Lock()
        self._jobs: dict[str, _Job] = {}
        self._attempted: set[str] = set()
        #: workload keys in the order background jobs finished — the
        #: observable priority-queue behavior (tests assert hot-first).
        self.completed_order: list[str] = []
        self._job_seq = 0
        self._spent_s = 0.0
        self._probe_s = 0.0
        # Publish log for changed-workload notification: (generation before,
        # generation after, workload key) per publish this service performed.
        self._pub_events: list[tuple[int, int, str]] = []
        # Counters are registry-backed (namespaced by target so a fleet's
        # per-target services share one registry without colliding); the
        # tracer records the tuning timeline (lookups, job spans, publishes)
        # on the ``tuning/<target>`` track.  Increments stay guarded by
        # ``_lock`` exactly as the plain-dict versions were.
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.tracer = tracer if tracer is not None else NULL_TRACER
        # Queue ages are measured on the owner's clock: fleets pass their
        # virtual ``_now``; the default rides the tracer's bound clock
        # (0.0 under NULL_TRACER — ages degrade to 0, never crash).
        self._clock = clock if clock is not None else self.tracer.now
        self.trace_track = f"tuning/{self.target}"
        self._counters = self.metrics.group(f"tuning.{self.target}", [
            "lookups", "exact_hits", "transfer_hits", "default_misses",
            "jobs_enqueued", "jobs_deduped", "jobs_rejected_budget",
            "jobs_completed", "jobs_failed", "upgrades", "publish_skipped",
            "prefetches", "jobs_cancelled", "jobs_starved"])
        self._job_hist = self.metrics.histogram(
            f"tuning.{self.target}.job_search_s")
        self._queue_age_g = self.metrics.gauge(
            f"tuning.{self.target}.queue_age_mean_s")
        self._oldest_age_g = self.metrics.gauge(
            f"tuning.{self.target}.oldest_unstarted_age_s")

    # -- lookup ---------------------------------------------------------------
    def donor_models(self, db: ScheduleDB) -> list[str]:
        """Donor model ids the transfer tier and background jobs pool over
        (also what the TuningAdvisor estimates class headroom from)."""
        if self.donors is not None:
            return list(self.donors)
        return [m for m in db.models(target=self.donor_target)
                if m != self.model_id]

    def lookup(self, instance: KernelInstance) -> LookupResult:
        snap = self.registry.snapshot()
        # Pool over every mode: a record's mode tag certifies validity under
        # that mode, but candidates are re-validated here under self.mode (the
        # exact tier's seconds query and the probe measurements both raise /
        # invalidate on a bad bind), so cross-mode reuse is safe.
        db = snap.db(None)
        untuned = self.runner.seconds(instance, None)
        with self._lock:
            self._counters["lookups"] += 1

        # Best exact record overall, falling back to the best record published
        # under this service's own mode when the overall winner doesn't bind
        # (e.g. a faster adaptive-mode record shadowing a valid strict one).
        # Both reads stay inside this service's target namespace: a same-shape
        # record from another chip was selected under the wrong roofline (and
        # may not even fit this chip's VMEM), so it is never an exact hit.
        for exact in (db.exact(instance, target=self.target),
                      snap.db(self.mode).exact(instance, target=self.target)):
            if exact is None:
                continue
            try:
                secs = self.runner.seconds(instance, exact.schedule, mode=self.mode)
            except ScheduleInvalid:
                continue
            with self._lock:
                self._counters["exact_hits"] += 1
            self._trace_lookup(instance, "exact", snap.generation)
            return LookupResult(exact.schedule, "exact", secs, untuned,
                                exact.model_id, snap.generation)

        # Miss: queue the upgrade first so serving latency never gates search.
        self._enqueue(instance)

        # Tier 2: probe the strongest same-class donor candidates.
        # probe_candidates: 0 disables the tier (pure background-upgrade
        # serving), None probes the full pool, N > 0 caps serve-path probing.
        candidates: list[Record] = []
        if self.probe_candidates != 0:
            candidates = db.by_class(instance.class_id,
                                     models=self.donor_models(db),
                                     target=self.donor_target)
            if (self.probe_candidates is not None
                    and len(candidates) > self.probe_candidates):
                # Same ranking the offline transfer path truncates with.
                candidates = _strongest_first(candidates, self.probe_candidates,
                                              self.runner)
        if candidates:
            measured = self.runner.measure_many(
                instance, [r.schedule for r in candidates], mode=self.mode,
                seed=self.seed, noise_sigma=self.noise_sigma)
            best_secs, best = untuned, None
            probe_cost = 0.0
            for rec, m in zip(candidates, measured):
                probe_cost += m.measure_cost_s
                if m.valid and not m.pruned and m.seconds < best_secs:
                    best_secs, best = m.seconds, rec
            with self._lock:
                self._probe_s += probe_cost
            if best is not None:
                secs = self.runner.seconds(instance, best.schedule, mode=self.mode)
                with self._lock:
                    self._counters["transfer_hits"] += 1
                self._trace_lookup(instance, "transfer", snap.generation)
                return LookupResult(best.schedule, "transfer", secs, untuned,
                                    best.model_id, snap.generation)

        with self._lock:
            self._counters["default_misses"] += 1
        self._trace_lookup(instance, "default", snap.generation)
        return LookupResult(None, "default", untuned, untuned, "", snap.generation)

    def _trace_lookup(self, instance: KernelInstance, tier: str,
                      generation: int) -> None:
        if self.tracer.enabled:
            self.tracer.event("lookup", self.trace_track,
                              key=instance.workload_key(), tier=tier,
                              target=self.target, generation=generation)

    # -- background jobs ------------------------------------------------------
    def _enqueue(self, instance: KernelInstance, *,
                 priority: float = 0.0) -> bool:
        """Queue a background transfer-tuning job (dedup + budget gated).

        Returns True when a job for the workload is now pending (whether
        this call created it or one was already queued).
        """
        key = instance.workload_key()
        with self._lock:
            job = self._jobs.get(key)
            if job is not None:
                self._counters["jobs_deduped"] += 1
                # A hotter demand signal promotes an already-queued job.
                if not job.started and priority > job.priority:
                    job.priority = priority
                return not job.started
            if key in self._attempted:
                self._counters["jobs_deduped"] += 1
                return False
            if self._spent_s >= self.budget_s:
                self._counters["jobs_rejected_budget"] += 1
                return False
            self._job_seq += 1
            job = _Job(instance, priority=priority, seq=self._job_seq,
                       enqueued_t=self._clock())
            self._jobs[key] = job
            self._counters["jobs_enqueued"] += 1
            if self.tracer.enabled:
                self.tracer.event("enqueue", self.trace_track, key=key,
                                  priority=priority)
            if self._pool is not None:
                # The worker claims the best *unstarted* job at run time
                # rather than being bound to this key: a priority queue in
                # front of the pool, so prefetch promotions reorder work
                # that was submitted earlier but has not started yet.
                job.future = self._pool.submit(self._run_job)
            return True

    def prefetch(self, instance: KernelInstance, *,
                 priority: float = 0.0) -> bool:
        """Demand-driven enqueue: queue (or promote) a tuning job *ahead* of
        a serving miss.

        Fleets call this for the hottest unresolved shapes so upgrades land
        before demand peaks.  ``priority`` orders both the deferred drain
        queue and the threaded pool (higher first; FIFO within a priority):
        workers claim the highest-priority unstarted job when a pool slot
        frees up, so a promotion reorders queued work in either mode.
        Returns True when a job for the workload is pending.
        """
        with self._lock:
            self._counters["prefetches"] += 1
        return self._enqueue(instance, priority=priority)

    def attempted(self, key: str) -> bool:
        """Whether a background job for this workload key already ran
        (whether or not it published).  Advisors treat attempted workloads
        as exhausted: re-running the same deterministic search cannot find
        a different answer, so their priority budget goes elsewhere."""
        with self._lock:
            return key in self._attempted

    def pending_jobs(self) -> list[str]:
        """Workload keys awaiting background tuning, in deferred-drain order
        (highest priority first, then FIFO)."""
        with self._lock:
            jobs = [j for j in self._jobs.values() if not j.started]
        jobs.sort(key=lambda j: (-j.priority, j.seq))
        return [j.instance.workload_key() for j in jobs]

    def cancel_pending(self) -> int:
        """Drop queued jobs that have not started.

        Works in both modes: threaded workers claim jobs under the lock, so
        removing an unstarted job here means no worker will ever run it (its
        already-submitted future completes as a no-op).  The workloads are
        *not* marked attempted: a later lookup or prefetch may legitimately
        re-enqueue them.  Callers shutting down (e.g. a fleet at end of
        trace) use this so ``close()``'s drain does not spend search budget
        tuning shapes nobody is waiting for.
        """
        with self._lock:
            keys = [k for k, j in self._jobs.items() if not j.started]
            for k in keys:
                del self._jobs[k]
            self._counters["jobs_cancelled"] += len(keys)
        if keys and self.tracer.enabled:
            self.tracer.event("cancel", self.trace_track, jobs=len(keys))
        return len(keys)

    def _claim_best_locked(self) -> str | None:
        """Highest-priority unstarted workload key (FIFO within a priority).
        Caller holds ``_lock``."""
        best = None
        for k, j in self._jobs.items():
            if j.started:
                continue
            cand = (-j.priority, j.seq, k)
            if best is None or cand < best:
                best = cand
        return best[2] if best is not None else None

    def _note_claim_locked(self, winner: _Job) -> None:
        """Starvation accounting for one claim.  Caller holds ``_lock``.

        Every still-unstarted job that was enqueued *before* the claimed one
        was just passed over by a higher-priority claim; a job passed over
        more than :data:`STARVATION_SKIPS` times counts as starved (once).
        """
        for j in self._jobs.values():
            if j.started or j is winner or j.seq >= winner.seq:
                continue
            j.skips += 1
            if j.skips > self.STARVATION_SKIPS and not j.starved:
                j.starved = True
                self._counters["jobs_starved"] += 1

    def _run_job(self, key: str | None = None) -> bool:
        """Transfer-tune one missed workload and publish an upgrade.

        ``key=None`` (threaded workers) claims the best unstarted job under
        the lock — claim and mark-started are one critical section, so two
        workers can never pick the same job and none is orphaned.  Returns
        True when a better schedule was published."""
        with self._lock:
            if key is None:
                key = self._claim_best_locked()
                if key is None:
                    return False
            job = self._jobs.get(key)
            if job is None or job.started:
                return False
            # Re-check the budget at run time: jobs admitted while earlier
            # ones were still queued must not run once the budget is spent.
            if self._spent_s >= self.budget_s:
                self._counters["jobs_rejected_budget"] += 1
                self._jobs.pop(key, None)
                return False
            job.started = True
            self._note_claim_locked(job)
        instance = job.instance
        claim_t = self.tracer.now() if self.tracer.enabled else 0.0
        try:
            snap = self.registry.snapshot()
            db = snap.db(None)
            res = transfer_tune(
                [KernelUse(instance)], db, model_id=self.model_id,
                donors=self.donor_models(db), mode=self.mode, seed=self.seed,
                noise_sigma=self.noise_sigma, runner=self.runner,
                target=self.target, donor_target=self.donor_target)
            with self._lock:
                self._spent_s += res.search_time_s
            k = res.kernels[0]
            published = False
            if k.chosen is not None:
                published = self._publish(instance, k.chosen, k.seconds,
                                          k.chosen_from)
            with self._lock:
                self._counters["jobs_completed"] += 1
                self.completed_order.append(key)
            self._job_hist.observe(res.search_time_s)
            if self.tracer.enabled:
                # The span covers the job's *virtual search cost* from its
                # claim instant — the duration the budget was charged.
                self.tracer.add_async_span(
                    "tune", self.trace_track, claim_t,
                    claim_t + res.search_time_s, "tune", key, key=key,
                    priority=job.priority, published=published,
                    search_s=res.search_time_s, target=self.target,
                    donor_target=self.donor_target)
            return published
        except Exception:
            with self._lock:
                self._counters["jobs_failed"] += 1
            raise
        finally:
            with self._lock:
                self._attempted.add(key)
                self._jobs.pop(key, None)

    def _publish(self, instance: KernelInstance, schedule: Schedule,
                 seconds: float, donor: str) -> bool:
        """Publish atomically unless it would downgrade the visible best."""
        with self._publish_lock:
            current = self.registry.snapshot().db(None).exact(
                instance, target=self.target)
            if current is not None and current.seconds <= seconds:
                with self._lock:
                    self._counters["publish_skipped"] += 1
                return False
            gen_before = self.registry.generation
            comp_before = getattr(self.registry, "compactions", 0)
            gen_after = self.registry.publish(
                [Record(instance=instance, schedule=schedule, seconds=seconds,
                        model_id=self.model_id, target=self.target)],
                mode=self.mode)
            comp_delta = getattr(self.registry, "compactions", 0) - comp_before
            # gen_after may exceed gen_before + 1: auto-compaction inside
            # publish (keeps the best record per workload — attributable to
            # this key) or *another process's* publishes folded in when our
            # snapshot was stale (NOT attributable: those may change any
            # workload's answer).  A span wider than 1 + compactions poisons
            # the event (key None -> changed_since reports unknown).
            key = (instance.workload_key()
                   if gen_after == gen_before + 1 + comp_delta else None)
            with self._lock:
                self._counters["upgrades"] += 1
                self._pub_events.append((gen_before, gen_after, key))
                del self._pub_events[:-512]
            if self.tracer.enabled:
                self.tracer.event(
                    "publish", self.trace_track,
                    key=instance.workload_key(), seconds=seconds,
                    donor=donor, gen_before=gen_before, gen_after=gen_after,
                    target=self.target, donor_target=self.donor_target)
            return True

    # -- generation / change notification -------------------------------------
    def generation(self) -> int:
        """Registry generation visible to this service's lookups."""
        return self.registry.generation

    def changed_since(self, generation: int) -> set[str] | None:
        """Workload keys whose published best may have changed since
        ``generation``.

        Returns ``None`` when the generation bumps since then cannot all be
        attributed to this service's own publishes (another writer touched
        the registry, or the publish log was trimmed) — callers must then
        assume anything changed.  Resolution pipelines use this to migrate
        memoized entries across generations instead of re-resolving every
        workload after each background upgrade.
        """
        current = self.registry.generation
        if generation >= current:
            return set()
        with self._lock:
            events = sorted((e for e in self._pub_events if e[1] > generation),
                            key=lambda e: (e[0], e[1]))
        g = generation
        changed: set[str] = set()
        for g_before, g_after, key in events:
            if g_before > g:
                return None  # gap: a publish we did not perform
            if g_after > g:
                if key is None:
                    return None  # poisoned: external publishes folded in
                changed.add(key)
                g = g_after
        return changed if g == current else None

    def drain(self, max_jobs: int | None = None, timeout: float | None = None) -> int:
        """Complete queued background work; returns jobs finished.

        Deferred mode (``max_workers=0``) runs up to ``max_jobs`` queued jobs
        inline, oldest first — the deterministic stepping used by the
        benchmark's serve stream.  Threaded mode waits for in-flight futures.
        """
        finished = 0
        if self._pool is None:
            while True:
                with self._lock:
                    pending = [(-j.priority, j.seq, k)
                               for k, j in self._jobs.items()
                               if j.future is None and not j.started]
                if not pending or (max_jobs is not None and finished >= max_jobs):
                    return finished
                # Highest demand priority first, FIFO within a priority —
                # the order pending_jobs() reports.
                self._run_job(min(pending)[2])
                finished += 1
        while True:
            with self._lock:
                futures = [j.future for j in self._jobs.values()
                           if j.future is not None]
            if not futures:
                return finished
            done, _ = wait(futures, timeout=timeout)
            finished += len(done)
            if timeout is not None:
                return finished

    def close(self) -> None:
        """Drain outstanding work (including deferred jobs) and shut down."""
        self.drain()
        if self._pool is not None:
            self._pool.shutdown(wait=True)

    # -- telemetry ------------------------------------------------------------
    def stats(self) -> dict:
        now = self._clock()
        with self._lock:
            out = dict(self._counters)
            out["in_flight"] = len(self._jobs)
            out["search_seconds_spent"] = self._spent_s
            out["probe_search_s"] = self._probe_s
            out["budget_s"] = self.budget_s
            # Queue health: how long unstarted work has been waiting, and
            # the per-job view (age / skips / starved) for the starvation
            # audit the advisor's priority ordering is checked against.
            unstarted = [j for j in self._jobs.values() if not j.started]
            ages = [max(0.0, now - j.enqueued_t) for j in unstarted]
            out["queue_depth_unstarted"] = len(unstarted)
            out["queue_age_mean_s"] = sum(ages) / len(ages) if ages else 0.0
            out["oldest_unstarted_age_s"] = max(ages, default=0.0)
            out["queue_jobs"] = sorted(
                ({"key": j.instance.workload_key(), "priority": j.priority,
                  "age_s": max(0.0, now - j.enqueued_t), "skips": j.skips,
                  "starved": j.starved} for j in unstarted),
                key=lambda r: -r["age_s"])
        self._queue_age_g.sample(out["queue_age_mean_s"], now)
        self._oldest_age_g.sample(out["oldest_unstarted_age_s"], now)
        out["generation"] = self.registry.generation
        out["target"] = self.target
        out["donor_target"] = self.donor_target
        lookups = out["lookups"] or 1
        out["exact_hit_rate"] = out["exact_hits"] / lookups
        return out
