"""Resolution pipeline: staged, generation-aware schedule resolution.

A copy of ``repro.core.resolution`` (the port imports nothing of
``repro``); the ops it plans for are :mod:`repro_torch.kernels.ops`.

The paper's payoff is *cheap reuse*: auto-schedules are found once and then
served many times.  Before this module, the serving hot path re-paid
resolution on every kernel call — a service lookup (lock + counters +
optional transfer probe) followed by a fresh ``concretize``.  This module
makes resolution a first-class, explicitly staged pipeline with a memoized
result cache:

* :class:`ResolutionPipeline` walks an ordered list of stages —
  **service** (online :class:`~repro_torch.service.TuningService`) → **static map**
  (frozen offline schedules) → **default** (untuned fallback) — and caches
  the winning :class:`Resolution` keyed by
  ``(workload_key, mode, target, generation)``.  ``generation`` is the
  schedule registry's publish counter, so a background upgrade naturally
  invalidates exactly the stale keys: steady-state resolution is a single
  dict hit with no service lock and no re-``concretize``.
* When the service can attribute every generation bump to its own publishes
  (:meth:`TuningService.changed_since`), the cache *migrates* unchanged
  workloads to the new generation instead of clearing — an upgrade to one
  kernel does not re-resolve the other hundred.
* :class:`ExecutionPlan` freezes the resolutions for every kernel instance a
  model emits (via :mod:`repro_torch.core.extract`), with provenance tier and a
  generation stamp.  :func:`plan_model` builds one for an (arch × shape)
  cell; :func:`plan_serving` builds one for a serving engine's decode batch
  and prefill buckets.  Ops consult the active plan before falling back to
  the pipeline; a plan lookup is a dict hit — no service lock, no stage
  walk, no re-``concretize`` (only a cheap local counter bump remains).

Per-tier accounting (``exact`` / ``transfer`` / ``static`` / ``default``) is
kept here under a lock, replacing the lossy (and racy) hit/miss pair the old
provider kept: a service answer of the *untuned default* tier falls through
the stage and is never counted as a hit.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Iterable, Mapping, Sequence

from repro_torch.core.schedule import (
    ConcreteSchedule,
    Schedule,
    ScheduleInvalid,
    concretize,
    default_schedule,
)
from repro_torch.core.workload import KernelInstance, KernelUse, dedup_uses
from repro_torch.obs import NULL_TRACER, MetricsRegistry
from repro_torch.targets import DEFAULT_TARGET, target_name

#: Resolution tiers, strongest first.  ``exact``/``transfer`` come from the
#: online service, ``static`` from a frozen offline schedule map, ``default``
#: is the untuned fallback.
TIERS = ("exact", "transfer", "static", "default")


@dataclasses.dataclass(frozen=True)
class Resolution:
    """One resolved schedule: the concrete binding plus its provenance."""

    concrete: ConcreteSchedule
    tier: str                 # one of TIERS
    stage: str = ""           # name of the pipeline stage that answered
    source_model: str = ""    # model the winning schedule was tuned on
    generation: int = 0       # pipeline generation the resolution is valid at

    @property
    def schedule(self) -> Schedule:
        return self.concrete.schedule

    @property
    def instance(self) -> KernelInstance:
        return self.concrete.instance


# ---------------------------------------------------------------------------
# Stages
# ---------------------------------------------------------------------------


class ResolutionStage:
    """One rung of the pipeline: answer or pass (return ``None``)."""

    name = "stage"

    def resolve(self, instance: KernelInstance, mode: str) -> Resolution | None:
        raise NotImplementedError

    def generation(self) -> int:
        """Monotone counter bumped whenever this stage's answers may change."""
        return 0

    def changed_since(self, generation: int) -> set[str] | None:
        """Workload keys whose answer may differ since ``generation``.

        ``None`` means "unknown — assume everything changed".  Static stages
        never change, so the base returns the empty set.
        """
        return set()


class ServiceStage(ResolutionStage):
    """Tiered online lookup through a :class:`~repro_torch.service.TuningService`.

    Only ``exact``/``transfer`` answers count; a ``default``-tier lookup
    falls through to the next stage (the untuned default is not a hit — the
    accounting bug the old provider had).  Answers are re-validated under
    the *requested* mode, which may differ from the service's own.
    """

    name = "service"

    def __init__(self, service):
        self.service = service

    def resolve(self, instance: KernelInstance, mode: str) -> Resolution | None:
        lr = self.service.lookup(instance)
        if lr.schedule is None or lr.tier == "default":
            return None
        try:
            cs = concretize(lr.schedule, instance, mode=mode)
        except ScheduleInvalid:
            return None
        return Resolution(cs, lr.tier, self.name, lr.source_model, lr.generation)

    def generation(self) -> int:
        gen = getattr(self.service, "generation", None)
        if callable(gen):
            return gen()
        return getattr(self.service.registry, "generation", 0)

    def changed_since(self, generation: int) -> set[str] | None:
        fn = getattr(self.service, "changed_since", None)
        if fn is None:
            return None
        return fn(generation)


class StaticMapStage(ResolutionStage):
    """Frozen ``workload_key -> Schedule`` mapping (offline tuning output)."""

    name = "static"

    def __init__(self, schedule_map: Mapping[str, Schedule] | None = None):
        self.schedule_map = dict(schedule_map or {})

    def resolve(self, instance: KernelInstance, mode: str) -> Resolution | None:
        sched = self.schedule_map.get(instance.workload_key())
        if sched is None:
            return None
        try:
            cs = concretize(sched, instance, mode=mode)
        except ScheduleInvalid:
            return None
        return Resolution(cs, "static", self.name, sched.source)


class DefaultStage(ResolutionStage):
    """Terminal stage: the untuned default schedule, always valid."""

    name = "default"

    def resolve(self, instance: KernelInstance, mode: str) -> Resolution | None:
        cs = concretize(default_schedule(instance), instance)
        return Resolution(cs, "default", self.name, "")


# ---------------------------------------------------------------------------
# Pipeline
# ---------------------------------------------------------------------------


class ResolutionPipeline:
    """Staged resolution with a generation-keyed memo cache.

    ``resolve()`` walks the stages on a miss and caches the winner under
    ``(workload_key, mode, target, generation)``.  The generation is the sum
    of the stages' counters (in practice: the schedule registry's publish
    counter), so background upgrades invalidate exactly the stale entries.
    Counter updates are lock-protected; the steady-state read is a dict hit.
    """

    def __init__(self, stages: Sequence[ResolutionStage], *,
                 mode: str = "strict", target=None,
                 metrics: MetricsRegistry | None = None, tracer=None):
        if not stages:
            stages = [DefaultStage()]
        self.stages = list(stages)
        self.mode = mode
        self.target = target_name(target) if target is not None else DEFAULT_TARGET
        self._lock = threading.Lock()
        self._cache: dict[tuple[str, str, str, int], Resolution] = {}
        # Per-stage generation vector: each stage's changed_since must be
        # asked against its OWN last generation (summing first would
        # misattribute bumps when several stages carry counters).
        self._stage_gens = tuple(st.generation() for st in self.stages)
        self._cache_gen = sum(self._stage_gens)
        # Counters live in a metrics registry (private by default: one
        # pipeline per replica, and same-named counters must not merge
        # across replicas).  Owners rebind ``tracer`` post-construction.
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self._counters = self.metrics.group("resolution", [
            "resolves", "cache_hits", "cache_misses", "stage_calls",
            "migrated", "invalidations", *(f"served_{t}" for t in TIERS)])

    @staticmethod
    def build(schedule_map: Mapping[str, Schedule] | None = None,
              service=None, mode: str = "strict", target=None
              ) -> "ResolutionPipeline":
        """The canonical stage order: service → static map → default."""
        stages: list[ResolutionStage] = []
        if service is not None:
            stages.append(ServiceStage(service))
            if target is None:
                target = getattr(service, "target", None)
        stages.append(StaticMapStage(schedule_map))
        stages.append(DefaultStage())
        return ResolutionPipeline(stages, mode=mode, target=target)

    # -- convenience accessors ------------------------------------------------
    @property
    def service(self):
        for st in self.stages:
            if isinstance(st, ServiceStage):
                return st.service
        return None

    @property
    def schedule_map(self) -> dict[str, Schedule]:
        for st in self.stages:
            if isinstance(st, StaticMapStage):
                return st.schedule_map
        return {}

    # -- resolution -----------------------------------------------------------
    def generation(self) -> int:
        return sum(st.generation() for st in self.stages)

    def resolve(self, instance: KernelInstance, mode: str | None = None
                ) -> Resolution:
        mode = mode or self.mode
        gen = self.generation()
        if gen != self._cache_gen:
            with self._lock:
                self._sync_generation_locked()
            gen = self._cache_gen
        key = (instance.workload_key(), mode, self.target, gen)
        res = self._cache.get(key)
        if res is not None:
            with self._lock:
                self._counters["resolves"] += 1
                self._counters["cache_hits"] += 1
                self._counters[f"served_{res.tier}"] += 1
            return res

        res = None
        walked = 0
        for stage in self.stages:
            walked += 1
            res = stage.resolve(instance, mode)
            if res is not None:
                break
        if res is None:  # no terminal stage configured: untuned fallback
            res = Resolution(concretize(default_schedule(instance), instance),
                             "default", "fallback", "")
        res = dataclasses.replace(res, generation=gen)
        with self._lock:
            self._counters["resolves"] += 1
            self._counters["cache_misses"] += 1
            self._counters["stage_calls"] += walked
            self._counters[f"served_{res.tier}"] += 1
            self._cache[key] = res
        # Only stage walks are traced: memoized hits are the hot path and
        # would swamp the trace with identical records.
        if self.tracer.enabled:
            self.tracer.event("resolve", "resolution",
                              key=instance.workload_key(), tier=res.tier,
                              stage=res.stage, target=self.target,
                              generation=gen)
        return res

    def get(self, instance: KernelInstance) -> ConcreteSchedule:
        """Ops-facing API: the concrete schedule to run ``instance`` with."""
        return self.resolve(instance).concrete

    def _sync_generation_locked(self) -> None:
        stage_gens = tuple(st.generation() for st in self.stages)
        new_gen = sum(stage_gens)
        if new_gen == self._cache_gen:
            return  # another thread synced while we waited on the lock
        changed: set[str] | None = set()
        for st, old_g in zip(self.stages, self._stage_gens):
            c = st.changed_since(old_g)
            if c is None:
                changed = None
                break
            changed |= c
        if changed is None:
            # Unattributable bump (e.g. another process published): assume
            # anything may have changed.
            self._cache.clear()
            self._counters["invalidations"] += 1
        else:
            moved: dict[tuple[str, str, str, int], Resolution] = {}
            for (wk, mode, tgt, g), res in self._cache.items():
                # Only entries at the synced generation migrate: a slow
                # resolver may have inserted under an older generation after
                # a previous sync, and rekeying it here could shadow the
                # fresher answer.
                if g == self._cache_gen and wk not in changed:
                    moved[(wk, mode, tgt, new_gen)] = dataclasses.replace(
                        res, generation=new_gen)
            self._counters["migrated"] += len(moved)
            self._cache = moved
        self._cache_gen = new_gen
        self._stage_gens = stage_gens

    def invalidate(self) -> None:
        """Drop every memoized resolution (stages are re-walked on demand)."""
        with self._lock:
            self._cache.clear()
            self._counters["invalidations"] += 1

    # -- telemetry ------------------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            out = dict(self._counters)
            out["cache_size"] = len(self._cache)
        out["generation"] = self.generation()
        out["mode"] = self.mode
        out["target"] = self.target
        out["stages"] = [st.name for st in self.stages]
        return out


# ---------------------------------------------------------------------------
# Execution plans
# ---------------------------------------------------------------------------


class ExecutionPlan:
    """Frozen pre-resolved schedules for every kernel a model emits.

    Built once per (model, shapes, generation); lookups are a plain dict hit
    with zero locks — the serving hot path's steady state.  A plan is
    immutable: upgrades produce a *new* plan via :meth:`refresh` (the engine
    swaps plans only between decode steps, never mid-step).
    """

    def __init__(self, uses: Sequence[KernelUse],
                 resolutions: Sequence[Resolution], *, generation: int,
                 mode: str, target: str, label: str = ""):
        if len(uses) != len(resolutions):
            raise ValueError("one resolution per kernel use required")
        self.uses = tuple(uses)
        self.generation = generation
        self.mode = mode
        self.target = target
        self.label = label
        self._by_key: dict[str, Resolution] = {
            u.instance.workload_key(): r for u, r in zip(uses, resolutions)
        }

    def __len__(self) -> int:
        return len(self._by_key)

    def lookup(self, instance: KernelInstance) -> Resolution | None:
        return self._by_key.get(instance.workload_key())

    def get(self, workload_key: str) -> Resolution | None:
        return self._by_key.get(workload_key)

    def items(self) -> Iterable[tuple[KernelUse, Resolution]]:
        for u in self.uses:
            yield u, self._by_key[u.instance.workload_key()]

    def tier_counts(self) -> dict[str, int]:
        counts = {t: 0 for t in TIERS}
        for r in self._by_key.values():
            counts[r.tier] += 1
        return counts

    def schedules(self) -> dict[str, Schedule]:
        """workload_key -> chosen Schedule (for equivalence checks)."""
        return {k: r.schedule for k, r in self._by_key.items()}

    def refresh(self, pipeline: ResolutionPipeline) -> "ExecutionPlan":
        """Re-resolve every entry at the pipeline's current generation."""
        return plan_uses(self.uses, pipeline, label=self.label)


def plan_uses(uses: Sequence[KernelUse], pipeline: ResolutionPipeline,
              label: str = "") -> ExecutionPlan:
    """Freeze resolutions for an explicit kernel-use list."""
    merged = dedup_uses(list(uses))
    generation = pipeline.generation()
    resolutions = [pipeline.resolve(u.instance) for u in merged]
    return ExecutionPlan(merged, resolutions, generation=generation,
                         mode=pipeline.mode, target=pipeline.target,
                         label=label)


def plan_model(model_cfg, pipeline: ResolutionPipeline, shape="train_4k", *,
               dp: int = 1, tp: int = 1, label: str | None = None
               ) -> ExecutionPlan:
    """Pre-resolve every kernel instance an (arch × shape) cell emits.

    ``model_cfg`` is an :class:`~repro_torch.configs.base.ArchConfig` or arch id;
    ``shape`` a :class:`~repro_torch.configs.base.ShapeConfig` or shape name.
    """
    from repro_torch.configs.base import get_arch, get_shape  # lazy: layering
    from repro_torch.core.extract import extract_kernels

    cfg = get_arch(model_cfg) if isinstance(model_cfg, str) else model_cfg
    sh = get_shape(shape) if isinstance(shape, str) else shape
    uses = extract_kernels(cfg, sh, dp=dp, tp=tp)
    return plan_uses(uses, pipeline,
                     label=label if label is not None else f"{cfg.name}/{sh.name}")


def plan_serving(model_cfg, pipeline: ResolutionPipeline, *, slots: int,
                 max_len: int, prefill_lengths: Sequence[int] = (),
                 label: str = "serving") -> ExecutionPlan:
    """Pre-resolve a serving engine's kernel set.

    Covers the batched decode step (batch = ``slots``) plus a batch-1
    prefill cell per expected prompt-length bucket.  Instances the engine
    emits outside this set (e.g. unbucketed prompt lengths) fall back to the
    pipeline at run time.
    """
    from repro_torch.configs.base import ShapeConfig  # lazy: layering
    from repro_torch.core.extract import extract_kernels

    uses = list(extract_kernels(
        model_cfg, ShapeConfig("serve_decode", max_len, slots, "decode"),
        dp=1, tp=1))
    for n in sorted(set(int(n) for n in prefill_lengths)):
        uses.extend(extract_kernels(
            model_cfg, ShapeConfig(f"serve_prefill_{n}", n, 1, "prefill"),
            dp=1, tp=1))
    return plan_uses(uses, pipeline, label=label)


def plan_serving_paged(model_cfg, pipeline: ResolutionPipeline, *,
                       decode_batch: int, page_size: int, pages_per_seq: int,
                       chunk_lens: Sequence[int] = (), spec_k: int = 0,
                       draft_cfg=None, label: str | None = None
                       ) -> ExecutionPlan:
    """Pre-resolve a *paged* serving engine's kernel set.

    The paged engine's workload classes key on (decode-batch-size,
    page-size): the batched decode step runs at ``decode_batch`` lanes over
    a per-lane context of ``page_size * pages_per_seq`` gathered pages, and
    prefill is batch-1 ``chunk_prefill`` cells — one per chunk length —
    attending into that same context.  The registry/TuningService stack
    learns these shapes exactly like any other cell.

    ``spec_k > 0`` adds the speculative cells: the batched ``verify`` step
    (k+1 positions per lane, all ``decode_batch`` lanes) for the target
    model, and — when ``draft_cfg`` is given — the draft model's decode and
    chunk-prefill cells.  The verify cell shares the chunk-prefill kernel
    classes, so transfer-tuning seeds it from the chunk donors.
    """
    from repro_torch.configs.base import ShapeConfig  # lazy: layering
    from repro_torch.core.extract import extract_kernels

    max_ctx = page_size * pages_per_seq
    if label is None:
        label = f"paged/b{decode_batch}/p{page_size}"
    uses = list(extract_kernels(
        model_cfg, ShapeConfig("paged_decode", max_ctx, decode_batch,
                               "decode"), dp=1, tp=1))
    for c in sorted(set(int(c) for c in chunk_lens)):
        uses.extend(extract_kernels(
            model_cfg, ShapeConfig(f"paged_chunk_{c}", c, 1, "chunk_prefill",
                                   ctx_len=max_ctx), dp=1, tp=1))
    if spec_k > 0:
        uses.extend(spec_verify_uses(model_cfg, decode_batch=decode_batch,
                                     max_ctx=max_ctx, spec_k=spec_k))
        if draft_cfg is not None:
            uses.extend(extract_kernels(
                draft_cfg, ShapeConfig("paged_decode", max_ctx, decode_batch,
                                       "decode"), dp=1, tp=1))
            for c in sorted(set(int(c) for c in chunk_lens)):
                uses.extend(extract_kernels(
                    draft_cfg, ShapeConfig(f"paged_chunk_{c}", c, 1,
                                           "chunk_prefill", ctx_len=max_ctx),
                    dp=1, tp=1))
    return plan_uses(uses, pipeline, label=label)


def spec_verify_uses(model_cfg, *, decode_batch: int, max_ctx: int,
                     spec_k: int) -> list[KernelUse]:
    """Kernel uses of one batched speculative ``verify`` step: k+1 positions
    per lane across all ``decode_batch`` lanes, attending into ``max_ctx``
    cached context.  Exposed standalone so benchmarks and the tuning service
    can tune / transfer-seed the verify workload without building a plan."""
    from repro_torch.configs.base import ShapeConfig  # lazy: layering
    from repro_torch.core.extract import extract_kernels

    return list(extract_kernels(
        model_cfg, ShapeConfig(f"spec_verify_{spec_k + 1}", spec_k + 1,
                               decode_batch, "verify", ctx_len=max_ctx),
        dp=1, tp=1))
