"""Pluggable measurement runners: the seam between search and "hardware".

A copy of ``repro.core.runner``; the runner that times schedules on the card
is :class:`repro_torch.core.measured_runner.MeasuredRunner`, and
:class:`AnalyticalRunner` refuses a measured-only target (``h100``), so no
cost-model second lands in the card's namespace.

Every layer of the tuning stack (evolutionary search, transfer-tuning, the
donor heuristic, benchmarks) needs the answer to one question — "how fast is
schedule S on instance I?" — and historically each called
:func:`repro_torch.core.cost_model.measure` directly, serially, uncached.  This
module extracts that call behind a small protocol so the *policy* of
measurement (caching, batching, draft-then-verify pruning, and eventually a
real interpreted-Pallas backend) is injectable without touching the search
code.

Three implementations ship today:

* :class:`AnalyticalRunner` — wraps the analytical cost model one-to-one;
  behaviour-identical to the old direct calls.
* :class:`CachedRunner` — memoizes on ``(workload, schedule, mode, seed,
  noise_sigma)``.  Repeated donor schedules across target kernels, matrix
  cells, and benchmark passes are measured once; hits are free (zero virtual
  ``measure_cost_s``) and counted in :class:`RunnerStats`.
* :class:`PruningRunner` — Pruner-style (arXiv:2402.02361) draft-then-verify:
  ranks a candidate batch with the zero-cost noise-free analytical
  breakdown, then charges full virtual build+run seconds only for the
  ``verify_top_k`` drafts it actually verifies.  Pruned candidates come back
  with ``seconds=None`` and ``pruned=True`` so callers can distinguish them
  from invalid schedules.

The composition ``CachedRunner(AnalyticalRunner())`` is the default
everywhere (see :func:`default_runner`); ``PruningRunner(CachedRunner(...))``
is the aggressive search configuration.  See DESIGN.md for the worked
example.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.core.cost_model import Measurement, kernel_seconds, measure
from repro_torch.core.schedule import Schedule, ScheduleInvalid
from repro_torch.core.workload import KernelInstance
from repro_torch.hw.specs import ChipSpec
from repro_torch.targets import DEFAULT_TARGET, Target, resolve_target


@dataclasses.dataclass
class RunnerStats:
    """Per-runner-layer counters (each layer of a composition keeps its own)."""

    requests: int = 0          # measure() questions answered at this layer
    measurements: int = 0      # full cost-model evaluations actually performed
    cache_hits: int = 0
    cache_misses: int = 0
    drafts: int = 0            # zero-cost draft rankings performed
    pruned: int = 0            # candidates dropped without full measurement
    measure_cost_s: float = 0.0  # virtual harness seconds charged by this layer


class MeasureRunner:
    """Protocol + shared machinery for measurement backends.

    Subclasses implement :meth:`measure`; :meth:`measure_many` defaults to a
    serial loop and is the batching seam (PruningRunner overrides it, a
    future real-hardware runner would build candidates concurrently).
    """

    def __init__(self) -> None:
        self.stats = RunnerStats()

    @property
    def target(self) -> str:
        """Name of the hardware target this runner measures for.

        Wrapper layers inherit it from their inner runner; the innermost
        backend (AnalyticalRunner, or a future real-hardware runner) owns it.
        A runner measures exactly one target — per-target namespacing of
        schedule stores relies on this identity.
        """
        inner = getattr(self, "inner", None)
        if inner is not None:
            return inner.target
        return DEFAULT_TARGET

    # -- core protocol -------------------------------------------------------
    def measure(self, instance: KernelInstance, schedule: Schedule, *,
                mode: str = "strict", seed: int = 0,
                noise_sigma: float = 0.05) -> Measurement:
        raise NotImplementedError

    def measure_many(self, instance: KernelInstance, schedules: Sequence[Schedule],
                     *, mode: str = "strict", seed: int = 0,
                     noise_sigma: float = 0.05) -> list[Measurement]:
        """Measure a candidate batch for one instance (order-preserving)."""
        return [
            self.measure(instance, s, mode=mode, seed=seed, noise_sigma=noise_sigma)
            for s in schedules
        ]

    def seconds(self, instance: KernelInstance, schedule: Schedule | None = None,
                mode: str = "strict") -> float:
        """Noise-free ground-truth seconds (no virtual harness cost).

        Raises ScheduleInvalid if the schedule cannot bind to the instance.
        """
        return kernel_seconds(instance, schedule, mode=mode)

    # -- telemetry -----------------------------------------------------------
    def telemetry(self) -> dict[str, float]:
        """Flat counter dict merged across the runner composition."""
        out = {
            "requests": self.stats.requests,
            "measurements": self.stats.measurements,
            "cache_hits": self.stats.cache_hits,
            "cache_misses": self.stats.cache_misses,
            "drafts": self.stats.drafts,
            "pruned": self.stats.pruned,
            "measure_cost_s": self.stats.measure_cost_s,
        }
        inner = getattr(self, "inner", None)
        if inner is not None:
            for k, v in inner.telemetry().items():
                if k == "requests":
                    pass  # outermost layer owns the question count
                else:
                    # Summing is exact: each counter is incremented by exactly
                    # one layer kind (measurements by the innermost backend,
                    # hits/misses by caches, drafts/pruned + draft charges by
                    # pruners), so the total measure_cost_s matches the sum
                    # of per-Measurement charges callers accumulate.
                    out[k] = out.get(k, 0) + v
        return out


def telemetry_delta(after: dict[str, float], before: dict[str, float]) -> dict[str, float]:
    """Counter difference between two :meth:`MeasureRunner.telemetry` snapshots."""
    return {k: after[k] - before.get(k, 0) for k in after}


#: Targets whose seconds come only from timing the port's kernels on the
#: card: the TPU cost model does not describe them.
MEASURED_TARGETS = ("h100",)


class AnalyticalRunner(MeasureRunner):
    """Bare analytical cost model — behaviour-identical to direct measure().

    ``target`` names the chip to model: a registered target name, a
    :class:`~repro_torch.targets.Target`, a bare :class:`ChipSpec`, or ``None``
    (the default ``tpu-v5e``).  A target of :data:`MEASURED_TARGETS` raises
    ``ValueError``: its schedules are timed by ``MeasuredRunner``.
    """

    def __init__(self, target: "str | Target | ChipSpec | None" = None):
        super().__init__()
        t = resolve_target(target)
        if t.name in MEASURED_TARGETS:
            raise ValueError(
                f"target {t.name!r} is measured, not modelled: time its schedules with "
                "repro_torch.core.measured_runner.MeasuredRunner")
        self.spec = t.spec
        self._target_name = t.name

    @property
    def target(self) -> str:
        return self._target_name

    def measure(self, instance: KernelInstance, schedule: Schedule, *,
                mode: str = "strict", seed: int = 0,
                noise_sigma: float = 0.05) -> Measurement:
        m = measure(instance, schedule, mode=mode, seed=seed,
                    noise_sigma=noise_sigma, spec=self.spec)
        self.stats.requests += 1
        self.stats.measurements += 1
        self.stats.measure_cost_s += m.measure_cost_s
        return m

    def seconds(self, instance: KernelInstance, schedule: Schedule | None = None,
                mode: str = "strict") -> float:
        return kernel_seconds(instance, schedule, mode=mode, spec=self.spec)


class CachedRunner(MeasureRunner):
    """Memoizing wrapper: one full measurement per unique question.

    The key is ``(workload_key, schedule json, mode, seed, noise_sigma)`` —
    everything the simulated measurement depends on, including the noise
    seed, so caching is bit-transparent: a hit returns the stored
    measurement with ``measure_cost_s`` zeroed (the harness already paid for
    it exactly once) and ``cached=True``.
    """

    def __init__(self, inner: MeasureRunner | None = None):
        super().__init__()
        self.inner = inner if inner is not None else AnalyticalRunner()
        self._cache: dict[tuple, Measurement] = {}
        self._seconds_cache: dict[tuple, float | ScheduleInvalid] = {}

    def _key(self, instance: KernelInstance, schedule: Schedule, mode: str,
             seed: int, noise_sigma: float) -> tuple:
        # The target is part of the key: the cached answer is a property of
        # the chip the inner runner models, and keeping it explicit means a
        # future cross-runner cache merge cannot alias across targets.
        return (self.target, instance.workload_key(), repr(schedule.to_json()),
                mode, seed, noise_sigma)

    def measure(self, instance: KernelInstance, schedule: Schedule, *,
                mode: str = "strict", seed: int = 0,
                noise_sigma: float = 0.05) -> Measurement:
        self.stats.requests += 1
        key = self._key(instance, schedule, mode, seed, noise_sigma)
        hit = self._cache.get(key)
        if hit is not None:
            self.stats.cache_hits += 1
            return dataclasses.replace(hit, measure_cost_s=0.0, cached=True)
        self.stats.cache_misses += 1
        m = self.inner.measure(instance, schedule, mode=mode, seed=seed,
                               noise_sigma=noise_sigma)
        self._cache[key] = m
        return m

    def seconds(self, instance: KernelInstance, schedule: Schedule | None = None,
                mode: str = "strict") -> float:
        skey = repr(schedule.to_json()) if schedule is not None else None
        key = (self.target, instance.workload_key(), skey, mode)
        if key in self._seconds_cache:
            val = self._seconds_cache[key]
            if isinstance(val, ScheduleInvalid):
                raise val
            return val
        try:
            val = self.inner.seconds(instance, schedule, mode=mode)
        except ScheduleInvalid as e:
            self._seconds_cache[key] = e
            raise
        self._seconds_cache[key] = val
        return val

    def cache_info(self) -> dict[str, int]:
        return {
            "entries": len(self._cache),
            "hits": self.stats.cache_hits,
            "misses": self.stats.cache_misses,
        }


class PruningRunner(MeasureRunner):
    """Draft-then-verify batch measurement (Pruner, arXiv:2402.02361).

    ``measure_many`` ranks the batch with the zero-cost noise-free analytical
    breakdown (the draft), then fully measures only the best
    ``verify_top_k`` drafts through ``inner``.  Invalid candidates are caught
    statically at draft time (free — no virtual failed-compile charge);
    pruned candidates return ``seconds=None, pruned=True`` and cost
    ``draft_cost_s`` virtual seconds each (default 0).

    With ``verify_top_k >= len(candidates)`` every valid candidate is
    verified and the winning schedule is identical to the unpruned path.
    Single ``measure`` calls bypass drafting entirely.
    """

    def __init__(self, inner: MeasureRunner | None = None, *,
                 verify_top_k: int = 8, draft_cost_s: float = 0.0):
        super().__init__()
        if verify_top_k < 1:
            raise ValueError("verify_top_k must be >= 1")
        self.inner = inner if inner is not None else CachedRunner()
        self.verify_top_k = verify_top_k
        self.draft_cost_s = draft_cost_s

    def measure(self, instance: KernelInstance, schedule: Schedule, *,
                mode: str = "strict", seed: int = 0,
                noise_sigma: float = 0.05) -> Measurement:
        self.stats.requests += 1
        return self.inner.measure(instance, schedule, mode=mode, seed=seed,
                                  noise_sigma=noise_sigma)

    def measure_many(self, instance: KernelInstance, schedules: Sequence[Schedule],
                     *, mode: str = "strict", seed: int = 0,
                     noise_sigma: float = 0.05) -> list[Measurement]:
        self.stats.requests += len(schedules)
        drafts: list[tuple[int, float]] = []   # (index, draft seconds)
        results: list[Measurement | None] = [None] * len(schedules)
        for i, s in enumerate(schedules):
            self.stats.drafts += 1
            try:
                drafts.append((i, self.inner.seconds(instance, s, mode=mode)))
            except ScheduleInvalid:
                # Static draft catches invalid bindings before any build.
                results[i] = Measurement(seconds=None, measure_cost_s=self.draft_cost_s)
                self.stats.measure_cost_s += self.draft_cost_s
        drafts.sort(key=lambda t: t[1])
        verify = {i for i, _ in drafts[: self.verify_top_k]}
        for i, _ in drafts:
            if i in verify:
                results[i] = self.inner.measure(
                    instance, schedules[i], mode=mode, seed=seed,
                    noise_sigma=noise_sigma)
            else:
                self.stats.pruned += 1
                self.stats.measure_cost_s += self.draft_cost_s
                results[i] = Measurement(seconds=None,
                                         measure_cost_s=self.draft_cost_s,
                                         pruned=True)
        # Callers zip() the result against `schedules`: positional alignment
        # is part of the contract, so every slot must be filled.
        assert all(m is not None for m in results)
        return results

    def seconds(self, instance: KernelInstance, schedule: Schedule | None = None,
                mode: str = "strict") -> float:
        return self.inner.seconds(instance, schedule, mode=mode)


def default_runner(target: "str | Target | ChipSpec | None" = None) -> MeasureRunner:
    """The stack-wide default: memoized analytical measurement of ``target``."""
    return CachedRunner(AnalyticalRunner(target))


def resolve_runner(runner: MeasureRunner | None,
                   target: "str | Target | ChipSpec | None" = None,
                   ) -> tuple[MeasureRunner, str]:
    """Resolve the (runner, target-name) pair every tuning entrypoint needs.

    * runner=None            → a fresh :func:`default_runner` for ``target``;
    * runner given, target=None → the runner's own target;
    * both given             → they must agree; a mismatch raises rather than
      silently measuring one chip while labelling records with another.
    """
    if runner is None:
        runner = default_runner(target)
        return runner, runner.target
    if target is not None:
        name = resolve_target(target).name
        if name != runner.target:
            raise ValueError(
                f"runner measures target {runner.target!r} but target={name!r} "
                "was requested — build the runner with default_runner(target)")
        return runner, name
    return runner, runner.target
