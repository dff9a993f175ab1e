"""Auto-scheduler: the Ansor analogue this framework tunes kernels with.

A copy of ``repro.core.autoscheduler`` (the port imports nothing of ``repro``).

Structure mirrors Ansor (Zheng et al., OSDI'20) at the granularity the paper
relies on:

* per-kernel *tasks*, each searching the schedule space of one workload;
* evolutionary search: a population of schedules, mutation + crossover,
  ranked by a learned surrogate (ridge regression on schedule features),
  with only the top candidates sent to "hardware" measurement through a
  pluggable :class:`repro_torch.core.runner.MeasureRunner` (default: memoized
  analytical model with seeded noise);
* a task scheduler that allocates measurement trials across kernels
  proportionally to their share of remaining model time (Ansor §5);
* a search trace — (cumulative virtual search seconds, best model seconds) —
  which the benchmarks use for the paper's "same search time" and
  "time to match" comparisons (Figs. 1/5, Table 4).
"""
from __future__ import annotations

import dataclasses
import math
import random
import time
from typing import Callable, Sequence

import numpy as np

from repro_torch.core.cost_model import Measurement
from repro_torch.core.database import Record, ScheduleDB
from repro_torch.core.runner import MeasureRunner, resolve_runner, telemetry_delta
from repro_torch.targets import DEFAULT_TARGET
from repro_torch.core.schedule import (
    UNROLL_CHOICES,
    VEC_CHOICES,
    Schedule,
    default_schedule,
)
from repro_torch.core.workload import KernelInstance, KernelUse, class_axes

#: Candidate tile sizes: powers of two plus the 3× and 5× series (384 = 3·128
#: etc.) — TPU-friendly multiples of the (8, 128) VREG tile that divide the
#: d_model/d_ff families of real architectures (2304 = 9·256, 5120 = 5·1024).
TILE_POOL = tuple(sorted(
    {1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048}
    | {3, 6, 12, 24, 48, 96, 192, 384, 768, 1536}
    | {5, 10, 20, 40, 80, 160, 320, 640, 1280, 2560}
))


def _divisor_tiles(extent: int) -> list[int]:
    """Candidate tile sizes for an extent: divisors near hardware-friendly sizes."""
    out = sorted({d for d in TILE_POOL if d <= extent and extent % d == 0})
    if not out:
        out = [1]
    if extent <= 2048 and extent not in out:
        out.append(extent)
    return out


def random_schedule(instance: KernelInstance, rng: random.Random) -> Schedule:
    axes = class_axes(instance.class_id)
    tiles = {a: rng.choice(_divisor_tiles(instance.extent(a))) for a in axes}
    reduction = {"matmul": "K", "attention": "KV", "scan": "T"}[instance.family]
    non_reduction = [a for a in axes if a != reduction]
    rng.shuffle(non_reduction)
    # Reduction axis position: anywhere but first (keeps ≥1 parallelizable axis).
    pos = rng.randrange(1, len(axes))
    order = non_reduction[:]
    order.insert(pos, reduction)
    parallel = rng.randint(1, max(1, order.index(reduction)))
    return Schedule.make(
        instance.class_id,
        tiles=tiles,
        order=order,
        parallel=parallel,
        unroll=rng.choice(UNROLL_CHOICES),
        vec=rng.choice(VEC_CHOICES),
        cache_write=rng.random() < 0.7,
        source=instance.workload_key(),
    )


def mutate(schedule: Schedule, instance: KernelInstance, rng: random.Random) -> Schedule:
    axes = class_axes(instance.class_id)
    kind = rng.choice(("tile", "tile", "tile", "order", "unroll", "vec", "cache"))
    tiles = schedule.t
    order = list(schedule.order)
    parallel, unroll, vec, cache = schedule.parallel, schedule.unroll, schedule.vec, schedule.cache_write
    if kind == "tile":
        a = rng.choice(axes)
        choices = _divisor_tiles(instance.extent(a))
        tiles[a] = rng.choice(choices)
    elif kind == "order":
        reduction = {"matmul": "K", "attention": "KV", "scan": "T"}[instance.family]
        i, j = rng.sample(range(len(order)), 2) if len(order) >= 2 else (0, 0)
        order[i], order[j] = order[j], order[i]
        if order[0] == reduction:  # keep one leading parallelizable axis
            order[0], order[1] = order[1], order[0]
        parallel = min(parallel, max(1, order.index(reduction)))
    elif kind == "unroll":
        unroll = rng.choice(UNROLL_CHOICES)
    elif kind == "vec":
        vec = rng.choice(VEC_CHOICES)
    else:
        cache = not cache
    return Schedule.make(
        schedule.class_id, tiles=tiles, order=order, parallel=parallel,
        unroll=unroll, vec=vec, cache_write=cache, source=instance.workload_key(),
    )


def crossover(a: Schedule, b: Schedule, rng: random.Random) -> Schedule:
    tiles = {ax: (a.t[ax] if rng.random() < 0.5 else b.t[ax]) for ax in a.t}
    donor = a if rng.random() < 0.5 else b
    return Schedule.make(
        a.class_id, tiles=tiles, order=donor.order, parallel=donor.parallel,
        unroll=(a if rng.random() < 0.5 else b).unroll,
        vec=(a if rng.random() < 0.5 else b).vec,
        cache_write=(a if rng.random() < 0.5 else b).cache_write,
        source=a.source,
    )


# ---------------------------------------------------------------------------
# Surrogate cost model (Ansor's learned model, here: ridge on features)
# ---------------------------------------------------------------------------


def featurize(schedule: Schedule, instance: KernelInstance) -> np.ndarray:
    axes = class_axes(instance.class_id)
    f: list[float] = []
    for a in axes:
        t, e = schedule.t[a], instance.extent(a)
        f += [math.log2(t), math.log2(max(e // t, 1)), float(t % 128 == 0), float(t % 8 == 0)]
    for a in axes:
        f.append(float(schedule.order.index(a)) / len(axes))
    f += [
        float(schedule.parallel),
        math.log2(schedule.unroll + 1),
        math.log2(schedule.vec),
        float(schedule.cache_write),
    ]
    return np.asarray(f, dtype=np.float64)


class Surrogate:
    def __init__(self, lam: float = 1e-2):
        self.lam = lam
        self._x: list[np.ndarray] = []
        self._y: list[float] = []
        self._w: np.ndarray | None = None

    def add(self, feat: np.ndarray, seconds: float) -> None:
        self._x.append(feat)
        self._y.append(math.log(max(seconds, 1e-12)))
        self._w = None

    def _fit(self) -> None:
        x = np.stack(self._x)
        x = np.concatenate([x, np.ones((len(x), 1))], axis=1)
        y = np.asarray(self._y)
        a = x.T @ x + self.lam * np.eye(x.shape[1])
        self._w = np.linalg.solve(a, x.T @ y)

    def predict(self, feats: Sequence[np.ndarray]) -> np.ndarray:
        if len(self._x) < 8:
            return np.zeros(len(feats))  # no signal yet: random ranking
        if self._w is None:
            self._fit()
        x = np.stack(list(feats))
        x = np.concatenate([x, np.ones((len(x), 1))], axis=1)
        return x @ self._w


# ---------------------------------------------------------------------------
# Per-kernel evolutionary search task
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TracePoint:
    search_time_s: float   # cumulative virtual search seconds
    best_seconds: float    # best (noise-free ranked by noisy measurement) kernel/model seconds
    trials: int


@dataclasses.dataclass
class TuneResult:
    best: Schedule
    best_seconds: float
    trials: int
    search_time_s: float
    trace: list[TracePoint]
    wall_time_s: float
    runner_telemetry: dict = dataclasses.field(default_factory=dict)
    target: str = DEFAULT_TARGET   # chip the search measured on


class KernelTask:
    """Evolutionary search state for one kernel workload.

    Measurement goes through the injected ``runner`` (one may be shared
    across tasks to pool caching); the default is a fresh memoizing
    analytical runner for ``target`` (the two must agree when both given —
    the task's records belong in that target's namespace).
    """

    def __init__(self, instance: KernelInstance, seed: int, noise_sigma: float = 0.05,
                 population: int = 32, measure_per_round: int = 8,
                 runner: MeasureRunner | None = None, target=None):
        self.instance = instance
        # int(hex_key) not hash(): str hash is salted per process and would
        # make tuning results non-reproducible across runs.
        self.rng = random.Random(seed ^ (int(instance.workload_key(), 16) & 0xFFFFFFFF))
        self.noise_sigma = noise_sigma
        self.population = population
        self.measure_per_round = measure_per_round
        self.runner, self.target = resolve_runner(runner, target)
        self.surrogate = Surrogate()
        self.seed = seed
        self.pool: list[tuple[Schedule, float]] = []  # measured (schedule, noisy seconds)
        self.trials = 0
        self.search_time_s = 0.0
        base = default_schedule(instance)
        m = self.runner.measure(instance, base, seed=seed, noise_sigma=0.0)
        assert m.valid, "default schedule must be valid"
        self.best_schedule: Schedule = base
        self.best_seconds: float = m.seconds
        self.untuned_seconds: float = m.seconds

    def _record(self, schedule: Schedule, m: Measurement) -> None:
        self.trials += 1
        self.search_time_s += m.measure_cost_s
        if m.pruned:
            return
        if m.valid:
            self.pool.append((schedule, m.seconds))
            self.surrogate.add(featurize(schedule, self.instance), m.seconds)
            if m.seconds < self.best_seconds:
                self.best_seconds = m.seconds
                self.best_schedule = schedule

    def _measure_batch(self, schedules: Sequence[Schedule]) -> None:
        ms = self.runner.measure_many(self.instance, schedules, seed=self.seed,
                                      noise_sigma=self.noise_sigma)
        for s, m in zip(schedules, ms):
            self._record(s, m)

    def step(self, budget_trials: int) -> None:
        """Run measurement rounds until `budget_trials` more trials are spent."""
        spent = 0
        while spent < budget_trials:
            candidates: list[Schedule] = []
            if len(self.pool) < 4:
                candidates = [random_schedule(self.instance, self.rng)
                              for _ in range(self.measure_per_round * 4)]
            else:
                elite = sorted(self.pool, key=lambda p: p[1])[: self.population // 2]
                for _ in range(self.measure_per_round * 6):
                    r = self.rng.random()
                    if r < 0.5:
                        parent = self.rng.choice(elite)[0]
                        candidates.append(mutate(parent, self.instance, self.rng))
                    elif r < 0.75 and len(elite) >= 2:
                        a, b = self.rng.sample(elite, 2)
                        candidates.append(crossover(a[0], b[0], self.rng))
                    else:
                        candidates.append(random_schedule(self.instance, self.rng))
            feats = [featurize(c, self.instance) for c in candidates]
            pred = self.surrogate.predict(feats)
            ranked = [c for _, c in sorted(zip(pred, candidates), key=lambda t: t[0])]
            n = min(self.measure_per_round, budget_trials - spent)
            self._measure_batch(ranked[:n])
            spent += n


def tune_kernel(instance: KernelInstance, trials: int = 128, seed: int = 0,
                noise_sigma: float = 0.05,
                runner: MeasureRunner | None = None, target=None) -> TuneResult:
    t0 = time.monotonic()
    runner, tname = resolve_runner(runner, target)
    before = runner.telemetry()
    task = KernelTask(instance, seed=seed, noise_sigma=noise_sigma, runner=runner)
    trace: list[TracePoint] = []
    batch = max(8, trials // 16)
    while task.trials < trials:
        task.step(min(batch, trials - task.trials))
        trace.append(TracePoint(task.search_time_s, task.best_seconds, task.trials))
    return TuneResult(
        best=task.best_schedule, best_seconds=task.best_seconds, trials=task.trials,
        search_time_s=task.search_time_s, trace=trace, wall_time_s=time.monotonic() - t0,
        runner_telemetry=telemetry_delta(runner.telemetry(), before),
        target=tname,
    )


# ---------------------------------------------------------------------------
# Whole-model tuning with an Ansor-style task scheduler
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ModelTuneResult:
    model_id: str
    records: list[Record]
    total_trials: int
    search_time_s: float
    wall_time_s: float
    untuned_seconds: float
    tuned_seconds: float
    trace: list[TracePoint]   # (search time, best *model* seconds)
    runner_telemetry: dict = dataclasses.field(default_factory=dict)
    target: str = DEFAULT_TARGET   # chip the search measured on

    @property
    def speedup(self) -> float:
        return self.untuned_seconds / self.tuned_seconds


def tune_model(
    uses: Sequence[KernelUse],
    model_id: str,
    total_trials: int = 1024,
    seed: int = 0,
    noise_sigma: float = 0.05,
    round_trials: int = 16,
    stop_when: Callable[[float, float], bool] | None = None,
    runner: MeasureRunner | None = None,
    target=None,
) -> ModelTuneResult:
    """Tune every kernel of a model under a shared trial budget.

    Trials are allocated Ansor-style: each round goes to the task with the
    largest expected gain, estimated as (current share of model time) ×
    (recent relative improvement + exploration bonus).

    ``stop_when(search_time_s, model_seconds)`` allows the benchmarks to cut
    the search at a given virtual time or speedup (paper's same-time /
    time-to-match comparisons).  One ``runner`` is shared across all kernel
    tasks, so a memoizing runner dedups measurements model-wide.  ``target``
    selects the chip to tune for; the emitted records land in its namespace.
    """
    t0 = time.monotonic()
    runner, tname = resolve_runner(runner, target)
    tele_before = runner.telemetry()
    tasks = [KernelTask(u.instance, seed=seed, noise_sigma=noise_sigma, runner=runner)
             for u in uses]
    weights = [u.use_count for u in uses]
    improv = [1.0] * len(tasks)  # optimistic init → round-robin warmup

    def model_now() -> float:
        return sum(w * t.best_seconds for w, t in zip(weights, tasks))

    untuned = model_now()
    trace: list[TracePoint] = []
    spent = 0
    while spent < total_trials:
        shares = [w * t.best_seconds for w, t in zip(weights, tasks)]
        total_share = sum(shares) or 1.0
        scores = [
            (shares[i] / total_share) * (improv[i] + 0.05 / (1 + tasks[i].trials / 64))
            for i in range(len(tasks))
        ]
        i = max(range(len(tasks)), key=lambda j: scores[j])
        before = tasks[i].best_seconds
        n = min(round_trials, total_trials - spent)
        tasks[i].step(n)
        spent += n
        after = tasks[i].best_seconds
        improv[i] = 0.7 * improv[i] + 0.3 * ((before - after) / before if before > 0 else 0.0)
        st = sum(t.search_time_s for t in tasks)
        now = model_now()
        trace.append(TracePoint(st, now, spent))
        if stop_when is not None and stop_when(st, now):
            break

    # Emit the top-k distinct schedules per kernel (Ansor's log retains every
    # measurement; transfer-tuning's candidate pool draws from them).
    records = []
    for t in tasks:
        seen: set = set()
        for sched, secs in sorted(t.pool, key=lambda p: p[1]):
            key = sched.to_json().__repr__()
            if key in seen:
                continue
            seen.add(key)
            records.append(Record(instance=t.instance, schedule=sched, seconds=secs,
                                  model_id=model_id, trials=t.trials, target=tname))
            if len(seen) >= 5:
                break
        if not seen:  # no valid measured schedule: record the default-based best
            records.append(Record(instance=t.instance, schedule=t.best_schedule,
                                  seconds=t.best_seconds, model_id=model_id,
                                  trials=t.trials, target=tname))
    return ModelTuneResult(
        model_id=model_id,
        records=records,
        total_trials=spent,
        search_time_s=sum(t.search_time_s for t in tasks),
        wall_time_s=time.monotonic() - t0,
        untuned_seconds=untuned,
        tuned_seconds=model_now(),
        trace=trace,
        runner_telemetry=telemetry_delta(runner.telemetry(), tele_before),
        target=tname,
    )


def tune_model_into_db(db: ScheduleDB, uses: Sequence[KernelUse], model_id: str,
                       **kw) -> ModelTuneResult:
    res = tune_model(uses, model_id, **kw)
    for r in res.records:
        db.add(r)
    return res
