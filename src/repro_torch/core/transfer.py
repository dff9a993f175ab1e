"""Transfer-tuning engine (paper §4): reuse auto-schedules across kernels.

A copy of ``repro.core.transfer`` (the port imports nothing of ``repro``).

For each kernel of the target model, every compatible schedule (same kernel
class) from the donor pool is *applied and measured standalone*; the best
valid one wins.  The accumulated measurement cost is transfer-tuning's search
time — the quantity the paper compares against Ansor's (§4.3: "the time for
testing each kernel of the target model with each valid schedule").

Modes:
* ``strict``   — paper-faithful: non-dividing/oversized tiles are invalid
  (Fig. 4's -1 bars) and simply skipped.
* ``adaptive`` — beyond-paper: shape-agnostic tile reformulation
  (schedule.py) rescues otherwise-invalid transfers.  Reported separately.

Exact workload hits (same class *and* shapes) reuse the donor schedule with
zero extra measurements, matching Ansor's workload-ID reuse.

Measurement goes through an injected :class:`repro_torch.core.runner.MeasureRunner`
(default ``CachedRunner(AnalyticalRunner())``), so repeated donor schedules
across kernels, matrix cells, and passes are measured once; pass a shared
runner across calls to pool the cache.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Sequence

from repro_torch.core.database import Record, ScheduleDB
from repro_torch.core.runner import MeasureRunner, resolve_runner, telemetry_delta
from repro_torch.core.schedule import Schedule
from repro_torch.core.workload import KernelInstance, KernelUse
from repro_torch.targets import DEFAULT_TARGET, target_name


@dataclasses.dataclass(frozen=True)
class KernelTransfer:
    """Outcome of transfer-tuning one target kernel."""

    instance: KernelInstance
    chosen: Schedule | None          # None -> fall back to untuned default
    chosen_from: str                 # donor model id ("" if default)
    seconds: float                   # standalone (cost-model) seconds after choice
    untuned_seconds: float
    candidates: int                  # schedules evaluated
    invalid: int                     # candidates rejected as invalid
    exact_hit: bool                  # Ansor-style exact workload reuse
    pruned: int = 0                  # candidates dropped by a PruningRunner draft

    @property
    def speedup(self) -> float:
        return self.untuned_seconds / self.seconds


@dataclasses.dataclass
class TransferResult:
    model_id: str
    kernels: list[KernelTransfer]
    uses: list[KernelUse]
    search_time_s: float             # virtual seconds (measurement harness)
    wall_time_s: float
    untuned_seconds: float
    tuned_seconds: float
    # Measurement telemetry (delta over the injected runner for this call):
    measurements: int = 0            # full cost-model evaluations performed
    cache_hits: int = 0
    cache_misses: int = 0
    pruned_candidates: int = 0
    runner_telemetry: dict = dataclasses.field(default_factory=dict)
    target: str = DEFAULT_TARGET     # chip the transfers were measured on
    donor_target: str = DEFAULT_TARGET  # chip the donor pool was tuned on

    @property
    def speedup(self) -> float:
        return self.untuned_seconds / self.tuned_seconds

    @property
    def invalid_transfers(self) -> int:
        """Candidates rejected as invalid across all kernels (Fig. 4 −1 bars;
        for cross-target runs these include donors infeasible on ``target``,
        e.g. server tiles overflowing the edge chip's VMEM)."""
        return sum(k.invalid for k in self.kernels)

    def schedule_map(self) -> dict[str, Schedule]:
        """workload_key -> chosen schedule (for model execution / launch)."""
        out = {}
        for k in self.kernels:
            if k.chosen is not None:
                out[k.instance.workload_key()] = k.chosen
        return out

    def coverage(self) -> float:
        """Fraction of untuned model time whose kernels got a transferred
        schedule (paper §5.2 discusses uncovered classes, e.g. MobileNetV2)."""
        covered = sum(
            u.use_count * k.untuned_seconds
            for u, k in zip(self.uses, self.kernels)
            if k.chosen is not None
        )
        return covered / self.untuned_seconds if self.untuned_seconds else 0.0


def _strongest_first(candidates: list[Record], limit: int,
                     runner: MeasureRunner) -> list[Record]:
    """Truncate the donor pool keeping the strongest donors — ``db.by_class``
    order is (model_id, seconds), so a naive ``[:limit]`` would keep
    whichever models sort first alphabetically.  Strength is the recorded
    seconds *relative to the donor workload's own untuned seconds* (its
    speedup at home): raw seconds are only comparable within one workload
    shape, and would bias a mixed pool toward small donors."""
    def strength(r: Record) -> float:
        return r.seconds / runner.seconds(r.instance, None)
    return sorted(candidates, key=strength)[:limit]


def transfer_tune(
    uses: Sequence[KernelUse],
    db: ScheduleDB,
    *,
    model_id: str = "target",
    donors: Sequence[str] | None = None,
    mode: str = "strict",
    seed: int = 0,
    noise_sigma: float = 0.05,
    max_candidates_per_kernel: int | None = None,
    runner: MeasureRunner | None = None,
    target=None,
    donor_target=None,
) -> TransferResult:
    """Transfer-tune a target model from donor schedules in ``db``.

    ``donors=None`` uses the full pool (paper §5.5 "mixed"); a single-element
    list is the paper's default one-to-one setting.  ``runner`` injects the
    measurement backend; the default is a fresh memoizing analytical runner.

    ``target`` names the chip transfers are measured and served on (it must
    match ``runner``'s target when both are given).  ``donor_target`` names
    the chip the donor pool was tuned on — it defaults to ``target``, and
    setting it to a different chip is cross-target transfer
    (:func:`cross_target_transfer`): donors are re-validated under
    ``target``'s spec, and infeasible ones count as invalid transfers.  Exact
    workload reuse only ever draws from ``target``'s own namespace — a
    same-shape record from another chip is a candidate to re-measure, not a
    zero-cost hit.
    """
    t0 = time.monotonic()
    runner, tname = resolve_runner(runner, target)
    donor_tname = target_name(donor_target) if donor_target is not None else tname
    before = runner.telemetry()
    kernels: list[KernelTransfer] = []
    search_time = 0.0
    for u in uses:
        inst = u.instance
        untuned = runner.seconds(inst, None)
        exact = db.exact(inst, target=tname) if donor_tname == tname else None
        if exact is not None and (donors is None or exact.model_id in donors):
            # Ansor workload-ID reuse: no measurement needed — the noise-free
            # seconds query charges nothing and counts as zero measurements.
            kernels.append(KernelTransfer(
                instance=inst, chosen=exact.schedule, chosen_from=exact.model_id,
                seconds=runner.seconds(inst, exact.schedule, mode="strict"),
                untuned_seconds=untuned,
                candidates=0, invalid=0, exact_hit=True,
            ))
            continue
        candidates = db.by_class(inst.class_id, models=donors, target=donor_tname)
        if max_candidates_per_kernel is not None:
            candidates = _strongest_first(candidates, max_candidates_per_kernel, runner)
        measured = runner.measure_many(
            inst, [rec.schedule for rec in candidates],
            mode=mode, seed=seed, noise_sigma=noise_sigma)
        best_secs, best_sched, best_model = untuned, None, ""
        invalid = pruned = 0
        for rec, m in zip(candidates, measured):
            search_time += m.measure_cost_s
            if m.pruned:
                pruned += 1
                continue
            if not m.valid:
                invalid += 1
                continue
            if m.seconds < best_secs:
                best_secs, best_sched, best_model = m.seconds, rec.schedule, rec.model_id
        final_secs = (
            runner.seconds(inst, best_sched, mode=mode) if best_sched is not None else untuned
        )
        kernels.append(KernelTransfer(
            instance=inst, chosen=best_sched, chosen_from=best_model,
            seconds=final_secs, untuned_seconds=untuned,
            candidates=len(candidates), invalid=invalid, exact_hit=False,
            pruned=pruned,
        ))
    untuned_total = sum(u.use_count * k.untuned_seconds for u, k in zip(uses, kernels))
    tuned_total = sum(u.use_count * k.seconds for u, k in zip(uses, kernels))
    delta = telemetry_delta(runner.telemetry(), before)
    return TransferResult(
        model_id=model_id,
        kernels=kernels,
        uses=list(uses),
        search_time_s=search_time,
        wall_time_s=time.monotonic() - t0,
        untuned_seconds=untuned_total,
        tuned_seconds=tuned_total,
        measurements=int(delta.get("measurements", 0)),
        cache_hits=int(delta.get("cache_hits", 0)),
        cache_misses=int(delta.get("cache_misses", 0)),
        pruned_candidates=int(delta.get("pruned", 0)),
        runner_telemetry=delta,
        target=tname,
        donor_target=donor_tname,
    )


def cross_target_transfer(
    uses: Sequence[KernelUse],
    db: ScheduleDB,
    *,
    source_target,
    target,
    runner: MeasureRunner | None = None,
    **kw,
) -> TransferResult:
    """Explicit cross-target transfer: schedules auto-tuned on
    ``source_target`` become the donor pool for ``target``.

    This is the only sanctioned way a schedule crosses a target namespace
    (Chen et al. 2018 argue schedule knowledge transfers across devices; the
    namespaced stores make the trade-off measurable instead of accidental).
    Every donor is re-validated and re-measured under ``target``'s spec:
    tiles that overflow the destination chip's VMEM or break its geometry
    surface as invalid transfers (the paper's −1 bars) rather than crashing,
    and survivors are ranked by their measured seconds *on the destination
    chip*.  The result's records belong in ``target``'s namespace.

    Accepts every :func:`transfer_tune` keyword except ``donor_target``
    (which is ``source_target`` by definition).
    """
    if target_name(source_target) == target_name(target):
        raise ValueError(
            f"source and destination target are both {target_name(target)!r} — "
            "use transfer_tune for same-target reuse")
    return transfer_tune(uses, db, runner=runner, target=target,
                         donor_target=source_target, **kw)


def transfer_matrix(
    uses: Sequence[KernelUse],
    db: ScheduleDB,
    donors: Sequence[str] | None = None,
    mode: str = "strict",
    seed: int = 0,
    runner: MeasureRunner | None = None,
    target=None,
    donor_target=None,
) -> dict[str, dict[str, float | None]]:
    """Paper Fig. 4: per-(target kernel × donor schedule) standalone seconds.

    Returns {target workload_key: {donor record key: seconds | None(invalid)}}.
    Cells a :class:`PruningRunner` drafts away are omitted entirely — they
    were never evaluated, so recording them as ``None`` would conflate them
    with the paper's invalid (-1) transfers.  Sharing ``runner`` with a
    subsequent :func:`transfer_tune` call makes the tune pass free — every
    cell is already cached.
    """
    runner, tname = resolve_runner(runner, target)
    donor_tname = target_name(donor_target) if donor_target is not None else tname
    out: dict[str, dict[str, float | None]] = {}
    for u in uses:
        row: dict[str, float | None] = {}
        recs = db.by_class(u.instance.class_id, models=donors, target=donor_tname)
        measured = runner.measure_many(
            u.instance, [rec.schedule for rec in recs], mode=mode, seed=seed)
        for rec, m in zip(recs, measured):
            if m.pruned:
                continue
            key = f"{rec.model_id}/{rec.instance.workload_key()}"
            row[key] = m.seconds
        out[u.instance.workload_key()] = row
    return out
