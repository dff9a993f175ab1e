"""Top-level tuning API gluing the core together (the paper's workflow).

A copy of ``repro.core.tuner`` (the port imports nothing of ``repro``).

    uses  = arch_uses("gemma2-2b", "train_4k", dp=16, tp=16)
    native = tune_arch(db, "gemma2-2b", ...)          # Ansor analogue
    donor  = select_donor(uses, db)                   # Eq. 1
    tt     = transfer_arch(db, "gemma2-2b", donors=[donor])   # transfer-tuning

All results carry virtual search seconds (measurement-harness time, the
paper's cost axis) and cost-model kernel seconds; under a
:class:`~repro_torch.core.measured_runner.MeasuredRunner`, host seconds of
the search and kernel seconds timed on the card.
"""
from __future__ import annotations

from typing import Sequence

from repro_torch.configs.base import get_arch, get_shape
from repro_torch.core.autoscheduler import ModelTuneResult, tune_model
from repro_torch.core.database import Record, ScheduleDB
from repro_torch.core.extract import extract_kernels
from repro_torch.core.heuristic import select_donor, select_donor_v2, top_donors
from repro_torch.core.runner import MeasureRunner, resolve_runner
from repro_torch.core.transfer import TransferResult, transfer_tune
from repro_torch.core.workload import KernelUse
from repro_torch.targets import target_name


def arch_uses(arch: str, shape: str = "train_4k", *, dp: int = 1, tp: int = 1
              ) -> list[KernelUse]:
    return extract_kernels(get_arch(arch), get_shape(shape), dp=dp, tp=tp)


def tune_arch(db: ScheduleDB, arch: str, shape: str = "train_4k", *,
              dp: int = 1, tp: int = 1, total_trials: int = 1024, seed: int = 0,
              runner: MeasureRunner | None = None, target=None,
              **kw) -> ModelTuneResult:
    """Full auto-scheduling of one arch for one hardware target; records land
    in `db` under the arch id, namespaced by the target."""
    uses = arch_uses(arch, shape, dp=dp, tp=tp)
    res = tune_model(uses, model_id=arch, total_trials=total_trials, seed=seed,
                     runner=runner, target=target, **kw)
    for r in res.records:
        db.add(r)
    return res


def transfer_arch(db: ScheduleDB, arch: str, shape: str = "train_4k", *,
                  dp: int = 1, tp: int = 1, donors: Sequence[str] | None | str = "auto",
                  mode: str = "strict", seed: int = 0,
                  runner: MeasureRunner | None = None, target=None,
                  source_target=None, **kw) -> TransferResult:
    """Transfer-tune one arch from donor schedules.

    donors="auto" applies the Eq. 1 heuristic (excluding the arch itself);
    donors="auto2" the beyond-paper compatibility-aware variant;
    donors=None uses the full mixed pool (paper §5.5); otherwise a list.

    ``target`` is the chip the arch will run on; ``source_target`` (optional)
    draws the donor pool from another chip's namespace — cross-target
    transfer, with every donor re-validated under ``target``'s spec.  The
    Eq. 1 heuristic counts donors in the source namespace in that case.

    One ``runner`` (default: memoizing analytical) serves both donor
    selection and the transfer pass, so the untuned-seconds queries Eq. 1
    makes are never recomputed by the transfer loop.
    """
    uses = arch_uses(arch, shape, dp=dp, tp=tp)
    runner, tname = resolve_runner(runner, target)
    donor_tname = target_name(source_target) if source_target is not None else tname
    if donors in ("auto", "auto2"):
        pick = select_donor_v2 if donors == "auto2" else select_donor
        best = pick(uses, db, exclude=(arch,), runner=runner,
                    donor_target=donor_tname)
        donors = [best] if best is not None else []
    return transfer_tune(uses, db, model_id=arch, donors=donors, mode=mode,
                         seed=seed, runner=runner, target=tname,
                         donor_target=donor_tname, **kw)


def tune_arch_registry(registry, arch: str, shape: str = "train_4k", *,
                       mode: str = "strict", **kw) -> ModelTuneResult:
    """:func:`tune_arch` writing through a schedule registry.

    The arch's records land as one atomically published segment — the
    online-store analogue of merging a freshly tuned ScheduleDB.  ``registry``
    is a :class:`repro_torch.service.ScheduleRegistry` (duck-typed to avoid a
    core → service import cycle).
    """
    db = ScheduleDB()
    res = tune_arch(db, arch, shape, **kw)
    registry.merge_db(db, mode=mode)
    return res


def transfer_arch_registry(registry, arch: str, shape: str = "train_4k", *,
                           mode: str = "strict", publish: bool = True,
                           **kw) -> TransferResult:
    """:func:`transfer_arch` reading donors from — and publishing chosen
    schedules back to — a schedule registry.

    The donor pool is the registry's current snapshot (all modes; candidates
    are re-validated under ``mode`` by measurement).  With ``publish=True``
    every kernel's chosen schedule is published under the arch id in one
    atomic segment, so a subsequent :class:`~repro_torch.service.TuningService`
    serves them as exact hits.
    """
    db = registry.snapshot().db(None)
    res = transfer_arch(db, arch, shape, mode=mode, **kw)
    if publish:
        registry.publish(
            [Record(instance=k.instance, schedule=k.chosen, seconds=k.seconds,
                    model_id=arch, target=res.target)
             for k in res.kernels if k.chosen is not None],
            mode=mode)
    return res


def donor_ranking(db: ScheduleDB, arch: str, shape: str = "train_4k", *,
                  dp: int = 1, tp: int = 1, k: int = 3,
                  runner: MeasureRunner | None = None, donor_target=None):
    uses = arch_uses(arch, shape, dp=dp, tp=tp)
    return top_donors(uses, db, k=k, exclude=(arch,), runner=runner,
                      donor_target=donor_target)
