"""Donor-model selection heuristic (paper §4.4, Eq. 1).

A copy of ``repro.core.heuristic`` (the port imports nothing of ``repro``).

For a target model M with kernel classes C, choose the donor T maximizing

    score(T) = Σ_{c ∈ C}  P_c² · sqrt(|W_Tc|)

where P_c is class c's share of M's *untuned* inference time and W_Tc the set
of tuned schedules of class c available from T.  Squaring P_c boosts the
influence of expensive classes; the square root damps donors with very many
schedules (paper's stated rationale).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Sequence

from repro_torch.core.cost_model import class_proportions
from repro_torch.core.database import ScheduleDB
from repro_torch.core.runner import MeasureRunner
from repro_torch.core.workload import KernelUse
from repro_torch.targets import target_name


@dataclasses.dataclass(frozen=True)
class DonorScore:
    model_id: str
    score: float
    per_class: tuple[tuple[str, float], ...]  # class -> contribution


def _proportions(uses: Sequence[KernelUse], runner: MeasureRunner | None) -> dict[str, float]:
    """P_c via the injected runner (sharing its noise-free seconds cache),
    falling back to the bare cost model when no runner is given."""
    if runner is None:
        return class_proportions(uses)
    return class_proportions(uses, seconds_fn=lambda inst: runner.seconds(inst, None))


def donor_scores(
    uses: Sequence[KernelUse],
    db: ScheduleDB,
    exclude: Sequence[str] = (),
    proportions: Mapping[str, float] | None = None,
    runner: MeasureRunner | None = None,
    donor_target=None,
) -> list[DonorScore]:
    """Rank all donor models in the DB for this target model (descending).

    ``donor_target`` names the hardware namespace the candidate pool is
    drawn from (default: the runner's target, i.e. same-target transfer);
    |W_Tc| only counts schedules tuned on that chip.  P_c shares come from
    the runner's own target — the model will *run* there.
    """
    p = dict(proportions) if proportions is not None else _proportions(uses, runner)
    dt = target_name(donor_target if donor_target is not None
                     else (runner.target if runner is not None else None))
    scores: list[DonorScore] = []
    for model_id in db.models(target=dt):
        if model_id in exclude:
            continue
        counts = db.class_counts(model_id, target=dt)
        contrib = []
        total = 0.0
        for c, pc in p.items():
            n = counts.get(c, 0)
            s = (pc ** 2) * math.sqrt(n)
            if s > 0:
                contrib.append((c, s))
            total += s
        scores.append(DonorScore(model_id=model_id, score=total, per_class=tuple(contrib)))
    scores.sort(key=lambda s: (-s.score, s.model_id))
    return scores


def select_donor(uses: Sequence[KernelUse], db: ScheduleDB,
                 exclude: Sequence[str] = (),
                 runner: MeasureRunner | None = None,
                 donor_target=None) -> str | None:
    ranked = donor_scores(uses, db, exclude=exclude, runner=runner,
                          donor_target=donor_target)
    if not ranked or ranked[0].score <= 0.0:
        return None
    return ranked[0].model_id


def top_donors(uses: Sequence[KernelUse], db: ScheduleDB, k: int = 3,
               exclude: Sequence[str] = (),
               runner: MeasureRunner | None = None,
               donor_target=None) -> list[DonorScore]:
    """Top-k choices (paper Table 3)."""
    return donor_scores(uses, db, exclude=exclude, runner=runner,
                        donor_target=donor_target)[:k]


# ---------------------------------------------------------------------------
# Beyond-paper: compatibility-aware donor selection (the paper's §4.4.2
# future-work direction — "a better predictive model of which schedules may
# perform well").  Eq. 1 counts schedules but ignores whether their tiles
# can legally bind to the target's extents; divisibility is *static*
# (zero measurement cost), so we weight each class contribution by the
# fraction of the donor's schedules that strictly concretize on the
# target's kernels of that class.
# ---------------------------------------------------------------------------


def donor_scores_v2(
    uses: Sequence[KernelUse],
    db: ScheduleDB,
    exclude: Sequence[str] = (),
    proportions: Mapping[str, float] | None = None,
    runner: MeasureRunner | None = None,
    donor_target=None,
) -> list[DonorScore]:
    from repro_torch.core.schedule import is_valid

    p = dict(proportions) if proportions is not None else _proportions(uses, runner)
    dt = target_name(donor_target if donor_target is not None
                     else (runner.target if runner is not None else None))
    targets_by_class: dict[str, list] = {}
    for u in uses:
        targets_by_class.setdefault(u.instance.class_id, []).append(u.instance)

    scores: list[DonorScore] = []
    for model_id in db.models(target=dt):
        if model_id in exclude:
            continue
        counts = db.class_counts(model_id, target=dt)
        contrib = []
        total = 0.0
        for c, pc in p.items():
            n = counts.get(c, 0)
            if n == 0:
                continue
            recs = db.by_class(c, [model_id], target=dt)
            pairs = [(r, t) for r in recs for t in targets_by_class.get(c, [])]
            compat = (sum(is_valid(r.schedule, t) for r, t in pairs) / len(pairs)
                      if pairs else 0.0)
            s = (pc ** 2) * math.sqrt(n) * compat
            if s > 0:
                contrib.append((c, s))
            total += s
        scores.append(DonorScore(model_id=model_id, score=total, per_class=tuple(contrib)))
    scores.sort(key=lambda s: (-s.score, s.model_id))
    return scores


def select_donor_v2(uses: Sequence[KernelUse], db: ScheduleDB,
                    exclude: Sequence[str] = (),
                    runner: MeasureRunner | None = None,
                    donor_target=None) -> str | None:
    ranked = donor_scores_v2(uses, db, exclude=exclude, runner=runner,
                             donor_target=donor_target)
    if not ranked or ranked[0].score <= 0.0:
        return None
    return ranked[0].model_id
