"""Transfer-tuning core: the paper's contribution as a composable library.

A copy of ``repro.core`` (the port imports nothing of ``repro``), plus
:class:`~repro_torch.core.measured_runner.MeasuredRunner`, the runner that
times schedules with the port's CUDA kernels on the card.

Public API:
    KernelInstance / KernelUse / kernel classes ............ workload.py
    Schedule / concretize / default_schedule ............... schedule.py
    measure / evaluate / model_seconds (v5e cost model) .... cost_model.py
    MeasureRunner / Analytical|Cached|PruningRunner ........ runner.py
    MeasuredRunner (timed on the card) ..................... measured_runner.py
    tune_kernel / tune_model (Ansor analogue) .............. autoscheduler.py
    ScheduleDB / Record (target-namespaced) ................ database.py
    transfer_tune / transfer_matrix / cross_target_transfer  transfer.py
    select_donor / top_donors (Eq. 1) ...................... heuristic.py
    extract_kernels (model config -> kernel workloads) ..... extract.py
    ResolutionPipeline / ExecutionPlan / plan_model ........ resolution.py
    Target / get_target / resolve_target ................... repro_torch.targets
"""
from repro_torch.core.autoscheduler import ModelTuneResult, TuneResult, tune_kernel, tune_model, tune_model_into_db
from repro_torch.core.cost_model import (
    CostBreakdown,
    Measurement,
    class_proportions,
    evaluate,
    kernel_seconds,
    measure,
    model_seconds,
)
from repro_torch.core.database import Record, ScheduleDB
from repro_torch.core.heuristic import DonorScore, donor_scores, select_donor, top_donors
from repro_torch.core.resolution import (
    DefaultStage,
    ExecutionPlan,
    Resolution,
    ResolutionPipeline,
    ResolutionStage,
    ServiceStage,
    StaticMapStage,
    plan_model,
    plan_serving,
    plan_uses,
)
from repro_torch.core.runner import (
    AnalyticalRunner,
    CachedRunner,
    MeasureRunner,
    PruningRunner,
    RunnerStats,
    default_runner,
)
from repro_torch.core.schedule import ConcreteSchedule, Schedule, ScheduleInvalid, concretize, default_schedule
from repro_torch.core.transfer import (
    KernelTransfer,
    TransferResult,
    cross_target_transfer,
    transfer_matrix,
    transfer_tune,
)
from repro_torch.core.workload import KERNEL_CLASSES, KernelInstance, KernelUse, classes_in, dedup_uses
from repro_torch.targets import DEFAULT_TARGET, Target, get_target, list_targets, resolve_target

__all__ = [
    "DEFAULT_TARGET",
    "KERNEL_CLASSES",
    "AnalyticalRunner",
    "CachedRunner",
    "ConcreteSchedule",
    "CostBreakdown",
    "DefaultStage",
    "DonorScore",
    "ExecutionPlan",
    "Target",
    "MeasureRunner",
    "MeasuredRunner",
    "PruningRunner",
    "RunnerStats",
    "KernelInstance",
    "KernelTransfer",
    "KernelUse",
    "Measurement",
    "ModelTuneResult",
    "Record",
    "Resolution",
    "ResolutionPipeline",
    "ResolutionStage",
    "Schedule",
    "ScheduleDB",
    "ScheduleInvalid",
    "ServiceStage",
    "StaticMapStage",
    "TransferResult",
    "TuneResult",
    "class_proportions",
    "classes_in",
    "concretize",
    "cross_target_transfer",
    "dedup_uses",
    "default_runner",
    "default_schedule",
    "donor_scores",
    "evaluate",
    "extract_kernels",
    "get_target",
    "kernel_seconds",
    "list_targets",
    "measure",
    "model_seconds",
    "plan_model",
    "plan_serving",
    "plan_uses",
    "resolve_target",
    "select_donor",
    "top_donors",
    "transfer_matrix",
    "transfer_tune",
    "tune_kernel",
    "tune_model",
    "tune_model_into_db",
]


def extract_kernels(*args, **kwargs):  # lazy import: configs depend on models
    from repro_torch.core.extract import extract_kernels as _ek

    return _ek(*args, **kwargs)


def __getattr__(name: str):
    # lazy: MeasuredRunner imports torch and the kernel wrappers, which
    # import this package
    if name == "MeasuredRunner":
        from repro_torch.core.measured_runner import MeasuredRunner

        return MeasuredRunner
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
