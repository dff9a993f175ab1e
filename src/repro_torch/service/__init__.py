"""Online schedule-registry service.

A copy of ``repro.service`` (the port imports nothing of ``repro``).

Serves tuned schedules behind the serving path and upgrades them with
background transfer-tuning:

    ScheduleRegistry ... segmented persistent store (registry.py)
    TuningService ...... tiered lookup + background jobs (tuning_service.py)
"""
from repro_torch.service.registry import (
    RegistryError,
    RegistryRecord,
    RegistrySnapshot,
    ScheduleRegistry,
)
from repro_torch.service.tuning_service import LookupResult, TuningService

__all__ = [
    "LookupResult",
    "RegistryError",
    "RegistryRecord",
    "RegistrySnapshot",
    "ScheduleRegistry",
    "TuningService",
]
