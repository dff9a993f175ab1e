"""Multi-target hardware subsystem.

Makes the hardware target a first-class, pluggable dimension of the tuning
and serving stack: a named-target registry (registry.py), target-namespaced
schedule stores, and explicit cross-target schedule transfer.
"""
from repro_torch.targets.registry import (
    DEFAULT_TARGET,
    Target,
    get_target,
    list_targets,
    register_target,
    resolve_target,
    target_name,
)

__all__ = [
    "DEFAULT_TARGET",
    "Target",
    "get_target",
    "list_targets",
    "register_target",
    "resolve_target",
    "target_name",
]
