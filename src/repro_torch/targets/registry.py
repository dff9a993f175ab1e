"""Hardware-target registry: named, pluggable tuning targets.

The paper's headline result is evaluated on *two* platforms — a server-class
CPU and a constrained edge CPU — and its key finding is that transfer-tuning's
advantage widens on the constrained device.  Reproducing that axis requires
the target to be a first-class dimension of the whole tuning stack rather
than a hardcoded ``TPU_V5E`` constant:

* a :class:`Target` binds a name, a :class:`~repro_torch.hw.specs.ChipSpec`, and a
  tier ("server" / "edge") — resolvable from CLI flags and configs;
* every schedule record, registry entry, and service lookup is *namespaced*
  by target name, so schedules tuned for one chip never silently serve
  another (a v5e schedule may overflow the lite chip's VMEM, and even a
  structurally valid one was selected under the wrong roofline);
* cross-target reuse is an *explicit* API
  (:func:`repro_torch.core.transfer.cross_target_transfer`): donors tuned on
  target A are re-validated and re-measured under target B's spec, and
  edge-infeasible donors surface as invalid transfers (the paper's −1 bars)
  instead of crashing.

Three targets ship registered: ``tpu-v5e`` (the seed server chip),
``tpu-v5e-lite`` (constrained edge analogue), and ``tpu-v5p`` (larger).
``register_target`` adds more without touching the tuning stack.

A copy of ``repro.targets.registry``, registering the same three TPU targets
plus ``h100``, the card the port runs on: its schedules are timed there
(:class:`repro_torch.core.measured_runner.MeasuredRunner`), never modelled.
"""
from __future__ import annotations

import dataclasses

from repro_torch.hw.specs import H100, TPU_V5E, TPU_V5E_LITE, TPU_V5P, ChipSpec

#: The target every pre-subsystem API call implicitly tuned for; also the
#: value persisted records without a ``target`` field are attributed to.
DEFAULT_TARGET = "tpu-v5e"


@dataclasses.dataclass(frozen=True)
class Target:
    """A named hardware target: the unit tuning namespaces are keyed by."""

    name: str
    spec: ChipSpec
    tier: str = "server"          # "server" | "edge" — the paper's platform axis
    description: str = ""

    def __post_init__(self):
        if not self.name:
            raise ValueError("target name must be non-empty")
        if self.tier not in ("server", "edge"):
            raise ValueError(f"unknown target tier {self.tier!r}")


_REGISTRY: dict[str, Target] = {}


def register_target(target: Target, *, overwrite: bool = False) -> Target:
    """Register a target by name; re-registration requires ``overwrite``."""
    if target.name in _REGISTRY and not overwrite:
        raise ValueError(f"target {target.name!r} already registered")
    _REGISTRY[target.name] = target
    return target


def get_target(name: str) -> Target:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown target {name!r}; registered targets: {list_targets()}"
        ) from None


def list_targets() -> list[str]:
    return sorted(_REGISTRY)


def target_name(target: "str | Target | ChipSpec | None") -> str:
    """The namespace key for a target-ish value (no registry lookup).

    Accepts a name, a :class:`Target`, a bare :class:`ChipSpec`, or ``None``
    (the default target).  Used by stores that only need the *key*, not the
    spec — unregistered names pass through so foreign DBs stay readable.
    """
    if target is None:
        return DEFAULT_TARGET
    if isinstance(target, str):
        return target
    return target.name


def resolve_target(target: "str | Target | ChipSpec | None") -> Target:
    """Resolve a target-ish value to a full :class:`Target` (spec included).

    Names go through the registry (unknown names raise with the available
    list); a bare :class:`ChipSpec` resolves to its registered target when
    the name matches, else wraps as an anonymous server-tier target.
    """
    if target is None:
        return get_target(DEFAULT_TARGET)
    if isinstance(target, Target):
        return target
    if isinstance(target, ChipSpec):
        known = _REGISTRY.get(target.name)
        if known is not None:
            if known.spec == target:
                return known
            # A different chip wearing a registered name would alias two
            # hardware namespaces — records measured on one would be served
            # as exact hits on the other.
            raise ValueError(
                f"ChipSpec named {target.name!r} differs from the registered "
                "target of that name; register it under a distinct name")
        return Target(name=target.name, spec=target)
    return get_target(target)


register_target(Target(
    name="tpu-v5e", spec=TPU_V5E, tier="server",
    description="seed server-class chip; the paper's high-end platform"))
register_target(Target(
    name="tpu-v5e-lite", spec=TPU_V5E_LITE, tier="edge",
    description="constrained edge analogue: 1 MXU, narrow memory, 8 MiB VMEM"))
register_target(Target(
    name="tpu-v5p", spec=TPU_V5P, tier="server",
    description="pod-scale chip: more FLOPs, HBM2e bandwidth, larger VMEM"))
register_target(Target(
    name="h100", spec=H100, tier="server",
    description="NVIDIA H100 SXM 80GB: schedules timed on the card, never modelled"))
