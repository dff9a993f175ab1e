"""Schedule IR: a copy of ``repro.core.schedule``'s schedule, concretization
and default schedules (the port imports nothing of ``repro``).

A :class:`Schedule` stores absolute tile sizes, a loop order and the
TPU-flavoured knobs (``parallel``, ``unroll``, ``vec``, ``cache_write``);
:func:`concretize` binds it to one :class:`KernelInstance` exactly as the
reference does, so a kernel instance resolves to the same
:class:`ConcreteSchedule` in both packages.  How the CUDA kernels read each
field is written in their wrappers' docstrings
(:mod:`repro_torch.kernels.matmul`, :mod:`repro_torch.kernels.flash_attention`).
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

from repro_torch.core.workload import KernelInstance, class_axes, class_family


class ScheduleInvalid(Exception):
    """Transferred schedule produces invalid code for this instance."""


@dataclasses.dataclass(frozen=True)
class Schedule:
    """A shape-transferable auto-schedule for one kernel class."""

    class_id: str
    tiles: tuple[tuple[str, int], ...]      # axis -> block size (absolute)
    order: tuple[str, ...]                  # grid axis order, outer→inner
    parallel: int = 1                       # leading grid axes marked parallel
    unroll: int = 0
    vec: int = 128
    cache_write: bool = True
    source: str = ""                        # workload key tuned on (provenance)

    @staticmethod
    def make(class_id: str, tiles: Mapping[str, int], order: Sequence[str] | None = None,
             parallel: int = 1, unroll: int = 0, vec: int = 128,
             cache_write: bool = True, source: str = "") -> "Schedule":
        axes = class_axes(class_id)
        order = tuple(order) if order is not None else tuple(axes)
        if sorted(order) != sorted(axes):
            raise ValueError(f"order {order} must permute axes {axes}")
        missing = [a for a in axes if a not in tiles]
        if missing:
            raise ValueError(f"tiles missing axes {missing}")
        return Schedule(
            class_id=class_id,
            tiles=tuple(sorted((a, int(tiles[a])) for a in axes)),
            order=order,
            parallel=int(parallel),
            unroll=int(unroll),
            vec=int(vec),
            cache_write=bool(cache_write),
            source=source,
        )

    @property
    def t(self) -> dict[str, int]:
        return dict(self.tiles)

    def to_json(self) -> dict:
        return {
            "class_id": self.class_id,
            "tiles": list(self.tiles),
            "order": list(self.order),
            "parallel": self.parallel,
            "unroll": self.unroll,
            "vec": self.vec,
            "cache_write": self.cache_write,
            "source": self.source,
        }


@dataclasses.dataclass(frozen=True)
class ConcreteSchedule:
    """A schedule bound to one instance: validated tiles + derived grid."""

    schedule: Schedule
    instance: KernelInstance
    tiles: tuple[tuple[str, int], ...]   # validated per-axis block sizes
    grid: tuple[tuple[str, int], ...]    # axis -> trip count, in `order` order
    adapted: bool                        # True if adaptive reformulation fired

    @property
    def t(self) -> dict[str, int]:
        return dict(self.tiles)

    @property
    def g(self) -> dict[str, int]:
        return dict(self.grid)

    @property
    def order(self) -> tuple[str, ...]:
        return self.schedule.order


def nearest_divisor(n: int, target: int) -> int:
    """Largest divisor of n that is <= target (n itself if none)."""
    below = [d for d in range(1, n + 1) if n % d == 0 and d <= target]
    if below:
        return below[-1]
    return n


#: Axes whose partial tiles the kernels mask (token rows, output columns,
#: both attention axes, scan channels).  Reduction-carrying axes stay strict.
MASKABLE_AXES = {"M", "N", "Q", "KV", "C"}

#: GLU epilogues pair adjacent (gate, up) columns: an odd N tile splits pairs.
GLU_CLASSES = ("matmul_silu_glu", "matmul_gelu_glu", "moe_gemm_silu_glu")


def concretize(schedule: Schedule, instance: KernelInstance, mode: str = "strict") -> ConcreteSchedule:
    """Bind a (possibly foreign) schedule to an instance.

    strict:   raise ScheduleInvalid on any layout-critical mismatch
              (maskable axes tolerate partial tiles).
    adaptive: snap tiles to the nearest divisor of the new extent.
    """
    if schedule.class_id != instance.class_id:
        raise ScheduleInvalid(
            f"class mismatch: schedule {schedule.class_id} vs instance {instance.class_id}"
        )
    if mode not in ("strict", "adaptive"):
        raise ValueError(f"unknown mode {mode!r}")

    tiles: dict[str, int] = {}
    adapted = False
    for axis in class_axes(instance.class_id):
        extent = instance.extent(axis)
        tile = schedule.t[axis]
        maskable = axis in MASKABLE_AXES
        if tile > extent:
            if maskable:
                tile = extent
            elif mode == "strict":
                raise ScheduleInvalid(f"tile {axis}={tile} exceeds extent {extent}")
            else:
                tile, adapted = extent, True
        if extent % tile != 0 and not maskable:
            if mode == "strict":
                raise ScheduleInvalid(f"tile {axis}={tile} does not divide extent {extent}")
            tile, adapted = nearest_divisor(extent, tile), True
        if axis == "N" and instance.class_id in GLU_CLASSES and tile % 2:
            if mode == "strict":
                raise ScheduleInvalid(f"odd N tile {tile} splits GLU pairs")
            tile, adapted = max(tile - 1, 2), True
        tiles[axis] = tile

    grid = tuple(
        (axis, -(-instance.extent(axis) // tiles[axis])) for axis in schedule.order
    )
    return ConcreteSchedule(
        schedule=schedule,
        instance=instance,
        tiles=tuple(sorted(tiles.items())),
        grid=grid,
        adapted=adapted,
    )


# ---------------------------------------------------------------------------
# Default (untuned) schedules
# ---------------------------------------------------------------------------

REDUCTION_AXIS = {"matmul": "K", "attention": "KV", "scan": "T"}

_DEFAULT_TARGET = {"M": 128, "Q": 128, "T": 128, "N": 512, "KV": 512, "C": 512,
                   "K": 256, "E": 1}


def default_schedule(instance: KernelInstance) -> Schedule:
    axes = class_axes(instance.class_id)
    tiles: dict[str, int] = {}
    for axis in axes:
        extent = instance.extent(axis)
        tiles[axis] = nearest_divisor(extent, min(_DEFAULT_TARGET[axis], extent))
    red = REDUCTION_AXIS[class_family(instance.class_id)]
    order = tuple(a for a in axes if a != red) + (red,)
    return Schedule.make(
        instance.class_id,
        tiles=tiles,
        order=order,
        parallel=1,
        unroll=0,
        vec=128,
        cache_write=True,
        source="__default__",
    )
