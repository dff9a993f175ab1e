"""Schedule IR: the TPU reformulation of the paper's schedule primitives, a
copy of ``repro.core.schedule`` (the port imports nothing of ``repro``), so a
kernel instance resolves to the same schedules in both packages.  The knobs
model the TPU; which of them each CUDA kernel reads is written in its
wrapper's docstring (:mod:`repro_torch.kernels.matmul`,
:mod:`repro_torch.kernels.flash_attention`, ...) and returned by its
``schedule_key``.

Paper primitives (Algorithm 1) and their TPU/Pallas mapping:

=================  ========================================================
TVM primitive       This framework
=================  ========================================================
Split(ax, f)        ``tiles[ax] = f`` — BlockSpec block size for the axis.
Reorder(...)        ``order`` — grid iteration order (outer→inner); changes
                    which operand block stays VMEM-resident between
                    consecutive grid steps, i.e. the HBM traffic pattern.
Fuse + Parallel     ``parallel`` — number of leading grid axes given
                    ``dimension_semantics="parallel"`` (Megacore/pipelining).
Unroll(ax, n)       ``unroll`` — in-kernel sub-tile unroll factor for the
                    innermost loop (instruction-overhead knob).
Vectorize(ax)       ``vec`` — lane multiple the innermost tile must respect
                    ((8,128) VREG tiling; misalignment wastes lanes).
ComputeAt/Cache     ``cache_write`` — accumulate into an f32 VMEM scratch
                    buffer instead of the (bf16) output block.
=================  ========================================================

A ``Schedule`` stores *absolute* tile sizes — exactly what an auto-scheduler
measures on its source kernel.  Applying a schedule to another instance of
the same class is *transfer-tuning*; ``concretize`` validates it:

* ``strict``  — the paper's semantics: a tile that does not divide the new
  extent (or exceeds it, or overflows VMEM) makes the transferred schedule
  INVALID (the ``-1`` bars of paper Fig. 4).
* ``adaptive`` — beyond-paper extension: reformulate the tile
  shape-agnostically (paper §4.1's ``Split(N, N/8, 8)`` trick, generalized):
  snap the tile to the nearest divisor of the new extent, preserving the
  schedule's *structure*.  Recovers most invalid transfers; evaluated
  separately in EXPERIMENTS.md.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Sequence

from repro_torch.core.workload import KernelInstance, class_axes


class ScheduleInvalid(Exception):
    """Transferred schedule produces invalid code for this instance."""


UNROLL_CHOICES = (0, 4, 16, 64, 512)
VEC_CHOICES = (128, 256, 512)


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

    def with_source(self, source: str) -> "Schedule":
        return dataclasses.replace(self, source=source)

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

    @staticmethod
    def from_json(d: Mapping) -> "Schedule":
        return Schedule(
            class_id=d["class_id"],
            tiles=tuple((str(a), int(v)) for a, v in d["tiles"]),
            order=tuple(d["order"]),
            parallel=int(d["parallel"]),
            unroll=int(d["unroll"]),
            vec=int(d["vec"]),
            cache_write=bool(d["cache_write"]),
            source=d.get("source", ""),
        )


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

    def trip_counts(self) -> tuple[int, ...]:
        return tuple(n for _, n in self.grid)

    def total_steps(self) -> int:
        return math.prod(self.trip_counts())


def divisors_leq(n: int, cap: int) -> list[int]:
    return [d for d in range(1, min(n, cap) + 1) if n % d == 0]


def nearest_divisor(n: int, target: int) -> int:
    """Largest divisor of n that is <= target, else smallest divisor >= target."""
    below = [d for d in range(1, n + 1) if n % d == 0 and d <= target]
    if below:
        return below[-1]
    return n  # target < 1 cannot happen; fall back to full extent


#: Axes whose partial tiles the kernels mask on TPU (cdiv grids with clipped
#: OOB write-back / score masks): token rows (M), output columns (N — each
#: output column depends only on its own weight column), both attention axes,
#: and scan channels (C).  Reduction-carrying axes stay strict — a partial K
#: tile would pollute the accumulation and a partial T chunk would corrupt
#: the recurrent state — and those are exactly the splits that produce
#: invalid transferred code, the analogue of the paper's Fig. 4 "-1" bars.
MASKABLE_AXES = {"M", "N", "Q", "KV", "C"}

#: GLU epilogues pair adjacent (gate, up) columns: a partial N tile is fine
#: but an odd tile would split pairs.
GLU_CLASSES = ("matmul_silu_glu", "matmul_gelu_glu", "moe_gemm_silu_glu")


def concretize(schedule: Schedule, instance: KernelInstance, mode: str = "strict") -> ConcreteSchedule:
    """Bind a (possibly foreign) schedule to an instance.

    strict:   paper semantics — raise ScheduleInvalid on any layout-critical
              mismatch (maskable row axes tolerate partial tiles).
    adaptive: beyond-paper — shape-agnostic reformulation of tiles.
    """
    if schedule.class_id != instance.class_id:
        # Across-class transfer is out of scope (paper §4.2): always invalid.
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
                tile = extent  # one (partial) block — masked, still valid
            elif mode == "strict":
                # Paper §4.2: "a loop splitting factor which is larger than
                # the loop itself" → invalid code.
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


def is_valid(schedule: Schedule, instance: KernelInstance, mode: str = "strict") -> bool:
    try:
        concretize(schedule, instance, mode=mode)
        return True
    except ScheduleInvalid:
        return False


# ---------------------------------------------------------------------------
# Default (untuned) schedules: the baseline every speedup is measured against,
# playing the role of TVM's generic fallback schedules in the paper.
# They are deliberately generic: small fixed tiles, natural order, no staging.
# ---------------------------------------------------------------------------


REDUCTION_AXIS = {"matmul": "K", "attention": "KV", "scan": "T"}

#: Generic fallback tile targets — the analogue of TVM's hand-written
#: default schedules (sensible blocking + staging, but shape-agnostic and
#: therefore leaving the shape-specific headroom auto-scheduling recovers).
_DEFAULT_TARGET = {"M": 128, "Q": 128, "T": 128, "N": 512, "KV": 512, "C": 512,
                   "K": 256, "E": 1}


def default_schedule(instance: KernelInstance) -> Schedule:
    from repro_torch.core.workload import class_family

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
