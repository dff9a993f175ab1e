"""Meshes (the counterpart of ``repro.launch.mesh``).

A :class:`Mesh` is a description: axis names and sizes, with the
reference's shapes, and no device state.  Rank ``r`` of a process group sits
at the row-major coordinates of ``r`` over the axis sizes, as
``jax.make_mesh`` lays host devices out.  :meth:`Mesh.device_mesh` turns the
description into a ``torch.distributed.device_mesh.DeviceMesh`` once a
process group is up; importing this module touches no device and no group.
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes) or min(self.sizes, default=1) < 1:
            raise ValueError(f"bad mesh {self.axis_names} x {self.sizes}")

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    @property
    def name(self) -> str:
        return "x".join(str(s) for s in self.sizes)

    def coords(self, rank: int) -> dict[str, int]:
        """The row-major coordinates of ``rank``, by axis name."""
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside a mesh of {self.size}")
        out = {}
        for name, size in zip(reversed(self.axis_names), reversed(self.sizes)):
            rank, out[name] = divmod(rank, size)
        return {name: out[name] for name in self.axis_names}

    def rank_of(self, coords: dict[str, int]) -> int:
        r = 0
        for name, size in zip(self.axis_names, self.sizes):
            r = r * size + coords[name]
        return r

    def device_mesh(self):
        """This mesh as a ``DeviceMesh`` over the default process group's
        ranks (which must number :attr:`size`), its dims named by the axes:
        on ``cuda`` under NCCL, on ``cpu`` under gloo."""
        import torch.distributed as dist
        from torch.distributed.device_mesh import DeviceMesh

        if dist.get_world_size() != self.size:
            raise ValueError(f"a {self.name} mesh needs {self.size} ranks, "
                             f"the group has {dist.get_world_size()}")
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
        return DeviceMesh(device_type, torch.arange(self.size).reshape(self.sizes),
                          mesh_dim_names=self.axis_names)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 single pod (256 chips) or 2x16x16 two-pod (512 chips)."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_test_mesh(n_devices: int | None = None, model: int = 2) -> Mesh:
    """A (n / model, model) mesh over ``n_devices`` ranks (default: the
    process group's world size, 1 without a group)."""
    if n_devices is None:
        import torch.distributed as dist

        n_devices = dist.get_world_size() if dist.is_initialized() else 1
    if model < 1 or n_devices % model:
        raise ValueError(f"{n_devices} ranks do not split into model axes of {model}")
    return Mesh(("data", "model"), (n_devices // model, model))
