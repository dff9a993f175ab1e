"""Collectives for sharded training over ``torch.distributed`` (the
reference leaves them to GSPMD, which inserts them from the shardings).

* :class:`MeshGroups` — the process groups of a :class:`~repro_torch.launch.
  mesh.Mesh` over the default group: one per set of axes a leaf is sharded
  over (single axes from the mesh's ``DeviceMesh``, larger proper sets from
  ``new_group``), all made at construction, in one order on every rank.
* :class:`GatherParam` — an autograd Function: forward, the
  ``all_gather_into_tensor`` of a leaf's shards over the ranks that hold
  distinct ones, put back into the full leaf; backward, the gradient
  reduce-scattered over the same ranks, all-reduced over the ranks that
  hold copies of the shard, and divided by the world size.  Every rank
  computes its loss on its batch shard, so the gradient a step applies is
  (1/world)·Σ over ranks, which stays right when the ``model`` axis holds
  duplicate batch shards.
* :class:`AllReduceMean` — the mean over the world (forward and backward).
* :class:`CollectiveCounter` — per op: the count, the operand bytes and the
  result bytes (and the bytes per dtype), as the reference's dry-run counts
  them from the compiled HLO.

One leaf per collective, its shard flattened into one buffer.  Leaves are
gathered in the model's order of use, and autograd runs the backward in one
order on every rank, so every rank issues the same collectives in the same
order.  A group of one rank still runs its collective (a copy): at world 1
the sharded step launches what the unsharded step launches, plus copies.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import Spec, local_shape, local_slices, shard_leaf, spec_axes
from repro_torch.tree import flatten_up_to, leaves, tree_map, unflatten


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class CollectiveCounter:
    """Collectives issued, per op: count, operand bytes, result bytes and
    the operand bytes per dtype."""

    def __init__(self):
        self.stats: dict[str, dict] = {}

    def add(self, op: str, operand: torch.Tensor, result: torch.Tensor) -> None:
        s = self.stats.setdefault(op, {"count": 0, "operand_bytes": 0, "result_bytes": 0,
                                       "dtypes": {}})
        s["count"] += 1
        s["operand_bytes"] += _nbytes(operand)
        s["result_bytes"] += _nbytes(result)
        name = str(operand.dtype).removeprefix("torch.")
        s["dtypes"][name] = s["dtypes"].get(name, 0) + _nbytes(operand)

    def reset(self) -> None:
        self.stats = {}

    def snapshot(self) -> dict:
        out = {op: {**s, "dtypes": dict(s["dtypes"])} for op, s in self.stats.items()}
        out["total_operand_bytes"] = sum(s["operand_bytes"] for s in self.stats.values())
        return out


@dataclasses.dataclass(frozen=True)
class LeafPlacement:
    """Where one leaf lives on a mesh of ``world`` ranks: its spec, full and
    local shapes, the axes its shards differ over (mesh order) and the axes
    that hold copies, with their sizes."""
    spec: Spec
    full_shape: tuple[int, ...]
    local_shape: tuple[int, ...]
    gather_axes: tuple[str, ...]
    copy_axes: tuple[str, ...]
    gather_size: int
    copy_size: int
    world: int

    @property
    def gathers(self) -> bool:
        """Whether gathering the leaf (and reduce-scattering its gradient)
        issues a collective: over the ranks holding distinct shards, or over
        the world of one rank (a copy).  Else the rank holds it whole."""
        return self.gather_size > 1 or self.world == 1

    @property
    def reduces_copies(self) -> bool:
        """Whether its gradient is all-reduced over ranks holding copies."""
        return self.copy_size > 1


def leaf_placement(full_shape: tuple[int, ...], spec: Spec, mesh) -> LeafPlacement:
    """A leaf's placement by its spec; needs no process group (the planner
    reads it as the sharded step does)."""
    sharded = {a for entry in spec for a in spec_axes(entry)}
    gather = tuple(a for a in mesh.axis_names if a in sharded)
    copy = tuple(a for a in mesh.axis_names if a not in sharded)
    return LeafPlacement(tuple(spec), tuple(full_shape), local_shape(tuple(full_shape), spec, mesh),
                         gather, copy, math.prod(mesh.shape[a] for a in gather),
                         math.prod(mesh.shape[a] for a in copy), mesh.size)


class MeshGroups:
    """The process groups of ``mesh`` over the default process group, whose
    world size must be ``mesh.size``.  This rank sits at
    ``mesh.coords(rank)``."""

    def __init__(self, mesh, counter: CollectiveCounter | None = None):
        if not dist.is_initialized():
            raise RuntimeError("sharded training needs a process group "
                               "(torch.distributed.init_process_group)")
        self.mesh = mesh
        self.world = dist.get_world_size()
        self.rank = dist.get_rank()
        self.coords = mesh.coords(self.rank)
        self.counter = counter if counter is not None else CollectiveCounter()
        self.device_mesh = mesh.device_mesh()
        names = mesh.axis_names
        self._groups: dict[frozenset, Any] = {}
        for n in range(len(names) + 1):
            for axes in itertools.combinations(names, n):     # one order on every rank
                self._groups[frozenset(axes)] = self._make(axes)

    def _make(self, axes: tuple[str, ...]):
        size = math.prod(self.mesh.shape[a] for a in axes)
        if size == self.world:
            return dist.group.WORLD
        if size == 1:
            return None                                      # this rank alone: a copy
        if len(axes) == 1:
            return self.device_mesh.get_group(axes[0])
        mine = None
        rest = [a for a in self.mesh.axis_names if a not in axes]
        for fixed in itertools.product(*(range(self.mesh.shape[a]) for a in rest)):
            ranks = [self.mesh.rank_of({**dict(zip(rest, fixed)), **dict(zip(axes, c))})
                     for c in itertools.product(*(range(self.mesh.shape[a]) for a in axes))]
            g = dist.new_group(sorted(ranks))
            if self.rank in ranks:
                mine = g
        return mine

    def group(self, axes) -> Any:
        """The group over ``axes`` that holds this rank (None: this rank
        alone)."""
        return self._groups[frozenset(axes)]

    def size(self, axes) -> int:
        return math.prod(self.mesh.shape[a] for a in axes)

    def placement(self, full_shape: tuple[int, ...], spec: Spec) -> LeafPlacement:
        return leaf_placement(full_shape, spec, self.mesh)

    # -- the collectives, counted (every one the port issues goes here) ----------
    # all_gather_into_tensor / reduce_scatter_tensor: the names every torch
    # since 2.0 has (later versions add *_single and deprecate these)
    def all_gather(self, out: torch.Tensor, x: torch.Tensor, group) -> None:
        """Every rank's ``x`` concatenated in rank order into ``out``."""
        dist.all_gather_into_tensor(out, x, group=group)
        self.counter.add("all_gather", x, out)

    def reduce_scatter(self, out: torch.Tensor, x: torch.Tensor, group) -> None:
        dist.reduce_scatter_tensor(out, x, op=dist.ReduceOp.SUM, group=group)
        self.counter.add("reduce_scatter", x, out)

    def all_reduce(self, x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> None:
        dist.all_reduce(x, op=op, group=group)
        self.counter.add("all_reduce", x, x)

    # -- a leaf's shards <-> the full leaf ---------------------------------------
    def gather_full(self, local: torch.Tensor, pl: LeafPlacement) -> torch.Tensor:
        """The full leaf from every rank's shard (a collective over the
        ranks that hold distinct shards)."""
        if not pl.gathers:
            return local.clone()
        group = self.group(pl.gather_axes)
        sizes = [self.mesh.shape[a] for a in pl.gather_axes]
        x = local.contiguous().view(-1)
        out = torch.empty(math.prod(sizes) * x.numel(), dtype=x.dtype, device=x.device)
        self.all_gather(out, x, group)
        n = len(sizes)
        perm = []
        for d, entry in enumerate(pl.spec):
            perm += [pl.gather_axes.index(a) for a in spec_axes(entry)] + [n + d]
        return out.view(tuple(sizes) + pl.local_shape).permute(perm).reshape(pl.full_shape)

    def reduce_grad(self, grad: torch.Tensor, pl: LeafPlacement) -> torch.Tensor:
        """A full leaf's gradient -> this rank's shard of (1/world)·Σ over
        ranks: reduce-scattered over the ranks with distinct shards,
        all-reduced over the ranks with copies."""
        if not pl.gathers:
            local = grad.contiguous().clone()
        else:
            split, where, loc = [], {}, []
            for d, entry in enumerate(pl.spec):
                for a in spec_axes(entry):
                    where[a] = len(split)
                    split.append(self.mesh.shape[a])
                loc.append(len(split))
                split.append(pl.local_shape[d])
            order = [where[a] for a in pl.gather_axes] + loc
            send = grad.reshape(tuple(split)).permute(order).contiguous().view(-1)
            local = torch.empty(math.prod(pl.local_shape), dtype=grad.dtype, device=grad.device)
            self.reduce_scatter(local, send, self.group(pl.gather_axes))
            local = local.view(pl.local_shape)
        if pl.reduces_copies:
            self.all_reduce(local, self.group(pl.copy_axes))
        return local.div_(self.world)


class GatherParam(torch.autograd.Function):
    """A leaf's shard -> the full leaf (all-gather); its gradient -> the
    shard's (reduce-scatter, all-reduce over copies, / world)."""

    @staticmethod
    def forward(ctx, local, placement, groups):
        ctx.placement, ctx.groups = placement, groups
        return groups.gather_full(local, placement)

    @staticmethod
    def backward(ctx, grad):
        return ctx.groups.reduce_grad(grad, ctx.placement), None, None


class AllReduceMean(torch.autograd.Function):
    """The mean over the world of a tensor every rank holds; its gradient
    likewise."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return _mean(x, groups)

    @staticmethod
    def backward(ctx, grad):
        return _mean(grad, ctx.groups), None


def _mean(x: torch.Tensor, groups: MeshGroups) -> torch.Tensor:
    y = x.contiguous().clone()
    groups.all_reduce(y, dist.group.WORLD)
    return y.div_(groups.world)


class ShardedTree:
    """One tree's placements on this rank: ``specs`` (a spec tree of the
    tree's structure, :func:`~repro_torch.distributed.sharding.param_shardings`)
    over full leaves shaped like ``like``'s."""

    def __init__(self, groups: MeshGroups, like: Any, specs: Any):
        self.groups = groups
        self.like = tree_map(lambda t: torch.empty(tuple(t.shape), dtype=t.dtype, device="meta"),
                             like)
        self.placements = [groups.placement(tuple(t.shape), s)
                           for t, s in zip(leaves(like), flatten_up_to(specs, like))]

    def shard(self, full: Any) -> Any:
        """This rank's slices of a full tree (leaves found by path, so its
        dicts may hold their keys in another order), each a tensor of its
        own, in the order of ``like``."""
        g = self.groups
        return unflatten(self.like, [shard_leaf(t, pl.spec, g.mesh, g.coords) for t, pl in
                                     zip(flatten_up_to(full, self.like), self.placements)])

    def slices(self) -> Any:
        """This rank's index (a tuple of slices) into each full leaf."""
        g = self.groups
        return unflatten(self.like, [local_slices(pl.full_shape, pl.spec, g.mesh, g.coords)
                                     for pl in self.placements])

    @torch.no_grad()
    def full_leaves(self, local: Any):
        """Each full leaf in turn (a collective per leaf on every rank)."""
        for t, pl in zip(flatten_up_to(local, self.like), self.placements):
            yield self.groups.gather_full(t, pl)

    def gather(self, local: Any) -> Any:
        """The whole full tree (every leaf on every rank)."""
        return unflatten(self.like, list(self.full_leaves(local)))


class ParamGather:
    """What the models call on a subtree of sharded params: each leaf goes
    through :class:`GatherParam` to its full value.  It knows a leaf by the
    tensor itself (the step updates its shards in place).  The batch is
    split into ``batch_shards`` distinct shards over the world (the
    ``model`` axis may hold copies of one)."""

    def __init__(self, sharded: ShardedTree, local: Any, batch_shards: int):
        self._keep = flatten_up_to(local, sharded.like)
        self._by_id = {id(t): pl for t, pl in zip(self._keep, sharded.placements)}
        self.groups = sharded.groups
        self.batch_shards = batch_shards

    def __call__(self, tree: Any) -> Any:
        return tree_map(lambda t: GatherParam.apply(t, self._by_id[id(t)], self.groups), tree)

    def batch_mean(self, x: torch.Tensor) -> torch.Tensor:
        """A mean over this rank's batch shard -> the mean over the global
        batch (every shard holds as many rows): :class:`AllReduceMean`."""
        return AllReduceMean.apply(x, self.groups)

    def batch_count(self, n: torch.Tensor) -> torch.Tensor:
        """This rank's share of a count over the global batch, from its
        shard's count ``n``: the global count over ``batch_shards``, at
        least 1 over it (a masked mean's divisor, floored at 1 as the
        reference floors it).  A shard's sum over it averages over the world
        to the global batch's sum over the global count."""
        return torch.clamp(AllReduceMean.apply(n, self.groups), min=1.0 / self.batch_shards)
