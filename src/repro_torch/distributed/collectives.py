"""Collectives for sharded training over ``torch.distributed`` (the
reference leaves them to GSPMD, which inserts them from the shardings).

* :class:`MeshGroups` — the process groups of a :class:`~repro_torch.launch.
  mesh.Mesh` over the default group: one per set of axes a leaf is sharded
  over (single axes from the mesh's ``DeviceMesh``, larger proper sets from
  ``new_group``), all made at construction, in one order on every rank.
  Every collective the port issues goes through it, named by its axes and
  counted.  Under gloo a CUDA tensor's collective is staged through host
  memory (gloo's reduce-scatter takes no CUDA tensor): one op, counted once.
* :class:`GatherParam` — an autograd Function: forward, the
  ``all_gather_into_tensor`` of a leaf's shards over the ranks that hold
  distinct ones, put back into the full leaf; backward, the gradient
  reduce-scattered over the same ranks, all-reduced over the ranks that
  hold copies of the shard, and divided by the number of batch shards.
  Under tensor-parallel compute a leaf's ``model`` shard may stay local: it
  is gathered over the fsdp axes only (:func:`leaf_placement`'s
  ``local_axes``).
* :class:`TensorParallel` — the ``model`` axis's compute: the residual
  stream's all-gather along D (backward, a reduce-scatter), a row-parallel
  product's reduce-scatter into the residual layout (backward, an
  all-gather), the all-reduces of the vocab-parallel loss, and a sharded
  cache's collectives at decode.  In bf16 every sum of partial products
  over ``model`` is taken in f32 (``f32_partials``): a row-parallel
  product's partial sums reach the reduce-scatter in f32, its bias is added
  once after it and the cast follows (the reference's order: its f32 dot
  is summed, then cast); under autograd the gathered stream is an f32
  *carrier* of its bf16 values, so the partial input gradients of the
  column-parallel products (and of the norms and the MoE dispatch between
  them) reach the gather's reduce-scatter in f32 and are rounded after it;
  a bf16 leaf whose gradient is summed over ``model`` from partial
  products (a norm's scale, rwkv6's token mixes and decay adapter, an
  attention projection gathered over ``model``: :func:`widens_grad`) is
  gathered as an f32 carrier too, and its gradient reduced in f32.
* :class:`SequenceParallel` — context parallelism for prefill over
  ``model``: S split over the axis, each attention layer's K and V
  all-gathered, a token shift's rows passed on (``collective_permute``), a
  scan's state handed from rank to rank, the final states taken from the
  last rank.
* :class:`AllReduceMean` — the mean over a set of axes (forward and
  backward).
* :class:`CollectiveCounter` — per op: the count, the operand bytes and the
  result bytes (and the bytes per dtype and the count per set of axes), as
  the reference's dry-run counts them from the compiled HLO.

The gradients' bookkeeping.  Every rank computes the loss of its batch
shard.  Under tensor-parallel compute the ranks of one ``model`` row hold
one batch shard, and a value every rank of the row computes alike (a norm's
output, the router's probabilities, the loss itself) carries on each rank a
*partial* gradient: the rank's own share, the shares summing over the row
to the whole.  The loss seeds its gradient on the row's first rank
(:meth:`TensorParallel.once`), each product over a local shard adds its
share, and each collective's backward is its dual: an all-gather's a
reduce-scatter, a reduce-scatter's an all-gather, an all-reduce's an
all-reduce.  So a leaf that stays local gets its whole gradient, and a leaf
the row holds copies of (or gathers over ``model``) gets partial ones that
the gradient's reduce over copies (or its reduce-scatter) sums; dividing
by the number of batch shards then gives the global batch's mean.  Without
tensor-parallel compute every rank of the mesh holds a batch shard of its
own, and the divisor is the world size.

One leaf per collective, its shard flattened into one buffer.  Leaves are
gathered in the model's order of use, and autograd runs the backward in one
order on every rank, so every rank issues the same collectives in the same
order.  A group of one rank still runs its collective (a copy) at world 1:
there the sharded step launches what the unsharded step launches, plus
copies.  Above world 1 an axis of size 1 moves nothing.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import math
from typing import Any

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import (Spec, attn_heads_local, leaf_name, local_shape,
                                              local_slices, moe_expert_parallel, shard_leaf,
                                              spec_axes, tp_keeps_local)
from repro_torch.tree import flatten_up_to, leaves, leaves_with_paths, tree_map, unflatten

#: the axis tensor-parallel compute splits over
MODEL_AXIS = "model"


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def axes_key(axes) -> str:
    """A set of axes as the counter names it ("data,model")."""
    return ",".join(axes)


class CollectiveCounter:
    """Collectives issued, per op: count, operand bytes, result bytes, the
    operand bytes per dtype and the count per set of axes."""

    def __init__(self):
        self.stats: dict[str, dict] = {}

    def add(self, op: str, operand: torch.Tensor, result: torch.Tensor, axes=()) -> None:
        s = self.stats.setdefault(op, {"count": 0, "operand_bytes": 0, "result_bytes": 0,
                                       "dtypes": {}, "axes": {}})
        s["count"] += 1
        s["operand_bytes"] += _nbytes(operand)
        s["result_bytes"] += _nbytes(result)
        name = str(operand.dtype).removeprefix("torch.")
        s["dtypes"][name] = s["dtypes"].get(name, 0) + _nbytes(operand)
        key = axes_key(axes)
        s["axes"][key] = s["axes"].get(key, 0) + 1

    def reset(self) -> None:
        self.stats = {}

    def snapshot(self) -> dict:
        out = {op: {**s, "dtypes": dict(s["dtypes"]), "axes": dict(s["axes"])}
               for op, s in self.stats.items()}
        out["total_operand_bytes"] = sum(s["operand_bytes"] for s in self.stats.values())
        return out


@dataclasses.dataclass(frozen=True)
class LeafPlacement:
    """Where one leaf lives on a mesh of ``world`` ranks and what a gather
    of it gives: the spec and full shape of what is gathered (the leaf
    itself, or under tensor-parallel compute the rank's ``model`` shard of
    it), the stored shard's shape, the axes the gather runs over (mesh
    order) and the axes that hold copies, with their sizes, and what the
    gradient is divided by (the number of batch shards)."""
    spec: Spec
    full_shape: tuple[int, ...]
    local_shape: tuple[int, ...]
    gather_axes: tuple[str, ...]
    copy_axes: tuple[str, ...]
    gather_size: int
    copy_size: int
    world: int
    grad_div: int

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


def leaf_placement(full_shape: tuple[int, ...], spec: Spec, mesh, local_axes=(),
                   batch_shards: int | None = None) -> LeafPlacement:
    """A leaf's placement by its spec; needs no process group (the planner
    reads it as the sharded step does).  ``local_axes``: axes whose shard
    the compute keeps (tensor-parallel compute: ``("model",)``), gathered
    over the rest; ``batch_shards``: the gradient's divisor (default: the
    world size)."""
    sharded = {a for entry in spec for a in spec_axes(entry)}
    gather = tuple(a for a in mesh.axis_names if a in sharded and a not in local_axes)
    copy = tuple(a for a in mesh.axis_names if a not in sharded)
    shape, kept = list(full_shape), []
    for d, entry in enumerate(spec):
        axes = spec_axes(entry)
        for a in axes:
            if a in local_axes:
                shape[d] //= mesh.shape[a]
        rest = tuple(a for a in axes if a not in local_axes)
        kept.append(None if not rest else rest[0] if len(rest) == 1 else rest)
    return LeafPlacement(tuple(kept), tuple(shape), local_shape(tuple(full_shape), spec, mesh),
                         gather, copy, math.prod(mesh.shape[a] for a in gather),
                         math.prod(mesh.shape[a] for a in copy), mesh.size,
                         batch_shards or mesh.size)


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
        #: gloo: a CUDA tensor's collective goes through host memory
        self.staged = dist.get_backend() == "gloo"
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

    def moves(self, axes) -> bool:
        """Whether a collective over ``axes`` is issued: over more than one
        rank, or at world 1 (a copy)."""
        return self.size(axes) > 1 or self.world == 1

    @property
    def all_axes(self) -> tuple[str, ...]:
        return tuple(self.mesh.axis_names)

    def placement(self, full_shape: tuple[int, ...], spec: Spec) -> LeafPlacement:
        return leaf_placement(full_shape, spec, self.mesh)

    # -- the collectives, counted (every one the port issues goes here) ----------
    # all_gather_into_tensor / reduce_scatter_tensor: the names every torch
    # since 2.0 has (later versions add *_single and deprecate these)
    def _host(self, *ts: torch.Tensor) -> bool:
        return self.staged and ts[0].is_cuda

    def all_gather(self, out: torch.Tensor, x: torch.Tensor, axes) -> None:
        """Every rank's ``x`` over ``axes`` concatenated in rank order into
        ``out``."""
        if self._host(x):
            o = out.cpu()
            dist.all_gather_into_tensor(o, x.cpu(), group=self.group(axes))
            out.copy_(o)
        else:
            dist.all_gather_into_tensor(out, x, group=self.group(axes))
        self.counter.add("all_gather", x, out, axes)

    def reduce_scatter(self, out: torch.Tensor, x: torch.Tensor, axes) -> None:
        if self._host(x):
            o = out.cpu()
            dist.reduce_scatter_tensor(o, x.cpu(), op=dist.ReduceOp.SUM, group=self.group(axes))
            out.copy_(o)
        else:
            dist.reduce_scatter_tensor(out, x, op=dist.ReduceOp.SUM, group=self.group(axes))
        self.counter.add("reduce_scatter", x, out, axes)

    def all_reduce(self, x: torch.Tensor, axes, op=dist.ReduceOp.SUM) -> None:
        if self._host(x):
            h = x.cpu()
            dist.all_reduce(h, op=op, group=self.group(axes))
            x.copy_(h)
        else:
            dist.all_reduce(x, op=op, group=self.group(axes))
        self.counter.add("all_reduce", x, x, axes)

    def neighbour(self, axis: str, step: int) -> int | None:
        """The global rank ``step`` places along ``axis`` from this one
        (None: off the axis's end)."""
        i = self.coords[axis] + step
        if not 0 <= i < self.mesh.shape[axis]:
            return None
        return self.mesh.rank_of({**self.coords, axis: i})

    def permute(self, x: torch.Tensor, axis: str, *, send: bool = True,
                recv: bool = True, count: bool = True) -> torch.Tensor:
        """Each rank's ``x`` to the next rank along ``axis`` (point to point):
        what the previous rank sent, zeros on the first; counted once a call
        as ``collective_permute`` (the reference's name for it).  ``send`` /
        ``recv`` False: this rank's half of the exchange is left out (a
        hand-off chain issues them apart, and counts the pair once)."""
        out = torch.zeros_like(x)
        src, dst = self.neighbour(axis, -1), self.neighbour(axis, 1)
        host = self._host(x)
        buf = out.cpu() if host else out
        payload = x.contiguous().cpu() if host else x.contiguous()
        reqs = []
        if recv and src is not None:
            reqs.append(dist.irecv(buf, src))
        if send and dst is not None:
            reqs.append(dist.isend(payload, dst))
        for r in reqs:
            r.wait()
        if host:
            out.copy_(buf)
        if count:
            self.counter.add("collective_permute", x, out, (axis,))
        return out

    # -- a leaf's shards <-> the full leaf ---------------------------------------
    def gather_full(self, local: torch.Tensor, pl: LeafPlacement) -> torch.Tensor:
        """The full leaf (or under tensor-parallel compute its local
        ``model`` shard) from every rank's shard: a collective over the
        ranks that hold distinct shards."""
        if not pl.gathers:
            return local.clone()
        sizes = [self.mesh.shape[a] for a in pl.gather_axes]
        x = local.contiguous().view(-1)
        out = torch.empty(math.prod(sizes) * x.numel(), dtype=x.dtype, device=x.device)
        self.all_gather(out, x, pl.gather_axes)
        n = len(sizes)
        perm = []
        for d, entry in enumerate(pl.spec):
            perm += [pl.gather_axes.index(a) for a in spec_axes(entry)] + [n + d]
        return out.view(tuple(sizes) + pl.local_shape).permute(perm).reshape(pl.full_shape)

    def reduce_grad(self, grad: torch.Tensor, pl: LeafPlacement) -> torch.Tensor:
        """A gathered leaf's gradient -> this rank's shard of the sum over
        ranks divided by the number of batch shards: reduce-scattered over
        the ranks with distinct shards, all-reduced over the ranks with
        copies."""
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
            self.reduce_scatter(local, send, pl.gather_axes)
            local = local.view(pl.local_shape)
        if pl.reduces_copies:
            self.all_reduce(local, pl.copy_axes)
        return local.div_(pl.grad_div)


class GatherParam(torch.autograd.Function):
    """A leaf's shard -> the gathered leaf (all-gather); its gradient -> the
    shard's (reduce-scatter, all-reduce over copies, / batch shards).
    ``wide``: the gathered leaf is an f32 carrier of its bf16 values (marked
    ``bf16_carrier``), whose f32 gradient is reduced in f32 and rounded to
    the leaf's dtype after the sum."""

    @staticmethod
    def forward(ctx, local, placement, groups, wide=False):
        ctx.placement, ctx.groups, ctx.dtype = placement, groups, local.dtype
        full = groups.gather_full(local, placement)
        if not wide:
            return full
        full = full.float()
        full.bf16_carrier = True
        return full

    @staticmethod
    def backward(ctx, grad):
        return ctx.groups.reduce_grad(grad, ctx.placement).to(ctx.dtype), None, None, None


#: leaves whose gradient's sum over the ``model`` row has at most one
#: addend per entry (an embedding's looked-up rows, a position table's, an
#: unsplit head seeded on one rank): exact in any dtype
ONE_ADDEND = ("embed", "enc_pos", "dec_pos", "lm_head")


def widens_grad(path: str, pl: LeafPlacement, dtype: torch.dtype, f32_partials: bool) -> bool:
    """Whether tensor-parallel compute with f32 partial sums gathers this
    leaf as an f32 carrier: a bf16 leaf whose gradient the ``model`` row sums
    from partial products (it is gathered over ``model``, or the row holds
    copies of it), but for :data:`ONE_ADDEND`."""
    return (f32_partials and dtype == torch.bfloat16
            and MODEL_AXIS in pl.gather_axes + pl.copy_axes
            and leaf_name(path) not in ONE_ADDEND)


class AllReduceMean(torch.autograd.Function):
    """The mean over ``axes`` (default: the world) of a tensor every rank
    holds; its gradient likewise."""

    @staticmethod
    def forward(ctx, x, groups, axes=None):
        ctx.groups, ctx.axes = groups, axes
        return _mean(x, groups, axes)

    @staticmethod
    def backward(ctx, grad):
        return _mean(grad, ctx.groups, ctx.axes), None, None


def _mean(x: torch.Tensor, groups: MeshGroups, axes=None) -> torch.Tensor:
    axes = groups.all_axes if axes is None else tuple(axes)
    y = x.contiguous().clone()
    if not groups.moves(axes):
        return y
    groups.all_reduce(y, axes)
    return y.div_(groups.size(axes))


# ---------------------------------------------------------------------------
# Tensor-parallel compute over the model axis
# ---------------------------------------------------------------------------


def _cols(x: torch.Tensor, m: int, r: int) -> torch.Tensor:
    n = x.shape[-1] // m
    return x[..., r * n:(r + 1) * n]


class _GatherLast(torch.autograd.Function):
    """(..., n) per rank -> (..., m·n), the ranks' blocks in order along the
    last dim (all-gather); backward, the reduce-scatter of the partial
    gradients.  ``wide``: the result is an f32 carrier of the gathered
    values and its gradient, f32 partial sums, is reduce-scattered in f32
    and rounded to x's dtype after the sum."""

    @staticmethod
    def forward(ctx, x, tp, wide=False):
        ctx.tp, ctx.dtype = tp, x.dtype
        y = tp._all_gather_last(x)
        return y.float() if wide else y

    @staticmethod
    def backward(ctx, g):
        return ctx.tp._reduce_scatter_last(g).to(ctx.dtype), None, None


class _ScatterLast(torch.autograd.Function):
    """(..., m·n) partial sums per rank -> (..., n), this rank's block of
    their sum (reduce-scatter); backward, the all-gather of the blocks'
    gradients."""

    @staticmethod
    def forward(ctx, y, tp):
        ctx.tp = tp
        return tp._reduce_scatter_last(y)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp._all_gather_last(g), None


class _ScatterCast(torch.autograd.Function):
    """f32 partial sums (the whole of D) per rank -> their sum in the
    residual stream's layout (a reduce-scatter in f32, or an all-reduce
    where D is whole on every rank), plus the bias once, cast to the
    model's dtype; backward, the gradient's all-gather in that dtype (where
    D is whole, the gradient itself: the row's, see
    :class:`_GatherWhole`), handed back as f32, and this rank's columns of
    the bias's (where D is whole, the first rank's)."""

    @staticmethod
    def forward(ctx, y, bias, tp):
        ctx.tp, ctx.has_bias = tp, bias is not None
        s = tp._reduce_scatter_last(y) if tp.d_sharded else tp._all_reduce(y)
        if bias is not None:
            ctx.bias_dtype, ctx.n = bias.dtype, bias.shape[0]
            s = s + tp.local(bias).float()
        return s.to(tp.dtype)

    @staticmethod
    def backward(ctx, g):
        tp = ctx.tp
        gy = (tp._all_gather_last(g) if tp.d_sharded else g).float()
        db = None
        if ctx.has_bias and ctx.needs_input_grad[1]:
            part = g.float().reshape(-1, g.shape[-1]).sum(0)
            db = torch.zeros(ctx.n, dtype=torch.float32, device=g.device)
            if tp.d_sharded:
                _cols(db, tp.m, tp.rank).copy_(part)
            elif tp.rank == 0:          # a whole stream's gradient is the row's: once
                db = part
            db = db.to(ctx.bias_dtype)
        return gy, db, None


class _SumOverModel(torch.autograd.Function):
    """The sum over the ``model`` row (all-reduce); backward, the sum of the
    partial gradients (all-reduce)."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return tp._all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp._all_reduce(g), None


class _GatherWhole(torch.autograd.Function):
    """A read of a residual stream whole on every rank (``model`` does not
    split D): forward, the stream itself (``wide``: an f32 carrier of its
    values); backward, the sum over the row of the ranks' partial input
    gradients (an all-reduce, in f32 for a carrier), rounded to x's dtype
    after it.  The stream's gradient is then the row's whole one on every
    rank (see :class:`_ReduceWhole`)."""

    @staticmethod
    def forward(ctx, x, tp, wide=False):
        ctx.tp, ctx.dtype = tp, x.dtype
        return x.float() if wide else x.clone()

    @staticmethod
    def backward(ctx, g):
        return ctx.tp._all_reduce(g).to(ctx.dtype), None, None


class _ReduceWhole(torch.autograd.Function):
    """A write of partial sums into a residual stream whole on every rank:
    forward, their sum over the row (an all-reduce); backward, the stream's
    gradient, which is already the row's whole one (:class:`_GatherWhole`
    sums each read's partial ones)."""

    @staticmethod
    def forward(ctx, y, tp):
        return tp._all_reduce(y)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Once(torch.autograd.Function):
    """A value every rank of the row holds alike, entering its gradient on
    the row's first rank only (its partial gradient: zero elsewhere);
    ``zero``: the value too is zero off the first rank."""

    @staticmethod
    def forward(ctx, x, first, zero):
        ctx.first = first
        return x.clone() if first or not zero else torch.zeros_like(x)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.first else torch.zeros_like(g)), None, None


class TensorParallel:
    """Tensor-parallel compute over the ``model`` axis of ``groups.mesh``
    for ``cfg`` (the reference's GSPMD layout, computed by hand).

    The residual stream keeps the reference's ``activation_sharding``,
    ``(fsdp, None, model)``: each rank holds D/m of its columns
    (``d_sharded``), or the whole of D where m does not divide it.  Each
    block all-gathers it along D before its norm (:meth:`gather`), runs its
    column-parallel products on local heads, d_ff slices, channels or
    experts, and reduce-scatters each row-parallel product's partial sums
    into it (:meth:`scatter`; an all-reduce where D is whole).  Where D is
    whole a read moves nothing forward, and its backward sums the ranks'
    partial input gradients (an all-reduce, f32 under ``f32_partials``), so
    the stream's gradient is the row's on every rank: a write's backward is
    then the identity, and a value every rank computes alike enters the
    stream once (:meth:`local`).  Embedding,
    head and loss are vocab-parallel where m > 1 divides the vocabulary
    (``vocab_parallel``), else whole on every rank.  ``q_local``,
    ``kv_local`` (:func:`~repro_torch.distributed.sharding.attn_heads_local`)
    and ``expert_parallel`` say how attention and MoE split.

    A ``model`` axis of size 1 moves nothing (``moves`` false: every
    method is the identity), at world 1 too: the residual stream is whole,
    and a gather's copy would sit between it and the norm that reads it,
    so an f32 stream's gradient would add the norm's terms in another
    order than the unsharded step does."""

    def __init__(self, groups: MeshGroups, cfg):
        mesh = groups.mesh
        self.groups, self.cfg = groups, cfg
        self.axes = (MODEL_AXIS,)
        self.m = mesh.shape[MODEL_AXIS]
        self.rank = groups.coords[MODEL_AXIS]
        self.moves = self.m > 1
        self.d_sharded = cfg.d_model % self.m == 0
        self.vocab_parallel = self.m > 1 and cfg.vocab_size % self.m == 0
        self.q_local, self.kv_local = attn_heads_local(cfg, mesh)
        self.expert_parallel = moe_expert_parallel(cfg, mesh)
        self.batch_axes = tuple(a for a in mesh.axis_names if a != MODEL_AXIS)
        self.dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
        #: every sum of partial products over model in f32 (bf16 at m > 1)
        self.f32_partials = self.moves and self.dtype != torch.float32
        #: the residual stream's reads ("gather") and writes ("scatter") so
        #: far (``distributed.context.block_io`` checks a block's)
        self.events: collections.Counter = collections.Counter()
        #: (shards, this rank's index, axes): the K/V caches' S split over the
        #: fsdp axes (a serving batch whose rows do not split over them), else
        #: None; set by the serving step
        self.kv_seq: tuple | None = None

    # -- the residual stream ----------------------------------------------------
    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The residual stream (this rank's D/m) -> the whole of D.  Under
        autograd with ``f32_partials`` the result is an f32 carrier of its
        values, whose gradient is reduce-scattered in f32 (where D is
        whole, all-reduced in f32: :class:`_GatherWhole`)."""
        self.events["gather"] += 1
        if not self.moves:
            return x
        grad = torch.is_grad_enabled() and x.requires_grad
        wide = self.f32_partials and grad
        if not self.d_sharded:          # whole on every rank: the sum is the backward's
            return _GatherWhole.apply(x, self, wide) if grad else x
        return _GatherLast.apply(x, self, wide)

    def scatter(self, y: torch.Tensor, bias: torch.Tensor | None = None) -> torch.Tensor:
        """A row-parallel product's partial sums (the whole of D) -> their
        sum in the residual stream's layout.  Partial sums in f32 under
        ``f32_partials`` are summed in f32, ``bias`` (the product's, whole)
        added once and the sum cast to the model's dtype; otherwise ``y`` is
        summed in its dtype (and a bias must already be in it, on the row's
        first rank: :meth:`first`)."""
        self.events["scatter"] += 1
        if not self.moves:
            return y
        if y.dtype != self.dtype:
            return _ScatterCast.apply(y, bias, self)
        if bias is not None:
            raise ValueError("a bias goes through the sum only with f32 partial sums")
        if self.d_sharded:
            return _ScatterLast.apply(y, self)
        return _ReduceWhole.apply(y, self)


    def local(self, x: torch.Tensor) -> torch.Tensor:
        """A value every rank of the row holds (the whole of D) -> its part
        in the residual stream's layout (no collective).  Where D is whole,
        the value itself, its gradient (the row's) taken on the first rank
        only, so a leaf the row holds copies of sums it once."""
        if self.d_sharded:
            return _cols(x, self.m, self.rank)
        return _Once.apply(x, self.rank == 0, False) if self.moves else x

    def cols(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the last dim of a value the row holds
        alike (a replicated leaf read at a local shard's columns)."""
        return _cols(x, self.m, self.rank)

    # -- the loss ---------------------------------------------------------------------
    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the row of each rank's ``x`` (forward and backward)."""
        return _SumOverModel.apply(x, self) if self.moves else x

    def max(self, x: torch.Tensor) -> torch.Tensor:
        """The max over the row (no gradient)."""
        y = x.detach().contiguous().clone()
        if self.moves:
            self.groups.all_reduce(y, self.axes, op=dist.ReduceOp.MAX)
        return y

    def once(self, x: torch.Tensor) -> torch.Tensor:
        """A value the row holds alike whose gradient must count once."""
        return _Once.apply(x, self.rank == 0, False)

    def first(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` on the row's first rank, zeros elsewhere (a bias a
        row-parallel product adds once), with the gradient likewise."""
        return _Once.apply(x, self.rank == 0, True)

    # -- a sharded cache at decode ---------------------------------------------------
    def gather_row(self, x: torch.Tensor) -> torch.Tensor:
        """A cache row stored at this rank's D/m columns (rwkv6's
        ``last_tm``/``last_cm``, ``cache_leaf_sharding``'s last dim over
        model) -> the whole row (an all-gather; no gradient)."""
        if not (self.moves and self.d_sharded):
            return x
        return self._all_gather_last(x)

    def gather_dim(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The ranks' blocks of ``x`` in order along ``dim`` (an all-gather;
        no gradient)."""
        if not self.moves:
            return x
        return self._all_gather_last(x.movedim(dim, -1)).movedim(-1, dim).contiguous()

    def seq_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``x`` summed (or its maximum, ``op`` "max") over the axes the K/V
        caches' S is split over (:attr:`kv_seq`; an all-reduce; no
        gradient)."""
        y = x.contiguous().clone()
        self.groups.all_reduce(y, self.kv_seq[2],
                               op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM)
        return y

    def sum_over_model(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of the ranks' ``x`` (an all-reduce; no gradient)."""
        if not self.moves:
            return x
        return self._all_reduce(x)

    # -- the collectives along the last dim -------------------------------------------
    def _all_gather_last(self, x: torch.Tensor) -> torch.Tensor:
        x = x.contiguous()
        out = torch.empty((self.m,) + tuple(x.shape), dtype=x.dtype, device=x.device)
        self.groups.all_gather(out.view(-1), x.view(-1), self.axes)
        return out.movedim(0, -2).reshape(*x.shape[:-1], self.m * x.shape[-1])

    def _reduce_scatter_last(self, y: torch.Tensor) -> torch.Tensor:
        n = y.shape[-1] // self.m
        send = y.reshape(*y.shape[:-1], self.m, n).movedim(-2, 0).contiguous()
        out = torch.empty(tuple(y.shape[:-1]) + (n,), dtype=y.dtype, device=y.device)
        self.groups.reduce_scatter(out.view(-1), send.view(-1), self.axes)
        return out

    def _all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        y = x.contiguous().clone()
        self.groups.all_reduce(y, self.axes)
        return y


def compute_placements(sharded: "ShardedTree", tp: TensorParallel) -> list[LeafPlacement]:
    """The placements a tree's leaves are gathered by under ``tp``: each
    leaf's ``model`` shard kept where
    :func:`~repro_torch.distributed.sharding.tp_keeps_local` says, every
    gradient divided by the number of batch shards."""
    mesh = sharded.groups.mesh
    shards = mesh.size // tp.m
    return [leaf_placement(pl.full_shape, pl.spec, mesh,
                           (MODEL_AXIS,) if tp_keeps_local(path, pl.spec, tp.cfg, mesh) else (),
                           shards)
            for (path, _), pl in zip(leaves_with_paths(sharded.like), sharded.placements)]


class ShardedTree:
    """One tree's placements on this rank: ``specs`` (a spec tree of the
    tree's structure, :func:`~repro_torch.distributed.sharding.param_shardings`)
    over full leaves shaped like ``like``'s.  ``tp``: the tensor-parallel
    compute its gathers serve (None: gathers give full leaves)."""

    def __init__(self, groups: MeshGroups, like: Any, specs: Any,
                 tp: TensorParallel | None = None):
        self.groups = groups
        self.like = tree_map(lambda t: torch.empty(tuple(t.shape), dtype=t.dtype, device="meta"),
                             like)
        self.placements = [groups.placement(tuple(t.shape), s)
                           for t, s in zip(leaves(like), flatten_up_to(specs, like))]
        self.tp = tp
        self.compute = compute_placements(self, tp) if tp is not None else self.placements

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
    through :class:`GatherParam` to its gathered value (under
    tensor-parallel compute, ``tp``, the rank's ``model`` shard where it
    stays local).  It knows a leaf by the tensor itself (the step updates
    its shards in place).  The batch is split into ``batch_shards`` distinct
    shards over the batch axes (the fsdp axes under tensor-parallel
    compute, every axis else)."""

    #: whether the MoE layers' load-balance means are taken over the batch
    #: (the aux loss; a serving step, which returns none, leaves them out)
    aux = True

    def __init__(self, sharded: ShardedTree, local: Any, batch_shards: int):
        self._keep = flatten_up_to(local, sharded.like)
        self._by_id = {id(t): pl for t, pl in zip(self._keep, sharded.compute)}
        self.groups = sharded.groups
        self.tp = sharded.tp
        f32_partials = self.tp is not None and self.tp.f32_partials
        self._wide = {id(t): widens_grad(path, pl, t.dtype, f32_partials)
                      for (path, _), t, pl in zip(leaves_with_paths(sharded.like), self._keep,
                                                  sharded.compute)}
        self.batch_shards = batch_shards
        self.batch_axes = self.tp.batch_axes if self.tp is not None else self.groups.all_axes

    def __call__(self, tree: Any) -> Any:
        def gather(t):
            wide = self._wide[id(t)] and torch.is_grad_enabled() and t.requires_grad
            return GatherParam.apply(t, self._by_id[id(t)], self.groups, wide)
        return tree_map(gather, tree)

    def batch_mean(self, x: torch.Tensor) -> torch.Tensor:
        """A mean over this rank's batch shard -> the mean over the global
        batch (every shard holds as many rows): :class:`AllReduceMean` over
        the batch axes."""
        return AllReduceMean.apply(x, self.groups, self.batch_axes)

    def batch_count(self, n: torch.Tensor) -> torch.Tensor:
        """This rank's share of a count over the global batch, from its
        shard's count ``n``: the global count over ``batch_shards``, at
        least 1 over it (a masked mean's divisor, floored at 1 as the
        reference floors it).  A shard's sum over it averages over the batch
        shards to the global batch's sum over the global count."""
        return torch.clamp(AllReduceMean.apply(n, self.groups, self.batch_axes),
                           min=1.0 / self.batch_shards)


# ---------------------------------------------------------------------------
# Context parallelism for prefill over the model axis
# ---------------------------------------------------------------------------


class SequenceParallel:
    """Context parallelism for prefill over the ``model`` axis of
    ``groups.mesh`` (the reference's ``activation_sharding(...,
    seq_parallel=True)``): the residual stream is ``(fsdp, model, None)``,
    this rank's ``local`` positions from ``offset`` with D whole, and every
    weight is gathered whole, so each rank runs whole-width products on its
    tokens.  S is laid out as GSPMD lays out a dim: blocks of ``block`` =
    ceil(S/m) positions in rank order, the last rank's shorter where m does
    not divide S; a layout that leaves a rank no position is refused.  What
    crosses ranks:

    * attention: each layer all-gathers K and V along S (:meth:`gather_seq`,
      two all-gathers of blocks padded to ``block``), and the rank's queries
      attend at ``q_offset = offset`` under the causal, window and softcap
      masks;
    * a token shift or a conv window reads the previous rank's last rows
      (:meth:`shift`, a ``collective_permute``);
    * a scan starts from the state the previous rank ends with
      (:meth:`handoff`): rank r waits for rank r - 1, so the ranks' scans
      run one after another (the design's cost), and a scan continued from
      its state gives one scan's bits;
    * the cache after prefill: the last rank's final states, each rank
      keeping its slice by ``cache_leaf_sharding`` (:meth:`from_last`, a
      reduce-scatter of the last rank's state and zeros elsewhere, exact);
      K/V caches from the gathered K and V, which hold the whole prompt;
    * the logits: the last real position's row on every rank
      (:meth:`row_at`, an all-reduce of that row and zeros elsewhere), each
      rank taking its vocabulary shard of the head where ``model`` splits
      the vocabulary (``logits_sharding``).

    An encoder's frames are a sequence of their own (:meth:`over`: the same
    ranks, another length).  The collectives are counted by
    ``groups.counter``.  No gradient: prefill."""

    def __init__(self, groups: MeshGroups, cfg, seq: int):
        self.groups, self.cfg = groups, cfg
        self.axes = (MODEL_AXIS,)
        self.m = groups.mesh.shape[MODEL_AXIS]
        self.rank = groups.coords[MODEL_AXIS]
        self.moves = self.m > 1
        self.seq, self.block = seq, -(-seq // self.m)
        last = seq - (self.m - 1) * self.block          # the last rank's, the fewest positions
        if last <= 0:
            raise ValueError(f"sequence parallelism lays S = {seq} out over model={self.m} in "
                             f"blocks of {self.block}: the last rank would hold no position")
        griffin = cfg.family != "ssm" and "R" in cfg.layer_kinds
        if griffin and self.moves and last < cfg.conv_width - 1:
            raise ValueError(f"sequence parallelism needs {cfg.conv_width - 1} positions a rank "
                             f"(the conv window); S = {seq} over model={self.m} leaves the last "
                             f"rank {last}")
        self.offset = self.rank * self.block
        self.local = min(seq, self.offset + self.block) - self.offset
        self.last = self.rank == self.m - 1
        self.vocab_parallel = self.moves and cfg.vocab_size % self.m == 0

    def head(self, w: torch.Tensor) -> torch.Tensor:
        """A whole LM head (D, V) -> this rank's vocabulary shard of it
        where ``model`` splits V (``logits_sharding``), else ``w``."""
        if not self.vocab_parallel:
            return w
        n = w.shape[1] // self.m
        return w[:, self.rank * n:(self.rank + 1) * n].contiguous()

    def over(self, seq: int) -> "SequenceParallel":
        """The same ranks over a sequence of ``seq`` positions (an encoder's
        frames)."""
        return SequenceParallel(self.groups, self.cfg, seq)

    def gather_seq(self, x: torch.Tensor, dim: int = 2) -> torch.Tensor:
        """The whole sequence of a per-rank ``x`` along ``dim`` (an
        all-gather over model of the blocks padded to ``block``, trimmed
        to S after it)."""
        if not self.moves:
            return x
        y = x.movedim(dim, 0)
        if y.shape[0] < self.block:
            y = torch.cat([y, y.new_zeros((self.block - y.shape[0],) + tuple(y.shape[1:]))])
        y = y.contiguous()
        out = torch.empty((self.m,) + tuple(y.shape), dtype=y.dtype, device=y.device)
        self.groups.all_gather(out.view(-1), y.view(-1), self.axes)
        out = out.reshape((self.m * self.block,) + tuple(y.shape[1:]))[:self.seq]
        return out.movedim(0, dim)

    def shift(self, rows: torch.Tensor, first: torch.Tensor) -> torch.Tensor:
        """The previous rank's ``rows`` (its last positions, (B, n, ...)):
        on the first rank, ``first`` (the cache's carry)."""
        if not self.moves:
            return first
        got = self.groups.permute(rows.contiguous(), MODEL_AXIS)
        return first if self.rank == 0 else got

    def handoff(self, run, state0: torch.Tensor):
        """``run(state)`` -> (out, final state) from the state the previous
        rank ends with (the first rank: ``state0``), its final state passed
        to the next rank.  Returns (out, final state)."""
        if not self.moves:
            return run(state0)
        g = self.groups
        state = g.permute(state0, MODEL_AXIS, send=False, count=False)   # waits for rank r - 1
        out, final = run(state0 if self.rank == 0 else state)
        g.permute(final, MODEL_AXIS, recv=False)
        return out, final

    def from_last(self, x: torch.Tensor, spec_entry_dim: int | None) -> torch.Tensor:
        """The last rank's ``x``, on every rank: this rank's block along
        ``spec_entry_dim`` (the cache's dim over model; None: whole)."""
        if not self.moves:
            return x
        mine = x if self.last else torch.zeros_like(x)
        if spec_entry_dim is None:
            y = mine.contiguous().clone()
            self.groups.all_reduce(y, self.axes)
            return y
        y = mine.movedim(spec_entry_dim, -1)
        n = y.shape[-1] // self.m
        send = y.reshape(*y.shape[:-1], self.m, n).movedim(-2, 0).contiguous()
        out = torch.empty(tuple(y.shape[:-1]) + (n,), dtype=y.dtype, device=y.device)
        self.groups.reduce_scatter(out.view(-1), send.view(-1), self.axes)
        return out.movedim(-1, spec_entry_dim).contiguous()

    def row_at(self, h: torch.Tensor, t: int) -> torch.Tensor:
        """The residual stream's row at global position ``t`` (B, 1, D), on
        every rank."""
        j = t - self.offset
        mine = 0 <= j < self.local
        row = h[:, j:j + 1] if mine else torch.zeros_like(h[:, :1])
        if not self.moves:
            return row
        row = row.contiguous().clone()
        self.groups.all_reduce(row, self.axes)
        return row
