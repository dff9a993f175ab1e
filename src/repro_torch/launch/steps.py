"""Train-step builder (the counterpart of ``repro.launch.steps``'s
``make_train_step`` and ``init_opt_state``).

``make_train_step`` — loss → grads (torch autograd; on the card every
product's gradient comes from the kernels) → optional int8 gradient
compression with error feedback → AdamW.  The params are a model's params
(with a tied head's ``embed_t``); the optimizer state covers the trainable
ones (:func:`repro_torch.models.lm.trainable`), and ``embed_t`` is rebuilt
from ``embed`` after every update.  The params and the state are updated
in place, as the reference donates them to its jitted step.

``make_sharded_train_step`` — the same step over a process group (ZeRO-3,
:class:`ShardedTrainStep`): each rank holds its shards of the params and the
optimizer state by the reference's rules, computes the loss on its batch
shard on weights gathered one layer at a time, and updates its shards.

The prefill and decode steps of the reference are the model's own entry
points here (``Model.prefill``, ``Model.decode_step``).
"""
from __future__ import annotations

import math
from typing import Any, Callable

import torch

import torch.distributed as dist

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.collectives import (AllReduceMean, MeshGroups, ParamGather,
                                                 ShardedTree, leaf_placement)
from repro_torch.distributed.context import gathered_params
from repro_torch.models.build import Model
from repro_torch.models.lm import LAYER_KEYS, retie, trainable, uses_moe
from repro_torch.optim import adamw, compression
from repro_torch.tree import flatten_up_to, leaves, leaves_with_paths, tree_map, unflatten

#: --strategy: "dp" shards every leaf over the whole mesh (the reference's
#: dp_only), "fsdp_tp" takes the reference's FSDP + TP layout
STRATEGIES = ("dp", "fsdp_tp")


def value_and_grad(model: Model, params: dict, batch: dict, *, remat: bool = True,
                   provider=None) -> tuple[torch.Tensor, dict, dict]:
    """(loss, metrics, grads): grads of the trainable params, a tree of
    their structure (zeros for a param the loss does not reach), each
    contiguous (a tied embedding's comes out of the head transposed)."""
    train = trainable(params)
    flat = leaves(train)
    for p in flat:
        p.requires_grad_(True)
    try:
        loss, metrics = model.loss_fn(params, batch, remat=remat, provider=provider)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    finally:
        for p in flat:
            p.requires_grad_(False)
    # contiguous: the norm and the int8 scale reduce over each leaf in its
    # memory order, and a sharded step's gradients are contiguous
    grads = [torch.zeros_like(p) if g is None else g.contiguous() for g, p in zip(grads, flat)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, unflatten(train, grads)


def make_train_step(model: Model, opt_cfg: adamw.AdamWConfig, *, grad_accum: int = 1,
                    compress_grads: bool = False, remat: bool = True,
                    provider=None) -> Callable:
    """Returns train_step(params, opt_state, batch) -> (params, opt_state, metrics).

    grad_accum > 1 splits the batch into microbatches along the batch axis
    and accumulates grads / grad_accum in f32, one microbatch after another;
    the loss is the microbatches' mean and the other metrics the last
    microbatch's, as the reference's scan leaves them.  ``provider``: the
    schedule provider of the forward's kernel launches (None: the process
    default); the backward's launches take their default schedules."""

    def train_step(params, opt_state, batch):
        val, metrics, grads = _grads_of(model, params, batch, grad_accum, remat, provider)
        train = trainable(params)
        if compress_grads:
            grads, residuals = compression.compressed_gradients(grads, opt_state["residuals"])
            inner = {k: v for k, v in opt_state.items() if k != "residuals"}
            _, inner, om = adamw.apply_updates(train, grads, inner, opt_cfg)
            opt_state.update(inner, residuals=residuals)
        else:
            _, opt_state, om = adamw.apply_updates(train, grads, opt_state, opt_cfg)
        retie(params)
        return params, opt_state, {**metrics, **om, "loss": val}

    return train_step


def _grads_of(model: Model, params: dict, batch: dict, grad_accum: int, remat: bool,
              provider, shard=None) -> tuple[torch.Tensor, dict, dict]:
    """(loss, metrics, grads) of one batch, over ``grad_accum`` microbatches.
    ``shard``: this rank's shard of a microbatch (sharded training: each
    rank takes its shard of every microbatch of the global batch)."""
    shard = shard or (lambda mb: mb)
    if grad_accum <= 1:
        return value_and_grad(model, params, shard(batch), remat=remat, provider=provider)
    acc, vals, metrics = None, [], None
    for i in range(grad_accum):
        mb = shard({k: v.reshape(grad_accum, v.shape[0] // grad_accum, *v.shape[1:])[i]
                    for k, v in batch.items()})
        val, metrics, grads = value_and_grad(model, params, mb, remat=remat, provider=provider)
        g = leaves(grads)
        acc = ([gi.float() / grad_accum for gi in g] if acc is None
               else [a + gi.float() / grad_accum for a, gi in zip(acc, g)])
        vals.append(val)
    return torch.stack(vals).mean(), metrics, unflatten(grads, acc)


class ShardedTrainStep:
    """The train step over the default process group, on a ``mesh`` of its
    world size (ZeRO-3: weights gathered per layer, gradients
    reduce-scattered).

    ``strategy``: ``"dp"`` — every leaf sharded over the whole mesh, the
    batch over every axis (the reference's ``dp_only``); ``"fsdp_tp"`` — the
    reference's layout (FSDP over ``pod``/``data``, TP/EP dims over
    ``model``) and the batch over the fsdp axes.  Compute is gathered under
    both: under ``fsdp_tp`` the ranks of one ``model`` row compute the same
    batch shard on the same full weights (tensor-parallel compute is not
    realised, ROADMAP A.9b).  The gradient is (1/world)·Σ over ranks of
    each rank's gradient (a mean over its batch shard), which is the global
    batch's gradient when the model axis duplicates shards.  With a
    ``mask`` each rank divides its shard's masked sum by the global count
    (``ParamGather.batch_count``), so the loss is the global masked mean,
    as the unsharded step's.

    ``__call__(params, opt_state, batch)`` takes this rank's shards
    (:meth:`shard_params`, :meth:`init_opt_state`) and the global batch,
    whose batch dim must split over the batch axes; it updates the shards
    in place and returns them with the metrics (loss, ce and aux averaged
    over ranks).  ``grad_accum`` splits the global batch into microbatches,
    as the unsharded step does, and each rank takes its shard of each; with
    ``compress_grads`` each shard takes its leaf's int8 scale.  A tied
    head's ``embed_t`` is no shard: the forward rebuilds it from the
    gathered ``embed``.  The collectives are counted in
    ``groups.counter``."""

    def __init__(self, model: Model, opt_cfg: adamw.AdamWConfig, mesh,
                 groups: MeshGroups | None = None, strategy: str = "dp", *,
                 grad_accum: int = 1, compress_grads: bool = False, remat: bool = True,
                 provider=None):
        if strategy not in STRATEGIES:
            raise ValueError(f"strategy must be one of {STRATEGIES}, got {strategy!r}")
        self.model, self.opt_cfg, self.mesh = model, opt_cfg, mesh
        self.groups = groups if groups is not None else MeshGroups(mesh)
        self.strategy, self.dp_only = strategy, strategy == "dp"
        self.grad_accum, self.compress_grads = grad_accum, compress_grads
        self.remat, self.provider = remat, provider
        like = trainable(model.abstract_params())
        self.specs = shd.param_shardings(like, model.cfg, mesh, self.dp_only)
        self.params = ShardedTree(self.groups, like, self.specs)
        self._copies = [self.groups.size(pl.copy_axes) for pl in self.params.placements]

    # -- state ---------------------------------------------------------------
    def shard_params(self, params: dict) -> dict:
        """This rank's shards of a model's full params (``embed_t`` left out)."""
        return self.params.shard(trainable(params))

    def init_opt_state(self, params: dict) -> dict:
        """AdamW state over this rank's shards (and error-feedback residuals)."""
        return init_opt_state(params, compress_grads=self.compress_grads)

    def state_sharded(self, opt_state: dict) -> ShardedTree:
        """The placements of a {"params", "opt"} bundle of this step's
        shards (checkpoints, :func:`~repro_torch.distributed.fault.
        elastic_restore`)."""
        f32 = tree_map(lambda t: torch.empty(tuple(t.shape), dtype=torch.float32, device="meta"),
                       self.params.like)
        like = {"m": f32, "v": f32, "master": f32,
                "step": torch.empty((), dtype=torch.int32, device="meta")}
        if "residuals" in opt_state:
            like["residuals"] = f32
        return ShardedTree(self.groups, {"params": self.params.like, "opt": like},
                           {"params": self.specs,
                            "opt": shd.opt_state_shardings(self.specs, opt_state)})

    def batch_shard(self, batch: dict) -> dict:
        """This rank's shard of a global batch (``batch_shardings``)."""
        specs = shd.batch_shardings(batch, self.model.cfg, self.mesh, self.dp_only)
        out = {}
        for k, v in batch.items():
            spec = specs[k]
            if spec[0] is None and self.groups.size(self.batch_axes) > 1:
                raise ValueError(f"batch {k!r} of {tuple(v.shape)} does not split over the "
                                 f"batch axes {self.batch_axes} of a {self.mesh.name} mesh")
            out[k] = shd.shard_leaf(v, spec[:1] + (None,) * (v.dim() - 1), self.mesh,
                                    self.groups.coords)
        return out

    @property
    def batch_axes(self) -> tuple[str, ...]:
        return shd.all_axes(self.mesh) if self.dp_only else shd.fsdp_axes(self.mesh)

    # -- the step ----------------------------------------------------------------
    def global_norm(self, grads: dict) -> torch.Tensor:
        """The global gradient norm from this rank's shards: each leaf's
        sum of squares over the ranks holding distinct shards (copies
        weighted 1/copies), summed over the world."""
        sq = sum(torch.sum(torch.square(g.float())) / c
                 for g, c in zip(leaves(grads), self._copies))
        self.groups.all_reduce(sq, dist.group.WORLD)
        return torch.sqrt(sq)

    def _max_over_ranks(self, v: torch.Tensor) -> torch.Tensor:
        v = v.contiguous().clone()
        self.groups.all_reduce(v, dist.group.WORLD, op=dist.ReduceOp.MAX)
        return v

    def __call__(self, params: dict, opt_state: dict, batch: dict):
        gather = ParamGather(self.params, params, self.groups.size(self.batch_axes))
        with gathered_params(gather):
            val, metrics, grads = _grads_of(self.model, params, batch, self.grad_accum,
                                            self.remat, self.provider, shard=self.batch_shard)
        names = sorted(metrics)
        means = AllReduceMean.apply(torch.stack([val] + [metrics[k] for k in names]),
                                    self.groups).unbind()
        val, metrics = means[0], dict(zip(names, means[1:]))
        if self.compress_grads:
            grads, residuals = compression.compressed_gradients(
                grads, opt_state["residuals"], reduce_max=self._max_over_ranks)
            inner = {k: v for k, v in opt_state.items() if k != "residuals"}
            _, inner, om = adamw.apply_updates(params, grads, inner, self.opt_cfg,
                                               gnorm=self.global_norm(grads))
            opt_state.update(inner, residuals=residuals)
        else:
            _, opt_state, om = adamw.apply_updates(params, grads, opt_state, self.opt_cfg,
                                                   gnorm=self.global_norm(grads))
        return params, opt_state, {**metrics, **om, "loss": val}


def make_sharded_train_step(model: Model, opt_cfg: adamw.AdamWConfig, mesh,
                            groups: MeshGroups | None = None, strategy: str = "dp",
                            **kw) -> ShardedTrainStep:
    """The sharded counterpart of :func:`make_train_step`
    (:class:`ShardedTrainStep`)."""
    return ShardedTrainStep(model, opt_cfg, mesh, groups, strategy, **kw)


#: the metrics ``Model.loss_fn`` returns beside the loss (ce, aux), which the
#: sharded step all-reduces with the loss in one f32 stack
LOSS_METRICS = 2


def plan_collectives(cfg: ArchConfig, params: Any, specs: Any, mesh, *, train: bool = True,
                     remat: bool = True, grad_accum: int = 1,
                     compress_grads: bool = False) -> dict:
    """The collectives one rank issues in one :class:`ShardedTrainStep` step
    (``train``), or in one forward under its param gather, read without a
    process group from the leaf placements its :class:`MeshGroups` takes
    (:func:`~repro_torch.distributed.collectives.leaf_placement`): per op the
    count, operand and result bytes, as ``CollectiveCounter.snapshot()``
    gives them (without the bytes per dtype).  ``params``: the trainable
    params with full shapes (``meta`` will do), ``specs`` theirs.  The batch
    is unmasked, as the trainer's and the reference's dry-run cells are.

    Per microbatch: each leaf whose shards differ (every leaf at world 1)
    is gathered, a layer's again under remat's recompute, and its gradient
    reduce-scattered; a gradient that ranks hold copies of is all-reduced
    over them; each MoE layer all-reduces its two load-balance means (again
    under the recompute) and the gradient of the one that has one.  Once a
    step: the loss and its metrics, the gradient norm and, with
    ``compress_grads``, the leaves' max |g|."""
    stats: dict = {}

    def add(op: str, count: int, operand: int, result: int) -> None:
        s = stats.setdefault(op, {"count": 0, "operand_bytes": 0, "result_bytes": 0})
        s["count"] += count
        s["operand_bytes"] += count * operand
        s["result_bytes"] += count * result

    recompute = train and remat
    n_leaves = 0
    for (path, leaf), spec in zip(leaves_with_paths(params), flatten_up_to(specs, params)):
        n_leaves += 1
        pl = leaf_placement(tuple(leaf.shape), spec, mesh)
        local = math.prod(pl.local_shape) * leaf.element_size()
        layer = path.split("]")[0].strip("['") in LAYER_KEYS
        if pl.gathers:
            add("all_gather", (2 if recompute and layer else 1) * grad_accum, local,
                pl.gather_size * local)
            if train:
                add("reduce_scatter", grad_accum, pl.gather_size * local, local)
        if train and pl.reduces_copies:
            add("all_reduce", grad_accum, local, local)
    moe_layers = sum(uses_moe(cfg, kind) for kind in cfg.layer_kinds)
    if moe_layers:
        per_layer = (4 if recompute else 2) + (1 if train else 0)
        add("all_reduce", moe_layers * per_layer * grad_accum, 4 * cfg.n_experts,
            4 * cfg.n_experts)
    if train:
        add("all_reduce", 1, 4 * (1 + LOSS_METRICS), 4 * (1 + LOSS_METRICS))
        add("all_reduce", 1, 4, 4)                    # the gradient norm's sum of squares
        if compress_grads:
            add("all_reduce", 1, 4 * n_leaves, 4 * n_leaves)
    stats["total_operand_bytes"] = sum(v["operand_bytes"] for v in stats.values())
    return stats


def init_opt_state(params: Any, *, compress_grads: bool = False) -> dict:
    """AdamW state over the trainable params (and error-feedback residuals)."""
    train = trainable(params)
    state = adamw.init_state(train)
    if compress_grads:
        state["residuals"] = compression.init_residuals(train)
    return state
