"""Train-step builder (the counterpart of ``repro.launch.steps``'s
``make_train_step`` and ``init_opt_state``).

``make_train_step`` — loss → grads (torch autograd; on the card every
product's gradient comes from the kernels) → optional int8 gradient
compression with error feedback → AdamW.  The params are a model's params
(with a tied head's ``embed_t``); the optimizer state covers the trainable
ones (:func:`repro_torch.models.lm.trainable`), and ``embed_t`` is rebuilt
from ``embed`` after every update.  The params and the state are updated
in place, as the reference donates them to its jitted step.

``make_sharded_train_step`` — the same step over a process group
(:class:`ShardedTrainStep`): each rank holds its shards of the params and the
optimizer state by the reference's rules, computes the loss on its batch
shard on weights gathered one layer at a time, and updates its shards.
Under ``fsdp_tp`` the weights are gathered over the fsdp axes only and the
ranks of a ``model`` row compute tensor-parallel.

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
from repro_torch.distributed.collectives import (MODEL_AXIS, AllReduceMean, MeshGroups,
                                                 ParamGather, ShardedTree, TensorParallel,
                                                 axes_key, leaf_placement)
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
    world size (weights gathered per layer, gradients reduce-scattered).

    ``strategy``: ``"dp"`` — every leaf sharded over the whole mesh, the
    batch over every axis and every weight gathered whole (ZeRO-3, the
    reference's ``dp_only``); ``"fsdp_tp"`` — the reference's layout (FSDP
    over ``pod``/``data``, TP/EP dims over ``model``), the batch over the
    fsdp axes, and tensor-parallel compute over ``model``
    (:class:`~repro_torch.distributed.collectives.TensorParallel`): each
    leaf is gathered over the fsdp axes only, its ``model`` shard kept
    local, so a rank computes its heads, d_ff slices, channels, experts and
    vocabulary shard, and the residual stream between layers holds D/m
    columns (attention projections whose heads a shard would cut are
    gathered over ``model`` too: ``sharding.attn_heads_local``).  The
    gradient applied is Σ over ranks of each rank's gradient over the
    number of batch shards: each rank's is a mean over its batch shard,
    whole for a leaf it keeps local and a partial share (summed over the
    row) for one the row holds alike.  With a ``mask`` each rank divides
    its shard's masked sum by the global count (``ParamGather.batch_count``),
    so the loss is the global masked mean, as the unsharded step's.

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
        self.tp = None
        if not self.dp_only:
            shd.check_tensor_parallel(model.cfg, mesh)
            self.tp = TensorParallel(self.groups, model.cfg)
        self.params = ShardedTree(self.groups, like, self.specs, tp=self.tp)
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
        self.groups.all_reduce(sq, self.groups.all_axes)
        return torch.sqrt(sq)

    def plan(self, batch_shape: tuple[int, int], train: bool = True, by_axes: bool = False) -> dict:
        """:func:`plan_collectives` of this step on a global batch of
        ``batch_shape`` (B, S) tokens."""
        return plan_collectives(self.model.cfg, self.params.like, self.specs, self.mesh,
                                train=train, remat=self.remat, grad_accum=self.grad_accum,
                                compress_grads=self.compress_grads, strategy=self.strategy,
                                batch=batch_shape, by_axes=by_axes)

    def _max_over_ranks(self, v: torch.Tensor) -> torch.Tensor:
        v = v.contiguous().clone()
        self.groups.all_reduce(v, self.groups.all_axes, op=dist.ReduceOp.MAX)
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
                     remat: bool = True, grad_accum: int = 1, compress_grads: bool = False,
                     strategy: str = "dp", batch: tuple[int, int] | None = None,
                     by_axes: bool = False) -> dict:
    """The collectives one rank issues in one :class:`ShardedTrainStep` step
    (``train``), or in one forward under its param gather, read without a
    process group from the leaf placements its :class:`MeshGroups` takes
    (:func:`~repro_torch.distributed.collectives.leaf_placement`): per op the
    count, operand and result bytes, as ``CollectiveCounter.snapshot()``
    gives them (without the bytes per dtype; with the count per set of
    axes where ``by_axes``).  ``params``: the trainable params
    with full shapes (``meta`` will do), ``specs`` theirs.  ``strategy``:
    the step's; under ``fsdp_tp`` the leaves are gathered as tensor-parallel
    compute gathers them, and ``batch``, the global batch's (B, S) tokens,
    sizes the activations' collectives.  The batch is unmasked, as the
    trainer's and the reference's dry-run cells are.

    Per microbatch: each leaf whose gather moves (every leaf at world 1) is
    gathered, a layer's again under remat's recompute, and its gradient
    reduce-scattered; a gradient that ranks hold copies of is all-reduced
    over them; each MoE layer all-reduces its two load-balance means over
    the batch axes (again under the recompute) and the gradient of the one
    that has one.  Under ``fsdp_tp`` (:func:`_plan_tensor_parallel`) the
    residual stream's gathers and scatters, per layer and pass, and the
    vocab-parallel embedding, head and loss.  Once a step: the loss and its
    metrics, the gradient norm and, with ``compress_grads``, the leaves'
    max |g|."""
    stats: dict = {}

    def add(op: str, count: int, operand: int, result: int, axes) -> None:
        s = stats.setdefault(op, {"count": 0, "operand_bytes": 0, "result_bytes": 0, "axes": {}})
        s["count"] += count
        s["operand_bytes"] += count * operand
        s["result_bytes"] += count * result
        key = axes_key(axes)
        s["axes"][key] = s["axes"].get(key, 0) + count

    tp = strategy == "fsdp_tp"
    shards = mesh.size // (mesh.shape[MODEL_AXIS] if tp else 1)
    recompute = train and remat
    n_leaves = 0
    for (path, leaf), spec in zip(leaves_with_paths(params), flatten_up_to(specs, params)):
        n_leaves += 1
        local_axes = (MODEL_AXIS,) if tp and shd.tp_keeps_local(path, spec, cfg, mesh) else ()
        pl = leaf_placement(tuple(leaf.shape), spec, mesh, local_axes, shards)
        local = math.prod(pl.local_shape) * leaf.element_size()
        layer = path.split("]")[0].strip("['") in LAYER_KEYS
        if pl.gathers:
            add("all_gather", (2 if recompute and layer else 1) * grad_accum, local,
                pl.gather_size * local, pl.gather_axes)
            if train:
                add("reduce_scatter", grad_accum, pl.gather_size * local, local, pl.gather_axes)
        if train and pl.reduces_copies:
            add("all_reduce", grad_accum, local, local, pl.copy_axes)
    everything = tuple(mesh.axis_names)
    batch_axes = tuple(a for a in everything if not (tp and a == MODEL_AXIS))
    moe_layers = sum(uses_moe(cfg, kind) for kind in cfg.layer_kinds)
    if moe_layers and (math.prod(mesh.shape[a] for a in batch_axes) > 1 or mesh.size == 1):
        per_layer = (4 if recompute else 2) + (1 if train else 0)
        add("all_reduce", moe_layers * per_layer * grad_accum, 4 * cfg.n_experts,
            4 * cfg.n_experts, batch_axes)
    if tp and mesh.shape[MODEL_AXIS] > 1:
        if batch is None:
            raise ValueError("the plan of a tensor-parallel step needs the batch's (B, S)")
        _plan_tensor_parallel(add, cfg, mesh, batch, shards, train=train, recompute=recompute,
                              grad_accum=grad_accum)
    if train:
        add("all_reduce", 1, 4 * (1 + LOSS_METRICS), 4 * (1 + LOSS_METRICS), everything)
        add("all_reduce", 1, 4, 4, everything)        # the gradient norm's sum of squares
        if compress_grads:
            add("all_reduce", 1, 4 * n_leaves, 4 * n_leaves, everything)
    if not by_axes:
        for v in stats.values():
            del v["axes"]
    stats["total_operand_bytes"] = sum(v["operand_bytes"] for v in stats.values())
    return stats


def _plan_tensor_parallel(add, cfg: ArchConfig, mesh, batch: tuple[int, int], shards: int, *,
                          train: bool, recompute: bool, grad_accum: int) -> None:
    """The activations' collectives of tensor-parallel compute
    (:class:`~repro_torch.distributed.collectives.TensorParallel`), per
    microbatch of ``batch[0] // grad_accum`` rows, ``shards`` batch shards.
    Each block reads the residual stream through an all-gather along D
    before each norm and writes each row-parallel product back through a
    reduce-scatter (an all-reduce where m does not divide D): two of each a
    decoder-only or encoder layer, three a whisper decoder layer, in the
    forward, again in the recompute, and their duals in the backward.
    Once: the vocab-parallel embedding's reduce-scatter, the final norm's
    gather (whisper: the encoder output's too), their duals, and the loss's
    all-reduces (the max, then the sum of exponentials with the target's
    logit, and that sum's dual)."""
    m, model = mesh.shape[MODEL_AXIS], (MODEL_AXIS,)
    rows = batch[0] // grad_accum // shards
    seq = batch[1]
    act = 2 if cfg.dtype == "bfloat16" else 4
    d_sharded = cfg.d_model % m == 0
    vocab_parallel = m > 1 and cfg.vocab_size % m == 0

    def gather(tokens: int, count: int, passes: int) -> None:
        """``count`` reads of the residual stream over ``tokens`` tokens."""
        full = tokens * cfg.d_model * act
        if d_sharded:
            add("all_gather", count * passes * grad_accum, full // m, full, model)
            if train:
                add("reduce_scatter", count * grad_accum, full, full // m, model)

    def scatter(tokens: int, count: int, passes: int) -> None:
        """``count`` writes of partial sums into the residual stream."""
        full = tokens * cfg.d_model * act
        if d_sharded:
            add("reduce_scatter", count * passes * grad_accum, full, full // m, model)
            if train:
                add("all_gather", count * grad_accum, full // m, full, model)
        else:
            add("all_reduce", count * (passes + (1 if train else 0)) * grad_accum, full, full,
                model)

    layer_passes = 2 if recompute else 1
    text = rows * seq
    if cfg.family == "audio":
        enc = rows * cfg.encoder_seq
        gather(enc, 2 * cfg.encoder_layers, layer_passes)
        scatter(enc, 2 * cfg.encoder_layers, layer_passes)
        gather(enc, 1, 1)                             # the encoder's output, whole
        gather(text, 3 * cfg.n_layers, layer_passes)
        scatter(text, 3 * cfg.n_layers, layer_passes)
        predicted = rows * (seq - 1)
        tokens = text
    else:
        tokens = rows * (seq + cfg.vision_tokens)
        gather(tokens, 2 * cfg.n_layers, layer_passes)
        scatter(tokens, 2 * cfg.n_layers, layer_passes)
        predicted = rows * (seq if cfg.vision_tokens else seq - 1)
    if vocab_parallel:
        scatter(text, 1, 1)                           # the embedding's lookup
    gather(tokens, 1, 1)                              # the final norm's input
    if train and vocab_parallel:
        add("all_reduce", grad_accum, 4 * predicted, 4 * predicted, model)
        add("all_reduce", 2 * grad_accum, 8 * predicted, 8 * predicted, model)


def init_opt_state(params: Any, *, compress_grads: bool = False) -> dict:
    """AdamW state over the trainable params (and error-feedback residuals)."""
    train = trainable(params)
    state = adamw.init_state(train)
    if compress_grads:
        state["residuals"] = compression.init_residuals(train)
    return state
