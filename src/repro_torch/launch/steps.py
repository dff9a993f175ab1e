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
``make_sharded_serve_step`` runs them over a process group
(:class:`ShardedServeStep`), as the reference's are jitted under
``param_shardings``, ``batch_shardings`` and ``activation_sharding``:
under ``fsdp_tp`` (prefill and decode) or with a prefill's S split over
``model`` (``seq_parallel``).

:func:`plan_collectives` and :func:`plan_serve` count the collectives a
step issues from the placements it takes, without a process group; the
residual stream's from the one declaration the models are checked against
(``distributed.context.RESIDUAL_IO``).
"""
from __future__ import annotations

import math
from typing import Any, Callable

import torch

import torch.distributed as dist

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.collectives import (MODEL_AXIS, AllReduceMean, MeshGroups,
                                                 ParamGather, SequenceParallel, ShardedTree,
                                                 TensorParallel, axes_key, leaf_placement,
                                                 widens_grad)
from repro_torch.distributed.context import (RESIDUAL_IO, gathered_params, sequence_parallel,
                                             sharded_cache)
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
    stats, add = _collector()
    tp = strategy == "fsdp_tp"
    shards = mesh.size // (mesh.shape[MODEL_AXIS] if tp else 1)
    recompute = train and remat
    n_leaves = _plan_param_gathers(add, cfg, params, specs, mesh, tp=tp, train=train,
                                   recompute=recompute, grad_accum=grad_accum)
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
    return _finish(stats, by_axes)


def _collector() -> tuple[dict, Callable]:
    """(stats, add): ``add(op, count, operand bytes, result bytes, axes)``
    counts ``count`` collectives of one kind into ``stats``, as
    ``CollectiveCounter`` counts them."""
    stats: dict = {}

    def add(op: str, count: int, operand: int, result: int, axes) -> None:
        if count == 0:
            return
        s = stats.setdefault(op, {"count": 0, "operand_bytes": 0, "result_bytes": 0, "axes": {}})
        s["count"] += count
        s["operand_bytes"] += count * operand
        s["result_bytes"] += count * result
        key = axes_key(axes)
        s["axes"][key] = s["axes"].get(key, 0) + count

    return stats, add


def _finish(stats: dict, by_axes: bool) -> dict:
    """The plan as ``CollectiveCounter.snapshot()`` gives it (the counts per
    set of axes where ``by_axes``)."""
    if not by_axes:
        for v in stats.values():
            del v["axes"]
    stats["total_operand_bytes"] = sum(v["operand_bytes"] for v in stats.values())
    return stats


def _plan_param_gathers(add, cfg: ArchConfig, params: Any, specs: Any, mesh, *, tp: bool,
                        train: bool, recompute: bool, grad_accum: int = 1,
                        keep=lambda path: True) -> int:
    """Each leaf's gather (a layer's again under the recompute) and, in a
    train step, its gradient's reduce-scatter and all-reduce over copies
    (in f32 for a leaf tensor-parallel compute widens:
    ``collectives.widens_grad``); ``tp``: each leaf's ``model`` shard kept
    where tensor-parallel compute keeps it; ``keep(path)``: the leaves
    gathered.  Returns the number of leaves."""
    shards = mesh.size // (mesh.shape[MODEL_AXIS] if tp else 1)
    f32_partials = tp and mesh.shape[MODEL_AXIS] > 1 and cfg.dtype == "bfloat16"
    n_leaves = 0
    for (path, leaf), spec in zip(leaves_with_paths(params), flatten_up_to(specs, params)):
        n_leaves += 1
        if not keep(path):
            continue
        local_axes = (MODEL_AXIS,) if tp and shd.tp_keeps_local(path, spec, cfg, mesh) else ()
        pl = leaf_placement(tuple(leaf.shape), spec, mesh, local_axes, shards)
        n = math.prod(pl.local_shape)
        local = n * leaf.element_size()
        grad = n * (4 if widens_grad(path, pl, leaf.dtype, f32_partials) else leaf.element_size())
        layer = path.split("]")[0].strip("['") in LAYER_KEYS
        if pl.gathers:
            add("all_gather", (2 if recompute and layer else 1) * grad_accum, local,
                pl.gather_size * local, pl.gather_axes)
            if train:
                add("reduce_scatter", grad_accum, pl.gather_size * grad, grad, pl.gather_axes)
        if train and pl.reduces_copies:
            add("all_reduce", grad_accum, grad, grad, pl.copy_axes)
    return n_leaves


def block_kinds(cfg: ArchConfig) -> list[tuple[str, str]]:
    """Each layer's :data:`~repro_torch.distributed.context.RESIDUAL_IO`
    kind and the stack it runs in (``"encoder"`` or ``"decoder"``), in
    order."""
    if cfg.family == "audio":
        return [("mixer_ffn", "encoder")] * cfg.encoder_layers + [("cross", "decoder")] * cfg.n_layers
    return [("rwkv" if k == "R" and cfg.family == "ssm" else "mixer_ffn", "decoder")
            for k in cfg.layer_kinds]


class _ResidualPlan:
    """The residual stream's collectives of tensor-parallel compute over
    ``model`` for ``cfg`` on ``mesh``
    (:class:`~repro_torch.distributed.collectives.TensorParallel`):
    :meth:`gather` reads it (an all-gather along D), :meth:`scatter` writes
    partial sums into it (a reduce-scatter, an all-reduce where ``model``
    does not split D).  A write's partial sums are f32 (bf16 compute sums
    them in f32); ``train`` adds each one's dual (an all-gather of the
    gradient, a reduce-scatter of the f32 partial gradients of an f32
    carrier in bf16; where D is whole, a read's dual alone, an all-reduce
    of f32 partial gradients)."""

    def __init__(self, add, cfg: ArchConfig, mesh, *, train: bool, grad_accum: int = 1):
        self.add, self.cfg, self.train, self.grad_accum = add, cfg, train, grad_accum
        self.m, self.model = mesh.shape[MODEL_AXIS], (MODEL_AXIS,)
        self.act = 2 if cfg.dtype == "bfloat16" else 4
        self.d_sharded = cfg.d_model % self.m == 0

    def gather(self, tokens: int, count: int, passes: int = 1) -> None:
        """``count`` reads of the residual stream over ``tokens`` tokens
        (where ``model`` does not split D, a read moves nothing forward and
        its dual sums the partial input gradients: an all-reduce in f32)."""
        if self.m == 1:
            return
        full = tokens * self.cfg.d_model
        n = count * self.grad_accum
        if not self.d_sharded:
            if self.train:
                self.add("all_reduce", n, full * 4, full * 4, self.model)
            return
        self.add("all_gather", n * passes, full // self.m * self.act, full * self.act,
                 self.model)
        if self.train:
            self.add("reduce_scatter", n, full * 4, full // self.m * 4, self.model)

    def scatter(self, tokens: int, count: int, passes: int = 1, elem: int = 4) -> None:
        """``count`` writes of partial sums (``elem`` bytes each: f32, or the
        embedding lookup's, in the model's dtype) over ``tokens`` tokens."""
        if self.m == 1:
            return
        full = tokens * self.cfg.d_model
        n = count * self.grad_accum
        if self.d_sharded:
            self.add("reduce_scatter", n * passes, full * elem, full // self.m * elem, self.model)
            if self.train:
                self.add("all_gather", n, full // self.m * self.act, full * self.act, self.model)
        else:           # its dual: none, the stream's gradient is the row's (see gather)
            self.add("all_reduce", n * passes, full * elem, full * elem, self.model)

    def blocks(self, tokens: dict, passes: int = 1) -> None:
        """Every layer's reads and writes (:data:`~repro_torch.distributed.
        context.RESIDUAL_IO`), ``tokens`` per stack that runs."""
        for kind, stack in block_kinds(self.cfg):
            if stack not in tokens:
                continue
            self.gather(tokens[stack], RESIDUAL_IO[kind], passes)
            self.scatter(tokens[stack], RESIDUAL_IO[kind], passes)


def _plan_tensor_parallel(add, cfg: ArchConfig, mesh, batch: tuple[int, int], shards: int, *,
                          train: bool, recompute: bool, grad_accum: int) -> None:
    """The activations' collectives of tensor-parallel compute
    (:class:`_ResidualPlan`), per microbatch of ``batch[0] // grad_accum``
    rows, ``shards`` batch shards: each layer's reads and writes of the
    residual stream in the forward, again in the recompute, and their duals
    in the backward.  Once: the vocab-parallel embedding's reduce-scatter,
    the final norm's gather (whisper: the encoder output's too), their
    duals, and the loss's all-reduces (the max, then the sum of
    exponentials with the target's logit, and that sum's dual)."""
    m, model = mesh.shape[MODEL_AXIS], (MODEL_AXIS,)
    rows = batch[0] // grad_accum // shards
    seq = batch[1]
    vocab_parallel = m > 1 and cfg.vocab_size % m == 0
    plan = _ResidualPlan(add, cfg, mesh, train=train, grad_accum=grad_accum)
    text = rows * seq
    if cfg.family == "audio":
        enc = rows * cfg.encoder_seq
        plan.blocks({"encoder": enc, "decoder": text}, 2 if recompute else 1)
        plan.gather(enc, 1)                           # the encoder's output, whole
        predicted = rows * (seq - 1)
        tokens = text
    else:
        tokens = rows * (seq + cfg.vision_tokens)
        plan.blocks({"decoder": tokens}, 2 if recompute else 1)
        predicted = rows * (seq if cfg.vision_tokens else seq - 1)
    if vocab_parallel:
        plan.scatter(text, 1, elem=plan.act)          # the embedding's lookup
    plan.gather(tokens, 1)                            # the final norm's input
    if train and vocab_parallel:
        add("all_reduce", grad_accum, 4 * predicted, 4 * predicted, model)
        add("all_reduce", 2 * grad_accum, 8 * predicted, 8 * predicted, model)


# ---------------------------------------------------------------------------
# Sharded serving
# ---------------------------------------------------------------------------


class CacheLayout:
    """This rank's shards of a serving cache: each leaf of the cache of the
    global batch (``row_shards`` times a rank's rows: the fsdp axes' size,
    or 1 where the rows do not split over them) laid out by
    ``cache_leaf_sharding`` (``distributed.context.sharded_cache``: the
    models' ``init_cache`` calls it)."""

    def __init__(self, cfg: ArchConfig, mesh, row_shards: int):
        self.cfg, self.mesh, self.row_shards = cfg, mesh, row_shards

    def specs(self, like: Any) -> list:
        return [shd.cache_leaf_sharding(path, tuple(t.shape), self.cfg, self.mesh)
                for path, t in leaves_with_paths(like)]

    def __call__(self, build: Callable, batch: int, device) -> Any:
        like = build(batch * self.row_shards, "meta")
        return unflatten(like, [torch.zeros(shd.local_shape(tuple(t.shape), spec, self.mesh),
                                            dtype=t.dtype, device=device)
                                for t, spec in zip(leaves(like), self.specs(like))])

    def tree(self, groups: MeshGroups, like: Any) -> ShardedTree:
        """The cache's placements (gather a rank's shards whole)."""
        return ShardedTree(groups, like, unflatten(like, self.specs(like)))


class ShardedServeStep:
    """The reference's prefill and decode steps over the default process
    group, on a ``mesh`` of its world size, under ``fsdp_tp`` (the
    reference's serving strategy: ``dp_dominant`` holds only for train).

    Each rank holds its shards of the params by the reference's rules
    (:meth:`shard_params`) and takes its rows of the global batch over the
    fsdp axes (``batch_shardings``).  ``prefill(params, batch, max_len,
    true_len=None)`` and ``decode(params, cache, tokens)`` return this
    rank's (logits, cache): under tensor-parallel compute
    (:class:`~repro_torch.distributed.collectives.TensorParallel`) each leaf
    is gathered over the fsdp axes only, the residual stream holds D/m
    columns, the logits are ``logits_sharding``'s (the vocabulary over
    ``model`` where it splits, else whole) and the cache is
    ``cache_leaf_sharding``'s: K/V heads over ``model`` where they split,
    else ``head_dim`` (decode then sums the scores over ``model``); rwkv6's
    ``state`` heads, griffin's ``h`` and every ``conv``/``last_*`` last dim
    over ``model``.  ``last_tm``/``last_cm`` keep the rank's D/m columns,
    gathered again at the next step.

    A batch whose rows do not split over the fsdp axes (``long_500k``'s
    one row) is held whole by every rank, and ``cache_leaf_sharding`` then
    splits each K/V cache's positions over those axes: prefill keeps the
    rank's block, decode merges each attention's softmax over them
    (``TensorParallel.kv_seq``); whisper-medium's cross K/V cache keeps the
    rank's block of the frames where they split, and its cross attention
    merges the softmax at prefill and decode.  Refused where a self K/V
    cache's length does not split, and under ``seq_parallel``.

    ``seq_parallel``: the prefill is the reference's context-parallel one
    (``activation_sharding(..., seq_parallel=True)``: the residual stream
    ``(fsdp, model, None)``): every leaf gathered whole, S split over
    ``model`` in GSPMD's blocks of ceil(S/m)
    (:class:`~repro_torch.distributed.collectives.SequenceParallel`; whisper's
    encoder frames split alike), and the cache and logits laid out as
    above, so :meth:`decode` continues from it under ``fsdp_tp`` alike.  The
    collectives are counted in ``groups.counter`` (:meth:`plan`)."""

    def __init__(self, model: Model, mesh, groups: MeshGroups | None = None, *,
                 seq_parallel: bool = False, provider=None):
        cfg = model.cfg
        shd.check_tensor_parallel(cfg, mesh)
        self.model, self.mesh, self.provider = model, mesh, provider
        self.seq_parallel = seq_parallel
        self.groups = groups if groups is not None else MeshGroups(mesh)
        self.tp = TensorParallel(self.groups, cfg)
        like = trainable(model.abstract_params())
        self.specs = shd.param_shardings(like, cfg, mesh)
        self.params = ShardedTree(self.groups, like, self.specs, tp=self.tp)
        self.whole = ShardedTree(self.groups, like, self.specs)     # every leaf gathered whole
        self.batch_axes = shd.fsdp_axes(mesh)
        self.batch_shards = self.groups.size(self.batch_axes)
        self.layout = CacheLayout(cfg, mesh, self.batch_shards)

    def shard_params(self, params: dict) -> dict:
        """This rank's shards of a model's full params (``embed_t`` left out)."""
        return self.params.shard(trainable(params))

    def rows_split(self, rows: int) -> bool:
        """Whether a batch of ``rows`` splits over the fsdp axes."""
        return rows % self.batch_shards == 0

    def batch_shard(self, batch: dict) -> dict:
        """This rank's rows of a global batch (``batch_shardings``): all of
        them where they do not split over the fsdp axes."""
        out = {}
        for k, v in batch.items():
            if not self.rows_split(v.shape[0]):
                out[k] = v
                continue
            spec = (self.batch_axes,) + (None,) * (v.dim() - 1)
            out[k] = shd.shard_leaf(v, spec, self.mesh, self.groups.coords)
        return out

    def _split_positions(self, rows: int, max_len: int | None = None) -> None:
        """Lays the caches out for a batch of ``rows``: ``tp.kv_seq`` (the
        K/V caches' S split over the fsdp axes where the rows are not) and
        the cache layout's rows; with ``max_len`` (prefill), checks that
        every K/V cache's positions split where they must."""
        self.tp.kv_seq = None
        self.layout.row_shards = self.batch_shards
        if self.rows_split(rows):
            return
        if self.seq_parallel and max_len is not None:
            raise ValueError(f"sequence parallelism takes batches whose rows split over the fsdp "
                             f"axes {self.batch_axes}; {rows} rows do not")
        self.layout.row_shards = 1
        index = shd.shard_index(self.batch_axes, self.mesh, self.groups.coords)[0]
        self.tp.kv_seq = (self.batch_shards, index, self.batch_axes)
        if max_len is None:
            return
        like = self.model.init_cache(rows, max_len, device="meta")
        for (path, t), spec in zip(leaves_with_paths(like), self.layout.specs(like)):
            if shd.leaf_name(path) in ("k", "v") and spec[2] is None:
                raise ValueError(f"{rows} rows do not split over the fsdp axes "
                                 f"{self.batch_axes}, nor do the {t.shape[2]} positions of the "
                                 f"cache {path}")

    def _gather(self, params: dict, whole: bool) -> ParamGather:
        gather = ParamGather(self.whole if whole else self.params, params, self.batch_shards)
        gather.aux = False
        return gather

    @torch.no_grad()
    def prefill(self, params: dict, batch: dict, max_len: int, true_len: int | None = None):
        """This rank's (last-position logits, cache) of a global batch."""
        self._split_positions(batch["tokens"].shape[0], max_len)
        local = self.batch_shard(batch)
        sp = None
        if self.seq_parallel:
            sp = SequenceParallel(self.groups, self.model.cfg,
                                  batch["tokens"].shape[1] + self.model.cfg.vision_tokens)
        with (gathered_params(self._gather(params, sp is not None)), sequence_parallel(sp),
              sharded_cache(self.layout)):
            return self.model.prefill(params, local, max_len=max_len, true_len=true_len,
                                      provider=self.provider)

    @torch.no_grad()
    def decode(self, params: dict, cache: dict, tokens: torch.Tensor):
        """This rank's (logits, cache) of one token for each row of the
        global batch (``tokens`` (B,)); the cache's K/V rows are written in
        place, as ``Model.decode_step`` writes them."""
        local = self.batch_shard({"tokens": tokens})["tokens"]
        self._split_positions(tokens.shape[0])
        with gathered_params(self._gather(params, False)), sharded_cache(self.layout):
            return self.model.decode_step(params, cache, local, provider=self.provider)

    # -- whole values from the shards (collectives: read the counter before) -----
    def full_logits(self, logits: torch.Tensor, rows: int) -> torch.Tensor:
        """The global batch's logits (``rows``, V) from every rank's shard."""
        vocab = shd.logits_sharding(self.mesh, self.model.cfg)[2]
        spec = (self.batch_axes if self.rows_split(rows) else None, vocab)
        like = torch.empty((rows, logits.shape[1] * (self.tp.m if vocab else 1)),
                           dtype=logits.dtype, device="meta")
        return ShardedTree(self.groups, [like], [spec]).gather([logits])[0]

    def full_cache(self, cache: dict, rows: int, max_len: int) -> dict:
        """The global batch's cache (``rows`` rows) from every rank's
        shards."""
        like = self.model.init_cache(rows, max_len, device="meta")
        return self.layout.tree(self.groups, like).gather(cache)

    def plan(self, phase: str, batch_shape: tuple[int, int], max_len: int,
             by_axes: bool = False) -> dict:
        """:func:`plan_serve` of this step's ``phase`` ("prefill" or
        "decode") on a global batch of ``batch_shape`` (B, S) prompt
        tokens."""
        return plan_serve(self.model.cfg, self.params.like, self.specs, self.mesh, phase=phase,
                          batch=batch_shape, max_len=max_len,
                          seq_parallel=self.seq_parallel and phase == "prefill",
                          by_axes=by_axes)


def make_sharded_serve_step(model: Model, mesh, groups: MeshGroups | None = None,
                            seq_parallel: bool = False, **kw) -> ShardedServeStep:
    """The sharded counterparts of ``Model.prefill`` and ``Model.decode_step``
    (:class:`ShardedServeStep`: ``.prefill``, ``.decode``)."""
    return ShardedServeStep(model, mesh, groups, seq_parallel=seq_parallel, **kw)


def plan_serve(cfg: ArchConfig, params: Any, specs: Any, mesh, *, phase: str,
               batch: tuple[int, int], max_len: int, seq_parallel: bool = False,
               by_axes: bool = False) -> dict:
    """The collectives one rank issues in one :class:`ShardedServeStep`
    ``phase``: a prefill of ``batch`` (B, S) prompt tokens (S counts text
    tokens; a vision prefix adds its own) into a cache of ``max_len`` text
    positions, or one decode step of B tokens against it; as
    :func:`plan_collectives` gives them.

    Both: each leaf gathered once (a decode step gathers no encoder layer),
    its ``model`` shard kept where tensor-parallel compute keeps it; the
    residual stream's reads and writes per layer
    (:data:`~repro_torch.distributed.context.RESIDUAL_IO`), the
    vocab-parallel embedding's write, the last row's read before the final
    norm (whisper's prefill: the encoder's output too); each rwkv6 layer's
    two reads of its ``last_*`` rows (D/m a rank).  A decode step's
    attention over a cache whose ``head_dim`` ``model`` splits: q gathered
    over ``model`` where each rank computes its own heads, the (B, KV,
    group, S) f32 scores all-reduced, the f32 output slices all-gathered.

    ``seq_parallel`` (prefill): each leaf gathered whole; per attention
    layer K and V all-gathered along S (blocks of ceil(S/m), padded); per
    rwkv6 layer two token shifts (``collective_permute``), the state's
    hand-off and the final state, ``last_tm`` and ``last_cm`` taken from
    the last rank (reduce-scatters over the cache's dim over ``model``);
    per griffin layer one conv shift, the hand-off, and ``h`` and ``conv``
    from the last rank; the last real row all-reduced to every rank.
    whisper: per encoder layer K and V all-gathered along the frames
    (blocks of ceil(frames/m)), and the encoder's output once.

    A batch whose rows do not split over the fsdp axes (``long_500k``'s
    one row): the rows on every fsdp rank and each K/V cache's S split over
    the fsdp axes, a decode step merging each attention's softmax over them
    (an all-reduce of the (B, KV, group) maxima, one of the sums of the
    exponentials and the weighted values); whisper's cross attention, where
    its frames split, merges likewise at prefill and decode (the (B, H, S)
    maxima of its rows' log-sum-exps, then the weights and outputs)."""
    stats, add = _collector()
    if phase not in ("prefill", "decode"):
        raise ValueError(f"phase must be prefill or decode, got {phase!r}")
    m, model = mesh.shape[MODEL_AXIS], (MODEL_AXIS,)
    fsdp = shd.fsdp_axes(mesh)
    shards = math.prod(mesh.shape[a] for a in fsdp)
    rows = batch[0] // shards if batch[0] % shards == 0 else batch[0]
    act = 2 if cfg.dtype == "bfloat16" else 4
    d = cfg.d_model
    decode = phase == "decode"
    audio = cfg.family == "audio"
    skip = ("['encoder']",) if decode and audio else ()
    _plan_param_gathers(add, cfg, params, specs, mesh, tp=not seq_parallel, train=False,
                        recompute=False, keep=lambda path: not path.startswith(skip))
    cache = dict(leaves_with_paths(_cache_like(cfg, batch[0], max_len)))
    cache_specs = {path: shd.cache_leaf_sharding(path, tuple(t.shape), cfg, mesh)
                   for path, t in cache.items()}

    def cache_split(path: str) -> tuple[tuple, int | None]:
        """A cache leaf's global shape and the dim ``model`` splits (None)."""
        t = cache[path]
        dims = [j for j, e in enumerate(cache_specs[path]) if MODEL_AXIS in shd.spec_axes(e)]
        return tuple(t.shape), (dims[0] if dims and m > 1 else None)

    kinds = block_kinds(cfg)
    seq = 1 if decode else batch[1] + cfg.vision_tokens
    if seq_parallel:
        _plan_seq_parallel(add, cfg, mesh, rows, seq, cache_split, act)
        return _finish(stats, by_axes)
    plan = _ResidualPlan(add, cfg, mesh, train=False)
    plan.blocks({"decoder": rows * seq} if decode else
                {"encoder": rows * cfg.encoder_seq, "decoder": rows * seq})
    if m > 1 and cfg.vocab_size % m == 0:
        plan.scatter(rows * (1 if decode else batch[1]), 1, elem=act)    # the embedding's lookup
    if audio and not decode:
        plan.gather(rows * cfg.encoder_seq, 1)                           # the encoder's output
    plan.gather(rows, 1)                                                 # the last row's final norm
    q_local = shd.attn_heads_local(cfg, mesh)[0]
    cross_split = audio and batch[0] % shards != 0 and cfg.encoder_seq % shards == 0
    for j, (kind, stack) in enumerate(kinds):
        if stack != "decoder":
            continue
        j -= cfg.encoder_layers if audio else 0
        if cross_split:     # the cross attention's softmax over the frames' blocks
            heads = rows * cfg.n_heads // (m if q_local else 1) * seq
            add("all_reduce", 1, heads * 4, heads * 4, fsdp)
            add("all_reduce", 1, heads * (1 + cfg.head_dim) * 4,
                heads * (1 + cfg.head_dim) * 4, fsdp)
        if kind == "rwkv" and m > 1 and d % m == 0:
            add("all_gather", 2, rows * d // m * act, rows * d * act, model)
        if kind == "rwkv" or not decode:
            continue
        lk = cfg.layer_kinds[j] if not audio else "G"
        if lk == "R":
            continue
        key = f"['layers'][{j}]['self']['k']" if audio else f"['layers'][{j}]['k']"
        shape, split = cache_split(key)
        hkv, size, hd = shape[1], shape[2], shape[3]
        group = cfg.n_heads // hkv
        if any(a in shd.spec_axes(cache_specs[key][2]) for a in fsdp) and shards > 1:
            # S over the fsdp axes: the softmax's maxima, then its sums and values
            heads = rows * cfg.n_heads // (1 if split == 3 or not q_local else m)
            width = hd // (m if split == 3 else 1)
            add("all_reduce", 1, heads * 4, heads * 4, fsdp)
            add("all_reduce", 1, heads * (1 + width) * 4, heads * (1 + width) * 4, fsdp)
            size //= shards
        if split != 3:
            continue
        if q_local:
            add("all_gather", 1, rows * cfg.n_heads // m * hd * act,
                rows * cfg.n_heads * hd * act, model)
        add("all_reduce", 1, rows * hkv * group * size * 4, rows * hkv * group * size * 4, model)
        add("all_gather", 1, rows * cfg.n_heads * hd // m * 4, rows * cfg.n_heads * hd * 4, model)
    return _finish(stats, by_axes)


def _cache_like(cfg: ArchConfig, batch: int, max_len: int) -> dict:
    """The serving cache of ``batch`` rows on ``meta``."""
    from repro_torch.models import encdec, lm
    mod = encdec if cfg.family == "audio" else lm
    return mod._init_cache(cfg, batch, max_len, torch.device("meta"))


def _plan_seq_parallel(add, cfg: ArchConfig, mesh, rows: int, seq: int, cache_split,
                       act: int) -> None:
    """The activations' and caches' collectives of a sequence-parallel
    prefill (:class:`~repro_torch.distributed.collectives.SequenceParallel`,
    see :func:`plan_serve`)."""
    m, model = mesh.shape[MODEL_AXIS], (MODEL_AXIS,)
    if m == 1:
        return
    d, local = cfg.d_model, -(-seq // m)             # a block, padded where m does not split S
    if cfg.family == "audio":
        frames = -(-cfg.encoder_seq // m)
        kv = rows * cfg.n_kv_heads * frames * cfg.head_dim * act
        add("all_gather", 2 * cfg.encoder_layers, kv, kv * m, model)
        add("all_gather", 1, rows * frames * d * act, rows * frames * d * act * m, model)

    def from_last(path: str, elem: int) -> None:
        shape, split = cache_split(path)
        n = rows * math.prod(shape[1:]) * elem
        if split is None:
            add("all_reduce", 1, n, n, model)
        else:
            add("reduce_scatter", 1, n, n // m, model)

    for j, kind in enumerate(cfg.layer_kinds):
        key = f"['layers'][{j}]"
        if kind == "R" and cfg.family == "ssm":
            add("collective_permute", 2, rows * d * act, rows * d * act, model)
            state = rows * cfg.n_heads * cfg.head_dim ** 2 * 4
            add("collective_permute", 1, state, state, model)
            from_last(key + "['state']", 4)
            from_last(key + "['last_tm']", act)
            from_last(key + "['last_cm']", act)
        elif kind == "R":
            w = cfg.rnn_width or d
            tail = rows * (cfg.conv_width - 1) * w * act
            add("collective_permute", 1, tail, tail, model)
            add("collective_permute", 1, rows * w * 4, rows * w * 4, model)
            from_last(key + "['h']", 4)
            from_last(key + "['conv']", act)
        else:
            kv = rows * cfg.n_kv_heads * local * cfg.head_dim * act
            add("all_gather", 2, kv, kv * m, model)
    add("all_reduce", 1, rows * d * act, rows * d * act, model)         # the last real row


def init_opt_state(params: Any, *, compress_grads: bool = False) -> dict:
    """AdamW state over the trainable params (and error-feedback residuals)."""
    train = trainable(params)
    state = adamw.init_state(train)
    if compress_grads:
        state["residuals"] = compression.init_residuals(train)
    return state
