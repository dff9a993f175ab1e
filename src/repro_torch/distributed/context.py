"""How the launcher injects distribution into model code without threading
mesh objects through every layer (the counterpart of
``repro.distributed.context``): the residual-stream and named activation
constraints, tensor-parallel compute, the gather of sharded params, and the
remat policy.

The reference's constraints are GSPMD sharding constraints, from which XLA
derives its tensor-parallel collectives.  The port issues them by hand:
under :func:`tensor_parallel` (a
:class:`~repro_torch.distributed.collectives.TensorParallel`, which the
sharded train step's param gather carries) each block reads the residual
stream through :func:`gather_residual` (an all-gather along D over
``model``) and returns its row-parallel products through
:func:`scatter_residual` (a reduce-scatter into the reference's
``activation_sharding`` layout, ``(fsdp, None, model)``).  Both are the
identity outside such a context, as are :func:`activation_sharding`,
:func:`set_sharding_rules`, :func:`constrain` and :func:`constrain_named`,
which keep the reference's names and calls: the layouts they name are the
ones the tensor-parallel context computes in.  The sharded train step
installs a param gather (:func:`gathered_params`) that the models read
(:func:`param_gather`) once per forward: it captures the gather and the
tensor-parallel context for the layers' recompute, which runs on
autograd's thread.

The residual stream's collectives fall where :data:`RESIDUAL_IO`
declares: each block kind reads the stream and writes partial sums into
it that many times a pass.  The planner (``launch.steps``) counts from it,
and every block runs under :func:`block_io`, which checks the block's
reads and writes against it.

Serving (``launch.steps.make_sharded_serve_step``): under
:func:`tensor_parallel` the caches are this rank's shards
(:func:`sharded_cache` says how a cache of the global batch is laid out:
``models.lm.init_cache`` allocates them), and under
:func:`sequence_parallel` (a :class:`~repro_torch.distributed.collectives.
SequenceParallel`) a prefill splits S over ``model``.

The reference's remat policies are ``jax.checkpoint`` policies; here the
models read the policy's name (``models.lm.rematted``).  Each layer runs
under ``torch.utils.checkpoint.checkpoint``.  ``full`` (the default) saves
nothing inside a layer and recomputes it in the backward.  ``dots`` saves
the outputs of the layer's K1 launches (the reference's
``dots_with_no_batch_dims_saveable``) through selective checkpointing and
recomputes the rest, so no K1 forward runs twice; the gelu and GLU classes
keep their pre-activation too.
"""
from __future__ import annotations

import contextlib
import threading

import torch

REMAT_POLICIES = ("full", "dots")
_tls = threading.local()


@contextlib.contextmanager
def activation_sharding(sharding):
    """The residual stream's spec for the block: the layout a
    tensor-parallel context computes in (see the module); nothing to
    constrain."""
    yield


def constrain(x: torch.Tensor) -> torch.Tensor:
    """The residual-stream constraint: the identity (the tensor-parallel
    context lays the stream out itself)."""
    return x


def set_sharding_rules(rules: dict | None) -> None:
    """Named internal-activation specs (e.g. ``moe_buf``): nothing to
    constrain (see the module)."""


def constrain_named(x: torch.Tensor, name: str) -> torch.Tensor:
    """A named activation's constraint: the identity, as :func:`constrain`
    is."""
    return x


# -- tensor-parallel compute ---------------------------------------------------


@contextlib.contextmanager
def tensor_parallel(tp):
    """Models called in the block compute tensor-parallel under ``tp`` (a
    :class:`~repro_torch.distributed.collectives.TensorParallel`; None:
    whole)."""
    prev = getattr(_tls, "tp", None)
    _tls.tp = tp
    try:
        yield
    finally:
        _tls.tp = prev


def tp_context():
    """The active tensor-parallel context, or None."""
    return getattr(_tls, "tp", None)


def gather_residual(x: torch.Tensor) -> torch.Tensor:
    """A block's read of the residual stream: the whole of D (an all-gather
    over ``model`` under tensor-parallel compute)."""
    tp = tp_context()
    return x if tp is None else tp.gather(x)


def scatter_residual(y: torch.Tensor) -> torch.Tensor:
    """A row-parallel product's output into the residual stream's layout (a
    reduce-scatter of the ranks' partial sums under tensor-parallel
    compute)."""
    tp = tp_context()
    return y if tp is None else tp.scatter(y)


def local_residual(x: torch.Tensor) -> torch.Tensor:
    """A value every rank computes whole (the whole of D) -> its part in the
    residual stream's layout."""
    tp = tp_context()
    return x if tp is None else tp.local(x)


def f32_partials() -> bool:
    """Whether row-parallel products write f32 partial sums (tensor-parallel
    compute in bf16 over more than one rank)."""
    tp = tp_context()
    return tp is not None and tp.f32_partials


#: a block kind -> the times a pass of it reads the residual stream
#: (:func:`gather_residual`) and writes partial sums into it (a row-parallel
#: product's scatter) under tensor-parallel compute: ``mixer_ffn`` a
#: norm-mixer-MLP layer (attention or griffin's recurrent block, then an MLP
#: or MoE) or a whisper encoder layer, ``rwkv`` a time mix and a channel
#: mix, ``cross`` a whisper decoder layer (self attention, cross attention,
#: MLP)
RESIDUAL_IO = {"mixer_ffn": 2, "rwkv": 2, "cross": 3}


@contextlib.contextmanager
def block_io(kind: str):
    """A block of ``kind`` (:data:`RESIDUAL_IO`): under tensor-parallel
    compute, raises if it read or wrote the residual stream other than the
    declared times."""
    tp = tp_context()
    if tp is None:
        yield
        return
    before = (tp.events["gather"], tp.events["scatter"])
    yield
    got = (tp.events["gather"] - before[0], tp.events["scatter"] - before[1])
    want = RESIDUAL_IO[kind]
    if got != (want, want):
        raise AssertionError(f"a {kind} block read the residual stream {got[0]} times and wrote "
                             f"it {got[1]} times; RESIDUAL_IO declares {want} each")


# -- sequence parallelism and sharded caches (serving) ---------------------------


@contextlib.contextmanager
def sequence_parallel(sp):
    """A prefill in the block splits S over ``model`` under ``sp`` (a
    :class:`~repro_torch.distributed.collectives.SequenceParallel`; None:
    whole)."""
    prev = getattr(_tls, "sp", None)
    _tls.sp = sp
    try:
        yield
    finally:
        _tls.sp = prev


def sp_context():
    """The active sequence-parallel context, or None."""
    return getattr(_tls, "sp", None)


@contextlib.contextmanager
def sharded_cache(layout):
    """Caches made in the block are this rank's shards: ``layout(like)``
    maps a cache tree of the global batch (``meta`` leaves) to this rank's
    zeroed shards (None: whole caches)."""
    prev = getattr(_tls, "cache_layout", None)
    _tls.cache_layout = layout
    try:
        yield
    finally:
        _tls.cache_layout = prev


def cache_layout():
    """The active cache layout (see :func:`sharded_cache`), or None."""
    return getattr(_tls, "cache_layout", None)


# -- sharded params (set by the sharded train step) ------------------------


@contextlib.contextmanager
def gathered_params(gather):
    """Models called in the block gather their params through ``gather``
    (a :class:`~repro_torch.distributed.collectives.ParamGather`) and
    compute under its tensor-parallel context, if it has one."""
    prev = getattr(_tls, "gather", None)
    _tls.gather = gather
    try:
        with tensor_parallel(getattr(gather, "tp", None) if gather is not None else tp_context()):
            yield
    finally:
        _tls.gather = prev


def param_gather():
    """The active param gather, or None (params are whole: no change)."""
    return getattr(_tls, "gather", None)


# -- remat policy (set by the launcher; models read it at trace time) -------


def set_remat_policy(name: str | None) -> None:
    """'full' (default: recompute everything, save layer boundaries only)
    or 'dots' (save K1's outputs, recompute the rest; see the module)."""
    if name is not None and name not in REMAT_POLICIES:
        raise ValueError(f"remat policy must be one of {REMAT_POLICIES}, got {name!r}")
    _tls.remat_policy = name


def remat_policy() -> str:
    return getattr(_tls, "remat_policy", None) or "full"


@contextlib.contextmanager
def using_remat_policy(name: str | None):
    """:func:`set_remat_policy` for the block; the previous policy after it."""
    prev = getattr(_tls, "remat_policy", None)
    set_remat_policy(name)
    try:
        yield
    finally:
        _tls.remat_policy = prev
