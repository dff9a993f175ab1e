"""How the launcher injects distribution into model code without threading
mesh objects through every layer (the counterpart of
``repro.distributed.context``): the residual-stream and named activation
constraints, the gather of sharded params, and the remat policy.

The reference's constraints are GSPMD sharding constraints.  The port
computes on gathered weights (ZeRO-3): every activation is rank-local, this
rank's batch shard, so there is nothing to constrain.
:func:`activation_sharding`, :func:`set_sharding_rules`, :func:`constrain`
and :func:`constrain_named` keep the reference's names and calls and change
nothing; nothing reads the specs they are given (tensor-parallel compute,
which would, is ROADMAP A.9b's).  The sharded train step installs a param
gather (:func:`gathered_params`) that the models read (:func:`param_gather`)
once per forward: it captures the gather for the layers' recompute, which
runs on autograd's thread.

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
    """The residual stream's spec for the block: nothing to constrain under
    gathered compute (see the module)."""
    yield


def constrain(x: torch.Tensor) -> torch.Tensor:
    """The residual-stream constraint: the identity under gathered compute,
    where every activation is this rank's batch shard."""
    return x


def set_sharding_rules(rules: dict | None) -> None:
    """Named internal-activation specs (e.g. ``moe_buf``): nothing to
    constrain under gathered compute (see the module)."""


def constrain_named(x: torch.Tensor, name: str) -> torch.Tensor:
    """A named activation's constraint: the identity under gathered compute,
    as :func:`constrain` is."""
    return x


# -- sharded params (set by the sharded train step) ------------------------


@contextlib.contextmanager
def gathered_params(gather):
    """Models called in the block gather their params through ``gather``
    (a :class:`~repro_torch.distributed.collectives.ParamGather`)."""
    prev = getattr(_tls, "gather", None)
    _tls.gather = gather
    try:
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
