"""The single-process parts of ``repro.distributed.context``: the remat
policy the launcher sets and the models read, and the residual-stream
sharding constraint, which is the identity without a mesh.

The reference's policies are ``jax.checkpoint`` policies; here the models
read the policy's name.  ``full`` (the default) saves nothing inside a
layer: each layer runs under ``torch.utils.checkpoint.checkpoint`` and is
recomputed in the backward.  ``dots`` (save the matmul outputs) is not
realised yet (ROADMAP A.8): a model asked for it raises.  Sharded
activations wait for the port's distributed training (ROADMAP A.9).
"""
from __future__ import annotations

import contextlib
import threading

import torch

REMAT_POLICIES = ("full", "dots")
_tls = threading.local()


@contextlib.contextmanager
def activation_sharding(sharding):
    """The identity without a mesh (``sharding`` None); a sharding raises."""
    if sharding is not None:
        raise NotImplementedError("sharded activations wait for distributed training "
                                  "(ROADMAP A.9)")
    yield


def constrain(x: torch.Tensor) -> torch.Tensor:
    """The residual-stream constraint: the identity on one device."""
    return x


def set_remat_policy(name: str | None) -> None:
    """'full' (default: recompute everything, save layer boundaries only)
    or 'dots' (save matmul outputs; not realised yet, see the module)."""
    if name is not None and name not in REMAT_POLICIES:
        raise ValueError(f"remat policy must be one of {REMAT_POLICIES}, got {name!r}")
    _tls.remat_policy = name


def remat_policy() -> str:
    return getattr(_tls, "remat_policy", None) or "full"
