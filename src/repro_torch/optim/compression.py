"""Gradient compression with error feedback (the counterpart of
``repro.optim.compression``).

Per-leaf symmetric int8 quantization with a max-abs scale; error feedback
(Seide et al.) keeps the quantization residual and re-injects it at the next
step.  The round trip is applied to the gradient before the optimizer, as in
the reference's pure-pjit training; under sharded training each rank applies
it to its shards with the leaf's scale (the max over every rank's shard).

:func:`compressed_all_reduce` is the reference's ``compressed_psum`` over a
process group: each rank quantizes its contribution to int8 with its f32
scale, the int8 payloads and the scales travel (``all_gather``), and every
rank sums the dequantized contributions in rank order — deterministic, and
the bytes on the wire are int8, as the reference's docstring intends.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.tree import leaves, tree_map, unflatten


def quantize(x: torch.Tensor, amax: torch.Tensor | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization. Returns (q, scale).  ``amax``: max |x|
    over the whole leaf where ``x`` is a shard of it."""
    xf = x.float()
    if amax is None:
        amax = torch.max(torch.abs(xf))
    scale = amax / 127.0 + 1e-12
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def compress_with_feedback(grad: torch.Tensor, residual: torch.Tensor, amax=None
                           ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Quantize (grad + residual); return (q, scale, new_residual)."""
    target = grad.float() + residual
    q, scale = quantize(target, amax)
    recon = dequantize(q, scale)
    return q, scale, target - recon


def init_residuals(grads: Any) -> Any:
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), grads)


def compressed_gradients(grads: Any, residuals: Any, reduce_max=None) -> tuple[Any, Any]:
    """Apply the int8 round trip with error feedback to every gradient leaf.

    ``reduce_max`` (sharded training): takes the per-leaf max |grad +
    residual| of this rank's shards (one f32 vector) and returns the max
    over every rank, so each shard quantizes with its leaf's scale.

    Returns (dequantized grads to feed the optimizer, new residuals)."""
    g, r = leaves(grads), leaves(residuals)
    amax = [None] * len(g)
    if reduce_max is not None:
        amax = reduce_max(torch.stack([torch.max(torch.abs(gi.float() + ri))
                                       for gi, ri in zip(g, r)])).unbind()
    outs = [compress_with_feedback(gi, ri, a) for gi, ri, a in zip(g, r, amax)]
    deq = [dequantize(q, s, g.dtype) for (q, s, _), g in zip(outs, leaves(grads))]
    return unflatten(grads, deq), unflatten(grads, [o[2] for o in outs])


def compressed_all_reduce(x: torch.Tensor, groups) -> torch.Tensor:
    """The sum over every rank of ``groups``' mesh (a
    :class:`~repro_torch.distributed.collectives.MeshGroups`, which issues
    and counts the collectives) of each rank's int8 round trip of ``x``
    (f32), summed in rank order on every rank."""
    world = groups.world
    q, scale = quantize(x)
    payload = q.reshape(-1)
    qs = torch.empty(world * payload.numel(), dtype=torch.int8, device=x.device)
    scales = torch.empty(world, dtype=torch.float32, device=x.device)
    groups.all_gather(qs, payload, groups.all_axes)
    groups.all_gather(scales, scale.reshape(1), groups.all_axes)
    qs = qs.view(world, *x.shape)
    out = dequantize(qs[0], scales[0])
    for r in range(1, world):
        out = out + dequantize(qs[r], scales[r])
    return out
