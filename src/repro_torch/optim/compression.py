"""Gradient compression with error feedback (the counterpart of
``repro.optim.compression``).

Per-leaf symmetric int8 quantization with a max-abs scale; error feedback
(Seide et al.) keeps the quantization residual and re-injects it at the next
step.  On one process the round trip is applied to the gradient before the
optimizer, as in the reference's pure-pjit training.  The collective
(``compressed_psum``) waits for the port's distributed training (ROADMAP
A.9).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.tree import leaves, tree_map, unflatten


def quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization. Returns (q, scale)."""
    xf = x.float()
    scale = torch.max(torch.abs(xf)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def compress_with_feedback(grad: torch.Tensor, residual: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Quantize (grad + residual); return (q, scale, new_residual)."""
    target = grad.float() + residual
    q, scale = quantize(target)
    recon = dequantize(q, scale)
    return q, scale, target - recon


def init_residuals(grads: Any) -> Any:
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), grads)


def compressed_gradients(grads: Any, residuals: Any) -> tuple[Any, Any]:
    """Apply the int8 round trip with error feedback to every gradient leaf.

    Returns (dequantized grads to feed the optimizer, new residuals)."""
    outs = [compress_with_feedback(g, r) for g, r in zip(leaves(grads), leaves(residuals))]
    deq = [dequantize(q, s, g.dtype) for (q, s, _), g in zip(outs, leaves(grads))]
    return unflatten(grads, deq), unflatten(grads, [o[2] for o in outs])
