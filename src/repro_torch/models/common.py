"""Shared model substrate: norms, RoPE, initializers, GLU weight packing
(the counterpart of ``repro.models.common``).

Parameters are plain nested dicts of tensors, as in the reference.  Every
random draw comes from an explicit ``torch.Generator`` and lands on the
generator's device; the scales are the reference's.

Tensor-parallel compute in bf16 (``distributed.context``): the gathered
residual stream is, under autograd, an f32 carrier of its bf16 values, and
so is a weight whose gradient the ranks sum from partial products (a norm's
scale, say: ``collectives.widens_grad``).  A norm of a carrier, and rwkv6's
token mix of one, round their output to bf16 values and keep it an f32
carrier (:func:`cast`), so the column-parallel products that read it hand
back f32 partial gradients.
:func:`row_parallel` is every product whose rows the ``model`` axis splits
(an output projection): its partial sums go into the residual stream.
"""
from __future__ import annotations

import torch

from repro_torch.distributed.context import f32_partials, scatter_residual, tp_context
from repro_torch.kernels import ops


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------


def _normal(gen: torch.Generator, shape: tuple[int, ...]) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)


def dense_init(gen: torch.Generator, fan_in: int, fan_out: int, dtype) -> torch.Tensor:
    """One f32 draw, scaled in place, then cast: the only f32 copy alive is
    the draw itself."""
    scale = (2.0 / (fan_in + fan_out)) ** 0.5
    return _normal(gen, (fan_in, fan_out)).mul_(scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, dim: int, dtype) -> torch.Tensor:
    return _normal(gen, (vocab, dim)).mul_(dim ** -0.5).to(dtype)


def pack_glu(w_gate: torch.Tensor, w_up: torch.Tensor,
             out: torch.Tensor | None = None) -> torch.Tensor:
    """Interleave gate/up columns: (K, F) + (K, F) -> (K, 2F) with columns
    (g0, u0, g1, u1, ...), the layout the fused GLU epilogue reads.  Written
    into ``out`` (K, 2F) where given, say one expert's slice of a stack."""
    k, f = w_gate.shape
    if out is None:
        out = torch.empty((k, 2 * f), dtype=w_gate.dtype, device=w_gate.device)
    pairs = out.view(k, f, 2)
    pairs[:, :, 0] = w_gate
    pairs[:, :, 1] = w_up
    return out


def glu_init(gen: torch.Generator, d: int, f: int, dtype,
             out: torch.Tensor | None = None) -> torch.Tensor:
    w_gate = dense_init(gen, d, f, dtype)
    return pack_glu(w_gate, dense_init(gen, d, f, dtype), out=out)


# ---------------------------------------------------------------------------
# Norms (computed in f32, cast back)
# ---------------------------------------------------------------------------


class _Round(torch.autograd.Function):
    """f32 values rounded to ``dtype``'s, kept in f32; the gradient passes
    unrounded (the carrier's: see the module)."""

    @staticmethod
    def forward(ctx, y, dtype):
        return y.to(dtype).float()

    @staticmethod
    def backward(ctx, g):
        return g, None


def cast(y: torch.Tensor, in_dtype: torch.dtype) -> torch.Tensor:
    """``y`` (f32), computed from an input of ``in_dtype``: cast to it,
    except under tensor-parallel compute with f32 partial sums, where an f32
    input is a carrier of the model's bf16 values: then rounded to bf16's
    values and kept an f32 carrier."""
    if in_dtype == torch.float32 and f32_partials():
        return _Round.apply(y, tp_context().dtype)
    return y.to(in_dtype)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return cast(y, x.dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps) * scale.float() + bias.float()
    return cast(y, x.dtype)


def row_parallel(x: torch.Tensor, w: torch.Tensor, *, bias: torch.Tensor | None = None,
                 provider=None) -> torch.Tensor:
    """``x @ w`` (+ ``bias``, class ``matmul_bias``) into the residual
    stream.  Under tensor-parallel compute ``x`` holds this rank's columns
    and ``w`` its rows, so the product gives partial sums: with
    ``f32_partials`` it writes them in f32 and the sum over ``model`` is
    taken in f32, the bias added once after it, the cast last (the
    reference's order); otherwise the bias goes in on the row's first rank
    and the sum is in the product's dtype.  Outside it, the product."""
    tp = tp_context()
    if f32_partials():
        return tp.scatter(ops.matmul(x, w, provider=provider, out_f32=True), bias=bias)
    if tp is not None and bias is not None:
        bias = tp.first(bias)
    y = ops.matmul(x, w, class_id="matmul" if bias is None else "matmul_bias", bias=bias,
                   provider=provider)
    return scatter_residual(y)


def norm_params(d: int, kind: str, dtype, device) -> dict:
    if kind == "rmsnorm":
        return {"scale": torch.zeros((d,), dtype=dtype, device=device)}
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def apply_norm(p: dict, x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "rmsnorm":
        return rmsnorm(x, p["scale"])
    return layernorm(x, p["scale"], p["bias"])


# ---------------------------------------------------------------------------
# RoPE (interleaved pairs, as the reference)
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    return theta ** (-torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, H, S, D); positions: (B, S) or (S,) absolute positions.

    Rotates the interleaved pairs (x[..., 0::2], x[..., 1::2]), not the
    rotate-half halves."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                # (D/2,)
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freqs            # (B, S, D/2)
    cos = torch.cos(ang)[:, None, :, :]
    sin = torch.sin(ang)[:, None, :, :]
    xf = x.float()
    x1, x2 = xf[..., 0::2], xf[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x1 * sin + x2 * cos
    return torch.stack([y1, y2], dim=-1).reshape(x.shape).to(x.dtype)
