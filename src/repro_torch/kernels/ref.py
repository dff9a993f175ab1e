"""Plain PyTorch versions of the kernels (mirrors of ``repro.kernels.ref``).

The CPU tests hold these against the JAX oracles, the kernel wrappers take
them for tensors that lie on the CPU, and ``chip_smoke.py`` holds each CUDA
kernel against them on the card.  When a card is present, nothing on the
main path calls them.

Numerics follow the reference: products in f32 (``preferred_element_type``),
epilogues in f32, one cast back to the input dtype; ``jax.nn.gelu`` is the
tanh form (``approximate=True``), so :func:`gelu` is too.

Every function here is differentiable by torch's autograd (no in-place
write touches a tensor that carries a gradient): on the CPU, training
differentiates these.  The ``*_bwd`` functions are the plain versions of
the backward kernels, each torch's autograd through its forward here:
:func:`chunked_attention_bwd` (K2), :func:`grouped_matmul_bwd` (K1g),
:func:`rwkv6_scan_bwd` (K3) and :func:`rglru_scan_bwd` (K4).  Each returns
the gradient of every input, in that input's dtype.

``cuda_calls`` counts the calls of each plain version on a CUDA tensor
since :func:`reset_calls`, so a run on the card can show that its main path
reached none of them.
"""
from __future__ import annotations

import collections
import functools
from typing import Callable

import torch
import torch.nn.functional as F

#: calls of the plain versions on a CUDA tensor since the last reset, by name
cuda_calls: collections.Counter = collections.Counter()


def reset_calls() -> None:
    cuda_calls.clear()


def _counted(fn):
    @functools.wraps(fn)
    def counted(x, *args, **kwargs):
        if x.is_cuda:
            cuda_calls[fn.__name__] += 1
        return fn(x, *args, **kwargs)
    return counted

# ---------------------------------------------------------------------------
# Matmul + fused epilogues
# ---------------------------------------------------------------------------

#: every non-grouped class of the matmul family: the classes the matmul kernel takes
MATMUL_CLASSES = ("matmul", "matmul_bias", "matmul_bias_gelu", "matmul_silu_glu",
                  "matmul_gelu_glu", "matmul_residual", "matmul_lmhead",
                  "matmul_lmhead_softcap", "moe_router")
#: the grouped (MoE expert) classes: the grouped matmul kernel takes these
GROUPED_CLASSES = ("moe_gemm_silu_glu", "moe_gemm")


def gelu(y: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(y, approximate="tanh")


def _glu(y: torch.Tensor, act: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """Interleaved GLU: columns are packed (gate, up, gate, up, ...)."""
    return act(y[..., 0::2]) * y[..., 1::2]


def apply_epilogue(y: torch.Tensor, class_id: str, *, bias: torch.Tensor | None = None,
                   residual: torch.Tensor | None = None, softcap: float = 0.0) -> torch.Tensor:
    if bias is not None:
        y = y + bias
    if class_id in ("matmul", "matmul_bias", "matmul_lmhead", "moe_router", "moe_gemm"):
        pass
    elif class_id == "matmul_bias_gelu":
        y = gelu(y)
    elif class_id in ("matmul_silu_glu", "moe_gemm_silu_glu"):
        y = _glu(y, F.silu)
    elif class_id == "matmul_gelu_glu":
        y = _glu(y, gelu)
    elif class_id == "matmul_residual":
        if residual is None:
            raise ValueError("matmul_residual needs a residual")
        y = y + residual
    elif class_id == "matmul_lmhead_softcap":
        if softcap <= 0.0:
            raise ValueError("matmul_lmhead_softcap needs softcap > 0")
        y = torch.tanh(y / softcap) * softcap
    else:
        raise ValueError(f"unknown matmul epilogue class {class_id!r}")
    return y


@_counted
def matmul(x: torch.Tensor, w: torch.Tensor, class_id: str = "matmul", *,
           bias: torch.Tensor | None = None, residual: torch.Tensor | None = None,
           softcap: float = 0.0, round_k: int = 0) -> torch.Tensor:
    """x: (..., K) @ w: (K, N) in f32, epilogue in f32, cast to x.dtype.

    ``round_k`` > 0 is the Pallas kernel's accumulation without its f32
    scratch (``cache_write=False``, or K not innermost; see
    :func:`repro_torch.kernels.matmul.round_k_for`): the f32 product of each
    K tile of ``round_k`` rows is added to the sum so far, which is rounded
    to x.dtype after every tile but the last.  0 sums all of K in f32."""
    if not round_k:
        y = torch.matmul(x.float(), w.float())
    else:
        k = x.shape[-1]
        if k % round_k:
            raise ValueError(f"the rounding K tile {round_k} does not divide K = {k}")
        xf, wf = x.float(), w.float()
        y = torch.matmul(xf[..., :round_k], wf[:round_k])
        for k0 in range(round_k, k, round_k):
            y = y.to(x.dtype).float() + torch.matmul(xf[..., k0:k0 + round_k], wf[k0:k0 + round_k])
    y = apply_epilogue(y, class_id, bias=bias, residual=residual, softcap=softcap)
    return y.to(x.dtype)


@_counted
def grouped_matmul(x: torch.Tensor, w: torch.Tensor, class_id: str = "moe_gemm", *,
                   round_k: int = 0) -> torch.Tensor:
    """x: (E, M, K) @ w: (E, K, N): :func:`matmul` applied to each expert (the
    reference's ``jax.vmap(ref.matmul)``), ``round_k`` as there.  Calls this
    module's ``matmul`` one expert at a time, so a patched ``matmul`` patches
    this too, and only one expert's f32 copy of ``w`` is alive at once."""
    if class_id not in GROUPED_CLASSES:
        raise ValueError(f"unknown grouped matmul class {class_id!r}")
    return torch.stack([matmul(xe, we, class_id, round_k=round_k) for xe, we in zip(x, w)])


def _grads(fn, inputs: tuple, douts: tuple) -> tuple[torch.Tensor, ...]:
    """The gradients of ``fn(*inputs)``'s outputs at ``douts`` (None: the
    output is not used) with respect to every input, by torch's autograd."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in inputs]
        outs = fn(*leaves)
        outs = outs if isinstance(outs, tuple) else (outs,)
        pairs = [(o, d) for o, d in zip(outs, douts) if d is not None]
        return torch.autograd.grad([o for o, _ in pairs], leaves, [d for _, d in pairs],
                                   allow_unused=True, materialize_grads=True)


@_counted
def grouped_matmul_bwd(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor,
                       class_id: str = "moe_gemm") -> tuple[torch.Tensor, torch.Tensor]:
    """(dx, dw) of :func:`grouped_matmul` at ``dy`` (f32 sums, no rounding
    per K tile): the plain version of K1g's backward."""
    return _grads(lambda a, b: grouped_matmul(a, b, class_id), (x, w), (dy,))


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def _mask_ok(sq: int, skv: int, q_offset: int, causal: bool, window: int,
             device) -> torch.Tensor:
    q_pos = q_offset + torch.arange(sq, device=device)[:, None]
    kv_pos = torch.arange(skv, device=device)[None, :]
    ok = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        ok &= kv_pos <= q_pos
    if window > 0:
        ok &= kv_pos > q_pos - window
    return ok


@_counted
def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
              window: int = 0, softcap: float = 0.0, q_offset: int = 0,
              scale: float | None = None) -> torch.Tensor:
    """Naive full-materialization attention.

    q: (B, Hq, Sq, D), k/v: (B, Hkv, Skv, D) with Hq % Hkv == 0 (GQA).
    """
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    qg = q.reshape(b, hkv, group, sq, d).float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) * scale
    if softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    ok = _mask_ok(sq, skv, q_offset, causal, window, q.device)
    s = s + torch.where(ok, 0.0, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return o.reshape(b, hq, sq, d).to(q.dtype)


@_counted
def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int = 0, softcap: float = 0.0,
                      q_offset: int = 0, chunk: int = 1024,
                      scale: float | None = None) -> torch.Tensor:
    """Online-softmax attention chunked over KV: O(Sq·chunk) live memory."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    chunk = min(chunk, skv)
    qg = (q.reshape(b, hkv, group, sq, d) * scale).float()
    q_pos = q_offset + torch.arange(sq, device=q.device)
    m = torch.full((b, hkv, group, sq), float("-inf"), device=q.device)
    l = torch.zeros((b, hkv, group, sq), device=q.device)
    acc = torch.zeros((b, hkv, group, sq, d), device=q.device)
    for start in range(0, skv, chunk):
        kb = k[:, :, start:start + chunk].float()
        vb = v[:, :, start:start + chunk].float()
        s = torch.einsum("bhgqd,bhkd->bhgqk", qg, kb)
        if softcap > 0:
            s = torch.tanh(s / softcap) * softcap
        kv_pos = start + torch.arange(kb.shape[2], device=q.device)
        ok = torch.ones((sq, kb.shape[2]), dtype=torch.bool, device=q.device)
        if causal:
            ok &= kv_pos[None, :] <= q_pos[:, None]
        if window > 0:
            ok &= kv_pos[None, :] > q_pos[:, None] - window
        s = torch.where(ok, s, float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1))
        # guard fully-masked rows (m_new == -inf)
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        p = torch.exp(s - m_safe[..., None])
        p = torch.where(ok, p, 0.0)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhgqk,bhkd->bhgqd", p, vb)
        m = m_new
    o = acc / torch.clamp(l, min=1e-30)[..., None]
    return o.reshape(b, hq, sq, d).to(q.dtype)


@_counted
def attention_lse(q: torch.Tensor, k: torch.Tensor, *, causal: bool = True, window: int = 0,
                  softcap: float = 0.0, q_offset: int = 0,
                  scale: float | None = None) -> torch.Tensor:
    """Each query row's log-sum-exp of its masked, softcapped, scaled scores,
    (B, Hq, Sq) f32: what the forward kernel writes for the backward (the
    plain version of its ``lse`` output).  A fully masked row gets +inf, so
    exp(s - lse) is 0 there, as the kernels leave such a row at 0."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    qg = q.reshape(b, hkv, hq // hkv, sq, d).float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) * scale
    if softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    s = torch.where(_mask_ok(sq, skv, q_offset, causal, window, q.device), s, float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    return torch.where(torch.isfinite(lse), lse, float("inf")).reshape(b, hq, sq)


@_counted
def chunked_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor, *,
                          causal: bool = True, window: int = 0, softcap: float = 0.0,
                          q_offset: int = 0, chunk: int = 1024,
                          scale: float | None = None) -> tuple[torch.Tensor, ...]:
    """(dq, dk, dv) of :func:`chunked_attention` at ``do`` (the output's
    gradient), by torch's autograd: the plain version of the attention
    backward kernel.  Each gradient takes its input's dtype."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        o = chunked_attention(*leaves, causal=causal, window=window, softcap=softcap,
                              q_offset=q_offset, chunk=chunk, scale=scale)
        return torch.autograd.grad(o, leaves, do)


# ---------------------------------------------------------------------------
# RWKV6 time-mix scan (Finch wkv: data-dependent per-channel decay + bonus)
# ---------------------------------------------------------------------------


@_counted
def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
               u: torch.Tensor, state: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain wkv6 recurrence, one step per token.

    r/k/v/w: (B, H, T, D); u: (H, D); state: (B, H, D, D) mapping k-dim->v-dim.
      y_t   = (S_t + (u ⊙ k_t) v_tᵀ)ᵀ r_t
      S_t+1 = diag(w_t) S_t + k_t v_tᵀ
    Returns (y (B, H, T, D) in r's dtype, final state (B, H, D, D) f32).
    """
    rf, kf, vf, wf = (x.float() for x in (r, k, v, w))
    uf = u.float()[None, :, :, None]
    s = state.float()
    ys = []
    for t in range(r.shape[2]):
        kv = kf[:, :, t, :, None] * vf[:, :, t, None, :]          # (B,H,D,D)
        ys.append(torch.einsum("bhk,bhkv->bhv", rf[:, :, t], s + uf * kv))
        s = wf[:, :, t, :, None] * s + kv
    y = torch.stack(ys, dim=2) if ys else rf.new_zeros(r.shape)
    return y.to(r.dtype), s


@_counted
def rwkv6_scan_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                   u: torch.Tensor, state: torch.Tensor, dy: torch.Tensor,
                   dstate: torch.Tensor | None = None) -> tuple[torch.Tensor, ...]:
    """(dr, dk, dv, dw, du, dstate_in) of :func:`rwkv6_scan` at ``dy`` (y's
    gradient) and ``dstate`` (the final state's; None: unused): the plain
    version of K3's backward."""
    return _grads(rwkv6_scan, (r, k, v, w, u, state), (dy, dstate))


# ---------------------------------------------------------------------------
# RG-LRU scan (Griffin / RecurrentGemma)
# ---------------------------------------------------------------------------


@_counted
def rglru_scan(x: torch.Tensor, a: torch.Tensor,
               state: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain RG-LRU recurrence, one step per token.

    x, a: (B, T, C) — pre-gated input and per-step decay a_t ∈ (0,1);
    state: (B, C).   h_t = a_t ⊙ h_{t-1} + sqrt(max(1 - a_t², 0)) ⊙ x_t
    Returns (y (B, T, C) in x's dtype, final h (B, C) f32).
    """
    xf, af = x.float(), a.float()
    h = state.float()
    hs = []
    for t in range(x.shape[1]):
        at = af[:, t]
        h = at * h + torch.sqrt(torch.clamp(1.0 - at * at, min=0.0)) * xf[:, t]
        hs.append(h)
    y = torch.stack(hs, dim=1) if hs else xf.new_zeros(x.shape)
    return y.to(x.dtype), h


@_counted
def rglru_scan_bwd(x: torch.Tensor, a: torch.Tensor, state: torch.Tensor, dy: torch.Tensor,
                   dstate: torch.Tensor | None = None) -> tuple[torch.Tensor, ...]:
    """(dx, da, dstate_in) of :func:`rglru_scan` at ``dy`` and ``dstate``
    (the final state's gradient; None: unused): the plain version of K4's
    backward.  Where 1 − a² is 0 (a = 1) ``da`` is ±inf (NaN where x·g is
    0): the derivative of the square root at 0, as ``jax.grad`` gives it."""
    return _grads(rglru_scan, (x, a, state), (dy, dstate))
