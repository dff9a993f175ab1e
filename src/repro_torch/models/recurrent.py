"""Recurrent blocks: RWKV6 (Finch) and Griffin's RG-LRU recurrent block (the
counterpart of ``repro.models.recurrent``).

RWKV6 block = time-mix (token-shift interpolation, r/k/v/gate projections,
data-dependent decay via a low-rank adapter, the wkv scan, per-head group
norm, output gate) + channel-mix (token-shift, squared-relu FFN with
receptance gating).  Decode keeps (wkv state, last hidden) per layer.

Griffin recurrent block = two branches from the residual stream:
gelu-gated branch, and conv1d → RG-LRU branch; multiplied and projected
out.  Gates are per-channel (diagonal), as in the reference.  Decode keeps
(lru state, conv tail).

The numerics are the reference's, casts included: the decay ``w`` and the
RG-LRU inputs are cast to the activation dtype before the scan, the
low-rank decay product ``dw @ wb`` is an f32 ``torch.matmul`` outside any
kernel, and the conv1d and gates are plain torch.  The projections go
through the matmul kernel and the scans through the rwkv6 (K3) and RG-LRU
(K4) kernels, via :mod:`repro_torch.kernels.ops`.  Blocks return fresh
cache dicts; they never write the cache they are given.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.kernels.ref import gelu
from repro_torch.models.common import dense_init, dtype_of, rmsnorm

DECAY_LORA = 64


# ---------------------------------------------------------------------------
# RWKV6
# ---------------------------------------------------------------------------


def rwkv_params(gen: torch.Generator, cfg: ArchConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    h, hd = cfg.n_heads, cfg.head_dim
    dt = dtype_of(cfg.dtype)
    dev = gen.device
    return {
        # time-mix
        "mu": torch.full((5, d), 0.5, dtype=dt, device=dev),   # shift mix for r,k,v,w,g
        "wr": dense_init(gen, d, d, dt),
        "wk": dense_init(gen, d, d, dt),
        "wv": dense_init(gen, d, d, dt),
        "wg": dense_init(gen, d, d, dt),
        "w0": torch.full((d,), -6.0, dtype=torch.float32, device=dev),  # base decay
        "wa": dense_init(gen, d, DECAY_LORA, dt),                # decay adapter
        "wb": dense_init(gen, DECAY_LORA, d, dt),
        "u": torch.randn((h, hd), generator=gen, device=dev) * 0.1,
        "ln_x": torch.ones((d,), dtype=dt, device=dev),         # per-head group norm scale
        "wo": dense_init(gen, d, d, dt),
        # channel-mix
        "mu_c": torch.full((2, d), 0.5, dtype=dt, device=dev),
        "ck": dense_init(gen, d, f, dt),
        "cv": dense_init(gen, f, d, dt),
        "cr": dense_init(gen, d, d, dt),
    }


def _token_shift(x: torch.Tensor, last: torch.Tensor) -> torch.Tensor:
    """shifted[t] = x[t-1]; position 0 takes `last` (decode carry)."""
    return torch.cat([last[:, None, :], x[:, :-1, :]], dim=1)


def init_rwkv_cache(cfg: ArchConfig, batch: int, device) -> dict:
    h, hd, d = cfg.n_heads, cfg.head_dim, cfg.d_model
    dt = dtype_of(cfg.dtype)
    return {
        "state": torch.zeros((batch, h, hd, hd), dtype=torch.float32, device=device),
        "last_tm": torch.zeros((batch, d), dtype=dt, device=device),
        "last_cm": torch.zeros((batch, d), dtype=dt, device=device),
    }


def _mix(xn: torch.Tensor, xs: torch.Tensor, mu: torch.Tensor, i: int) -> torch.Tensor:
    return (xn.float() * mu[i] + xs.float() * (1 - mu[i])).to(xn.dtype)


def rwkv_block(p: dict, cfg: ArchConfig, x: torch.Tensor, *,
               cache: dict | None, provider=None) -> tuple[torch.Tensor, dict | None]:
    """Full RWKV6 block (time-mix + channel-mix); it applies its own norms.
    x: (B, S, D) residual stream."""
    b, s, d = x.shape
    h, hd = cfg.n_heads, cfg.head_dim
    zeros = torch.zeros((d,), dtype=x.dtype, device=x.device)

    # ---- time mix ----
    xn = rmsnorm(x, zeros)
    last_tm = cache["last_tm"] if cache is not None else torch.zeros((b, d), dtype=x.dtype,
                                                                     device=x.device)
    xs = _token_shift(xn, last_tm)
    mu = p["mu"].float()
    r = ops.matmul(_mix(xn, xs, mu, 0), p["wr"], provider=provider).reshape(b, s, h, hd)
    k = ops.matmul(_mix(xn, xs, mu, 1), p["wk"], provider=provider).reshape(b, s, h, hd)
    v = ops.matmul(_mix(xn, xs, mu, 2), p["wv"], provider=provider).reshape(b, s, h, hd)
    g = ops.matmul(_mix(xn, xs, mu, 4), p["wg"], provider=provider)
    dw = torch.tanh(ops.matmul(_mix(xn, xs, mu, 3), p["wa"], provider=provider).float())
    dw = dw @ p["wb"].float()
    w = torch.exp(-torch.exp(p["w0"] + dw)).reshape(b, s, h, hd)   # decay in (0,1)

    def tr(a):  # (B, S, H, hd) -> (B, H, S, hd)
        return a.transpose(1, 2)

    state0 = cache["state"] if cache is not None else torch.zeros(
        (b, h, hd, hd), dtype=torch.float32, device=x.device)
    y, state = ops.rwkv6(tr(r), tr(k), tr(v), tr(w.to(x.dtype)), p["u"], state0,
                         provider=provider)
    y = y.transpose(1, 2).reshape(b, s, d)
    # per-head group norm + silu output gate
    yh = y.reshape(b, s, h, hd).float()
    yh = yh * torch.rsqrt(torch.mean(yh * yh, dim=-1, keepdim=True) + 1e-6)
    y = (yh.reshape(b, s, d) * p["ln_x"].float()).to(x.dtype)
    y = y * F.silu(g.float()).to(x.dtype)
    x = x + ops.matmul(y, p["wo"], provider=provider)

    # ---- channel mix ----
    xn2 = rmsnorm(x, zeros)
    last_cm = cache["last_cm"] if cache is not None else torch.zeros((b, d), dtype=x.dtype,
                                                                     device=x.device)
    xs2 = _token_shift(xn2, last_cm)
    mc = p["mu_c"].float()
    kk = ops.matmul(_mix(xn2, xs2, mc, 0), p["ck"], provider=provider)
    kk = torch.square(torch.relu(kk.float())).to(x.dtype)
    vv = ops.matmul(kk, p["cv"], provider=provider)
    rr = torch.sigmoid(ops.matmul(_mix(xn2, xs2, mc, 1), p["cr"], provider=provider).float())
    x = x + (rr * vv.float()).to(x.dtype)

    new_cache = None
    if cache is not None:
        new_cache = {"state": state, "last_tm": xn[:, -1, :].contiguous(),
                     "last_cm": xn2[:, -1, :].contiguous()}
    return x, new_cache


# ---------------------------------------------------------------------------
# Griffin / RG-LRU recurrent block
# ---------------------------------------------------------------------------


def griffin_params(gen: torch.Generator, cfg: ArchConfig) -> dict:
    d = cfg.d_model
    w = cfg.rnn_width or d
    dt = dtype_of(cfg.dtype)
    dev = gen.device
    return {
        "w_gate": dense_init(gen, d, w, dt),     # gelu branch
        "w_x": dense_init(gen, d, w, dt),        # recurrent branch input
        "conv": (torch.randn((cfg.conv_width, w), generator=gen, device=dev) * 0.1).to(dt),
        "lambda": torch.full((w,), 2.0, dtype=torch.float32, device=dev),  # a = sigmoid(λ)^(c·r_t)
        "gate_a": torch.zeros((w,), dtype=torch.float32, device=dev),      # diagonal recurrence gate
        "gate_i": torch.zeros((w,), dtype=torch.float32, device=dev),      # diagonal input gate
        "w_out": dense_init(gen, w, d, dt),
    }


def init_griffin_cache(cfg: ArchConfig, batch: int, device) -> dict:
    w = cfg.rnn_width or cfg.d_model
    dt = dtype_of(cfg.dtype)
    return {
        "h": torch.zeros((batch, w), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, w), dtype=dt, device=device),
    }


_RGLRU_C = 8.0


def _rglru_decay(xc: torch.Tensor, p: dict) -> torch.Tensor:
    """Per-step decay a_t ∈ (0,1): a = exp(c · log σ(λ) · σ(x·g_a))."""
    r = torch.sigmoid(xc.float() * p["gate_a"])
    log_a = _RGLRU_C * F.logsigmoid(p["lambda"]) * r
    return torch.exp(log_a)


def griffin_block(p: dict, cfg: ArchConfig, x: torch.Tensor, *,
                  cache: dict | None, provider=None) -> tuple[torch.Tensor, dict | None]:
    """Griffin recurrent block on the *normalized* input x: (B, S, D).
    Returns the block output (the caller adds the residual)."""
    b, s, d = x.shape
    gate = gelu(ops.matmul(x, p["w_gate"], provider=provider).float())
    xr = ops.matmul(x, p["w_x"], provider=provider)        # (B, S, W)

    # temporal conv1d (causal, width cw)
    cw = cfg.conv_width
    tail = cache["conv"] if cache is not None else torch.zeros(
        (b, cw - 1, xr.shape[-1]), dtype=xr.dtype, device=x.device)
    xpad = torch.cat([tail, xr], dim=1)                    # (B, S+cw-1, W)
    conv = sum(
        xpad[:, i:i + s, :].float() * p["conv"][i].float()
        for i in range(cw)
    ).to(xr.dtype)

    i_gate = torch.sigmoid(conv.float() * p["gate_i"])
    a = _rglru_decay(conv, p)
    h0 = cache["h"] if cache is not None else torch.zeros(
        (b, xr.shape[-1]), dtype=torch.float32, device=x.device)
    y, h_final = ops.rglru((i_gate * conv.float()).to(xr.dtype), a.to(xr.dtype), h0,
                           provider=provider)

    out = (y.float() * gate).to(x.dtype)
    out = ops.matmul(out, p["w_out"], provider=provider)

    new_cache = None
    if cache is not None:
        new_cache = {"h": h_final, "conv": xpad[:, xpad.shape[1] - (cw - 1):, :].contiguous()}
    return out, new_cache
