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

Under tensor-parallel compute (``distributed.context.tensor_parallel``)
the column-parallel products (rwkv6's ``wr``, ``wk``, ``wv``, ``wg``, the
decay adapter's ``wb``, ``ck``, ``cr``; griffin's ``w_gate``, ``w_x``)
give this rank's heads or channels, K3 runs on the local heads (``u`` is
local) and K4 on the local channels (``conv``, ``lambda`` and the gates
are local), and the replicated ``w0`` and ``ln_x`` are read at the local
columns.  The row-parallel products (``wo``, ``cv``, griffin's ``w_out``)
give partial sums, which ``common.row_parallel`` sums into the residual
stream (the channel mix's ``vv`` before the receptance gate, whose columns
are the rank's).  A sharded serving step's cache holds the rank's heads
(rwkv6's ``state``) or channels (griffin's ``h`` and ``conv``) and, for
``last_tm``/``last_cm``, the rank's D/m columns of the last normalized row
(``cache_leaf_sharding``'s layout): the next step all-gathers them
(``TensorParallel.gather_row``) before its token shift.

Under sequence parallelism (``distributed.context.sequence_parallel``,
prefill only) a rank holds S/m positions and every head and channel: the
token shift and the conv window read the previous rank's last rows
(``SequenceParallel.shift``), each scan starts from the state the previous
rank's ends with (``SequenceParallel.handoff``: the ranks' scans run one
after another), and the cache keeps this rank's part of the last rank's
final states (``SequenceParallel.from_last``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.context import block_io, gather_residual, sp_context, tp_context
from repro_torch.kernels import ops
from repro_torch.kernels.ref import gelu
from repro_torch.models.common import cast, dense_init, dtype_of, rmsnorm, row_parallel

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
    return cast(xn.float() * mu[i] + xs.float() * (1 - mu[i]), xn.dtype)


def split_dim(whole: torch.Tensor, part: torch.Tensor) -> int | None:
    """The dim along which a cache leaf ``part`` holds a block of
    ``whole`` (None: all of it)."""
    return next((d for d in range(whole.dim()) if whole.shape[d] != part.shape[d]), None)


def _carry_in(cache: dict | None, key: str, b: int, width: int, like: torch.Tensor):
    """The last normalized row a token shift starts from: zeros without a
    cache (and under sequence parallelism, whose prefill starts a fresh
    one); under tensor-parallel compute the cache's D/m columns gathered."""
    tp = tp_context()
    if cache is None or sp_context() is not None:
        return torch.zeros((b, width), dtype=like.dtype, device=like.device)
    return cache[key] if tp is None else tp.gather_row(cache[key]).to(like.dtype)


def _shifted(xn: torch.Tensor, last: torch.Tensor) -> torch.Tensor:
    """:func:`_token_shift`; under sequence parallelism a rank's first
    position takes the previous rank's last row."""
    sp = sp_context()
    if sp is not None:
        last = sp.shift(xn[:, -1], last)
    return _token_shift(xn, last)


def _carry_out(xn: torch.Tensor, part: torch.Tensor) -> torch.Tensor:
    """The cache's ``last_tm``/``last_cm`` after a step: the last
    normalized row, as the cache leaf ``part`` holds it."""
    tp, sp = tp_context(), sp_context()
    row = xn[:, -1, :]
    if sp is not None:
        return sp.from_last(row.contiguous(), split_dim(row, part))
    if tp is not None:
        row = tp.local(row)
    return row.contiguous()


def _final(state: torch.Tensor, part: torch.Tensor) -> torch.Tensor:
    """A scan's final state as the cache leaf ``part`` holds it (under
    sequence parallelism, this rank's block of the last rank's)."""
    sp = sp_context()
    if sp is None:
        return state
    return sp.from_last(state.contiguous(), split_dim(state, part))


def _scan(run, state0: torch.Tensor):
    """``run(state0)`` -> (out, final state); under sequence parallelism
    from the previous rank's final state."""
    sp = sp_context()
    return run(state0) if sp is None else sp.handoff(run, state0)


def rwkv_block(p: dict, cfg: ArchConfig, x: torch.Tensor, *,
               cache: dict | None, provider=None) -> tuple[torch.Tensor, dict | None]:
    """Full RWKV6 block (time-mix + channel-mix); it applies its own norms.
    x: (B, S, D) residual stream (under tensor-parallel compute, this
    rank's D/m of it)."""
    with block_io("rwkv"):
        return _rwkv_block(p, cfg, x, cache=cache, provider=provider)


def _rwkv_block(p: dict, cfg: ArchConfig, x: torch.Tensor, *,
                cache: dict | None, provider=None) -> tuple[torch.Tensor, dict | None]:
    b, s, d = x.shape[0], x.shape[1], cfg.d_model
    hd = cfg.head_dim
    tp = tp_context()
    dt = x.dtype
    zeros = torch.zeros((d,), dtype=dt, device=x.device)

    # ---- time mix ----
    xn = rmsnorm(gather_residual(x), zeros)
    xs = _shifted(xn, _carry_in(cache, "last_tm", b, d, xn))
    mu = p["mu"].float()
    r = ops.matmul(_mix(xn, xs, mu, 0), p["wr"], provider=provider).reshape(b, s, -1, hd)
    k = ops.matmul(_mix(xn, xs, mu, 1), p["wk"], provider=provider).reshape(b, s, -1, hd)
    v = ops.matmul(_mix(xn, xs, mu, 2), p["wv"], provider=provider).reshape(b, s, -1, hd)
    g = ops.matmul(_mix(xn, xs, mu, 4), p["wg"], provider=provider)
    dw = torch.tanh(ops.matmul(_mix(xn, xs, mu, 3), p["wa"], provider=provider).float())
    dw = dw @ p["wb"].float()
    w0, ln_x = (p["w0"], p["ln_x"]) if tp is None else (tp.cols(p["w0"]), tp.cols(p["ln_x"]))
    h, dl = r.shape[2], r.shape[2] * hd                             # the heads here
    w = torch.exp(-torch.exp(w0 + dw)).reshape(b, s, h, hd)         # decay in (0,1)

    def tr(a):  # (B, S, H, hd) -> (B, H, S, hd)
        return a.transpose(1, 2)

    state0 = cache["state"] if cache is not None and sp_context() is None else torch.zeros(
        (b, h, hd, hd), dtype=torch.float32, device=x.device)
    wd = w.to(dt)
    y, state = _scan(lambda s0: ops.rwkv6(tr(r), tr(k), tr(v), tr(wd), p["u"], s0,
                                          provider=provider), state0)
    y = y.transpose(1, 2).reshape(b, s, dl)
    # per-head group norm + silu output gate
    yh = y.reshape(b, s, h, hd).float()
    yh = yh * torch.rsqrt(torch.mean(yh * yh, dim=-1, keepdim=True) + 1e-6)
    y = (yh.reshape(b, s, dl) * ln_x.float()).to(dt)
    y = y * F.silu(g.float()).to(dt)
    x = x + row_parallel(y, p["wo"], provider=provider)

    # ---- channel mix ----
    xn2 = rmsnorm(gather_residual(x), zeros)
    xs2 = _shifted(xn2, _carry_in(cache, "last_cm", b, d, xn2))
    mc = p["mu_c"].float()
    kk = ops.matmul(_mix(xn2, xs2, mc, 0), p["ck"], provider=provider)
    kk = torch.square(torch.relu(kk.float())).to(dt)
    vv = row_parallel(kk, p["cv"], provider=provider)
    rr = torch.sigmoid(ops.matmul(_mix(xn2, xs2, mc, 1), p["cr"], provider=provider).float())
    x = x + (rr * vv.float()).to(dt)

    new_cache = None
    if cache is not None:
        new_cache = {"state": _final(state, cache["state"]),
                     "last_tm": _carry_out(xn, cache["last_tm"]),
                     "last_cm": _carry_out(xn2, cache["last_cm"])}
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
    Returns the block output (the caller adds the residual; under
    tensor-parallel compute, this rank's partial sums)."""
    b, s, d = x.shape
    gate = gelu(ops.matmul(x, p["w_gate"], provider=provider).float())
    xr = ops.matmul(x, p["w_x"], provider=provider)        # (B, S, W)

    # temporal conv1d (causal, width cw)
    cw = cfg.conv_width
    sp = sp_context()
    if cache is not None and sp is None:
        tail = cache["conv"]
    else:
        tail = torch.zeros((b, cw - 1, xr.shape[-1]), dtype=xr.dtype, device=x.device)
    if sp is not None:      # the previous rank's last cw - 1 rows of xr (every rank
        tail = sp.shift(xr[:, s - (cw - 1):], tail)     # holds as many: SequenceParallel)
    xpad = torch.cat([tail, xr], dim=1)                    # (B, S+cw-1, W)
    conv = sum(
        xpad[:, i:i + s, :].float() * p["conv"][i].float()
        for i in range(cw)
    ).to(xr.dtype)

    i_gate = torch.sigmoid(conv.float() * p["gate_i"])
    a = _rglru_decay(conv, p)
    h0 = cache["h"] if cache is not None and sp is None else torch.zeros(
        (b, xr.shape[-1]), dtype=torch.float32, device=x.device)
    xi, ai = (i_gate * conv.float()).to(xr.dtype), a.to(xr.dtype)
    y, h_final = _scan(lambda h: ops.rglru(xi, ai, h, provider=provider), h0)

    out = (y.float() * gate).to(xr.dtype)
    out = row_parallel(out, p["w_out"], provider=provider)

    new_cache = None
    if cache is not None:
        new_cache = {"h": _final(h_final, cache["h"]),
                     "conv": _final(xpad[:, xpad.shape[1] - (cw - 1):, :].contiguous(),
                                    cache["conv"])}
    return out, new_cache
