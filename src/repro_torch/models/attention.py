"""Attention blocks: GQA projections, RoPE, global + local/SWA variants,
logit softcapping and KV caches (the counterpart of
``repro.models.attention``).

* ``attn_forward`` — full sequence (prefill): the projections go through the
  matmul kernel, the attention through the flash-attention kernel.
* ``attn_decode`` — one token per slot against the cache, at per-slot
  positions.  The masked decode attention is plain torch, as the reference's
  is plain jnp.
* ``init_attn_cache`` — full cache for global layers, window-sized ring for
  local/SWA layers.

Unlike the reference, which is functional, the caches are updated in place:
``attn_forward`` writes the prefix of the (fresh) cache it is given, and
``attn_decode`` writes one row per slot of the cache it is given.  Both
return the cache dict they wrote.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models.common import apply_rope, dense_init, dtype_of


def attn_params(gen: torch.Generator, cfg: ArchConfig) -> dict:
    d, hd = cfg.d_model, cfg.head_dim
    dt = dtype_of(cfg.dtype)
    return {
        "wq": dense_init(gen, d, cfg.n_heads * hd, dt),
        "wk": dense_init(gen, d, cfg.n_kv_heads * hd, dt),
        "wv": dense_init(gen, d, cfg.n_kv_heads * hd, dt),
        "wo": dense_init(gen, cfg.n_heads * hd, d, dt),
    }


def _attn_class(cfg: ArchConfig, kind: str) -> str:
    if kind == "L":
        return "flash_attention_swa" if len(set(cfg.layer_kinds)) == 1 else "flash_attention_local"
    if cfg.attn_softcap > 0:
        return "flash_attention_softcap"
    return "flash_attention_causal"


def _qkv(p: dict, cfg: ArchConfig, x: torch.Tensor, provider):
    """(B, S, D) -> q (B, H, S, hd), k/v (B, KV, S, hd)."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    q = ops.matmul(x, p["wq"], provider=provider).reshape(b, s, cfg.n_heads, hd).transpose(1, 2)
    k = ops.matmul(x, p["wk"], provider=provider).reshape(b, s, cfg.n_kv_heads, hd).transpose(1, 2)
    v = ops.matmul(x, p["wv"], provider=provider).reshape(b, s, cfg.n_kv_heads, hd).transpose(1, 2)
    return q, k, v


def _rope_qk(cfg: ArchConfig, q, k, positions):
    if cfg.pos != "rope":
        return q, k
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta))


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------


def init_attn_cache(cfg: ArchConfig, kind: str, batch: int, max_len: int, device) -> dict:
    """Full cache for global layers; window-sized ring for local/SWA."""
    size = max_len if (kind == "G" or cfg.window == 0) else min(cfg.window, max_len)
    dt = dtype_of(cfg.dtype)
    shape = (batch, cfg.n_kv_heads, size, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def _cache_size(cache: dict) -> int:
    return cache["k"].shape[2]


# ---------------------------------------------------------------------------
# Forward (prefill)
# ---------------------------------------------------------------------------


def attn_forward(p: dict, cfg: ArchConfig, x: torch.Tensor, kind: str, *,
                 positions: torch.Tensor, provider=None,
                 cache: dict | None = None) -> tuple[torch.Tensor, dict | None]:
    """x: (B, S, D) normalized input. Returns (attn_out, cache written)."""
    b, s, _ = x.shape
    q, k, v = _qkv(p, cfg, x, provider)
    q, k = _rope_qk(cfg, q, k, positions)

    window = cfg.window if kind == "L" else 0
    out = ops.flash_attention(
        q, k, v,
        class_id=_attn_class(cfg, kind),
        causal=True,
        window=window,
        softcap=cfg.attn_softcap if kind == "G" else 0.0,
        provider=provider,
    )
    out = out.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.head_dim)
    y = ops.matmul(out, p["wo"], provider=provider)

    if cache is None:
        return y, None
    size = _cache_size(cache)
    if size >= s:
        cache["k"][:, :, :s] = k.to(cache["k"].dtype)
        cache["v"][:, :, :s] = v.to(cache["v"].dtype)
    else:  # ring prefill: keep the last `size` positions, slot convention p % size
        shift = (s - size) % size
        cache["k"].copy_(torch.roll(k[:, :, s - size:, :], shift, dims=2))
        cache["v"].copy_(torch.roll(v[:, :, s - size:, :], shift, dims=2))
    return y, cache


# ---------------------------------------------------------------------------
# Decode (single token against cache)
# ---------------------------------------------------------------------------


def attn_decode(p: dict, cfg: ArchConfig, x: torch.Tensor, kind: str, *,
                pos: torch.Tensor, cache: dict, provider=None) -> tuple[torch.Tensor, dict]:
    """x: (B, 1, D); pos: (B,) per-slot absolute positions (every slot may
    be at a different decode position)."""
    b = x.shape[0]
    pos = torch.broadcast_to(pos.to(torch.long), (b,))
    q, k, v = _qkv(p, cfg, x, provider)
    q, k = _rope_qk(cfg, q, k, pos[:, None])

    size = _cache_size(cache)
    slot = torch.where(pos < size, pos, pos % size)          # (B,) ring for local
    bi = torch.arange(b, device=x.device)[:, None]
    hi = torch.arange(cfg.n_kv_heads, device=x.device)[None, :]
    ck, cv = cache["k"], cache["v"]
    ck[bi, hi, slot[:, None]] = k[:, :, 0, :].to(ck.dtype)
    cv[bi, hi, slot[:, None]] = v[:, :, 0, :].to(cv.dtype)

    window = cfg.window if kind == "L" else 0
    slots = torch.arange(size, device=x.device)[None, :]     # (1, size)
    if window and size <= window:
        # ring cache: live slots hold the last `size` (<= window) positions,
        # so only not-yet-written slots need masking
        valid = slots < torch.clamp(pos + 1, max=size)[:, None]
        out = _masked_decode_attention(q, ck, cv, valid)
    else:
        valid = slots <= pos[:, None]
        out = _masked_decode_attention(q, ck, cv, valid,
                                       softcap=cfg.attn_softcap if kind == "G" else 0.0)
    out = out.transpose(1, 2).reshape(b, 1, cfg.n_heads * cfg.head_dim)
    y = ops.matmul(out, p["wo"], provider=provider)
    return y, cache


def _masked_decode_attention(q, k, v, valid_mask, softcap: float = 0.0):
    """Single-query attention over the whole cache with an explicit (B, size)
    validity mask (causal prefix and ring-buffer semantics)."""
    b, hq, _, d = q.shape
    hkv = k.shape[1]
    group = hq // hkv
    qg = q.reshape(b, hkv, group, d).float() * d ** -0.5
    s = torch.einsum("bhgd,bhkd->bhgk", qg, k.float())
    if softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    s = torch.where(valid_mask[:, None, None, :], s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bhkd->bhgd", p, v.float())
    return o.reshape(b, hq, 1, d).to(q.dtype)
