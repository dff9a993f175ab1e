"""Attention blocks: GQA projections, RoPE, global + local/SWA variants,
logit softcapping and KV caches (the counterpart of
``repro.models.attention``).

* ``attn_forward`` — full sequence (prefill): the projections go through the
  matmul kernel, the attention through the flash-attention kernel.
* ``attn_chunk`` — one prefill chunk at absolute offset ``off`` against a
  partially filled cache (the paged engine's chunked prefill): full-length
  caches through the flash-attention kernel with ``q_offset=off``, ring
  caches through a masked plain attention over [ring ‖ chunk].
* ``attn_decode`` — one token per slot against the cache, at per-slot
  positions.  The masked decode attention is plain torch, as the reference's
  is plain jnp.
* ``attn_verify`` — k+1 speculative positions per lane at per-lane offsets:
  the decode attention applied once per position, so verify takes decode's
  bits.
* ``init_attn_cache`` — full cache for global layers, window-sized ring for
  local/SWA layers.

Under tensor-parallel compute (``distributed.context.tensor_parallel``)
``wq``, ``wk`` and ``wv`` are this rank's columns: q and K/V hold the
rank's heads (:func:`_qkv`; where KV heads are whole on every rank, the
run its q heads read: :func:`kv_for`), and the output that ``wo``'s local
rows take is those heads' columns (:func:`out_cols`; where every head is
computed whole, the rank's slice of them).  ``wo`` is a row-parallel
product (``common.row_parallel``): its partial sums go into the residual
stream.  A sharded serving step's caches are this rank's shards by
``cache_leaf_sharding`` (:func:`cache_part` writes them): the rank's KV
heads, or where ``model`` does not split the KV heads but splits
``head_dim``, the rank's ``head_dim`` slice of every KV head
(recurrentgemma's one KV head).  Decode then contracts the rank's q slice
against its K slice and sums the scores over ``model``
(:func:`_split_decode_attention`): (B, H, 1, S) f32 scores a step, where
gathering the cache would move the whole cache.  Where a serving batch's
rows do not split over the fsdp axes, each rank holds all of them and its
block of every K/V cache's positions (``TensorParallel.kv_seq``): prefill
keeps its block, decode writes a row on the rank that holds its slot and
merges the softmax over the fsdp axes (:func:`_attend`).

Under sequence parallelism (``distributed.context.sequence_parallel``) a
prefill holds this rank's S/m positions: K and V are all-gathered along S,
the rank's queries attend at ``q_offset`` (flash attention's causal,
window and softcap masks), and the cache is written from the gathered K
and V, which hold the whole prompt.

Unlike the reference, which is functional, the caches are updated in place:
``attn_forward`` writes the prefix of the (fresh) cache it is given,
``attn_chunk`` the chunk's rows (ring caches: after attention),
``attn_decode`` one row per slot and ``attn_verify`` k+1 rows per lane of
the cache they are given.  Each returns the cache dict it wrote, holding
the tensors it was given.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.context import sp_context, tp_context
from repro_torch.kernels import ops
from repro_torch.models.common import apply_rope, dense_init, dtype_of, row_parallel


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
    """(B, S, D) -> q (B, H, S, hd), k/v (B, KV, S, hd): the heads this rank
    computes under tensor-parallel compute (:func:`kv_for` gives the KV
    heads its q heads read)."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    q = ops.matmul(x, p["wq"], provider=provider).reshape(b, s, -1, hd).transpose(1, 2)
    k = ops.matmul(x, p["wk"], provider=provider).reshape(b, s, -1, hd).transpose(1, 2)
    v = ops.matmul(x, p["wv"], provider=provider).reshape(b, s, -1, hd).transpose(1, 2)
    return q, k, v


def kv_for(cfg: ArchConfig, q: torch.Tensor, kv: torch.Tensor) -> torch.Tensor:
    """K or V (B, KV, S, hd) for q's heads: under tensor-parallel compute with
    q heads local and KV heads computed whole, the contiguous run of KV
    heads this rank's q heads read (one ratio:
    ``sharding.attn_heads_local``)."""
    tp = tp_context()
    if tp is None or not tp.q_local or tp.kv_local:
        return kv
    per, group = q.shape[1], cfg.n_heads // cfg.n_kv_heads
    k0 = tp.rank * per // group
    return kv[:, k0:k0 + max(1, per // group)]


def cache_part(kv: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The part of ``kv`` (B, KV, S, hd: the KV heads this rank computed)
    that a cache shaped like ``like`` holds: all of it, this rank's block
    of the heads (sequence parallelism computes every head) or its block of
    ``head_dim`` (tensor parallelism where ``model`` splits ``head_dim``)."""
    heads, hd = like.shape[1], like.shape[3]
    if (heads, hd) == (kv.shape[1], kv.shape[3]):
        return kv
    ctx = tp_context() or sp_context()
    r = ctx.rank
    if heads != kv.shape[1]:
        return kv[:, r * heads:(r + 1) * heads]
    return kv[..., r * hd:(r + 1) * hd]


def out_cols(out: torch.Tensor) -> torch.Tensor:
    """The attention output (B, S, heads·hd) -> the columns ``wo``'s rows
    take: all of them, or under tensor-parallel compute with every head
    computed whole, this rank's slice."""
    tp = tp_context()
    return out if tp is None or tp.q_local else tp.cols(out)


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
    """x: (B, S, D) normalized input. Returns (attn_out, cache written)
    (under sequence parallelism, this rank's S/m positions)."""
    b, s, _ = x.shape
    q, k, v = _qkv(p, cfg, x, provider)
    q, k = _rope_qk(cfg, q, k, positions)

    sp = sp_context()
    q_offset = 0
    if sp is not None:      # the whole sequence's K and V
        k, v, q_offset = sp.gather_seq(k), sp.gather_seq(v), sp.offset
    window = cfg.window if kind == "L" else 0
    out = ops.flash_attention(
        q, kv_for(cfg, q, k), kv_for(cfg, q, v),
        class_id=_attn_class(cfg, kind),
        causal=True,
        window=window,
        softcap=cfg.attn_softcap if kind == "G" else 0.0,
        q_offset=q_offset,
        provider=provider,
    )
    out = out_cols(out.transpose(1, 2).reshape(b, s, -1))
    y = row_parallel(out, p["wo"], provider=provider)

    if cache is None:
        return y, None
    k, v = cache_part(k, cache["k"]), cache_part(v, cache["v"])
    seq = _kv_seq()
    whole = cache
    if seq is not None:         # the whole cache, then this rank's block of it
        shape = list(cache["k"].shape)
        shape[2] *= seq[0]
        whole = {n: torch.zeros(shape, dtype=cache[n].dtype, device=cache[n].device)
                 for n in ("k", "v")}
    s = k.shape[2]
    size = _cache_size(whole)
    if size >= s:
        whole["k"][:, :, :s] = k.to(whole["k"].dtype)
        whole["v"][:, :, :s] = v.to(whole["v"].dtype)
    else:  # ring prefill: keep the last `size` positions, slot convention p % size
        shift = (s - size) % size
        whole["k"].copy_(torch.roll(k[:, :, s - size:, :], shift, dims=2))
        whole["v"].copy_(torch.roll(v[:, :, s - size:, :], shift, dims=2))
    if seq is not None:
        n = _cache_size(cache)
        for name in ("k", "v"):
            cache[name].copy_(whole[name][:, :, seq[1] * n:(seq[1] + 1) * n])
    return y, cache


def _kv_seq():
    """The K/V caches' split of S over the fsdp axes, or None."""
    tp = tp_context()
    return None if tp is None else tp.kv_seq


# ---------------------------------------------------------------------------
# Chunked prefill (a prompt slice against a partially filled cache)
# ---------------------------------------------------------------------------


def attn_chunk(p: dict, cfg: ArchConfig, x: torch.Tensor, kind: str, *,
               positions: torch.Tensor, off: int, cache: dict,
               provider=None) -> tuple[torch.Tensor, dict]:
    """One prefill chunk: queries at absolute positions ``off .. off+C-1``
    attend to the cache prefix (positions ``< off``) plus the chunk itself.

    Full-length caches get the chunk written at ``[off, off+C)`` before one
    causal pass of the flash-attention kernel over the whole buffer with
    ``q_offset=off`` (rows beyond ``off+C`` hold garbage the causal mask
    hides); so does a ring shorter than its window, which never wraps.
    Other ring caches attend over [ring prefix ‖ chunk] under explicit
    position masks and are written *after* attention: writing a chunk into
    the ring first would overwrite positions earlier queries still need.
    """
    b, s, _ = x.shape
    off = int(off)
    dev = x.device
    q, k, v = _qkv(p, cfg, x, provider)
    q, k = _rope_qk(cfg, q, k, positions)
    k, v = kv_for(cfg, q, k), kv_for(cfg, q, v)

    size = _cache_size(cache)
    window = cfg.window if kind == "L" else 0
    softcap = cfg.attn_softcap if kind == "G" else 0.0
    ck, cv = cache["k"], cache["v"]
    if kind == "G" or cfg.window == 0 or cfg.window > size:
        # a full-length cache, keyed as the reference keys it (Q = C, KV =
        # the cache length, window 0); or a ring shorter than its window
        # (mixtral's 4096 in a 512-token context), which never wraps: each
        # position sits in its own slot and the window never bites, so its
        # rows sum as one-shot prefill's, under the layer's window.  The
        # reference keeps its ring branch there: the same values, summed
        # otherwise
        ck[:, :, off:off + s] = k.to(ck.dtype)
        cv[:, :, off:off + s] = v.to(cv.dtype)
        out = ops.flash_attention(q, ck, cv, class_id=_attn_class(cfg, kind), causal=True,
                                  window=window, softcap=softcap, q_offset=off, provider=provider)
    else:
        # ring (slot convention p % size): each slot's absolute position is
        # the latest p < off congruent to it (< 0: never written)
        slots = torch.arange(size, device=dev)
        ring_pos = off - 1 - torch.remainder(off - 1 - slots, size)
        chunk_pos = off + torch.arange(s, device=dev)
        kv_pos = torch.cat([ring_pos, chunk_pos])
        ok = (kv_pos[None, :] >= 0) & (kv_pos[None, :] <= chunk_pos[:, None])
        if window > 0:
            ok &= kv_pos[None, :] > chunk_pos[:, None] - window
        kk = torch.cat([ck.to(k.dtype), k], dim=2)
        vv = torch.cat([cv.to(v.dtype), v], dim=2)
        out = _masked_chunk_attention(q, kk, vv, ok, softcap=softcap)
        # write after attention: slot (off+i) % size takes position off+i,
        # later positions winning on wrap
        if s >= size:
            shift = (off + s) % size
            ck.copy_(torch.roll(k[:, :, s - size:], shift, dims=2))
            cv.copy_(torch.roll(v[:, :, s - size:], shift, dims=2))
        else:
            wslots = torch.remainder(chunk_pos, size)
            ck[:, :, wslots] = k.to(ck.dtype)
            cv[:, :, wslots] = v.to(cv.dtype)
    out = out.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.head_dim)
    y = row_parallel(out, p["wo"], provider=provider)
    return y, cache


def _masked_chunk_attention(q, k, v, valid_mask, softcap: float = 0.0):
    """Multi-query attention with an explicit (C, T) validity mask: the
    chunk analogue of :func:`_masked_decode_attention` (ring semantics need
    per-position masks the flash kernel's causal/window params cannot say)."""
    b, hq, c, d = q.shape
    hkv = k.shape[1]
    group = hq // hkv
    qg = q.reshape(b, hkv, group, c, d).float() * d ** -0.5
    s = torch.einsum("bhgqd,bhtd->bhgqt", qg, k.float())
    if softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    s = torch.where(valid_mask[None, None, None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqt,bhtd->bhgqd", p, v.float())
    return o.reshape(b, hq, c, d).to(q.dtype)


# ---------------------------------------------------------------------------
# Decode (single token against cache)
# ---------------------------------------------------------------------------


def attn_decode(p: dict, cfg: ArchConfig, x: torch.Tensor, kind: str, *,
                pos: torch.Tensor, cache: dict, provider=None) -> tuple[torch.Tensor, dict]:
    """x: (B, 1, D); pos: (B,) per-slot absolute positions (every slot may
    be at a different decode position).  Under tensor-parallel compute the
    cache is this rank's shard (see the module)."""
    b = x.shape[0]
    pos = torch.broadcast_to(pos.to(torch.long), (b,))
    q, k, v = _qkv(p, cfg, x, provider)
    q, k = _rope_qk(cfg, q, k, pos[:, None])

    ck, cv = cache["k"], cache["v"]
    k, v = cache_part(k, ck), cache_part(v, cv)
    seq = _kv_seq()
    local = _cache_size(cache)
    size, first = (local, 0) if seq is None else (local * seq[0], seq[1] * local)
    slot = torch.where(pos < size, pos, pos % size)          # (B,) ring for local
    bi = torch.arange(b, device=x.device)[:, None]
    hi = torch.arange(ck.shape[1], device=x.device)[None, :]
    kn, vn = k[:, :, 0, :].to(ck.dtype), v[:, :, 0, :].to(cv.dtype)
    if seq is not None:     # only the rank that holds a row's slot writes it
        mine = ((slot >= first) & (slot < first + local))[:, None, None]
        slot = torch.where(mine[:, 0, 0], slot - first, 0)
        kn = torch.where(mine, kn, ck[bi, hi, slot[:, None]])
        vn = torch.where(mine, vn, cv[bi, hi, slot[:, None]])
    ck[bi, hi, slot[:, None]] = kn
    cv[bi, hi, slot[:, None]] = vn

    window = cfg.window if kind == "L" else 0
    slots = first + torch.arange(local, device=x.device)[None, :]     # (1, local)
    if window and size <= window:
        # ring cache: live slots hold the last `size` (<= window) positions,
        # so only not-yet-written slots need masking
        valid = slots < torch.clamp(pos + 1, max=size)[:, None]
        softcap = 0.0
    else:
        valid = slots <= pos[:, None]
        softcap = cfg.attn_softcap if kind == "G" else 0.0
    if ck.shape[-1] < cfg.head_dim:
        out = _split_decode_attention(q, ck, cv, valid, softcap, cfg)
    else:
        out = _masked_decode_attention(q, kv_for(cfg, q, ck), kv_for(cfg, q, cv), valid,
                                       softcap=softcap)
    out = out_cols(out.transpose(1, 2).reshape(b, 1, -1))
    y = row_parallel(out, p["wo"], provider=provider)
    return y, cache


def _split_decode_attention(q, ck, cv, valid_mask, softcap: float, cfg: ArchConfig):
    """Decode attention over a cache whose ``head_dim`` ``model`` splits:
    ``ck``/``cv`` (B, KV, size, hd/m) hold this rank's slice of every KV
    head.  Every rank takes every q head (an all-gather of q over
    ``model`` where each computed its own), contracts its q slice against
    its K slice, and the scores (B, KV, group, size) are summed over
    ``model`` in f32; the softmax is then every rank's, each weighs its V
    slice, and the slices of the output are all-gathered.  Returns the
    output of the heads this rank computed."""
    tp = tp_context()
    r, hd_l = tp.rank, ck.shape[-1]
    q_all = tp.gather_dim(q, 1) if tp.q_local else q
    b, hq, _, d = q_all.shape
    hkv = ck.shape[1]
    qg = q_all[..., r * hd_l:(r + 1) * hd_l].reshape(b, hkv, hq // hkv, hd_l).float() * d ** -0.5
    s = tp.sum_over_model(torch.einsum("bhgd,bhkd->bhgk", qg, ck.float()))
    if softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    s = torch.where(valid_mask[:, None, None, :], s, -1e30)
    o = tp.gather_dim(_attend(s, cv.float()), 3).reshape(b, hq, 1, d).to(q.dtype)
    if tp.q_local:
        per = q.shape[1]
        return o[:, r * per:(r + 1) * per]
    return o


# ---------------------------------------------------------------------------
# Speculative verify (k+1 draft positions against cache, per-lane offsets)
# ---------------------------------------------------------------------------


def attn_verify(p: dict, cfg: ArchConfig, x: torch.Tensor, kind: str, *,
                off: torch.Tensor, cache: dict, provider=None) -> tuple[torch.Tensor, dict]:
    """x: (B, C, D); off: (B,) per-lane absolute write offsets.

    The speculative analogue of :func:`attn_chunk`, batched across lanes
    that each sit at a different cache offset: all C rows are written at
    ``off .. off+C-1``, then each position attends to the slots at or before
    it.  Rows beyond a lane's committed length may hold rejected positions
    from an earlier burst; the validity mask hides them and later steps
    overwrite them in order.  Full-length caches only (callers gate on
    :func:`repro_torch.serving.speculative.spec_exact_reason`)."""
    b, s, _ = x.shape
    dev = x.device
    off = torch.broadcast_to(torch.as_tensor(off, device=dev).long(), (b,))
    q, k, v = _qkv(p, cfg, x, provider)
    positions = off[:, None] + torch.arange(s, device=dev)   # (B, C)
    q, k = _rope_qk(cfg, q, k, positions)
    k, v = kv_for(cfg, q, k), kv_for(cfg, q, v)

    size = _cache_size(cache)
    bi = torch.arange(b, device=dev)[:, None, None]
    hi = torch.arange(cfg.n_kv_heads, device=dev)[None, :, None]
    rows = positions[:, None, :]                              # (B, 1, C)
    ck, cv = cache["k"], cache["v"]
    ck[bi, hi, rows] = k.to(ck.dtype)
    cv[bi, hi, rows] = v.to(cv.dtype)

    slots = torch.arange(size, device=dev)
    ok = slots[None, None, :] <= positions[:, :, None]       # (B, C, T)
    out = _masked_verify_attention(q, ck, cv, ok,
                                   softcap=cfg.attn_softcap if kind == "G" else 0.0)
    out = out.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.head_dim)
    y = row_parallel(out, p["wo"], provider=provider)
    return y, cache


def _masked_verify_attention(q, k, v, valid_mask, softcap: float = 0.0):
    """Multi-query attention with a per-lane (B, C, T) validity mask: the
    decode attention applied once per verify position with that position's
    (B, T) mask.  Each product then has decode's shapes, so it reduces in
    decode's order and a verify position takes the bits plain decode would
    (a batched product of another shape may be split otherwise)."""
    kf, vf = k.float(), v.float()
    return torch.cat([_decode_attention_f32(q[:, :, j:j + 1], kf, vf, valid_mask[:, j], softcap)
                      for j in range(q.shape[2])], dim=2)


def _masked_decode_attention(q, k, v, valid_mask, softcap: float = 0.0):
    """Single-query attention over the whole cache with an explicit (B, size)
    validity mask (causal prefix and ring-buffer semantics)."""
    return _decode_attention_f32(q, k.float(), v.float(), valid_mask, softcap)


def _decode_attention_f32(q, kf, vf, valid_mask, softcap: float):
    """:func:`_masked_decode_attention` on a cache already cast to f32."""
    b, hq, _, d = q.shape
    hkv = kf.shape[1]
    group = hq // hkv
    qg = q.reshape(b, hkv, group, d).float() * d ** -0.5
    s = torch.einsum("bhgd,bhkd->bhgk", qg, kf)
    if softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    s = torch.where(valid_mask[:, None, None, :], s, -1e30)
    return _attend(s, vf).reshape(b, hq, 1, d).to(q.dtype)


def merge_blocks(o: torch.Tensor, lse: torch.Tensor) -> torch.Tensor:
    """Attention over this rank's block of the keys -> over all of them,
    where the blocks are split over the fsdp axes (:func:`_kv_seq`): ``o``
    (..., d) and its rows' log-sum-exp ``lse`` (...) f32; the maxima
    all-reduced, then each block's weight and weighted output summed in one
    all-reduce."""
    tp = tp_context()
    w = torch.exp(lse - tp.seq_reduce(lse, "max"))[..., None]
    part = tp.seq_reduce(torch.cat([w, w * o.float()], dim=-1))
    return (part[..., 1:] / part[..., :1]).to(o.dtype)


def _attend(s: torch.Tensor, vf: torch.Tensor) -> torch.Tensor:
    """softmax(s) · v over the cache's positions, (B, KV, group, d).  Where
    the caches' S is split over the fsdp axes (:func:`_kv_seq`), the softmax
    is merged over them (:func:`merge_blocks`)."""
    o = torch.einsum("bhgk,bhkd->bhgd", torch.softmax(s, dim=-1), vf)
    return o if _kv_seq() is None else merge_blocks(o, torch.logsumexp(s, dim=-1))
