"""Encoder-decoder model, the whisper-medium backbone (the counterpart of
``repro.models.encdec``).

The conv/mel frontend is a stub, as in the reference: ``batch["frames"]``
holds precomputed frame embeddings (B, encoder_seq, D).  The encoder is a
stack of bidirectional attention blocks (flash attention with
``causal=False``, class ``flash_attention_bidir``); each decoder block runs
causal self-attention, cross-attention to the encoder's output (class
``flash_attention_cross``, also ``causal=False``) and the MLP.  Positions are
learned tables: ``enc_pos`` added to the frames, ``dec_pos`` to the token
embeddings (per slot at decode).

The reference stacks the encoder's and the decoder's layer params along a
leading axis and scans them; here ``params["encoder"]`` and
``params["decoder"]`` are lists in layer order and a Python loop walks them,
as :mod:`repro_torch.models.lm` walks its layers
(:func:`repro_torch.convert.params_from_jax` unstacks the reference's).

Serving: prefill computes each layer's cross K/V once and keeps them in the
cache, ``{"layers": [{"self": {"k", "v"}, "cross_k", "cross_v"}, ...],
"t"}`` with ``cross_k``/``cross_v`` of shape (B, Hkv, encoder_seq, hd);
every decode step attends to them.  Self-attention caches are written in
place, as in :mod:`repro_torch.models.attention`.  The audio family has no
chunked prefill and no speculative verify.

Training: ``forward`` and ``loss_fn`` take ``remat``: under autograd each
encoder and decoder layer runs under ``torch.utils.checkpoint``, as the
reference wraps each scanned layer in ``jax.checkpoint``
(:func:`repro_torch.models.lm.rematted`).  Under tensor-parallel compute
(``distributed.context.tensor_parallel``) both stacks keep the residual
stream's D/m columns, every block all-gathers it before each norm and
reduce-scatters each row-parallel product into it, as the decoder-only
blocks do; the encoder's output is gathered whole before its norm, so
every rank projects its own cross K/V heads from it.  A sharded serving
step (``launch.steps.make_sharded_serve_step``) gathers the params in
:func:`prefill` and :func:`decode_step` and keeps this rank's shards of the
self and cross K/V caches (``cache_leaf_sharding``: heads over ``model``).
Where the batch's rows do not split over the fsdp axes
(``TensorParallel.kv_seq``) every rank runs the encoder on the whole row,
projects cross K/V from its block of the frames (where they split over
those axes; whole where they do not) and merges the cross attention's
softmax over the axes (:func:`_cross_attend`).

Under sequence parallelism (``distributed.context.sequence_parallel``,
prefill) the frames are a sequence of their own: each rank runs the
encoder on its block of them (``SequenceParallel.over``), its blocks
attending to K and V gathered along the frames, and the encoder's output
is gathered whole after its norm; the decoder takes the rank's block of
the prompt, as the decoder-only families do, its cross attention over the
whole frames, the cache keeping the rank's heads.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.context import (block_io, cache_layout, gather_residual,
                                             local_residual, param_gather, sequence_parallel,
                                             sp_context, tp_context)
from repro_torch.kernels import ops
from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlpm
from repro_torch.models.common import (apply_norm, dense_init, dtype_of, embed_init, norm_params,
                                       row_parallel)
from repro_torch.models.lm import gather_top, gathered, lookup, next_token_nll, once, rematted

MAX_DECODE_POS = 32768  # learned position table size, the reference's


def _enc_block_params(gen: torch.Generator, cfg: ArchConfig) -> dict:
    dt, dev = dtype_of(cfg.dtype), gen.device
    return {
        "ln1": norm_params(cfg.d_model, cfg.norm, dt, dev),
        "attn": attn.attn_params(gen, cfg),
        "ln2": norm_params(cfg.d_model, cfg.norm, dt, dev),
        "mlp": mlpm.mlp_params(gen, cfg),
    }


def _dec_block_params(gen: torch.Generator, cfg: ArchConfig) -> dict:
    dt, dev = dtype_of(cfg.dtype), gen.device
    return {
        "ln1": norm_params(cfg.d_model, cfg.norm, dt, dev),
        "self_attn": attn.attn_params(gen, cfg),
        "ln_x": norm_params(cfg.d_model, cfg.norm, dt, dev),
        "cross_attn": attn.attn_params(gen, cfg),
        "ln2": norm_params(cfg.d_model, cfg.norm, dt, dev),
        "mlp": mlpm.mlp_params(gen, cfg),
    }


def _pos_init(gen: torch.Generator, n: int, d: int, dtype) -> torch.Tensor:
    return torch.randn((n, d), generator=gen, device=gen.device).mul_(0.01).to(dtype)


def init_params(cfg: ArchConfig, gen: torch.Generator) -> dict:
    """Random params drawn from ``gen`` on ``gen.device``."""
    dt, dev = dtype_of(cfg.dtype), gen.device
    return {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dt),
        "enc_pos": _pos_init(gen, cfg.encoder_seq, cfg.d_model, dt),
        "dec_pos": _pos_init(gen, MAX_DECODE_POS, cfg.d_model, dt),
        "encoder": [_enc_block_params(gen, cfg) for _ in range(cfg.encoder_layers)],
        "enc_norm": norm_params(cfg.d_model, cfg.norm, dt, dev),
        "decoder": [_dec_block_params(gen, cfg) for _ in range(cfg.n_layers)],
        "final_norm": norm_params(cfg.d_model, cfg.norm, dt, dev),
        "lm_head": dense_init(gen, cfg.d_model, cfg.vocab_size, dt),
    }


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------


def enc_block(p: dict, cfg: ArchConfig, h: torch.Tensor, provider=None) -> torch.Tensor:
    """One encoder block: bidirectional self-attention, then the MLP (under
    sequence parallelism the rank's frames attend to K and V gathered along
    all of them)."""
    b, s, _ = h.shape
    with block_io("mixer_ffn"):
        xn = apply_norm(p["ln1"], gather_residual(h), cfg.norm)
        q, k, v = attn._qkv(p["attn"], cfg, xn, provider)
        sp = sp_context()
        if sp is not None:
            k, v = sp.gather_seq(k), sp.gather_seq(v)
        o = ops.flash_attention(q, attn.kv_for(cfg, q, k), attn.kv_for(cfg, q, v),
                                class_id="flash_attention_bidir", causal=False, provider=provider)
        o = attn.out_cols(o.transpose(1, 2).reshape(b, s, -1))
        h = h + row_parallel(o, p["attn"]["wo"], provider=provider)
        xn2 = apply_norm(p["ln2"], gather_residual(h), cfg.norm)
        return h + mlpm.mlp_apply(p["mlp"], cfg, xn2, provider=provider)


def encode(params: dict, cfg: ArchConfig, frames: torch.Tensor, provider=None,
           remat: bool = False, gather=None) -> torch.Tensor:
    """frames: (B, enc_seq, D) stub embeddings -> encoder hidden states.
    ``gather``: each layer's params gathered inside its remat (sharded
    training, :func:`repro_torch.models.lm.gathered`).  Under sequence
    parallelism the rank's block of the frames runs, and the output is
    gathered whole."""
    sp = sp_context()
    off = 0
    if sp is not None:
        sp = sp.over(frames.shape[1])
        off, frames = sp.offset, frames[:, sp.offset:sp.offset + sp.local]
    h = local_residual(frames.to(dtype_of(cfg.dtype))
                       + params["enc_pos"][None, off:off + frames.shape[1]])
    block = rematted(gathered(lambda p, hh: enc_block(p, cfg, hh, provider), gather), remat)
    with sequence_parallel(sp):
        for p in params["encoder"]:
            h = block(p, h)
    h = apply_norm(params["enc_norm"], gather_residual(h), cfg.norm)
    return h if sp is None else sp.gather_seq(h, dim=1)


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------


def _frames_split(cfg: ArchConfig) -> tuple | None:
    """(shards, this rank's index) where a sharded serving step splits the
    cross K/V cache's frames over the fsdp axes (``TensorParallel.kv_seq``,
    a batch whose rows do not split, and frames that do), else None."""
    tp = tp_context()
    seq = None if tp is None else tp.kv_seq
    if seq is None or cfg.encoder_seq % seq[0]:
        return None
    return seq[0], seq[1]


def _cross_attend(p: dict, cfg: ArchConfig, x: torch.Tensor, ck: torch.Tensor,
                  cv: torch.Tensor, provider=None) -> torch.Tensor:
    """x: (B, S, D) attends to precomputed cross K/V (B, Hkv, Senc, hd).
    Where they hold this rank's block of the frames (:func:`_frames_split`)
    the softmax is merged over the fsdp axes from each block's output and
    row log-sum-exp (``attention.merge_blocks``)."""
    b, s, _ = x.shape
    if ck.shape[-1] != cfg.head_dim:
        raise ValueError("a cross K/V cache split along head_dim is not taken "
                         "(whisper's KV heads split over model)")
    q = ops.matmul(x, p["wq"], provider=provider).reshape(b, s, -1, cfg.head_dim).transpose(1, 2)
    split = _frames_split(cfg) is not None
    o = ops.flash_attention(q, attn.kv_for(cfg, q, ck), attn.kv_for(cfg, q, cv),
                            class_id="flash_attention_cross", causal=False, provider=provider,
                            with_lse=split)
    if split:
        o = attn.merge_blocks(*o)
    o = attn.out_cols(o.transpose(1, 2).reshape(b, s, -1))
    return row_parallel(o, p["wo"], provider=provider)


def _cross_kv(p: dict, cfg: ArchConfig, enc: torch.Tensor,
              provider=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The encoder's output projected to cross K/V, each (B, Hkv, Senc, hd)."""
    b, s, _ = enc.shape
    k = ops.matmul(enc, p["wk"], provider=provider).reshape(b, s, -1, cfg.head_dim)
    v = ops.matmul(enc, p["wv"], provider=provider).reshape(b, s, -1, cfg.head_dim)
    return k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()


def dec_block(p: dict, cfg: ArchConfig, h: torch.Tensor, *, enc: torch.Tensor | None = None,
              cache: dict | None = None, positions: torch.Tensor | None = None,
              pos: torch.Tensor | None = None, provider=None) -> tuple[torch.Tensor, dict | None]:
    """One decoder block; returns (h, the layer's cache written).

    Full sequence (``positions``): cross K/V from ``enc``, the self-attention
    cache (given: a fresh one) written in place.  Decode (``pos``, (B,) per
    slot): one token per slot against ``cache``'s self-KV and cross K/V."""
    with block_io("cross"):
        xn = apply_norm(p["ln1"], gather_residual(h), cfg.norm)
        if pos is not None:
            a, c_self = attn.attn_decode(p["self_attn"], cfg, xn, "G", pos=pos,
                                         cache=cache["self"], provider=provider)
            ck, cv = cache["cross_k"], cache["cross_v"]
        else:
            a, c_self = attn.attn_forward(p["self_attn"], cfg, xn, "G", positions=positions,
                                          cache=None if cache is None else cache["self"],
                                          provider=provider)
            split = _frames_split(cfg) if cache is not None else None
            if split is not None:                   # this rank's block of the frames
                n = enc.shape[1] // split[0]
                enc = enc[:, split[1] * n:(split[1] + 1) * n]
            ck, cv = _cross_kv(p["cross_attn"], cfg, enc, provider)
        h = h + a
        xc = apply_norm(p["ln_x"], gather_residual(h), cfg.norm)
        h = h + _cross_attend(p["cross_attn"], cfg, xc, ck, cv, provider)
        xn2 = apply_norm(p["ln2"], gather_residual(h), cfg.norm)
        h = h + mlpm.mlp_apply(p["mlp"], cfg, xn2, provider=provider)
    if cache is None:
        return h, None
    if pos is None and "cross_k" in cache:      # the part the cache holds (SP: the rank's heads)
        ck, cv = attn.cache_part(ck, cache["cross_k"]), attn.cache_part(cv, cache["cross_v"])
    return h, {"self": c_self, "cross_k": ck, "cross_v": cv}


def _dec_embed(params: dict, tokens: torch.Tensor, off: int = 0) -> torch.Tensor:
    s = tokens.shape[1]
    return lookup(params["embed"], tokens) + local_residual(params["dec_pos"][None, off:off + s])


def forward(params: dict, cfg: ArchConfig, batch: dict, *, remat: bool = True,
            provider=None) -> tuple[torch.Tensor, torch.Tensor]:
    """batch: frames (B, enc_seq, D) + tokens (B, S). Returns (logits, aux = 0).
    Under a param gather (sharded training) the non-layer params are
    gathered once and each layer's inside its remat, as in ``lm.forward``."""
    gather = param_gather()
    if gather is not None:
        params = gather_top(params, cfg, gather)
    enc = encode(params, cfg, batch["frames"], provider, remat=remat, gather=gather)
    h = _dec_embed(params, batch["tokens"])
    b, s, _ = h.shape
    positions = torch.arange(s, device=h.device).expand(b, s)
    block = rematted(gathered(lambda p, hh, e: dec_block(p, cfg, hh, enc=e, positions=positions,
                                                         provider=provider)[0], gather), remat)
    for p in params["decoder"]:
        h = block(p, h, enc)
    h = apply_norm(params["final_norm"], gather_residual(h), cfg.norm)
    logits = ops.matmul(h, params["lm_head"], class_id="matmul_lmhead", provider=provider)
    return logits, torch.zeros((), dtype=torch.float32, device=h.device)


def loss_fn(params: dict, cfg: ArchConfig, batch: dict, *, remat: bool = True,
            provider=None) -> tuple[torch.Tensor, dict]:
    """Next-token cross-entropy of the decoder.  Returns (ce, {"ce", "aux"})."""
    logits, aux = forward(params, cfg, batch, remat=remat, provider=provider)
    ce = next_token_nll(logits[:, :-1], batch["tokens"][:, 1:]).mean()
    return once(ce), {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def prefill(params: dict, cfg: ArchConfig, batch: dict, *, max_len: int,
            true_len: int | None = None, provider=None) -> tuple[torch.Tensor, dict]:
    """Encode the frames and process the prompt; returns (last-position
    logits (B, V), cache).  ``true_len``: the number of real decoder tokens
    when the prompt is right-padded (see :func:`repro_torch.models.lm.prefill`).
    Sharded: params gathered, caches and logits this rank's shards (under
    sequence parallelism each rank runs its block of the frames and of the
    prompt, and the last real row is taken to every rank)."""
    gather = param_gather()
    if gather is not None:
        params = gather_top(params, cfg, gather)
    enc = encode(params, cfg, batch["frames"], provider, gather=gather)
    sp = sp_context()
    tokens = batch["tokens"]
    s, off = (sp.seq, sp.offset) if sp is not None else (tokens.shape[1], 0)
    if sp is not None:
        tokens = tokens[:, off:off + sp.local]
    h = _dec_embed(params, tokens, off)
    b = h.shape[0]
    t = s if true_len is None else int(true_len)
    if not 1 <= t <= s:
        raise ValueError(f"true_len {t} outside 1..{s}")
    positions = off + torch.arange(h.shape[1], device=h.device).expand(b, h.shape[1])
    fresh = init_cache(cfg, b, max_len, h.device)["layers"]
    layers = []
    for p, c0 in zip(params["decoder"], fresh):
        p = p if gather is None else gather(p)
        h, c = dec_block(p, cfg, h, enc=enc, cache=c0, positions=positions, provider=provider)
        layers.append(c)
    row = h[:, t - 1:t, :] if sp is None else sp.row_at(h, t - 1)
    h_last = apply_norm(params["final_norm"], gather_residual(row), cfg.norm)
    w = params["lm_head"] if sp is None else sp.head(params["lm_head"])
    logits = ops.matmul(h_last, w, class_id="matmul_lmhead", provider=provider)
    return logits[:, 0, :], {"layers": layers,
                             "t": torch.full((b,), t, dtype=torch.int32, device=h.device)}


def init_cache(cfg: ArchConfig, batch: int, max_len: int, device) -> dict:
    """A zeroed decode cache: self KV per layer and room for the cross K/V
    (under a sharded serving step's cache layout, this rank's shards)."""
    layout = cache_layout()
    if layout is not None:
        return layout(lambda b, dev: _init_cache(cfg, b, max_len, dev), batch, device)
    return _init_cache(cfg, batch, max_len, device)


def _init_cache(cfg: ArchConfig, batch: int, max_len: int, device) -> dict:
    dt = dtype_of(cfg.dtype)
    shape = (batch, cfg.n_kv_heads, cfg.encoder_seq, cfg.head_dim)
    return {
        "layers": [{"self": attn.init_attn_cache(cfg, "G", batch, max_len, device),
                    "cross_k": torch.zeros(shape, dtype=dt, device=device),
                    "cross_v": torch.zeros(shape, dtype=dt, device=device)}
                   for _ in range(cfg.n_layers)],
        "t": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def decode_step(params: dict, cfg: ArchConfig, cache: dict, tokens: torch.Tensor,
                provider=None) -> tuple[torch.Tensor, dict]:
    """tokens: (B,) — one new token per slot, each at its own position.
    Returns (logits (B, V), cache); self-KV rows are written in place and
    ``t`` advances by one.  Sharded: see :func:`prefill`."""
    gather = param_gather()
    if gather is not None:
        params = gather_top(params, cfg, gather)
    pos = cache["t"]
    h = (lookup(params["embed"], tokens[:, None])
         + local_residual(params["dec_pos"][pos.long()][:, None, :]))
    layers = []
    for p, c in zip(params["decoder"], cache["layers"]):
        p = p if gather is None else gather(p)
        h, c_out = dec_block(p, cfg, h, cache=c, pos=pos, provider=provider)
        layers.append(c_out)
    h = apply_norm(params["final_norm"], gather_residual(h), cfg.norm)
    logits = ops.matmul(h, params["lm_head"], class_id="matmul_lmhead", provider=provider)
    return logits[:, 0, :], {"layers": layers, "t": pos + 1}
