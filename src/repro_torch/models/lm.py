"""Decoder-only LM stack: dense and MoE attention layers and recurrent
(rwkv6, griffin) layers (the counterpart of ``repro.models.lm``).

The reference stacks each layer-pattern position's params along a leading
axis and runs ``jax.lax.scan`` over the repeats plus explicit tail layers.
Here ``params["layers"]`` and ``cache["layers"]`` are plain lists in layer
order and a Python loop walks them (:mod:`repro_torch.convert` unstacks the
reference's pytrees into this layout).

Entry points (bundled per config by :mod:`repro_torch.models.build`):
  forward(params, batch)            — full-sequence logits
  prefill(params, batch, max_len)   — last-position logits + filled cache
  decode_step(params, cache, tok)   — one token per slot, cache updated in place

Each takes ``provider``, the :class:`~repro_torch.kernels.ops.ScheduleProvider`
every kernel op resolves its schedule through (None: the process default),
passed down to every op as the reference passes it.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlpm
from repro_torch.models import recurrent as rec
from repro_torch.models.common import apply_norm, dense_init, dtype_of, embed_init, norm_params

def _check_supported(cfg: ArchConfig) -> None:
    if cfg.vision_tokens or cfg.encoder_layers:
        raise NotImplementedError("enc-dec and vision-prefixed archs are not ported yet: ROADMAP A.6")


# ---------------------------------------------------------------------------
# Per-block params / apply
# ---------------------------------------------------------------------------


def block_params(gen: torch.Generator, cfg: ArchConfig, kind: str) -> dict:
    if kind == "R" and cfg.family == "ssm":
        return rec.rwkv_params(gen, cfg)
    dt = dtype_of(cfg.dtype)
    mixer = ({"rnn": rec.griffin_params(gen, cfg)} if kind == "R"
             else {"attn": attn.attn_params(gen, cfg)})
    moe = kind != "R" and cfg.n_experts > 0   # griffin's R blocks keep a dense MLP
    return {
        "ln1": norm_params(cfg.d_model, cfg.norm, dt, gen.device),
        **mixer,
        "ln2": norm_params(cfg.d_model, cfg.norm, dt, gen.device),
        **({"moe": mlpm.moe_params(gen, cfg)} if moe else {"mlp": mlpm.mlp_params(gen, cfg)}),
    }


def apply_mixer(p: dict, cfg: ArchConfig, kind: str, x: torch.Tensor, *,
                positions: torch.Tensor | None, pos: torch.Tensor | None,
                cache: dict | None, decode: bool,
                provider=None) -> tuple[torch.Tensor, dict | None]:
    """A norm-mixer-MLP block's first half: (the mixer's output to add to
    the residual stream x, cache written)."""
    xn = apply_norm(p["ln1"], x, cfg.norm)
    if kind == "R":
        return rec.griffin_block(p["rnn"], cfg, xn, cache=cache, provider=provider)
    if decode:
        return attn.attn_decode(p["attn"], cfg, xn, kind, pos=pos, cache=cache,
                                provider=provider)
    return attn.attn_forward(p["attn"], cfg, xn, kind, positions=positions, cache=cache,
                             provider=provider)


def ffn_input(p: dict, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """What the block's MLP or MoE reads from the residual stream x."""
    return apply_norm(p["ln2"], x, cfg.norm)


def apply_ffn(p: dict, cfg: ArchConfig, x: torch.Tensor,
              provider=None) -> tuple[torch.Tensor, torch.Tensor]:
    """A norm-mixer-MLP block's second half: (the MLP's or MoE's output to
    add to the residual stream x, aux loss)."""
    xn = ffn_input(p, cfg, x)
    if "moe" in p:
        return mlpm.moe_apply(p["moe"], cfg, xn, provider=provider)
    return (mlpm.mlp_apply(p["mlp"], cfg, xn, provider=provider),
            torch.zeros((), dtype=torch.float32, device=x.device))


def apply_block(p: dict, cfg: ArchConfig, kind: str, x: torch.Tensor, *,
                positions: torch.Tensor | None, pos: torch.Tensor | None,
                cache: dict | None, decode: bool,
                provider=None) -> tuple[torch.Tensor, dict | None, torch.Tensor]:
    """Returns (x, cache written, aux loss).  Recurrent blocks carry their
    state through ``cache`` at prefill and decode alike; the aux loss is the
    MoE load-balance loss, zero for any other block."""
    if kind == "R" and cfg.family == "ssm":  # rwkv blocks apply their own norms
        x, c = rec.rwkv_block(p, cfg, x, cache=cache, provider=provider)
        return x, c, torch.zeros((), dtype=torch.float32, device=x.device)
    a, c = apply_mixer(p, cfg, kind, x, positions=positions, pos=pos, cache=cache, decode=decode,
                       provider=provider)
    x = x + a
    y, aux = apply_ffn(p, cfg, x, provider=provider)
    return x + y, c, aux


# ---------------------------------------------------------------------------
# Stack construction
# ---------------------------------------------------------------------------


def init_params(cfg: ArchConfig, gen: torch.Generator) -> dict:
    """Random params drawn from ``gen`` on ``gen.device``."""
    _check_supported(cfg)
    dt = dtype_of(cfg.dtype)
    params: dict[str, Any] = {"embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dt)}
    params["layers"] = [block_params(gen, cfg, kind) for kind in cfg.layer_kinds]
    params["final_norm"] = norm_params(cfg.d_model, cfg.norm, dt, gen.device)
    if cfg.tie_embeddings:
        params["embed_t"] = tied_head(params["embed"])
    else:
        params["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab_size, dt)
    return params


def tied_head(embed: torch.Tensor) -> torch.Tensor:
    """The LM head's w of a tied embedding: one transposed, contiguous copy
    (d_model, vocab), built once with the params and held beside them, so
    the head launches on it without copying the embedding at every call."""
    return embed.T.contiguous()


def _lm_head(params: dict, cfg: ArchConfig, h: torch.Tensor, provider=None) -> torch.Tensor:
    w = params["embed_t"] if cfg.tie_embeddings else params["lm_head"]
    if cfg.final_softcap > 0:
        return ops.matmul(h, w, class_id="matmul_lmhead_softcap", softcap=cfg.final_softcap,
                          provider=provider)
    return ops.matmul(h, w, class_id="matmul_lmhead", provider=provider)


def _embed(params: dict, cfg: ArchConfig, tokens: torch.Tensor) -> torch.Tensor:
    h = params["embed"][tokens.long()]
    if cfg.tie_embeddings:  # gemma-family embedding scaling
        h = (h.float() * cfg.d_model ** 0.5).to(h.dtype)
    return h


def _stack_pass(params: dict, cfg: ArchConfig, h: torch.Tensor, *, positions: torch.Tensor,
                caches: list | None,
                provider=None) -> tuple[torch.Tensor, list | None, torch.Tensor]:
    """All layers; returns (h, caches written, the layers' summed aux loss)."""
    new = [] if caches is not None else None
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for j, kind in enumerate(cfg.layer_kinds):
        c_in = caches[j] if caches is not None else None
        h, c_out, a = apply_block(params["layers"][j], cfg, kind, h, positions=positions,
                                  pos=None, cache=c_in, decode=False, provider=provider)
        aux = aux + a
        if new is not None:
            new.append(c_out)
    return h, new, aux


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.long, device=device).expand(b, s)


def forward(params: dict, cfg: ArchConfig, batch: dict,
            provider=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence logits and the auxiliary loss: the MoE layers' summed
    load-balance loss (zero without MoE layers)."""
    _check_supported(cfg)
    h = _embed(params, cfg, batch["tokens"])
    b, s, _ = h.shape
    h, _, aux = _stack_pass(params, cfg, h, positions=_positions(b, s, h.device), caches=None,
                            provider=provider)
    h = apply_norm(params["final_norm"], h, cfg.norm)
    return _lm_head(params, cfg, h, provider=provider), aux


# ---------------------------------------------------------------------------
# Serving: prefill + decode
# ---------------------------------------------------------------------------


def init_block_cache(cfg: ArchConfig, kind: str, batch: int, max_len: int, device) -> dict:
    if kind == "R":
        if cfg.family == "ssm":
            return rec.init_rwkv_cache(cfg, batch, device)
        return rec.init_griffin_cache(cfg, batch, device)
    return attn.init_attn_cache(cfg, kind, batch, max_len, device)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, device) -> dict:
    _check_supported(cfg)
    return {
        "layers": [init_block_cache(cfg, kind, batch, max_len, device)
                   for kind in cfg.layer_kinds],
        "t": torch.zeros((batch,), dtype=torch.int32, device=device),  # per-slot positions
    }


def prefill(params: dict, cfg: ArchConfig, batch: dict, *, max_len: int,
            true_len: int | None = None, provider=None) -> tuple[torch.Tensor, dict]:
    """Process the prompt; returns (last-position logits (B, V), cache).

    ``true_len`` marks the number of real tokens when the prompt is
    right-padded to a bucket: logits come from the last real position and the
    decode position starts there (pad rows sit beyond it and are overwritten
    before they become visible)."""
    tokens = batch["tokens"]
    h = _embed(params, cfg, tokens)
    b, s, _ = h.shape
    caches = init_cache(cfg, b, max_len, h.device)
    h, layers, _ = _stack_pass(params, cfg, h, positions=_positions(b, s, h.device),
                               caches=caches["layers"], provider=provider)
    t = s if true_len is None else int(true_len)
    if not 1 <= t <= s:
        raise ValueError(f"true_len {t} outside 1..{s}")
    h_last = apply_norm(params["final_norm"], h[:, t - 1:t, :], cfg.norm)
    logits = _lm_head(params, cfg, h_last, provider=provider)
    cache = {"layers": layers,
             "t": torch.full((b,), t, dtype=torch.int32, device=h.device)}
    return logits[:, 0, :], cache


def decode_step(params: dict, cfg: ArchConfig, cache: dict, tokens: torch.Tensor,
                provider=None) -> tuple[torch.Tensor, dict]:
    """tokens: (B,) — one new token per slot. Returns (logits (B, V), cache);
    the cache's KV rows are written in place, recurrent layers return fresh
    state, and ``t`` advances by one."""
    pos = cache["t"]
    h = _embed(params, cfg, tokens[:, None])
    layers = []
    for j, kind in enumerate(cfg.layer_kinds):
        h, c_out, _ = apply_block(params["layers"][j], cfg, kind, h, positions=None, pos=pos,
                                  cache=cache["layers"][j], decode=True, provider=provider)
        layers.append(c_out)
    h = apply_norm(params["final_norm"], h, cfg.norm)
    logits = _lm_head(params, cfg, h, provider=provider)
    return logits[:, 0, :], {"layers": layers, "t": pos + 1}
