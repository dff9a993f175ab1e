"""Speculative-decoding support: acceptance math, exactness gating, and a
self-draft constructor (the counterpart of ``repro.serving.speculative``).

Greedy draft-then-verify: a small draft model proposes ``k`` tokens per
burst, the target verifies all of them, plus the correction token, in one
batched ``verify_step``.  With greedy acceptance the committed stream is
bit-exact against plain greedy decode, so speculation is purely a
throughput knob.  A burst costs roughly k+1 cheap draft steps and one
decode-priced verify and commits ``expected_committed_tokens(k, alpha)``
tokens.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig


def expected_committed_tokens(k: int, alpha: float) -> float:
    """E[tokens committed per burst] for draft length ``k`` and per-token
    acceptance probability ``alpha`` (i.i.d. model): 1 + a + ... + a^k.

    Every burst commits at least 1 (the correction token); all-accept commits
    k+1 (k drafts + the free extra token from the verify logits).
    """
    if k <= 0:
        return 1.0
    a = min(max(float(alpha), 0.0), 1.0)
    if a >= 1.0:
        return float(k + 1)
    return (1.0 - a ** (k + 1)) / (1.0 - a)


def spec_gain(k: int, alpha: float, *, draft_cost_s: float, verify_cost_s: float,
              decode_cost_s: float) -> float:
    """Throughput multiplier of speculating vs plain decode: tokens/s ratio.

    Plain decode commits 1 token per ``decode_cost_s``.  A burst costs
    ``(k+1) * draft_cost_s + verify_cost_s`` (the draft runs k+1 steps so its
    cache covers the all-accept case) and commits E(k, alpha) tokens.
    """
    if k <= 0 or decode_cost_s <= 0:
        return 1.0
    burst = (k + 1) * draft_cost_s + verify_cost_s
    if burst <= 0:
        return 1.0
    return expected_committed_tokens(k, alpha) * decode_cost_s / burst


def spec_exact_reason(cfg: ArchConfig) -> str:
    """"" if ``cfg`` supports bit-exact speculative verify, else why not.

    Verify needs every rejected KV row to be recoverable by plain overwrite,
    which only full-length caches give: ring (windowed local) caches lose
    history on wrap, and recurrent state cannot be partially rolled back.
    """
    if cfg.family == "audio":
        return "audio encdec family has no chunked/verify path"
    if cfg.vision_tokens:
        return "vision-prefix archs lack the chunked/verify path"
    kinds = set(cfg.layer_kinds)
    if "R" in kinds:
        return "recurrent layers: state cannot roll back rejected tokens"
    if "L" in kinds and cfg.window > 0:
        return "windowed local layers: ring cache loses rejected-row history"
    return ""


def make_self_draft(cfg: ArchConfig, params: dict, *, keep_layers: int,
                    damp: float = 0.0) -> tuple[ArchConfig, dict, dict]:
    """Build a truncated self-draft: ``(draft_cfg, draft_params, target_params)``.

    The draft is the target's first ``keep_layers`` layers sharing the
    embedding, final norm and LM head; the returned *target* params have
    every deeper layer's residual contribution (attn ``wo``, mlp ``w_out``)
    scaled by ``damp``.  ``damp=0`` makes the damped target compute exactly
    the draft's function (acceptance rate 1); a small ``damp`` gives a high
    but partial acceptance rate.  The draft's layers and the target's first
    ``keep_layers`` layers are the given params' tensors, not copies.

    Requires a single-kind layer pattern (minitron-4b's ("G",)).
    """
    if len(cfg.layer_pattern) != 1 or cfg.n_layers % len(cfg.layer_pattern):
        raise ValueError("self-draft needs a single-group layer pattern")
    if not 0 < keep_layers <= cfg.n_layers:
        raise ValueError(f"keep_layers must be in 1..{cfg.n_layers}")

    layers = list(params["layers"][:keep_layers])
    for lp in params["layers"][keep_layers:]:
        lp = dict(lp)
        for block, key in (("attn", "wo"), ("mlp", "w_out")):
            w = lp[block][key]
            lp[block] = {**lp[block], key: (w.float() * damp).to(w.dtype)}
        layers.append(lp)
    target_params = {**params, "layers": layers}

    draft_cfg = dataclasses.replace(cfg, name=f"{cfg.name}-draft{keep_layers}",
                                    n_layers=keep_layers)
    draft_params = {**params, "layers": list(params["layers"][:keep_layers])}
    return draft_cfg, draft_params, target_params
