"""AdamW with f32 master weights, global-norm clipping, and LR schedules
(the counterpart of ``repro.optim.adamw``).

Params may be stored bf16; the optimizer keeps f32 first and second moments
and an f32 master copy, casting back to the param dtype after each update
(mixed-precision training).  The state is a dict of trees with the params'
structure (the trainable params: a tied head's ``embed_t`` is no leaf of it,
:func:`repro_torch.models.lm.trainable`), plus ``step``.

The update is the reference's f32 arithmetic in the reference's order.
Unlike the reference, which is functional, :func:`apply_updates` writes
``m``, ``v``, ``master`` and the params in place (a param leaf may require
grad: the writes run under ``torch.no_grad``), and takes its temporaries one
leaf at a time: at gemma2-2b's full width the f32 state alone is 31 GB, and
a second copy of it would not fit the card.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.tree import leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def lr_at(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup then cosine decay to min_lr_ratio·peak (f32)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
    frac = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * frac))
    return torch.where(step < cfg.warmup_steps, warm, cfg.peak_lr * cos)


def init_state(params: Any) -> dict:
    """Zero moments, an f32 master copy and step 0.  ``master`` is always a
    copy: for an f32 param it must not alias the param, which the update
    writes too."""
    first = leaves(params)[0]
    zeros = lambda x: torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    return {
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "master": tree_map(lambda x: x.detach().to(torch.float32, copy=True), params),
        "step": torch.zeros((), dtype=torch.int32, device=first.device),
    }


def global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in leaves(tree)))


@torch.no_grad()
def apply_updates(params: Any, grads: Any, state: dict, cfg: AdamWConfig,
                  gnorm: torch.Tensor | None = None) -> tuple[Any, dict, dict]:
    """One AdamW step, in place.  Returns (params, state, metrics).
    ``gnorm``: the gradient's global norm where ``grads`` are shards of it
    (sharded training); None: :func:`global_norm` of ``grads``."""
    step = state["step"] + 1
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    lr = lr_at(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step.to(torch.float32)
    bc2 = 1 - b2 ** step.to(torch.float32)
    for g, m, v, master, p in zip(leaves(grads), leaves(state["m"]), leaves(state["v"]),
                                  leaves(state["master"]), leaves(params)):
        g = g.float() * scale
        m.mul_(b1).add_((1 - b1) * g)                      # b1·m + (1 - b1)·g
        v.mul_(b2).add_(((1 - b2) * g).mul_(g))            # b2·v + (1 - b2)·g·g
        del g
        denom = torch.div(v, bc2).sqrt_().add_(cfg.eps)    # sqrt(v / bc2) + eps
        update = torch.div(m, bc1).div_(denom)             # (m / bc1) / denom
        del denom
        update.add_(cfg.weight_decay * master).mul_(lr)    # lr·(update + wd·master)
        master.sub_(update)
        p.copy_(master)
    state.update(step=step)
    return params, state, {"grad_norm": gnorm, "lr": lr}
