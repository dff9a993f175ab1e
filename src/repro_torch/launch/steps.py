"""Train-step builder (the counterpart of ``repro.launch.steps``'s
``make_train_step`` and ``init_opt_state``).

``make_train_step`` — loss → grads (torch autograd; on the card every
product's gradient comes from the kernels) → optional int8 gradient
compression with error feedback → AdamW.  The params are a model's params
(with a tied head's ``embed_t``); the optimizer state covers the trainable
ones (:func:`repro_torch.models.lm.trainable`), and ``embed_t`` is rebuilt
from ``embed`` after every update.  The params and the state are updated
in place, as the reference donates them to its jitted step.

The prefill and decode steps of the reference are the model's own entry
points here (``Model.prefill``, ``Model.decode_step``).
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.models.build import Model
from repro_torch.models.lm import retie, trainable
from repro_torch.optim import adamw, compression
from repro_torch.tree import leaves, unflatten


def value_and_grad(model: Model, params: dict, batch: dict, *, remat: bool = True,
                   provider=None) -> tuple[torch.Tensor, dict, dict]:
    """(loss, metrics, grads): grads of the trainable params, a tree of
    their structure (zeros for a param the loss does not reach)."""
    train = trainable(params)
    flat = leaves(train)
    for p in flat:
        p.requires_grad_(True)
    try:
        loss, metrics = model.loss_fn(params, batch, remat=remat, provider=provider)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    finally:
        for p in flat:
            p.requires_grad_(False)
    grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, flat)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, unflatten(train, grads)


def make_train_step(model: Model, opt_cfg: adamw.AdamWConfig, *, grad_accum: int = 1,
                    compress_grads: bool = False, remat: bool = True,
                    provider=None) -> Callable:
    """Returns train_step(params, opt_state, batch) -> (params, opt_state, metrics).

    grad_accum > 1 splits the batch into microbatches along the batch axis
    and accumulates grads / grad_accum in f32, one microbatch after another;
    the loss is the microbatches' mean and the other metrics the last
    microbatch's, as the reference's scan leaves them.  ``provider``: the
    schedule provider of the forward's kernel launches (None: the process
    default); the backward's launches take their default schedules."""

    def grads_of(params, batch):
        if grad_accum <= 1:
            return value_and_grad(model, params, batch, remat=remat, provider=provider)
        acc, vals, metrics = None, [], None
        for i in range(grad_accum):
            mb = {k: v.reshape(grad_accum, v.shape[0] // grad_accum, *v.shape[1:])[i]
                  for k, v in batch.items()}
            val, metrics, grads = value_and_grad(model, params, mb, remat=remat,
                                                 provider=provider)
            g = leaves(grads)
            acc = ([gi.float() / grad_accum for gi in g] if acc is None
                   else [a + gi.float() / grad_accum for a, gi in zip(acc, g)])
            vals.append(val)
        return torch.stack(vals).mean(), metrics, unflatten(grads, acc)

    def train_step(params, opt_state, batch):
        val, metrics, grads = grads_of(params, batch)
        train = trainable(params)
        if compress_grads:
            grads, residuals = compression.compressed_gradients(grads, opt_state["residuals"])
            inner = {k: v for k, v in opt_state.items() if k != "residuals"}
            _, inner, om = adamw.apply_updates(train, grads, inner, opt_cfg)
            opt_state.update(inner, residuals=residuals)
        else:
            _, opt_state, om = adamw.apply_updates(train, grads, opt_state, opt_cfg)
        retie(params)
        return params, opt_state, {**metrics, **om, "loss": val}

    return train_step


def init_opt_state(params: Any, *, compress_grads: bool = False) -> dict:
    """AdamW state over the trainable params (and error-feedback residuals)."""
    train = trainable(params)
    state = adamw.init_state(train)
    if compress_grads:
        state["residuals"] = compression.init_residuals(train)
    return state
