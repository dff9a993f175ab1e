"""Convert the JAX reference's parameter and cache pytrees into the port's.

torch cannot reproduce ``jax.random``, so the tests build weights once in
the reference and hand them to both packages.  The reference stacks each
layer-pattern position's params along a leading ``groups`` axis for
``lax.scan`` (``repro.models.lm.init_params``) and keeps the remainder in
``tail``; the port keeps one list in layer order.  The enc-dec model
(``repro.models.encdec``) stacks its ``encoder`` and ``decoder`` layers
along a leading axis, and its cache is ``{"layers": {"self", "cross_k",
"cross_v"} stacked, "t"}``; the port keeps lists of per-layer dicts.  A
VLM's ``vis_proj`` passes straight through.  Inputs are nested
dicts/lists of numpy arrays (``jax.tree_util.tree_map(np.asarray, tree)``).

Training state maps the same way: :func:`grads_from_jax` takes a gradient
pytree (the params' structure) to the port's trainable layout, without the
tied head's copy ``embed_t``; :func:`opt_state_from_jax` takes the
reference's AdamW state (``m``, ``v``, ``master``, ``step`` and, with
compressed gradients, ``residuals``).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.lm import tied_head, trainable
from repro_torch.tree import tree_map as _map


def _tensor(a: Any, device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":  # ml_dtypes bfloat16: no numpy->torch bridge
        return torch.from_numpy(arr.astype(np.float32)).to(device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def _unstack(groups: dict, tail: list, cfg: ArchConfig, device) -> list:
    """Stacked pattern groups + tail -> one entry per layer, in layer order."""
    pat = cfg.layer_pattern
    reps = cfg.n_layers // len(pat)
    layers = []
    for r in range(reps):
        for i in range(len(pat)):
            layers.append(_map(lambda a, r=r: _tensor(np.asarray(a)[r], device), groups[str(i)]))
    layers.extend(_map(lambda a: _tensor(a, device), t) for t in tail)
    return layers


def _layer_list(stacked: Any, n: int, device) -> list:
    """A tree stacked along a leading layer axis -> one tree per layer."""
    return [_map(lambda a, i=i: _tensor(np.asarray(a)[i], device), stacked) for i in range(n)]


def params_from_jax(tree: dict, cfg: ArchConfig, device="cpu") -> dict:
    """The reference's ``lm.init_params`` (or ``encdec.init_params``) pytree
    -> the port's params (with a tied embedding's head copy, ``embed_t``, as
    ``lm.init_params`` holds it)."""
    if cfg.family == "audio":
        out = {k: _map(lambda a: _tensor(a, device), v)
               for k, v in tree.items() if k not in ("encoder", "decoder")}
        out["encoder"] = _layer_list(tree["encoder"], cfg.encoder_layers, device)
        out["decoder"] = _layer_list(tree["decoder"], cfg.n_layers, device)
        return out
    out = {k: _map(lambda a: _tensor(a, device), v)
           for k, v in tree.items() if k not in ("groups", "tail")}
    out["layers"] = _unstack(tree["groups"], tree["tail"], cfg, device)
    if cfg.tie_embeddings:
        out["embed_t"] = tied_head(out["embed"])
    return out


def grads_from_jax(tree: dict, cfg: ArchConfig, device="cpu") -> dict:
    """A pytree of the params' structure (grads, AdamW moments, ...) -> the
    port's trainable layout: layers unstacked, no ``embed_t``."""
    return trainable(params_from_jax(tree, cfg, device))


def opt_state_from_jax(state: dict, cfg: ArchConfig, device="cpu") -> dict:
    """The reference's ``init_opt_state`` / ``apply_updates`` state -> the
    port's (``repro_torch.optim.adamw``)."""
    out = {k: grads_from_jax(state[k], cfg, device) for k in ("m", "v", "master")}
    out["step"] = _tensor(state["step"], device).to(torch.int32)
    if "residuals" in state:
        out["residuals"] = grads_from_jax(state["residuals"], cfg, device)
    return out


def cache_from_jax(tree: dict, cfg: ArchConfig, device="cpu") -> dict:
    """The reference's ``lm.init_cache`` / ``prefill`` cache (or the
    enc-dec model's) -> the port's."""
    if cfg.family == "audio":
        return {"layers": _layer_list(tree["layers"], cfg.n_layers, device),
                "t": _tensor(tree["t"], device).to(torch.int32)}
    return {"layers": _unstack(tree["groups"], tree["tail"], cfg, device),
            "t": _tensor(tree["t"], device).to(torch.int32)}
