"""Convert the JAX reference's parameter and cache pytrees into the port's.

torch cannot reproduce ``jax.random``, so the tests build weights once in
the reference and hand them to both packages.  The reference stacks each
layer-pattern position's params along a leading ``groups`` axis for
``lax.scan`` (``repro.models.lm.init_params``) and keeps the remainder in
``tail``; the port keeps one list in layer order.  Inputs are nested
dicts/lists of numpy arrays (``jax.tree_util.tree_map(np.asarray, tree)``).
"""
from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.lm import tied_head


def _tensor(a: Any, device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":  # ml_dtypes bfloat16: no numpy->torch bridge
        return torch.from_numpy(arr.astype(np.float32)).to(device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def _map(fn: Callable[[Any], Any], tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(fn, v) for v in tree]
    return fn(tree)


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


def params_from_jax(tree: dict, cfg: ArchConfig, device="cpu") -> dict:
    """The reference's ``lm.init_params`` pytree -> the port's params (with a
    tied embedding's head copy, ``embed_t``, as ``lm.init_params`` holds it)."""
    out = {k: _map(lambda a: _tensor(a, device), v)
           for k, v in tree.items() if k not in ("groups", "tail")}
    out["layers"] = _unstack(tree["groups"], tree["tail"], cfg, device)
    if cfg.tie_embeddings:
        out["embed_t"] = tied_head(out["embed"])
    return out


def cache_from_jax(tree: dict, cfg: ArchConfig, device="cpu") -> dict:
    """The reference's ``lm.init_cache`` / ``prefill`` cache -> the port's."""
    return {"layers": _unstack(tree["groups"], tree["tail"], cfg, device),
            "t": _tensor(tree["t"], device).to(torch.int32)}
