"""Logical-axis sharding rules (a copy of ``repro.distributed.sharding``):
DP + FSDP (ZeRO-3) + TP/EP layouts, with the reference's divisibility
fallbacks.

Mesh axes:
  ``pod``    (multi-pod only) — outer data parallelism across pods,
  ``data``   — data parallelism + FSDP param/optimizer sharding,
  ``model``  — tensor / expert parallelism.

A spec is a plain tuple with one entry per dim, as ``PartitionSpec`` holds
them: ``None`` (replicated), an axis name, or a tuple of axis names (major
to minor).  The rules are path-based over the param tree with the
reference's fallbacks:
  * expert dims shard over ``model`` when n_experts % model_size == 0
    (dbrx 16e on 16) else experts replicate and d_ff takes ``model``
    (mixtral 8e on 16 → TP inside experts);
  * a dim that its axes do not divide replicates (``_maybe``): no leaf is
    ever padded, so :func:`shard_leaf` cuts equal slices.

The reference stacks the layers of a pattern position along a leading dim;
the port keeps one entry per layer.  The rules align a layout to a leaf's
trailing dims, so the port's spec of a layer's leaf is the reference's spec
of the stacked leaf without its leading ``None``.  The cache rule alike:
the port's caches are per layer, so no cache leaf has a stacked dim (the
reference detects its stacked leaves by name).

The functions keep the reference's names; a "sharding" here is a spec
(``param_shardings`` gives a tree of specs, not of ``NamedSharding``s).
Added for the port: :func:`shard_leaf` (this rank's slice of a full leaf),
:func:`local_shape`, :func:`local_slices` and :func:`sharded_bytes` (the
reference's ``launch.dryrun._sharded_bytes``).
"""
from __future__ import annotations

import math
import re
from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.tree import flatten_up_to, leaves, leaves_with_paths, tree_map

Spec = tuple


def fsdp_axes(mesh) -> tuple[str, ...]:
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def all_axes(mesh) -> tuple[str, ...]:
    return tuple(mesh.axis_names)


def dp_dominant(cfg: ArchConfig, mesh, *, kind: str, global_batch: int) -> bool:
    """Pure-DP/ZeRO-3 strategy gate: small models whose fully-sharded state
    fits pay far less in weight gathers (≈4·params bytes/step) than tensor
    parallelism pays in activation reductions (≈4·layers·B_local·S·D
    bytes/step).  Applied when the whole batch divides the chip count and
    the model has at most 3.5 B params."""
    chips = math.prod(tuple(mesh.shape.values()))
    if kind != "train" or global_batch % chips:
        return False
    return cfg.param_count() <= 3.5e9


def _axis_size(mesh, axes: tuple[str, ...] | str | None) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


def _maybe(mesh, axes, dim: int):
    """Use the axes only if they divide the dim; else replicate."""
    return axes if dim % _axis_size(mesh, axes) == 0 else None


def moe_expert_parallel(cfg: ArchConfig, mesh) -> bool:
    return cfg.n_experts > 0 and cfg.n_experts % mesh.shape["model"] == 0


#: leaf-name -> logical axis layout. "fsdp" / "tp" / None per dimension,
#: matched against the *trailing* dims of the leaf (the reference's stacked
#: scan groups add a leading repeat dim that stays unsharded).
_LEAF_RULES: dict[str, tuple] = {
    # embeddings / head
    "embed": ("tp", "fsdp"),            # (V, D)
    "lm_head": ("fsdp", "tp"),          # (D, V)
    "dec_pos": (None, "fsdp"),
    "enc_pos": (None, "fsdp"),
    "vis_proj": ("fsdp", "tp"),
    # attention projections
    "wq": ("fsdp", "tp"),
    "wk": ("fsdp", "tp"),
    "wv": ("fsdp", "tp"),
    "wo": ("tp", "fsdp"),
    # dense MLP (gated or plain)
    "w_in": ("fsdp", "tp"),
    "w_out": ("tp", "fsdp"),
    "b_in": ("tp",),
    # MoE (expert-parallel layout; TP fallback applied below)
    "router": ("fsdp", None),
    # rwkv
    "wg": ("fsdp", "tp"),
    "wr": ("fsdp", "tp"),
    "wa": ("fsdp", None),
    "wb": (None, "tp"),
    "ck": ("fsdp", "tp"),
    "cv": ("tp", "fsdp"),
    "cr": ("fsdp", "tp"),
    "u": ("tp", None),                  # (H, hd)
    # griffin
    "w_gate": ("fsdp", "tp"),
    "w_x": ("fsdp", "tp"),
    "conv": (None, "tp"),
    "lambda": ("tp",),
    "gate_a": ("tp",),
    "gate_i": ("tp",),
}


def leaf_name(path: str) -> str:
    # keystr like "['layers'][0]['attn']['wq']" -> "wq"
    return path.rstrip("]'").rsplit("'", 1)[-1] if "'" in path else path


def param_spec(path: str, shape: tuple[int, ...], cfg: ArchConfig, mesh,
               dp_only: bool = False) -> Spec:
    """The spec of one param leaf, by its tree path.

    dp_only: pure-DP/ZeRO-3 strategy — the "fsdp" logical axis covers the
    whole mesh and "tp" dims replicate (weights gathered, no TP collectives).
    """
    fsdp = all_axes(mesh) if dp_only else fsdp_axes(mesh)
    tp_phys = None if dp_only else "model"
    name = leaf_name(path)

    def resolve(layout: tuple) -> Spec:
        # align layout to the trailing dims; leading (stack) dims unsharded
        pad = len(shape) - len(layout)
        full = (None,) * pad + layout
        axes = []
        for a, d in zip(full, shape):
            phys = fsdp if a == "fsdp" else (tp_phys if a == "tp" else None)
            axes.append(_maybe(mesh, phys, d))
        return tuple(axes)

    # MoE expert weights: (E, D, 2F)/(E, F, D) — EP when E divides the axis.
    if name in ("w_in", "w_out") and len(shape) >= 3 and cfg.n_experts > 0 and shape[-3] == cfg.n_experts:
        if moe_expert_parallel(cfg, mesh):
            layout = ("tp", "fsdp", None) if name == "w_in" else ("tp", None, "fsdp")
        else:
            layout = (None, "fsdp", "tp") if name == "w_in" else (None, "tp", "fsdp")
        return resolve(layout)
    if name in _LEAF_RULES:
        return resolve(_LEAF_RULES[name])
    return (None,) * len(shape)


def param_shardings(params: Any, cfg: ArchConfig, mesh, dp_only: bool = False) -> Any:
    """A spec per leaf of a param tree (tensors, ``meta`` ones included)
    (the reference's ``param_shardings``)."""
    specs = [param_spec(path, tuple(leaf.shape), cfg, mesh, dp_only)
             for path, leaf in leaves_with_paths(params)]
    it = iter(specs)
    return tree_map(lambda _: next(it), params)


def opt_state_shardings(param_specs_tree: Any, state: dict | None = None) -> dict:
    """Optimizer state inherits the param specs (m/v/master, and the error
    feedback residuals where ``state`` has them); step replicated."""
    out = {"m": param_specs_tree, "v": param_specs_tree, "master": param_specs_tree,
           "step": ()}
    if state is not None and "residuals" in state:
        out["residuals"] = param_specs_tree
    return out


# ---------------------------------------------------------------------------
# Batch / activation / cache specs
# ---------------------------------------------------------------------------


def batch_shardings(specs: Any, cfg: ArchConfig, mesh, dp_only: bool = False) -> Any:
    """Specs for an input tree (train / prefill / decode) of leaves with a
    ``shape`` (the reference's ``batch_shardings``)."""
    fsdp = all_axes(mesh) if dp_only else fsdp_axes(mesh)

    def leaf_spec(path: str, shape: tuple[int, ...]) -> Spec:
        if path.endswith("['tokens']") or "tokens" in path:
            if len(shape) == 1:  # decode: (B,)
                return (_maybe(mesh, fsdp, shape[0]),)
            b, s = shape
            if b % _axis_size(mesh, fsdp) == 0:
                return (fsdp, None)
            return (None, _maybe(mesh, fsdp, s))
        if "mask" in path:
            return (_maybe(mesh, fsdp, shape[0]), None)
        if "frames" in path or "patch_embeds" in path:
            return (_maybe(mesh, fsdp, shape[0]), None, None)
        # cache leaves
        return cache_leaf_sharding(path, shape, cfg, mesh)

    out = [leaf_spec(path, tuple(leaf.shape)) for path, leaf in leaves_with_paths(specs)]
    it = iter(out)
    return tree_map(lambda _: next(it), specs)


def cache_leaf_sharding(path: str, shape: tuple[int, ...], cfg: ArchConfig, mesh) -> Spec:
    """One cache leaf's spec (the reference's ``_cache_leaf_sharding`` of a
    leaf without a stacked-layer dim: the port's caches are per layer)."""
    fsdp = fsdp_axes(mesh)
    nd = len(shape)
    if nd == 0:  # step counter
        return ()
    spec: list = [None] * nd
    batch_sharded = shape[0] % _axis_size(mesh, fsdp) == 0 and shape[0] > 1
    if batch_sharded:
        spec[0] = fsdp                 # batch dim
    if "['k']" in path or "['v']" in path or "cross_k" in path or "cross_v" in path:
        # (B, Hkv, S, hd): heads over model if divisible; else shard head_dim
        # (GQA kv-head counts are often below the TP degree — leaving the
        # cache replicated costs an all-gather of the whole cache per step).
        if shape[1] % mesh.shape["model"] == 0:
            spec[1] = "model"
        elif shape[3] % mesh.shape["model"] == 0:
            spec[3] = "model"
        if not batch_sharded and shape[2] % _axis_size(mesh, fsdp) == 0:
            spec[2] = fsdp
    elif "state" in path or "['h']" in path:
        # recurrent states: shard the big channel/head dim over model
        for j in range(1, nd):
            if shape[j] % mesh.shape["model"] == 0 and shape[j] >= mesh.shape["model"]:
                spec[j] = "model"
                break
    elif "conv" in path or "last_" in path:
        if shape[-1] % mesh.shape["model"] == 0:
            spec[-1] = "model"
    return tuple(spec)


def activation_sharding(mesh, cfg: ArchConfig, dp_only: bool = False,
                        seq_parallel: bool = False) -> Spec:
    """Residual-stream spec (B, S, D): batch over fsdp, D over model
    (pure-DP strategy: batch over the whole mesh, D replicated;
    seq_parallel: S over model — context parallelism for prefill)."""
    if dp_only:
        return (all_axes(mesh), None, None)
    fsdp = fsdp_axes(mesh)
    if seq_parallel:
        return (fsdp, "model", None)
    d_ok = cfg.d_model % mesh.shape["model"] == 0
    return (fsdp, None, "model" if d_ok else None)


def internal_sharding_rules(mesh, cfg: ArchConfig) -> dict:
    """Named specs for internal activations (``context.set_sharding_rules``).

    moe_buf (E, cap, D): TP-fallback archs shard capacity over the fsdp
    axes so the dispatch scatter stays data-local; expert-parallel archs
    leave the buffer's layout free.
    """
    rules: dict = {}
    if cfg.n_experts > 0:
        fsdp = fsdp_axes(mesh)
        if not moe_expert_parallel(cfg, mesh):
            rules["moe_buf"] = (None, fsdp, None)
        d_ok = cfg.d_model % mesh.shape["model"] == 0
        rules["moe_out"] = (fsdp, "model" if d_ok else None)
    return rules


def logits_sharding(mesh, cfg: ArchConfig) -> Spec:
    fsdp = fsdp_axes(mesh)
    v_ok = cfg.vocab_size % mesh.shape["model"] == 0
    return (fsdp, None, "model" if v_ok else None)


# ---------------------------------------------------------------------------
# The port's additions: slices, shapes, bytes
# ---------------------------------------------------------------------------


def spec_axes(entry) -> tuple[str, ...]:
    """One spec entry's axes, major to minor (``()`` for replicated)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def shard_index(entry, mesh, coords: dict[str, int]) -> tuple[int, int]:
    """(index of this rank's slice along a dim, number of slices)."""
    idx, n = 0, 1
    for a in spec_axes(entry):
        idx, n = idx * mesh.shape[a] + coords[a], n * mesh.shape[a]
    return idx, n


def local_slices(shape: tuple[int, ...], spec: Spec, mesh, coords: dict[str, int]) -> tuple:
    """The slices of a full leaf of ``shape`` that this rank holds."""
    out = []
    for d, entry in zip(shape, spec):
        idx, n = shard_index(entry, mesh, coords)
        if d % n:
            raise ValueError(f"dim {d} does not split into {n} shards ({spec})")
        out.append(slice(idx * (d // n), (idx + 1) * (d // n)))
    return tuple(out)


def local_shape(shape: tuple[int, ...], spec: Spec, mesh) -> tuple[int, ...]:
    out = []
    for d, entry in zip(shape, spec):
        n = _axis_size(mesh, spec_axes(entry))
        if d % n:
            raise ValueError(f"dim {d} does not split into {n} shards ({spec})")
        out.append(d // n)
    return tuple(out)


def shard_leaf(full: torch.Tensor, spec: Spec, mesh, coords: dict[str, int]) -> torch.Tensor:
    """This rank's slice of a full leaf, as a tensor of its own."""
    return full[local_slices(tuple(full.shape), spec, mesh, coords)].clone()


def sharded_bytes(tree: Any, specs: Any, mesh) -> int:
    """Per-device bytes of a tree sharded by ``specs`` (leaves with
    ``shape`` and ``dtype``: ``meta`` tensors will do)."""
    total = 0
    for leaf, spec in zip(leaves(tree), flatten_up_to(specs, tree)):
        n_shards = 1
        for entry in spec:
            n_shards *= _axis_size(mesh, spec_axes(entry))
        total += math.ceil(leaf.numel() / n_shards) * leaf.element_size()
    return total


# ---------------------------------------------------------------------------
# The port's tensor-parallel compute: which model shards stay local
# ---------------------------------------------------------------------------

#: the param-tree keys that hold an attention block's projections
ATTN_KEYS = ("attn", "self_attn", "cross_attn")


def _path_keys(path: str) -> list[str]:
    """A keystr's dict keys in order ("['layers'][0]['attn']['wq']" ->
    ['layers', 'attn', 'wq']); list indices are left out."""
    return re.findall(r"\['([^']*)'\]", path)


def attn_heads_local(cfg: ArchConfig, mesh) -> tuple[bool, bool]:
    """(q heads local, KV heads local) under tensor-parallel compute.

    ``_LEAF_RULES`` shard the flattened head dim whenever it divides, so a
    rank's slice of ``wq`` or ``wk``/``wv`` may cut a head.  q heads are
    local when the ``model`` axis splits them whole; KV heads likewise.
    Where q heads are local and KV heads are not, each rank computes every
    KV head and attends with the run its q heads read, which must be one
    contiguous run in one group ratio; where it is not, or where q heads
    are cut, every rank computes every head (the projections gathered over
    ``model``) and ``wo`` stays row-parallel on its slice of the output."""
    m = mesh.shape["model"]
    q_ok = cfg.n_heads % m == 0
    kv_ok = q_ok and cfg.n_kv_heads % m == 0
    if q_ok and not kv_ok:
        per, group = cfg.n_heads // m, cfg.n_heads // cfg.n_kv_heads
        q_ok = per % group == 0 or group % per == 0
    return q_ok, kv_ok


def tp_keeps_local(path: str, spec: Spec, cfg: ArchConfig, mesh) -> bool:
    """Whether tensor-parallel compute keeps this leaf's ``model`` shard
    local (gathers it over the fsdp axes only): every leaf sharded over
    ``model`` but the attention projections whose heads
    :func:`attn_heads_local` finds cut."""
    if not any("model" in spec_axes(e) for e in spec):
        return False
    keys = _path_keys(path)
    if len(keys) >= 2 and keys[-2] in ATTN_KEYS and keys[-1] in ("wq", "wk", "wv"):
        q_ok, kv_ok = attn_heads_local(cfg, mesh)
        return q_ok if keys[-1] == "wq" else kv_ok
    return True


def check_tensor_parallel(cfg: ArchConfig, mesh) -> None:
    """Raise ``ValueError`` where tensor-parallel compute over ``mesh``'s
    ``model`` axis cannot take ``cfg``: each row-parallel product (``wo``,
    ``w_out``, ``cv``) must split its rows, a GLU slice must keep its
    gate/up pairs whole, an rwkv6 rank must hold whole heads."""
    m = mesh.shape["model"]
    if m == 1:
        return
    why = []
    if not cfg.is_attention_free and cfg.family != "ssm" and (cfg.n_heads * cfg.head_dim) % m:
        why.append(f"the attention output's {cfg.n_heads * cfg.head_dim} columns")
    split_ff = not (cfg.n_experts and moe_expert_parallel(cfg, mesh))
    if split_ff and cfg.d_ff % m:
        why.append(f"d_ff {cfg.d_ff}")
    elif split_ff and cfg.mlp_kind in ("swiglu", "geglu") and (2 * cfg.d_ff // m) % 2:
        why.append(f"the GLU's {2 * cfg.d_ff} packed columns into even slices")
    if cfg.family == "ssm" and (cfg.n_heads % m or cfg.d_model % m):
        why.append(f"rwkv6's {cfg.n_heads} heads")
    if cfg.rnn_width and cfg.rnn_width % m:
        why.append(f"the RG-LRU width {cfg.rnn_width}")
    if why:
        raise ValueError(f"tensor-parallel compute over model={m} cannot split {cfg.name}: "
                         + ", ".join(why))
