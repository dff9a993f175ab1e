"""Nested dicts and lists of tensors: the port's pytrees.

The params, the optimizer state and a checkpoint's bundle are plain nested
dicts and lists, as the reference's are; these helpers walk them in one
fixed order (dict keys as stored, list items in order).  Paths are written
as ``jax.tree_util.keystr`` writes them: ``['layers'][0]['attn']['wq']``.
"""
from __future__ import annotations

from typing import Any, Callable


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` applied leaf by leaf to ``tree`` and trees of its structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def leaves_with_paths(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """Every leaf with its path, in the tree's order."""
    if isinstance(tree, dict):
        return [item for k, v in tree.items() for item in leaves_with_paths(v, f"{prefix}['{k}']")]
    if isinstance(tree, (list, tuple)):
        return [item for i, v in enumerate(tree) for item in leaves_with_paths(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def leaves(tree: Any) -> list[Any]:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def unflatten(tree: Any, values: list[Any]) -> Any:
    """``tree``'s structure with its leaves replaced by ``values``, in order."""
    it = iter(values)
    out = tree_map(lambda _: next(it), tree)
    if next(it, None) is not None:
        raise ValueError("more values than leaves")
    return out


def flatten_up_to(tree: Any, like: Any) -> list[Any]:
    """``tree``'s values at the leaves of ``like`` (a tree of its structure
    down to them), in ``like``'s order: a value there may itself be a tuple,
    say a sharding spec, which :func:`leaves` would walk into."""
    if isinstance(like, dict):
        return [v for k in like for v in flatten_up_to(tree[k], like[k])]
    if isinstance(like, (list, tuple)):
        return [v for i in range(len(like)) for v in flatten_up_to(tree[i], like[i])]
    return [tree]
