"""Minimal pytree helpers over nested dicts, NamedTuples and tuples of tensors."""
from __future__ import annotations

from typing import Any, Callable

import torch

__all__ = ["tree_map", "tree_leaves", "tree_where"]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply `fn` leafwise to trees of the same structure; non-tensor leaves
    (None, empty tuples) pass through."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return tree


def tree_leaves(tree: Any) -> list[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [leaf for k in tree for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for x in tree for leaf in tree_leaves(x)]
    return []


def tree_where(mask: torch.Tensor, a: Any, b: Any) -> Any:
    """Per-problem select between two batched trees: mask [B] bool."""

    def pick(x, y):
        return torch.where(mask.reshape((-1,) + (1,) * (x.ndim - 1)), x, y)

    return tree_map(pick, a, b)
