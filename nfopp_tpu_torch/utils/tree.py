"""Minimal pytree helpers over nested dicts, NamedTuples and tuples of tensors."""
from __future__ import annotations

from typing import Any, Callable

import torch

__all__ = ["tree_map", "tree_leaves", "tree_named_leaves", "tree_rows", "tree_where", "tree_copy_"]


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


def tree_named_leaves(tree: Any, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    """(path, leaf) pairs in `tree_leaves` order; a path joins NamedTuple
    field names, dict keys and sequence indices with "/"."""
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    if isinstance(tree, dict):
        items = ((str(k), tree[k]) for k in tree)
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    elif isinstance(tree, (tuple, list)):
        items = ((str(i), x) for i, x in enumerate(tree))
    else:
        return []
    return [pair for key, x in items
            for pair in tree_named_leaves(x, f"{prefix}/{key}" if prefix else key)]


def tree_rows(tree: Any, lo: int, hi: int, batch: int | None = None) -> Any:
    """Rows lo:hi of every leaf of a batched tree. With `batch`, a leaf whose
    leading axis is not `batch` long (one world shared by every row) passes
    through whole."""
    return tree_map(lambda x: x if batch is not None and x.shape[0] != batch else x[lo:hi], tree)


def tree_where(mask: torch.Tensor, a: Any, b: Any) -> Any:
    """Per-problem select between two batched trees: mask [B] bool."""

    def pick(x, y):
        return torch.where(mask.reshape((-1,) + (1,) * (x.ndim - 1)), x, y)

    return tree_map(pick, a, b)


def tree_copy_(dst: Any, src: Any) -> Any:
    """Copy every leaf of `src` into the same leaf of `dst` in place; returns
    `dst`. A source leaf that shares memory with a destination leaf other
    than its own is copied aside first, so no copy reads what another wrote."""
    pairs = [(d, s) for d, s in zip(tree_leaves(dst), tree_leaves(src)) if d is not s]
    written = {d.untyped_storage().data_ptr() for d, _ in pairs}
    pairs = [(d, s.clone() if s.untyped_storage().data_ptr() in written else s)
             for d, s in pairs]
    for d, s in pairs:
        d.copy_(s)
    return dst
