"""Param trees: nested dicts and lists of tensors, walked as ``jax.tree``
walks them."""

from __future__ import annotations

from typing import Any, Callable

Pytree = Any


def tree_map(fn: Callable, *trees: Pytree) -> Pytree:
    """``jax.tree.map``: ``fn`` on the leaves of ``trees`` (same structure)
    in step, the result in their structure."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, (list, tuple)):
        return type(t)(tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def tree_leaves(tree: Pytree) -> list:
    """``jax.tree.leaves`` order: dict keys sorted, lists in index order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]
