"""Nested dicts and lists of tensors (the port's pytrees): map, leaves,
rebuild.  Dict keys keep their insertion order."""
from __future__ import annotations

from typing import Any, Callable


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure), in the same nesting."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list[Any]:
    """The leaves in order: depth first, dicts in key order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_unflatten(like: Any, leaves: list[Any]) -> Any:
    """``leaves`` (in ``tree_leaves`` order) in the nesting of ``like``."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)
