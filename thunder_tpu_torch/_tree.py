"""Flatten and rebuild nested dict/list/tuple trees of tensors.

The port's counterpart of the ``jax.tree_util`` calls the training modules
make (params dicts, optimizer states, checkpoint states): dict keys in
sorted order, as ``jax.tree_util`` orders them; ``None`` is an empty
subtree; anything else is a leaf.
"""
from __future__ import annotations

from typing import Any, Callable

__all__ = ["tree_flatten", "tree_leaves", "tree_map", "tree_unflatten"]


def tree_flatten(tree) -> tuple[list, Any]:
    """``(leaves, spec)``; :func:`tree_unflatten` inverts it."""
    leaves: list = []

    def walk(node):
        if isinstance(node, dict):
            keys = sorted(node)
            return ("dict", keys, [walk(node[k]) for k in keys])
        if isinstance(node, (list, tuple)):
            return (type(node).__name__, None, [walk(x) for x in node])
        if node is None:
            return ("none", None, [])
        leaves.append(node)
        return ("leaf", None, [])

    return leaves, walk(tree)


def tree_unflatten(spec, leaves) -> Any:
    it = iter(leaves)

    def build(node):
        kind, keys, children = node
        if kind == "leaf":
            return next(it)
        if kind == "none":
            return None
        built = [build(c) for c in children]
        if kind == "dict":
            return dict(zip(keys, built))
        return built if kind == "list" else tuple(built)

    return build(spec)


def tree_leaves(tree) -> list:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of each
    tree in ``rest``), rebuilt in ``tree``'s structure."""
    leaves, spec = tree_flatten(tree)
    others = [tree_leaves(r) for r in rest]
    return tree_unflatten(spec, [fn(x, *xs) for x, *xs in zip(leaves, *others)])
