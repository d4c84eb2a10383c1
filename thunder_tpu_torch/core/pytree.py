"""Pytree utilities (counterpart of ``thunder_tpu/core/pytree.py``).

The reference wraps ``jax.tree_util``; the port wraps its own
``thunder_tpu_torch/_tree.py``, which follows ``jax.tree_util``'s rules
(sorted dict keys, ``None`` as an empty subtree, namedtuples rebuilt as
their own type, proxies as leaves).  The flatten order fixes the order of
the prologue's unpacks and the names in a trace.
"""
from __future__ import annotations

from typing import Any, Callable

from thunder_tpu_torch import _tree

__all__ = ["tree_flatten", "tree_unflatten", "tree_map", "tree_leaves", "tree_structure",
           "tree_flatten_with_path"]


def tree_flatten(x: Any, *, is_leaf: Callable[[Any], bool] | None = None):
    return _tree.tree_flatten(x, is_leaf)


def tree_unflatten(leaves, spec):
    return _tree.tree_unflatten(spec, leaves)


def tree_map(fn: Callable, *trees, is_leaf: Callable[[Any], bool] | None = None):
    return _tree.tree_map(fn, *trees, is_leaf=is_leaf)


def tree_leaves(x: Any, *, is_leaf: Callable[[Any], bool] | None = None):
    return _tree.tree_leaves(x, is_leaf)


def tree_structure(x: Any, *, is_leaf: Callable[[Any], bool] | None = None):
    return _tree.tree_structure(x, is_leaf)


def tree_flatten_with_path(x: Any, *, is_leaf: Callable[[Any], bool] | None = None):
    """``([(path, leaf), ...], spec)``: a path holds plain keys (indices,
    dict keys, namedtuple field names), the reference's keypaths after
    ``functional._detect_mutations`` converts them."""
    return _tree.tree_flatten_with_path(x, is_leaf)
