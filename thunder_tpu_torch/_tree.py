"""Flatten and rebuild nested containers of tensors.

The port's counterpart of ``jax.tree_util``, with its rules: dict keys in
sorted order (an ``OrderedDict`` keeps its own order), ``None`` is an empty
subtree, a namedtuple is a node that rebuilds its own type, lists and tuples
are nodes, and anything else (tensors, numbers, proxies, subclasses of
list, tuple or dict) is a leaf.  ``is_leaf`` stops the walk at the subtrees
it accepts.  The training modules (params dicts, optimizer and checkpoint
states) and the IR's ``core/pytree.py`` share it.
"""
from __future__ import annotations

from collections import OrderedDict, defaultdict
from dataclasses import dataclass
from typing import Any, Callable

__all__ = ["PyTreeDef", "tree_flatten", "tree_flatten_with_path", "tree_leaves", "tree_map",
           "tree_structure", "tree_unflatten"]


@dataclass(frozen=True)
class PyTreeDef:
    """One node of a flattened tree: its kind, its keys (dict keys, a
    namedtuple's type, a defaultdict's factory) and its children's specs."""

    kind: str
    meta: Any
    children: tuple


_LEAF = PyTreeDef("leaf", None, ())
_NONE = PyTreeDef("none", None, ())


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(type(node), "_fields")


def _children(node):
    """``(kind, meta, [(path key, child), ...])`` of a node, None for a leaf."""
    t = type(node)
    if t is dict:
        keys = sorted(node)
        return "dict", tuple(keys), [(k, node[k]) for k in keys]
    if t is OrderedDict:
        keys = tuple(node)
        return "odict", keys, [(k, node[k]) for k in keys]
    if t is defaultdict:
        keys = sorted(node)
        return "ddict", (node.default_factory, tuple(keys)), [(k, node[k]) for k in keys]
    if t is list or t is tuple:
        return t.__name__, None, list(enumerate(node))
    if _is_namedtuple(node):
        return "namedtuple", t, [(f, getattr(node, f)) for f in t._fields]
    return None


def tree_flatten_with_path(tree, is_leaf: Callable[[Any], bool] | None = None
                           ) -> tuple[list[tuple[tuple, Any]], PyTreeDef]:
    """``([(path, leaf), ...], spec)``; a path holds the list or tuple
    indices, dict keys and namedtuple field names down to its leaf."""
    out: list = []
    spec = _walk(tree, (), is_leaf, out)
    return out, spec


# The walks are module functions, not closures: a recursive closure is a
# reference cycle (the function's cell holds the function) that would keep
# its ``out`` list or leaf iterator, and so every leaf, alive until the
# cyclic garbage collector runs (a step's gradients, for one).
def _walk(node, path, is_leaf, out) -> PyTreeDef:
    if is_leaf is not None and is_leaf(node):
        out.append((path, node))
        return _LEAF
    if node is None:
        return _NONE
    split = _children(node)
    if split is None:
        out.append((path, node))
        return _LEAF
    kind, meta, items = split
    return PyTreeDef(kind, meta, tuple(_walk(c, path + (k,), is_leaf, out) for k, c in items))


def tree_flatten(tree, is_leaf: Callable[[Any], bool] | None = None) -> tuple[list, PyTreeDef]:
    """``(leaves, spec)``; :func:`tree_unflatten` inverts it."""
    pairs, spec = tree_flatten_with_path(tree, is_leaf)
    return [leaf for _, leaf in pairs], spec


def tree_unflatten(spec: PyTreeDef, leaves) -> Any:
    return _build(spec, iter(leaves))


def _build(node: PyTreeDef, it) -> Any:
    kind = node.kind
    if kind == "leaf":
        return next(it)
    if kind == "none":
        return None
    built = [_build(c, it) for c in node.children]
    if kind == "dict":
        return dict(zip(node.meta, built))
    if kind == "odict":
        return OrderedDict(zip(node.meta, built))
    if kind == "ddict":
        factory, keys = node.meta
        return defaultdict(factory, zip(keys, built))
    if kind == "namedtuple":
        return node.meta(*built)
    return built if kind == "list" else tuple(built)


def tree_structure(tree, is_leaf: Callable[[Any], bool] | None = None) -> PyTreeDef:
    return tree_flatten(tree, is_leaf)[1]


def tree_leaves(tree, is_leaf: Callable[[Any], bool] | None = None) -> list:
    return tree_flatten(tree, is_leaf)[0]


def tree_map(fn: Callable, tree, *rest, is_leaf: Callable[[Any], bool] | None = None) -> Any:
    """``fn`` over the leaves of ``tree`` (and the matching subtrees of each
    tree in ``rest``), rebuilt in ``tree``'s structure."""
    leaves, spec = tree_flatten(tree, is_leaf)
    others = [_flatten_up_to(spec, r) for r in rest]
    return tree_unflatten(spec, [fn(x, *xs) for x, *xs in zip(leaves, *others)])


def _flatten_up_to(spec: PyTreeDef, tree) -> list:
    """``tree``'s subtrees at the leaves of ``spec`` (``jax.tree_util``'s
    ``flatten_up_to``): ``tree_map`` hands a leaf of the first tree the
    matching whole subtree of the others."""
    if spec.kind == "leaf":
        return [tree]
    if spec.kind == "none":
        if tree is not None:
            raise ValueError(f"tree structures differ: expected None, got {type(tree).__name__}")
        return []
    split = _children(tree) if tree is not None else None
    if split is None or split[0] != spec.kind or split[1] != spec.meta \
            or len(split[2]) != len(spec.children):
        raise ValueError(f"tree structures differ at a {spec.kind} node")
    out: list = []
    for c, (_, sub) in zip(spec.children, split[2]):
        out.extend(_flatten_up_to(c, sub))
    return out
