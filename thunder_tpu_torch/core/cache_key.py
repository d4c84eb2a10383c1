"""Structural dispatch keys: the O(1) tier of the compilation cache.

Counterpart of ``thunder_tpu/core/cache_key.py``.  Running each cached
prologue until one succeeds costs O(entries) prologue runs per call once a
function holds several specializations.  This module computes a cheap,
hashable **structural key** from the call inputs (the pytree spec, then per
leaf ``(shape, dtype, device, requires_grad)`` for tensors, ``(type,
value)`` for static scalars under CONSTANT_VALUES and the type alone under
SYMBOLIC_VALUES), so dispatch is one key computation and one dict lookup
(tier 1).  The matched entry's prologue still runs once for exact guard
validation (tier 2).

The reference keys a ``jax.Array`` leaf; the port keys a ``torch.Tensor``
by its shape, dtype (``float32``, ``bfloat16``), device string (``cpu``,
``cuda:0``) and ``requires_grad``, and a numpy array as a CPU tensor.  All
of it is metadata: computing a key reads no tensor's values and never
waits for the card.  ``torch.dtype`` and ``torch.device`` leaves key by
value, as the port's own dtypes do.

Key consistency is by construction: the dispatcher computes the key once per
call and files new entries under that same key, so a leaf kind that tokenizes
imprecisely costs at most a duplicate specialization (caught by tier 2),
never a wrong program.
"""
from __future__ import annotations

from enum import Enum
from typing import Any, Callable

import numpy as np
import torch

from thunder_tpu_torch.core import dtypes as _dt
from thunder_tpu_torch.core.pytree import tree_flatten

__all__ = ["compute_cache_key", "make_cache_key_fn", "leaf_token"]


def _tensor_token(leaf) -> tuple | None:
    if isinstance(leaf, torch.Tensor):
        return ("T", tuple(leaf.shape), str(leaf.dtype).removeprefix("torch."), str(leaf.device),
                bool(leaf.requires_grad))
    if isinstance(leaf, np.ndarray):
        return ("T", tuple(leaf.shape), leaf.dtype.name, "cpu", False)
    return None


# static-leaf kinds whose hash is stable across calls (value types and
# singletons); arbitrary objects id-hash and would turn each freshly built
# config/lambda into a new specialization, so they tokenize by type+name only
_STABLE_HASH_KINDS = (_dt.dtype, type, np.dtype, Enum, bytes, frozenset, torch.dtype,
                      torch.device)


def leaf_token(leaf: Any, symbolic: bool = False) -> tuple:
    """One flattened input leaf → a hashable key component, mirroring what the
    prologue guards about it (``functional.proxy_leaf`` decides the guard)."""
    t = _tensor_token(leaf)
    if t is not None:
        return t
    # str before numbers: Device subclasses str, and proxy_leaf keeps it a
    # static leaf — its string value is stable, so key it by value like str
    if isinstance(leaf, str):
        return ("s", str(leaf))
    if isinstance(leaf, bool):
        return ("v", "bool", leaf)
    if isinstance(leaf, (int, float)):
        if symbolic:
            # SYMBOLIC_VALUES: the guard pins only the canonical type
            # (check_number_type) — the value is a runtime scalar input
            return ("n", "int" if isinstance(leaf, int) else "float")
        # exact type in the token: check_number_type_and_value compares
        # type identity, so np.float64(1.0) and 1.0 must not share an entry
        return ("v", type(leaf).__name__, leaf)
    if isinstance(leaf, complex):
        return ("v", type(leaf).__name__, leaf)
    # static leaves (dtypes, devices, configs, callables, …): no prologue
    # guard exists for these, so the token only needs to be consistent —
    # type + qualname separates relu-vs-gelu and float32-vs-bfloat16 without
    # over-specializing per-call-fresh objects
    name = getattr(leaf, "__qualname__", None) or getattr(leaf, "__name__", None)
    if isinstance(leaf, _STABLE_HASH_KINDS):
        try:
            return ("o", type(leaf).__qualname__, name if isinstance(name, str) else None, hash(leaf))
        except TypeError:  # pragma: no cover - unhashable subclass
            pass
    return ("o", type(leaf).__qualname__, name if isinstance(name, str) else None)


def compute_cache_key(args: tuple, kwargs: dict, *, symbolic: bool = False, salt=None):
    """The structural dispatch key for one call, or ``None`` when the inputs
    cannot be keyed (unhashable pytree aux data, exotic leaves) — the caller
    falls back to the legacy linear prologue scan, never to a wrong entry.

    ``salt`` folds compile configuration that changes the generated program
    (not the inputs) into the key, so the same function compiled under
    different configurations never shares a specialization.  ``None`` (the
    default) adds nothing."""
    try:
        flat, spec = tree_flatten((tuple(args), dict(kwargs)))
        key = (spec, tuple(leaf_token(leaf, symbolic) for leaf in flat))
        if salt is not None:
            key = key + (salt,)
        hash(key)  # force hashability failures onto the fallback path here
        return key
    except Exception:
        return None


def make_cache_key_fn(symbolic: bool, salt=None) -> Callable:
    """The per-entry key function emitted at trace time alongside the
    prologue: closes over the trace's cache mode (and any compile-config
    salt) so introspection (and any external dispatcher) can recompute an
    entry's key from raw inputs."""

    def cache_key_fn(args: tuple, kwargs: dict):
        return compute_cache_key(args, kwargs, symbolic=symbolic, salt=salt)

    return cache_key_fn
