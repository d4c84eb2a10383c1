"""Typed compile-option enums with string resolvers.

Counterpart of ``thunder_tpu/core/options.py`` (copied; only the imports change).

Analog of the reference's ``thunder/core/options.py`` (CACHE_OPTIONS,
SHARP_EDGES_OPTIONS and resolvers). The interpretation option is a plain
string, ``jit(..., interpretation="bytecode")``, read by
``functional.trace_from_fn``.
"""
from __future__ import annotations

from enum import Enum, auto

from thunder_tpu_torch.core.baseutils import check

__all__ = [
    "CACHE_OPTIONS",
    "SHARP_EDGES_OPTIONS",
    "resolve_cache_option",
    "resolve_sharp_edges_option",
]


class CACHE_OPTIONS(Enum):
    NO_CACHING = auto()
    SAME_INPUT = auto()
    CONSTANT_VALUES = auto()
    SYMBOLIC_VALUES = auto()


_string_to_cache_option_map = {
    "no caching": CACHE_OPTIONS.NO_CACHING,
    "same input": CACHE_OPTIONS.SAME_INPUT,
    "constant values": CACHE_OPTIONS.CONSTANT_VALUES,
    "symbolic values": CACHE_OPTIONS.SYMBOLIC_VALUES,
}


def resolve_cache_option(x: None | str | CACHE_OPTIONS) -> CACHE_OPTIONS:
    if x is None:
        return CACHE_OPTIONS.CONSTANT_VALUES
    if isinstance(x, CACHE_OPTIONS):
        return x
    check(isinstance(x, str), lambda: f"Unknown cache option {x}")
    co = _string_to_cache_option_map.get(x.lower())
    check(co is not None, lambda: f"Unknown cache option {x!r}; known: {list(_string_to_cache_option_map)}")
    return co


class SHARP_EDGES_OPTIONS(Enum):
    ALLOW = auto()
    WARN = auto()
    ERROR = auto()


_string_to_sharp_edges_option_map = {
    "allow": SHARP_EDGES_OPTIONS.ALLOW,
    "warn": SHARP_EDGES_OPTIONS.WARN,
    "error": SHARP_EDGES_OPTIONS.ERROR,
}


def resolve_sharp_edges_option(x: None | str | SHARP_EDGES_OPTIONS) -> SHARP_EDGES_OPTIONS:
    if x is None:
        return SHARP_EDGES_OPTIONS.ALLOW
    if isinstance(x, SHARP_EDGES_OPTIONS):
        return x
    check(isinstance(x, str), lambda: f"Unknown sharp edges option {x}")
    so = _string_to_sharp_edges_option_map.get(x.lower())
    check(so is not None, lambda: f"Unknown sharp edges option {x!r}")
    return so
