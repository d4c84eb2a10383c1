"""Contextvar access to the active compile data/stats.

Counterpart of ``thunder_tpu/core/compile_data.py`` (copied; only the imports change).

Analog of the reference's ``thunder/core/compile_data.py``, including
``get_compile_option(name, docstring)`` — self-documenting ad-hoc compile
flags queried lazily by passes; usage is recorded into CompileStats.
"""
from __future__ import annotations

from contextlib import contextmanager
from contextvars import ContextVar
from typing import Any

__all__ = [
    "get_compile_data",
    "get_compile_stats",
    "compile_data_and_stats",
    "get_compile_option",
    "using_symbolic_values",
]

_compile_data_var: ContextVar = ContextVar("compile_data", default=None)
_compile_stats_var: ContextVar = ContextVar("compile_stats", default=None)


def get_compile_data():
    return _compile_data_var.get()


def get_compile_stats():
    return _compile_stats_var.get()


@contextmanager
def compile_data_and_stats(cd, cs):
    tok_cd = _compile_data_var.set(cd)
    tok_cs = _compile_stats_var.set(cs)
    try:
        yield
    finally:
        _compile_data_var.reset(tok_cd)
        _compile_stats_var.reset(tok_cs)


def get_compile_option(option: str, description: str, *, default: Any = None) -> Any:
    """Queries a free-form compile option by name.

    Passes call this lazily; the (option, description) pair is recorded in the
    active CompileStats so users can discover which flags a compilation looked
    at (``last_compile_options``).
    """
    cd = get_compile_data()
    cs = get_compile_stats()
    if cs is not None:
        cs.last_compile_reasons.setdefault(option, description)
    if cd is None:
        return default
    value = cd.compile_options.get(option, default)
    if cs is not None and option in cd.compile_options:
        cs.used_compile_options[option] = value
    return value


def using_symbolic_values() -> bool:
    from thunder_tpu_torch.core.options import CACHE_OPTIONS

    cd = get_compile_data()
    return cd is not None and cd.cache_option is CACHE_OPTIONS.SYMBOLIC_VALUES
