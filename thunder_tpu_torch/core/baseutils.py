"""Base utilities and interfaces for the core IR.

Counterpart of ``thunder_tpu/core/baseutils.py`` (copied; only the imports change).

The reference is the analog of ``thunder/core/baseutils.py`` (interfaces,
``check``, printable-literal rules, ``compile_and_exec``).  Re-designed, not
ported: the generated program is plain Python over the executors' callables.
"""
from __future__ import annotations

import collections.abc
import enum
import functools
import sys
from types import CodeType, ModuleType
from typing import Any, Callable, Hashable, Sequence, Type

__all__ = [
    "BoundSymbolInterface",
    "NumberProxyInterface",
    "ProxyInterface",
    "SymbolInterface",
    "TensorProxyInterface",
    "TagBase",
    "check",
    "check_type",
    "check_types",
    "check_valid_length",
    "check_valid_shape",
    "compile_and_exec",
    "default_dataclass_params",
    "extract_callable_name",
    "fnprint",
    "indent",
    "is_base_printable",
    "is_base_printable_literal",
    "is_base_printable_type",
    "is_base_printable_value",
    "is_collection",
    "print_base_printable",
    "print_base_type",
    "print_number",
    "run_once",
    "sequencify",
]

#
# Interfaces (avoid circular imports between trace/symbol/proxies)
#


class ProxyInterface:
    """Anything that stands in for a runtime value inside a trace."""

    name: str

    def type_string(self) -> str:
        raise NotImplementedError

    def replace_name(self, name: str):
        raise NotImplementedError


class NumberProxyInterface:
    pass


class TensorProxyInterface:
    pass


class SymbolInterface:
    name: str
    is_prim: bool
    id: Hashable | None


class BoundSymbolInterface:
    sym: SymbolInterface
    args: tuple
    kwargs: dict
    output: Any
    subsymbols: Sequence["BoundSymbolInterface"]


class TagBase:
    """Base for op/proxy tag enums."""


#
# Error checking
#


def check(pred: bool, s: Callable[[], str], exception_type: Type[Exception] = RuntimeError) -> None:
    """Lazily composes an error message and raises if ``pred`` is False."""
    if not pred:
        raise exception_type(s())


def check_type(x: Any, types: type | Sequence[type]) -> None:
    check(
        isinstance(x, types),
        lambda: f"{x} had an unexpected type {type(x)}. Supported types are {types}",
        exception_type=ValueError,
    )


def check_types(xs: Sequence, types: type | Sequence[type]) -> None:
    for x in xs:
        check_type(x, types)


def check_valid_length(length: int) -> None:
    check(length >= 0, lambda: f"Found invalid length {length}!")


def check_valid_shape(shape: Sequence[int]) -> None:
    for l in shape:
        if isinstance(l, int):
            check_valid_length(l)


def is_collection(x: Any) -> bool:
    return isinstance(x, (collections.abc.Sequence, collections.abc.Mapping, set)) and not isinstance(
        x, (str, bytes)
    )


def sequencify(x: Any) -> Sequence:
    if isinstance(x, Sequence) and not isinstance(x, (str, bytes)):
        return x
    return (x,)


def run_once(fn):
    """Decorator: runs ``fn`` only on the first call (e.g. one-time warnings)."""
    ran = False
    result = None

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        nonlocal ran, result
        if not ran:
            ran = True
            result = fn(*args, **kwargs)
        return result

    return wrapper


default_dataclass_params = dict(frozen=True, eq=True)


#
# Printable literals — values that can be round-tripped through generated source
#

_printable_literal_types = (
    bool,
    int,
    float,
    complex,
    str,
    bytes,
    type(None),
    type(Ellipsis),
    slice,
)


def is_base_printable_literal(x: Any) -> bool:
    # Enum members subclass int/str but repr as '<Signals.SIGINT: 2>', which
    # is not evaluable source — route them to the trace's named-object
    # registry instead (found by tracing asyncio.run: the prologue guarded a
    # signal-module constant and the generated program failed to compile)
    if isinstance(x, enum.Enum):
        return False
    return isinstance(x, _printable_literal_types)


def is_base_printable_type(typ: Any) -> bool:
    return isinstance(typ, type) and (typ.__module__ in ("builtins",) or _lookup_module_path(typ) is not None)


def _lookup_module_path(typ: type) -> str | None:
    mod = getattr(typ, "__module__", None)
    name = getattr(typ, "__qualname__", None)
    if mod is None or name is None or "<locals>" in name:
        return None
    return f"{mod}.{name}"


def print_number(x) -> str:
    if isinstance(x, float):
        # repr round-trips floats incl. inf/nan only with helpers
        import math

        if math.isinf(x):
            return "float('inf')" if x > 0 else "float('-inf')"
        if math.isnan(x):
            return "float('nan')"
    if isinstance(x, complex):
        return f"complex({x.real!r}, {x.imag!r})"
    return repr(x)


def print_base_type(typ: type) -> str:
    if typ.__module__ == "builtins":
        return typ.__qualname__
    return f"{typ.__module__}.{typ.__qualname__}"


def is_base_printable_value(x: Any) -> bool:
    return is_base_printable_literal(x)


def print_base_printable(x: Any) -> str:
    if isinstance(x, (bool,)):
        return repr(x)
    if isinstance(x, (int, float, complex)):
        return print_number(x)
    if isinstance(x, slice):
        return f"slice({print_base_printable(x.start)}, {print_base_printable(x.stop)}, {print_base_printable(x.step)})"
    if x is None:
        return "None"
    if x is Ellipsis:
        return "..."
    if isinstance(x, type):
        return print_base_type(x)
    return repr(x)


def is_base_printable(x: Any) -> bool:
    return is_base_printable_literal(x) or (isinstance(x, type) and is_base_printable_type(x))


def extract_callable_name(fn: Callable) -> str:
    name = getattr(fn, "__name__", None)
    if name is None:
        name = getattr(type(fn), "__name__", "fn")
    return name


def indent(level: int) -> str:
    return " " * (level * 2)


def fnprint(fn: Callable) -> str:
    mod = getattr(fn, "__module__", None)
    name = getattr(fn, "__qualname__", getattr(fn, "__name__", None))
    if mod and name:
        return f"{mod}.{name}"
    return extract_callable_name(fn)


#
# Source compilation — generated traces are compiled into real modules so
# tracebacks point at readable source (mirrors reference baseutils.py:440,
# but we register sources with linecache instead of writing temp files).
#

_compile_counter = 0


def compile_and_exec(name: str, python_str: str, ctx: dict[str, Any]) -> Callable:
    """Compiles ``python_str`` (defining function ``name``) and returns the callable.

    ``ctx`` supplies the globals for the generated module (imports, fusion
    callables, constants).  The source is registered with ``linecache`` so that
    exceptions raised inside generated programs show real source lines.
    """
    global _compile_counter
    _compile_counter += 1
    filename = f"<thunder_tpu_torch.gen {name} {_compile_counter}>"

    import linecache

    lines = python_str.splitlines(keepends=True)
    linecache.cache[filename] = (len(python_str), None, lines, filename)

    code: CodeType = compile(python_str, filename, "exec")
    module_ctx = dict(ctx)
    exec(code, module_ctx)
    fn = module_ctx[name]
    fn.__thunder_source__ = python_str
    return fn
