"""Source rendering for traces: proxy-aware pretty-printing and signatures.

Counterpart of ``thunder_tpu/core/codeutils.py`` (copied; only the imports change).

Analog of the reference's ``thunder/core/codeutils.py`` (SigInfo/get_siginfo,
``to_printable``, ``prettyprint``).
"""
from __future__ import annotations

import inspect
from dataclasses import dataclass, field
from typing import Any, Callable, Sequence

from thunder_tpu_torch.core import baseutils
from thunder_tpu_torch.core.baseutils import ProxyInterface, check, is_base_printable, print_base_printable

__all__ = ["SigInfo", "get_siginfo", "to_printable", "prettyprint", "ContextObject", "importable_name"]


@dataclass
class ContextObject:
    """A non-literal object referenced from generated code; passed via the exec ctx."""

    name: str
    obj: Any


Printable = Any


def importable_name(x: Any) -> str | None:
    """Module-qualified name for importable objects (functions, classes)."""
    mod = getattr(x, "__module__", None)
    qual = getattr(x, "__qualname__", None)
    if mod is None or qual is None or "<locals>" in qual:
        return None
    return f"{mod}.{qual}"


def to_printable(trace, x: Any) -> Printable:
    """Converts a value into something ``prettyprint`` can render.

    Proxies and base literals print directly; other objects are registered as
    named context objects on the trace.
    """
    from thunder_tpu_torch.core.pytree import tree_flatten

    if isinstance(x, ProxyInterface):
        return x
    if is_base_printable(x):
        return x
    if baseutils.is_collection(x):
        leaves, spec = tree_flatten(x)
        # a container subclass the pytree does not open (dict/tuple
        # subclasses like HF configs) comes back as its own single leaf —
        # recursing would loop forever; register it as an opaque context
        # object instead
        if not (len(leaves) == 1 and leaves[0] is x):
            printables = tuple(to_printable(trace, l) for l in leaves)
            from thunder_tpu_torch.core.pytree import tree_unflatten

            return tree_unflatten(printables, spec)
    from thunder_tpu_torch.core import dtypes
    from thunder_tpu_torch.core.devices import Device

    if isinstance(x, (dtypes.dtype, Device)):
        return x
    # opaque object: register on trace
    if trace is not None:
        name = trace.register_object(x)
        return ContextObject(name, x)
    return x


def _print_dtype(d) -> str:
    from thunder_tpu_torch.core import dtypes

    attr = None
    for n, v in vars(dtypes).items():
        if v is d:
            attr = n
            break
    return f"dtypes.{attr}" if attr else repr(d)


def prettyprint(x: Any, *, with_type: bool = False, literals_as_underscores: bool = False) -> str:
    """Renders a printable (from ``to_printable``) as Python source."""
    from thunder_tpu_torch.core import dtypes
    from thunder_tpu_torch.core.devices import Device

    if isinstance(x, ContextObject):
        return x.name
    if isinstance(x, ProxyInterface):
        if with_type:
            return f'{x.name}: "{x.type_string()}"'
        return x.name
    if isinstance(x, dtypes.dtype):
        return _print_dtype(x)
    if isinstance(x, Device):
        return f'devices.Device("{x.device_str()}")'
    if literals_as_underscores and is_base_printable(x) and not baseutils.is_collection(x):
        return "_"
    if is_base_printable(x):
        return print_base_printable(x)
    if isinstance(x, tuple):
        if len(x) == 1:
            return f"({prettyprint(x[0], literals_as_underscores=literals_as_underscores)},)"
        return f"({', '.join(prettyprint(i, literals_as_underscores=literals_as_underscores) for i in x)})"
    if isinstance(x, list):
        return f"[{', '.join(prettyprint(i, literals_as_underscores=literals_as_underscores) for i in x)}]"
    if isinstance(x, dict):
        items = ", ".join(
            f"{prettyprint(k, literals_as_underscores=literals_as_underscores)}: "
            f"{prettyprint(v, literals_as_underscores=literals_as_underscores)}"
            for k, v in x.items()
        )
        return f"{{{items}}}"
    if isinstance(x, set):
        if not x:
            return "set()"
        return f"{{{', '.join(prettyprint(i) for i in x)}}}"
    return repr(x)


@dataclass
class SigInfo:
    """Captured signature of the traced callable, used to print the trace header."""

    name: str
    args: list = field(default_factory=list)  # list[(name, default_printable_or_None)]
    varargs: tuple | None = None  # (name, value)
    kwargs: dict = field(default_factory=dict)
    varkwargs: tuple | None = None
    defaultdict: dict = field(default_factory=dict)

    def prettyprint(self, *, trace=None) -> str:
        params = []
        for name, _ in self.args:
            params.append(name)
        if self.varargs is not None:
            params.append(f"*{self.varargs[0]}")
        for name in self.kwargs:
            params.append(f"{name}={name}" if False else name)
        if self.varkwargs is not None:
            params.append(f"**{self.varkwargs[0]}")
        return f"def {self.name}({', '.join(params)}):"


def get_siginfo(fn: Callable, args: Sequence, kwargs: dict) -> SigInfo:
    name = baseutils.extract_callable_name(fn)
    if not name.isidentifier():
        name = "".join(c if c.isalnum() or c == "_" else "_" for c in name)
        if not name or name[0].isdigit():
            name = f"fn_{name}"
    si = SigInfo(name=name)
    try:
        sig = inspect.signature(fn)
        bound = sig.bind(*args, **kwargs)
    except (TypeError, ValueError):
        si.args = [(f"arg{i}", None) for i in range(len(args))]
        si.kwargs = dict(kwargs)
        return si

    for pname, param in sig.parameters.items():
        if pname not in bound.arguments:
            continue
        val = bound.arguments[pname]
        if param.kind == inspect.Parameter.VAR_POSITIONAL:
            si.varargs = (pname, val)
        elif param.kind == inspect.Parameter.VAR_KEYWORD:
            si.varkwargs = (pname, val)
        elif param.kind == inspect.Parameter.KEYWORD_ONLY:
            si.kwargs[pname] = val
        else:
            si.args.append((pname, val))
    return si
