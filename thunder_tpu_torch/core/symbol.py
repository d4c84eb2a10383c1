"""Symbols and bound symbols: the instructions of a trace.

Counterpart of ``thunder_tpu/core/symbol.py``, copied; the provenance walk
skips the port's own frames.  The reference is the analog of Lightning
Thunder's ``thunder/core/symbol.py`` (Symbol :127, BoundSymbol :280,
BoundSymbolRHS :631).  Calling a Symbol inside a trace runs its meta
function and records a BoundSymbol; non-prim symbols additionally record the
subsymbols produced while the meta ran, giving every trace a decomposition
hierarchy that executors can claim at any level.
"""
from __future__ import annotations

import os
import sys
import sysconfig
from contextlib import contextmanager
from contextvars import ContextVar
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Hashable, Sequence

import torch

from thunder_tpu_torch.core import baseutils, codeutils
from thunder_tpu_torch.core.baseutils import BoundSymbolInterface, SymbolInterface, check
from thunder_tpu_torch.core.codeutils import prettyprint, to_printable
from thunder_tpu_torch.core.proxies import Proxy, TensorProxy, Variable, variableify
from thunder_tpu_torch.core.pytree import tree_flatten, tree_unflatten

__all__ = [
    "Symbol",
    "BoundSymbol",
    "BoundSymbolRHS",
    "has_tags",
    "gather_tags",
    "gather_provenance",
    "provenance_inherited",
]


#
# Source provenance: which user line produced a bound symbol.
#
# Recorded at trace time (Symbol.__call__ walks up past the framework frames
# to the first user frame) and carried through every rewriting pass via
# from_bsym, so anomaly detection and debug hooks can name the user's
# file:line even after claiming and fusion.  Framework machinery = anything
# under the thunder_tpu_torch package (except models/, which IS user-level model
# code), the stdlib, and site-packages; everything else is "user code".
#

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PKG_USER_DIRS = (os.path.join(_PKG_ROOT, "models"),)
_STDLIB = sysconfig.get_paths().get("stdlib", "")
_SEP = os.sep

# per-filename machinery verdicts; traces revisit the same few files thousands
# of times, so this keeps the per-bsym cost at one dict hit per frame
_machinery_files: dict[str, bool] = {}


def _is_machinery_file(fname: str) -> bool:
    hit = _machinery_files.get(fname)
    if hit is None:
        hit = (
            not fname
            or fname.startswith("<")
            or (f"{_SEP}site-packages{_SEP}" in fname)
            or (_STDLIB and fname.startswith(_STDLIB + _SEP))
            or (
                fname.startswith(_PKG_ROOT + _SEP)
                and not fname.startswith(_PKG_USER_DIRS)
            )
        )
        _machinery_files[fname] = hit
    return hit


def _capture_provenance() -> tuple[str | None, int | None]:
    """(filename, lineno) of the nearest user frame, or (None, None)."""
    f = sys._getframe(2)
    depth = 0
    while f is not None and depth < 64:
        if not _is_machinery_file(f.f_code.co_filename):
            return f.f_code.co_filename, f.f_lineno
        f = f.f_back
        depth += 1
    return None, None


# rewriting passes that re-trace on behalf of an existing bsym (executor
# execution_transforms, backward-rule expansion) set this so the freshly
# recorded bsyms inherit the original's provenance instead of walking a
# stack made entirely of framework frames
_provenance_override: ContextVar[tuple | None] = ContextVar(
    "provenance_override", default=None
)


@contextmanager
def provenance_inherited(bsym: "BoundSymbol"):
    """Bound symbols recorded inside inherit ``bsym``'s source provenance."""
    token = _provenance_override.set((bsym.source_filename, bsym.source_positions))
    try:
        yield
    finally:
        _provenance_override.reset(token)


def default_python_printer(bsym: "BoundSymbol", out_printables, arg_printables, kwarg_printables) -> str:
    result_str = ""
    if bsym.output is not None and (not isinstance(bsym.output, Sequence) or len(bsym.output) > 0):
        result_str = f"{prettyprint(out_printables)} = "
    arg_str = ", ".join(prettyprint(x) for x in arg_printables)
    kwarg_str = ", ".join(f"{k}={prettyprint(v)}" for k, v in kwarg_printables.items())
    call_str = ", ".join(s for s in (arg_str, kwarg_str) if s)
    return f"{result_str}{bsym.name_with_module()}({call_str})"


class Symbol(SymbolInterface):
    """A named, traceable operation.

    Attributes:
        name: printable name
        meta: shape/dtype propagation fn over proxies; for non-prims the meta is
            the decomposition itself (it calls other symbols while tracing)
        id: stable hashable id (prims use PrimIDs values)
        is_prim: if True, calling it records a single BoundSymbol with no
            subsymbols; if False, subsymbols are recorded
        is_fusion: marks executor fusion symbols
        executor: the executor that owns this symbol, if any
        python_impl: direct Python implementation used when the generated
            program calls this symbol outside any executor (prologue checks,
            del, …)
        _module: module whose attribute this symbol is, for codegen imports
        _fn: concrete callable for operator-executor symbols
        _bind_postprocess: hook invoked on each freshly created BoundSymbol
        tags: OpTags
    """

    def __init__(
        self,
        *,
        name: str,
        meta: Callable | None = None,
        id: Hashable | None = None,
        is_prim: bool = False,
        is_fusion: bool = False,
        tags: Sequence | None = None,
        executor: Any = None,
        python_impl: Callable | None = None,
        module: Any = None,
        _fn: Callable | None = None,
        python_printer: Callable = default_python_printer,
        _bind_postprocess: Callable | None = None,
    ):
        self.name = name
        self.meta = meta
        self.id = id
        self.is_prim = is_prim
        self.is_fusion = is_fusion
        self.tags = tuple(tags) if tags is not None else ()
        self.executor = executor
        self.python_impl = python_impl
        self._module = module
        self._fn = _fn
        self.python_printer = python_printer
        self._bind_postprocess = _bind_postprocess

    @property
    def module(self):
        return self._module

    @property
    def fn(self) -> Callable | None:
        return self._fn

    def __repr__(self) -> str:
        return f"[Symbol name={self.name}]"

    def name_with_module(self) -> str:
        if self._module is not None:
            alias = getattr(self._module, "__print_alias__", None)
            if alias is None:
                modname = self._module.__name__ if hasattr(self._module, "__name__") else str(self._module)
                alias = modname.split(".")[-1]
            return f"{alias}.{self.name}"
        return self.name

    def normalize(self, *args, **kwargs):
        return args, kwargs

    def bind(self, *args, output, subsymbols=(), _call_ctx=None, **kwargs) -> "BoundSymbol":
        b = BoundSymbol(
            self,
            args=tuple(args),
            kwargs=kwargs,
            output=output,
            subsymbols=tuple(subsymbols),
            _call_ctx=_call_ctx,
        )
        if self._bind_postprocess is not None:
            self._bind_postprocess(b)
        return b

    def __call__(self, *args, **kwargs):
        from thunder_tpu_torch.core.trace import get_tracectx

        trace = get_tracectx()
        if trace is None:
            # Eager escape hatch: execute directly when an implementation exists.
            if self._fn is not None:
                return self._fn(*args, **kwargs)
            if self.python_impl is not None:
                return self.python_impl(*args, **kwargs)
            # Generic eager mode: record into a micro-trace and evaluate it
            # at once with the torch executor's implementations.  Works
            # inside torch.func transforms too (core/eager.py).
            if self.meta is not None:
                from thunder_tpu_torch.core.eager import eager_symbol_eval

                return eager_symbol_eval(self, args, kwargs)
            raise RuntimeError(
                f"Symbol {self.name} called outside of a trace and has no eager implementation"
            )

        check(self.meta is not None, lambda: f"Symbol {self.name} has no meta function")

        # CONSTANT_VALUES caching: known number/string proxies fold to literals
        # at every op boundary, so computation traces only carry tensor proxies
        # (guards on the original inputs live in the prologue).  Check/unpack
        # prims must see the proxies themselves.
        from thunder_tpu_torch.core.prims import OpTags as _OpTags

        if not (_OpTags.CHECK_OP in self.tags or _OpTags.UNPACK_OP in self.tags):
            from thunder_tpu_torch.core.proxies import NumberProxy as _NP, StringProxy as _SP
            from thunder_tpu_torch.core.pytree import tree_flatten as _tf, tree_unflatten as _tu

            def _fold(x):
                if isinstance(x, _NP) and x.value is not None:
                    return x.value
                if isinstance(x, _SP):
                    return x.value
                return x

            flat, spec = _tf((args, kwargs))
            flat = [_fold(x) for x in flat]
            # real torch.Tensor operands (constants from the tracing mode's
            # concrete-factory fast path) bake to constant proxies before
            # binding, so recorded bsym args never carry raw torch tensors
            if any(isinstance(x, torch.Tensor) for x in flat):
                from thunder_tpu_torch.torch_interop import _const_tensor_proxy

                flat = [_const_tensor_proxy(x) if isinstance(x, torch.Tensor) else x
                        for x in flat]
            args, kwargs = _tu(flat, spec)

        if self.is_prim:
            # prims run their meta without recording subsymbols
            with trace.suppress_recording():
                result = self.meta(*args, **kwargs)
            subsymbols = ()
        else:
            with trace.push_scope() as subscope:
                result = self.meta(*args, **kwargs)
            subsymbols = tuple(subscope)

        # identity record: a composite that returned (a subset of) its inputs
        # unchanged and traced nothing (e.g. no-op ``to``) — the names already
        # bind, so recording would only confuse downstream passes
        if not subsymbols and not self.is_prim:
            from thunder_tpu_torch.core.proxies import Proxy as _Proxy
            from thunder_tpu_torch.core.pytree import tree_flatten as _tf

            out_proxies = [x for x in _tf(result)[0] if isinstance(x, _Proxy)]
            if out_proxies:
                in_ids = {id(x) for x in _tf((args, kwargs))[0] if isinstance(x, _Proxy)}
                if all(id(p) in in_ids for p in out_proxies):
                    return result

        bsym = self.bind(*args, output=result, subsymbols=subsymbols, **kwargs)
        override = _provenance_override.get()
        if override is not None:
            bsym.source_filename, bsym.source_positions = override
        else:
            bsym.source_filename, bsym.source_positions = _capture_provenance()
        trace.record(bsym)
        return result


class BoundSymbol(BoundSymbolInterface):
    """A Symbol bound to concrete (proxy) arguments and outputs."""

    def __init__(
        self,
        sym: Symbol,
        *,
        args: tuple,
        kwargs: dict,
        output: Any,
        subsymbols: tuple = (),
        _call_ctx: dict | None = None,
        header: str | None = None,
        source_filename: str | None = None,
        source_positions: Any = None,
    ):
        self.sym = sym
        self.args = args
        self.kwargs = kwargs
        self.output = output
        self.subsymbols = subsymbols
        self._call_ctx = _call_ctx
        self.header = header
        self.source_filename = source_filename
        self.source_positions = source_positions
        self._out_printables = None

    #
    # Introspection
    #

    @property
    def _flat_args(self):
        flat, _ = tree_flatten((self.args, self.kwargs))
        return flat

    @property
    def flat_args(self):
        return self._flat_args

    @property
    def flat_proxy_args(self) -> tuple[Proxy, ...]:
        return tuple(x for x in self._flat_args if isinstance(x, Proxy))

    @property
    def flat_outs(self):
        flat, _ = tree_flatten(self.output)
        return flat

    @property
    def flat_proxy_outs(self) -> tuple[Proxy, ...]:
        return tuple(x for x in self.flat_outs if isinstance(x, Proxy))

    @property
    def flat_variableified_proxy_args(self) -> tuple[Variable, ...]:
        return tuple(variableify(x) for x in self.flat_proxy_args)

    @property
    def flat_variableified_proxy_outs(self) -> tuple[Variable, ...]:
        return tuple(variableify(x) for x in self.flat_proxy_outs)

    def name_with_module(self) -> str:
        return self.sym.name_with_module()

    def has_tag(self, tag) -> bool:
        return tag in self.sym.tags

    #
    # Rewriting
    #

    def from_bsym(self, **kwargs) -> "BoundSymbol":
        new = BoundSymbol(
            kwargs.get("sym", self.sym),
            args=kwargs.get("args", self.args),
            kwargs=kwargs.get("kwargs", self.kwargs),
            output=kwargs.get("output", self.output),
            subsymbols=kwargs.get("subsymbols", self.subsymbols),
            _call_ctx=kwargs.get("_call_ctx", self._call_ctx),
            header=kwargs.get("header", self.header),
            source_filename=kwargs.get("source_filename", self.source_filename),
            source_positions=kwargs.get("source_positions", self.source_positions),
        )
        return new

    def from_bsym_swap_proxies(
        self,
        swap_map: dict[Variable, Proxy],
        *,
        skip_inputs: bool = False,
        skip_output: bool = False,
        skip_subsymbols: bool = False,
    ) -> "BoundSymbol":
        """Returns a copy with proxies replaced according to ``swap_map``."""
        if not swap_map:
            return self

        def swap(c):
            flat, spec = tree_flatten(c)
            out = []
            for x in flat:
                if isinstance(x, Proxy):
                    v = variableify(x)
                    x = swap_map.get(v, x)
                out.append(x)
            return tree_unflatten(out, spec)

        nargs = self.args if skip_inputs else swap(self.args)
        nkwargs = self.kwargs if skip_inputs else swap(self.kwargs)
        nout = self.output if skip_output else swap(self.output)
        nsubs = self.subsymbols
        if not skip_subsymbols:
            nsubs = tuple(
                s.from_bsym_swap_proxies(swap_map, skip_inputs=skip_inputs, skip_output=skip_output)
                for s in self.subsymbols
            )
        return self.from_bsym(args=nargs, kwargs=nkwargs, output=nout, subsymbols=nsubs)

    def rhs(self) -> "BoundSymbolRHS":
        return BoundSymbolRHS(self)

    #
    # Codegen
    #

    def import_ctx(self) -> dict[str, Any]:
        """Modules/objects the printed form references, merged into the exec ctx."""
        ctx: dict[str, Any] = {}
        if self.sym.is_fusion or self._call_ctx is not None:
            pass  # call ctx objects handled by gather_call_ctx
        elif self.sym.executor is not None and self.sym.fn is not None:
            ctx[self.sym.name] = self.sym.fn
        elif self.sym.module is not None:
            mod = self.sym.module
            alias = getattr(mod, "__print_alias__", None)
            if alias is None:
                alias = (mod.__name__ if hasattr(mod, "__name__") else str(mod)).split(".")[-1]
            ctx[alias] = mod
        elif self.sym.python_impl is not None:
            ctx[self.sym.name] = self.sym.python_impl
        elif self.sym.fn is not None:
            ctx[self.sym.name] = self.sym.fn
        for sub in self.subsymbols:
            pass  # subsymbols are comments; no imports needed
        return ctx

    def gather_call_ctx(self) -> dict[str, Any]:
        ctx = dict(self._call_ctx or {})
        return ctx

    def python(self, indent: int = 0, print_depth: int = 1, commented: bool = False) -> list[str]:
        """Renders this bound symbol (and optionally subsymbols as comments)."""
        from thunder_tpu_torch.core.trace import get_tracectx

        trace = get_tracectx()
        out_printables = to_printable(trace, self.output)
        arg_printables = tuple(to_printable(trace, a) for a in self.args)
        kwarg_printables = {k: to_printable(trace, v) for k, v in self.kwargs.items()}

        line = self.sym.python_printer(self, out_printables, arg_printables, kwarg_printables)
        prefix = baseutils.indent(indent) + ("# " if commented else "")
        lines = []
        if self.header:
            for h in self.header.splitlines():
                lines.append(baseutils.indent(indent) + f"# {h}")
        if isinstance(line, str):
            lines.append(prefix + line)
        else:
            lines.extend(prefix + l for l in line)
        if print_depth > 1 or (print_depth == -1):
            next_depth = -1 if print_depth == -1 else print_depth - 1
            for sub in self.subsymbols:
                lines.extend(sub.python(indent + 1, print_depth=next_depth, commented=True))
        return lines

    def __repr__(self) -> str:
        try:
            return "\n".join(self.python(indent=0, print_depth=-1))
        except Exception:
            return f"<BoundSymbol {self.sym.name}>"


class BoundSymbolRHS:
    """Hashable view of (sym.id, args, kwargs) for CSE (reference symbol.py:631)."""

    def __init__(self, bsym: BoundSymbol):
        self.bsym = bsym
        self._hashable_args = tuple(variableify(x) for x in bsym._flat_args)
        key = bsym.sym.id if bsym.sym.id is not None else bsym.sym.name
        self._key = (key, self._hashable_args)

    def __hash__(self):
        try:
            return hash(self._key)
        except TypeError:
            return id(self.bsym)

    def __eq__(self, other):
        if not isinstance(other, BoundSymbolRHS):
            return False
        try:
            return self._key == other._key
        except Exception:
            return self.bsym is other.bsym


def gather_provenance(bsym: BoundSymbol) -> tuple[tuple[str, Any], ...]:
    """Ordered, de-duplicated ``(filename, position)`` pairs for ``bsym`` and
    its subsymbols — for a fusion region this is the provenance list of every
    op folded into it.  A bsym whose ``source_filename`` is None but whose
    ``source_positions`` is a sequence carries a pre-gathered list (fusion
    symbols store one so provenance survives passes that drop subsymbols)."""
    out: list[tuple[str, Any]] = []
    seen: set = set()

    def add(entry) -> None:
        try:
            new = entry not in seen
        except TypeError:  # unhashable position payloads: keep, unde-duplicated
            out.append(entry)
            return
        if new:
            seen.add(entry)
            out.append(entry)

    def walk(b: BoundSymbol) -> None:
        if b.source_filename is not None:
            add((b.source_filename, b.source_positions))
        elif isinstance(b.source_positions, (list, tuple)):
            for entry in b.source_positions:
                add(tuple(entry) if isinstance(entry, list) else entry)
        for sub in b.subsymbols:
            walk(sub)

    walk(bsym)
    return tuple(out)


def gather_tags(bsym: BoundSymbol) -> set:
    tags = set(bsym.sym.tags)
    for sub in bsym.subsymbols:
        tags |= gather_tags(sub)
    return tags


def has_tags(bsym: BoundSymbol, tags: set) -> bool:
    """True if the bsym or any subsymbol carries one of ``tags``."""
    return bool(gather_tags(bsym) & set(tags))
