"""Traces: ordered, printable, executable programs of bound symbols.

Counterpart of ``thunder_tpu/core/trace.py`` (copied; only the imports change).

Analog of the reference's ``thunder/core/trace.py`` (TraceCtx :46,
TraceProvenance :29, ``set_tracectx`` :453, ``from_trace`` :434, TraceResults
:582).  A trace prints itself as a runnable Python program whose calls target
executors' callables, and compiles that source with ``compile_and_exec``.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from contextvars import ContextVar
from dataclasses import dataclass
from typing import Any, Callable, Sequence

from thunder_tpu_torch.core import baseutils
from thunder_tpu_torch.core.baseutils import check, compile_and_exec
from thunder_tpu_torch.core.codeutils import SigInfo, get_siginfo
from thunder_tpu_torch.core.proxies import Proxy, TensorProxy

__all__ = [
    "TraceCtx",
    "TraceProvenance",
    "TraceResults",
    "TraceTag",
    "get_tracectx",
    "set_tracectx",
    "reset_tracectx",
    "tracectx",
    "maybe_start_trace",
    "from_trace",
]


@dataclass
class TraceProvenance:
    """Which pass produced a trace (with timing)."""

    pss: str

    def __repr__(self) -> str:
        return f"# Constructed by {self.pss}"


class TraceTag:
    AUGMENTED_FORWARD = "AUGMENTED_FORWARD"
    BACKWARD = "BACKWARD"
    PROLOGUE = "PROLOGUE"
    EPILOGUE = "EPILOGUE"
    DISTRIBUTED = "DISTRIBUTED"


class TraceCtx:
    def __init__(self, fn: Callable | None = None, *, prologue: "TraceCtx | None" = None):
        self.fn = fn
        self.bound_symbols: list = []
        self._scopes: list[list] = [self.bound_symbols]
        self._suppress = 0

        self.args: tuple | None = None
        self.kwargs: dict = {}
        self._siginfo: SigInfo | None = None

        self.names: set[str] = set()
        self._name_ctrs: dict[str, int] = {}

        self._object_ctx: dict[str, Any] = {}
        self._object_names: dict[int, str] = {}

        self._provenance: TraceProvenance | None = None
        self.tags: set[str] = set()

        self.prologue = prologue
        # set by the fw/bw split: names of saved-for-backward proxies
        self._siginfo_hint: str | None = None

    #
    # Naming
    #

    def make_name(self, prefix: str = "t") -> str:
        ctr = self._name_ctrs.get(prefix, 0)
        while True:
            name = f"{prefix}{ctr}"
            ctr += 1
            if name not in self.names:
                break
        self._name_ctrs[prefix] = ctr
        self.names.add(name)
        return name

    def add_name(self, name: str) -> None:
        self.names.add(name)

    def has_name(self, name: str) -> bool:
        return name in self.names

    #
    # Recording
    #

    def record(self, bsym) -> None:
        if self._suppress:
            return
        self._scopes[-1].append(bsym)

    @contextmanager
    def push_scope(self):
        scope: list = []
        self._scopes.append(scope)
        try:
            yield scope
        finally:
            popped = self._scopes.pop()
            check(popped is scope, lambda: "Unbalanced trace scopes")

    @contextmanager
    def suppress_recording(self):
        self._suppress += 1
        try:
            yield
        finally:
            self._suppress -= 1

    @property
    def scopes(self) -> list[list]:
        return self._scopes

    def peek_scope(self) -> list:
        return self._scopes[-1]

    #
    # Provenance and objects
    #

    def set_provenance(self, provenance: TraceProvenance | str) -> None:
        if isinstance(provenance, str):
            provenance = TraceProvenance(provenance)
        self._provenance = provenance

    def get_provenance(self) -> TraceProvenance | None:
        return self._provenance

    def register_object(self, obj: Any, name: str | None = None) -> str:
        key = id(obj)
        if key in self._object_names:
            return self._object_names[key]
        if name is None:
            base = baseutils.extract_callable_name(obj) if callable(obj) else type(obj).__name__.lower()
            name = self.make_name(prefix=f"_{base}_")
        self._object_names[key] = name
        self._object_ctx[name] = obj
        return name

    #
    # Signature
    #

    def siginfo(self) -> SigInfo:
        if self._siginfo is not None:
            return self._siginfo
        check(self.fn is not None, lambda: "Trace has no function or signature info")
        self._siginfo = get_siginfo(self.fn, self.args or (), self.kwargs or {})
        return self._siginfo

    def set_siginfo(self, si: SigInfo) -> None:
        self._siginfo = si

    def name_args_for_print(self) -> list[str]:
        si = self.siginfo()
        parts = []
        for name, _ in si.args:
            parts.append(name)
        if si.varargs is not None:
            parts.append(f"*{si.varargs[0]}")
        for name in si.kwargs:
            parts.append(name)
        if si.varkwargs is not None:
            parts.append(f"**{si.varkwargs[0]}")
        return parts

    #
    # Codegen
    #

    def python(self, *, print_depth: int = 2, include_decorators: bool = True) -> str:
        """Renders the trace as a Python program string."""
        token = set_tracectx(self)
        try:
            lines: list[str] = []
            if self._provenance is not None:
                lines.append(repr(self._provenance))
            # the donation pass leaves a one-line summary (buffers/bytes
            # donated, per-reason rejections) so a dumped program documents
            # its own aliasing behavior
            summary = getattr(self, "_donation_summary", None)
            if summary:
                lines.append(f"# donation: {summary}")
            lines.append("import thunder_tpu_torch.core.dtypes as dtypes")
            lines.append("import thunder_tpu_torch.core.devices as devices")
            lines.append("")

            si = self.siginfo()
            lines.append(f"def {si.name}({', '.join(self.name_args_for_print())}):")

            # arg type comments
            for name, val in si.args:
                if isinstance(val, TensorProxy):
                    lines.append(f'  # {name}: "{val.type_string()}"')

            body_empty = True
            for bsym in self.bound_symbols:
                bsym_lines = bsym.python(indent=1, print_depth=print_depth)
                lines.extend(bsym_lines)
                body_empty = False
            if body_empty:
                lines.append("  pass")
            return "\n".join(lines) + "\n"
        finally:
            reset_tracectx(token)

    def import_ctx(self) -> dict[str, Any]:
        ctx: dict[str, Any] = {}

        def gather(bsyms):
            for bsym in bsyms:
                ctx.update(bsym.import_ctx())
                ctx.update(bsym.gather_call_ctx())

        gather(self.bound_symbols)
        from thunder_tpu_torch.core import devices, dtypes

        ctx.setdefault("dtypes", dtypes)
        ctx.setdefault("devices", devices)
        ctx.update(self._object_ctx)
        return ctx

    def python_callable(self, **kwargs) -> Callable:
        """Compiles this trace's printed program and returns the callable.

        When an execution file is set (``set_execution_callback_file``,
        reference trace.py:565-574), the generated program is dumped there —
        and if the file already holds a user-edited program, that version is
        compiled and executed instead (debug lever: edit the generated code,
        rerun)."""
        from thunder_tpu_torch.observability.events import span as _phase_span

        with _phase_span("codegen", trace=self.siginfo().name):
            return self._python_callable_impl(**kwargs)

    def _python_callable_impl(self, **kwargs) -> Callable:
        python_str = self.python(**kwargs)
        si = self.siginfo()
        path = _execution_file.get()
        if path is not None:
            import hashlib
            import os

            # keyed by generated-source hash: a different function (or a
            # retrace with new shapes) gets its own file instead of silently
            # executing another program's edited dump; the same generated
            # program keeps finding the user's edits
            digest = hashlib.sha1(python_str.encode()).hexdigest()[:10]
            fname = f"{path}.{si.name}.{digest}.py"
            if os.path.exists(fname):
                with open(fname) as f:
                    python_str = f.read()
            else:
                with open(fname, "w") as f:
                    f.write(python_str)
        fn = compile_and_exec(si.name, python_str, self.import_ctx())
        fn.__thunder_trace__ = self
        return fn

    def __repr__(self) -> str:
        try:
            return self.python(print_depth=2)
        except Exception as e:
            return f"<TraceCtx {len(self.bound_symbols)} bound symbols; unprintable: {e}>"


@dataclass
class TraceResults:
    """Result of frontend acquisition (reference trace.py:582).

    ``cache_key_meta`` is emitted next to the prologue: the structural
    dispatch key for the traced inputs, the key function that recomputes it,
    and a summary of external state the key canNOT cover (bytecode-frontend
    guards — those are why the prologue still runs once on a key hit)."""

    prologue_trace: TraceCtx
    computation_trace: TraceCtx
    epilogue_trace: TraceCtx | None
    interpreter_log: list
    cache_key_meta: dict | None = None


#
# Trace context management
#

_tracectx_var: ContextVar[TraceCtx | None] = ContextVar("tracectx", default=None)

# debug lever (reference trace.py:565-574): when set, generated programs are
# dumped to <path>.<fn name>.py and user-edited versions are executed instead
_execution_file: ContextVar[str | None] = ContextVar("execution_file", default=None)


def set_execution_callback_file(path: str | None) -> None:
    """Dump every generated program under ``path`` and execute user edits."""
    _execution_file.set(path)


def get_tracectx() -> TraceCtx | None:
    return _tracectx_var.get()


def set_tracectx(trace: TraceCtx):
    return _tracectx_var.set(trace)


def reset_tracectx(token) -> None:
    _tracectx_var.reset(token)


@contextmanager
def tracectx(trace: TraceCtx | None):
    token = set_tracectx(trace)
    try:
        yield trace
    finally:
        reset_tracectx(token)


def maybe_start_trace(fn: Callable | None = None) -> tuple[bool, Any, TraceCtx]:
    current = get_tracectx()
    if current is not None:
        return False, None, current
    trace = TraceCtx(fn)
    token = set_tracectx(trace)
    return True, token, trace


def from_trace(trace: TraceCtx) -> TraceCtx:
    """Shallow clone: same metadata and names, empty bound symbols."""
    new = TraceCtx(trace.fn, prologue=trace.prologue)
    new.args = trace.args
    new.kwargs = trace.kwargs
    new._siginfo = trace._siginfo
    new.names = set(trace.names)
    new._name_ctrs = dict(trace._name_ctrs)
    new._object_ctx = dict(trace._object_ctx)
    new._object_names = dict(trace._object_names)
    new.tags = set(trace.tags)
    return new
