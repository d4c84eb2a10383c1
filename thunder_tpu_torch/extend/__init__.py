"""Executor extension API.

Counterpart of ``thunder_tpu/extend/__init__.py``, copied.  The built-in
executors (``thunder_tpu_torch.executors``: ``cuda`` over the hand-written
kernels, ``torch`` as the always-executor) register on first use.  The
reference is the analog of ``thunder/extend/__init__.py`` (Executor :46,
OperatorExecutor :190, FusionExecutor :132, optimization fuel :136, global
registries :272).  Executors claim bound symbols during
``transform_for_execution``; operator executors substitute concrete callables,
fusion executors compile whole regions.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable, Hashable, Sequence

from thunder_tpu_torch.core.baseutils import check
from thunder_tpu_torch.core.symbol import BoundSymbol, Symbol, default_python_printer

__all__ = [
    "ImplInfo",
    "Executor",
    "OperatorExecutor",
    "FusionExecutor",
    "register_executor",
    "deregister_executor",
    "get_all_executors",
    "get_executor",
    "get_default_executors",
    "get_always_executors",
    "add_default_executor",
    "add_always_executor",
    "remove_default_executor",
    "remove_always_executor",
    "resolve_executors",
]


@dataclass
class ImplInfo:
    """How an executor implements a symbol."""

    symbol: Symbol | None = None  # executor's own symbol to substitute
    checker: Callable | None = None  # (*args, **kwargs) -> bool: can this impl run?
    execution_transform: Callable | None = None  # (*args, **kwargs) -> result, traced
    grad_transform: Callable | None = None  # custom grad rule when claimed


class Executor:
    def __init__(self, name: Hashable, *, version: str | None = None):
        self._name = name
        self._version = version
        self.implmap: dict[Hashable, ImplInfo] = {}
        self._lookasides: dict[Callable, Callable] = {}

    @property
    def name(self) -> Hashable:
        return self._name

    @property
    def version(self):
        return self._version

    def __repr__(self) -> str:
        return f"thunder_tpu_torch.extend.{type(self).__name__}('{self.name}')"

    def __hash__(self) -> int:
        return hash(self._name)

    def __eq__(self, other) -> bool:
        return isinstance(other, Executor) and other.name == self.name

    def can_execute(self, bsym: BoundSymbol) -> bool:
        impl = self.implmap.get(bsym.sym.id)
        if impl is None:
            return False
        if impl.checker is not None:
            try:
                return bool(impl.checker(*bsym.args, **bsym.kwargs))
            except Exception:
                return False
        return True

    def get_impl(self, sym_id: Hashable) -> ImplInfo | None:
        return self.implmap.get(sym_id)

    def register_lookaside(self, fn: Callable, replacement: Callable) -> None:
        self._lookasides[fn] = replacement

    def get_lookaside(self, fn: Callable) -> Callable | None:
        return self._lookasides.get(fn)


class OperatorExecutor(Executor):
    """Executes individual operations with concrete Python callables (JAX ops,
    Pallas kernels, …)."""

    def register_operator(
        self,
        name: str,
        *,
        like: Symbol | None = None,
        meta: Callable | None = None,
        fn: Callable | None = None,
        tags: Sequence | None = None,
        replaces: Callable | None = None,
        python_printer: Callable = default_python_printer,
    ) -> Symbol:
        check(
            (like is not None) or (meta is not None),
            lambda: "register_operator requires a meta function or a symbol to mimic (like=)",
        )
        meta_fn = meta if meta is not None else like.meta
        sym = Symbol(
            name=name,
            meta=meta_fn,
            id=f"{self.name}.{name}",
            is_prim=True,
            tags=tuple(tags) if tags is not None else (like.tags if like is not None else ()),
            executor=self,
            _fn=fn,
            python_printer=python_printer,
        )
        if replaces is not None:
            self._lookasides[replaces] = sym
        return sym

    def register_implementation(
        self,
        sym_or_id: Symbol | Hashable,
        op: Symbol | None = None,
        *,
        checker: Callable | None = None,
        execution_transform: Callable | None = None,
        grad_transform: Callable | None = None,
    ) -> None:
        sym_id = sym_or_id.id if isinstance(sym_or_id, Symbol) else sym_or_id
        self.implmap[sym_id] = ImplInfo(
            symbol=op, checker=checker, execution_transform=execution_transform, grad_transform=grad_transform
        )


class FusionExecutor(Executor):
    """Compiles regions of the trace into fused callables.

    Carries *optimization fuel* (reference extend/__init__.py:136): a budget of
    fusions to create, for bisecting miscompiles via
    ``THUNDER_TPU_OPTIMIZATION_FUEL``.
    """

    def __init__(self, name: Hashable, *, version: str | None = None):
        super().__init__(name, version=version)
        fuel = os.environ.get("THUNDER_TPU_OPTIMIZATION_FUEL", "")
        self._optimization_fuel: int | None = int(fuel) if fuel.isdigit() else None

    def get_fuel(self, amount: int = 1) -> bool:
        if self._optimization_fuel is None:
            return True
        if self._optimization_fuel < amount:
            return False
        self._optimization_fuel -= amount
        return True

    def set_fuel(self, amount: int | None) -> None:
        self._optimization_fuel = amount

    def fusion_pass(self, trace):
        raise NotImplementedError

    def register_supported(
        self, sym_or_id: Symbol | Hashable, *, checker: Callable | None = None
    ) -> None:
        sym_id = sym_or_id.id if isinstance(sym_or_id, Symbol) else sym_or_id
        self.implmap[sym_id] = ImplInfo(checker=checker)

    def can_fuse(self, bsym: BoundSymbol) -> bool:
        return self.can_execute(bsym)


#
# Global registries
#

_executor_map: dict[Hashable, Executor] = {}
_default_executors: list[Executor] = []
_always_executors: list[Executor] = []


def register_executor(ex: Executor) -> Executor:
    _executor_map[ex.name] = ex
    return ex


def deregister_executor(ex: Executor | Hashable) -> None:
    name = ex.name if isinstance(ex, Executor) else ex
    _executor_map.pop(name, None)
    remove_default_executor(name)
    remove_always_executor(name)


def get_all_executors() -> tuple[Executor, ...]:
    import thunder_tpu_torch.executors  # noqa: F401  (ensure built-ins registered)

    return tuple(_executor_map.values())


def get_executor(name: Hashable) -> Executor | None:
    import thunder_tpu_torch.executors  # noqa: F401

    return _executor_map.get(name)


def get_default_executors() -> tuple[Executor, ...]:
    import thunder_tpu_torch.executors  # noqa: F401

    return tuple(_default_executors)


def get_always_executors() -> tuple[Executor, ...]:
    import thunder_tpu_torch.executors  # noqa: F401

    return tuple(_always_executors)


def add_default_executor(ex: Executor) -> None:
    remove_default_executor(ex)
    _default_executors.insert(0, ex)


def add_always_executor(ex: Executor) -> None:
    if ex not in _always_executors:
        _always_executors.append(ex)


def remove_default_executor(ex: Executor | Hashable) -> None:
    name = ex.name if isinstance(ex, Executor) else ex
    _default_executors[:] = [e for e in _default_executors if e.name != name]


def remove_always_executor(ex: Executor | Hashable) -> None:
    name = ex.name if isinstance(ex, Executor) else ex
    _always_executors[:] = [e for e in _always_executors if e.name != name]


def resolve_executors(executors: Sequence | None) -> tuple[Executor, ...]:
    """Resolves names/instances into executor objects; None → defaults."""
    if executors is None:
        return get_default_executors()
    out = []
    for e in executors:
        if isinstance(e, Executor):
            out.append(e)
            continue
        ex = get_executor(e)
        check(ex is not None, lambda: f"Unknown executor {e!r}; known: {[x.name for x in get_all_executors()]}")
        out.append(ex)
    return tuple(out)
