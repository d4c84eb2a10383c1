"""Language contexts: method resolution for proxies.

Counterpart of ``thunder_tpu/core/langctxs.py``, itself the analog of the
reference's ``thunder/core/langctxs.py`` (LanguageContext registry,
``resolve_method``): ``TensorProxy.__getattr__`` and operators dispatch through
the active language (torch-like by default), so ``a + b`` and ``a.sum()`` record
the right symbols.
"""
from __future__ import annotations

from contextlib import contextmanager
from contextvars import ContextVar
from enum import Enum
from typing import Any, Callable

__all__ = [
    "LanguageContext",
    "Languages",
    "register_langctx",
    "resolve_language",
    "get_langctx",
    "set_langctx",
    "reset_langctx",
    "langctx",
    "resolve_method",
]


class Languages(Enum):
    CLANG = "clang"
    TORCH = "torch"
    NUMPY = "numpy"
    PRIMS = "prims"


class LanguageContext:
    def __init__(self, name: str):
        self._name = name
        self._methods: dict[str, Callable] = {}

    @property
    def name(self) -> str:
        return self._name

    def register_method(self, method_name: str, fn: Callable) -> None:
        self._methods[method_name] = fn

    def get_method(self, id: str, *args, **kwargs) -> Callable:
        method = self._methods.get(id)
        if method is None:
            raise AttributeError(f"The {self._name} language context has no method {id}")
        return method

    def has_method(self, id: str) -> bool:
        return id in self._methods


_langctx_registry: dict[Any, LanguageContext] = {}


def register_langctx(id: Any, ctx: LanguageContext) -> LanguageContext:
    _langctx_registry[id] = ctx
    return ctx


def resolve_language(id: Any) -> LanguageContext:
    if isinstance(id, LanguageContext):
        return id
    if isinstance(id, str):
        # string aliases ("torch", "numpy", ...) resolve through the enum;
        # importing the module registers its context on first use.  Members
        # with no module/registered context (prims) fall through to the
        # registry lookup below and fail with the uniform LookupError.
        try:
            lang = Languages(id.lower())
        except ValueError:
            raise LookupError(f"Unknown language context {id!r}") from None
        import importlib

        try:
            importlib.import_module(f"thunder_tpu_torch.{lang.value}")
        except ImportError:
            pass
        id = lang
    ctx = _langctx_registry.get(id)
    if ctx is None and id is Languages.TORCH:
        # the torch language registers itself on import
        import thunder_tpu_torch.torch  # noqa: F401

        ctx = _langctx_registry.get(id)
    if ctx is None:
        raise LookupError(f"Unknown language context {id}")
    return ctx


_langctx_var: ContextVar[LanguageContext | None] = ContextVar("langctx", default=None)


def get_langctx() -> LanguageContext:
    ctx = _langctx_var.get()
    if ctx is None:
        return resolve_language(Languages.TORCH)
    return ctx


def set_langctx(ctx: LanguageContext | Any):
    return _langctx_var.set(resolve_language(ctx))


def reset_langctx(token) -> None:
    _langctx_var.reset(token)


@contextmanager
def langctx(ctx: LanguageContext | Any):
    tok = set_langctx(ctx)
    try:
        yield
    finally:
        reset_langctx(tok)


def resolve_method(id: str, *args, **kwargs) -> Callable | None:
    """Returns the active language's implementation of method ``id``.

    A context that does not OVERRIDE a method falls back to the torch
    surface (the framework's full method set): alternate languages
    (numpy) register only the methods whose semantics differ, and proxy
    dunders (`+`, `[]`, ...) keep working everywhere."""
    ctx = get_langctx()
    try:
        return ctx.get_method(id, *args, **kwargs)
    except AttributeError:
        pass
    if ctx.name != "torch":
        try:
            return resolve_language(Languages.TORCH).get_method(id, *args, **kwargs)
        except (AttributeError, LookupError):
            return None
    return None
