"""Proxies: abstract values recorded into traces.

Counterpart of ``thunder_tpu/core/proxies.py`` (Proxy, NumberProxy family,
TensorProxy with language-context method dispatch, FutureTensorProxy,
DistParallelType, ``variableify``/``pyval``), copied with two seams changed:

- ``tensorproxy``/``is_proxyable`` read ``torch.Tensor`` and ``np.ndarray``;
  a CUDA tensor's proxy lives on ``cuda:N``.
- ``__torch_function__`` diverts torch calls on proxies into the torch
  language (``thunder_tpu_torch/torch``); ``FutureTensorProxy.wait`` (the
  distributed prims) raises ``NotImplementedError`` naming its
  ``ROADMAP.md`` Queue 1 item.  The ``sharding`` field is kept and stays
  ``None``.
"""
from __future__ import annotations

from enum import Enum, auto
from numbers import Number
from typing import Any, Callable, Sequence, Type

import numpy as np
import torch

from thunder_tpu_torch.core import baseutils, dtypes
from thunder_tpu_torch.core.baseutils import (
    NumberProxyInterface,
    ProxyInterface,
    TensorProxyInterface,
    check,
    check_type,
)
from thunder_tpu_torch.core.devices import Device, from_torch_device, to_device
from thunder_tpu_torch.core.langctxs import get_langctx, resolve_method

__all__ = [
    "DistParallelType",
    "Variable",
    "variableify",
    "unvariableify",
    "Proxy",
    "AnyProxy",
    "StringProxy",
    "CollectionProxy",
    "TupleProxy",
    "ListProxy",
    "DictProxy",
    "NumberProxy",
    "IntegerProxy",
    "FloatProxy",
    "ComplexProxy",
    "TensorProxy",
    "FutureTensorProxy",
    "pyval",
    "pytype",
    "proxy",
    "numberproxy",
    "is_proxyable",
    "is_proxy_name_available",
]


class DistParallelType(Enum):
    """How a tensor participates in data/model parallelism.

    Extends the reference's ``DDPType`` {NONE, REPLICATED, FULLY_SHARDED}
    (reference proxies.py:995) with tensor-parallel placements, which on TPU
    are just more shardings.
    """

    NONE = auto()
    REPLICATED = auto()
    FULLY_SHARDED = auto()
    COLUMN_WISE = auto()
    ROW_WISE = auto()


#
# Variables: name-keyed wrappers so proxies can be used in maps/sets by identity
#


class Variable:
    def __init__(self, p: "Proxy"):
        self.proxy = p

    def __hash__(self):
        return hash(self.proxy.name)

    def __eq__(self, other):
        return isinstance(other, Variable) and self.proxy.name == other.proxy.name

    def __repr__(self):
        return f"Variable({self.proxy.name})"


def variableify(x: Any) -> Any:
    if isinstance(x, Proxy):
        return Variable(x)
    return x


def unvariableify(x: Any) -> Any:
    if isinstance(x, Variable):
        return x.proxy
    return x


#
# Base proxy
#


def _get_tracectx():
    from thunder_tpu_torch.core.trace import get_tracectx

    return get_tracectx()


class Proxy(ProxyInterface):
    def __init__(self, name: str | None = None, *, history: Any = None, tags: set | None = None):
        trace = _get_tracectx()
        if name is None:
            prefix = self._name_prefix()
            check(trace is not None, lambda: "Cannot create an unnamed proxy outside of a trace")
            name = trace.make_name(prefix=prefix)
        elif trace is not None:
            trace.add_name(name)
        self._name = name
        self.history = history
        self._tags = tags if tags is not None else set()

    def _name_prefix(self) -> str:
        return "p"

    @property
    def name(self) -> str:
        return self._name

    @property
    def tags(self) -> set:
        return self._tags

    @property
    def prefix(self) -> str:
        return self._name_prefix()

    def type_string(self) -> str:
        return "Any"

    def replace_name(self, name: str | None = None):
        """Returns a copy of this proxy with a new name registered in the trace."""
        return self.__class__(name=name, history=self.history)

    def replace(self, **changes):
        return self.replace_name(changes.get("name"))

    def __repr__(self) -> str:
        return f"<{type(self).__name__} {self.name}>"

    #
    # Default operator dispatch through the active language context.
    # NumberProxy/TensorProxy refine these; having them here means AnyProxy
    # arithmetic produces good errors.
    #

    def _dispatch(self, method_name: str, *args, **kwargs):
        method = resolve_method(method_name, self, *args, **kwargs)
        if method is None:
            raise NotImplementedError(
                f"The active language context has no method {method_name!r} for {type(self).__name__}"
            )
        return method(*args, **kwargs)


class AnyProxy(Proxy):
    """Stands in for an arbitrary opaque object (None, dtypes, …) in prologues."""

    def __init__(self, value: Any = None, name: str | None = None, *, history: Any = None):
        super().__init__(name, history=history)
        self._value = value

    def _name_prefix(self):
        return "any"

    @property
    def value(self):
        return self._value

    def replace_name(self, name: str | None = None):
        return AnyProxy(self._value, name=name, history=self.history)

    def type_string(self) -> str:
        return str(type(self._value).__name__)


class StringProxy(Proxy, str):
    def __new__(cls, value: str, *, name: str | None = None, history: Any = None):
        self = str.__new__(cls, value)
        return self

    def __init__(self, value: str, *, name: str | None = None, history: Any = None):
        Proxy.__init__(self, name, history=history)
        self.value: str = value

    def _name_prefix(self):
        return "s"

    def __str__(self):
        return self.value

    def replace_name(self, name: str | None = None):
        return StringProxy(self.value, name=name, history=self.history)

    def type_string(self):
        return "str"

    def __eq__(self, other):
        if isinstance(other, StringProxy):
            return self.value == other.value
        return self.value == other

    def __hash__(self):
        return hash(self.value)


class CollectionProxy(Proxy):
    """Names a Python collection inside a trace (for unpacking)."""

    def __init__(self, coll: Any, *, name: str | None = None, history: Any = None):
        super().__init__(name, history=history)
        self.coll = coll

    def _name_prefix(self):
        return "coll"

    @property
    def collection(self) -> Any:
        return self.coll

    def replace_name(self, name: str | None = None):
        return self.__class__(self.coll, name=name, history=self.history)

    def type_string(self) -> str:
        return "Collection"


class TupleProxy(CollectionProxy):
    def _name_prefix(self):
        return "tup"


class ListProxy(CollectionProxy):
    def _name_prefix(self):
        return "lst"


class DictProxy(CollectionProxy):
    def _name_prefix(self):
        return "d"


#
# Number proxies
#
# Under CONSTANT_VALUES caching (the default), number proxies carry concrete
# values; arithmetic on them happens at trace time and bakes constants into the
# program, while the prologue re-checks the inputs each call.  This matches the
# reference's default behavior without recording number compute into the trace.
#


class NumberProxy(Proxy, NumberProxyInterface):
    def __init__(
        self,
        name: str | None = None,
        value: Number | None = None,
        *,
        python_type: Type,
        history: Any = None,
        constraint: Any = None,
    ):
        self._value = value
        self._python_type = python_type
        self.constraint = constraint
        super().__init__(name, history=history)

    def _name_prefix(self):
        return {bool: "b", int: "i", float: "f", complex: "c"}.get(self._python_type, "n")

    @property
    def value(self):
        return self._value

    @property
    def python_type(self) -> Type:
        return self._python_type

    def type_string(self) -> str:
        value_str = f"{self._value}" if self._value is not None else "?"
        return f"{self._python_type.__name__} {value_str}"

    def replace_name(self, name: str | None = None):
        return numberproxy(self._python_type, self._value, name=name, history=self.history)

    def known_value(self) -> bool:
        return self._value is not None

    # Concrete-value arithmetic: numbers fold at trace time.
    def _number_op(self, op: Callable, *args):
        operands = (self,) + args
        # defer BEFORE any concreteness check: symbolic-scalar ⊗ tensor must
        # reach TensorProxy's reflected op (which traces it), not raise here
        if any(isinstance(a, Proxy) and not isinstance(a, NumberProxy) for a in operands):
            return NotImplemented
        vals = []
        for a in operands:
            if isinstance(a, NumberProxy):
                a._check_concrete("number arithmetic")
            vals.append(pyval(a))
        return op(*vals)

    def __add__(self, other):
        return self._number_op(lambda a, b: a + b, other)

    def __radd__(self, other):
        return self._number_op(lambda a, b: b + a, other)

    def __sub__(self, other):
        return self._number_op(lambda a, b: a - b, other)

    def __rsub__(self, other):
        return self._number_op(lambda a, b: b - a, other)

    def __mul__(self, other):
        return self._number_op(lambda a, b: a * b, other)

    def __rmul__(self, other):
        return self._number_op(lambda a, b: b * a, other)

    def __truediv__(self, other):
        return self._number_op(lambda a, b: a / b, other)

    def __rtruediv__(self, other):
        return self._number_op(lambda a, b: b / a, other)

    def __floordiv__(self, other):
        return self._number_op(lambda a, b: a // b, other)

    def __rfloordiv__(self, other):
        return self._number_op(lambda a, b: b // a, other)

    def __mod__(self, other):
        return self._number_op(lambda a, b: a % b, other)

    def __rmod__(self, other):
        return self._number_op(lambda a, b: b % a, other)

    def __pow__(self, other):
        return self._number_op(lambda a, b: a**b, other)

    def __rpow__(self, other):
        return self._number_op(lambda a, b: b**a, other)

    def __neg__(self):
        self._check_concrete("-x")
        return -pyval(self)

    def __pos__(self):
        self._check_concrete("+x")
        return +pyval(self)

    def __abs__(self):
        self._check_concrete("abs()")
        return abs(pyval(self))

    def _check_concrete(self, op: str) -> None:
        if self._value is None:
            raise NotImplementedError(
                f"cannot use '{op}' on the symbolic number {self.name}: its value is "
                "unknown at trace time (a scalar input under cache='symbolic values', "
                "or a tensor .item() result).  Data-dependent Python control flow on "
                "it would bake one branch; use tensor ops (where/cond) instead, or "
                "make the value concrete (default cache / avoid .item())"
            )

    @staticmethod
    def _check_operands_concrete(op: str, *vals) -> None:
        for v in vals:
            if isinstance(v, NumberProxy):
                v._check_concrete(op)

    def __eq__(self, other):
        if isinstance(other, Proxy) and not isinstance(other, NumberProxy):
            return NotImplemented
        self._check_operands_concrete("==", self, other)
        ov = pyval(other) if isinstance(other, NumberProxy) else other
        return pyval(self) == ov

    def __ne__(self, other):
        result = self.__eq__(other)
        if result is NotImplemented:
            return result
        return not result

    def __lt__(self, other):
        self._check_operands_concrete("<", self, other)
        return pyval(self) < (pyval(other) if isinstance(other, NumberProxy) else other)

    def __le__(self, other):
        self._check_operands_concrete("<=", self, other)
        return pyval(self) <= (pyval(other) if isinstance(other, NumberProxy) else other)

    def __gt__(self, other):
        self._check_operands_concrete(">", self, other)
        return pyval(self) > (pyval(other) if isinstance(other, NumberProxy) else other)

    def __ge__(self, other):
        self._check_operands_concrete(">=", self, other)
        return pyval(self) >= (pyval(other) if isinstance(other, NumberProxy) else other)

    def __hash__(self):
        return hash(self._name)

    def __bool__(self):
        self._check_concrete("bool()")
        return bool(pyval(self))

    def __int__(self):
        self._check_concrete("int()")
        return int(pyval(self))

    def __float__(self):
        self._check_concrete("float()")
        return float(pyval(self))

    def __complex__(self):
        self._check_concrete("complex()")
        return complex(pyval(self))

    def __index__(self):
        self._check_concrete("index()")
        return int(pyval(self))


class IntegerProxy(NumberProxy):
    def __init__(self, name=None, value=None, *, history=None, constraint=None, python_type=int):
        super().__init__(name, value, python_type=python_type, history=history, constraint=constraint)


class FloatProxy(NumberProxy):
    def __init__(self, name=None, value=None, *, history=None, constraint=None):
        super().__init__(name, value, python_type=float, history=history, constraint=constraint)


class ComplexProxy(NumberProxy):
    def __init__(self, name=None, value=None, *, history=None, constraint=None):
        super().__init__(name, value, python_type=complex, history=history, constraint=constraint)


def numberproxy(python_type: Type, value: Number | None, *, name: str | None = None, history=None) -> NumberProxy:
    if python_type is bool:
        return IntegerProxy(name, value, history=history, python_type=bool)
    if python_type is int:
        return IntegerProxy(name, value, history=history)
    if python_type is float:
        return FloatProxy(name, value, history=history)
    if python_type is complex:
        return ComplexProxy(name, value, history=history)
    raise ValueError(f"Cannot create a number proxy for type {python_type}")


def pyval(x: Any):
    """Extracts the concrete Python value of a number/string proxy (or passes numbers through)."""
    if isinstance(x, NumberProxy):
        return x.value
    if isinstance(x, StringProxy):
        return x.value
    if isinstance(x, AnyProxy):
        return x.value
    if isinstance(x, (Number, str)) or x is None:
        return x
    raise ValueError(f"Cannot extract a Python value from {type(x)}")


def pytype(x: Any) -> Type:
    if isinstance(x, NumberProxy):
        return x.python_type
    if isinstance(x, StringProxy):
        return str
    if isinstance(x, Proxy):
        return type(x)
    return type(x)


#
# TensorProxy
#


def _shape_to_tuple(shape) -> tuple[int, ...]:
    out = []
    for s in shape:
        if isinstance(s, NumberProxy):
            s = int(pyval(s))
        check_type(s, (int,))
        out.append(int(s))
    return tuple(out)


class _CallableSize(int):
    """``.size`` that reads as an int (numpy numel) AND calls as a method
    (torch ``t.size()`` → shape tuple, ``t.size(dim)`` → int)."""

    def __new__(cls, value, proxy):
        obj = super().__new__(cls, value)
        obj._proxy = proxy
        return obj

    def __call__(self, dim: int | None = None):
        shape = tuple(self._proxy.shape)
        if dim is None:
            return shape
        return shape[dim]


class TensorProxy(Proxy, TensorProxyInterface):
    def __init__(
        self,
        name: str | None = None,
        *,
        shape: Sequence[int] | None = None,
        device: Device | str | None = None,
        dtype: dtypes.dtype | None = None,
        requires_grad: bool = False,
        distparallel_type: DistParallelType = DistParallelType.NONE,
        sharding: Any = None,  # the reference's PartitionSpec; None in the port
        grad: "TensorProxy | None" = None,
        history: Any = None,
        tags: set | None = None,
    ):
        super().__init__(name, history=history, tags=tags)
        check(shape is not None, lambda: "TensorProxy requires a shape")
        self._shape = _shape_to_tuple(shape)
        baseutils.check_valid_shape(self._shape)
        self._device = to_device(device)
        check(isinstance(dtype, dtypes.dtype), lambda: f"TensorProxy requires a dtype, got {dtype}")
        self._dtype = dtypes.canonicalize_dtype(dtypes.to_strong_dtype(dtype))
        self._requires_grad = requires_grad
        self._distparallel_type = distparallel_type
        self._sharding = sharding
        self._grad = grad

    def _name_prefix(self):
        return "t"

    @property
    def shape(self) -> tuple[int, ...]:
        return self._shape

    @property
    def ndim(self) -> int:
        return len(self._shape)

    @property
    def device(self) -> Device:
        return self._device

    @property
    def dtype(self) -> dtypes.dtype:
        return self._dtype

    @property
    def true_dtype(self) -> dtypes.dtype:
        return self._dtype

    @property
    def requires_grad(self) -> bool:
        return self._requires_grad

    @property
    def grad(self):
        return self._grad

    @property
    def distparallel_type(self) -> DistParallelType:
        return self._distparallel_type

    # reference-compat alias
    @property
    def ddp_type(self) -> DistParallelType:
        return self._distparallel_type

    @property
    def sharding(self):
        return self._sharding

    @property
    def numel(self) -> int:
        n = 1
        for s in self._shape:
            n *= s
        return n

    @property
    def size(self) -> int:
        # numpy reads `.size` as an int (numel); torch calls `.size()` /
        # `.size(dim)` as a method.  A callable int serves both languages, so
        # unmodified HF/torch module code traces through (torch interop).
        return _CallableSize(self.numel, self)

    def type_string(self) -> str:
        return f'{self.device.device_str()} {self.dtype.shortname()}{list(self.shape)}'

    def dim(self) -> int:
        return len(self._shape)

    def is_floating_point(self) -> bool:
        return dtypes.is_float_dtype(self._dtype)

    def replace_name(self, name: str | None = None):
        return self.replace(name=name)

    def replace(self, **changes) -> "TensorProxy":
        """Returns a copy with the given attributes replaced (name is re-registered)."""
        return TensorProxy(
            name=changes.get("name"),
            shape=changes.get("shape", self._shape),
            device=changes.get("device", self._device),
            dtype=changes.get("dtype", self._dtype),
            requires_grad=changes.get("requires_grad", self._requires_grad),
            distparallel_type=changes.get("distparallel_type", self._distparallel_type),
            sharding=changes.get("sharding", self._sharding),
            history=changes.get("history", self.history),
            tags=set(self.tags),
        )

    #
    # Method dispatch: unknown attributes resolve through the language context,
    # so tp.sum(), tp.view(...), tp.transpose(...) record symbols.
    #

    _known_attrs = None

    def __getattr__(self, attr: str):
        if attr.startswith("_"):
            raise AttributeError(f"{type(self).__name__} has no attribute {attr}")
        method = resolve_method(attr, self)
        if method is None:
            raise AttributeError(
                f"The active language context has no method {attr!r} (on TensorProxy {self.name})"
            )
        import functools

        return functools.partial(method, self)

    #
    # torch interop: torch.* functions called on proxies divert here
    #

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        # torch.* / torch.nn.functional.* / torch.Tensor calls on proxies
        # divert into the torch language (reference
        # thunder_tpu/core/proxies.py:658-685)
        kwargs = kwargs or {}
        from thunder_tpu_torch.torch import _torch_to_thunder_function_map
        from thunder_tpu_torch.torch_interop import _bake_torch_constants

        mapped = _torch_to_thunder_function_map.get(func)
        if mapped is not None:
            # real torch.Tensor operands (constants) bake into the trace
            # before dispatch
            args, kwargs = _bake_torch_constants(args, kwargs)
            return mapped(*args, **kwargs)

        # a torch.Tensor method the map lacks, or a mixed real-tensor ⊗ proxy
        # method call (`real[1:3] = proxy` dispatches here with the TensorBase
        # slot): bake the constants, then resolve it by name on the receiver
        # through the proxy's method protocol (the language)
        name = getattr(func, "__name__", "")
        args, kwargs = _bake_torch_constants(args, kwargs)
        if args and isinstance(args[0], TensorProxy) and name:
            recv_method = getattr(args[0], name, None)
            if callable(recv_method):
                return recv_method(*args[1:], **kwargs)

        raise NotImplementedError(
            f"torch function {getattr(func, '__qualname__', None) or func} is not mapped into "
            "thunder_tpu_torch; register it in thunder_tpu_torch/torch/__init__.py"
        )

    # numpy interop: real np.* calls on proxies divert into the numpy
    # language (thunder_tpu_torch/numpy), the numpy analog of
    # __torch_function__
    def __array_ufunc__(self, ufunc, method, *inputs, **kwargs):
        if method != "__call__" or kwargs.get("out") is not None:
            return NotImplemented
        from thunder_tpu_torch.numpy import _numpy_to_thunder_function_map

        mapped = _numpy_to_thunder_function_map.get(ufunc)
        if mapped is None:
            return NotImplemented
        return mapped(*inputs, **kwargs)

    def __array_function__(self, func, types, args, kwargs):
        from thunder_tpu_torch.numpy import _numpy_to_thunder_function_map

        mapped = _numpy_to_thunder_function_map.get(func)
        if mapped is None:
            raise NotImplementedError(
                f"numpy function {func.__name__} is not mapped into thunder_tpu_torch; "
                "register it in thunder_tpu_torch/numpy/__init__.py"
            )
        return mapped(*args, **(kwargs or {}))

    # Operators
    def _op(self, method_name: str, *args):
        method = resolve_method(method_name, self, *args)
        if method is None:
            raise NotImplementedError(f"No method {method_name!r} in the active language context")
        return method(self, *args)

    def _rop(self, method_name: str, other):
        method = resolve_method(method_name, other, self)
        if method is None:
            raise NotImplementedError(f"No method {method_name!r} in the active language context")
        return method(other, self)

    def __add__(self, other):
        return self._op("add", other)

    def __radd__(self, other):
        return self._rop("add", other)

    def __sub__(self, other):
        return self._op("sub", other)

    def __rsub__(self, other):
        return self._rop("sub", other)

    def __mul__(self, other):
        return self._op("mul", other)

    def __rmul__(self, other):
        return self._rop("mul", other)

    def __truediv__(self, other):
        return self._op("true_divide", other)

    def __rtruediv__(self, other):
        return self._rop("true_divide", other)

    def __floordiv__(self, other):
        return self._op("floor_divide", other)

    def __rfloordiv__(self, other):
        return self._rop("floor_divide", other)

    def __mod__(self, other):
        return self._op("remainder", other)

    def __rmod__(self, other):
        return self._rop("remainder", other)

    def __pow__(self, other):
        return self._op("pow", other)

    def __rpow__(self, other):
        return self._rop("pow", other)

    def __matmul__(self, other):
        return self._op("matmul", other)

    def __rmatmul__(self, other):
        return self._rop("matmul", other)

    def __neg__(self):
        return self._op("neg")

    def __pos__(self):
        return self

    def __abs__(self):
        return self._op("abs")

    def __eq__(self, other):
        return self._op("eq", other)

    def __ne__(self, other):
        return self._op("ne", other)

    def __lt__(self, other):
        return self._op("lt", other)

    def __le__(self, other):
        return self._op("le", other)

    def __gt__(self, other):
        return self._op("gt", other)

    def __ge__(self, other):
        return self._op("ge", other)

    def __and__(self, other):
        return self._op("bitwise_and", other)

    def __rand__(self, other):
        return self._rop("bitwise_and", other)

    def __or__(self, other):
        return self._op("bitwise_or", other)

    def __ror__(self, other):
        return self._rop("bitwise_or", other)

    def __xor__(self, other):
        return self._op("bitwise_xor", other)

    def __rxor__(self, other):
        return self._op("bitwise_xor", other)

    def __invert__(self):
        return self._op("bitwise_not")

    def __getitem__(self, key):
        method = resolve_method("getitem", self, key)
        if method is None:
            raise NotImplementedError("No getitem in the active language context")
        return method(self, key)

    def _rebind_to(self, new: "TensorProxy") -> "TensorProxy":
        """Functionalized in-place semantics: everything already recorded
        against this object is re-pointed at a same-named snapshot of the
        old value, then this Python object REBINDS to ``new`` — every later
        use reads the updated value while the history keeps the old one
        (the reference's in-place functionalization)."""
        from thunder_tpu_torch.core.trace import get_tracectx

        trace = get_tracectx()
        if trace is not None:
            import copy as _copy

            old_snapshot = _copy.copy(self)  # same name, distinct identity
            swap = {variableify(self): old_snapshot}
            # in-place on the ACTIVE recording scope (a composite's subscope
            # when one is open, else the trace's top level)
            scope = trace.peek_scope()
            scope[:] = [b.from_bsym_swap_proxies(swap) for b in scope]
        self._name = new._name
        return self

    def _inplace(self, method_name: str, *args, label: str | None = None, **kwargs) -> "TensorProxy":
        """torch's ``t.op_(...)`` contract: compute the out-of-place result
        and rebind.  In-place ops must not change the receiver's shape OR
        dtype (torch raises on promoting in-place results)."""
        label = label or f"{method_name}_"
        method = resolve_method(method_name, self, *args, **kwargs)
        if method is None:
            raise NotImplementedError(
                f"No method {method_name!r} in the active language context")
        new = method(self, *args, **kwargs)
        if tuple(new.shape) != tuple(self.shape):
            raise RuntimeError(
                f"{label}: in-place result shape {tuple(new.shape)} "
                f"differs from the receiver's {tuple(self.shape)}")
        if new.dtype != self.dtype:
            raise RuntimeError(
                f"{label}: result type {new.dtype} can't be stored in-place "
                f"into a {self.dtype} tensor (torch in-place dtype contract)")
        return self._rebind_to(new)

    # the common in-place method family (torch parity): functionalized via
    # _inplace — the variable updates, the trace stays SSA
    def add_(self, other, *, alpha=None):
        return self._inplace("add", other, alpha=alpha)

    def sub_(self, other, *, alpha=None):
        return self._inplace("sub", other, alpha=alpha)

    def mul_(self, other):
        return self._inplace("mul", other)

    def div_(self, other):
        return self._inplace("true_divide", other, label="div_")

    def pow_(self, other):
        return self._inplace("pow", other)

    def clamp_(self, min=None, max=None):
        return self._inplace("clamp", min, max)

    def clamp_min_(self, min):
        return self._inplace("clamp_min", min)

    def clamp_max_(self, max):
        return self._inplace("clamp_max", max)

    def masked_fill_(self, mask, value):
        return self._inplace("masked_fill", mask, value)

    def relu_(self):
        return self._inplace("relu")

    def neg_(self):
        return self._inplace("neg")

    def exp_(self):
        return self._inplace("exp")

    def zero_(self):
        # unconditional overwrite — a mul-by-zero formulation would turn
        # inf/NaN residents into NaN (IEEE mul(inf, 0))
        from thunder_tpu_torch import clang

        return self._rebind_to(clang.zeros_like(self))

    def fill_(self, value):
        from thunder_tpu_torch import clang

        return self._rebind_to(clang.full_like(self, value))

    def copy_(self, src):
        # value copy with broadcast into the receiver's shape; the receiver
        # contributes only its shape/dtype, never its values
        from thunder_tpu_torch import clang

        z = clang.zeros_like(self)
        new = resolve_method("add", z, src)(z, src)
        if tuple(new.shape) != tuple(self.shape):
            raise RuntimeError(
                f"copy_: source broadcasts to {tuple(new.shape)}, receiver is {tuple(self.shape)}")
        new = resolve_method("to", new, self.dtype)(new, self.dtype)
        return self._rebind_to(new)

    def __setitem__(self, key, value):
        """In-place indexed assignment under functional tracing (torch's
        ``a[k] = v`` contract): record the functional update, then REBIND
        this Python object to the result (see ``_rebind_to``)."""
        method = resolve_method("setitem", self, key, value)
        if method is None:
            raise NotImplementedError("No setitem in the active language context")
        self._rebind_to(method(self, key, value))

    def __len__(self):
        check(self.ndim > 0, lambda: "len() of a 0-d tensor")
        return self._shape[0]

    def __hash__(self):
        return hash(self._name)

    def __bool__(self):
        raise RuntimeError(
            "The truth value of a TensorProxy is data-dependent and cannot be used in Python "
            "control flow under tracing; use lax-style cond/where ops instead"
        )

    @property
    def T(self):
        method = resolve_method("t", self)
        return method(self)

    @property
    def mT(self):
        method = resolve_method("matrix_transpose", self)
        return method(self)

    @property
    def real(self):
        method = resolve_method("real", self)
        return method(self)

    def __format__(self, spec):
        return self.name.__format__(spec)


class FutureTensorProxy(TensorProxy):
    """Result of an async communication prim; ``.wait()`` materializes it."""

    def _name_prefix(self):
        return "fut"

    def wait(self) -> TensorProxy:
        from thunder_tpu_torch.distributed import prims as dist_prims

        return dist_prims.wait(self)


#
# Generic proxy construction
#


def is_proxyable(x: Any) -> bool:
    if isinstance(x, Proxy):
        return False
    return isinstance(x, (Number, str, torch.Tensor, np.ndarray))


def tensorproxy(x, *, name: str | None = None, history=None, requires_grad: bool | None = None) -> TensorProxy:
    """Creates a TensorProxy describing a concrete torch tensor or numpy array
    (the reference reads ``jax.Array`` and ``np.ndarray``, proxies.py:995-1060)."""
    if isinstance(x, torch.Tensor):
        rg = x.requires_grad if requires_grad is None else requires_grad
        return TensorProxy(
            name,
            shape=tuple(x.shape),
            device=from_torch_device(x.device),
            dtype=dtypes.from_torch_dtype(x.dtype),
            requires_grad=rg,
            history=history,
        )
    if isinstance(x, np.ndarray):
        return TensorProxy(
            name,
            shape=x.shape,
            device="cpu",
            dtype=dtypes.to_dtype(x.dtype),
            requires_grad=bool(requires_grad) if requires_grad is not None else False,
            history=history,
        )
    raise ValueError(f"Cannot create a TensorProxy from {type(x)}")


def proxy(x: Any, *, name: str | None = None, history=None) -> Any:
    """Proxies a concrete value: arrays → TensorProxy, numbers → NumberProxy, etc."""
    if isinstance(x, Proxy):
        return x
    # Device subclasses str — check it before str so devices stay AnyProxy,
    # not StringProxy of the raw "cuda:0" value
    if x is None or isinstance(x, (type, Device, dtypes.dtype)):
        return AnyProxy(x, name=name, history=history)
    if isinstance(x, str):
        return StringProxy(x, name=name, history=history)
    if isinstance(x, bool):
        return numberproxy(bool, x, name=name, history=history)
    if isinstance(x, int):
        return numberproxy(int, x, name=name, history=history)
    if isinstance(x, float):
        return numberproxy(float, x, name=name, history=history)
    if isinstance(x, complex):
        return numberproxy(complex, x, name=name, history=history)
    return tensorproxy(x, name=name, history=history)


def is_proxy_name_available(name: str) -> bool:
    trace = _get_tracectx()
    if trace is None:
        return True
    return not trace.has_name(name)
