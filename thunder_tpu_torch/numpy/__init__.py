"""NumPy language context: the second language of the port.

Counterpart of ``thunder_tpu/numpy/__init__.py``.  Ops decompose to the
same clang/prims layer the torch language uses, so numpy-flavored user code
traces into identical programs (``jit(fn, langctx="numpy")`` resolves a
proxy's methods here); ``_numpy_to_thunder_function_map`` lets real
``np.*`` calls and ufuncs on proxies divert here
(``TensorProxy.__array_function__``/``__array_ufunc__``), the numpy
analog of ``_torch_to_thunder_function_map``.
"""
from __future__ import annotations

import sys
from typing import Callable

import numpy as np

from thunder_tpu_torch import clang
from thunder_tpu_torch.core.langctxs import LanguageContext, Languages, register_langctx
from thunder_tpu_torch.core.proxies import TensorProxy
from thunder_tpu_torch.core.symbol import Symbol

_this_module = sys.modules[__name__]
__print_alias__ = "lnp"

_np_ctx = LanguageContext("numpy")
register_langctx(Languages.NUMPY, _np_ctx)

_numpy_to_thunder_function_map: dict = {}


class npsymbol:
    def __init__(self, *numpyfns, method_name: str | None = None):
        self.numpyfns = numpyfns
        self.method_name = method_name

    def __call__(self, fn: Callable) -> Symbol:
        sym = Symbol(name=fn.__name__, meta=fn, id=f"numpy.{fn.__name__}", module=_this_module)
        if self.method_name is not None:
            _np_ctx.register_method(self.method_name, sym)
        for nfn in self.numpyfns:
            if nfn is not None:
                _numpy_to_thunder_function_map[nfn] = sym
        return sym


#
# Tensor properties (methods)
#

_np_ctx.register_method("len", lambda a: a.shape[0])
_np_ctx.register_method("size", lambda a: a.numel)


#
# Elementwise unary
#

_unary = ["abs", "exp", "log", "sqrt", "sin", "cos", "tan", "tanh", "floor", "ceil", "sign", "negative"]
_unary_clang = {"negative": "neg"}

for _name in _unary:
    _cfn = getattr(clang, _unary_clang.get(_name, _name))

    def _mk(cfn):
        def meta(a):
            return cfn(a)

        return meta

    _m = _mk(_cfn)
    _m.__name__ = _name
    globals()[_name] = npsymbol(getattr(np, _name, None))(_m)

#
# Elementwise binary (with numpy broadcasting via clang)
#

_binary = [
    ("add", "add"),
    ("subtract", "sub"),
    ("multiply", "mul"),
    ("divide", "true_divide"),
    ("true_divide", "true_divide"),
    ("floor_divide", "floor_divide"),
    ("power", "pow"),
    ("maximum", "maximum"),
    ("minimum", "minimum"),
    ("greater", "gt"),
    ("greater_equal", "ge"),
    ("less", "lt"),
    ("less_equal", "le"),
    ("equal", "eq"),
    ("not_equal", "ne"),
]

for _name, _cname in _binary:
    _cfn = getattr(clang, _cname)

    def _mkb(cfn):
        def meta(a, b):
            return cfn(a, b)

        return meta

    _m = _mkb(_cfn)
    _m.__name__ = _name
    globals()[_name] = npsymbol(getattr(np, _name, None))(_m)


#
# Shape / reduction / linalg
#


@npsymbol(np.reshape, method_name="reshape")
def reshape(a: TensorProxy, shape):
    return clang.reshape(a, tuple(shape))


@npsymbol(np.transpose, method_name="transpose")
def transpose(a: TensorProxy, axes=None):
    if axes is None:
        axes = tuple(reversed(range(a.ndim)))
    return clang.permute(a, tuple(axes))


@npsymbol(np.sum, method_name="sum")
def sum(a: TensorProxy, axis=None, keepdims=False):
    return clang.sum(a, axis, keepdims)


@npsymbol(np.mean, method_name="mean")
def mean(a: TensorProxy, axis=None, keepdims=False):
    from thunder_tpu_torch.core import dtypes

    total = clang.sum(a, axis, keepdims)
    if axis is None:
        n = a.numel
    else:
        dims = (axis,) if isinstance(axis, int) else tuple(axis)
        n = 1
        for d in dims:
            n *= a.shape[d]
    return clang.true_divide(total, n)


@npsymbol(np.matmul, method_name="matmul")
def matmul(a: TensorProxy, b: TensorProxy):
    return clang.matmul(a, b)


@npsymbol(np.where)
def where(pred, a, b):
    return clang.where(pred, a, b)


@npsymbol(np.exp2)
def exp2(a):
    return clang.exp2(a)


@npsymbol(np.clip, method_name="clip")
def clip(a, a_min=None, a_max=None):
    return clang.clamp(a, a_min, a_max)
