"""Primitive operations: the closed instruction set traces bottom out in.

Counterpart of ``thunder_tpu/core/prims.py``: every prim and ``PrimIDs``
member under the same name and signature, the metas copied.  Two seams
change: the einsum meta reads shapes from torch's ``meta`` device (the
reference calls ``jax.eval_shape``), and the prologue's unpack and check
implementations take torch tensors as they come, on ``cpu`` or ``cuda:N``.
Where the reference's backend rejects an input only when its program runs
and torch would compute something else or raise another type, the meta
checks it at trace time with the reference's exception type: float indices
(``take_along_axis``, ``gather``: TypeError), shapes that do not broadcast
(``take_along_axis``, ``scatter_add``: ValueError), einsum's parser errors
and convolution channels (ValueError).

As in the reference, prims are strict (broadcast and type promotion happen
in ``thunder_tpu_torch.clang``), random prims take an explicit PRNG ``key``
tensor plus a static ``offset`` instead of global RNG state, index results
are int32, and there are no stride or contiguity prims.  The reference is
the analog of ``thunder/core/prims.py`` (~150 prims, PrimIDs :94-255, OpTags
:256, make_prim :271).
"""
from __future__ import annotations

from enum import Enum, auto
from numbers import Number
from typing import Any, Callable, Sequence

import numpy as np
import torch

from thunder_tpu_torch.core import dtypes, utils
from thunder_tpu_torch.core.baseutils import check, check_type
from thunder_tpu_torch.core.codeutils import prettyprint
from thunder_tpu_torch.core.devices import Device, to_device
from thunder_tpu_torch.core.proxies import (
    AnyProxy,
    CollectionProxy,
    NumberProxy,
    Proxy,
    TensorProxy,
    numberproxy,
    pyval,
)
from thunder_tpu_torch.core.symbol import BoundSymbol, Symbol, default_python_printer

__all__ = ["PrimIDs", "OpTags", "make_prim", "get_prim", "prim_lookup"]


class OpTags(Enum):
    ELEMENTWISE_UNARY_OP = auto()
    ELEMENTWISE_BINARY_OP = auto()
    SHAPE_OP = auto()
    REDUCTION_OP = auto()
    RANDOM_OP = auto()
    MATMUL_OP = auto()
    INDEXING_OP = auto()
    DEVICE_SYNC_OP = auto()
    COMM_OP = auto()
    DONT_DCE = auto()
    CHECK_OP = auto()
    UNPACK_OP = auto()
    CTX_MANAGER_OP = auto()
    AUTOCAST_DOWNCAST = auto()


class PrimIDs(Enum):
    # Prologue: unpack and check
    UNPACK_TRIVIAL = auto()
    UNPACK_FLATTEN = auto()
    UNPACK_GETITEM = auto()
    UNPACK_ATTR = auto()
    CHECK_TENSOR_METADATA = auto()
    CHECK_NUMBER_TYPE_AND_VALUE = auto()
    CHECK_NUMBER_TYPE = auto()
    CHECK_STRING_VALUE = auto()
    CHECK_INSTANCE = auto()
    CHECK_LEN = auto()
    CHECK_CONTAINS = auto()
    CHECK_KEYS = auto()
    CHECK_TYPE_NAME = auto()
    CHECK_LITERAL_LIKE = auto()
    CHECK_NONE = auto()
    # Utility
    DEL = auto()
    RETURN = auto()
    COMMENT = auto()
    PRINT = auto()
    PYTHON_VARS = auto()
    # Grad markers
    GET_GRAD = auto()
    PUT_GRAD = auto()
    # Data movement
    CONVERT_ELEMENT_TYPE = auto()
    DEVICE_PUT = auto()
    ITEM = auto()
    COPY_ = auto()
    SHARD = auto()
    # Tensor creation
    FULL = auto()
    IOTA = auto()
    UNIFORM = auto()
    RANDN = auto()
    RANDINT = auto()
    MULTINOMIAL = auto()
    # Shape
    BROADCAST_IN_DIM = auto()
    CAT = auto()
    FLIP = auto()
    RESHAPE = auto()
    SLICE = auto()
    SQUEEZE = auto()
    TRANSPOSE = auto()
    UNFOLD = auto()
    PAD = auto()
    # Elementwise unary
    ABS = auto()
    ACOS = auto()
    ACOSH = auto()
    ASIN = auto()
    ASINH = auto()
    ATAN = auto()
    ATANH = auto()
    BITWISE_NOT = auto()
    CEIL = auto()
    COS = auto()
    COSH = auto()
    DIGAMMA = auto()
    ERF = auto()
    ERFC = auto()
    ERFINV = auto()
    EXP = auto()
    EXP2 = auto()
    EXPM1 = auto()
    FLOOR = auto()
    ISFINITE = auto()
    ISINF = auto()
    ISNAN = auto()
    LGAMMA = auto()
    LOG = auto()
    LOG10 = auto()
    LOG1P = auto()
    LOG2 = auto()
    NEG = auto()
    RECIPROCAL = auto()
    ROUND = auto()
    RSQRT = auto()
    SIGN = auto()
    SIGNBIT = auto()
    SIN = auto()
    SINH = auto()
    SQRT = auto()
    TAN = auto()
    TANH = auto()
    TRUNC = auto()
    REAL = auto()
    IMAG = auto()
    # Elementwise binary
    ADD = auto()
    ATAN2 = auto()
    BITWISE_AND = auto()
    BITWISE_OR = auto()
    BITWISE_XOR = auto()
    SHIFT_LEFT = auto()
    SHIFT_RIGHT = auto()
    COPYSIGN = auto()
    DIV = auto()
    EQ = auto()
    FMOD = auto()
    GE = auto()
    GT = auto()
    LE = auto()
    LT = auto()
    MAXIMUM = auto()
    MINIMUM = auto()
    MUL = auto()
    NE = auto()
    NEXTAFTER = auto()
    POW = auto()
    REMAINDER = auto()
    SUB = auto()
    # Conditional
    WHERE = auto()
    CLAMP = auto()
    # Reductions
    AMAX = auto()
    AMIN = auto()
    PROD = auto()
    SUM = auto()
    VAR = auto()
    VAR_MEAN = auto()
    ARGMAX = auto()
    ARGMIN = auto()
    TOPK = auto()
    SORT = auto()
    ARGSORT = auto()
    CUMSUM = auto()
    CUMPROD = auto()
    # Scatter/gather
    INDEX_ADD = auto()
    INDEX_PUT = auto()
    SCATTER_ADD = auto()
    GATHER = auto()
    TAKE = auto()
    TAKE_ALONG_AXIS = auto()
    # Linear algebra / NN
    MATMUL = auto()
    LINEAR = auto()
    EMBEDDING = auto()
    EMBEDDING_BACKWARD = auto()
    CONVOLUTION = auto()
    ONE_HOT = auto()
    # fused attention (claimed by the cuda flash-attention executor; the
    # reference models this as executor-registered symbols, sdpaex.py:240)
    SDPA = auto()
    SDPA_BACKWARD = auto()
    # fused cross-entropy (analog of the reference's apex/triton CE executors,
    # apex_entropyex.py:15, triton_crossentropy_impl.py:18)
    CROSS_ENTROPY_FWD = auto()
    FUSED_LINEAR_CE = auto()
    FUSED_LINEAR_CE_BACKWARD = auto()
    # einsum stays one prim (one contraction call)
    # (the reference decomposes via opt_einsum, torch/__init__.py einsum)
    EINSUM = auto()
    # windowed reduction: the pooling prim (torch max_pool/avg_pool lower
    # here)
    REDUCE_WINDOW = auto()
    # spatial resize (torch nn.functional.interpolate linear modes)
    RESIZE = auto()
    # epilogue write-back of mutated input containers (reference epilogue
    # traces, jit_ext.py:1336)
    WRITE_PATH = auto()


#
# Registration
#

prim_lookup: dict[PrimIDs, Symbol] = {}

import sys

_this_module = sys.modules[__name__]


def make_prim(
    id: PrimIDs,
    name: str,
    *,
    meta: Callable,
    python_printer: Callable = default_python_printer,
    python_impl: Callable | None = None,
    tags: Sequence[OpTags] | None = None,
    _bind_postprocess: Callable | None = None,
) -> Symbol:
    sym = Symbol(
        name=name,
        meta=meta,
        id=id,
        is_prim=True,
        tags=tags,
        python_printer=python_printer,
        python_impl=python_impl,
        module=_this_module,
        _bind_postprocess=_bind_postprocess,
    )
    prim_lookup[id] = sym
    return sym


def get_prim(id: PrimIDs) -> Symbol:
    return prim_lookup[id]


# module print name used by Symbol.name_with_module via module.__name__
__print_name__ = "prims"


#
# Meta helpers
#


def _out_like(
    a: TensorProxy,
    *,
    shape: Sequence[int] | None = None,
    dtype: dtypes.dtype | None = None,
    device: Device | None = None,
    requires_grad: bool | None = None,
) -> TensorProxy:
    rg = a.requires_grad if requires_grad is None else requires_grad
    d = a.dtype if dtype is None else dtype
    if dtypes.is_exact_dtype(d):
        rg = False
    return TensorProxy(
        shape=tuple(shape if shape is not None else a.shape),
        device=device if device is not None else a.device,
        dtype=d,
        requires_grad=rg,
    )


def _check_tensor(a, name="input"):
    check_type(a, TensorProxy)


def _same_meta(*tensors: TensorProxy, name: str):
    utils.check_same_shape(*tensors, name=name)
    utils.check_same_device(*tensors, name=name)
    utils.check_same_dtype(*tensors, name=name)


#
# Elementwise prims
#


def _elementwise_unary_meta_factory(name: str, *, out_dtype: Callable | None = None, float_only: bool = False):
    def meta(a: TensorProxy) -> TensorProxy:
        _check_tensor(a, name)
        if float_only:
            check(
                dtypes.is_inexact_dtype(a.dtype),
                lambda: f"{name} requires a floating dtype, got {a.dtype}",
            )
        d = out_dtype(a.dtype) if out_dtype is not None else a.dtype
        rg = a.requires_grad and dtypes.is_inexact_dtype(d)
        return _out_like(a, dtype=d, requires_grad=rg)

    meta.__name__ = f"{name}_meta"
    return meta


def _bool_dtype(_):
    return dtypes.bool8


def _abs_dtype(d):
    if dtypes.is_complex_dtype(d):
        return dtypes.corresponding_real_dtype(d)
    return d


_unary_defs = [
    # (PrimID, name, out_dtype_fn, float_only)
    (PrimIDs.ABS, "abs", _abs_dtype, False),
    (PrimIDs.ACOS, "acos", None, True),
    (PrimIDs.ACOSH, "acosh", None, True),
    (PrimIDs.ASIN, "asin", None, True),
    (PrimIDs.ASINH, "asinh", None, True),
    (PrimIDs.ATAN, "atan", None, True),
    (PrimIDs.ATANH, "atanh", None, True),
    (PrimIDs.BITWISE_NOT, "bitwise_not", None, False),
    (PrimIDs.CEIL, "ceil", None, False),
    (PrimIDs.COS, "cos", None, True),
    (PrimIDs.COSH, "cosh", None, True),
    (PrimIDs.DIGAMMA, "digamma", None, True),
    (PrimIDs.ERF, "erf", None, True),
    (PrimIDs.ERFC, "erfc", None, True),
    (PrimIDs.ERFINV, "erfinv", None, True),
    (PrimIDs.EXP, "exp", None, True),
    (PrimIDs.EXP2, "exp2", None, True),
    (PrimIDs.EXPM1, "expm1", None, True),
    (PrimIDs.FLOOR, "floor", None, False),
    (PrimIDs.ISFINITE, "isfinite", _bool_dtype, False),
    (PrimIDs.ISINF, "isinf", _bool_dtype, False),
    (PrimIDs.ISNAN, "isnan", _bool_dtype, False),
    (PrimIDs.LGAMMA, "lgamma", None, True),
    (PrimIDs.LOG, "log", None, True),
    (PrimIDs.LOG10, "log10", None, True),
    (PrimIDs.LOG1P, "log1p", None, True),
    (PrimIDs.LOG2, "log2", None, True),
    (PrimIDs.NEG, "neg", None, False),
    (PrimIDs.RECIPROCAL, "reciprocal", None, True),
    (PrimIDs.ROUND, "round", None, False),
    (PrimIDs.RSQRT, "rsqrt", None, True),
    (PrimIDs.SIGN, "sign", None, False),
    (PrimIDs.SIGNBIT, "signbit", _bool_dtype, False),
    (PrimIDs.SIN, "sin", None, True),
    (PrimIDs.SINH, "sinh", None, True),
    (PrimIDs.SQRT, "sqrt", None, True),
    (PrimIDs.TAN, "tan", None, True),
    (PrimIDs.TANH, "tanh", None, True),
    (PrimIDs.TRUNC, "trunc", None, False),
    (PrimIDs.REAL, "real", _abs_dtype, False),
    (PrimIDs.IMAG, "imag", _abs_dtype, False),
]

for _pid, _name, _odt, _fo in _unary_defs:
    _sym = make_prim(
        _pid,
        _name,
        meta=_elementwise_unary_meta_factory(_name, out_dtype=_odt, float_only=_fo),
        tags=(OpTags.ELEMENTWISE_UNARY_OP,),
    )
    setattr(_this_module, _name, _sym)


def _elementwise_binary_meta_factory(name: str, *, out_dtype: Callable | None = None):
    def meta(a: TensorProxy, b: TensorProxy) -> TensorProxy:
        _check_tensor(a, name)
        _check_tensor(b, name)
        _same_meta(a, b, name=name)
        d = out_dtype(a.dtype) if out_dtype is not None else a.dtype
        rg = (a.requires_grad or b.requires_grad) and dtypes.is_inexact_dtype(d)
        return _out_like(a, dtype=d, requires_grad=rg)

    meta.__name__ = f"{name}_meta"
    return meta


_binary_defs = [
    (PrimIDs.ADD, "add", None),
    (PrimIDs.ATAN2, "atan2", None),
    (PrimIDs.BITWISE_AND, "bitwise_and", None),
    (PrimIDs.BITWISE_OR, "bitwise_or", None),
    (PrimIDs.BITWISE_XOR, "bitwise_xor", None),
    (PrimIDs.SHIFT_LEFT, "shift_left", None),
    (PrimIDs.SHIFT_RIGHT, "shift_right", None),
    (PrimIDs.COPYSIGN, "copysign", None),
    (PrimIDs.DIV, "div", None),
    (PrimIDs.EQ, "eq", _bool_dtype),
    (PrimIDs.FMOD, "fmod", None),
    (PrimIDs.GE, "ge", _bool_dtype),
    (PrimIDs.GT, "gt", _bool_dtype),
    (PrimIDs.LE, "le", _bool_dtype),
    (PrimIDs.LT, "lt", _bool_dtype),
    (PrimIDs.MAXIMUM, "maximum", None),
    (PrimIDs.MINIMUM, "minimum", None),
    (PrimIDs.MUL, "mul", None),
    (PrimIDs.NE, "ne", _bool_dtype),
    (PrimIDs.NEXTAFTER, "nextafter", None),
    (PrimIDs.POW, "pow", None),
    (PrimIDs.REMAINDER, "remainder", None),
    (PrimIDs.SUB, "sub", None),
]

for _pid, _name, _odt in _binary_defs:
    _sym = make_prim(
        _pid,
        _name,
        meta=_elementwise_binary_meta_factory(_name, out_dtype=_odt),
        tags=(OpTags.ELEMENTWISE_BINARY_OP,),
    )
    setattr(_this_module, _name, _sym)


def _where_meta(pred: TensorProxy, a: TensorProxy, b: TensorProxy) -> TensorProxy:
    _check_tensor(pred, "where")
    _check_tensor(a, "where")
    _check_tensor(b, "where")
    utils.check_same_shape(pred, a, b, name="where")
    utils.check_same_device(pred, a, b, name="where")
    utils.check_same_dtype(a, b, name="where")
    check(dtypes.is_boolean_dtype(pred.dtype), lambda: f"where predicate must be bool, got {pred.dtype}")
    rg = (a.requires_grad or b.requires_grad) and dtypes.is_inexact_dtype(a.dtype)
    return _out_like(a, requires_grad=rg)


where = make_prim(PrimIDs.WHERE, "where", meta=_where_meta)


def _clamp_meta(a: TensorProxy, min: TensorProxy, max: TensorProxy) -> TensorProxy:
    _same_meta(a, min, max, name="clamp")
    return _out_like(a)


clamp = make_prim(PrimIDs.CLAMP, "clamp", meta=_clamp_meta)


#
# Data movement
#


def _convert_element_type_meta(a: TensorProxy, dtype: dtypes.dtype) -> TensorProxy:
    _check_tensor(a)
    check(dtypes.is_dtype(dtype), lambda: f"convert_element_type: {dtype} is not a dtype")
    d = dtypes.resolve_dtype(dtype)
    rg = a.requires_grad and dtypes.is_inexact_dtype(d)
    return _out_like(a, dtype=d, requires_grad=rg)


convert_element_type = make_prim(PrimIDs.CONVERT_ELEMENT_TYPE, "convert_element_type", meta=_convert_element_type_meta)


def _device_put_meta(a: TensorProxy, device: Device) -> TensorProxy:
    _check_tensor(a)
    return _out_like(a, device=to_device(device))


device_put = make_prim(PrimIDs.DEVICE_PUT, "device_put", meta=_device_put_meta, tags=(OpTags.DEVICE_SYNC_OP,))


def _item_meta(a: TensorProxy):
    _check_tensor(a)
    check(a.numel == 1, lambda: f"item requires a one-element tensor, got shape {a.shape}")
    return numberproxy(dtypes.dtype_to_numbertype(a.dtype), None)


item = make_prim(PrimIDs.ITEM, "item", meta=_item_meta, tags=(OpTags.DEVICE_SYNC_OP,))


def _copy__meta(a: TensorProxy, b: TensorProxy) -> TensorProxy:
    _same_meta(a, b, name="copy_")
    return _out_like(a)


copy_ = make_prim(PrimIDs.COPY_, "copy_", meta=_copy__meta, tags=(OpTags.DONT_DCE,))


#
# Tensor creation
#


def _full_meta(shape: Sequence[int], fill_value, *, device: Device, dtype: dtypes.dtype) -> TensorProxy:
    dev = to_device(device)
    d = dtypes.resolve_dtype(dtype)
    return TensorProxy(shape=tuple(int(s) for s in shape), device=dev, dtype=d, requires_grad=False)


full = make_prim(PrimIDs.FULL, "full", meta=_full_meta)


def _iota_meta(length: int, *, start: int, step: int, device: Device, dtype: dtypes.dtype) -> TensorProxy:
    check(dtypes.is_exact_dtype(dtype) or dtypes.is_inexact_dtype(dtype), lambda: f"bad iota dtype {dtype}")
    return TensorProxy(
        shape=(int(length),),
        device=to_device(device),
        dtype=dtypes.resolve_dtype(dtype),
        requires_grad=False,
    )


iota = make_prim(PrimIDs.IOTA, "iota", meta=_iota_meta)


def _uniform_meta(shape, minval, maxval, *, device: Device, dtype: dtypes.dtype, key: TensorProxy, offset: int) -> TensorProxy:
    check(dtypes.is_float_dtype(dtype), lambda: f"uniform requires float dtype, got {dtype}")
    return TensorProxy(
        shape=tuple(int(s) for s in shape),
        device=to_device(device),
        dtype=dtypes.to_strong_dtype(dtype),
        requires_grad=False,
    )


uniform = make_prim(PrimIDs.UNIFORM, "uniform", meta=_uniform_meta, tags=(OpTags.RANDOM_OP,))


def _randn_meta(shape, *, device: Device, dtype: dtypes.dtype, key: TensorProxy, offset: int) -> TensorProxy:
    check(dtypes.is_float_dtype(dtype), lambda: f"randn requires float dtype, got {dtype}")
    return TensorProxy(
        shape=tuple(int(s) for s in shape),
        device=to_device(device),
        dtype=dtypes.to_strong_dtype(dtype),
        requires_grad=False,
    )


randn = make_prim(PrimIDs.RANDN, "randn", meta=_randn_meta, tags=(OpTags.RANDOM_OP,))


def _randint_meta(shape, low: int, high: int, *, device: Device, dtype: dtypes.dtype, key: TensorProxy, offset: int) -> TensorProxy:
    check(dtypes.is_exact_dtype(dtype), lambda: f"randint requires integer dtype, got {dtype}")
    return TensorProxy(
        shape=tuple(int(s) for s in shape),
        device=to_device(device),
        dtype=dtypes.to_strong_dtype(dtype),
        requires_grad=False,
    )


randint = make_prim(PrimIDs.RANDINT, "randint", meta=_randint_meta, tags=(OpTags.RANDOM_OP,))


def _multinomial_meta(a: TensorProxy, num_samples: int, replacement: bool, *, key: TensorProxy, offset: int) -> TensorProxy:
    _check_tensor(a)
    check(1 <= a.ndim <= 2, lambda: "multinomial requires a 1D or 2D input")
    shape = (a.shape[0], num_samples) if a.ndim == 2 else (num_samples,)
    return TensorProxy(shape=shape, device=a.device, dtype=dtypes.int32, requires_grad=False)


multinomial = make_prim(PrimIDs.MULTINOMIAL, "multinomial", meta=_multinomial_meta, tags=(OpTags.RANDOM_OP,))


#
# Shape prims
#


def _broadcast_in_dim_meta(a: TensorProxy, shape: Sequence[int], broadcast_dimensions: Sequence[int]) -> TensorProxy:
    _check_tensor(a)
    shape = tuple(int(s) for s in shape)
    bdims = tuple(int(d) for d in broadcast_dimensions)
    check(len(bdims) == a.ndim, lambda: f"broadcast_in_dim: {len(bdims)} dims for rank {a.ndim}")
    for i, d in enumerate(bdims):
        check(0 <= d < len(shape), lambda: f"broadcast_in_dim: dim {d} out of range")
        check(
            a.shape[i] == shape[d] or a.shape[i] == 1,
            lambda: f"broadcast_in_dim: cannot broadcast {a.shape} to {shape} via {bdims}",
        )
    return _out_like(a, shape=shape)


broadcast_in_dim = make_prim(
    PrimIDs.BROADCAST_IN_DIM, "broadcast_in_dim", meta=_broadcast_in_dim_meta, tags=(OpTags.SHAPE_OP,)
)


def _cat_meta(tensors: Sequence[TensorProxy], dim: int) -> TensorProxy:
    check(len(tensors) > 0, lambda: "cat expects at least one tensor")
    first = tensors[0]
    dim = utils.canonicalize_dim(first.ndim, int(dim))
    total = 0
    for t in tensors:
        _check_tensor(t)
        check(t.ndim == first.ndim, lambda: "cat: rank mismatch")
        for i in range(first.ndim):
            if i != dim:
                check(t.shape[i] == first.shape[i], lambda: f"cat: shape mismatch at dim {i}")
        total += t.shape[dim]
    shape = list(first.shape)
    shape[dim] = total
    rg = any(t.requires_grad for t in tensors)
    return _out_like(first, shape=shape, requires_grad=rg)


cat = make_prim(PrimIDs.CAT, "cat", meta=_cat_meta, tags=(OpTags.SHAPE_OP,))


def _flip_meta(a: TensorProxy, dims: Sequence[int]) -> TensorProxy:
    _check_tensor(a)
    dims = tuple(utils.canonicalize_dim(a.ndim, int(d)) for d in dims)
    utils.check_no_duplicates(dims)
    return _out_like(a)


flip = make_prim(PrimIDs.FLIP, "flip", meta=_flip_meta, tags=(OpTags.SHAPE_OP,))


def _reshape_meta(a: TensorProxy, shape: Sequence[int]) -> TensorProxy:
    _check_tensor(a)
    shape = tuple(int(s) for s in shape)
    n = 1
    for s in shape:
        n *= s
    check(n == a.numel, lambda: f"reshape: cannot reshape {a.shape} to {shape}")
    return _out_like(a, shape=shape)


reshape = make_prim(PrimIDs.RESHAPE, "reshape", meta=_reshape_meta, tags=(OpTags.SHAPE_OP,))


def _slice_meta(
    a: TensorProxy, start_indices: Sequence[int], end_indices: Sequence[int], strides: Sequence[int] | None = None
) -> TensorProxy:
    _check_tensor(a)
    check(len(start_indices) == a.ndim and len(end_indices) == a.ndim, lambda: "slice: rank mismatch")
    if strides is None:
        strides = [1] * a.ndim
    shape = []
    for s, e, st, dim in zip(start_indices, end_indices, strides, a.shape):
        s, e, st = int(s), int(e), int(st)
        check(0 <= s <= dim and s <= e <= dim and st > 0, lambda: f"slice: bad indices {s}:{e}:{st} for dim {dim}")
        shape.append((e - s + st - 1) // st)
    return _out_like(a, shape=shape)


slice_prim = make_prim(PrimIDs.SLICE, "slice_prim", meta=_slice_meta, tags=(OpTags.SHAPE_OP,))


def _squeeze_meta(a: TensorProxy, dims: Sequence[int]) -> TensorProxy:
    _check_tensor(a)
    dims = tuple(utils.canonicalize_dim(a.ndim, int(d)) for d in dims)
    utils.check_no_duplicates(dims)
    shape = []
    for i, s in enumerate(a.shape):
        if i in dims:
            check(s == 1, lambda: f"squeeze: dim {i} has size {s} != 1")
        else:
            shape.append(s)
    return _out_like(a, shape=shape)


squeeze = make_prim(PrimIDs.SQUEEZE, "squeeze", meta=_squeeze_meta, tags=(OpTags.SHAPE_OP,))


def _transpose_meta(a: TensorProxy, permutation: Sequence[int]) -> TensorProxy:
    _check_tensor(a)
    perm = tuple(utils.canonicalize_dim(a.ndim, int(d)) for d in permutation)
    utils.check_no_duplicates(perm)
    check(len(perm) == a.ndim, lambda: f"transpose: permutation {perm} for rank {a.ndim}")
    shape = tuple(a.shape[p] for p in perm)
    return _out_like(a, shape=shape)


transpose = make_prim(PrimIDs.TRANSPOSE, "transpose", meta=_transpose_meta, tags=(OpTags.SHAPE_OP,))


def _unfold_meta(a: TensorProxy, dim: int, size: int, step: int) -> TensorProxy:
    _check_tensor(a)
    dim = utils.canonicalize_dim(a.ndim, int(dim))
    size, step = int(size), int(step)
    check(size <= a.shape[dim], lambda: f"unfold: size {size} > dim size {a.shape[dim]}")
    shape = list(a.shape)
    shape[dim] = (a.shape[dim] - size) // step + 1
    shape.append(size)
    return _out_like(a, shape=shape)


unfold = make_prim(PrimIDs.UNFOLD, "unfold", meta=_unfold_meta, tags=(OpTags.SHAPE_OP,))


def _pad_meta(a: TensorProxy, padding_value, padding_config: Sequence[tuple[int, int, int]]) -> TensorProxy:
    _check_tensor(a)
    check(len(padding_config) == a.ndim, lambda: "pad: config rank mismatch")
    shape = []
    for (lo, hi, interior), s in zip(padding_config, a.shape):
        check(interior >= 0, lambda: "pad: negative interior padding")
        new = s + lo + hi + max(0, s - 1) * interior
        check(new >= 0, lambda: f"pad: negative result dim {new}")
        shape.append(new)
    return _out_like(a, shape=shape)


pad = make_prim(PrimIDs.PAD, "pad", meta=_pad_meta, tags=(OpTags.SHAPE_OP,))


#
# Reductions
#


def _reduction_meta_factory(name: str, *, out_dtype: Callable | None = None):
    def meta(a: TensorProxy, dims: Sequence[int]) -> TensorProxy:
        _check_tensor(a, name)
        dims = tuple(utils.canonicalize_dim(a.ndim, int(d)) for d in dims)
        utils.check_no_duplicates(dims)
        shape = tuple(s for i, s in enumerate(a.shape) if i not in dims)
        d = out_dtype(a.dtype) if out_dtype is not None else a.dtype
        rg = a.requires_grad and dtypes.is_inexact_dtype(d)
        return _out_like(a, shape=shape, dtype=d, requires_grad=rg)

    meta.__name__ = f"{name}_meta"
    return meta


amax = make_prim(PrimIDs.AMAX, "amax", meta=_reduction_meta_factory("amax"), tags=(OpTags.REDUCTION_OP,))
amin = make_prim(PrimIDs.AMIN, "amin", meta=_reduction_meta_factory("amin"), tags=(OpTags.REDUCTION_OP,))
prod = make_prim(PrimIDs.PROD, "prod", meta=_reduction_meta_factory("prod"), tags=(OpTags.REDUCTION_OP,))
sum_prim = make_prim(PrimIDs.SUM, "sum", meta=_reduction_meta_factory("sum"), tags=(OpTags.REDUCTION_OP,))
setattr(_this_module, "sum", sum_prim)


def _var_meta(a: TensorProxy, dims: Sequence[int], *, correction: float) -> TensorProxy:
    m = _reduction_meta_factory("var")(a, dims)
    d = m.dtype
    if dtypes.is_complex_dtype(d):
        d = dtypes.corresponding_real_dtype(d)
    return _out_like(m, dtype=d)


var = make_prim(PrimIDs.VAR, "var", meta=_var_meta, tags=(OpTags.REDUCTION_OP,))


def _var_mean_meta(a: TensorProxy, dims: Sequence[int], *, correction: float):
    v = _var_meta(a, dims, correction=correction)
    m = _reduction_meta_factory("mean")(a, dims)
    return v, m


var_mean = make_prim(PrimIDs.VAR_MEAN, "var_mean", meta=_var_mean_meta, tags=(OpTags.REDUCTION_OP,))


def _arg_reduction_meta_factory(name: str):
    def meta(a: TensorProxy, dim: int | None) -> TensorProxy:
        _check_tensor(a, name)
        if dim is None:
            shape: tuple = ()
        else:
            d = utils.canonicalize_dim(a.ndim, int(dim))
            shape = tuple(s for i, s in enumerate(a.shape) if i != d)
        # index results are int32, as in the reference (impls emit int32)
        return TensorProxy(shape=shape, device=a.device, dtype=dtypes.int32, requires_grad=False)

    return meta


argmax = make_prim(PrimIDs.ARGMAX, "argmax", meta=_arg_reduction_meta_factory("argmax"), tags=(OpTags.REDUCTION_OP,))
argmin = make_prim(PrimIDs.ARGMIN, "argmin", meta=_arg_reduction_meta_factory("argmin"), tags=(OpTags.REDUCTION_OP,))


def _topk_meta(a: TensorProxy, k: int, dim: int, largest: bool, sorted: bool):
    _check_tensor(a)
    dim = utils.canonicalize_dim(a.ndim, int(dim))
    k = int(k)
    check(0 <= k <= a.shape[dim], lambda: f"topk: k={k} out of range for dim size {a.shape[dim]}")
    shape = list(a.shape)
    shape[dim] = k
    values = _out_like(a, shape=shape)
    indices = TensorProxy(shape=tuple(shape), device=a.device, dtype=dtypes.int32, requires_grad=False)
    return values, indices


topk = make_prim(PrimIDs.TOPK, "topk", meta=_topk_meta, tags=(OpTags.REDUCTION_OP,))


def _sort_meta(a: TensorProxy, dim: int, descending: bool):
    _check_tensor(a)
    utils.canonicalize_dim(a.ndim, int(dim))
    values = _out_like(a)
    indices = TensorProxy(shape=a.shape, device=a.device, dtype=dtypes.int32, requires_grad=False)
    return values, indices


sort = make_prim(PrimIDs.SORT, "sort", meta=_sort_meta)


def _argsort_meta(a: TensorProxy, dim: int, descending: bool) -> TensorProxy:
    _check_tensor(a)
    utils.canonicalize_dim(a.ndim, int(dim))
    return TensorProxy(shape=a.shape, device=a.device, dtype=dtypes.int32, requires_grad=False)


argsort = make_prim(PrimIDs.ARGSORT, "argsort", meta=_argsort_meta)


def _cumsum_meta(a: TensorProxy, dim: int) -> TensorProxy:
    _check_tensor(a)
    utils.canonicalize_dim(a.ndim, int(dim))
    return _out_like(a)


cumsum = make_prim(PrimIDs.CUMSUM, "cumsum", meta=_cumsum_meta)


def _cumprod_meta(a: TensorProxy, dim: int) -> TensorProxy:
    _check_tensor(a)
    utils.canonicalize_dim(a.ndim, int(dim))
    return _out_like(a)


cumprod = make_prim(PrimIDs.CUMPROD, "cumprod", meta=_cumprod_meta)


#
# Scatter/gather
#


def _take_meta(a: TensorProxy, indices: TensorProxy, dim: int) -> TensorProxy:
    _check_tensor(a)
    _check_tensor(indices)
    check(dtypes.is_exact_dtype(indices.dtype), lambda: "take: indices must be integer")
    check(indices.ndim <= 1, lambda: "take: indices must be 0D or 1D")
    dim = utils.canonicalize_dim(a.ndim, int(dim))
    shape = list(a.shape)
    if indices.ndim == 1:
        shape[dim] = indices.shape[0]
    else:
        del shape[dim]
    return _out_like(a, shape=shape)


take = make_prim(PrimIDs.TAKE, "take", meta=_take_meta, tags=(OpTags.INDEXING_OP,))


def _check_integer_indices(name: str, indices: TensorProxy) -> None:
    # the reference's backend raises TypeError for float indices when its
    # program runs; torch would index by the truncated floats, so check here
    check(dtypes.is_exact_dtype(indices.dtype) and not dtypes.is_boolean_dtype(indices.dtype),
          lambda: f"{name}: indices must be of integer type, got {indices.dtype}",
          exception_type=TypeError)


def _take_along_axis_meta(a: TensorProxy, indices: TensorProxy, dim: int) -> TensorProxy:
    _check_tensor(a)
    _check_tensor(indices)
    _check_integer_indices("take_along_axis", indices)
    dim = utils.canonicalize_dim(a.ndim, int(dim))
    check(indices.ndim == a.ndim, lambda: "take_along_axis: rank mismatch")
    # off the axis, the indices' size is the output's: ``a`` may broadcast
    # (size 1) up to it, nothing else (the reference's backend raises
    # ValueError for incompatible shapes when its program runs)
    for d in range(a.ndim):
        check(d == dim or indices.shape[d] == a.shape[d] or a.shape[d] == 1,
              lambda: f"take_along_axis: Incompatible shapes for broadcasting: {tuple(a.shape)} "
                      f"and indices {tuple(indices.shape)} off axis {dim}",
              exception_type=ValueError)
    return _out_like(a, shape=indices.shape)


take_along_axis = make_prim(
    PrimIDs.TAKE_ALONG_AXIS, "take_along_axis", meta=_take_along_axis_meta, tags=(OpTags.INDEXING_OP,)
)


def _gather_meta(a: TensorProxy, indices: TensorProxy, dim: int) -> TensorProxy:
    _check_tensor(a)
    _check_tensor(indices)
    _check_integer_indices("gather", indices)
    check(indices.ndim == a.ndim, lambda: "gather: rank mismatch")
    return _out_like(a, shape=indices.shape)


gather = make_prim(PrimIDs.GATHER, "gather", meta=_gather_meta, tags=(OpTags.INDEXING_OP,))


def _index_add_meta(a: TensorProxy, indices: TensorProxy, value: TensorProxy, dim: int) -> TensorProxy:
    _check_tensor(a)
    _check_tensor(indices)
    _check_tensor(value)
    utils.canonicalize_dim(a.ndim, int(dim))
    return _out_like(a)


index_add = make_prim(PrimIDs.INDEX_ADD, "index_add", meta=_index_add_meta, tags=(OpTags.INDEXING_OP,))


def _index_put_meta(a: TensorProxy, indices: Sequence[TensorProxy], values: TensorProxy, accumulate: bool) -> TensorProxy:
    _check_tensor(a)
    _check_tensor(values)
    return _out_like(a)


index_put = make_prim(PrimIDs.INDEX_PUT, "index_put", meta=_index_put_meta, tags=(OpTags.INDEXING_OP,))


def _scatter_add_meta(a: TensorProxy, indices: TensorProxy, value: TensorProxy, dim: int) -> TensorProxy:
    _check_tensor(a)
    _check_tensor(indices)
    _check_tensor(value)
    utils.canonicalize_dim(a.ndim, int(dim))
    # the values broadcast to the indices' shape (the reference's backend
    # raises ValueError for incompatible shapes when its program runs)
    vs, ix = tuple(value.shape), tuple(indices.shape)
    check(len(vs) <= len(ix) and all(v in (1, i) for v, i in zip(vs[::-1], ix[::-1])),
          lambda: f"scatter_add: Incompatible shapes for broadcasting: values {vs} and "
                  f"requested shape {ix}", exception_type=ValueError)
    return _out_like(a)


scatter_add = make_prim(PrimIDs.SCATTER_ADD, "scatter_add", meta=_scatter_add_meta, tags=(OpTags.INDEXING_OP,))


#
# Linear algebra / NN
#


def _matmul_meta(a: TensorProxy, b: TensorProxy) -> TensorProxy:
    _check_tensor(a)
    _check_tensor(b)
    utils.check_same_device(a, b, name="matmul")
    utils.check_same_dtype(a, b, name="matmul")
    check(a.ndim >= 1 and b.ndim >= 1, lambda: "matmul: inputs must have rank >= 1")
    if a.ndim == 1 and b.ndim == 1:
        check(a.shape[0] == b.shape[0], lambda: f"matmul: {a.shape} x {b.shape}")
        shape: tuple = ()
    elif a.ndim == 1:
        check(b.shape[-2] == a.shape[0], lambda: f"matmul: {a.shape} x {b.shape}")
        shape = b.shape[:-2] + (b.shape[-1],)
    elif b.ndim == 1:
        check(a.shape[-1] == b.shape[0], lambda: f"matmul: {a.shape} x {b.shape}")
        shape = a.shape[:-1]
    else:
        check(a.shape[-1] == b.shape[-2], lambda: f"matmul: {a.shape} x {b.shape}")
        batch = _broadcast_shapes(a.shape[:-2], b.shape[:-2])
        shape = batch + (a.shape[-2], b.shape[-1])
    rg = (a.requires_grad or b.requires_grad) and dtypes.is_inexact_dtype(a.dtype)
    return _out_like(a, shape=shape, requires_grad=rg)


def _broadcast_shapes(sa: tuple, sb: tuple) -> tuple:
    out = []
    la, lb = len(sa), len(sb)
    for i in range(max(la, lb)):
        da = sa[la - 1 - i] if i < la else 1
        db = sb[lb - 1 - i] if i < lb else 1
        check(da == db or da == 1 or db == 1, lambda: f"Cannot broadcast {sa} with {sb}")
        out.append(max(da, db))
    return tuple(reversed(out))


matmul = make_prim(PrimIDs.MATMUL, "matmul", meta=_matmul_meta, tags=(OpTags.MATMUL_OP,))


def _linear_meta(a: TensorProxy, w: TensorProxy, bias: TensorProxy | None) -> TensorProxy:
    _check_tensor(a)
    _check_tensor(w)
    check(w.ndim == 2, lambda: f"linear: weight must be 2D, got {w.ndim}D")
    check(a.shape[-1] == w.shape[1], lambda: f"linear: {a.shape} x {w.shape}^T")
    if bias is not None:
        _check_tensor(bias)
        check(bias.shape == (w.shape[0],), lambda: f"linear: bias shape {bias.shape} != ({w.shape[0]},)")
    shape = a.shape[:-1] + (w.shape[0],)
    rg = a.requires_grad or w.requires_grad or (bias is not None and bias.requires_grad)
    return _out_like(a, shape=shape, requires_grad=rg and dtypes.is_inexact_dtype(a.dtype))


linear = make_prim(PrimIDs.LINEAR, "linear", meta=_linear_meta, tags=(OpTags.MATMUL_OP,))


def _embedding_meta(indices: TensorProxy, weight: TensorProxy, *, padding_idx: int | None = None) -> TensorProxy:
    _check_tensor(indices)
    _check_tensor(weight)
    check(dtypes.is_exact_dtype(indices.dtype), lambda: "embedding: indices must be integer")
    check(weight.ndim == 2, lambda: "embedding: weight must be 2D")
    shape = indices.shape + (weight.shape[1],)
    return TensorProxy(
        shape=shape, device=weight.device, dtype=weight.dtype, requires_grad=weight.requires_grad
    )


embedding = make_prim(PrimIDs.EMBEDDING, "embedding", meta=_embedding_meta)


def _embedding_backward_meta(
    grad: TensorProxy, indices: TensorProxy, num_weights: int, padding_idx: int | None
) -> TensorProxy:
    _check_tensor(grad)
    _check_tensor(indices)
    return TensorProxy(
        shape=(int(num_weights), grad.shape[-1]), device=grad.device, dtype=grad.dtype, requires_grad=False
    )


embedding_backward = make_prim(PrimIDs.EMBEDDING_BACKWARD, "embedding_backward", meta=_embedding_backward_meta)


def _one_hot_meta(indices: TensorProxy, num_classes: int) -> TensorProxy:
    _check_tensor(indices)
    check(dtypes.is_exact_dtype(indices.dtype), lambda: "one_hot: indices must be integer")
    return TensorProxy(
        shape=indices.shape + (int(num_classes),), device=indices.device, dtype=dtypes.int32, requires_grad=False
    )


one_hot = make_prim(PrimIDs.ONE_HOT, "one_hot", meta=_one_hot_meta)


def _convolution_meta(
    a: TensorProxy,
    weight: TensorProxy,
    bias: TensorProxy | None,
    stride: Sequence[int],
    padding: Sequence[int],
    dilation: Sequence[int],
    transposed: bool,
    output_padding: Sequence[int],
    groups: int,
) -> TensorProxy:
    _check_tensor(a)
    _check_tensor(weight)
    check(not transposed, lambda: "transposed convolution is not supported yet")
    ndim = a.ndim - 2  # spatial dims
    check(weight.ndim == a.ndim, lambda: "convolution: weight rank mismatch")
    # the reference's backend raises ValueError here when its program runs
    check(a.shape[1] % groups == 0 and a.shape[1] // groups == weight.shape[1],
          lambda: f"convolution: lhs feature dimension size divided by feature_group_count must "
                  f"equal the rhs input feature dimension size, but {a.shape[1]} // {groups} != "
                  f"{weight.shape[1]}", exception_type=ValueError)
    out_channels = weight.shape[0]
    spatial = []
    for i in range(ndim):
        inp = a.shape[2 + i] + 2 * padding[i]
        k = dilation[i] * (weight.shape[2 + i] - 1) + 1
        spatial.append((inp - k) // stride[i] + 1)
    shape = (a.shape[0], out_channels, *spatial)
    rg = a.requires_grad or weight.requires_grad or (bias is not None and bias.requires_grad)
    return _out_like(a, shape=shape, requires_grad=rg)


convolution = make_prim(PrimIDs.CONVOLUTION, "convolution", meta=_convolution_meta, tags=(OpTags.MATMUL_OP,))


def _sdpa_check_gqa(q: TensorProxy, k: TensorProxy, v: TensorProxy) -> None:
    """Batch-dim validation shared by the SDPA metas.

    Equal batch dims is plain MHA.  Grouped-query attention (the memory
    layout of Llama-2-70B/Llama-3/Mixtral: fewer KV heads than Q heads) is
    expressed natively — q ``(..., H, Tq, hs)`` with k/v ``(..., G, Tk, hs)``,
    ``H % G == 0`` — so executors index KV groups directly instead of the
    model pre-expanding K/V to H heads (the reference leans on aten's
    ``enable_gqa``, sdpaex.py:240; pre-expansion costs H/G× KV bandwidth).
    """
    if q.shape[:-2] == k.shape[:-2]:
        return
    check(q.ndim >= 3, lambda: "sdpa GQA: need an explicit head dim (rank >= 3)")
    check(
        q.shape[:-3] == k.shape[:-3],
        lambda: f"sdpa: leading batch dims must match, got {q.shape} vs {k.shape}",
    )
    H, G = q.shape[-3], k.shape[-3]
    check(G > 0 and H % G == 0, lambda: f"sdpa GQA: n_head {H} not a multiple of kv groups {G}")


def _sdpa_check_mask(mask: TensorProxy | None, q: TensorProxy, k: TensorProxy) -> None:
    """``mask`` is an additive float bias broadcastable (right-aligned) to
    ``q.shape[:-2] + (Tq, Tk)`` — boolean masks are canonicalized to additive
    form at the torch layer (torch/__init__.py scaled_dot_product_attention)."""
    if mask is None:
        return
    _check_tensor(mask)
    check(dtypes.is_float_dtype(mask.dtype), lambda: f"sdpa: mask must be additive float, got {mask.dtype}")
    target = q.shape[:-2] + (q.shape[-2], k.shape[-2])
    check(mask.ndim <= len(target), lambda: f"sdpa: mask rank {mask.ndim} > operand rank {len(target)}")
    for md, td in zip(reversed(mask.shape), reversed(target)):
        check(md == 1 or md == td, lambda: f"sdpa: mask shape {mask.shape} not broadcastable to {target}")


def _sdpa_check_window(window, causal: bool) -> None:
    """``window`` (sliding-window attention, Mistral-style) restricts query i
    to keys in (i-window, i].  Causal-only: a two-sided band has no torch
    analog and the kernels' block skipping assumes the causal diagonal."""
    if window is None:
        return
    check(causal, lambda: "sdpa: sliding_window requires is_causal=True")
    check(int(window) > 0, lambda: f"sdpa: sliding_window must be positive, got {window}")


def _sdpa_meta(
    q: TensorProxy, k: TensorProxy, v: TensorProxy, mask: TensorProxy | None, causal: bool, scale: float,
    window: int | None = None,
) -> tuple[TensorProxy, TensorProxy]:
    """Fused scaled-dot-product attention over (..., T, hs) q/k/v.

    Returns ``(out, lse)`` where ``lse`` is the float32 log-sum-exp of the
    scaled scores per query row — the residual a flash-attention backward
    needs instead of the (T, T) probability matrix (the memory property the
    reference gets from aten/cudnn flash kernels, sdpaex.py:240).

    ``mask`` (optional) is an additive float bias applied to the scaled
    scores; grouped-query K/V (fewer heads than q) is accepted natively —
    see ``_sdpa_check_gqa``/``_sdpa_check_mask``.
    """
    for t in (q, k, v):
        _check_tensor(t)
    utils.check_same_device(q, k, v, name="sdpa")
    utils.check_same_dtype(q, k, v, name="sdpa")
    check(q.ndim >= 2, lambda: f"sdpa: rank must be >= 2, got {q.ndim}")
    check(q.ndim == k.ndim == v.ndim, lambda: f"sdpa: rank mismatch {q.ndim}/{k.ndim}/{v.ndim}")
    check(q.shape[-1] == k.shape[-1], lambda: f"sdpa: q/k head dims {q.shape[-1]} != {k.shape[-1]}")
    check(k.shape[-2] == v.shape[-2], lambda: f"sdpa: k/v lengths {k.shape[-2]} != {v.shape[-2]}")
    check(k.shape[:-2] == v.shape[:-2], lambda: "sdpa: k/v batch dims must match")
    _sdpa_check_gqa(q, k, v)
    _sdpa_check_mask(mask, q, k)
    _sdpa_check_window(window, causal)
    rg = (q.requires_grad or k.requires_grad or v.requires_grad) and dtypes.is_inexact_dtype(q.dtype)
    out = _out_like(q, shape=q.shape[:-1] + (v.shape[-1],), requires_grad=rg)
    lse = TensorProxy(shape=q.shape[:-1], device=q.device, dtype=dtypes.float32, requires_grad=False)
    return out, lse


sdpa = make_prim(PrimIDs.SDPA, "sdpa", meta=_sdpa_meta, tags=(OpTags.MATMUL_OP,))


def _sdpa_backward_meta(
    g: TensorProxy,
    q: TensorProxy,
    k: TensorProxy,
    v: TensorProxy,
    out: TensorProxy,
    lse: TensorProxy,
    mask: TensorProxy | None,
    causal: bool,
    scale: float,
    window: int | None = None,
) -> tuple[TensorProxy, TensorProxy, TensorProxy]:
    for t in (g, q, k, v, out, lse):
        _check_tensor(t)
    _sdpa_check_gqa(q, k, v)
    _sdpa_check_mask(mask, q, k)
    _sdpa_check_window(window, causal)
    dq = _out_like(q, requires_grad=False)
    dk = _out_like(k, requires_grad=False)
    dv = _out_like(v, requires_grad=False)
    return dq, dk, dv


sdpa_backward = make_prim(
    PrimIDs.SDPA_BACKWARD, "sdpa_backward", meta=_sdpa_backward_meta, tags=(OpTags.MATMUL_OP,)
)


def _cross_entropy_fwd_meta(logits: TensorProxy, target: TensorProxy) -> tuple[TensorProxy, TensorProxy]:
    """Fused row-wise cross-entropy over (N, C) logits and (N,) class targets.

    Returns ``(losses, lse)``, both float32 (N,).  The backward recomputes the
    softmax from ``(logits, lse)`` so the (N, C) log-probability matrix is
    never saved — the memory property the reference buys with its apex/triton
    kernels (apex_entropyex.py:15).
    """
    _check_tensor(logits)
    _check_tensor(target)
    check(logits.ndim == 2, lambda: f"cross_entropy_fwd: logits must be 2D, got {logits.ndim}D")
    check(target.ndim == 1, lambda: f"cross_entropy_fwd: target must be 1D, got {target.ndim}D")
    check(logits.shape[0] == target.shape[0], lambda: f"cross_entropy_fwd: {logits.shape} vs {target.shape}")
    check(dtypes.is_exact_dtype(target.dtype), lambda: "cross_entropy_fwd: target must be integer")
    rg = logits.requires_grad
    losses = TensorProxy(shape=(logits.shape[0],), device=logits.device, dtype=dtypes.float32, requires_grad=rg)
    lse = TensorProxy(shape=(logits.shape[0],), device=logits.device, dtype=dtypes.float32, requires_grad=False)
    return losses, lse


cross_entropy_fwd = make_prim(
    PrimIDs.CROSS_ENTROPY_FWD, "cross_entropy_fwd", meta=_cross_entropy_fwd_meta, tags=(OpTags.REDUCTION_OP,)
)


def _fused_linear_ce_meta(
    h: TensorProxy, w: TensorProxy, target: TensorProxy, ignore_index: int = -100
) -> tuple[TensorProxy, TensorProxy]:
    """Fused lm-head linear + row-wise cross-entropy: ``h (N, C) @ w (V, C)^T``
    consumed by an online-logsumexp CE without ever materializing the
    ``(N, V)`` logits (executors chunk the vocab dim).  Returns
    ``(losses, lse)``, float32 ``(N,)``; ignored rows produce zero loss.

    The memory property goes beyond the reference's apex/triton CE
    (apex_entropyex.py:15, which takes materialized logits): saved residuals
    are ``(h, w, target, lse)`` — O(N·C + V·C) — instead of the O(N·V)
    logits, the Liger-kernel-class fused_linear_cross_entropy capability.
    """
    for t in (h, w):
        _check_tensor(t)
    _check_tensor(target)
    check(h.ndim == 2, lambda: f"fused_linear_ce: h must be 2D, got {h.ndim}D")
    check(w.ndim == 2, lambda: f"fused_linear_ce: w must be 2D, got {w.ndim}D")
    check(h.shape[1] == w.shape[1], lambda: f"fused_linear_ce: {h.shape} vs {w.shape}")
    check(target.ndim == 1 and target.shape[0] == h.shape[0],
          lambda: f"fused_linear_ce: target {target.shape} vs h {h.shape}")
    check(dtypes.is_exact_dtype(target.dtype), lambda: "fused_linear_ce: target must be integer")
    rg = (h.requires_grad or w.requires_grad) and dtypes.is_inexact_dtype(h.dtype)
    losses = TensorProxy(shape=(h.shape[0],), device=h.device, dtype=dtypes.float32, requires_grad=rg)
    lse = TensorProxy(shape=(h.shape[0],), device=h.device, dtype=dtypes.float32, requires_grad=False)
    return losses, lse


fused_linear_ce = make_prim(
    PrimIDs.FUSED_LINEAR_CE, "fused_linear_ce", meta=_fused_linear_ce_meta,
    tags=(OpTags.MATMUL_OP, OpTags.REDUCTION_OP),
)


def _fused_linear_ce_backward_meta(
    g: TensorProxy, h: TensorProxy, w: TensorProxy, target: TensorProxy, lse: TensorProxy,
    ignore_index: int = -100,
) -> tuple[TensorProxy, TensorProxy]:
    for t in (g, h, w, lse):
        _check_tensor(t)
    _check_tensor(target)
    dh = _out_like(h, requires_grad=False)
    dw = _out_like(w, requires_grad=False)
    return dh, dw


fused_linear_ce_backward = make_prim(
    PrimIDs.FUSED_LINEAR_CE_BACKWARD, "fused_linear_ce_backward",
    meta=_fused_linear_ce_backward_meta, tags=(OpTags.MATMUL_OP,),
)


def _einsum_meta(spec: str, *operands: TensorProxy) -> TensorProxy:
    """Einstein summation (reference: ``thunder/torch/__init__.py`` einsum via
    opt_einsum), kept as one prim as in ``thunder_tpu``.  The reference reads
    the shape and dtype from ``jax.eval_shape``; the port runs ``torch.einsum``
    on tensors of the ``meta`` device (shapes only, no compute), with the
    dtype promoted on the port's lattice."""
    import torch

    check(isinstance(spec, str), lambda: f"einsum spec must be a string, got {type(spec)}")
    check(len(operands) > 0, lambda: "einsum needs at least one operand")
    for o in operands:
        _check_tensor(o)
    utils.check_same_device(*operands, name="einsum")
    out_dtype = operands[0].dtype
    for o in operands[1:]:
        out_dtype = utils._promote_dtypes(out_dtype, o.dtype)
    metas = [torch.empty(tuple(o.shape), dtype=dtypes.to_torch_dtype(out_dtype), device="meta")
             for o in operands]
    try:
        out = torch.einsum(spec, *metas)
    except RuntimeError as e:
        # the reference's shape function (opt_einsum's parser) raises ValueError
        raise ValueError(str(e)) from None
    rg = any(o.requires_grad for o in operands) and dtypes.is_inexact_dtype(operands[0].dtype)
    return TensorProxy(
        shape=tuple(out.shape),
        device=operands[0].device,
        dtype=out_dtype,
        requires_grad=rg,
    )


einsum = make_prim(PrimIDs.EINSUM, "einsum", meta=_einsum_meta, tags=(OpTags.MATMUL_OP,))


def _reduce_window_meta(
    a: TensorProxy,
    kind: str,
    window: Sequence[int],
    strides: Sequence[int],
    padding: Sequence[tuple[int, int]],
) -> TensorProxy:
    """Windowed reduction over the trailing ``len(window)`` dims of ``a``
    (XLA ReduceWindow; the pooling building block — reference pools live in
    ``thunder/torch/__init__.py`` max_pool/avg_pool)."""
    _check_tensor(a)
    check(kind in ("max", "add"), lambda: f"reduce_window: unknown kind {kind!r}")
    n = len(window)
    check(n <= a.ndim, lambda: f"reduce_window: window rank {n} exceeds input rank {a.ndim}")
    check(len(strides) == n and len(padding) == n, lambda: "reduce_window: window/strides/padding rank mismatch")
    lead = a.shape[: a.ndim - n]
    spatial = []
    for i in range(n):
        size = a.shape[a.ndim - n + i] + padding[i][0] + padding[i][1]
        check(size >= window[i], lambda: f"reduce_window: window {window[i]} larger than padded dim {size}")
        spatial.append((size - window[i]) // strides[i] + 1)
    return _out_like(a, shape=tuple(lead) + tuple(spatial))


reduce_window = make_prim(PrimIDs.REDUCE_WINDOW, "reduce_window", meta=_reduce_window_meta, tags=(OpTags.REDUCTION_OP,))


def _resize_meta(a: TensorProxy, shape: Sequence[int], method: str) -> TensorProxy:
    """Spatial resize to ``shape`` (jax.image.resize semantics, half-pixel
    centers — matches torch interpolate align_corners=False)."""
    _check_tensor(a)
    check(len(shape) == a.ndim, lambda: f"resize: shape rank {len(shape)} != input rank {a.ndim}")
    check(method in ("nearest", "linear", "bilinear", "trilinear", "cubic", "bicubic"), lambda: f"resize: unknown method {method!r}")
    check(dtypes.is_inexact_dtype(a.dtype), lambda: "resize requires a floating-point input")
    return _out_like(a, shape=tuple(shape))


resize = make_prim(PrimIDs.RESIZE, "resize", meta=_resize_meta)


#
# Utility prims
#


def _del_printer(bsym, out_printables, arg_printables, kwarg_printables):
    names = ", ".join(prettyprint(a) for a in arg_printables)
    return f"del {names}"


def _del_meta(*args):
    return None


python_del = make_prim(
    PrimIDs.DEL,
    "python_del",
    meta=_del_meta,
    python_printer=_del_printer,
    python_impl=lambda *args: None,
)


def _return_printer(bsym, out_printables, arg_printables, kwarg_printables):
    if len(arg_printables) == 1:
        return f"return {prettyprint(arg_printables[0])}"
    return f"return ({', '.join(prettyprint(a) for a in arg_printables)})"


def _return_meta(*args):
    return None


python_return = make_prim(
    PrimIDs.RETURN,
    "python_return",
    meta=_return_meta,
    python_printer=_return_printer,
    tags=(OpTags.DONT_DCE,),
)


def _comment_printer(bsym, out_printables, arg_printables, kwarg_printables):
    (s,) = arg_printables
    return f"# {pyval(s) if isinstance(s, Proxy) else s}"


comment = make_prim(
    PrimIDs.COMMENT,
    "comment",
    meta=lambda s: None,
    python_printer=_comment_printer,
    python_impl=lambda s: None,
    tags=(OpTags.DONT_DCE,),
)


def _print_impl(s):
    print(s)


python_print = make_prim(
    PrimIDs.PRINT,
    "python_print",
    meta=lambda s: None,
    python_impl=_print_impl,
    tags=(OpTags.DONT_DCE,),
)


#
# Grad markers (used by the grad transform; reference prims GET_GRAD/PUT_GRAD)
#


def _get_grad_meta(a: TensorProxy) -> TensorProxy:
    _check_tensor(a)
    return _out_like(a, requires_grad=False)


get_grad = make_prim(PrimIDs.GET_GRAD, "get_grad", meta=_get_grad_meta)


def _put_grad_meta(a: TensorProxy, grad: TensorProxy):
    return None


put_grad = make_prim(PrimIDs.PUT_GRAD, "put_grad", meta=_put_grad_meta, tags=(OpTags.DONT_DCE,))


#
# Prologue prims: unpacking and checking inputs.
#
# These have python_impls because prologues execute as plain Python over the
# real (tensor / number) inputs — they are the cache guards.
#


def _unpack_trivial_printer(bsym, out_printables, arg_printables, kwarg_printables):
    name = bsym.kwargs.get("name", None)
    return f"# {prettyprint(out_printables)} (unpacked from signature)"


def _unpack_trivial_meta(x: Any = None, *, name: str | None = None):
    return x


unpack_trivial = make_prim(
    PrimIDs.UNPACK_TRIVIAL,
    "unpack_trivial",
    meta=_unpack_trivial_meta,
    python_printer=_unpack_trivial_printer,
    python_impl=lambda x=None, *, name=None: x,
    tags=(OpTags.UNPACK_OP, OpTags.DONT_DCE),
)


def _unpack_flatten_impl(args, kwargs, spec):
    from thunder_tpu_torch.core.pytree import tree_flatten

    flat, actual_spec = tree_flatten((tuple(args), dict(kwargs)))
    if actual_spec != spec:
        raise RuntimeError(
            f"Input structure changed: expected {spec}, got {actual_spec}; recompiling"
        )
    return flat


def _unpack_flatten_meta(args, kwargs, spec):
    # the frontend binds this manually with pre-made proxies as output
    return None


unpack_flatten = make_prim(
    PrimIDs.UNPACK_FLATTEN,
    "unpack_flatten",
    meta=_unpack_flatten_meta,
    python_impl=_unpack_flatten_impl,
    tags=(OpTags.UNPACK_OP, OpTags.DONT_DCE),
)


def _to_torch_boundary(x):
    """numpy arrays cross into torch here, sharing memory when they can (the
    reference's ``_to_jax_boundary``): the prologue checks, and the program
    computes on, torch tensors.  Anything else passes through."""
    if isinstance(x, np.ndarray):
        try:
            return torch.from_numpy(x if x.flags.writeable else x.copy())
        except ValueError:  # negative strides
            return torch.from_numpy(x.copy())
        except TypeError:  # a dtype torch has not
            return x
    return x


def _unpack_getitem_impl(coll, key):
    return _to_torch_boundary(coll[key])


unpack_getitem = make_prim(
    PrimIDs.UNPACK_GETITEM,
    "unpack_getitem",
    meta=lambda coll, key: None,
    python_impl=_unpack_getitem_impl,
    tags=(OpTags.UNPACK_OP, OpTags.DONT_DCE),
)


def _unpack_attr_impl(obj, name):
    return _to_torch_boundary(getattr(obj, name))


unpack_attr = make_prim(
    PrimIDs.UNPACK_ATTR,
    "unpack_attr",
    meta=lambda obj, name: None,
    python_impl=_unpack_attr_impl,
    tags=(OpTags.UNPACK_OP, OpTags.DONT_DCE),
)


def _write_path_impl(root_args, root_kwargs, path, value):
    """Epilogue write-back: navigates the caller's real argument containers by
    ``path`` and assigns ``value`` (reference jit_ext.py:1336 — recorded
    setattr/setitem mutations execute in the epilogue trace)."""
    obj = (root_args, root_kwargs)
    for k in path[:-1]:
        obj = obj[k]
    last = path[-1]
    try:
        obj[last] = value
    except TypeError as e:
        raise RuntimeError(
            f"epilogue cannot write back through an immutable container at {path!r}: {e}"
        ) from None
    return None


write_path = make_prim(
    PrimIDs.WRITE_PATH,
    "write_path",
    meta=lambda root_args, root_kwargs, path, value: None,
    python_impl=_write_path_impl,
    tags=(OpTags.DONT_DCE,),
)


# prologue-guard hot path: dtype-name and device-string lookups are cached
# (a str() of a dtype or device per tensor per call is the dominant prologue
# cost on small programs)
_dtype_str_cache: dict = {}
_device_str_cache: dict = {}


def _dtype_name(dtype) -> str:
    s = _dtype_str_cache.get(dtype)
    if s is None:
        import numpy as np

        s = str(dtype).removeprefix("torch.") if isinstance(dtype, torch.dtype) else str(np.dtype(dtype))
        _dtype_str_cache[dtype] = s
    return s


def _device_str(dev) -> str:
    s = _device_str_cache.get(dev)
    if s is None:
        if dev.type == "cuda":
            s = f"cuda:{dev.index if dev.index is not None else torch.cuda.current_device()}"
        else:
            s = f"{dev.type}:{dev.index or 0}"
        _device_str_cache[dev] = s
    return s


def _check_tensor_metadata_impl(t, shape: tuple, device: str, dtype_str: str, requires_grad: bool):
    """The prologue's tensor guard.  Torch tensors are taken as they come (the
    reference moves them into JAX first); numpy arrays live on ``cpu:0``."""
    import numpy as np

    actual_rg = None  # only torch tensors carry requires_grad; None skips the check
    if isinstance(t, torch.Tensor):
        actual_shape = tuple(t.shape)
        actual_dtype = _dtype_name(t.dtype)
        actual_device = _device_str(t.device)
        actual_rg = bool(t.requires_grad)
    elif isinstance(t, np.ndarray):
        actual_shape = tuple(t.shape)
        actual_dtype = _dtype_name(t.dtype)
        actual_device = "cpu:0"
    else:
        raise TypeError(f"Expected a tensor, got {type(t)}")
    if actual_shape != tuple(shape):
        raise RuntimeError(f"Tensor shape changed: expected {tuple(shape)}, got {actual_shape}")
    if actual_dtype != dtype_str:
        raise RuntimeError(f"Tensor dtype changed: expected {dtype_str}, got {actual_dtype}")
    if actual_device != device:
        raise RuntimeError(f"Tensor device changed: expected {device}, got {actual_device}")
    if actual_rg is not None and actual_rg != bool(requires_grad):
        raise RuntimeError(f"Tensor requires_grad changed: expected {requires_grad}, got {actual_rg}")
    return None


check_tensor_metadata = make_prim(
    PrimIDs.CHECK_TENSOR_METADATA,
    "check_tensor_metadata",
    meta=lambda t, shape, device, dtype_str, requires_grad: None,
    python_impl=_check_tensor_metadata_impl,
    tags=(OpTags.CHECK_OP, OpTags.DONT_DCE),
)


def _check_number_type_and_value_impl(n, value):
    if type(n) is not type(value) or n != value:
        raise RuntimeError(f"Number input changed: expected {value!r} ({type(value)}), got {n!r} ({type(n)})")
    return None


check_number_type_and_value = make_prim(
    PrimIDs.CHECK_NUMBER_TYPE_AND_VALUE,
    "check_number_type_and_value",
    meta=lambda n, value: None,
    python_impl=_check_number_type_and_value_impl,
    tags=(OpTags.CHECK_OP, OpTags.DONT_DCE),
)


def _check_number_type_impl(n, type_name):
    # symbolic-values caching: the guard pins only the CANONICAL type — any
    # value of the same kind (incl. subclasses like np.float64/IntEnum)
    # reuses the compiled entry (the number enters as a runtime scalar)
    if isinstance(n, bool):
        canonical = "bool"
    elif isinstance(n, int):
        canonical = "int"
    elif isinstance(n, float):
        canonical = "float"
    else:
        canonical = type(n).__name__
    if canonical != type_name:
        raise RuntimeError(f"Number input type changed: expected {type_name}, got {canonical}")
    return None


check_number_type = make_prim(
    PrimIDs.CHECK_NUMBER_TYPE,
    "check_number_type",
    meta=lambda n, type_name: None,
    python_impl=_check_number_type_impl,
    tags=(OpTags.CHECK_OP, OpTags.DONT_DCE),
)


def _check_string_value_impl(s, value):
    if s != value:
        raise RuntimeError(f"String input changed: expected {value!r}, got {s!r}")
    return None


check_string_value = make_prim(
    PrimIDs.CHECK_STRING_VALUE,
    "check_string_value",
    meta=lambda s, value: None,
    python_impl=_check_string_value_impl,
    tags=(OpTags.CHECK_OP, OpTags.DONT_DCE),
)


def _check_instance_impl(x, types):
    if not isinstance(x, types):
        raise RuntimeError(f"Input type changed: expected {types}, got {type(x)}")
    return None


check_instance = make_prim(
    PrimIDs.CHECK_INSTANCE,
    "check_instance",
    meta=lambda x, types: None,
    python_impl=_check_instance_impl,
    tags=(OpTags.CHECK_OP, OpTags.DONT_DCE),
)


def _check_len_impl(x, length):
    if len(x) != length:
        raise RuntimeError(f"Input length changed: expected {length}, got {len(x)}")
    return None


check_len = make_prim(
    PrimIDs.CHECK_LEN,
    "check_len",
    meta=lambda x, length: None,
    python_impl=_check_len_impl,
    tags=(OpTags.CHECK_OP, OpTags.DONT_DCE),
)


def _check_contains_impl(x, key, kind, expect):
    found = hasattr(x, key) if kind == "attr" else key in x
    if found != expect:
        what = "Attribute" if kind == "attr" else "Key"
        state = "disappeared from" if expect else "appeared in"
        raise RuntimeError(f"{what} {key!r} {state} input (membership changed since trace time)")
    return None


# membership guard for branches baked on key/attribute presence — dict.get
# and 3-arg getattr misses (expect=False: the key APPEARING later must
# retrace) and `in` tests either way.  A whole-container value guard only
# works for small all-primitive dicts (_guardable); this checks exactly the
# observed membership on any container (kind: "item" `in` test, "attr"
# hasattr test)
check_contains = make_prim(
    PrimIDs.CHECK_CONTAINS,
    "check_contains",
    meta=lambda x, key, kind, expect: None,
    python_impl=_check_contains_impl,
    tags=(OpTags.CHECK_OP, OpTags.DONT_DCE),
)


def _check_keys_impl(x, keys):
    actual = tuple(x.keys())
    if actual != keys:
        raise RuntimeError(f"Dict keys changed: expected {keys!r}, got {actual!r}")
    return None


# key-SET-and-ORDER guard for traced dict iteration (for k in d / d.items()):
# the loop unrolled over the observed keys, so any membership OR insertion-
# order change must retrace — per-key membership checks alone would miss a
# reorder
check_keys = make_prim(
    PrimIDs.CHECK_KEYS,
    "check_keys",
    meta=lambda x, keys: None,
    python_impl=_check_keys_impl,
    tags=(OpTags.CHECK_OP, OpTags.DONT_DCE),
)


def _check_type_name_impl(x, name):
    actual = f"{type(x).__module__}.{type(x).__qualname__}"
    if actual != name:
        raise RuntimeError(f"Input class changed: expected {name}, got {actual}")
    return None


# class-identity guard for isinstance() observations on guarded objects: the
# traced branch baked the isinstance result, so swapping the object for one
# of a different class must retrace.  Compared by qualified NAME (repr-safe
# in generated prologue source) rather than by class object
check_type_name = make_prim(
    PrimIDs.CHECK_TYPE_NAME,
    "check_type_name",
    meta=lambda x, name: None,
    python_impl=_check_type_name_impl,
    tags=(OpTags.CHECK_OP, OpTags.DONT_DCE),
)


def _check_literal_like_impl(x, value):
    if x is not value and x != value:
        raise RuntimeError(f"Input changed: expected {value!r}, got {x!r}")
    return None


check_literal_like = make_prim(
    PrimIDs.CHECK_LITERAL_LIKE,
    "check_literal_like",
    meta=lambda x, value: None,
    python_impl=_check_literal_like_impl,
    tags=(OpTags.CHECK_OP, OpTags.DONT_DCE),
)


def _check_none_impl(x):
    if x is not None:
        raise RuntimeError(f"Input changed: expected None, got {x!r}")
    return None


check_none = make_prim(
    PrimIDs.CHECK_NONE,
    "check_none",
    meta=lambda x: None,
    python_impl=_check_none_impl,
    tags=(OpTags.CHECK_OP, OpTags.DONT_DCE),
)
