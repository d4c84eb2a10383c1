"""The core tensor language ("clang"): user-level op semantics over prims.

Counterpart of ``thunder_tpu/clang/__init__.py`` (copied; only the imports change).

Analog of the reference's ``thunder/clang/__init__.py`` (~90 clangops): type
promotion, broadcasting, scalar materialization, and indexing are resolved
here so prims stay strict (same-shape, same-dtype).
"""
from __future__ import annotations

import math
from functools import partial
from numbers import Number
from typing import Any, Callable, Sequence

from thunder_tpu_torch.core import dtypes, prims, utils
from thunder_tpu_torch.core.baseutils import check, check_type
from thunder_tpu_torch.core.devices import Device, to_device
from thunder_tpu_torch.core.langctxs import LanguageContext, Languages, register_langctx
from thunder_tpu_torch.core.prims import PrimIDs
from thunder_tpu_torch.core.proxies import NumberProxy, Proxy, TensorProxy, pyval
from thunder_tpu_torch.core.trace import get_tracectx
from thunder_tpu_torch.core.utils import ELEMENTWISE_TYPE_PROMOTION_KIND as TPK

__all__ = [
    "clangop",
    "maybe_convert_to_dtype",
    "compute_broadcast_shape",
    "maybe_broadcast",
    "broadcast_in_dim",
    "expand",
    "full",
    "full_like",
    "zeros",
    "ones",
    "zeros_like",
    "ones_like",
    "arange",
    "uniform",
    "randn",
    "randint",
    "bernoulli",
    "reshape",
    "squeeze",
    "unsqueeze",
    "transpose",
    "permute",
    "movedim",
    "flatten",
    "cat",
    "stack",
    "split",
    "chunk",
    "slice_in_dim",
    "getitem",
    "flip",
    "pad",
    "matmul",
    "linear",
    "embedding",
    "take",
    "take_along_axis",
    "gather",
    "scatter_add",
    "index_add",
    "index_put",
    "one_hot",
    "where",
    "clamp",
    "sum",
    "mean",
    "amax",
    "amin",
    "prod",
    "var",
    "var_mean",
    "std",
    "argmax",
    "argmin",
    "topk",
    "sort",
    "argsort",
    "cumsum",
    "cumprod",
    "maybe_convert_to_dtype",
    "convert_element_type",
    "device_put",
    "item",
]

#
# clangop registry (for introspection/parity with the reference's @clangop)
#

_clang_ctx = LanguageContext("clang")
register_langctx(Languages.CLANG, _clang_ctx)

_clangops: dict[str, Callable] = {}


class clangop:
    def __init__(self, *, method_name: str | None = None):
        self.method_name = method_name

    def __call__(self, fn: Callable) -> Callable:
        _clangops[fn.__name__] = fn
        if self.method_name is not None:
            _clang_ctx.register_method(self.method_name, fn)
        return fn


#
# dtype / scalar helpers
#


@clangop()
def maybe_convert_to_dtype(a, dtype, *, enforce_safe_casting: bool = False):
    """Converts a (tensor or number) to ``dtype`` if it differs."""
    if dtype is None:
        return a
    if isinstance(a, TensorProxy):
        if dtypes.are_same_dtypes(a.dtype, dtype):
            return a
        return prims.convert_element_type(a, dtypes.resolve_dtype(dtype))
    # numbers convert eagerly
    v = pyval(a) if isinstance(a, NumberProxy) else a
    nt = dtypes.dtype_to_numbertype(dtype)
    return nt(v)


@clangop()
def convert_element_type(a, dtype):
    return maybe_convert_to_dtype(a, dtype)


def _tensor_args(*args) -> list[TensorProxy]:
    return [a for a in args if isinstance(a, TensorProxy)]


def _unwrap_known_number(value):
    """NumberProxy → python value when known; unknown numbers (item()
    results) stay symbolic so the bsym records the proxy and codegen passes
    the runtime scalar through."""
    if isinstance(value, NumberProxy):
        pv = pyval(value)
        return value if pv is None else pv
    return value


def _scalar_to_tensor(value, dtype: dtypes.dtype, device: Device) -> TensorProxy:
    return prims.full((), _unwrap_known_number(value), device=device, dtype=dtype)


#
# broadcasting
#


@clangop()
def compute_broadcast_shape(*shapes) -> tuple[int, ...]:
    shapes = [tuple(s) for s in shapes if s is not None]
    if not shapes:
        return ()
    ndim = max(len(s) for s in shapes)
    out = [1] * ndim
    for s in shapes:
        off = ndim - len(s)
        for i, d in enumerate(s):
            j = off + i
            if d != 1:
                check(
                    out[j] == 1 or out[j] == d,
                    lambda: f"Incompatible broadcast shapes {shapes}",
                )
                out[j] = d
    return tuple(out)


@clangop()
def broadcast_in_dim(a: TensorProxy, shape, broadcast_dimensions) -> TensorProxy:
    return prims.broadcast_in_dim(a, tuple(shape), tuple(broadcast_dimensions))


@clangop()
def expand(a: TensorProxy, shape) -> TensorProxy:
    shape = tuple(int(s) for s in shape)
    # -1 means "keep this dim"
    off = len(shape) - a.ndim
    check(off >= 0, lambda: f"expand: target rank {len(shape)} < input rank {a.ndim}")
    resolved = []
    for i, s in enumerate(shape):
        if s == -1:
            check(i >= off, lambda: "expand: -1 not allowed for new dimensions")
            resolved.append(a.shape[i - off])
        else:
            resolved.append(s)
    if tuple(resolved) == a.shape:
        return a
    bdims = tuple(range(off, len(shape)))
    return prims.broadcast_in_dim(a, tuple(resolved), bdims)


def maybe_broadcast(*args, inputs_share_dtype: bool = False):
    """Broadcasts tensor args to a common shape (numbers pass through)."""
    shapes = [a.shape for a in args if isinstance(a, TensorProxy)]
    if not shapes:
        return args
    common = compute_broadcast_shape(*shapes)
    out = []
    for a in args:
        if isinstance(a, TensorProxy) and tuple(a.shape) != common:
            off = len(common) - a.ndim
            a = prims.broadcast_in_dim(a, common, tuple(range(off, len(common))))
        out.append(a)
    return tuple(out)


#
# elementwise factories
#


def _elementwise_unary_wrapper(a, *, prim, type_promotion_kind=TPK.DEFAULT):
    computation_dtype, result_dtype = utils.elementwise_type_promotion(a, type_promotion_kind=type_promotion_kind)
    if isinstance(a, TensorProxy):
        a = maybe_convert_to_dtype(a, computation_dtype)
        result = prim(a)
        return maybe_convert_to_dtype(result, result_dtype)
    # numbers fold at trace time
    import math as _math

    raise NotImplementedError(f"{prim.name} on plain numbers should fold in the torch layer")


def _elementwise_binary_wrapper(a, b, *, prim, type_promotion_kind=TPK.DEFAULT):
    computation_dtype, result_dtype = utils.elementwise_type_promotion(a, b, type_promotion_kind=type_promotion_kind)

    tensors = _tensor_args(a, b)
    check(len(tensors) > 0, lambda: f"{prim.name}: at least one input must be a tensor here")
    device = tensors[0].device

    # materialize scalars at the computation dtype, broadcast, convert, run
    if not isinstance(a, TensorProxy):
        a = _scalar_to_tensor(a, dtypes.resolve_dtype(computation_dtype), device)
    if not isinstance(b, TensorProxy):
        b = _scalar_to_tensor(b, dtypes.resolve_dtype(computation_dtype), device)
    a, b = maybe_broadcast(a, b)
    a = maybe_convert_to_dtype(a, computation_dtype)
    b = maybe_convert_to_dtype(b, computation_dtype)
    result = prim(a, b)
    return maybe_convert_to_dtype(result, result_dtype)


# unary ops exported with their promotion kinds
_unary_specs = {
    "abs": (prims.abs, TPK.COMPLEX_TO_FLOAT),
    "acos": (prims.acos, TPK.INT_TO_FLOAT),
    "acosh": (prims.acosh, TPK.INT_TO_FLOAT),
    "asin": (prims.asin, TPK.INT_TO_FLOAT),
    "asinh": (prims.asinh, TPK.INT_TO_FLOAT),
    "atan": (prims.atan, TPK.INT_TO_FLOAT),
    "atanh": (prims.atanh, TPK.INT_TO_FLOAT),
    "bitwise_not": (prims.bitwise_not, TPK.PRESERVE),
    "ceil": (prims.ceil, TPK.PRESERVE),
    "cos": (prims.cos, TPK.INT_TO_FLOAT),
    "cosh": (prims.cosh, TPK.INT_TO_FLOAT),
    "digamma": (prims.digamma, TPK.INT_TO_FLOAT),
    "erf": (prims.erf, TPK.INT_TO_FLOAT),
    "erfc": (prims.erfc, TPK.INT_TO_FLOAT),
    "erfinv": (prims.erfinv, TPK.INT_TO_FLOAT),
    "exp": (prims.exp, TPK.INT_TO_FLOAT),
    "exp2": (prims.exp2, TPK.INT_TO_FLOAT),
    "expm1": (prims.expm1, TPK.INT_TO_FLOAT),
    "floor": (prims.floor, TPK.PRESERVE),
    "isfinite": (prims.isfinite, TPK.ALWAYS_BOOL),
    "isinf": (prims.isinf, TPK.ALWAYS_BOOL),
    "isnan": (prims.isnan, TPK.ALWAYS_BOOL),
    "lgamma": (prims.lgamma, TPK.INT_TO_FLOAT),
    "log": (prims.log, TPK.INT_TO_FLOAT),
    "log10": (prims.log10, TPK.INT_TO_FLOAT),
    "log1p": (prims.log1p, TPK.INT_TO_FLOAT),
    "log2": (prims.log2, TPK.INT_TO_FLOAT),
    "neg": (prims.neg, TPK.PRESERVE),
    "reciprocal": (prims.reciprocal, TPK.INT_TO_FLOAT),
    "round": (prims.round, TPK.PRESERVE),
    "rsqrt": (prims.rsqrt, TPK.INT_TO_FLOAT),
    "sign": (prims.sign, TPK.PRESERVE),
    "signbit": (prims.signbit, TPK.ALWAYS_BOOL),
    "sin": (prims.sin, TPK.INT_TO_FLOAT),
    "sinh": (prims.sinh, TPK.INT_TO_FLOAT),
    "sqrt": (prims.sqrt, TPK.INT_TO_FLOAT),
    "tan": (prims.tan, TPK.INT_TO_FLOAT),
    "tanh": (prims.tanh, TPK.INT_TO_FLOAT),
    "trunc": (prims.trunc, TPK.PRESERVE),
    "real": (prims.real, TPK.COMPLEX_TO_FLOAT),
    "imag": (prims.imag, TPK.COMPLEX_TO_FLOAT),
}

import sys

_this = sys.modules[__name__]
for _name, (_prim, _kind) in _unary_specs.items():
    _fn = partial(_elementwise_unary_wrapper, prim=_prim, type_promotion_kind=_kind)
    _fn.__name__ = _name
    _clangops[_name] = _fn
    setattr(_this, _name, _fn)

_binary_specs = {
    "add": (prims.add, TPK.DEFAULT),
    "atan2": (prims.atan2, TPK.INT_TO_FLOAT),
    "bitwise_and": (prims.bitwise_and, TPK.PRESERVE),
    "bitwise_or": (prims.bitwise_or, TPK.PRESERVE),
    "bitwise_xor": (prims.bitwise_xor, TPK.PRESERVE),
    "shift_left": (prims.shift_left, TPK.PRESERVE),
    "shift_right": (prims.shift_right, TPK.PRESERVE),
    "copysign": (prims.copysign, TPK.INT_TO_FLOAT),
    "eq": (prims.eq, TPK.ALWAYS_BOOL),
    "fmod": (prims.fmod, TPK.DEFAULT),
    "ge": (prims.ge, TPK.ALWAYS_BOOL),
    "gt": (prims.gt, TPK.ALWAYS_BOOL),
    "le": (prims.le, TPK.ALWAYS_BOOL),
    "lt": (prims.lt, TPK.ALWAYS_BOOL),
    "maximum": (prims.maximum, TPK.DEFAULT),
    "minimum": (prims.minimum, TPK.DEFAULT),
    "mul": (prims.mul, TPK.DEFAULT),
    "ne": (prims.ne, TPK.ALWAYS_BOOL),
    "nextafter": (prims.nextafter, TPK.NO_OPMATH),
    "pow": (prims.pow, TPK.DEFAULT),
    "remainder": (prims.remainder, TPK.DEFAULT),
    "sub": (prims.sub, TPK.DEFAULT),
    "true_divide": (prims.div, TPK.INT_TO_FLOAT),
}

for _name, (_prim, _kind) in _binary_specs.items():
    _fn = partial(_elementwise_binary_wrapper, prim=_prim, type_promotion_kind=_kind)
    _fn.__name__ = _name
    _clangops[_name] = _fn
    setattr(_this, _name, _fn)


@clangop()
def floor_divide(a, b):
    res_dtype = (a.dtype if isinstance(a, TensorProxy) else b.dtype) if isinstance(a, TensorProxy) or isinstance(b, TensorProxy) else None
    is_exact = res_dtype is not None and dtypes.is_exact_dtype(res_dtype)
    if is_exact:
        # floor division on ints: a - mod(a, b) is exactly divisible and
        # remainder has the divisor's sign, so trunc-div equals floor-div
        mod = _elementwise_binary_wrapper(a, b, prim=prims.remainder, type_promotion_kind=TPK.DEFAULT)
        num = _elementwise_binary_wrapper(a, mod, prim=prims.sub, type_promotion_kind=TPK.DEFAULT)
        return _elementwise_binary_wrapper(num, b, prim=prims.div, type_promotion_kind=TPK.DEFAULT)
    res = _elementwise_binary_wrapper(a, b, prim=prims.div, type_promotion_kind=TPK.DEFAULT)
    return _clangops["floor"](res)


#
# creation
#


def _resolve_device_dtype(device, dtype, default_dtype=dtypes.float32):
    from thunder_tpu_torch.core.devices import default_device

    dev = to_device(device) if device is not None else default_device()
    dt = dtype if dtype is not None else default_dtype
    if dtypes.is_numbertype(dt):
        dt = dtypes.numbertype_to_dtype(dt)
    return dev, dtypes.to_strong_dtype(dt)


@clangop()
def full(shape, fill_value, *, device=None, dtype=None) -> TensorProxy:
    if dtype is None:
        v = pyval(fill_value) if isinstance(fill_value, NumberProxy) else fill_value
        if isinstance(v, bool):
            dtype = dtypes.bool8
        elif isinstance(v, int):
            dtype = dtypes.int64
        elif isinstance(v, complex):
            dtype = dtypes.complex64
        else:
            dtype = dtypes.float32
    dev, dt = _resolve_device_dtype(device, dtype)
    return prims.full(tuple(int(s) for s in shape), _unwrap_known_number(fill_value), device=dev, dtype=dt)


@clangop()
def full_like(a: TensorProxy, fill_value, *, device=None, dtype=None) -> TensorProxy:
    dev = to_device(device) if device is not None else a.device
    dt = dtype if dtype is not None else a.dtype
    return full(a.shape, fill_value, device=dev, dtype=dt)


@clangop()
def zeros(shape, *, device=None, dtype=None) -> TensorProxy:
    return full(shape, 0.0 if dtype is None or dtypes.is_inexact_dtype(dtype) else 0, device=device, dtype=dtype or dtypes.float32)


@clangop()
def ones(shape, *, device=None, dtype=None) -> TensorProxy:
    return full(shape, 1.0 if dtype is None or dtypes.is_inexact_dtype(dtype) else 1, device=device, dtype=dtype or dtypes.float32)


@clangop()
def zeros_like(a: TensorProxy, *, device=None, dtype=None) -> TensorProxy:
    return full_like(a, 0 if dtypes.is_exact_dtype(dtype or a.dtype) else 0.0, device=device, dtype=dtype)


@clangop()
def ones_like(a: TensorProxy, *, device=None, dtype=None) -> TensorProxy:
    return full_like(a, 1 if dtypes.is_exact_dtype(dtype or a.dtype) else 1.0, device=device, dtype=dtype)


@clangop()
def arange(start, end=None, step=1, *, device=None, dtype=None) -> TensorProxy:
    if end is None:
        start, end = 0, start
    start, end, step = (pyval(x) if isinstance(x, NumberProxy) else x for x in (start, end, step))
    if dtype is None:
        if any(isinstance(x, float) for x in (start, end, step)):
            dtype = dtypes.float32
        else:
            dtype = dtypes.int64
    dev, dt = _resolve_device_dtype(device, dtype)
    length = max(0, math.ceil((end - start) / step))
    return prims.iota(length, start=start, step=step, device=dev, dtype=dt)


def _rng_key_and_offset(device: Device):
    """Gets (key proxy, static offset) for a random op, threading an implicit
    PRNG-key input through the trace (TPU-first: explicit keys, pure programs)."""
    trace = get_tracectx()
    check(trace is not None, lambda: "random ops require an active trace")
    key = getattr(trace, "_rng_key_proxy", None)
    if key is None:
        key = TensorProxy(name="rng_key", shape=(2,), device=device, dtype=dtypes.uint32, requires_grad=False)
        trace._rng_key_proxy = key
    offset = getattr(trace, "_rng_offset_ctr", 0)
    trace._rng_offset_ctr = offset + 1
    return key, offset


@clangop()
def uniform(shape, minval=0.0, maxval=1.0, *, device=None, dtype=None) -> TensorProxy:
    dev, dt = _resolve_device_dtype(device, dtype)
    key, offset = _rng_key_and_offset(dev)
    minval = pyval(minval) if isinstance(minval, NumberProxy) else minval
    maxval = pyval(maxval) if isinstance(maxval, NumberProxy) else maxval
    return prims.uniform(tuple(int(s) for s in shape), minval, maxval, device=dev, dtype=dt, key=key, offset=offset)


@clangop()
def randn(shape, *, device=None, dtype=None) -> TensorProxy:
    dev, dt = _resolve_device_dtype(device, dtype)
    key, offset = _rng_key_and_offset(dev)
    return prims.randn(tuple(int(s) for s in shape), device=dev, dtype=dt, key=key, offset=offset)


@clangop()
def randint(low, high, shape, *, device=None, dtype=None) -> TensorProxy:
    dev, dt = _resolve_device_dtype(device, dtype, default_dtype=dtypes.int64)
    key, offset = _rng_key_and_offset(dev)
    return prims.randint(tuple(int(s) for s in shape), int(low), int(high), device=dev, dtype=dt, key=key, offset=offset)


@clangop()
def bernoulli(p, shape=None, *, device=None, dtype=None) -> TensorProxy:
    """Bernoulli(p) samples (as the requested dtype)."""
    if isinstance(p, TensorProxy):
        u = uniform(p.shape, 0.0, 1.0, device=p.device, dtype=dtypes.float32)
        mask = _clangops["lt"](u, p)
    else:
        check(shape is not None, lambda: "bernoulli with scalar p requires a shape")
        u = uniform(shape, 0.0, 1.0, device=device, dtype=dtypes.float32)
        mask = _clangops["lt"](u, float(p))
    return maybe_convert_to_dtype(mask, dtype or dtypes.float32)


#
# shape ops
#


@clangop()
def reshape(a: TensorProxy, shape) -> TensorProxy:
    shape = list(int(s) for s in shape)
    # resolve a single -1
    if -1 in shape:
        idx = shape.index(-1)
        known = 1
        for i, s in enumerate(shape):
            if i != idx:
                known *= s
        check(known != 0 and a.numel % known == 0, lambda: f"reshape: cannot infer -1 for {a.shape} -> {shape}")
        shape[idx] = a.numel // known
    if tuple(shape) == a.shape:
        return a
    return prims.reshape(a, tuple(shape))


@clangop()
def squeeze(a: TensorProxy, dims=None) -> TensorProxy:
    if dims is None:
        dims = tuple(i for i, s in enumerate(a.shape) if s == 1)
    elif isinstance(dims, int):
        dims = (dims,)
    dims = tuple(utils.canonicalize_dim(a.ndim, d) for d in dims)
    dims = tuple(d for d in dims if a.shape[d] == 1)
    if not dims:
        return a
    return prims.squeeze(a, dims)


@clangop()
def unsqueeze(a: TensorProxy, dim: int) -> TensorProxy:
    dim = utils.canonicalize_dim(a.ndim + 1, dim)
    shape = list(a.shape)
    shape.insert(dim, 1)
    return prims.reshape(a, tuple(shape))


@clangop()
def transpose(a: TensorProxy, dim0: int, dim1: int) -> TensorProxy:
    dim0 = utils.canonicalize_dim(a.ndim, dim0)
    dim1 = utils.canonicalize_dim(a.ndim, dim1)
    perm = list(range(a.ndim))
    perm[dim0], perm[dim1] = perm[dim1], perm[dim0]
    return prims.transpose(a, tuple(perm))


@clangop()
def permute(a: TensorProxy, dims) -> TensorProxy:
    return prims.transpose(a, tuple(utils.canonicalize_dim(a.ndim, d) for d in dims))


@clangop()
def movedim(a: TensorProxy, source, destination) -> TensorProxy:
    src = (source,) if isinstance(source, int) else tuple(source)
    dst = (destination,) if isinstance(destination, int) else tuple(destination)
    src = tuple(utils.canonicalize_dim(a.ndim, d) for d in src)
    dst = tuple(utils.canonicalize_dim(a.ndim, d) for d in dst)
    perm = [d for d in range(a.ndim) if d not in src]
    for d, s in sorted(zip(dst, src)):
        perm.insert(d, s)
    return prims.transpose(a, tuple(perm))


@clangop()
def flatten(a: TensorProxy, start_dim: int = 0, end_dim: int = -1) -> TensorProxy:
    start = utils.canonicalize_dim(a.ndim, start_dim)
    end = utils.canonicalize_dim(a.ndim, end_dim)
    check(start <= end, lambda: "flatten: start_dim > end_dim")
    if a.ndim == 0:
        return reshape(a, (1,))
    n = 1
    for s in a.shape[start : end + 1]:
        n *= s
    shape = a.shape[:start] + (n,) + a.shape[end + 1 :]
    return reshape(a, shape)


@clangop()
def cat(tensors, dim: int = 0) -> TensorProxy:
    return prims.cat(list(tensors), utils.canonicalize_dim(tensors[0].ndim, dim))


@clangop()
def stack(tensors, dim: int = 0) -> TensorProxy:
    tensors = [unsqueeze(t, dim) for t in tensors]
    return cat(tensors, dim)


@clangop()
def slice_in_dim(a: TensorProxy, start: int, stop: int, *, stride: int = 1, dim: int = 0) -> TensorProxy:
    dim = utils.canonicalize_dim(a.ndim, dim)
    starts = [0] * a.ndim
    stops = list(a.shape)
    strides = [1] * a.ndim
    starts[dim] = start
    stops[dim] = stop
    strides[dim] = stride
    return prims.slice_prim(a, starts, stops, strides)


@clangop()
def split(a: TensorProxy, size_or_sections, dim: int = 0):
    dim = utils.canonicalize_dim(a.ndim, dim)
    n = a.shape[dim]
    if isinstance(size_or_sections, int):
        sizes = [size_or_sections] * (n // size_or_sections)
        if n % size_or_sections:
            sizes.append(n % size_or_sections)
    else:
        sizes = list(size_or_sections)
    out = []
    offset = 0
    for s in sizes:
        out.append(slice_in_dim(a, offset, offset + s, dim=dim))
        offset += s
    return tuple(out)


@clangop()
def chunk(a: TensorProxy, chunks: int, dim: int = 0):
    dim = utils.canonicalize_dim(a.ndim, dim)
    size = -(-a.shape[dim] // chunks)  # ceil div
    return split(a, size, dim)


@clangop()
def flip(a: TensorProxy, dims) -> TensorProxy:
    if isinstance(dims, int):
        dims = (dims,)
    return prims.flip(a, tuple(dims))


@clangop()
def pad(a: TensorProxy, padding_value, padding_config) -> TensorProxy:
    return prims.pad(a, padding_value, list(padding_config))


#
# indexing
#


def _basic_index(a: TensorProxy, key) -> TensorProxy:
    """int/slice/None/Ellipsis indexing via slice+reshape."""
    if not isinstance(key, tuple):
        key = (key,)
    # expand Ellipsis
    n_specified = len([k for k in key if k is not None and k is not Ellipsis])
    # identity scan, not `in`/`index`: those call __eq__, which a TensorProxy
    # element would turn into an elementwise op
    ell = next((j for j, k in enumerate(key) if k is Ellipsis), None)
    if ell is not None:
        fill = a.ndim - n_specified
        key = key[:ell] + (slice(None),) * fill + key[ell + 1 :]
    else:
        key = key + (slice(None),) * (a.ndim - n_specified)

    starts, stops, strides = [], [], []
    out_shape = []
    squeeze_dims = []
    unsqueeze_positions = []
    advanced = None  # at most one (dim, list-of-ints | int tensor) among basics
    dim = 0
    out_dim = 0
    for k in key:
        if k is None:
            unsqueeze_positions.append(out_dim)
            out_dim += 1
            continue
        size = a.shape[dim]
        if isinstance(k, (int, NumberProxy)) and not isinstance(k, bool):
            i = int(pyval(k) if isinstance(k, NumberProxy) else k)
            if i < 0:
                i += size
            check(0 <= i < size, lambda: f"index {i} out of range for dim {dim} (size {size})", IndexError)
            starts.append(i)
            stops.append(i + 1)
            strides.append(1)
            squeeze_dims.append(dim)
        elif isinstance(k, slice):
            start, stop, stride = k.indices(size)
            check(stride > 0, lambda: "negative slice steps are not supported yet")
            starts.append(start)
            stops.append(max(start, stop))
            strides.append(stride)
            out_dim += 1
        elif (
            isinstance(k, list)
            and k
            and all(isinstance(e, int) and not isinstance(e, bool) for e in k)
        ) or (isinstance(k, TensorProxy) and k.ndim == 1 and not dtypes.is_boolean_dtype(k.dtype)):
            # ONE advanced index mixed with basics (torch a[:, [-1, 0]]):
            # keep the dim whole here, gather along it afterwards
            check(advanced is None, lambda: "only one advanced index among basic indices is supported")
            check(not unsqueeze_positions, lambda: "None + advanced index mixing is not supported")
            advanced = (dim, k)
            starts.append(0)
            stops.append(size)
            strides.append(1)
            out_dim += 1
        else:
            raise TypeError(f"Unsupported basic index {k!r}")
        dim += 1

    result = prims.slice_prim(a, starts, stops, strides)
    if squeeze_dims:
        result = prims.squeeze(result, tuple(squeeze_dims))
    if advanced is not None:
        adv_dim, k = advanced
        pos = adv_dim - len([d for d in squeeze_dims if d < adv_dim])  # NB: `sum` is clang's op here
        if isinstance(k, TensorProxy):
            result = prims.take(result, k, pos)
        else:
            result = _gather_static_list(result, k, pos)
    for pos in unsqueeze_positions:
        result = unsqueeze(result, pos)
    return result


@clangop(method_name="getitem")
def getitem(a: TensorProxy, key) -> TensorProxy:
    # advanced indexing with a tensor
    if isinstance(key, TensorProxy):
        if dtypes.is_boolean_dtype(key.dtype):
            raise NotImplementedError("boolean mask indexing produces dynamic shapes; use where/masked ops")
        if key.ndim <= 1:
            return prims.take(a, key, 0)
        # integer tensor of rank>1: flatten, take, reshape
        flat = reshape(key, (key.numel,))
        taken = prims.take(a, flat, 0)
        return reshape(taken, tuple(key.shape) + tuple(a.shape[1:]))
    if isinstance(key, list):
        # fancy list index along dim 0: a[[2, 0, 1]].  Small static lists
        # decompose to a cat of unit slices (stays fully static for XLA)
        if any(isinstance(k, bool) for k in key):
            raise NotImplementedError("boolean mask indexing produces dynamic shapes; use where/masked ops")
        check(all(isinstance(k, int) for k in key), lambda: "list indexing requires a list of ints")
        return _gather_static_list(a, key, 0)
    if isinstance(key, tuple) and any(isinstance(k, TensorProxy) for k in key):
        try:
            return _mixed_advanced_index(a, key)
        except NotImplementedError:
            # a single 1-D integer tensor among non-full-slice basics
            # (a[1, idx]) is served by the basic path's advanced arm; other
            # rejected patterns keep _mixed_advanced_index's rewrite hint
            tps = [k for k in key if isinstance(k, TensorProxy)]
            if (
                len(tps) == 1
                and tps[0].ndim == 1
                and not dtypes.is_boolean_dtype(tps[0].dtype)
                and not any(k is None for k in key)
            ):
                return _basic_index(a, key)
            raise
    return _basic_index(a, key)


def _gather_static_list(a: TensorProxy, ints: list, dim: int) -> TensorProxy:
    """Static-list gather along ``dim``: unit slices + cat (fully static for
    XLA).  Shared by plain list indexing and the basic path's advanced arm."""
    check(len(ints) > 0, lambda: "empty list index is not supported")
    size = a.shape[dim]
    parts = []
    for i in ints:
        if i < 0:
            i += size
        check(0 <= i < size, lambda: f"list index {i} out of range for dim of size {size}", IndexError)
        parts.append(slice_in_dim(a, i, i + 1, dim=dim))
    return cat(parts, dim) if len(parts) > 1 else parts[0]


def _mixed_advanced_index(a: TensorProxy, key: tuple) -> TensorProxy:
    """Advanced indexing with integer tensors mixed with full slices
    (reference: ``thunder/clang/__init__.py`` _advanced_indexing).  Supported:
    a *contiguous* run of integer-tensor indices, full slices elsewhere —
    ``a[i]``, ``a[:, i]``, ``a[i, j]``, ``a[:, i, j, :]`` — with NumPy result
    placement (broadcast index dims replace the indexed dims in place).
    Lowering: merge the indexed dims, fold the indices into one flat index,
    one ``take`` — a single XLA gather."""
    nkey = list(key) + [slice(None)] * (a.ndim - len(key))
    check(len(nkey) == a.ndim, lambda: f"too many indices for {a.ndim}D tensor")
    tensor_pos = [i for i, k in enumerate(nkey) if isinstance(k, TensorProxy)]
    ok_layout = all(isinstance(k, TensorProxy) or k == slice(None) for k in nkey) and tensor_pos == list(
        range(tensor_pos[0], tensor_pos[0] + len(tensor_pos))
    )
    if not ok_layout:
        raise NotImplementedError(
            "mixed advanced indexing supports one contiguous run of integer tensor "
            "indices with full slices elsewhere; rewrite other patterns with take/gather"
        )
    for p in tensor_pos:
        check(not dtypes.is_boolean_dtype(nkey[p].dtype), lambda: "boolean mask indexing produces dynamic shapes")
    start, n = tensor_pos[0], len(tensor_pos)
    idxs = [nkey[p] for p in tensor_pos]
    bshape = compute_broadcast_shape(*(i.shape for i in idxs))
    sizes = a.shape[start : start + n]
    # fold the (broadcast) indices into one flat row-major index
    flat_idx = None
    for i, (ix, size) in enumerate(zip(idxs, sizes)):
        ix = maybe_convert_to_dtype(ix, dtypes.int32)
        # wrap negatives (numpy/torch semantics)
        ix = where(lt(ix, 0), add(ix, size), ix)
        ix = expand(reshape(ix, (1,) * (len(bshape) - ix.ndim) + tuple(ix.shape)), bshape) if tuple(ix.shape) != tuple(bshape) else ix
        flat_idx = ix if flat_idx is None else add(mul(flat_idx, size), ix)
    merged = 1
    for s in sizes:
        merged *= s
    am = reshape(a, tuple(a.shape[:start]) + (merged,) + tuple(a.shape[start + n :]))
    if flat_idx.ndim == 0:
        flat1d = reshape(flat_idx, (1,))
    elif flat_idx.ndim == 1:
        flat1d = flat_idx
    else:
        flat1d = reshape(flat_idx, (flat_idx.numel,))
    taken = prims.take(am, flat1d, start)
    out_shape = tuple(a.shape[:start]) + tuple(bshape) + tuple(a.shape[start + n :])
    return reshape(taken, out_shape)


@clangop()
def take(a: TensorProxy, indices: TensorProxy, dim: int) -> TensorProxy:
    return prims.take(a, indices, utils.canonicalize_dim(a.ndim, dim))


@clangop()
def take_along_axis(a: TensorProxy, indices: TensorProxy, dim: int) -> TensorProxy:
    return prims.take_along_axis(a, indices, utils.canonicalize_dim(a.ndim, dim))


@clangop()
def gather(a: TensorProxy, indices: TensorProxy, dim: int) -> TensorProxy:
    return prims.gather(a, indices, utils.canonicalize_dim(a.ndim, dim))


@clangop()
def scatter_add(a: TensorProxy, indices: TensorProxy, value: TensorProxy, dim: int) -> TensorProxy:
    return prims.scatter_add(a, indices, value, utils.canonicalize_dim(a.ndim, dim))


@clangop()
def index_add(a: TensorProxy, indices: TensorProxy, value: TensorProxy, dim: int) -> TensorProxy:
    return prims.index_add(a, indices, value, utils.canonicalize_dim(a.ndim, dim))


@clangop()
def index_put(a: TensorProxy, indices, values: TensorProxy, accumulate: bool = False) -> TensorProxy:
    return prims.index_put(a, tuple(indices), values, bool(accumulate))


@clangop()
def one_hot(a: TensorProxy, num_classes: int) -> TensorProxy:
    return prims.one_hot(a, int(num_classes))


#
# matmul / nn
#


@clangop()
def matmul(a: TensorProxy, b: TensorProxy) -> TensorProxy:
    utils.check_same_dtype(a, b, name="matmul")
    return prims.matmul(a, b)


@clangop()
def linear(a: TensorProxy, w: TensorProxy, bias: TensorProxy | None = None) -> TensorProxy:
    return prims.linear(a, w, bias)


@clangop()
def embedding(indices: TensorProxy, weight: TensorProxy, *, padding_idx=None) -> TensorProxy:
    return prims.embedding(indices, weight, padding_idx=padding_idx)


#
# conditionals
#


@clangop()
def where(pred, a, b) -> TensorProxy:
    tensors = _tensor_args(pred, a, b)
    check(len(tensors) > 0, lambda: "where: expected at least one tensor input")
    device = tensors[0].device
    computation_dtype, result_dtype = utils.elementwise_type_promotion(
        *(x for x in (a, b)), type_promotion_kind=TPK.DEFAULT
    )
    dt = dtypes.resolve_dtype(computation_dtype)
    if not isinstance(pred, TensorProxy):
        pred = _scalar_to_tensor(bool(pred), dtypes.bool8, device)
    pred = maybe_convert_to_dtype(pred, dtypes.bool8)
    if not isinstance(a, TensorProxy):
        a = _scalar_to_tensor(a, dt, device)
    if not isinstance(b, TensorProxy):
        b = _scalar_to_tensor(b, dt, device)
    a = maybe_convert_to_dtype(a, dt)
    b = maybe_convert_to_dtype(b, dt)
    pred, a, b = maybe_broadcast(pred, a, b)
    result = prims.where(pred, a, b)
    return maybe_convert_to_dtype(result, result_dtype)


@clangop()
def clamp(a: TensorProxy, min=None, max=None) -> TensorProxy:
    result = a
    if min is not None:
        result = _clangops["maximum"](result, min)
    if max is not None:
        result = _clangops["minimum"](result, max)
    return result


#
# reductions
#


def _reduction_dims(ndim: int, dim) -> tuple[int, ...]:
    if dim is None:
        return tuple(range(ndim))
    if isinstance(dim, (int, NumberProxy)):
        dim = (int(pyval(dim) if isinstance(dim, NumberProxy) else dim),)
    return tuple(utils.canonicalize_dim(ndim, int(d)) for d in dim)


def _restore_keepdim(result: TensorProxy, orig_shape, dims) -> TensorProxy:
    shape = list(orig_shape)
    for d in dims:
        shape[d] = 1
    return reshape(result, tuple(shape))


@clangop()
def sum(a: TensorProxy, dim=None, keepdim: bool = False, *, dtype=None) -> TensorProxy:
    dims = _reduction_dims(a.ndim, dim)
    if dtype is None:
        # bool/int sums accumulate in int64 (torch semantics)
        dtype = a.dtype
        if dtypes.is_exact_dtype(dtype):
            dtype = dtypes.int64
    a = maybe_convert_to_dtype(a, dtype)
    result = prims.sum(a, dims)
    if keepdim:
        result = _restore_keepdim(result, a.shape, dims)
    return result


@clangop()
def mean(a: TensorProxy, dim=None, keepdim: bool = False, *, dtype=None) -> TensorProxy:
    dims = _reduction_dims(a.ndim, dim)
    if dtype is None:
        dtype = a.dtype if dtypes.is_inexact_dtype(a.dtype) else dtypes.float32
    n = 1
    for d in dims:
        n *= a.shape[d]
    result = sum(a, dim, keepdim, dtype=dtype)
    return _elementwise_binary_wrapper(result, float(n), prim=prims.div, type_promotion_kind=TPK.DEFAULT)


@clangop()
def amax(a: TensorProxy, dim=None, keepdim: bool = False) -> TensorProxy:
    dims = _reduction_dims(a.ndim, dim)
    result = prims.amax(a, dims)
    if keepdim:
        result = _restore_keepdim(result, a.shape, dims)
    return result


@clangop()
def amin(a: TensorProxy, dim=None, keepdim: bool = False) -> TensorProxy:
    dims = _reduction_dims(a.ndim, dim)
    result = prims.amin(a, dims)
    if keepdim:
        result = _restore_keepdim(result, a.shape, dims)
    return result


@clangop()
def prod(a: TensorProxy, dim=None, keepdim: bool = False, *, dtype=None) -> TensorProxy:
    dims = _reduction_dims(a.ndim, dim)
    if dtype is not None:
        a = maybe_convert_to_dtype(a, dtype)
    result = prims.prod(a, dims)
    if keepdim:
        result = _restore_keepdim(result, a.shape, dims)
    return result


@clangop()
def var(a: TensorProxy, dim=None, keepdim: bool = False, *, correction: float = 1) -> TensorProxy:
    dims = _reduction_dims(a.ndim, dim)
    result = prims.var(a, dims, correction=float(correction))
    if keepdim:
        result = _restore_keepdim(result, a.shape, dims)
    return result


@clangop()
def var_mean(a: TensorProxy, dim=None, keepdim: bool = False, *, correction: float = 1):
    dims = _reduction_dims(a.ndim, dim)
    v, m = prims.var_mean(a, dims, correction=float(correction))
    if keepdim:
        v = _restore_keepdim(v, a.shape, dims)
        m = _restore_keepdim(m, a.shape, dims)
    return v, m


@clangop()
def std(a: TensorProxy, dim=None, keepdim: bool = False, *, correction: float = 1) -> TensorProxy:
    return _clangops["sqrt"](var(a, dim, keepdim, correction=correction))


@clangop()
def argmax(a: TensorProxy, dim=None, keepdim: bool = False) -> TensorProxy:
    d = None if dim is None else utils.canonicalize_dim(a.ndim, dim)
    result = prims.argmax(a, d)
    if keepdim and d is not None:
        result = _restore_keepdim(result, a.shape, (d,))
    return result


@clangop()
def argmin(a: TensorProxy, dim=None, keepdim: bool = False) -> TensorProxy:
    d = None if dim is None else utils.canonicalize_dim(a.ndim, dim)
    result = prims.argmin(a, d)
    if keepdim and d is not None:
        result = _restore_keepdim(result, a.shape, (d,))
    return result


@clangop()
def topk(a: TensorProxy, k: int, dim: int = -1, largest: bool = True, sorted: bool = True):
    return prims.topk(a, int(k), utils.canonicalize_dim(a.ndim, dim), bool(largest), bool(sorted))


@clangop()
def sort(a: TensorProxy, dim: int = -1, descending: bool = False):
    return prims.sort(a, utils.canonicalize_dim(a.ndim, dim), bool(descending))


@clangop()
def argsort(a: TensorProxy, dim: int = -1, descending: bool = False) -> TensorProxy:
    return prims.argsort(a, utils.canonicalize_dim(a.ndim, dim), bool(descending))


@clangop()
def cumsum(a: TensorProxy, dim: int) -> TensorProxy:
    return prims.cumsum(a, utils.canonicalize_dim(a.ndim, dim))


@clangop()
def cumprod(a: TensorProxy, dim: int) -> TensorProxy:
    return prims.cumprod(a, utils.canonicalize_dim(a.ndim, dim))


@clangop()
def device_put(a: TensorProxy, device) -> TensorProxy:
    dev = to_device(device)
    if dev == a.device:
        return a
    return prims.device_put(a, dev)


@clangop()
def item(a: TensorProxy):
    return prims.item(a)
