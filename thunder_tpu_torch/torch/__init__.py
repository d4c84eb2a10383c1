"""The torch language: the ``ltorch`` operation surface of the port.

Counterpart of ``thunder_tpu/torch/__init__.py``, symbol for symbol: each op
is a non-prim Symbol whose meta is its decomposition into ``clang`` and
``prims``, so an executor can claim it whole (the cuda executor claims the
SDPA prim this module's ``scaled_dot_product_attention`` reaches) or run its
decomposition.  The module registers itself as ``Languages.TORCH``, the
default language of trace acquisition: proxies' operators and methods
(``a + b``, ``a.sum()``, ``a.float()``) resolve here, and
``_torch_to_thunder_function_map`` maps the real ``torch.*``,
``torch.nn.functional.*`` and ``torch.Tensor`` callables onto these symbols,
so ``TensorProxy.__torch_function__`` records a torch call made on proxies.

The port differs from the reference where torch is the framework:

- ``to``/``type`` and every ``dtype=`` take torch dtypes (``torch.float32``)
  as well as the port's own (``x.dtype`` on a proxy);
- ``var``/``std``/``var_mean`` also take torch's ``unbiased=``;
- ``nan_to_num``'s default bounds come from ``torch.finfo``;
- ``manual_seed`` seeds the port's ``core/rng.py``: masks reproduce, but
  the values are not JAX's threefry bits (``ROADMAP.md`` keeps this
  divergence on purpose);
- every torch.Tensor method registered here maps its ``torch.Tensor``
  callable too.

Factories given no ``device=`` take the port's default device (the card;
``core/devices.default_device`` raises without one), so nothing lands on
the CPU unasked.

This module is the traced language.  ``thunder_tpu_torch/ltorch.py`` stays
the eager autograd module of the train step's eager twin and the serving
forward (``_SDPA``, ``_CrossEntropy``, ``DECLINES``); its
``scaled_dot_product_attention``, ``cross_entropy`` and
``fused_linear_cross_entropy`` bind this module's symbols when they are
handed proxies.
"""
from __future__ import annotations

import builtins
import functools
import math
import sys
from numbers import Number
from typing import Any, Callable, Sequence

import torch

from thunder_tpu_torch import clang
from thunder_tpu_torch.core import dtypes, prims, utils
from thunder_tpu_torch.core.baseutils import check
from thunder_tpu_torch.core.devices import Device, to_device
from thunder_tpu_torch.core.langctxs import LanguageContext, Languages, register_langctx
from thunder_tpu_torch.core.proxies import NumberProxy, TensorProxy, pyval
from thunder_tpu_torch.core.symbol import Symbol

_this_module = sys.modules[__name__]
__print_alias__ = "ltorch"

#
# Language context: tensor methods resolve here
#

_torch_ctx = LanguageContext("torch")
register_langctx(Languages.TORCH, _torch_ctx)

_torch_to_thunder_function_map: dict[Any, Callable] = {}

_torchsymbols: dict[str, Symbol] = {}


class torchsymbol:
    def __init__(self, *torchfns, is_method: bool = False, method_name: str | None = None, id: str | None = None):
        self.torchfns = torchfns
        self.is_method = is_method
        self.method_name = method_name
        self.id = id

    def __call__(self, fn: Callable) -> Symbol:
        name = fn.__name__
        # real torch.Tensor operands bake to constant proxies centrally in
        # Symbol.__call__ (pre-bind), so the meta needs no wrapping here
        sym = Symbol(name=name, meta=fn, id=self.id or f"torch.{name}", module=_this_module)
        _torchsymbols[name] = sym
        if self.is_method or self.method_name is not None:
            _torch_ctx.register_method(self.method_name or name, sym)
        for tfn in self.torchfns:
            if tfn is not None:
                _torch_to_thunder_function_map[tfn] = sym
        return sym


_torch = torch


def _tfn(*path: str):
    """Resolves torch.<path> (None where this torch lacks it)."""
    obj = _torch
    for p in path:
        if obj is None:
            return None
        obj = getattr(obj, p, None)
    return obj


#
# Elementwise unary
#

_unary_ops = [
    "abs", "acos", "acosh", "asin", "asinh", "atan", "atanh", "ceil", "cos", "cosh",
    "digamma", "erf", "erfc", "erfinv", "exp", "exp2", "expm1", "floor", "isfinite",
    "isinf", "isnan", "lgamma", "log", "log10", "log1p", "log2", "neg", "reciprocal",
    "round", "rsqrt", "sign", "signbit", "sin", "sinh", "sqrt", "tan", "tanh", "trunc",
    "real", "bitwise_not",
]


def _check_bitwise(name: str, *operands) -> None:
    """Bitwise ops take integer or bool tensors: a float operand raises
    ``TypeError`` at trace time (the reference's ``jnp`` call raises the
    same type when its program runs; torch raises ``NotImplementedError``)."""
    for x in operands:
        if isinstance(x, TensorProxy):
            check(dtypes.is_exact_dtype(x.dtype),
                  lambda: f"{name} does not accept dtype {x.dtype}: bitwise ops take integer "
                          "or bool tensors", exception_type=TypeError)


def _make_unary(opname: str) -> Symbol:
    clang_fn = getattr(clang, opname)

    def meta(a):
        if opname == "bitwise_not":
            _check_bitwise(opname, a)
        return clang_fn(a)

    meta.__name__ = opname
    sym = torchsymbol(_tfn(opname), is_method=True)(meta)
    return sym


for _op in _unary_ops:
    setattr(_this_module, _op, _make_unary(_op))

#
# Elementwise binary
#

_binary_ops = [
    ("add", "add"),
    ("sub", "sub"),
    ("mul", "mul"),
    ("true_divide", "true_divide"),
    ("floor_divide", "floor_divide"),
    ("pow", "pow"),
    ("remainder", "remainder"),
    ("fmod", "fmod"),
    ("atan2", "atan2"),
    ("eq", "eq"),
    ("ne", "ne"),
    ("ge", "ge"),
    ("gt", "gt"),
    ("le", "le"),
    ("lt", "lt"),
    ("maximum", "maximum"),
    ("minimum", "minimum"),
    ("bitwise_and", "bitwise_and"),
    ("bitwise_or", "bitwise_or"),
    ("bitwise_xor", "bitwise_xor"),
    ("copysign", "copysign"),
    ("nextafter", "nextafter"),
]


def _make_binary(name: str, clang_name: str) -> Symbol:
    clang_fn = getattr(clang, clang_name)

    def meta(a, b, *, alpha=None):
        if name.startswith("bitwise_"):
            _check_bitwise(name, a, b)
        if alpha is not None and alpha != 1:
            b = clang.mul(b, alpha)
        return clang_fn(a, b)

    meta.__name__ = name
    sym = torchsymbol(_tfn(name), is_method=True)(meta)
    return sym


for _name, _cname in _binary_ops:
    setattr(_this_module, _name, _make_binary(_name, _cname))

_torch_to_thunder_function_map[_tfn("div")] = getattr(_this_module, "true_divide")
_torch_ctx.register_method("div", getattr(_this_module, "true_divide"))


@torchsymbol(_tfn("logical_and"))
def logical_and(a, b):
    return clang.bitwise_and(_to_bool(a), _to_bool(b))


@torchsymbol(_tfn("logical_or"))
def logical_or(a, b):
    return clang.bitwise_or(_to_bool(a), _to_bool(b))


@torchsymbol(_tfn("logical_not"))
def logical_not(a):
    return clang.bitwise_not(_to_bool(a))


def _to_bool(a):
    if isinstance(a, TensorProxy) and not dtypes.is_boolean_dtype(a.dtype):
        return clang.ne(a, 0)
    return a


@torchsymbol(_tfn("where"), is_method=True)
def where(pred, a, b):
    return clang.where(pred, a, b)


@torchsymbol(_tfn("clamp"), is_method=True)
def clamp(a, min=None, max=None):
    check(min is not None or max is not None,
          lambda: "clamp: at least one of min or max must not be None")
    return clang.clamp(a, min, max)


@torchsymbol(_tfn("clip"))
def clip(a, min=None, max=None):
    return clamp(a, min, max)


@torchsymbol(_tfn("masked_fill"), is_method=True)
def masked_fill(a, mask, value):
    return clang.where(mask, value, a)


@torchsymbol(_tfn("tril"), is_method=True)
def tril(a, diagonal: int = 0):
    check(a.ndim >= 2, lambda: "tril requires at least 2 dims")
    nrows, ncols = a.shape[-2], a.shape[-1]
    row = clang.arange(0, nrows, device=a.device, dtype=dtypes.int32)
    col = clang.arange(0, ncols, device=a.device, dtype=dtypes.int32)
    row = clang.reshape(row, (nrows, 1))
    col = clang.reshape(col, (1, ncols))
    mask = clang.ge(clang.sub(clang.add(row, diagonal), col), 0)
    return clang.where(mask, a, 0)


@torchsymbol(_tfn("triu"), is_method=True)
def triu(a, diagonal: int = 0):
    check(a.ndim >= 2, lambda: "triu requires at least 2 dims")
    nrows, ncols = a.shape[-2], a.shape[-1]
    row = clang.arange(0, nrows, device=a.device, dtype=dtypes.int32)
    col = clang.arange(0, ncols, device=a.device, dtype=dtypes.int32)
    row = clang.reshape(row, (nrows, 1))
    col = clang.reshape(col, (1, ncols))
    mask = clang.le(clang.sub(clang.add(row, diagonal), col), 0)
    return clang.where(mask, a, 0)


#
# Creation
#


@torchsymbol(_tfn("full"))
def full(size, fill_value, *, device=None, dtype=None):
    return clang.full(size, fill_value, device=device, dtype=_to_thunder_dtype(dtype))


@torchsymbol(_tfn("full_like"))
def full_like(a, fill_value, *, device=None, dtype=None):
    return clang.full_like(a, fill_value, device=device, dtype=_to_thunder_dtype(dtype))


@torchsymbol(_tfn("zeros"))
def zeros(*size, device=None, dtype=None):
    size = _flatten_size(size)
    return clang.zeros(size, device=device, dtype=_to_thunder_dtype(dtype))


@torchsymbol(_tfn("ones"))
def ones(*size, device=None, dtype=None):
    size = _flatten_size(size)
    return clang.ones(size, device=device, dtype=_to_thunder_dtype(dtype))


@torchsymbol(_tfn("zeros_like"))
def zeros_like(a, *, device=None, dtype=None):
    return clang.zeros_like(a, device=device, dtype=_to_thunder_dtype(dtype))


@torchsymbol(_tfn("ones_like"))
def ones_like(a, *, device=None, dtype=None):
    return clang.ones_like(a, device=device, dtype=_to_thunder_dtype(dtype))


@torchsymbol(_tfn("empty"))
def empty(*size, device=None, dtype=None):
    size = _flatten_size(size)
    return clang.zeros(size, device=device, dtype=_to_thunder_dtype(dtype))


@torchsymbol(is_method=True)
def new_ones(a, *size, device=None, dtype=None):
    size = _flatten_size(size)
    return clang.full(
        size, 1, device=device or a.device, dtype=_to_thunder_dtype(dtype) or a.dtype
    )


@torchsymbol(is_method=True)
def new_zeros(a, *size, device=None, dtype=None):
    size = _flatten_size(size)
    return clang.full(
        size, 0, device=device or a.device, dtype=_to_thunder_dtype(dtype) or a.dtype
    )


@torchsymbol(is_method=True)
def new_full(a, size, fill_value, *, device=None, dtype=None):
    return clang.full(
        size, fill_value, device=device or a.device, dtype=_to_thunder_dtype(dtype) or a.dtype
    )


@torchsymbol(_tfn("arange"))
def arange(start, end=None, step=1, *, device=None, dtype=None):
    return clang.arange(start, end, step, device=device, dtype=_to_thunder_dtype(dtype))


@torchsymbol(_tfn("rand"))
def rand(*size, device=None, dtype=None):
    size = _flatten_size(size)
    return clang.uniform(size, 0.0, 1.0, device=device, dtype=_to_thunder_dtype(dtype))


@torchsymbol(_tfn("randn"))
def randn(*size, device=None, dtype=None):
    size = _flatten_size(size)
    return clang.randn(size, device=device, dtype=_to_thunder_dtype(dtype))


@torchsymbol(_tfn("randint"))
def randint(low, high=None, size=(), *, device=None, dtype=None):
    if high is None:
        low, high = 0, low
    return clang.randint(low, high, size, device=device, dtype=_to_thunder_dtype(dtype) or dtypes.int64)


@torchsymbol(_tfn("bernoulli"))
def bernoulli(a):
    return clang.bernoulli(a)


@torchsymbol(_tfn("uniform"))
def uniform(shape, minval=0.0, maxval=1.0, *, device=None, dtype=None):
    return clang.uniform(shape, minval, maxval, device=device, dtype=_to_thunder_dtype(dtype))


def _flatten_size(size) -> tuple:
    if len(size) == 1 and isinstance(size[0], (tuple, list)):
        return tuple(size[0])
    return tuple(size)


def _to_thunder_dtype(dtype):
    if dtype is None:
        return None
    if isinstance(dtype, dtypes.dtype) or dtypes.is_numbertype(dtype):
        return dtype
    return dtypes.to_dtype(dtype)


#
# Shape ops
#


@torchsymbol(_tfn("reshape"), is_method=True)
def reshape(a, *shape):
    shape = _flatten_size(shape)
    return clang.reshape(a, shape)


@torchsymbol(method_name="view")
def view(a, *shape):
    shape = _flatten_size(shape)
    return clang.reshape(a, shape)


@torchsymbol(method_name="view_as")
def view_as(a, b):
    return clang.reshape(a, b.shape)


@torchsymbol(_tfn("permute"), is_method=True)
def permute(a, *dims):
    dims = _flatten_size(dims)
    return clang.permute(a, dims)


@torchsymbol(_tfn("transpose"), is_method=True)
def transpose(a, dim0, dim1):
    return clang.transpose(a, dim0, dim1)


@torchsymbol(_tfn("t"), is_method=True)
def t(a):
    check(a.ndim <= 2, lambda: "t() requires a tensor with at most 2 dims")
    if a.ndim < 2:
        return a
    return clang.transpose(a, 0, 1)


@torchsymbol(method_name="matrix_transpose")
def matrix_transpose(a):
    check(a.ndim >= 2, lambda: ".mT requires at least 2 dims")
    return clang.transpose(a, -2, -1)


@torchsymbol(_tfn("squeeze"), is_method=True)
def squeeze(a, dim=None):
    return clang.squeeze(a, dim)


@torchsymbol(_tfn("unsqueeze"), is_method=True)
def unsqueeze(a, dim):
    return clang.unsqueeze(a, dim)


@torchsymbol(_tfn("flatten"), is_method=True)
def flatten(a, start_dim=0, end_dim=-1):
    return clang.flatten(a, start_dim, end_dim)


@torchsymbol(_tfn("cat"), _tfn("concat"))
def cat(tensors, dim=0):
    return clang.cat(list(tensors), dim)


@torchsymbol(_tfn("stack"))
def stack(tensors, dim=0):
    return clang.stack(list(tensors), dim)


@torchsymbol(_tfn("split"), is_method=True)
def split(a, split_size_or_sections, dim=0):
    return clang.split(a, split_size_or_sections, dim)


@torchsymbol(_tfn("chunk"), is_method=True)
def chunk(a, chunks, dim=0):
    check(isinstance(chunks, (int, NumberProxy)) and chunks > 0,
          lambda: f"chunk expects chunks > 0, got {chunks}")
    return clang.chunk(a, chunks, dim)


@torchsymbol(method_name="expand")
def expand(a, *shape):
    shape = _flatten_size(shape)
    return clang.expand(a, shape)


@torchsymbol(_tfn("broadcast_to"), method_name="broadcast_to")
def broadcast_to(a, *shape):
    return clang.expand(a, _flatten_size(shape))


@torchsymbol(_tfn("movedim"), is_method=True)
def movedim(a, source, destination):
    return clang.movedim(a, source, destination)


@torchsymbol(_tfn("flip"), is_method=True)
def flip(a, dims):
    return clang.flip(a, dims)


@torchsymbol(_tfn("narrow"), is_method=True)
def narrow(a, dim, start, length):
    return clang.slice_in_dim(a, start, start + length, dim=dim)


@torchsymbol(method_name="contiguous")
def contiguous(a):
    return a  # traces are functional: every value the program makes is its own


@torchsymbol(_tfn("clone"), is_method=True)
def clone(a, *, memory_format=None):
    """Tracing is functional, so clone's one obligation is a DISTINCT proxy:
    in-place edits (``__setitem__`` rebinding) on the clone must not follow
    the source object.  The same-dtype convert records a fresh named proxy
    (``torchex`` runs it as a copy)."""
    return prims.convert_element_type(a, a.dtype)


@torchsymbol(_tfn("repeat_interleave"), is_method=True)
def repeat_interleave(a, repeats: int, dim: int):
    dim = utils.canonicalize_dim(a.ndim, dim)
    b = clang.unsqueeze(a, dim + 1)
    target = list(b.shape)
    target[dim + 1] = repeats
    b = clang.expand(b, target)
    shape = list(a.shape)
    shape[dim] *= repeats
    return clang.reshape(b, shape)


@torchsymbol(_tfn("unfold"), is_method=True)
def unfold(a, dimension, size, step):
    return prims.unfold(a, dimension, size, step)


@torchsymbol(_tfn("roll"), is_method=True)
def roll(a, shifts, dims):
    if isinstance(shifts, int):
        shifts = (shifts,)
    if isinstance(dims, int):
        dims = (dims,)
    out = a
    for shift, dim in zip(shifts, dims):
        dim = utils.canonicalize_dim(a.ndim, dim)
        n = out.shape[dim]
        shift = shift % n if n else 0
        if shift == 0:
            continue
        left = clang.slice_in_dim(out, n - shift, n, dim=dim)
        right = clang.slice_in_dim(out, 0, n - shift, dim=dim)
        out = clang.cat([left, right], dim)
    return out


#
# Indexing
#


@torchsymbol(method_name="getitem")
def getitem(a, key):
    return clang.getitem(a, key)


@torchsymbol(method_name="setitem")
def setitem(a, key, value):
    """Functional basic-indexing assignment: returns ``a`` with
    ``a[key] = value``.  ``TensorProxy.__setitem__`` rebinds the Python
    object to this result, which gives in-place semantics under tracing
    (the HF mask-editing pattern ``m[:, :, :, :L] = m2.masked_fill(...)``).

    Supported keys: ints, stride-1 slices, Ellipsis.  Lowering: the value is
    broadcast into the selected region, zero-padded to ``a``'s shape, and
    merged with an iota-derived region mask — static shapes throughout.
    """
    keyt = key if isinstance(key, tuple) else (key,)
    if any(k is Ellipsis for k in keyt):
        i = next(i for i, k in enumerate(keyt) if k is Ellipsis)
        n_spec = sum(1 for k in keyt if k is not Ellipsis)
        keyt = keyt[:i] + (slice(None),) * (a.ndim - n_spec) + keyt[i + 1 :]
    keyt = keyt + (slice(None),) * (a.ndim - len(keyt))
    check(len(keyt) == a.ndim, lambda: f"setitem: too many indices for rank {a.ndim}")

    starts, stops, value_dims = [], [], []
    for d, k in enumerate(keyt):
        n = a.shape[d]
        if isinstance(k, (int, NumberProxy)):
            ki = int(pyval(k) if isinstance(k, NumberProxy) else k)
            ki = ki + n if ki < 0 else ki
            check(0 <= ki < n, lambda: f"setitem: index {ki} out of range for dim {d} (size {n})")
            starts.append(ki)
            stops.append(ki + 1)
        elif isinstance(k, slice):
            start, stop, step = k.indices(n)
            check(step == 1, lambda: "setitem supports stride-1 slices only")
            starts.append(start)
            stops.append(builtins.max(start, stop))
            value_dims.append(d)
        else:
            raise NotImplementedError(
                "setitem supports int/slice/Ellipsis keys; use index_put for tensor indices"
            )
    region = tuple(stops[d] - starts[d] for d in range(a.ndim))

    if isinstance(value, TensorProxy):
        v = clang.maybe_convert_to_dtype(value, a.dtype)
        # torch broadcasting: extra LEADING size-1 dims beyond the selection
        # rank are legal (c[0, :] = ones(1, 8)) — strip them
        while v.ndim > len(value_dims) and v.shape[0] == 1:
            v = clang.reshape(v, v.shape[1:])
        check(
            v.ndim <= len(value_dims),
            lambda: f"setitem: value rank {v.ndim} exceeds selection rank {len(value_dims)}",
        )
        # right-align the value's dims against the sliced dims (torch
        # broadcasting), with int-indexed dims as size-1
        vshape = [1] * a.ndim
        for vd, d in zip(reversed(range(v.ndim)), reversed(value_dims)):
            vshape[d] = v.shape[vd]
        v = clang.reshape(v, tuple(vshape))
        v = clang.expand(v, region)
    else:
        v = clang.full(region, value, device=a.device, dtype=a.dtype)

    pad_cfg = tuple((starts[d], a.shape[d] - stops[d], 0) for d in range(a.ndim))
    v = clang.pad(v, 0, pad_cfg)

    mask = None
    for d in range(a.ndim):
        if starts[d] == 0 and stops[d] == a.shape[d]:
            continue  # full dim: no constraint
        row = clang.arange(0, a.shape[d], device=a.device, dtype=dtypes.int32)
        m = clang.bitwise_and(clang.ge(row, starts[d]), clang.lt(row, stops[d]))
        m = clang.reshape(m, (1,) * d + (a.shape[d],) + (1,) * (a.ndim - d - 1))
        mask = m if mask is None else clang.bitwise_and(mask, m)
    if mask is None:  # whole-tensor assignment
        return v
    return clang.where(mask, v, a)


@torchsymbol(_tfn("index_select"), is_method=True)
def index_select(a, dim, index):
    return clang.take(a, index, dim)


@torchsymbol(_tfn("gather"), is_method=True)
def gather(a, dim, index):
    return clang.gather(a, index, dim)


@torchsymbol(_tfn("scatter_add"), is_method=True)
def scatter_add(a, dim, index, src):
    return clang.scatter_add(a, index, src, dim)


@torchsymbol(_tfn("index_add"), is_method=True)
def index_add(a, dim, index, source):
    return clang.index_add(a, index, source, dim)


@torchsymbol(_tfn("index_put"), is_method=True)
def index_put(a, indices, values, accumulate=False):
    return clang.index_put(a, indices, values, accumulate)


@torchsymbol(_tfn("take_along_dim"), is_method=True)
def take_along_dim(a, indices, dim):
    return clang.take_along_axis(a, indices, dim)


#
# Type conversions
#


@torchsymbol(method_name="to")
def to(a, *args, **kwargs):
    device = kwargs.get("device")
    dtype = kwargs.get("dtype")
    for arg in args:
        if isinstance(arg, (dtypes.dtype, _torch.dtype)):
            dtype = arg
        elif isinstance(arg, (str, Device, _torch.device)):
            try:
                device = to_device(arg)
            except Exception:
                pass
        elif isinstance(arg, TensorProxy):
            dtype, device = arg.dtype, arg.device
    out = a
    if dtype is not None:
        out = clang.maybe_convert_to_dtype(out, _to_thunder_dtype(dtype))
    if device is not None:
        out = clang.device_put(out, device)
    return out


@torchsymbol(method_name="type_as")
def type_as(a, b):
    return clang.maybe_convert_to_dtype(a, b.dtype)


def _conv_method(name, dt):
    def meta(a):
        return clang.maybe_convert_to_dtype(a, dt)

    meta.__name__ = name
    return torchsymbol(method_name=name)(meta)


float_ = _conv_method("float", dtypes.float32)
double = _conv_method("double", dtypes.float64)
half = _conv_method("half", dtypes.float16)
bfloat16_m = _conv_method("bfloat16", dtypes.bfloat16)
long = _conv_method("long", dtypes.int64)
int_ = _conv_method("int", dtypes.int32)
bool_ = _conv_method("bool", dtypes.bool8)


@torchsymbol(method_name="item")
def item(a):
    return clang.item(a)


@torchsymbol(method_name="type")
def type(a, dtype=None):
    if dtype is None:
        return a
    return clang.maybe_convert_to_dtype(a, _to_thunder_dtype(dtype))


#
# Reductions
#


@torchsymbol(_tfn("sum"), is_method=True)
def sum(a, dim=None, keepdim=False, *, dtype=None):
    return clang.sum(a, dim, keepdim, dtype=_to_thunder_dtype(dtype))


@torchsymbol(_tfn("mean"), is_method=True)
def mean(a, dim=None, keepdim=False, *, dtype=None):
    return clang.mean(a, dim, keepdim, dtype=_to_thunder_dtype(dtype))


@torchsymbol(_tfn("prod"), is_method=True)
def prod(a, dim=None, keepdim=False, *, dtype=None):
    return clang.prod(a, dim, keepdim, dtype=_to_thunder_dtype(dtype))


@torchsymbol(_tfn("amax"), is_method=True)
def amax(a, dim=None, keepdim=False):
    return clang.amax(a, dim, keepdim)


@torchsymbol(_tfn("amin"), is_method=True)
def amin(a, dim=None, keepdim=False):
    return clang.amin(a, dim, keepdim)


@torchsymbol(_tfn("max"), is_method=True)
def max(a, dim=None, keepdim=False):
    if dim is None:
        return clang.amax(a, None, False)
    if isinstance(dim, TensorProxy):  # torch.max(a, other): elementwise
        return clang.maximum(a, dim)
    dim = utils.canonicalize_dim(a.ndim, dim)
    values = clang.amax(a, dim, keepdim)
    indices = clang.argmax(a, dim, keepdim)
    return values, indices


@torchsymbol(_tfn("min"), is_method=True)
def min(a, dim=None, keepdim=False):
    if dim is None:
        return clang.amin(a, None, False)
    if isinstance(dim, TensorProxy):  # torch.min(a, other): elementwise
        return clang.minimum(a, dim)
    dim = utils.canonicalize_dim(a.ndim, dim)
    values = clang.amin(a, dim, keepdim)
    indices = clang.argmin(a, dim, keepdim)
    return values, indices


def _correction(correction, unbiased) -> int:
    """torch's two spellings of the divisor: ``correction=`` or the older
    ``unbiased=`` (True: 1, False: 0); the default is 1."""
    check(correction is None or unbiased is None,
          lambda: "var/std take correction= or unbiased=, not both")
    if unbiased is not None:
        return 1 if unbiased else 0
    return 1 if correction is None else correction


@torchsymbol(_tfn("var"), is_method=True)
def var(a, dim=None, keepdim=False, *, correction=None, unbiased=None):
    return clang.var(a, dim, keepdim, correction=_correction(correction, unbiased))


@torchsymbol(_tfn("std"), is_method=True)
def std(a, dim=None, keepdim=False, *, correction=None, unbiased=None):
    return clang.std(a, dim, keepdim, correction=_correction(correction, unbiased))


@torchsymbol(_tfn("var_mean"))
def var_mean(a, dim=None, keepdim=False, *, correction=None, unbiased=None):
    return clang.var_mean(a, dim, keepdim, correction=_correction(correction, unbiased))


@torchsymbol(_tfn("argmax"), is_method=True)
def argmax(a, dim=None, keepdim=False):
    return clang.argmax(a, dim, keepdim)


@torchsymbol(_tfn("argmin"), is_method=True)
def argmin(a, dim=None, keepdim=False):
    return clang.argmin(a, dim, keepdim)


@torchsymbol(_tfn("topk"), is_method=True)
def topk(a, k, dim=-1, largest=True, sorted=True):
    return clang.topk(a, k, dim, largest, sorted)


@torchsymbol(_tfn("sort"), is_method=True)
def sort(a, dim=-1, descending=False):
    return clang.sort(a, dim, descending)


@torchsymbol(_tfn("argsort"), is_method=True)
def argsort(a, dim=-1, descending=False):
    return clang.argsort(a, dim, descending)


@torchsymbol(_tfn("diff"), is_method=True)
def diff(a, n=1, dim=-1, prepend=None, append=None):
    pieces = [x for x in (prepend, a, append) if x is not None]
    if len(pieces) > 1:
        a = clang.cat(pieces, dim)
    for _ in range(n):
        d = a.shape[dim] if dim >= 0 else a.shape[dim + len(a.shape)]
        hi = clang.slice_in_dim(a, 1, d, dim=dim)
        lo = clang.slice_in_dim(a, 0, d - 1, dim=dim)
        a = hi - lo
    return a


@torchsymbol(_tfn("cumsum"), is_method=True)
def cumsum(a, dim, *, dtype=None):
    if dtypes.is_boolean_dtype(a.dtype):
        # a running count: torch sums bools as integers (the reference's
        # jnp.cumsum gives int32, as x64 is off there)
        a = clang.maybe_convert_to_dtype(a, dtypes.int32)
    out = clang.cumsum(a, dim)
    if dtype is not None:
        out = clang.maybe_convert_to_dtype(out, _to_thunder_dtype(dtype))
    return out


@torchsymbol(_tfn("any"), is_method=True)
def any_(a, dim=None, keepdim=False):
    b = _to_bool(a)
    s = clang.sum(clang.maybe_convert_to_dtype(b, dtypes.int32), dim, keepdim)
    return clang.gt(s, 0)


@torchsymbol(_tfn("all"), is_method=True)
def all_(a, dim=None, keepdim=False):
    b = _to_bool(a)
    inv = clang.bitwise_not(b)
    s = clang.sum(clang.maybe_convert_to_dtype(inv, dtypes.int32), dim, keepdim)
    return clang.eq(s, 0)


# torch spells these methods without the trailing underscore
_torch_ctx.register_method("any", any_)
_torch_ctx.register_method("all", all_)


#
# Matmul family
#


@torchsymbol(_tfn("matmul"), is_method=True)
def matmul(a, b):
    return clang.matmul(a, b)


@torchsymbol(_tfn("mm"))
def mm(a, b):
    check(a.ndim == 2 and b.ndim == 2, lambda: "mm requires 2D tensors")
    return clang.matmul(a, b)


@torchsymbol(_tfn("bmm"), is_method=True)
def bmm(a, b):
    check(a.ndim == 3 and b.ndim == 3, lambda: "bmm requires 3D tensors")
    return clang.matmul(a, b)


@torchsymbol(_tfn("addmm"))
def addmm(bias, a, b, *, beta=1, alpha=1):
    out = clang.matmul(a, b)
    if alpha != 1:
        out = clang.mul(out, alpha)
    if beta != 1:
        bias = clang.mul(bias, beta)
    return clang.add(out, bias)


@torchsymbol(_tfn("outer"), is_method=True)
def outer(a, b):
    return clang.mul(clang.reshape(a, (a.shape[0], 1)), clang.reshape(b, (1, b.shape[0])))


#
# NN functional ops
#


@torchsymbol(_tfn("nn", "functional", "linear"))
def linear(a, w, bias=None):
    return clang.linear(a, w, bias)


@torchsymbol(_tfn("nn", "functional", "embedding"))
def embedding(indices, weight, padding_idx=None, max_norm=None, norm_type=2.0, scale_grad_by_freq=False, sparse=False):
    check(max_norm is None, lambda: "embedding max_norm is not supported")
    return clang.embedding(indices, weight, padding_idx=padding_idx)


@torchsymbol(_tfn("nn", "functional", "one_hot"))
def one_hot(a, num_classes):
    return clang.one_hot(a, num_classes)


def _in_float32(fn):
    """Runs an activation's decomposition in float32 for bf16/f16 input and
    rounds its result once, as torch's own kernels (``F.silu``,
    ``F.gelu``...) and the eager path do.  The reference leaves this to XLA,
    which fuses the chain and computes it in float32; the port runs each
    prim as its own torch call, which would round after every step."""

    @functools.wraps(fn)
    def meta(a, *args, **kwargs):
        if isinstance(a, TensorProxy) and dtypes.is_low_precision_dtype(a.dtype):
            out = fn(clang.maybe_convert_to_dtype(a, dtypes.float32), *args, **kwargs)
            return clang.maybe_convert_to_dtype(out, a.dtype)
        return fn(a, *args, **kwargs)

    return meta


@torchsymbol(_tfn("relu"), _tfn("nn", "functional", "relu"), is_method=True)
def relu(a, inplace=False):
    return clang.maximum(a, 0)


@torchsymbol(_tfn("nn", "functional", "relu6"))
def relu6(a, inplace=False):
    return clang.clamp(a, 0, 6)


@torchsymbol(_tfn("nn", "functional", "leaky_relu"))
def leaky_relu(a, negative_slope=0.01, inplace=False):
    return clang.where(clang.gt(a, 0), a, clang.mul(a, negative_slope))


@torchsymbol(_tfn("sigmoid"), _tfn("nn", "functional", "sigmoid"), is_method=True)
@_in_float32
def sigmoid(a):
    return clang.reciprocal(clang.add(clang.exp(clang.neg(a)), 1.0))


@torchsymbol(_tfn("nn", "functional", "softplus"))
@_in_float32
def softplus(a, beta=1.0, threshold=20.0):
    scaled = clang.mul(a, beta)
    soft = clang.true_divide(clang.log1p(clang.exp(scaled)), beta)
    return clang.where(clang.gt(scaled, threshold), a, soft)


@torchsymbol(_tfn("nn", "functional", "silu"))
@_in_float32
def silu(a, inplace=False):
    return clang.mul(a, sigmoid(a))


@torchsymbol(_tfn("nn", "functional", "mish"))
@_in_float32
def mish(a, inplace=False):
    return clang.mul(a, clang.tanh(softplus(a)))


@torchsymbol(_tfn("nn", "functional", "gelu"))
@_in_float32
def gelu(a, approximate: str = "none"):
    check(approximate in ("none", "tanh"),
          lambda: f"gelu: approximate must be 'none' or 'tanh', got {approximate!r}")
    if approximate == "tanh":
        inner = clang.mul(
            math.sqrt(2.0 / math.pi), clang.add(a, clang.mul(0.044715, clang.mul(a, clang.mul(a, a))))
        )
        return clang.mul(clang.mul(0.5, a), clang.add(1.0, clang.tanh(inner)))
    return clang.mul(clang.mul(0.5, a), clang.add(1.0, clang.erf(clang.true_divide(a, math.sqrt(2.0)))))


def _softmax_dim(a, dim):
    """torch's implicit softmax dim when ``dim=None`` reaches the call
    (``torch.nn.functional._get_softmax_dim``)."""
    if dim is not None:
        return dim
    return 0 if a.ndim in (0, 1, 3) else 1


@torchsymbol(_tfn("softmax"), _tfn("nn", "functional", "softmax"), is_method=True)
def softmax(a, dim=-1, *, dtype=None, _stacklevel=3):
    dim = utils.canonicalize_dim(a.ndim, _softmax_dim(a, dim))
    computation_dtype = _to_thunder_dtype(dtype) or (dtypes.float32 if dtypes.is_low_precision_dtype(a.dtype) else a.dtype)
    a_ = clang.maybe_convert_to_dtype(a, computation_dtype)
    m = clang.amax(a_, dim, True)
    e = clang.exp(clang.sub(a_, m))
    s = clang.sum(e, dim, True)
    out = clang.true_divide(e, s)
    if dtype is None:
        out = clang.maybe_convert_to_dtype(out, a.dtype)
    return out


@torchsymbol(_tfn("log_softmax"), _tfn("nn", "functional", "log_softmax"), is_method=True)
def log_softmax(a, dim=-1, *, dtype=None, _stacklevel=3):
    dim = utils.canonicalize_dim(a.ndim, _softmax_dim(a, dim))
    computation_dtype = _to_thunder_dtype(dtype) or (dtypes.float32 if dtypes.is_low_precision_dtype(a.dtype) else a.dtype)
    a_ = clang.maybe_convert_to_dtype(a, computation_dtype)
    m = clang.amax(a_, dim, True)
    shifted = clang.sub(a_, m)
    lse = clang.log(clang.sum(clang.exp(shifted), dim, True))
    out = clang.sub(shifted, lse)
    if dtype is None:
        out = clang.maybe_convert_to_dtype(out, a.dtype)
    return out


@torchsymbol(_tfn("nn", "functional", "dropout"))
def dropout(a, p=0.5, training=True, inplace=False):
    if not training or p == 0.0:
        return a
    check(0.0 <= p < 1.0, lambda: f"dropout p must be in [0, 1), got {p}")
    mask = clang.bernoulli(1.0 - p, a.shape, device=a.device, dtype=a.dtype)
    return clang.mul(clang.mul(a, mask), 1.0 / (1.0 - p))


@torchsymbol(_tfn("nn", "functional", "layer_norm"))
def layer_norm(a, normalized_shape, weight=None, bias=None, eps=1e-5):
    normalized_shape = tuple(normalized_shape)
    ndims = len(normalized_shape)
    check(
        tuple(a.shape[a.ndim - ndims :]) == normalized_shape,
        lambda: f"layer_norm: {normalized_shape} does not match input tail {a.shape}",
    )
    dims = tuple(range(a.ndim - ndims, a.ndim))
    computation_dtype = dtypes.float32 if dtypes.is_low_precision_dtype(a.dtype) else a.dtype
    a_ = clang.maybe_convert_to_dtype(a, computation_dtype)
    v, m = clang.var_mean(a_, dims, True, correction=0)
    rstd = clang.rsqrt(clang.add(v, eps))
    out = clang.mul(clang.sub(a_, m), rstd)
    if weight is not None:
        out = clang.mul(out, clang.maybe_convert_to_dtype(weight, computation_dtype))
    if bias is not None:
        out = clang.add(out, clang.maybe_convert_to_dtype(bias, computation_dtype))
    return clang.maybe_convert_to_dtype(out, a.dtype)


@torchsymbol(_tfn("nn", "functional", "rms_norm"))
def rms_norm(a, normalized_shape, weight=None, eps=None):
    normalized_shape = tuple(normalized_shape)
    ndims = len(normalized_shape)
    dims = tuple(range(a.ndim - ndims, a.ndim))
    if eps is None:
        eps = 1e-6
    computation_dtype = dtypes.float32 if dtypes.is_low_precision_dtype(a.dtype) else a.dtype
    a_ = clang.maybe_convert_to_dtype(a, computation_dtype)
    ms = clang.mean(clang.mul(a_, a_), dims, True)
    out = clang.mul(a_, clang.rsqrt(clang.add(ms, eps)))
    if weight is not None:
        out = clang.mul(out, clang.maybe_convert_to_dtype(weight, computation_dtype))
    return clang.maybe_convert_to_dtype(out, a.dtype)


@torchsymbol(_tfn("nn", "functional", "group_norm"))
def group_norm(a, num_groups, weight=None, bias=None, eps=1e-5):
    check(a.ndim >= 2, lambda: "group_norm requires at least 2 dims")
    N, C = a.shape[0], a.shape[1]
    check(C % num_groups == 0, lambda: "group_norm: channels not divisible by groups")
    rest = a.shape[2:]
    grouped = clang.reshape(a, (N, num_groups, C // num_groups) + tuple(rest))
    dims = tuple(range(2, grouped.ndim))
    computation_dtype = dtypes.float32 if dtypes.is_low_precision_dtype(a.dtype) else a.dtype
    g = clang.maybe_convert_to_dtype(grouped, computation_dtype)
    v, m = clang.var_mean(g, dims, True, correction=0)
    out = clang.mul(clang.sub(g, m), clang.rsqrt(clang.add(v, eps)))
    out = clang.reshape(out, a.shape)
    if weight is not None:
        w = clang.reshape(weight, (1, C) + (1,) * len(rest))
        out = clang.mul(out, clang.maybe_convert_to_dtype(w, computation_dtype))
    if bias is not None:
        b = clang.reshape(bias, (1, C) + (1,) * len(rest))
        out = clang.add(out, clang.maybe_convert_to_dtype(b, computation_dtype))
    return clang.maybe_convert_to_dtype(out, a.dtype)


@torchsymbol(_tfn("nn", "functional", "batch_norm"))
def batch_norm(a, running_mean=None, running_var=None, weight=None, bias=None, training=False, momentum=0.1, eps=1e-5):
    C = a.shape[1]
    reduce_dims = (0,) + tuple(range(2, a.ndim))
    computation_dtype = dtypes.float32 if dtypes.is_low_precision_dtype(a.dtype) else a.dtype
    a_ = clang.maybe_convert_to_dtype(a, computation_dtype)
    if training or running_mean is None:
        v, m = clang.var_mean(a_, reduce_dims, False, correction=0)
    else:
        m, v = running_mean, running_var
    bshape = (1, C) + (1,) * (a.ndim - 2)
    m_ = clang.reshape(clang.maybe_convert_to_dtype(m, computation_dtype), bshape)
    v_ = clang.reshape(clang.maybe_convert_to_dtype(v, computation_dtype), bshape)
    out = clang.mul(clang.sub(a_, m_), clang.rsqrt(clang.add(v_, eps)))
    if weight is not None:
        out = clang.mul(out, clang.reshape(clang.maybe_convert_to_dtype(weight, computation_dtype), bshape))
    if bias is not None:
        out = clang.add(out, clang.reshape(clang.maybe_convert_to_dtype(bias, computation_dtype), bshape))
    return clang.maybe_convert_to_dtype(out, a.dtype)


@torchsymbol(_tfn("conv1d"), _tfn("nn", "functional", "conv1d"))
def conv1d(a, weight, bias=None, stride=1, padding=0, dilation=1, groups=1):
    return _convnd(a, weight, bias, stride, padding, dilation, groups, 1)


@torchsymbol(_tfn("conv2d"), _tfn("nn", "functional", "conv2d"))
def conv2d(a, weight, bias=None, stride=1, padding=0, dilation=1, groups=1):
    return _convnd(a, weight, bias, stride, padding, dilation, groups, 2)


@torchsymbol(_tfn("conv3d"), _tfn("nn", "functional", "conv3d"))
def conv3d(a, weight, bias=None, stride=1, padding=0, dilation=1, groups=1):
    return _convnd(a, weight, bias, stride, padding, dilation, groups, 3)


def _convnd(a, weight, bias, stride, padding, dilation, groups, n):
    def _tup(x):
        return (x,) * n if isinstance(x, int) else tuple(x)

    return prims.convolution(a, weight, bias, _tup(stride), _tup(padding), _tup(dilation), False, (0,) * n, int(groups))


@torchsymbol(_tfn("nn", "functional", "scaled_dot_product_attention"))
def scaled_dot_product_attention(
    query, key, value, attn_mask=None, dropout_p=0.0, is_causal=False, scale=None, enable_gqa=False,
    sliding_window=None,
):
    """SDPA decomposition into the SDPA prim, which the cuda executor claims
    with the flash kernels (``cuda_sdpa``) where ``cudaex.flash_supported``
    holds (analog of reference sdpaex/cudnnex claiming).

    Masked (bool or additive-float ``attn_mask``) and grouped-query
    (``enable_gqa`` / fewer K/V heads) calls route through the fused prim too
    — boolean masks are canonicalized to an additive float bias first, so HF
    padding-mask models keep O(T) attention residuals (reference checker
    matrix: sdpaex.py:240-474).  Only dropout and mask-needs-grad fall back
    to the explicit decomposition.
    """
    d = query.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if is_causal:
        check(attn_mask is None, lambda: "is_causal and attn_mask are mutually exclusive")
    gqa_ok = query.shape[:-2] == key.shape[:-2] == value.shape[:-2] or (
        query.ndim >= 3
        and key.ndim >= 3
        and key.shape[:-2] == value.shape[:-2]
        and query.shape[:-3] == key.shape[:-3]
        and key.shape[-3] != 0
        and query.shape[-3] % key.shape[-3] == 0
    )
    mask_ok = attn_mask is None or not getattr(attn_mask, "requires_grad", False)
    if dropout_p == 0.0 and gqa_ok and mask_ok:
        mask = attn_mask
        if mask is not None and dtypes.is_boolean_dtype(mask.dtype):
            # additive form: 0 where attended, a large-negative (not -inf:
            # exp(finite - lse) underflows to 0 without the inf-inf NaN) where
            # masked — matches the kernels' _MASK_VALUE convention
            zeros = clang.full_like(mask, 0.0, dtype=dtypes.float32)
            mask = clang.where(mask, zeros, -0.7 * 3.4028235e38)  # -0.7 * f32 max
        elif mask is not None:
            mask = clang.maybe_convert_to_dtype(mask, dtypes.float32)
        out, _lse = prims.sdpa(
            query, key, value, mask, bool(is_causal), float(scale),
            None if sliding_window is None else int(sliding_window),
        )
        return out
    check(
        sliding_window is None,
        lambda: "sliding_window is only supported on the fused sdpa path "
                "(no dropout, mask without requires_grad)",
    )
    if enable_gqa and query.shape[-3] != key.shape[-3]:
        rep = query.shape[-3] // key.shape[-3]
        key = repeat_interleave(key, rep, dim=-3)
        value = repeat_interleave(value, rep, dim=-3)
    q = clang.mul(query, scale)
    kt = clang.transpose(key, -2, -1)
    scores = clang.matmul(q, kt)
    L, S = query.shape[-2], key.shape[-2]
    if is_causal:
        check(attn_mask is None, lambda: "is_causal and attn_mask are mutually exclusive")
        row = clang.arange(0, L, device=query.device, dtype=dtypes.int32)
        col = clang.arange(0, S, device=query.device, dtype=dtypes.int32)
        causal = clang.ge(clang.reshape(row, (L, 1)), clang.reshape(col, (1, S)))
        scores = clang.where(causal, scores, float("-inf"))
    elif attn_mask is not None:
        if dtypes.is_boolean_dtype(attn_mask.dtype):
            scores = clang.where(attn_mask, scores, float("-inf"))
        else:
            scores = clang.add(scores, attn_mask)
    probs = softmax(scores, -1)
    if dropout_p > 0.0:
        probs = dropout(probs, dropout_p, training=True)
    return clang.matmul(probs, value)


@torchsymbol(_tfn("nn", "functional", "nll_loss"))
def nll_loss(log_probs, target, weight=None, size_average=None, ignore_index=-100, reduce=None, reduction="mean"):
    check(size_average is None and reduce is None, lambda: "legacy size_average/reduce are not supported; use reduction=")
    C = log_probs.shape[-1]
    flat_logp = clang.reshape(log_probs, (-1, C))
    flat_t = clang.reshape(target, (-1,))
    safe_t = clang.where(clang.eq(flat_t, ignore_index), 0, flat_t)
    safe_t = clang.maybe_convert_to_dtype(safe_t, dtypes.int32)
    idx = clang.reshape(safe_t, (-1, 1))
    picked = clang.take_along_axis(flat_logp, idx, 1)
    picked = clang.reshape(picked, (-1,))
    losses = clang.neg(picked)
    valid = clang.ne(flat_t, ignore_index)
    if weight is not None:
        # torch: per-sample loss scaled by weight[target]; mean divides by the
        # summed weights of the non-ignored samples
        w = clang.take(weight, safe_t, 0)
        losses = clang.mul(losses, w)
        norm = clang.where(valid, w, 0.0)
    else:
        norm = clang.maybe_convert_to_dtype(valid, losses.dtype)
    losses = clang.where(valid, losses, 0.0)
    if reduction == "none":
        return clang.reshape(losses, target.shape)
    total = clang.sum(losses, None, False)
    if reduction == "sum":
        return total
    return clang.true_divide(total, clang.maximum(clang.sum(norm, None, False), 1e-12))


@torchsymbol(_tfn("nn", "functional", "cross_entropy"))
def cross_entropy(logits, target, weight=None, size_average=None, ignore_index=-100, reduce=None, reduction="mean", label_smoothing=0.0):
    check(size_average is None and reduce is None, lambda: "legacy size_average/reduce are not supported; use reduction=")
    # fast path: fused row-wise CE prim (no (N, C) log-prob residual saved for
    # backward).  Class-index targets with the standard 2D/1D layouts only
    if (
        weight is None
        and label_smoothing == 0.0
        and reduction in ("mean", "sum", "none")
        and logits.ndim == 2
        and target.ndim == 1
        and dtypes.is_exact_dtype(target.dtype)
    ):
        safe_t = clang.where(clang.eq(target, ignore_index), 0, target)
        losses, _lse = prims.cross_entropy_fwd(logits, clang.maybe_convert_to_dtype(safe_t, dtypes.int32))
        valid = clang.ne(target, ignore_index)
        losses = clang.where(valid, losses, 0.0)
        # reductions accumulate in the prim's float32 row losses (torch keeps
        # f32 accumulation for low-precision logits); only the result is cast
        out_dtype = logits.dtype if dtypes.is_inexact_dtype(logits.dtype) else dtypes.float32
        if reduction == "none":
            return clang.maybe_convert_to_dtype(losses, out_dtype)
        total = clang.sum(losses, None, False)
        if reduction == "sum":
            return clang.maybe_convert_to_dtype(total, out_dtype)
        n_valid = clang.sum(clang.maybe_convert_to_dtype(valid, losses.dtype), None, False)
        mean = clang.true_divide(total, clang.maximum(n_valid, 1.0))
        return clang.maybe_convert_to_dtype(mean, out_dtype)
    dim = -1 if logits.ndim != 1 else 0
    if logits.ndim > 2:
        # torch layout: (N, C, d1, ...) -> log_softmax over C, move C last
        logp = log_softmax(logits, 1)
        perm = (0,) + tuple(range(2, logits.ndim)) + (1,)
        logp = clang.permute(logp, perm)
    else:
        logp = log_softmax(logits, dim)
    nll = nll_loss(logp, target, weight, ignore_index=ignore_index, reduction=reduction)
    if label_smoothing == 0.0:
        return nll
    # label smoothing (torch aten cross_entropy_loss_label_smoothing):
    # smooth_i = -sum_c w_c * logp[i, c]; final = (1-ls)*nll + ls/C * smooth
    C = logp.shape[-1]
    wl = clang.mul(logp, clang.reshape(weight, (1,) * (logp.ndim - 1) + (C,))) if weight is not None else logp
    smooth = clang.neg(clang.sum(wl, -1, False))
    flat_t = clang.reshape(target, (-1,))
    valid = clang.ne(flat_t, ignore_index)
    smooth = clang.where(clang.reshape(valid, smooth.shape), smooth, 0.0)
    if reduction == "sum":
        smooth_ret = clang.sum(smooth, None, False)
    elif reduction == "mean":
        if weight is not None:
            safe_t = clang.maybe_convert_to_dtype(clang.where(valid, flat_t, 0), dtypes.int32)
            norm = clang.where(valid, clang.take(weight, safe_t, 0), 0.0)
        else:
            norm = clang.maybe_convert_to_dtype(valid, smooth.dtype)
        smooth_ret = clang.true_divide(clang.sum(smooth, None, False), clang.maximum(clang.sum(norm, None, False), 1e-12))
    else:
        smooth_ret = smooth
    return clang.add(clang.mul(nll, 1.0 - label_smoothing), clang.mul(smooth_ret, label_smoothing / C))


@torchsymbol()
def fused_linear_cross_entropy(h, weight, target, ignore_index=-100, reduction="mean"):
    """Fused lm-head linear + cross-entropy: ``cross_entropy(h @ weight.T, target)``
    without materializing the (N, V) logits (thunder extension; the
    Liger-kernel-class capability — the reference's apex/triton CE executors
    take materialized logits, apex_entropyex.py:15).  Backward saves
    (h, weight, target, lse) and recomputes the softmax chunkwise.
    """
    check(h.ndim == 2, lambda: f"fused_linear_cross_entropy: h must be 2D, got {h.ndim}D")
    check(reduction in ("mean", "sum", "none"), lambda: f"unsupported reduction {reduction!r}")
    # ignore_index lives in ONE layer: the prim (executors mask both the row
    # losses and the backward's row cotangents); raw targets pass through.
    # The loss stays float32 regardless of h's dtype — the matmul accumulates
    # f32 and the plain gpt_loss path (CE over f32 logits) returns f32 too.
    losses, _lse = prims.fused_linear_ce(
        h, weight, clang.maybe_convert_to_dtype(target, dtypes.int32), int(ignore_index)
    )
    if reduction == "none":
        return losses
    total = clang.sum(losses, None, False)
    if reduction == "sum":
        return total
    valid = clang.ne(target, ignore_index)
    n_valid = clang.sum(clang.maybe_convert_to_dtype(valid, losses.dtype), None, False)
    return clang.true_divide(total, clang.maximum(n_valid, 1.0))


def _check_legacy_reduction(size_average, reduce) -> None:
    check(size_average is None and reduce is None,
          lambda: "legacy size_average/reduce are not supported; use reduction=")


def _weighted(loss, weight):
    """torch's per-element loss ``weight`` (``mse_loss``/``l1_loss``/
    ``huber_loss``), applied before the reduction."""
    return loss if weight is None else clang.mul(loss, weight)


@torchsymbol(_tfn("nn", "functional", "mse_loss"))
def mse_loss(a, b, size_average=None, reduce=None, reduction="mean", weight=None):
    _check_legacy_reduction(size_average, reduce)
    d = clang.sub(a, b)
    sq = _weighted(clang.mul(d, d), weight)
    if reduction == "none":
        return sq
    if reduction == "sum":
        return clang.sum(sq, None, False)
    return clang.mean(sq, None, False)


@torchsymbol(_tfn("nn", "functional", "l1_loss"))
def l1_loss(a, b, size_average=None, reduce=None, reduction="mean", weight=None):
    _check_legacy_reduction(size_average, reduce)
    d = _weighted(clang.abs(clang.sub(a, b)), weight)
    if reduction == "none":
        return d
    if reduction == "sum":
        return clang.sum(d, None, False)
    return clang.mean(d, None, False)


def _smooth_l1(a, b, beta):
    d = clang.sub(a, b)
    ad = clang.abs(d)
    quad = clang.true_divide(clang.mul(clang.mul(d, d), 0.5), beta)
    lin = clang.sub(ad, 0.5 * beta)
    return clang.where(clang.lt(ad, beta), quad, lin)


@torchsymbol(_tfn("nn", "functional", "smooth_l1_loss"))
def smooth_l1_loss(a, b, size_average=None, reduce=None, reduction="mean", beta=1.0):
    _check_legacy_reduction(size_average, reduce)
    if beta == 0.0:
        return l1_loss(a, b, reduction)
    out = _smooth_l1(a, b, beta)
    if reduction == "none":
        return out
    if reduction == "sum":
        return clang.sum(out, None, False)
    return clang.mean(out, None, False)


@torchsymbol(_tfn("nn", "functional", "huber_loss"))
def huber_loss(a, b, reduction="mean", delta=1.0, weight=None):
    # huber = delta * smooth_l1(beta=delta)
    out = _weighted(clang.mul(_smooth_l1(a, b, delta), delta), weight)
    if reduction == "none":
        return out
    if reduction == "sum":
        return clang.sum(out, None, False)
    return clang.mean(out, None, False)


@torchsymbol(_tfn("nn", "functional", "binary_cross_entropy"))
def binary_cross_entropy(a, target, weight=None, size_average=None, reduce=None, reduction="mean"):
    check(size_average is None and reduce is None, lambda: "legacy size_average/reduce are not supported; use reduction=")
    # torch clamps each log term at -100
    log_a = clang.maximum(clang.log(a), -100.0)
    log_1ma = clang.maximum(clang.log(clang.sub(1.0, a)), -100.0)
    out = clang.neg(clang.add(clang.mul(target, log_a), clang.mul(clang.sub(1.0, target), log_1ma)))
    if weight is not None:
        out = clang.mul(out, weight)
    if reduction == "none":
        return out
    if reduction == "sum":
        return clang.sum(out, None, False)
    return clang.mean(out, None, False)


@torchsymbol(_tfn("nn", "functional", "binary_cross_entropy_with_logits"))
def binary_cross_entropy_with_logits(a, target, weight=None, size_average=None, reduce=None, reduction="mean", pos_weight=None):
    check(size_average is None and reduce is None, lambda: "legacy size_average/reduce are not supported; use reduction=")
    # stable: max(x,0) - x*t + log1p(exp(-|x|)); pos_weight scales the t term
    softplus_nabs = clang.log1p(clang.exp(clang.neg(clang.abs(a))))
    if pos_weight is not None:
        # torch aten: loss = (1-t)·x + lw·(log1p(exp(-|x|)) + max(-x, 0)),
        # lw = 1 + (pos_weight - 1)·t
        log_w = clang.add(clang.mul(clang.sub(pos_weight, 1.0), target), 1.0)
        out = clang.add(
            clang.mul(clang.sub(1.0, target), a),
            clang.mul(log_w, clang.add(softplus_nabs, clang.maximum(clang.neg(a), 0.0))),
        )
    else:
        out = clang.add(clang.sub(clang.maximum(a, 0.0), clang.mul(a, target)), softplus_nabs)
    if weight is not None:
        out = clang.mul(out, weight)
    if reduction == "none":
        return out
    if reduction == "sum":
        return clang.sum(out, None, False)
    return clang.mean(out, None, False)


@torchsymbol(_tfn("nn", "functional", "kl_div"))
def kl_div(a, target, size_average=None, reduce=None, reduction="mean", log_target=False):
    check(size_average is None and reduce is None, lambda: "legacy size_average/reduce are not supported; use reduction=")
    if log_target:
        out = clang.mul(clang.exp(target), clang.sub(target, a))
    else:
        # torch zeroes the contribution where target == 0 (0·log0 := 0)
        safe = clang.where(clang.gt(target, 0), target, 1.0)
        out = clang.where(
            clang.gt(target, 0), clang.mul(target, clang.sub(clang.log(safe), a)), 0.0
        )
    if reduction == "none":
        return out
    total = clang.sum(out, None, False)
    if reduction == "sum":
        return total
    if reduction == "batchmean":
        return clang.true_divide(total, a.shape[0])
    return clang.mean(out, None, False)


@torchsymbol(_tfn("nn", "functional", "pad"))
def nn_pad(a, pad_widths, mode="constant", value=0.0):
    check(mode == "constant", lambda: "only constant padding is supported")
    check(len(pad_widths) % 2 == 0, lambda: "pad widths must be pairs")
    npairs = len(pad_widths) // 2
    config = [(0, 0, 0)] * (a.ndim - npairs)
    for i in range(npairs):
        lo = pad_widths[2 * i]
        hi = pad_widths[2 * i + 1]
        config.append((lo, hi, 0))
    # torch pads last dims first
    config = config[: a.ndim - npairs] + list(reversed(config[a.ndim - npairs :]))
    return clang.pad(a, value if value is not None else 0.0, config)


@torchsymbol(_tfn("nn", "functional", "normalize"))
def normalize(a, p=2.0, dim=1, eps=1e-12, out=None):
    check(out is None, lambda: "normalize: out= is not supported (traces are functional)")
    norm = clang.pow(clang.sum(clang.pow(clang.abs(a), p), dim, True), 1.0 / p)
    return clang.true_divide(a, clang.maximum(norm, eps))


@torchsymbol(_tfn("erf"), id="torch.special.erf")
def special_erf(a):
    return clang.erf(a)


@torchsymbol(_tfn("polar"))
def polar(abs_t, angle):
    real = clang.mul(abs_t, clang.cos(angle))
    imag = clang.mul(abs_t, clang.sin(angle))
    return real, imag


@torchsymbol(_tfn("sgn"), is_method=True)
def sgn(a):
    return clang.sign(a)


@torchsymbol(_tfn("square"), is_method=True)
def square(a):
    return clang.mul(a, a)


@torchsymbol(_tfn("nn", "functional", "glu"))
@_in_float32
def glu(a, dim=-1):
    dim = utils.canonicalize_dim(a.ndim, dim)
    check(a.shape[dim] % 2 == 0, lambda: "glu: dim size must be even")
    x, g = clang.chunk(a, 2, dim)
    return clang.mul(x, sigmoid(g))


@torchsymbol(_tfn("lerp"), is_method=True)
def lerp(start, end, weight):
    return clang.add(start, clang.mul(clang.sub(end, start), weight))


@torchsymbol(_tfn("nn", "functional", "hardswish"))
def hardswish(a, inplace=False):
    return clang.mul(a, clang.true_divide(clang.clamp(clang.add(a, 3.0), 0.0, 6.0), 6.0))


@torchsymbol(_tfn("nn", "functional", "hardsigmoid"))
def hardsigmoid(a, inplace=False):
    return clang.true_divide(clang.clamp(clang.add(a, 3.0), 0.0, 6.0), 6.0)


@torchsymbol(_tfn("nn", "functional", "tanhshrink"))
def tanhshrink(a):
    return clang.sub(a, clang.tanh(a))


@torchsymbol(_tfn("nn", "functional", "elu"))
@_in_float32
def elu(a, alpha=1.0, inplace=False):
    return clang.where(clang.gt(a, 0), a, clang.mul(alpha, clang.expm1(a)))


@torchsymbol(_tfn("nn", "functional", "selu"))
@_in_float32
def selu(a, inplace=False):
    alpha = 1.6732632423543772
    scale = 1.0507009873554805
    return clang.mul(scale, clang.where(clang.gt(a, 0), a, clang.mul(alpha, clang.expm1(a))))


@torchsymbol(_tfn("nn", "functional", "celu"))
@_in_float32
def celu(a, alpha=1.0, inplace=False):
    return clang.where(clang.gt(a, 0), a, clang.mul(alpha, clang.expm1(clang.true_divide(a, alpha))))


@torchsymbol(_tfn("nn", "functional", "hardtanh"))
def hardtanh(a, min_val=-1.0, max_val=1.0, inplace=False):
    return clang.clamp(a, min_val, max_val)


@torchsymbol(_tfn("nn", "functional", "logsigmoid"))
@_in_float32
def logsigmoid(a):
    return clang.neg(softplus(clang.neg(a)))


@torchsymbol(_tfn("logsumexp"), is_method=True)
def logsumexp(a, dim, keepdim=False):
    computation_dtype = dtypes.float32 if dtypes.is_low_precision_dtype(a.dtype) else a.dtype
    af = clang.maybe_convert_to_dtype(a, computation_dtype)
    m = clang.amax(af, dim, True)
    # masked-out -inf rows: keep the max finite so exp(-inf - -inf) never NaNs
    m_safe = clang.where(clang.isfinite(m), m, 0.0)
    s = clang.sum(clang.exp(clang.sub(af, m_safe)), dim, keepdim)
    m_out = m if keepdim else clang.squeeze(m, (utils.canonicalize_dim(a.ndim, dim),))
    out = clang.add(clang.log(s), clang.where(clang.isfinite(m_out), m_out, 0.0))
    return clang.maybe_convert_to_dtype(out, a.dtype)


@torchsymbol(_tfn("logaddexp"), is_method=True)
def logaddexp(a, b):
    m = clang.maximum(a, b)
    stable = clang.add(m, clang.log1p(clang.exp(clang.neg(clang.abs(clang.sub(a, b))))))
    # equal infinities: a-b is NaN there, but the result is the infinity
    # itself (torch semantics: logaddexp(-inf, -inf) = -inf)
    inf_pair = logical_and(clang.isinf(a), clang.eq(a, b))
    return clang.where(inf_pair, a, stable)


@torchsymbol(_tfn("nan_to_num"), is_method=True)
def nan_to_num(a, nan=0.0, posinf=None, neginf=None):
    if dtypes.is_exact_dtype(a.dtype):
        return a
    big = float(torch.finfo(dtypes.to_torch_dtype(a.dtype)).max)
    out = clang.where(clang.isnan(a), nan if nan is not None else 0.0, a)
    out = clang.where(clang.eq(out, float("inf")), posinf if posinf is not None else big, out)
    out = clang.where(clang.eq(out, float("-inf")), neginf if neginf is not None else -big, out)
    return out


@torchsymbol(_tfn("cumprod"), is_method=True)
def cumprod(a, dim, *, dtype=None):
    # torch casts the INPUT before accumulating — the dtype kwarg exists to
    # buy accumulation precision, not to cast the result
    if dtype is not None:
        a = clang.maybe_convert_to_dtype(a, _to_thunder_dtype(dtype))
    return clang.cumprod(a, utils.canonicalize_dim(a.ndim, dim))


@torchsymbol(_tfn("heaviside"), is_method=True)
def heaviside(a, values):
    # NaN maps to 0 in torch (only exact zero selects `values`)
    return clang.where(clang.eq(a, 0), values, clang.where(clang.gt(a, 0), 1.0, 0.0))


@torchsymbol(_tfn("hypot"), is_method=True)
def hypot(a, b):
    # scale-safe (torch.hypot contract): factor out the larger magnitude so
    # squaring can neither overflow (~1e20 inputs) nor flush subnormals
    aa, ab = clang.abs(a), clang.abs(b)
    m = clang.maximum(aa, ab)
    n = clang.minimum(aa, ab)
    r = clang.true_divide(n, clang.where(clang.eq(m, 0.0), 1.0, m))
    return clang.mul(m, clang.sqrt(clang.add(1.0, clang.mul(r, r))))


@torchsymbol(_tfn("clamp_min"), is_method=True)
def clamp_min(a, min):
    return clang.maximum(a, min)


@torchsymbol(_tfn("clamp_max"), is_method=True)
def clamp_max(a, max):
    return clang.minimum(a, max)


@torchsymbol(_tfn("addcmul"), is_method=True)
def addcmul(a, t1, t2, *, value=1):
    return clang.add(a, clang.mul(clang.mul(t1, t2), value))


@torchsymbol(_tfn("addcdiv"), is_method=True)
def addcdiv(a, t1, t2, *, value=1):
    return clang.add(a, clang.mul(clang.true_divide(t1, t2), value))


@torchsymbol(_tfn("frac"), is_method=True)
def frac(a):
    return clang.sub(a, clang.trunc(a))


@torchsymbol(_tfn("norm"), is_method=True)
def norm(a, p=2, dim=None, keepdim=False, out=None, dtype=None):
    check(out is None, lambda: "norm: out= is not supported (traces are functional)")
    if dtype is not None:
        a = clang.maybe_convert_to_dtype(a, _to_thunder_dtype(dtype))
    check(p in (1, 2, "fro", float("inf")), lambda: f"norm: order {p!r} is not supported yet")
    if p == 1:
        return clang.sum(clang.abs(a), dim, keepdim)
    if p == float("inf"):
        return clang.amax(clang.abs(a), dim, keepdim)
    # 2 / fro
    return clang.sqrt(clang.sum(clang.mul(a, a), dim, keepdim))


@torchsymbol(_tfn("nn", "functional", "softmin"))
def softmin(a, dim=-1, *, dtype=None, _stacklevel=3):
    return softmax(clang.neg(a), dim, dtype=dtype)


@torchsymbol(_tfn("nn", "functional", "softshrink"))
def softshrink(a, lambd=0.5):
    return clang.where(
        clang.gt(a, lambd), clang.sub(a, lambd), clang.where(clang.lt(a, -lambd), clang.add(a, lambd), 0.0)
    )


@torchsymbol(_tfn("nn", "functional", "hardshrink"))
def hardshrink(a, lambd=0.5):
    return clang.where(clang.gt(clang.abs(a), lambd), a, 0.0)


@torchsymbol(_tfn("nn", "functional", "threshold"))
def threshold(a, threshold, value, inplace=False):
    return clang.where(clang.gt(a, threshold), a, value)


@torchsymbol(_tfn("nn", "functional", "prelu"))
def prelu(a, weight):
    if weight.numel != 1:
        check(a.ndim >= 2, lambda: "prelu: per-channel weight needs a channel dim")
        check(weight.numel == a.shape[1], lambda: f"prelu: weight numel {weight.numel} != channels {a.shape[1]}")
        w = clang.reshape(weight, (1, weight.numel) + (1,) * (a.ndim - 2))
    else:
        w = clang.reshape(weight, (1,) * a.ndim)
    return clang.where(clang.ge(a, 0), a, clang.mul(w, a))


@torchsymbol(_tfn("nn", "functional", "cosine_similarity"))
def cosine_similarity(x1, x2, dim=1, eps=1e-8):
    dot = clang.sum(clang.mul(x1, x2), dim, False)
    n1 = clang.sqrt(clang.sum(clang.mul(x1, x1), dim, False))
    n2 = clang.sqrt(clang.sum(clang.mul(x2, x2), dim, False))
    return clang.true_divide(dot, clang.maximum(clang.mul(n1, n2), eps))


#
# einsum / extra linalg (reference: thunder/torch/__init__.py einsum via opt_einsum;
# here a single EINSUM prim, which torchex runs as one torch.einsum)
#


@torchsymbol(_tfn("einsum"))
def einsum(equation, *operands):
    if len(operands) == 1 and isinstance(operands[0], (tuple, list)):
        operands = tuple(operands[0])
    check(isinstance(equation, str), lambda: "einsum: only the string-equation form is supported")
    return prims.einsum(equation, *operands)


@torchsymbol(_tfn("mv"), is_method=True)
def mv(a, b):
    check(a.ndim == 2 and b.ndim == 1, lambda: f"mv: expected (n,m) @ (m,), got {a.shape} @ {b.shape}")
    return clang.matmul(a, b)


@torchsymbol(_tfn("dot"), is_method=True)
def dot(a, b):
    check(a.ndim == 1 and b.ndim == 1, lambda: f"dot: expected 1D tensors, got {a.shape} and {b.shape}")
    return clang.sum(clang.mul(a, b), None, False)


@torchsymbol(_tfn("vdot"))
def vdot(a, b):
    return dot(a, b)


@torchsymbol(_tfn("baddbmm"), is_method=True)
def baddbmm(input, batch1, batch2, *, beta=1, alpha=1):
    out = clang.matmul(batch1, batch2)
    if alpha != 1:
        out = clang.mul(out, alpha)
    if beta == 0:
        return out
    return clang.add(out, clang.mul(input, beta) if beta != 1 else input)


@torchsymbol(_tfn("unbind"), is_method=True)
def unbind(a, dim=0):
    dim = utils.canonicalize_dim(a.ndim, dim)
    return tuple(clang.squeeze(clang.slice_in_dim(a, i, i + 1, dim=dim), (dim,)) for i in range(a.shape[dim]))


@torchsymbol(_tfn("diagonal"), is_method=True)
def diagonal(a, offset=0, dim1=0, dim2=1):
    dim1 = utils.canonicalize_dim(a.ndim, dim1)
    dim2 = utils.canonicalize_dim(a.ndim, dim2)
    check(a.ndim == 2 and (dim1, dim2) == (0, 1), lambda: "diagonal: only 2D (dim1=0, dim2=1) is supported yet")
    rows, cols = a.shape
    if offset >= 0:
        length = builtins.min(rows, cols - offset)
        start = offset
    else:
        length = builtins.min(rows + offset, cols)
        start = -offset * cols
    check(length > 0, lambda: f"diagonal: offset {offset} out of range for shape {a.shape}")
    flat = clang.reshape(a, (rows * cols,))
    idx = clang.arange(start, start + length * (cols + 1), cols + 1, device=a.device, dtype=dtypes.int32)
    return clang.take(flat, idx, 0)


_diagonal_op = diagonal


@torchsymbol(_tfn("diag"), is_method=True)
def diag(a, diagonal=0):
    check(a.ndim in (1, 2), lambda: f"diag: expected 1D or 2D, got {a.ndim}D")
    if a.ndim == 2:
        return _diagonal_op(a, diagonal)
    n = a.shape[0] + builtins.abs(diagonal)
    flat = zeros(n * n, device=a.device, dtype=a.dtype)
    start = diagonal if diagonal >= 0 else -diagonal * n
    idx = clang.arange(start, start + a.shape[0] * (n + 1), n + 1, device=a.device, dtype=dtypes.int32)
    flat = clang.index_put(flat, (idx,), a, False)
    return clang.reshape(flat, (n, n))


def _tile_impl(a, reps):
    shape = (1,) * (len(reps) - a.ndim) + tuple(a.shape)
    out = clang.reshape(a, shape)
    # (s0, s1, ...) tiled by (r0, r1, ...): expand to (r0, s0, r1, s1, ...) then merge pairs
    inter = []
    target = []
    final = []
    for r, s in zip(reps, shape):
        inter.extend([1, s])
        target.extend([r, s])
        final.append(r * s)
    out = clang.reshape(out, tuple(inter))
    out = clang.broadcast_in_dim(out, tuple(target), tuple(range(len(target))))
    return clang.reshape(out, tuple(final))


@torchsymbol(_tfn("tile"), is_method=True)
def tile(a, *reps):
    if len(reps) == 1 and isinstance(reps[0], (tuple, list)):
        reps = tuple(reps[0])
    # torch.tile left-pads reps with 1s when shorter than ndim
    if len(reps) < a.ndim:
        reps = (1,) * (a.ndim - len(reps)) + tuple(reps)
    return _tile_impl(a, tuple(reps))


@torchsymbol(method_name="repeat")
def repeat(a, *reps):
    if len(reps) == 1 and isinstance(reps[0], (tuple, list)):
        reps = tuple(reps[0])
    check(len(reps) >= a.ndim, lambda: f"repeat: needs at least {a.ndim} repeat dims, got {len(reps)}")
    return _tile_impl(a, tuple(reps))


#
# Pooling (the REDUCE_WINDOW prim; reference max_pool/avg_pool live in
# thunder/torch/__init__.py)
#


def _pool_args(n, kernel_size, stride, padding):
    k = (kernel_size,) * n if isinstance(kernel_size, int) else tuple(kernel_size)
    s = k if stride is None or stride == [] else ((stride,) * n if isinstance(stride, int) else tuple(stride))
    p = (padding,) * n if isinstance(padding, int) else tuple(padding)
    check(len(k) == n and len(s) == n and len(p) == n, lambda: "pool: kernel/stride/padding rank mismatch")
    for pi, ki in zip(p, k):
        check(pi <= ki // 2, lambda: f"pool: padding {pi} must be at most half the kernel {ki}")
    return k, s, tuple((pi, pi) for pi in p)


def _max_poolnd(a, n, kernel_size, stride, padding, dilation, ceil_mode, return_indices):
    check(dilation in (1, (1,) * n, [1] * n), lambda: "max_pool: dilation is not supported yet")
    check(not ceil_mode, lambda: "max_pool: ceil_mode is not supported yet")
    check(not return_indices, lambda: "max_pool: return_indices is not supported yet")
    k, s, p = _pool_args(n, kernel_size, stride, padding)
    return prims.reduce_window(a, "max", k, s, p)


@torchsymbol(_tfn("nn", "functional", "max_pool1d"))
def max_pool1d(a, kernel_size, stride=None, padding=0, dilation=1, ceil_mode=False, return_indices=False):
    return _max_poolnd(a, 1, kernel_size, stride, padding, dilation, ceil_mode, return_indices)


@torchsymbol(_tfn("nn", "functional", "max_pool2d"))
def max_pool2d(a, kernel_size, stride=None, padding=0, dilation=1, ceil_mode=False, return_indices=False):
    return _max_poolnd(a, 2, kernel_size, stride, padding, dilation, ceil_mode, return_indices)


@torchsymbol(_tfn("nn", "functional", "max_pool3d"))
def max_pool3d(a, kernel_size, stride=None, padding=0, dilation=1, ceil_mode=False, return_indices=False):
    return _max_poolnd(a, 3, kernel_size, stride, padding, dilation, ceil_mode, return_indices)


def _avg_poolnd(a, n, kernel_size, stride, padding, ceil_mode, count_include_pad, divisor_override):
    check(not ceil_mode, lambda: "avg_pool: ceil_mode is not supported yet")
    k, s, p = _pool_args(n, kernel_size, stride, padding)
    summed = prims.reduce_window(a, "add", k, s, p)
    if divisor_override is not None:
        return clang.true_divide(summed, divisor_override)
    if count_include_pad or all(lo == 0 and hi == 0 for lo, hi in p):
        div = 1
        for ki in k:
            div *= ki
        return clang.true_divide(summed, div)
    counts = prims.reduce_window(clang.full_like(a, 1.0), "add", k, s, p)
    return clang.true_divide(summed, counts)


@torchsymbol(_tfn("nn", "functional", "avg_pool1d"))
def avg_pool1d(a, kernel_size, stride=None, padding=0, ceil_mode=False, count_include_pad=True):
    return _avg_poolnd(a, 1, kernel_size, stride, padding, ceil_mode, count_include_pad, None)


@torchsymbol(_tfn("nn", "functional", "avg_pool2d"))
def avg_pool2d(a, kernel_size, stride=None, padding=0, ceil_mode=False, count_include_pad=True, divisor_override=None):
    return _avg_poolnd(a, 2, kernel_size, stride, padding, ceil_mode, count_include_pad, divisor_override)


@torchsymbol(_tfn("nn", "functional", "avg_pool3d"))
def avg_pool3d(a, kernel_size, stride=None, padding=0, ceil_mode=False, count_include_pad=True, divisor_override=None):
    return _avg_poolnd(a, 3, kernel_size, stride, padding, ceil_mode, count_include_pad, divisor_override)


def _adaptive_avg_poolnd(a, n, output_size):
    out = (output_size,) * n if isinstance(output_size, int) else tuple(output_size)
    check(len(out) == n, lambda: f"adaptive_avg_pool{n}d: output_size rank mismatch")
    spatial = a.shape[a.ndim - n :]
    k = []
    for i, (inp, o) in enumerate(zip(spatial, out)):
        check(o >= 1, lambda: "adaptive_avg_pool: output_size must be positive")
        check(inp % o == 0, lambda: f"adaptive_avg_pool: input {inp} not divisible by output {o} (general case unsupported)")
        k.append(inp // o)
    summed = prims.reduce_window(a, "add", tuple(k), tuple(k), ((0, 0),) * n)
    return clang.true_divide(summed, math.prod(k))


@torchsymbol(_tfn("nn", "functional", "adaptive_avg_pool1d"))
def adaptive_avg_pool1d(a, output_size):
    return _adaptive_avg_poolnd(a, 1, output_size)


@torchsymbol(_tfn("nn", "functional", "adaptive_avg_pool2d"))
def adaptive_avg_pool2d(a, output_size):
    return _adaptive_avg_poolnd(a, 2, output_size)


@torchsymbol(_tfn("nn", "functional", "interpolate"))
def interpolate(a, size=None, scale_factor=None, mode="nearest", align_corners=None, recompute_scale_factor=None, antialias=False):
    """Reference: thunder/torch/__init__.py interpolate.  nearest matches the
    torch floor-index rule exactly via static gathers; linear modes lower to
    the RESIZE prim (half-pixel centers == torch align_corners=False)."""
    check(a.ndim >= 3, lambda: f"interpolate: expected (N, C, spatial...), got {a.ndim}D")
    check(not antialias, lambda: "interpolate: antialias is not supported yet")
    n = a.ndim - 2
    spatial = a.shape[2:]
    sf = None
    if size is not None:
        check(scale_factor is None, lambda: "interpolate: size and scale_factor are mutually exclusive")
        out = (size,) * n if isinstance(size, int) else tuple(size)
    else:
        check(scale_factor is not None, lambda: "interpolate: one of size/scale_factor is required")
        sf = (scale_factor,) * n if isinstance(scale_factor, (int, float)) else tuple(scale_factor)
        out = tuple(int(s * f) for s, f in zip(spatial, sf))
        if recompute_scale_factor:
            sf = None  # torch recomputes the scale from the integer sizes
    check(len(out) == n, lambda: "interpolate: size rank mismatch")
    if mode == "nearest":
        res = a
        for i, (inp, o) in enumerate(zip(spatial, out)):
            if o == inp:
                continue
            if sf is not None:
                # torch keeps the user scale (recompute_scale_factor=False
                # semantics): src = floor(dst / scale_factor)
                frac = clang.true_divide(
                    clang.arange(0, o, device=a.device, dtype=dtypes.float32), float(sf[i])
                )
                idx = clang.maybe_convert_to_dtype(clang.floor(frac), dtypes.int32)
                idx = clang.minimum(idx, inp - 1)
            else:
                # size= path: src = floor(dst * in / out)
                idx = clang.floor_divide(clang.mul(clang.arange(0, o, device=a.device, dtype=dtypes.int32), inp), o)
            res = clang.take(res, idx, 2 + i)
        return res
    check(align_corners is not True, lambda: "interpolate: align_corners=True is not supported yet")
    check(mode in ("linear", "bilinear", "trilinear", "bicubic"), lambda: f"interpolate: unknown mode {mode!r}")
    if sf is not None:
        # the RESIZE prim derives its scale from the shapes; that only equals
        # the torch coordinate map when out == in·sf exactly
        for s, o, f in zip(spatial, out, sf):
            check(
                builtins.abs(s * f - o) < 1e-9,
                lambda: "interpolate: fractional scale_factor with linear modes needs "
                "recompute_scale_factor=True (or pass size=) — shape-derived and "
                "user scales diverge otherwise",
            )
    return prims.resize(a, tuple(a.shape[:2]) + out, mode)


#
# size/shape introspection helpers (trace-time)
#


def size(a, dim=None):
    if dim is None:
        return a.shape
    return a.shape[utils.canonicalize_dim(a.ndim, dim)]


_torch_ctx.register_method("size", size)
_torch_ctx.register_method("dim", lambda a: a.ndim)
_torch_ctx.register_method("numel", lambda a: a.numel)


def manual_seed(seed: int) -> None:
    """Sets the global RNG seed of compiled programs (``core/rng.py``):
    the same seed reproduces the same masks."""
    from thunder_tpu_torch.core import rng

    rng.manual_seed(seed)


# torch.Tensor methods that map through __torch_function__: the reference's
# table, then every method registered above under the name torch.Tensor
# gives it (``torch.Tensor.long(proxy)`` records ``ltorch.long``)
_method_map = {
    _torch.Tensor.add: getattr(_this_module, "add"),
    _torch.Tensor.mul: getattr(_this_module, "mul"),
    _torch.Tensor.sub: getattr(_this_module, "sub"),
    _torch.Tensor.div: getattr(_this_module, "true_divide"),
    _torch.Tensor.matmul: matmul,
    _torch.Tensor.sum: getattr(_this_module, "sum"),
    _torch.Tensor.mean: getattr(_this_module, "mean"),
    _torch.Tensor.reshape: reshape,
    _torch.Tensor.view: view,
    _torch.Tensor.permute: permute,
    _torch.Tensor.transpose: transpose,
    _torch.Tensor.softmax: softmax,
    _torch.Tensor.to: to,
    _torch.Tensor.float: float_,
    _torch.Tensor.contiguous: contiguous,
}
for _mname, _mfn in _torch_ctx._methods.items():
    _tmethod = getattr(_torch.Tensor, _mname, None)
    if callable(_tmethod):
        _method_map.setdefault(_tmethod, _mfn)
_torch_to_thunder_function_map.update(_method_map)


# torch-like dtype aliases (reference: torch.float32 etc. used throughout user code)
bool_ = dtypes.bool8
uint8 = dtypes.uint8
int8 = dtypes.int8
int16 = dtypes.int16
int32 = dtypes.int32
int64 = dtypes.int64
long = dtypes.int64
bfloat16 = dtypes.bfloat16
float16 = dtypes.float16
half = dtypes.float16
float32 = dtypes.float32
float64 = dtypes.float64
double = dtypes.float64
complex64 = dtypes.complex64
complex128 = dtypes.complex128
