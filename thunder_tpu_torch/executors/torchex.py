"""The default torch operator executor: every prim → a torch call.

Counterpart of ``thunder_tpu/executors/jaxex.py``: it implements every prim
that ``jaxex`` implements, under the same ``PrimIDs``, with JAX's semantics
where torch's differ (integer ``div`` truncates; ``pad`` takes negative and
interior padding; ``sort``/``topk`` are stable, ties keep index order;
``take``/``take_along_axis`` take negative indices as ``jnp`` does; ``sign(nan)`` is nan; ``resize`` is ``jax.image.resize``'s half-pixel weight matrices;
index results are int32).  It registers as the default and the always
executor, so a bound symbol no other executor claims runs here.

Random prims keep the reference's ``(key, offset)`` signature: they seed a
``torch.Generator`` on the output's device from the (2,) uint32 key and the
offset.  Equal ``(key, offset)`` gives equal values, another offset other
values; the values are not JAX's threefry bits.

``SDPA``, ``SDPA_BACKWARD`` and ``CROSS_ENTROPY_FWD`` take the fast path the
way ``jaxex`` does with the Pallas kernels (``jaxex.py:552-606``): on CUDA
tensors the flash kernels take (``cudaex.flash_supported`` /
``cudaex.ce_supported``), they call ``cudaex.flash_sdpa``,
``cudaex.flash_sdpa_backward`` and ``cudaex.flash_cross_entropy``; elsewhere
the reference formulas (``ltorch.sdpa_reference``,
``ltorch.sdpa_backward_reference``, ``cudaex.flash_cross_entropy_plain``).
A tensor off the CPU that reaches a reference formula counts one decline in
``ltorch.DECLINES``, as ``ltorch``'s autograd functions count theirs; on the
CPU the formula is the intended path and counts nothing.
"""
from __future__ import annotations

import functools
from typing import Callable

import torch
import torch.nn.functional as F

from thunder_tpu_torch import ltorch
from thunder_tpu_torch.core import dtypes
from thunder_tpu_torch.core.devices import to_torch_device
from thunder_tpu_torch.core.prims import PrimIDs, prim_lookup
from thunder_tpu_torch.executors import cudaex
from thunder_tpu_torch.extend import OperatorExecutor, add_always_executor, add_default_executor, register_executor

__all__ = ["ex", "torch_ex", "prim_impls"]


def _td(d) -> torch.dtype:
    """thunder dtype → torch dtype."""
    return dtypes.to_torch_dtype(d)


def _ints(xs) -> tuple[int, ...]:
    return tuple(int(x) for x in xs)


#
# Implementations, keyed by PrimIDs.  Signatures match the prim metas exactly.
#

prim_impls: dict[PrimIDs, Callable] = {}


def impl(pid: PrimIDs):
    def deco(fn):
        prim_impls[pid] = fn
        return fn

    return deco


def _exact(a) -> bool:
    return not (a.is_floating_point() or a.is_complex())


def _float_only(fn):
    """Rounding ops are the identity on exact dtypes, as in ``jnp``."""
    return lambda a: a if _exact(a) else fn(a)


# Elementwise unary
_unary_torch = {
    PrimIDs.ABS: torch.abs,
    PrimIDs.ACOS: torch.acos,
    PrimIDs.ACOSH: torch.acosh,
    PrimIDs.ASIN: torch.asin,
    PrimIDs.ASINH: torch.asinh,
    PrimIDs.ATAN: torch.atan,
    PrimIDs.ATANH: torch.atanh,
    PrimIDs.BITWISE_NOT: torch.bitwise_not,
    PrimIDs.CEIL: _float_only(torch.ceil),
    PrimIDs.COS: torch.cos,
    PrimIDs.COSH: torch.cosh,
    PrimIDs.DIGAMMA: torch.digamma,
    PrimIDs.ERF: torch.erf,
    PrimIDs.ERFC: torch.erfc,
    PrimIDs.ERFINV: torch.erfinv,
    PrimIDs.EXP: torch.exp,
    PrimIDs.EXP2: torch.exp2,
    PrimIDs.EXPM1: torch.expm1,
    PrimIDs.FLOOR: _float_only(torch.floor),
    PrimIDs.ISFINITE: torch.isfinite,
    PrimIDs.ISINF: torch.isinf,
    PrimIDs.ISNAN: torch.isnan,
    PrimIDs.LGAMMA: torch.lgamma,
    PrimIDs.LOG: torch.log,
    PrimIDs.LOG10: torch.log10,
    PrimIDs.LOG1P: torch.log1p,
    PrimIDs.LOG2: torch.log2,
    PrimIDs.NEG: torch.neg,
    PrimIDs.RECIPROCAL: torch.reciprocal,
    PrimIDs.ROUND: _float_only(torch.round),  # half to even, as jnp.round
    PrimIDs.RSQRT: torch.rsqrt,
    PrimIDs.SIGNBIT: torch.signbit,
    PrimIDs.SIN: torch.sin,
    PrimIDs.SINH: torch.sinh,
    PrimIDs.SQRT: torch.sqrt,
    PrimIDs.TAN: torch.tan,
    PrimIDs.TANH: torch.tanh,
    PrimIDs.TRUNC: _float_only(torch.trunc),
    PrimIDs.REAL: torch.real,
}
prim_impls.update(_unary_torch)


@impl(PrimIDs.SIGN)
def _sign_impl(a):
    if a.is_complex():
        return torch.sgn(a)
    out = torch.sign(a)
    return torch.where(torch.isnan(a), a, out) if a.is_floating_point() else out  # sign(nan) = nan


@impl(PrimIDs.IMAG)
def _imag_impl(a):
    return torch.imag(a) if a.is_complex() else torch.zeros_like(a)


# Elementwise binary
_binary_torch = {
    PrimIDs.ADD: torch.add,
    PrimIDs.ATAN2: torch.atan2,
    PrimIDs.BITWISE_AND: torch.bitwise_and,
    PrimIDs.BITWISE_OR: torch.bitwise_or,
    PrimIDs.BITWISE_XOR: torch.bitwise_xor,
    # torch shifts as XLA does: past the width a left shift gives 0 and a
    # right shift fills with the sign (arithmetic on signed types, logical
    # on unsigned ones)
    PrimIDs.SHIFT_LEFT: torch.bitwise_left_shift,
    PrimIDs.SHIFT_RIGHT: torch.bitwise_right_shift,
    PrimIDs.COPYSIGN: torch.copysign,
    PrimIDs.EQ: torch.eq,
    PrimIDs.FMOD: torch.fmod,            # the dividend's sign, as jnp.fmod
    PrimIDs.GE: torch.ge,
    PrimIDs.GT: torch.gt,
    PrimIDs.LE: torch.le,
    PrimIDs.LT: torch.lt,
    PrimIDs.MAXIMUM: torch.maximum,
    PrimIDs.MINIMUM: torch.minimum,
    PrimIDs.MUL: torch.mul,
    PrimIDs.NE: torch.ne,
    PrimIDs.NEXTAFTER: torch.nextafter,
    PrimIDs.POW: torch.pow,
    PrimIDs.REMAINDER: torch.remainder,  # the divisor's sign, as jnp.remainder
    PrimIDs.SUB: torch.sub,
}
prim_impls.update(_binary_torch)


@impl(PrimIDs.DIV)
def _div_impl(a, b):
    if _exact(a):
        # C-style truncation for exact types (lax.div, jaxex.py:142)
        return torch.div(a, b, rounding_mode="trunc")
    return torch.true_divide(a, b)


@impl(PrimIDs.WHERE)
def _where_impl(pred, a, b):
    return torch.where(pred, a, b)


@impl(PrimIDs.CLAMP)
def _clamp_impl(a, min, max):
    return torch.clamp(a, min, max)


# Data movement
@impl(PrimIDs.CONVERT_ELEMENT_TYPE)
def _convert_element_type_impl(a, dtype):
    return a.to(_td(dtype))


@impl(PrimIDs.DEVICE_PUT)
def _device_put_impl(a, device):
    return a.to(to_torch_device(device))


@impl(PrimIDs.ITEM)
def _item_impl(a):
    return a.reshape(()).item()


@impl(PrimIDs.COPY_)
def _copy__impl(a, b):
    return torch.as_tensor(b, dtype=a.dtype, device=a.device)


# Creation
@impl(PrimIDs.FULL)
def _full_impl(shape, fill_value, *, device, dtype):
    return torch.full(_ints(shape), fill_value, dtype=_td(dtype), device=to_torch_device(device))


@impl(PrimIDs.IOTA)
def _iota_impl(length, *, start, step, device, dtype):
    td = _td(dtype)
    return (start + step * torch.arange(int(length), dtype=td, device=to_torch_device(device))).to(td)


_SEED_MIX = 0x9E3779B97F4A7C15


def _generator(key, offset: int, device) -> torch.Generator:
    """A generator on ``device`` seeded from the (2,) uint32 ``key`` and the
    static ``offset`` (the counterpart of ``jax.random.fold_in``).  Reading
    the key waits for the device."""
    hi, lo = (int(x) & 0xFFFFFFFF for x in key.to(torch.int64).tolist())
    seed = (((hi << 32) | lo) ^ ((int(offset) + 1) * _SEED_MIX)) & 0x7FFFFFFFFFFFFFFF
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


@impl(PrimIDs.UNIFORM)
def _uniform_impl(shape, minval, maxval, *, device, dtype, key, offset):
    dev = to_torch_device(device)
    u = torch.rand(_ints(shape), generator=_generator(key, offset, dev), dtype=torch.float32,
                   device=dev)
    return (minval + (maxval - minval) * u).to(_td(dtype))


@impl(PrimIDs.RANDN)
def _randn_impl(shape, *, device, dtype, key, offset):
    dev = to_torch_device(device)
    return torch.randn(_ints(shape), generator=_generator(key, offset, dev), dtype=_td(dtype),
                       device=dev)


@impl(PrimIDs.RANDINT)
def _randint_impl(shape, low, high, *, device, dtype, key, offset):
    dev = to_torch_device(device)
    out = torch.randint(int(low), int(high), _ints(shape), generator=_generator(key, offset, dev),
                        dtype=torch.int64, device=dev)
    return out.to(_td(dtype))


@impl(PrimIDs.MULTINOMIAL)
def _multinomial_impl(a, num_samples, replacement, *, key, offset):
    out = torch.multinomial(a.float(), int(num_samples), bool(replacement),
                            generator=_generator(key, offset, a.device))
    return out.to(torch.int32)


# Shape
@impl(PrimIDs.BROADCAST_IN_DIM)
def _broadcast_in_dim_impl(a, shape, broadcast_dimensions):
    shape = _ints(shape)
    view = [1] * len(shape)
    for i, d in enumerate(broadcast_dimensions):
        view[int(d)] = a.shape[i]
    return a.reshape(view).expand(shape)


@impl(PrimIDs.CAT)
def _cat_impl(tensors, dim):
    return torch.cat(list(tensors), dim=int(dim))


@impl(PrimIDs.FLIP)
def _flip_impl(a, dims):
    return torch.flip(a, _ints(dims))


@impl(PrimIDs.RESHAPE)
def _reshape_impl(a, shape):
    return torch.reshape(a, _ints(shape))


@impl(PrimIDs.SLICE)
def _slice_impl(a, start_indices, end_indices, strides=None):
    if strides is None:
        strides = [1] * a.ndim
    return a[tuple(slice(int(s), int(e), int(st))
                   for s, e, st in zip(start_indices, end_indices, strides))]


@impl(PrimIDs.SQUEEZE)
def _squeeze_impl(a, dims):
    return torch.squeeze(a, _ints(dims)) if len(dims) else a


@impl(PrimIDs.TRANSPOSE)
def _transpose_impl(a, permutation):
    return a.permute(_ints(permutation))


@impl(PrimIDs.UNFOLD)
def _unfold_impl(a, dim, size, step):
    # windows at ``dim``, the window's elements last, as jaxex's take+moveaxis
    return a.unfold(int(dim), int(size), int(step))


@impl(PrimIDs.PAD)
def _pad_impl(a, padding_value, padding_config):
    """``lax.pad``: per dim ``(lo, hi, interior)``; ``interior`` values go
    between neighbours, and a negative ``lo``/``hi`` crops the dilated
    result.  No single torch call takes interior padding."""
    out_shape, dst, src = [], [], []
    for (lo, hi, interior), n in zip(padding_config, a.shape):
        lo, hi, step = int(lo), int(hi), int(interior) + 1
        size = lo + hi + n + max(n - 1, 0) * (step - 1)
        out_shape.append(size)
        # element i lands at lo + i·step; keep those inside [0, size)
        first = 0 if lo >= 0 else -(lo // step)
        last = min(n, max(0, -((lo - size) // step)))
        src.append(slice(first, max(first, last)))
        dst.append(slice(lo + first * step, lo + (last - 1) * step + 1, step))
    out = torch.full(out_shape, padding_value, dtype=a.dtype, device=a.device)
    if all(sl.stop > sl.start for sl in src):
        out[tuple(dst)] = a[tuple(src)]
    return out


# Reductions.  An empty ``dims`` reduces nothing (torch would reduce all).
def _reduce(fn, a, dims):
    dims = _ints(dims)
    return fn(a, dims) if dims else a


@impl(PrimIDs.AMAX)
def _amax_impl(a, dims):
    return _reduce(torch.amax, a, dims)


@impl(PrimIDs.AMIN)
def _amin_impl(a, dims):
    return _reduce(torch.amin, a, dims)


@impl(PrimIDs.PROD)
def _prod_impl(a, dims):
    for d in sorted(_ints(dims), reverse=True):   # torch.prod takes one dim
        a = torch.prod(a, d, dtype=a.dtype)
    return a


@impl(PrimIDs.SUM)
def _sum_impl(a, dims):
    return _reduce(lambda x, d: torch.sum(x, d, dtype=x.dtype), a, dims)


@impl(PrimIDs.VAR)
def _var_impl(a, dims, *, correction):
    return torch.var(a, _ints(dims), correction=correction)


@impl(PrimIDs.VAR_MEAN)
def _var_mean_impl(a, dims, *, correction):
    return torch.var_mean(a, _ints(dims), correction=correction)


@impl(PrimIDs.ARGMAX)
def _argmax_impl(a, dim):
    return torch.argmax(a, dim=None if dim is None else int(dim)).to(torch.int32)


@impl(PrimIDs.ARGMIN)
def _argmin_impl(a, dim):
    return torch.argmin(a, dim=None if dim is None else int(dim)).to(torch.int32)


def _stable_argsort(key, dim: int, descending: bool):
    return torch.sort(key, dim=dim, descending=descending, stable=True).indices


@impl(PrimIDs.TOPK)
def _topk_impl(a, k, dim, largest, sorted):
    """``lax.top_k`` on ``a`` (or ``-a`` for the smallest): ties keep index
    order, which torch.topk does not promise."""
    dim = int(dim)
    key = a if largest else -a
    idx = _stable_argsort(key, dim, True).narrow(dim, 0, int(k))
    return a.gather(dim, idx), idx.to(torch.int32)


@impl(PrimIDs.SORT)
def _sort_impl(a, dim, descending):
    dim = int(dim)
    idx = _stable_argsort(-a if descending else a, dim, False)
    return a.gather(dim, idx), idx.to(torch.int32)


@impl(PrimIDs.ARGSORT)
def _argsort_impl(a, dim, descending):
    return _stable_argsort(-a if descending else a, int(dim), False).to(torch.int32)


@impl(PrimIDs.CUMSUM)
def _cumsum_impl(a, dim):
    return torch.cumsum(a, int(dim), dtype=a.dtype)


@impl(PrimIDs.CUMPROD)
def _cumprod_impl(a, dim):
    return torch.cumprod(a, int(dim), dtype=a.dtype)


# Scatter/gather
def _wrap(indices, n: int):
    """Negative indices count from the end, as ``jnp.take`` reads them."""
    idx = indices.long()
    return torch.where(idx < 0, idx + n, idx)


@impl(PrimIDs.TAKE)
def _take_impl(a, indices, dim):
    dim = int(dim)
    out = a.index_select(dim, _wrap(indices, a.shape[dim]).reshape(-1))
    return out.squeeze(dim) if indices.ndim == 0 else out


@impl(PrimIDs.TAKE_ALONG_AXIS)
def _take_along_axis_impl(a, indices, dim):
    dim = int(dim)
    # off the axis a size-1 ``a`` broadcasts to the indices' size (the meta
    # admits nothing else); torch's gather does not broadcast
    shape = [s if d == dim or s != 1 else i for d, (s, i) in enumerate(zip(a.shape, indices.shape))]
    return a.expand(shape).gather(dim, _wrap(indices, a.shape[dim]))


@impl(PrimIDs.GATHER)
def _gather_impl(a, indices, dim):
    return a.gather(int(dim), _wrap(indices, a.shape[int(dim)]))


@impl(PrimIDs.INDEX_ADD)
def _index_add_impl(a, indices, value, dim):
    dim = int(dim)
    full = a.shape[:dim] + tuple(indices.shape) + a.shape[dim + 1:]
    value = value.expand(full).reshape(a.shape[:dim] + (-1,) + a.shape[dim + 1:])
    return a.index_add(dim, _wrap(indices, a.shape[dim]).reshape(-1), value.to(a.dtype))


@impl(PrimIDs.INDEX_PUT)
def _index_put_impl(a, indices, values, accumulate):
    idx = tuple(i if i.dtype == torch.bool else i.long() for i in indices)
    return a.index_put(idx, values.to(a.dtype), accumulate=bool(accumulate))


@impl(PrimIDs.SCATTER_ADD)
def _scatter_add_impl(a, indices, value, dim):
    # the values broadcast to the indices' shape, as the meta admits
    return a.scatter_add(int(dim), indices.long(), value.expand(indices.shape))


# Linear algebra / NN
@impl(PrimIDs.MATMUL)
def _matmul_impl(a, b):
    return torch.matmul(a, b)


@impl(PrimIDs.LINEAR)
def _linear_impl(a, w, bias):
    out = F.linear(a, w)
    if bias is not None:
        out = out + bias
    return out


@impl(PrimIDs.EMBEDDING)
def _embedding_impl(indices, weight, *, padding_idx=None):
    return _take_impl(weight, indices.reshape(-1), 0).reshape(*indices.shape, weight.shape[1])


@impl(PrimIDs.EMBEDDING_BACKWARD)
def _embedding_backward_impl(grad, indices, num_weights, padding_idx):
    flat_idx = _wrap(indices.reshape(-1), int(num_weights))
    flat_grad = grad.reshape(-1, grad.shape[-1])
    out = torch.zeros((int(num_weights), grad.shape[-1]), dtype=grad.dtype, device=grad.device)
    out = out.index_add(0, flat_idx, flat_grad)
    if padding_idx is not None and padding_idx >= 0:
        out[int(padding_idx)] = 0
    return out


@impl(PrimIDs.ONE_HOT)
def _one_hot_impl(indices, num_classes):
    # an index outside [0, num_classes) gives a zero row, as jax.nn.one_hot
    classes = torch.arange(int(num_classes), device=indices.device)
    return (indices.long()[..., None] == classes).to(torch.int32)


@impl(PrimIDs.EINSUM)
def _einsum_impl(spec, *operands):
    # torch.einsum takes one dtype; jnp.einsum promotes mixed operands
    dt = functools.reduce(torch.promote_types, (o.dtype for o in operands))
    return torch.einsum(spec, *(o.to(dt) for o in operands))


@impl(PrimIDs.REDUCE_WINDOW)
def _reduce_window_impl(a, kind, window, strides, padding):
    """``lax.reduce_window`` over the trailing ``len(window)`` dims: pad with
    the monoid's identity, cut windows with ``unfold``, reduce them."""
    n = len(window)
    lead = a.ndim - n
    if kind == "max":
        init = float("-inf") if a.is_floating_point() else torch.iinfo(a.dtype).min
    else:
        init = 0
    cfg = [(0, 0, 0)] * lead + [(int(lo), int(hi), 0) for lo, hi in padding]
    out = _pad_impl(a, init, cfg)
    for i, (w, s) in enumerate(zip(window, strides)):
        out = out.unfold(lead + i, int(w), int(s))
    win_dims = tuple(range(a.ndim, a.ndim + n))
    if kind == "max":
        return torch.amax(out, win_dims)
    return torch.sum(out, win_dims, dtype=a.dtype)


def _linear_kernel(x):
    return torch.clamp(1.0 - x, min=0.0)


def _keys_cubic_kernel(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _resize_weights(m: int, n: int, kernel, device) -> torch.Tensor:
    """The (m, n) weight matrix of ``jax.image.resize`` without antialias:
    half-pixel sample positions, weights normalized per output, outputs
    whose sample falls outside the input zeroed (``compute_weight_mat``)."""
    scale = n / m
    sample = (torch.arange(n, dtype=torch.float32, device=device) + 0.5) / scale - 0.5
    x = (sample[None, :] - torch.arange(m, dtype=torch.float32, device=device)[:, None]).abs()
    w = kernel(x)
    total = w.sum(dim=0, keepdim=True)
    eps = 1000.0 * float(torch.finfo(torch.float32).eps)
    w = torch.where(total.abs() > eps, w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= m - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


@impl(PrimIDs.RESIZE)
def _resize_impl(a, shape, method):
    """``jax.image.resize`` (antialias off): every dim whose size changes is
    resized, half-pixel centers."""
    shape = _ints(shape)
    dims = [d for d in range(a.ndim) if a.shape[d] != shape[d]]
    out = a
    if method == "nearest":
        for d in dims:
            m, n = a.shape[d], shape[d]
            idx = torch.floor((torch.arange(n, dtype=torch.float32, device=a.device) + 0.5) * m / n)
            out = out.index_select(d, idx.long())
        return out
    kernel = _keys_cubic_kernel if method in ("cubic", "bicubic") else _linear_kernel
    for d in dims:
        w = _resize_weights(a.shape[d], shape[d], kernel, a.device).to(a.dtype)
        out = torch.movedim(torch.tensordot(out, w, dims=([d], [0])), -1, d)
    return out


@impl(PrimIDs.CONVOLUTION)
def _convolution_impl(a, weight, bias, stride, padding, dilation, transposed, output_padding, groups):
    ndim = a.ndim - 2
    out = torch.convolution(a, weight, None, _ints(stride), _ints(padding), _ints(dilation), False,
                            [0] * ndim, int(groups))
    if bias is not None:
        out = out + bias.reshape((1, -1) + (1,) * ndim)
    return out


# Fused attention and cross-entropy: the flash kernels on CUDA tensors they
# take, the reference formulas elsewhere.  Under the default executors the
# cuda executor claims every SDPA and SDPA_BACKWARD the kernels take, so the
# attention branches here launch only under an executor list without it:
# a torch-only claim today, and the fusion regions (ROADMAP Queue 1 item 7)
# and the train step's trace evaluation (item 5) later, which run prims
# through these impls as the reference's xlaex regions and TrainStep run
# jaxex's.  CROSS_ENTROPY_FWD is decided here alone: no executor claims it.
def _flash_takes(q, k, v, mask, causal, window) -> bool:
    return q.is_cuda and cudaex.flash_supported(
        tuple(q.shape), tuple(k.shape), tuple(v.shape), q.dtype, causal,
        None if mask is None else tuple(mask.shape), window)


def _count_decline(name: str, t) -> None:
    """A kernel refused a tensor off the CPU: the reference formula runs,
    counted as ``ltorch``'s autograd functions count it."""
    if t.device.type != "cpu":
        ltorch.DECLINES[name] += 1


@impl(PrimIDs.SDPA)
def _sdpa_impl(q, k, v, mask, causal, scale, window=None):
    if _flash_takes(q, k, v, mask, causal, window):
        return cudaex.flash_sdpa(q, k, v, mask, causal=causal, scale=scale, window=window)
    _count_decline("flash_sdpa", q)
    return ltorch.sdpa_reference(q, k, v, mask, causal, scale, window)


@impl(PrimIDs.SDPA_BACKWARD)
def _sdpa_backward_impl(g, q, k, v, out, lse, mask, causal, scale, window=None):
    if _flash_takes(q, k, v, mask, causal, window):
        return cudaex.flash_sdpa_backward(g, q, k, v, out, lse, mask, causal=causal, scale=scale,
                                          window=window)
    _count_decline("flash_sdpa_backward", q)
    return ltorch.sdpa_backward_reference(g, q, k, v, out, lse, mask, causal, scale, window)


@impl(PrimIDs.CROSS_ENTROPY_FWD)
def _cross_entropy_fwd_impl(logits, target):
    if logits.is_cuda and cudaex.ce_supported(tuple(logits.shape), tuple(target.shape),
                                              logits.dtype):
        return cudaex.flash_cross_entropy(logits, target)
    _count_decline("flash_cross_entropy", logits)
    return cudaex.flash_cross_entropy_plain(logits, target)


def _flce_chunk(V: int, desired: int = 8192) -> int:
    """Vocab chunk for the fused linear+CE loop (``jaxex._flce_chunk``): the
    largest of the power-of-two slabs ≤ ``desired`` that DIVIDES ``V`` — a
    non-divisor would drop the tail vocab rows from the softmax."""
    for c in (8192, 4096, 2048, 1024, 512, 256, 128, 64, 32, 16, 8, 4, 2, 1):
        if c <= desired and V % c == 0:
            return c
    return V


def _chunk_logits(h, wc):
    """``h @ wc.T`` accumulated in float32 (``preferred_element_type``)."""
    return torch.matmul(h.float(), wc.float().T)


@impl(PrimIDs.FUSED_LINEAR_CE)
def _fused_linear_ce_impl(h, w, target, ignore_index=-100):
    """Online-logsumexp CE over vocab chunks of ``h @ w.T``: the (N, V)
    logits never exist; peak extra memory is one (N, CH) slab."""
    N, V = h.shape[0], w.shape[0]
    CH = _flce_chunk(V)
    tgt = target.long()
    m = torch.full((N,), float("-inf"), dtype=torch.float32, device=h.device)
    s = torch.zeros((N,), dtype=torch.float32, device=h.device)
    tl = torch.zeros((N,), dtype=torch.float32, device=h.device)
    for off in range(0, V, CH):
        lg = _chunk_logits(h, w[off:off + CH])
        m_new = torch.maximum(m, lg.amax(dim=-1))
        s = s * torch.exp(m - m_new) + torch.exp(lg - m_new[:, None]).sum(dim=-1)
        m = m_new
        in_chunk = (tgt >= off) & (tgt < off + CH)
        cand = lg.gather(1, (tgt - off).clamp(0, CH - 1)[:, None])[:, 0]
        tl = torch.where(in_chunk, cand, tl)
    lse = m + torch.log(s)
    losses = torch.where(tgt != ignore_index, lse - tl, torch.zeros_like(lse))
    return losses, lse


@impl(PrimIDs.FUSED_LINEAR_CE_BACKWARD)
def _fused_linear_ce_backward_impl(g, h, w, target, lse, ignore_index=-100):
    """dh/dw from the chunked softmax recompute: ds_c = (p_c - onehot_c)·g."""
    N, C = h.shape
    V = w.shape[0]
    CH = _flce_chunk(V)
    tgt = target.long()
    gg = torch.where(tgt != ignore_index, g.float(), torch.zeros_like(g, dtype=torch.float32))
    dh = torch.zeros((N, C), dtype=torch.float32, device=h.device)
    dws = []
    for off in range(0, V, CH):
        wc = w[off:off + CH]
        p = torch.exp(_chunk_logits(h, wc) - lse[:, None])
        col = torch.arange(off, off + CH, device=h.device)
        ds = (p - (tgt[:, None] == col[None, :]).float()) * gg[:, None]
        dh = dh + ds @ wc.float()
        dws.append((ds.T @ h.float()).to(w.dtype))
    return dh.to(h.dtype), torch.cat(dws, dim=0)


#
# The executor object: registers an eager implementation for every prim above.
#

ex = OperatorExecutor("torch", version=torch.__version__)
register_executor(ex)

for _pid, _impl_fn in list(prim_impls.items()):
    _prim_sym = prim_lookup[_pid]
    ex.register_implementation(
        _pid, ex.register_operator(f"torch_{_prim_sym.name}", like=_prim_sym, fn=_impl_fn))

torch_ex = ex

add_default_executor(ex)
add_always_executor(ex)
