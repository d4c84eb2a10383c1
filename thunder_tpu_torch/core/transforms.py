"""Functional transforms: VJP/autograd, grad APIs.

Counterpart of ``thunder_tpu/core/transforms.py``, copied: the rule table,
``forward_and_backward_from_trace`` and ``grad``/``value_and_grad`` are the
reference's with the port's imports.  The generic VJP of a prim with no
hand-written rule is synthesized from the ``torch`` executor's
implementation of the prim with ``torch.func.vjp`` (the reference uses
``jax.vjp`` over ``jaxex``'s), registered as an operator of the torch
executor.

The reference is the capability analog of the reference's
``thunder/core/transforms.py`` (vjp rule tables :2446-3340,
``augmented_forward_pass`` :3444, ``backward_pass`` :3475,
``forward_and_backward_from_trace`` :3793).

Design difference (TPU-first): instead of separate augmented-forward rules
that enumerate residuals, backward rules reference forward proxies *directly*
(inputs, intermediates, or outputs — whichever is cheapest), and
``saved_for_backward`` is computed afterwards as exactly the forward proxies
the backward trace consumes.  This yields the same contract as the reference
(fw returns ``(output, saved...)``, bw consumes ``(saved..., cotangents...)``)
with one rule table instead of two, and leaves residual minimization to the
rematerialization pass.
"""
from __future__ import annotations

import hashlib
import math
from typing import Any, Callable, Sequence

import numpy as _np

from thunder_tpu_torch import clang
from thunder_tpu_torch.core import dtypes, prims, utils
from thunder_tpu_torch.core.baseutils import check
from thunder_tpu_torch.core.codeutils import SigInfo
from thunder_tpu_torch.core.prims import OpTags, PrimIDs
from thunder_tpu_torch.core.proxies import Proxy, TensorProxy, Variable, variableify
from thunder_tpu_torch.core.pytree import tree_flatten, tree_unflatten
from thunder_tpu_torch.core.symbol import BoundSymbol, provenance_inherited
from thunder_tpu_torch.core.trace import TraceCtx, TraceTag, from_trace, tracectx
from thunder_tpu_torch.core.transform_common import dce

__all__ = [
    "register_backward_rule",
    "backward_rules",
    "nondifferentiable_ids",
    "flatten_to_prims",
    "forward_and_backward_from_trace",
    "grad",
    "value_and_grad",
]

#
# Rule registry
#
# A rule has signature rule(bsym, *cotangents) -> list[(input_proxy, grad)].
# It runs under the backward trace's tracectx and may reference any proxy of
# the forward trace (those become saved_for_backward).
#

backward_rules: dict[Any, Callable] = {}

# prims that produce no gradients (integer/bool results, RNG, bookkeeping)
nondifferentiable_ids = {
    PrimIDs.EQ, PrimIDs.NE, PrimIDs.GE, PrimIDs.GT, PrimIDs.LE, PrimIDs.LT,
    PrimIDs.BITWISE_AND, PrimIDs.BITWISE_OR, PrimIDs.BITWISE_XOR, PrimIDs.BITWISE_NOT,
    PrimIDs.SHIFT_LEFT, PrimIDs.SHIFT_RIGHT,
    PrimIDs.ISFINITE, PrimIDs.ISINF, PrimIDs.ISNAN, PrimIDs.SIGNBIT, PrimIDs.SIGN,
    PrimIDs.FLOOR, PrimIDs.CEIL, PrimIDs.ROUND, PrimIDs.TRUNC,
    PrimIDs.ARGMAX, PrimIDs.ARGMIN, PrimIDs.ARGSORT, PrimIDs.ONE_HOT,
    PrimIDs.FULL, PrimIDs.IOTA, PrimIDs.UNIFORM, PrimIDs.RANDN, PrimIDs.RANDINT,
    PrimIDs.MULTINOMIAL, PrimIDs.EMBEDDING_BACKWARD, PrimIDs.ITEM,
    PrimIDs.SDPA_BACKWARD,
}


def register_backward_rule(id):
    def deco(fn):
        backward_rules[id] = fn
        return fn

    return deco


def _t(x) -> bool:
    return isinstance(x, TensorProxy)


def _sum_to_shape(g: TensorProxy, shape: tuple) -> TensorProxy:
    """Reduces a broadcasted gradient back to ``shape``."""
    if tuple(g.shape) == tuple(shape):
        return g
    # sum leading dims
    lead = g.ndim - len(shape)
    if lead > 0:
        g = clang.sum(g, tuple(range(lead)), False)
    # sum broadcasted size-1 dims
    dims = tuple(i for i, (gs, s) in enumerate(zip(g.shape, shape)) if s == 1 and gs != 1)
    if dims:
        g = clang.sum(g, dims, True)
    if tuple(g.shape) != tuple(shape):
        g = clang.reshape(g, shape)
    return g


#
# Elementwise binary
#


@register_backward_rule(PrimIDs.ADD)
def _add_bw(bsym, g):
    a, b = bsym.args
    return [(a, g), (b, g)]


@register_backward_rule(PrimIDs.SUB)
def _sub_bw(bsym, g):
    a, b = bsym.args
    return [(a, g), (b, clang.neg(g))]


@register_backward_rule(PrimIDs.MUL)
def _mul_bw(bsym, g):
    a, b = bsym.args
    return [(a, clang.mul(g, b)), (b, clang.mul(g, a))]


@register_backward_rule(PrimIDs.DIV)
def _div_bw(bsym, g):
    a, b = bsym.args
    ga = clang.true_divide(g, b)
    gb = clang.neg(clang.true_divide(clang.mul(g, a), clang.mul(b, b)))
    return [(a, ga), (b, gb)]


@register_backward_rule(PrimIDs.POW)
def _pow_bw(bsym, g):
    a, b = bsym.args
    out = bsym.output
    ga = clang.mul(clang.mul(g, b), clang.pow(a, clang.sub(b, 1.0)))
    gb = clang.mul(clang.mul(g, out), clang.log(a))
    return [(a, ga), (b, gb)]


@register_backward_rule(PrimIDs.MAXIMUM)
def _maximum_bw(bsym, g):
    a, b = bsym.args
    half = clang.mul(g, 0.5)
    ga = clang.where(clang.gt(a, b), g, clang.where(clang.eq(a, b), half, 0.0))
    gb = clang.where(clang.lt(a, b), g, clang.where(clang.eq(a, b), half, 0.0))
    return [(a, ga), (b, gb)]


@register_backward_rule(PrimIDs.MINIMUM)
def _minimum_bw(bsym, g):
    a, b = bsym.args
    half = clang.mul(g, 0.5)
    ga = clang.where(clang.lt(a, b), g, clang.where(clang.eq(a, b), half, 0.0))
    gb = clang.where(clang.gt(a, b), g, clang.where(clang.eq(a, b), half, 0.0))
    return [(a, ga), (b, gb)]


@register_backward_rule(PrimIDs.ATAN2)
def _atan2_bw(bsym, g):
    a, b = bsym.args
    denom = clang.add(clang.mul(a, a), clang.mul(b, b))
    return [(a, clang.true_divide(clang.mul(g, b), denom)), (b, clang.neg(clang.true_divide(clang.mul(g, a), denom)))]


@register_backward_rule(PrimIDs.REMAINDER)
def _remainder_bw(bsym, g):
    # a % b = a - floor(a/b)*b  →  d/da = 1, d/db = -floor(a/b)
    a, b = bsym.args
    return [(a, g), (b, clang.neg(clang.mul(g, clang.floor(clang.true_divide(a, b)))))]


@register_backward_rule(PrimIDs.FMOD)
def _fmod_bw(bsym, g):
    # fmod(a, b) = a - trunc(a/b)*b  →  d/da = 1, d/db = -trunc(a/b)
    a, b = bsym.args
    return [(a, g), (b, clang.neg(clang.mul(g, clang.trunc(clang.true_divide(a, b)))))]


@register_backward_rule(PrimIDs.COPYSIGN)
def _copysign_bw(bsym, g):
    a, b = bsym.args
    out = bsym.output
    ga = clang.mul(g, clang.mul(clang.sign(a), clang.sign(out)))
    return [(a, ga)]


#
# Elementwise unary
#


@register_backward_rule(PrimIDs.NEG)
def _neg_bw(bsym, g):
    return [(bsym.args[0], clang.neg(g))]


@register_backward_rule(PrimIDs.ABS)
def _abs_bw(bsym, g):
    a = bsym.args[0]
    return [(a, clang.mul(g, clang.sign(a)))]


@register_backward_rule(PrimIDs.EXP)
def _exp_bw(bsym, g):
    return [(bsym.args[0], clang.mul(g, bsym.output))]


@register_backward_rule(PrimIDs.EXP2)
def _exp2_bw(bsym, g):
    return [(bsym.args[0], clang.mul(g, clang.mul(bsym.output, math.log(2.0))))]


@register_backward_rule(PrimIDs.EXPM1)
def _expm1_bw(bsym, g):
    return [(bsym.args[0], clang.mul(g, clang.add(bsym.output, 1.0)))]


@register_backward_rule(PrimIDs.LOG)
def _log_bw(bsym, g):
    return [(bsym.args[0], clang.true_divide(g, bsym.args[0]))]


@register_backward_rule(PrimIDs.LOG2)
def _log2_bw(bsym, g):
    return [(bsym.args[0], clang.true_divide(g, clang.mul(bsym.args[0], math.log(2.0))))]


@register_backward_rule(PrimIDs.LOG10)
def _log10_bw(bsym, g):
    return [(bsym.args[0], clang.true_divide(g, clang.mul(bsym.args[0], math.log(10.0))))]


@register_backward_rule(PrimIDs.LOG1P)
def _log1p_bw(bsym, g):
    return [(bsym.args[0], clang.true_divide(g, clang.add(bsym.args[0], 1.0)))]


@register_backward_rule(PrimIDs.SQRT)
def _sqrt_bw(bsym, g):
    return [(bsym.args[0], clang.true_divide(g, clang.mul(bsym.output, 2.0)))]


@register_backward_rule(PrimIDs.RSQRT)
def _rsqrt_bw(bsym, g):
    a = bsym.args[0]
    out = bsym.output
    return [(a, clang.mul(g, clang.true_divide(clang.mul(out, -0.5), a)))]


@register_backward_rule(PrimIDs.RECIPROCAL)
def _reciprocal_bw(bsym, g):
    out = bsym.output
    return [(bsym.args[0], clang.neg(clang.mul(g, clang.mul(out, out))))]


@register_backward_rule(PrimIDs.TANH)
def _tanh_bw(bsym, g):
    out = bsym.output
    return [(bsym.args[0], clang.mul(g, clang.sub(1.0, clang.mul(out, out))))]


@register_backward_rule(PrimIDs.SIN)
def _sin_bw(bsym, g):
    return [(bsym.args[0], clang.mul(g, clang.cos(bsym.args[0])))]


@register_backward_rule(PrimIDs.COS)
def _cos_bw(bsym, g):
    return [(bsym.args[0], clang.neg(clang.mul(g, clang.sin(bsym.args[0]))))]


@register_backward_rule(PrimIDs.TAN)
def _tan_bw(bsym, g):
    out = bsym.output
    return [(bsym.args[0], clang.mul(g, clang.add(1.0, clang.mul(out, out))))]


@register_backward_rule(PrimIDs.SINH)
def _sinh_bw(bsym, g):
    return [(bsym.args[0], clang.mul(g, clang.cosh(bsym.args[0])))]


@register_backward_rule(PrimIDs.COSH)
def _cosh_bw(bsym, g):
    return [(bsym.args[0], clang.mul(g, clang.sinh(bsym.args[0])))]


@register_backward_rule(PrimIDs.ASIN)
def _asin_bw(bsym, g):
    a = bsym.args[0]
    return [(a, clang.true_divide(g, clang.sqrt(clang.sub(1.0, clang.mul(a, a)))))]


@register_backward_rule(PrimIDs.ACOS)
def _acos_bw(bsym, g):
    a = bsym.args[0]
    return [(a, clang.neg(clang.true_divide(g, clang.sqrt(clang.sub(1.0, clang.mul(a, a))))))]


@register_backward_rule(PrimIDs.ATAN)
def _atan_bw(bsym, g):
    a = bsym.args[0]
    return [(a, clang.true_divide(g, clang.add(1.0, clang.mul(a, a))))]


@register_backward_rule(PrimIDs.ASINH)
def _asinh_bw(bsym, g):
    a = bsym.args[0]
    return [(a, clang.true_divide(g, clang.sqrt(clang.add(clang.mul(a, a), 1.0))))]


@register_backward_rule(PrimIDs.ACOSH)
def _acosh_bw(bsym, g):
    a = bsym.args[0]
    return [(a, clang.true_divide(g, clang.sqrt(clang.sub(clang.mul(a, a), 1.0))))]


@register_backward_rule(PrimIDs.ATANH)
def _atanh_bw(bsym, g):
    a = bsym.args[0]
    return [(a, clang.true_divide(g, clang.sub(1.0, clang.mul(a, a))))]


@register_backward_rule(PrimIDs.ERF)
def _erf_bw(bsym, g):
    a = bsym.args[0]
    coef = 2.0 / math.sqrt(math.pi)
    return [(a, clang.mul(g, clang.mul(coef, clang.exp(clang.neg(clang.mul(a, a))))))]


@register_backward_rule(PrimIDs.ERFC)
def _erfc_bw(bsym, g):
    a = bsym.args[0]
    coef = -2.0 / math.sqrt(math.pi)
    return [(a, clang.mul(g, clang.mul(coef, clang.exp(clang.neg(clang.mul(a, a))))))]


@register_backward_rule(PrimIDs.ERFINV)
def _erfinv_bw(bsym, g):
    out = bsym.output
    coef = math.sqrt(math.pi) / 2.0
    return [(bsym.args[0], clang.mul(g, clang.mul(coef, clang.exp(clang.mul(out, out)))))]


@register_backward_rule(PrimIDs.LGAMMA)
def _lgamma_bw(bsym, g):
    a = bsym.args[0]
    return [(a, clang.mul(g, clang.digamma(a)))]


@register_backward_rule(PrimIDs.WHERE)
def _where_bw(bsym, g):
    pred, a, b = bsym.args
    zero = clang.full_like(g, 0.0)
    return [(a, prims.where(pred, g, zero)), (b, prims.where(pred, zero, g))]


#
# Data movement
#


@register_backward_rule(PrimIDs.CONVERT_ELEMENT_TYPE)
def _convert_element_type_bw(bsym, g):
    a = bsym.args[0]
    if not dtypes.is_inexact_dtype(a.dtype):
        return []
    return [(a, clang.maybe_convert_to_dtype(g, a.dtype))]


@register_backward_rule(PrimIDs.DEVICE_PUT)
def _device_put_bw(bsym, g):
    a, device = bsym.args
    return [(a, prims.device_put(g, a.device))]


@register_backward_rule(PrimIDs.COPY_)
def _copy__bw(bsym, g):
    a, b = bsym.args
    return [(b, g)]


#
# Shape ops
#


@register_backward_rule(PrimIDs.BROADCAST_IN_DIM)
def _broadcast_in_dim_bw(bsym, g):
    a, shape, bdims = bsym.args[0], bsym.args[1], bsym.args[2]
    # reduce dims not mapped from a
    reduce_dims = tuple(d for d in range(len(shape)) if d not in bdims)
    if reduce_dims:
        g = clang.sum(g, reduce_dims, False)
    # now g has rank of a; sum broadcasted size-1 dims
    keep_dims = tuple(i for i in range(a.ndim) if a.shape[i] == 1 and g.shape[i] != 1)
    if keep_dims:
        g = clang.sum(g, keep_dims, True)
    if tuple(g.shape) != tuple(a.shape):
        g = clang.reshape(g, a.shape)
    return [(a, g)]


@register_backward_rule(PrimIDs.RESHAPE)
def _reshape_bw(bsym, g):
    a = bsym.args[0]
    return [(a, clang.reshape(g, a.shape))]


@register_backward_rule(PrimIDs.SQUEEZE)
def _squeeze_bw(bsym, g):
    a = bsym.args[0]
    return [(a, clang.reshape(g, a.shape))]


@register_backward_rule(PrimIDs.TRANSPOSE)
def _transpose_bw(bsym, g):
    a, perm = bsym.args
    inverse = [0] * len(perm)
    for i, p in enumerate(perm):
        inverse[p] = i
    return [(a, prims.transpose(g, tuple(inverse)))]


@register_backward_rule(PrimIDs.FLIP)
def _flip_bw(bsym, g):
    a, dims = bsym.args
    return [(a, prims.flip(g, dims))]


@register_backward_rule(PrimIDs.SLICE)
def _slice_bw(bsym, g):
    a = bsym.args[0]
    starts, ends = bsym.args[1], bsym.args[2]
    strides = bsym.args[3] if len(bsym.args) > 3 and bsym.args[3] is not None else [1] * a.ndim
    config = []
    for start, out_len, stride, dim in zip(starts, g.shape, strides, a.shape):
        span = (out_len - 1) * stride + 1 if out_len > 0 else 0
        hi = dim - start - span
        config.append((start, hi, stride - 1))
    return [(a, prims.pad(g, 0.0, config))]


@register_backward_rule(PrimIDs.CAT)
def _cat_bw(bsym, g):
    tensors, dim = bsym.args
    grads = []
    offset = 0
    for t in tensors:
        grads.append((t, clang.slice_in_dim(g, offset, offset + t.shape[dim], dim=dim)))
        offset += t.shape[dim]
    return grads


@register_backward_rule(PrimIDs.PAD)
def _pad_bw(bsym, g):
    a, _, config = bsym.args
    starts, ends, strides = [], [], []
    for (lo, hi, interior), dim in zip(config, a.shape):
        starts.append(lo)
        span = (dim - 1) * (interior + 1) + 1 if dim > 0 else 0
        ends.append(lo + span)
        strides.append(interior + 1)
    return [(a, prims.slice_prim(g, starts, ends, strides))]


#
# Reductions
#


def _broadcast_reduced(g: TensorProxy, orig_shape: tuple, dims: tuple) -> TensorProxy:
    """Expands a reduced gradient back over ``dims`` of ``orig_shape``."""
    keep = [1 if i in dims else s for i, s in enumerate(orig_shape)]
    g = clang.reshape(g, tuple(keep))
    return clang.expand(g, tuple(orig_shape))


@register_backward_rule(PrimIDs.SUM)
def _sum_bw(bsym, g):
    a, dims = bsym.args
    return [(a, _broadcast_reduced(g, a.shape, tuple(dims)))]


@register_backward_rule(PrimIDs.AMAX)
def _amax_bw(bsym, g):
    a, dims = bsym.args
    out = bsym.output
    out_b = _broadcast_reduced(out, a.shape, tuple(dims))
    g_b = _broadcast_reduced(g, a.shape, tuple(dims))
    mask = clang.maybe_convert_to_dtype(clang.eq(a, out_b), a.dtype)
    count = _broadcast_reduced(clang.sum(mask, tuple(dims), False), a.shape, tuple(dims))
    return [(a, clang.true_divide(clang.mul(g_b, mask), count))]


@register_backward_rule(PrimIDs.AMIN)
def _amin_bw(bsym, g):
    return _amax_bw(bsym, g)


@register_backward_rule(PrimIDs.PROD)
def _prod_bw(bsym, g):
    a, dims = bsym.args
    out = bsym.output
    out_b = _broadcast_reduced(out, a.shape, tuple(dims))
    g_b = _broadcast_reduced(g, a.shape, tuple(dims))
    return [(a, clang.true_divide(clang.mul(g_b, out_b), a))]


@register_backward_rule(PrimIDs.VAR)
def _var_bw(bsym, g):
    a, dims = bsym.args
    correction = bsym.kwargs.get("correction", 1)
    n = 1
    for d in dims:
        n *= a.shape[d]
    mean = clang.mean(a, tuple(dims), True)
    g_b = _broadcast_reduced(g, a.shape, tuple(dims))
    coef = 2.0 / max(n - correction, 1)
    return [(a, clang.mul(g_b, clang.mul(clang.sub(a, mean), coef)))]


@register_backward_rule(PrimIDs.VAR_MEAN)
def _var_mean_bw(bsym, g_var, g_mean):
    a, dims = bsym.args
    correction = bsym.kwargs.get("correction", 1)
    n = 1
    for d in dims:
        n *= a.shape[d]
    mean = clang.mean(a, tuple(dims), True)
    gv_b = _broadcast_reduced(g_var, a.shape, tuple(dims))
    gm_b = _broadcast_reduced(g_mean, a.shape, tuple(dims))
    coef = 2.0 / max(n - correction, 1)
    grad = clang.add(
        clang.mul(gv_b, clang.mul(clang.sub(a, mean), coef)),
        clang.true_divide(gm_b, float(n)),
    )
    return [(a, grad)]


@register_backward_rule(PrimIDs.CUMSUM)
def _cumsum_bw(bsym, g):
    a, dim = bsym.args
    return [(a, prims.flip(prims.cumsum(prims.flip(g, (dim,)), dim), (dim,)))]


@register_backward_rule(PrimIDs.TOPK)
def _topk_bw(bsym, g_values, g_indices):
    a, k, dim = bsym.args[0], bsym.args[1], bsym.args[2]
    _, indices = bsym.output
    zeros = clang.full_like(a, 0.0)
    return [(a, prims.scatter_add(zeros, indices, g_values, dim))]


@register_backward_rule(PrimIDs.SORT)
def _sort_bw(bsym, g_values, g_indices):
    a, dim = bsym.args[0], bsym.args[1]
    _, indices = bsym.output
    zeros = clang.full_like(a, 0.0)
    return [(a, prims.scatter_add(zeros, indices, g_values, dim))]


#
# Indexing
#


@register_backward_rule(PrimIDs.TAKE)
def _take_bw(bsym, g):
    a, indices, dim = bsym.args
    zeros = clang.full_like(a, 0.0)
    return [(a, prims.index_add(zeros, indices, g, dim))]


@register_backward_rule(PrimIDs.TAKE_ALONG_AXIS)
def _take_along_axis_bw(bsym, g):
    a, indices, dim = bsym.args
    zeros = clang.full_like(a, 0.0)
    return [(a, prims.scatter_add(zeros, indices, g, dim))]


@register_backward_rule(PrimIDs.GATHER)
def _gather_bw(bsym, g):
    a, indices, dim = bsym.args
    zeros = clang.full_like(a, 0.0)
    return [(a, prims.scatter_add(zeros, indices, g, dim))]


@register_backward_rule(PrimIDs.SCATTER_ADD)
def _scatter_add_bw(bsym, g):
    a, indices, value, dim = bsym.args
    return [(a, g), (value, prims.take_along_axis(g, indices, dim))]


@register_backward_rule(PrimIDs.INDEX_ADD)
def _index_add_bw(bsym, g):
    a, indices, value, dim = bsym.args
    return [(a, g), (value, prims.take(g, indices, dim))]


@register_backward_rule(PrimIDs.INDEX_PUT)
def _index_put_bw(bsym, g):
    raise NotImplementedError("index_put backward is not supported yet")


#
# Matmul family
#


@register_backward_rule(PrimIDs.MATMUL)
def _matmul_bw(bsym, g):
    a, b = bsym.args
    if a.ndim == 1 and b.ndim == 1:
        return [(a, clang.mul(g, b)), (b, clang.mul(g, a))]
    if a.ndim == 1:
        # (k) @ (..., k, n) -> (..., n)
        g_ = clang.unsqueeze(g, -2)  # (..., 1, n)
        ga = _sum_to_shape(prims.matmul(g_, clang.transpose(b, -2, -1)), a.shape)
        gb = prims.matmul(clang.unsqueeze(a, -1), g_)  # (k, 1) x (..., 1, n)
        gb = _sum_to_shape(gb, b.shape)
        return [(a, ga), (b, gb)]
    if b.ndim == 1:
        g_ = clang.unsqueeze(g, -1)  # (..., m, 1)
        ga = prims.matmul(g_, clang.unsqueeze(b, 0))  # (..., m, k)
        ga = _sum_to_shape(ga, a.shape)
        gb = prims.matmul(clang.transpose(a, -2, -1), g_)  # (..., k, 1)
        gb = _sum_to_shape(clang.squeeze(gb, (gb.ndim - 1,)), b.shape)
        return [(a, ga), (b, gb)]
    ga = _sum_to_shape(prims.matmul(g, clang.transpose(b, -2, -1)), a.shape)
    gb = _sum_to_shape(prims.matmul(clang.transpose(a, -2, -1), g), b.shape)
    return [(a, ga), (b, gb)]


@register_backward_rule(PrimIDs.LINEAR)
def _linear_bw(bsym, g):
    a, w, bias = bsym.args
    # ga: (..., out) @ (out, in) -> (..., in)
    ga = prims.matmul(g, w) if g.ndim > 1 else prims.matmul(clang.unsqueeze(g, 0), w)
    if g.ndim == 1:
        ga = clang.squeeze(ga, (0,))
    # gw: (out, in) = g2d^T @ a2d
    g2d = clang.reshape(g, (-1, w.shape[0]))
    a2d = clang.reshape(a, (-1, w.shape[1]))
    gw = prims.matmul(clang.transpose(g2d, 0, 1), a2d)
    grads = [(a, ga), (w, gw)]
    if bias is not None:
        grads.append((bias, clang.sum(g2d, (0,), False)))
    return grads


@register_backward_rule(PrimIDs.SDPA)
def _sdpa_bw(bsym, g_out, g_lse):
    """Flash-attention-style backward: consumes (q, k, v, out, lse) — never
    the (T, T) probability matrix — so saved_for_backward stays O(T).

    ``lse`` is an auxiliary output; when something downstream actually
    consumes it (g_lse is a real cotangent, not None), its contribution is
    added via the decomposed probability matrix — an O(T²) cost paid only in
    that rare case (e.g. distillation losses over lse).
    """
    q, k, v, mask, causal, scale, *rest = bsym.args
    window = rest[0] if rest else None
    out, lse = bsym.output
    if g_out is None:
        g_out = clang.full_like(out, 0.0)
    dq, dk, dv = prims.sdpa_backward(g_out, q, k, v, out, lse, mask, causal, scale, window)
    if g_lse is not None:
        if window is not None:
            raise NotImplementedError(
                "differentiating through sdpa's lse output with sliding_window is not supported"
            )
        # d lse_i/dq_i = scale * sum_j p_ij k_j ; d lse_i/dk_j = scale * p_ij q_i
        if q.shape[:-2] != k.shape[:-2]:
            raise NotImplementedError(
                "differentiating through sdpa's lse output with grouped-query K/V "
                "is not supported; expand K/V to the query head count first"
            )
        s = clang.mul(prims.matmul(q, clang.transpose(k, -2, -1)), scale)
        if mask is not None:
            s = clang.add(s, mask)
        if causal:
            Tq, Tk = q.shape[-2], k.shape[-2]
            row = clang.arange(0, Tq, device=q.device, dtype=dtypes.int32)
            col = clang.arange(0, Tk, device=q.device, dtype=dtypes.int32)
            keep = clang.ge(clang.reshape(row, (Tq, 1)), clang.reshape(col, (1, Tk)))
            s = clang.where(keep, s, float("-inf"))
        p = clang.exp(clang.sub(s, clang.unsqueeze(lse, -1)))
        p = clang.maybe_convert_to_dtype(p, q.dtype)
        gp = clang.mul(p, clang.unsqueeze(clang.maybe_convert_to_dtype(g_lse, q.dtype), -1))
        dq = clang.add(dq, clang.mul(prims.matmul(gp, k), scale))
        dk = clang.add(dk, clang.mul(prims.matmul(clang.transpose(gp, -2, -1), q), scale))
    return [(q, dq), (k, dk), (v, dv)]


_sdpa_bw._accepts_none_cotangents = True


@register_backward_rule(PrimIDs.CROSS_ENTROPY_FWD)
def _cross_entropy_fwd_bw(bsym, g_losses, g_lse):
    """dlogits = softmax(logits) * (g_losses + g_lse) - onehot(target) * g_losses,
    recomputed from (logits, lse) — no (N, C) log-prob residual."""
    logits, target = bsym.args
    losses, lse = bsym.output
    p = clang.exp(clang.sub(clang.maybe_convert_to_dtype(logits, dtypes.float32), clang.unsqueeze(lse, -1)))
    oh = clang.maybe_convert_to_dtype(prims.one_hot(target, logits.shape[1]), dtypes.float32)
    if g_losses is None:
        g_losses = clang.full_like(losses, 0.0)
    g_tot = clang.add(g_losses, g_lse) if g_lse is not None else g_losses
    dlogits = clang.sub(
        clang.mul(p, clang.unsqueeze(g_tot, -1)),
        clang.mul(oh, clang.unsqueeze(g_losses, -1)),
    )
    return [(logits, clang.maybe_convert_to_dtype(dlogits, logits.dtype))]


_cross_entropy_fwd_bw._accepts_none_cotangents = True


@register_backward_rule(PrimIDs.FUSED_LINEAR_CE)
def _fused_linear_ce_bw(bsym, g_losses, g_lse):
    """Saved: (h, w, target, lse) — O(N·C + V·C); the (N, V) softmax is
    recomputed chunkwise in the backward prim."""
    h, w, target, *rest = bsym.args
    ignore_index = rest[0] if rest else -100
    losses, lse = bsym.output
    if g_lse is not None:
        raise NotImplementedError(
            "differentiating through fused_linear_ce's lse output is not supported"
        )
    if g_losses is None:
        g_losses = clang.full_like(losses, 0.0)
    dh, dw = prims.fused_linear_ce_backward(g_losses, h, w, target, lse, ignore_index)
    return [(h, dh), (w, dw)]


_fused_linear_ce_bw._accepts_none_cotangents = True


@register_backward_rule(PrimIDs.EMBEDDING)
def _embedding_bw(bsym, g):
    indices = bsym.args[0]
    weight = bsym.args[1]
    padding_idx = bsym.kwargs.get("padding_idx", None)
    pi = -1 if padding_idx is None else int(padding_idx)
    gw = prims.embedding_backward(g, indices, weight.shape[0], pi)
    return [(weight, gw)]


#
# Collectives (thunder_tpu_torch/distributed/prims.py).  The rules follow
# the transposes JAX gives the reference's prims under ``shard_map``:
# all_gather ↔ reduce_scatter of the sum, all_reduce of a sum ↔ all_reduce
# of the sum (of the mean ↔ of the mean), ppermute ↔ the inverse
# permutation, all_to_all ↔ the swapped all_to_all, broadcast ↔ the sum
# landing on the root.  ``synchronize`` is the step's own: a sharded param
# is all-gathered forward and its grad reduce-scattered backward, a
# replicated one passes forward and its grad is all-reduced, both as the
# mean over the axes (each rank's loss is the mean of its batch slice).
# prims.py registers them once its symbols exist.
#


def _dist_args(bsym, names: tuple, defaults: dict) -> dict:
    got = dict(zip(names, bsym.args))
    got.update(bsym.kwargs)
    return {n: got.get(n, defaults.get(n)) for n in names}


def register_dist_backward_rules(dp) -> None:
    """Registers the collectives' VJP rules; ``dp`` is the dist prims
    module."""
    ids, ops = dp.DistPrimIDs, dp.DistributedReduceOps
    nondifferentiable_ids.add(ids.AXIS_INDEX)

    def pairs(a, gs):
        return list(zip(a, gs)) if isinstance(a, (tuple, list)) else [(a, gs[0])]

    def packed(a, gs):
        return tuple(gs) if isinstance(a, (tuple, list)) else gs[0]

    def scaled(g, n: int, op):
        if op is ops.MEAN and n != 1:
            return tuple(clang.mul(x, 1.0 / n) for x in g) if isinstance(g, tuple) \
                else clang.mul(g, 1.0 / n)
        return g

    @register_backward_rule(ids.ALL_GATHER)
    def _all_gather_bw(bsym, *gs):
        k = _dist_args(bsym, ("a", "axis_name", "axis_size", "dim", "tiled"),
                       {"dim": 0, "tiled": True})
        a, n = k["a"], int(k["axis_size"])
        if k["tiled"]:
            got = dp.reduce_scatter(packed(a, gs), k["axis_name"], n, k["dim"], ops.SUM)
            return pairs(a, got if isinstance(got, tuple) else (got,))
        # untiled: the stacked (n, ...) cotangent, scattered along its new dim
        flat = [clang.reshape(g, (n * x.shape[0], *x.shape[1:])) if x.ndim else g
                for g, x in zip(gs, a if isinstance(a, (tuple, list)) else (a,))]
        out = dp.reduce_scatter(packed(a, flat), k["axis_name"], n, 0, ops.SUM)
        out = out if isinstance(out, tuple) else (out,)
        xs = a if isinstance(a, (tuple, list)) else (a,)
        return [(x, clang.reshape(g, tuple(x.shape))) for x, g in zip(xs, out)]

    @register_backward_rule(ids.REDUCE_SCATTER)
    def _reduce_scatter_bw(bsym, *gs):
        k = _dist_args(bsym, ("a", "axis_name", "axis_size", "dim", "op"),
                       {"dim": 0, "op": ops.SUM})
        n = int(k["axis_size"])
        got = dp.all_gather(packed(k["a"], gs), k["axis_name"], n, k["dim"], True)
        got = scaled(got, n, k["op"])
        return pairs(k["a"], got if isinstance(got, tuple) else (got,))

    @register_backward_rule(ids.ALL_REDUCE)
    def _all_reduce_bw(bsym, *gs):
        k = _dist_args(bsym, ("a", "axis_name", "op", "async_op"), {"op": ops.SUM})
        check(k["op"] in (ops.SUM, ops.MEAN),
              lambda: f"all_reduce with {k['op']} has no VJP (the reference's pmax/pmin have none)",
              NotImplementedError)
        got = dp.all_reduce(packed(k["a"], gs), k["axis_name"], k["op"])
        return pairs(k["a"], got if isinstance(got, tuple) else (got,))

    @register_backward_rule(ids.BROADCAST)
    def _broadcast_bw(bsym, g):
        k = _dist_args(bsym, ("a", "axis_name", "root"), {"root": 0})
        total = dp.all_reduce(g, k["axis_name"], ops.SUM)
        on_root = clang.eq(dp.axis_index(k["axis_name"]), int(k["root"]))
        return [(k["a"], clang.where(on_root, total, clang.full_like(total, 0.0)))]

    @register_backward_rule(ids.PPERMUTE)
    def _ppermute_bw(bsym, g):
        k = _dist_args(bsym, ("a", "axis_name", "perm"), {})
        inverse = [[int(d), int(s)] for s, d in k["perm"]]
        return [(k["a"], dp.ppermute(g, k["axis_name"], inverse))]

    @register_backward_rule(ids.ALL_TO_ALL)
    def _all_to_all_bw(bsym, g):
        k = _dist_args(bsym, ("a", "axis_name", "axis_size", "split_dim", "concat_dim"), {})
        return [(k["a"], dp.all_to_all(g, k["axis_name"], k["axis_size"], k["concat_dim"],
                                       k["split_dim"]))]

    @register_backward_rule(ids.WAIT)
    def _wait_bw(bsym, *gs):
        return pairs(bsym.args[0], gs)

    @register_backward_rule(ids.SYNCHRONIZE)
    def _synchronize_bw(bsym, *gs):
        k = _dist_args(bsym, ("a", "axis_name", "axis_size", "sharded", "dim"),
                       {"axis_size": 1, "sharded": False, "dim": 0})
        n = int(k["axis_size"])
        if k["sharded"]:
            got = dp.reduce_scatter(packed(k["a"], gs), k["axis_name"], n, k["dim"], ops.MEAN)
        else:
            got = dp.all_reduce(packed(k["a"], gs), k["axis_name"], ops.MEAN)
        return pairs(k["a"], got if isinstance(got, tuple) else (got,))


#
# Generic fallback: synthesize a VJP from the prim's torch implementation.
# (analog of reference vjp_utils.make_aug_forward_and_backward)
#


# Synthesized-VJP operators cached by (prim, arg structure, static args): the
# closure bakes in the bsym's non-tensor args, so call sites sharing prim +
# structure + static values share one operator.  Caching here (not per call
# site) keeps the executor's implmap bounded across recompiles in a long-lived
# process and makes generated program names reproducible.
_generic_vjp_cache: dict[tuple, Any] = {}
# objects keyed by id() in the cache, kept alive so CPython can't reuse the id
_generic_vjp_pinned: list[Any] = []


def devalue_static_arg(x, *, owner: str = "?"):
    """Non-tensor proxies are replaced by their concrete value: the value is
    what the runtime impl needs (a proxy object would crash it), and it gives
    rule caches a value-stable key across recompiles (identity or name keys
    would defeat the cache every trace).  Shared by the generic VJP fallback
    and the vmap/jvp rule synthesis (core/batching.py)."""
    if isinstance(x, TensorProxy) or not isinstance(x, Proxy):
        return x
    v = getattr(x, "value", None)
    if v is None:
        raise NotImplementedError(
            f"cannot bake symbolic (unknown-value) arg {x} of {owner} into a "
            f"synthesized rule; register an explicit rule"
        )
    return v


def static_arg_key(x):
    """Value-faithful, hashable cache-key component for a (devalued) static
    arg.  repr() would truncate big numpy arrays (silent wrong sharing) or
    embed memory addresses (silent cache misses → registry leaks)."""
    import torch

    if isinstance(x, TensorProxy):
        return "·"
    if isinstance(x, (bool, int, float, complex, str, bytes, type(None))):
        return x
    if isinstance(x, (_np.ndarray, torch.Tensor)):
        arr = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else _np.asarray(x)
        return ("ndarray", arr.shape, str(arr.dtype), hashlib.sha1(arr.tobytes()).hexdigest())
    try:
        hash(x)
        return x
    except TypeError:
        # unhashable & unknown: per-object key, pinned alive so the id can't
        # be recycled onto a different value
        _generic_vjp_pinned.append(x)
        return ("id", id(x))


def _generic_vjp_rule(bsym: BoundSymbol, *cotangents):
    import torch

    from thunder_tpu_torch.executors.torchex import prim_impls
    from thunder_tpu_torch.extend import get_executor

    impl = prim_impls.get(bsym.sym.id)
    if impl is None:
        raise NotImplementedError(f"No backward rule or torch impl for {bsym.sym.name}")

    tensor_args = [x for x in bsym.flat_args if isinstance(x, TensorProxy)]
    diff_idx = [i for i, x in enumerate(tensor_args) if dtypes.is_inexact_dtype(x.dtype)]
    if not diff_idx:
        return []

    def _devalue(x):
        return devalue_static_arg(x, owner=bsym.sym.name)

    _key_static = static_arg_key

    flat_args, spec = tree_flatten((bsym.args, bsym.kwargs))
    flat_args = [_devalue(x) for x in flat_args]
    tensor_positions = [i for i, x in enumerate(flat_args) if isinstance(x, TensorProxy)]
    n_tensors = len(tensor_args)

    static_sig = tuple(_key_static(x) for x in flat_args)
    key = (bsym.sym.id, n_tensors, spec, static_sig)
    op = _generic_vjp_cache.get(key)

    if op is None:
        # Tensor slots are cleared so the cached closure doesn't pin the
        # first trace's proxies (and their trace state) alive for the
        # process lifetime; they're overwritten with runtime values anyway.
        closure_args = [
            None if i in set(tensor_positions) else v for i, v in enumerate(flat_args)
        ]
        wrt = tuple(diff_idx)

        # Tensor values are substituted at call time, so the operator is
        # shape-polymorphic: its meta derives output proxies from the call's
        # leading n_tensors arguments, and torch.func.vjp sees the runtime
        # shapes.  Only the inexact tensors are differentiated; the others
        # (indices, masks) get zeros, which the split never accumulates.
        def _vjp_fn(*vals):
            tensor_vals, cts = list(vals[:n_tensors]), vals[n_tensors:]

            def _fn(*diff_vals):
                tv = list(tensor_vals)
                for i, v in zip(wrt, diff_vals):
                    tv[i] = v
                full = list(closure_args)
                for pos, v in zip(tensor_positions, tv):
                    full[pos] = v
                args2, kwargs2 = tree_unflatten(full, spec)
                return impl(*args2, **kwargs2)

            _, pullback = torch.func.vjp(_fn, *(tensor_vals[i] for i in wrt))
            ct = cts[0] if len(cts) == 1 else tuple(cts)
            got = dict(zip(wrt, pullback(ct)))
            return tuple(
                got[i] if i in got else torch.zeros_like(t) for i, t in enumerate(tensor_vals)
            )

        torch_ex = get_executor("torch")
        op = torch_ex.register_operator(
            f"vjp_{bsym.sym.name}_{len(_generic_vjp_cache)}",
            meta=lambda *a: tuple(
                TensorProxy(shape=t.shape, device=t.device, dtype=t.dtype, requires_grad=False)
                for t in a[:n_tensors]
            ),
            fn=_vjp_fn,
        )
        _generic_vjp_cache[key] = op

    grads = op(*tensor_args, *cotangents)
    return [(t, gt) for t, gt in zip(tensor_args, grads)]


#
# The fw/bw split
#


def flatten_to_prims(bsyms: Sequence[BoundSymbol]) -> list[BoundSymbol]:
    """Recursively expands composites down to prims (keeps RETURN etc.)."""
    out: list[BoundSymbol] = []
    for bsym in bsyms:
        if bsym.sym.is_prim or not bsym.subsymbols:
            out.append(bsym)
        else:
            out.extend(flatten_to_prims(bsym.subsymbols))
    return out


def forward_and_backward_from_trace(trace: TraceCtx) -> tuple[TraceCtx, TraceCtx]:
    """Splits a computation trace into forward and backward traces.

    Contract (reference transforms.py:3793): the forward trace returns
    ``(original_output, saved_for_backward)``; the backward trace has signature
    ``backward(*saved_for_backward, *cotangents)`` and returns gradients for
    every input tensor proxy with ``requires_grad``, in input order.
    """
    flat_bsyms = flatten_to_prims(trace.bound_symbols)

    # collect the trace's return bsym / outputs
    return_bsym = None
    for bsym in flat_bsyms:
        if bsym.sym.id == PrimIDs.RETURN:
            return_bsym = bsym
    check(return_bsym is not None, lambda: "Trace has no return")
    output = return_bsym.args[0] if len(return_bsym.args) == 1 else tuple(return_bsym.args)
    flat_outs, out_spec = tree_flatten(output)
    out_tensors = [o for o in flat_outs if isinstance(o, TensorProxy) and dtypes.is_inexact_dtype(o.dtype)]

    grad_inputs = [p for p in trace.args if isinstance(p, TensorProxy) and p.requires_grad]
    check(len(grad_inputs) > 0, lambda: "No differentiable inputs (requires_grad) found")
    check(len(out_tensors) > 0, lambda: "No differentiable outputs found")

    #
    # Build the backward trace
    #
    bw_trace = TraceCtx(None)
    bw_trace.tags.add(TraceTag.BACKWARD)
    # reserve names of all fw proxies so bw-created proxies don't collide
    bw_trace.names = set(trace.names)

    with tracectx(bw_trace):
        cotangents = [
            TensorProxy(shape=o.shape, device=o.device, dtype=o.dtype, requires_grad=False)
            for o in out_tensors
        ]

        grad_map: dict[str, TensorProxy] = {}

        def accumulate(p: TensorProxy, g: TensorProxy):
            if g is None:
                return
            if tuple(g.shape) != tuple(p.shape):
                g = _sum_to_shape(g, p.shape)
            if dtypes.is_inexact_dtype(p.dtype) and not dtypes.are_same_dtypes(g.dtype, p.dtype):
                g = clang.maybe_convert_to_dtype(g, p.dtype)
            prior = grad_map.get(p.name)
            grad_map[p.name] = g if prior is None else clang.add(prior, g)

        for o, ct in zip(out_tensors, cotangents):
            accumulate(o, ct)

        # which proxies (by name) need grads: walk backwards from outputs
        needs_grad: set[str] = {p.name for p in grad_inputs}
        for bsym in flat_bsyms:
            if bsym.sym.id in (PrimIDs.RETURN, PrimIDs.DEL, PrimIDs.COMMENT):
                continue
            if any(
                isinstance(x, TensorProxy) and x.name in needs_grad for x in bsym.flat_proxy_args
            ):
                for o in bsym.flat_proxy_outs:
                    if isinstance(o, TensorProxy) and dtypes.is_inexact_dtype(o.dtype):
                        needs_grad.add(o.name)

        for bsym in reversed(flat_bsyms):
            if bsym.sym.id in (PrimIDs.RETURN, PrimIDs.DEL, PrimIDs.COMMENT):
                continue
            if bsym.sym.id in nondifferentiable_ids:
                continue
            if not any(o.name in needs_grad for o in bsym.flat_proxy_outs if isinstance(o, TensorProxy)):
                continue
            outs = [o for o in bsym.flat_outs if isinstance(o, TensorProxy)]
            # identity records (output proxy is an input proxy, e.g. no-op
            # ``to``): the cotangent already lives under the same name
            arg_names = {a.name for a in bsym.flat_proxy_args}
            if not bsym.subsymbols and all(o.name in arg_names for o in outs):
                continue
            cts = [grad_map.get(o.name) for o in outs]
            if all(ct is None for ct in cts):
                continue
            rule = backward_rules.get(bsym.sym.id, _generic_vjp_rule)
            # the backward ops a rule records inherit the FORWARD bsym's
            # source provenance: a NaN surfacing in the backward trace then
            # names the user line whose gradient produced it
            with provenance_inherited(bsym):
                if not getattr(rule, "_accepts_none_cotangents", False):
                    cts = [
                        ct if ct is not None else clang.full_like(o, 0.0)
                        for ct, o in zip(cts, outs)
                    ]
                pairs = rule(bsym, *cts)
                for inp, g in pairs:
                    if isinstance(inp, TensorProxy) and inp.name in needs_grad and dtypes.is_inexact_dtype(inp.dtype):
                        accumulate(inp, g)

        input_grads = []
        for p in grad_inputs:
            g = grad_map.get(p.name)
            if g is None:
                g = clang.full_like(p, 0.0)
            input_grads.append(g)
        prims.python_return(tuple(input_grads))

    #
    # saved_for_backward = fw proxies the bw trace consumes
    #
    bw_produced: set[str] = set()
    for ct in cotangents:
        bw_produced.add(ct.name)
    for bsym in bw_trace.bound_symbols:
        for o in bsym.flat_proxy_outs:
            bw_produced.add(o.name)

    fw_names = set()
    for bsym in flat_bsyms:
        for o in bsym.flat_proxy_outs:
            fw_names.add(o.name)
    for p in trace.args:
        if isinstance(p, Proxy):
            fw_names.add(p.name)

    saved_names: list[str] = []
    seen: set[str] = set()
    for bsym in bw_trace.bound_symbols:
        for a in bsym.flat_proxy_args:
            if a.name in fw_names and a.name not in bw_produced and a.name not in seen:
                seen.add(a.name)
                saved_names.append(a.name)

    name_to_proxy: dict[str, Proxy] = {}
    for p in trace.args:
        if isinstance(p, Proxy):
            name_to_proxy[p.name] = p
    for bsym in flat_bsyms:
        for o in bsym.flat_proxy_outs:
            name_to_proxy.setdefault(o.name, o)
    saved = [name_to_proxy[n] for n in saved_names]

    #
    # Forward trace: flattened prims + modified return
    #
    fw_trace = from_trace(trace)
    fw_trace.tags.add(TraceTag.AUGMENTED_FORWARD)
    fw_bsyms = [b for b in flat_bsyms if b.sym.id != PrimIDs.RETURN]
    with tracectx(fw_trace):
        fw_bsyms.append(prims.python_return.bind(output, tuple(saved), output=None))
    fw_trace.bound_symbols = fw_bsyms
    fw_trace.set_provenance("Augmented forward pass")

    # backward signature: (*saved, *cotangents)
    bw_args = list(saved) + list(cotangents)
    bw_si = SigInfo(name="backward", args=[(p.name, None) for p in bw_args])
    bw_trace.set_siginfo(bw_si)
    bw_trace.args = tuple(bw_args)
    bw_trace.set_provenance("Backward pass")
    bw_trace = dce(bw_trace)

    return fw_trace, bw_trace


#
# User-facing grad APIs
#


def value_and_grad(fn: Callable, argnums: int | Sequence[int] = 0, **jit_kwargs) -> Callable:
    """Compiles ``fn`` and returns ``wrapped(*args) -> (value, grads)``.

    ``fn`` must return a scalar (the loss).  ``grads`` matches the structure of
    the selected arguments.  The forward and backward are separately compiled
    programs sharing a minimal saved-residuals set — the reference's
    fw/bw-split contract, exposed jax-style.
    """
    import thunder_tpu_torch as ttpu

    if isinstance(argnums, int):
        argnums = (argnums,)
    argnums = tuple(argnums)

    cfn = ttpu.jit(fn, _grad_argnums=argnums, **jit_kwargs)

    def wrapped(*args, **kwargs):
        return cfn(*args, **kwargs)

    wrapped._lc_cd = cfn._lc_cd
    wrapped._lc_cs = cfn._lc_cs
    wrapped.__wrapped__ = fn
    return wrapped


def grad(fn: Callable, argnums: int | Sequence[int] = 0, **jit_kwargs) -> Callable:
    """Like ``value_and_grad`` but returns only the gradients."""
    vg = value_and_grad(fn, argnums, **jit_kwargs)

    def wrapped(*args, **kwargs):
        _, grads = vg(*args, **kwargs)
        return grads

    wrapped._lc_cd = vg._lc_cd
    wrapped._lc_cs = vg._lc_cs
    wrapped.__wrapped__ = fn
    return wrapped
