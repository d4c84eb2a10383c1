"""The int8 / fp8 quantization executors: weight and activation matmuls at
one byte per value.

Counterpart of ``thunder_tpu/executors/quantex.py``, with its names: ``ex``
(also ``quant_ex``, ``"quant_int8"``) and ``fp8_ex`` (``"quant_fp8"``) claim
``PrimIDs.LINEAR``/``PrimIDs.MATMUL`` and the torch-language ``linear``,
``matmul``, ``mm`` and ``bmm`` where the contraction is at least ``min_k``
(64) and both operands are floating point.  Neither is a default executor:
``jit(..., executors=[quantex.ex, *defaults])``, ``TrainStep(quant=...)``
(forward only) and the serving forwards' ``quantized=`` opt in.

The math is the reference's ``_make_quant_ops`` / ``_quantize_lastdim`` /
``_quantize_fp8_lastdim``:

- per-row absmax over the last dim: activations per token, weights per
  output channel, ``b`` of a matmul per output column;
- the scale is ``amax * f32(1/qmax)`` (1 where ``amax`` is 0): the
  reference runs jitted, and XLA compiles its ``amax / qmax`` into that
  multiply, as ``serving/quant.py`` notes for the quantized KV;
- int8: ``q = clip(round(x / scale), -127, 127)`` (half to even), products
  accumulated in int32, exactly; fp8: ``q = e4m3(x / scale)``, products
  accumulated in float32;
- ``out = f32(acc) * sa * sw``, then the bias in float32, then a cast to
  ``a``'s dtype.

On a CUDA tensor the product is a library call, as the reference's is an
XLA dot outside any Pallas kernel: ``torch._int_mm`` for int8 (exact int32
accumulation, so the result equals the plain version bit for bit) and
``torch._scaled_mm`` for e4m3 (unit scales, float32 out, fast accumulation
off; the reference's scales are applied after, in float32; the sum runs in
its own order, so the result is held within 1e-4 of the output's largest
magnitude, or one ulp of a bf16 output, not bitwise).  ``_int_mm``
takes more than 16 rows and ``_scaled_mm`` multiples of 16, so rows are
padded with zeros (exact) and dropped after; a shape either still refuses
raises.  Each call adds one to ``CALLS``.  On a CPU tensor the plain
version runs, and only there: the product of the quantized values in
float64, which is exact for both formats at any K whose sums stay below
2**31 (int8: integer products of at most 127**2; e4m3: products on a 2**-18
grid below 2**17.6), so int8's is the int32 result and e4m3's the exact sum
rounded once to float32.  The ``*_plain`` functions run it on any device,
the card included, for holding the library calls against it.
"""
from __future__ import annotations

import numpy as np
import torch

from thunder_tpu_torch.core import dtypes
from thunder_tpu_torch.core.prims import PrimIDs, prim_lookup
from thunder_tpu_torch.core.proxies import TensorProxy
from thunder_tpu_torch.extend import OperatorExecutor, register_executor

__all__ = ["CALLS", "ex", "quant_ex", "fp8_ex", "int8_linear", "int8_matmul", "fp8_linear",
           "fp8_matmul", "int8_linear_plain", "int8_matmul_plain", "fp8_linear_plain",
           "fp8_matmul_plain", "min_k", "quantize_lastdim", "quantize_fp8_lastdim",
           "reset_calls"]

# library products launched on the card, by format
CALLS = {"int_mm": 0, "scaled_mm": 0}

# claim threshold on the contraction dim: tiny K has nothing to amortize the
# quantize/dequantize traffic (and error) against
min_k = 64

_FP8 = torch.float8_e4m3fn
_INT8_INV_QMAX = float(np.float32(1.0) / np.float32(127.0))
_FP8_INV_QMAX = float(np.float32(1.0) / np.float32(448.0))


def reset_calls() -> None:
    for name in CALLS:
        CALLS[name] = 0


def _scale(xf, inv_qmax: float):
    amax = xf.abs().amax(dim=-1, keepdim=True)
    return torch.where(amax == 0.0, torch.ones_like(amax), amax * inv_qmax)


def quantize_lastdim(x):
    """absmax int8 over the last dim: ``(q, scale)``, scale (..., 1) float32."""
    xf = x.float()
    scale = _scale(xf, _INT8_INV_QMAX)
    return torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8), scale


def quantize_fp8_lastdim(x):
    """absmax float8_e4m3fn over the last dim: ``(q, scale)``."""
    xf = x.float()
    scale = _scale(xf, _FP8_INV_QMAX)
    return (xf / scale).to(_FP8), scale


def _pad_rows(a, multiple: int, least: int):
    """``a`` (M, K) with zero rows appended up to a multiple of ``multiple``
    and at least ``least`` rows."""
    M = a.shape[0]
    Mp = max(least, -(-M // multiple) * multiple)
    if Mp == M:
        return a
    return torch.cat([a, a.new_zeros(Mp - M, a.shape[1])])


def _mm_int8_plain(qa, qw):
    """``qa`` (M, K) int8 times ``qw`` (N, K) int8 transposed: (M, N) int32,
    by an exact float64 product."""
    return (qa.double() @ qw.double().T).to(torch.int32)


def _mm_fp8_plain(qa, qw):
    """``qa`` (M, K) e4m3 times ``qw`` (N, K) e4m3 transposed: (M, N)
    float32, the exact float64 sum rounded once."""
    return (qa.double() @ qw.double().T).float()


def _mm_int8(qa, qw):
    """``_mm_int8_plain`` by ``torch._int_mm`` on the card."""
    if qa.device.type != "cuda":
        return _mm_int8_plain(qa, qw)
    M = qa.shape[0]
    out = torch._int_mm(_pad_rows(qa.contiguous(), 8, 32), qw.contiguous().T)
    CALLS["int_mm"] += 1
    return out[:M]


def _mm_fp8(qa, qw):
    """``_mm_fp8_plain`` by ``torch._scaled_mm`` on the card (float32
    accumulation)."""
    if qa.device.type != "cuda":
        return _mm_fp8_plain(qa, qw)
    M = qa.shape[0]
    one = torch.ones((), dtype=torch.float32, device=qa.device)
    out = torch._scaled_mm(_pad_rows(qa.contiguous(), 16, 16), qw.contiguous().T,
                           scale_a=one, scale_b=one, out_dtype=torch.float32,
                           use_fast_accum=False)
    CALLS["scaled_mm"] += 1
    return (out[0] if isinstance(out, tuple) else out)[:M]


def _make_quant_ops(quantize_fn, mm_fn):
    """The (linear, matmul) pair of one format: ``quantize_fn(x) -> (q,
    scale)`` over the last dim, ``mm_fn(qa, qb) -> acc`` of (M, K) by
    (N, K) operands.  Shared by both formats so their scale handling cannot
    drift apart."""

    def q_linear(a, w, bias=None):
        qa, sa = quantize_fn(a)                        # (..., K), (..., 1)
        qw, sw = quantize_fn(w)                        # (N, K), (N, 1)
        K = a.shape[-1]
        acc = mm_fn(qa.reshape(-1, K), qw).reshape(*a.shape[:-1], w.shape[0])
        out = acc.float() * sa * sw.reshape(-1)
        if bias is not None:
            out = out + bias.float()
        return out.to(a.dtype)

    def q_matmul(a, b):
        if a.ndim == 1 or b.ndim == 1:                 # matvec paths gain nothing; stay exact
            return torch.matmul(a, b)
        qa, sa = quantize_fn(a)                        # (..., M, K), (..., M, 1)
        qb, sb = quantize_fn(b.float().transpose(-1, -2))   # per output column: (..., N, K)
        batch = torch.broadcast_shapes(qa.shape[:-2], qb.shape[:-2])
        M, K, N = qa.shape[-2], qa.shape[-1], qb.shape[-2]
        if not qb.shape[:-2] or all(n == 1 for n in qb.shape[:-2]):
            acc = mm_fn(qa.reshape(-1, K), qb.reshape(N, K))
            acc = acc.reshape(*qa.shape[:-1], N).expand(*batch, M, N)
        else:
            qa_b = qa.expand(*batch, M, K).reshape(-1, M, K)
            qb_b = qb.expand(*batch, N, K).reshape(-1, N, K)
            acc = torch.stack([mm_fn(x, y) for x, y in zip(qa_b, qb_b)]).reshape(*batch, M, N)
        out = acc.float() * sa * sb.transpose(-1, -2)
        return out.to(a.dtype)

    return q_linear, q_matmul


# int8: per-token activations, per-output-channel weights, int32 products
int8_linear, int8_matmul = _make_quant_ops(quantize_lastdim, _mm_int8)
int8_linear_plain, int8_matmul_plain = _make_quant_ops(quantize_lastdim, _mm_int8_plain)
# fp8 (e4m3): the same scaling onto ±448, float32 products
fp8_linear, fp8_matmul = _make_quant_ops(quantize_fp8_lastdim, _mm_fp8)
fp8_linear_plain, fp8_matmul_plain = _make_quant_ops(quantize_fp8_lastdim, _mm_fp8_plain)


def _linear_checker(a, w, bias=None):
    if not isinstance(a, TensorProxy) or not isinstance(w, TensorProxy):
        return False
    if not (dtypes.is_float_dtype(a.dtype) and dtypes.is_float_dtype(w.dtype)):
        return False
    return w.shape[-1] >= min_k


def _matmul_checker(a, b):
    if not isinstance(a, TensorProxy) or not isinstance(b, TensorProxy):
        return False
    if not (dtypes.is_float_dtype(a.dtype) and dtypes.is_float_dtype(b.dtype)):
        return False
    if a.ndim < 2 or b.ndim < 2:
        return False
    return a.shape[-1] >= min_k


def _register_quant(executor, prefix, q_linear, q_matmul):
    linear_op = executor.register_operator(f"{prefix}_linear", like=prim_lookup[PrimIDs.LINEAR],
                                           fn=q_linear)
    matmul_op = executor.register_operator(f"{prefix}_matmul", like=prim_lookup[PrimIDs.MATMUL],
                                           fn=q_matmul)
    executor.register_implementation(PrimIDs.LINEAR, linear_op, checker=_linear_checker)
    executor.register_implementation(PrimIDs.MATMUL, matmul_op, checker=_matmul_checker)
    # the claiming pass consults executors before a composite is decomposed,
    # so the torch-language symbols are claimable directly (same signatures
    # as the prims)
    executor.register_implementation("torch.linear", linear_op, checker=_linear_checker)
    executor.register_implementation("torch.matmul", matmul_op, checker=_matmul_checker)
    executor.register_implementation("torch.mm", matmul_op, checker=_matmul_checker)
    executor.register_implementation("torch.bmm", matmul_op, checker=_matmul_checker)


ex = OperatorExecutor("quant_int8", version="0.1")
quant_ex = ex
register_executor(ex)
_register_quant(ex, "int8", int8_linear, int8_matmul)

fp8_ex = OperatorExecutor("quant_fp8", version="0.1")
register_executor(fp8_ex)
_register_quant(fp8_ex, "fp8", fp8_linear, fp8_matmul)
