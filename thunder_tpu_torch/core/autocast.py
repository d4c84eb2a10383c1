"""Autocast: a trace→trace transform downcasting matmul-class ops.

Counterpart of ``thunder_tpu/core/autocast.py``, copied.  The reference is
the parity of ``thunder/core/transforms.py:3952-4031``: the inputs of
matmul/linear/SDPA go to a low-precision dtype while precision-sensitive
ops (norms, softmax, losses) keep their incoming dtype.  The policy keys off
the ``OpTags.MATMUL_OP`` tag that every matmul-class prim (matmul, linear,
convolution, sdpa) carries, and the transform is a *retrace*: each top-level
bound symbol is re-called under a fresh trace with (possibly converted)
inputs, so dtype propagation through metas is automatic and the result
composes with the fw/bw split like any other trace.

On the card the bf16 products accumulate in float32 (cuBLAS, and the flash
kernels' float32 accumulators).

Usage::

    jfn = thunder_tpu_torch.jit(fn, transforms=[autocast()])          # bf16
    jfn = thunder_tpu_torch.jit(fn, autocast="fp16")
"""
from __future__ import annotations

from typing import Any, Callable

from thunder_tpu_torch.core import dtypes
from thunder_tpu_torch.core.prims import OpTags, PrimIDs
from thunder_tpu_torch.core.proxies import Proxy, TensorProxy
from thunder_tpu_torch.core.pytree import tree_flatten, tree_unflatten
from thunder_tpu_torch.core.trace import TraceCtx, from_trace, tracectx

__all__ = ["autocast"]

# dtypes eligible for downcasting (full-precision floats)
_WIDE_FLOATS = (dtypes.float32, dtypes.float64)


def _wants_downcast(bsym) -> bool:
    """True iff the op (or any prim it decomposes to) is matmul-class."""
    if OpTags.MATMUL_OP in bsym.sym.tags:
        return True
    return any(_wants_downcast(sub) for sub in bsym.subsymbols)


def autocast(dtype: Any = None) -> Callable[[TraceCtx], TraceCtx]:
    """Returns a transform for ``thunder_tpu_torch.jit(fn, transforms=[...])``.

    The transform rewrites the computation trace so that every matmul-class
    op receives ``dtype`` (default bfloat16) inputs; all other ops run in
    whatever dtype flows to them (no upcasting — the low-precision outputs
    propagate, matching torch.autocast semantics).
    """
    target = dtypes.to_dtype(dtype) if dtype is not None else dtypes.bfloat16

    def transform(trace: TraceCtx) -> TraceCtx:
        from thunder_tpu_torch import clang

        new_trace = from_trace(trace)
        swap: dict[str, Proxy] = {}

        def _map(x):
            if isinstance(x, Proxy):
                return swap.get(x.name, x)
            return x

        def _cast(x):
            if isinstance(x, TensorProxy) and x.dtype in _WIDE_FLOATS:
                return clang.maybe_convert_to_dtype(x, target)
            return x

        with tracectx(new_trace):
            for bsym in trace.bound_symbols:
                flat, spec = tree_flatten((bsym.args, bsym.kwargs))
                flat = [_map(x) for x in flat]
                if bsym.sym.id is not PrimIDs.RETURN and _wants_downcast(bsym):
                    flat = [_cast(x) for x in flat]
                args, kwargs = tree_unflatten(flat, spec)
                result = bsym.sym(*args, **kwargs)

                old_out, _ = tree_flatten(bsym.output)
                new_out, _ = tree_flatten(result)
                for po, pn in zip(old_out, new_out):
                    if isinstance(po, Proxy) and isinstance(pn, Proxy):
                        swap[po.name] = pn

        new_trace.set_provenance(f"Autocast ({target}) transform")
        return new_trace

    return transform
