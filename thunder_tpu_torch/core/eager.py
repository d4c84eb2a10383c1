"""Eager execution of the port's symbols on concrete tensors.

Counterpart of ``thunder_tpu/core/eager.py``.  Calling a Symbol outside a
trace records it into a throwaway micro-trace and immediately evaluates
that trace with the torch executor's implementations (``torchex``).  The
evaluation is plain torch code, so it also works inside ``torch.func``
transforms (``grad``, ``vmap``, ``jvp``), which take the place of the
reference's JAX tracers: ltorch-built code runs under them unchanged.  The
kernel-backed implementations (SDPA, its backward, cross-entropy) launch
the flash kernels on CUDA tensors, and ``torch.func`` cannot see inside
those.
"""
from __future__ import annotations

from typing import Any

__all__ = ["eager_symbol_eval"]


def eager_symbol_eval(sym, args: tuple, kwargs: dict) -> Any:
    """Runs one symbol call eagerly: trace → evaluate → return concrete values."""
    import torch

    from thunder_tpu_torch.core.proxies import NumberProxy, Proxy, StringProxy, tensorproxy
    from thunder_tpu_torch.core.pytree import tree_flatten, tree_unflatten
    from thunder_tpu_torch.core.trace import TraceCtx, tracectx
    from thunder_tpu_torch.executors.utils import eval_bsyms

    trace = TraceCtx(None)
    env: dict[str, Any] = {}
    flat, spec = tree_flatten((tuple(args), dict(kwargs)))
    with tracectx(trace):
        pflat = []
        for x in flat:
            if isinstance(x, torch.Tensor):
                p = tensorproxy(x)
                env[p.name] = x
                pflat.append(p)
            else:
                pflat.append(x)
        pargs, pkwargs = tree_unflatten(pflat, spec)
        out = sym(*pargs, **pkwargs)
    eval_bsyms(trace.bound_symbols, env)

    def sub(o):
        if isinstance(o, (NumberProxy, StringProxy)):
            return o.value if o.value is not None else env[o.name]
        if isinstance(o, Proxy):
            return env[o.name]
        return o

    oflat, ospec = tree_flatten(out)
    return tree_unflatten([sub(o) for o in oflat], ospec)
