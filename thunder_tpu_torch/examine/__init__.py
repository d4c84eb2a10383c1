"""examine(): support reporting and debug tooling.

Counterpart of ``thunder_tpu/examine/__init__.py``: ``examine``,
``get_fusion_symbols``, ``get_fusions``, ``memory_estimate``,
``memory_timeline`` and ``train_memory_report`` as the reference's, over
the port's traces (fusion regions are the inductor executor's).
``HW_PEAKS`` has one row, the card's.  ``cost_analysis`` asked XLA's cost
model in the reference; it raises until the port has a roofline that reads
the same work whatever implements it (``ROADMAP.md`` Queue 1 item 7's
remainder).  The reference is the capability analog of the reference's ``thunder/examine/__init__.py:49`` —
runs a function under a collection mode, reports which torch operations are
(un)supported by the tracer, tries the jit, and prints a repro template.
Plus ``get_fusions`` (``:190``) and a trace memory calculator
(``examine/memory_caculation.py``).
"""
from __future__ import annotations

import collections
from typing import Any, Callable

__all__ = [
    "examine",
    "get_fusions",
    "get_fusion_symbols",
    "memory_estimate",
    "memory_timeline",
    "train_memory_report",
    "cost_analysis",
]


def _collect_torch_functions(fn, args, kwargs):
    """Runs ``fn`` on real torch tensors under TorchFunctionMode, collecting
    every torch callable used (reference CollectFunctionsUsed)."""
    import torch

    calls: dict[str, Any] = {}

    class Collect(torch.overrides.TorchFunctionMode):
        def __torch_function__(self, func, types, f_args=(), f_kwargs=None):
            f_kwargs = f_kwargs or {}
            qn = getattr(func, "__qualname__", None) or str(func)
            mod = getattr(func, "__module__", "") or ""
            calls.setdefault(f"{mod}.{qn}" if mod else qn, func)
            return func(*f_args, **f_kwargs)

    with Collect():
        result = fn(*args, **kwargs)
    return calls, result


def examine(fn: Callable, *args, **kwargs) -> bool:
    """Reports whether ``fn`` can run through thunder_tpu_torch.jit and why not.

    Returns True when everything checked out.  Never raises — the reference's
    contract is "doesn't crash the user program".
    """
    import torch

    from thunder_tpu_torch.torch import _torch_to_thunder_function_map

    if not callable(fn):
        print(f"examine(): expected a callable, got {type(fn)}")
        return False

    # Step 1: run eagerly, collect the torch surface used
    try:
        calls, torch_result = _collect_torch_functions(fn, args, kwargs)
    except Exception as e:
        print(f"examine(): the function failed outside thunder_tpu_torch ({type(e).__name__}: {e}); "
              "fix that first")
        return False

    known = set(_torch_to_thunder_function_map)
    unsupported = {name: f for name, f in calls.items() if isinstance(f, Callable) and f not in known and not _is_benign(f)}

    if unsupported:
        print(f"Found {len(unsupported)} distinct operation(s) not supported by the tracer:")
        for name in sorted(unsupported):
            print(f"  {name}")
        print(
            "\nRepro template for an operator request:\n"
            "  import thunder_tpu_torch as ttt\n"
            "  def repro(...):  # minimal fn using the op above\n"
            "      ...\n"
            "  ttt.jit(repro)(...)\n"
        )
    else:
        print(f"All {len(calls)} collected operations are supported by the tracer")

    # Step 2: try the jit and compare
    try:
        import thunder_tpu_torch as ttt

        jfn = ttt.jit(fn)
        jit_result = jfn(*args, **kwargs)
        diverged = False
        if isinstance(jit_result, torch.Tensor) and isinstance(torch_result, torch.Tensor) \
                and jit_result.shape == torch_result.shape:
            ok = torch.allclose(jit_result.detach().float(), torch_result.detach().float(),
                                rtol=1e-3, atol=1e-4)
            diverged = not ok
            print("jit result matches eager torch" if ok else
                  "WARNING: jit result DIVERGES from eager torch")
        print("thunder_tpu_torch.jit compiled and ran the function successfully")
        return not unsupported and not diverged
    except Exception as e:
        print(f"thunder_tpu_torch.jit failed: {type(e).__name__}: {e}")
        return False


def _is_benign(func) -> bool:
    """Attribute accesses and dunder plumbing that need no tracer support."""
    qn = getattr(func, "__qualname__", "") or ""
    return qn.startswith(("Tensor.__", "Tensor.shape", "Tensor.dtype", "Tensor.device", "_has_torch_function"))


def get_fusion_symbols(trace) -> list:
    """All fusion bound symbols (inductor regions) in ``trace``
    (reference examine/__init__.py:190 get_fusions)."""
    out = []
    for bsym in trace.bound_symbols:
        if getattr(bsym.sym, "is_fusion", False):
            out.append(bsym)
    return out


def get_fusions(trace) -> list[tuple[str, Callable]]:
    """(name, callable) for each fusion region in ``trace``."""
    out = []
    for bsym in get_fusion_symbols(trace):
        ctx = bsym._call_ctx or {}
        for name, fusion in ctx.items():
            out.append((name, fusion))
    return out


def memory_estimate(trace) -> dict[str, int]:
    """Bytes of inputs / outputs / peak-intermediate estimate for a trace
    (reference examine/memory_caculation.py).  The intermediate estimate
    walks the trace with del-aware liveness (the shared pass in
    ``observability/memory.py``): it is the ceiling the allocator's reuse
    then improves on.  Donation-aware: on a trace compiled with
    ``ttt.jit(fn, donate=...)`` the peak reflects donated buffers being
    reclaimed at their consuming region, and ``donated_bytes`` reports the
    total reclaimed that way.  ``memory_timeline(trace)`` returns the
    per-symbol live/peak rows behind this summary."""
    from thunder_tpu_torch.observability.memory import memory_timeline

    t = memory_timeline(trace)
    return {
        "input_bytes": t["input_bytes"],
        "output_bytes": t["output_bytes"],
        "peak_bytes_estimate": t["peak_bytes_estimate"],
        "donated_bytes": t["donated_bytes"],
    }


def memory_timeline(trace) -> dict:
    """Per-symbol live/peak-bytes rows for ``trace`` (del-aware liveness,
    keyed to ``del_last_used`` placement) — see
    ``thunder_tpu_torch.observability.memory.memory_timeline``."""
    from thunder_tpu_torch.observability.memory import memory_timeline as _mt

    return _mt(trace)


def train_memory_report(train_step) -> dict:
    """Memory accounting for a built ``TrainStep``: the donation-aware fw/bw
    peaks, the remat policy + residual-bytes delta it bought and the
    accumulation buffer (``TrainStep.profile_stats()``, surfaced here so the
    examine toolkit covers training-step memory the way ``memory_estimate``
    covers a single trace).  Requires the step to have run (built) at least
    once."""
    return dict(train_step.profile_stats())


# hardware peaks (bf16 FLOP/s, memory bytes/s) by device kind, the one
# source of truth for roofline math: NVIDIA H100 80GB HBM3 (SXM) at its
# 700 W power limit; a card held below that runs slower under load
HW_PEAKS: dict[str, tuple[float, float]] = {
    "cuda": (989e12, 3.35e12),
}


def cost_analysis(fn: Callable, *args, flops_per_sec: float | None = None,
                  bytes_per_sec: float | None = None) -> dict:
    """The reference asks XLA's cost model for ``fn``'s FLOPs and bytes at
    ``args``; the port has no cost model that reads the same work whatever
    implements it, so this raises."""
    raise NotImplementedError(
        "cost_analysis needs a roofline that reads the same work whatever implements it; "
        "the reference asks XLA's cost model, which the port has no counterpart of "
        "(ROADMAP.md Queue 1 item 7's remainder)")
