"""Per-trace live/peak-bytes accounting keyed to ``del_last_used`` placement.

Counterpart of ``thunder_tpu/observability/memory.py``, copied.  The single liveness walk behind ``examine.memory_estimate`` and the
live/peak columns in ``profile_stats``: inputs start live, each bound
symbol's new tensor outputs allocate, each ``del`` frees, and the running
sum/peak are recorded per symbol.  This is a static estimate over proxy
shapes — the ceiling the caching allocator's reuse (and a fusion region's
hidden intermediates) then improves on — which is exactly what capacity
planning wants: if the estimate fits the card's memory, the program fits.
"""
from __future__ import annotations

from thunder_tpu_torch.core.prims import PrimIDs
from thunder_tpu_torch.core.proxies import TensorProxy
from thunder_tpu_torch.core.trace import TraceCtx

__all__ = ["tensor_nbytes", "memory_timeline"]


def tensor_nbytes(p) -> int:
    """Bytes of one tensor proxy (0 for non-tensors)."""
    if not isinstance(p, TensorProxy):
        return 0
    n = 1
    for s in p.shape:
        n *= int(s)
    return n * p.dtype.bytes


def memory_timeline(trace: TraceCtx) -> dict:
    """Walks ``trace`` with del-aware liveness and returns::

        {
          "rows": [...],              # aligned with trace.bound_symbols
          "input_bytes": int,
          "output_bytes": int,
          "peak_bytes_estimate": int,
        }

    where each row is ``{"live_bytes", "peak_bytes"}`` — the live-set size
    right after that symbol executes (before any following ``del``) and the
    running peak up to and including it.

    Donation-aware: a fusion bound symbol annotated by the donation pass
    (``executors/donation.py`` sets ``bsym._donation``) releases its donated
    input buffers AS it executes — the region releases their storage, which
    the allocator hands to the region's outputs (the input→output alias
    pattern) or scratch — so the peak at that symbol
    is ``live - donated + outputs`` instead of ``live + outputs``.  The total
    reclaimed this way is returned as ``donated_bytes``.
    """
    inputs = sum(tensor_nbytes(p) for p in (trace.args or ()) if isinstance(p, TensorProxy))
    outputs = 0
    donated_total = 0
    live: dict[str, int] = {}
    for p in trace.args or ():
        if isinstance(p, TensorProxy):
            live[p.name] = tensor_nbytes(p)
    cur = sum(live.values())
    peak = cur

    rows: list[dict] = []
    for bsym in trace.bound_symbols:
        if bsym.sym.id == PrimIDs.RETURN:
            outputs = sum(tensor_nbytes(p) for p in bsym.flat_proxy_args)
            rows.append({"live_bytes": cur, "peak_bytes": peak})
            continue
        if bsym.sym.id == PrimIDs.DEL:
            for p in bsym.flat_proxy_args:
                cur -= live.pop(p.name, 0)
            rows.append({"live_bytes": cur, "peak_bytes": peak})
            continue
        donation = getattr(bsym, "_donation", None)
        if donation:
            # donated buffers are dead the moment the region runs (proven by
            # the analysis); the following DEL then pops nothing
            for name in donation["donated"]:
                freed = live.pop(name, 0)
                cur -= freed
                donated_total += freed
        for o in bsym.flat_proxy_outs:
            if o.name not in live:
                b = tensor_nbytes(o)
                live[o.name] = b
                cur += b
        peak = max(peak, cur)
        rows.append({"live_bytes": cur, "peak_bytes": peak})

    return {
        "rows": rows,
        "input_bytes": inputs,
        "output_bytes": outputs,
        "peak_bytes_estimate": peak,
        "donated_bytes": donated_total,
    }
