"""Debug-hook transform and anomaly detection over the execution trace.

Counterpart of ``thunder_tpu/observability/debug.py``: pre/post callbacks
on every executed BoundSymbol, and the half of
``torch.autograd.set_detect_anomaly`` that matters for compiled programs:
which op produced the NaN, and which user line wrote that op.

A post-lowering pass (`instrument_for_debugging`), of the same shape as the
profiler's (`observability/profiler.py`), swaps every claimed BoundSymbol /
fusion region for a wrapper whose ``python_impl`` invokes user callbacks
around the original callable:

* ``pre(info, args, kwargs)`` before the symbol executes,
* ``post(info, result)`` after it,

where ``info`` is a :class:`SymbolInfo` carrying the symbol name, its trace
("computation"/"backward"), and the source provenance recorded at trace
time and threaded through claiming (for a fused region: the list of every
user line folded into it).

Anomaly detection is a built-in post check (``ttt.jit(fn,
detect_anomalies=True)`` or ``THUNDER_TPU_DETECT_ANOMALIES=1``): each
instrumented symbol's outputs are scanned for NaN/Inf and the first hit
raises a structured :class:`AnomalyError` naming the symbol, the user
file:line(s) that produced it, the offending output, and a one-command repro
hint.  The scan reads one flag per floating output back to the host, so on
the card it synchronizes after every symbol: a debugging mode, and only
when asked for.

Both features are off by default, and off means off: the pass never runs and
the generated execution program is byte-identical to the uninstrumented one.

Debug-hook exceptions are not swallowed (unlike metrics hooks): hooks here
exist to stop the program at the first bad symbol, so a raise, including
``AnomalyError``, propagates out of the compiled call.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable

from thunder_tpu_torch.core.pytree import tree_flatten
from thunder_tpu_torch.core.symbol import BoundSymbol, Symbol, gather_provenance
from thunder_tpu_torch.core.trace import TraceCtx, TraceProvenance, from_trace
from thunder_tpu_torch.observability.metrics import registry
from thunder_tpu_torch.observability.profiler import (
    _resolve_callable,
    _sanitize,
    _should_skip,
)

__all__ = [
    "SymbolInfo",
    "AnomalyError",
    "instrument_for_debugging",
    "resolve_debug_hooks",
]


@dataclass(frozen=True)
class SymbolInfo:
    """What a debug hook learns about the symbol it fires around."""

    name: str  # symbol name (Inductor0, torch_linear, cuda_sdpa, ...)
    index: int  # position in its trace
    trace: str  # "computation" | "backward"
    is_fusion: bool
    provenance: tuple  # ((filename, position), ...) — user lines, in order

    def format_provenance(self, limit: int = 3) -> str:
        """``file:line`` of the first user sites (``+N more`` beyond limit)."""
        if not self.provenance:
            return "<no user source recorded>"
        parts = [f"{f}:{p}" for f, p in self.provenance[:limit]]
        extra = len(self.provenance) - limit
        if extra > 0:
            parts.append(f"(+{extra} more)")
        return ", ".join(parts)


class AnomalyError(RuntimeError):
    """A NaN/Inf surfaced in an instrumented symbol's output.

    Structured fields: ``kind`` ("nan"/"inf"), ``symbol``, ``trace``,
    ``output_index``, ``nan_count``/``inf_count``, and ``provenance`` — the
    ``(filename, position)`` pairs of the user code that produced the symbol
    (a list for fused regions).
    """

    def __init__(
        self,
        *,
        kind: str,
        info: SymbolInfo,
        output_index: int,
        nan_count: int,
        inf_count: int,
        shape: tuple,
        dtype: str,
    ):
        self.kind = kind
        self.symbol = info.name
        self.trace = info.trace
        self.provenance = info.provenance
        self.output_index = output_index
        self.nan_count = nan_count
        self.inf_count = inf_count
        super().__init__(
            f"anomaly ({kind}) in output {output_index} of symbol "
            f"{info.name!r} ({info.trace} trace): {nan_count} NaN / "
            f"{inf_count} Inf in shape {shape} {dtype}\n"
            f"  source: {info.format_provenance()}\n"
            f"  repro: rerun with THUNDER_TPU_DETECT_ANOMALIES=1 (or "
            f"ttt.jit(fn, detect_anomalies=True)) to stop at the first bad "
            f"symbol; ttt.last_traces(cfn)[-1] prints the instrumented program"
        )


def resolve_debug_hooks(hooks: Any) -> tuple[Callable | None, Callable | None]:
    """Normalizes the ``debug_hooks=`` compile option into ``(pre, post)``.

    Accepts ``(pre, post)``, ``{"pre": ..., "post": ...}``, or a single
    callable (treated as a post hook).
    """
    if hooks is None:
        return None, None
    if isinstance(hooks, dict):
        unknown = set(hooks) - {"pre", "post"}
        if unknown:
            raise TypeError(f"debug_hooks dict has unknown keys {sorted(unknown)}")
        return hooks.get("pre"), hooks.get("post")
    if isinstance(hooks, (tuple, list)):
        if len(hooks) != 2:
            raise TypeError(
                f"debug_hooks sequence must be (pre, post), got {len(hooks)} entries"
            )
        return hooks[0], hooks[1]
    if callable(hooks):
        return None, hooks
    raise TypeError(f"debug_hooks must be (pre, post), a dict, or a callable; got {hooks!r}")


def _scan_for_anomalies(info: SymbolInfo, result: Any) -> None:
    """Raises AnomalyError on the first non-finite value in ``result``'s
    floating tensor (or float) leaves.  Reads one flag per leaf back to the
    host: on the card that synchronizes, by design."""
    import torch

    flat, _ = tree_flatten(result)
    for i, x in enumerate(flat):
        if isinstance(x, float):
            if math.isnan(x) or math.isinf(x):
                registry().counter("anomaly.detected").inc()
                raise AnomalyError(
                    kind="nan" if math.isnan(x) else "inf",
                    info=info,
                    output_index=i,
                    nan_count=int(math.isnan(x)),
                    inf_count=int(math.isinf(x)),
                    shape=(),
                    dtype="float",
                )
            continue
        if not isinstance(x, torch.Tensor) or not (x.is_floating_point() or x.is_complex()):
            continue
        if bool(torch.isfinite(x).all()):
            continue
        nan_count = int(torch.isnan(x).sum())
        inf_count = int(torch.isinf(x).sum())
        registry().counter("anomaly.detected").inc()
        raise AnomalyError(
            kind="nan" if nan_count else "inf",
            info=info,
            output_index=i,
            nan_count=nan_count,
            inf_count=inf_count,
            shape=tuple(x.shape),
            dtype=str(x.dtype).removeprefix("torch."),
        )


def _make_debug_wrapper(
    info: SymbolInfo,
    fn: Callable,
    pre: Callable | None,
    post: Callable | None,
    detect_anomalies: bool,
) -> Callable:
    def _debug(*args, **kwargs):
        if pre is not None:
            pre(info, args, kwargs)
        out = fn(*args, **kwargs)
        if post is not None:
            post(info, out)
        if detect_anomalies:
            _scan_for_anomalies(info, out)
        return out

    _debug.__name__ = _sanitize(f"dbg_{info.name}")
    _debug.__qualname__ = f"debug.{_debug.__name__}"
    return _debug


def instrument_for_debugging(
    trace: TraceCtx,
    *,
    pre: Callable | None = None,
    post: Callable | None = None,
    detect_anomalies: bool = False,
    which: str = "computation",
) -> TraceCtx:
    """Returns a copy of ``trace`` where every instrumentable bound symbol is
    replaced by a wrapper invoking ``pre``/``post`` (and, when requested, the
    NaN/Inf output scan) around the original callable."""
    ntrace = from_trace(trace)
    new_bsyms: list[BoundSymbol] = []
    n_wrapped = 0
    for i, bsym in enumerate(trace.bound_symbols):
        orig = None if _should_skip(bsym) else _resolve_callable(bsym)
        if orig is None:
            new_bsyms.append(bsym)
            continue
        info = SymbolInfo(
            name=bsym.sym.name,
            index=i,
            trace=which,
            is_fusion=bool(bsym.sym.is_fusion),
            provenance=gather_provenance(bsym),
        )
        wrapper = _make_debug_wrapper(info, orig, pre, post, detect_anomalies)
        dsym = Symbol(
            name=f"_dbg{i}_{_sanitize(bsym.sym.name)}",
            id=None,
            is_prim=True,
            python_impl=wrapper,
        )
        new_bsyms.append(bsym.from_bsym(sym=dsym, subsymbols=(), _call_ctx=None))
        n_wrapped += 1
    ntrace.bound_symbols = new_bsyms
    ntrace.set_provenance(
        TraceProvenance(
            f"Debug-hook instrumentation ({n_wrapped} symbols wrapped; "
            f"detect_anomalies={detect_anomalies})"
        )
    )
    return ntrace
