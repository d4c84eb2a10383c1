"""Runtime profiling transform: per-symbol timing over the execution trace.

Counterpart of ``thunder_tpu/observability/profiler.py``.  A
post-lowering pass (`instrument_for_profiling`) rewrites the execution
trace so every claimed BoundSymbol (executor op or fusion region) is
swapped for a wrapper symbol whose ``python_impl`` times the original
callable with the monotonic clock, optionally fences it with
``torch.cuda.synchronize`` when its outputs lie on the card (nothing to
fence on the CPU), and opens a ``torch.profiler.record_function`` range
when ``THUNDER_TPU_ANNOTATE_TRACES`` is on (read on every call).

Per-symbol call counts and wall time accumulate into a
:class:`ProfileReport` (query via ``thunder_tpu_torch.profile_stats(cfn)``;
``print()`` it for the sorted table).  FLOP estimates come from
``torch.utils.flop_counter.FlopCounterMode`` over the symbol's callable
run on fake tensors of the traced shapes (a fusion region's uncompiled
function; the kernels' symbols are not run), and byte estimates from the
symbol's input and output tensors (each read or written once); both are
computed lazily on first query and cached.

The pass only runs when profiling is requested (``jit(fn, profile=True)``
or ``THUNDER_TPU_PROFILE=1``); otherwise the generated execution program is
byte-identical to the uninstrumented one.
"""
from __future__ import annotations

import re
import time
import weakref
from collections.abc import Mapping
from dataclasses import dataclass
from typing import Any, Callable

from thunder_tpu_torch.core.prims import OpTags, PrimIDs
from thunder_tpu_torch.core.proxies import NumberProxy, TensorProxy
from thunder_tpu_torch.core.pytree import tree_flatten, tree_unflatten
from thunder_tpu_torch.core.symbol import BoundSymbol, Symbol, default_python_printer
from thunder_tpu_torch.core.trace import TraceCtx, TraceProvenance, from_trace
from thunder_tpu_torch.observability.config import annotations_enabled
from thunder_tpu_torch.observability.metrics import registry

__all__ = [
    "SymbolProfile",
    "ProfileReport",
    "instrument_for_profiling",
    "reset_profile_reports",
]

# never instrumented: control prims whose printed form is not a call, and
# check/unpack prims (prologue machinery)
_SKIP_IDS = {PrimIDs.RETURN, PrimIDs.DEL, PrimIDs.COMMENT, PrimIDs.PRINT}


@dataclass
class SymbolProfile:
    """Accumulated runtime stats for one instrumented bound symbol."""

    name: str  # unique display label within the report
    symbol: str  # underlying symbol name (Inductor0, torch_linear, ...)
    index: int  # position in its trace
    trace: str  # "computation" | "backward"
    calls: int = 0
    total_ns: int = 0
    min_ns: int | None = None
    max_ns: int | None = None
    # static memory-accounting estimates at this symbol's trace position
    # (del-aware liveness over proxy shapes; observability/memory.py)
    live_bytes: int | None = None
    peak_bytes: int | None = None
    _cost_thunk: Callable | None = None
    _cost: tuple | None = None  # (flops|None, bytes|None), lazily computed

    def add(self, ns: int) -> None:
        self.calls += 1
        self.total_ns += ns
        if self.min_ns is None or ns < self.min_ns:
            self.min_ns = ns
        if self.max_ns is None or ns > self.max_ns:
            self.max_ns = ns

    def cost(self) -> tuple:
        """(flops, bytes) at the traced shapes: FLOPs counted over fake
        tensors (None when the callable does not run on them), bytes of the
        symbol's tensor inputs and outputs; (None, None) when the arguments
        cannot be abstracted."""
        if self._cost is None:
            thunk, self._cost_thunk = self._cost_thunk, None
            if thunk is None:
                self._cost = (None, None)
            else:
                try:
                    self._cost = thunk()
                except Exception:
                    self._cost = (None, None)
        return self._cost

    def stats(self) -> dict:
        d = {
            "calls": self.calls,
            "total_ns": self.total_ns,
            "mean_ns": self.total_ns // self.calls if self.calls else 0,
            "min_ns": self.min_ns,
            "max_ns": self.max_ns,
        }
        flops, bytes_accessed = self.cost()
        if flops is not None:
            d["flops"] = flops
        if bytes_accessed is not None:
            d["bytes"] = bytes_accessed
        if self.live_bytes is not None:
            d["live_bytes"] = self.live_bytes
        if self.peak_bytes is not None:
            d["peak_bytes"] = self.peak_bytes
        return d


class ProfileReport(Mapping):
    """Mapping ``label -> {calls, total_ns, mean_ns, min_ns, max_ns,
    flops?, bytes?}``; ``print()``/``str()`` renders the table sorted by
    total time.  One report per compiled function, accumulating across
    specializations (each recompile appends its own records)."""

    def __init__(self):
        self.records: list[SymbolProfile] = []
        self._labels: set[str] = set()
        _REPORTS[id(self)] = self

    def add_record(self, symbol: str, index: int, trace: str) -> SymbolProfile:
        base = f"{symbol}" if trace == "computation" else f"{trace}:{symbol}"
        label, k = base, 1
        while label in self._labels:
            k += 1
            label = f"{base}#{k}"
        self._labels.add(label)
        rec = SymbolProfile(name=label, symbol=symbol, index=index, trace=trace)
        self.records.append(rec)
        return rec

    # Mapping interface
    def __getitem__(self, label: str) -> dict:
        for r in self.records:
            if r.name == label:
                return r.stats()
        raise KeyError(label)

    def __iter__(self):
        return iter([r.name for r in self.records])

    def __len__(self) -> int:
        return len(self.records)

    def table(self, *, sort_by: str = "total_ns", limit: int | None = None) -> str:
        """The sorted per-symbol table (descending by ``sort_by``)."""
        rows = sorted(
            ((r.name, r.stats()) for r in self.records),
            key=lambda kv: kv[1].get(sort_by) or 0,
            reverse=True,
        )
        if limit is not None:
            rows = rows[:limit]
        header = (
            f"{'symbol':<40} {'calls':>7} {'total_ms':>10} {'mean_us':>10} "
            f"{'flops':>12} {'bytes':>12} {'live_mb':>9} {'peak_mb':>9}"
        )
        lines = [header, "-" * len(header)]

        def mb(v):
            return f"{v / 1e6:.2f}" if isinstance(v, (int, float)) else "-"

        for name, st in rows:
            lines.append(
                f"{name[:40]:<40} {st['calls']:>7} "
                f"{st['total_ns'] / 1e6:>10.3f} {st['mean_ns'] / 1e3:>10.1f} "
                f"{st.get('flops', '-')!s:>12} {st.get('bytes', '-')!s:>12} "
                f"{mb(st.get('live_bytes')):>9} {mb(st.get('peak_bytes')):>9}"
            )
        return "\n".join(lines)

    def __str__(self) -> str:
        return self.table()

    def __repr__(self) -> str:
        return f"<ProfileReport {len(self.records)} symbols>"


# every live report, so tt.reset_observability() can clear accumulated
# per-symbol stats without holding compiled functions alive.  Keyed by id:
# ProfileReport is a Mapping (value equality, unhashable), so a WeakSet
# would conflate distinct empty reports
_REPORTS: "weakref.WeakValueDictionary[int, ProfileReport]" = weakref.WeakValueDictionary()


def reset_profile_reports() -> None:
    """Clears the accumulated records of every live ProfileReport (the
    reports stay attached to their compiled functions and refill on the next
    instrumented compilation/call)."""
    for report in list(_REPORTS.values()):
        report.records.clear()
        report._labels.clear()


def _sanitize(name: str) -> str:
    return re.sub(r"\W", "_", name)


def _resolve_callable(bsym: BoundSymbol):
    """The callable the generated program would invoke for this bsym, or
    None when it cannot be resolved (then the bsym stays uninstrumented)."""
    sym = bsym.sym
    if sym.is_fusion:
        return (bsym._call_ctx or {}).get(sym.name)
    if bsym._call_ctx:
        return None  # non-fusion call-ctx (exotic); leave as-is
    if sym.executor is not None and sym.fn is not None:
        return sym.fn
    if sym.module is not None:
        return getattr(sym.module, sym.name, None)
    if sym.python_impl is not None:
        return sym.python_impl
    return sym.fn


def _should_skip(bsym: BoundSymbol) -> bool:
    sym = bsym.sym
    if sym.id in _SKIP_IDS:
        return True
    tags = set(sym.tags or ())
    if OpTags.CHECK_OP in tags or OpTags.UNPACK_OP in tags:
        return True
    # a custom printer means the printed form may not be `name(args)` —
    # the wrapper's default-printed call would not match its semantics
    if sym.python_printer is not default_python_printer:
        return True
    return False


def _tensor_bytes(p: TensorProxy) -> int:
    from thunder_tpu_torch.core import dtypes

    n = 1
    for d in p.shape:
        n *= int(d)
    return n * dtypes.to_torch_dtype(p.dtype).itemsize


# symbols whose callable launches a hand-written kernel on CUDA tensors: their
# FLOPs are not counted (a fake tensor must not reach a kernel wrapper)
_KERNEL_OPS = frozenset({"torch_sdpa", "torch_sdpa_backward", "torch_cross_entropy_fwd"})


def _cost_thunk_for(bsym: BoundSymbol, fn: Callable) -> Callable | None:
    """Builds a lazy cost estimate for ``fn`` at the bsym's traced shapes:
    the FLOPs ``FlopCounterMode`` counts while ``fn`` (a fusion region's
    uncompiled ``plain`` function) runs on fake tensors of those shapes,
    dtypes and devices (None when it cannot run on them, and for the
    kernels' symbols), and the bytes of the bsym's tensor inputs and
    outputs.  Returns None when the args cannot be abstracted."""
    from thunder_tpu_torch.core import dtypes
    from thunder_tpu_torch.core.devices import to_torch_device

    try:
        flat, spec = tree_flatten((bsym.args, bsym.kwargs))
        outs = [o for o in tree_flatten(bsym.output)[0] if isinstance(o, TensorProxy)]
    except Exception:
        return None
    metas, slots, baked = [], [], []
    for i, x in enumerate(flat):
        if isinstance(x, TensorProxy):
            metas.append((tuple(int(s) for s in x.shape), dtypes.to_torch_dtype(x.dtype),
                          to_torch_device(x.device)))
            slots.append(i)
            baked.append(None)
        elif isinstance(x, NumberProxy):
            if x.value is None:
                return None
            baked.append(x.value)
        else:
            baked.append(x)
    nbytes = sum(_tensor_bytes(flat[i]) for i in slots) + sum(_tensor_bytes(o) for o in outs)
    kernel = getattr(bsym.sym.executor, "name", None) == "cuda" or bsym.sym.name in _KERNEL_OPS
    fn = getattr(fn, "plain", fn)

    def thunk():
        if kernel:
            return (None, float(nbytes))
        import torch
        from torch._subclasses.fake_tensor import FakeTensorMode
        from torch.utils.flop_counter import FlopCounterMode

        counter = FlopCounterMode(display=False)
        try:
            with FakeTensorMode():
                vals = list(baked)
                for slot, (shape, dtype, device) in zip(slots, metas):
                    vals[slot] = torch.empty(shape, dtype=dtype, device=device)
                a, kw = tree_unflatten(vals, spec)
                with counter:
                    fn(*a, **kw)
        except Exception:
            return (None, float(nbytes))
        return (float(counter.get_total_flops()), float(nbytes))

    return thunk


def _on_card(out) -> bool:
    import torch

    return any(isinstance(x, torch.Tensor) and x.is_cuda for x in tree_flatten(out)[0])


def _make_timed(label: str, fn: Callable, rec: SymbolProfile, barriers: bool) -> Callable:
    perf = time.perf_counter_ns
    reg_calls = registry().counter("profile.instrumented_calls")
    reg_ns = registry().histogram("profile.symbol_ns")

    def _profiled(*args, **kwargs):
        annotate = annotations_enabled()
        t0 = perf()
        if annotate:
            import torch

            with torch.profiler.record_function(label):
                out = fn(*args, **kwargs)
        else:
            out = fn(*args, **kwargs)
        if barriers and _on_card(out):
            import torch

            torch.cuda.synchronize()
        ns = perf() - t0
        rec.add(ns)
        reg_calls.inc()
        reg_ns.observe(ns)
        return out

    _profiled.__name__ = _sanitize(label)
    _profiled.__qualname__ = f"profiled.{_sanitize(label)}"
    return _profiled


def instrument_for_profiling(
    trace: TraceCtx,
    report: ProfileReport,
    *,
    which: str = "computation",
    barriers: bool = True,
    with_cost: bool = True,
) -> TraceCtx:
    """Returns a copy of ``trace`` where every instrumentable bound symbol
    is replaced by a timing wrapper accumulating into ``report``.

    ``barriers=True`` fences each symbol whose outputs lie on the card with
    ``torch.cuda.synchronize`` so wall times attribute device work to the
    symbol that launched it (without it, asynchronous launches attribute
    everything to whatever synchronizes last).
    """
    # static live/peak-bytes accounting at each symbol's trace position
    # (del-aware liveness over proxy shapes) — the memory columns of
    # profile_stats, mirrored into the registry as gauges
    from thunder_tpu_torch.observability.memory import memory_timeline

    timeline = memory_timeline(trace)
    registry().gauge(f"memory.{which}.peak_bytes_estimate").set(
        timeline["peak_bytes_estimate"]
    )
    registry().gauge(f"memory.{which}.input_bytes").set(timeline["input_bytes"])
    registry().gauge(f"memory.{which}.output_bytes").set(timeline["output_bytes"])

    ntrace = from_trace(trace)
    new_bsyms: list[BoundSymbol] = []
    n_wrapped = 0
    for i, bsym in enumerate(trace.bound_symbols):
        orig = None if _should_skip(bsym) else _resolve_callable(bsym)
        if orig is None:
            new_bsyms.append(bsym)
            continue
        rec = report.add_record(bsym.sym.name, i, which)
        row = timeline["rows"][i]
        rec.live_bytes = row["live_bytes"]
        rec.peak_bytes = row["peak_bytes"]
        if with_cost:
            rec._cost_thunk = _cost_thunk_for(bsym, orig)
        wrapper = _make_timed(rec.name, orig, rec, barriers)
        # the wrapper symbol prints as `_prof<i>_<name>(args)` and resolves
        # through python_impl in the exec ctx; executor/module stay unset so
        # import_ctx picks the python_impl branch
        psym = Symbol(
            name=f"_prof{i}_{_sanitize(bsym.sym.name)}",
            id=None,
            is_prim=True,
            python_impl=wrapper,
        )
        new_bsyms.append(bsym.from_bsym(sym=psym, subsymbols=(), _call_ctx=None))
        n_wrapped += 1
    ntrace.bound_symbols = new_bsyms
    ntrace.set_provenance(
        TraceProvenance(f"Runtime profiling instrumentation ({n_wrapped} symbols wrapped)")
    )
    return ntrace
