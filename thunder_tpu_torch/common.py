"""Compile data, statistics, and cache entries.

Counterpart of ``thunder_tpu/common.py`` (``CompileData``, ``CompileStats``,
``CacheEntry``), itself the analog of the reference's ``thunder/common.py``
and the CacheEntry machinery in ``thunder/__init__.py``.
``CompileStats.persistent_cache`` reads the fusion regions' persistent
cache (``core/compile_cache.py``) and ``donation_reports`` the last
compilation's donation analysis.  ``CacheEntry`` carries the grad path's
backward program (``backward_fn``, ``backward_trace``, ``return_spec``,
``vjp_mode``, ``ct_positions``) and the program inputs a donated region
consumes (``donated_inputs``); ``CompileStats.profile_report`` the runtime
profiler's report, and ``last_interpreter_log`` the bytecode interpreter's
run log.  ``CompileData``'s process-group fields come with their
``ROADMAP.md`` item.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Sequence

from thunder_tpu_torch.core.options import CACHE_OPTIONS, SHARP_EDGES_OPTIONS
from thunder_tpu_torch.core.trace import TraceCtx

__all__ = ["CompileData", "CompileStats", "CacheEntry"]


class CompileStats:
    """Per-compiled-function counters, timings, and retained traces."""

    def __init__(self):
        self.calls: int = 0
        self.cache_hits: int = 0
        self.cache_misses: int = 0

        # two-tier dispatch counters: key_hits = resolved by the O(1) hash
        # lookup (first entry of the key's bucket validated); scan_hits =
        # resolved by scanning shadowed bucket entries or the legacy linear
        # fallback; guard_evictions = prologue failures AFTER a key match
        # (external state changed → the entry is shadowed behind fresher
        # ones); lru_evictions = specializations dropped by the LRU bound
        self.key_hits: int = 0
        self.scan_hits: int = 0
        self.guard_evictions: int = 0
        self.lru_evictions: int = 0
        self.key_computations: int = 0
        self.prologue_runs: int = 0
        self.last_dispatch_ns: int = -1
        self.dispatch_ns: int = 0

        self.last_trace_host_start: int = -1
        self.last_trace_host_stop: int = -1
        self.last_trace_tracing_start: int = -1
        self.last_trace_tracing_stop: int = -1
        self.last_trace_host_execution_start: int = -1
        self.last_trace_host_execution_stop: int = -1

        # all intermediate traces from the last compilation, in pass order
        self.last_traces: list[TraceCtx] = []
        self.last_backward_traces: list[TraceCtx] = []
        self.last_prologue_traces: list[TraceCtx] = []
        # the bytecode interpreter's run log of the last trace (empty under
        # the functional frontend)
        self.last_interpreter_log: list = []

        self.last_compile_reasons: dict[str, str] = {}
        self.used_compile_options: dict[str, Any] = {}

        # live entries in insertion order (introspection + the legacy linear
        # fallback for unkeyable inputs); the hash-map view below is the hot
        # dispatch path: structural key → bucket of entries, most recently
        # validated first (shadowed entries with the same key sit behind)
        self.interpreter_cache: list[CacheEntry] = []
        self.dispatch_cache: dict[Any, list[CacheEntry]] = {}

        # donation analysis of the last compilation: {"forward": summary,
        # "backward": summary|None} plain dicts (executors/donation.py
        # donation_summary); None unless compiled with donate=True/argnums
        self.donation_reports = None

        # the runtime profiler's per-symbol report (observability/profiler.py),
        # shared by every specialization; None unless compiled with profile=True
        # or THUNDER_TPU_PROFILE=1
        self.profile_report = None

    @property
    def persistent_cache(self) -> dict:
        """Process-wide persistent compile-cache counters (hits = region
        graphs loaded from disk instead of compiled, incl. by previous
        processes; see core/compile_cache.py)."""
        from thunder_tpu_torch.core import compile_cache

        return compile_cache.stats()


class CompileData:
    """Everything the compilation pipeline needs to know about one jit call."""

    def __init__(
        self,
        *,
        fn: Callable,
        executors_list: Sequence,
        cache_option: CACHE_OPTIONS,
        sharp_edges: SHARP_EDGES_OPTIONS,
        transforms: Sequence | None = None,
        compile_options: dict | None = None,
        max_cached_specializations: int | None = 512,
    ):
        self.fn = fn
        self.executors_list = tuple(executors_list)
        self.cache_option = cache_option
        self.sharp_edges = sharp_edges
        self.transforms = list(transforms or [])
        self.compile_options = dict(compile_options or {})
        # LRU bound on cached specializations (None/0 = unbounded): a served
        # model with many shape/value variants stays O(1) in dispatch AND
        # bounded in retained traces/compiled programs
        self.max_cached_specializations = max_cached_specializations


@dataclass(eq=False)  # identity semantics: entries live in lists/buckets
class CacheEntry:
    """A (prologue, computation[, backward]) triple; the prologue doubles as
    the cache guard — if it raises, the entry does not apply (reference
    __init__.py:418-491).  A grad entry's computation is the augmented
    forward, returning ``(output, saved)``; its ``backward_fn`` takes the
    saved residuals as one list, which it empties once it has unpacked it
    (``executors.passes.take_saved``), and the cotangents.

    Tier-1 dispatch metadata: ``cache_key`` is the structural key the entry is
    filed under in ``CompileStats.dispatch_cache`` (None = unkeyable inputs,
    legacy linear scan only); ``cache_key_fn`` recomputes that key from raw
    ``(args, kwargs)`` (emitted at trace time alongside the prologue);
    ``key_meta`` records why tier 2 is still required (external-state guards
    can't be keyed); ``last_used`` drives the LRU bound."""

    prologue_fn: Callable
    computation_fn: Callable
    prologue_trace: TraceCtx
    computation_trace: TraceCtx
    epilogue_trace: TraceCtx | None
    uses_rng: bool
    epilogue_fn: Callable | None = None
    backward_fn: Callable | None = None
    backward_trace: TraceCtx | None = None
    return_spec: Any = None
    vjp_mode: bool = False
    ct_positions: tuple = ()
    cache_key: Any = None
    cache_key_fn: Callable | None = None
    key_meta: Any = None
    has_state_guards: bool = False
    last_used: int = 0
    # (program input position, name, region, provenance) of every program
    # input a donated region consumes
    donated_inputs: tuple = ()
