"""thunder_tpu_torch: the PyTorch/CUDA port of thunder_tpu.

A package beside the JAX reference (``thunder_tpu/``) that imports neither
JAX nor the reference package.  Its layout mirrors ``thunder_tpu/`` module
for module.  It carries the serving path: the Llama model family
(``models``, with speculative decoding), the serving engine (``serving``:
paged decode, chunked prefill, speculative serving, quantized KV,
multi-tenant LoRA), the single-device train step, the hand-written
Hopper kernels of those paths (``executors.cudaex`` over ``csrc/``), and
the trace IR: ``core`` (proxies, symbols, traces, prims), ``clang``, the
torch language (``thunder_tpu_torch.torch``, the ``ltorch`` surface that
``__torch_function__`` diverts torch calls into), executor claiming
(``extend``, ``executors.passes``, the ``torch`` and ``cuda`` executors),
trace acquisition (``functional.trace_from_fn``), ``jit`` with its
two-tier dispatch cache, and the transforms (``core/transforms.py``: the
VJP table, the forward/backward split, ``grad``, ``value_and_grad`` and
``vjp``; ``core/rematerialization.py``; ``core/autocast.py``).  The train
step (``distributed.api.TrainStep``) runs the traced loss: split,
rematerialized, claimed and generated, as the reference's does.  MoE
configs train and serve; ``executors.quantex`` (exported as ``quantex``)
is the opt-in int8/fp8 quantization executor behind ``TrainStep(quant=)``
and the serving forwards' ``quantized=``.  Entry points run on the card
unless the caller passes ``device="cpu"``.

``jit`` and its introspection are the counterpart of
``thunder_tpu/__init__.py:128-760, 768-940``: ``jit`` (with its grad path
and ``autocast=``), ``compile``, ``grad``, ``value_and_grad``, ``vjp``,
``last_traces``, ``last_backward_traces``, ``last_prologue_traces``,
``compile_data``, ``compile_stats``, ``cache_option``, ``cache_hits``,
``cache_misses``, ``dispatch_stats``, ``last_compile_options`` and
``metrics_snapshot``, with ``donate=`` (``executors/donation.py``),
``donation_stats`` and ``DonationError``.  The default executors are
cuda ≻ inductor ≻ torch: the fusion executor (``executors/inductorex.py``)
compiles each maximal fusible region with ``torch.compile`` on the card,
and ``jit`` and ``TrainStep`` enable its persistent cache
(``core/compile_cache.py``) at construction.  ``jit`` of a
``torch.nn.Module`` returns a ``ThunderModule`` (``torch_interop.py``);
``profile=``, ``detect_anomalies=`` and ``debug_hooks=`` instrument the
program (``observability/``).  ``interpretation="bytecode"`` runs the
function through the bytecode interpreter (``core/interpreter.py``,
``core/jit_ext.py``): tensors it reads from globals, closures and
attribute or item chains become extra inputs that the prologue re-fetches,
and plain values it reads become prologue guards;
``last_interpreter_log`` and ``print_last_interpreter_log`` show the
interpreter's run.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Sequence

import torch as _real_torch

from thunder_tpu_torch import clang  # noqa: F401
from thunder_tpu_torch import numpy  # noqa: F401  (registers the numpy langctx)
from thunder_tpu_torch import observability
from thunder_tpu_torch import torch as _torch_language  # noqa: F401  (registers the torch langctx)

# einops interop: registers the TensorProxy backend, gated on the package
# being present (a broken interop module must raise, not leave proxies
# unknown to einops)
import importlib.util as _ilu

if _ilu.find_spec("einops") is not None:
    from thunder_tpu_torch import einops_support  # noqa: F401
from thunder_tpu_torch.common import CacheEntry, CompileData, CompileStats
from thunder_tpu_torch.core import cache_key as _cache_key
from thunder_tpu_torch.core.autocast import autocast
from thunder_tpu_torch.core.batching import jvp, vmap
from thunder_tpu_torch.core.baseutils import check
from thunder_tpu_torch.core.compile_data import compile_data_and_stats
from thunder_tpu_torch.core.options import (
    CACHE_OPTIONS,
    SHARP_EDGES_OPTIONS,
    resolve_cache_option,
    resolve_sharp_edges_option,
)
from thunder_tpu_torch.core.trace import TraceCtx, TraceResults
from thunder_tpu_torch.core.transform_common import absorb_ce_widening_converts, cse, dce
from thunder_tpu_torch.distributed.api import TrainStep, make_eager_train_step, make_train_step
from thunder_tpu_torch.executors import quantex
from thunder_tpu_torch.executors.donation import DonationError
from thunder_tpu_torch.extend import resolve_executors
from thunder_tpu_torch.functional import trace_from_fn
from thunder_tpu_torch.models.generate import generate
from thunder_tpu_torch.models.llama import Config, gpt_loss, init_params
from thunder_tpu_torch.models.weights import params_from_numpy
from thunder_tpu_torch.observability import reset_observability
from thunder_tpu_torch.observability.debug import AnomalyError
from thunder_tpu_torch.observability.events import span as _phase_span
from thunder_tpu_torch.serving.engine import ServingEngine, serve
from thunder_tpu_torch.serving.lora import (
    AdapterRegistry,
    RegistryFullError,
    make_lora_factors,
    valid_targets,
)
from thunder_tpu_torch.serving.speculative import SpecConfig
from thunder_tpu_torch.train.loop import TrainLoopResult, train_loop
from thunder_tpu_torch.train.optim import adamw

__all__ = ["AdapterRegistry", "AnomalyError", "Config", "DonationError", "RegistryFullError", "ServingEngine", "SpecConfig",
           "TrainLoopResult", "TrainStep", "adamw", "cache_hits", "cache_misses",
           "cache_option", "compile", "compile_data", "compile_stats", "dispatch_stats", "donation_stats",
           "generate", "gpt_loss", "grad", "init_params", "jit", "jvp", "last_backward_traces",
           "last_compile_options", "last_interpreter_log", "last_prologue_traces", "last_traces",
           "make_eager_train_step",
           "make_lora_factors", "make_train_step",
           "metrics_snapshot", "params_from_numpy", "print_last_interpreter_log", "profile_stats",
           "quantex",
           "reset_observability", "serve", "train_loop",
           "valid_targets", "value_and_grad", "vjp", "vmap"]

def _normalize_donate(donate):
    """``donate=`` → a hashable canonical form: ``None`` (off), ``"auto"``
    (True: every provably dead fusion input), or a sorted argnums tuple
    (explicit: those positional args' tensors MUST be donatable, else
    :class:`DonationError`).  Raises on anything else at jit() time
    (reference ``thunder_tpu/__init__.py:107-124``)."""
    if donate is None or donate is False:
        return None
    if donate is True:
        return "auto"
    if isinstance(donate, int) and not isinstance(donate, bool):
        return (donate,)
    if isinstance(donate, (tuple, list)) and all(
        isinstance(i, int) and not isinstance(i, bool) for i in donate
    ):
        check(len(donate) > 0, lambda: "donate=() donates nothing; pass False or argnums")
        return tuple(sorted(set(donate)))
    check(False, lambda: (
        f"donate must be True, False, or a tuple of positional argnums, got {donate!r}"
    ))


def jit(
    fn: Callable,
    *,
    langctx: Any | None = None,
    executors: Sequence | None = None,
    cache: str | CACHE_OPTIONS | None = None,
    sharp_edges: str | SHARP_EDGES_OPTIONS | None = None,
    transforms: Sequence | None = None,
    max_cached_specializations: int | None = 512,
    **compile_options,
) -> Callable:
    """Compiles ``fn``: traces it into a program (torch calls on its inputs
    divert into the torch language), applies ``transforms``, claims it with
    the executor stack (cuda ≻ torch by default) and generates its Python.

    The returned callable caches compilations by a structural key of its
    inputs (tier 1), and runs the matched entry's prologue once to validate
    them (tier 2); a guard failure after a key match shadows the entry, and
    ``max_cached_specializations`` bounds the cache by least recent use
    (reference ``thunder_tpu.jit``, ``thunder_tpu/__init__.py:128``).

    ``autocast="bf16"|"fp16"|dtype`` appends the autocast transform.  With
    ``_grad_argnums`` (set by ``grad``/``value_and_grad``/``vjp``) the
    program is split into forward and backward, rematerialized unless
    ``remat=False`` is passed, and each half claimed and generated.

    ``donate=True`` releases every fusion-region input the lowered trace
    proves dead right after its region (the caller's donated tensors are
    consumed: passing one again raises :class:`DonationError`); a tuple of
    positional argnums asserts those arguments' tensors must donate.

    ``interpretation="bytecode"`` traces ``fn`` through the bytecode
    interpreter (``core/jit_ext.py``): captured tensors and guards on the
    plain values it reads outside the arguments enter the prologue."""
    # sugar: jit(fn, autocast="bf16"|"fp16") appends the autocast transform
    # (reference thunder_tpu/__init__.py:152-173)
    ac = compile_options.pop("autocast", None)
    if ac is not None:
        transforms = list(transforms or []) + [autocast(_autocast_dtype(ac))]

    if isinstance(fn, _real_torch.nn.Module):
        # the module's forward runs as a compiled program bridged into torch
        # autograd (reference thunder_tpu/__init__.py:177-196)
        from thunder_tpu_torch.torch_interop import ThunderModule

        check(langctx is None, lambda: (
            "langctx is not supported for torch.nn.Module inputs: the interop path traces "
            "through the torch language by construction"))
        return ThunderModule(
            fn,
            executors=executors,
            cache=cache,
            sharp_edges=sharp_edges,
            transforms=transforms,
            max_cached_specializations=max_cached_specializations,
            **compile_options,
        )

    # the fusion regions' persistent compile cache (core/compile_cache.py):
    # lazy, so a plain import changes no setting
    from thunder_tpu_torch.core import compile_cache

    compile_cache.ensure_enabled()

    if langctx is not None:
        # resolve eagerly so a typo fails at jit() time, not first call
        from thunder_tpu_torch.core.langctxs import resolve_language

        compile_options["langctx"] = resolve_language(langctx)

    # normalized donation setting, validated here so a typo fails at jit()
    # time and folded into the dispatch key as a salt: the donated and
    # undonated programs differ and never share a specialization
    _donation_salt = _normalize_donate(compile_options.get("donate", None))

    cd = CompileData(
        fn=fn,
        executors_list=resolve_executors(executors),
        cache_option=resolve_cache_option(cache),
        sharp_edges=resolve_sharp_edges_option(sharp_edges),
        transforms=transforms,
        compile_options=compile_options,
        max_cached_specializations=max_cached_specializations,
    )
    cs = CompileStats()

    from itertools import chain

    from thunder_tpu_torch.core.proxies import Proxy
    from thunder_tpu_torch.core.pytree import tree_flatten
    from thunder_tpu_torch.core.trace import get_tracectx

    _fn_label = getattr(fn, "__name__", "fn")

    def fn_(*args, **kwargs):
        if get_tracectx() is not None and any(
            isinstance(a, Proxy)
            for a in chain(tree_flatten(args)[0], tree_flatten(kwargs)[0])
        ):
            # a compiled callable invoked on proxies inside another trace
            # would run its prologue on symbolic values
            raise NotImplementedError(
                "a thunder_tpu_torch-compiled function was called inside another "
                "trace (nested jit composition is unsupported) — compose at the "
                "trace level instead: pass the original Python function"
            )
        cs.calls += 1
        dispatch_start = time.perf_counter_ns()
        cs.last_trace_host_start = dispatch_start

        # Two-tier dispatch.  Tier 1: one structural key computation + one
        # hash-map lookup selects the candidate bucket.  Tier 2: the
        # candidate's prologue runs ONCE for exact guard validation.  A
        # prologue failure after a key match shadows the entry (demoted
        # behind fresher same-key entries) instead of a full rescan.
        cache_entry = None
        key = None
        inps = None
        if cd.cache_option is not CACHE_OPTIONS.NO_CACHING:
            key = _cache_key.compute_cache_key(
                args, kwargs, symbolic=cd.cache_option is CACHE_OPTIONS.SYMBOLIC_VALUES,
                salt=("donate", _donation_salt) if _donation_salt is not None else None)
            cs.key_computations += 1
            if key is not None:
                bucket = cs.dispatch_cache.get(key)
                if bucket:
                    for idx, entry in enumerate(tuple(bucket)):
                        cs.prologue_runs += 1
                        try:
                            inps = entry.prologue_fn(*args, **kwargs)
                        except Exception:
                            # guard failure after a key match: shadow the
                            # entry (the recompile lands in front; a later
                            # call whose guards hold re-finds it by scan)
                            cs.guard_evictions += 1
                            bucket.remove(entry)
                            bucket.append(entry)
                            continue
                        cache_entry = entry
                        if idx == 0:
                            cs.key_hits += 1
                        else:
                            cs.scan_hits += 1
                            bucket.remove(entry)
                            bucket.insert(0, entry)
                        break
            else:
                # unkeyable inputs (unhashable pytree aux, exotic leaves):
                # the legacy linear prologue scan, correct but O(entries)
                for entry in cs.interpreter_cache:
                    cs.prologue_runs += 1
                    try:
                        inps = entry.prologue_fn(*args, **kwargs)
                    except Exception:
                        continue
                    cache_entry = entry
                    cs.scan_hits += 1
                    break
            if cache_entry is not None:
                cs.cache_hits += 1
                cache_entry.last_used = cs.calls

        was_hit = cache_entry is not None
        if cache_entry is None:
            cs.cache_misses += 1
            observability.compile_begin(_fn_label)
            compile_start = time.perf_counter_ns()
            with _phase_span("compile", fn=_fn_label), compile_data_and_stats(cd, cs):
                cache_entry = _compile(cd, cs, args, kwargs)
            observability.compile_end(_fn_label, time.perf_counter_ns() - compile_start)
            if cd.cache_option is not CACHE_OPTIONS.NO_CACHING:
                cache_entry.cache_key = key
                cache_entry.last_used = cs.calls
                cs.interpreter_cache.append(cache_entry)
                if key is not None:
                    cs.dispatch_cache.setdefault(key, []).insert(0, cache_entry)
                _evict_lru(cd, cs)
            cs.prologue_runs += 1
            inps = cache_entry.prologue_fn(*args, **kwargs)
        cs.last_dispatch_ns = time.perf_counter_ns() - dispatch_start
        cs.dispatch_ns += cs.last_dispatch_ns
        observability.dispatch_event(_fn_label, ns=cs.last_dispatch_ns, hit=was_hit)

        for pos, name, region, where in cache_entry.donated_inputs:
            # a tensor an earlier donated call consumed: raise before any
            # kernel of the program reads it
            v = inps[pos]
            if v.numel() > 0 and v.untyped_storage().nbytes() == 0:
                from thunder_tpu_torch.executors.donation import consumed_error

                raise consumed_error(name, pos, region, where)

        if cache_entry.uses_rng:
            from thunder_tpu_torch.core import rng

            inps = tuple(inps) + (rng.next_key(),)

        cs.last_trace_host_execution_start = time.perf_counter_ns()
        if cache_entry.backward_fn is not None and cache_entry.vjp_mode:
            # the backward entry point: the caller supplies cotangents
            output, saved = cache_entry.computation_fn(*inps)
            result = (output, _pullback(cache_entry, list(saved)))
        elif cache_entry.backward_fn is not None:
            # scalar-loss sugar: the cotangent is ones (grad / value_and_grad).
            # The list is the residuals' only holder: the backward empties it
            output, saved = cache_entry.computation_fn(*inps)
            saved = list(saved)
            ct = _real_torch.ones(output.shape, dtype=output.dtype, device=output.device)
            flat_grads = cache_entry.backward_fn(saved, ct)
            result = (output, cache_entry.return_spec(flat_grads))
        else:
            result = cache_entry.computation_fn(*inps)
            if cache_entry.epilogue_fn is not None:
                # the computation returns (user_result, mutated_leaves); the
                # epilogue writes the mutated leaves back into the caller's
                # containers (reference epilogue execution)
                result, mutated = result
                cache_entry.epilogue_fn(args, kwargs, *mutated)
        cs.last_trace_host_execution_stop = time.perf_counter_ns()
        cs.last_trace_host_stop = cs.last_trace_host_execution_stop
        return result

    fn_._lc_cd = cd
    fn_._lc_cs = cs
    fn_.__wrapped__ = fn
    fn_.__name__ = getattr(fn, "__name__", "fn") + "_compiled"
    return fn_


def _pullback(entry: CacheEntry, saved: list) -> Callable:
    """The ``vjp`` pullback over one forward's residuals: it hands them to
    the backward program, which empties the list, so it runs once."""
    from thunder_tpu_torch.core.pytree import tree_flatten

    def pullback(cotangents):
        """cotangents: same structure as the function's output; pass None
        for non-differentiable output leaves (None flattens away, so exactly
        the differentiable leaves remain, in output order)."""
        flat_cts, _ = tree_flatten(cotangents)
        check(
            len(flat_cts) == len(entry.ct_positions),
            lambda: f"pullback expected cotangents for {len(entry.ct_positions)} "
            f"differentiable output leaves, got {len(flat_cts)} (pass None "
            f"for non-differentiable outputs)",
        )
        check(pullback.fresh, lambda: "the pullback runs once: its backward program took "
                                      "the forward's residuals; call the vjp again")
        pullback.fresh = False
        return entry.return_spec(entry.backward_fn(saved, *flat_cts))

    pullback.fresh = True
    return pullback


def _autocast_dtype(ac):
    """``autocast=``'s target: "bf16"/"fp16" (or their long names) or a
    float dtype (reference thunder_tpu/__init__.py:152-173)."""
    from thunder_tpu_torch.core import dtypes as _dt

    _ac_map = {"bf16": _dt.bfloat16, "bfloat16": _dt.bfloat16,
               "fp16": _dt.float16, "float16": _dt.float16}
    if isinstance(ac, str):
        dtype = _ac_map.get(ac)
    elif isinstance(ac, (bool, int, float, complex)) or hasattr(ac, "shape"):
        # numbers and arrays are typos, not dtype requests: fail fast
        dtype = None
    else:  # torch/numpy/thunder dtype objects all convert
        try:
            dtype = _dt.to_dtype(ac)
        except Exception:
            dtype = None
        if dtype is not None and not _dt.is_float_dtype(dtype):
            dtype = None
    check(dtype is not None,
          lambda: f"unknown autocast target {ac!r} (use 'bf16'/'fp16' or a float dtype)")
    return dtype


def _evict_lru(cd: CompileData, cs: CompileStats) -> None:
    """Enforces the specialization bound: least-recently-validated entries are
    dropped from both cache views.  Runs at insert time only (compile cost
    already dominates), so the hot dispatch path never pays for it."""
    bound = cd.max_cached_specializations
    if not bound:
        return
    while len(cs.interpreter_cache) > bound:
        victim = min(cs.interpreter_cache, key=lambda e: e.last_used)
        cs.interpreter_cache.remove(victim)
        bucket = cs.dispatch_cache.get(victim.cache_key)
        if bucket is not None and victim in bucket:
            bucket.remove(victim)
            if not bucket:
                del cs.dispatch_cache[victim.cache_key]
        cs.lru_evictions += 1


def _compile(cd: CompileData, cs: CompileStats, args: tuple, kwargs: dict) -> CacheEntry:
    """Trace → dce, cse, absorb_ce_widening_converts → user transforms →
    [forward/backward split → rematerialization → the backward's claiming,
    del_last_used, take_saved and codegen] → executor claiming →
    del_last_used → codegen (one cache entry): the reference's path."""
    from thunder_tpu_torch.core.sharp_edges import sharp_edges_guard
    from thunder_tpu_torch.executors.passes import (
        del_last_used,
        take_saved,
        transform_for_execution,
    )

    from thunder_tpu_torch.core.compile_data import get_compile_option

    grad_argnums = cd.compile_options.get("_grad_argnums")
    vjp_mode = bool(cd.compile_options.get("_vjp_mode"))
    # del-aware buffer donation (executors/donation.py): a post-lowering pass
    # arming each fusion region with the inputs the trace proves dead.  Off
    # (None) means the pass never runs and the program is the undonated one
    donation = _normalize_donate(get_compile_option(
        "donate",
        "Buffer donation for fusion regions: True donates every input the lowered trace "
        "proves dead (its DEL follows the region; it is not a trace output, an aliased view, "
        "or consumed later); a tuple of positional argnums additionally asserts those args' "
        "tensors MUST donate (DonationError names the proxy and the blocking use otherwise). "
        "Donated caller tensors are CONSUMED — do not reuse them after the call.  Default "
        "False: the undonated program.",
        default=None,
    ))
    if vjp_mode and grad_argnums is None:
        grad_argnums = tuple(range(len(args)))

    # runtime profiling transform (observability/profiler.py): applied last,
    # over the execution trace(s), and only when requested; otherwise the
    # generated program is byte-identical to the uninstrumented one
    profile_opt = get_compile_option(
        "profile",
        "Enable the runtime profiling transform: every executed symbol/fusion "
        "region is wrapped in timing, queryable via thunder_tpu_torch.profile_stats.",
        default=None,
    )
    profile_on = bool(profile_opt) if profile_opt is not None else observability.profiling_env_enabled()
    profile_report = None
    profile_barriers = True
    if profile_on:
        from thunder_tpu_torch.observability.profiler import ProfileReport

        profile_barriers = bool(get_compile_option(
            "profile_barriers",
            "Fence each instrumented symbol whose outputs lie on the card with "
            "torch.cuda.synchronize for device-accurate per-symbol times (default True).",
            default=True,
        ))
        if cs.profile_report is None:
            cs.profile_report = ProfileReport()
        profile_report = cs.profile_report

    # numerics-debugging transform (observability/debug.py): pre/post hooks
    # on every executed symbol plus the NaN/Inf anomaly scan; like the
    # profiler, applied last and only when requested
    detect_opt = get_compile_option(
        "detect_anomalies",
        "Scan every instrumented symbol's outputs for NaN/Inf and raise a "
        "structured AnomalyError naming the symbol and the user source line "
        "(forward and backward traces).",
        default=None,
    )
    anomaly_on = bool(detect_opt) if detect_opt is not None else observability.anomaly_env_enabled()
    debug_hooks_opt = get_compile_option(
        "debug_hooks",
        "Pre/post callbacks on every executed BoundSymbol/fusion region: "
        "(pre, post) tuple, {'pre':..., 'post':...} dict, or one callable "
        "(post).  Each receives a SymbolInfo with name and source provenance.",
        default=None,
    )
    debug_cfg = None
    if anomaly_on or debug_hooks_opt is not None:
        from thunder_tpu_torch.observability.debug import resolve_debug_hooks

        dbg_pre, dbg_post = resolve_debug_hooks(debug_hooks_opt)
        debug_cfg = {"pre": dbg_pre, "post": dbg_post, "detect_anomalies": anomaly_on}

    cs.last_trace_tracing_start = time.perf_counter_ns()
    with sharp_edges_guard(cd.sharp_edges):
        trace_results: TraceResults = trace_from_fn(
            cd.fn,
            args,
            kwargs,
            grad_argnums=grad_argnums,
            interpretation=cd.compile_options.get("interpretation"),
            symbolic_numbers=cd.cache_option is CACHE_OPTIONS.SYMBOLIC_VALUES,
            language=cd.compile_options.get("langctx"),
        )
    cs.last_trace_tracing_stop = time.perf_counter_ns()

    prologue_trace = trace_results.prologue_trace
    computation_trace = trace_results.computation_trace
    computation_trace.set_provenance("Trace acquisition (functional frontend)")

    cs.last_traces = [computation_trace]
    cs.last_backward_traces = []
    cs.last_prologue_traces = [prologue_trace]
    cs.last_interpreter_log = getattr(computation_trace, "_interpreter_log", [])

    with _phase_span("transform:dce"):
        computation_trace = dce(computation_trace)
    cs.last_traces.append(computation_trace)
    with _phase_span("transform:cse"):
        computation_trace = cse(computation_trace)
    cs.last_traces.append(computation_trace)
    with _phase_span("transform:absorb_ce_widening_converts"):
        absorbed = absorb_ce_widening_converts(computation_trace)
    if absorbed is not computation_trace:  # no-op returns the input unchanged
        computation_trace = absorbed
        cs.last_traces.append(computation_trace)

    # user transforms (trace -> trace)
    for transform in cd.transforms:
        tname = getattr(transform, "__name__", type(transform).__name__)
        with _phase_span(f"transform:{tname}"):
            computation_trace = transform(computation_trace)
        cs.last_traces.append(computation_trace)

    bw_fn = None
    bw_extrace = None
    bw_donation_report = None
    grad_postprocess = None
    ct_positions = ()
    if grad_argnums is not None:
        from thunder_tpu_torch.core import dtypes, prims
        from thunder_tpu_torch.core.proxies import TensorProxy as _TP
        from thunder_tpu_torch.core.pytree import tree_flatten as _tf
        from thunder_tpu_torch.core.transforms import forward_and_backward_from_trace

        # grad contract (jax.grad-style): a single scalar differentiable
        # output — unless vjp mode, where the caller supplies cotangents for
        # every differentiable output leaf
        for bsym in computation_trace.bound_symbols:
            if bsym.sym.id is prims.PrimIDs.RETURN:
                flat_outs = _tf(bsym.args)[0]
                outs = [o for o in flat_outs if isinstance(o, _TP)]
                if vjp_mode:
                    ct_positions = tuple(
                        i
                        for i, o in enumerate(flat_outs)
                        if isinstance(o, _TP) and dtypes.is_inexact_dtype(o.dtype)
                    )
                    check(
                        len(ct_positions) > 0,
                        lambda: "vjp requires at least one differentiable output",
                    )
                else:
                    check(
                        len(outs) == 1 and outs[0].shape == () and dtypes.is_inexact_dtype(outs[0].dtype),
                        lambda: f"grad/value_and_grad require the function to return a single scalar float "
                        f"(got {[(tuple(o.shape), str(o.dtype)) for o in outs]})",
                    )

        with _phase_span("transform:forward_backward_split"):
            fw_trace, bw_trace = forward_and_backward_from_trace(computation_trace)
        cs.last_traces.append(fw_trace)
        cs.last_backward_traces = [bw_trace]
        from thunder_tpu_torch.core.rematerialization import (
            rematerialize_forward_and_backward,
            saved_for_backward,
        )

        if cd.compile_options.get("remat", True):
            with _phase_span("transform:rematerialization"):
                fw_trace, bw_trace = rematerialize_forward_and_backward(fw_trace, bw_trace)
            cs.last_traces.append(fw_trace)
            cs.last_backward_traces.append(bw_trace)
        computation_trace = fw_trace
        n_saved = len(saved_for_backward(fw_trace))

        bw_extrace = transform_for_execution(bw_trace, cd.executors_list)
        cs.last_backward_traces.append(bw_extrace)
        bw_extrace = del_last_used(bw_extrace)
        cs.last_backward_traces.append(bw_extrace)
        if donation is not None:
            # backward donation is always automatic: its inputs are saved
            # residuals and cotangents, which user argnums cannot name
            from thunder_tpu_torch.executors.passes import annotate_donations

            # the caller's tensors among the residuals keep their storage: the
            # forward's returned outputs, and its inputs unless donate=True
            # (explicit argnums donate those arguments' tensors alone)
            kept = _forward_output_names(computation_trace)
            arg_names = {p.name for p in computation_trace.args or ()
                         if isinstance(p, _TP)}
            if donation != "auto":
                arg_map = getattr(trace_results.computation_trace, "_input_argnums", {})
                kept |= {n for n in arg_names if arg_map.get(n) not in donation}
            candidate = None
            if kept:
                candidate = {p.name for b in bw_extrace.bound_symbols if b.sym.is_fusion
                             for p in b.flat_proxy_args} - kept
            bw_extrace, bw_donation_report = annotate_donations(
                bw_extrace, candidate_names=candidate, which="backward")
            cs.last_backward_traces.append(bw_extrace)
        if debug_cfg is not None:
            from thunder_tpu_torch.observability.debug import instrument_for_debugging

            bw_extrace = instrument_for_debugging(bw_extrace, which="backward", **debug_cfg)
            cs.last_backward_traces.append(bw_extrace)
        if profile_report is not None:
            from thunder_tpu_torch.observability.profiler import instrument_for_profiling

            bw_extrace = instrument_for_profiling(
                bw_extrace, profile_report, which="backward", barriers=profile_barriers)
            cs.last_backward_traces.append(bw_extrace)
        bw_extrace = take_saved(bw_extrace, n_saved)
        cs.last_backward_traces.append(bw_extrace)
        bw_fn = bw_extrace.python_callable()
        grad_postprocess = _make_grad_postprocess(trace_results.computation_trace, grad_argnums)

    extrace = transform_for_execution(computation_trace, cd.executors_list)
    cs.last_traces.append(extrace)
    extrace = del_last_used(extrace)
    cs.last_traces.append(extrace)
    donated_inputs = []
    if donation is not None:
        from thunder_tpu_torch.executors.donation import donation_summary
        from thunder_tpu_torch.executors.passes import annotate_donations

        candidate = None
        strict = False
        if donation != "auto":
            # explicit argnums: resolve the user's positional args to their
            # tensor-leaf proxies (functional.py records the map at trace
            # time) and assert donation of exactly those
            arg_map = getattr(trace_results.computation_trace, "_input_argnums", {})
            candidate = {n for n, a in arg_map.items() if a in donation}
            check(
                bool(candidate),
                lambda: f"donate={donation!r} matched no tensor arguments of "
                f"{getattr(cd.fn, '__name__', cd.fn)!r}",
            )
            strict = True
        extrace, fw_donation_report = annotate_donations(
            extrace, candidate_names=candidate, strict=strict
        )
        cs.last_traces.append(extrace)
        cs.donation_reports = {
            "forward": donation_summary(fw_donation_report),
            "backward": (
                donation_summary(bw_donation_report)
                if bw_donation_report is not None
                else None
            ),
        }
        # the program's own inputs a region consumes: dispatch checks them
        # before the program runs
        positions = {p.name: i for i, p in enumerate(extrace.args or ())}
        for region in fw_donation_report.regions:
            fusion = (region.bsym._call_ctx or {}).get(region.name)
            where = fusion.provenance() if fusion is not None else ""
            for _, p in region.donated:
                if p.name in positions:
                    donated_inputs.append((positions[p.name], p.name, region.name, where))

    if debug_cfg is not None:
        from thunder_tpu_torch.observability.debug import instrument_for_debugging

        with _phase_span("transform:debug_instrumentation"):
            extrace = instrument_for_debugging(extrace, **debug_cfg)
        cs.last_traces.append(extrace)
    if profile_report is not None:
        from thunder_tpu_torch.observability.profiler import instrument_for_profiling

        with _phase_span("transform:profiling_instrumentation"):
            extrace = instrument_for_profiling(extrace, profile_report, barriers=profile_barriers)
        cs.last_traces.append(extrace)

    comp_fn = extrace.python_callable()
    pro_fn = prologue_trace.python_callable()

    uses_rng = getattr(trace_results.computation_trace, "_rng_key_proxy", None) is not None

    entry = CacheEntry(
        prologue_fn=pro_fn,
        computation_fn=comp_fn,
        prologue_trace=prologue_trace,
        computation_trace=extrace,
        epilogue_trace=trace_results.epilogue_trace,
        uses_rng=uses_rng,
        epilogue_fn=(
            trace_results.epilogue_trace.python_callable()
            if trace_results.epilogue_trace is not None
            else None
        ),
        backward_fn=bw_fn,
        backward_trace=bw_extrace,
        return_spec=grad_postprocess,
        vjp_mode=vjp_mode,
        ct_positions=ct_positions,
    )
    # trace-time key emission (functional.py builds it next to the prologue):
    # the key function + metadata ride on the entry for introspection; the
    # dispatcher files the entry under the key it computed for this call
    key_meta = trace_results.cache_key_meta or {}
    entry.cache_key_fn = key_meta.get("cache_key_fn")
    entry.donated_inputs = tuple(donated_inputs)
    if donation is not None:
        # the dispatcher salts this entry's key with the donation setting;
        # the recomputing key fn (and the introspectable meta) must agree
        entry.cache_key_fn = _cache_key.make_cache_key_fn(
            cd.cache_option is CACHE_OPTIONS.SYMBOLIC_VALUES,
            salt=("donate", donation),
        )
        key_meta = {**key_meta, "donate": donation}
    entry.key_meta = key_meta
    entry.has_state_guards = key_meta.get("state") is not None
    return entry


def _forward_output_names(fw_trace) -> set:
    """Names of the tensors an augmented forward returns to the caller (its
    ``(output, saved)`` return's first part)."""
    from thunder_tpu_torch.core.prims import PrimIDs
    from thunder_tpu_torch.core.proxies import TensorProxy
    from thunder_tpu_torch.core.pytree import tree_flatten

    for bsym in fw_trace.bound_symbols:
        if bsym.sym.id == PrimIDs.RETURN and bsym.args:
            ret = bsym.args[0]
            output = ret[0] if isinstance(ret, tuple) and len(ret) == 2 else ret
            return {p.name for p in tree_flatten(output)[0] if isinstance(p, TensorProxy)}
    return set()


def _make_grad_postprocess(computation_trace, grad_argnums):
    """Builds grads-restructuring: flat grads (input order) → per-argnum pytrees."""
    from thunder_tpu_torch.core.pytree import tree_unflatten

    grad_meta = getattr(computation_trace, "_grad_meta", [])

    def postprocess(flat_grads):
        flat_grads = list(flat_grads)
        it = iter(flat_grads)
        by_argnum = {}
        for argnum, spec_i, leaf_proxies in grad_meta:
            leaves = [next(it) if p is not None else None for p in leaf_proxies]
            by_argnum[argnum] = tree_unflatten(leaves, spec_i)
        ordered = tuple(by_argnum[a] for a in grad_argnums)
        return ordered[0] if len(ordered) == 1 else ordered

    return postprocess


def compile(fn: Callable, **kwargs) -> Callable:
    """Legacy alias for ``jit`` (reference thunder.compile)."""
    return jit(fn, **kwargs)


#
# grad APIs (populated by thunder_tpu_torch.core.transforms; re-exported here)
#


def grad(fn: Callable, **jit_kwargs) -> Callable:
    from thunder_tpu_torch.core.transforms import grad as _grad

    return _grad(fn, **jit_kwargs)


def value_and_grad(fn: Callable, **jit_kwargs) -> Callable:
    from thunder_tpu_torch.core.transforms import value_and_grad as _value_and_grad

    return _value_and_grad(fn, **jit_kwargs)


def vjp(fn: Callable, argnums: Sequence[int] | None = None, **jit_kwargs) -> Callable:
    """jax.vjp-style backward entry point with user-supplied cotangents.

    ``vjp(fn)(*args)`` returns ``(out, pullback)`` where ``pullback(ct)``
    takes a cotangent matching ``out``'s structure and returns gradients for
    ``argnums`` (default: every positional arg).  Unlike ``grad``/
    ``value_and_grad``, the function may return non-scalar (and multiple)
    outputs.  The pullback runs once: its backward program takes the
    forward's residuals (reference ``thunder_tpu.vjp``)."""
    if argnums is not None:
        argnums = (argnums,) if isinstance(argnums, int) else tuple(argnums)
    return jit(fn, _vjp_mode=True, _grad_argnums=argnums, **jit_kwargs)


#
# Introspection (reference thunder_tpu/__init__.py:768-943)
#


def _unwrap_cfn(cfn):
    """A ThunderModule holds its compiled functions inside (the vjp of the
    functionalized forward, and the forward-only inference path);
    introspection accepts either, and the most recently invoked one answers
    (reference ``thunder_tpu/__init__.py:763``)."""
    if not hasattr(cfn, "_lc_cs"):
        for attr in ("_last_compiled", "_vjp_fn", "_fwd_fn"):
            inner = getattr(cfn, attr, None)
            if inner is not None and hasattr(inner, "_lc_cs"):
                return inner
    return cfn


def _get_cs(cfn) -> CompileStats:
    cs = getattr(_unwrap_cfn(cfn), "_lc_cs", None)
    check(cs is not None, lambda: f"{cfn} is not a thunder_tpu_torch-compiled function")
    return cs


def compile_data(cfn) -> CompileData:
    cd = getattr(_unwrap_cfn(cfn), "_lc_cd", None)
    check(cd is not None, lambda: f"{cfn} is not a thunder_tpu_torch-compiled function")
    return cd


def compile_stats(cfn) -> CompileStats:
    return _get_cs(cfn)


def last_traces(cfn) -> list[TraceCtx]:
    return _get_cs(cfn).last_traces


def last_backward_traces(cfn) -> list[TraceCtx]:
    return _get_cs(cfn).last_backward_traces


def last_prologue_traces(cfn) -> list[TraceCtx]:
    return _get_cs(cfn).last_prologue_traces


def last_interpreter_log(cfn) -> list:
    """The bytecode frontend's per-opcode run log from the last trace
    (reference ``thunder_tpu.last_interpreter_log``).  Empty unless the
    function was compiled with ``interpretation="bytecode"``."""
    return _get_cs(cfn).last_interpreter_log


def print_last_interpreter_log(cfn, *, max_lines: int | None = 2000) -> None:
    """Prints the last bytecode-interpreter run as an indented instruction
    listing (reference ``thunder_tpu.print_last_interpreter_log``)."""
    from thunder_tpu_torch.core.interpreter import format_interpreter_log

    print(format_interpreter_log(last_interpreter_log(cfn), max_lines=max_lines))


def cache_option(cfn) -> CACHE_OPTIONS:
    return compile_data(cfn).cache_option


def cache_hits(cfn) -> int:
    return _get_cs(cfn).cache_hits


def cache_misses(cfn) -> int:
    return _get_cs(cfn).cache_misses


def dispatch_stats(cfn) -> dict:
    """Two-tier dispatch counters: ``key_hits`` (O(1) hash-map hit, first
    bucket entry validated), ``scan_hits`` (shadowed-bucket or legacy linear
    scan), ``guard_evictions`` (prologue failed after a key match),
    ``lru_evictions``, plus per-call dispatch timing.  The dispatch path also
    publishes process-wide aggregates into the metrics registry
    (``dispatch.calls`` / ``dispatch.cache_hits`` / ``dispatch.cache_misses``
    / ``dispatch.ns``)."""
    cs = _get_cs(cfn)
    return {
        "key_hits": cs.key_hits,
        "scan_hits": cs.scan_hits,
        "guard_evictions": cs.guard_evictions,
        "lru_evictions": cs.lru_evictions,
        "key_computations": cs.key_computations,
        "prologue_runs": cs.prologue_runs,
        "cached_specializations": len(cs.interpreter_cache),
        "last_dispatch_ns": cs.last_dispatch_ns,
        "dispatch_ns": cs.dispatch_ns,
    }


def profile_stats(cfn):
    """Per-symbol runtime profile of a function compiled with
    ``profile=True`` (or under ``THUNDER_TPU_PROFILE=1``): a mapping
    ``label -> {calls, total_ns, mean_ns, min_ns, max_ns, flops?, bytes?,
    live_bytes, peak_bytes}`` covering every instrumented BoundSymbol /
    fusion region (forward and, when present, backward).  ``print()`` the
    report for the table sorted by total time.  FLOPs are counted by
    ``FlopCounterMode`` over meta tensors of the traced shapes, bytes are the
    symbol's tensor inputs and outputs, both computed on first query
    (reference ``thunder_tpu.profile_stats``)."""
    cs = _get_cs(cfn)
    check(
        cs.profile_report is not None,
        lambda: "no profiling data: compile with ttt.jit(fn, profile=True) "
        "(or set THUNDER_TPU_PROFILE=1 before the first call) and invoke "
        "the compiled function at least once",
    )
    return cs.profile_report


def donation_stats(cfn) -> dict:
    """The donation analysis of a function compiled with ``ttt.jit(fn,
    donate=True|argnums)``: ``{"forward": summary, "backward": summary|None}``
    where each summary lists, per fusion region, the donated buffers, the
    input→output alias pairings, the donated byte count, and every rejection
    by reason (``trace_output`` / ``later_use`` / ``aliased_view`` /
    ``no_del``).  Process-wide aggregates land in the ``donation.*`` metrics
    (reference ``thunder_tpu.donation_stats``)."""
    cs = _get_cs(cfn)
    check(
        cs.donation_reports is not None,
        lambda: "no donation data: compile with ttt.jit(fn, donate=True) (or "
        "donate=(argnums,)) and call it once",
    )
    return cs.donation_reports


def metrics_snapshot() -> dict:
    """One plain dict of every registered metric, ``dispatch.*`` and
    ``compile.*`` included (alias of ``observability.snapshot()``)."""
    return observability.snapshot()


def last_compile_options(cfn) -> dict:
    """Which compile options the last compilation consulted (self-documented
    via get_compile_option)."""
    cs = _get_cs(cfn)
    return dict(cs.last_compile_reasons)
