"""Executor claiming and lifetime passes.

Counterpart of ``thunder_tpu/executors/passes.py``, copied, the donation
pass over ``executors/donation.py`` included.  ``take_saved`` is
the port's own: the backward program takes the saved residuals as one list
and empties it, so that no frame outside the program keeps a residual alive
past its ``del`` (in the reference XLA owns the buffers).  The reference is the
analog of the reference's ``thunder/executors/passes.py``:
``transform_for_execution`` (dce → operator claiming in priority order →
fusion passes → always-executor sweep) and ``del_last_used``.
"""
from __future__ import annotations

import time
from typing import Any, Sequence

from thunder_tpu_torch.core.prims import OpTags, PrimIDs
from thunder_tpu_torch.core.proxies import Proxy, variableify
from thunder_tpu_torch.core.symbol import BoundSymbol, Symbol, provenance_inherited
from thunder_tpu_torch.core.trace import TraceCtx, TraceProvenance, from_trace, tracectx
from thunder_tpu_torch.core.transform_common import dce
from thunder_tpu_torch.extend import Executor, FusionExecutor, OperatorExecutor
from thunder_tpu_torch.core.pytree import tree_flatten
from thunder_tpu_torch.observability.events import span as _phase_span

__all__ = ["transform_for_execution", "del_last_used", "take_saved", "annotate_donations"]

_PASSTHROUGH_IDS = {
    PrimIDs.RETURN,
    PrimIDs.DEL,
    PrimIDs.COMMENT,
    PrimIDs.PRINT,
    PrimIDs.UNPACK_TRIVIAL,
    PrimIDs.UNPACK_FLATTEN,
    PrimIDs.UNPACK_GETITEM,
    PrimIDs.UNPACK_ATTR,
}


def _is_passthrough(bsym: BoundSymbol) -> bool:
    if bsym.sym.id in _PASSTHROUGH_IDS:
        return True
    tags = set(bsym.sym.tags)
    return OpTags.CHECK_OP in tags or OpTags.UNPACK_OP in tags


def _is_identity(bsym: BoundSymbol) -> bool:
    """A recorded no-op: its output proxies *are* its input proxies (e.g.
    ``a.to(a.dtype)``).  Safe to elide — the names already bind."""
    outs = list(bsym.flat_proxy_outs)
    if not outs or bsym.subsymbols:
        return False
    in_names = {p.name for p in bsym.flat_proxy_args}
    return all(p.name in in_names for p in outs)


def _claimable_inside(
    bsym: BoundSymbol, op_executors: Sequence[Executor], memo: dict | None = None
) -> bool:
    """True if any *descendant* bsym is claimable by one of ``op_executors`` —
    a fusion executor must not swallow a composite whose insides a
    higher-priority operator executor (pallas kernels, int8) wants.

    Memoized per (bsym, executor-prefix length): the trace is immutable
    during claiming, and deep composites would otherwise pay a quadratic
    re-walk per fusion-candidacy test."""
    if memo is None:
        memo = {}
    key = (id(bsym), len(op_executors))
    hit = memo.get(key)
    if hit is not None:
        return hit

    result = False
    for sub in bsym.subsymbols:
        for ex in op_executors:
            impl = ex.get_impl(sub.sym.id)
            if impl is not None:
                if impl.checker is None:
                    result = True
                    break
                try:
                    if impl.checker(*sub.args, **sub.kwargs):
                        result = True
                        break
                except Exception:
                    pass
        if result:
            break
        if sub.subsymbols and _claimable_inside(sub, op_executors, memo):
            result = True
            break
    memo[key] = result
    return result


def _claim_bsym(trace: TraceCtx, bsym: BoundSymbol, executors: Sequence[Executor], memo: dict | None = None) -> list[BoundSymbol]:
    if memo is None:
        memo = {}
    if _is_passthrough(bsym):
        return [bsym]
    if _is_identity(bsym):
        return []

    higher_ops: list[Executor] = []
    for ex in executors:
        if isinstance(ex, FusionExecutor):
            if ex.can_fuse(bsym) and not _claimable_inside(bsym, higher_ops, memo):
                # preserved as-is; the executor's fusion pass will absorb it
                # (unless a higher-priority operator executor wants something
                # inside, in which case we fall through and decompose)
                return [bsym]
        elif isinstance(ex, OperatorExecutor):
            higher_ops.append(ex)
            impl = ex.get_impl(bsym.sym.id)
            if impl is None:
                continue
            if impl.checker is not None:
                try:
                    if not impl.checker(*bsym.args, **bsym.kwargs):
                        continue
                except Exception:
                    continue
            if impl.execution_transform is not None:
                return _apply_execution_transform(trace, bsym, impl.execution_transform)
            if impl.symbol is not None:
                return [bsym.from_bsym(sym=impl.symbol, subsymbols=())]
            return [bsym]

    # no executor claims it: decompose
    if bsym.subsymbols:
        out: list[BoundSymbol] = []
        for sub in bsym.subsymbols:
            out.extend(_claim_bsym(trace, sub, executors, memo))
        return out
    return [bsym]


def _apply_execution_transform(trace: TraceCtx, bsym: BoundSymbol, transform) -> list[BoundSymbol]:
    """Re-traces ``bsym`` through an executor's execution_transform, swapping
    the transform's outputs back to the original output proxies.  The
    replacement bsyms inherit the original's source provenance (the stack
    here is all framework frames)."""
    with tracectx(trace):
        with trace.push_scope() as scope, provenance_inherited(bsym):
            result = transform(*bsym.args, **bsym.kwargs)

    flat_old, _ = tree_flatten(bsym.output)
    flat_new, _ = tree_flatten(result)
    swap_map = {}
    for old, new in zip(flat_old, flat_new):
        if isinstance(old, Proxy) and isinstance(new, Proxy) and old.name != new.name:
            swap_map[variableify(new)] = old
    return [b.from_bsym_swap_proxies(swap_map) for b in scope]


@_phase_span("lower")
def transform_for_execution(trace: TraceCtx, executors: Sequence[Executor]) -> TraceCtx:
    """The claiming pass (reference passes.py:131)."""
    start = time.perf_counter_ns()
    trace = dce(trace)

    new_bsyms: list[BoundSymbol] = []
    claim_memo: dict = {}
    for bsym in trace.bound_symbols:
        new_bsyms.extend(_claim_bsym(trace, bsym, executors, claim_memo))

    extrace = from_trace(trace)
    extrace.bound_symbols = new_bsyms

    # fusion passes, in priority order
    for ex in executors:
        if isinstance(ex, FusionExecutor):
            extrace = ex.fusion_pass(extrace)

    # always-executor sweep for anything left unclaimed
    from thunder_tpu_torch.extend import get_always_executors

    always = get_always_executors()
    swept: list[BoundSymbol] = []
    for bsym in extrace.bound_symbols:
        if bsym.sym.is_fusion or bsym.sym.executor is not None or _is_passthrough(bsym):
            swept.append(bsym)
            continue
        if _is_identity(bsym):
            continue
        claimed = None
        for ex in always:
            impl = ex.get_impl(bsym.sym.id)
            if impl is not None and (impl.checker is None or impl.checker(*bsym.args, **bsym.kwargs)):
                if impl.execution_transform is not None:
                    claimed = _apply_execution_transform(extrace, bsym, impl.execution_transform)
                elif impl.symbol is not None:
                    claimed = [bsym.from_bsym(sym=impl.symbol, subsymbols=())]
                else:
                    claimed = [bsym]
                break
        if claimed is None:
            if bsym.subsymbols:
                claimed = []
                for sub in bsym.subsymbols:
                    for c in _claim_bsym(extrace, sub, always):
                        if c.sym.executor is None and c.sym.python_impl is None and not _is_passthrough(c):
                            raise RuntimeError(f"No executor can run {c.sym.name} (id={c.sym.id})")
                        claimed.append(c)
            elif bsym.sym.python_impl is not None:
                claimed = [bsym]
            else:
                raise RuntimeError(f"No executor can run {bsym.sym.name} (id={bsym.sym.id})")
        swept.extend(claimed)

    extrace.bound_symbols = swept
    elapsed = (time.perf_counter_ns() - start) // 1000000
    extrace.set_provenance(TraceProvenance(f"Transform for execution (took {elapsed} milliseconds)"))
    return extrace


@_phase_span("lower:del_last_used")
def del_last_used(trace: TraceCtx, *, clear_collections: bool = False) -> TraceCtx:
    """Inserts ``del`` statements after each proxy's last use so the generated
    program drops references to dead tensors promptly (reference
    passes.py:232), so the caching allocator can reuse their memory."""
    start = time.perf_counter_ns()
    from thunder_tpu_torch.core.prims import python_del

    # proxies that must outlive the program
    from thunder_tpu_torch.executors.utils import trace_return_names

    protected: set[str] = trace_return_names(trace)

    new_reversed: list[BoundSymbol] = []
    seen: set[str] = set()
    for bsym in reversed(trace.bound_symbols):
        if bsym.sym.id in (PrimIDs.RETURN, PrimIDs.DEL, PrimIDs.COMMENT):
            new_reversed.append(bsym)
            continue
        dead: list[Proxy] = []
        for p in list(bsym.flat_proxy_outs) + list(bsym.flat_proxy_args):
            if p.name not in seen and p.name not in protected:
                from thunder_tpu_torch.core.proxies import TensorProxy

                if isinstance(p, TensorProxy) and not any(d.name == p.name for d in dead):
                    dead.append(p)
            seen.add(p.name)
        if dead:
            new_reversed.append(python_del.bind(*dead, output=None))
        new_reversed.append(bsym)

    ntrace = from_trace(trace)
    ntrace.bound_symbols = list(reversed(new_reversed))
    elapsed = (time.perf_counter_ns() - start) // 1000000
    ntrace.set_provenance(TraceProvenance(f"Delete Last Used (took {elapsed} milliseconds)"))
    return ntrace


def _unpack_saved(saved_for_backward: list) -> tuple:
    values = tuple(saved_for_backward)
    saved_for_backward.clear()
    return values


_UNPACK_SAVED = Symbol(name="unpack_saved", meta=lambda coll: None, id="unpack_saved",
                       is_prim=True, python_impl=_unpack_saved)


def take_saved(trace: TraceCtx, n_saved: int) -> TraceCtx:
    """Rewrites a backward execution trace ``backward(*saved, *cotangents)``
    into ``backward(saved_for_backward, *cotangents)``, whose first line
    unpacks the list and empties it (the upstream Lightning Thunder's
    ``clear_mutable_collection``).  The caller hands over its only
    reference to the list's residuals; each then dies at its ``del``."""
    from thunder_tpu_torch.core.codeutils import SigInfo
    from thunder_tpu_torch.core.proxies import CollectionProxy

    saved, cotangents = trace.args[:n_saved], trace.args[n_saved:]
    ntrace = from_trace(trace)
    with tracectx(ntrace):
        coll = CollectionProxy(None, name="saved_for_backward")
    unpack = _UNPACK_SAVED.bind(coll, output=tuple(saved))
    ntrace.bound_symbols = [unpack, *trace.bound_symbols]
    ntrace.args = (coll, *cotangents)
    ntrace.set_siginfo(SigInfo(name=trace.siginfo().name,
                               args=[(p.name, None) for p in ntrace.args]))
    ntrace.set_provenance(TraceProvenance("Take saved for backward"))
    return ntrace


def annotate_donations(
    trace: TraceCtx,
    *,
    candidate_names: set | None = None,
    strict: bool = False,
    which: str = "forward",
    arm: bool = True,
):
    """Del-aware buffer donation pass: runs AFTER ``del_last_used`` (it needs
    the explicit ``DEL`` placement as its liveness proof) and arms each
    fusion region with the inputs that are provably safe to donate.  Returns
    ``(annotated_trace, DonationReport)`` — see
    ``thunder_tpu_torch.executors.donation`` for the safety contract."""
    from thunder_tpu_torch.executors.donation import apply_donation

    return apply_donation(
        trace, candidate_names=candidate_names, strict=strict, which=which, arm=arm
    )
