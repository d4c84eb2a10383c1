"""Common trace-to-trace transforms: DCE, CSE, redundant-input replacement.

Counterpart of ``thunder_tpu/core/transform_common.py`` (copied; only the imports change).

Analog of the reference's ``thunder/core/transform_common.py`` (dce :41,
cse :194, replace_redundant_inputs :107).
"""
from __future__ import annotations

import time
from typing import Sequence

from thunder_tpu_torch.core.proxies import Proxy, Variable, unvariableify, variableify
from thunder_tpu_torch.core.pytree import tree_flatten
from thunder_tpu_torch.core.symbol import BoundSymbol, BoundSymbolRHS, has_tags
from thunder_tpu_torch.core.trace import TraceCtx, TraceProvenance, from_trace

__all__ = ["dce", "cse", "replace_redundant_inputs", "order_proxies",
           "absorb_ce_widening_converts"]


def _tracked_tags():
    from thunder_tpu_torch.core.prims import OpTags

    return {OpTags.DONT_DCE, OpTags.COMM_OP}


def dce(trace: TraceCtx, keep: Sequence[Proxy] | None = None) -> TraceCtx:
    """Removes bound symbols whose outputs are never consumed.

    A reverse pass over the trace keeps symbols that produce a needed proxy or
    carry DONT_DCE-ish tags (RETURN, checks, comm ops, copies).
    """
    start = time.perf_counter_ns()
    from thunder_tpu_torch.core.prims import OpTags, PrimIDs

    needed: set[Variable] = set()
    if keep is not None:
        needed.update(variableify(p) for p in keep if isinstance(p, Proxy))

    kept: list[BoundSymbol] = []
    for bsym in reversed(trace.bound_symbols):
        is_needed = False
        if has_tags(bsym, {OpTags.DONT_DCE}):
            is_needed = True
        elif bsym.sym.id == PrimIDs.DEL:
            # del symbols are regenerated by del_last_used; drop here
            continue
        else:
            for out in bsym.flat_proxy_outs:
                if variableify(out) in needed:
                    is_needed = True
                    break
        if is_needed:
            kept.append(bsym)
            for inp in bsym.flat_proxy_args:
                needed.add(variableify(inp))
    kept.reverse()

    ntrace = from_trace(trace)
    ntrace.bound_symbols = kept
    elapsed = (time.perf_counter_ns() - start) // 1000000
    ntrace.set_provenance(TraceProvenance(f"Dead Code Elimination (took {elapsed} milliseconds)"))
    return ntrace


def absorb_ce_widening_converts(trace: TraceCtx) -> TraceCtx:
    """``CROSS_ENTROPY_FWD(convert_element_type(x, f32))`` →
    ``CROSS_ENTROPY_FWD(x)`` for half-precision ``x`` with no other consumer
    of the converted value.

    Every CE implementation (the Pallas kernel, the jaxex reference, XLA's
    own lowering) upcasts to float32 INTERNALLY, and bf16/f16 → f32 is
    exact, so the rewrite is bit-identical.  It exists for the claimed-kernel
    path: a convert left outside the kernel materializes the full (N, V)
    f32 logits in HBM — the model's largest tensor — where the kernel could
    have read the half-precision original and moved half the bytes.  (XLA
    fuses the convert into its fused lowering, so without this pass the
    Pallas kernel starts ~2× behind on HBM traffic at the head.)
    """
    start = time.perf_counter_ns()
    from thunder_tpu_torch.core import dtypes
    from thunder_tpu_torch.core.prims import PrimIDs

    def leaf_prims(bsym: BoundSymbol) -> set:
        """Prim ids of the bsym's primitive decomposition (the bsym itself
        when it has no subsymbols — both frontends appear here: bare prims
        and ltorch wrappers with prim subsymbols)."""
        if not bsym.subsymbols:
            return {bsym.sym.id}
        out: set = set()
        for s in bsym.subsymbols:
            out |= leaf_prims(s)
        return out

    def leaf_consumers(bsym: BoundSymbol, v: Variable) -> set:
        """Prim ids of the LEAF bsyms that take ``v`` as an input — the
        precise safety condition: the swap is only exact if every primitive
        consumer of the widened value upcasts internally (i.e. is the CE
        prim itself), not e.g. a regularizer term in a composite loss."""
        if not bsym.subsymbols:
            if any(variableify(a) == v for a in bsym.flat_proxy_args):
                return {bsym.sym.id}
            return set()
        out: set = set()
        for s in bsym.subsymbols:
            out |= leaf_consumers(s, v)
        return out

    def is_ce_candidate(bsym: BoundSymbol) -> bool:
        # cheap pre-screen before any tree walk: bare prim or a symbol whose
        # name mentions cross_entropy (the ltorch wrapper)
        if bsym.sym.id is PrimIDs.CROSS_ENTROPY_FWD:
            return True
        return "cross_entropy" in str(getattr(bsym.sym, "name", ""))

    # producer map + use counts over proxy names
    producer: dict[Variable, BoundSymbol] = {}
    uses: dict[Variable, int] = {}
    for bsym in trace.bound_symbols:
        for out in bsym.flat_proxy_outs:
            producer[variableify(out)] = bsym
        for inp in bsym.flat_proxy_args:
            v = variableify(inp)
            uses[v] = uses.get(v, 0) + 1

    rewritten = []
    changed = False
    for bsym in trace.bound_symbols:
        if bsym.args and is_ce_candidate(bsym):
            logits = bsym.args[0]
            v = variableify(logits)
            src = producer.get(v)
            if (
                src is not None
                and src.args
                # src must be a PURE widening cast (a bare convert prim or an
                # ltorch .to/.float wrapper around one)
                and leaf_prims(src) == {PrimIDs.CONVERT_ELEMENT_TYPE}
                and len(src.flat_proxy_args) == 1
                and uses.get(v, 0) == 1
                and getattr(logits, "dtype", None) == dtypes.float32
                and getattr(src.args[0], "dtype", None) in (dtypes.bfloat16, dtypes.float16)
                # and INSIDE this bsym the only primitive consumer of the
                # widened value is the CE prim itself
                and leaf_consumers(bsym, v) == {PrimIDs.CROSS_ENTROPY_FWD}
            ):
                # swap through args AND subsymbols: the inner prim bsyms
                # reference the converted proxy too
                rewritten.append(bsym.from_bsym_swap_proxies({v: src.args[0]}, skip_output=True))
                changed = True
                continue
        rewritten.append(bsym)

    if not changed:
        return trace
    ntrace = from_trace(trace)
    ntrace.bound_symbols = rewritten
    ntrace = dce(ntrace)  # the orphaned convert disappears here
    elapsed = (time.perf_counter_ns() - start) // 1000000
    ntrace.set_provenance(TraceProvenance(f"Absorb CE widening converts (took {elapsed} milliseconds)"))
    return ntrace


def cse(trace: TraceCtx) -> TraceCtx:
    """Replaces bound symbols whose right-hand side was already computed.

    Skips random ops, comm ops, and side-effecting symbols.
    """
    start = time.perf_counter_ns()
    from thunder_tpu_torch.core.prims import OpTags

    skip_tags = {OpTags.RANDOM_OP, OpTags.COMM_OP, OpTags.DONT_DCE, OpTags.DEVICE_SYNC_OP, OpTags.UNPACK_OP}

    seen: dict[BoundSymbolRHS, BoundSymbol] = {}
    swap_map: dict[Variable, Proxy] = {}
    new_bsyms: list[BoundSymbol] = []

    for bsym in trace.bound_symbols:
        nbsym = bsym.from_bsym_swap_proxies(swap_map, skip_output=True) if swap_map else bsym
        if has_tags(bsym, skip_tags) or not bsym.flat_proxy_outs:
            new_bsyms.append(nbsym)
            continue
        rhs = nbsym.rhs()
        prior = seen.get(rhs)
        if prior is None:
            seen[rhs] = nbsym
            new_bsyms.append(nbsym)
        else:
            for old_out, new_out in zip(nbsym.flat_proxy_outs, prior.flat_proxy_outs):
                if old_out.name != new_out.name:
                    swap_map[variableify(old_out)] = new_out

    ntrace = from_trace(trace)
    ntrace.bound_symbols = new_bsyms
    elapsed = (time.perf_counter_ns() - start) // 1000000
    ntrace.set_provenance(TraceProvenance(f"Common Subexpression Elimination (took {elapsed} milliseconds)"))
    return ntrace


def replace_redundant_inputs(redundant_map: dict[Variable, Proxy], bsyms: Sequence[BoundSymbol]) -> list[BoundSymbol]:
    if not redundant_map:
        return list(bsyms)
    return [b.from_bsym_swap_proxies(redundant_map) for b in bsyms]


def order_proxies(bsyms: Sequence[BoundSymbol]) -> dict[str, int]:
    """Maps proxy names to the index of the bsym producing them (for sorting)."""
    order: dict[str, int] = {}
    for i, bsym in enumerate(bsyms):
        for out in bsym.flat_proxy_outs:
            order.setdefault(out.name, i)
    return order
