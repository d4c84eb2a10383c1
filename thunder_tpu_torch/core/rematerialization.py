"""Activation rematerialization over the forward/backward split.

Counterpart of ``thunder_tpu/core/rematerialization.py``: the choice of what
to recompute (``rematerialize_forward_and_backward``'s cones) is the
reference's, copied.  One step is the port's own.  The reference prepends
every recomputed cone to the top of the backward and leaves XLA's scheduler
to place each op; the port runs the generated program in trace order, so
``schedule_recompute`` then moves each recomputed bound symbol to just
before its first consumer in the backward (a stable topological reorder of
the same bound symbols: none is added or dropped).  Without it every
layer's recompute would run before the first backward op and live until its
layer's backward, about the whole forward's activations at once; with it the
recomputed values live one layer at a time.  ``reorder=False`` leaves the
reference's order, for comparing the traces with the reference's.

The reference is the capability analog of the reference's
``thunder/core/rematerialization.py`` (igraph min-cut over fusion pairs,
``find_cut`` :230, ``rematerialize_forward_and_backward`` :567), operating
directly on the **saved-for-backward set** of the trace-level fw/bw split:

- *anchors* are expensive-to-recompute outputs (matmul/conv/attention
  (MATMUL_OP), reductions, RNG) plus trace inputs;
- every other saved proxy whose producer cone back to anchors consists of
  cheap ops (elementwise, shape, casts) is dropped from the saved set and its
  cone is re-executed in the backward trace;
- a greedy byte-accounting step only drops a proxy when the recomputation
  leaves it adds are smaller than the proxy itself.
"""
from __future__ import annotations

from typing import Any, Sequence

from thunder_tpu_torch.core import dtypes
from thunder_tpu_torch.core.baseutils import check
from thunder_tpu_torch.core.codeutils import SigInfo
from thunder_tpu_torch.core.prims import OpTags, PrimIDs
from thunder_tpu_torch.core.proxies import Proxy, TensorProxy
from thunder_tpu_torch.core.symbol import BoundSymbol
from thunder_tpu_torch.core.trace import TraceCtx, from_trace, tracectx
from thunder_tpu_torch.core.transform_common import dce

__all__ = ["peak_live_bytes", "rematerialize_forward_and_backward", "saved_bytes",
           "saved_for_backward", "schedule_recompute"]

# ops cheap enough to re-execute in backward rather than save their outputs
_CHEAP_IDS = {
    PrimIDs.CONVERT_ELEMENT_TYPE,
    PrimIDs.BROADCAST_IN_DIM,
    PrimIDs.RESHAPE,
    PrimIDs.TRANSPOSE,
    PrimIDs.SLICE,
    PrimIDs.SQUEEZE,
    PrimIDs.CAT,
    PrimIDs.PAD,
    PrimIDs.FLIP,
    PrimIDs.WHERE,
    PrimIDs.CLAMP,
    PrimIDs.FULL,
    PrimIDs.IOTA,
}


def _is_cheap(bsym: BoundSymbol) -> bool:
    sym = bsym.sym
    if sym.id in _CHEAP_IDS:
        return True
    tags = set(sym.tags or ())
    return bool(
        tags & {OpTags.ELEMENTWISE_UNARY_OP, OpTags.ELEMENTWISE_BINARY_OP, OpTags.SHAPE_OP}
    )


def _is_anchor(bsym: BoundSymbol) -> bool:
    tags = set(bsym.sym.tags or ())
    return (
        OpTags.MATMUL_OP in tags
        or OpTags.REDUCTION_OP in tags
        or OpTags.RANDOM_OP in tags
        or bsym.sym.id in (PrimIDs.EMBEDDING, PrimIDs.EMBEDDING_BACKWARD)
    )


def _collective(bsym: BoundSymbol) -> str | None:
    """The kind (``"ALL_GATHER"``, ``"SYNCHRONIZE"``, ...) of a collective of
    ``distributed/prims.py``, else None."""
    sid = bsym.sym.id
    return sid.name if type(sid).__name__ == "DistPrimIDs" else None


def _passes_input(bsym: BoundSymbol) -> bool:
    """The ``synchronize`` of a replicated param: its output is its input
    (the forward passes it), so remat treats it as a trace input."""
    if _collective(bsym) != "SYNCHRONIZE":
        return False
    args = dict(zip(("a", "axis_name", "axis_size", "sharded", "dim"), bsym.args))
    args.update(bsym.kwargs)
    return not args.get("sharded", False)


def _regather(bsym: BoundSymbol) -> bool:
    """A collective that only gathers (an all_gather, or the synchronize of
    a sharded param): the one kind ZeRO-3 recomputes in the backward."""
    kind = _collective(bsym)
    if kind == "ALL_GATHER":
        return True
    if kind == "SYNCHRONIZE":
        args = dict(zip(("a", "axis_name", "axis_size", "sharded", "dim"), bsym.args))
        args.update(bsym.kwargs)
        return bool(args.get("sharded", False))
    return False


def _bytes(p: Proxy) -> int:
    if not isinstance(p, TensorProxy):
        return 0
    n = 1
    for s in p.shape:
        n *= int(s)
    try:
        width = dtypes.to_torch_dtype(p.dtype).itemsize
    except Exception:
        width = 4
    return n * width


def saved_bytes(fw_trace: TraceCtx) -> int:
    """Total bytes of the forward trace's saved-for-backward residuals
    (the second element of its RETURN) — the quantity remat shrinks."""
    for b in fw_trace.bound_symbols:
        if b.sym.id == PrimIDs.RETURN and len(b.args) == 2:
            return sum(_bytes(p) for p in b.args[1] if isinstance(p, TensorProxy))
    return 0


def saved_for_backward(fw_trace: TraceCtx) -> tuple:
    """The residuals an augmented forward returns beside its output: the
    leading arguments of its backward, in order."""
    for b in fw_trace.bound_symbols:
        if b.sym.id == PrimIDs.RETURN and len(b.args) == 2:
            return tuple(b.args[1])
    raise ValueError("the trace is not an augmented forward (no (output, saved) return)")


def rematerialize_forward_and_backward(
    fw_trace: TraceCtx, bw_trace: TraceCtx, *, max_cone: int = 64, aggressive: bool = False,
    reorder: bool = True, regather: bool = False,
) -> tuple[TraceCtx, TraceCtx]:
    """Shrinks saved_for_backward by re-executing cheap producer cones in the
    backward trace.  Returns updated ``(fw_trace, bw_trace)`` honoring the
    split contract (fw returns ``(output, saved)``; bw takes
    ``(*saved, *cotangents)``).

    ``aggressive`` (the ZeRO-3 / full-checkpoint mode, reference
    ``rematerialization.py:389`` regather-in-backward): cones may recompute
    *expensive* ops too (matmuls — and, under SPMD, the param all-gathers
    GSPMD attaches to them), bottoming out only at trace inputs and other
    saved values, so residual memory shrinks toward the inputs at the cost
    of backward recompute.  RANDOM-tagged ops are never recomputed.

    ``reorder`` (the port's step) then places each recomputed bound symbol
    just before its first consumer (:func:`schedule_recompute`).

    Collectives (the port's sharded step writes them into the trace, where
    the reference's GSPMD inserts them after remat) are never recomputed,
    except that ``regather`` (ZeRO-3) recomputes the param all-gathers in
    the backward: their outputs are dropped from the residuals and each
    gather runs again before its first backward use.  Without it (ZeRO-2)
    the gathered params stay residuals.
    """
    # locate the fw return bsym: (output, saved)
    ret = None
    for b in fw_trace.bound_symbols:
        if b.sym.id == PrimIDs.RETURN:
            ret = b
    check(ret is not None and len(ret.args) == 2, lambda: "fw trace is not an augmented forward")
    output, saved = ret.args
    saved = list(saved)
    saved_names = [p.name for p in saved]

    # producer map over fw bsyms (prims level)
    producer_of: dict[str, tuple[int, BoundSymbol]] = {}
    for idx, b in enumerate(fw_trace.bound_symbols):
        if b.sym.id == PrimIDs.RETURN:
            continue
        for o in b.flat_proxy_outs:
            producer_of[o.name] = (idx, b)

    # a replicated param's synchronize passes its input through: saving or
    # reading its output costs what the input costs (nothing), as on one
    # device, so the cones and the residuals are the single-device step's
    input_names = {p.name for p in fw_trace.args if isinstance(p, Proxy)}
    input_names |= {o.name for _, b in producer_of.values() if _passes_input(b)
                    for o in b.flat_proxy_outs}
    anchor_names = {
        o.name
        for _, b in producer_of.values()
        for o in b.flat_proxy_outs
        if _is_anchor(b)
    }

    def cone_for(p: Proxy, stop: set[str]) -> tuple[list[tuple[int, BoundSymbol]], set[str]] | None:
        """Cheap-op producer cone of ``p``; leaves are inputs/anchors/other
        saved proxies.  None if the cone hits a non-cheap producer or the
        size cap."""
        bsyms: dict[int, BoundSymbol] = {}
        leaves: set[str] = set()
        stack = [p.name]
        seen = set()
        while stack:
            name = stack.pop()
            if name in seen:
                continue
            seen.add(name)
            if name != p.name and name in stop:
                leaves.add(name)
                continue
            if name in input_names:
                leaves.add(name)
                continue
            prod = producer_of.get(name)
            if prod is None:  # constant/number: nothing to recompute
                continue
            idx, b = prod
            if _collective(b) is not None and not (regather and _regather(b)):
                if name == p.name:
                    return None
                leaves.add(name)
                continue
            if not aggressive and name != p.name and name in anchor_names:
                leaves.add(name)
                continue
            if aggressive:
                if OpTags.RANDOM_OP in set(b.sym.tags or ()):
                    return None
            elif not (_is_cheap(b) or (regather and _regather(b))):
                return None
            if idx not in bsyms:
                bsyms[idx] = b
                if len(bsyms) > max_cone:
                    return None
                for a in b.flat_proxy_args:
                    stack.append(a.name)
        return sorted(bsyms.items()), leaves

    # greedy, biggest savings first (the reference rebuilds the output map
    # for every saved proxy; built once here, the same map)
    out_proxies = {o.name: o for _, b in producer_of.values() for o in b.flat_proxy_outs}
    removable: dict[str, tuple[list, set]] = {}
    order = sorted(
        (p for p in saved if isinstance(p, TensorProxy)), key=_bytes, reverse=True
    )
    saved_set = set(saved_names)
    for p in order:
        if p.name in input_names or (not aggressive and p.name in anchor_names):
            continue
        res = cone_for(p, stop=saved_set - {p.name} - set(removable))
        if res is None:
            continue
        bsyms, leaves = res
        # every leaf must become a bw arg (bw receives only saved+cotangents);
        # input leaves cost nothing — params/batch stay alive regardless
        new_leaves = [n for n in leaves if n not in saved_set]
        added = sum(
            _bytes(out_proxies[n])
            for n in new_leaves
            if n in out_proxies and n not in input_names
        )
        if added >= _bytes(p):
            continue
        removable[p.name] = (bsyms, leaves)
        saved_set.update(new_leaves)

    if not removable:
        return fw_trace, bw_trace

    # final saved set: previous minus removed, plus new anchor leaves;
    # anything recomputed by a prepended bsym must not also stay an arg
    recompute_bsyms: dict[int, BoundSymbol] = {}
    for bsyms, _ in removable.values():
        for idx, b in bsyms:
            recompute_bsyms[idx] = b
    recomputed_names = {
        o.name for b in recompute_bsyms.values() for o in b.flat_proxy_outs
    }

    name_to_proxy: dict[str, Proxy] = {}
    for p in fw_trace.args:
        if isinstance(p, Proxy):
            name_to_proxy[p.name] = p
    for _, b in producer_of.values():
        for o in b.flat_proxy_outs:
            name_to_proxy.setdefault(o.name, o)

    new_saved_names = [
        n for n in saved_names if n not in removable and n not in recomputed_names
    ]
    for n in sorted(saved_set - set(saved_names), key=lambda n: producer_of.get(n, (1 << 30,))[0]):
        if n not in recomputed_names and n not in new_saved_names:
            new_saved_names.append(n)
    new_saved = [name_to_proxy[n] for n in new_saved_names]

    # rebuild fw return
    import thunder_tpu_torch.core.prims as prims

    new_fw = from_trace(fw_trace)
    new_fw.bound_symbols = [b for b in fw_trace.bound_symbols if b.sym.id != PrimIDs.RETURN]
    with tracectx(new_fw):
        new_fw.bound_symbols.append(prims.python_return.bind(output, tuple(new_saved), output=None))
    new_fw.set_provenance("Rematerialization (forward)")

    # rebuild bw: recompute cones first (fw order), then the original body
    cotangents = [p for p in bw_trace.args if p.name not in set(saved_names)]
    new_bw = from_trace(bw_trace)
    prepend = [b for _, b in sorted(recompute_bsyms.items())]
    body = [b for b in bw_trace.bound_symbols]
    new_bw.bound_symbols = prepend + body
    bw_args = new_saved + cotangents
    new_bw.args = tuple(bw_args)
    new_bw.set_siginfo(SigInfo(name="backward", args=[(p.name, None) for p in bw_args]))
    new_bw.names = set(bw_trace.names) | {p.name for p in bw_args} | recomputed_names
    new_bw.set_provenance("Rematerialization (backward)")
    new_bw = dce(new_bw)
    if reorder:
        new_bw = schedule_recompute(new_bw, {id(b) for b in prepend})

    return new_fw, new_bw


def schedule_recompute(bw_trace: TraceCtx, recompute_ids: set[int]) -> TraceCtx:
    """Moves each recomputed bound symbol (``id`` in ``recompute_ids``) to
    just before the first bound symbol that needs it, directly or through
    other recomputed ones; the rest keep their order.  The result holds the
    same bound symbols in a topological order."""
    recompute = [b for b in bw_trace.bound_symbols if id(b) in recompute_ids]
    body = [b for b in bw_trace.bound_symbols if id(b) not in recompute_ids]
    if not recompute:
        return bw_trace
    producer = {o.name: i for i, b in enumerate(recompute) for o in b.flat_proxy_outs}
    emitted = [False] * len(recompute)

    def wanted(bsym: BoundSymbol) -> list[int]:
        found: set[int] = set()
        stack = [a.name for a in bsym.flat_proxy_args]
        while stack:
            i = producer.get(stack.pop())
            if i is None or emitted[i] or i in found:
                continue
            found.add(i)
            stack.extend(a.name for a in recompute[i].flat_proxy_args)
        return sorted(found)          # the forward's order is topological

    ordered: list[BoundSymbol] = []
    for bsym in body:
        if bsym.sym.id == PrimIDs.RETURN:
            # a recomputed bound symbol kept for its tags alone runs last
            ordered.extend(b for b, done in zip(recompute, emitted) if not done)
            emitted = [True] * len(recompute)
        for i in wanted(bsym):
            emitted[i] = True
            ordered.append(recompute[i])
        ordered.append(bsym)
    new_bw = from_trace(bw_trace)
    new_bw.bound_symbols = ordered
    new_bw.args = bw_trace.args
    new_bw.names = set(bw_trace.names)
    new_bw.set_provenance("Rematerialization (backward, recompute placed at first use)")
    return new_bw


def peak_live_bytes(trace: TraceCtx) -> int:
    """The most tensor bytes a program holds at once, run in trace order:
    its arguments live until their ``del``, every output from its bound
    symbol to its ``del`` (the trace after ``del_last_used``).  A trace
    without ``del`` statements holds everything to its end."""
    live: dict[str, int] = {p.name: _bytes(p) for p in trace.args if isinstance(p, TensorProxy)}
    total = peak = sum(live.values())
    for b in trace.bound_symbols:
        if b.sym.id == PrimIDs.DEL:
            for p in b.flat_proxy_args:
                total -= live.pop(p.name, 0)
            continue
        for o in b.flat_proxy_outs:
            if isinstance(o, TensorProxy) and o.name not in live:
                live[o.name] = _bytes(o)
                total += live[o.name]
        peak = max(peak, total)
    return peak
