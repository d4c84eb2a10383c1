"""Graph pattern matching over bound-symbol lists.

Counterpart of ``thunder_tpu/core/patterns.py`` (itself the analog of
Lightning Thunder's ``thunder/core/patterns.py``): a pattern is an ordered
list of matcher callables;
calling it on a trace yields groups of bound symbols that match the sequence
AND can legally be reordered to be adjacent (no unmatched op sits on a
dataflow path between two matched ops).  ``replace`` rewrites each match
through a builder, re-tracing its replacement into the trace.

The matcher contract follows Lightning Thunder's: ``matcher(bsym, ctx) ->
(bool, dict)`` where the dict updates the running match context (captures).
"""
from __future__ import annotations

from typing import Any, Callable, Sequence

from thunder_tpu_torch.core.baseutils import check
from thunder_tpu_torch.core.proxies import Proxy, variableify
from thunder_tpu_torch.core.pytree import tree_flatten
from thunder_tpu_torch.core.symbol import BoundSymbol
from thunder_tpu_torch.core.trace import TraceCtx, from_trace, tracectx

__all__ = ["Pattern", "match_replace"]


def _ancestor_sets(bsyms: Sequence[BoundSymbol]) -> list[set[int]]:
    """Per-bsym set of *immediate* producer indices."""
    producer_of: dict[str, int] = {}
    out: list[set[int]] = []
    for i, b in enumerate(bsyms):
        anc = set()
        for a in b.flat_proxy_args:
            p = producer_of.get(a.name)
            if p is not None:
                anc.add(p)
        out.append(anc)
        for o in b.flat_proxy_outs:
            producer_of.setdefault(o.name, i)
    return out


def _on_path_between(bsyms, ancestors, matched: set[int], candidate: int) -> bool:
    """True if some UNMATCHED bsym sits on a dataflow path from a matched
    bsym to ``candidate`` — matching would then require an illegal reorder."""
    if not matched:
        return False
    oldest = min(matched)
    frontier = set(ancestors[candidate]) - matched
    seen = set()
    while frontier:
        nxt = max(frontier)
        frontier.discard(nxt)
        if nxt < oldest or nxt in seen:
            continue
        seen.add(nxt)
        # an unmatched intermediate that itself depends on a matched op
        if ancestors[nxt] & matched:
            return True
        frontier |= set(ancestors[nxt]) - matched
    return False


class Pattern:
    """Build with repeated ``match`` calls, then call on a trace.

    Example::

        p = Pattern()
        p.match(lambda bsym, ctx: (bsym.sym.id == PrimIDs.MUL, {"mul": bsym}))
        p.match(lambda bsym, ctx: (bsym.sym.id == PrimIDs.ADD and
                                   ctx["mul"].output.name in
                                   (a.name for a in bsym.flat_proxy_args), {}))
        for bsyms, ctx in p(trace):
            ...
    """

    def __init__(self):
        self.matchers: list[tuple[Callable, int, int]] = []

    def match(self, matcher: Callable, *, min_times: int = 1, max_times: int = 1) -> "Pattern":
        check(min_times >= 0 and (max_times == -1 or max_times >= min_times), lambda: "bad repeat bounds")
        self.matchers.append((matcher, min_times, max_times))
        return self

    def __call__(self, trace: TraceCtx, *, window: int = 16):
        bsyms = list(trace.bound_symbols)
        ancestors = _ancestor_sets(bsyms)
        taken: set[int] = set()
        results: list[tuple[list[BoundSymbol], dict]] = []

        i = 0
        while i < len(bsyms):
            got = self._try_at(bsyms, ancestors, taken, i, window)
            if got is None:
                i += 1
                continue
            idxs, ctx = got
            taken |= set(idxs)
            results.append(([bsyms[j] for j in sorted(idxs)], ctx))
            i += 1
        return results

    def _try_at(self, bsyms, ancestors, taken, start, window):
        idxs: list[int] = []
        ctx: dict[str, Any] = {}
        pos = start

        for matcher, min_t, max_t in self.matchers:
            count = 0
            limit = max_t if max_t != -1 else len(bsyms)
            while count < limit:
                found = None
                hi = min(len(bsyms), (idxs[-1] if idxs else start) + window + 1)
                scan_from = pos if not idxs else idxs[0]
                for j in range(max(scan_from, start), hi):
                    if j in taken or j in idxs:
                        continue
                    try:
                        ok, update = matcher(bsyms[j], dict(ctx))
                    except Exception:
                        ok, update = False, {}
                    if not ok:
                        continue
                    if _on_path_between(bsyms, ancestors, set(idxs), j):
                        continue
                    found = (j, update or {})
                    break
                if found is None:
                    break
                j, update = found
                idxs.append(j)
                ctx.update(update)
                pos = j + 1
                count += 1
            if count < min_t:
                return None
        if not idxs:
            return None
        return idxs, ctx


def match_replace(trace: TraceCtx, pattern: Pattern, builder: Callable) -> TraceCtx:
    """Rewrites every match through ``builder(ctx, *matched_bsyms)``.

    The builder runs under the new trace's context and must return the
    replacement output value(s) built from thunder ops; its outputs are
    swapped for the final matched bsym's outputs.  Matched bsyms other than
    the last must be internal (their outputs consumed only inside the match)
    or the rewrite is skipped for safety."""
    matches = pattern(trace)
    if not matches:
        return trace

    replace_at: dict[int, tuple[list[BoundSymbol], dict]] = {}
    skip: set[int] = set()
    index_of = {id(b): i for i, b in enumerate(trace.bound_symbols)}

    for group, ctx in matches:
        gidx = [index_of[id(b)] for b in group]
        member = set(gidx)
        internal_ok = True
        out_names = {o.name for b in group[:-1] for o in b.flat_proxy_outs}
        for i, b in enumerate(trace.bound_symbols):
            if i in member:
                continue
            for a in b.flat_proxy_args:
                if a.name in out_names:
                    internal_ok = False
                    break
            if not internal_ok:
                break
        if not internal_ok:
            continue
        replace_at[gidx[-1]] = (group, ctx)
        skip |= set(gidx[:-1])

    new_trace = from_trace(trace)
    new_trace.names = set(trace.names)
    new_bsyms: list[BoundSymbol] = []
    swap_map: dict = {}

    with tracectx(new_trace):
        for i, b in enumerate(trace.bound_symbols):
            if i in skip:
                continue
            if i in replace_at:
                group, ctx = replace_at[i]
                with new_trace.push_scope() as scope:
                    result = builder(ctx, *group)
                new_bsyms.extend(scope)
                old_flat, _ = tree_flatten(group[-1].output)
                new_flat, _ = tree_flatten(result)
                for old, new in zip(old_flat, new_flat):
                    if isinstance(old, Proxy) and isinstance(new, Proxy) and old.name != new.name:
                        swap_map[variableify(new)] = old
                continue
            new_bsyms.append(b)

    new_bsyms = [b.from_bsym_swap_proxies(swap_map) for b in new_bsyms]
    new_trace.bound_symbols = new_bsyms
    new_trace.set_provenance("Pattern rewrite")
    return new_trace
