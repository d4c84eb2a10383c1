"""Dataflow-aware fusion partitioning.

Counterpart of ``thunder_tpu/executors/data_dependent_partition.py``,
copied: given the same trace and predicate it forms the same groups, in the
same order.  The reference is the capability analog of the reference's ``thunder/executors/
data_dependent_partition.py`` (``fuse_bound_symbols``: toposort-based group
merging with cycle checks).  The round-1 xlaex pass fused only *adjacent*
fusible bsyms, so a single non-fusible op (an all-reduce, an item(), a
pallas call) split an otherwise-fusible region in two.  This partitioner
groups by dataflow instead: a fusible bsym joins an existing group whenever
doing so cannot create a cycle through a node outside the group, so fusible
islands reorder *around* non-fusible bsyms and the fusion backend sees
maximal programs.

Cycle-safety must be judged at the **group** level: a group's dependencies
are the union of its members', so a member added later can make the whole
group depend on something an individual node's ancestry does not show.  The
partitioner therefore maintains the transitive closure of the group DAG as
integer bitsets (``greach``), propagated to dependents on every join —
``n`` may join group ``g`` iff no producer group of ``n`` other than ``g``
transitively depends on ``g``.
"""
from __future__ import annotations

from typing import Callable, Sequence

from thunder_tpu_torch.core.symbol import BoundSymbol

__all__ = ["fuse_bound_symbols", "Group"]


class Group:
    __slots__ = ("gid", "fusible", "bsyms")

    def __init__(self, gid: int, fusible: bool):
        self.gid = gid
        self.fusible = fusible
        self.bsyms: list[BoundSymbol] = []


def fuse_bound_symbols(
    bsyms: Sequence[BoundSymbol], should_fuse: Callable[[BoundSymbol], bool]
) -> list[Group]:
    """Partitions ``bsyms`` (assumed topologically ordered — trace order) into
    groups; members of a fusible group need not be adjacent in the input.
    Returns groups in a valid topological order of the group DAG."""
    n = len(bsyms)
    producer_of: dict[str, int] = {}
    direct_prods: list[list[int]] = [[] for _ in range(n)]
    for i, b in enumerate(bsyms):
        seen_p = set()
        for a in b.flat_proxy_args:
            p = producer_of.get(a.name)
            if p is not None and p not in seen_p:
                seen_p.add(p)
                direct_prods[i].append(p)
        for o in b.flat_proxy_outs:
            producer_of.setdefault(o.name, i)

    groups: list[Group] = []
    group_of: list[int] = [0] * n
    # group-level transitive dependency closure, as bitsets over group ids
    greach: list[int] = []
    rdeps: list[set[int]] = []  # gid -> groups that directly depend on it

    def new_group(fusible: bool) -> Group:
        g = Group(len(groups), fusible)
        groups.append(g)
        greach.append(0)
        rdeps.append(set())
        return g

    def propagate(gid: int):
        """greach[gid] grew: push the new closure to dependents."""
        stack = [gid]
        while stack:
            g = stack.pop()
            add = greach[g] | (1 << g)
            for d in rdeps[g]:
                if add & ~greach[d]:
                    greach[d] |= add
                    stack.append(d)

    def assign(i: int, t: Group):
        group_of[i] = t.gid
        t.bsyms.append(bsyms[i])
        grew = False
        for p in direct_prods[i]:
            h = group_of[p]
            if h == t.gid:
                continue
            add = greach[h] | (1 << h)
            if add & ~greach[t.gid]:
                greach[t.gid] |= add
                grew = True
            rdeps[h].add(t.gid)
        if grew:
            propagate(t.gid)

    for i, b in enumerate(bsyms):
        if not should_fuse(b):
            assign(i, new_group(False))
            continue

        def safe_to_join(pg: Group) -> bool:
            # joining adds edges (producer groups of n) -> pg; a cycle needs a
            # pre-existing path pg ⇝ some producer group h ≠ pg, i.e. h's
            # closure containing pg.  n ⇝ pg paths are impossible (topo order).
            gbit = 1 << pg.gid
            for q in direct_prods[i]:
                h = group_of[q]
                if h != pg.gid and (greach[h] & gbit):
                    return False
            return True

        target: Group | None = None
        seen_cand: set[int] = set()
        # producers' groups first (locality), then any fusible group newest-
        # first so independent islands merge into one region
        for p in direct_prods[i]:
            pg = groups[group_of[p]]
            if pg.fusible and pg.gid not in seen_cand:
                seen_cand.add(pg.gid)
                if safe_to_join(pg):
                    target = pg
                    break
        if target is None:
            for pg in reversed(groups):
                if pg.fusible and pg.gid not in seen_cand:
                    seen_cand.add(pg.gid)
                    if safe_to_join(pg):
                        target = pg
                        break
        if target is None:
            target = new_group(True)
        assign(i, target)

    # topological order over the group DAG (stable by first-member position)
    first_pos: dict[int, int] = {}
    for i in range(n):
        first_pos.setdefault(group_of[i], i)
    gdeps: dict[int, set[int]] = {g.gid: set() for g in groups}
    for i in range(n):
        gi = group_of[i]
        for p in direct_prods[i]:
            if group_of[p] != gi:
                gdeps[gi].add(group_of[p])

    ordered: list[Group] = []
    visited: set[int] = set()
    temp: set[int] = set()

    def visit(gid: int):
        if gid in visited:
            return
        if gid in temp:  # pragma: no cover - partitioner invariant
            raise RuntimeError("fusion partitioner produced a cyclic group graph")
        temp.add(gid)
        for d in sorted(gdeps[gid], key=lambda g: first_pos.get(g, 0)):
            visit(d)
        temp.discard(gid)
        visited.add(gid)
        ordered.append(groups[gid])

    for g in sorted(groups, key=lambda g: first_pos.get(g.gid, 0)):
        visit(g.gid)
    return [g for g in ordered if g.bsyms]
