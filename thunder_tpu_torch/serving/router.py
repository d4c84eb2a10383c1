"""Replicated serving: N engine lanes on one device behind one
prefix-affinity router.

Counterpart of ``thunder_tpu/serving/router.py`` for ``replicas=N``
without a mesh (the reference's ``router.py:16-21`` form; a mesh's ``dp``
axis belongs to a later slice of the port).  :class:`ReplicatedEngine`
owns N independent :class:`~thunder_tpu_torch.serving.engine.ServingEngine`
lanes, each with its own paged KV arenas, in-flight records, scheduler and
step graphs, sharing the one ``params``, and fronts them with a router
that keeps the solo engine's surface (submit / run / drain / shutdown /
stats / evict / close_session / goodput_report).  The win is shape
segregation: the router co-locates request families, so each lane decodes
at its own narrow block-table bucket.  Graphs stay per engine (they hold
the addresses of their engine's arenas), so the reference's shared
program cache has no counterpart.

**Routing.**  The router owns the global queue, FIFO within a priority
level, and hands a request to a lane only when that lane can admit it on
its next step (``Scheduler.can_accept``: a free batch slot and enough
uncommitted free blocks).  Placement order:

1. **session affinity**: a session's next turn goes to the lane holding
   its parked blocks;
2. **resident affinity**: the lane whose live prefix index (probed without
   mutation, ``PrefixIndex.probe``) holds the longest block-aligned prefix
   of the prompt;
3. **routing-history affinity**: a bounded LRU of block-aligned prompt
   prefixes → the lane they last routed to (under burst submission nothing
   is resident yet at routing time);
4. **least-loaded**: among lanes that can admit now, the one with the most
   uncommitted free blocks (ties: fewest requests, lowest index).

When the affinity-preferred lane cannot admit now, the head waits (strict
global FIFO): spilling a long-prefix request onto a short-request lane
would drag that lane's decode bucket up for everyone.

**Drive.**  :meth:`ReplicatedEngine.step` routes, steps the lanes in
rotating round-robin order, then routes again.  Faults stay lane-scoped
(``fault_plans=[plan_or_None, ...]``, one per lane): a lane's quarantine,
retry or recovery happens inside its own ``step()``, and a stall names its
lane (``EngineStalledError(..., replica=i)`` with that lane's flight
state).

Observability: ``serving.router.*`` (queue depth, routed and affinity-hit
counters, per-lane running gauges, imbalance) beside each lane's own
``serving.*`` metrics; ``stats()`` and ``goodput_report()`` aggregate.
"""
from __future__ import annotations

from collections import OrderedDict, deque
from typing import Any, Callable, Sequence

import numpy as np
import torch

from thunder_tpu_torch.observability.goodput import fleet_goodput
from thunder_tpu_torch.observability.metrics import registry
from thunder_tpu_torch.serving.engine import EngineStalledError, RequestResult, ServingEngine
from thunder_tpu_torch.serving.priority import priority_level
from thunder_tpu_torch.serving.scheduler import FINISH_DEADLINE, FINISH_EVICTED, AdmissionError

__all__ = ["ReplicatedEngine", "RoutedHandle"]

# routing-history capacity: block-aligned prefix keys retained (LRU).
# 1024 keys at typical prompt lengths is a few hundred KB of host memory
# and covers far more concurrent request families than fit any arena
_HISTORY_CAP = 1024


class RoutedHandle:
    """Caller's view of a request submitted through the router.

    Mirrors :class:`~thunder_tpu_torch.serving.engine.RequestHandle`: the
    request sits in the router's global queue (state ``"queued"``) until
    the router hands it to a replica, after which every accessor
    delegates to the replica-local handle.  ``replica`` is the lane index
    once routed (``None`` before)."""

    def __init__(self, router: "ReplicatedEngine", rid: int, prompt: np.ndarray,
                 submit_kwargs: dict, deadline_t: float | None, submit_t: float):
        self._router = router
        self._rid = rid
        self._prompt = prompt
        self._kwargs = submit_kwargs
        self._deadline_t = deadline_t
        self._submit_t = submit_t
        self._blocks = 0                 # full reservation, set at submit
        self._level = 1                  # priority level (normal) for queue order
        self._inner = None               # replica-local RequestHandle
        self.replica: int | None = None
        self._synthetic: RequestResult | None = None   # expired/evicted pre-route

    @property
    def rid(self) -> int:
        """Router-level request id (replica-local rids restart per lane)."""
        return self._rid

    @property
    def state(self) -> str:
        if self._synthetic is not None:
            return "finished"
        if self._inner is None:
            return "queued"
        return self._inner.state

    def done(self) -> bool:
        return self._synthetic is not None or (
            self._inner is not None and self._inner.done())

    def tokens_so_far(self) -> tuple[int, ...]:
        return () if self._inner is None else self._inner.tokens_so_far()

    def result(self, *, drive: bool = True) -> RequestResult:
        """The structured result; with ``drive`` (default) steps the whole
        replicated fleet until this request finishes."""
        while drive and not self.done():
            if not self._router.step() and not self.done():
                raise self._router._stall_error(
                    f"request {self._rid} still {self.state}")
        if self._synthetic is not None:
            return self._synthetic
        if not self.done():
            raise RuntimeError(f"request {self._rid} is still {self.state}")
        return self._inner.result(drive=False)


class ReplicatedEngine:
    """N engine lanes + the prefix-affinity router that owns admission."""

    def __init__(
        self,
        params,
        cfg,
        *,
        model_fn: Callable | None = None,
        replicas: int,
        fault_plans: Sequence | None = None,
        telemetry=None,
        **engine_kwargs,
    ):
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        if "fault_plan" in engine_kwargs:
            raise ValueError(
                "fault_plan= is ambiguous under replication (a list "
                "already means several specs for ONE plan) — pass "
                "fault_plans=[plan_or_None, ...], one entry per replica"
            )
        if fault_plans is not None and len(fault_plans) != replicas:
            raise ValueError(
                f"fault_plans has {len(fault_plans)} entries for "
                f"{replicas} replicas"
            )
        self._engines: list[ServingEngine] = []
        for i in range(replicas):
            eng = ServingEngine(
                params, cfg,
                model_fn=model_fn,
                fault_plan=fault_plans[i] if fault_plans is not None else None,
                # owned telemetry (a path) must not be opened N times over;
                # replica 0 carries it, the others run dark
                telemetry=telemetry if i == 0 else None,
                **engine_kwargs,
            )
            eng.replica_id = i
            self._engines.append(eng)
        e0 = self._engines[0]
        self._clock = e0.scheduler.clock
        self._max_pending = e0.scheduler.max_queue * replicas
        self._pending: deque[RoutedHandle] = deque()
        self._handles: dict[int, RoutedHandle] = {}
        self._next_rid = 0
        self._rr = 0                                   # round-robin drive offset
        self._closed = False
        # routing-history affinity map: block-aligned prompt-prefix tuple
        # -> replica index, LRU-bounded (see module docstring)
        self._history: OrderedDict[tuple, int] = OrderedDict()
        # router accounting (mirrored into serving.router.* as it changes)
        self.submitted = 0
        self.routed = 0
        self.affinity_hits = 0
        self.expired = 0
        self.routed_by_replica = [0] * replicas
        reg = registry()
        self._m_queue_depth = reg.gauge("serving.router.queue_depth")
        self._m_routed = reg.counter("serving.router.routed")
        self._m_affinity = reg.counter("serving.router.affinity_hits")
        self._m_imbalance = reg.gauge("serving.router.imbalance")
        self._m_running = [
            reg.gauge(f"serving.router.replica{i}.running") for i in range(replicas)
        ]
        reg.gauge("serving.router.replicas").set(replicas)

    @property
    def replicas(self) -> int:
        return len(self._engines)

    @property
    def engines(self) -> tuple[ServingEngine, ...]:
        """The replica lanes (read-only view; tests and operators peek)."""
        return tuple(self._engines)

    #
    # public API (the solo engine's surface)
    #

    def submit(
        self,
        prompt,
        *,
        max_new_tokens: int,
        deadline: float | None = None,
        generator: torch.Generator | None = None,
        stream_cb: Callable[[int], Any] | None = None,
        adapter_id: str | None = None,
        session_id: str | None = None,
        priority: str | None = None,
        constraint=None,
    ) -> RoutedHandle:
        """Enqueues one request on the router's global queue; returns
        immediately.  Admission is aggregate: the request is validated
        against one replica's full capacity (replicas are configured
        identically, so feasible-on-one means feasible-anywhere) and the
        global queue bound is ``max_queue × replicas``.  Raises
        :class:`AdmissionError` when the request can never fit or the
        global queue is full.

        ``session_id`` / ``priority`` / ``constraint`` pass through to the
        replica (engines must be built with the matching knob); the router
        adds session affinity (a session's next turn routes to the lane
        holding its parked KV) and class-ordered global queueing."""
        if self._closed:
            raise RuntimeError("engine is shut down")
        prompt = np.asarray(prompt, dtype=np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
        reg = registry()
        try:
            blocks = self._engines[0].scheduler.check_feasible(
                int(prompt.shape[0]), max_new_tokens)
            if len(self._pending) >= self._max_pending:
                raise AdmissionError(
                    f"router queue full ({self._max_pending}); request rejected"
                )
        except AdmissionError:
            reg.counter("serving.requests.rejected").inc()
            raise
        now = self._clock()
        handle = RoutedHandle(
            self, self._next_rid, prompt,
            dict(max_new_tokens=int(max_new_tokens), generator=generator,
                 stream_cb=stream_cb, adapter_id=adapter_id,
                 session_id=session_id, priority=priority,
                 constraint=constraint),
            (now + deadline) if deadline is not None else None,
            now,
        )
        handle._blocks = blocks
        if priority is not None:
            handle._level = priority_level(priority)[1]
        self._next_rid += 1
        self.submitted += 1
        self._enqueue(handle)
        self._handles[handle.rid] = handle
        self._m_queue_depth.set(len(self._pending))
        return handle

    def _enqueue(self, handle: RoutedHandle) -> None:
        """Class-ordered global queueing: insert before the first pending
        request of a strictly less urgent class (FIFO within a class).
        All-default submissions carry the same level, so this degrades to
        append — the off-path queue order is untouched."""
        for i, h in enumerate(self._pending):
            if h._level > handle._level:
                self._pending.insert(i, handle)
                return
        self._pending.append(handle)

    def step(self) -> bool:
        """One router iteration: route whatever is placeable, drive every
        replica one step in rotating order (so lane *i*'s dispatch
        overlaps lane *j*'s harvest), then route again — admissions freed
        by this step's finishes land without waiting a full turn.
        Returns whether any work happened anywhere."""
        if self._closed:
            raise RuntimeError("engine is shut down")
        worked = self._route()
        n = len(self._engines)
        start, self._rr = self._rr, (self._rr + 1) % n
        for k in range(n):
            if self._engines[(start + k) % n].step():
                worked = True
        if self._route():
            worked = True
        self._update_gauges()
        return worked

    def run(self, requests: Sequence, *, max_new_tokens: int | None = None) -> list[RequestResult]:
        """Mirrors ``ServingEngine.run``: submits every request (stepping
        through transient router-queue-full backpressure) and drives the
        fleet to completion."""
        handles = []
        for r in requests:
            kw = dict(r) if isinstance(r, dict) else {"prompt": r}
            if "max_new_tokens" not in kw:
                if max_new_tokens is None:
                    raise ValueError("max_new_tokens missing (argument or per-request)")
                kw["max_new_tokens"] = max_new_tokens
            prompt = kw.pop("prompt")
            while len(self._pending) >= self._max_pending:
                if not self.step():
                    raise AdmissionError(
                        f"router queue full ({self._max_pending}) and the "
                        "fleet cannot make progress"
                    )
            handles.append(self.submit(prompt, **kw))
        self.drain()
        return [h.result(drive=False) for h in handles]

    def drain(self) -> None:
        """Steps until every submitted request has finished.  A stall
        raises :class:`EngineStalledError` naming WHICH replica stalled,
        with that replica's flight-state snapshot attached (an unroutable
        global queue with idle replicas names the router instead)."""
        while self._busy():
            if not self.step():
                raise self._stall_error("fleet stalled during drain")

    def evict(self, handle: RoutedHandle) -> None:
        """Administratively removes a request wherever it is: routed →
        the owning replica frees its blocks (that replica's pool only);
        still pending → dropped from the global queue with a synthetic
        ``"evicted"`` result.  Either way the request's session (if any)
        is closed fleet-wide — an evicted turn must not leave parked
        blocks resident on any lane."""
        if handle.done():
            return
        sid = handle._kwargs.get("session_id")
        if handle._inner is not None:
            self._engines[handle.replica].evict(handle._inner)
            if sid is not None:
                self.close_session(sid)
            return
        self._finish_pending(handle, FINISH_EVICTED)
        try:
            self._pending.remove(handle)
        except ValueError:
            pass
        if sid is not None:
            self.close_session(sid)
        self._m_queue_depth.set(len(self._pending))

    def close_session(self, session_id: str) -> int:
        """Releases a session's parked blocks on EVERY lane; returns the
        total blocks freed.  (A session normally lives on one lane thanks
        to affinity, but the fleet-wide sweep is what guarantees a dead
        session's blocks return to the free list no matter how routing
        history scattered its turns.)"""
        return sum(eng.close_session(session_id) for eng in self._engines)

    def shutdown(self, *, drain: bool = True) -> None:
        """Graceful stop: optionally drains the fleet, evicts whatever
        remains (pending and replica-local), shuts every replica down,
        and rejects further submits."""
        if self._closed:
            return
        if drain:
            self.drain()
        for h in list(self._pending):
            self._finish_pending(h, FINISH_EVICTED)
        self._pending.clear()
        for eng in self._engines:
            eng.shutdown(drain=False)
        self._closed = True

    def __enter__(self) -> "ReplicatedEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown(drain=exc == (None, None, None))

    def stats(self) -> dict:
        """Router-level statistics beside every replica's own
        ``stats()``.  ``router.imbalance`` is the running-occupancy
        spread (max − min) across lanes; ``aggregate`` sums the fleet."""
        per = [eng.stats() for eng in self._engines]
        running = [p["running"] for p in per]
        return {
            "replicas": len(self._engines),
            "router": {
                "queue_depth": len(self._pending),
                "submitted": self.submitted,
                "routed": self.routed,
                "affinity_hits": self.affinity_hits,
                "expired": self.expired,
                "routed_by_replica": list(self.routed_by_replica),
                "history_size": len(self._history),
                "imbalance": (max(running) - min(running)) if running else 0,
            },
            "per_replica": per,
            "aggregate": {
                "queue_depth": len(self._pending) + sum(p["queue_depth"] for p in per),
                "running": sum(running),
                "pool_free_blocks": sum(p["pool_free_blocks"] for p in per),
                "pool_free_blocks_low_water": [
                    p["pool_free_blocks_low_water"] for p in per
                ],
                "tokens_generated": sum(p["tokens_generated"] for p in per),
                "decode_steps": sum(p["decode_steps"] for p in per),
                "host_visits": sum(p["host_visits"] for p in per),
                "prefix_hits": sum(p["prefix_hits"] for p in per),
                "prefix_lookups": sum(p["prefix_lookups"] for p in per),
                "prefix_hit_rate": (
                    sum(p["prefix_hits"] for p in per)
                    / sum(p["prefix_lookups"] for p in per)
                    if sum(p["prefix_lookups"] for p in per) else None
                ),
                **({
                    "session_resident_blocks": sum(
                        p["sessions"]["resident_blocks"]
                        for p in per if "sessions" in p),
                    "session_reattach_hits": sum(
                        p["sessions"]["reattach_hits"]
                        for p in per if "sessions" in p),
                    "session_evictions": sum(
                        p["sessions"]["evictions"]
                        for p in per if "sessions" in p),
                } if any("sessions" in p for p in per) else {}),
                **({"preempted": sum(p["priority"]["preempted"]
                                     for p in per if "priority" in p)}
                   if any("priority" in p for p in per) else {}),
                **({"goodput": fleet_goodput(
                        [p["goodput"] for p in per if "goodput" in p])}
                   if any("goodput" in p for p in per) else {}),
            },
        }

    def goodput_report(self) -> dict:
        """Fleet goodput: the summed waste taxonomy plus per-lane reports
        and the committed-work imbalance figure (see
        :func:`thunder_tpu_torch.observability.goodput.fleet_goodput`).  Lanes
        with the ledger disabled report ``{"enabled": False}``."""
        per = [eng.goodput_report() for eng in self._engines]
        snaps = [p for p in per if p.get("enabled", True)]
        return {
            "replicas": len(self._engines),
            "per_replica": per,
            **(fleet_goodput(snaps) if snaps else {"enabled": False}),
        }

    #
    # routing
    #

    def _route(self) -> bool:
        """Places global-queue heads onto replicas until the head cannot
        be placed (strict FIFO — see the module docstring for why an
        affinity-blocked head waits rather than routing around)."""
        worked = False
        while self._pending:
            head = self._pending[0]
            now = self._clock()
            if head._deadline_t is not None and now >= head._deadline_t:
                self._finish_pending(head, FINISH_DEADLINE)
                self._pending.popleft()
                sid = head._kwargs.get("session_id")
                if sid is not None:
                    # expiry kills the session: release parked blocks on
                    # every lane, not just wherever affinity last sent it
                    self.close_session(sid)
                worked = True
                continue
            placed = self._place(head)
            if placed is None:
                break
            self._pending.popleft()
            worked = True
        if worked:
            self._m_queue_depth.set(len(self._pending))
        return worked

    def _place(self, head: RoutedHandle) -> int | None:
        """One placement attempt; returns the replica index or ``None``
        when the head must wait this step."""
        idx, kind = self._choose(head)
        if idx is None:
            return None
        eng = self._engines[idx]
        adapter = head._kwargs.get("adapter_id")
        shared = eng.probe_prefix(head._prompt, adapter) // eng.pool.block_size
        if not (eng.scheduler.can_accept(head._blocks, shared_blocks=shared)
                and len(eng.scheduler.queue) < eng.scheduler.max_queue):
            # the preferred replica can't admit now: WAIT (affinity-
            # preserving FIFO).  For the least-loaded case _choose already
            # filtered to acceptors, so this only triggers on affinity.
            return None
        kw = dict(head._kwargs)
        if head._deadline_t is not None:
            kw["deadline"] = max(head._deadline_t - self._clock(), 1e-9)
        inner = eng.submit(head._prompt, **kw)
        head._inner = inner
        head.replica = idx
        self.routed += 1
        self.routed_by_replica[idx] += 1
        self._m_routed.inc()
        if kind is not None:
            self.affinity_hits += 1
            self._m_affinity.inc()
        self._remember(head._prompt, idx)
        if eng._tracer is not None:
            eng._tracer.instant(inner.rid, "router.routed",
                                replica=idx, affinity=kind or "least-loaded",
                                router_rid=head.rid)
        if eng._flight is not None:
            eng._flight.record("route", rid=inner.rid, replica=idx,
                               affinity=kind, router_rid=head.rid)
        return idx

    def _choose(self, head: RoutedHandle) -> tuple[int | None, str | None]:
        """Pick the target replica: resident session > resident prefix >
        routing history > least-loaded-that-can-accept."""
        sid = head._kwargs.get("session_id")
        if sid is not None:
            for i, eng in enumerate(self._engines):
                if eng.session_resident(sid):
                    return i, "session"
        best_i, best_k = None, 0
        adapter = head._kwargs.get("adapter_id")
        for i, eng in enumerate(self._engines):
            k = eng.probe_prefix(head._prompt, adapter)
            if k > best_k:
                best_i, best_k = i, k
        if best_i is not None:
            return best_i, "resident"
        hist = self._recall(head._prompt)
        if hist is not None:
            return hist, "history"
        # least-loaded among replicas that can admit NOW: most uncommitted
        # free blocks, ties to the emptier then lower-indexed lane
        best = None
        for i, eng in enumerate(self._engines):
            sch = eng.scheduler
            shared = 0   # no affinity anywhere, by construction of this branch
            if not (sch.can_accept(head._blocks, shared_blocks=shared)
                    and len(sch.queue) < sch.max_queue):
                continue
            load = (eng.pool.num_free - sch.committed_blocks(),
                    -(len(sch.running) + len(sch.queue)), -i)
            if best is None or load > best[1]:
                best = (i, load)
        return (best[0], None) if best is not None else (None, None)

    def _remember(self, prompt: np.ndarray, idx: int) -> None:
        """Registers every block-aligned prefix of a routed prompt in the
        history map, so the NEXT member of the family lands on the same
        lane even before anything is resident."""
        bs = self._engines[0].pool.block_size
        hi = ((int(prompt.shape[0]) - 1) // bs) * bs
        toks = prompt.tolist()
        for k in range(bs, hi + 1, bs):
            key = tuple(toks[:k])
            self._history[key] = idx
            self._history.move_to_end(key)
        while len(self._history) > _HISTORY_CAP:
            self._history.popitem(last=False)

    def _recall(self, prompt: np.ndarray) -> int | None:
        """Longest-prefix lookup in the history map (freshening the hit)."""
        bs = self._engines[0].pool.block_size
        hi = ((int(prompt.shape[0]) - 1) // bs) * bs
        toks = prompt.tolist()
        for k in range(hi, 0, -bs):
            idx = self._history.get(tuple(toks[:k]))
            if idx is not None:
                self._history.move_to_end(tuple(toks[:k]))
                return idx
        return None

    #
    # internals
    #

    def _busy(self) -> bool:
        return bool(self._pending) or any(
            eng.scheduler.queue or eng.scheduler.running for eng in self._engines
        )

    def _finish_pending(self, handle: RoutedHandle, reason: str) -> None:
        """Synthesizes a terminal result for a request that never reached
        a replica (router-side deadline expiry or eviction)."""
        now = self._clock()
        handle._synthetic = RequestResult(
            rid=handle.rid,
            prompt=handle._prompt,
            new_tokens=(),
            finish_reason=reason,
            ttft_s=None,
            tpot_s=None,
            tokens_per_sec=None,
            queue_s=None,
            e2e_s=now - handle._submit_t,
            shared_prefix_blocks=0,
        )
        if reason == FINISH_DEADLINE:
            self.expired += 1

    def _stall_error(self, what: str) -> EngineStalledError:
        """Builds the replica-naming stall error: the first replica still
        holding work is the culprit and contributes its flight state; an
        all-idle fleet with an unroutable global queue names the router."""
        for i, eng in enumerate(self._engines):
            if eng.scheduler.queue or eng.scheduler.running:
                return EngineStalledError(
                    what, eng._flight_state(), replica=i)
        return EngineStalledError(
            f"{what} — global queue has {len(self._pending)} unroutable "
            "request(s) but every replica is idle", self._flight_state())

    def _flight_state(self) -> dict:
        """Router-level snapshot (nested per-replica summaries stay
        shallow; a specific replica's full flight state travels on the
        stall error that names it)."""
        return {
            "router": self.stats()["router"],
            "pending": [
                {"rid": h.rid, "prompt_tokens": int(h._prompt.shape[0]),
                 "blocks": h._blocks}
                for h in self._pending
            ],
            "replicas": [
                {"replica": i,
                 "queued": len(eng.scheduler.queue),
                 "running": len(eng.scheduler.running),
                 "pool_free": eng.pool.num_free}
                for i, eng in enumerate(self._engines)
            ],
        }

    def _update_gauges(self) -> None:
        running = [len(eng.scheduler.running) for eng in self._engines]
        for g, r in zip(self._m_running, running):
            g.set(r)
        self._m_imbalance.set((max(running) - min(running)) if running else 0)
        self._m_queue_depth.set(len(self._pending))
