"""Continuous-batching scheduler: FIFO admission, deadlines, buckets.

Counterpart of ``thunder_tpu/serving/scheduler.py``, whole; the one change
is that a request carries its own ``torch.Generator`` (``generator``) where
the JAX package carries a PRNG key (so :meth:`Scheduler.preempt` relies on
the engine to restore it).

The scheduler owns the *request-level* state machine — queued → running →
finished — and every policy decision:

- **Admission control** is reservation-based (the TGI model, not vLLM's
  preempt-and-recompute): a request is admitted only when a batch slot is
  free AND the pool can lease every block the request could ever need
  (``prompt + max_new_tokens``, minus blocks covered by a shared prefix).
  Requests that don't fit wait in a bounded FIFO queue; a full queue rejects
  at ``submit`` (:class:`AdmissionError`).  Admitted requests therefore
  *never* run out of blocks mid-decode.
- **Strict FIFO**: if the queue head does not fit, later (smaller) requests
  do not jump it — saturation cannot starve a large request forever.
- **Deadlines** are absolute timestamps on the engine's clock (injectable
  for tests); expiry is checked every step for queued and running requests
  alike and finishes the request with reason ``"deadline"``.
- **Bucketed shapes**: batch size and per-request block counts round up to
  small power-of-two bucket sets, so the number of distinct step
  geometries is bounded by ``len(batch_buckets) × len(block_buckets)`` regardless of
  traffic mix.
- **Sliding-window expiry**: for banded models, blocks whose every position
  has slid out of the attention window are released back to the pool and
  the table entry falls back to the sink block (the positional keep-mask
  already excludes those slots, so correctness is unaffected).
- **Chunked prefill** (``prefill_chunk=``): long prompts prefill in
  block-aligned pieces of at most ``prefill_chunk`` tokens, one piece per
  engine step, so a long prompt never monopolizes a step.  A request whose
  prompt is not yet fully resident is *running but not decode-ready*
  (``pos < prompt_len``); :meth:`Scheduler.decode_ready` filters the batch
  the decode lane dispatches.  With chunking enabled the prompt-length
  admission cap is the pool/block-bucket capacity, not the largest prefill
  bucket — each piece is bounded by the bucket set instead.
"""
from __future__ import annotations

import itertools
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Sequence

import numpy as np

from thunder_tpu_torch.serving.kv_pool import SINK_BLOCK, PagedKVPool

__all__ = [
    "AdmissionError",
    "FINISH_LENGTH",
    "FINISH_EOS",
    "FINISH_DEADLINE",
    "FINISH_EVICTED",
    "FINISH_ERROR",
    "Request",
    "Scheduler",
    "pick_bucket",
    "pow2_buckets",
]

FINISH_LENGTH = "length"
FINISH_EOS = "eos"
FINISH_DEADLINE = "deadline"
FINISH_EVICTED = "evicted"
FINISH_ERROR = "error"


class AdmissionError(RuntimeError):
    """Submit rejected: the wait queue is at capacity (or the request could
    never fit the pool at all)."""


def pow2_buckets(lo: int, hi: int) -> tuple[int, ...]:
    """Powers of two covering [lo, hi] (endpoints rounded up)."""
    out = []
    b = 1
    while b < lo:
        b *= 2
    while True:
        out.append(b)
        if b >= hi:
            break
        b *= 2
    return tuple(out)


def pick_bucket(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n (buckets sorted ascending)."""
    for b in buckets:
        if b >= n:
            return b
    raise ValueError(f"{n} exceeds the largest bucket {buckets[-1]}")


@dataclass
class Request:
    """One in-flight generation request (scheduler-owned mutable state)."""

    rid: int
    prompt: np.ndarray                      # (T_prompt,) int32
    max_new_tokens: int
    generator: object                       # this request's torch.Generator
    deadline_t: float | None = None         # absolute, engine clock
    stream_cb: Callable | None = None
    submit_t: float = 0.0
    # multi-tenant routing: which LoRA adapter (registry slot) this request
    # decodes through; slot 0 is the reserved base (no-adapter) slot
    adapter_id: str | None = None
    adapter_slot: int = 0
    adapter_version: int = 0                # the slot's factor version at admission
    # stateful serving: session identity (prefix blocks parked on finish),
    # priority class (lower level = more urgent; 1 = "normal" everywhere
    # when priorities are off), and the host-side decoding automaton
    session_id: str | None = None
    priority: int = 1
    priority_class: str = "normal"
    constraint: object | None = None
    preemptions: int = 0
    # cache state
    block_table: list[int] = field(default_factory=list)
    n_shared_blocks: int = 0                # leading table entries leased via share()
    pos: int = 0                            # cache slots written (prompt + generated)
    # lifecycle
    state: str = "queued"                   # queued | running | finished
    generated: list[int] = field(default_factory=list)
    finish_reason: str | None = None
    admit_t: float | None = None
    first_token_t: float | None = None
    finish_t: float | None = None
    prefill_compiled: bool = False          # this request's prefill met a new bucket geometry
    error_cause: dict | None = None         # structured cause when quarantined
    # recompute accounting (goodput ledger): prompt positions
    # re-dispatched by replay (recovery/preemption/session re-attach) and
    # why; replay_until marks the watermark below which prefill positions
    # are recomputation rather than fresh work
    tokens_recomputed: int = 0
    recompute_causes: list = field(default_factory=list)
    replay_until: int = 0
    replay_cause: str | None = None

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def total_capacity(self) -> int:
        """Cache slots this request may ever write."""
        return self.prompt_len + self.max_new_tokens

    def remaining_budget(self) -> int:
        return self.max_new_tokens - len(self.generated)


class Scheduler:
    """Queue + running set + every admission/finish policy decision."""

    def __init__(
        self,
        pool: PagedKVPool,
        *,
        max_batch: int = 8,
        max_queue: int = 64,
        clock: Callable[[], float] | None = None,
        batch_buckets: Sequence[int] | None = None,
        block_buckets: Sequence[int] | None = None,
        prefill_buckets: Sequence[int] | None = None,
        sliding_window: int | None = None,
        prefill_chunk: int | None = None,
        reserve_extra_tokens: int = 0,
        decode_horizon: int = 1,
    ):
        self.pool = pool
        self.max_batch = int(max_batch)
        self.max_queue = int(max_queue)
        self.clock = clock if clock is not None else time.monotonic
        self.sliding_window = sliding_window
        # extra cache slots reserved past prompt+max_new (speculative
        # serving: a round's draft scan writes up to K slots past the last
        # committed token, and those writes must land in owned blocks;
        # multi-step decode likewise reserves its N-1 slot overshoot)
        self.reserve_extra_tokens = int(reserve_extra_tokens)
        # tokens one decode dispatch may serve per row before the host sees
        # any of them (decode_steps=N).  Admission, deadline expiry, and
        # window reclamation all happen at visit boundaries — the horizon is
        # recorded so snapshots/diagnostics can attribute the added
        # scheduling latency to the knob rather than to a stall
        self.decode_horizon = int(decode_horizon)
        max_blocks = pool.num_usable
        self.batch_buckets = tuple(batch_buckets) if batch_buckets else pow2_buckets(1, self.max_batch)
        self.block_buckets = tuple(block_buckets) if block_buckets else pow2_buckets(1, max_blocks)
        self.prefill_buckets = (
            tuple(prefill_buckets) if prefill_buckets
            else pow2_buckets(min(8, pool.block_size), pool.capacity_tokens(max_blocks))
        )
        if prefill_chunk is not None:
            prefill_chunk = int(prefill_chunk)
            bs = pool.block_size
            if prefill_chunk < bs or prefill_chunk % bs:
                raise ValueError(
                    f"prefill_chunk={prefill_chunk} must be a positive "
                    f"multiple of the pool block_size ({bs}) so every chunk "
                    f"boundary is block-aligned"
                )
            if pick_bucket(prefill_chunk, self.prefill_buckets) != prefill_chunk:
                raise ValueError(
                    f"prefill_chunk={prefill_chunk} is not itself a prefill "
                    f"bucket ({self.prefill_buckets}); intermediate chunks "
                    f"must bucket to exactly their own length (zero padding) "
                    f"so a chunk never writes past its block range"
                )
        self.prefill_chunk = prefill_chunk
        self.queue: deque[Request] = deque()
        self.running: list[Request] = []     # admission order == FIFO batch order
        self._ids = itertools.count()

    #
    # submit / admission
    #

    def blocks_needed(self, req: Request) -> int:
        """Full reservation: blocks covering prompt + max_new plus any
        engine-level overshoot reserve (window models reclaim early via
        :meth:`expire_window_blocks`, but admission is conservative so a
        running request can never be starved of blocks)."""
        return self.pool.blocks_for_tokens(
            req.total_capacity + self.reserve_extra_tokens)

    def bytes_needed(self, req: Request) -> int:
        """The reservation in **stored arena bytes** — block count × the
        pool's per-block cost at its storage dtype (int8 blocks plus their
        scale arenas cost ~4x less than f32, which is where quantized
        capacity shows up in admission accounting)."""
        return self.blocks_needed(req) * self.pool.block_bytes()

    def check_feasible(self, prompt_len: int, max_new_tokens: int) -> int:
        """The never-fits validation, callable without constructing a
        :class:`Request` (the dp router pre-validates against one replica's
        configuration before a request enters the global queue — every
        replica is configured identically, so one check covers the fleet).
        Returns the full block reservation; raises :class:`AdmissionError`
        for a request that could never be admitted."""
        blocks = self.pool.blocks_for_tokens(
            prompt_len + int(max_new_tokens) + self.reserve_extra_tokens)
        hard_cap = min(self.pool.num_usable, self.block_buckets[-1])
        if blocks > hard_cap:
            raise AdmissionError(
                f"request needs {blocks} blocks; the pool/bucket "
                f"cap is {hard_cap} — it can never be admitted"
            )
        if self.prefill_chunk is None and prompt_len > self.prefill_buckets[-1]:
            # with chunking enabled the prompt prefills in pieces bounded by
            # the bucket set, so only the pool/block-bucket capacity (checked
            # above) caps prompt length
            raise AdmissionError(
                f"prompt of {prompt_len} tokens exceeds the largest prefill "
                f"bucket {self.prefill_buckets[-1]} — it can never be admitted"
            )
        return blocks

    def committed_blocks(self) -> int:
        """Blocks the queued (not-yet-leased) requests will claim at
        admission — reservations *promised* but not yet taken from the
        pool's free list.  The router's hand-off test subtracts this from
        ``pool.num_free`` so stacking several requests onto one replica in
        a single routing pass can never overcommit its arena."""
        return sum(self.blocks_needed(r) for r in self.queue)

    def free_slots(self) -> int:
        """Batch slots not yet spoken for: ``max_batch`` minus running
        minus queued (queued requests hold a promised slot the same way
        :meth:`committed_blocks` holds promised blocks)."""
        return self.max_batch - len(self.running) - len(self.queue)

    def can_accept(self, blocks: int, *, shared_blocks: int = 0) -> bool:
        """Whether a request reserving ``blocks`` (less any shareable
        prefix discount) could be handed to this scheduler *now* without
        queueing behind an infeasible head: a free batch slot AND enough
        uncommitted free blocks.  This is the dp router's placement test —
        it keeps replica queues shallow (a handed-off request admits on the
        replica's next step), which is what lets prefix affinity engage."""
        if self.free_slots() < 1:
            return False
        need = max(blocks - shared_blocks, 0)
        return self.pool.num_free - self.committed_blocks() >= need

    def submit(self, prompt, max_new_tokens: int, *, generator, deadline_s: float | None = None,
               stream_cb=None, adapter_id: str | None = None,
               adapter_slot: int = 0, session_id: str | None = None,
               priority: int = 1, priority_class: str = "normal",
               constraint=None) -> Request:
        prompt = np.asarray(prompt, dtype=np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
        now = self.clock()
        req = Request(
            rid=next(self._ids),
            prompt=prompt,
            max_new_tokens=int(max_new_tokens),
            generator=generator,
            deadline_t=(now + deadline_s) if deadline_s is not None else None,
            stream_cb=stream_cb,
            submit_t=now,
            adapter_id=adapter_id,
            adapter_slot=int(adapter_slot),
            session_id=session_id,
            priority=int(priority),
            priority_class=str(priority_class),
            constraint=constraint,
        )
        self.check_feasible(req.prompt_len, req.max_new_tokens)
        if len(self.queue) >= self.max_queue:
            raise AdmissionError(
                f"wait queue full ({self.max_queue}); request rejected"
            )
        self._enqueue(req)
        return req

    def _enqueue(self, req: Request) -> None:
        """Queue insertion: priority order, FIFO within a class.

        Inserts before the first entry of a strictly less urgent class
        (larger level) — with uniform levels (priorities off) this is a
        plain append, so default scheduling is unchanged."""
        at = next((i for i, q in enumerate(self.queue)
                   if q.priority > req.priority), None)
        if at is None:
            self.queue.append(req)
        else:
            self.queue.insert(at, req)

    def next_admittable(self, *, shared_blocks: int = 0) -> Request | None:
        """FIFO head if a batch slot and enough blocks are free, else None
        (strict FIFO: a blocked head blocks everything behind it).
        ``shared_blocks`` discounts blocks the engine found shareable."""
        if not self.queue or len(self.running) >= self.max_batch:
            return None
        head = self.queue[0]
        if self.pool.can_alloc(max(self.blocks_needed(head) - shared_blocks, 0)):
            return head
        return None

    def admit(self, req: Request, block_table: list[int], n_shared: int) -> None:
        """Moves the queue head to running with its leased table."""
        assert self.queue and self.queue[0] is req, "admission must be FIFO"
        self.queue.popleft()
        req.block_table = block_table
        req.n_shared_blocks = n_shared
        # the block-aligned prefill resume point: tokens below it are
        # resident via the shared prefix; prefill pieces advance pos from
        # here (chunked prefill dispatches one piece per engine step)
        req.pos = n_shared * self.pool.block_size
        req.state = "running"
        req.admit_t = self.clock()
        self.running.append(req)

    #
    # finishing
    #

    def finish(self, req: Request, reason: str) -> None:
        """Marks finished and returns every leased block to the pool."""
        if req.state == "finished":
            return
        if req.state == "running":
            self.running.remove(req)
        elif req.state == "queued":
            self.queue.remove(req)
        req.state = "finished"
        req.finish_reason = reason
        req.finish_t = self.clock()
        if req.block_table:
            self.pool.free([b for b in req.block_table if b != SINK_BLOCK])
            req.block_table = []

    def preempt(self, req: Request) -> None:
        """Evict-and-resume checkpoint: running → queued, blocks released.

        The checkpoint is host-side: prompt and generated tokens are
        exact, and the engine gives the request's ``torch.Generator`` back
        the state it saved at the last harvest (a port generator advances
        when a step draws, at dispatch; the engine drops an in-flight
        step's record for this request by ``preemptions``, its epoch).  So
        releasing the blocks loses nothing that the chunk-step replay
        cannot rebuild at re-admission.  The caller (the engine) must scrub
        its prefix index for this request *before* calling, exactly as for
        finish.
        Re-queued at the front of its own class (seniority by submit
        time), behind every strictly more urgent entry."""
        assert req.state == "running", f"cannot preempt {req.state} request"
        self.running.remove(req)
        if req.block_table:
            self.pool.free([b for b in req.block_table if b != SINK_BLOCK])
            req.block_table = []
        req.n_shared_blocks = 0
        req.pos = 0
        req.state = "queued"
        req.preemptions += 1
        at = next((i for i, q in enumerate(self.queue)
                   if q.priority > req.priority
                   or (q.priority == req.priority
                       and q.submit_t > req.submit_t)), None)
        if at is None:
            self.queue.append(req)
        else:
            self.queue.insert(at, req)

    def deadline_expired(self) -> list[Request]:
        """Queued/running requests past their deadline.  The engine finishes
        them (it must scrub its prefix index *before* blocks are freed)."""
        now = self.clock()
        return [
            r for r in (*self.running, *self.queue)
            if r.deadline_t is not None and now >= r.deadline_t
        ]

    def expire_window_blocks(self, req: Request) -> int:
        """Releases blocks that slid fully out of the attention window:
        block i (positions [i*bs, (i+1)*bs)) is dead once
        ``(i+1)*bs <= pos+1 - window`` — the next query attends only
        ``(pos-window, pos]``.  Dead table entries fall back to the sink.
        Never releases shared-prefix blocks still co-owned (free() only
        drops this request's reference).  Returns blocks released."""
        W = self.sliding_window
        if W is None:
            return 0
        bs = self.pool.block_size
        horizon = req.pos + 1 - W  # strictly-below-this positions are dead
        n_dead = min(max(horizon // bs, 0), len(req.block_table))
        released = 0
        for i in range(n_dead):
            if req.block_table[i] != SINK_BLOCK:
                self.pool.free([req.block_table[i]])
                req.block_table[i] = SINK_BLOCK
                released += 1
        return released

    def state_snapshot(self) -> dict:
        """Request-level state for the flight recorder: one compact row per
        queued/running request plus the bucket configuration."""
        def row(r: Request) -> dict:
            return {
                "rid": r.rid,
                "state": r.state,
                "prompt_tokens": r.prompt_len,
                "generated": len(r.generated),
                "max_new_tokens": r.max_new_tokens,
                "pos": r.pos,
                "prefilled": r.pos >= r.prompt_len,
                "blocks": len(r.block_table),
                "reserved_bytes": self.bytes_needed(r),
                "shared_blocks": r.n_shared_blocks,
                "adapter_id": r.adapter_id,
                "prefill_compiled": r.prefill_compiled,
                "deadline_t": r.deadline_t,
                "session_id": r.session_id,
                "priority": r.priority_class,
                "constrained": r.constraint is not None,
                "preemptions": r.preemptions,
            }

        return {
            "queue_depth": len(self.queue),
            "running": len(self.running),
            "max_batch": self.max_batch,
            "max_queue": self.max_queue,
            "batch_buckets": list(self.batch_buckets),
            "block_buckets": list(self.block_buckets),
            "prefill_buckets": list(self.prefill_buckets),
            "prefill_chunk": self.prefill_chunk,
            "decode_horizon": self.decode_horizon,
            "requests": [row(r) for r in (*self.running, *self.queue)],
        }

    #
    # bucket selection
    #

    def decode_ready(self) -> list[Request]:
        """Running requests the decode lane may advance this step, in FIFO
        admission order: the prompt is fully resident AND the first token
        exists (a chunked prefill in progress, or a final chunk whose token
        is still in flight, keeps the request out of the decode batch)."""
        return [r for r in self.running if r.generated and r.pos >= r.prompt_len]

    def decode_bucket(self, ready: Sequence[Request] | None = None) -> tuple[int, int]:
        """(batch bucket, table-width bucket) for the decode batch
        (``ready`` defaults to the whole running set — the synchronous
        engine, where running implies decode-ready)."""
        rows = list(ready) if ready is not None else self.running
        B = pick_bucket(len(rows), self.batch_buckets)
        widest = max(len(r.block_table) for r in rows)
        return B, pick_bucket(widest, self.block_buckets)

    def prefill_bucket(self, n_tokens: int) -> int:
        return pick_bucket(n_tokens, self.prefill_buckets)
