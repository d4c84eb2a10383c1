"""Serving engine front-end: ``serve(...)`` → :class:`ServingEngine`.

Counterpart of ``thunder_tpu/serving/engine.py`` for the serving main path:
continuous (in-flight) batching over a paged KV pool, where independent
requests join the decode batch the step after their prefill and leave it
the step they finish.

- ``models.generate.forward_with_cache`` is the model step of the prefill
  (whole prompt at once, over the request's blocks gathered dense) and of
  the gather decode path;
- the paged decode path (``attn="paged"``, what ``"auto"`` resolves to)
  runs ``serving.paged_attention.forward_paged``: per layer one launch of
  the ``paged_attn_decode`` kernel straight off the block arena, then one
  ``paged_token_write`` launch lands the fresh K and V.  On the CPU the same
  path runs the kernels' plain PyTorch versions;
- the prefill lane (``prefill_chunk=N``, async engines only) splits a
  prompt longer than N into block-aligned pieces, one per engine step, so
  decode steps interleave with a long prefill.  Intermediate pieces write
  K/V only: the paged kind (``prefill_chunk_paged``) runs
  ``forward_paged`` at T = N through the ``paged_attn_verify`` kernel and
  lands the chunk with ``paged_chunk_write``; the gather kind
  (``prefill_chunk``) densifies.  The kind is resolved once, at
  construction: paged needs ``attn`` paged, block-aligned chunk and
  prefill buckets, no sliding window and no ``speculative=``, else gather
  with the reason in ``stats()["attn"]["kinds"]``.  The final piece runs
  the ordinary ``prefill`` and samples token 0;
- the speculative lane (``speculative=SpecConfig(...)``, see
  :mod:`serving.speculative`): a draft model proposes K tokens per round
  over its own arena beside the target's, the target verifies K+1
  positions at once (``verify_paged``: the ``paged_attn_verify`` kernel and
  the ``paged_token_write_masked`` commit), and each round emits 1..K+1
  tokens per request;
- the pool (:mod:`serving.kv_pool`) owns cache memory.  Arenas update in
  place, which replaces the JAX package's buffer donation: every step
  reads and writes the same tensors on one stream, so stream order is
  what keeps a step's reads ahead of a later step's writes;
- quantized KV (``kv_dtype="int8"|"fp8"``, :mod:`serving.quant`): the
  arenas store 1-byte values and float32 scales.  The gather steps
  dequantize on gather and quantize on scatter (``gather_dense_q``,
  ``scatter_blocks_q``, ``scatter_token_q``); the paged steps run the same
  kernels as above with the dequant inside the attention kernels and the
  fused quantizing writers (``paged_token_write_fused``,
  ``paged_chunk_write_fused``).  The paged/gather resolution does not look
  at ``kv_dtype``.  Every prefill and chunk piece measures its
  quantization error into the ``serving.kv_quant.rel_err`` gauge;
- the scheduler (:mod:`serving.scheduler`) owns admission, FIFO order,
  deadlines and the bucket sets.  Batch, block and prefill buckets stay as
  in the JAX package, so each step runs at one of a bounded set of bucket
  geometries; ``compile_counts`` counts the geometries seen (PyTorch runs
  eagerly and compiles nothing);
- weight quantization (``quantized=True``): every forward of every lane
  (prefill, chunk pieces, gather and paged decode, the speculative target
  and draft) runs its weight matmuls through ``quantex.int8_linear``, per
  call, as the reference's ``_fwd_kwargs`` passes ``quantized=`` to each;
- MoE configs (``LLaMAMoE``) serve on every lane through the dense expert
  MLP with its float32 router;
- multi-tenant LoRA (``lora=AdapterRegistry(...)``, :mod:`serving.lora`):
  ``submit(..., adapter_id=...)`` routes a request through a registered
  adapter.  A prefill piece reads its one request's factors as views of
  the registry's arenas; every batched step passes the arenas and the
  rows' slots, which the paged decode, paged chunk and ``verify_paged``
  steps' ``lora_delta_fused`` kernel (wq, wk, wv, wo: four launches per
  layer) reads inside, and the plain delta (the gather lanes, MLP targets)
  by ``index_select`` layer by layer: no step copies a whole stack of
  factors.  Requests of different adapters never share a prompt prefix;
- greedy and temperature sampling; each request draws from its own
  ``torch.Generator`` — one draw at the prefill and one per decode step,
  like a solo ``generate()`` — so its tokens do not depend on what else
  shares the batch.

The drive loop is threadless with two lanes (``async_step=True``, the
default): a step harvests the tokens of the decode dispatched by the
previous step (the one host block), expires deadlines, dispatches decode
for the current batch — on the card, kernels are queued and the host goes
on — and admits and prefills new requests while the card computes.
``async_step=False`` runs admit → prefill → one blocking decode.  Served
tokens are the same either way.

Engine options of the JAX package that belong to later slices of the port
raise ``NotImplementedError`` naming the option.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from functools import partial
from typing import Any, Callable, Sequence

import numpy as np
import torch

from thunder_tpu_torch._device import resolve_device
from thunder_tpu_torch.models.generate import forward_with_cache, sample_token
from thunder_tpu_torch.models.llama import build_rope_cache
from thunder_tpu_torch.serving import speculative as spec_lane
from thunder_tpu_torch.observability.metrics import registry
from thunder_tpu_torch.serving.lora import AdapterRegistry
from thunder_tpu_torch.serving.kv_pool import (
    SINK_BLOCK,
    PagedKVPool,
    PrefixIndex,
    chunk_tables,
)
from thunder_tpu_torch.serving.paged_attention import (
    forward_paged,
    paged_supported,
    write_fresh_kv,
    write_fresh_kv_chunk,
)
from thunder_tpu_torch.serving.scheduler import (
    FINISH_DEADLINE,
    FINISH_EOS,
    FINISH_EVICTED,
    FINISH_LENGTH,
    AdmissionError,
    Request,
    Scheduler,
    pick_bucket,
)

__all__ = [
    "serve",
    "ServingEngine",
    "RequestHandle",
    "RequestResult",
    "AdmissionError",
    "EngineStalledError",
]

# engine options of the JAX package not ported yet, with their "off" values
_DEFERRED_ENGINE = {
    "model_fn": None,
    "telemetry": None, "trace": None, "slo": None, "flight_recorder": None,
    "mesh": None, "shardings": None, "fault_plan": None,
    "retry": None, "watchdog_timeout_s": None, "replica_id": None,
    "decode_steps": 1, "sessions": None, "priorities": None, "constraints": None,
    "goodput": None, "replicas": 1, "fault_plans": None,
}
_DEFERRED_SUBMIT = {"key": None, "session_id": None, "priority": None, "constraint": None}


def _reject_deferred(where: str, given: dict, table: dict) -> None:
    for name, value in given.items():
        if name not in table:
            raise TypeError(f"{where} got an unexpected keyword argument {name!r}")
        off = table[name]
        if value is None or value is False or (off is not None and value == off):
            continue
        raise NotImplementedError(
            f"{where}: {name}= is not ported to thunder_tpu_torch yet")


class EngineStalledError(RuntimeError):
    """``drain()``/``result()`` could not make progress: requests remain
    queued/running but ``step()`` did no work.  Carries a state snapshot
    (scheduler rows, pool counts) as ``.state``."""

    def __init__(self, msg: str, state: dict | None = None):
        self.state = state or {}
        pool = self.state.get("pool", {})
        detail = (f" [pool free={pool.get('num_free')}/{pool.get('num_blocks')} "
                  f"leased={pool.get('leased_blocks')}]" if pool else "")
        super().__init__(msg + detail)


@dataclass(frozen=True)
class RequestResult:
    """Structured outcome of one served request."""

    rid: int
    prompt: np.ndarray
    new_tokens: tuple[int, ...]
    finish_reason: str                      # length | eos | deadline | evicted
    ttft_s: float | None                    # submit → first token
    tpot_s: float | None                    # mean per-token after the first
    tokens_per_sec: float | None
    queue_s: float | None                   # submit → admission
    e2e_s: float | None                     # submit → finish wall time
    shared_prefix_blocks: int
    prefill_compiled: bool = False          # the prefill met a new bucket geometry

    @property
    def tokens(self) -> np.ndarray:
        """Full sequence (prompt + generated), the solo ``generate()`` row."""
        return np.concatenate([self.prompt, np.asarray(self.new_tokens, dtype=np.int32)])


class RequestHandle:
    """Caller's view of a submitted request."""

    def __init__(self, engine: "ServingEngine", req: Request):
        self._engine = engine
        self._req = req

    @property
    def rid(self) -> int:
        return self._req.rid

    @property
    def state(self) -> str:
        return self._req.state

    def done(self) -> bool:
        return self._req.state == "finished"

    def tokens_so_far(self) -> tuple[int, ...]:
        return tuple(self._req.generated)

    def result(self, *, drive: bool = True) -> RequestResult:
        """The structured result; with ``drive`` (default) steps the engine
        until this request finishes."""
        while drive and not self.done():
            if not self._engine.step() and not self.done():
                raise EngineStalledError(
                    f"engine stalled with request {self.rid} still {self._req.state}",
                    self._engine._state(),
                )
        if not self.done():
            raise RuntimeError(f"request {self.rid} is still {self._req.state}")
        return self._engine._result(self._req)


class ServingEngine:
    """Continuous-batching inference engine over a paged KV pool, on
    ``device`` (default: the card; raises without one unless
    ``device="cpu"``).  ``params`` must already live there."""

    def __init__(
        self,
        params,
        cfg,
        *,
        block_size: int = 16,
        num_blocks: int = 64,
        max_batch: int = 8,
        max_queue: int = 64,
        temperature: float = 0.0,
        eos_id: int | None = None,
        cache_dtype=None,
        prefix_sharing: bool = True,
        clock: Callable[[], float] | None = None,
        batch_buckets: Sequence[int] | None = None,
        block_buckets: Sequence[int] | None = None,
        prefill_buckets: Sequence[int] | None = None,
        attn: str = "auto",
        async_step: bool = True,
        prefill_chunk: int | None = None,
        speculative: spec_lane.SpecConfig | None = None,
        kv_dtype=None,
        lora: AdapterRegistry | None = None,
        quantized: bool = False,
        device="cuda",
        **deferred,
    ):
        steps = deferred.get("decode_steps")
        if speculative is not None and steps not in (None, 1):
            ok, why = spec_lane.multi_step_supported(speculative)
            if not ok:
                raise ValueError(
                    f"decode_steps={steps} with speculative= is unsupported: {why}")
        _reject_deferred("ServingEngine", deferred, _DEFERRED_ENGINE)
        if cfg.learned_pos_embedding:
            raise NotImplementedError(
                "ServingEngine: learned_pos_embedding configs are not ported yet")
        self.device = resolve_device(device)
        if params["wte"].device.type != self.device.type:
            raise ValueError(f"params live on {params['wte'].device}, "
                             f"the engine on {self.device}")
        self.params = params
        self.cfg = cfg
        self.quantized = bool(quantized)
        # multi-tenant LoRA: the registry's arenas are step arguments, read
        # anew every step, so register/evict land without touching the steps
        self._registry = lora
        if lora is not None:
            for dim in ("n_layer", "n_head", "n_query_groups", "head_size", "n_embd"):
                if getattr(lora.cfg, dim) != getattr(cfg, dim):
                    raise ValueError(f"lora registry was built for {dim}={getattr(lora.cfg, dim)} "
                                     f"but the engine serves {dim}={getattr(cfg, dim)}")
            if lora.device.type != self.device.type:
                raise ValueError(f"the lora registry lives on {lora.device}, the engine on "
                                 f"{self.device}")
        self.async_step = bool(async_step)
        if prefill_chunk is not None and not self.async_step:
            raise ValueError("prefill_chunk= requires async_step=True: the chunked prefill "
                             "lane lives in the async event loop")
        self.temperature = float(temperature)
        self.eos_id = eos_id
        self.prefix_sharing = bool(prefix_sharing)
        dtype = cache_dtype if cache_dtype is not None else params["wte"].dtype
        self.pool = PagedKVPool(cfg, num_blocks=num_blocks, block_size=block_size,
                                dtype=dtype, kv_dtype=kv_dtype, device=self.device)
        if attn not in ("auto", "paged", "gather"):
            raise ValueError(f"attn= must be 'auto', 'paged', or 'gather', got {attn!r}")
        ok, why = paged_supported(cfg, block_size=block_size, device=self.device)
        if attn == "paged" and not ok:
            raise ValueError(f"attn='paged' is unsupported here: {why}")
        self._attn_requested = attn
        # "auto" serves through the gather path where the paged one declines
        self.attn = "paged" if attn != "gather" and ok else "gather"
        self._attn_fallback_reason = None if attn == "gather" or ok else why
        self.attn_kernel_steps = 0
        # speculative serving: a draft arena beside the target arena, indexed
        # by the target pool's block tables (its own free list is unused)
        self.spec = speculative
        self.draft_pool = None
        if speculative is not None:
            spec_lane.validate_spec(speculative, cfg, device=self.device)
            # the draft arena may quantize apart from the target's
            # (SpecConfig.draft_kv_dtype; None inherits kv_dtype)
            self.draft_pool = PagedKVPool(
                speculative.draft_cfg, num_blocks=num_blocks, block_size=block_size,
                dtype=dtype, device=self.device,
                kv_dtype=(speculative.draft_kv_dtype
                          if speculative.draft_kv_dtype is not None else kv_dtype))
        self.scheduler = Scheduler(
            self.pool, max_batch=max_batch, max_queue=max_queue, clock=clock,
            batch_buckets=batch_buckets, block_buckets=block_buckets,
            prefill_buckets=prefill_buckets, sliding_window=cfg.sliding_window,
            prefill_chunk=prefill_chunk,
            # a round's draft loop writes up to K slots past the last
            # committed token: admission reserves them
            reserve_extra_tokens=speculative.K if speculative is not None else 0,
        )
        self._table_widths = self._table_width_buckets()
        # the chunk kind resolves once, apart from decode: the chunk writer
        # lands whole (L, ng, bs, hs) slabs, so the chunk width and every
        # prefill bucket must be multiples of the block size (the final
        # piece runs the ordinary prefill and may stay ragged)
        sch = self.scheduler
        if self.attn != "paged":
            chunk_why = self._attn_fallback_reason or "attn='gather' requested"
        elif speculative is not None:
            chunk_why = "speculative prefill writes the draft arena (gather chunk)"
        elif cfg.sliding_window is not None:
            chunk_why = "sliding-window keep-mask is decode-only"
        elif sch.prefill_chunk is not None and sch.prefill_chunk % block_size:
            chunk_why = (f"prefill_chunk={sch.prefill_chunk} not a multiple "
                         f"of block_size={block_size}")
        elif any(t % block_size for t in sch.prefill_buckets):
            chunk_why = (f"prefill_buckets={tuple(sch.prefill_buckets)} not "
                         f"all multiples of block_size={block_size}")
        else:
            chunk_why = None
        self.attn_chunk = "paged" if chunk_why is None else "gather"
        self._attn_chunk_fallback_reason = chunk_why
        # per-kind [kernel, fallback] step counts
        self._attn_steps = {"decode": [0, 0], "prefill_chunk": [0, 0]}
        self._prefix_index = PrefixIndex(self.pool.block_size)
        self._programs: dict[tuple, Callable] = {}
        self._rope: dict[tuple, tuple[torch.Tensor, torch.Tensor]] = {}
        self._closed = False
        self.decode_steps = 0
        self.prefill_runs = 0
        self.chunk_runs = 0
        self.step_calls = 0
        self.tokens_generated = 0
        self.host_visits = 0
        self._occupancy_sum = 0
        self.compile_counts = {"prefill": 0, "prefill_chunk": 0, "prefill_chunk_paged": 0,
                               "decode": 0, "decode_paged": 0, "spec_prefill": 0,
                               "spec_prefill_chunk": 0, "draft_decode": 0, "verify": 0,
                               "verify_paged": 0}
        # async lanes: the in-flight decode record plus prefill records,
        # harvested at the top of the next step (the only host block)
        self._inflight_decode: dict | None = None
        self._inflight_prefill: list[dict] = []
        self._stall_s_sum = 0.0
        self._overlap_frac_sum = 0.0
        self._overlap_obs = 0
        # chained decode inputs: while the batch and tables are unchanged,
        # each decode step consumes the previous step's device outputs
        self._decode_state: dict | None = None
        # the speculative lane's chained round inputs (toks=y, pos+n_emit)
        # and its acceptance accounting
        self._spec_state: dict | None = None
        self.spec_rounds = 0
        self.spec_draft_tokens = 0
        self.spec_accepted_tokens = 0
        self._spec_accept_hist = (np.zeros(speculative.K + 1, dtype=np.int64)
                                  if speculative is not None else None)
        reg = registry()
        self._m_steps_decode = reg.counter("serving.steps.decode")
        self._m_occupancy = reg.histogram("serving.batch_occupancy")
        self._m_tokens = reg.counter("serving.tokens")
        self._m_queue_depth = reg.gauge("serving.queue_depth")
        self._m_running = reg.gauge("serving.running")
        self._m_pool_util = reg.gauge("serving.pool.utilization")
        self._m_pool_free = reg.gauge("serving.pool.free_blocks")
        self._m_pool_low_water = reg.gauge("serving.pool.free_blocks_low_water")
        self._m_attn_kernel = reg.counter("serving.attn.kernel_steps")
        self._m_attn_fallback = reg.counter("serving.attn.fallback_steps")
        self._m_host_visits = reg.counter("serving.decode.host_visits")
        self._m_pool_occ = reg.gauge("serving.pool.occupancy_frac")
        if speculative is not None:
            self._m_spec_rounds = reg.counter("serving.spec.rounds")
            self._m_spec_accepted = reg.counter("serving.spec.accepted_tokens")
            self._m_spec_accept_len = reg.histogram("serving.spec.accept_len")
        if self.async_step:
            self._m_stall = reg.histogram("serving.decode.stall_s")
            self._m_overlap = reg.gauge("serving.step.overlap_frac")

    #
    # public API
    #

    def submit(self, prompt, *, max_new_tokens: int, deadline: float | None = None,
               generator: torch.Generator | None = None,
               stream_cb: Callable[[int], Any] | None = None, adapter_id: str | None = None,
               **deferred) -> RequestHandle:
        """Enqueues one request; returns immediately with a handle.

        ``deadline`` is seconds from now.  ``generator`` is the request's
        private sampling generator on the engine's device (default: a fresh
        one seeded 0, like ``generate``).  ``stream_cb`` receives each
        generated token id as soon as the host sees it.  ``adapter_id``
        routes the request through a LoRA adapter of the engine's ``lora=``
        registry, resolved to its slot here (an unknown id raises
        ``KeyError``).  Raises :class:`AdmissionError` when the wait queue
        is full or the request can never fit the pool."""
        if self._closed:
            raise RuntimeError("engine is shut down")
        _reject_deferred("submit", deferred, _DEFERRED_SUBMIT)
        adapter_slot = 0
        if adapter_id is not None:
            if self._registry is None:
                raise ValueError(f"adapter_id={adapter_id!r} requires an engine built with "
                                 f"lora=AdapterRegistry(...)")
            adapter_slot = self._registry.slot(adapter_id)
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        elif generator.device.type != self.device.type:
            raise ValueError(f"generator lives on {generator.device}, the engine on {self.device}")
        reg = registry()
        try:
            req = self.scheduler.submit(prompt, max_new_tokens, generator=generator,
                                        deadline_s=deadline, stream_cb=stream_cb,
                                        adapter_id=adapter_id, adapter_slot=adapter_slot)
        except AdmissionError:
            reg.counter("serving.requests.rejected").inc()
            raise
        reg.counter("serving.requests.submitted").inc()
        reg.gauge("serving.queue_depth").set(len(self.scheduler.queue))
        return RequestHandle(self, req)

    def step(self) -> bool:
        """One event-loop iteration; returns whether any work happened."""
        if self._closed:
            raise RuntimeError("engine is shut down")
        self.step_calls += 1
        with torch.no_grad():
            return self._step_async() if self.async_step else self._step_sync()

    def _step_sync(self) -> bool:
        """expire → admit + prefill → one blocking decode."""
        worked = False
        for req in self.scheduler.deadline_expired():
            self._finish(req, FINISH_DEADLINE)
            worked = True
        while self._try_admit():
            worked = True
        if self.scheduler.running:
            self._decode_once()
            worked = True
        self._update_gauges()
        return worked

    def _step_async(self) -> bool:
        """harvest step k-1 → expire → dispatch decode k → admit + prefill
        while the card computes."""
        worked = self._harvest()
        for req in self.scheduler.deadline_expired():
            self._finish(req, FINISH_DEADLINE)
            worked = True
        if self.scheduler.decode_ready():
            self._decode_once()
            worked = True
        while self._try_admit():
            worked = True
        if self._advance_prefills():
            worked = True
        self._update_gauges()
        return worked

    def _advance_prefills(self) -> bool:
        """The prefill lane: dispatches the next piece for every running
        request whose prompt is not yet resident and has no piece in flight
        — at most one piece per request per step, so chunks interleave 1:1
        with decode dispatches."""
        worked = False
        inflight = {rec["req"].rid for rec in self._inflight_prefill}
        for r in list(self.scheduler.running):
            if r.pos < r.prompt_len and r.rid not in inflight:
                self._inflight_prefill.append(self._prefill_dispatch(r))
                worked = True
        return worked

    def _harvest(self) -> bool:
        """Materializes every in-flight record (decode first: it was
        dispatched before the prefills)."""
        worked = False
        rec, self._inflight_decode = self._inflight_decode, None
        if rec is not None:
            self._decode_harvest(rec)
            worked = True
        pending, self._inflight_prefill = self._inflight_prefill, []
        for prec in pending:
            self._prefill_harvest(prec)
            worked = True
        if worked:
            self._sample_occupancy()
        return worked

    def run(self, requests: Sequence, *, max_new_tokens: int | None = None) -> list[RequestResult]:
        """Submits every request (a prompt, or a dict of :meth:`submit`
        kwargs), stepping through transient queue-full backpressure, and
        drives to completion."""
        handles = []
        for r in requests:
            kw = dict(r) if isinstance(r, dict) else {"prompt": r}
            if "max_new_tokens" not in kw:
                if max_new_tokens is None:
                    raise ValueError("max_new_tokens missing (argument or per-request)")
                kw["max_new_tokens"] = max_new_tokens
            prompt = kw.pop("prompt")
            while len(self.scheduler.queue) >= self.scheduler.max_queue:
                if not self.step():
                    raise AdmissionError(
                        f"wait queue full ({self.scheduler.max_queue}) and the "
                        "engine cannot make progress")
            handles.append(self.submit(prompt, **kw))
        self.drain()
        return [h.result(drive=False) for h in handles]

    def drain(self) -> None:
        """Steps until every submitted request has finished; raises
        :class:`EngineStalledError` when work remains but no step can
        progress."""
        while self.scheduler.queue or self.scheduler.running:
            if not self.step():
                raise EngineStalledError("engine stalled during drain", self._state())

    def evict(self, handle: RequestHandle) -> None:
        """Removes a queued/running request (finish reason ``"evicted"``)."""
        if not handle.done():
            self._finish(handle._req, FINISH_EVICTED)

    def shutdown(self, *, drain: bool = True) -> None:
        """Graceful stop: optionally drains, drops in-flight records,
        evicts whatever remains, and rejects further submits."""
        if self._closed:
            return
        if drain:
            self.drain()
        self._inflight_decode = None
        self._inflight_prefill = []
        self._decode_state = None
        self._spec_state = None
        for req in (*self.scheduler.running, *self.scheduler.queue):
            self._finish(req, FINISH_EVICTED)
        self._closed = True

    def __enter__(self) -> "ServingEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown(drain=exc == (None, None, None))

    def stats(self) -> dict:
        """Host-side engine statistics."""
        sch = self.scheduler
        n = self._overlap_obs
        # step kinds a bucket may instantiate: decode per batch bucket
        # (draft_decode and verify under speculative serving), prefill per
        # prefill bucket (and the chunk kind beside it when chunking is on)
        kinds = (len(sch.batch_buckets) * (2 if self.spec is not None else 1)
                 + len(sch.prefill_buckets) * (2 if sch.prefill_chunk is not None else 1))
        return {
            "device": str(self.device),
            "queue_depth": len(sch.queue),
            "running": len(sch.running),
            "pool_free_blocks": self.pool.num_free,
            "pool_free_blocks_low_water": self.pool.free_blocks_low_water,
            "pool_utilization": self.pool.utilization(),
            "arena_bytes": self.pool.arena_bytes(),
            "kv_dtype": str(self.pool.kv_dtype),
            "quantized": self.quantized,
            "async_step": self.async_step,
            "prefill_chunk": sch.prefill_chunk,
            "decode_steps": self.decode_steps,
            "host_visits": self.host_visits,
            "prefill_runs": self.prefill_runs,
            "chunk_runs": self.chunk_runs,
            "step_calls": self.step_calls,
            "tokens_generated": self.tokens_generated,
            "mean_batch_occupancy": (self._occupancy_sum / self.decode_steps
                                     if self.decode_steps else 0.0),
            "decode_stall_s_mean": (self._stall_s_sum / n) if n else None,
            "overlap_frac_mean": (self._overlap_frac_sum / n) if n else None,
            "compile_counts": dict(self.compile_counts),
            "attn": {
                "mode": self.attn,
                "requested": self._attn_requested,
                "kernel_steps": self.attn_kernel_steps,
                # decode and chunked prefill resolve apart: the chunk kernel
                # needs block-aligned widths and no sliding window
                "kinds": {
                    "decode": {
                        "mode": self.attn,
                        "fallback_reason": self._attn_fallback_reason,
                        "kernel_steps": self._attn_steps["decode"][0],
                        "fallback_steps": self._attn_steps["decode"][1],
                    },
                    "prefill_chunk": {
                        "mode": self.attn_chunk,
                        "fallback_reason": self._attn_chunk_fallback_reason,
                        "kernel_steps": self._attn_steps["prefill_chunk"][0],
                        "fallback_steps": self._attn_steps["prefill_chunk"][1],
                    },
                },
            },
            "bucket_bound": kinds * len(self._table_widths),
            "prefix_lookups": self._prefix_index.lookups,
            "prefix_hits": self._prefix_index.hits,
            "speculative": self._spec_stats() if self.spec is not None else None,
            "pool_occupancy": self.pool.occupancy_snapshot(),
            **({"lora": self._registry.state_snapshot()} if self._registry is not None else {}),
        }

    def _spec_stats(self) -> dict:
        """Acceptance accounting of the speculative lane: the histogram
        counts rounds by tokens emitted (1..K+1); acceptance_rate is
        accepted drafts over drafted tokens; tokens_per_round the mean
        emission."""
        hist = self._spec_accept_hist
        rounds = int(hist.sum())
        drafted = self.spec_draft_tokens
        return {
            "K": self.spec.K,
            "rounds": self.spec_rounds,
            "chained": self._spec_state is not None,
            "draft_tokens": drafted,
            "accepted_tokens": self.spec_accepted_tokens,
            "acceptance_rate": (self.spec_accepted_tokens / drafted) if drafted else None,
            "accept_len_hist": {i + 1: int(hist[i]) for i in range(len(hist))},
            "tokens_per_round": (sum((i + 1) * int(hist[i]) for i in range(len(hist))) / rounds
                                 if rounds else None),
        }

    def _state(self) -> dict:
        return {"engine": self.stats(), "scheduler": self.scheduler.state_snapshot(),
                "pool": self.pool.state_snapshot()}

    #
    # admission + prefill
    #

    def _table_width_buckets(self) -> tuple[int, ...]:
        """Every table width a step may use: the block buckets, shifted off
        any width whose dense capacity equals ``sliding_window`` (the ring
        layout the pool never uses), extended so a shared-prefix or
        chunked-prefill resume point plus prefill-bucket padding still
        rounds up into the set.  With chunking, prompts are capped only by
        the pool, but every piece is at most one chunk wide."""
        sch, bs = self.scheduler, self.pool.block_size
        W = self.cfg.sliding_window
        chunk = sch.prefill_chunk

        def dodge(b: int) -> int:
            return b + 1 if W is not None and self.pool.capacity_tokens(b) == W else b

        widths = {dodge(b) for b in sch.block_buckets}
        cap_tokens = self.pool.capacity_tokens(min(self.pool.num_usable, sch.block_buckets[-1]))
        max_prompt = cap_tokens if chunk is not None else min(sch.prefill_buckets[-1], cap_tokens)
        resumes = self.prefix_sharing or chunk is not None
        max_resume = ((max_prompt - 1) // bs) * bs if resumes else 0
        piece = chunk if chunk is not None else pick_bucket(max_prompt, sch.prefill_buckets)
        need = -(-(max_resume + piece) // bs)
        b = max(widths)
        while b < need:
            b *= 2
            widths.add(dodge(b))
        return tuple(sorted(widths))

    def _nbb(self, min_blocks: int) -> int:
        return pick_bucket(min_blocks, self._table_widths)

    def _try_admit(self) -> bool:
        sch = self.scheduler
        if not sch.queue:
            return False
        shared = self._find_shared_prefix(sch.queue[0])
        req = sch.next_admittable(shared_blocks=len(shared))
        if req is None:
            return False
        n_needed = sch.blocks_needed(req)
        table = self.pool.share(shared) + self.pool.alloc(n_needed - len(shared))
        sch.admit(req, table, len(shared))
        if self._registry is not None:
            req.adapter_version = self._registry.version(req.adapter_slot)
        self._prefill(req)
        return True

    def _factor_tag(self, req: Request):
        """What decides a request's K/V besides its tokens: the (slot,
        version) of its adapter's factors as they stand now, None without a
        registry."""
        if self._registry is None:
            return None
        return (req.adapter_slot, self._registry.version(req.adapter_slot))

    def _find_shared_prefix(self, req: Request) -> list[int]:
        """Longest block-aligned prompt prefix already resident in a live
        request's blocks whose K/V were computed with this request's
        adapter factors."""
        if not self.prefix_sharing:
            return []
        return self._prefix_index.find(req.prompt, self._prefix_alive, tag=self._factor_tag(req))

    def _prefix_alive(self, hit: tuple[int, tuple[int, ...]]) -> bool:
        """A registered prefix is shareable only while its owner is running
        and every snapshot block id is still its live table entry."""
        rid, blocks = hit
        owner = next((r for r in self.scheduler.running if r.rid == rid), None)
        if owner is None or len(owner.block_table) < len(blocks):
            return False
        return all(t == b != SINK_BLOCK for t, b in zip(owner.block_table, blocks))

    def _register_prefix(self, req: Request, upto: int | None = None) -> None:
        """Registers ``req``'s written prefixes under its factor tag; not at
        all once its adapter's slot was written after admission (its K/V
        then mix two sets of factors)."""
        if not self.prefix_sharing:
            return
        tag = self._factor_tag(req)
        if tag is not None and tag[1] != req.adapter_version:
            return
        self._prefix_index.register(req.rid, req.prompt, req.block_table, self._prefix_alive,
                                    upto=upto, tag=tag)

    def _unregister_prefix(self, req: Request) -> None:
        self._prefix_index.unregister(req.rid)

    def _prefill(self, req: Request) -> None:
        rec = self._prefill_dispatch(req)
        if self.async_step:
            self._inflight_prefill.append(rec)
        else:
            self._prefill_harvest(rec)
            self._sample_occupancy()

    def _chunk_kind(self) -> str:
        """The chunk step kind of this engine, resolved at construction."""
        return "prefill_chunk_paged" if self.attn_chunk == "paged" else "prefill_chunk"

    def _prefill_dispatch(self, req: Request) -> dict:
        """Dispatches the next prefill piece of ``req`` past its resume
        point and returns the in-flight record.  A piece is the final
        ``prefill`` (samples token 0, which stays on the device until the
        harvest) or an intermediate chunk of ``prefill_chunk`` tokens (K/V
        only, no draw, so the final draw is the unchunked prefill's)."""
        sch, bs = self.scheduler, self.pool.block_size
        pos = req.pos                                      # block-aligned resume point
        remainder = req.prompt_len - pos
        chunk = sch.prefill_chunk
        final = chunk is None or remainder <= chunk
        n_real = remainder if final else chunk
        first = pos == req.n_shared_blocks * bs            # the admission piece
        Tb = sch.prefill_bucket(n_real)
        nbb = self._nbb(max(len(req.block_table), -(-(pos + Tb) // bs)))
        toks = np.zeros(Tb, dtype=np.int32)
        toks[:n_real] = req.prompt[pos:pos + n_real]
        # gather the whole table; write back only this piece's block range
        table, dest = chunk_tables(req.block_table, pos, Tb, nbb, bs)
        if self.spec is not None:
            kind = "spec_prefill" if final else "spec_prefill_chunk"
        else:
            kind = "prefill" if final else self._chunk_kind()
        prog, new = self._program(kind, Tb, nbb)
        req.prefill_compiled = req.prefill_compiled or new
        slots = req.adapter_slot if self._registry is not None else None
        if final:
            tok, qerr = prog(toks, pos, n_real, table, dest, req.generator, slots)
            rec = {"kind": "prefill", "req": req, "tok": tok, "qerr": qerr}
        else:
            rec = {"kind": "chunk", "req": req, "qerr": prog(toks, pos, table, dest, slots)}
        req.pos = pos + n_real                             # written (stream-ordered)
        self._register_prefix(req, upto=req.pos)
        reg = registry()
        if final:
            self.prefill_runs += 1
            reg.counter("serving.steps.prefill").inc()
        else:
            self.chunk_runs += 1
            reg.counter("serving.steps.prefill_chunk").inc()
            if self.spec is None:
                st = self._attn_steps["prefill_chunk"]
                if self.attn_chunk == "paged":
                    st[0] += 1
                else:
                    st[1] += 1
                    if self._attn_requested != "gather":
                        self._m_attn_fallback.inc()
        if first and req.n_shared_blocks:
            reg.counter("serving.prefix.shared_blocks").inc(req.n_shared_blocks)
        return rec

    def _prefill_harvest(self, rec: dict) -> None:
        """Delivers token 0 (TTFT stamps here: token availability); an
        intermediate chunk delivers nothing.  A quantized pool's piece sets
        the ``serving.kv_quant.rel_err`` gauge to the quantization error it
        measured over the blocks it wrote."""
        if rec["kind"] == "chunk":
            self._note_qerr(rec)
            return
        req = rec["req"]
        tok0 = int(rec["tok"][0])                          # blocks until the device delivers
        if req.state != "running":                         # finished while in flight
            return
        req.first_token_t = self.scheduler.clock()
        self.tokens_generated += 1
        self._m_tokens.inc()
        self._note_qerr(rec)
        self._emit_token(req, tok0)

    def _note_qerr(self, rec: dict) -> None:
        if self.pool.quantized_kv:
            registry().gauge("serving.kv_quant.rel_err").set(float(rec["qerr"]))

    def _sample_occupancy(self) -> None:
        self.pool.sample_occupancy()
        self._m_pool_occ.set(self.pool.utilization())

    #
    # decode
    #

    def _decode_once(self) -> None:
        rec = (spec_lane.spec_decode_dispatch(self) if self.spec is not None
               else self._decode_dispatch())
        if self.async_step:
            self._inflight_decode = rec
        else:
            self._decode_harvest(rec)
            self._sample_occupancy()

    def _decode_dispatch(self) -> dict:
        sch, dev = self.scheduler, self.device
        running = sch.decode_ready() if self.async_step else list(sch.running)
        Bb, nbb_raw = sch.decode_bucket(running)
        nbb = self._nbb(nbb_raw)
        sig = (tuple(r.rid for r in running), Bb, nbb)
        st = self._decode_state
        if st is not None and st["sig"] == sig:
            # steady state: this step's inputs are the previous step's
            # device outputs plus the cached tables — no host→device copy
            toks_d, pos_d, tables_d = st["toks"], st["pos"], st["tables"]
            slots_d = st["slots"]
            host_pos = st["host_pos"] + 1
        else:
            toks = np.zeros(Bb, dtype=np.int32)
            host_pos = np.zeros(Bb, dtype=np.int32)
            tables = np.full((Bb, nbb), SINK_BLOCK, dtype=np.int32)
            for i, r in enumerate(running):
                toks[i] = r.generated[-1]
                host_pos[i] = r.prompt_len + len(r.generated) - 1   # slot this step writes
                tables[i, : len(r.block_table)] = r.block_table
            toks_d = torch.as_tensor(toks, device=dev)
            pos_d = torch.as_tensor(host_pos, device=dev)
            tables_d = torch.as_tensor(tables, device=dev)
            slots_d = self._slots(running, Bb)
        kind = "decode_paged" if self.attn == "paged" else "decode"
        decode, _ = self._program(kind, Bb, nbb)
        if self.attn == "paged":
            self.attn_kernel_steps += 1
            self._attn_steps["decode"][0] += 1
            self._m_attn_kernel.inc()
        nxt = decode(toks_d, pos_d, tables_d, [r.generator for r in running], slots_d)
        self._decode_state = {"sig": sig, "toks": nxt, "pos": pos_d + 1,
                              "tables": tables_d, "slots": slots_d, "host_pos": host_pos}
        self.decode_steps += 1
        self._occupancy_sum += len(running)
        self._m_steps_decode.inc()
        self._m_occupancy.observe(len(running))
        return {"running": running, "nxt": nxt, "pos": host_pos,
                "t_disp": time.perf_counter()}

    def _note_stall(self, t0: float, t_disp: float) -> None:
        """Overlap accounting of one harvest that started at ``t0`` for a
        dispatch at ``t_disp``: host work since the dispatch against the
        residual wait."""
        if not self.async_step:
            return
        stall = time.perf_counter() - t0
        overlapped = t0 - t_disp
        frac = overlapped / (overlapped + stall) if (overlapped + stall) > 0 else 0.0
        self._stall_s_sum += stall
        self._overlap_frac_sum += frac
        self._overlap_obs += 1
        self._m_stall.observe(stall)
        self._m_overlap.set(frac)

    def _decode_harvest(self, rec: dict) -> None:
        if rec.get("spec"):
            spec_lane.spec_decode_harvest(self, rec)
            return
        sch = self.scheduler
        t0 = time.perf_counter()
        nxt = rec["nxt"].tolist()                          # the host block
        self._note_stall(t0, rec["t_disp"])
        emitted = 0
        invalidate = False
        for i, r in enumerate(rec["running"]):
            if r.state != "running":
                invalidate = True                          # finished mid-flight
                continue
            r.pos = int(rec["pos"][i]) + 1
            if sch.expire_window_blocks(r):
                # its registered prefixes start at the just-sunk blocks, and
                # the cached device tables are stale
                invalidate = True
                self._unregister_prefix(r)
            emitted += 1
            self._emit_token(r, int(nxt[i]))
            if r.state != "running":
                invalidate = True
        self.tokens_generated += emitted
        self.host_visits += 1
        self._m_host_visits.inc()
        if emitted:
            self._m_tokens.inc(emitted)
        if invalidate:
            self._decode_state = None

    #
    # finishing / results
    #

    def _emit_token(self, req: Request, tok: int) -> None:
        req.generated.append(tok)
        if req.stream_cb is not None:
            req.stream_cb(tok)
        if self.eos_id is not None and tok == self.eos_id:
            self._finish(req, FINISH_EOS)
        elif len(req.generated) >= req.max_new_tokens:
            self._finish(req, FINISH_LENGTH)

    def _finish(self, req: Request, reason: str) -> None:
        self._unregister_prefix(req)                       # before blocks free
        self.scheduler.finish(req, reason)
        reg = registry()
        reg.counter("serving.requests.completed").inc()
        reg.counter(f"serving.finish.{reason}").inc()
        res = self._result(req)
        if res.ttft_s is not None:
            reg.histogram("serving.ttft_s").observe(res.ttft_s)
        if res.tpot_s is not None:
            reg.histogram("serving.tpot_s").observe(res.tpot_s)
        if res.tokens_per_sec is not None:
            reg.histogram("serving.tokens_per_sec").observe(res.tokens_per_sec)
        if req.adapter_id is not None:
            # per-tenant accounting: which adapter consumed the tokens and
            # what latency its requests saw
            reg.counter(f"serving.tenant.{req.adapter_id}.tokens").inc(len(req.generated))
            reg.counter(f"serving.tenant.{req.adapter_id}.requests").inc()
            if res.ttft_s is not None:
                reg.histogram(f"serving.tenant.{req.adapter_id}.ttft_s").observe(res.ttft_s)
            if res.e2e_s is not None:
                reg.histogram(f"serving.tenant.{req.adapter_id}.e2e_s").observe(res.e2e_s)

    def _result(self, req: Request) -> RequestResult:
        n = len(req.generated)
        ttft = (req.first_token_t - req.submit_t) if req.first_token_t is not None else None
        tpot = tps = None
        if req.first_token_t is not None and req.finish_t is not None and n > 1:
            tpot = max(req.finish_t - req.first_token_t, 0.0) / (n - 1)
        if req.finish_t is not None and n and (req.finish_t - req.submit_t) > 0:
            tps = n / (req.finish_t - req.submit_t)
        return RequestResult(
            rid=req.rid,
            prompt=req.prompt,
            new_tokens=tuple(req.generated),
            finish_reason=req.finish_reason or "?",
            ttft_s=ttft,
            tpot_s=tpot,
            tokens_per_sec=tps,
            queue_s=(req.admit_t - req.submit_t) if req.admit_t is not None else None,
            e2e_s=(req.finish_t - req.submit_t) if req.finish_t is not None else None,
            shared_prefix_blocks=req.n_shared_blocks,
            prefill_compiled=req.prefill_compiled,
        )

    def _update_gauges(self) -> None:
        self._m_queue_depth.set(len(self.scheduler.queue))
        self._m_running.set(len(self.scheduler.running))
        self._m_pool_util.set(self.pool.utilization())
        self._m_pool_free.set(self.pool.num_free)
        self._m_pool_low_water.set(self.pool.free_blocks_low_water)

    #
    # bucket-geometry steps
    #

    def _program(self, kind: str, a: int, b: int) -> tuple[Callable, bool]:
        """The step function for bucket geometry ``(kind, a, b)`` and
        whether this lookup met the geometry for the first time."""
        key = (kind, a, b)
        prog = self._programs.get(key)
        if prog is not None:
            return prog, False
        build = {"prefill": self._build_prefill,
                 "prefill_chunk": self._build_prefill_chunk,
                 "prefill_chunk_paged": self._build_prefill_chunk_paged,
                 "decode": self._build_decode,
                 "decode_paged": self._build_decode_paged,
                 "spec_prefill": partial(spec_lane.build_spec_prefill, self),
                 "spec_prefill_chunk": partial(spec_lane.build_spec_prefill_chunk, self),
                 "draft_decode": partial(spec_lane.build_draft_decode, self),
                 "verify": partial(spec_lane.build_verify, self),
                 "verify_paged": partial(spec_lane.build_verify_paged, self)}[kind]
        prog = build(a, b)
        self.compile_counts[kind] += 1
        registry().counter(f"serving.geometries.{kind}").inc()
        self._programs[key] = prog
        return prog, True

    def _rope_cache(self, nbb: int, *, draft: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
        """Rope rows of the target (or the draft) model for a table of
        ``nbb`` blocks."""
        cap = self.pool.capacity_tokens(nbb)
        if (draft, cap) not in self._rope:
            cfg = self.spec.draft_cfg if draft else self.cfg
            self._rope[draft, cap] = build_rope_cache(cfg, cap, device=self.device)
        return self._rope[draft, cap]

    def _slots(self, reqs, Bb: int) -> torch.Tensor | None:
        """(Bb,) adapter slots of ``reqs`` on the device; padding rows ride
        the base slot.  None without a registry: no copy to the device."""
        if self._registry is None:
            return None
        slots = np.zeros(Bb, dtype=np.int32)
        slots[:len(reqs)] = [r.adapter_slot for r in reqs]
        return torch.as_tensor(slots, device=self.device)

    def _lora_kwargs(self, slots) -> dict:
        """The LoRA forward kwargs of a step's rows and the registry's
        scaling; none without a registry.  ``slots``: one request's slot
        (an int: a prefill piece), whose factors are then views of the
        arenas; or a batch's (Bb,) device slots, passed with the arenas
        (``lora_slots``), which every delta reads by slot.  Nothing is
        copied here."""
        reg = self._registry
        if reg is None:
            return {}
        if isinstance(slots, int):
            lora = {t: {k: v[slots:slots + 1] for k, v in ab.items()}
                    for t, ab in reg.arenas.items()}
            return {"lora": lora, "lora_scaling": reg.scaling}
        return {"lora": reg.arenas, "lora_scaling": reg.scaling, "lora_slots": slots}

    def _fwd_kwargs(self, slots) -> dict:
        """The forward kwargs a step adds to the base call (reference
        ``engine.py:2648 _fwd_kwargs``): weight quantization and the rows'
        LoRA factors."""
        return {"quantized": self.quantized, **self._lora_kwargs(slots)}

    def _sample_rows(self, logits, generators) -> torch.Tensor:
        """One token per batch row; each live row draws from its own
        generator exactly as a solo B=1 call would; padding rows get 0."""
        if self.temperature == 0.0:
            return sample_token(logits, 0.0)
        rows = [sample_token(logits[i:i + 1], self.temperature, g)
                for i, g in enumerate(generators)]
        pad = logits.shape[0] - len(rows)
        if pad:
            rows.append(torch.zeros(pad, dtype=torch.int32, device=logits.device))
        return torch.cat(rows)

    def _build_prefill(self, Tb: int, nbb: int) -> Callable:
        """The final prefill piece over the gathered arena: returns token 0
        and the piece's quantization error."""
        cfg, pool, dev = self.cfg, self.pool, self.device
        cos_all, sin_all = self._rope_cache(nbb)

        def prefill(toks, pos, n_real, table, dest, generator, slots):
            t = torch.as_tensor(table, device=dev)[None]
            logits, cache = forward_with_cache(
                self.params, torch.as_tensor(toks, device=dev)[None], pos,
                pool.gather(t), cos_all, sin_all, cfg, **self._fwd_kwargs(slots))
            tok = sample_token(logits[:, n_real - 1], self.temperature, generator)  # (1,)
            return tok, pool.scatter_dense(cache, torch.as_tensor(dest, device=dev))

        return prefill

    def _build_prefill_chunk(self, Tb: int, nbb: int) -> Callable:
        """An intermediate chunked-prefill piece on the gathered arena: the
        chunk's K/V written back, nothing sampled; returns the piece's
        quantization error."""
        cfg, pool, dev = self.cfg, self.pool, self.device
        cos_all, sin_all = self._rope_cache(nbb)

        def prefill_chunk(toks, pos, table, dest, slots):
            t = torch.as_tensor(table, device=dev)[None]
            _, cache = forward_with_cache(
                self.params, torch.as_tensor(toks, device=dev)[None], pos,
                pool.gather(t), cos_all, sin_all, cfg, **self._fwd_kwargs(slots))
            return pool.scatter_dense(cache, torch.as_tensor(dest, device=dev))

        return prefill_chunk

    def _build_prefill_chunk_paged(self, Tb: int, nbb: int) -> Callable:
        """The kernel twin of :meth:`_build_prefill_chunk`: the chunk's
        attention runs ``paged_attn_verify`` at T = the chunk width straight
        off the arena (earlier chunks and any shared prefix read in block
        granules, the causal intra-chunk mask in the kernel), and the fresh
        K/V land block by block through ``paged_chunk_write`` (the fused
        quantizing ``paged_chunk_write_fused`` on a quantized pool); no
        dense cache and no logits materialize."""
        cfg, pool, dev = self.cfg, self.pool, self.device
        cos_all, sin_all = self._rope_cache(nbb)

        def prefill_chunk_paged(toks, pos, table, dest, slots):
            pv = torch.tensor([pos], dtype=torch.int32, device=dev)
            _, fresh = forward_paged(
                self.params, torch.as_tensor(toks, device=dev)[None], pv, pool.arenas,
                torch.as_tensor(table, device=dev)[None], cos_all, sin_all, cfg,
                cdtype=pool.dtype, head=False, **self._fwd_kwargs(slots))
            _, qerr = write_fresh_kv_chunk(pool.arenas, fresh, torch.as_tensor(dest, device=dev),
                                           pv, block_size=pool.block_size,
                                           kv_dtype=pool.quantized_storage)
            return qerr

        return prefill_chunk_paged

    def _build_decode(self, Bb: int, nbb: int) -> Callable:
        """Gather decode: the rows' blocks gathered dense, the dense
        forward, then the fresh K/V scattered back."""
        cfg, pool, bs = self.cfg, self.pool, self.pool.block_size
        cos_all, sin_all = self._rope_cache(nbb)
        rows = torch.arange(Bb, device=self.device)

        def decode(toks, pos, tables, generators, slots):
            p = pos.long()
            col = torch.clamp(p // bs, max=tables.shape[1] - 1)
            dest_block = tables.long().gather(1, col[:, None])[:, 0]
            logits, cache = forward_with_cache(
                self.params, toks[:, None], pos, pool.gather(tables), cos_all, sin_all,
                cfg, **self._fwd_kwargs(slots))
            nxt = self._sample_rows(logits[:, 0], generators)
            pool.scatter_rows(cache, p, rows, dest_block, p % bs)
            return nxt

        return decode

    def _build_decode_paged(self, Bb: int, nbb: int) -> Callable:
        """Paged decode: attention straight off the arenas through the
        ``paged_attn_decode`` kernel, the fresh K/V landed in place by
        ``paged_token_write`` (``paged_token_write_fused`` on a quantized
        pool); no dense cache ever materializes."""
        cfg, pool = self.cfg, self.pool
        cos_all, sin_all = self._rope_cache(nbb)

        def decode_paged(toks, pos, tables, generators, slots):
            logits, fresh = forward_paged(self.params, toks[:, None], pos, pool.arenas, tables,
                                          cos_all, sin_all, cfg, cdtype=pool.dtype,
                                          **self._fwd_kwargs(slots))
            nxt = self._sample_rows(logits[:, 0], generators)
            write_fresh_kv(pool.arenas, fresh, tables, pos, block_size=pool.block_size,
                           kv_dtype=pool.quantized_storage)
            return nxt

        return decode_paged


def serve(model_fn, params, cfg, *, device="cuda", **kwargs) -> ServingEngine:
    """Builds a :class:`ServingEngine` on ``device`` (default: the card;
    raises without one unless ``device="cpu"``).  ``model_fn`` must be
    ``None`` (the in-tree model step); replicated and mesh serving belong to
    later slices of the port and raise ``NotImplementedError``."""
    _reject_deferred("serve", {"model_fn": model_fn}, _DEFERRED_ENGINE)
    return ServingEngine(params, cfg, device=device, **kwargs)
