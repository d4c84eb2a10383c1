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
- multi-step decode (``decode_steps=N``): N decode iterations per host
  visit with the reference's liveness rule (``stop = prompt_len +
  max_new_tokens - 2``; a row dies on ``pos >= stop`` or an EOS token, then
  sends its K/V write to the sink block, freezes ``pos`` and ``toks`` and
  draws nothing more; padding rows enter with ``stop = -1``).  The harvest
  reads the visit's (N, Bb) tokens and liveness once;
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
  dequantize on gather and quantize on scatter; the paged steps run the
  same kernels as above with the dequant inside the attention kernels and
  the fused quantizing writers.  Every prefill and chunk piece measures its
  quantization error into the ``serving.kv_quant.rel_err`` gauge;
- the scheduler (:mod:`serving.scheduler`) owns admission, FIFO order,
  deadlines and the bucket sets.  Batch, block and prefill buckets stay as
  in the JAX package, so each step runs at one of a bounded set of bucket
  geometries (``stats()["bucket_bound"]``);
- weight quantization (``quantized=True``): every forward of every lane
  runs its weight matmuls through ``quantex.int8_linear``;
- MoE configs (``LLaMAMoE``) serve on every lane through the dense expert
  MLP with its float32 router;
- multi-tenant LoRA (``lora=AdapterRegistry(...)``, :mod:`serving.lora`):
  ``submit(..., adapter_id=...)`` routes a request through a registered
  adapter; every step reads the rows' factors by slot from the registry's
  arenas, which ``register``/``evict`` write in place.  Requests of
  different adapters never share a prompt prefix;
- greedy and temperature sampling; each request draws from its own
  ``torch.Generator`` — one draw at the prefill and one per emitted decode
  token, like a solo ``generate()`` — so its tokens do not depend on what
  else shares the batch.

Bucket steps on the card (:mod:`serving.graphs`): every decode kind
(``decode``, ``decode_paged``, ``decode_multi``, ``decode_multi_paged``),
the paged chunk piece (``prefill_chunk_paged``) and the speculative round
(``draft_decode``, ``verify``, ``verify_paged``) run eagerly at a bucket's
first call, which is then captured once as a CUDA graph into the engine's
memory pool; every later step of that bucket is one replay.  Greedy steps
take the argmax inside the graph; at temperature > 0 a graph ends at a
static logits buffer and each row draws eagerly from its own generator.  A
capture that fails raises with the kind and the bucket.  The final prefill
piece (a table of ragged length, once per request), the gather-lane
prefills (``prefill``, ``prefill_chunk``, ``spec_prefill``,
``spec_prefill_chunk``) stay eager.  A graph holds the addresses of this
engine's parameters and arenas, so graphs are per engine: the reference's
module-wide program cache has no counterpart.  ``compile_counts`` counts
the geometries met (on the card, a step kind's captures; eager kinds
compile nothing).  The CPU runs the same step functions eagerly.

The drive loop is threadless with two lanes (``async_step=True``, the
default): a step harvests the tokens of the decode dispatched by the
previous step (the one host block), expires deadlines, dispatches decode
for the current batch — on the card, kernels are queued and the host goes
on — and admits and prefills new requests while the card computes.
``async_step=False`` runs admit → prefill → one blocking decode.  Served
tokens are the same either way.

Fault tolerance (:mod:`serving.faults`): ``fault_plan=`` injects faults at
the named points (``prefill.dispatch``, ``decode.dispatch``,
``draft.dispatch``, ``verify.dispatch``, ``harvest``, ``scatter``); a
classified step exception is absorbed — a poison request is quarantined
(``finish_reason="error"``), a transient fault retries with backoff
(``retry=RetryPolicy(...)``), and engine-class faults (OOM, hangs caught by
``watchdog_timeout_s=``, retry exhaustion) run :meth:`ServingEngine.recover`:
the arenas are zeroed in place (captured graphs keep their addresses) and
every running request replays its prompt and emitted tokens through the
chunk steps.  Each request's generator state is saved at harvest and
restored by the recovery, so the next draws are the unfaulted run's.

Observability (all off by default): ``trace=`` per-request async spans,
``slo=`` burn rates (``slo_report()``), ``flight_recorder=`` a crash dump
on any ``step()`` exception, ``goodput=`` the ledger of dispatched slots
(``goodput_report()``), ``telemetry=`` one JSON line per finished request.

Stateful serving (all off by default, host policy over the same steps):
``sessions=`` parks a finished turn's block-aligned prefix so the
session's next turn re-attaches it through the shared-prefix admission
(:mod:`serving.sessions`); ``priorities=`` orders the queue by class,
defers classes at admission on SLO burn and preempts a less urgent running
request for a more urgent head, which resumes later through the chunk
steps (:mod:`serving.priority`); ``constraints=True`` lets ``submit(...,
constraint=)`` mask every draw of a request through its host automaton
(:mod:`serving.constrain`), the mask being one more step input (``cmask``)
that a graphed step copies into its buffer like ``toks``.  ``model_fn=``
replaces ``forward_with_cache`` on the gather lanes (the paged kernels
mirror the in-tree forward, so ``attn="auto"`` resolves gather).
Learned-position configs (GPT-2) serve with their bucket sets capped at
``cfg.block_size`` and without prefix sharing or chunked prefill.
``serve(..., replicas=N)`` returns the replica router
(:mod:`serving.router`).

Engine options of the JAX package that belong to later slices of the port
(``mesh=``, ``shardings=``, ``replica_id=``; ``key=`` at submit, which the
port takes as ``generator=``) raise ``NotImplementedError`` naming the
option.
"""
from __future__ import annotations

import dataclasses
import time
import weakref
from dataclasses import dataclass
from functools import partial
from typing import Any, Callable, Sequence

import numpy as np
import torch

from thunder_tpu_torch._device import resolve_device
from thunder_tpu_torch.models.generate import forward_with_cache, sample_token
from thunder_tpu_torch.models.llama import build_rope_cache
from thunder_tpu_torch.observability.flight import FlightRecorder, flight_recorder_env_enabled
from thunder_tpu_torch.observability.goodput import resolve_goodput
from thunder_tpu_torch.observability.metrics import registry
from thunder_tpu_torch.observability.slo import resolve_slo
from thunder_tpu_torch.observability.tracing import RequestTracer, serving_trace_env_enabled
from thunder_tpu_torch.serving import speculative as spec_lane
from thunder_tpu_torch.serving.faults import (
    CLASS_REQUEST,
    CLASS_TRANSIENT,
    FP_DECODE,
    FP_HARVEST,
    FP_PREFILL,
    FP_SCATTER,
    RecoveryError,
    RetryPolicy,
    WatchdogTimeout,
    classify_fault,
    fault_cause,
    resolve_fault_plan,
)
from thunder_tpu_torch.serving.graphs import StepGraph, run_eager
from thunder_tpu_torch.serving.kv_pool import (
    SINK_BLOCK,
    PagedKVPool,
    PrefixIndex,
    chunk_tables,
)
from thunder_tpu_torch.serving.lora import AdapterRegistry
from thunder_tpu_torch.serving.paged_attention import (
    forward_paged,
    paged_supported,
    write_fresh_kv,
    write_fresh_kv_chunk,
    write_fresh_kv_live,
)
from thunder_tpu_torch.serving.priority import priority_level, resolve_priorities
from thunder_tpu_torch.serving.scheduler import (
    FINISH_DEADLINE,
    FINISH_EOS,
    FINISH_ERROR,
    FINISH_EVICTED,
    FINISH_LENGTH,
    AdmissionError,
    Request,
    Scheduler,
    pick_bucket,
)
from thunder_tpu_torch.serving.sessions import resolve_sessions

__all__ = [
    "serve",
    "ServingEngine",
    "RequestHandle",
    "RequestResult",
    "AdmissionError",
    "EngineStalledError",
    "RecoveryError",
]

# engine options of the JAX package not ported yet, with their "off" values:
# the mesh engine (ROADMAP.md Queue 1 item 10's mesh bullet); ``key`` the
# port takes as ``generator=``
_DEFERRED_ENGINE = {"mesh": None, "shardings": None, "replica_id": None}
_DEFERRED_SUBMIT = {"key": None}

# step kinds written as ``fn(x, host) -> (out, carry)`` (serving.graphs):
# captured as CUDA graphs on the card, run eagerly on the CPU
GRAPH_KINDS = ("decode", "decode_paged", "decode_multi", "decode_multi_paged",
               "prefill_chunk_paged", "draft_decode", "verify", "verify_paged")


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
    queued/running but ``step()`` did no work.  Carries the flight-recorder
    state snapshot (scheduler rows, pool counts) as ``.state``.  Under the
    replica router ``replica`` names the stalled lane, whose flight state
    it carries."""

    def __init__(self, msg: str, state: dict | None = None, *, replica: int | None = None):
        self.replica = replica
        if replica is not None:
            msg = f"replica {replica}: {msg}"
        self.state = state or {}
        sched = self.state.get("scheduler", {})
        pool = self.state.get("pool", {})
        rows = sched.get("requests", [])
        detail = (f" [queued rids={[r['rid'] for r in rows if r.get('state') == 'queued']} "
                  f"running rids={[r['rid'] for r in rows if r.get('state') == 'running']} "
                  f"pool free={pool.get('num_free')}/{pool.get('num_blocks')} "
                  f"leased={pool.get('leased_blocks')}]" if pool else "")
        super().__init__(msg + detail)


@dataclass(frozen=True)
class RequestResult:
    """Structured outcome of one served request."""

    rid: int
    prompt: np.ndarray
    new_tokens: tuple[int, ...]
    finish_reason: str                      # length | eos | deadline | evicted | error
    ttft_s: float | None                    # submit → first token
    tpot_s: float | None                    # mean per-token after the first
    tokens_per_sec: float | None
    queue_s: float | None                   # submit → admission
    e2e_s: float | None                     # submit → finish wall time
    shared_prefix_blocks: int
    prefill_compiled: bool = False          # the prefill met a new bucket geometry
    error: dict | None = None               # structured cause when quarantined
    tokens_recomputed: int = 0              # prompt positions re-dispatched by replay
    recompute_causes: tuple = ()            # why (goodput waste-cause names)

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
                    self._engine._flight_state(),
                )
        if not self.done():
            raise RuntimeError(f"request {self.rid} is still {self._req.state}")
        return self._engine._result(self._req)


class ServingEngine:
    """Continuous-batching inference engine over a paged KV pool, on
    ``device`` (default: the card; raises without one unless
    ``device="cpu"``).  ``params`` must already live there.  ``model_fn``:
    the model step of the gather lanes, with ``forward_with_cache``'s
    signature (None: ``forward_with_cache``)."""

    def __init__(
        self,
        params,
        cfg,
        *,
        model_fn: Callable | None = None,
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
        decode_steps: int = 1,
        fault_plan=None,
        retry: RetryPolicy | None = None,
        watchdog_timeout_s: float | None = None,
        telemetry=None,
        trace: bool | None = None,
        slo=None,
        flight_recorder=None,
        goodput=None,
        sessions=None,
        priorities=None,
        constraints=None,
        device="cuda",
        _graphs: bool = True,
        **deferred,
    ):
        self.n_decode_steps = int(decode_steps)
        if self.n_decode_steps < 1:
            raise ValueError(f"decode_steps= must be >= 1, got {decode_steps}")
        if speculative is not None and self.n_decode_steps > 1:
            ok, why = spec_lane.multi_step_supported(speculative)
            if not ok:
                raise ValueError(f"decode_steps={self.n_decode_steps} with speculative= is "
                                 f"unsupported: {why}")
        _reject_deferred("ServingEngine", deferred, _DEFERRED_ENGINE)
        self.device = resolve_device(device)
        if params["wte"].device.type != self.device.type:
            raise ValueError(f"params live on {params['wte'].device}, "
                             f"the engine on {self.device}")
        self.params = params
        self.cfg = cfg
        self._forward = model_fn if model_fn is not None else forward_with_cache
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
        ok, why = paged_supported(cfg, block_size=block_size, device=self.device,
                                  custom_forward=model_fn is not None)
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
            spec_lane.validate_spec(speculative, cfg, device=self.device,
                                    custom_forward=model_fn is not None)
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
            # committed token, a multi-step visit up to N-1: admission
            # reserves them
            reserve_extra_tokens=(speculative.K if speculative is not None
                                  else self.n_decode_steps - 1),
            decode_horizon=self.n_decode_steps,
        )
        cfgs = [cfg] + ([speculative.draft_cfg] if speculative is not None else [])
        learned = [c.block_size for c in cfgs if c.learned_pos_embedding]
        if learned:
            self._cap_learned_positions(min(learned))
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
        # stateful serving: the resident-session table (parked prefix
        # blocks), the priority gate (admission and preemption) and the
        # constraint knob, which adds one mask input to the sampling steps
        self._sessions = resolve_sessions(sessions, self.pool, self._prefix_index)
        if self._sessions is not None and not self.prefix_sharing:
            raise ValueError("sessions= requires prefix_sharing: session re-attach rides the "
                             "shared-prefix admission path")
        self._priorities = resolve_priorities(priorities)
        self._constraints = bool(constraints)
        if self._constraints and speculative is not None:
            raise ValueError("constraints= with speculative= is unsupported: the verify lane has "
                             "no mask input (use the plain decode lane)")
        # logit width every constraint mask must match
        self._vocab = int(cfg.padded_vocab_size)
        self._mask_ones: dict[tuple, torch.Tensor] = {}
        self._hit_owner: int | None = None             # owner rid of the last live prefix hit
        self.preempted = 0
        self.replica_id: int | None = None             # the router's lane index
        # bucket steps: CUDA graphs on the card (the private _graphs=False
        # runs them eagerly, for comparison), eager on the CPU
        self._graphs = self.device.type == "cuda" and bool(_graphs)
        self._graph_pool = torch.cuda.graph_pool_handle() if self._graphs else None
        self._programs: dict[tuple, Callable] = {}
        # the configs' share of _static_key, flattened once
        self._cfg_key = tuple(sorted(dataclasses.asdict(self.cfg).items()))
        self._draft_cfg_key = (tuple(sorted(dataclasses.asdict(self.spec.draft_cfg).items()))
                               if self.spec is not None else None)
        self._rope: dict[tuple, tuple[torch.Tensor, torch.Tensor]] = {}
        self._closed = False
        self.decode_steps = 0
        self.prefill_runs = 0
        self.chunk_runs = 0
        self.step_calls = 0
        self.tokens_generated = 0
        self.host_visits = 0
        self.decode_lane_tokens = 0
        self._occupancy_sum = 0
        self.compile_counts = {"prefill": 0, "prefill_chunk": 0, "prefill_chunk_paged": 0,
                               "decode": 0, "decode_paged": 0, "decode_multi": 0,
                               "decode_multi_paged": 0, "spec_prefill": 0,
                               "spec_prefill_chunk": 0, "draft_decode": 0, "verify": 0,
                               "verify_paged": 0}
        self.captures = dict.fromkeys(GRAPH_KINDS, 0)
        self._compile_log: list[dict] = []
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
        # fault tolerance: the plan (None = unarmed: one `is None` test per
        # fault point), the retry policy, the harvest watchdog on the
        # scheduler's clock, and each request's generator state as of its
        # last harvest (a port generator advances at dispatch; recovery
        # restores these so the replayed draws are the unfaulted run's)
        self._faults = resolve_fault_plan(fault_plan)
        self._retry = retry if retry is not None else RetryPolicy()
        self.watchdog_timeout_s = watchdog_timeout_s
        self._retry_streak = 0
        self.recoveries = 0
        self._gen_states: dict[int, Any] = {}
        # telemetry: a StepLogger, a path for one, or None
        self._owns_telemetry = isinstance(telemetry, (str, bytes)) or hasattr(telemetry,
                                                                               "__fspath__")
        if self._owns_telemetry:
            from thunder_tpu_torch.observability.telemetry import StepLogger

            telemetry = StepLogger(telemetry, meta={
                "kind": "serving", "block_size": block_size, "num_blocks": num_blocks,
                "max_batch": max_batch, "model": getattr(cfg, "name", "?")})
        self.telemetry = telemetry
        if trace is None:
            trace = serving_trace_env_enabled()
        self._tracer = RequestTracer() if trace else None
        self._slo = resolve_slo(slo)
        self._goodput = resolve_goodput(goodput)
        if flight_recorder is None:
            flight_recorder = flight_recorder_env_enabled()
        me = weakref.proxy(self)                           # no engine-recorder cycle
        if isinstance(flight_recorder, FlightRecorder):
            flight_recorder.state_provider = lambda: me._flight_state()
            self._flight = flight_recorder
        else:
            self._flight = (FlightRecorder(state_provider=lambda: me._flight_state())
                            if flight_recorder else None)
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
        self._m_captures = reg.counter("serving.graphs.captures")
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
               session_id: str | None = None, priority: str | None = None, constraint=None,
               **deferred) -> RequestHandle:
        """Enqueues one request; returns immediately with a handle.

        ``deadline`` is seconds from now.  ``generator`` is the request's
        private sampling generator on the engine's device (default: a fresh
        one seeded 0, like ``generate``).  ``stream_cb`` receives each
        generated token id as soon as the host sees it.  ``adapter_id``
        routes the request through a LoRA adapter of the engine's ``lora=``
        registry, resolved to its slot here (an unknown id raises
        ``KeyError``).  Raises :class:`AdmissionError` when the wait queue
        is full or the request can never fit the pool.

        ``session_id`` (needs ``sessions=``) parks the finished turn's
        prefix blocks so the next turn re-attaches them; ``priority``
        (``"high"``/``"normal"``/``"low"``, needs ``priorities=``) orders
        the queue, feeds the SLO admission gate and marks preemption
        victims; ``constraint`` (a :class:`serving.constrain.Constraint`,
        needs ``constraints=True``) masks every draw of the request through
        its host automaton."""
        if self._closed:
            raise RuntimeError("engine is shut down")
        _reject_deferred("submit", deferred, _DEFERRED_SUBMIT)
        adapter_slot = 0
        if adapter_id is not None:
            if self._registry is None:
                raise ValueError(f"adapter_id={adapter_id!r} requires an engine built with "
                                 f"lora=AdapterRegistry(...)")
            adapter_slot = self._registry.slot(adapter_id)
        if session_id is not None and self._sessions is None:
            raise ValueError(f"session_id={session_id!r} requires an engine built with "
                             f"sessions= (e.g. sessions=True)")
        if priority is not None and self._priorities is None:
            raise ValueError(f"priority={priority!r} requires an engine built with "
                             f"priorities= (e.g. priorities=True)")
        priority_cls, level = priority_level(priority)
        if constraint is not None:
            if not self._constraints:
                raise ValueError("constraint= requires an engine built with constraints=True")
            if int(constraint.vocab_size) != self._vocab:
                raise ValueError(f"constraint.vocab_size={constraint.vocab_size} != model "
                                 f"logit width {self._vocab}")
            # multi-step decode needs exact masks N draws ahead: fail here,
            # not mid-visit (ConstraintLookaheadError propagates)
            if self.n_decode_steps > 1:
                constraint.masks(self.n_decode_steps)
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        elif generator.device.type != self.device.type:
            raise ValueError(f"generator lives on {generator.device}, the engine on {self.device}")
        reg = registry()
        try:
            req = self.scheduler.submit(prompt, max_new_tokens, generator=generator,
                                        deadline_s=deadline, stream_cb=stream_cb,
                                        adapter_id=adapter_id, adapter_slot=adapter_slot,
                                        session_id=session_id, priority=level,
                                        priority_class=priority_cls, constraint=constraint)
        except AdmissionError:
            reg.counter("serving.requests.rejected").inc()
            raise
        self._save_generator(req)
        reg.counter("serving.requests.submitted").inc()
        reg.gauge("serving.queue_depth").set(len(self.scheduler.queue))
        if self._tracer is not None:
            self._tracer.register_request(req.rid)
            self._tracer.begin(req.rid, "queued", prompt_tokens=req.prompt_len,
                               max_new_tokens=req.max_new_tokens)
        if self._flight is not None:
            self._flight.record("submit", rid=req.rid, prompt_tokens=req.prompt_len,
                                max_new_tokens=req.max_new_tokens,
                                queue_depth=len(self.scheduler.queue))
        return RequestHandle(self, req)

    def step(self) -> bool:
        """One event-loop iteration; returns whether any work happened.  A
        classified fault is absorbed (quarantine, retry or recovery); any
        other exception dumps the flight record, when one is armed, and
        propagates."""
        if self._closed:
            raise RuntimeError("engine is shut down")
        self.step_calls += 1
        tr = self._tracer
        if tr is not None:
            tr.engine_begin("engine.step", queued=len(self.scheduler.queue),
                            running=len(self.scheduler.running))
        try:
            with torch.no_grad():
                worked = self._step_async() if self.async_step else self._step_sync()
            self._retry_streak = 0                         # a clean step resets the budget
        except Exception as e:
            try:
                with torch.no_grad():
                    handled = self._absorb_fault(e)
            except Exception as e2:
                if self._flight is not None:
                    self._flight.crash_dump(e2)
                if tr is not None:
                    tr.engine_end("engine.step", error=type(e2).__name__)
                raise
            if not handled:
                if self._flight is not None:
                    self._flight.crash_dump(e)
                if tr is not None:
                    tr.engine_end("engine.step", error=type(e).__name__)
                raise
            worked = True
        if tr is not None:
            tr.engine_end("engine.step", worked=worked)
        return worked

    def _step_sync(self) -> bool:
        """expire → admit + prefill → one blocking decode."""
        worked = False
        for req in self.scheduler.deadline_expired():
            self._finish(req, FINISH_DEADLINE)
            worked = True
        while self._try_admit():
            worked = True
        for r in list(self.scheduler.running):
            if not r.generated and r.state == "running":
                # stranded without token 0 (its prefill was absorbed as a
                # fault, or a recovery reset it): prefill before decoding
                self._prefill_harvest(self._prefill_dispatch(r))
                self._sample_occupancy()
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
        dispatched before the prefills).  The watchdog turns a record older
        than ``watchdog_timeout_s`` on the engine clock into a
        :class:`WatchdogTimeout`."""
        wd = self.watchdog_timeout_s
        if wd is not None:
            now = self.scheduler.clock()
            inflight = list(self._inflight_prefill)
            if self._inflight_decode is not None:
                inflight.append(self._inflight_decode)
            for wrec in inflight:
                age = now - wrec["t_clock"]
                if age > wd:
                    rids = ([r.rid for r in wrec["running"]] if "running" in wrec
                            else [wrec["req"].rid])
                    raise WatchdogTimeout(FP_HARVEST, rids, age_s=age)
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
                raise EngineStalledError("engine stalled during drain", self._flight_state())

    def evict(self, handle: RequestHandle) -> None:
        """Removes a queued/running request (finish reason ``"evicted"``)."""
        if not handle.done():
            self._finish(handle._req, FINISH_EVICTED)

    def shutdown(self, *, drain: bool = True) -> None:
        """Graceful stop: optionally drains, drops in-flight records,
        evicts whatever remains, closes an owned telemetry sink, and rejects
        further submits."""
        if self._closed:
            return
        if drain:
            self.drain()
        self._discard_inflight()
        for req in (*self.scheduler.running, *self.scheduler.queue):
            self._finish(req, FINISH_EVICTED)
        if self._sessions is not None:
            self._sessions.clear()
        self._closed = True
        if self._owns_telemetry and self.telemetry is not None:
            self.telemetry.close()

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
        # prefill bucket (and the chunk kind beside it when chunking is on,
        # or once a recovery replayed through the chunk steps)
        kinds = (len(sch.batch_buckets) * (2 if self.spec is not None else 1)
                 + len(sch.prefill_buckets)
                 * (2 if (sch.prefill_chunk is not None or self.chunk_runs > 0) else 1))
        return {
            **({"replica": self.replica_id} if self.replica_id is not None else {}),
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
            "decode_steps_per_visit": self.n_decode_steps,
            "host_visits": self.host_visits,
            "tokens_per_host_visit": (self.decode_lane_tokens / self.host_visits
                                      if self.host_visits else None),
            "prefill_runs": self.prefill_runs,
            "chunk_runs": self.chunk_runs,
            "step_calls": self.step_calls,
            "tokens_generated": self.tokens_generated,
            "mean_batch_occupancy": (self._occupancy_sum / self.decode_steps
                                     if self.decode_steps else 0.0),
            "decode_stall_s_mean": (self._stall_s_sum / n) if n else None,
            "overlap_frac_mean": (self._overlap_frac_sum / n) if n else None,
            "compile_counts": dict(self.compile_counts),
            "graphs": self._graph_stats(),
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
            "recoveries": self.recoveries,
            "faults": self._faults.snapshot() if self._faults is not None else None,
            "speculative": self._spec_stats() if self.spec is not None else None,
            **({"goodput": self._goodput.snapshot()} if self._goodput is not None else {}),
            "pool_occupancy": self.pool.occupancy_snapshot(),
            **({"lora": self._registry.state_snapshot()} if self._registry is not None else {}),
            **({"sessions": self._sessions.snapshot()} if self._sessions is not None else {}),
            **({"priority": {**self._priorities.snapshot(), "preempted": self.preempted}}
               if self._priorities is not None else {}),
            **({"constrained": True} if self._constraints else {}),
        }

    def _graph_stats(self) -> dict:
        """The bucket steps' CUDA graphs: captures by kind, replays, and
        the host seconds spent capturing."""
        steps = [p for p in self._programs.values() if isinstance(p, StepGraph)]
        return {"enabled": self._graphs,
                "captures": {k: v for k, v in self.captures.items() if v},
                "replays": sum(p.replays for p in steps),
                "capture_s": sum(p.capture_s for p in steps)}

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

    def slo_report(self) -> dict:
        """Burn rates against the ``slo=`` targets
        (:mod:`observability.slo`); ``{"enabled": False}`` without them."""
        if self._slo is None:
            return {"enabled": False}
        return self._slo.report()

    def goodput_report(self) -> dict:
        """The goodput ledger's report (``goodput=``,
        :mod:`observability.goodput`); ``{"enabled": False}`` without it."""
        if self._goodput is None:
            return {"enabled": False}
        return self._goodput.report()

    def _flight_state(self) -> dict:
        """State snapshot the flight recorder embeds in every dump: engine
        stats, scheduler rows (with the decode horizon), pool counts and
        what each lane has in flight."""
        lookups = self._prefix_index.lookups
        dec = self._inflight_decode
        return {
            "engine": self.stats(),
            "scheduler": self.scheduler.state_snapshot(),
            "pool": self.pool.state_snapshot(),
            "lanes": {
                "async_step": self.async_step,
                "decode_inflight": (
                    {"step": dec["step"], "bucket": dec["bucket"], "steps": dec.get("multi", 1),
                     "rids": [r.rid for r in dec["running"]]} if dec is not None else None),
                "prefill_inflight": [{"rid": rec["req"].rid, "kind": rec["kind"]}
                                     for rec in self._inflight_prefill],
                "prefilling": [{"rid": r.rid, "pos": r.pos, "prompt_tokens": r.prompt_len}
                               for r in self.scheduler.running if r.pos < r.prompt_len],
                "speculative": (
                    {"K": self.spec.K, "chained": self._spec_state is not None,
                     "rounds": self.spec_rounds,
                     "acceptance_rate": self._spec_stats()["acceptance_rate"]}
                    if self.spec is not None else None),
                "goodput": self._goodput.brief() if self._goodput is not None else None,
            },
            "prefix_share_hit_rate": (self._prefix_index.hits / lookups) if lookups else None,
            "compiles": list(self._compile_log),
            "slo": self.slo_report(),
        }

    #
    # admission + prefill
    #

    def _cap_learned_positions(self, cap: int) -> None:
        """A learned-position model (``wpe`` of ``cap`` rows, the target's
        or a speculative draft's): caps the block and prefill buckets so no
        step's positions pass the table, and turns off prefix sharing and
        chunked prefill, whose resumed pieces could reach past it with
        their bucket padding (reference ``engine.py:443-466``)."""
        sch = self.scheduler
        blk = tuple(b for b in sch.block_buckets if self.pool.capacity_tokens(b) <= cap)
        if not blk:
            raise ValueError(f"block_size(cfg)={cap} admits no pool bucket at pool "
                             f"block_size={self.pool.block_size} with learned position "
                             f"embeddings")
        sch.block_buckets = blk
        sch.prefill_buckets = tuple(t for t in sch.prefill_buckets if t <= cap) or (cap,)
        self.prefix_sharing = False
        sch.prefill_chunk = None

    def _table_width_buckets(self) -> tuple[int, ...]:
        """Every table width a step may use: the block buckets, shifted off
        any width whose dense capacity equals ``sliding_window`` (the ring
        layout the pool never uses), extended so a shared-prefix or
        chunked-prefill resume point plus prefill-bucket padding still
        rounds up into the set, and so are a recovery replay's pieces (the
        widest block-aligned prefill bucket, resumed up to one token short
        of the full reservation).  With chunking, prompts are capped only
        by the pool, but every piece is at most one chunk wide."""
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
        aligned = [t for t in sch.prefill_buckets if t % bs == 0]
        replay_piece = max(aligned) if aligned else sch.prefill_buckets[-1]
        replay_resume = ((cap_tokens - 1) // bs) * bs
        need = max(need, -(-(replay_resume + replay_piece) // bs))
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
        head = sch.queue[0]
        gate = self._priorities
        if gate is not None and not gate.admit_ok(head.priority_class, self._slo):
            # SLO burn defers this class; more urgent arrivals are inserted
            # ahead of it, so holding the head is safe
            return False
        # a preempted victim that holds tokens replays from position 0, so
        # it shares no prefix (leased shared blocks would be written)
        resume = bool(head.generated)
        shared = [] if resume else self._find_shared_prefix(head)
        req = sch.next_admittable(shared_blocks=len(shared))
        if req is None:
            return gate is not None and self._maybe_preempt(head)
        if (shared and self._sessions is not None
                and self._hit_owner is not None and self._hit_owner < 0):
            self._sessions.note_reattach(self._hit_owner)
            entry = self._sessions.owner_entry(self._hit_owner)
            if entry is not None and entry.full_pos:
                # the parked turn had written full_pos slots: the prompt
                # positions below that watermark past the shared blocks are
                # recomputation of the cut tail
                req.replay_until = max(req.replay_until, min(entry.full_pos, req.prompt_len))
                req.replay_cause = "replay_session_tail"
        n_needed = sch.blocks_needed(req)
        table = self.pool.share(shared) + self.pool.alloc(n_needed - len(shared))
        sch.admit(req, table, len(shared))
        if self._registry is not None:
            req.adapter_version = self._registry.version(req.adapter_slot)
        if gate is not None:
            registry().counter(f"serving.priority.{req.priority_class}.admitted").inc()
        if self._tracer is not None:
            self._tracer.end(req.rid, "queued", queue_s=req.admit_t - req.submit_t)
        if self._flight is not None:
            self._flight.record("admit", rid=req.rid, blocks=n_needed, shared_blocks=len(shared),
                                pool_free=self.pool.num_free, resume=resume)
        if resume:
            self._resume_replay(req)
        else:
            self._prefill(req)
        return True

    def _maybe_preempt(self, head: Request) -> bool:
        """Evict-and-resume: checkpoints the least urgent running request so
        a strictly more urgent head can be funded (reference
        ``engine.py:1265``).  The checkpoint is host state: prompt and
        generated tokens, and the generator state saved at the victim's last
        harvest, which it gets back here (a step in flight may have drawn
        for it; the harvest drops that step's record by the victim's
        preemption epoch).  Re-admission replays through the chunk steps
        (:meth:`_resume_replay`).  Not beside the speculative lane, whose
        harvest keeps no epochs."""
        if self.spec is not None:
            return False
        victim = self._priorities.pick_victim(self.scheduler.running, head.priority)
        if victim is None:
            return False
        self._unregister_prefix(victim)
        self.scheduler.preempt(victim)                 # frees blocks, bumps preemptions
        saved = self._gen_states.get(victim.rid)
        if saved is not None:
            victim.generator.set_state(saved)
        self._decode_state = None
        self.preempted += 1
        registry().counter(f"serving.priority.{victim.priority_class}.preempted").inc()
        if self._tracer is not None:
            self._tracer.instant(victim.rid, "preempted", for_rid=head.rid,
                                 generated=len(victim.generated))
            self._tracer.begin(victim.rid, "queued", preemptions=victim.preemptions)
        if self._flight is not None:
            self._flight.record("preempt", rid=victim.rid, for_rid=head.rid,
                                generated=len(victim.generated), pool_free=self.pool.num_free)
        return True

    def _resume_replay(self, req: Request) -> None:
        """Re-admission of a preempted request that holds tokens: its K/V
        rebuilt through the chunk-step replay (no draw), then it rejoins the
        decode lane at the same position and generator state."""
        tr = self._tracer
        if tr is not None:
            tr.begin(req.rid, "resume", lane="prefill", generated=len(req.generated))
        self._replay_request(req, cause="replay_preemption")
        self._register_prefix(req, upto=req.pos)
        if tr is not None:
            tr.end(req.rid, "resume", pos=req.pos)

    def _factor_tag(self, req: Request):
        """What decides a request's K/V besides its tokens: the (slot,
        version) of its adapter's factors as they stand now, None without a
        registry."""
        if self._registry is None:
            return None
        return (req.adapter_slot, self._registry.version(req.adapter_slot))

    def _find_shared_prefix(self, req: Request) -> list[int]:
        """Longest block-aligned prompt prefix already resident in a live
        request's (or a parked session's) blocks whose K/V were computed
        with this request's adapter factors."""
        if not self.prefix_sharing:
            return []
        self._hit_owner = None
        return self._prefix_index.find(req.prompt, self._prefix_alive, tag=self._factor_tag(req))

    def _prefix_alive(self, hit: tuple[int, tuple[int, ...]]) -> bool:
        """A registered prefix is shareable only while its owner is running
        and every snapshot block id is still its live table entry.  Negative
        owner rids are parked sessions, alive while the session table holds
        those blocks."""
        rid, blocks = hit
        if rid < 0:
            ok = self._sessions is not None and self._sessions.alive(rid, blocks)
        else:
            owner = next((r for r in self.scheduler.running if r.rid == rid), None)
            ok = (owner is not None and len(owner.block_table) >= len(blocks)
                  and all(t == b != SINK_BLOCK for t, b in zip(owner.block_table, blocks)))
        if ok:
            self._hit_owner = rid
        return ok

    def probe_prefix(self, prompt, adapter_id: str | None = None) -> int:
        """Longest resident shared-prefix length (tokens) of ``prompt`` for
        a request of ``adapter_id``, without counting a lookup or changing
        the index: the replica router's affinity probe."""
        if not self.prefix_sharing:
            return 0
        tag = None
        if self._registry is not None:
            slot = self._registry.slot(adapter_id) if adapter_id is not None else 0
            tag = (slot, self._registry.version(slot))
        return self._prefix_index.probe(prompt, self._prefix_alive, tag=tag)

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

    def _note_chunk_attn_step(self) -> None:
        st = self._attn_steps["prefill_chunk"]
        if self.attn_chunk == "paged":
            st[0] += 1
        else:
            st[1] += 1
            if self._attn_requested != "gather":
                self._m_attn_fallback.inc()

    def _chunk_piece(self, kind: str, toks, pos: int, table, dest, slot: int):
        """Runs one intermediate (sampling-free) piece; returns its
        quantization error (a tensor a graph may overwrite at its next
        replay is copied), 0.0 unquantized."""
        prog, compiled = self._program(kind, len(toks), len(table))
        slots = slot if self._registry is not None else None
        if kind == "prefill_chunk_paged":
            x = {"toks": toks[None], "pos": np.asarray([pos], np.int32), "table": table[None],
                 "dest": dest,
                 "slots": None if slots is None else np.asarray([slots], np.int32)}
            out, _ = prog(x)
            qerr = out.get("qerr", 0.0)
            if isinstance(prog, StepGraph) and isinstance(qerr, torch.Tensor):
                qerr = qerr.clone()
            return qerr, compiled
        return prog(toks, pos, table, dest, slots), compiled

    def _prefill_dispatch(self, req: Request) -> dict:
        """Dispatches the next prefill piece of ``req`` past its resume
        point and returns the in-flight record.  A piece is the final
        ``prefill`` (samples token 0, which stays on the device until the
        harvest) or an intermediate chunk of ``prefill_chunk`` tokens (K/V
        only, no draw, so the final draw is the unchunked prefill's)."""
        self._fault_point(FP_PREFILL, (req.rid,))
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
        name = "prefill.chunk" if not final else "prefill.dispatch"
        tr = self._tracer
        if tr is not None and first:
            tr.begin(req.rid, "prefill", bucket=[Tb, nbb], shared_blocks=req.n_shared_blocks,
                     lane="prefill", chunked=not final)
        if final:
            prog, compiled = self._program(kind, Tb, nbb)
            if tr is not None:
                name = "prefill.compile" if compiled else name
                tr.begin(req.rid, name, lane="prefill")
            slots = req.adapter_slot if self._registry is not None else None
            # the final piece draws token 0: a constrained request's mask
            # applies to it as to every decode draw
            cmask = req.constraint.mask()[None] if req.constraint is not None else None
            tok, qerr = prog(toks, pos, n_real, table, dest, req.generator, slots, cmask)
            rec = {"kind": "prefill", "req": req, "tok": tok, "qerr": qerr,
                   "epoch": req.preemptions}
        else:
            if tr is not None:
                tr.begin(req.rid, name, lane="prefill")
            qerr, compiled = self._chunk_piece(kind, toks, pos, table, dest, req.adapter_slot)
            rec = {"kind": "chunk", "req": req, "qerr": qerr}
        rec.update(compiled=compiled, span=name, t_clock=sch.clock())
        req.prefill_compiled = req.prefill_compiled or compiled
        self._fault_point(FP_SCATTER, (req.rid,))
        req.pos = pos + n_real                             # written (stream-ordered)
        self._register_prefix(req, upto=req.pos)
        if req.replay_until > pos:
            # recompute bookkeeping: positions dispatched once before a replay
            req.tokens_recomputed += min(req.replay_until, pos + n_real) - pos
            if req.replay_cause and req.replay_cause not in req.recompute_causes:
                req.recompute_causes.append(req.replay_cause)
        if self._goodput is not None:
            rec["pkind"] = kind
            rec["t_disp"] = time.perf_counter()
            rec["goodput"] = self._account_prefill(req, kind, pos, n_real, Tb)
        reg = registry()
        if final:
            self.prefill_runs += 1
            reg.counter("serving.steps.prefill").inc()
        else:
            self.chunk_runs += 1
            reg.counter("serving.steps.prefill_chunk").inc()
            if self.spec is None:
                self._note_chunk_attn_step()
        if compiled:
            reg.counter("serving.prefill.compiles").inc()
        if first and req.n_shared_blocks:
            reg.counter("serving.prefix.shared_blocks").inc(req.n_shared_blocks)
        if self._flight is not None:
            self._flight.record("prefill" if final else "prefill_chunk", rid=req.rid,
                                compiled=compiled, bucket=[Tb, nbb], pos=pos,
                                shared_blocks=req.n_shared_blocks,
                                **({} if final else {"attn": self.attn_chunk}))
        return rec

    def _prefill_harvest(self, rec: dict) -> None:
        """Delivers token 0 (TTFT stamps here: token availability); an
        intermediate chunk delivers nothing.  A quantized pool's piece sets
        the ``serving.kv_quant.rel_err`` gauge to the quantization error it
        measured over the blocks it wrote."""
        req = rec["req"]
        self._fault_point(FP_HARVEST, (req.rid,))
        gp = self._goodput
        if gp is not None and "t_disp" in rec:
            gp.note_device_s(rec["pkind"], time.perf_counter() - rec["t_disp"])
        tr = self._tracer
        if rec["kind"] == "chunk":
            self._note_qerr(rec)
            if tr is not None:
                tr.end(req.rid, rec["span"], lane="prefill")
            return
        if tr is not None:
            tr.end(req.rid, rec["span"])
            tr.begin(req.rid, "prefill.host")
        tok0 = int(rec["tok"][0])                          # blocks until the device delivers
        if req.state != "running" or req.preemptions != rec["epoch"]:
            # finished while in flight, or preempted (a resumed request
            # draws token 0 again against its rebuilt K/V)
            if tr is not None:
                tr.end(req.rid, "prefill.host")
                tr.end(req.rid, "prefill", aborted=True)
            return
        req.first_token_t = self.scheduler.clock()
        if tr is not None:
            tr.end(req.rid, "prefill.host")
            tr.end(req.rid, "prefill", compile=req.prefill_compiled)
        self.tokens_generated += 1
        if gp is not None:
            gp.commit_tokens(1)
        self._m_tokens.inc()
        self._note_qerr(rec)
        self._save_generator(req)
        self._emit_token(req, tok0)

    def _note_qerr(self, rec: dict) -> None:
        if self.pool.quantized_kv:
            registry().gauge("serving.kv_quant.rel_err").set(float(rec["qerr"]))

    def _sample_occupancy(self) -> None:
        self.pool.sample_occupancy()
        self._m_pool_occ.set(self.pool.utilization())

    #
    # goodput accounting (host integers only; the steps are untouched)
    #

    @staticmethod
    def _sunk_positions(block_table, pos: int, n: int, bs: int) -> int:
        """How many of the real positions ``[pos, pos + n)`` write to the
        sink block (window-expired table entries)."""
        if n <= 0:
            return 0
        sunk = 0
        for bi in range(pos // bs, -(-(pos + n) // bs)):
            b = block_table[bi] if bi < len(block_table) else SINK_BLOCK
            if b == SINK_BLOCK:
                sunk += min(pos + n, (bi + 1) * bs) - max(pos, bi * bs)
        return sunk

    def _account_prefill(self, req: Request, kind: str, pos: int, n_real: int, Tb: int) -> dict:
        """Classifies one prefill-family dispatch (1 row x Tb positions):
        bucket padding, sink-routed slots, recompute below the replay
        watermark, and fresh committed work."""
        bs = self.pool.block_size
        sunk = self._sunk_positions(req.block_table, pos, n_real, bs)
        replay_n = min(max(req.replay_until - pos, 0), n_real)
        win = min(sunk, replay_n)
        extra_sunk = sunk - win
        cause_n = replay_n - win
        waste = {}
        if Tb > n_real:
            waste["pad_prefill"] = Tb - n_real
        if sunk:
            waste["replay_window"] = sunk
        if cause_n:
            cause = req.replay_cause or "replay_recovery"
            waste[cause] = waste.get(cause, 0) + cause_n
        return self._goodput.account(kind, 1, Tb, committed=n_real - replay_n - extra_sunk,
                                     **waste)

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
        sch = self.scheduler
        running = sch.decode_ready() if self.async_step else list(sch.running)
        self._fault_point(FP_DECODE, tuple(r.rid for r in running))
        Bb, nbb_raw = sch.decode_bucket(running)
        nbb = self._nbb(nbb_raw)
        bs = self.pool.block_size
        N = self.n_decode_steps
        sig = (tuple(r.rid for r in running), Bb, nbb)
        st = self._decode_state
        if st is not None and st["sig"] == sig:
            # steady state: this step's inputs are the previous step's
            # device outputs plus the cached tables — no host→device copy
            x = st["x"]
            host_pos = st["host_pos"] + N
        else:
            toks = np.zeros(Bb, dtype=np.int32)
            host_pos = np.zeros(Bb, dtype=np.int32)
            tables = np.full((Bb, nbb), SINK_BLOCK, dtype=np.int32)
            stop = np.full(Bb, -1, dtype=np.int32)         # padding rows: dead from step 0
            for i, r in enumerate(running):
                toks[i] = r.generated[-1]
                host_pos[i] = r.prompt_len + len(r.generated) - 1   # slot this step writes
                tables[i, : len(r.block_table)] = r.block_table
                stop[i] = r.prompt_len + r.max_new_tokens - 2
            x = {"toks": toks, "pos": host_pos.copy(), "tables": tables,
                 "slots": self._slots(running, Bb)}
            if N > 1:
                x.update(stop=stop, live=host_pos <= stop)
        cmasks = self._decode_masks(running, Bb, N) if self._constraints else None
        if N > 1:
            kind = "decode_multi_paged" if self.attn == "paged" else "decode_multi"
        else:
            kind = "decode_paged" if self.attn == "paged" else "decode"
        step, compiled = self._program(kind, Bb, nbb)
        if self.attn == "paged":
            self.attn_kernel_steps += 1
            self._attn_steps["decode"][0] += 1
            self._m_attn_kernel.inc()
        elif self._attn_requested == "auto":
            self._attn_steps["decode"][1] += 1
            self._m_attn_fallback.inc()
        if self._goodput is not None and self.attn == "paged":
            hp = np.asarray(host_pos, dtype=np.int64)[:, None] + np.arange(N)
            real = int(np.minimum(np.maximum(-(-hp // bs), 1), nbb).sum())
            self._goodput.note_blocks(kind, Bb * nbb * N, real)
        tr = self._tracer
        if tr is not None:
            for r in running:
                tr.begin(r.rid, "decode", step=self.decode_steps, compile=compiled,
                         bucket=[Bb, nbb], lane="decode", attn=self.attn,
                         **({"steps": N} if N > 1 else {}))
        rec = {"kind": "decode", "running": running, "pos": host_pos, "bucket": [Bb, nbb],
               "pkind": kind, "compiled": compiled, "step": self.decode_steps,
               "epochs": [r.preemptions for r in running]}
        if N == 1:
            host_fns = None
            if self.temperature != 0.0:
                host_fns = {"sample": partial(self._draw_rows, running, None, None)}
            if cmasks is not None:
                x = {**x, "cmask": cmasks[0]}
            out, x = step(x, host_fns)
            rec["nxt"] = out["nxt"]
            if isinstance(step, StepGraph):
                rec["guard"] = (step, step.replays)        # nxt is the graph's buffer
        else:
            ys_tok = torch.empty((N, Bb), dtype=torch.int32, device=self.device)
            ys_emit = torch.empty((N, Bb), dtype=torch.bool, device=self.device)
            states = [[] for _ in running]
            for s in range(N):
                host_fns = None
                if self.temperature != 0.0:
                    # a row draws while its length allows; a row that died
                    # of EOS gets its generator back at the harvest
                    active = [host_pos[i] + s <= r.prompt_len + r.max_new_tokens - 2
                              for i, r in enumerate(running)]
                    host_fns = {"sample": partial(self._draw_rows, running, active, states)}
                if cmasks is not None:
                    x = {**x, "cmask": cmasks[s]}
                out, x = step(x, host_fns)
                ys_tok[s].copy_(out["nxt"])
                ys_emit[s].copy_(out["emit"])
            rec.update(multi=N, nxt=ys_tok, emit=ys_emit, states=states)
        self._fault_point(FP_SCATTER, tuple(r.rid for r in running))
        self._decode_state = {"sig": sig, "x": x, "host_pos": host_pos}
        rec.update(t_disp=time.perf_counter(), t_clock=sch.clock())
        self.decode_steps += 1
        self._occupancy_sum += len(running)
        self._m_steps_decode.inc()
        self._m_occupancy.observe(len(running))
        return rec

    def _decode_masks(self, running, Bb: int, N: int):
        """The constraint masks of one decode dispatch, one (Bb, V) bool
        tensor per iteration: each constrained row's automaton masks,
        uploaded once; a batch without a constrained row takes the cached
        all-True mask (no upload)."""
        if not any(r.constraint is not None for r in running):
            ones = self._ones_mask((Bb, self._vocab))
            return [ones] * N
        m = np.ones((N, Bb, self._vocab), dtype=bool)
        for i, r in enumerate(running):
            if r.constraint is not None:
                m[:, i] = r.constraint.masks(N) if N > 1 else r.constraint.mask()
        return list(torch.from_numpy(m).to(self.device))

    def _ones_mask(self, shape: tuple) -> torch.Tensor:
        """The cached all-True constraint mask unconstrained batches ride
        through a constrained step (``where(True, logits, -inf)`` is the
        identity, bitwise)."""
        m = self._mask_ones.get(shape)
        if m is None:
            m = self._mask_ones[shape] = torch.ones(shape, dtype=torch.bool, device=self.device)
        return m

    def _draw_rows(self, running, active, states, logits):
        """One temperature draw per running row that is ``active`` (all
        when None) from its own generator, as a solo B=1 call would draw;
        other rows get 0.  ``states`` (per row, or None) collects each
        generator's state before its draw."""
        rows = []
        for i, r in enumerate(running):
            if active is not None and not active[i]:
                rows.append(torch.zeros(1, dtype=torch.int32, device=logits.device))
                continue
            if states is not None:
                states[i].append(r.generator.get_state())
            rows.append(sample_token(logits[i:i + 1], self.temperature, r.generator))
        pad = logits.shape[0] - len(rows)
        if pad:
            rows.append(torch.zeros(pad, dtype=torch.int32, device=logits.device))
        return (torch.cat(rows),)

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

    @staticmethod
    def _check_guard(rec: dict) -> None:
        """A record whose outputs are a graph's buffers is read before that
        graph replays again."""
        guard = rec.get("guard")
        if guard is not None and guard[0].replays != guard[1]:
            raise RuntimeError(f"the {guard[0].kind} graph {guard[0].bucket} replayed before "
                               f"its record of replay {guard[1]} was harvested")

    def _decode_harvest(self, rec: dict) -> None:
        if rec.get("spec"):
            spec_lane.spec_decode_harvest(self, rec)
            return
        if rec.get("multi"):
            self._decode_harvest_multi(rec)
            return
        sch = self.scheduler
        running = rec["running"]
        self._fault_point(FP_HARVEST, tuple(r.rid for r in running))
        t0 = time.perf_counter()
        self._check_guard(rec)
        nxt = rec["nxt"].tolist()                          # the host block
        self._note_stall(t0, rec["t_disp"])
        stale = self._stale_rows(rec)
        gp, gtag = self._goodput, None
        if gp is not None:
            Bb = rec["bucket"][0]
            n_stale = sum(stale)
            n_dead = sum(r.state != "running" and not st for r, st in zip(running, stale))
            waste = {}
            if Bb > len(running):
                waste["pad_row"] = Bb - len(running)
            if n_stale:
                waste["replay_preemption"] = n_stale
            if n_dead:
                waste["dead_scan_row"] = n_dead
            gtag = gp.account(rec["pkind"], Bb, 1, committed=len(running) - n_dead - n_stale,
                              **waste)
            gp.note_device_s(rec["pkind"], time.perf_counter() - rec["t_disp"])
        self._note_decode_visit(rec, gtag)
        emitted = 0
        invalidate = False
        for i, r in enumerate(running):
            if r.state != "running" or stale[i]:
                # finished mid-flight (the token was never promised), or
                # preempted: the resumed request draws this token again
                invalidate = True
                continue
            r.pos = int(rec["pos"][i]) + 1
            invalidate |= self._expire_window(r)
            emitted += 1
            self._save_generator(r)
            self._emit_token(r, int(nxt[i]))
            if r.state != "running":
                invalidate = True
        self._count_visit(emitted)
        if invalidate:
            self._decode_state = None

    def _decode_harvest_multi(self, rec: dict) -> None:
        """Harvests one multi-step visit: up to N tokens per row.  The
        emitted prefix of each column is what the 1-step engine would have
        served: the in-step ``done`` rule (pos >= stop, or an EOS token)
        coincides with :meth:`_emit_token`'s finish conditions, so a column
        with k < N emitted tokens finished at its k-th token and its later
        iterations sent their K/V writes to the sink."""
        sch = self.scheduler
        running = rec["running"]
        N = rec["multi"]
        self._fault_point(FP_HARVEST, tuple(r.rid for r in running))
        t0 = time.perf_counter()
        nxt = rec["nxt"].cpu().numpy()                     # (N, Bb): the host block
        emit = rec["emit"].cpu().numpy()
        self._note_stall(t0, rec["t_disp"])
        harvested = [int(emit[:, i].sum()) for i in range(len(running))]
        stale = self._stale_rows(rec)
        gp, gtag = self._goodput, None
        if gp is not None:
            Bb = rec["bucket"][0]
            committed = n_dead = n_stale = 0
            for i, r in enumerate(running):
                if stale[i]:
                    n_stale += N
                    continue
                if r.state != "running":
                    n_dead += N
                    continue
                streamed = min(harvested[i], r.max_new_tokens - len(r.generated))
                if self.eos_id is not None:
                    for s in range(streamed):
                        if int(nxt[s, i]) == self.eos_id:
                            streamed = s + 1
                            break
                committed += streamed
                n_dead += N - streamed
            waste = {}
            if Bb > len(running):
                waste["pad_row"] = (Bb - len(running)) * N
            if n_stale:
                waste["replay_preemption"] = n_stale
            if n_dead:
                waste["dead_scan_row"] = n_dead
            gtag = gp.account(rec["pkind"], Bb, N, committed=committed, **waste)
            gp.note_device_s(rec["pkind"], time.perf_counter() - rec["t_disp"])
        self._note_decode_visit(rec, gtag, harvested=harvested, steps=N)
        emitted = 0
        invalidate = False
        for i, r in enumerate(running):
            if r.state != "running" or stale[i]:
                invalidate = True                          # finished or preempted mid-flight
                continue
            k = harvested[i]
            states = rec["states"][i]
            if k < len(states):
                # died of EOS inside the visit: its generator goes back to
                # the state after its k-th draw, as if it drew no more
                r.generator.set_state(states[k])
            r.pos = int(rec["pos"][i]) + k
            invalidate |= self._expire_window(r)
            self._save_generator(r)
            for s in range(k):
                emitted += 1
                self._emit_token(r, int(nxt[s, i]))
                if r.state != "running":
                    invalidate = True                      # finished at this token
                    break
            if k < N:
                invalidate = True                          # died inside the visit
        self._count_visit(emitted)
        if invalidate:
            self._decode_state = None

    @staticmethod
    def _stale_rows(rec: dict) -> list[bool]:
        """Per row of a decode record: preempted since its dispatch (the
        resumed request derives those tokens again)."""
        return [r.preemptions != e for r, e in zip(rec["running"], rec["epochs"])]

    def _note_decode_visit(self, rec: dict, gtag, **fields) -> None:
        """The decode span ends (tokens host-visible) and the flight event
        of one harvested visit."""
        running = rec["running"]
        tr = self._tracer
        if tr is not None:
            harvested = fields.get("harvested")
            for i, r in enumerate(running):
                tr.end(r.rid, "decode",
                       **({"harvested": harvested[i]} if harvested is not None else {}),
                       **({"goodput": gtag} if gtag is not None else {}))
        if self._flight is not None:
            self._flight.record("decode", step=rec["step"], batch=len(running),
                                bucket=rec["bucket"], compiled=rec["compiled"],
                                rids=[r.rid for r in running], **fields,
                                **({"goodput": gtag} if gtag is not None else {}))

    def _expire_window(self, r: Request) -> bool:
        """Window expiry at a harvest; True when blocks were released (its
        registered prefixes start at the just-sunk blocks, and the cached
        device tables are stale)."""
        released = self.scheduler.expire_window_blocks(r)
        if released:
            self._unregister_prefix(r)
            if self._flight is not None:
                self._flight.record("window_expire", rid=r.rid, released=released)
        return bool(released)

    def _count_visit(self, emitted: int) -> None:
        self.tokens_generated += emitted
        self.decode_lane_tokens += emitted
        self.host_visits += 1
        self._m_host_visits.inc()
        if emitted:
            self._m_tokens.inc(emitted)
        if self._goodput is not None:
            self._goodput.commit_tokens(emitted)

    def _save_generator(self, req: Request) -> None:
        """Keeps ``req``'s generator state as of now (submit and every
        harvest): what :meth:`recover` restores.  Greedy engines draw
        nothing, so keep nothing."""
        if self.temperature != 0.0:
            self._gen_states[req.rid] = req.generator.get_state()

    #
    # finishing / results
    #

    def _emit_token(self, req: Request, tok: int) -> None:
        req.generated.append(tok)
        if req.constraint is not None:
            # the automaton advances at harvest, so a replay or a resume
            # never advances it again
            req.constraint.advance(tok)
        if req.stream_cb is not None:
            req.stream_cb(tok)
        if self.eos_id is not None and tok == self.eos_id:
            self._finish(req, FINISH_EOS)
        elif len(req.generated) >= req.max_new_tokens:
            self._finish(req, FINISH_LENGTH)

    def _finish(self, req: Request, reason: str) -> None:
        never_admitted = req.admit_t is None
        if self._sessions is not None and req.session_id is not None:
            if reason in (FINISH_LENGTH, FINISH_EOS) and req.state == "running":
                # park the turn's written prefix before the scheduler frees
                # the request's references (the table takes its own)
                self._park_session(req)
            else:
                # an abnormal turn breaks the continuation: release it
                self._sessions.close(req.session_id)
        self._unregister_prefix(req)                       # before blocks free
        self.scheduler.finish(req, reason)
        self._gen_states.pop(req.rid, None)
        reg = registry()
        reg.counter("serving.requests.completed").inc()
        reg.counter(f"serving.finish.{reason}").inc()
        res = self._result(req)
        if self._tracer is not None:
            if never_admitted:                             # died in the queue
                self._tracer.end(req.rid, "queued", finish_reason=reason)
            self._tracer.instant(req.rid, "finish", reason=reason,
                                 new_tokens=len(req.generated),
                                 **({"session_id": req.session_id} if req.session_id else {}),
                                 **({"priority": req.priority_class}
                                    if self._priorities is not None else {}),
                                 **({"constrained": True} if req.constraint is not None else {}),
                                 **({"error": req.error_cause.get("type")}
                                    if req.error_cause else {}))
        if self._flight is not None:
            self._flight.record("finish", rid=req.rid, reason=reason,
                                new_tokens=len(req.generated))
        if self._slo is not None:
            self._slo.observe(res)
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
        if self.telemetry is not None:
            self.telemetry.log_request(
                rid=req.rid, prompt_tokens=req.prompt_len, new_tokens=len(req.generated),
                finish_reason=reason, ttft_s=res.ttft_s, tpot_s=res.tpot_s,
                tokens_per_sec=res.tokens_per_sec, queue_s=res.queue_s, e2e_s=res.e2e_s,
                prefill_compiled=req.prefill_compiled,
                shared_prefix_blocks=req.n_shared_blocks, session_id=req.session_id,
                priority=req.priority_class if self._priorities is not None else None,
                constrained=True if req.constraint is not None else None,
                preemptions=req.preemptions or None, error=req.error_cause,
                tokens_recomputed=(req.tokens_recomputed or None),
                recompute_causes=(list(req.recompute_causes) if req.recompute_causes
                                  else None))

    def _park_session(self, req: Request) -> None:
        """Parks the finished turn's written block-aligned prefix.  The
        resident K/V covers positions ``[0, req.pos)`` of prompt + generated
        (the last token's K/V is never written); window expiry may have sunk
        leading blocks, which cuts the parkable prefix to nothing.  A turn
        whose adapter slot was written after its admission holds K/V of two
        sets of factors, and parks nothing."""
        tag = self._factor_tag(req)
        if tag is not None and tag[1] != req.adapter_version:
            self._sessions.close(req.session_id)
            return
        full = np.concatenate([np.asarray(req.prompt, dtype=np.int64),
                               np.asarray(req.generated, dtype=np.int64)])
        bs = self.pool.block_size
        nblk = min(req.pos // bs, len(req.block_table))
        entry = self._sessions.park(req.session_id, full[:nblk * bs], req.block_table[:nblk],
                                    adapter_slot=req.adapter_slot, full_pos=req.pos, tag=tag)
        if self._flight is not None:
            self._flight.record("session_park", rid=req.rid, session_id=req.session_id,
                                blocks=len(entry.blocks) if entry is not None else 0,
                                resident_blocks=self._sessions.resident_blocks)

    def close_session(self, session_id: str) -> int:
        """Releases a session's parked blocks; returns how many were freed
        (0 for an unknown session: closing twice is a no-op)."""
        if self._sessions is None:
            return 0
        freed = self._sessions.close(session_id)
        if freed and self._flight is not None:
            self._flight.record("session_close", session_id=session_id, blocks=freed)
        return freed

    def session_resident(self, session_id: str) -> bool:
        """Does this engine's table hold the session's blocks?  (The replica
        router's session-affinity probe.)"""
        return self._sessions is not None and self._sessions.resident(session_id)

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
            error=req.error_cause,
            tokens_recomputed=req.tokens_recomputed,
            recompute_causes=tuple(req.recompute_causes),
        )

    def _update_gauges(self) -> None:
        self._m_queue_depth.set(len(self.scheduler.queue))
        self._m_running.set(len(self.scheduler.running))
        self._m_pool_util.set(self.pool.utilization())
        self._m_pool_free.set(self.pool.num_free)
        self._m_pool_low_water.set(self.pool.free_blocks_low_water)

    #
    # fault containment + re-prefill recovery (reference engine.py:2195-2502)
    #

    def _fault_point(self, point: str, rids: Sequence[int] = ()) -> None:
        """One injectable fault point (an unarmed engine pays one ``is
        None`` test; the steps never see the plan)."""
        if self._faults is not None:
            self._faults.check(point, rids)

    def _absorb_fault(self, exc: Exception) -> bool:
        """Blast-radius containment for one step exception; False for
        anything the recovery layer must not absorb.

        - **request** class: quarantine the offending rids and keep
          serving; a harvest/scatter fault also recovers (that step's
          tokens are lost);
        - **transient** class: bounded retry with backoff on the policy's
          sleep; a harvest/scatter fault recovers instead of retrying; retry
          exhaustion escalates to recovery;
        - **engine** class (OOM, hang, watchdog): straight to recovery."""
        cls = classify_fault(exc)
        if cls is None:
            return False
        cause = fault_cause(exc)
        point = cause.get("point")
        reg = registry()
        reg.counter("serving.faults.observed").inc()
        if self._flight is not None:
            self._flight.record("fault", fault_class=cls, cause=cause,
                                rids=cause.get("rids", []))
        lossy = point in (FP_HARVEST, FP_SCATTER)
        if cls == CLASS_REQUEST:
            for rid in cause.get("rids", ()):
                self._quarantine(rid, cause)
            if lossy:
                self._recover(cause)
        elif cls == CLASS_TRANSIENT:
            self._retry_streak += 1
            if self._retry_streak > self._retry.max_retries:
                self._retry_streak = 0
                self._recover(cause)
            else:
                reg.counter("serving.faults.retries").inc()
                self._retry.sleep(self._retry.backoff(self._retry_streak))
                if lossy:
                    self._recover(cause)
        else:
            self._recover(cause)
        return True

    def _quarantine(self, rid: int, cause: dict) -> None:
        """Finishes one poisoned request with ``finish_reason="error"`` and
        the structured cause; the rest of the batch keeps serving."""
        req = next((r for r in (*self.scheduler.running, *self.scheduler.queue)
                    if r.rid == rid), None)
        if req is None or req.state == "finished":
            return
        req.error_cause = cause
        registry().counter("serving.faults.quarantined").inc()
        if self._flight is not None:
            self._flight.record("quarantine", rid=rid, cause=cause)
        self._finish(req, FINISH_ERROR)

    def recover(self) -> None:
        """Zeroes the KV arenas in place and re-prefills every running
        request from its prompt and emitted tokens (the engine runs this on
        engine-class faults and retry exhaustion; public for operational
        use).  The KV arena is soft state: replaying the known tokens
        through the sampling-free chunk steps rebuilds the K/V an
        uninterrupted run holds, to the rounding of the chunk products,
        which round apart from those of the prefill and decode steps that
        wrote the lost cache (in bf16 that can move later greedy tokens);
        restoring each request's generator to its last harvest makes every
        later draw the unfaulted run's."""
        with torch.no_grad():
            self._recover({"type": "manual", "point": None, "kind": None, "rids": [],
                           "injected": False, "message": "engine.recover()"})

    def _recover(self, cause: dict) -> None:
        reg = registry()
        t0 = time.perf_counter()
        tr = self._tracer
        if tr is not None:
            tr.engine_begin("engine.recover", cause=cause.get("type"))
        if self._flight is not None:
            self._flight.record("recover", cause=cause,
                                rids=[r.rid for r in self.scheduler.running])
        attempts = 0
        while True:
            try:
                self._recover_once()
                break
            except Exception as e:
                ecls = classify_fault(e)
                if ecls is None:
                    if tr is not None:
                        tr.engine_end("engine.recover", error=type(e).__name__)
                    raise
                if ecls == CLASS_REQUEST:
                    # a poison request resurfaced during its own replay:
                    # quarantining it is progress, not a retry
                    ecause = fault_cause(e)
                    for rid in ecause.get("rids", ()):
                        self._quarantine(rid, ecause)
                    continue
                attempts += 1
                if attempts > self._retry.max_retries:
                    if tr is not None:
                        tr.engine_end("engine.recover", error="RecoveryError")
                    raise RecoveryError(f"re-prefill recovery failed {attempts} times "
                                        f"(last: {type(e).__name__}: {e})") from e
                self._retry.sleep(self._retry.backoff(attempts))
        self.recoveries += 1
        self._retry_streak = 0
        dt = time.perf_counter() - t0
        reg.counter("serving.faults.recoveries").inc()
        reg.histogram("serving.recovery.duration_s").observe(dt)
        if self._flight is not None:
            self._flight.record("recovered", duration_s=dt,
                                rids=[r.rid for r in self.scheduler.running])
        if tr is not None:
            tr.engine_end("engine.recover", duration_s=dt)

    def _recover_once(self) -> None:
        """One recovery attempt: drop in-flight work, zero the arenas in
        place (allocator state — tables, refcounts, prefix sharing — is
        host-side and survives), restore each generator to its last
        harvest, then replay every resident session's parked tokens and
        every running request's known tokens into their own blocks
        (sessions first: a running sharer then rewrites a co-owned block
        with its own replay).  Requests still waiting on token 0 restart
        their prefill from position 0."""
        self._discard_inflight(cause="replay_recovery")
        self.pool.rebuild_arenas()
        if self.draft_pool is not None:
            self.draft_pool.rebuild_arenas()
        if self._sessions is not None:
            for entry in self._sessions.entries():
                self._replay_seq(entry.tokens, list(entry.blocks), entry.adapter_slot,
                                 len(entry.tokens), cause="replay_recovery")
        for req in list(self.scheduler.running):
            saved = self._gen_states.get(req.rid)
            if saved is not None:
                req.generator.set_state(saved)
            if req.pos and not req.generated:
                req.replay_until = max(req.replay_until, req.pos)
                req.replay_cause = "replay_recovery"
            req.pos = 0
            if req.generated:
                self._replay_request(req)
        if not self.async_step:
            for req in list(self.scheduler.running):
                if req.state == "running" and not req.generated:
                    self._prefill_harvest(self._prefill_dispatch(req))

    def _replay_request(self, req: Request, *, cause: str = "replay_recovery") -> None:
        """Replays ``req``'s prompt and all but its last emitted token into
        its blocks through the sampling-free chunk steps, one bucket-wide
        piece at a time: afterwards the written K/V cover ``[0, prompt_len
        + n - 1)``, the state an uninterrupted run holds before its next
        decode step."""
        n = len(req.generated)
        seq = np.concatenate([req.prompt, np.asarray(req.generated[:n - 1], dtype=np.int32)])
        self._replay_seq(seq, req.block_table, req.adapter_slot, req.prompt_len + n - 1,
                         req=req, cause=cause)

    def _replay_seq(self, seq, block_table, adapter_slot: int, target: int, *,
                    req: Request | None = None, cause: str = "replay_recovery") -> None:
        """The chunk-step replay under :meth:`_replay_request` and the
        resident sessions' recovery: writes K/V for ``seq[:target]`` into
        ``block_table``, one bucket-wide piece at a time (``req``, when
        given, is billed the recomputation and its ``pos`` advanced)."""
        sch, bs = self.scheduler, self.pool.block_size
        seq = np.asarray(seq, dtype=np.int32)
        aligned = [t for t in sch.prefill_buckets if t % bs == 0]
        piece = max(aligned) if aligned else sch.prefill_buckets[-1]
        if self.cfg.learned_pos_embedding:
            # no resumed piece for learned positions (its padding could pass
            # the wpe table); the capped buckets fit the whole sequence
            piece = max(piece, target)
        kind = "spec_prefill_chunk" if self.spec is not None else self._chunk_kind()
        pos = 0
        while pos < target:
            t_disp = time.perf_counter()
            n_real = min(target - pos, piece)
            Tb = sch.prefill_bucket(n_real)
            nbb = self._nbb(max(len(block_table), -(-(pos + Tb) // bs)))
            toks = np.zeros(Tb, dtype=np.int32)
            toks[:n_real] = seq[pos:pos + n_real]
            table, dest = chunk_tables(block_table, pos, Tb, nbb, bs)
            self._chunk_piece(kind, toks, pos, table, dest, adapter_slot)
            if self.spec is None:
                self._note_chunk_attn_step()
            if req is not None:
                req.tokens_recomputed += n_real
                if cause not in req.recompute_causes:
                    req.recompute_causes.append(cause)
            gp = self._goodput
            if gp is not None:
                sunk = self._sunk_positions(block_table, pos, n_real, bs)
                waste = {}
                if Tb > n_real:
                    waste["pad_prefill"] = Tb - n_real
                if sunk:
                    waste["replay_window"] = sunk
                if n_real > sunk:
                    waste[cause] = waste.get(cause, 0) + (n_real - sunk)
                gp.account(kind, 1, Tb, committed=0, **waste)
                gp.note_device_s(kind, time.perf_counter() - t_disp)
            pos += n_real
            if req is not None:
                req.pos = pos
            self.chunk_runs += 1
            registry().counter("serving.steps.prefill_chunk").inc()

    def _discard_inflight(self, cause: str = "dead_scan_row") -> None:
        """Drops every in-flight record (their tokens were never promised)
        and the chained step inputs; the goodput ledger charges a discarded
        decode dispatch's slots to ``cause``."""
        rec, self._inflight_decode = self._inflight_decode, None
        tr = self._tracer
        if rec is not None and tr is not None:
            for r in rec["running"]:
                tr.end(r.rid, "decode", aborted=True)
        gp = self._goodput
        if gp is not None and rec is not None:
            Bb = rec["bucket"][0]
            if rec.get("spec"):
                K = self.spec.K
                gp.account("draft_decode", Bb, K, **{cause: Bb * K})
                gp.account(rec["vkind"], Bb, K + 1, **{cause: Bb * (K + 1)})
            else:
                n = rec.get("multi", 1)
                gp.account(rec["pkind"], Bb, n, **{cause: Bb * n})
        pending, self._inflight_prefill = self._inflight_prefill, []
        if tr is not None:
            for prec in pending:
                tr.end(prec["req"].rid, prec["span"], aborted=True)
        self._decode_state = None
        self._spec_state = None

    #
    # bucket-geometry steps
    #

    def _static_key(self) -> tuple:
        """Everything baked into a bucket step besides its bucket
        dimensions (reference ``engine.py:2514``): the config, block size,
        cache and KV dtypes, temperature, ``quantized``, the LoRA registry's
        geometry, the speculative component, the multi-step horizon (N=1
        collapses to None, so a ``decode_steps=1`` engine keys as a default
        one) and the constraint knob (None when off: an unconstrained
        engine's steps are today's).  :meth:`_program` keys this engine's
        steps on it."""
        return (
            self._cfg_key,
            self.pool.block_size, str(self.pool.dtype), str(self.pool.kv_dtype),
            self.temperature, self.quantized,
            self._registry.geometry if self._registry is not None else None,
            (self.spec.K, str(self.draft_pool.kv_dtype), self._draft_cfg_key)
            if self.spec is not None else None,
            self.n_decode_steps if self.n_decode_steps > 1 else None,
            "constrained" if self._constraints else None,
        )

    def _program(self, kind: str, a: int, b: int) -> tuple[Callable, bool]:
        """The step for bucket geometry ``(kind, a, b)`` under this engine's
        :meth:`_static_key`, and whether this lookup met the geometry for
        the first time.  On the card a kind of ``GRAPH_KINDS`` is a
        :class:`~serving.graphs.StepGraph` (eager at its first call, then
        one replay per call); elsewhere those kinds run their step function
        eagerly.  The steps and the graph's callbacks reach the engine
        through a weak proxy: an engine and its steps form no reference
        cycle, so a dropped engine frees its arenas and its graph pool at
        once."""
        key = (self._static_key(), kind, a, b)
        prog = self._programs.get(key)
        if prog is not None:
            return prog, False
        build = {"prefill": ServingEngine._build_prefill,
                 "prefill_chunk": ServingEngine._build_prefill_chunk,
                 "prefill_chunk_paged": ServingEngine._build_prefill_chunk_paged,
                 "decode": ServingEngine._build_decode,
                 "decode_paged": ServingEngine._build_decode_paged,
                 "decode_multi": ServingEngine._build_decode,
                 "decode_multi_paged": ServingEngine._build_decode_paged,
                 "spec_prefill": spec_lane.build_spec_prefill,
                 "spec_prefill_chunk": spec_lane.build_spec_prefill_chunk,
                 "draft_decode": spec_lane.build_draft_decode,
                 "verify": spec_lane.build_verify,
                 "verify_paged": spec_lane.build_verify_paged}[kind]
        me = weakref.proxy(self)
        fn = build(me, a, b)
        if kind not in GRAPH_KINDS:
            prog = fn
        elif self._graphs:
            prog = StepGraph(fn, kind=kind, bucket=(a, b), device=self.device,
                             pool=self._graph_pool, versions=lambda: me._arena_versions(),
                             on_capture=lambda k: me._note_capture(k))
        else:
            prog = partial(run_eager, fn, device=self.device)
        self.compile_counts[kind] += 1
        self._compile_log.append({"kind": kind, "bucket": [a, b],
                                  "cause": f"new {kind} geometry"})
        registry().counter(f"serving.compiles.{kind}").inc()
        self._programs[key] = prog
        return prog, True

    def _arena_versions(self) -> tuple:
        return (self.pool.arena_version,
                self.draft_pool.arena_version if self.draft_pool is not None else None)

    def _note_capture(self, kind: str) -> None:
        self.captures[kind] += 1
        self._m_captures.inc()

    def _rope_cache(self, nbb: int, *, draft: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
        """Rope rows of the target (or the draft) model for a table of
        ``nbb`` blocks."""
        cap = self.pool.capacity_tokens(nbb)
        if (draft, cap) not in self._rope:
            cfg = self.spec.draft_cfg if draft else self.cfg
            self._rope[draft, cap] = build_rope_cache(cfg, cap, device=self.device)
        return self._rope[draft, cap]

    def _slots(self, reqs, Bb: int) -> np.ndarray | None:
        """(Bb,) adapter slots of ``reqs``; padding rows ride the base slot.
        None without a registry."""
        if self._registry is None:
            return None
        slots = np.zeros(Bb, dtype=np.int32)
        slots[:len(reqs)] = [r.adapter_slot for r in reqs]
        return slots

    def _lora_kwargs(self, slots) -> dict:
        """The LoRA forward kwargs of a step's rows and the registry's
        scaling; none without a registry.  ``slots``: one request's slot
        (an int: a final prefill piece), whose factors are then views of
        the arenas; or a step's device slots, passed with the arenas
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

    def _pick(self, logits, host, cmask=None) -> torch.Tensor:
        """A step's tokens from its (Bb, V) logits, masked by the
        constraint mask ``cmask`` (Bb, V) when the engine is constrained:
        the argmax inside the step when greedy, else the per-row draws at
        the step's ``sample`` host point (the mask applies inside the
        graph segment, before it)."""
        if cmask is not None:
            logits = torch.where(cmask, logits, float("-inf"))
        if self.temperature == 0.0:
            return sample_token(logits, 0.0)
        return host("sample", logits, like=[((logits.shape[0],), torch.int32)])[0]

    def _build_prefill(self, Tb: int, nbb: int) -> Callable:
        """The final prefill piece over the gathered arena: returns token 0
        (drawn under the request's constraint mask ``cmask`` (1, V), when
        given) and the piece's quantization error."""
        cfg, pool, dev = self.cfg, self.pool, self.device
        cos_all, sin_all = self._rope_cache(nbb)

        def prefill(toks, pos, n_real, table, dest, generator, slots, cmask=None):
            t = torch.as_tensor(table, device=dev)[None]
            logits, cache = self._forward(
                self.params, torch.as_tensor(toks, device=dev)[None], pos,
                pool.gather(t), cos_all, sin_all, cfg, **self._fwd_kwargs(slots))
            last = logits[:, n_real - 1]
            if cmask is not None:
                last = torch.where(torch.as_tensor(cmask, device=dev), last, float("-inf"))
            tok = sample_token(last, self.temperature, generator)  # (1,)
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
            _, cache = self._forward(
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
        dense cache and no logits materialize.  Inputs ``toks`` (1, Tb),
        ``pos`` (1,), ``table`` (1, nbb), ``dest`` (nbb,), ``slots`` (1,) or
        None; output the quantization error of a quantized pool."""
        cfg, pool = self.cfg, self.pool
        cos_all, sin_all = self._rope_cache(nbb)

        def prefill_chunk_paged(x, host):
            _, fresh = forward_paged(
                self.params, x["toks"], x["pos"], pool.arenas, x["table"], cos_all, sin_all,
                cfg, cdtype=pool.dtype, head=False, **self._fwd_kwargs(x["slots"]))
            _, qerr = write_fresh_kv_chunk(pool.arenas, fresh, x["dest"], x["pos"],
                                           block_size=pool.block_size,
                                           kv_dtype=pool.quantized_storage)
            return ({"qerr": qerr} if isinstance(qerr, torch.Tensor) else {}), {}

        return prefill_chunk_paged

    def _build_decode(self, Bb: int, nbb: int) -> Callable:
        """Gather decode: the rows' blocks gathered dense, the dense
        forward, the fresh K/V scattered back, one token per row.  Inputs
        ``toks``/``pos``/``slots`` (Bb,), ``tables`` (Bb, nbb); the next
        step's ``toks`` and ``pos`` carry.  One iteration of multi-step
        decode (a visit runs it N times) adds ``stop`` and ``live`` (Bb,)
        bool: a dead row's K/V write goes to the sink block
        (:meth:`_advance`)."""
        cfg, pool, bs = self.cfg, self.pool, self.pool.block_size
        cos_all, sin_all = self._rope_cache(nbb)
        rows = torch.arange(Bb, device=self.device)

        def decode(x, host):
            toks, pos, tables, live = x["toks"], x["pos"], x["tables"], x.get("live")
            p = pos.long()
            col = torch.clamp(p // bs, max=tables.shape[1] - 1)
            dest_block = tables.long().gather(1, col[:, None])[:, 0]
            dest_slot = p % bs
            if live is not None:
                dest_block = torch.where(live, dest_block, SINK_BLOCK)
                dest_slot = torch.where(live, dest_slot, 0)
            logits, cache = self._forward(
                self.params, toks[:, None], pos, pool.gather(tables), cos_all, sin_all,
                cfg, **self._fwd_kwargs(x["slots"]))
            pool.scatter_rows(cache, p, rows, dest_block, dest_slot)
            return self._advance(x, self._pick(logits[:, 0], host, x.get("cmask")))

        return decode

    def _build_decode_paged(self, Bb: int, nbb: int) -> Callable:
        """Paged decode: attention straight off the arenas through the
        ``paged_attn_decode`` kernel, the fresh K/V landed in place by
        ``paged_token_write`` (``paged_token_write_fused`` on a quantized
        pool); no dense cache ever materializes.  Inputs and carry as
        :meth:`_build_decode`'s; with ``live`` (a multi-step iteration) the
        write is ``write_fresh_kv_live``'s: a live row commits at ``pos``,
        a dead row lands in the sink."""
        cfg, pool = self.cfg, self.pool
        cos_all, sin_all = self._rope_cache(nbb)

        def decode_paged(x, host):
            toks, pos, tables, live = x["toks"], x["pos"], x["tables"], x.get("live")
            logits, fresh = forward_paged(self.params, toks[:, None], pos, pool.arenas, tables,
                                          cos_all, sin_all, cfg, cdtype=pool.dtype,
                                          **self._fwd_kwargs(x["slots"]))
            if live is None:
                write_fresh_kv(pool.arenas, fresh, tables, pos, block_size=pool.block_size,
                               kv_dtype=pool.quantized_storage)
            else:
                write_fresh_kv_live(pool.arenas, fresh, tables, pos, live,
                                    block_size=pool.block_size, kv_dtype=pool.quantized_storage)
            return self._advance(x, self._pick(logits[:, 0], host, x.get("cmask")))

        return decode_paged

    def _advance(self, x, nxt):
        """A decode step's outputs and carry from its tokens ``nxt``: the
        next ``toks`` and ``pos``.  A multi-step iteration (``live`` in
        ``x``; reference ``engine.py:2973-2979``) also emits the liveness
        the token was made under; then a live row advances, and dies on
        ``pos >= stop`` or an EOS token; a dead row freezes ``toks`` and
        ``pos``."""
        toks, pos, live = x["toks"], x["pos"], x.get("live")
        if live is None:
            return {"nxt": nxt}, {"toks": nxt, "pos": pos + 1}
        done = pos >= x["stop"]
        if self.eos_id is not None:
            done = done | (nxt == self.eos_id)
        out = {"nxt": nxt, "emit": live.clone()}
        return out, {"toks": torch.where(live, nxt, toks),
                     "pos": torch.where(live, pos + 1, pos), "live": live & ~done}


def serve(model_fn, params, cfg, *, device="cuda", **kwargs):
    """Builds a :class:`ServingEngine` over ``model_fn`` (None: the in-tree
    ``models.generate.forward_with_cache``) on ``device`` (default: the
    card; raises without one unless ``device="cpu"``).  Mesh serving belongs
    to a later slice of the port and raises ``NotImplementedError``.

    ``decode_steps=N`` serves up to N decode tokens per host visit;
    ``fault_plan=``/``retry=``/``watchdog_timeout_s=`` arm the recovery
    layer; ``trace=``, ``slo=``, ``flight_recorder=``, ``goodput=`` and
    ``telemetry=`` the serving observability; ``sessions=``,
    ``priorities=`` and ``constraints=`` the stateful serving (see
    :class:`ServingEngine`).

    ``replicas=N`` (N > 1) returns a
    :class:`~thunder_tpu_torch.serving.router.ReplicatedEngine`: N engines
    on the one device, each with its own arenas and step graphs, behind a
    prefix-affinity router with this API; ``fault_plans=[...]`` (one entry
    per replica) takes the place of the solo ``fault_plan=``."""
    replicas = kwargs.pop("replicas", None)
    fault_plans = kwargs.pop("fault_plans", None)
    if replicas is not None and replicas > 1:
        from thunder_tpu_torch.serving.router import ReplicatedEngine

        return ReplicatedEngine(params, cfg, model_fn=model_fn, replicas=replicas,
                                fault_plans=fault_plans, device=device, **kwargs)
    if fault_plans is not None:
        raise ValueError("fault_plans= is the per-replica form; a solo engine takes fault_plan=")
    return ServingEngine(params, cfg, model_fn=model_fn, device=device, **kwargs)
