"""Speculative continuous batching: a draft/verify lane over the paged arena.

Counterpart of ``thunder_tpu/serving/speculative.py``.
``serve(..., speculative=SpecConfig(draft_params, draft_cfg, K=4))`` adds a
second, cheaper proposal model to the engine.  Each decode-lane turn then
runs two bucket steps instead of one:

- ``draft_decode`` — K+1 chained single-token forwards of the draft model
  over its gathered dense cache (the solo ``speculative_generate`` draft
  loop), reading and writing a draft KV block arena that sits beside the
  target arena: its own ``PagedKVPool`` storage, but indexed by the target
  pool's block tables — block ids are leased once per request and index
  both arenas, so the allocator and the prefix index stay single;
- ``verify`` / ``verify_paged`` — one target forward over the K+1 query
  positions ``[cur, d_1..d_K]``, the rejection rule of
  ``models.speculative``, and a keep-masked commit that writes only the
  accepted prefix's K/V into the target arena (rejected offsets go to the
  sink).  ``verify_paged`` runs the ``paged_attn_verify`` kernel and the
  ``paged_token_write_masked`` commit (the masked ``paged_token_write_fused``
  on a quantized pool); ``verify`` gathers and scatters.

Quantized KV: the draft arena stores ``SpecConfig.draft_kv_dtype``, or the
target's ``kv_dtype`` when that is None; the gathered steps dequantize on
gather and quantize on scatter (``serving.quant``).

Reproducibility: each request draws from its own ``torch.Generator`` in the
solo order (K+1 draft draws, K uniforms, one residual draw per round; none
when greedy), so a request's tokens do not depend on what shares its batch
and equal solo ``speculative_generate`` at B = 1.

Emission is variable-rate: a round emits ``n_emit`` in [1, K+1] tokens per
row, harvested in order through the engine's ``_emit_token``; an EOS or the
length limit can land mid-round, and the surplus is dropped.  While the
batch is unchanged, the next round's inputs are the previous round's device
outputs ``(y, pos + n_emit)``.

The prefill of a speculative engine runs both models over the gathered
arenas (``spec_prefill``, and ``spec_prefill_chunk`` for intermediate
chunks).

LoRA rides the target only (reference ``serving/speculative.py:268-270``):
the target's prefill, chunk and verify steps take each row's adapter
factors (``verify_paged`` through the ``lora_delta_fused`` kernel), the
draft proposes with the base model, and the rejection rule corrects the
mismatch, so greedy tokens equal the LoRA engine's plain decode.  The fault points of the JAX module wait for ``serving/faults.py``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from thunder_tpu_torch.models.generate import forward_with_cache, sample_token
from thunder_tpu_torch.models.speculative import (
    accept_tokens,
    emitted_tokens,
    greedy_acceptance,
)
from thunder_tpu_torch.serving.kv_pool import SINK_BLOCK
from thunder_tpu_torch.serving.paged_attention import forward_paged, write_fresh_kv_masked

__all__ = ["SpecConfig", "multi_step_supported", "validate_spec"]


@dataclass
class SpecConfig:
    """Speculative-serving knob for ``serve``.

    ``draft_params``/``draft_cfg``: the small proposal model, on the
    engine's device (it must share the target's padded vocabulary).  ``K``:
    drafted tokens per round — a round costs K+1 draft forwards plus one
    (K+1)-position target verify, and emits 1..K+1 tokens.
    ``draft_kv_dtype``: the draft arena's storage (``"int8"``/``"fp8"``,
    or the compute dtype); None inherits the engine's ``kv_dtype``."""

    draft_params: Any
    draft_cfg: Any
    K: int = 4
    draft_kv_dtype: Any = None


def validate_spec(spec: SpecConfig, cfg, *, device: torch.device) -> None:
    """Engine-construction validation, before any allocation."""
    if not isinstance(spec, SpecConfig):
        raise TypeError(f"speculative= expects SpecConfig, got {type(spec).__name__}")
    if spec.K < 1:
        raise ValueError(f"SpecConfig.K must be >= 1, got {spec.K}")
    dcfg = spec.draft_cfg
    if dcfg.padded_vocab_size != cfg.padded_vocab_size:
        raise ValueError(
            "speculative serving needs a shared tokenizer: draft "
            f"padded_vocab_size={dcfg.padded_vocab_size} != target {cfg.padded_vocab_size}")
    if cfg.sliding_window is not None or dcfg.sliding_window is not None:
        raise ValueError(
            "speculative serving does not support sliding-window engines: window expiry "
            "would invalidate the K-token draft/verify arena math (solo "
            "speculative_generate has the same restriction)")
    if dcfg.mlp_class == "LLaMAMoE" or dcfg.learned_pos_embedding:
        raise NotImplementedError("SpecConfig: MoE and learned_pos_embedding drafts are not "
                                  "ported yet")
    if spec.draft_params["wte"].device.type != device.type:
        raise ValueError(f"draft params live on {spec.draft_params['wte'].device}, "
                         f"the engine on {device}")


def multi_step_supported(spec: SpecConfig) -> tuple[bool, str | None]:
    """Whether the speculative lane can chain rounds behind
    ``decode_steps=N``: never, for the reason returned (the engine rejects
    the combination at construction with it)."""
    return False, (
        "a speculative round emits a data-dependent 1..K+1 tokens per host "
        "visit; chaining N rounds needs ragged outputs and acceptance "
        "accounting that lives on the host (the spec lane already amortizes "
        "host visits over accepted tokens)"
    )


#
# bucket-step builders (called from ServingEngine._program)
#


def _prefill_both(eng, nbb: int):
    """The shared body of the two prefill kinds: both models over their
    gathered arenas, both caches scattered back through the same dest
    table (shared block ids).  Returns the target logits and the target
    pool's quantization error over the blocks written."""
    cfg, dcfg, dev = eng.cfg, eng.spec.draft_cfg, eng.device
    cos, sin = eng._rope_cache(nbb)
    cos_d, sin_d = eng._rope_cache(nbb, draft=True)
    pools = ((eng.pool, eng.params, cfg, cos, sin),
             (eng.draft_pool, eng.spec.draft_params, dcfg, cos_d, sin_d))

    def run(toks, pos, table, dest, slots):
        idx = torch.as_tensor(toks, device=dev)[None]
        t = torch.as_tensor(table, device=dev)[None]
        d = torch.as_tensor(dest, device=dev)
        out = None
        for pool, params, c, co, si in pools:
            kw = eng._lora_kwargs(slots) if out is None else {}   # the target only
            lg, cache = forward_with_cache(params, idx, pos, pool.gather(t), co, si, c, **kw)
            qerr = pool.scatter_dense(cache, d)
            out = (lg, qerr) if out is None else out
        return out

    return run


def build_spec_prefill(eng, Tb: int, nbb: int):
    """The final prefill piece of a speculative engine: both arenas
    written, token 0 drawn from the target's logits."""
    run = _prefill_both(eng, nbb)

    def spec_prefill(toks, pos, n_real, table, dest, generator, slots):
        logits, qerr = run(toks, pos, table, dest, slots)
        return sample_token(logits[:, n_real - 1], eng.temperature, generator), qerr  # (1,)

    return spec_prefill


def build_spec_prefill_chunk(eng, Tb: int, nbb: int):
    """An intermediate chunk of a speculative engine: K/V into both
    arenas, no sampling."""
    run = _prefill_both(eng, nbb)

    def spec_prefill_chunk(toks, pos, table, dest, slots):
        return run(toks, pos, table, dest, slots)[1]

    return spec_prefill_chunk


def build_draft_decode(eng, Bb: int, nbb: int):
    """K+1 chained single-token draft forwards over the gathered draft
    arena, then every one of the K+1 fresh draft K/V scattered back.  The
    (K+1)-th forward consumes d_K and writes its K/V at pos+K, so a fully
    accepted round leaves no unwritten slot in the draft cache.  Returns
    ``(drafts (Bb, K), q_rows (Bb, K, V) or None when greedy)``."""
    dcfg, dpool = eng.spec.draft_cfg, eng.draft_pool
    K, temp, bs = eng.spec.K, eng.temperature, dpool.block_size
    cos_d, sin_d = eng._rope_cache(nbb, draft=True)
    rows = torch.arange(Bb, device=eng.device)

    def draft_decode(toks, pos, tables, generators):
        dc = dpool.gather(tables)
        tok, dpos, outs, qs = toks, pos, [], []
        for _ in range(K + 1):
            dl, dc = forward_with_cache(eng.spec.draft_params, tok[:, None], dpos, dc,
                                        cos_d, sin_d, dcfg)
            row = dl[:, -1]
            tok = eng._sample_rows(row, generators)
            outs.append(tok)
            if temp != 0.0:
                qs.append(torch.softmax(row / temp, dim=-1))
            dpos = dpos + 1
        for k in range(K + 1):
            p_k = (pos + k).long()
            col = torch.clamp(p_k // bs, max=nbb - 1)
            blk = tables.long().gather(1, col[:, None])[:, 0]
            dpool.scatter_rows(dc, p_k, rows, blk, p_k % bs)
        drafts = torch.stack(outs[:K], dim=1)
        return drafts, (torch.stack(qs[:K], dim=1) if qs else None)

    return draft_decode


def _accept(eng, tlogits, drafts, q_rows, generators):
    """The rejection rule per row: greedy over the whole batch, or speculative
    sampling from each live row's own generator (padding rows emit 0).
    Returns ``(emitted (Bb, K+1), n_emit (Bb,) int32, y (Bb,))``."""
    if eng.temperature == 0.0:
        m, y = greedy_acceptance(tlogits, drafts)
    else:
        p_all = torch.softmax(tlogits / eng.temperature, dim=-1)
        Bb = drafts.shape[0]
        m = torch.zeros(Bb, dtype=torch.int64, device=drafts.device)
        y = torch.zeros(Bb, dtype=torch.int32, device=drafts.device)
        for i, g in enumerate(generators):
            m[i], y[i] = accept_tokens(g, drafts[i], p_all[i], q_rows[i])
    return emitted_tokens(drafts, m, y), (m + 1).to(torch.int32), y.to(torch.int32)


def build_verify(eng, Bb: int, nbb: int):
    """One target forward over the K+1 chunk on the gathered arena, the
    rejection rule, and a keep-masked scatter: offset k lands at pos + k
    iff k < n_emit, else in the sink."""
    cfg, pool, K, bs = eng.cfg, eng.pool, eng.spec.K, eng.pool.block_size
    cos, sin = eng._rope_cache(nbb)
    rows = torch.arange(Bb, device=eng.device)

    def verify(toks, pos, tables, drafts, q_rows, generators, slots):
        chunk = torch.cat([toks[:, None], drafts], dim=1)
        tlogits, cache = forward_with_cache(eng.params, chunk, pos, pool.gather(tables),
                                            cos, sin, cfg, **eng._lora_kwargs(slots))
        emitted, n_emit, y = _accept(eng, tlogits, drafts, q_rows, generators)
        for k in range(K + 1):
            p_k = (pos + k).long()
            live = k < n_emit
            col = torch.clamp(p_k // bs, max=nbb - 1)
            blk = torch.where(live, tables.long().gather(1, col[:, None])[:, 0], SINK_BLOCK)
            slot = torch.where(live, p_k % bs, 0)
            pool.scatter_rows(cache, p_k, rows, blk, slot)
        return emitted, n_emit, y

    return verify


def build_verify_paged(eng, Bb: int, nbb: int):
    """The kernel twin of :func:`build_verify`: attention straight off the
    arena through ``paged_attn_verify`` (T = K+1, causal intra-chunk mask in
    the kernel), the accepted prefix committed by
    ``paged_token_write_masked`` (the masked ``paged_token_write_fused`` on
    a quantized pool); no dense cache materializes."""
    cfg, pool = eng.cfg, eng.pool
    cos, sin = eng._rope_cache(nbb)

    def verify_paged(toks, pos, tables, drafts, q_rows, generators, slots):
        chunk = torch.cat([toks[:, None], drafts], dim=1)
        tlogits, fresh = forward_paged(eng.params, chunk, pos, pool.arenas, tables, cos, sin,
                                       cfg, cdtype=pool.dtype, **eng._lora_kwargs(slots))
        emitted, n_emit, y = _accept(eng, tlogits, drafts, q_rows, generators)
        write_fresh_kv_masked(pool.arenas, fresh, tables, pos, n_emit,
                              block_size=pool.block_size, kv_dtype=pool.quantized_storage)
        return emitted, n_emit, y

    return verify_paged


#
# the speculative decode lane (dispatch/harvest halves; the engine calls in)
#


def spec_decode_dispatch(eng) -> dict:
    """One speculative round for the decode-ready batch: draft step, then
    verify step.  While the batch and tables are unchanged, the round's
    inputs are the previous round's device outputs (``toks = y``, ``pos +
    n_emit``); ``host_pos`` advances at harvest."""
    sch, dev = eng.scheduler, eng.device
    running = sch.decode_ready() if eng.async_step else list(sch.running)
    Bb, nbb_raw = sch.decode_bucket(running)
    nbb = eng._nbb(nbb_raw)
    sig = (tuple(r.rid for r in running), Bb, nbb)
    st = eng._spec_state
    if st is not None and st["sig"] == sig:
        toks_d, pos_d, tables_d, slots_d = st["toks"], st["pos"], st["tables"], st["slots"]
        host_pos = st["host_pos"]
    else:
        toks = np.zeros(Bb, dtype=np.int32)
        host_pos = np.zeros(Bb, dtype=np.int32)
        tables = np.full((Bb, nbb), SINK_BLOCK, dtype=np.int32)
        for i, r in enumerate(running):
            toks[i] = r.generated[-1]
            host_pos[i] = r.prompt_len + len(r.generated) - 1   # slot cur's K/V lands in
            tables[i, : len(r.block_table)] = r.block_table
        toks_d = torch.as_tensor(toks, device=dev)
        pos_d = torch.as_tensor(host_pos, device=dev)
        tables_d = torch.as_tensor(tables, device=dev)
        slots_d = eng._slots(running, Bb)
    generators = [r.generator for r in running]
    draft, _ = eng._program("draft_decode", Bb, nbb)
    drafts, q_rows = draft(toks_d, pos_d, tables_d, generators)
    vkind = "verify_paged" if eng.attn == "paged" else "verify"
    verify, _ = eng._program(vkind, Bb, nbb)
    if eng.attn == "paged":
        eng.attn_kernel_steps += 1
        eng._m_attn_kernel.inc()
    emitted, n_emit, y = verify(toks_d, pos_d, tables_d, drafts, q_rows, generators, slots_d)
    eng._spec_state = {"sig": sig, "toks": y, "pos": pos_d + n_emit, "tables": tables_d,
                       "slots": slots_d, "host_pos": host_pos}
    eng.decode_steps += 1
    eng.spec_rounds += 1
    eng._occupancy_sum += len(running)
    eng._m_steps_decode.inc()
    eng._m_spec_rounds.inc()
    eng._m_occupancy.observe(len(running))
    return {"spec": True, "running": running, "emitted": emitted, "n_emit": n_emit,
            "pos": host_pos, "t_disp": time.perf_counter()}


def spec_decode_harvest(eng, rec: dict) -> None:
    """Materializes one round: per live row, advance the position by the
    row's own ``n_emit`` and emit the accepted prefix plus the correction
    token in order (an EOS or the length limit drops the rest).  Feeds the
    ``serving.spec.accept_len`` histogram and the accepted/drafted
    counters."""
    t0 = time.perf_counter()
    emitted = rec["emitted"].cpu().numpy()             # the host block
    n_emit = rec["n_emit"].cpu().numpy()
    eng._note_stall(t0, rec["t_disp"])
    K = eng.spec.K
    pos = rec["pos"]
    count = 0
    invalidate = False
    for i, r in enumerate(rec["running"]):
        if r.state != "running":
            invalidate = True                          # finished mid-flight
            continue
        ne = int(n_emit[i])
        r.pos = int(pos[i]) + ne
        eng._spec_accept_hist[ne - 1] += 1
        eng.spec_draft_tokens += K
        eng.spec_accepted_tokens += ne - 1
        eng._m_spec_accept_len.observe(ne)
        if ne > 1:
            eng._m_spec_accepted.inc(ne - 1)
        for k in range(ne):
            count += 1
            eng._emit_token(r, int(emitted[i, k]))
            if r.state != "running":
                invalidate = True                      # EOS/length mid-round
                break
    eng.tokens_generated += count
    eng.host_visits += 1
    eng._m_host_visits.inc()
    if count:
        eng._m_tokens.inc(count)
    if invalidate:
        eng._spec_state = None
    elif eng._spec_state is not None:
        # the device chain already carries pos + n_emit; mirror it on the
        # host (a new array: rec["pos"] keeps the dispatch's view)
        eng._spec_state["host_pos"] = eng._spec_state["host_pos"] + n_emit
