"""Paged attention: the serving forward that never densifies the KV.

Counterpart of ``thunder_tpu/serving/paged_attention.py``.
:func:`forward_paged` runs the same per-layer math as
``models.generate.forward_with_cache`` but attention reads K/V directly
from the block arena through the ``executors.cudaex`` kernels, one launch
per layer: ``paged_attn_decode`` for one new token per row (T = 1),
``paged_attn_verify`` for T > 1 (the speculative verify chunk, T = K+1, and
the paged chunked-prefill piece, T = the chunk width).  Quantized arenas
(``k_scale``/``v_scale`` beside int8/fp8 K/V) are dequantized inside those
kernels as each tile loads.  The fresh K/V land in place afterwards:

- :func:`write_fresh_kv` — one decode step, through ``paged_token_write``
  (``paged_token_write_fused`` into a quantized arena);
- :func:`write_fresh_kv_masked` — a verify step's accepted prefix, one
  ``paged_token_write_masked`` (masked ``paged_token_write_fused``) call
  per chunk offset;
- :func:`write_fresh_kv_live` — one multi-step decode iteration, the masked
  write at offset 0 with the per-row liveness as ``n_emit``;
- :func:`write_fresh_kv_chunk` — a prefill chunk, block by block, through
  ``paged_chunk_write`` (``paged_chunk_write_fused``, which also returns
  the quantization error sums).

The ``kv_dtype`` argument of the writers is the pool's storage dtype when
it is quantized and None otherwise, as in the reference; the fused writers
quantize exactly as ``serving.quant.quantize_kv`` does, so the stored bytes
equal the gather path's.

Per-request LoRA factors (``lora=``) add each target's delta next to its
matmul: the qkv and wo deltas go through the ``lora_delta_fused`` kernel
(four launches per layer), while the MLP targets keep the plain delta, as
the reference's ``_mlp`` does.

Parity contract: the kernels score the arena's committed slots and fold
the fresh K/V — cast to the cache dtype, exactly what the dense path would
have just written — as the final online-softmax term, so greedy tokens
match the gather path and solo ``generate()``.
"""
from __future__ import annotations

import torch

from thunder_tpu_torch.executors.cudaex import (
    lora_delta_fused,
    paged_attn_decode,
    paged_attn_verify,
    paged_chunk_write,
    paged_chunk_write_fused,
    paged_kernels_decline,
    paged_token_write,
    paged_token_write_fused,
    paged_token_write_masked,
)
from thunder_tpu_torch.models.generate import (
    _block_tail,
    _embed,
    _head,
    _layer_lora,
    _linear,
    _norm,
    _project_qkv,
)

__all__ = ["forward_paged", "write_fresh_kv", "write_fresh_kv_live", "write_fresh_kv_masked",
           "write_fresh_kv_chunk", "paged_supported"]


def paged_supported(cfg, *, block_size: int, device) -> tuple[bool, str]:
    """Support check for the paged path of a pool of ``block_size`` on
    ``device``: ``(ok, why)``.  Structural on any device; on a CUDA device
    also whether the paged attention kernels hold the config's query heads
    per group, block size and head size (``cudaex.paged_kernels_decline``)
    — the CPU runs the kernels' plain versions, which take any."""
    if cfg.mlp_class == "LLaMAMoE":
        return False, "the LLaMAMoE MLP is not ported yet"
    if torch.device(device).type == "cuda":
        why = paged_kernels_decline(cfg.n_head // cfg.n_query_groups, block_size, cfg.head_size)
        if why:
            return False, why
    return True, ""


def forward_paged(params, idx, pos, arenas, tables, cos_all, sin_all, cfg, *, cdtype,
                  head: bool = True, lora=None, lora_scaling=1.0):
    """Decode/verify/chunk forward straight off the KV block arenas.

    ``idx``: (B, T) tokens at positions ``[pos, pos+T)`` — T = 1 is the
    decode step, T > 1 a verify chunk or a prefill chunk (causal
    intra-chunk mask inside the kernel); ``pos``: (B,) int32;
    ``arenas``: the pool's ``{"k", "v"}``, plus ``{"k_scale", "v_scale"}``
    when quantized; ``tables``: (B, nbb) int32 sink-padded block tables;
    ``cdtype``: the cache compute dtype (fresh K/V are cast to it before
    attending).  ``head=False`` skips the final norm and the vocabulary
    projection (a prefill chunk needs only its K/V) and returns ``None``
    logits.  Returns ``(logits (B, T, V) float32, fresh)`` with ``fresh =
    {"k"/"v": (B, L, ng, hs)}`` for T = 1 or ``(B, L, ng, T, hs)`` for
    T > 1, at ``cdtype``, which the caller persists with one of the
    ``write_fresh_kv*`` functions.  ``lora``/``lora_scaling``: per-request
    factors as ``forward_with_cache`` takes them; the wq/wk/wv/wo deltas
    go through ``cudaex.lora_delta_fused``."""
    B, T = idx.shape
    if T > 1 and cfg.sliding_window is not None:
        raise ValueError("forward_paged: multi-token queries have no sliding-window keep-mask; "
                         "windowed models take the gather path for T > 1")
    hs, nh = cfg.head_size, cfg.n_head
    scales = {"k_scale": arenas.get("k_scale"), "v_scale": arenas.get("v_scale")}
    x, cos_t, sin_t = _embed(params, idx, pos, cos_all, sin_all, cfg)
    fresh_k, fresh_v = [], []
    for l, bp in enumerate(params["blocks"]):
        lora_l = _layer_lora(lora, l)
        n1 = _norm(x, bp["norm_1"], cfg, bp.get("norm_1_b"))
        q, k, v = _project_qkv(bp["attn"], n1, cos_t, sin_t, cfg, lora=lora_l,
                               lora_scaling=lora_scaling, delta_fn=lora_delta_fused)
        if T == 1:
            fk = k[:, :, 0].to(cdtype).contiguous()        # (B, ng, hs)
            fv = v[:, :, 0].to(cdtype).contiguous()
            y = paged_attn_decode(q[:, :, 0].contiguous(), arenas["k"], arenas["v"], fk, fv,
                                  tables, pos, layer=l, window=cfg.sliding_window, **scales)
        else:
            fk = k.to(cdtype).contiguous()                 # (B, ng, T, hs)
            fv = v.to(cdtype).contiguous()
            y = paged_attn_verify(q.contiguous(), arenas["k"], arenas["v"], fk, fv,
                                  tables, pos, layer=l, **scales)    # (B, nh, T, hs)
            y = y.transpose(1, 2)
        y = y.reshape(B, T, nh * hs)
        h = _linear(y, bp["attn"]["wo"], bp["attn"].get("bo"))
        if lora_l is not None and "wo" in lora_l:
            h = h + lora_delta_fused(y, *lora_l["wo"], lora_scaling)
        fresh_k.append(fk)
        fresh_v.append(fv)
        x = _block_tail(bp, x, n1, h, cfg, lora=lora_l, lora_scaling=lora_scaling)
    logits = _head(params, x, cfg) if head else None
    return logits, {"k": torch.stack(fresh_k, dim=1), "v": torch.stack(fresh_v, dim=1)}


def write_fresh_kv(arenas, fresh, tables, pos, *, block_size: int, kv_dtype=None):
    """Lands one decode step's fresh K/V (``{"k"/"v": (B, L, ng, hs)}`` at
    the compute dtype) in the arenas, in place; padding rows land in sink
    block 0.  ``kv_dtype``: the storage dtype of a quantized pool (the
    fused writer quantizes on the way), None otherwise."""
    for name in ("k", "v"):
        if kv_dtype is None:
            paged_token_write(arenas[name], fresh[name], tables, pos, block_size=block_size)
        else:
            paged_token_write_fused(arenas[name], arenas[name + "_scale"], fresh[name], tables,
                                    pos, block_size=block_size)
    return arenas


def _write_masked(arenas, vals: dict, tables, pos, n_emit, offset: int, *, block_size: int,
                  kv_dtype) -> None:
    for name in ("k", "v"):
        if kv_dtype is None:
            paged_token_write_masked(arenas[name], vals[name], tables, pos, n_emit, offset,
                                     block_size=block_size)
        else:
            paged_token_write_fused(arenas[name], arenas[name + "_scale"], vals[name], tables,
                                    pos, block_size=block_size, n_emit=n_emit, offset=offset)


def write_fresh_kv_masked(arenas, fresh, tables, pos, n_emit, *, block_size: int,
                          kv_dtype=None):
    """Lands a verify step's accepted prefix in the arenas, in place.

    ``fresh``: ``{"k"/"v": (B, L, ng, T, hs)}`` from a T = K+1
    :func:`forward_paged` call; ``n_emit``: (B,) int32 accepted counts.
    Offset ``k`` of row ``i`` lands at ``pos[i] + k`` iff ``k < n_emit[i]``;
    the rest go to the sink, so rejected drafts leave no trace and the next
    round derives them again.  Quantized pools (``kv_dtype``) take the
    masked fused write per offset."""
    for k in range(fresh["k"].shape[3]):
        _write_masked(arenas, {n: fresh[n][:, :, :, k].contiguous() for n in ("k", "v")},
                      tables, pos, n_emit, k, block_size=block_size, kv_dtype=kv_dtype)
    return arenas


def write_fresh_kv_live(arenas, fresh, tables, pos, live, *, block_size: int, kv_dtype=None):
    """Lands one multi-step decode iteration's fresh K/V
    (``{"k"/"v": (B, L, ng, hs)}``), keep-masked by the per-row liveness
    ``live`` (B,) bool: a live row commits at ``pos`` exactly like
    :func:`write_fresh_kv`, a dead row (finished earlier, or batch padding)
    lands in the sink.  An offset-0 masked write with ``n_emit = live``."""
    _write_masked(arenas, fresh, tables, pos, live.to(torch.int32), 0, block_size=block_size,
                  kv_dtype=kv_dtype)
    return arenas


def _chunk_blocks(x, bs: int):
    """(1, L, ng, T, hs) chunk-fresh layout → (T // bs, L, ng, bs, hs)
    block granules for the chunk writer (a transpose, made contiguous)."""
    _, L, ng, T, hs = x.shape
    return x[0].reshape(L, ng, T // bs, bs, hs).permute(2, 0, 1, 3, 4).contiguous()


def write_fresh_kv_chunk(arenas, fresh, dest, pos, *, block_size: int, kv_dtype=None):
    """Lands one chunked-prefill piece's K/V in the arenas, block by block,
    in place.

    ``fresh``: ``{"k"/"v": (1, L, ng, T, hs)}`` from a T = chunk-width
    :func:`forward_paged` call (T a multiple of ``block_size``); ``dest``:
    (nbb,) int32 scatter table from ``kv_pool.chunk_tables`` (sink outside
    the chunk's own blocks); ``pos``: (1,) int32 block-aligned chunk start.
    Chunk block ``c`` lands as one (L, ng, bs, hs) slab at
    ``dest[pos // bs + c]``; quantized pools (``kv_dtype``) take the fused
    writer.  Returns ``(arenas, qerr)``: ``qerr`` is ``0.5 * (k_rel +
    v_rel)``, each ``rel = sum|dq - x| / (sum|x| + 1e-30)`` over the blocks
    actually written (a float32 scalar tensor on the arenas' device), the
    figure the gather chunk step reports; the float 0.0 unquantized."""
    rels = []
    for name in ("k", "v"):
        vals = _chunk_blocks(fresh[name], block_size)
        if kv_dtype is None:
            paged_chunk_write(arenas[name], vals.to(arenas[name].dtype), dest, pos,
                              block_size=block_size)
            continue
        _, _, err = paged_chunk_write_fused(arenas[name], arenas[name + "_scale"], vals, dest,
                                            pos, block_size=block_size)
        rels.append(err[:, 0].sum() / (err[:, 1].sum() + 1e-30))
    if not rels:
        return arenas, 0.0
    return arenas, 0.5 * (rels[0] + rels[1])
