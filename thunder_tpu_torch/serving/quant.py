"""Quantized (int8 / fp8-e4m3) KV block storage for the paged serving pool.

Counterpart of ``thunder_tpu/serving/quant.py``.  With
``serve(..., kv_dtype="int8"|"fp8")`` the K/V arenas store one byte per
value — ``int8`` (symmetric absmax) or ``float8_e4m3fn`` (absmax scaled
onto the e4m3 range) — with a float32 scale arena beside each, one scale
per ``(block, layer, kv_group, slot)``: the absmax over the ``head_size``
values of one token's K (or V) for one KV group.

- :func:`quantize_kv` is per token, so a request's stored KV never depends
  on what shares its batch;
- :func:`scatter_token_q` / :func:`scatter_blocks_q` quantize on write (the
  exact K/V a step computed, never a dequantized round trip);
- :func:`gather_dense_q` dequantizes back into the dense
  ``forward_with_cache`` layout, in the pool's compute dtype.

These are plain PyTorch, as the reference's are plain jnp, and they are
also the plain versions of the fused write kernels
(``executors.cudaex.paged_token_write_fused`` / ``paged_chunk_write_fused``)
and of the dequantizing loads inside ``paged_attn_decode`` /
``paged_attn_verify``.

Numerics, bit for bit with the reference as its programs run: the scale is
``amax * f32(1/qmax)`` — every jitted program of the reference, and its
Pallas kernels run interpreted, compile the division by the constant
``qmax`` into that multiply (XLA rewrites a division by a constant) — and
the values are ``x / scale`` (an IEEE division), then rounded half to even
and clipped to ±127 (int8) or cast to e4m3 (fp8; the scaled absmax lands on
±448·(1±ε), inside the range where every implementation rounds to nearest
even and none saturates or overflows differently).

Capacity: a stored slot-head costs ``hs`` bytes plus 4 bytes of scale
instead of ``hs * itemsize`` (:func:`arena_block_bytes`); int8 and fp8 cost
the same bytes and differ only in error shape.
"""
from __future__ import annotations

import numpy as np
import torch

from thunder_tpu_torch.models.generate import kv_block_shape

__all__ = [
    "QUANTIZED_DTYPES",
    "as_bytes",
    "inv_qmax",
    "resolve_kv_dtype",
    "is_quantized_kv",
    "quantize_kv",
    "dequantize_kv",
    "gather_dense_q",
    "scatter_token_q",
    "scatter_blocks_q",
    "arena_block_bytes",
    "blocks_for_arena_bytes",
]

_SINK = 0  # kv_pool.SINK_BLOCK (not imported: kv_pool imports this module)

_FP8 = torch.float8_e4m3fn
_FP8_ALIASES = ("fp8", "e4m3", "float8_e4m3fn")
QUANTIZED_DTYPES = (torch.int8, _FP8)


def _qmax(storage) -> float:
    """Largest representable magnitude of a quantized storage dtype — the
    absmax scale divisor (127 for int8, 448 for fp8 e4m3)."""
    return 127.0 if storage == torch.int8 else float(torch.finfo(storage).max)


def inv_qmax(storage) -> float:
    """``f32(1/qmax)``: the factor the scale is computed with (the
    reference's programs multiply by it in place of dividing by ``qmax``)."""
    return float(np.float32(1.0) / np.float32(_qmax(storage)))


def _as_dtype(kv_dtype) -> torch.dtype | None:
    if isinstance(kv_dtype, torch.dtype):
        return kv_dtype
    if isinstance(kv_dtype, str):
        found = getattr(torch, kv_dtype.lower(), None)
        return found if isinstance(found, torch.dtype) else None
    return None


def resolve_kv_dtype(kv_dtype, dtype) -> torch.dtype:
    """Storage dtype of the block arenas: ``None`` stores at the compute
    ``dtype``; ``"int8"``/``torch.int8`` selects int8 storage;
    ``"fp8"``/``"e4m3"``/``"float8_e4m3fn"``/``torch.float8_e4m3fn`` the
    fp8 one.  Any other storage dtype is rejected — a silent float
    truncation is what this module replaces."""
    if kv_dtype is None:
        return dtype
    if isinstance(kv_dtype, str) and kv_dtype.lower() in _FP8_ALIASES:
        return _FP8
    kd = _as_dtype(kv_dtype)
    if kd in QUANTIZED_DTYPES or kd == dtype:
        return kd
    raise ValueError(
        f"unsupported kv_dtype {kv_dtype!r}: use None (store at the compute "
        f"dtype {dtype}), 'int8', or 'fp8' (quantized block storage)"
    )


def is_quantized_kv(kv_dtype, dtype) -> bool:
    """Whether a resolved storage dtype takes the quantize/scale-arena path
    (1-byte storage that is not the compute dtype itself)."""
    return kv_dtype != dtype and kv_dtype in QUANTIZED_DTYPES


def quantize_kv(x, storage=torch.int8):
    """Symmetric absmax quantization over the last (``hs``) dim into
    ``storage`` (int8: round half to even and clip to ±127; fp8 e4m3: scale
    the absmax onto ±448 and let the cast round).

    Returns ``(q, scale)``: ``q`` in ``storage`` shaped like ``x``,
    ``scale`` float32 shaped ``x.shape[:-1]``.  All-zero rows get scale 1.0
    (exact)."""
    qmax = _qmax(storage)
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.where(amax == 0.0, torch.ones_like(amax), amax * inv_qmax(storage))
    y = xf / scale[..., None]
    if storage == torch.int8:
        q = torch.clamp(torch.round(y), -qmax, qmax).to(storage)
    else:
        q = y.to(storage)
    return q, scale


def dequantize_kv(q, scale, dtype=torch.float32):
    """Inverse of :func:`quantize_kv` (up to rounding)."""
    return (q.float() * scale[..., None]).to(dtype)


def as_bytes(t: torch.Tensor) -> torch.Tensor:
    """A 1-byte arena viewed as ``uint8``: the moves of fp8 storage go
    through its bytes, since not every PyTorch op takes fp8 tensors."""
    return t.view(torch.uint8) if t.dtype == _FP8 else t


def gather_dense_q(k_arena, v_arena, k_scale, v_scale, tables, dtype):
    """Quantized twin of :func:`kv_pool.gather_dense`: reassembles dense
    caches from quantized block arenas, dequantizing into ``dtype``.

    ``tables``: (B, nb) int physical-block ids (sink-padded).  Returns
    ``k, v`` of shape (L, B, ng, nb*bs, hs) — new tensors in the layout
    ``forward_with_cache`` consumes."""
    idx = tables.long()

    def one(arena, scale):
        g = as_bytes(arena)[idx].view(arena.dtype)       # (B, nb, L, ng, bs, hs)
        x = g.float() * scale[idx][..., None]
        x = x.permute(2, 0, 3, 1, 4, 5)                  # (L, B, ng, nb, bs, hs)
        L, B, ng, nb, bs, hs = x.shape
        return x.reshape(L, B, ng, nb * bs, hs).to(dtype)

    return one(k_arena, k_scale), one(v_arena, v_scale)


def scatter_token_q(arena, scale_arena, new_kv, dest_block, dest_slot):
    """Quantized twin of :func:`kv_pool.scatter_token`: quantizes one
    token's K (or V) per batch row and writes value and scale, in place.

    ``new_kv``: (B, L, ng, hs) at the compute dtype; ``dest_block``/
    ``dest_slot``: (B,) integer tensors (sink-routed for padding rows).  The
    storage dtype comes from the arena.  Returns ``(arena, scale_arena)``."""
    q, s = quantize_kv(new_kv, arena.dtype)            # (B, L, ng, hs) / (B, L, ng)
    blk, slot = dest_block.long(), dest_slot.long()
    as_bytes(arena)[blk, :, :, slot, :] = as_bytes(q)
    scale_arena[blk, :, :, slot] = s
    return arena, scale_arena


def scatter_blocks_q(arena, scale_arena, dense, dest_table):
    """Quantized twin of :func:`kv_pool.scatter_blocks`: quantizes a
    request's dense cache block by block and writes values and scales, in
    place.

    ``dense``: (L, 1, ng, nb*bs, hs) float (B=1 prefill layout);
    ``dest_table``: (nb,) integer tensor — sink entries absorb padding.
    Returns ``(arena, scale_arena, rel_err)``: ``rel_err`` (a float32
    scalar tensor) is ``sum|dq - x| / sum|x|`` over the blocks actually
    written (non-sink), the value behind the ``serving.kv_quant.rel_err``
    gauge."""
    if not dense.is_floating_point():
        from thunder_tpu_torch.serving.kv_pool import ArenaMismatchError

        raise ArenaMismatchError(
            "scatter", "dtype", "floating source", dense.dtype,
            msg=f"scatter_blocks_q quantizes a float dense cache into a "
                f"quantized arena; got source dtype {dense.dtype}",
        )
    L, _, ng, cap, hs = dense.shape
    bs = arena.shape[3]
    blocks = dense[:, 0].reshape(L, ng, cap // bs, bs, hs).permute(2, 0, 1, 3, 4)
    q, s = quantize_kv(blocks, arena.dtype)            # (nb, L, ng, bs, hs) / (nb, L, ng, bs)
    dq = q.float() * s[..., None]
    xf = blocks.float()
    m = (dest_table != _SINK).float()[:, None, None, None, None]
    rel_err = ((dq - xf).abs() * m).sum() / ((xf.abs() * m).sum() + 1e-30)
    d = dest_table.long()
    as_bytes(arena)[d] = as_bytes(q)
    scale_arena[d] = s
    return arena, scale_arena, rel_err


#
# capacity math (host-side; admission accounting in bytes)
#


def arena_block_bytes(cfg, block_size: int, dtype, kv_dtype=None) -> int:
    """Bytes ONE pool block costs across both (K+V) arenas, including the
    scale arenas on the quantized path — the unit of byte-based capacity
    math (equal-byte pools are sized with it)."""
    L, ng, bs, hs = kv_block_shape(cfg, block_size)
    storage = resolve_kv_dtype(kv_dtype, dtype)
    per_side = L * ng * bs * hs * torch.empty((), dtype=storage).element_size()
    if is_quantized_kv(storage, dtype):
        per_side += L * ng * bs * 4                    # float32 scale per slot-head
    return 2 * per_side


def blocks_for_arena_bytes(cfg, block_size: int, budget_bytes: int, dtype,
                           kv_dtype=None) -> int:
    """Total blocks (sink included) an arena-byte budget affords — the
    equal-bytes pool sizing."""
    bb = arena_block_bytes(cfg, block_size, dtype, kv_dtype)
    return max(int(budget_bytes) // bb, 2)
