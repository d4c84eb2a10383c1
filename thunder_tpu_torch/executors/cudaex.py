"""Kernel wrappers for the port's hand-written CUDA kernels.

Counterpart of ``thunder_tpu/executors/pallasex.py`` for the five kernels
of the serving paths:

- :func:`paged_attn_decode` replaces ``pallasex.paged_attn_decode``
  (``pallasex.py:1165``): single-token attention straight off the KV block
  arena, one layer;
- :func:`paged_token_write` replaces ``pallasex.paged_token_write``
  (``pallasex.py:1249``): in-place write of each request's fresh K/V;
- :func:`paged_attn_verify` replaces ``pallasex.paged_attn_verify``
  (``pallasex.py:1376``): T queries per request off the arena, the chunk's
  own K/V folded last under a causal mask (speculative verify, paged
  chunked prefill);
- :func:`paged_chunk_write` replaces ``pallasex.paged_chunk_write``
  (``pallasex.py:1535``): a prefill chunk's K/V landed block by block;
- :func:`paged_token_write_masked` replaces
  ``pallasex.paged_token_write_masked`` (``pallasex.py:1462``): one chunk
  offset's K/V landed where the offset was accepted, else in the sink;

and for the three kernels of a training step:

- :func:`flash_sdpa` replaces ``pallasex.flash_sdpa`` (``pallasex.py:711``,
  ``_flash_fwd`` :293): blockwise flash attention, out and f32 lse;
- :func:`flash_sdpa_backward` replaces ``pallasex.flash_sdpa_backward``
  (``pallasex.py:739``, ``_flash_bwd`` :460): the dq kernel and the dk/dv
  kernel (two launches, counted as ``flash_bwd_dq`` and ``flash_bwd_dkv``).

Each wrapper checks device, dtype, shape and contiguity, then routes by the
device of its tensors: CPU tensors run the plain PyTorch version beside it
(``*_plain``, the same arithmetic, which the CPU tests hold against the
Pallas kernels); CUDA tensors launch the kernel from
``thunder_tpu_torch/csrc/`` (``paged_attention.cu``, ``paged_verify.cu``,
``flash_attention.cu``) on the current stream or raise — there is no
fallback.  ``LAUNCHES`` counts kernel launches, one per kernel a wrapper
call launched, so a run can show that its main path went through the
kernels.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from thunder_tpu_torch.executors import _build

__all__ = [
    "LAUNCHES",
    "MASK_VALUE",
    "causal_keep",
    "flash_sdpa",
    "flash_sdpa_backward",
    "flash_sdpa_backward_plain",
    "flash_sdpa_plain",
    "flash_supported",
    "paged_attn_decode",
    "paged_attn_decode_plain",
    "paged_attn_verify",
    "paged_attn_verify_plain",
    "paged_available",
    "paged_chunk_write",
    "paged_chunk_write_plain",
    "paged_token_write",
    "paged_token_write_masked",
    "paged_token_write_masked_plain",
    "paged_token_write_plain",
    "reset_launches",
]

# exp(MASK_VALUE - m) underflows to 0 without the inf-inf NaN hazard of -inf
MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)

LAUNCHES = {"paged_attn_decode": 0, "paged_token_write": 0, "paged_attn_verify": 0,
            "paged_chunk_write": 0, "paged_token_write_masked": 0, "flash_fwd": 0,
            "flash_bwd_dq": 0, "flash_bwd_dkv": 0}

_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_KERNEL_HEAD_SIZES = (64, 128, 256)
_MAX_SMEM_BYTES = 232448      # shared memory one block may use on Hopper


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def paged_available() -> bool:
    """Whether the CUDA kernels can run here: a card and a compiler to
    build them with.  Without either, CPU tensors still take the plain
    versions."""
    return torch.cuda.is_available() and _build.nvcc_path() is not None


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_common(name: str, tensors: dict, tables, pos, B: int) -> torch.device:
    dev = tables.device
    for arg, t in tensors.items():
        _require(isinstance(t, torch.Tensor), f"{name}: {arg} must be a tensor")
        _require(t.device == dev, f"{name}: {arg} is on {t.device}, tables on {dev}")
        _require(t.is_contiguous(), f"{name}: {arg} must be contiguous")
    _require(tables.dtype == torch.int32 and tables.ndim == 2 and tables.shape[0] == B,
             f"{name}: tables must be int32 (B={B}, nbb), got {tables.dtype} {tuple(tables.shape)}")
    _require(pos.dtype == torch.int32 and tuple(pos.shape) == (B,),
             f"{name}: pos must be int32 ({B},), got {pos.dtype} {tuple(pos.shape)}")
    _require(tables.shape[1] >= 1, f"{name}: tables need at least one column")
    _require(dev.type in ("cpu", "cuda"), f"{name}: unsupported device {dev}")
    return dev


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _raise_on(lib, rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} "
                           f"({lib.tt_error_string(rc).decode()})")


#
# paged_attn_decode
#


def _online(m, l, acc, s, v, dt):
    """One online-softmax step: fold scores ``s`` (.., rep, n) and values
    ``v`` (.., n, hs) into the running (m, l, acc)."""
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    p = torch.exp(s - m_new)
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1, keepdim=True)
    acc_new = acc * corr + torch.matmul(p.to(dt).float(), v)
    return m_new, l_new, acc_new


def paged_attn_decode_plain(q, k_arena, v_arena, fresh_k, fresh_v, tables, pos, *,
                            layer: int, window: int | None = None):
    """Plain PyTorch version of :func:`paged_attn_decode`: the same walk
    over each request's live blocks in table order, one online-softmax step
    per block, the fresh token folded last, with the kernel's numerics."""
    B, nh, hs = q.shape
    ng, bs = k_arena.shape[2], k_arena.shape[3]
    rep, nbb, dt = nh // ng, tables.shape[1], q.dtype
    sm = float(np.sqrt(hs))
    f32 = torch.float32
    qf = q.reshape(B, ng, rep, hs).float()
    m = torch.full((B, ng, rep, 1), MASK_VALUE, dtype=f32, device=q.device)
    l = torch.zeros((B, ng, rep, 1), dtype=f32, device=q.device)
    acc = torch.zeros((B, ng, rep, hs), dtype=f32, device=q.device)
    p_i = pos.long()
    hi = (p_i + bs - 1) // bs
    lo = (torch.clamp(p_i - (window - 1), min=0) // bs if window is not None
          else torch.zeros_like(p_i))
    t = torch.arange(bs, device=q.device)
    for j in range(nbb):
        run = (j >= lo) & (j < hi)
        if not bool(run.any()):
            continue
        blk = tables[:, j].long()
        k = k_arena[blk, layer].to(dt).float()                 # (B, ng, bs, hs)
        v = v_arena[blk, layer].to(dt).float()
        s = torch.matmul(qf, k.transpose(-1, -2)) / sm         # (B, ng, rep, bs)
        slot = j * bs + t
        keep = slot[None, :] < p_i[:, None]
        if window is not None:
            keep = keep & (slot[None, :] > p_i[:, None] - window)
        s = torch.where(keep[:, None, None, :], s, MASK_VALUE)
        m_new, l_new, acc_new = _online(m, l, acc, s, v, dt)
        r = run[:, None, None, None]
        m, l, acc = torch.where(r, m_new, m), torch.where(r, l_new, l), torch.where(r, acc_new, acc)
    fk = fresh_k.to(dt).float()                                 # (B, ng, hs)
    fv = fresh_v.to(dt).float()
    s_f = torch.matmul(qf, fk[..., None]) / sm                  # (B, ng, rep, 1)
    m, l, acc = _online(m, l, acc, s_f, fv[:, :, None, :], dt)
    return (acc / l).to(dt).reshape(B, nh, hs)


def paged_attn_decode(q, k_arena, v_arena, fresh_k, fresh_v, tables, pos, *, layer: int,
                      k_scale=None, v_scale=None, window: int | None = None):
    """Single-token attention straight off the KV block arena, one layer.

    ``q``: (B, nh, hs) queries; ``k_arena``/``v_arena``: the FULL
    (num_blocks, L, ng, bs, hs) pool arenas — ``layer`` picks the layer
    inside the kernel, so no per-layer arena slice is ever copied;
    ``fresh_k``/``fresh_v``: (B, ng, hs) this step's K/V at the arena dtype
    (not yet in the arena — :func:`paged_token_write` lands them after);
    ``tables``: (B, nbb) int32 sink-padded block tables; ``pos``: (B,) int32
    positions; ``window``: ``cfg.sliding_window``.  Returns (B, nh, hs) at
    ``q.dtype``.  Quantized arenas (``k_scale``/``v_scale``) are not ported
    yet and raise."""
    name = "paged_attn_decode"
    if k_scale is not None or v_scale is not None:
        raise NotImplementedError(f"{name}: quantized arenas (k_scale/v_scale) are not ported yet")
    _require(q.ndim == 3 and k_arena.ndim == 5, f"{name}: q must be (B, nh, hs) and the "
             f"arenas (num_blocks, L, ng, bs, hs), got {tuple(q.shape)} {tuple(k_arena.shape)}")
    B, nh, hs = q.shape
    num_blocks, L, ng, bs, hs_a = k_arena.shape
    _require(tuple(v_arena.shape) == tuple(k_arena.shape), f"{name}: K/V arena shapes differ")
    _require(hs_a == hs and nh % ng == 0,
             f"{name}: q {tuple(q.shape)} does not fit arena {tuple(k_arena.shape)}")
    _require(tuple(fresh_k.shape) == (B, ng, hs) and tuple(fresh_v.shape) == (B, ng, hs),
             f"{name}: fresh K/V must be {(B, ng, hs)}")
    _require(q.dtype in _DTYPE_CODE and k_arena.dtype in _DTYPE_CODE,
             f"{name}: dtypes must be float32/float16/bfloat16, got {q.dtype} {k_arena.dtype}")
    _require(v_arena.dtype == k_arena.dtype == fresh_k.dtype == fresh_v.dtype,
             f"{name}: arenas and fresh K/V must share one dtype")
    _require(0 <= layer < L, f"{name}: layer {layer} out of range for L={L}")
    _require(window is None or window >= 1, f"{name}: window must be >= 1, got {window}")
    dev = _check_common(name, dict(q=q, k_arena=k_arena, v_arena=v_arena, fresh_k=fresh_k,
                                   fresh_v=fresh_v), tables, pos, B)
    if dev.type == "cpu":
        return paged_attn_decode_plain(q, k_arena, v_arena, fresh_k, fresh_v, tables, pos,
                                       layer=layer, window=window)
    rep, nbb = nh // ng, tables.shape[1]
    _require(hs in _KERNEL_HEAD_SIZES,
             f"{name}: the CUDA kernel takes head sizes {_KERNEL_HEAD_SIZES}, got {hs}")
    smem = 4 * (2 * rep * hs + 2 * bs * hs + rep * bs + 3 * rep)
    _require(smem <= _MAX_SMEM_BYTES,
             f"{name}: rep={rep}, bs={bs}, hs={hs} needs {smem} B of shared memory "
             f"(limit {_MAX_SMEM_BYTES})")
    lib = _build.load_library()
    out = torch.empty_like(q)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.tt_paged_attn_decode(
            _ptr(q), _ptr(k_arena), _ptr(v_arena), _ptr(fresh_k), _ptr(fresh_v),
            _ptr(tables), _ptr(pos), _ptr(out),
            B, ng, rep, hs, bs, nbb, L, layer, 0 if window is None else int(window),
            ctypes.c_float(float(np.sqrt(hs))), _DTYPE_CODE[q.dtype],
            _DTYPE_CODE[k_arena.dtype], ctypes.c_void_p(stream))
    _raise_on(lib, rc, name)
    LAUNCHES[name] += 1
    return out


#
# paged_token_write
#


def _dest(tables, pos, block_size: int):
    """Destination block and slot of each row's write: ``tables[i, pos //
    bs]`` (the column clamped to the table) and ``pos % bs``."""
    p = pos.long()
    col = torch.clamp(p // block_size, max=tables.shape[1] - 1)
    return tables.long().gather(1, col[:, None])[:, 0], p % block_size


def paged_token_write_plain(arena, vals, tables, pos, *, block_size: int):
    """Plain PyTorch version of :func:`paged_token_write` (in place)."""
    blk, slot = _dest(tables, pos, block_size)
    if arena.ndim == 5:
        arena[blk, :, :, slot, :] = vals
    else:
        arena[blk, :, :, slot] = vals
    return arena


def paged_token_write(arena, vals, tables, pos, *, block_size: int):
    """In-place single-token arena write; returns ``arena`` itself.

    ``arena``: (num_blocks, L, ng, bs, hs) K/V arena — or a (num_blocks, L,
    ng, bs) scale arena; ``vals``: (B, L, ng, hs) (or (B, L, ng)) at the
    arena dtype.  Row ``i`` lands in block ``tables[i, pos[i] // bs]``, slot
    ``pos[i] % bs``; batch-padding rows (all-sink tables, pos 0) land in
    sink block 0, which is never read."""
    name = "paged_token_write"
    _require(arena.ndim in (4, 5) and vals.ndim == arena.ndim - 1,
             f"{name}: arena must be rank 4 or 5 and vals one rank lower, got "
             f"{tuple(arena.shape)} and {tuple(vals.shape)}")
    B = vals.shape[0]
    bs = arena.shape[3]
    want = (B, *arena.shape[1:3], *arena.shape[4:])
    _require(tuple(vals.shape) == want, f"{name}: vals must be {want}, got {tuple(vals.shape)}")
    _require(block_size == bs, f"{name}: block_size={block_size} but the arena holds {bs}")
    _require(vals.dtype == arena.dtype,
             f"{name}: vals dtype {vals.dtype} != arena dtype {arena.dtype}")
    _require(arena.element_size() in (1, 2, 4), f"{name}: unsupported dtype {arena.dtype}")
    dev = _check_common(name, dict(arena=arena, vals=vals), tables, pos, B)
    if dev.type == "cpu":
        return paged_token_write_plain(arena, vals, tables, pos, block_size=block_size)
    if B == 0:
        return arena
    hs = arena.shape[4] if arena.ndim == 5 else 1
    lib = _build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.tt_paged_token_write(
            _ptr(arena), _ptr(vals), _ptr(tables), _ptr(pos),
            B, arena.shape[1] * arena.shape[2], bs, hs, tables.shape[1],
            arena.element_size(), ctypes.c_void_p(stream))
    _raise_on(lib, rc, name)
    LAUNCHES[name] += 1
    return arena



#
# paged_attn_verify
#


def paged_attn_verify_plain(q, k_arena, v_arena, fresh_k, fresh_v, tables, pos, *, layer: int):
    """Plain PyTorch version of :func:`paged_attn_verify`: the decode walk
    over each request's live blocks at rep·T query rows (the arena keep-mask
    ``slot < pos`` is the same for every query), then the chunk's own K/V
    folded in one last online-softmax step under the causal mask ``col <=
    t``, with the kernel's numerics."""
    B, nh, T, hs = q.shape
    ng, bs = k_arena.shape[2], k_arena.shape[3]
    rep, nbb, dt = nh // ng, tables.shape[1], q.dtype
    rows = rep * T
    sm = float(np.sqrt(hs))
    f32 = torch.float32
    qf = q.reshape(B, ng, rows, hs).float()            # row r = rep_idx * T + t
    m = torch.full((B, ng, rows, 1), MASK_VALUE, dtype=f32, device=q.device)
    l = torch.zeros((B, ng, rows, 1), dtype=f32, device=q.device)
    acc = torch.zeros((B, ng, rows, hs), dtype=f32, device=q.device)
    p_i = pos.long()
    t = torch.arange(bs, device=q.device)
    for j in range(nbb):
        run = j * bs < p_i
        if not bool(run.any()):
            continue
        blk = tables[:, j].long()
        k = k_arena[blk, layer].to(dt).float()                 # (B, ng, bs, hs)
        v = v_arena[blk, layer].to(dt).float()
        s = torch.matmul(qf, k.transpose(-1, -2)) / sm         # (B, ng, rows, bs)
        keep = (j * bs + t)[None, :] < p_i[:, None]
        s = torch.where(keep[:, None, None, :], s, MASK_VALUE)
        m_new, l_new, acc_new = _online(m, l, acc, s, v, dt)
        r = run[:, None, None, None]
        m, l, acc = torch.where(r, m_new, m), torch.where(r, l_new, l), torch.where(r, acc_new, acc)
    fk = fresh_k.to(dt).float()                                 # (B, ng, T, hs)
    fv = fresh_v.to(dt).float()
    s_f = torch.matmul(qf, fk.transpose(-1, -2)) / sm           # (B, ng, rows, T)
    t_of = torch.arange(rows, device=q.device)[:, None] % T
    col = torch.arange(T, device=q.device)[None, :]
    s_f = torch.where(col <= t_of, s_f, MASK_VALUE)
    m, l, acc = _online(m, l, acc, s_f, fv, dt)
    return (acc / l).to(dt).reshape(B, nh, T, hs)


def _verify_rows_per_block(rows: int, hs: int, bs: int) -> int | None:
    """Query rows one kernel block owns: the smallest of 16, 32, 64 that
    covers ``rows`` (64 at most), halved until the block's shared memory
    fits; None when even 16 does not."""
    R = 16
    while R < min(rows, 64):
        R *= 2
    while R >= 16:
        if 4 * (R * (hs + 1) + R * hs + bs * (hs + 1) + bs * hs + R * bs + 3 * R) \
                <= _MAX_SMEM_BYTES:
            return R
        R //= 2
    return None


def paged_attn_verify(q, k_arena, v_arena, fresh_k, fresh_v, tables, pos, *, layer: int,
                      k_scale=None, v_scale=None):
    """Multi-token-query attention straight off the KV block arena, one
    layer: the speculative verify step (T = K+1) and the paged chunked
    prefill (T = the chunk width).

    ``q``: (B, nh, T, hs) queries at positions ``[pos, pos+T)``;
    ``k_arena``/``v_arena``: the full (num_blocks, L, ng, bs, hs) arenas;
    ``fresh_k``/``fresh_v``: (B, ng, T, hs) the chunk's own K/V at the arena
    dtype (not yet in the arena: :func:`paged_token_write_masked` or
    :func:`paged_chunk_write` land it after); ``tables``: (B, nbb) int32
    sink-padded block tables; ``pos``: (B,) int32.  Every query sees the
    arena slots ``< pos`` and the chunk's keys up to its own offset.  No
    sliding window (windowed models take the gather path).  Returns
    (B, nh, T, hs) at ``q.dtype``.  Quantized arenas are not ported yet and
    raise."""
    name = "paged_attn_verify"
    if k_scale is not None or v_scale is not None:
        raise NotImplementedError(f"{name}: quantized arenas (k_scale/v_scale) are not ported yet")
    _require(q.ndim == 4 and k_arena.ndim == 5, f"{name}: q must be (B, nh, T, hs) and the "
             f"arenas (num_blocks, L, ng, bs, hs), got {tuple(q.shape)} {tuple(k_arena.shape)}")
    B, nh, T, hs = q.shape
    num_blocks, L, ng, bs, hs_a = k_arena.shape
    _require(tuple(v_arena.shape) == tuple(k_arena.shape), f"{name}: K/V arena shapes differ")
    _require(hs_a == hs and nh % ng == 0 and T >= 1,
             f"{name}: q {tuple(q.shape)} does not fit arena {tuple(k_arena.shape)}")
    _require(tuple(fresh_k.shape) == (B, ng, T, hs) and tuple(fresh_v.shape) == (B, ng, T, hs),
             f"{name}: fresh K/V must be {(B, ng, T, hs)}")
    _require(q.dtype in _DTYPE_CODE and k_arena.dtype in _DTYPE_CODE,
             f"{name}: dtypes must be float32/float16/bfloat16, got {q.dtype} {k_arena.dtype}")
    _require(v_arena.dtype == k_arena.dtype == fresh_k.dtype == fresh_v.dtype,
             f"{name}: arenas and fresh K/V must share one dtype")
    _require(0 <= layer < L, f"{name}: layer {layer} out of range for L={L}")
    dev = _check_common(name, dict(q=q, k_arena=k_arena, v_arena=v_arena, fresh_k=fresh_k,
                                   fresh_v=fresh_v), tables, pos, B)
    if dev.type == "cpu":
        return paged_attn_verify_plain(q, k_arena, v_arena, fresh_k, fresh_v, tables, pos,
                                       layer=layer)
    rep, nbb = nh // ng, tables.shape[1]
    _require(hs in _KERNEL_HEAD_SIZES,
             f"{name}: the CUDA kernel takes head sizes {_KERNEL_HEAD_SIZES}, got {hs}")
    R = _verify_rows_per_block(rep * T, hs, bs)
    _require(R is not None, f"{name}: bs={bs}, hs={hs} needs more shared memory than "
             f"{_MAX_SMEM_BYTES} B even at 16 rows per block")
    lib = _build.load_library()
    out = torch.empty_like(q)
    if B == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.tt_paged_attn_verify(
            _ptr(q), _ptr(k_arena), _ptr(v_arena), _ptr(fresh_k), _ptr(fresh_v),
            _ptr(tables), _ptr(pos), _ptr(out),
            B, ng, rep * T, T, hs, bs, nbb, L, layer, R,
            ctypes.c_float(float(np.sqrt(hs))), _DTYPE_CODE[q.dtype],
            _DTYPE_CODE[k_arena.dtype], ctypes.c_void_p(stream))
    _raise_on(lib, rc, name)
    LAUNCHES[name] += 1
    return out


#
# paged_chunk_write
#


def _chunk_dest(dest, pos, nc: int, block_size: int):
    """Destination block of each chunk block: ``dest[pos // bs + c]``, or
    sink block 0 for entries past the table."""
    nbb = dest.shape[0]
    idx = pos.long()[0] // block_size + torch.arange(nc, device=dest.device)
    return torch.where(idx < nbb, dest.long()[torch.clamp(idx, max=nbb - 1)], 0)


def paged_chunk_write_plain(arena, vals, dest, pos, *, block_size: int):
    """Plain PyTorch version of :func:`paged_chunk_write` (in place)."""
    arena[_chunk_dest(dest, pos, vals.shape[0], block_size)] = vals
    return arena


def paged_chunk_write(arena, vals, dest, pos, *, block_size: int):
    """In-place block-granule write of one prefill chunk's K (or V);
    returns ``arena`` itself.

    ``arena``: (num_blocks, L, ng, bs, hs); ``vals``: (nc, L, ng, bs, hs)
    the chunk's fresh K/V at the arena dtype, folded to block granules;
    ``dest``: (nbb,) int32 scatter table (``kv_pool.chunk_tables``: sink
    outside the chunk's own blocks); ``pos``: (1,) int32 block-aligned chunk
    start.  Chunk block ``c`` lands as one slab at ``dest[pos // bs + c]``,
    or in sink block 0 when that entry lies past the table."""
    name = "paged_chunk_write"
    _require(arena.ndim == 5 and vals.ndim == 5 and tuple(vals.shape[1:]) == tuple(arena.shape[1:]),
             f"{name}: arena must be (num_blocks, L, ng, bs, hs) and vals (nc, L, ng, bs, hs), "
             f"got {tuple(arena.shape)} and {tuple(vals.shape)}")
    _require(block_size == arena.shape[3],
             f"{name}: block_size={block_size} but the arena holds {arena.shape[3]}")
    _require(vals.dtype == arena.dtype,
             f"{name}: vals dtype {vals.dtype} != arena dtype {arena.dtype}")
    _require(dest.dtype == torch.int32 and dest.ndim == 1 and dest.shape[0] >= 1,
             f"{name}: dest must be int32 (nbb,), got {dest.dtype} {tuple(dest.shape)}")
    _require(pos.dtype == torch.int32 and tuple(pos.shape) == (1,),
             f"{name}: pos must be int32 (1,), got {pos.dtype} {tuple(pos.shape)}")
    dev = arena.device
    for arg, t in dict(arena=arena, vals=vals, dest=dest, pos=pos).items():
        _require(t.device == dev, f"{name}: {arg} is on {t.device}, arena on {dev}")
        _require(t.is_contiguous(), f"{name}: {arg} must be contiguous")
    _require(dev.type in ("cpu", "cuda"), f"{name}: unsupported device {dev}")
    if dev.type == "cpu":
        return paged_chunk_write_plain(arena, vals, dest, pos, block_size=block_size)
    slab = vals[0].numel() * vals.element_size() if vals.shape[0] else 0
    vec = next(w for w in (16, 8, 4, 2, 1)
               if slab % w == 0 and arena.data_ptr() % w == 0 and vals.data_ptr() % w == 0)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.tt_paged_chunk_write(
            _ptr(arena), _ptr(vals), _ptr(dest), _ptr(pos), vals.shape[0], slab,
            block_size, dest.shape[0], vec, ctypes.c_void_p(stream))
    _raise_on(lib, rc, name)
    LAUNCHES[name] += 1
    return arena


#
# paged_token_write_masked
#


def paged_token_write_masked_plain(arena, vals, tables, pos, n_emit, offset: int, *,
                                   block_size: int):
    """Plain PyTorch version of :func:`paged_token_write_masked` (in place)."""
    live = offset < n_emit.long()
    blk, slot = _dest(tables, pos + offset, block_size)
    blk = torch.where(live, blk, 0)
    slot = torch.where(live, slot, 0)
    if arena.ndim == 5:
        arena[blk, :, :, slot, :] = vals
    else:
        arena[blk, :, :, slot] = vals
    return arena


def paged_token_write_masked(arena, vals, tables, pos, n_emit, offset: int, *, block_size: int):
    """In-place keep-masked single-token arena write; returns ``arena``.

    The speculative verify commit (one call per chunk offset) and, at
    ``offset=0`` with ``n_emit`` the per-row liveness, the multi-step
    decode write.  Row ``i`` lands ``vals[i]`` — the K/V (or scale) of
    chunk offset ``offset`` — at slot ``pos[i] + offset`` (block
    ``tables[i, (pos[i] + offset) // bs]``) iff ``offset < n_emit[i]``;
    otherwise it lands in sink block 0, slot 0, which is never read.
    ``arena``/``vals`` as :func:`paged_token_write`; ``n_emit``: (B,)
    int32."""
    name = "paged_token_write_masked"
    _require(arena.ndim in (4, 5) and vals.ndim == arena.ndim - 1,
             f"{name}: arena must be rank 4 or 5 and vals one rank lower, got "
             f"{tuple(arena.shape)} and {tuple(vals.shape)}")
    B = vals.shape[0]
    bs = arena.shape[3]
    want = (B, *arena.shape[1:3], *arena.shape[4:])
    _require(tuple(vals.shape) == want, f"{name}: vals must be {want}, got {tuple(vals.shape)}")
    _require(block_size == bs, f"{name}: block_size={block_size} but the arena holds {bs}")
    _require(vals.dtype == arena.dtype,
             f"{name}: vals dtype {vals.dtype} != arena dtype {arena.dtype}")
    _require(arena.element_size() in (1, 2, 4), f"{name}: unsupported dtype {arena.dtype}")
    _require(n_emit.dtype == torch.int32 and tuple(n_emit.shape) == (B,),
             f"{name}: n_emit must be int32 ({B},), got {n_emit.dtype} {tuple(n_emit.shape)}")
    _require(offset >= 0, f"{name}: offset must be >= 0, got {offset}")
    dev = _check_common(name, dict(arena=arena, vals=vals, n_emit=n_emit), tables, pos, B)
    if dev.type == "cpu":
        return paged_token_write_masked_plain(arena, vals, tables, pos, n_emit, offset,
                                              block_size=block_size)
    if B == 0:
        return arena
    hs = arena.shape[4] if arena.ndim == 5 else 1
    lib = _build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.tt_paged_token_write_masked(
            _ptr(arena), _ptr(vals), _ptr(tables), _ptr(pos), _ptr(n_emit), int(offset),
            B, arena.shape[1] * arena.shape[2], bs, hs, tables.shape[1],
            arena.element_size(), ctypes.c_void_p(stream))
    _raise_on(lib, rc, name)
    LAUNCHES[name] += 1
    return arena


#
# flash attention: the training step's forward and backward
#

_FLASH_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 2}
_MASK_MODE_CODE = {"shared": 0, "batch": 1, "head": 2, "full": 3}
# (query rows, keys) per tile, in the order the wrapper tries them
_FLASH_TILES = ((64, 64), (64, 32), (32, 64), (32, 32), (32, 16), (16, 32), (16, 16))


def _flash_block(T: int) -> int:
    """The Pallas kernels' block size for a length-``T`` axis (``_block``,
    ``pallasex.py:94``): the largest of 512, 256, 128 dividing ``T``, else 0."""
    return next((b for b in (512, 256, 128) if T % b == 0), 0)


def _gqa_rep(q_shape, k_shape) -> int | None:
    """Heads per KV group, or None when the shapes do not fit the kernels
    (``_gqa_rep``, ``pallasex.py:121``)."""
    if tuple(q_shape[:-2]) == tuple(k_shape[:-2]):
        return 1
    if len(q_shape) < 3 or tuple(q_shape[:-3]) != tuple(k_shape[:-3]):
        return None
    H, G = q_shape[-3], k_shape[-3]
    if G <= 0 or H % G != 0:
        return None
    return H // G


def _canon_mask(mask_shape, q_shape, k_shape):
    """``(mode, mq)`` of an additive mask against the kernels' flat
    batch×head axis, or None (``_canon_mask``, ``pallasex.py:139``): mode
    ``shared`` (broadcast), ``batch`` (flat // H: the HF padding-mask layout),
    ``head`` (flat % H) or ``full``; ``mq`` is 1 (row-broadcast) or Tq."""
    *qb, Tq, _ = q_shape
    Tk = k_shape[-2]
    if len(mask_shape) > len(qb) + 2:
        return None
    ms = (1,) * (len(qb) + 2 - len(mask_shape)) + tuple(mask_shape)
    if ms[-1] != Tk:
        return None
    mq = ms[-2]
    if mq not in (1, Tq):
        return None
    mb = ms[:-2]
    if any(md not in (1, qd) for md, qd in zip(mb, qb)):
        return None
    if all(md == 1 for md in mb):
        return ("shared", mq)
    if all(md == qd for md, qd in zip(mb, qb)):
        return ("full", mq)
    if len(mb) == 2 and mb[1] == 1:
        return ("batch", mq)
    if len(mb) == 2 and mb[0] == 1:
        return ("head", mq)
    return None


def flash_supported(q_shape, k_shape, v_shape, dtype, causal, mask_shape=None,
                    window=None) -> bool:
    """Whether the flash kernels take these shapes (``_supported``,
    ``pallasex.py:180``): one head size for q/k/v, up to 512; query and key
    lengths multiples of 128; native GQA; a window only with causal;
    bfloat16 or float32; a mask in one of the four layouts."""
    if window is not None and (not causal or int(window) <= 0):
        return False
    *_, Tq, hs = q_shape
    Tk = k_shape[-2]
    if v_shape[-1] != hs or _gqa_rep(q_shape, k_shape) is None:
        return False
    if tuple(k_shape[:-1]) != tuple(v_shape[:-1]):
        return False
    if -(-hs // 128) * 128 > 512:
        return False
    if _flash_block(Tq) == 0 or _flash_block(Tk) == 0:
        return False
    if dtype not in _FLASH_DTYPE_CODE:
        return False
    return mask_shape is None or _canon_mask(mask_shape, q_shape, k_shape) is not None


def _flash_smem(kind: str, R: int, KT: int, hs: int, esize: int, mma: bool) -> int:
    """Bytes of shared memory of one block (``*_smem`` in
    ``csrc/flash_attention.cu``, which carves the buffers in this order)."""
    tp, fp = (16 // esize, 4) if mma else (1, 1)

    def t(rows, w):
        return -(-rows * (w + tp) * esize // 128) * 128

    def f(rows, w):
        return -(-rows * (w + fp) * 4 // 128) * 128

    vec = -(-4 * R // 128) * 128
    if kind == "fwd":
        return t(R, hs) + 2 * t(KT, hs) + f(R, hs) + f(R, KT) + t(R, KT) + 2 * vec
    if kind == "dq":
        return 2 * t(R, hs) + 2 * t(KT, hs) + f(R, hs) + 2 * f(R, KT) + t(R, KT) + 2 * vec
    return 2 * t(KT, hs) + 2 * t(R, hs) + 2 * f(KT, hs) + 2 * f(KT, R) + 2 * t(KT, R) + 2 * vec


def _flash_tiles(kind: str, hs: int, dtype, mma: bool) -> tuple[int, int]:
    """(query rows, keys) per tile of kernel ``kind`` ("fwd", "dq", "dkv"):
    the first of ``_FLASH_TILES`` whose shared memory fits a Hopper block."""
    esize = torch.empty((), dtype=dtype).element_size()
    return next(rk for rk in _FLASH_TILES
                if _flash_smem(kind, *rk, hs, esize, mma) <= _MAX_SMEM_BYTES)


def _flash_mma(hs: int, dtype, tensors) -> bool:
    """The tensor-core body takes bf16 with hs a multiple of 16 and every
    tensor 16-byte aligned (its 16-byte vector loads)."""
    return (dtype == torch.bfloat16 and hs % 16 == 0
            and all(t.data_ptr() % 16 == 0 for t in tensors))


def _geometry(q_shape, k_shape):
    """(BH, BG, H, G): the flat q-head and KV-head counts and the per-batch
    head counts (``_local_geometry``, ``pallasex.py:566``)."""
    BH = int(np.prod(q_shape[:-2], dtype=np.int64))
    BG = int(np.prod(k_shape[:-2], dtype=np.int64))
    H = q_shape[-3] if len(q_shape) >= 3 else 1
    G = k_shape[-3] if len(k_shape) >= 3 else 1
    return BH, BG, H, G


def _kv_of(BH: int, H: int, G: int, device) -> torch.Tensor:
    """KV index of each flat q head: ``(b // H) * G + (b % H) // (H // G)``
    (``_kv_index``, ``pallasex.py:266``)."""
    b = torch.arange(BH, device=device)
    return (b // H) * G + (b % H) // (H // G)


def _mask3(mask, q_shape, k_shape):
    """The mask as the kernels' (M, mq, Tk) f32 and its layout, or
    (None, None, 1)."""
    if mask is None:
        return None, None, 1
    mode, mq = _canon_mask(tuple(mask.shape), q_shape, k_shape)
    return mask.reshape(-1, mq, k_shape[-2]).float().contiguous(), mode, mq


def _mask_rows(mask3, mode, BH: int, H: int):
    """(BH, mq, Tk): each flat q head's slice of the canonical mask."""
    b = torch.arange(BH, device=mask3.device)
    idx = {"shared": b * 0, "batch": b // H, "head": b % H, "full": b}[mode]
    return mask3[idx]


def _acc_dtype(dtype):
    """The accumulation type: float32 (float64 stays float64, for gradcheck)."""
    return torch.promote_types(dtype, torch.float32)


def causal_keep(Tq: int, Tk: int, window, device) -> torch.Tensor:
    """Causal (+ sliding-window) keep-mask, top-left: row ``i`` sees cols
    ``(i - window, i]`` (``_band``, ``jaxex.py:527``)."""
    row = torch.arange(Tq, device=device)[:, None]
    col = torch.arange(Tk, device=device)[None, :]
    keep = row >= col
    if window is not None:
        keep = keep & (col > row - window)
    return keep


def flash_sdpa_plain(q, k, v, mask=None, *, causal: bool, scale: float, window=None):
    """Plain PyTorch version of :func:`flash_sdpa` with the kernel's
    arithmetic: f32 scores ``q·kᵀ * scale`` (+ mask), masked scores at
    ``MASK_VALUE``, one online-softmax step per key tile, f32 accumulators,
    over the kernel's own tiles: the probabilities round to the value type
    against the running max of each key tile, and a causal block of query
    rows skips the tiles the kernel skips (which decides what a row masked
    whole averages over)."""
    *batch, Tq, hs = q.shape
    Tk = k.shape[-2]
    BH, BG, H, G = _geometry(tuple(q.shape), tuple(k.shape))
    R, KT = _flash_tiles("fwd", hs, q.dtype, _flash_mma(hs, q.dtype, ()))
    ft = _acc_dtype(q.dtype)
    kv = _kv_of(BH, H, G, q.device)
    qf = q.reshape(BH, Tq, hs).to(ft)
    kx = k.reshape(BG, Tk, hs)[kv].to(ft)
    vx = v.reshape(BG, Tk, hs)[kv]
    mask3, mode, _ = _mask3(mask, tuple(q.shape), tuple(k.shape))
    mrows = None if mask3 is None else _mask_rows(mask3, mode, BH, H)
    keep = causal_keep(Tq, Tk, window, q.device) if causal else None
    row0 = torch.arange(Tq, device=q.device) // R * R     # first row of each row's block
    m = torch.full((BH, Tq, 1), MASK_VALUE, dtype=ft, device=q.device)
    l = torch.zeros((BH, Tq, 1), dtype=ft, device=q.device)
    acc = torch.zeros((BH, Tq, hs), dtype=ft, device=q.device)
    for c0 in range(0, Tk, KT):
        cols = slice(c0, c0 + KT)
        s = torch.matmul(qf, kx[:, cols].transpose(1, 2)) * scale
        if mrows is not None:
            s = s + mrows[:, :, cols].to(ft)
        if keep is not None:
            s = torch.where(keep[:, cols], s, MASK_VALUE)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l_new = l * corr + p.sum(dim=-1, keepdim=True)
        acc_new = acc * corr + torch.matmul(p.to(v.dtype).to(ft), vx[:, cols].to(ft))
        if causal:   # the kernel's tile skip, per block of query rows
            run = c0 <= row0 + R - 1
            if window is not None:
                run = run & (c0 + KT - 1 > row0 - window)
            run = run[None, :, None]
            m_new, l_new = torch.where(run, m_new, m), torch.where(run, l_new, l)
            acc_new = torch.where(run, acc_new, acc)
        m, l, acc = m_new, l_new, acc_new
    out = (acc / l).to(q.dtype).reshape(*batch, Tq, hs)
    return out, (m + torch.log(l)).reshape(*batch, Tq)


def flash_sdpa_backward_plain(g, q, k, v, out, lse, mask=None, *, causal: bool, scale: float,
                              window=None):
    """Plain PyTorch version of :func:`flash_sdpa_backward` with the
    kernels' arithmetic: ``p = exp(s - lse)`` (0 where causally masked),
    ``delta = Σ g·out`` in f32, ``ds = p·(dp - delta)``; ds rounds to the key
    type for dq and the query type for dk, p to the gradient type for dv;
    dk/dv sum each group's q heads in f32 and round once."""
    *batch, Tq, hs = q.shape
    Tk = k.shape[-2]
    BH, BG, H, G = _geometry(tuple(q.shape), tuple(k.shape))
    rep = H // G
    ft = _acc_dtype(q.dtype)
    kv = _kv_of(BH, H, G, q.device)
    qf = q.reshape(BH, Tq, hs).to(ft)
    gf = g.reshape(BH, Tq, hs).to(ft)
    kx = k.reshape(BG, Tk, hs)[kv].to(ft)
    vx = v.reshape(BG, Tk, hs)[kv].to(ft)
    s = torch.matmul(qf, kx.transpose(1, 2)) * scale
    mask3, mode, _ = _mask3(mask, tuple(q.shape), tuple(k.shape))
    if mask3 is not None:
        s = s + _mask_rows(mask3, mode, BH, H).to(ft)
    p = torch.exp(s - lse.reshape(BH, Tq, 1).to(ft))
    if causal:
        p = torch.where(causal_keep(Tq, Tk, window, q.device), p, 0.0)
    dp = torch.matmul(gf, vx.transpose(1, 2))
    delta = (gf * out.reshape(BH, Tq, hs).to(ft)).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta)
    dq = scale * torch.matmul(ds.to(k.dtype).to(ft), kx)
    dv = torch.matmul(p.to(g.dtype).to(ft).transpose(1, 2), gf)
    dk = torch.matmul(ds.to(q.dtype).to(ft).transpose(1, 2), qf)
    # flat q-head order is (batch, group, rep): sum rep onto each group
    dv = dv.reshape(BG, rep, Tk, hs).sum(dim=1)
    dk = scale * dk.reshape(BG, rep, Tk, hs).sum(dim=1)
    return (dq.to(q.dtype).reshape(q.shape), dk.to(k.dtype).reshape(k.shape),
            dv.to(v.dtype).reshape(v.shape))


def _flash_check(name, tensors: dict, mask, causal, window):
    q, k, v = tensors["q"], tensors["k"], tensors["v"]
    dev = q.device
    for arg, t in tensors.items():
        _require(isinstance(t, torch.Tensor), f"{name}: {arg} must be a tensor")
        _require(t.device == dev, f"{name}: {arg} is on {t.device}, q on {dev}")
    _require(dev.type in ("cpu", "cuda"), f"{name}: unsupported device {dev}")
    _require(k.dtype == v.dtype == q.dtype, f"{name}: q, k, v must share one dtype")
    _require(mask is None or (isinstance(mask, torch.Tensor) and mask.device == dev),
             f"{name}: mask must be a tensor on {dev}")
    _require(flash_supported(tuple(q.shape), tuple(k.shape), tuple(v.shape), q.dtype, causal,
                             None if mask is None else tuple(mask.shape), window),
             f"{name}: the flash kernels do not take q {tuple(q.shape)}, k {tuple(k.shape)}, "
             f"v {tuple(v.shape)}, {q.dtype}, causal={causal}, window={window}, mask "
             f"{None if mask is None else tuple(mask.shape)} (T % 128, hs <= 512, bf16/f32, "
             f"GQA, the four mask layouts)")


def _flash_args(q, k, mask, causal, window):
    """The ints every flash entry point shares, before (R, KT, mma)."""
    *_, Tq, hs = q.shape
    Tk = k.shape[-2]
    BH, _, H, G = _geometry(tuple(q.shape), tuple(k.shape))
    mask3, mode, mq = _mask3(mask, tuple(q.shape), tuple(k.shape))
    ints = [BH, H, G, Tq, Tk, hs, -1 if mode is None else _MASK_MODE_CODE[mode], mq,
            int(bool(causal)), 0 if window is None else int(window)]
    return mask3, ints


def flash_sdpa(q, k, v, mask=None, *, causal: bool, scale: float, window=None):
    """Flash attention forward: ``(out, lse)``.

    ``q``: (*batch, H, Tq, hs); ``k``/``v``: (*batch, G, Tk, hs) with ``H % G
    == 0`` (or the same leading dims as q); ``mask``: an additive mask
    broadcastable in one of the four ``_canon_mask`` layouts, or None;
    ``causal`` top-left; ``window``: sliding window (causal only).  Returns
    ``out`` (*batch, H, Tq, hs) at q's dtype and ``lse`` (*batch, H, Tq) f32.
    Shapes :func:`flash_supported` declines raise ``ValueError``."""
    name = "flash_sdpa"
    _flash_check(name, dict(q=q, k=k, v=v), mask, causal, window)
    if q.device.type == "cpu":
        return flash_sdpa_plain(q, k, v, mask, causal=causal, scale=scale, window=window)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    *batch, Tq, hs = q.shape
    mask3, ints = _flash_args(q, k, mask, causal, window)
    mma = _flash_mma(hs, q.dtype, (q, k, v))
    R, KT = _flash_tiles("fwd", hs, q.dtype, mma)
    lib = _build.load_library()
    out = torch.empty_like(q)
    lse = torch.empty((*batch, Tq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.tt_flash_fwd(
            _ptr(q), _ptr(k), _ptr(v), None if mask3 is None else _ptr(mask3), _ptr(out),
            _ptr(lse), *ints, R, KT, int(mma), ctypes.c_float(scale),
            _FLASH_DTYPE_CODE[q.dtype], ctypes.c_void_p(stream))
    _raise_on(lib, rc, name)
    LAUNCHES["flash_fwd"] += 1
    return out, lse


def flash_sdpa_backward(g, q, k, v, out, lse, mask=None, *, causal: bool, scale: float,
                        window=None):
    """Flash attention backward: ``(dq, dk, dv)`` from ``(g, q, k, v, out,
    lse)``, never the (Tq, Tk) probabilities.  Shapes as :func:`flash_sdpa`;
    ``g``/``out`` like q, ``lse`` (*batch, H, Tq) f32.  ``delta = Σ g·out``
    is computed here in f32, as the Pallas wrapper computes it outside its
    kernels; then the dq kernel and the dk/dv kernel launch."""
    name = "flash_sdpa_backward"
    _flash_check(name, dict(q=q, k=k, v=v, g=g, out=out, lse=lse), mask, causal, window)
    _require(tuple(g.shape) == tuple(q.shape) == tuple(out.shape) and g.dtype == q.dtype
             and out.dtype == q.dtype, f"{name}: g and out must match q")
    _require(tuple(lse.shape) == tuple(q.shape[:-1]) and lse.dtype == torch.float32,
             f"{name}: lse must be float32 {tuple(q.shape[:-1])}")
    if q.device.type == "cpu":
        return flash_sdpa_backward_plain(g, q, k, v, out, lse, mask, causal=causal, scale=scale,
                                         window=window)
    g, q, k, v, out, lse = (t.contiguous() for t in (g, q, k, v, out, lse))
    hs = q.shape[-1]
    mask3, ints = _flash_args(q, k, mask, causal, window)
    delta = (g.float() * out.float()).sum(dim=-1)
    mma = _flash_mma(hs, q.dtype, (g, q, k, v))
    lib = _build.load_library()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    mptr = None if mask3 is None else _ptr(mask3)
    with torch.cuda.device(q.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream)
        R, KT = _flash_tiles("dq", hs, q.dtype, mma)
        rc = lib.tt_flash_bwd_dq(
            _ptr(g), _ptr(q), _ptr(k), _ptr(v), _ptr(lse), _ptr(delta), mptr, _ptr(dq),
            *ints, R, KT, int(mma), ctypes.c_float(scale), _FLASH_DTYPE_CODE[q.dtype], stream)
        _raise_on(lib, rc, f"{name} (dq)")
        LAUNCHES["flash_bwd_dq"] += 1
        R, KT = _flash_tiles("dkv", hs, q.dtype, mma)
        rc = lib.tt_flash_bwd_dkv(
            _ptr(g), _ptr(q), _ptr(k), _ptr(v), _ptr(lse), _ptr(delta), mptr, _ptr(dk), _ptr(dv),
            *ints, R, KT, int(mma), ctypes.c_float(scale), _FLASH_DTYPE_CODE[q.dtype], stream)
        _raise_on(lib, rc, f"{name} (dk/dv)")
        LAUNCHES["flash_bwd_dkv"] += 1
    return dq, dk, dv
