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
  offset's K/V landed where the offset was accepted, else in the sink.

Each wrapper checks device, dtype, shape and contiguity, then routes by the
device of its tensors: CPU tensors run the plain PyTorch version beside it
(``*_plain``, the same arithmetic, which the CPU tests hold against the
Pallas kernels); CUDA tensors launch the kernel from
``thunder_tpu_torch/csrc/`` (``paged_attention.cu``, ``paged_verify.cu``)
on the current stream or raise — there is no fallback.  ``LAUNCHES`` counts kernel launches, one per
wrapper call that launched, so a run can show that its main path went
through the kernels.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from thunder_tpu_torch.executors import _build

__all__ = [
    "LAUNCHES",
    "MASK_VALUE",
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
            "paged_chunk_write": 0, "paged_token_write_masked": 0}

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
