"""Kernel wrappers for the port's hand-written CUDA kernels.

Counterpart of ``thunder_tpu/executors/pallasex.py`` for the seven kernels
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
- :func:`paged_token_write_fused` replaces
  ``pallasex.paged_token_write_fused`` (``pallasex.py:1672``): the token
  write (plain or masked) into a quantized (int8/fp8) arena, the absmax
  quantization of ``serving.quant.quantize_kv`` done in the kernel;
- :func:`paged_chunk_write_fused` replaces
  ``pallasex.paged_chunk_write_fused`` (``pallasex.py:1616``): the chunk
  write into a quantized arena, with the per-block error sums behind the
  ``serving.kv_quant.rel_err`` gauge;

``paged_attn_decode`` and ``paged_attn_verify`` read quantized arenas too
(``k_scale``/``v_scale``): each tile is dequantized as it is loaded,
``f32(x) * scale`` rounded to the compute dtype and then to the query
dtype, as the Pallas kernels round (``pallasex.py:1094-1098``);

and for the kernels of a training step:

- :func:`flash_sdpa` replaces ``pallasex.flash_sdpa`` (``pallasex.py:711``,
  ``_flash_fwd`` :293): blockwise flash attention, out and f32 lse;
- :func:`flash_sdpa_backward` replaces ``pallasex.flash_sdpa_backward``
  (``pallasex.py:739``, ``_flash_bwd`` :460): the dq kernel and the dk/dv
  kernel (counted as ``flash_bwd_dq`` and ``flash_bwd_dkv``);
  :func:`flash_body` names the kernel body both pick (Hopper warpgroup
  products for bf16 at hs 64/128);
- :func:`flash_cross_entropy` replaces ``pallasex.flash_cross_entropy``
  (``pallasex.py:984``, ``_flash_ce`` :911): the loss's row losses and
  logsumexps in one pass over the logits (counted as ``flash_ce``);
  :func:`ce_supported` says which inputs the kernel takes;

and for the adapter delta of multi-tenant LoRA serving:

- :func:`lora_delta_fused` replaces ``pallasex.lora_delta_fused``
  (``pallasex.py:1740``): per request ``scaling·(x·Aᵀ)·Bᵀ``.

Each wrapper checks device, dtype, shape and contiguity, then routes by the
device of its tensors: CPU tensors run the plain PyTorch version beside it
(``*_plain``, the same arithmetic, which the CPU tests hold against the
Pallas kernels); CUDA tensors launch the kernel from
``thunder_tpu_torch/csrc/`` (``paged_attention.cu``, ``paged_verify.cu``,
``flash_attention.cu``, ``cross_entropy.cu``, ``lora_delta.cu``) on the
current stream or raise — there is no
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
    "ce_supported",
    "dkv_splits",
    "flash_body",
    "flash_cross_entropy",
    "flash_cross_entropy_plain",
    "flash_sdpa",
    "flash_sdpa_backward",
    "flash_sdpa_backward_plain",
    "flash_sdpa_plain",
    "flash_supported",
    "lora_delta_fused",
    "lora_delta_fused_plain",
    "paged_attn_decode",
    "paged_attn_decode_plain",
    "paged_attn_verify",
    "paged_attn_verify_plain",
    "paged_available",
    "paged_chunk_write",
    "paged_chunk_write_fused",
    "paged_chunk_write_fused_plain",
    "paged_chunk_write_plain",
    "paged_kernels_decline",
    "paged_token_write",
    "paged_token_write_fused",
    "paged_token_write_fused_plain",
    "paged_token_write_masked",
    "paged_token_write_masked_plain",
    "paged_token_write_plain",
    "reset_launches",
]

# exp(MASK_VALUE - m) underflows to 0 without the inf-inf NaN hazard of -inf
MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)

LAUNCHES = {"paged_attn_decode": 0, "paged_token_write": 0, "paged_attn_verify": 0,
            "paged_chunk_write": 0, "paged_token_write_masked": 0, "flash_fwd": 0,
            "flash_bwd_dq": 0, "flash_bwd_dkv": 0, "paged_token_write_fused": 0,
            "paged_chunk_write_fused": 0, "flash_ce": 0, "lora_delta_fused": 0}

_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
# arena storage codes: the float dtypes above, then the quantized ones
_QUANT_CODE = {torch.int8: 3, torch.float8_e4m3fn: 4}
_STORAGE_CODE = {**_DTYPE_CODE, **_QUANT_CODE}
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


def _quant():
    """``serving.quant``: the quantize math the fused writes' plain versions
    share with the gather path.  Imported at call time, since the serving
    package imports this module."""
    from thunder_tpu_torch.serving import quant

    return quant


def _kv_tile(arena, scale, blk, layer: int, cdtype, dt):
    """The (B, ng, bs, hs) tiles of ``layer`` in blocks ``blk``, at the
    query dtype ``dt`` and as float32 numbers, loaded the way the kernels
    load them: a quantized tile is dequantized first, ``f32(x) * scale``
    rounded to the compute dtype ``cdtype``."""
    if scale is None:
        return arena[blk, layer].to(dt).float()
    x = _quant().as_bytes(arena)[blk, layer].view(arena.dtype).float()
    return (x * scale[blk, layer][..., None]).to(cdtype).to(dt).float()


def _check_kv(name: str, k_arena, v_arena, fresh_k, fresh_v, k_scale, v_scale) -> bool:
    """Dtype and shape checks of the arenas, their scales and the fresh
    K/V; returns whether the arenas are quantized.  Unquantized arenas
    share one float dtype with the fresh K/V; quantized ones are int8 or
    fp8 e4m3 with float32 scales shaped ``arena.shape[:-1]``, both given,
    and the fresh K/V are at the compute dtype."""
    if k_scale is None and v_scale is None:
        _require(k_arena.dtype in _DTYPE_CODE,
                 f"{name}: arena dtype must be float32/float16/bfloat16 (or int8/fp8 with "
                 f"k_scale/v_scale), got {k_arena.dtype}")
        _require(v_arena.dtype == k_arena.dtype == fresh_k.dtype == fresh_v.dtype,
                 f"{name}: arenas and fresh K/V must share one dtype")
        return False
    _require(k_scale is not None and v_scale is not None,
             f"{name}: k_scale and v_scale go together: pass both or neither")
    _require(k_arena.dtype in _QUANT_CODE and v_arena.dtype == k_arena.dtype,
             f"{name}: scaled arenas must both be int8 or float8_e4m3fn, got "
             f"{k_arena.dtype} {v_arena.dtype}")
    want = tuple(k_arena.shape[:-1])
    for arg, t in (("k_scale", k_scale), ("v_scale", v_scale)):
        _require(t.dtype == torch.float32 and tuple(t.shape) == want,
                 f"{name}: {arg} must be float32 {want}, got {t.dtype} {tuple(t.shape)}")
    _require(fresh_k.dtype in _DTYPE_CODE and fresh_v.dtype == fresh_k.dtype,
             f"{name}: fresh K/V must share one compute dtype (float32/float16/bfloat16), "
             f"got {fresh_k.dtype} {fresh_v.dtype}")
    return True


def _decode_smem(rep: int, bs: int, hs: int) -> int:
    """Bytes of shared memory of one decode block (``launch_decode`` in
    ``csrc/paged_attention.cu``): the group's queries and accumulators, one
    K and one V tile, the scores and the softmax state, all f32.  The kernel
    walks any head size at run time."""
    return 4 * (2 * rep * hs + 2 * bs * hs + rep * bs + 3 * rep)


def paged_kernels_decline(rep: int, bs: int, hs: int) -> str:
    """Why the paged attention kernels cannot serve ``rep`` query heads per
    KV group at block size ``bs`` and head size ``hs`` on the card, or ""
    when they can.  The decode kernel must fit one block's shared memory;
    so must the verify kernel's scalar body at its smallest tile (16 query
    rows), which takes every shape its tensor-core body refuses (``hs`` or
    ``bs`` not a multiple of 16, float32)."""
    smem = _decode_smem(rep, bs, hs)
    if smem > _MAX_SMEM_BYTES:
        return (f"paged_attn_decode needs {smem} B of shared memory for rep={rep}, bs={bs}, "
                f"hs={hs} (limit {_MAX_SMEM_BYTES})")
    if _verify_rows_per_block(16, hs, bs) is None:
        return (f"paged_attn_verify needs more than {_MAX_SMEM_BYTES} B of shared memory for "
                f"bs={bs}, hs={hs} even at 16 rows per block")
    return ""


def paged_attn_decode_plain(q, k_arena, v_arena, fresh_k, fresh_v, tables, pos, *,
                            layer: int, k_scale=None, v_scale=None,
                            window: int | None = None):
    """Plain PyTorch version of :func:`paged_attn_decode`: the same walk
    over each request's live blocks in table order, one online-softmax step
    per block, the fresh token folded last, with the kernel's numerics."""
    B, nh, hs = q.shape
    ng, bs = k_arena.shape[2], k_arena.shape[3]
    rep, nbb, dt, cdtype = nh // ng, tables.shape[1], q.dtype, fresh_k.dtype
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
        k = _kv_tile(k_arena, k_scale, blk, layer, cdtype, dt)     # (B, ng, bs, hs)
        v = _kv_tile(v_arena, v_scale, blk, layer, cdtype, dt)
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
    ``k_scale``/``v_scale``: (num_blocks, L, ng, bs) float32 scales of
    int8/fp8 arenas (both or neither), dequantized as each tile loads;
    ``fresh_k``/``fresh_v``: (B, ng, hs) this step's K/V at the compute
    dtype (the arena dtype when unquantized; not yet in the arena — a
    token write lands them after); ``tables``: (B, nbb) int32 sink-padded
    block tables; ``pos``: (B,) int32 positions; ``window``:
    ``cfg.sliding_window``.  Returns (B, nh, hs) at ``q.dtype``."""
    name = "paged_attn_decode"
    _require(q.ndim == 3 and k_arena.ndim == 5, f"{name}: q must be (B, nh, hs) and the "
             f"arenas (num_blocks, L, ng, bs, hs), got {tuple(q.shape)} {tuple(k_arena.shape)}")
    B, nh, hs = q.shape
    num_blocks, L, ng, bs, hs_a = k_arena.shape
    _require(tuple(v_arena.shape) == tuple(k_arena.shape), f"{name}: K/V arena shapes differ")
    _require(hs_a == hs and nh % ng == 0,
             f"{name}: q {tuple(q.shape)} does not fit arena {tuple(k_arena.shape)}")
    _require(tuple(fresh_k.shape) == (B, ng, hs) and tuple(fresh_v.shape) == (B, ng, hs),
             f"{name}: fresh K/V must be {(B, ng, hs)}")
    _require(q.dtype in _DTYPE_CODE,
             f"{name}: q dtype must be float32/float16/bfloat16, got {q.dtype}")
    quantized = _check_kv(name, k_arena, v_arena, fresh_k, fresh_v, k_scale, v_scale)
    _require(0 <= layer < L, f"{name}: layer {layer} out of range for L={L}")
    _require(window is None or window >= 1, f"{name}: window must be >= 1, got {window}")
    scales = dict(k_scale=k_scale, v_scale=v_scale) if quantized else {}
    dev = _check_common(name, dict(q=q, k_arena=k_arena, v_arena=v_arena, fresh_k=fresh_k,
                                   fresh_v=fresh_v, **scales), tables, pos, B)
    if dev.type == "cpu":
        return paged_attn_decode_plain(q, k_arena, v_arena, fresh_k, fresh_v, tables, pos,
                                       layer=layer, window=window, **scales)
    rep, nbb = nh // ng, tables.shape[1]
    smem = _decode_smem(rep, bs, hs)
    _require(smem <= _MAX_SMEM_BYTES,
             f"{name}: rep={rep}, bs={bs}, hs={hs} needs {smem} B of shared memory "
             f"(limit {_MAX_SMEM_BYTES})")
    lib = _build.load_library()
    out = torch.empty_like(q)
    null = ctypes.c_void_p(0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.tt_paged_attn_decode(
            _ptr(q), _ptr(k_arena), _ptr(v_arena),
            _ptr(k_scale) if quantized else null, _ptr(v_scale) if quantized else null,
            _ptr(fresh_k), _ptr(fresh_v), _ptr(tables), _ptr(pos), _ptr(out),
            B, ng, rep, hs, bs, nbb, L, layer, 0 if window is None else int(window),
            ctypes.c_float(float(np.sqrt(hs))), _DTYPE_CODE[q.dtype],
            _STORAGE_CODE[k_arena.dtype], _DTYPE_CODE[fresh_k.dtype], ctypes.c_void_p(stream))
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


def paged_attn_verify_plain(q, k_arena, v_arena, fresh_k, fresh_v, tables, pos, *, layer: int,
                            k_scale=None, v_scale=None):
    """Plain PyTorch version of :func:`paged_attn_verify`: the decode walk
    over each request's live blocks at rep·T query rows (the arena keep-mask
    ``slot < pos`` is the same for every query), then the chunk's own K/V
    folded in one last online-softmax step under the causal mask ``col <=
    t``, with the kernel's numerics."""
    B, nh, T, hs = q.shape
    ng, bs = k_arena.shape[2], k_arena.shape[3]
    rep, nbb, dt, cdtype = nh // ng, tables.shape[1], q.dtype, fresh_k.dtype
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
        k = _kv_tile(k_arena, k_scale, blk, layer, cdtype, dt)     # (B, ng, bs, hs)
        v = _kv_tile(v_arena, v_scale, blk, layer, cdtype, dt)
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
    ``k_arena``/``v_arena``: the full (num_blocks, L, ng, bs, hs) arenas,
    with ``k_scale``/``v_scale`` (num_blocks, L, ng, bs) float32 when they
    are int8/fp8 (dequantized as each tile loads, in both kernel bodies);
    ``fresh_k``/``fresh_v``: (B, ng, T, hs) the chunk's own K/V at the
    compute dtype (not yet in the arena: a masked token write or a chunk
    write lands it after); ``tables``: (B, nbb) int32 sink-padded block
    tables; ``pos``: (B,) int32.  Every query sees the arena slots ``<
    pos`` and the chunk's keys up to its own offset.  No sliding window
    (windowed models take the gather path).  Returns (B, nh, T, hs) at
    ``q.dtype``."""
    name = "paged_attn_verify"
    _require(q.ndim == 4 and k_arena.ndim == 5, f"{name}: q must be (B, nh, T, hs) and the "
             f"arenas (num_blocks, L, ng, bs, hs), got {tuple(q.shape)} {tuple(k_arena.shape)}")
    B, nh, T, hs = q.shape
    num_blocks, L, ng, bs, hs_a = k_arena.shape
    _require(tuple(v_arena.shape) == tuple(k_arena.shape), f"{name}: K/V arena shapes differ")
    _require(hs_a == hs and nh % ng == 0 and T >= 1,
             f"{name}: q {tuple(q.shape)} does not fit arena {tuple(k_arena.shape)}")
    _require(tuple(fresh_k.shape) == (B, ng, T, hs) and tuple(fresh_v.shape) == (B, ng, T, hs),
             f"{name}: fresh K/V must be {(B, ng, T, hs)}")
    _require(q.dtype in _DTYPE_CODE,
             f"{name}: q dtype must be float32/float16/bfloat16, got {q.dtype}")
    quantized = _check_kv(name, k_arena, v_arena, fresh_k, fresh_v, k_scale, v_scale)
    _require(0 <= layer < L, f"{name}: layer {layer} out of range for L={L}")
    scales = dict(k_scale=k_scale, v_scale=v_scale) if quantized else {}
    dev = _check_common(name, dict(q=q, k_arena=k_arena, v_arena=v_arena, fresh_k=fresh_k,
                                   fresh_v=fresh_v, **scales), tables, pos, B)
    if dev.type == "cpu":
        return paged_attn_verify_plain(q, k_arena, v_arena, fresh_k, fresh_v, tables, pos,
                                       layer=layer, **scales)
    rep, nbb = nh // ng, tables.shape[1]
    R = _verify_rows_per_block(rep * T, hs, bs)
    _require(R is not None, f"{name}: bs={bs}, hs={hs} needs more shared memory than "
             f"{_MAX_SMEM_BYTES} B even at 16 rows per block")
    lib = _build.load_library()
    out = torch.empty_like(q)
    if B == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        null = ctypes.c_void_p(0)
        rc = lib.tt_paged_attn_verify(
            _ptr(q), _ptr(k_arena), _ptr(v_arena),
            _ptr(k_scale) if quantized else null, _ptr(v_scale) if quantized else null,
            _ptr(fresh_k), _ptr(fresh_v), _ptr(tables), _ptr(pos), _ptr(out),
            B, ng, rep * T, T, hs, bs, nbb, L, layer, R,
            ctypes.c_float(float(np.sqrt(hs))), _DTYPE_CODE[q.dtype],
            _STORAGE_CODE[k_arena.dtype], _DTYPE_CODE[fresh_k.dtype], ctypes.c_void_p(stream))
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
# paged_token_write_fused, paged_chunk_write_fused: quantize on write
#


def _check_quant_arena(name: str, arena, scale_arena, vals) -> None:
    _require(arena.dtype in _QUANT_CODE,
             f"{name}: the arena must be int8 or float8_e4m3fn, got {arena.dtype}")
    _require(scale_arena.dtype == torch.float32
             and tuple(scale_arena.shape) == tuple(arena.shape[:-1]),
             f"{name}: scale_arena must be float32 {tuple(arena.shape[:-1])}, got "
             f"{scale_arena.dtype} {tuple(scale_arena.shape)}")
    _require(vals.dtype in _DTYPE_CODE,
             f"{name}: vals must be at the compute dtype (float32/float16/bfloat16), got "
             f"{vals.dtype}")


def paged_token_write_fused_plain(arena, scale_arena, vals, tables, pos, *, block_size: int,
                                  n_emit=None, offset: int = 0):
    """Plain PyTorch version of :func:`paged_token_write_fused` (in place):
    ``serving.quant.quantize_kv``, then the token write of values and
    scales (keep-masked when ``n_emit`` is given)."""
    quant = _quant()
    q, s = quant.quantize_kv(vals, arena.dtype)        # (B, L, ng, hs) / (B, L, ng)
    blk, slot = _dest(tables, pos + offset, block_size)
    if n_emit is not None:
        live = offset < n_emit.long()
        blk, slot = torch.where(live, blk, 0), torch.where(live, slot, 0)
    quant.as_bytes(arena)[blk, :, :, slot, :] = quant.as_bytes(q)
    scale_arena[blk, :, :, slot] = s
    return arena, scale_arena


def paged_token_write_fused(arena, scale_arena, vals, tables, pos, *, block_size: int,
                            n_emit=None, offset: int = 0):
    """In-place single-token write into a quantized arena, quantizing on the
    way; returns ``(arena, scale_arena)`` themselves.

    ``arena``: (num_blocks, L, ng, bs, hs) int8 or float8_e4m3fn;
    ``scale_arena``: (num_blocks, L, ng, bs) float32; ``vals``: (B, L, ng,
    hs) at the compute dtype.  Each (row, layer, group) vector is quantized
    exactly as ``serving.quant.quantize_kv`` does (the kernel's stored bytes
    and scales equal the plain version's, bit for bit) and lands with its
    scale at block ``tables[i, pos[i] // bs]``, slot ``pos[i] % bs``.  With
    ``n_emit`` (B,) int32 it is the keep-masked write of chunk offset
    ``offset`` (:func:`paged_token_write_masked`): row ``i`` lands at
    ``pos[i] + offset`` iff ``offset < n_emit[i]``, else in sink block 0,
    slot 0."""
    name = "paged_token_write_fused"
    _require(arena.ndim == 5 and vals.ndim == 4,
             f"{name}: arena must be (num_blocks, L, ng, bs, hs) and vals (B, L, ng, hs), got "
             f"{tuple(arena.shape)} and {tuple(vals.shape)}")
    B = vals.shape[0]
    _, L, ng, bs, hs = arena.shape
    _require(tuple(vals.shape) == (B, L, ng, hs),
             f"{name}: vals must be {(B, L, ng, hs)}, got {tuple(vals.shape)}")
    _require(block_size == bs, f"{name}: block_size={block_size} but the arena holds {bs}")
    _check_quant_arena(name, arena, scale_arena, vals)
    tensors = dict(arena=arena, scale_arena=scale_arena, vals=vals)
    if n_emit is None:
        _require(offset == 0, f"{name}: offset={offset} needs n_emit (the masked write)")
    else:
        _require(n_emit.dtype == torch.int32 and tuple(n_emit.shape) == (B,),
                 f"{name}: n_emit must be int32 ({B},), got {n_emit.dtype} "
                 f"{tuple(n_emit.shape)}")
        _require(offset >= 0, f"{name}: offset must be >= 0, got {offset}")
        tensors["n_emit"] = n_emit
    dev = _check_common(name, tensors, tables, pos, B)
    if dev.type == "cpu":
        return paged_token_write_fused_plain(arena, scale_arena, vals, tables, pos,
                                             block_size=block_size, n_emit=n_emit,
                                             offset=offset)
    if B == 0:
        return arena, scale_arena
    lib = _build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.tt_paged_token_write_fused(
            _ptr(arena), _ptr(scale_arena), _ptr(vals), _ptr(tables), _ptr(pos),
            _ptr(n_emit) if n_emit is not None else ctypes.c_void_p(0), int(offset),
            B, L * ng, bs, hs, tables.shape[1], ctypes.c_float(_quant().inv_qmax(arena.dtype)),
            _QUANT_CODE[arena.dtype], _DTYPE_CODE[vals.dtype], ctypes.c_void_p(stream))
    _raise_on(lib, rc, name)
    LAUNCHES[name] += 1
    return arena, scale_arena


def _chunk_live(dest, pos, nc: int, block_size: int):
    """Whether chunk block ``c`` lands in a real block: its dest entry lies
    within the table and is not the sink (the error sums' mask)."""
    nbb = dest.shape[0]
    idx = pos.long()[0] // block_size + torch.arange(nc, device=dest.device)
    return (idx < nbb) & (dest.long()[torch.clamp(idx, max=nbb - 1)] != 0)


def paged_chunk_write_fused_plain(arena, scale_arena, vals, dest, pos, *, block_size: int):
    """Plain PyTorch version of :func:`paged_chunk_write_fused` (in place):
    ``serving.quant.quantize_kv`` of every slot-head, the chunk write of
    values and scales, and the masked per-block error sums."""
    quant = _quant()
    nc = vals.shape[0]
    q, s = quant.quantize_kv(vals, arena.dtype)        # (nc, L, ng, bs, hs) / (nc, L, ng, bs)
    blk = _chunk_dest(dest, pos, nc, block_size)
    quant.as_bytes(arena)[blk] = quant.as_bytes(q)
    scale_arena[blk] = s
    xf = vals.float()
    dq = q.float() * s[..., None]
    sums = torch.stack([(dq - xf).abs().reshape(nc, -1).sum(1),
                        xf.abs().reshape(nc, -1).sum(1)], dim=1)
    return arena, scale_arena, sums * _chunk_live(dest, pos, nc, block_size).float()[:, None]


def paged_chunk_write_fused(arena, scale_arena, vals, dest, pos, *, block_size: int):
    """In-place block-granule chunk write into a quantized arena,
    quantizing on the way; returns ``(arena, scale_arena, err)``.

    ``arena``/``scale_arena`` as :func:`paged_token_write_fused`; ``vals``:
    (nc, L, ng, bs, hs) the chunk's fresh K (or V) at the compute dtype,
    folded to block granules; ``dest``/``pos`` and the routing as
    :func:`paged_chunk_write`.  ``err``: (nc, 2) float32, per chunk block
    ``sum|dq - x|`` and ``sum|x|`` over its slab, zero for a block routed to
    the sink (its dest entry is the sink or lies past the table) — the
    Pallas kernel's ``[c, 0, 0]`` and ``[c, 0, 1]``; ``err[:, 0].sum() /
    (err[:, 1].sum() + 1e-30)`` is the ``rel_err`` ``scatter_blocks_q``
    reports.  Values and scales are bit-equal to the plain version's, the
    sums equal up to the order of f32 additions."""
    name = "paged_chunk_write_fused"
    _require(arena.ndim == 5 and vals.ndim == 5 and tuple(vals.shape[1:]) == tuple(arena.shape[1:]),
             f"{name}: arena must be (num_blocks, L, ng, bs, hs) and vals (nc, L, ng, bs, hs), "
             f"got {tuple(arena.shape)} and {tuple(vals.shape)}")
    _require(block_size == arena.shape[3],
             f"{name}: block_size={block_size} but the arena holds {arena.shape[3]}")
    _check_quant_arena(name, arena, scale_arena, vals)
    _require(dest.dtype == torch.int32 and dest.ndim == 1 and dest.shape[0] >= 1,
             f"{name}: dest must be int32 (nbb,), got {dest.dtype} {tuple(dest.shape)}")
    _require(pos.dtype == torch.int32 and tuple(pos.shape) == (1,),
             f"{name}: pos must be int32 (1,), got {pos.dtype} {tuple(pos.shape)}")
    dev = arena.device
    for arg, t in dict(arena=arena, scale_arena=scale_arena, vals=vals, dest=dest,
                       pos=pos).items():
        _require(t.device == dev, f"{name}: {arg} is on {t.device}, arena on {dev}")
        _require(t.is_contiguous(), f"{name}: {arg} must be contiguous")
    _require(dev.type in ("cpu", "cuda"), f"{name}: unsupported device {dev}")
    if dev.type == "cpu":
        return paged_chunk_write_fused_plain(arena, scale_arena, vals, dest, pos,
                                             block_size=block_size)
    nc, L, ng, bs, hs = vals.shape
    err = torch.empty((nc, 2), dtype=torch.float32, device=dev)
    if nc == 0:
        return arena, scale_arena, err
    partial = torch.empty((nc, L * ng, 2), dtype=torch.float32, device=dev)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.tt_paged_chunk_write_fused(
            _ptr(arena), _ptr(scale_arena), _ptr(vals), _ptr(dest), _ptr(pos), _ptr(err),
            _ptr(partial), nc, L * ng, bs, hs, dest.shape[0],
            ctypes.c_float(_quant().inv_qmax(arena.dtype)), _QUANT_CODE[arena.dtype],
            _DTYPE_CODE[vals.dtype], ctypes.c_void_p(stream))
    _raise_on(lib, rc, name)
    LAUNCHES[name] += 1
    return arena, scale_arena, err


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


_FLASH_BODY_CODE = {"scalar": 0, "wmma": 1, "wgmma": 2}
_WGMMA_HEAD_SIZES = (64, 128)


def _flash_smem(kind: str, R: int, KT: int, hs: int, esize: int, body: str) -> int:
    """Bytes of shared memory of one block of body ``body`` (the ``*_smem``
    functions of ``csrc/flash_attention.cu``)."""
    if body == "wgmma":             # bf16 tiles; 1024 bytes of alignment slack
        def t(rows):
            return rows * hs * 2

        if kind == "fwd":
            return 1024 + 2 * (t(64) + 4 * t(64))
        if kind == "dq":
            return 1024 + 2 * (2 * t(64) + 4 * t(64))
        return 1024 + 2 * (2 * t(64) + 2 * (2 * t(64) + 1024))
    tp, fp = (16 // esize, 4) if body == "wmma" else (1, 1)

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


def flash_body(kind: str, hs: int, dtype, tensors=()) -> tuple[str, int, int]:
    """``(body, R, KT)``: the body the flash kernel ``kind`` ("fwd", "dq",
    "dkv") runs for these inputs on the card, with its query rows and keys
    per tile.  ``"wgmma"``: bf16 at hs 64 or 128 with every tensor 16-byte
    aligned (Hopper warpgroup products, register accumulators; 64 rows per
    warpgroup, 64 keys per tile).  ``"wmma"``: other bf16 head sizes that
    are multiples of 16, aligned (16x16 tensor-core tiles through shared
    memory).  ``"scalar"``: float32, or unaligned tensors.  The last two take
    the first of ``_FLASH_TILES`` whose shared memory fits a block.  Query
    and key lengths are multiples of 128 (:func:`flash_supported`)."""
    aligned = all(t.data_ptr() % 16 == 0 for t in tensors)
    if dtype == torch.bfloat16 and aligned and hs in _WGMMA_HEAD_SIZES:
        return "wgmma", 64, 64
    body = "wmma" if dtype == torch.bfloat16 and aligned and hs % 16 == 0 else "scalar"
    esize = torch.empty((), dtype=dtype).element_size()
    R, KT = next(rk for rk in _FLASH_TILES
                 if _flash_smem(kind, *rk, hs, esize, body) <= _MAX_SMEM_BYTES)
    return body, R, KT


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
    _, R, KT = flash_body("fwd", hs, q.dtype)
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
    """The ints every flash entry point shares, before (R, KT, body)."""
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
    body, R, KT = flash_body("fwd", hs, q.dtype, (q, k, v))
    lib = _build.load_library()
    out = torch.empty_like(q)
    lse = torch.empty((*batch, Tq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.tt_flash_fwd(
            _ptr(q), _ptr(k), _ptr(v), None if mask3 is None else _ptr(mask3), _ptr(out),
            _ptr(lse), *ints, R, KT, _FLASH_BODY_CODE[body], ctypes.c_float(scale),
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
    mask3, ints = _flash_args(q, k, mask, causal, window)
    delta = (g.float() * out.float()).sum(dim=-1)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        _flash_bwd_dq(g, q, k, v, lse, delta, mask3, ints, scale, dq)
        LAUNCHES["flash_bwd_dq"] += 1
        _flash_bwd_dkv(g, q, k, v, lse, delta, mask3, ints, scale, dk, dv)
        LAUNCHES["flash_bwd_dkv"] += 1
    return dq, dk, dv


def _flash_bwd_dq(g, q, k, v, lse, delta, mask3, ints, scale, dq) -> None:
    """Launches the dq kernel on the current stream (``flash_sdpa_backward``'s
    first launch; uncounted here)."""
    lib = _build.load_library()
    body, R, KT = flash_body("dq", q.shape[-1], q.dtype, (g, q, k, v, lse, delta))
    rc = lib.tt_flash_bwd_dq(
        _ptr(g), _ptr(q), _ptr(k), _ptr(v), _ptr(lse), _ptr(delta),
        None if mask3 is None else _ptr(mask3), _ptr(dq), *ints, R, KT, _FLASH_BODY_CODE[body],
        ctypes.c_float(scale), _FLASH_DTYPE_CODE[q.dtype],
        ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream))
    _raise_on(lib, rc, "flash_sdpa_backward (dq)")


def dkv_splits(H: int, G: int, body: str) -> int:
    """Blocks that share each KV group's q heads in the dk/dv kernel: 2 on
    the warpgroup body when the group has an even number of heads (twice
    the blocks, so a causal grid's long key tiles no longer pace one lopsided
    wave; the two f32 partials are added in a fixed order), else 1."""
    return 2 if body == "wgmma" and (H // G) % 2 == 0 else 1


def _flash_bwd_dkv(g, q, k, v, lse, delta, mask3, ints, scale, dk, dv) -> None:
    """Launches the dk/dv kernel (and, when the heads are split, the sum of
    the partials) on the current stream; uncounted here."""
    lib = _build.load_library()
    body, R, KT = flash_body("dkv", q.shape[-1], q.dtype, (g, q, k, v, lse, delta))
    BH, BG, H, G = _geometry(tuple(q.shape), tuple(k.shape))
    nsplit = dkv_splits(H, G, body)
    partial = (torch.empty((2, nsplit, BG, k.shape[-2], k.shape[-1]), dtype=torch.float32,
                           device=q.device) if nsplit > 1 else None)
    rc = lib.tt_flash_bwd_dkv(
        _ptr(g), _ptr(q), _ptr(k), _ptr(v), _ptr(lse), _ptr(delta),
        None if mask3 is None else _ptr(mask3), _ptr(dk), _ptr(dv),
        None if partial is None else _ptr(partial), *ints, R, KT, _FLASH_BODY_CODE[body], nsplit,
        ctypes.c_float(scale), _FLASH_DTYPE_CODE[q.dtype],
        ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream))
    _raise_on(lib, rc, "flash_sdpa_backward (dk/dv)")


#
# flash_cross_entropy: the training step's loss
#

_CE_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 2}


def ce_supported(logits_shape, target_shape, dtype) -> bool:
    """Whether :func:`flash_cross_entropy` takes these inputs: 2-D float32
    or bfloat16 logits with at least one column and (N,) targets.  The
    kernel takes any N and V (a scalar walk where V is no multiple of the
    vector width), so this admits every shape the JAX package's
    ``_ce_supported`` (``pallasex.py:947``) does, and also those its TPU
    tiling refuses."""
    return (len(logits_shape) == 2 and tuple(target_shape) == (logits_shape[0],)
            and logits_shape[1] >= 1 and dtype in _CE_DTYPE_CODE)


def flash_cross_entropy_plain(logits, target):
    """Plain PyTorch version of :func:`flash_cross_entropy`, the formula of
    ``jaxex._cross_entropy_fwd_reference`` (``jaxex.py:594``): float32
    ``lse = logsumexp(logits)`` and ``loss = lse - logits[target]``."""
    lg = logits.float()
    lse = torch.logsumexp(lg, dim=-1)
    picked = lg.gather(1, target.long()[:, None])[:, 0]
    return lse - picked, lse


def flash_cross_entropy(logits, target):
    """Row losses and logsumexps of (N, V) logits: ``(loss, lse)``, both
    (N,) float32, from one pass over each row (``csrc/cross_entropy.cu``).
    ``logits``: float32 or bfloat16; ``target``: (N,) integer class ids in
    [0, V)."""
    name = "flash_cross_entropy"
    _require(isinstance(logits, torch.Tensor) and isinstance(target, torch.Tensor),
             f"{name}: logits and target must be tensors")
    _require(target.device == logits.device,
             f"{name}: target is on {target.device}, logits on {logits.device}")
    _require(logits.device.type in ("cpu", "cuda"), f"{name}: unsupported device {logits.device}")
    _require(logits.ndim == 2 and logits.dtype in _CE_DTYPE_CODE,
             f"{name}: logits must be 2-D float32 or bfloat16, got {logits.dtype} "
             f"{tuple(logits.shape)}")
    N, V = logits.shape
    _require(tuple(target.shape) == (N,) and not target.is_floating_point(),
             f"{name}: target must be integer ({N},), got {target.dtype} {tuple(target.shape)}")
    _require(V >= 1, f"{name}: logits have no columns")
    if logits.device.type == "cpu":
        return flash_cross_entropy_plain(logits, target)
    if N == 0:                      # an empty grid: nothing to launch
        empty = torch.empty(0, dtype=torch.float32, device=logits.device)
        return empty, empty.clone()
    logits = logits.contiguous()
    tgt = target.to(torch.int32).contiguous()
    width = 16 // logits.element_size()
    vec = width if V % width == 0 and logits.data_ptr() % 16 == 0 else 1
    lib = _build.load_library()
    loss = torch.empty(N, dtype=torch.float32, device=logits.device)
    lse = torch.empty(N, dtype=torch.float32, device=logits.device)
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream(logits.device).cuda_stream
        rc = lib.tt_flash_ce(_ptr(logits), _ptr(tgt), _ptr(loss), _ptr(lse), N, V, vec,
                             _CE_DTYPE_CODE[logits.dtype], ctypes.c_void_p(stream))
    _raise_on(lib, rc, name)
    LAUNCHES["flash_ce"] += 1
    return loss, lse


#
# lora_delta_fused: the per-request adapter delta of the serving paths
#

_LORA_ROWS, _LORA_COLS = 16, 128


def _as_dtype_scalar(value: float, dtype) -> float:
    """``value`` rounded to ``dtype``: the reference multiplies by a weakly
    typed Python scalar, which takes the array's dtype first."""
    return float(torch.tensor(float(value), dtype=dtype))


def lora_delta_fused_plain(x, a, b, scaling):
    """Plain PyTorch version of :func:`lora_delta_fused`: the factors
    rounded to x's dtype, ``d = x·Aᵀ`` accumulated in float32 and rounded to
    x's dtype, ``d·Bᵀ`` likewise, then times ``scaling`` (rounded to x's
    dtype) in float32 and rounded once more."""
    ft = _acc_dtype(x.dtype)
    d = torch.matmul(x.to(ft), a.to(x.dtype).to(ft).transpose(-1, -2)).to(x.dtype)
    o = torch.matmul(d.to(ft), b.to(x.dtype).to(ft).transpose(-1, -2)).to(x.dtype)
    return (o.to(ft) * _as_dtype_scalar(scaling, x.dtype)).to(x.dtype)


_SM_COUNT: dict = {}


def _lora_split(dev, B: int, T: int, fout: int) -> int:
    """Blocks along fout: enough for about two blocks per SM in all, at most
    one per 128-column tile."""
    if dev not in _SM_COUNT:
        _SM_COUNT[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    tiles = -(-fout // _LORA_COLS)
    rows = B * -(-T // _LORA_ROWS)
    return max(1, min(tiles, -(-2 * _SM_COUNT[dev] // rows)))


def lora_delta_fused(x, a, b, scaling):
    """Per-request LoRA delta ``scaling·(x·Aᵀ)·Bᵀ`` (``csrc/lora_delta.cu``).

    ``x``: (B, T, fin) float32/float16/bfloat16, contiguous; ``a``:
    (B, r, fin) and ``b``: (B, fout, r) at the registry's dtype, each
    request's slab contiguous (a per-layer view ``stack[:, l]`` of a
    (B, L, ...) stack is taken as it is), any rank ``r`` (the kernel walks
    it in chunks of 64 with one f32 accumulator per output element).
    Returns (B, T, fout) at x's dtype, with the reference's rounding points
    (see :func:`lora_delta_fused_plain`)."""
    name = "lora_delta_fused"
    for arg, t in (("x", x), ("a", a), ("b", b)):
        _require(isinstance(t, torch.Tensor) and t.ndim == 3,
                 f"{name}: {arg} must be a 3-D tensor")
        _require(t.device == x.device, f"{name}: {arg} is on {t.device}, x on {x.device}")
        _require(t.dtype in _DTYPE_CODE,
                 f"{name}: {arg} must be float32/float16/bfloat16, got {t.dtype}")
    _require(x.device.type in ("cpu", "cuda"), f"{name}: unsupported device {x.device}")
    B, T, fin = x.shape
    r, fout = a.shape[1], b.shape[1]
    _require(tuple(a.shape) == (B, r, fin) and tuple(b.shape) == (B, fout, r),
             f"{name}: want a (B, r, fin) and b (B, fout, r) for x {tuple(x.shape)}, got "
             f"{tuple(a.shape)} and {tuple(b.shape)}")
    _require(a.dtype == b.dtype, f"{name}: a and b must share one dtype")
    _require(r >= 1, f"{name}: the rank must be at least 1, got {r}")
    if x.device.type == "cpu":
        return lora_delta_fused_plain(x, a, b, scaling)
    _require(x.is_contiguous(), f"{name}: x must be contiguous")
    for arg, t, inner in (("a", a, fin), ("b", b, r)):
        _require(t.stride(2) == 1 and t.stride(1) == inner,
                 f"{name}: each request's {arg} must be one contiguous slab")
    out = torch.empty((B, T, fout), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    _require(fin >= 1, f"{name}: fin must be at least 1")
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.tt_lora_delta(
            _ptr(x), _ptr(a), _ptr(b), _ptr(out), B, T, fin, fout, r, a.stride(0), b.stride(0),
            _lora_split(x.device, B, T, fout), ctypes.c_float(scaling), _DTYPE_CODE[x.dtype],
            _DTYPE_CODE[a.dtype], ctypes.c_void_p(stream))
    _raise_on(lib, rc, name)
    LAUNCHES["lora_delta_fused"] += 1
    return out
