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

the engine lands K and V together, reading the forward's values in place
(no staging copy): :func:`paged_token_write_pair` writes both arenas of a
decode step, a verify round (every offset) or a multi-step iteration in
one launch of the token-write kernel, :func:`paged_token_write_fused_pair`
the same into quantized arenas, :func:`paged_chunk_write_pair` both arenas
of a chunk piece off the forward's (1, L, ng, T, hs) values in one launch,
and :func:`paged_chunk_write_fused_pair` both quantized arenas of a chunk
piece in one pass;

``paged_attn_decode`` and ``paged_attn_verify`` read quantized arenas too
(``k_scale``/``v_scale``): each tile is dequantized as it is loaded,
``f32(x) * scale`` rounded to the compute dtype and then to the query
dtype, as the Pallas kernels round (``pallasex.py:1094-1098``).
:func:`paged_body` names the kernel body each call takes on the card:
split-K (``"split"``: every decode, and verify at rep·T <= 64, with
:func:`paged_splits` splits from shapes alone), the Hopper warpgroup body
(``"wg"``), the WMMA body (``"mma"``) or the scalar one (``"scalar"``);

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

import contextlib
import contextvars
import ctypes
import functools

import numpy as np
import torch

from thunder_tpu_torch.executors import _build

__all__ = [
    "DISPATCH",
    "LAUNCHES",
    "MASK_VALUE",
    "active_mesh",
    "causal_keep",
    "ce_supported",
    "chunk_blocks",
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
    "lora_plan",
    "mesh_context",
    "paged_attn_decode",
    "paged_attn_decode_plain",
    "paged_attn_verify",
    "paged_attn_verify_plain",
    "paged_available",
    "paged_body",
    "paged_chunk_write",
    "paged_chunk_write_fused",
    "paged_chunk_write_fused_pair",
    "paged_chunk_write_fused_pair_plain",
    "paged_chunk_write_fused_plain",
    "paged_chunk_write_pair",
    "paged_chunk_write_pair_plain",
    "paged_chunk_write_plain",
    "paged_kernels_decline",
    "paged_splits",
    "paged_token_write",
    "paged_token_write_fused",
    "paged_token_write_fused_pair",
    "paged_token_write_fused_pair_plain",
    "paged_token_write_fused_plain",
    "paged_token_write_masked",
    "paged_token_write_masked_plain",
    "paged_token_write_pair",
    "paged_token_write_pair_plain",
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


# Sharded dispatch (``pallasex.mesh_context``/``_dispatch``, :57-75 and
# :656-690, and the CE's row sharding, :984-990).  The reference wraps its
# kernels in ``shard_map`` over the mesh's batch axes, so each chip runs the
# single-device kernel on its shard.  In the port each rank is a process and
# the sharded train step hands its programs the rank's local batch, so the
# kernels already run on the shard; the step publishes its mesh here while
# its programs run, and ``DISPATCH`` counts the training kernels' calls by
# path: ``"sharded"`` inside a mesh context (any mesh, one rank included),
# ``"direct"`` outside, as ``pallasex.stats`` counts them.
_mesh_var = contextvars.ContextVar("cuda_mesh", default=None)

#: calls of flash_sdpa, flash_sdpa_backward and flash_cross_entropy by path
DISPATCH = {"direct": 0, "sharded": 0}


@contextlib.contextmanager
def mesh_context(mesh):
    """Publishes ``mesh`` (a ``DeviceMesh``) while a sharded step's programs
    run: the dist prims resolve their axis names on it."""
    tok = _mesh_var.set(mesh)
    try:
        yield
    finally:
        _mesh_var.reset(tok)


def active_mesh():
    """The mesh of the innermost :func:`mesh_context`, or None."""
    return _mesh_var.get()


def _count_dispatch() -> None:
    DISPATCH["sharded" if _mesh_var.get() is not None else "direct"] += 1


def paged_available() -> bool:
    """Whether the CUDA kernels can run here: a card and a compiler to
    build them with.  Without either, CPU tensors still take the plain
    versions."""
    return torch.cuda.is_available() and _build.nvcc_path() is not None


def _require(cond: bool, msg) -> None:
    """Raises ValueError(msg) unless ``cond``; ``msg`` may be a callable that
    makes the message, so a passing check formats nothing."""
    if not cond:
        raise ValueError(msg() if callable(msg) else msg)


def _check_common(name: str, tensors: dict, tables, pos, B: int) -> torch.device:
    dev, index = tables.device, tables.get_device()   # index: -1 off CUDA
    for arg, t in tensors.items():
        if (isinstance(t, torch.Tensor) and index >= 0 and t.get_device() == index
                and t.is_contiguous()):
            continue                     # the fast path of a card's tensors
        _require(isinstance(t, torch.Tensor), lambda: f"{name}: {arg} must be a tensor")
        _require(t.device == dev, lambda: f"{name}: {arg} is on {t.device}, tables on {dev}")
        _require(t.is_contiguous(), lambda: f"{name}: {arg} must be contiguous")
    _require(tables.dtype == torch.int32 and tables.ndim == 2 and tables.shape[0] == B,
             lambda: f"{name}: tables must be int32 (B={B}, nbb), got {tables.dtype} "
                     f"{tuple(tables.shape)}")
    _require(pos.dtype == torch.int32 and tuple(pos.shape) == (B,),
             lambda: f"{name}: pos must be int32 ({B},), got {pos.dtype} {tuple(pos.shape)}")
    _require(tables.shape[1] >= 1, lambda: f"{name}: tables need at least one column")
    _require(dev.type in ("cpu", "cuda"), lambda: f"{name}: unsupported device {dev}")
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
                 lambda: f"{name}: arena dtype must be float32/float16/bfloat16 (or int8/fp8 with "
                 f"k_scale/v_scale), got {k_arena.dtype}")
        _require(v_arena.dtype == k_arena.dtype == fresh_k.dtype == fresh_v.dtype,
                 lambda: f"{name}: arenas and fresh K/V must share one dtype")
        return False
    _require(k_scale is not None and v_scale is not None,
             lambda: f"{name}: k_scale and v_scale go together: pass both or neither")
    _require(k_arena.dtype in _QUANT_CODE and v_arena.dtype == k_arena.dtype,
             lambda: f"{name}: scaled arenas must both be int8 or float8_e4m3fn, got "
             f"{k_arena.dtype} {v_arena.dtype}")
    want = tuple(k_arena.shape[:-1])
    for arg, t in (("k_scale", k_scale), ("v_scale", v_scale)):
        _require(t.dtype == torch.float32 and tuple(t.shape) == want,
                 lambda: f"{name}: {arg} must be float32 {want}, got {t.dtype} {tuple(t.shape)}")
    _require(fresh_k.dtype in _DTYPE_CODE and fresh_v.dtype == fresh_k.dtype,
             lambda: f"{name}: fresh K/V must share one compute dtype (float32/float16/bfloat16), "
             f"got {fresh_k.dtype} {fresh_v.dtype}")
    return True


# The split-K body (csrc/paged_attention.cu) serves every decode call and the
# verify calls of at most _SPLIT_MAX_ROWS query rows; its block count aims
# at _SPLIT_TARGET_BLOCKS (two waves of two blocks per SM on the H100's 132).
_SPLIT_MAX_ROWS = 64
_SPLIT_ROW_TILE = 64          # query rows per block of the mma.sync products
_SPLIT_MMA_BS = 16            # the block size the mma.sync products take
_SPLIT_TARGET_BLOCKS = 4 * 132
_SPLIT_MAX = 64               # kMaxSplits
_LOWP = (torch.float16, torch.bfloat16)
PAGED_BODIES = ("wg", "split", "mma", "scalar")
_PAGED_BODY_CODE = {"scalar": 0, "mma": 1, "wg": 2}
_SPLIT_PRODUCTS_CODE = {"fma": 0, "mma": 1}


def _lowp_types(q_dtype, kv_dtype, c_dtype) -> bool:
    """bf16 or f16 queries and fresh K/V, the arena in that type or
    quantized: the types the tensor-core bodies take."""
    return (q_dtype in _LOWP and c_dtype == q_dtype
            and (kv_dtype == q_dtype or kv_dtype in _QUANT_CODE))


def _verify_mma_smem(R: int, hs: int, bs: int) -> int:
    """Bytes of shared memory of one WMMA verify block (``verify_mma_smem_bytes``
    in ``csrc/paged_verify.cu``): R query rows, key tiles of up to 64 keys."""
    KT = bs * (1 if bs >= 64 else 64 // bs)
    return (2 * ((R + 2 * KT) * (hs + 8) + R * (KT + 8)) + 4 * R * (hs + 4)
            + 4 * R * (KT + 4) + 12 * R)


def _split_fma_smem(RT: int, hs: int, bs: int) -> int:
    """Bytes of shared memory of one split block on FMA products
    (``fma_split_floats``): RT query rows and their accumulators, one K and
    V block, the scores and the softmax state, all f32."""
    return 4 * (RT * (hs + 1) + RT * hs + bs * (hs + 1) + bs * hs + RT * bs + 3 * RT)


def _split_products(hs: int, bs: int, q_dtype, kv_dtype, c_dtype) -> str:
    """The split body's products: ``"mma"`` (mma.sync tensor-core tiles) for
    the low-precision types at bs 16 and hs a multiple of 16 up to 128, else
    ``"fma"``."""
    mma = (_lowp_types(q_dtype, kv_dtype, c_dtype) and bs == _SPLIT_MMA_BS and hs % 16 == 0
           and hs <= 128)
    return "mma" if mma else "fma"


def _split_row_tile(rows: int, hs: int, bs: int, products: str) -> int | None:
    """Query rows per split block: 64 on the mma.sync products; on the FMA
    products min(rows, 64), halved until the block's shared memory fits;
    None when even one row does not."""
    if products == "mma":
        return _SPLIT_ROW_TILE
    RT = min(rows, _SPLIT_ROW_TILE)
    while RT >= 1:
        if _split_fma_smem(RT, hs, bs) <= _MAX_SMEM_BYTES:
            return RT
        RT //= 2
    return None


def paged_splits(B: int, ng: int, row_tiles: int, nbb: int) -> int:
    """Splits of the arena walk of every (request, group, row tile) of a
    split-body call, from shapes alone: enough for about
    ``_SPLIT_TARGET_BLOCKS`` blocks, at most half the table's width (two
    blocks a split when the table is full) and ``_SPLIT_MAX``.  Never from
    ``pos`` or the tables' values: no launch reads a device value on the
    host."""
    blocks = max(1, B * ng * row_tiles)
    return max(1, min(-(-_SPLIT_TARGET_BLOCKS // blocks), -(-nbb // 2), _SPLIT_MAX))


def paged_body(kind: str, rows: int, hs: int, bs: int, q_dtype, kv_dtype, c_dtype=None) -> str:
    """The kernel body a ``paged_attn_decode`` (``kind="decode"``) or
    ``paged_attn_verify`` (``"verify"``) call with ``rows`` = rep·T query
    rows per (request, group) takes on the card: ``"split"`` (split-K,
    ``csrc/paged_attention.cu``) for every decode and every verify of at
    most 64 rows; else ``"wg"`` (Hopper warpgroup, ``csrc/paged_verify.cu``)
    for bf16/f16 at hs 64 or 128 with ``64 % bs == 0``, ``"mma"`` (WMMA) for
    bf16/f16 at other multiples of 16, ``"scalar"`` otherwise (float32).
    ``c_dtype``: the fresh K/V's dtype (default: ``q_dtype`` beside a
    quantized arena, else the arena's)."""
    if c_dtype is None:
        c_dtype = q_dtype if kv_dtype in _QUANT_CODE else kv_dtype
    if kind == "decode" or rows <= _SPLIT_MAX_ROWS:
        return "split"
    lowp = _lowp_types(q_dtype, kv_dtype, c_dtype) and hs % 16 == 0 and bs % 16 == 0
    if lowp and hs in (64, 128) and 64 % bs == 0:
        return "wg"
    if lowp and _verify_mma_smem(64, hs, bs) <= _MAX_SMEM_BYTES:
        return "mma"
    return "scalar"


def paged_kernels_decline(rep: int, bs: int, hs: int) -> str:
    """Why the paged attention kernels cannot serve ``rep`` query heads per
    KV group at block size ``bs`` and head size ``hs`` on the card, or ""
    when they can.  The split body on FMA products (which takes every type)
    must fit one block's shared memory at a single query row; so must the
    verify kernel's scalar body at its smallest tile (16 query rows), which
    takes every many-row shape the tensor-core bodies refuse."""
    smem = _split_fma_smem(1, hs, bs)
    if smem > _MAX_SMEM_BYTES:
        return (f"paged_attn_decode needs {smem} B of shared memory for rep={rep}, bs={bs}, "
                f"hs={hs} (limit {_MAX_SMEM_BYTES})")
    if _verify_rows_per_block(16, hs, bs) is None:
        return (f"paged_attn_verify needs more than {_MAX_SMEM_BYTES} B of shared memory for "
                f"bs={bs}, hs={hs} even at 16 rows per block")
    return ""


def _split_range(pos, bs: int, nbb: int, window, s: int, splits: int):
    """Split ``s``'s share ``[jb, je)`` of each request's live arena blocks
    (``split_range`` in ``csrc/paged_attention.cu``): slots ``[0, pos)``
    clipped to the window, the table bounding the walk, cut into ``splits``
    contiguous shares of ``ceil(n / splits)`` blocks."""
    p = pos.long()
    hi = torch.clamp((p + bs - 1) // bs, max=nbb)
    lo = (torch.clamp(p - (window - 1), min=0) // bs if window is not None
          else torch.zeros_like(p))
    n = torch.clamp(hi - lo, min=0)
    per = (n + splits - 1) // splits
    jb = torch.minimum(lo + s * per, lo + n)
    return jb, torch.minimum(jb + per, lo + n)


def _arena_walk(qf, k_arena, v_arena, k_scale, v_scale, tables, pos, jb, je, *, layer: int,
                dt, cdtype, window):
    """Online softmax over each request's arena blocks ``[jb, je)`` in table
    order, one step per block: the (m, l, acc) of the (B, ng, rows, hs)
    float32 queries ``qf``, with the kernels' numerics."""
    B, ng, rows, hs = qf.shape
    bs, nbb = k_arena.shape[3], tables.shape[1]
    sm = float(np.sqrt(hs))
    m = torch.full((B, ng, rows, 1), MASK_VALUE, dtype=torch.float32, device=qf.device)
    l = torch.zeros((B, ng, rows, 1), dtype=torch.float32, device=qf.device)
    acc = torch.zeros((B, ng, rows, hs), dtype=torch.float32, device=qf.device)
    p_i = pos.long()
    t = torch.arange(bs, device=qf.device)
    for j in range(nbb):
        run = (j >= jb) & (j < je)
        if not bool(run.any()):
            continue
        blk = tables[:, j].long()
        k = _kv_tile(k_arena, k_scale, blk, layer, cdtype, dt)     # (B, ng, bs, hs)
        v = _kv_tile(v_arena, v_scale, blk, layer, cdtype, dt)
        s = torch.matmul(qf, k.transpose(-1, -2)) / sm         # (B, ng, rows, bs)
        slot = j * bs + t
        keep = slot[None, :] < p_i[:, None]
        if window is not None:
            keep = keep & (slot[None, :] > p_i[:, None] - window)
        s = torch.where(keep[:, None, None, :], s, MASK_VALUE)
        m_new, l_new, acc_new = _online(m, l, acc, s, v, dt)
        r = run[:, None, None, None]
        m, l, acc = torch.where(r, m_new, m), torch.where(r, l_new, l), torch.where(r, acc_new, acc)
    return m, l, acc


def _split_walk(qf, k_arena, v_arena, k_scale, v_scale, tables, pos, *, layer: int, dt, cdtype,
                window, splits: int):
    """The arena walk cut as the split body cuts it: each split's share
    walked alone, then the partials folded in split order (the combine
    kernel's fold).  ``splits=1`` is the one walk over every live block."""
    bs, nbb = k_arena.shape[3], tables.shape[1]
    kw = dict(layer=layer, dt=dt, cdtype=cdtype, window=window)
    if splits == 1:
        return _arena_walk(qf, k_arena, v_arena, k_scale, v_scale, tables, pos,
                           *_split_range(pos, bs, nbb, window, 0, 1), **kw)
    m = torch.full(qf.shape[:-1] + (1,), MASK_VALUE, dtype=torch.float32, device=qf.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(qf.shape, dtype=torch.float32, device=qf.device)
    for s in range(splits):
        ms, ls, accs = _arena_walk(qf, k_arena, v_arena, k_scale, v_scale, tables, pos,
                                   *_split_range(pos, bs, nbb, window, s, splits), **kw)
        mn = torch.maximum(m, ms)
        co, cs = torch.exp(m - mn), torch.exp(ms - mn)
        m, l, acc = mn, l * co + ls * cs, acc * co + accs * cs
    return m, l, acc


def paged_attn_decode_plain(q, k_arena, v_arena, fresh_k, fresh_v, tables, pos, *,
                            layer: int, k_scale=None, v_scale=None,
                            window: int | None = None, splits: int = 1):
    """Plain PyTorch version of :func:`paged_attn_decode`: the same walk
    over each request's live blocks in table order, one online-softmax step
    per block, the fresh token folded last, with the kernel's numerics.
    ``splits`` cuts the walk as the split-K body does (``splits`` shares
    folded in order); 1 walks every block in one pass."""
    B, nh, hs = q.shape
    ng = k_arena.shape[2]
    rep, dt, cdtype = nh // ng, q.dtype, fresh_k.dtype
    sm = float(np.sqrt(hs))
    qf = q.reshape(B, ng, rep, hs).float()
    m, l, acc = _split_walk(qf, k_arena, v_arena, k_scale, v_scale, tables, pos, layer=layer,
                            dt=dt, cdtype=cdtype, window=window, splits=splits)
    fk = fresh_k.to(dt).float()                                 # (B, ng, hs)
    fv = fresh_v.to(dt).float()
    s_f = torch.matmul(qf, fk[..., None]) / sm                  # (B, ng, rep, 1)
    m, l, acc = _online(m, l, acc, s_f, fv[:, :, None, :], dt)
    return (acc / l).to(dt).reshape(B, nh, hs)


@functools.lru_cache(maxsize=256)
def _split_plan(kind: str, q_shape, arena_shape, nbb: int, T: int, q_dtype, kv_dtype,
                c_dtype) -> dict:
    """The launch plan of one split-body call, from shapes and dtypes alone
    (no tensor value is read): the products, query rows per block
    (``row_tile``), the split count, the scalar arguments of
    ``tt_paged_attn_split`` before (``head``) and after (``tail``) ``layer``
    and ``window``, and the float count of the f32 partials."""
    B, nh, hs = q_shape[0], q_shape[1], q_shape[-1]
    _, L, ng, bs, _ = arena_shape
    rows = nh // ng * T
    products = _split_products(hs, bs, q_dtype, kv_dtype, c_dtype)
    RT = _split_row_tile(rows, hs, bs, products)
    _require(RT is not None, f"paged attention: bs={bs}, hs={hs} needs "
             f"{_split_fma_smem(1, hs, bs)} B of shared memory (limit {_MAX_SMEM_BYTES})")
    splits = paged_splits(B, ng, -(-rows // RT), nbb)
    tail = (splits, RT, float(np.sqrt(hs)), _DTYPE_CODE[q_dtype], _STORAGE_CODE[kv_dtype],
            _DTYPE_CODE[c_dtype], _SPLIT_PRODUCTS_CODE[products], 0 if kind == "decode" else 1)
    return dict(products=products, row_tile=RT, splits=splits,
                head=(B, ng, rows, T, hs, bs, nbb, L), tail=tail,
                n_partial=B * ng * splits * rows * (hs + 2))


def _launch_split(kind: str, dev, q, k_arena, v_arena, k_scale, v_scale, fresh_k, fresh_v,
                  tables, pos, *, T: int, layer: int, window):
    """Launches the split body (the split kernel and its combine kernel) on
    an f32 partials' scratch; returns the output."""
    plan = _split_plan(kind, q.shape, k_arena.shape, tables.shape[1], T, q.dtype,
                       k_arena.dtype, fresh_k.dtype)
    out = torch.empty_like(q)
    partial = torch.empty(plan["n_partial"], dtype=torch.float32, device=q.device)
    scales = (k_scale.data_ptr(), v_scale.data_ptr()) if k_scale is not None else (None, None)
    lib = _build.load_library()
    stream = torch._C._cuda_getCurrentRawStream(dev.index)   # current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.tt_paged_attn_split(
            q.data_ptr(), k_arena.data_ptr(), v_arena.data_ptr(), *scales, fresh_k.data_ptr(),
            fresh_v.data_ptr(), tables.data_ptr(), pos.data_ptr(), out.data_ptr(),
            partial.data_ptr(), *plan["head"], layer, 0 if window is None else int(window),
            *plan["tail"], stream)
    _raise_on(lib, rc, f"paged_attn_{kind}")
    del partial            # the stream orders its reuse after the kernels
    return out


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
    ``cfg.sliding_window``.  Returns (B, nh, hs) at ``q.dtype``.

    On the card every call takes the split-K body (:func:`paged_body`):
    the split kernel, then its combine kernel, one counted launch."""
    name = "paged_attn_decode"
    _require(q.ndim == 3 and k_arena.ndim == 5, lambda: f"{name}: q must be (B, nh, hs) and the "
             f"arenas (num_blocks, L, ng, bs, hs), got {tuple(q.shape)} {tuple(k_arena.shape)}")
    B, nh, hs = q.shape
    num_blocks, L, ng, bs, hs_a = k_arena.shape
    _require(tuple(v_arena.shape) == tuple(k_arena.shape),
             lambda: f"{name}: K/V arena shapes differ")
    _require(hs_a == hs and nh % ng == 0,
             lambda: f"{name}: q {tuple(q.shape)} does not fit arena {tuple(k_arena.shape)}")
    _require(tuple(fresh_k.shape) == (B, ng, hs) and tuple(fresh_v.shape) == (B, ng, hs),
             lambda: f"{name}: fresh K/V must be {(B, ng, hs)}")
    _require(q.dtype in _DTYPE_CODE,
             lambda: f"{name}: q dtype must be float32/float16/bfloat16, got {q.dtype}")
    quantized = _check_kv(name, k_arena, v_arena, fresh_k, fresh_v, k_scale, v_scale)
    _require(0 <= layer < L, lambda: f"{name}: layer {layer} out of range for L={L}")
    _require(window is None or window >= 1, lambda: f"{name}: window must be >= 1, got {window}")
    scales = dict(k_scale=k_scale, v_scale=v_scale) if quantized else {}
    dev = _check_common(name, dict(q=q, k_arena=k_arena, v_arena=v_arena, fresh_k=fresh_k,
                                   fresh_v=fresh_v, **scales), tables, pos, B)
    if dev.type == "cpu":
        return paged_attn_decode_plain(q, k_arena, v_arena, fresh_k, fresh_v, tables, pos,
                                       layer=layer, window=window, **scales)
    if B == 0:
        return torch.empty_like(q)
    out = _launch_split("decode", dev, q, k_arena, v_arena, k_scale if quantized else None,
                        v_scale if quantized else None, fresh_k, fresh_v, tables, pos, T=1,
                        layer=layer, window=window)
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


def paged_token_write_pair_plain(k_arena, v_arena, k_vals, v_vals, tables, pos, *,
                                 block_size: int, n_emit=None, offset: int = 0):
    """Plain PyTorch version of :func:`paged_token_write_pair` (in place):
    per arena, the single-offset plain writes of offsets ``offset`` ..
    ``offset + T - 1`` in order."""
    for arena, vals in ((k_arena, k_vals), (v_arena, v_vals)):
        if vals.ndim == arena.ndim - 1:
            vals = vals.unsqueeze(3)
        for t in range(vals.shape[3]):
            if n_emit is None:
                paged_token_write_plain(arena, vals[:, :, :, t], tables, pos + (offset + t),
                                        block_size=block_size)
            else:
                paged_token_write_masked_plain(arena, vals[:, :, :, t], tables, pos, n_emit,
                                               offset + t, block_size=block_size)
    return k_arena, v_arena


def _token_key(name: str, arenas: tuple, vals: tuple, scales: tuple, tables, pos, n_emit,
               offset: int, block_size: int) -> tuple:
    """What the checks read of a token write's arguments, flat: the first
    arena's device, every other tensor's card index (-1 off the card);
    ``scales`` holds the scale arenas of a quantized write, else nothing."""
    try:
        a0, v0 = arenas[0], vals[0]
        key = (name, offset, block_size, a0.device, a0.shape, a0.dtype, a0.is_contiguous(),
               v0.shape, v0.stride(), v0.dtype, v0.get_device(),
               tables.shape, tables.dtype, tables.get_device(), tables.is_contiguous(),
               pos.shape, pos.dtype, pos.get_device(), pos.is_contiguous(),
               None if n_emit is None else (n_emit.shape, n_emit.dtype, n_emit.get_device(),
                                            n_emit.is_contiguous()),
               tuple((s.shape, s.dtype, s.get_device(), s.is_contiguous()) for s in scales))
        if len(arenas) == 2:
            a1, v1 = arenas[1], vals[1]
            key += (a1.shape, a1.dtype, a1.get_device(), a1.is_contiguous(),
                    v1.shape, v1.stride(), v1.dtype, v1.get_device())
        return key
    except AttributeError:
        raise ValueError(f"{name}: arenas, {'scale arenas, ' if scales else ''}vals, tables, pos "
                         "(and n_emit, if given) must be tensors") from None


def _card(index: int) -> str:
    return "cpu" if index < 0 else f"cuda:{index}"


def _q_lanes(hs: int) -> tuple[int, int]:
    """(log2 G, 8-value pieces per lane) of the quantizing writes: a group
    of G lanes per slot-head (8 values a lane, G a power of two up to a
    warp)."""
    log2 = 0
    while log2 < 5 and 8 << log2 < hs:
        log2 += 1
    return log2, -(-hs // (8 << log2))


def _token_checked(key: tuple):
    """Validates one token write from its ``_token_key`` and returns what
    ``_TOKEN_CHECKED`` keeps for it: "cpu", "empty" (nothing to write), or
    the launch on the card: the kernel's geometry array, the vector widths
    that divide a row and the strides, the card; for a quantized write the
    geometry, whether the 16-byte path may take the shapes, the card, the
    storage and value dtype codes and f32(1/qmax)."""
    (name, offset, block_size, dev, ashape, adtype, acontig, vshape, vstride, vdtype, vdev,
     tshape, tdtype, tdev, tcontig, pshape, pdtype, pdev, pcontig, ne, scales, *second) = key
    pair, quant = bool(second), bool(scales)
    index = dev.index if dev.type == "cuda" else -1
    anames, vnames = (("k_arena", "v_arena"), ("k_vals", "v_vals")) if pair else (("arena",),
                                                                                  ("vals",))
    snames = ("k_scale", "v_scale") if pair else ("scale_arena",)
    strides = [vstride]
    if pair:
        a1shape, a1dtype, a1dev, a1contig, v1shape, v1stride, v1dtype, v1dev = second
        _require((a1shape, a1dtype, a1dev) == (ashape, adtype, index),
                 lambda: f"{name}: v_arena must match k_arena ({tuple(ashape)} {adtype} on "
                 f"{dev}), got {tuple(a1shape)} {a1dtype} on {_card(a1dev)}")
        _require((v1shape, v1dtype, v1dev) == (vshape, vdtype, vdev),
                 lambda: f"{name}: v_vals must match k_vals ({tuple(vshape)} {vdtype} on "
                 f"{_card(vdev)}), got {tuple(v1shape)} {v1dtype} on {_card(v1dev)}")
        _require(a1contig, lambda: f"{name}: v_arena must be contiguous")
        strides.append(v1stride)
    rank = len(ashape)
    _require(rank in ((5,) if quant else (4, 5))
             and len(vshape) in ((rank - 1, rank) if pair else (rank - 1,)),
             lambda: f"{name}: arena must be rank {'5' if quant else '4 or 5'} and vals one rank "
             f"lower{' (or of its rank, with T at dim 3)' if pair else ''}, got "
             f"{tuple(ashape)} and {tuple(vshape)}")
    B, bs = vshape[0], ashape[3]
    T = vshape[3] if len(vshape) == rank else 1
    want = (B, *ashape[1:3], *((T,) if len(vshape) == rank else ()), *ashape[4:])
    _require(tuple(vshape) == want,
             lambda: f"{name}: {vnames[0]} must be {want}, got {tuple(vshape)}")
    _require(block_size == bs, lambda: f"{name}: block_size={block_size} but the arena holds {bs}")
    if quant:
        _require(adtype in _QUANT_CODE,
                 lambda: f"{name}: the arena must be int8 or float8_e4m3fn, got {adtype}")
        _require(vdtype in _DTYPE_CODE,
                 lambda: f"{name}: vals must be at the compute dtype (float32/float16/bfloat16), "
                 f"got {vdtype}")
        for arg, (sshape, sdtype, sdev, scontig) in zip(snames, scales):
            _require(sdtype == torch.float32 and tuple(sshape) == tuple(ashape[:-1]),
                     lambda: f"{name}: {arg} must be float32 {tuple(ashape[:-1])}, got {sdtype} "
                     f"{tuple(sshape)}")
            _require(sdev == index, lambda: f"{name}: {arg} is on {_card(sdev)}, {anames[0]} on "
                     f"{dev}")
            _require(scontig, lambda: f"{name}: {arg} must be contiguous")
    else:
        _require(vdtype == adtype, lambda: f"{name}: vals dtype {vdtype} != arena dtype {adtype}")
    esize = torch.empty((), dtype=adtype).element_size()
    _require(esize in (1, 2, 4), lambda: f"{name}: unsupported dtype {adtype}")
    if ne is not None:
        nshape, ndtype, ndev, ncontig = ne
        _require(ndtype == torch.int32 and tuple(nshape) == (B,),
                 lambda: f"{name}: n_emit must be int32 ({B},), got {ndtype} {tuple(nshape)}")
    _require(offset >= 0, lambda: f"{name}: offset must be >= 0, got {offset}")
    for arg, d, contig in (("tables", tdev, tcontig), ("pos", pdev, pcontig),
                           *((("n_emit", ne[2], ne[3]),) if ne is not None else ()),
                           (vnames[0], vdev, True)):
        _require(d == index, lambda: f"{name}: {arg} is on {_card(d)}, {anames[0]} on {dev}")
        _require(contig, lambda: f"{name}: {arg} must be contiguous")
    _require(acontig, lambda: f"{name}: {anames[0]} must be contiguous")
    _require(tdtype == torch.int32 and len(tshape) == 2 and tshape[0] == B,
             lambda: f"{name}: tables must be int32 (B={B}, nbb), got {tdtype} {tuple(tshape)}")
    _require(pdtype == torch.int32 and tuple(pshape) == (B,),
             lambda: f"{name}: pos must be int32 ({B},), got {pdtype} {tuple(pshape)}")
    _require(tshape[1] >= 1, lambda: f"{name}: tables need at least one column")
    _require(dev.type in ("cpu", "cuda"), lambda: f"{name}: unsupported device {dev}")
    if dev.type == "cpu":
        return "cpu"
    if B == 0 or T == 0:
        return "empty"
    # each vals' strides in elements, read in place: the head's elements
    # contiguous, layer and group merged into one arena-row stride
    L, ng = ashape[1], ashape[2]
    hs = ashape[4] if rank == 5 else 1
    flat = []
    for arg, st in zip(vnames, strides):
        sb, sl, sg = st[:3]
        sr = sg if ng > 1 else sl
        _require((hs == 1 or st[-1] == 1) and (L == 1 or sl == ng * sr),
                 lambda: f"{name}: {arg} must hold each head's values contiguously and its "
                 f"layers at ng times its groups' stride, got strides {tuple(st)}")
        flat += [sb, sr, st[3] if len(vshape) == rank and T > 1 else 0]
    flat *= 2 // len(strides)            # one arena: its strides stand in for the second's
    if quant:
        log2, pieces = _q_lanes(hs)
        threads = min(256, -(-(L * ng << log2) // 32) * 32)
        geom = (B, T, L * ng, bs, hs, tshape[1], log2, pieces, threads, *flat)
        return ((ctypes.c_int64 * len(geom))(*geom), hs % 8 == 0 and all(x % 8 == 0 for x in flat),
                index, _QUANT_CODE[adtype], _DTYPE_CODE[vdtype], _quant().inv_qmax(adtype))
    geom = (B, T, L * ng, bs, tshape[1], hs * esize, *(x * esize for x in flat))
    widths = tuple(w for w in (16, 8, 4, 2, 1) if all(g % w == 0 for g in geom[5:]))
    return (ctypes.c_int64 * len(geom))(*geom), widths, index


# checked token writes by _token_key (see _token_checked); a call that fails
# a check raises and is not kept
_TOKEN_CHECKED: dict = {}


def _token_write(name: str, counter: str, arenas: tuple, vals: tuple, tables, pos, n_emit,
                 offset: int, block_size: int, scales: tuple = ()):
    """The token write of one arena or of both (``arenas``/``vals`` of one or
    two; quantizing when ``scales`` holds their scale arenas): checks kept
    by key, the plain version for CPU tensors, else one launch, counted
    under ``counter``.  Returns True when it launched or had nothing to
    write, False for the CPU (the caller runs the plain version)."""
    key = _token_key(name, arenas, vals, scales, tables, pos, n_emit, offset, block_size)
    launch = _TOKEN_CHECKED.get(key)
    if launch is None:
        launch = _token_checked(key)
        if len(_TOKEN_CHECKED) >= 256:
            _TOKEN_CHECKED.clear()
        _TOKEN_CHECKED[key] = launch
    if launch == "cpu":
        return False
    if launch == "empty":
        return True
    pa, va = arenas[0].data_ptr(), vals[0].data_ptr()
    pb, vb = (arenas[1].data_ptr(), vals[1].data_ptr()) if len(arenas) == 2 else (None, None)
    ne = None if n_emit is None else n_emit.data_ptr()
    index = launch[2]
    stream = torch._C._cuda_getCurrentRawStream(index)
    lib = _build.load_library()
    if scales:
        geom, vec_ok, _, kv_code, v_code, inv_qmax = launch
        sa, sb = (s.data_ptr() for s in scales) if len(scales) == 2 else (scales[0].data_ptr(),
                                                                           None)
        vec = int(vec_ok and (va | (vb or 0)) % 16 == 0 and (pa | (pb or 0)) % 8 == 0)
        fn = lib.tt_paged_token_write_fused
        args = (pa, pb, sa, sb, va, vb, tables.data_ptr(), pos.data_ptr(), ne, geom, offset,
                inv_qmax, kv_code, v_code, vec, stream)
    else:
        geom, widths, _ = launch
        at = pa | va | (pb or 0) | (vb or 0)
        vec = next(w for w in widths if at % w == 0)
        fn = lib.tt_paged_token_write
        args = (pa, pb, va, vb, tables.data_ptr(), pos.data_ptr(), ne, geom, offset, vec, stream)
    if index == torch._C._cuda_getDevice():
        rc = fn(*args)
    else:
        with torch.cuda.device(index):
            rc = fn(*args)
    if rc:
        _raise_on(lib, rc, name)
    LAUNCHES[counter] += 1
    return True


def paged_token_write(arena, vals, tables, pos, *, block_size: int):
    """In-place single-token arena write; returns ``arena`` itself.

    ``arena``: (num_blocks, L, ng, bs, hs) K/V arena — or a (num_blocks, L,
    ng, bs) scale arena; ``vals``: (B, L, ng, hs) (or (B, L, ng)) at the
    arena dtype, each head's values contiguous (read in place by its
    strides).  Row ``i`` lands in block ``tables[i, pos[i] // bs]``, slot
    ``pos[i] % bs``; batch-padding rows (all-sink tables, pos 0) land in
    sink block 0, which is never read.  The engine writes K and V of a
    step in one launch through :func:`paged_token_write_pair`."""
    if not _token_write("paged_token_write", "paged_token_write", (arena,), (vals,), tables,
                        pos, None, 0, block_size):
        paged_token_write_plain(arena, vals, tables, pos, block_size=block_size)
    return arena


def paged_token_write_masked(arena, vals, tables, pos, n_emit, offset: int, *, block_size: int):
    """In-place keep-masked single-token arena write; returns ``arena``.

    One chunk offset of the speculative commit and, at ``offset=0`` with
    ``n_emit`` the per-row liveness, the multi-step decode write.  Row ``i``
    lands ``vals[i]`` — the K/V (or scale) of chunk offset ``offset`` — at
    slot ``pos[i] + offset`` (block ``tables[i, (pos[i] + offset) // bs]``)
    iff ``offset < n_emit[i]``; otherwise it lands in sink block 0, slot 0,
    which is never read.  ``arena``/``vals`` as :func:`paged_token_write`;
    ``n_emit``: (B,) int32.  The engine commits K and V of every offset of
    a round in one launch through :func:`paged_token_write_pair`."""
    if not _token_write("paged_token_write_masked", "paged_token_write_masked", (arena,),
                        (vals,), tables, pos, n_emit, offset, block_size):
        paged_token_write_masked_plain(arena, vals, tables, pos, n_emit, offset,
                                       block_size=block_size)
    return arena


def paged_token_write_pair(k_arena, v_arena, k_vals, v_vals, tables, pos, *, block_size: int,
                           n_emit=None, offset: int = 0):
    """K and V of a whole decode step, verify round or multi-step iteration
    landed in one launch, in place; returns ``(k_arena, v_arena)``.

    ``k_arena``/``v_arena``: two arenas of one shape and dtype, as
    :func:`paged_token_write` takes them; ``k_vals``/``v_vals``: (B, L, ng,
    T, hs) (or (B, L, ng, T) for rank-4 arenas), or without the T dim for
    T = 1, at the arena dtype, read in place by their strides (each head's
    values contiguous, layers at ng times the groups' stride: a slice of the
    forward's (B, L, ng, T, hs) is taken as it is).  Offset ``t`` of row
    ``i`` is the write of chunk offset ``offset + t``: without ``n_emit``
    :func:`paged_token_write` at ``pos[i] + offset + t``, with ``n_emit``
    (B,) int32 :func:`paged_token_write_masked` (live iff ``offset + t <
    n_emit[i]``, else sink block 0, slot 0).  The live offsets of one row
    land at distinct slots, so the arenas equal those of the 2T sequential
    single-offset writes (:func:`paged_token_write_pair_plain`).  One
    launch, counted as ``paged_token_write`` (plain) or
    ``paged_token_write_masked`` (with ``n_emit``)."""
    counter = "paged_token_write" if n_emit is None else "paged_token_write_masked"
    if not _token_write("paged_token_write_pair", counter, (k_arena, v_arena), (k_vals, v_vals),
                        tables, pos, n_emit, offset, block_size):
        paged_token_write_pair_plain(k_arena, v_arena, k_vals, v_vals, tables, pos,
                                     block_size=block_size, n_emit=n_emit, offset=offset)
    return k_arena, v_arena


#
# paged_attn_verify
#


def paged_attn_verify_plain(q, k_arena, v_arena, fresh_k, fresh_v, tables, pos, *, layer: int,
                            k_scale=None, v_scale=None, splits: int = 1):
    """Plain PyTorch version of :func:`paged_attn_verify`: the decode walk
    over each request's live blocks at rep·T query rows (the arena keep-mask
    ``slot < pos`` is the same for every query), then the chunk's own K/V
    folded in one last online-softmax step under the causal mask ``col <=
    t``, with the kernel's numerics.  ``splits`` cuts the arena walk as the
    split-K body does; 1 walks every block in one pass."""
    B, nh, T, hs = q.shape
    ng = k_arena.shape[2]
    rep, dt, cdtype = nh // ng, q.dtype, fresh_k.dtype
    rows = rep * T
    sm = float(np.sqrt(hs))
    qf = q.reshape(B, ng, rows, hs).float()            # row r = rep_idx * T + t
    m, l, acc = _split_walk(qf, k_arena, v_arena, k_scale, v_scale, tables, pos, layer=layer,
                            dt=dt, cdtype=cdtype, window=None, splits=splits)
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
    are int8/fp8 (dequantized as each tile loads, in every kernel body);
    ``fresh_k``/``fresh_v``: (B, ng, T, hs) the chunk's own K/V at the
    compute dtype (not yet in the arena: a masked token write or a chunk
    write lands it after); ``tables``: (B, nbb) int32 sink-padded block
    tables; ``pos``: (B,) int32.  Every query sees the arena slots ``<
    pos`` and the chunk's keys up to its own offset.  No sliding window
    (windowed models take the gather path).  Returns (B, nh, T, hs) at
    ``q.dtype``.

    On the card the call takes the body :func:`paged_body` names: split-K
    (the split and combine kernels, one counted launch) at rep·T <= 64, the
    Hopper warpgroup body for bf16/f16 at hs 64/128, the WMMA body for
    bf16/f16 at other multiples of 16, the scalar one otherwise."""
    name = "paged_attn_verify"
    _require(q.ndim == 4 and k_arena.ndim == 5, lambda: f"{name}: q must be (B, nh, T, hs) and the "
             f"arenas (num_blocks, L, ng, bs, hs), got {tuple(q.shape)} {tuple(k_arena.shape)}")
    B, nh, T, hs = q.shape
    num_blocks, L, ng, bs, hs_a = k_arena.shape
    _require(tuple(v_arena.shape) == tuple(k_arena.shape),
             lambda: f"{name}: K/V arena shapes differ")
    _require(hs_a == hs and nh % ng == 0 and T >= 1,
             lambda: f"{name}: q {tuple(q.shape)} does not fit arena {tuple(k_arena.shape)}")
    _require(tuple(fresh_k.shape) == (B, ng, T, hs) and tuple(fresh_v.shape) == (B, ng, T, hs),
             lambda: f"{name}: fresh K/V must be {(B, ng, T, hs)}")
    _require(q.dtype in _DTYPE_CODE,
             lambda: f"{name}: q dtype must be float32/float16/bfloat16, got {q.dtype}")
    quantized = _check_kv(name, k_arena, v_arena, fresh_k, fresh_v, k_scale, v_scale)
    _require(0 <= layer < L, lambda: f"{name}: layer {layer} out of range for L={L}")
    scales = dict(k_scale=k_scale, v_scale=v_scale) if quantized else {}
    dev = _check_common(name, dict(q=q, k_arena=k_arena, v_arena=v_arena, fresh_k=fresh_k,
                                   fresh_v=fresh_v, **scales), tables, pos, B)
    if dev.type == "cpu":
        return paged_attn_verify_plain(q, k_arena, v_arena, fresh_k, fresh_v, tables, pos,
                                       layer=layer, **scales)
    out = torch.empty_like(q)
    if B == 0:
        return out
    rep, nbb = nh // ng, tables.shape[1]
    body = paged_body("verify", rep * T, hs, bs, q.dtype, k_arena.dtype, fresh_k.dtype)
    if body == "split":
        out = _launch_split("verify", dev, q, k_arena, v_arena, k_scale if quantized else None,
                            v_scale if quantized else None, fresh_k, fresh_v, tables, pos, T=T,
                            layer=layer, window=None)
        LAUNCHES[name] += 1
        return out
    R = _verify_rows_per_block(rep * T, hs, bs) if body == "scalar" else 0
    _require(R is not None, lambda: f"{name}: bs={bs}, hs={hs} needs more shared memory than "
             f"{_MAX_SMEM_BYTES} B even at 16 rows per block")
    lib = _build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        null = ctypes.c_void_p(0)
        rc = lib.tt_paged_attn_verify(
            _ptr(q), _ptr(k_arena), _ptr(v_arena),
            _ptr(k_scale) if quantized else null, _ptr(v_scale) if quantized else null,
            _ptr(fresh_k), _ptr(fresh_v), _ptr(tables), _ptr(pos), _ptr(out),
            B, ng, rep * T, T, hs, bs, nbb, L, layer, R,
            ctypes.c_float(float(np.sqrt(hs))), _DTYPE_CODE[q.dtype],
            _STORAGE_CODE[k_arena.dtype], _DTYPE_CODE[fresh_k.dtype], _PAGED_BODY_CODE[body],
            ctypes.c_void_p(stream))
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


def paged_chunk_write_pair_plain(k_arena, v_arena, k_vals, v_vals, dest, pos, *,
                                 block_size: int):
    """Plain PyTorch version of :func:`paged_chunk_write_pair`: the values
    folded into block granules (:func:`chunk_blocks`), then
    :func:`paged_chunk_write_plain` per arena."""
    for arena, vals in ((k_arena, k_vals), (v_arena, v_vals)):
        paged_chunk_write_plain(arena, chunk_blocks(vals, block_size), dest, pos,
                                block_size=block_size)
    return k_arena, v_arena


def _chunk_copy(name: str, arenas: tuple, vals: tuple, dest, pos, nc: int, strides: tuple):
    """One launch of the chunk-write kernel over ``arenas`` (one or two) and
    their values, read at ``strides`` (each arena's chunk-block and
    arena-row strides, in elements)."""
    arena = arenas[0]
    _, L, ng, bs, hs = arena.shape
    if nc == 0 or arena[0].numel() == 0:
        return
    esize = arena.element_size()
    strides = strides * (2 // len(arenas))
    geom = (nc, L * ng, bs, dest.shape[0], bs * hs * esize, *(x * esize for x in strides))
    at = 0
    for t in (*arenas, *vals):
        at |= t.data_ptr()
    vec = next(w for w in (16, 8, 4, 2, 1) if at % w == 0 and all(g % w == 0 for g in geom[4:]))
    ptrs = [t.data_ptr() for t in arenas] + [None] * (2 - len(arenas))
    vptrs = [t.data_ptr() for t in vals] + [None] * (2 - len(vals))
    lib = _build.load_library()
    with torch.cuda.device(arena.device):
        stream = torch.cuda.current_stream(arena.device).cuda_stream
        rc = lib.tt_paged_chunk_write(*ptrs, *vptrs, dest.data_ptr(), pos.data_ptr(),
                                      (ctypes.c_int64 * len(geom))(*geom), vec, stream)
    _raise_on(lib, rc, name)
    LAUNCHES["paged_chunk_write"] += 1


def paged_chunk_write(arena, vals, dest, pos, *, block_size: int):
    """In-place block-granule write of one prefill chunk's K (or V);
    returns ``arena`` itself.

    ``arena``: (num_blocks, L, ng, bs, hs); ``vals``: (nc, L, ng, bs, hs)
    the chunk's fresh K/V at the arena dtype, folded to block granules;
    ``dest``: (nbb,) int32 scatter table (``kv_pool.chunk_tables``: sink
    outside the chunk's own blocks); ``pos``: (1,) int32 block-aligned chunk
    start.  Chunk block ``c`` lands as one slab at ``dest[pos // bs + c]``,
    or in sink block 0 when that entry lies past the table.  The engine
    writes K and V of a piece in one launch through
    :func:`paged_chunk_write_pair`."""
    name = "paged_chunk_write"
    _require(arena.ndim == 5 and vals.ndim == 5 and tuple(vals.shape[1:]) == tuple(arena.shape[1:]),
             lambda: f"{name}: arena must be (num_blocks, L, ng, bs, hs) and vals (nc, L, ng, bs, "
             f"hs), got {tuple(arena.shape)} and {tuple(vals.shape)}")
    _require(block_size == arena.shape[3],
             lambda: f"{name}: block_size={block_size} but the arena holds {arena.shape[3]}")
    _require(vals.dtype == arena.dtype,
             lambda: f"{name}: vals dtype {vals.dtype} != arena dtype {arena.dtype}")
    _check_chunk_route(name, dest, pos)
    dev = _check_devices(name, dict(arena=arena, vals=vals, dest=dest, pos=pos))
    if dev.type == "cpu":
        return paged_chunk_write_plain(arena, vals, dest, pos, block_size=block_size)
    nc, L, ng, bs, hs = vals.shape
    _chunk_copy(name, (arena,), (vals,), dest, pos, nc, (L * ng * bs * hs, bs * hs))
    return arena


def paged_chunk_write_pair(k_arena, v_arena, k_vals, v_vals, dest, pos, *, block_size: int):
    """K and V of one chunked-prefill piece landed in their arenas in one
    launch, in place; returns ``(k_arena, v_arena)``.

    ``k_arena``/``v_arena``: two (num_blocks, L, ng, bs, hs) arenas of one
    shape and dtype; ``k_vals``/``v_vals``: (1, L, ng, T, hs) at the arena
    dtype, the layout ``forward_paged`` returns, read in place by their
    strides (chunk block ``c``, slot ``t`` is token ``c·bs + t``; T a
    multiple of the block size; each head's tokens contiguous, so the bs
    tokens of a chunk block and arena row are one contiguous run, as they
    are in the arena).  Each arena ends as :func:`paged_chunk_write` over
    the values folded into block granules leaves it
    (:func:`paged_chunk_write_pair_plain`); bits are moved as they are.  One
    launch, counted as ``paged_chunk_write``."""
    name = "paged_chunk_write_pair"
    _require(k_arena.ndim == 5, lambda: f"{name}: k_arena must be (num_blocks, L, ng, bs, hs), "
             f"got {tuple(k_arena.shape)}")
    _require(v_arena.shape == k_arena.shape and v_arena.dtype == k_arena.dtype,
             lambda: f"{name}: v_arena must match k_arena ({tuple(k_arena.shape)} "
             f"{k_arena.dtype}), got {tuple(v_arena.shape)} {v_arena.dtype}")
    _, L, ng, bs, hs = k_arena.shape
    _require(k_vals.ndim == 5 and k_vals.shape[:3] == (1, L, ng) and k_vals.shape[4] == hs,
             lambda: f"{name}: k_vals must be (1, {L}, {ng}, T, {hs}), got {tuple(k_vals.shape)}")
    _require(v_vals.shape == k_vals.shape and v_vals.dtype == k_vals.dtype,
             lambda: f"{name}: v_vals must match k_vals ({tuple(k_vals.shape)} {k_vals.dtype}), "
             f"got {tuple(v_vals.shape)} {v_vals.dtype}")
    T = k_vals.shape[3]
    _require(T % block_size == 0,
             lambda: f"{name}: T={T} of k_vals/v_vals is not a multiple of block_size={block_size}")
    _require(block_size == bs, lambda: f"{name}: block_size={block_size} but the arena holds {bs}")
    _require(k_vals.dtype == k_arena.dtype,
             lambda: f"{name}: vals dtype {k_vals.dtype} != arena dtype {k_arena.dtype}")
    _check_chunk_route(name, dest, pos)
    dev = _check_devices(name, dict(k_arena=k_arena, v_arena=v_arena, dest=dest, pos=pos))
    strides = ()
    for arg, v in (("k_vals", k_vals), ("v_vals", v_vals)):
        _require(v.device == dev, lambda: f"{name}: {arg} is on {v.device}, k_arena on {dev}")
        st = v.stride()
        sr = st[2] if ng > 1 else st[1]
        _require((hs == 1 or st[4] == 1) and (T == 1 or st[3] == hs)
                 and (L == 1 or st[1] == ng * sr),
                 lambda: f"{name}: {arg} must hold each head's tokens contiguously and its "
                 f"layers at ng times its groups' stride, got strides {tuple(st)}")
        strides += (bs * hs, sr)
    if dev.type == "cpu":
        return paged_chunk_write_pair_plain(k_arena, v_arena, k_vals, v_vals, dest, pos,
                                            block_size=block_size)
    _chunk_copy(name, (k_arena, v_arena), (k_vals, v_vals), dest, pos, T // bs, strides)
    return k_arena, v_arena


#
# paged_token_write_fused, paged_chunk_write_fused: quantize on write
#


def _check_quant_arena(name: str, arena, scale_arena, vals) -> None:
    _require(arena.dtype in _QUANT_CODE,
             lambda: f"{name}: the arena must be int8 or float8_e4m3fn, got {arena.dtype}")
    _require(scale_arena.dtype == torch.float32
             and tuple(scale_arena.shape) == tuple(arena.shape[:-1]),
             lambda: f"{name}: scale_arena must be float32 {tuple(arena.shape[:-1])}, got "
             f"{scale_arena.dtype} {tuple(scale_arena.shape)}")
    _require(vals.dtype in _DTYPE_CODE,
             lambda: f"{name}: vals must be at the compute dtype (float32/float16/bfloat16), "
             f"got {vals.dtype}")


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
    hs) at the compute dtype, read in place by its strides as
    :func:`paged_token_write` reads them.  Each (row, layer, group) vector
    is quantized exactly as ``serving.quant.quantize_kv`` does (the
    kernel's stored bytes
    and scales equal the plain version's, bit for bit) and lands with its
    scale at block ``tables[i, pos[i] // bs]``, slot ``pos[i] % bs``.  With
    ``n_emit`` (B,) int32 it is the keep-masked write of chunk offset
    ``offset`` (:func:`paged_token_write_masked`): row ``i`` lands at
    ``pos[i] + offset`` iff ``offset < n_emit[i]``, else in sink block 0,
    slot 0.  It launches the pair's kernel with one arena; the engine
    writes K and V of a step or round in one launch through
    :func:`paged_token_write_fused_pair`."""
    name = "paged_token_write_fused"
    _require(n_emit is not None or offset == 0,
             lambda: f"{name}: offset={offset} needs n_emit (the masked write)")
    if not _token_write(name, name, (arena,), (vals,), tables, pos, n_emit, offset, block_size,
                        scales=(scale_arena,)):
        paged_token_write_fused_plain(arena, scale_arena, vals, tables, pos,
                                      block_size=block_size, n_emit=n_emit, offset=offset)
    return arena, scale_arena


def paged_token_write_fused_pair_plain(k_arena, v_arena, k_scale, v_scale, k_vals, v_vals,
                                       tables, pos, *, block_size: int, n_emit=None,
                                       offset: int = 0):
    """Plain PyTorch version of :func:`paged_token_write_fused_pair` (in
    place): per arena, :func:`paged_token_write_fused_plain` of offsets
    ``offset`` .. ``offset + T - 1`` in order."""
    for arena, scale, vals in ((k_arena, k_scale, k_vals), (v_arena, v_scale, v_vals)):
        if vals.ndim == arena.ndim - 1:
            vals = vals.unsqueeze(3)
        for t in range(vals.shape[3]):
            paged_token_write_fused_plain(arena, scale, vals[:, :, :, t], tables, pos,
                                          block_size=block_size, n_emit=n_emit, offset=offset + t)
    return k_arena, v_arena, k_scale, v_scale


def paged_token_write_fused_pair(k_arena, v_arena, k_scale, v_scale, k_vals, v_vals, tables, pos,
                                 *, block_size: int, n_emit=None, offset: int = 0):
    """K and V of a whole decode step, verify round or multi-step iteration
    landed in their quantized arenas in one launch, quantizing on the way,
    in place; returns ``(k_arena, v_arena, k_scale, v_scale)``.

    ``k_arena``/``v_arena``: two (num_blocks, L, ng, bs, hs) arenas of one
    shape and dtype (int8 or float8_e4m3fn) with their (num_blocks, L, ng,
    bs) float32 scale arenas; ``k_vals``/``v_vals``: (B, L, ng, T, hs), or
    (B, L, ng, hs) for T = 1, at one compute dtype, read in place by their
    strides (each head's values contiguous, layers at ng times the groups'
    stride: the forward's (B, L, ng, T, hs) is taken as it is).  Offset
    ``t`` of row ``i`` is quantized as ``serving.quant.quantize_kv`` does
    and lands as chunk offset ``offset + t``: without ``n_emit`` at
    ``pos[i] + offset + t``, with ``n_emit`` (B,) int32 there iff ``offset
    + t < n_emit[i]``, else in sink block 0, slot 0.  The live offsets of
    one row land at distinct slots, so the arenas equal those of the 2T
    sequential single-offset writes
    (:func:`paged_token_write_fused_pair_plain`).  One launch, counted as
    ``paged_token_write_fused``."""
    if not _token_write("paged_token_write_fused_pair", "paged_token_write_fused",
                        (k_arena, v_arena), (k_vals, v_vals), tables, pos, n_emit, offset,
                        block_size, scales=(k_scale, v_scale)):
        paged_token_write_fused_pair_plain(k_arena, v_arena, k_scale, v_scale, k_vals, v_vals,
                                           tables, pos, block_size=block_size, n_emit=n_emit,
                                           offset=offset)
    return k_arena, v_arena, k_scale, v_scale


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


def chunk_blocks(x, block_size: int):
    """(1, L, ng, T, hs) chunk-fresh layout (what ``forward_paged`` returns
    for one chunk) → (T // bs, L, ng, bs, hs) block granules: chunk block
    ``c``, slot ``t`` is token ``c·bs + t`` (a transpose, made
    contiguous)."""
    _, L, ng, T, hs = x.shape
    return x[0].reshape(L, ng, T // block_size, block_size, hs).permute(2, 0, 1, 3, 4).contiguous()


def paged_chunk_write_fused_pair_plain(k_arena, v_arena, k_scale, v_scale, k_vals, v_vals, dest,
                                       pos, *, block_size: int):
    """Plain PyTorch version of :func:`paged_chunk_write_fused_pair`: the
    values folded into block granules (:func:`chunk_blocks`), then
    :func:`paged_chunk_write_fused_plain` per arena."""
    errs = [paged_chunk_write_fused_plain(a, s, chunk_blocks(v, block_size), dest, pos,
                                          block_size=block_size)[2]
            for a, s, v in ((k_arena, k_scale, k_vals), (v_arena, v_scale, v_vals))]
    return k_arena, v_arena, k_scale, v_scale, torch.stack(errs)


# the fused chunk kernel's plan: a group of G lanes per slot-head
# (_q_lanes), blocks of _CHUNK_Q_THREADS lanes walking _CHUNK_Q_ROUNDS
# slot-heads per group
_CHUNK_Q_THREADS = 256
_CHUNK_Q_ROUNDS = 8


def _chunk_q_plan(rows: int, bs: int, hs: int) -> tuple[int, int, int, int]:
    """(log2 G, 8-value pieces per lane, slot-heads per block, blocks per
    chunk block) of the fused chunk kernel, from shapes alone."""
    log2, pieces = _q_lanes(hs)
    spb = (_CHUNK_Q_THREADS >> log2) * _CHUNK_Q_ROUNDS
    return log2, pieces, spb, max(1, -(-rows * bs // spb))


def _chunk_q(name: str, arenas: tuple, scales: tuple, vals: tuple, dest, pos, nc: int,
             strides: tuple):
    """One launch of the fused chunk kernel over ``arenas`` (one or two, with
    their scale arenas and values); returns err (arenas, nc, 2)."""
    arena = arenas[0]
    _, L, ng, bs, hs = arena.shape
    dev = arena.device
    err_n = len(arenas) * nc * 2
    log2, pieces, spb, tiles = _chunk_q_plan(L * ng, bs, hs)
    buf = torch.empty(err_n + err_n * tiles, dtype=torch.float32, device=dev)
    err = buf[:err_n].view(len(arenas), nc, 2)
    if nc == 0:
        return err
    geom = (ctypes.c_int64 * 11)(nc, L * ng, bs, hs, dest.shape[0], *strides, log2, pieces, spb,
                                 tiles)
    ptrs = [(a.data_ptr(), s.data_ptr(), v.data_ptr()) for a, s, v in zip(arenas, scales, vals)]
    vec = hs % 8 == 0 and all(pv % 16 == 0 and pa % 8 == 0 for pa, _, pv in ptrs)
    if len(ptrs) == 1:
        ptrs.append((None, None, None))
    lib = _build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.tt_paged_chunk_write_fused(
            *ptrs[0], *ptrs[1], dest.data_ptr(), pos.data_ptr(), err.data_ptr(),
            buf[err_n:].data_ptr(), geom, ctypes.c_float(_quant().inv_qmax(arena.dtype)),
            _QUANT_CODE[arena.dtype], _DTYPE_CODE[vals[0].dtype], int(vec), stream)
    _raise_on(lib, rc, name)
    LAUNCHES["paged_chunk_write_fused"] += 1
    return err


def _check_chunk_route(name: str, dest, pos) -> None:
    _require(dest.dtype == torch.int32 and dest.ndim == 1 and dest.shape[0] >= 1,
             lambda: f"{name}: dest must be int32 (nbb,), got {dest.dtype} {tuple(dest.shape)}")
    _require(pos.dtype == torch.int32 and tuple(pos.shape) == (1,),
             lambda: f"{name}: pos must be int32 (1,), got {pos.dtype} {tuple(pos.shape)}")


def _check_devices(name: str, tensors: dict) -> torch.device:
    """Every tensor on the first one's device and contiguous; returns it."""
    first = next(iter(tensors))
    dev = tensors[first].device
    for arg, t in tensors.items():
        _require(t.device == dev, lambda: f"{name}: {arg} is on {t.device}, {first} on {dev}")
        _require(t.is_contiguous(), lambda: f"{name}: {arg} must be contiguous")
    _require(dev.type in ("cpu", "cuda"), lambda: f"{name}: unsupported device {dev}")
    return dev


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
    sums equal up to the order of f32 additions (and repeat bit for bit
    from call to call).  The engine writes K and V of a chunk piece in one
    launch through :func:`paged_chunk_write_fused_pair`."""
    name = "paged_chunk_write_fused"
    _require(arena.ndim == 5 and vals.ndim == 5 and tuple(vals.shape[1:]) == tuple(arena.shape[1:]),
             lambda: f"{name}: arena must be (num_blocks, L, ng, bs, hs) and vals (nc, L, ng, bs, "
             f"hs), got {tuple(arena.shape)} and {tuple(vals.shape)}")
    _require(block_size == arena.shape[3],
             lambda: f"{name}: block_size={block_size} but the arena holds {arena.shape[3]}")
    _check_quant_arena(name, arena, scale_arena, vals)
    _check_chunk_route(name, dest, pos)
    dev = _check_devices(name, dict(arena=arena, scale_arena=scale_arena, vals=vals, dest=dest,
                                    pos=pos))
    if dev.type == "cpu":
        return paged_chunk_write_fused_plain(arena, scale_arena, vals, dest, pos,
                                             block_size=block_size)
    nc, L, ng, bs, hs = vals.shape
    err = _chunk_q(name, (arena,), (scale_arena,), (vals,), dest, pos, nc,
                   (L * ng * bs * hs, bs * hs))
    return arena, scale_arena, err[0]


def paged_chunk_write_fused_pair(k_arena, v_arena, k_scale, v_scale, k_vals, v_vals, dest, pos, *,
                                 block_size: int):
    """K and V of one chunked-prefill piece landed in their quantized arenas
    in one launch, in place; returns ``(k_arena, v_arena, k_scale, v_scale,
    err)``.

    ``k_arena``/``v_arena``: two arenas of one shape and dtype (int8 or
    float8_e4m3fn) with their scale arenas, as
    :func:`paged_chunk_write_fused` takes one; ``k_vals``/``v_vals``: (1, L,
    ng, T, hs) at one compute dtype, the layout ``forward_paged`` returns,
    read in place (chunk block ``c``, slot ``t`` is token ``c·bs + t``; T a
    multiple of the block size).  Each arena ends as
    :func:`paged_chunk_write_fused` over the values folded into block
    granules leaves it (:func:`paged_chunk_write_fused_pair_plain`); ``err``
    (2, nc, 2) holds its sums, K's then V's.  One launch, counted as
    ``paged_chunk_write_fused``."""
    name = "paged_chunk_write_fused_pair"
    _require(k_arena.ndim == 5, lambda: f"{name}: k_arena must be (num_blocks, L, ng, bs, hs), "
             f"got {tuple(k_arena.shape)}")
    _require(v_arena.shape == k_arena.shape and v_arena.dtype == k_arena.dtype,
             lambda: f"{name}: v_arena must match k_arena ({tuple(k_arena.shape)} "
             f"{k_arena.dtype}), got {tuple(v_arena.shape)} {v_arena.dtype}")
    _, L, ng, bs, hs = k_arena.shape
    _require(k_vals.ndim == 5 and k_vals.shape[:3] == (1, L, ng) and k_vals.shape[4] == hs,
             lambda: f"{name}: k_vals must be (1, {L}, {ng}, T, {hs}), got {tuple(k_vals.shape)}")
    _require(v_vals.shape == k_vals.shape and v_vals.dtype == k_vals.dtype,
             lambda: f"{name}: v_vals must match k_vals ({tuple(k_vals.shape)} {k_vals.dtype}), "
             f"got {tuple(v_vals.shape)} {v_vals.dtype}")
    T = k_vals.shape[3]
    _require(T % block_size == 0,
             lambda: f"{name}: T={T} of k_vals/v_vals is not a multiple of block_size={block_size}")
    _require(block_size == bs, lambda: f"{name}: block_size={block_size} but the arena holds {bs}")
    for arena, scale, vals in ((k_arena, k_scale, k_vals), (v_arena, v_scale, v_vals)):
        _check_quant_arena(name, arena, scale, vals)
    _check_chunk_route(name, dest, pos)
    dev = _check_devices(name, dict(k_arena=k_arena, v_arena=v_arena, k_scale=k_scale,
                                    v_scale=v_scale, k_vals=k_vals, v_vals=v_vals, dest=dest,
                                    pos=pos))
    if dev.type == "cpu":
        return paged_chunk_write_fused_pair_plain(k_arena, v_arena, k_scale, v_scale, k_vals,
                                                  v_vals, dest, pos, block_size=block_size)
    err = _chunk_q(name, (k_arena, v_arena), (k_scale, v_scale), (k_vals, v_vals), dest, pos,
                   T // bs, (bs * hs, T * hs))
    return k_arena, v_arena, k_scale, v_scale, err


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
    _count_dispatch()
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
    _count_dispatch()
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
    _count_dispatch()
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

def _as_dtype_scalar(value: float, dtype) -> float:
    """``value`` rounded to ``dtype`` (a torch dtype, or the port's own, as
    a proxy's ``.dtype`` under ``jit``): the reference multiplies by a
    weakly typed Python scalar, which takes the array's dtype first."""
    if not isinstance(dtype, torch.dtype):
        from thunder_tpu_torch.core import dtypes

        dtype = dtypes.to_torch_dtype(dtype)
    return float(torch.tensor(float(value), dtype=dtype))


def lora_delta_fused_plain(x, a, b, scaling, slots=None):
    """Plain PyTorch version of :func:`lora_delta_fused`: each request's
    factors taken by slot (``index_select``) when ``slots`` is given, then
    rounded to x's dtype, ``d = x·Aᵀ`` accumulated in float32 and rounded to
    x's dtype, ``d·Bᵀ`` likewise, then times ``scaling`` (rounded to x's
    dtype) in float32 and rounded once more."""
    if slots is not None:
        idx = slots.long()
        a, b = a.index_select(0, idx), b.index_select(0, idx)
    ft = _acc_dtype(x.dtype)
    d = torch.matmul(x.to(ft), a.to(x.dtype).to(ft).transpose(-1, -2)).to(x.dtype)
    o = torch.matmul(d.to(ft), b.to(x.dtype).to(ft).transpose(-1, -2)).to(x.dtype)
    return (o.to(ft) * _as_dtype_scalar(scaling, x.dtype)).to(x.dtype)


def lora_plan(B: int, T: int, fin: int, r: int, x_dtype) -> dict:
    """The launch plan of a :func:`lora_delta_fused` call on the card, as
    ``csrc/lora_delta.cu`` computes it (``tt_lora_plan``) from shapes and
    x's dtype alone, so a call never syncs: the body (``"mma"``, mma.sync
    tiles for bf16/f16 x at T >= 16: phase 1, a fold kernel, phase 2; else
    ``"fma"``: FMA phases 1 and 2), x rows per block, fin cut into
    ``splits`` pieces of ``ks``, the float32 workspace's floats and phase
    2's shared memory per block.  Builds the kernels on first use."""
    lib = _build.load_library()
    out = (ctypes.c_int64 * 6)()
    _raise_on(lib, lib.tt_lora_plan(B, T, fin, r, _DTYPE_CODE[x_dtype], out), "lora_plan")
    mma, rows, splits, ks, n_ws, smem = out
    return dict(body="mma" if mma else "fma", rows=rows, splits=splits, ks=ks, n_ws=n_ws,
                smem=smem)


def _lora_key(x, a, b, slots) -> tuple:
    """What the checks read of a call's tensors, flat: shape, dtype, device
    (and whether x is contiguous, the factors' strides)."""
    try:
        return (x.shape, x.dtype, x.device, x.is_contiguous(), a.shape, a.stride(), a.dtype,
                a.device, b.shape, b.stride(), b.dtype, b.device,
                None if slots is None else (slots.shape, slots.dtype, slots.device))
    except AttributeError:
        raise ValueError("lora_delta_fused: x, a, b (and slots, if given) must be tensors") from None


# checked calls by _lora_key: the launch on the card (the output's shape,
# the workspace's floats, the kernel's shape array, whether every row start
# is a multiple of 16 bytes from its tensor's, the card), "cpu", or "empty"
# (no output element); a call that fails a check raises and is not kept
_LORA_CHECKED: dict = {}


def _lora_checked(key: tuple):
    """Validates one :func:`lora_delta_fused` call from its ``_lora_key``
    and returns what ``_LORA_CHECKED`` keeps for it."""
    name = "lora_delta_fused"
    (xs, xdt, dev, x_contiguous, as_, ast, adt, adev, bs, bst, bdt, bdev, s_meta) = key
    for arg, shape, dt, d in (("x", xs, xdt, dev), ("a", as_, adt, adev), ("b", bs, bdt, bdev)):
        _require(len(shape) == 3, lambda: f"{name}: {arg} must be a 3-D tensor")
        _require(d == dev, lambda: f"{name}: {arg} is on {d}, x on {dev}")
        _require(dt in _DTYPE_CODE,
                 lambda: f"{name}: {arg} must be float32/float16/bfloat16, got {dt}")
    _require(dev.type in ("cpu", "cuda"), lambda: f"{name}: unsupported device {dev}")
    B, T, fin = xs
    S, r = as_[0], as_[1]
    fout = bs[1]
    _require(tuple(as_) == (S, r, fin) and tuple(bs) == (S, fout, r),
             lambda: f"{name}: want a (S, r, fin) and b (S, fout, r) for x {xs}, got {as_} and "
             f"{bs}")
    if s_meta is None:
        _require(S == B, lambda: f"{name}: want a (B, r, fin) and b (B, fout, r) for x {xs} "
                 f"without slots, got {as_} and {bs}")
    else:
        sshape, sdt, sdev = s_meta
        _require(sdt == torch.int32 and tuple(sshape) == (B,),
                 lambda: f"{name}: slots must be a ({B},) int32 tensor, got {sdt} {sshape}")
        _require(sdev == dev, lambda: f"{name}: slots are on {sdev}, x on {dev}")
    _require(adt == bdt, lambda: f"{name}: a and b must share one dtype")
    _require(r >= 1, lambda: f"{name}: the rank must be at least 1, got {r}")
    if dev.type == "cpu":
        return "cpu"
    _require(x_contiguous, lambda: f"{name}: x must be contiguous")
    for arg, st, inner in (("a", ast, fin), ("b", bst, r)):
        _require(st[2] == 1 and st[1] == inner,
                 lambda: f"{name}: each slot's {arg} must be one contiguous slab")
    if B * T * fout == 0:
        return "empty"
    _require(fin >= 1, lambda: f"{name}: fin must be at least 1")
    plan = lora_plan(B, T, fin, r, xdt)
    _require(plan["smem"] <= _MAX_SMEM_BYTES, lambda: f"{name}: rank {r} needs "
             f"{plan['smem']} B of shared memory per block (limit {_MAX_SMEM_BYTES})")
    ints = (B, T, fin, fout, r, S, ast[0], bst[0], _DTYPE_CODE[xdt], _DTYPE_CODE[adt])
    rows16 = fin % 8 == 0 and r % 8 == 0 and ast[0] % 8 == 0 and bst[0] % 8 == 0
    return ((B, T, fout), plan["n_ws"], (ctypes.c_int64 * len(ints))(*ints), rows16, dev.index)


# the float32 workspaces of lora_delta_fused, one per (device, stream): the
# stream orders every call's use after the last one's, and a workspace is
# never freed (a captured CUDA graph may hold its address), only joined by
# a larger one when a call needs more
_LORA_WS: dict = {}       # (card, stream) -> (address, floats)
_LORA_KEEP: list = []     # every workspace ever made, kept alive


def _lora_workspace(dev, stream: int, n: int) -> int:
    """The address of at least ``n`` floats of workspace for ``stream`` on
    card ``dev``."""
    held = _LORA_WS.get((dev, stream))
    if held is None or held[1] < n:
        ws = torch.empty(max(n, 1 << 16), dtype=torch.float32, device=dev)
        _LORA_KEEP.append(ws)
        held = _LORA_WS[dev, stream] = (ws.data_ptr(), ws.numel())
    return held[0]


def lora_delta_fused(x, a, b, scaling, slots=None):
    """Per-request LoRA delta ``scaling·(x·Aᵀ)·Bᵀ`` (``csrc/lora_delta.cu``).

    ``x``: (B, T, fin) float32/float16/bfloat16, contiguous.  Without
    ``slots``: ``a`` (B, r, fin) and ``b`` (B, fout, r), request i's factors
    at index i (the reference's signature).  With ``slots`` ((B,) int32 on
    x's device): ``a`` (S, r, fin) and ``b`` (S, fout, r) are the registry's
    per-layer arena views, and request i reads its factors at slot
    ``slots[i]`` inside the kernel, so nothing is gathered; a slot outside
    [0, S) raises on the CPU and gives NaN rows on the card (no device
    value is read on the host).  Factors at the registry's dtype, each
    slot's slab contiguous (a per-layer view ``stack[:, l]`` is taken as it
    is), any rank whose phase 2 fits a block's shared memory
    (:func:`lora_plan`).  Returns (B, T, fout) at x's dtype, with the
    reference's rounding points (see :func:`lora_delta_fused_plain`).  One
    counted launch per call (the kernels of the body); the checks and the
    plan are kept by the tensors' shapes, strides, dtypes and devices."""
    key = _lora_key(x, a, b, slots)
    launch = _LORA_CHECKED.get(key)
    if launch is None:
        launch = _lora_checked(key)
        if len(_LORA_CHECKED) >= 256:
            _LORA_CHECKED.clear()
        _LORA_CHECKED[key] = launch
    if launch == "cpu":
        if slots is not None and slots.numel():
            S = a.shape[0]
            _require(int(slots.min()) >= 0 and int(slots.max()) < S,
                     lambda: f"lora_delta_fused: slots {slots.tolist()} out of range for {S} "
                     "arena slots")
        return lora_delta_fused_plain(x, a, b, scaling, slots)
    dev = key[2]
    if launch == "empty":
        return torch.empty((x.shape[0], x.shape[1], b.shape[1]), dtype=x.dtype, device=dev)
    out_shape, n_ws, shape, rows16, index = launch
    px, pa, pb = x.data_ptr(), a.data_ptr(), b.data_ptr()
    stream = torch._C._cuda_getCurrentRawStream(index)
    out = torch.empty(out_shape, dtype=key[1], device=dev)
    args = (px, pa, pb, None if slots is None else slots.data_ptr(), out.data_ptr(),
            _lora_workspace(dev, stream, n_ws), shape, rows16 and not (px | pa | pb) & 15,
            scaling, stream)
    lib = _build.load_library()
    if index == torch._C._cuda_getDevice():
        rc = lib.tt_lora_delta(*args)
    else:
        with torch.cuda.device(dev):
            rc = lib.tt_lora_delta(*args)
    if rc:
        _raise_on(lib, rc, "lora_delta_fused")
    LAUNCHES["lora_delta_fused"] += 1
    return out


#
# The cuda operator executor: the IR's claims of the flash attention kernels
# (the counterpart of the Pallas executor's registrations, pallasex.py:795-816).
# It claims a bound symbol when its proxies lie on a CUDA device and the
# kernels take their shapes.  It registers no cross-entropy operator: the
# reference claims CE only under a tuning file's ``ce.claim`` (pallasex.py
# :1013-1034), which the repo has none of, so the loss reaches ``flash_ce``
# through torchex's CROSS_ENTROPY_FWD fast path.
#

def _register_operator_executor():
    from thunder_tpu_torch.core import dtypes as _dtypes
    from thunder_tpu_torch.core.prims import PrimIDs, prim_lookup
    from thunder_tpu_torch.extend import OperatorExecutor, register_executor

    def sdpa(q, k, v, mask, causal, scale, window=None):
        return flash_sdpa(q, k, v, mask, causal=causal, scale=scale, window=window)

    def sdpa_backward(g, q, k, v, out, lse, mask, causal, scale, window=None):
        return flash_sdpa_backward(g, q, k, v, out, lse, mask, causal=causal, scale=scale,
                                   window=window)

    def takes(q, k, v, mask, causal, window) -> bool:
        try:
            dtype = _dtypes.to_torch_dtype(q.dtype)
        except KeyError:
            return False
        return q.device.type == "cuda" and flash_supported(
            tuple(q.shape), tuple(k.shape), tuple(v.shape), dtype, causal,
            None if mask is None else tuple(mask.shape), window)

    def sdpa_checker(q, k, v, mask, causal, scale, window=None):
        return takes(q, k, v, mask, causal, window)

    def sdpa_backward_checker(g, q, k, v, out, lse, mask, causal, scale, window=None):
        return takes(q, k, v, mask, causal, window)

    ex = OperatorExecutor("cuda", version=torch.version.cuda)
    register_executor(ex)
    for pid, name, fn, checker in (
            (PrimIDs.SDPA, "cuda_sdpa", sdpa, sdpa_checker),
            (PrimIDs.SDPA_BACKWARD, "cuda_sdpa_backward", sdpa_backward, sdpa_backward_checker)):
        op = ex.register_operator(name, like=prim_lookup[pid], fn=fn)
        ex.register_implementation(pid, op, checker=checker)
    return ex


cuda_ex = _register_operator_executor()
