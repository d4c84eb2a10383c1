#!/usr/bin/env python3
"""Chip smoke test of thunder_tpu_torch, the PyTorch/CUDA port, on one GPU.

    python3 chip_smoke.py            # needs one NVIDIA H100 (sm_90a) and nvcc

Phases (any failure exits non-zero; nothing is caught and passed over):

1. device: requires CUDA, prints the card's name and power limit, and turns
   TF32 off so float32 products run in full float32;
2. build: compiles every ``thunder_tpu_torch/csrc/*.cu`` with one nvcc call
   each, all at once, into ``build/thunder_tpu_torch/`` and prints ptxas'
   registers and spills;
3. kernels: each kernel against its plain PyTorch version at the shapes
   the served paths give it (Llama-3-8B: 32 heads over 8 KV groups,
   hs=128, block 16, a 1024-block 32-layer arena), ragged positions with
   batch-padding rows: the decode kernels at B=8 with and without a
   sliding window, bf16 and f32; ``paged_attn_verify`` at the speculative
   shape (B=8, T=5) and the chunk shape (B=1, T=512, pos 2560), bf16, f16
   and f32 (attention in float32 within 1e-5 of the plain version, in
   bf16/f16 with an error against the float32 result at most twice the
   plain version's own); the chunk and masked writes bitwise outside sink
   block 0, every offset of the masked write.  Then CUDA-event and profiler times of kernel, plain
   version and one library call computing the same function, beside the
   bound;
4. serve: Llama-3-8B at full width (random weights from a seed) through
   ``serve(None, params, cfg, attn="paged")``: 8 greedy requests with
   prompts of 128-1024 tokens and 32 new tokens each; the kernels' launch
   counts must equal the decode steps times n_layer and times 2; then one
   decode step's logits through the kernels against the dense path over
   the same gathered cache;
5. chunked serve: the same model with ``prefill_chunk=512``, block-aligned
   prefill buckets (16..512), 8 greedy requests with prompts of 1024-3072
   tokens, 32 new tokens each; the chunk kind must resolve "paged", and
   ``paged_attn_verify`` must launch n_layer and ``paged_chunk_write`` 2
   times per intermediate piece, the decode kernels as in phase 4;
6. speculative serve: the same target with a layer-skip draft (its own
   embedding, first two blocks, final norm and head), K=4, 8 greedy
   requests; ``paged_attn_verify`` launches n_layer and
   ``paged_token_write_masked`` 2(K+1) times per round, the decode kernels
   never; then once more with draft = target, which must accept K drafts
   in some round;
7. correctness at full width: served tokens, exact, in float32 at
   Llama-3-8B widths and 4 layers (chunked = unchunked, speculative =
   plain); and at full depth one prefill chunk (T=512) and one verify
   chunk (T=5) through the kernels against ``forward_with_cache`` over the
   gathered cache, float32 within 1e-3, bf16 error within twice the dense
   bf16 path's own;
8. flash attention (run with the kernels of phase 3): the forward, dq and
   dk/dv kernels against their plain versions at the training shape (B=1,
   32 heads over 8 KV groups, T=2048, hs=128, causal) and at small shapes
   (non-causal, a window, Tq != Tk, hs 64 and 256, every mask layout), bf16
   and float32, each run twice bitwise equal; then their times beside the
   plain versions, ``F.scaled_dot_product_attention`` and the bounds;
9. train correctness: one step's loss and grads at Llama-3-8B widths and 4
   layers, through the kernels against their plain versions, float32 and
   bf16;
10. train at full width and depth: 4 AdamW steps of Llama-3-8B (bf16,
    B=1, T=2048, remat full_block, lr 1e-4) on one fixed batch, with
    exact flash launch counts, no declines, finite losses and the last below
    the first; step time, tokens/s, model FLOPs and their share of peak,
    peak memory, and a profile of one more step by kernel group;
11. a ``{"kernels": [...]}`` line, then the ``{"ok": true, ...}`` line.
"""
from __future__ import annotations

import contextlib
import ctypes
import gc
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from thunder_tpu_torch import ltorch
from thunder_tpu_torch._tree import tree_leaves
from thunder_tpu_torch.distributed.api import make_train_step
from thunder_tpu_torch.executors import _build, cudaex
from thunder_tpu_torch.models.generate import forward_with_cache
from thunder_tpu_torch.models.llama import (
    Config,
    build_rope_cache,
    gpt_loss,
    init_params,
    param_count,
)
from thunder_tpu_torch.train.optim import adamw
from thunder_tpu_torch.serving import SpecConfig, serve
from thunder_tpu_torch.serving.kv_pool import SINK_BLOCK, chunk_tables, gather_dense
from thunder_tpu_torch.serving.paged_attention import forward_paged

SEED = 0
DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12                      # H100 SXM, NVIDIA data sheet
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float16: 989e12, torch.float32: 67e12}
# attention kernel vs plain version.  float32: the same arithmetic in
# another summation order and exp, a few ulps of outputs of magnitude <= ~4.
ATOL_F32 = 1e-5
# bf16/f16: kernel and plain version round at the same places (K/V and the
# probabilities to the query dtype, the output) but over other key tiles,
# so they differ by rounding alone.  Both are held against the float32
# plain result of the same rounded inputs: the kernel's error may be at
# most LOWP_ERR_RATIO times the plain version's own.  (A fixed bar would
# sit near the outputs' own size at long contexts, |out| ~ 0.03 over 3000
# keys, and let a wrong kernel through.)
LOWP_ERR_RATIO = 2.0
# one decode step of the 32-layer model, kernel path vs dense path.  In
# float32 the two are the same math summed in another order.  In bf16 they
# round at different places (the dense path rounds normalized attention
# probabilities to bf16, the kernel unnormalized ones) and 32 residual
# layers carry those roundings to the logits, so the bar is relative: held
# against the float32 dense logits, the kernel path's error may be at most
# BF16_ERR_RATIO times the dense bf16 path's own.
LOGITS_ATOL_F32 = 1e-3
BF16_ERR_RATIO = 2.0

CARD = ""


def say(msg: str) -> None:
    print(f"[{CARD}] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0].strip()


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``iters`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, kernel: str, iters: int = 20) -> float | None:
    """Mean device time of the kernels whose name contains ``kernel``, from
    the profiler's CUDA activity (host launch overhead excluded); None when
    the profiler sees no device activity."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = count = 0
    for evt in prof.key_averages():
        if kernel in evt.key:
            total += evt.device_time_total
            count += evt.count
    return total / count / 1e3 if count else None


def bound(nbytes: float, ops: float, dtype) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[dtype]
    return (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def timed(name, label, kernel, plain, library, library_name, bound_ms_by, *, iters,
          plain_iters, plain_warmup=3, device_kernel=None) -> dict:
    """Per-call times of a kernel, its plain version and the library call
    computing the same function, the kernel's device time (of the CUDA
    kernels named like ``device_kernel``, default ``name``), and its bound."""
    ms = time_ms(kernel, iters=iters)
    dev_ms = device_ms(kernel, device_kernel or name)
    plain_ms = time_ms(plain, iters=plain_iters, warmup=plain_warmup)
    library_ms = time_ms(library, iters=iters)
    bound_ms, bound_by = bound_ms_by
    say(f"{name} bf16{label} timing per call: kernel {ms:.4f} ms (device {dev_ms} ms), "
        f"plain {plain_ms:.4f} ms, {library_name} {library_ms:.4f} ms, bound "
        f"{1e3 * bound_ms:.3f} us ({bound_by})")
    return dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by)


#
# phase 3: kernels against their plain versions at the serving shape
#

B, NH, NG, HS, BS, NBB, L, NUM_BLOCKS = 8, 32, 8, 128, 16, 64, 32, 1024


def decode_inputs(dtype, gen):
    dev = DEVICE
    rng = np.random.default_rng(SEED)
    pos = rng.integers(1, NBB * BS, B).astype(np.int32)
    pos[[2, 6]] = 0                                    # batch-padding rows
    tables = np.full((B, NBB), SINK_BLOCK, dtype=np.int32)
    free = rng.permutation(np.arange(1, NUM_BLOCKS))
    k = 0
    for i, p in enumerate(pos):
        n = -(-int(p) // BS)
        tables[i, :n] = free[k:k + n]
        k += n
    shape = (NUM_BLOCKS, L, NG, BS, HS)
    x = dict(
        q=torch.randn((B, NH, HS), generator=gen, device=dev).to(dtype),
        k_arena=torch.randn(shape, generator=gen, device=dev).to(dtype),
        v_arena=torch.randn(shape, generator=gen, device=dev).to(dtype),
        fresh_k=torch.randn((B, NG, HS), generator=gen, device=dev).to(dtype),
        fresh_v=torch.randn((B, NG, HS), generator=gen, device=dev).to(dtype),
        tables=torch.as_tensor(tables, device=dev),
        pos=torch.as_tensor(pos, device=dev),
    )
    return x, pos


def attn_bound(pos, window, dtype):
    esize = torch.empty((), dtype=dtype).element_size()
    lo = np.zeros_like(pos) if window is None else np.maximum(pos - window + 1, 0)
    slots = int((pos - lo).sum())                      # arena slots the rows attend
    nbytes = (2 * slots * NG * HS * esize              # K and V read once
              + 2 * B * NH * HS * esize                # q in, out
              + 2 * B * NG * HS * esize                # fresh K/V
              + 4 * B * NBB + 4 * B)                   # tables, pos
    ops = 4 * NH * HS * (slots + B)                    # QK and PV, fresh included
    return bound(nbytes, ops, dtype)


def check_attn(name, label, kernel, plain, x, **kw) -> float:
    """``kernel`` against ``plain`` on the inputs ``x``: float32 within
    ATOL_F32; bf16/f16 against the float32 plain result of the same inputs,
    the kernel's error within LOWP_ERR_RATIO times the plain version's own.
    Returns the kernel's max abs difference from the plain version."""
    got = kernel(**x, **kw)
    torch.cuda.synchronize()
    want = plain(**x, **kw)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    if x["q"].dtype == torch.float32:
        ok, bar = err <= ATOL_F32, f"atol {ATOL_F32:.0e}"
    else:
        ref = plain(**{k: v.float() if v.is_floating_point() else v for k, v in x.items()}, **kw)
        err_kernel = (got.float() - ref).abs().max().item()
        err_plain = (want.float() - ref).abs().max().item()
        ok = err_kernel <= LOWP_ERR_RATIO * err_plain
        bar = (f"against float32: kernel {err_kernel:.3e}, plain {err_plain:.3e}, ratio "
               f"{err_kernel / err_plain:.3f}, limit {LOWP_ERR_RATIO}")
        del ref
    ok = ok and bool(torch.isfinite(got).all())
    say(f"{name} {label} {str(x['q'].dtype)[6:]}: max_abs_err={err:.3e} ({bar}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} {label} disagrees with its plain version")
    return err


def check_decode(layer=L - 3):
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    result = {}
    for dtype in (torch.bfloat16, torch.float32):
        x, pos = decode_inputs(dtype, gen)
        for window in (None, 256):
            err = check_attn("paged_attn_decode", f"window={window}", cudaex.paged_attn_decode,
                             cudaex.paged_attn_decode_plain, x, layer=layer, window=window)
            if dtype == torch.bfloat16 and window is None:
                result["max_abs_err"] = err
        if dtype == torch.bfloat16:
            result.update(time_decode(x, pos, layer))
        del x
    return result


def time_decode(x, pos, layer):
    # the library yardstick: SDPA over K/V gathered dense beforehand, the
    # fresh token in its slot, a per-row keep-mask; only the call is timed
    S = NBB * BS + 1
    kd = x["k_arena"][x["tables"].long(), layer].permute(0, 2, 1, 3, 4).reshape(B, NG, NBB * BS, HS)
    vd = x["v_arena"][x["tables"].long(), layer].permute(0, 2, 1, 3, 4).reshape(B, NG, NBB * BS, HS)
    kd = torch.cat([kd, torch.zeros_like(kd[:, :, :1])], dim=2)
    vd = torch.cat([vd, torch.zeros_like(vd[:, :, :1])], dim=2)
    rows = torch.arange(B, device=DEVICE)
    p = x["pos"].long()
    kd[rows, :, p] = x["fresh_k"]
    vd[rows, :, p] = x["fresh_v"]
    mask = (torch.arange(S, device=DEVICE)[None, :] <= p[:, None])[:, None, None, :]
    q4 = x["q"][:, :, None]
    return timed("paged_attn_decode", "", lambda: cudaex.paged_attn_decode(**x, layer=layer),
                 lambda: cudaex.paged_attn_decode_plain(**x, layer=layer),
                 lambda: F.scaled_dot_product_attention(q4, kd, vd, attn_mask=mask,
                                                        enable_gqa=True),
                 "SDPA", attn_bound(pos, None, x["q"].dtype), iters=200, plain_iters=10,
                 plain_warmup=1)


def check_write():
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    result = {}
    for dtype in (torch.bfloat16, torch.float32):
        x, pos = decode_inputs(dtype, gen)
        tables, posd = x["tables"], x["pos"]
        arena = x.pop("k_arena")
        del x
        vals = torch.randn((B, L, NG, HS), generator=gen, device=DEVICE).to(dtype)
        plain = cudaex.paged_token_write_plain(arena.clone(), vals, tables, posd, block_size=BS)
        got = cudaex.paged_token_write(arena, vals, tables, posd, block_size=BS)
        torch.cuda.synchronize()
        same = bool(torch.equal(got[1:], plain[1:]))    # block 0 is the sink
        say(f"paged_token_write {str(dtype)[6:]}: bitwise equal outside block 0: {same}")
        if not same:
            raise AssertionError("paged_token_write disagrees with its plain version")
        if dtype == torch.bfloat16:
            result.update(time_write(arena, vals, tables, posd, dtype))
        del arena, plain
    # the rank-4 (scale arena) form
    scale = torch.randn((NUM_BLOCKS, L, NG, BS), generator=gen, device=DEVICE)
    svals = torch.randn((B, L, NG), generator=gen, device=DEVICE)
    plain = cudaex.paged_token_write_plain(scale.clone(), svals, tables, posd, block_size=BS)
    got = cudaex.paged_token_write(scale, svals, tables, posd, block_size=BS)
    torch.cuda.synchronize()
    same = bool(torch.equal(got[1:], plain[1:]))
    say(f"paged_token_write rank-4 f32: bitwise equal outside block 0: {same}")
    if not same:
        raise AssertionError("paged_token_write (rank 4) disagrees with its plain version")
    result["max_abs_err"] = 0.0
    return result


def time_write(arena, vals, tables, pos, dtype):
    # the library yardstick: one index_put_ on the arena viewed (nb, L*ng, bs, hs)
    p = pos.long()
    blk = tables.long().gather(1, (p // BS)[:, None])
    rows = torch.arange(L * NG, device=DEVICE)[None, :]
    view = arena.view(NUM_BLOCKS, L * NG, BS, HS)
    idx = (blk.expand(B, L * NG), rows.expand(B, L * NG), (p % BS)[:, None].expand(B, L * NG))
    v3 = vals.reshape(B, L * NG, HS)
    esize = vals.element_size()
    return timed("paged_token_write", "",
                 lambda: cudaex.paged_token_write(arena, vals, tables, pos, block_size=BS),
                 lambda: cudaex.paged_token_write_plain(arena, vals, tables, pos, block_size=BS),
                 lambda: view.index_put_(idx, v3), "index_put_",
                 bound(2 * vals.numel() * esize + 4 * tables.numel() + 4 * B, 0, dtype),
                 iters=500, plain_iters=100)


#
# phase 3, continued: the kernels of chunked prefill and speculative serving
#

VERIFY_SHAPES = {"spec": dict(Bv=8, T=5, nbb=NBB), "chunk": dict(Bv=1, T=512, nbb=192)}
CHUNK_POS = 2560                                      # the chunk shape's block-aligned start


def verify_inputs(dtype, gen, Bv, T, nbb):
    """Arenas of the decode shape; ragged positions with padding rows at
    the spec shape, one chunk at ``CHUNK_POS`` (and its table) at the chunk
    shape."""
    dev = DEVICE
    rng = np.random.default_rng(SEED + T)
    if Bv == 1:
        pos = np.array([CHUNK_POS], np.int32)
    else:
        pos = rng.integers(1, nbb * BS - T, Bv).astype(np.int32)
        pos[[2, 6]] = 0                                # batch-padding rows
        pos[3] = 4 * BS                                # a block edge
    tables = np.full((Bv, nbb), SINK_BLOCK, dtype=np.int32)
    free = rng.permutation(np.arange(1, NUM_BLOCKS))
    k = 0
    for i, p in enumerate(pos):
        n = -(-(int(p) + T) // BS)                     # the blocks the chunk lands in too
        tables[i, :n] = free[k:k + n]
        k += n
    shape = (NUM_BLOCKS, L, NG, BS, HS)
    x = dict(
        q=torch.randn((Bv, NH, T, HS), generator=gen, device=dev).to(dtype),
        k_arena=torch.randn(shape, generator=gen, device=dev).to(dtype),
        v_arena=torch.randn(shape, generator=gen, device=dev).to(dtype),
        fresh_k=torch.randn((Bv, NG, T, HS), generator=gen, device=dev).to(dtype),
        fresh_v=torch.randn((Bv, NG, T, HS), generator=gen, device=dev).to(dtype),
        tables=torch.as_tensor(tables, device=dev),
        pos=torch.as_tensor(pos, device=dev),
    )
    return x, pos


def verify_bound(pos, T, nbb, dtype):
    esize = torch.empty((), dtype=dtype).element_size()
    Bv, slots = len(pos), int(pos.sum())               # arena slots the rows attend
    nbytes = (2 * slots * NG * HS * esize              # K and V read once
              + 2 * Bv * NH * T * HS * esize           # q in, out
              + 2 * Bv * NG * T * HS * esize           # fresh K/V
              + 4 * Bv * nbb + 4 * Bv)                 # tables, pos
    ops = 4 * NH * HS * (slots * T + Bv * T * (T + 1) // 2)   # QK and PV, causal fresh part
    return bound(nbytes, ops, dtype)


def check_verify(layer=L - 3):
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 2)
    result = {"shapes": {}}
    for shape, dims in VERIFY_SHAPES.items():
        # bf16 and f16 run the tensor-core body, float32 the scalar one
        for dtype in (torch.bfloat16, torch.float16, torch.float32):
            x, pos = verify_inputs(dtype, gen, **dims)
            err = check_attn("paged_attn_verify", f"{shape} B={dims['Bv']} T={dims['T']}",
                             cudaex.paged_attn_verify, cudaex.paged_attn_verify_plain, x,
                             layer=layer)
            if dtype == torch.bfloat16:
                rec = time_verify(x, pos, layer, dims["nbb"])
                rec["max_abs_err"] = err
                result["shapes"][shape] = rec
            del x
    result.update(result["shapes"]["chunk"])
    return result


def time_verify(x, pos, layer, nbb):
    Bv, _, T, _ = x["q"].shape
    # the library yardstick: SDPA over the K/V gathered dense beforehand with
    # the chunk's own K/V appended, a (T, S) keep-mask per row; only the call
    # is timed
    S = nbb * BS + T
    tab = x["tables"].long()
    kd = x["k_arena"][tab, layer].permute(0, 2, 1, 3, 4).reshape(Bv, NG, nbb * BS, HS)
    vd = x["v_arena"][tab, layer].permute(0, 2, 1, 3, 4).reshape(Bv, NG, nbb * BS, HS)
    kd = torch.cat([kd, x["fresh_k"]], dim=2)
    vd = torch.cat([vd, x["fresh_v"]], dim=2)
    j = torch.arange(S, device=DEVICE)
    t = torch.arange(T, device=DEVICE)
    p = x["pos"].long()
    arena_keep = j[None, None, :] < p[:, None, None]                       # (B, 1, S)
    fresh_keep = (j[None, :] - nbb * BS <= t[:, None]) & (j[None, :] >= nbb * BS)   # (T, S)
    mask = (arena_keep | fresh_keep[None])[:, None]                        # (B, 1, T, S)
    return timed("paged_attn_verify", f" B={Bv} T={T}",
                 lambda: cudaex.paged_attn_verify(**x, layer=layer),
                 lambda: cudaex.paged_attn_verify_plain(**x, layer=layer),
                 lambda: F.scaled_dot_product_attention(x["q"], kd, vd, attn_mask=mask,
                                                        enable_gqa=True),
                 "SDPA", verify_bound(pos, T, nbb, x["q"].dtype), iters=50, plain_iters=5,
                 plain_warmup=1)


def check_chunk_write():
    """One chunk of the chunk shape (T=512 at pos 2560) through its
    192-entry scatter table, whose last entries run past the leased blocks
    (they route to the sink)."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 3)
    nc, nbb = VERIFY_SHAPES["chunk"]["T"] // BS, VERIFY_SHAPES["chunk"]["nbb"]
    rng = np.random.default_rng(SEED + 3)
    leased = [int(b) for b in rng.permutation(np.arange(1, NUM_BLOCKS))[:nbb - 8]]
    pos = CHUNK_POS
    _, dest = chunk_tables(leased, pos, nc * BS, nbb, BS)
    dest_d = torch.as_tensor(dest, device=DEVICE)
    pos_d = torch.tensor([pos], dtype=torch.int32, device=DEVICE)
    result = {}
    for dtype in (torch.bfloat16, torch.float32):
        arena = torch.randn((NUM_BLOCKS, L, NG, BS, HS), generator=gen, device=DEVICE).to(dtype)
        vals = torch.randn((nc, L, NG, BS, HS), generator=gen, device=DEVICE).to(dtype)
        plain = cudaex.paged_chunk_write_plain(arena.clone(), vals, dest_d, pos_d, block_size=BS)
        got = cudaex.paged_chunk_write(arena, vals, dest_d, pos_d, block_size=BS)
        torch.cuda.synchronize()
        same = bool(torch.equal(got[1:], plain[1:]))
        say(f"paged_chunk_write {str(dtype)[6:]}: bitwise equal outside block 0: {same}")
        if not same:
            raise AssertionError("paged_chunk_write disagrees with its plain version")
        if dtype == torch.bfloat16:
            # the library yardstick: one index_copy_ of the slabs, routing
            # computed beforehand
            idx = pos // BS + np.arange(nc)
            blk = torch.as_tensor(np.where(idx < nbb, dest[np.minimum(idx, nbb - 1)], 0),
                                  dtype=torch.long, device=DEVICE)
            result = timed(
                "paged_chunk_write", f" ({nc} blocks of {vals[0].numel() * 2 / 2**20:.2f} MiB)",
                lambda: cudaex.paged_chunk_write(arena, vals, dest_d, pos_d, block_size=BS),
                lambda: cudaex.paged_chunk_write_plain(arena, vals, dest_d, pos_d, block_size=BS),
                lambda: arena.index_copy_(0, blk, vals), "index_copy_",
                bound(2 * vals.numel() * vals.element_size() + 4 * nbb + 4, 0, dtype),
                iters=100, plain_iters=50)
            result["max_abs_err"] = 0.0
        del arena, vals, plain
    return result


def check_masked_write(K=4):
    """Every offset 0..K of a speculative commit with n_emit from 0 to K+1
    across the rows (padding rows carry n_emit 0), rank 5 in bf16 and f32
    and the rank-4 scale form."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 4)
    result = {}
    for dtype in (torch.bfloat16, torch.float32):
        x, pos = decode_inputs(dtype, gen)
        tables, posd = x["tables"], x["pos"]
        arena = x.pop("k_arena")
        del x
        n_emit = torch.tensor([1, 5, 0, 3, 2, 4, 0, 5], dtype=torch.int32, device=DEVICE)
        for off in range(K + 1):
            vals = torch.randn((B, L, NG, HS), generator=gen, device=DEVICE).to(dtype)
            plain = cudaex.paged_token_write_masked_plain(arena.clone(), vals, tables, posd,
                                                          n_emit, off, block_size=BS)
            got = cudaex.paged_token_write_masked(arena, vals, tables, posd, n_emit, off,
                                                  block_size=BS)
            torch.cuda.synchronize()
            if not torch.equal(got[1:], plain[1:]):
                raise AssertionError(f"paged_token_write_masked offset {off} disagrees with "
                                     "its plain version")
        say(f"paged_token_write_masked {str(dtype)[6:]}: bitwise equal outside block 0 at "
            f"offsets 0..{K}")
        if dtype == torch.bfloat16:
            off = 2
            # the library yardstick: one index_put_ with the routing computed
            # beforehand (rejected rows to block 0, slot 0)
            p = posd.long() + off
            live = off < n_emit.long()
            blk = torch.where(live, tables.long().gather(1, (p // BS)[:, None])[:, 0], 0)
            slot = torch.where(live, p % BS, 0)
            rows = torch.arange(L * NG, device=DEVICE)[None, :]
            view = arena.view(NUM_BLOCKS, L * NG, BS, HS)
            idx = (blk[:, None].expand(B, L * NG), rows.expand(B, L * NG),
                   slot[:, None].expand(B, L * NG))
            v3 = vals.reshape(B, L * NG, HS)
            result = timed(
                "paged_token_write_masked", f" (offset {off})",
                lambda: cudaex.paged_token_write_masked(arena, vals, tables, posd, n_emit, off,
                                                        block_size=BS),
                lambda: cudaex.paged_token_write_masked_plain(arena, vals, tables, posd, n_emit,
                                                              off, block_size=BS),
                lambda: view.index_put_(idx, v3), "index_put_",
                bound(2 * vals.numel() * vals.element_size() + 4 * tables.numel() + 8 * B, 0,
                      dtype),
                iters=500, plain_iters=100,
                device_kernel="paged_token_write_kernel")   # the kernel both writes share
            result["max_abs_err"] = 0.0
        del arena
    scale = torch.randn((NUM_BLOCKS, L, NG, BS), generator=gen, device=DEVICE)
    svals = torch.randn((B, L, NG), generator=gen, device=DEVICE)
    plain = cudaex.paged_token_write_masked_plain(scale.clone(), svals, tables, posd, n_emit, 1,
                                                  block_size=BS)
    got = cudaex.paged_token_write_masked(scale, svals, tables, posd, n_emit, 1, block_size=BS)
    torch.cuda.synchronize()
    same = bool(torch.equal(got[1:], plain[1:]))
    say(f"paged_token_write_masked rank-4 f32: bitwise equal outside block 0: {same}")
    if not same:
        raise AssertionError("paged_token_write_masked (rank 4) disagrees with its plain version")
    return result


#
# phase 4: serve Llama-3-8B at full width
#


def make_params(cfg_name="Llama-3-8B"):
    cfg = Config.from_name(cfg_name)
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    params = init_params(cfg, generator=gen, dtype=torch.bfloat16, device=DEVICE)
    torch.cuda.synchronize()
    say(f"{cfg_name} params: {param_count(params) / 1e9:.3f} B in bf16, "
        f"init {time.perf_counter() - t0:.1f} s")
    return params, cfg


def no_launches_but(**expected) -> dict:
    return {name: expected.get(name, 0) for name in cudaex.LAUNCHES}


def serve_full_width(params, cfg, n_requests=8, new_tokens=32):
    cfg_name = cfg.name
    eng = serve(None, params, cfg, attn="paged", block_size=16, num_blocks=1024, max_batch=8,
                device=DEVICE)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in rng.integers(128, 1025, n_requests)]
    eng.run([prompts[0][:64]], max_new_tokens=2)            # warm-up: cuBLAS handles, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps0 = eng.decode_steps
    cudaex.reset_launches()
    t0 = time.perf_counter()
    handles = [eng.submit(p, max_new_tokens=new_tokens) for p in prompts]
    eng.step()                                              # admits and prefills every request
    tables = [list(h._req.block_table) for h in handles]
    eng.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cudaex.LAUNCHES)
    steps = eng.decode_steps - steps0
    results = [h.result(drive=False) for h in handles]
    for r in results:
        toks = np.asarray(r.new_tokens)
        if (r.finish_reason != "length" or len(toks) != new_tokens
                or toks.min() < 0 or toks.max() >= cfg.padded_vocab_size):
            raise AssertionError(f"request {r.rid}: bad result {r.finish_reason} {toks}")
    n_tok = sum(len(r.new_tokens) for r in results)
    ttft = float(np.median([r.ttft_s for r in results]))
    tpot = float(np.median([r.tpot_s for r in results]))
    say(f"serve {cfg_name} bf16: {n_requests} requests, prompts "
        f"{sorted(len(p) for p in prompts)}, {n_tok} tokens in {wall:.3f} s = "
        f"{n_tok / wall:.1f} tokens/s; TTFT p50 {1e3 * ttft:.1f} ms; TPOT p50 "
        f"{1e3 * tpot:.2f} ms; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; decode steps {steps}")
    say(f"launches during serve: {launches} (expected paged_attn_decode "
        f"{steps * cfg.n_layer}, paged_token_write {steps * 2})")
    if launches != no_launches_but(paged_attn_decode=steps * cfg.n_layer,
                                   paged_token_write=steps * 2):
        raise AssertionError(f"launch counts {launches} do not match {steps} decode steps")
    compare_logits(eng, params, cfg, prompts, results, tables)
    profile_decode(eng, prompts)
    return launches


def profile_decode(eng, prompts, steps=4):
    """Device time of a few steady decode steps of the same batch, by
    kernel, from the profiler's CUDA activity: where the decode step's time
    goes, and how much of the span between the first and the last kernel
    the card sits idle."""
    handles = [eng.submit(p, max_new_tokens=steps + 3) for p in prompts]
    eng.step()                                             # admit + prefill
    eng.step()                                             # token 0, first decode dispatch
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
    eng.drain()
    if not all(h.done() for h in handles):
        raise AssertionError("profiled requests did not finish")
    spans = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    if not spans:
        say("decode step profile: not measured (the profiler saw no CUDA activity)")
        return
    busy = sum(end - start for _, start, end in spans)
    window = max(end for *_, end in spans) - min(start for _, start, _ in spans)
    groups: dict[str, float] = {}
    by_name: dict[str, float] = {}
    for name, start, end in spans:
        low = name.lower()
        key = ("paged_attn_decode" if "paged_attn_decode" in low
               else "paged_token_write" if "paged_token_write" in low
               else "matmul" if any(s in low for s in ("gemm", "gemv", "cutlass", "xmma", "nvjet"))
               else "other")
        groups[key] = groups.get(key, 0.0) + (end - start)
        by_name[name] = by_name.get(name, 0.0) + (end - start)
    per_step = {k: round(v / steps / 1e3, 4) for k, v in sorted(groups.items())}
    say(f"decode step profile ({steps} steps, 8 rows): device busy {busy / steps / 1e3:.3f} ms "
        f"per step over a {window / steps / 1e3:.3f} ms kernel span (idle share "
        f"{1 - busy / window:.3f}); device ms per step by kernel group: {per_step}")
    for name, total in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        say(f"  {total / steps / 1e3:.4f} ms per step: {name[:110]}")


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast(v, dtype) for v in tree]
    return tree.to(dtype)


def compare_logits(eng, params, cfg, prompts, results, tables):
    """One decode step at the served rows' last positions (their blocks
    still hold the K/V the run wrote), through the kernels and through the
    dense path over the same gathered cache, in bf16 and in float32."""
    Bb = len(results)
    nbb = eng._nbb(max(len(t) for t in tables))
    tab = np.full((Bb, nbb), SINK_BLOCK, dtype=np.int32)
    for i, t in enumerate(tables):
        tab[i, :len(t)] = t
    pos = np.array([len(p) + len(r.new_tokens) - 2 for p, r in zip(prompts, results)], np.int32)
    toks = np.array([r.new_tokens[-2] for r in results], np.int32)
    dev = DEVICE
    tab_d, pos_d = torch.as_tensor(tab, device=dev), torch.as_tensor(pos, device=dev)
    toks_d = torch.as_tensor(toks, device=dev)[:, None]
    cos, sin = build_rope_cache(cfg, nbb * eng.pool.block_size, device=dev)

    def both_paths(p, arenas, cdtype):
        lp, _ = forward_paged(p, toks_d, pos_d, arenas, tab_d, cos, sin, cfg, cdtype=cdtype)
        kd, vd = gather_dense(arenas["k"], arenas["v"], tab_d)
        lg, _ = forward_with_cache(p, toks_d, pos_d, {"k": kd, "v": vd}, cos, sin, cfg)
        return lp, lg

    with torch.no_grad():
        lp, lg = both_paths(params, eng.pool.arenas, torch.bfloat16)
        lp32, lg32 = both_paths(_cast(params, torch.float32),
                                _cast(eng.pool.arenas, torch.float32), torch.float32)
    torch.cuda.synchronize()
    err = (lp - lg).abs().max().item()
    err32 = (lp32 - lg32).abs().max().item()
    err_kernel = (lp - lg32).abs().max().item()          # bf16 paths against float32
    err_dense = (lg - lg32).abs().max().item()
    agree = int((lp.argmax(-1) == lg.argmax(-1)).sum())
    served = torch.as_tensor([r.new_tokens[-1] for r in results], device=dev)
    replay = int((lp.argmax(-1)[:, 0] == served).sum())
    ok = (bool(torch.isfinite(lp).all()) and err32 <= LOGITS_ATOL_F32
          and err_kernel <= BF16_ERR_RATIO * err_dense)
    say(f"decode logits, kernels vs dense path ({Bb} rows, nbb={nbb}, logits std "
        f"{lg32.std().item():.3f}): float32 max_abs_err={err32:.3e} (atol {LOGITS_ATOL_F32}); "
        f"bf16 max_abs_err={err:.4f}, against float32 dense: kernel path {err_kernel:.4f}, "
        f"dense path {err_dense:.4f} (ratio limit {BF16_ERR_RATIO}); bf16 argmax agree "
        f"{agree}/{Bb}; kernel path re-derives the served last token {replay}/{Bb} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("forward_paged disagrees with forward_with_cache")


#
# phases 5-6: chunked prefill and speculative serving at full width
#


def serve_stats(name, results, wall):
    n_tok = sum(len(r.new_tokens) for r in results)
    ttft = float(np.median([r.ttft_s for r in results]))
    tpot = float(np.median([r.tpot_s for r in results]))
    say(f"{name}: {len(results)} requests, {n_tok} tokens in {wall:.3f} s = "
        f"{n_tok / wall:.1f} tokens/s; TTFT p50 {1e3 * ttft:.1f} ms; TPOT p50 "
        f"{1e3 * tpot:.2f} ms; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return dict(tokens_per_s=n_tok / wall, ttft_p50_ms=1e3 * ttft, tpot_p50_ms=1e3 * tpot)


def check_results(results, new_tokens, vocab):
    for r in results:
        toks = np.asarray(r.new_tokens)
        if (r.finish_reason != "length" or len(toks) != new_tokens
                or toks.min() < 0 or toks.max() >= vocab):
            raise AssertionError(f"request {r.rid}: bad result {r.finish_reason} {toks}")


CHUNK = 512
CHUNK_BUCKETS = tuple(16 * 2 ** i for i in range(6))          # 16 .. 512, block-aligned


def chunked_serve(params, cfg, n_requests=8, new_tokens=32):
    eng = serve(None, params, cfg, attn="paged", block_size=16, num_blocks=2048, max_batch=8,
                prefill_chunk=CHUNK, prefill_buckets=CHUNK_BUCKETS, device=DEVICE)
    kind = eng.stats()["attn"]["kinds"]["prefill_chunk"]
    say(f"chunked serve: chunk kind {kind['mode']!r} (fallback reason "
        f"{kind['fallback_reason']}), arena {eng.pool.arena_bytes() / 2**30:.2f} GiB")
    if kind["mode"] != "paged":
        raise AssertionError(f"the chunk kind resolved {kind['mode']!r}, not 'paged'")
    rng = np.random.default_rng(SEED + 5)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in rng.integers(1024, 3073, n_requests)]
    eng.run([prompts[0][:600]], max_new_tokens=2)            # warm-up: one chunk + final piece
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps0, chunks0 = eng.decode_steps, eng.chunk_runs
    cudaex.reset_launches()
    t0 = time.perf_counter()
    handles = [eng.submit(p, max_new_tokens=new_tokens) for p in prompts]
    eng.step()                                              # admits every request
    tables = [list(h._req.block_table) for h in handles]
    eng.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cudaex.LAUNCHES)
    steps, pieces = eng.decode_steps - steps0, eng.chunk_runs - chunks0
    results = [h.result(drive=False) for h in handles]
    check_results(results, new_tokens, cfg.padded_vocab_size)
    rec = serve_stats(f"chunked serve {cfg.name} bf16 (prompts {sorted(len(p) for p in prompts)}, "
                      f"prefill_chunk {CHUNK})", results, wall)
    want = no_launches_but(paged_attn_verify=pieces * cfg.n_layer,
                           paged_chunk_write=pieces * 2,
                           paged_attn_decode=steps * cfg.n_layer,
                           paged_token_write=steps * 2)
    say(f"launches during chunked serve: {launches} ({pieces} intermediate pieces, "
        f"{steps} decode steps; expected {want})")
    if launches != want or not pieces:
        raise AssertionError(f"chunked serve launch counts {launches} != {want} "
                             f"({pieces} intermediate pieces)")
    rec.update(launches=launches, pieces=pieces, steps=steps)
    return rec, eng, prompts, tables


def layer_skip_draft(params, cfg, n_layer=2):
    """The target's own embedding, first ``n_layer`` blocks, final norm and
    head: a draft made from the target's weights, sharing its tensors."""
    return {**params, "blocks": params["blocks"][:n_layer]}, Config.from_name(cfg.name,
                                                                               n_layer=n_layer)


def spec_serve(params, cfg, K=4, n_requests=8, new_tokens=32):
    dparams, dcfg = layer_skip_draft(params, cfg)
    eng = serve(None, params, cfg, attn="paged", block_size=16, num_blocks=1024, max_batch=8,
                speculative=SpecConfig(dparams, dcfg, K=K), device=DEVICE)
    rng = np.random.default_rng(SEED + 6)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in rng.integers(128, 1025, n_requests)]
    eng.run([prompts[0][:64]], max_new_tokens=8)             # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rounds0 = eng.spec_rounds
    cudaex.reset_launches()
    t0 = time.perf_counter()
    handles = [eng.submit(p, max_new_tokens=new_tokens) for p in prompts]
    eng.step()
    tables = [list(h._req.block_table) for h in handles]
    eng.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cudaex.LAUNCHES)
    rounds = eng.spec_rounds - rounds0
    results = [h.result(drive=False) for h in handles]
    check_results(results, new_tokens, cfg.padded_vocab_size)
    st = eng.stats()["speculative"]
    rec = serve_stats(f"speculative serve {cfg.name} bf16, {dcfg.n_layer}-layer draft, K={K} "
                      f"(prompts {sorted(len(p) for p in prompts)})", results, wall)
    say(f"speculative serve: {rounds} rounds, acceptance rate {st['acceptance_rate']:.4f}, "
        f"tokens per round {st['tokens_per_round']:.3f}, accept_len histogram "
        f"{st['accept_len_hist']} (warm-up included)")
    want = no_launches_but(paged_attn_verify=rounds * cfg.n_layer,
                           paged_token_write_masked=rounds * 2 * (K + 1))
    say(f"launches during speculative serve: {launches} (expected {want})")
    if launches != want or not rounds:
        raise AssertionError(f"speculative serve launch counts {launches} != {want} "
                             f"({rounds} rounds)")
    rec.update(launches=launches, rounds=rounds, acceptance_rate=st["acceptance_rate"],
               tokens_per_round=st["tokens_per_round"])
    # draft = target: every draft should be accepted (bf16 argmax flips
    # between the gathered draft path and the kernel verify path aside)
    same = serve(None, params, cfg, attn="paged", block_size=16, num_blocks=256, max_batch=2,
                 speculative=SpecConfig(params, cfg, K=K), device=DEVICE)
    cudaex.reset_launches()
    res = same.run(prompts[:2], max_new_tokens=16)
    st2 = same.stats()["speculative"]
    check_results(res, 16, cfg.padded_vocab_size)
    say(f"speculative serve, draft = target: acceptance rate {st2['acceptance_rate']:.4f}, "
        f"accept_len histogram {st2['accept_len_hist']}, launches {dict(cudaex.LAUNCHES)}")
    if st2["accept_len_hist"][K + 1] == 0:
        raise AssertionError("draft = target never accepted all K drafts")
    rec["self_draft_acceptance_rate"] = st2["acceptance_rate"]
    return rec, eng, prompts, results, tables


#
# phase 7: correctness at full width
#


def _exact_tokens(params32, cfg4, n_new=8):
    """Tokens, exact, in float32 at Llama-3-8B widths and 4 layers:
    chunked = unchunked, speculative = plain."""
    rng = np.random.default_rng(SEED + 7)
    long = [rng.integers(0, cfg4.vocab_size, n).astype(np.int32) for n in (1100, 1600)]
    common = dict(attn="paged", block_size=16, num_blocks=512, max_batch=4, device=DEVICE)

    def tokens(eng, prompts, n):
        return [r.new_tokens for r in eng.run(prompts, max_new_tokens=n)]

    unchunked = tokens(serve(None, params32, cfg4, prefill_buckets=tuple(16 * 2 ** i
                                                                         for i in range(8)),
                             **common), long, n_new)
    chunked_eng = serve(None, params32, cfg4, prefill_chunk=CHUNK, prefill_buckets=CHUNK_BUCKETS,
                        **common)
    chunked = tokens(chunked_eng, long, n_new)
    say(f"float32, 4 layers: chunked tokens {chunked} vs unchunked {unchunked} "
        f"({chunked_eng.chunk_runs} chunk pieces): {'equal' if chunked == unchunked else 'DIFFER'}")
    if chunked != unchunked:
        raise AssertionError("chunked prefill serves other tokens than the unchunked prefill")
    short = [rng.integers(0, cfg4.vocab_size, n).astype(np.int32) for n in (90, 200, 333, 411)]
    plain = tokens(serve(None, params32, cfg4, **common), short, 16)
    dparams, dcfg = layer_skip_draft(params32, cfg4)
    spec_eng = serve(None, params32, cfg4, speculative=SpecConfig(dparams, dcfg, K=4), **common)
    spec = tokens(spec_eng, short, 16)
    st = spec_eng.stats()["speculative"]
    say(f"float32, 4 layers: speculative tokens equal plain: {spec == plain} (acceptance rate "
        f"{st['acceptance_rate']:.4f}, {st['rounds']} rounds)")
    if spec != plain:
        raise AssertionError(f"speculative serving serves other tokens: {spec} vs {plain}")


def _compact(arenas, table_rows):
    """The blocks ``table_rows`` list, copied into a small arena (block 0
    stays the sink) with the tables renumbered to match."""
    used = sorted({b for row in table_rows for b in row} - {SINK_BLOCK})
    remap = {b: i + 1 for i, b in enumerate(used)}
    idx = torch.as_tensor([SINK_BLOCK] + used, device=DEVICE)
    small = {k: arenas[k][idx] for k in ("k", "v")}
    return small, [[remap.get(b, SINK_BLOCK) for b in row] for row in table_rows]


def _logits_bars(name, lp, lg, lp32, lg32):
    err32 = (lp32 - lg32).abs().max().item()
    err_kernel = (lp - lg32).abs().max().item()
    err_dense = (lg - lg32).abs().max().item()
    ok = (bool(torch.isfinite(lp).all()) and err32 <= LOGITS_ATOL_F32
          and err_kernel <= BF16_ERR_RATIO * err_dense)
    say(f"{name} logits, kernels vs dense path (logits std {lg32.std().item():.3f}): float32 "
        f"max_abs_err={err32:.3e} (atol {LOGITS_ATOL_F32}); bf16 against float32 dense: kernel "
        f"path {err_kernel:.4f}, dense path {err_dense:.4f} (ratio limit {BF16_ERR_RATIO}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: forward_paged disagrees with forward_with_cache")
    return dict(f32_max_abs_err=err32, bf16_kernel_err=err_kernel, bf16_dense_err=err_dense)


def chunk_and_verify_logits(params, cfg, chunk_case, spec_case):
    """At full depth: the second prefill chunk (T=512 at pos 512) of a
    chunked-served request, and one verify chunk (T=5) at each speculative
    row's first decode position, through the kernels against
    ``forward_with_cache`` over the same gathered blocks, bf16 and float32.
    Each case carries its served blocks compacted into a small arena."""
    ((small, (row,)), chunk_prompt) = chunk_case
    ((spec_small, rows), spec_prompts, spec_results) = spec_case
    dev = DEVICE
    out = {}

    def run(p, arenas, tab, toks, pos_paged, pos_dense, cdtype, nbb):
        cos, sin = build_rope_cache(cfg, nbb * BS, device=dev)
        lp, _ = forward_paged(p, toks, pos_paged, arenas, tab, cos, sin, cfg, cdtype=cdtype)
        kd, vd = gather_dense(arenas["k"], arenas["v"], tab)
        lg, _ = forward_with_cache(p, toks, pos_dense, {"k": kd, "v": vd}, cos, sin, cfg)
        return lp, lg

    params32 = _cast(params, torch.float32)
    # one prefill chunk
    nbb = len(row)
    tab = torch.as_tensor([row], dtype=torch.int32, device=dev)
    toks = torch.as_tensor(chunk_prompt[CHUNK:2 * CHUNK], device=dev)[None]
    pv = torch.tensor([CHUNK], dtype=torch.int32, device=dev)
    with torch.no_grad():
        lp, lg = run(params, small, tab, toks, pv, CHUNK, torch.bfloat16, nbb)
        lp32, lg32 = run(params32, _cast(small, torch.float32), tab, toks, pv, CHUNK,
                         torch.float32, nbb)
    torch.cuda.synchronize()
    out["prefill_chunk"] = _logits_bars(f"prefill chunk (T={CHUNK}, pos {CHUNK}, "
                                        f"{cfg.n_layer} layers)",
                                        lp, lg, lp32, lg32)
    del lp, lg, lp32, lg32
    # one verify chunk per speculative row
    small = spec_small
    nbb = max(len(r) for r in rows)
    tab = torch.as_tensor([r + [SINK_BLOCK] * (nbb - len(r)) for r in rows], dtype=torch.int32,
                          device=dev)
    pos = torch.as_tensor([len(p) for p in spec_prompts], dtype=torch.int32, device=dev)
    toks = torch.as_tensor([r.new_tokens[:5] for r in spec_results], dtype=torch.int32,
                           device=dev)
    with torch.no_grad():
        lp, lg = run(params, small, tab, toks, pos, pos, torch.bfloat16, nbb)
        lp32, lg32 = run(params32, _cast(small, torch.float32), tab, toks, pos, pos,
                         torch.float32, nbb)
    torch.cuda.synchronize()
    out["verify"] = _logits_bars(f"verify chunk (T=5, {len(rows)} rows, {cfg.n_layer} layers)",
                                 lp, lg, lp32, lg32)
    del params32
    return out


#
# phase 8: the flash-attention kernels against their plain versions
#

# the training shape: Llama-3-8B attention at B=1, T=2048, causal
FB, FH, FG, FT, FHS = 1, 32, 8, 2048, 128
# float32: the same arithmetic in another summation order, within this
# share of each output's largest magnitude
FLASH_REL_F32 = 1e-5


def _flash_run(q, k, v, g, mask, kw, fwd, bwd):
    out, lse = fwd(q, k, v, mask, **kw)
    return (out, lse, *bwd(g, q, k, v, out, lse, mask, **kw))


FLASH_OUTPUTS = ("out", "lse", "dq", "dk", "dv")


def check_flash_case(label, q, k, v, g, mask, kw) -> float:
    """The kernels against their plain versions on one input set: float32
    within FLASH_REL_F32 of each output's largest magnitude; bf16 held
    against the float32 plain result of the same inputs, each output's
    error at most LOWP_ERR_RATIO times the plain version's own (lse, float32
    on both sides, under the float32 bar); every kernel run twice gives
    bitwise-equal outputs.  Returns the largest error against the plain
    version (bf16: of out, dq, dk, dv)."""
    got = _flash_run(q, k, v, g, mask, kw, cudaex.flash_sdpa, cudaex.flash_sdpa_backward)
    again = _flash_run(q, k, v, g, mask, kw, cudaex.flash_sdpa, cudaex.flash_sdpa_backward)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    want = _flash_run(q, k, v, g, mask, kw, cudaex.flash_sdpa_plain,
                      cudaex.flash_sdpa_backward_plain)
    errs = {n: (a.float() - b.float()).abs().max().item() for n, a, b in
            zip(FLASH_OUTPUTS, got, want)}
    bars = {n: FLASH_REL_F32 * max(1.0, b.float().abs().max().item())
            for n, b in zip(FLASH_OUTPUTS, want)}
    ok = same and all(bool(torch.isfinite(a).all()) for a in got)
    notes = []
    if q.dtype == torch.float32:
        ok = ok and all(errs[n] <= bars[n] for n in FLASH_OUTPUTS)
    else:
        ref = _flash_run(*(x.float() for x in (q, k, v, g)), mask, kw, cudaex.flash_sdpa_plain,
                         cudaex.flash_sdpa_backward_plain)
        ok = ok and errs["lse"] <= bars["lse"]
        for n, a, b, r in zip(FLASH_OUTPUTS, got, want, ref):
            if n == "lse":
                continue
            ek, ep = (a.float() - r).abs().max().item(), (b.float() - r).abs().max().item()
            ok = ok and ek <= LOWP_ERR_RATIO * ep
            notes.append(f"{n} {ek:.2e}/{ep:.2e}")
        del ref
    say(f"flash {label} {str(q.dtype)[6:]}: max_abs_err vs plain "
        + ", ".join(f"{n} {e:.2e}" for n, e in errs.items())
        + (f"; against float32 kernel/plain: {', '.join(notes)} (ratio limit {LOWP_ERR_RATIO})"
           if notes else f" (bar {FLASH_REL_F32:.0e} of each output's max)")
        + f"; bitwise repeatable: {same} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"flash kernels disagree with their plain versions ({label})")
    return max(e for n, e in errs.items() if n != "lse" or q.dtype == torch.float32)


def flash_inputs(gen, B_, H, G, Tq, Tk, hs, dtype, mask=None):
    dev = DEVICE
    x = [torch.randn(shape, generator=gen, device=dev).to(dtype)
         for shape in ((B_, H, Tq, hs), (B_, G, Tk, hs), (B_, G, Tk, hs), (B_, H, Tq, hs))]
    if mask is not None:
        layout, mq = mask
        mq = 1 if mq == 1 else Tq
        shape = {"shared": (mq, Tk), "batch": (B_, 1, mq, Tk), "head": (1, H, mq, Tk),
                 "full": (B_, H, mq, Tk)}[layout]
        bias = torch.randn(shape, generator=gen, device=dev)
        drop = torch.rand(shape, generator=gen, device=dev) < 0.25
        mask = torch.where(drop, cudaex.MASK_VALUE, bias)
    return x, mask


# small shapes: non-causal, a window, Tq != Tk, hs 64 and 256, each mask
# layout with mq 1 and Tq (B, H, G, Tq, Tk, hs, causal, window, mask)
FLASH_SMALL = [
    (2, 4, 4, 256, 256, 64, False, None, None),
    (1, 8, 2, 256, 256, 64, True, 100, None),
    (1, 8, 2, 128, 256, 64, True, None, None),
    (1, 4, 2, 256, 128, 256, False, None, None),
    (2, 4, 2, 128, 128, 64, False, None, ("shared", 1)),
    (2, 4, 2, 128, 128, 64, False, None, ("shared", "T")),
    (2, 4, 2, 128, 128, 64, False, None, ("batch", 1)),
    (2, 4, 2, 128, 128, 64, False, None, ("batch", "T")),
    (2, 4, 2, 128, 128, 64, False, None, ("head", 1)),
    (2, 4, 2, 128, 128, 64, False, None, ("head", "T")),
    (2, 4, 2, 128, 128, 64, False, None, ("full", 1)),
    (2, 4, 2, 128, 128, 64, False, None, ("full", "T")),
]


def flash_bounds(dtype):
    """(bytes, operations) each kernel needs at the training shape: inputs
    read once, outputs written once; the causal pairs' products (the
    forward 2, the dq kernel 3, the dk/dv kernel 4)."""
    esize = torch.empty((), dtype=dtype).element_size()
    qn, kn = FB * FH * FT * FHS, FB * FG * FT * FHS
    rows = FB * FH * FT
    pairs = FB * FH * FT * (FT + 1) // 2
    per_product = 2 * FHS * pairs
    return {
        "flash_fwd": bound(esize * (2 * qn + 2 * kn) + 4 * rows, 2 * per_product, dtype),
        "flash_bwd_dq": bound(esize * (3 * qn + 2 * kn) + 8 * rows, 3 * per_product, dtype),
        "flash_bwd_dkv": bound(esize * (2 * qn + 4 * kn) + 8 * rows, 4 * per_product, dtype),
    }


def check_flash():
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 8)
    result = {}
    kw = dict(causal=True, scale=FHS ** -0.5, window=None)
    for dtype in (torch.bfloat16, torch.float32):
        (q, k, v, g), _ = flash_inputs(gen, FB, FH, FG, FT, FT, FHS, dtype)
        err = check_flash_case(f"training shape B={FB} H={FH} G={FG} T={FT} hs={FHS} causal",
                               q, k, v, g, None, kw)
        if dtype == torch.bfloat16:
            result = time_flash(q, k, v, g, kw)
            for name in result:
                result[name]["max_abs_err"] = err
        del q, k, v, g
    for B_, H, G, Tq, Tk, hs, causal, window, mask in FLASH_SMALL:
        for dtype in (torch.bfloat16, torch.float32):
            (q, k, v, g), m = flash_inputs(gen, B_, H, G, Tq, Tk, hs, dtype, mask)
            check_flash_case(f"B={B_} H={H} G={G} Tq={Tq} Tk={Tk} hs={hs} causal={causal} "
                             f"window={window} mask={mask}", q, k, v, g, m,
                             dict(causal=causal, scale=hs ** -0.5, window=window))
    return result


def time_flash(q, k, v, g, kw):
    """Times of the three kernels, their plain versions and the library
    yardstick (``F.scaled_dot_product_attention(..., is_causal=True,
    enable_gqa=True)``: its forward beside ``flash_fwd``, its backward
    through autograd, which computes dq, dk and dv together, beside each
    backward kernel) at the training shape, beside the bounds."""
    out, lse = cudaex.flash_sdpa(q, k, v, **kw)
    hs = q.shape[-1]
    delta = (g.float() * out.float()).sum(dim=-1)
    mma = cudaex._flash_mma(hs, q.dtype, (g, q, k, v))
    lib = _build.load_library()
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    _, ints = cudaex._flash_args(q, k, None, kw["causal"], kw["window"])
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    P = cudaex._ptr
    tiles = {kind: cudaex._flash_tiles(kind, hs, q.dtype, mma) for kind in ("dq", "dkv")}
    code = cudaex._FLASH_DTYPE_CODE[q.dtype]
    scale = ctypes.c_float(kw["scale"])

    def dq_kernel():       # the dq launch alone, as flash_sdpa_backward makes it
        rc = lib.tt_flash_bwd_dq(P(g), P(q), P(k), P(v), P(lse), P(delta), None, P(dq), *ints,
                                 *tiles["dq"], int(mma), scale, code, stream)
        cudaex._raise_on(lib, rc, "flash_bwd_dq")

    def dkv_kernel():
        rc = lib.tt_flash_bwd_dkv(P(g), P(q), P(k), P(v), P(lse), P(delta), None, P(dk), P(dv),
                                  *ints, *tiles["dkv"], int(mma), scale, code, stream)
        cudaex._raise_on(lib, rc, "flash_bwd_dkv")

    ql, kl, vl = (x.detach().requires_grad_() for x in (q, k, v))
    lib_out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True, enable_gqa=True)

    def lib_fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)

    def lib_bwd():
        torch.autograd.grad(lib_out, (ql, kl, vl), g, retain_graph=True)

    bounds = flash_bounds(q.dtype)
    rec = {
        "flash_fwd": timed("flash_fwd", "", lambda: cudaex.flash_sdpa(q, k, v, **kw),
                           lambda: cudaex.flash_sdpa_plain(q, k, v, **kw), lib_fwd,
                           "SDPA forward", bounds["flash_fwd"], iters=20, plain_iters=3,
                           plain_warmup=1, device_kernel="flash_fwd_kernel"),
        "flash_bwd_dq": timed("flash_bwd_dq", "", dq_kernel,
                              lambda: cudaex.flash_sdpa_backward_plain(g, q, k, v, out, lse, **kw),
                              lib_bwd, "SDPA backward (dq, dk, dv)", bounds["flash_bwd_dq"],
                              iters=20, plain_iters=3, plain_warmup=1,
                              device_kernel="flash_bwd_dq_kernel"),
        "flash_bwd_dkv": timed("flash_bwd_dkv", "", dkv_kernel,
                               lambda: cudaex.flash_sdpa_backward_plain(g, q, k, v, out, lse,
                                                                        **kw),
                               lib_bwd, "SDPA backward (dq, dk, dv)", bounds["flash_bwd_dkv"],
                               iters=20, plain_iters=3, plain_warmup=1,
                               device_kernel="flash_bwd_dkv_kernel"),
    }
    say("flash plain times: the backward's plain version computes dq, dk and dv together, "
        "so both backward rows carry the same plain time")
    return rec


#
# phases 9-10: train Llama-3-8B at full width
#

TRAIN_B, TRAIN_T, TRAIN_LR, TRAIN_STEPS = 1, 2048, 1e-4, 4
TRAIN_LOSS_REL = 1e-5       # float32 step, kernels vs plain versions
TRAIN_GRAD_REL = 1e-4       # each grad, of its own largest magnitude
# the bf16 loss is one number, a mean of 2048 row losses: its error against
# float32 is rounding noise of ~1e-5 relative on either path, so a ratio of
# two such errors means little; it may exceed twice the plain path's by this
# share of the loss (the grads, millions of numbers, take the bare ratio)
TRAIN_LOSS_FLOOR_BF16 = 1e-4


def train_batch(cfg, seed):
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    idx = torch.randint(0, cfg.vocab_size, (TRAIN_B, TRAIN_T), generator=gen, device=DEVICE)
    tgt = torch.randint(0, cfg.vocab_size, (TRAIN_B, TRAIN_T), generator=gen, device=DEVICE)
    cos, sin = build_rope_cache(cfg, TRAIN_T, device=DEVICE)
    return idx, tgt, cos, sin


def make_step(cfg, remat="full_block"):
    return make_train_step(lambda p, i, t, c, s: gpt_loss(p, i, t, c, s, cfg),
                           adamw(TRAIN_LR), remat=remat)


@contextlib.contextmanager
def plain_flash():
    """The attention function calls the kernels' plain versions."""
    saved = dict(ltorch.FLASH)
    ltorch.FLASH.update(forward=cudaex.flash_sdpa_plain,
                        backward=cudaex.flash_sdpa_backward_plain)
    try:
        yield
    finally:
        ltorch.FLASH.update(saved)


def train_correctness(params, cfg):
    """One step's loss and grads at Llama-3-8B widths and 4 layers, through
    the kernels and through their plain versions: float32 (TF32 off) within
    TRAIN_LOSS_REL / TRAIN_GRAD_REL; bf16 held against the float32 kernel
    step, the kernel path's error at most LOWP_ERR_RATIO times the plain
    path's own (loss, and the relative L2 error of all grads)."""
    cfg4 = Config.from_name(cfg.name, n_layer=4)
    batch = train_batch(cfg4, SEED + 9)
    step = make_step(cfg4)
    p16 = {**params, "blocks": params["blocks"][:4]}
    p32 = _cast(p16, torch.float32)
    loss_k, g_k = step.grads(p32, None, *batch)
    with plain_flash():
        loss_p, g_p = step.grads(p32, None, *batch)
    torch.cuda.synchronize()
    loss_err = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    worst, worst_name = -1.0, None
    for name, a, b in zip(_names(g_p), tree_leaves(g_k), tree_leaves(g_p)):
        rel = (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
        if rel > worst:
            worst, worst_name = rel, name
    ok = loss_err <= TRAIN_LOSS_REL and worst <= TRAIN_GRAD_REL and math.isfinite(loss_k.item())
    say(f"train step float32, {cfg4.n_layer} layers at full width (B={TRAIN_B}, T={TRAIN_T}): "
        f"loss kernels {loss_k.item():.6f} plain {loss_p.item():.6f} (rel {loss_err:.2e}, bar "
        f"{TRAIN_LOSS_REL:.0e}); worst grad rel max-abs diff {worst:.2e} ({worst_name}, bar "
        f"{TRAIN_GRAD_REL:.0e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the float32 train step through the kernels disagrees with the "
                             "plain versions")
    del p32, g_p
    loss16_k, g16_k = step.grads(p16, None, *batch)
    with plain_flash():
        loss16_p, g16_p = step.grads(p16, None, *batch)
    torch.cuda.synchronize()

    def l2_err(gs):
        num = sum(((a.float() - r) ** 2).sum().item() for a, r in zip(tree_leaves(gs),
                                                                       tree_leaves(g_k)))
        den = sum((r ** 2).sum().item() for r in tree_leaves(g_k))
        return math.sqrt(num / den)

    lk, lp = abs(loss16_k.item() - loss_k.item()), abs(loss16_p.item() - loss_k.item())
    gk, gp = l2_err(g16_k), l2_err(g16_p)
    floor = TRAIN_LOSS_FLOOR_BF16 * abs(loss_k.item())
    ok = lk <= LOWP_ERR_RATIO * lp + floor and gk <= LOWP_ERR_RATIO * gp
    say(f"train step bf16 against the float32 step: loss error kernels {lk:.3e} plain {lp:.3e} "
        f"(limit {LOWP_ERR_RATIO}× plain + {floor:.2e}); grads relative L2 error kernels "
        f"{gk:.3e} plain {gp:.3e} (ratio limit {LOWP_ERR_RATIO}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the bf16 train step through the kernels strays further from float32 "
                             "than the plain versions")
    return dict(loss_rel_f32=loss_err, grad_rel_f32=worst, bf16_loss_err=(lk, lp),
                bf16_grad_l2=(gk, gp))


def _names(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _names(tree[k], f"{prefix}.{k}" if prefix else k)
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from _names(x, f"{prefix}[{i}]")
    else:
        yield prefix


def model_flops(cfg, n_params):
    """6·N·B·T (the matmuls of forward and backward, every parameter
    counted) + 3·n_layer·4·B·nh·hs·T²/2 (causal attention, forward and a
    backward of twice the forward); no remat recompute."""
    attn = 4 * TRAIN_B * cfg.n_head * cfg.head_size * TRAIN_T ** 2 / 2
    return 6 * n_params * TRAIN_B * TRAIN_T + 3 * cfg.n_layer * attn


def train_full_width(params, cfg):
    """TRAIN_STEPS AdamW steps of Llama-3-8B at full width and depth on one
    fixed batch, remat full_block, bf16: exact flash launch counts, no
    declines, finite losses, the last below the first; then one more step
    under the profiler."""
    batch = train_batch(cfg, SEED + 10)
    step = make_step(cfg)
    t0 = time.perf_counter()
    opt_state = step.init_optimizer_state(params)
    torch.cuda.synchronize()
    say(f"AdamW state for {param_count(params) / 1e9:.3f} B params in "
        f"{time.perf_counter() - t0:.1f} s; memory allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    torch.cuda.reset_peak_memory_stats()
    cudaex.reset_launches()
    for key in ltorch.DECLINES:
        ltorch.DECLINES[key] = 0
    losses, times = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        params, opt_state, loss = step(params, opt_state, *batch)
        losses.append(loss.item())                     # waits for the step
        times.append(time.perf_counter() - t0)
    launches = dict(cudaex.LAUNCHES)
    declines = dict(ltorch.DECLINES)
    peak = torch.cuda.max_memory_allocated()
    L = cfg.n_layer
    want = no_launches_but(flash_fwd=2 * L * TRAIN_STEPS, flash_bwd_dq=L * TRAIN_STEPS,
                           flash_bwd_dkv=L * TRAIN_STEPS)
    step_s = float(np.mean(times[1:]))
    flops = model_flops(cfg, param_count(params))
    say(f"train {cfg.name} bf16, {L} layers, B={TRAIN_B} T={TRAIN_T}, remat "
        f"{step.last_remat_policy}, AdamW lr {TRAIN_LR}: losses {losses}; step times "
        f"{[round(t, 4) for t in times]} s (first includes warm-up); step time (steps 2-"
        f"{TRAIN_STEPS}) {1e3 * step_s:.1f} ms = {TRAIN_B * TRAIN_T / step_s:.1f} tokens/s; "
        f"model FLOPs per step {flops:.4e} (6·N·B·T + 3·n_layer·4·B·nh·hs·T²/2, N = "
        f"{param_count(params)}) = {flops / step_s / 1e12:.1f} TFLOP/s, "
        f"{flops / step_s / PEAK_OPS_PER_S[torch.bfloat16]:.4f} of 989 TFLOP/s; "
        f"max_memory_allocated {peak / 2**30:.2f} GiB")
    say(f"launches during {TRAIN_STEPS} train steps: {launches} (expected {want}); declines "
        f"{declines}")
    if launches != want or any(declines.values()):
        raise AssertionError(f"train launch counts {launches} != {want} or declines {declines}")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"train losses {losses}: not finite or not falling")
    profile_train_step(step, params, opt_state, batch)
    return dict(launches=launches, losses=losses, step_ms=1e3 * step_s, peak_gib=peak / 2**30)


def profile_train_step(step, params, opt_state, batch):
    """Device time of one more train step by kernel group, from the
    profiler's CUDA activity, and the card's idle share of its kernel span."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        step(params, opt_state, *batch)[2].item()
        torch.cuda.synchronize()
    spans = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    if not spans:
        say("train step profile: not measured (the profiler saw no CUDA activity)")
        return
    busy = sum(end - start for _, start, end in spans)
    window = max(end for *_, end in spans) - min(start for _, start, _ in spans)
    groups: dict[str, float] = {}
    for name, start, end in spans:
        low = name.lower()
        key = ("flash fwd" if "flash_fwd_kernel" in low
               else "flash dq" if "flash_bwd_dq_kernel" in low
               else "flash dk/dv" if "flash_bwd_dkv_kernel" in low
               else "cuBLAS GEMMs" if any(s in low for s in ("gemm", "gemv", "cutlass", "xmma",
                                                             "nvjet"))
               else "optimizer" if "adam" in low
               else "the rest")
        groups[key] = groups.get(key, 0.0) + (end - start)
    say(f"train step profile: device busy {busy / 1e3:.3f} ms over a {window / 1e3:.3f} ms kernel "
        f"span (idle share {1 - busy / window:.4f}); device ms by group: "
        f"{ {k: round(v / 1e3, 3) for k, v in sorted(groups.items(), key=lambda kv: -kv[1])} }")


def main() -> int:
    global CARD
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    CARD = card_line()
    print(CARD, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")

    if not cudaex.paged_available():
        raise RuntimeError("the paged kernels cannot be built here: no nvcc found")
    _build.load_library()
    info = _build.build_info
    say(f"built {len(info['sources'])} sources in parallel in {info['seconds']:.1f} s "
        f"(cached: {info['cached']})")
    for name, src in info["sources"].items():
        say(f"{name} -> {src['path']}")
        for line in src["log"].splitlines():
            if "registers" in line or "spill" in line or "Function properties" in line:
                say(f"ptxas: {line.strip()}")

    recs = {"paged_attn_decode": check_decode(), "paged_token_write": check_write(),
            "paged_attn_verify": check_verify(), "paged_chunk_write": check_chunk_write(),
            "paged_token_write_masked": check_masked_write(), **check_flash()}
    torch.cuda.empty_cache()
    params, cfg = make_params()
    served = {"decode serve": serve_full_width(params, cfg)}
    crec, eng, prompts, tables = chunked_serve(params, cfg)
    served["chunked serve"] = crec["launches"]
    chunk_case = (_compact(eng.pool.arenas, [tables[0]]), prompts[0])
    del eng
    torch.cuda.empty_cache()
    srec, eng, prompts, results, tables = spec_serve(params, cfg)
    served["speculative serve"] = srec["launches"]
    spec_case = (_compact(eng.pool.arenas, tables), prompts, results)
    del eng
    torch.cuda.empty_cache()
    cfg4 = Config.from_name(cfg.name, n_layer=4)
    _exact_tokens(_cast({**params, "blocks": params["blocks"][:4]}, torch.float32), cfg4)
    torch.cuda.empty_cache()
    chunk_and_verify_logits(params, cfg, chunk_case, spec_case)
    del chunk_case, spec_case
    gc.collect()                 # the serving engines' arenas, held in reference cycles
    torch.cuda.empty_cache()
    train_correctness(params, cfg)
    gc.collect()
    torch.cuda.empty_cache()
    # the serving params become the trained ones: updated in place from here
    served["train step"] = train_full_width(params, cfg)["launches"]

    sources = {"paged_attn_decode": "paged_attention.cu", "paged_token_write": "paged_attention.cu",
               "paged_attn_verify": "paged_verify.cu", "paged_chunk_write": "paged_verify.cu",
               "paged_token_write_masked": "paged_attention.cu",
               "flash_fwd": "flash_attention.cu", "flash_bwd_dq": "flash_attention.cu",
               "flash_bwd_dkv": "flash_attention.cu"}
    replaces = {"paged_attn_decode": 1165, "paged_token_write": 1249, "paged_attn_verify": 1376,
                "paged_chunk_write": 1535, "paged_token_write_masked": 1462, "flash_fwd": 293,
                "flash_bwd_dq": 460, "flash_bwd_dkv": 460}
    # the Pallas function and its pallas_call site, where they differ
    counterpart = {"flash_fwd": "_flash_fwd (pallas_call :322)",
                   "flash_bwd_dq": "_flash_bwd (dq pallas_call :495)",
                   "flash_bwd_dkv": "_flash_bwd (dk/dv pallas_call :526)"}
    kernels = []
    for name, rec in recs.items():
        by_path = {path: counts[name] for path, counts in served.items() if counts[name]}
        launches = sum(by_path.values())
        if not launches:
            raise AssertionError(f"{name} launched on no path")
        line = f"thunder_tpu/executors/pallasex.py:{replaces[name]}"
        kernels.append(dict(
            name=name, route="cuda", source=f"thunder_tpu_torch/csrc/{sources[name]}",
            replaces=line, jax_counterpart=f"{line} {counterpart.get(name, name)}", check="pass",
            launches=launches,
            launches_by_path=by_path, max_abs_err=rec["max_abs_err"], ms=rec["ms"],
            device_ms=rec["device_ms"], plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
            bound_us=1e3 * rec["bound_ms"], bound_by=rec["bound_by"],
            library_ms=rec["library_ms"], card=CARD,
            **({"shapes": rec["shapes"]} if "shapes" in rec else {})))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
