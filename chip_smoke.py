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
   bound.  On int8 and fp8 arenas (quantized KV): ``paged_attn_decode``
   (B=8) and ``paged_attn_verify`` (both shapes; the profiler must see the
   tensor-core body run on the quantized arena) in float32 within 1e-5 and
   in bf16 by the ratio bar; ``paged_token_write_fused`` (B=8, the plain
   write and every offset 0..4 of the masked one) and
   ``paged_chunk_write_fused`` (32 blocks) with stored bytes and scales
   bitwise equal to the plain versions' and error sums within 1e-5
   relative; their times beside the bounds (no single PyTorch call
   computes these functions, so no library time).  The decode and verify
   kernels at head sizes 16 and 80 (off the 64/128/256 grid), bf16 and
   float32, by the same bars.  ``flash_ce`` at the
   training step's (2048, 128256), float32 and bf16 logits, random
   targets, loss and lse within 1e-5 of their largest magnitude, timed
   beside ``F.cross_entropy(..., reduction="none")`` (the losses only);
   ``lora_delta_fused`` at the decode (B=8, T=1), verify (B=8, T=5) and
   chunk (B=1, T=512) shapes for wq, wk and wo, ranks 8, 16, 64 and 128
   (two of the kernel's 64-rank chunks), x in
   bf16 and float32, factors in float32 and bf16 (float32 within 1e-5 of
   the output's max magnitude, bf16 by the ratio bar, base-slot rows
   exactly 0), timed at each shape and at rank 128 (no library call
   computes it);
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
6b. quantized serves: the chunked serve with ``kv_dtype="int8"`` on a pool
   of the bf16 chunked pool's bytes (1.94x the blocks), then the
   speculative serve with ``kv_dtype="fp8"`` (the draft arena inherits
   fp8); exact launch counts (the fused writes only, never an unquantized
   write), the ``serving.kv_quant.rel_err`` gauge in (0, 0.05), and one
   decode step's logits off the int8 arenas through the kernels against
   ``gather_dense_q`` and ``forward_with_cache`` (phase 4's bars);
6c. LoRA serves: a registry of rank 16, alpha 32 (scaling 2), targets
   wq/wk/wv/wo, three adapters of std 0.05 from a seeded generator; the
   chunked serve of phase 5 and the speculative serve of phase 6 with two
   requests per adapter and two base ones; exact launch counts
   (``lora_delta_fused`` 4·n_layer per decode step, chunk piece and verify
   round, none elsewhere), the tenant counters, TTFT/TPOT/tokens/s beside
   the serves without LoRA, and one decode step's logits through the
   kernels against the dense path with the plain delta (phase 4's bars);
7. correctness at full width: served tokens, exact, in float32 at
   Llama-3-8B widths and 4 layers (chunked = unchunked, speculative =
   plain; on an int8 pool paged = gather, unchunked and chunked, with
   chunked against unchunked reported; with LoRA paged = gather, alone =
   mixed, adapters change tokens, base in a LoRA engine = registry-free,
   and two adapters with a shared 2-block prefix each = their solo run);
   tiny-llama-debug at its own hs 16 served on the default attn, which must
   resolve paged, through the decode kernel, with the gather path's tokens;
   and at
   full depth one prefill chunk (T=512) and one verify chunk (T=5) through
   the kernels against ``forward_with_cache`` over the gathered cache,
   float32 within 1e-3, bf16 error within twice the dense bf16 path's own;
8. flash attention (run with the kernels of phase 3): the forward, dq and
   dk/dv kernels against their plain versions at the training shape (B=1,
   32 heads over 8 KV groups, T=2048, hs=128, causal) and at small shapes
   (non-causal, a window, Tq != Tk, hs 64 and 256, every mask layout), bf16
   and float32, each run twice bitwise equal, each case printing the body
   the wrappers picked (bf16 at hs 64/128: the warpgroup body); then their
   times beside the plain versions, ``F.scaled_dot_product_attention`` and
   the bounds;
9. train correctness: one step's loss and grads at Llama-3-8B widths and 4
   layers, through the kernels (flash attention and the fused
   cross-entropy, one launch) against their plain versions, float32 and
   bf16;
10. train at full width and depth: 4 AdamW steps of Llama-3-8B (bf16,
    B=1, T=2048, remat full_block, lr 1e-4) on one fixed batch, with
    exact flash and ``flash_ce`` (one per step) launch counts, no declines
    (attention or cross-entropy), finite losses and the last below
    the first; step time, tokens/s, model FLOPs and their share of peak,
    peak memory; then two more steps profiled by kernel group, one on the
    flash bodies the wrappers pick (the warpgroup kernels, by name) and one
    on the WMMA body (the earlier tensor-core body): the step's device
    time must fall by at least 0.9 of the flash groups' saving;
11. a ``{"kernels": [...]}`` line, then the ``{"ok": true, ...}`` line.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import re
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
from thunder_tpu_torch.observability import registry
from thunder_tpu_torch.train.optim import adamw
from thunder_tpu_torch.serving import AdapterRegistry, SpecConfig, make_lora_factors, serve
from thunder_tpu_torch.serving.lora import gather_adapter_slots
from thunder_tpu_torch.serving.kv_pool import SINK_BLOCK, chunk_tables, gather_dense
from thunder_tpu_torch.serving.paged_attention import forward_paged
from thunder_tpu_torch.serving.quant import (
    arena_block_bytes,
    blocks_for_arena_bytes,
    gather_dense_q,
    quantize_kv,
)

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


def device_ms(fn, kernel: str, iters: int = 20, also=()) -> float | None:
    """Mean device time of the kernels whose name contains ``kernel``, from
    the profiler's CUDA activity (host launch overhead excluded), plus that
    of the kernels named like an entry of ``also`` that ``fn`` launches
    beside it; None when the profiler sees no device activity."""
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
        elif any(a in evt.key for a in also):
            total += evt.device_time_total
    return total / count / 1e3 if count else None


def bound(nbytes: float, ops: float, dtype) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[dtype]
    return (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


NO_LIBRARY = "no single PyTorch call computes this"


def timed(name, label, kernel, plain, library, library_name, bound_ms_by, *, iters,
          plain_iters, plain_warmup=3, device_kernel=None, device_also=(),
          dtype_name="bf16") -> dict:
    """Per-call times of a kernel, its plain version and the library call
    computing the same function (``library`` None where no single PyTorch
    call does), the kernel's device time (of the CUDA kernels named like
    ``device_kernel``, default ``name``), and its bound."""
    ms = time_ms(kernel, iters=iters)
    dev_ms = device_ms(kernel, device_kernel or name, also=device_also)
    plain_ms = time_ms(plain, iters=plain_iters, warmup=plain_warmup)
    library_ms = time_ms(library, iters=iters) if library is not None else None
    bound_ms, bound_by = bound_ms_by
    lib = f"{library_name} {library_ms:.4f} ms" if library is not None else f"library: {NO_LIBRARY}"
    say(f"{name} {dtype_name}{label} timing per call: kernel {ms:.4f} ms (device {dev_ms} ms), "
        f"plain {plain_ms:.4f} ms, {lib}, bound {1e3 * bound_ms:.3f} us ({bound_by})")
    return dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by,
                **({} if library is not None else {"library": NO_LIBRARY}))


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
        ref = plain(**{k: v.float() if v.is_floating_point() and v.element_size() > 1 else v
                       for k, v in x.items()}, **kw)
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


# the decode and verify kernels at head sizes off the 64/128/256 grid the
# wrappers once required: tiny-llama-debug's 16 and 80 (bf16 takes the
# verify kernel's tensor-core body, float32 its scalar one); 32 heads over
# 8 groups, block 16, ragged positions with a padding row and a block edge
ODD_HEAD_SIZES = (16, 80)


def odd_head_inputs(dtype, gen, hs, T=None):
    """Decode (T None) or verify (T tokens per request) inputs at head size
    ``hs``: 4 requests over a 2-layer, 128-block arena."""
    dev, Bo, nbb, nblocks = DEVICE, 4, 16, 128
    pos = np.array([0, 37, 128, 250 - (T or 0)], np.int32)
    tables = np.full((Bo, nbb), SINK_BLOCK, dtype=np.int32)
    free = np.random.default_rng(SEED + hs).permutation(np.arange(1, nblocks))
    k = 0
    for i, p in enumerate(pos):
        n = -(-(int(p) + (T or 0)) // BS)
        tables[i, :n] = free[k:k + n]
        k += n
    shape = (nblocks, 2, NG, BS, hs)
    qs, fs = ((Bo, NH, hs), (Bo, NG, hs)) if T is None else ((Bo, NH, T, hs), (Bo, NG, T, hs))
    return dict(
        q=torch.randn(qs, generator=gen, device=dev).to(dtype),
        k_arena=torch.randn(shape, generator=gen, device=dev).to(dtype),
        v_arena=torch.randn(shape, generator=gen, device=dev).to(dtype),
        fresh_k=torch.randn(fs, generator=gen, device=dev).to(dtype),
        fresh_v=torch.randn(fs, generator=gen, device=dev).to(dtype),
        tables=torch.as_tensor(tables, device=dev),
        pos=torch.as_tensor(pos, device=dev),
    )


def check_head_sizes() -> None:
    """``paged_attn_decode`` and ``paged_attn_verify`` (T=5) at each of
    ODD_HEAD_SIZES against their plain versions, phase 3's bars."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 16)
    for hs in ODD_HEAD_SIZES:
        for dtype in (torch.bfloat16, torch.float32):
            check_attn("paged_attn_decode", f"hs={hs}", cudaex.paged_attn_decode,
                       cudaex.paged_attn_decode_plain, odd_head_inputs(dtype, gen, hs), layer=1)
            check_attn("paged_attn_verify", f"hs={hs} T=5", cudaex.paged_attn_verify,
                       cudaex.paged_attn_verify_plain, odd_head_inputs(dtype, gen, hs, T=5),
                       layer=1)


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
# phase 3, continued: quantized KV (kv_dtype int8 / fp8) — the dequantizing
# attention kernels and the fused quantizing writes
#

QUANT = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}
# the fused chunk write's error sums: f32 sums in another order
ERR_SUMS_REL = 1e-5


def quantize_arenas(x, storage):
    """``x`` with its K/V arenas quantized into ``storage`` and their
    scales beside them: what a quantized pool holds."""
    out = dict(x)
    for name in ("k", "v"):
        q, s = quantize_kv(out.pop(f"{name}_arena"), storage)
        out[f"{name}_arena"], out[f"{name}_scale"] = q, s
    return out


def quant_attn_bound(pos, T, nbb, dtype):
    """Bound of a dequantizing attention call: the live 1-byte K/V and
    their float32 scales read once, q in and out, the fresh K/V, tables and
    positions; the products as the float kernels count them."""
    esize = torch.empty((), dtype=dtype).element_size()
    Bv, slots = len(pos), int(pos.sum())
    nbytes = (2 * slots * NG * HS + 2 * slots * NG * 4         # K/V bytes and scales
              + 2 * Bv * NH * T * HS * esize + 2 * Bv * NG * T * HS * esize
              + 4 * Bv * nbb + 4 * Bv)
    ops = 4 * NH * HS * (slots * T + Bv * T * (T + 1) // 2)
    return bound(nbytes, ops, dtype)


def _cast_inputs(x, dtype):
    return {k: v.to(dtype) if k in ("q", "fresh_k", "fresh_v") else v for k, v in x.items()}


def check_decode_quant(layer=L - 3):
    """``paged_attn_decode`` on int8 and fp8 arenas at the decode shape:
    float32 within ATOL_F32 of the plain version, bf16 by the ratio bar;
    then the bf16 times."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 11)
    result = {}
    for kind, storage in QUANT.items():
        x, pos = decode_inputs(torch.bfloat16, gen)
        xq = quantize_arenas(x, storage)
        del x
        for dtype in (torch.bfloat16, torch.float32):
            xd = _cast_inputs(xq, dtype)
            err = check_attn("paged_attn_decode", f"{kind} arena", cudaex.paged_attn_decode,
                             cudaex.paged_attn_decode_plain, xd, layer=layer)
            if dtype == torch.bfloat16:
                rec = timed(
                    "paged_attn_decode", f" {kind} arena",
                    lambda: cudaex.paged_attn_decode(**xd, layer=layer),
                    lambda: cudaex.paged_attn_decode_plain(**xd, layer=layer),
                    None, None, quant_attn_bound(pos, 1, NBB, dtype), iters=200, plain_iters=10,
                    plain_warmup=1)
                rec["max_abs_err"] = err
                result[kind] = rec
            del xd
        del xq
    return result


def check_verify_quant(layer=L - 3):
    """``paged_attn_verify`` on int8 and fp8 arenas at the spec and chunk
    shapes, bf16 (the tensor-core body, which the profiler must see run)
    and float32 (the scalar body); then the bf16 times."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 12)
    result = {}
    for kind, storage in QUANT.items():
        result[kind] = {}
        for shape, dims in VERIFY_SHAPES.items():
            x, pos = verify_inputs(torch.bfloat16, gen, **dims)
            xq = quantize_arenas(x, storage)
            del x
            for dtype in (torch.bfloat16, torch.float32):
                xd = _cast_inputs(xq, dtype)
                err = check_attn("paged_attn_verify",
                                 f"{kind} arena, {shape} B={dims['Bv']} T={dims['T']}",
                                 cudaex.paged_attn_verify, cudaex.paged_attn_verify_plain, xd,
                                 layer=layer)
                if dtype == torch.bfloat16:
                    def kernel():
                        return cudaex.paged_attn_verify(**xd, layer=layer)

                    mma = device_ms(kernel, "paged_attn_verify_mma", iters=3)
                    say(f"paged_attn_verify {kind} arena, {shape}: tensor-core body "
                        f"paged_attn_verify_mma_kernel device time {mma} ms")
                    if mma is None:
                        raise AssertionError(f"paged_attn_verify on the {kind} arena did not "
                                             "run its tensor-core body")
                    rec = timed(
                        "paged_attn_verify", f" {kind} arena B={dims['Bv']} T={dims['T']}",
                        kernel, lambda: cudaex.paged_attn_verify_plain(**xd, layer=layer),
                        None, None, quant_attn_bound(pos, dims["T"], dims["nbb"], dtype),
                        iters=50,
                        plain_iters=3, plain_warmup=1)
                    rec["max_abs_err"] = err
                    result[kind][shape] = rec
                del xd
            del xq
    return result


def check_token_write_fused(K=4):
    """``paged_token_write_fused`` at B=8 into int8 and fp8 arenas of the
    decode shape: the plain write and the masked one at every offset 0..K
    with n_emit from 0 to K+1, stored bytes and scales bitwise equal to the
    plain version's outside sink block 0; then the plain write's times."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 13)
    x, _ = decode_inputs(torch.bfloat16, gen)
    tables, posd = x["tables"], x["pos"]
    base = x.pop("k_arena")
    del x
    n_emit = torch.tensor([1, 5, 0, 3, 2, 4, 0, 5], dtype=torch.int32, device=DEVICE)
    result = {}
    for kind, storage in QUANT.items():
        arena, scale = quantize_kv(base, storage)
        for off in (None, *range(K + 1)):
            vals = (3 * torch.randn((B, L, NG, HS), generator=gen, device=DEVICE)).to(
                torch.bfloat16)
            vals[0, 0, 0] = 0.0                                  # an all-zero vector
            kw = {} if off is None else dict(n_emit=n_emit, offset=off)
            wa, ws = cudaex.paged_token_write_fused_plain(arena.clone(), scale.clone(), vals,
                                                          tables, posd, block_size=BS, **kw)
            ga, gs = cudaex.paged_token_write_fused(arena, scale, vals, tables, posd,
                                                    block_size=BS, **kw)
            torch.cuda.synchronize()
            if not (torch.equal(ga.view(torch.uint8)[1:], wa.view(torch.uint8)[1:])
                    and torch.equal(gs[1:], ws[1:])):
                raise AssertionError(f"paged_token_write_fused {kind} offset {off} disagrees "
                                     "with its plain version")
            del wa, ws
        say(f"paged_token_write_fused {kind}: stored bytes and scales bitwise equal outside "
            f"block 0, plain write and masked offsets 0..{K}")
        # bf16 values in; bytes and scales out; tables, positions
        nbytes = (B * L * NG * HS * 2 + B * L * NG * HS + B * L * NG * 4
                  + 4 * tables.numel() + 4 * B)
        rec = timed(
            "paged_token_write_fused", f" {kind} (B={B})",
            lambda: cudaex.paged_token_write_fused(arena, scale, vals, tables, posd,
                                                   block_size=BS),
            lambda: cudaex.paged_token_write_fused_plain(arena, scale, vals, tables, posd,
                                                         block_size=BS),
            None, None, bound(nbytes, 0, torch.bfloat16), iters=500, plain_iters=100)
        rec["max_abs_err"] = 0.0
        result[kind] = rec
        del arena, scale
    return result


def check_chunk_write_fused():
    """``paged_chunk_write_fused`` of one chunk of the chunk shape (32
    blocks at pos 2560) through its 192-entry scatter table into int8 and
    fp8 arenas: bytes and scales bitwise equal to the plain version's
    outside sink block 0, the error sums within ERR_SUMS_REL; then times."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 14)
    nc, nbb = VERIFY_SHAPES["chunk"]["T"] // BS, VERIFY_SHAPES["chunk"]["nbb"]
    rng = np.random.default_rng(SEED + 3)
    leased = [int(b) for b in rng.permutation(np.arange(1, NUM_BLOCKS))[:nbb - 8]]
    _, dest = chunk_tables(leased, CHUNK_POS, nc * BS, nbb, BS)
    dest_d = torch.as_tensor(dest, device=DEVICE)
    pos_d = torch.tensor([CHUNK_POS], dtype=torch.int32, device=DEVICE)
    result = {}
    for kind, storage in QUANT.items():
        arena, scale = quantize_kv(
            torch.randn((NUM_BLOCKS, L, NG, BS, HS), generator=gen, device=DEVICE), storage)
        vals = (3 * torch.randn((nc, L, NG, BS, HS), generator=gen, device=DEVICE)).to(
            torch.bfloat16)
        wa, ws, werr = cudaex.paged_chunk_write_fused_plain(arena.clone(), scale.clone(), vals,
                                                            dest_d, pos_d, block_size=BS)
        ga, gs, gerr = cudaex.paged_chunk_write_fused(arena, scale, vals, dest_d, pos_d,
                                                      block_size=BS)
        torch.cuda.synchronize()
        same = (torch.equal(ga.view(torch.uint8)[1:], wa.view(torch.uint8)[1:])
                and torch.equal(gs[1:], ws[1:]))
        sums_rel = ((gerr - werr).abs() / werr.abs().clamp_min(1e-30)).max().item()
        rel = (gerr[:, 0].sum() / (gerr[:, 1].sum() + 1e-30)).item()
        ok = same and sums_rel <= ERR_SUMS_REL and 0.0 < rel < 0.05
        say(f"paged_chunk_write_fused {kind}: bytes and scales bitwise equal outside block 0: "
            f"{same}; error sums max relative difference {sums_rel:.2e} (bar {ERR_SUMS_REL}); "
            f"rel_err {rel:.5f} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"paged_chunk_write_fused {kind} disagrees with its plain "
                                 "version")
        del wa, ws
        n = vals.numel()
        nbytes = 2 * n + n + (n // HS) * 4 + 4 * nbb + 4 + nc * 2 * 4
        rec = timed(
            "paged_chunk_write_fused", f" {kind} ({nc} blocks)",
            lambda: cudaex.paged_chunk_write_fused(arena, scale, vals, dest_d, pos_d,
                                                   block_size=BS),
            lambda: cudaex.paged_chunk_write_fused_plain(arena, scale, vals, dest_d, pos_d,
                                                         block_size=BS),
            None, None, bound(nbytes, 0, torch.bfloat16), iters=100, plain_iters=20)
        rec["max_abs_err"] = sums_rel
        result[kind] = rec
        del arena, scale, vals
    return result


#
# phase 3, continued: the adapter delta of LoRA serving and the training
# step's cross-entropy
#

# the per-request delta at the serving shapes: decode (B=8, T=1), verify
# (B=8, T=5) and a prefill chunk (B=1, T=512); wq (4096 -> 4096), wk (4096 ->
# 1024) and wo (4096 -> 4096) of Llama-3-8B
LORA_SHAPES = {"decode": (8, 1), "verify": (8, 5), "chunk": (1, 512)}
LORA_TARGETS = {"wq": (NH * HS, NH * HS), "wk": (NH * HS, NG * HS), "wo": (NH * HS, NH * HS)}
LORA_RANKS = (8, 16, 64, 128)       # 128: two of the kernel's 64-rank chunks
LORA_SCALING = 2.0                      # alpha 32 over rank 16, the serves' registry
# float32 delta: the same products summed in another order, within this
# share of the output's largest magnitude
LORA_REL_F32 = 1e-5


def lora_bound(B_, T, fin, fout, r, x_dtype, f_dtype):
    xb = torch.empty((), dtype=x_dtype).element_size()
    fb = torch.empty((), dtype=f_dtype).element_size()
    nbytes = B_ * T * fin * xb + B_ * r * (fin + fout) * fb + B_ * T * fout * xb
    return bound(nbytes, 2 * B_ * T * r * (fin + fout), x_dtype)


def lora_inputs(gen, B_, T, fin, fout, r, x_dtype, f_dtype):
    """Unit activations, factors of std 0.05 (the serves' adapters); rows 2
    and 6 of a batch of 8 ride the base slot (zero factors)."""
    x = torch.randn((B_, T, fin), generator=gen, device=DEVICE).to(x_dtype)
    a = (0.05 * torch.randn((B_, r, fin), generator=gen, device=DEVICE)).to(f_dtype)
    b = (0.05 * torch.randn((B_, fout, r), generator=gen, device=DEVICE)).to(f_dtype)
    base = [2, 6] if B_ == 8 else []
    a[base], b[base] = 0, 0
    return x, a, b, base


def check_lora():
    """``lora_delta_fused`` against its plain version at every shape,
    target and rank above, x in bf16 and float32, factors in float32 and
    bf16: float32 x within LORA_REL_F32 of the output's max magnitude; bf16
    x against the float32 plain result of the same inputs, the kernel's
    error at most LOWP_ERR_RATIO times the plain version's own; base-slot
    rows exactly 0.  Then times at each shape (wq, rank 16, bf16 x, float32
    factors: what the bf16 serves run)."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 15)
    worst = {}
    main_err = None
    for shape, (B_, T) in LORA_SHAPES.items():
        for target, (fin, fout) in LORA_TARGETS.items():
            for r in LORA_RANKS:
                for x_dtype in (torch.bfloat16, torch.float32):
                    for f_dtype in (torch.float32, torch.bfloat16):
                        x, a, b, base = lora_inputs(gen, B_, T, fin, fout, r, x_dtype, f_dtype)
                        got = cudaex.lora_delta_fused(x, a, b, LORA_SCALING)
                        torch.cuda.synchronize()
                        want = cudaex.lora_delta_fused_plain(x, a, b, LORA_SCALING)
                        err = (got.float() - want.float()).abs().max().item()
                        zero = all(bool((got[i] == 0).all()) for i in base)
                        if x_dtype == torch.float32:
                            lim = LORA_REL_F32 * want.abs().max().item()
                            ok, bar = err <= lim, f"atol {lim:.2e}"
                        else:
                            ref = cudaex.lora_delta_fused_plain(x.float(), a.float(), b.float(),
                                                                LORA_SCALING)
                            ek = (got.float() - ref).abs().max().item()
                            ep = (want.float() - ref).abs().max().item()
                            ok = ek <= LOWP_ERR_RATIO * ep
                            bar = f"against float32: kernel {ek:.3e}, plain {ep:.3e}"
                        ok = ok and zero and bool(torch.isfinite(got).all())
                        label = (f"{shape} {target} r={r} x {str(x_dtype)[6:]} factors "
                                 f"{str(f_dtype)[6:]}")
                        key = str(x_dtype)[6:]
                        worst[key] = max(worst.get(key, 0.0), err)
                        if (shape, target, r, x_dtype, f_dtype) == (
                                "decode", "wq", 16, torch.bfloat16, torch.float32):
                            main_err = err
                        if not ok:
                            say(f"lora_delta_fused {label}: max_abs_err={err:.3e} ({bar}); "
                                f"base rows zero {zero} FAIL")
                            raise AssertionError(f"lora_delta_fused {label} disagrees with its "
                                                 "plain version")
    n = len(LORA_SHAPES) * len(LORA_TARGETS) * len(LORA_RANKS) * 4
    say(f"lora_delta_fused: {n} cases (shapes {LORA_SHAPES}, targets {LORA_TARGETS}, ranks "
        f"{LORA_RANKS}, x bf16/float32, factors float32/bf16) ok; worst max_abs_err {worst}; "
        f"base-slot rows exactly 0")
    shapes = {}
    for shape, (B_, T) in LORA_SHAPES.items():
        fin, fout = LORA_TARGETS["wq"]
        x, a, b, _ = lora_inputs(gen, B_, T, fin, fout, 16, torch.bfloat16, torch.float32)
        shapes[shape] = timed(
            "lora_delta_fused", f" {shape} wq r=16 (B={B_}, T={T})",
            lambda: cudaex.lora_delta_fused(x, a, b, LORA_SCALING),
            lambda: cudaex.lora_delta_fused_plain(x, a, b, LORA_SCALING),
            None, None, lora_bound(B_, T, fin, fout, 16, torch.bfloat16, torch.float32),
            iters=200, plain_iters=50, device_kernel="lora_delta_kernel")
    B_, T = LORA_SHAPES["decode"]
    x, a, b, _ = lora_inputs(gen, B_, T, fin, fout, 128, torch.bfloat16, torch.float32)
    shapes["decode r=128"] = timed(
        "lora_delta_fused", f" decode wq r=128 (B={B_}, T={T})",
        lambda: cudaex.lora_delta_fused(x, a, b, LORA_SCALING),
        lambda: cudaex.lora_delta_fused_plain(x, a, b, LORA_SCALING),
        None, None, lora_bound(B_, T, fin, fout, 128, torch.bfloat16, torch.float32),
        iters=200, plain_iters=50, device_kernel="lora_delta_kernel")
    rec = dict(shapes["decode"], max_abs_err=main_err, shapes=shapes)
    return rec


CE_N, CE_V = 2048, 128256               # Llama-3-8B's training step: B=1, T=2048
# float32 row losses: a sum of exp over 128256 logits in another order,
# within this share of the largest loss (both paths upcast bf16 logits
# exactly and compute in float32, so bf16 takes the same bar)
CE_REL = 1e-5
# a shape the TPU kernel's tiling refuses (no row block divides N, no ×128
# tile divides V, GPT-2's vocabulary): the kernel takes it on its scalar walk
CE_ODD_N, CE_ODD_V = 2047, 50257


def check_ce():
    """``flash_cross_entropy`` against its plain version at (2048, 128256),
    float32 and bf16 logits, random targets: loss and lse within CE_REL of
    their largest magnitude; then times beside ``F.cross_entropy``
    (reduction "none": the losses only, no lse) and the bound."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 16)
    rec = {}
    for dtype in (torch.float32, torch.bfloat16):
        logits = torch.randn((CE_N, CE_V), generator=gen, device=DEVICE).to(dtype)
        target = torch.randint(0, CE_V, (CE_N,), generator=gen, device=DEVICE)
        loss, lse = cudaex.flash_cross_entropy(logits, target)
        torch.cuda.synchronize()
        want_loss, want_lse = cudaex.flash_cross_entropy_plain(logits, target)
        err = (loss - want_loss).abs().max().item()
        err_lse = (lse - want_lse).abs().max().item()
        lim = CE_REL * want_loss.abs().max().item()
        ok = (err <= lim and err_lse <= CE_REL * want_lse.abs().max().item()
              and bool(torch.isfinite(loss).all()))
        name = str(dtype)[6:]
        say(f"flash_ce {name} ({CE_N}, {CE_V}): loss max_abs_err={err:.3e}, lse "
            f"max_abs_err={err_lse:.3e} (bar {lim:.2e}; lse mean {want_lse.mean().item():.4f}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"flash_ce {name} disagrees with its plain version")
        esize = logits.element_size()
        nbytes = CE_N * CE_V * esize + CE_N * target.element_size() + 2 * CE_N * 4
        rec[name] = dict(timed(
            "flash_ce", f" ({CE_N}, {CE_V})", lambda: cudaex.flash_cross_entropy(logits, target),
            lambda: cudaex.flash_cross_entropy_plain(logits, target),
            lambda: F.cross_entropy(logits, target, reduction="none"),
            "F.cross_entropy (reduction none, losses only)",
            bound(nbytes, 4 * CE_N * CE_V, torch.float32), iters=20, plain_iters=5,
            device_kernel="flash_ce_kernel", dtype_name=name), max_abs_err=err)
        del logits, loss, lse, want_loss, want_lse
    for dtype in (torch.float32, torch.bfloat16):
        logits = torch.randn((CE_ODD_N, CE_ODD_V), generator=gen, device=DEVICE).to(dtype)
        target = torch.randint(0, CE_ODD_V, (CE_ODD_N,), generator=gen, device=DEVICE)
        loss, lse = cudaex.flash_cross_entropy(logits, target)
        want_loss, want_lse = cudaex.flash_cross_entropy_plain(logits, target)
        err = (loss - want_loss).abs().max().item()
        err_lse = (lse - want_lse).abs().max().item()
        ok = (err <= CE_REL * want_loss.abs().max().item()
              and err_lse <= CE_REL * want_lse.abs().max().item())
        say(f"flash_ce {str(dtype)[6:]} ({CE_ODD_N}, {CE_ODD_V}), scalar walk: loss "
            f"max_abs_err={err:.3e}, lse max_abs_err={err_lse:.3e} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"flash_ce disagrees with its plain version at "
                                 f"({CE_ODD_N}, {CE_ODD_V})")
    torch.cuda.empty_cache()
    return dict(rec["float32"], dtypes=rec,
                library="F.cross_entropy(logits, target, reduction='none'): the row losses "
                        "only (no lse)")


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


def compare_logits(eng, params, cfg, prompts, results, tables, slots=None):
    """One decode step at the served rows' last positions (their blocks
    still hold the K/V the run wrote), through the kernels and through the
    dense path over the same gathered cache, in bf16 and in float32.  A
    quantized pool keeps its bytes and scales in both: the kernels
    dequantize them in-kernel, the dense path through ``gather_dense_q``,
    each into the compute dtype of the run.  ``slots``: the rows' adapter
    slots in a LoRA engine; the kernel path then adds the deltas through
    ``lora_delta_fused``, the dense path through the plain delta."""
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

    quantized = eng.pool.quantized_kv
    reg = eng._registry
    lora = ({} if slots is None else
            {"lora": gather_adapter_slots(reg.arenas, torch.as_tensor(slots, device=dev)),
             "lora_scaling": reg.scaling})

    def both_paths(p, arenas, cdtype):
        lp, _ = forward_paged(p, toks_d, pos_d, arenas, tab_d, cos, sin, cfg, cdtype=cdtype,
                              **lora)
        if quantized:
            kd, vd = gather_dense_q(arenas["k"], arenas["v"], arenas["k_scale"],
                                    arenas["v_scale"], tab_d, cdtype)
        else:
            kd, vd = gather_dense(arenas["k"], arenas["v"], tab_d)
        lg, _ = forward_with_cache(p, toks_d, pos_d, {"k": kd, "v": vd}, cos, sin, cfg, **lora)
        return lp, lg

    with torch.no_grad():
        lp, lg = both_paths(params, eng.pool.arenas, torch.bfloat16)
        arenas32 = eng.pool.arenas if quantized else _cast(eng.pool.arenas, torch.float32)
        lp32, lg32 = both_paths(_cast(params, torch.float32), arenas32, torch.float32)
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
    say(f"decode logits{' off ' + str(eng.pool.kv_dtype)[6:] + ' arenas' if quantized else ''}"
        f"{', LoRA slots ' + str(slots) if slots is not None else ''}, "
        f"kernels vs dense path ({Bb} rows, nbb={nbb}, logits std "
        f"{lg32.std().item():.3f}): float32 max_abs_err={err32:.3e} (atol {LOGITS_ATOL_F32}); "
        f"bf16 max_abs_err={err:.4f}, against float32 dense: kernel path {err_kernel:.4f}, "
        f"dense path {err_dense:.4f} (ratio limit {BF16_ERR_RATIO}); bf16 argmax agree "
        f"{agree}/{Bb}; kernel path re-derives the served last token {replay}/{Bb} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("forward_paged disagrees with forward_with_cache")
    return dict(f32_max_abs_err=err32, bf16_kernel_err=err_kernel, bf16_dense_err=err_dense)


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


def quant_gauge() -> float | None:
    return registry().gauge("serving.kv_quant.rel_err").value


def check_gauge(name, kv_dtype) -> float | None:
    """A quantized serve's ``serving.kv_quant.rel_err`` gauge: finite and in
    (0, 0.05) (plausibly near 1e-2 for int8, 3e-2 for fp8)."""
    gauge = quant_gauge()
    say(f"{name}: serving.kv_quant.rel_err gauge {gauge} (kv_dtype {kv_dtype})")
    if kv_dtype is not None and not (gauge is not None and math.isfinite(gauge)
                                     and 0.0 < gauge < 0.05):
        raise AssertionError(f"{name}: rel_err gauge {gauge} outside (0, 0.05)")
    return gauge


def submit_all(eng, prompts, new_tokens, lora):
    """Submits every prompt; with a registry, two requests per adapter and
    two base ones (``LORA_IDS``)."""
    ids = LORA_IDS if lora is not None else [None] * len(prompts)
    return [eng.submit(p, max_new_tokens=new_tokens, adapter_id=a) for p, a in zip(prompts, ids)]


def lora_launches(cfg, lora, calls: int) -> dict:
    """The expected ``lora_delta_fused`` launches: wq, wk, wv, wo in every
    layer of every kernel-path call (decode step, chunk piece, verify
    round) of a LoRA engine."""
    return {"lora_delta_fused": 4 * cfg.n_layer * calls} if lora is not None else {}


def tenant_report(name, lora):
    if lora is None:
        return None
    snap = registry().snapshot("serving.tenant.")
    tenants = {a: {"tokens": snap[f"serving.tenant.{a}.tokens"],
                   "requests": snap[f"serving.tenant.{a}.requests"],
                   "ttft_p50_ms": 1e3 * snap[f"serving.tenant.{a}.ttft_s"]["p50"],
                   "e2e_p50_ms": 1e3 * snap[f"serving.tenant.{a}.e2e_s"]["p50"]}
               for a in LORA_ADAPTERS}
    say(f"{name}: tenant counters {tenants}")
    if any(t["requests"] != 2 for t in tenants.values()) or any(
            k.startswith("serving.tenant.None") for k in snap):
        raise AssertionError(f"{name}: tenant counters {snap}")
    return tenants


def chunked_serve(params, cfg, n_requests=8, new_tokens=32, kv_dtype=None, num_blocks=2048,
                  lora=None):
    eng = serve(None, params, cfg, attn="paged", block_size=16, num_blocks=num_blocks,
                max_batch=8, prefill_chunk=CHUNK, prefill_buckets=CHUNK_BUCKETS,
                kv_dtype=kv_dtype, lora=lora, device=DEVICE)
    kind = eng.stats()["attn"]["kinds"]["prefill_chunk"]
    say(f"chunked serve (kv_dtype {kv_dtype}): chunk kind {kind['mode']!r} (fallback reason "
        f"{kind['fallback_reason']}), {eng.pool.num_blocks} blocks of "
        f"{eng.pool.block_bytes()} B, arena {eng.pool.arena_bytes()} B = "
        f"{eng.pool.arena_bytes() / 2**30:.3f} GiB")
    if kind["mode"] != "paged":
        raise AssertionError(f"the chunk kind resolved {kind['mode']!r}, not 'paged'")
    rng = np.random.default_rng(SEED + 5)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in rng.integers(1024, 3073, n_requests)]
    eng.run([prompts[0][:600]], max_new_tokens=2)            # warm-up: one chunk + final piece
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    registry().reset()
    steps0, chunks0 = eng.decode_steps, eng.chunk_runs
    cudaex.reset_launches()
    t0 = time.perf_counter()
    handles = submit_all(eng, prompts, new_tokens, lora)
    eng.step()                                              # admits every request
    tables = [list(h._req.block_table) for h in handles]
    eng.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cudaex.LAUNCHES)
    steps, pieces = eng.decode_steps - steps0, eng.chunk_runs - chunks0
    results = [h.result(drive=False) for h in handles]
    check_results(results, new_tokens, cfg.padded_vocab_size)
    tag = f", LoRA rank {lora.rank} ids {LORA_IDS}" if lora is not None else ""
    rec = serve_stats(f"chunked serve {cfg.name} bf16, kv_dtype {kv_dtype}{tag} (prompts "
                      f"{sorted(len(p) for p in prompts)}, prefill_chunk {CHUNK})", results, wall)
    q = "_fused" if kv_dtype is not None else ""
    want = no_launches_but(paged_attn_verify=pieces * cfg.n_layer,
                           paged_attn_decode=steps * cfg.n_layer,
                           **{f"paged_chunk_write{q}": pieces * 2,
                              f"paged_token_write{q}": steps * 2},
                           **lora_launches(cfg, lora, pieces + steps))
    say(f"launches during chunked serve: {launches} ({pieces} intermediate pieces, "
        f"{steps} decode steps; expected {want})")
    if launches != want or not pieces:
        raise AssertionError(f"chunked serve launch counts {launches} != {want} "
                             f"({pieces} intermediate pieces)")
    rec.update(launches=launches, pieces=pieces, steps=steps, blocks=eng.pool.num_blocks,
               arena_bytes=eng.pool.arena_bytes(),
               rel_err=check_gauge("chunked serve", kv_dtype),
               tenants=tenant_report("chunked LoRA serve", lora))
    return rec, eng, prompts, tables, results


LORA_RANK, LORA_ALPHA = 16, 32         # scaling 2.0
LORA_ADAPTERS = ("tenant-a", "tenant-b", "tenant-c")
LORA_IDS = [*LORA_ADAPTERS, None] * 2   # two requests per adapter, two base


def make_registry(cfg):
    """Rank 16, alpha 32, the default targets wq/wk/wv/wo, four slots,
    three adapters of std 0.05 from a seeded generator, float32 factors."""
    reg = AdapterRegistry(cfg, rank=LORA_RANK, alpha=LORA_ALPHA, max_adapters=4, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 17)
    for name in LORA_ADAPTERS:
        reg.register(name, make_lora_factors(cfg, LORA_RANK, gen, std=0.05))
    return reg


def layer_skip_draft(params, cfg, n_layer=2):
    """The target's own embedding, first ``n_layer`` blocks, final norm and
    head: a draft made from the target's weights, sharing its tensors."""
    return {**params, "blocks": params["blocks"][:n_layer]}, Config.from_name(cfg.name,
                                                                               n_layer=n_layer)


def spec_serve(params, cfg, K=4, n_requests=8, new_tokens=32, kv_dtype=None, self_draft=True,
               lora=None):
    dparams, dcfg = layer_skip_draft(params, cfg)
    eng = serve(None, params, cfg, attn="paged", block_size=16, num_blocks=1024, max_batch=8,
                speculative=SpecConfig(dparams, dcfg, K=K), kv_dtype=kv_dtype, lora=lora,
                device=DEVICE)
    rng = np.random.default_rng(SEED + 6)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in rng.integers(128, 1025, n_requests)]
    eng.run([prompts[0][:64]], max_new_tokens=8)             # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    registry().reset()
    rounds0 = eng.spec_rounds
    cudaex.reset_launches()
    t0 = time.perf_counter()
    handles = submit_all(eng, prompts, new_tokens, lora)
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
    tag = f", LoRA rank {lora.rank} on the target, ids {LORA_IDS}" if lora is not None else ""
    rec = serve_stats(f"speculative serve {cfg.name} bf16, kv_dtype {kv_dtype} (draft arena "
                      f"{eng.draft_pool.kv_dtype}), {dcfg.n_layer}-layer draft, K={K}{tag} "
                      f"(prompts {sorted(len(p) for p in prompts)})", results, wall)
    say(f"speculative serve: {rounds} rounds, acceptance rate {st['acceptance_rate']:.4f}, "
        f"tokens per round {st['tokens_per_round']:.3f}, accept_len histogram "
        f"{st['accept_len_hist']} (warm-up included)")
    write = "paged_token_write_fused" if kv_dtype is not None else "paged_token_write_masked"
    want = no_launches_but(paged_attn_verify=rounds * cfg.n_layer,
                           **{write: rounds * 2 * (K + 1)}, **lora_launches(cfg, lora, rounds))
    say(f"launches during speculative serve: {launches} (expected {want}); pool "
        f"{eng.pool.num_blocks} blocks, arena {eng.pool.arena_bytes()} B")
    if launches != want or not rounds:
        raise AssertionError(f"speculative serve launch counts {launches} != {want} "
                             f"({rounds} rounds)")
    rec.update(launches=launches, rounds=rounds, acceptance_rate=st["acceptance_rate"],
               tokens_per_round=st["tokens_per_round"], blocks=eng.pool.num_blocks,
               arena_bytes=eng.pool.arena_bytes(),
               rel_err=check_gauge("speculative serve", kv_dtype),
               tenants=tenant_report("speculative LoRA serve", lora))
    if not self_draft:
        return rec, eng, prompts, results, tables
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


def _exact_tokens_tiny(n_new=8):
    """tiny-llama-debug at its own head size (16): the default attn resolves
    paged on the card, every decode step goes through the kernels, and the
    float32 tokens equal the gather path's."""
    cfg = Config.from_name("tiny-llama-debug")
    params = init_params(cfg, generator=torch.Generator(DEVICE).manual_seed(SEED + 11),
                         dtype=torch.float32, device=DEVICE)
    rng = np.random.default_rng(SEED + 11)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (3, 17, 30, 61)]
    common = dict(block_size=16, num_blocks=64, max_batch=4, device=DEVICE)
    eng = serve(None, params, cfg, **common)
    cudaex.reset_launches()
    paged = [r.new_tokens for r in eng.run(prompts, max_new_tokens=n_new)]
    torch.cuda.synchronize()
    launches = cudaex.LAUNCHES["paged_attn_decode"]
    gather = [r.new_tokens for r in serve(None, params, cfg, attn="gather", **common).run(
        prompts, max_new_tokens=n_new)]
    ok = eng.attn == "paged" and launches == eng.decode_steps * cfg.n_layer > 0 and paged == gather
    say(f"float32, tiny-llama-debug (hs {cfg.head_size}): default attn {eng.attn!r}, "
        f"paged_attn_decode launches {launches} ({eng.decode_steps} decode steps x "
        f"{cfg.n_layer} layers); tokens equal gather: {paged == gather} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("tiny-llama-debug does not serve paged through the kernels with "
                             "the gather path's tokens")


def _exact_tokens_quant(params32, cfg4, n_new=8):
    """Tokens, exact, in float32 at Llama-3-8B widths and 4 layers on an
    int8 pool: the paged lanes (kernels) serve the gather lanes' tokens,
    unchunked and chunked.  Chunked against unchunked is reported, not
    held: a chunked prefill reads its earlier pieces back through the int8
    arena while an unchunked one attends them at full precision (the
    reference's chunk programs gather through ``gather_dense_q`` too), so
    the two are different computations that agree to the quantization
    error, and a near tie of two logits may flip."""
    rng = np.random.default_rng(SEED + 8)
    long = [rng.integers(0, cfg4.vocab_size, n).astype(np.int32) for n in (1100, 1600)]
    common = dict(block_size=16, num_blocks=512, max_batch=4, kv_dtype="int8", device=DEVICE)
    unchunked = dict(prefill_buckets=tuple(16 * 2 ** i for i in range(8)))
    chunked = dict(prefill_chunk=CHUNK, prefill_buckets=CHUNK_BUCKETS)

    def tokens(**kw):
        eng = serve(None, params32, cfg4, **common, **kw)
        return [r.new_tokens for r in eng.run(long, max_new_tokens=n_new)]

    got = {(attn, name): tokens(attn=attn, **kw) for attn in ("paged", "gather")
           for name, kw in (("unchunked", unchunked), ("chunked", chunked))}
    same = {name: got["paged", name] == got["gather", name] for name in ("unchunked", "chunked")}
    rows = sum(a == b for a, b in zip(got["paged", "chunked"], got["paged", "unchunked"]))
    say(f"float32, 4 layers, int8 KV: paged = gather unchunked {same['unchunked']}, chunked "
        f"{same['chunked']}; chunked = unchunked on {rows} of {len(long)} rows (reported, not "
        f"held: the chunked prefill reads its earlier pieces through the int8 arena); "
        f"tokens {got}")
    if not all(same.values()):
        raise AssertionError(f"the int8 paged lanes serve other tokens than the gather lanes: "
                             f"{got}")


def _exact_tokens_lora(params32, cfg4, n_new=8):
    """LoRA tokens, exact, in float32 at Llama-3-8B widths and 4 layers:
    paged (the kernel) = gather (the plain delta); each request alone =
    mixed; every adapter changes the tokens of its prompt; a base request
    in a LoRA engine = a registry-free engine's; and two adapters with a
    shared 2-block prompt prefix each serve their solo tokens (no K/V
    shared across adapters), while a third request of the first adapter
    shares the prefix and serves its solo tokens too."""
    reg = make_registry(cfg4)
    rng = np.random.default_rng(SEED + 12)
    prompts = [rng.integers(0, cfg4.vocab_size, n).astype(np.int32) for n in (90, 200, 333, 411)]
    ids = [*LORA_ADAPTERS, None]
    common = dict(block_size=16, num_blocks=512, max_batch=4, device=DEVICE)

    def tokens(ps, ids_, lora=reg, attn="paged"):
        eng = serve(None, params32, cfg4, attn=attn, lora=lora, **common)
        hs = [eng.submit(p, max_new_tokens=n_new, adapter_id=a) for p, a in zip(ps, ids_)]
        eng.drain()
        return [h.result(drive=False).new_tokens for h in hs]

    cudaex.reset_launches()
    mixed = tokens(prompts, ids)
    kernel_launches = cudaex.LAUNCHES["lora_delta_fused"]
    gather = tokens(prompts, ids, attn="gather")
    solo = [tokens([p], [a])[0] for p, a in zip(prompts, ids)]
    base = tokens(prompts, [None] * 4)
    plain = tokens(prompts[3:], [None], lora=None)
    differ = [mixed[i] != base[i] for i in range(3)]
    say(f"float32, 4 layers, LoRA (rank {LORA_RANK}, scaling {reg.scaling}): paged = gather "
        f"{mixed == gather}; alone = mixed {solo == mixed}; adapters change their tokens "
        f"{differ}; base in a LoRA engine = registry-free {base[3] == plain[0] == mixed[3]} "
        f"(paged lora_delta_fused launches {kernel_launches}); tokens {mixed}")
    if not (mixed == gather and solo == mixed and all(differ) and base[3] == plain[0] == mixed[3]
            and kernel_launches > 0):
        raise AssertionError("LoRA float32 tokens: an equality failed")
    prefix = rng.integers(0, cfg4.vocab_size, 32).astype(np.int32)
    tails = [rng.integers(0, cfg4.vocab_size, n).astype(np.int32) for n in (40, 57, 23)]
    shared = [np.concatenate([prefix, t]) for t in tails]
    sids = [LORA_ADAPTERS[0], LORA_ADAPTERS[1], LORA_ADAPTERS[0]]
    eng = serve(None, params32, cfg4, attn="paged", lora=reg, **common)
    hs = []
    for p, a in zip(shared, sids):
        hs.append(eng.submit(p, max_new_tokens=n_new, adapter_id=a))
        eng.step()                                        # admit: the prefix registers
    eng.drain()
    got = [h.result(drive=False) for h in hs]
    want = [tokens([p], [a])[0] for p, a in zip(shared, sids)]
    blocks = [r.shared_prefix_blocks for r in got]
    ok = [r.new_tokens for r in got] == want and blocks == [0, 0, 2]
    say(f"float32, 4 layers, LoRA shared 2-block prefix: adapters {sids}, shared blocks "
        f"{blocks} (expected [0, 0, 2]), each = its solo run "
        f"{[r.new_tokens for r in got] == want} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("LoRA prefix sharing: a request differs from its solo run or "
                             "shared across adapters")


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
    body = cudaex.flash_body("fwd", q.shape[-1], q.dtype, (q, k, v))[0]
    say(f"flash {label} {str(q.dtype)[6:]} ({body} body): max_abs_err vs plain "
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
    backward kernel) at the training shape, beside the bounds.  The device
    times count the kernels of the body the wrappers pick (the dk/dv time
    includes the fixed-order sum of its split partials)."""
    out, lse = cudaex.flash_sdpa(q, k, v, **kw)
    delta = (g.float() * out.float()).sum(dim=-1)
    mask3, ints = cudaex._flash_args(q, k, None, kw["causal"], kw["window"])
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    body = cudaex.flash_body("fwd", q.shape[-1], q.dtype, (q, k, v))[0]
    tag = "_wg" if body == "wgmma" else ""

    def dq_kernel():       # the dq launch alone, as flash_sdpa_backward makes it
        cudaex._flash_bwd_dq(g, q, k, v, lse, delta, mask3, ints, kw["scale"], dq)

    def dkv_kernel():
        cudaex._flash_bwd_dkv(g, q, k, v, lse, delta, mask3, ints, kw["scale"], dk, dv)

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
                           plain_warmup=1, device_kernel=f"flash_fwd{tag}_kernel"),
        "flash_bwd_dq": timed("flash_bwd_dq", "", dq_kernel,
                              lambda: cudaex.flash_sdpa_backward_plain(g, q, k, v, out, lse, **kw),
                              lib_bwd, "SDPA backward (dq, dk, dv)", bounds["flash_bwd_dq"],
                              iters=20, plain_iters=3, plain_warmup=1,
                              device_kernel=f"flash_bwd_dq{tag}_kernel"),
        "flash_bwd_dkv": timed("flash_bwd_dkv", "", dkv_kernel,
                               lambda: cudaex.flash_sdpa_backward_plain(g, q, k, v, out, lse,
                                                                        **kw),
                               lib_bwd, "SDPA backward (dq, dk, dv)", bounds["flash_bwd_dkv"],
                               iters=20, plain_iters=3, plain_warmup=1,
                               device_kernel=f"flash_bwd_dkv{tag}_kernel",
                               device_also=("flash_dkv_sum_kernel",)),
    }
    for name in rec:
        rec[name]["body"] = body
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
def plain_kernels():
    """The attention and cross-entropy functions call the kernels' plain
    versions."""
    saved, saved_ce = dict(ltorch.FLASH), dict(ltorch.CE)
    ltorch.FLASH.update(forward=cudaex.flash_sdpa_plain,
                        backward=cudaex.flash_sdpa_backward_plain)
    ltorch.CE.update(forward=cudaex.flash_cross_entropy_plain)
    try:
        yield
    finally:
        ltorch.FLASH.update(saved)
        ltorch.CE.update(saved_ce)


def train_correctness(params, cfg):
    """One step's loss and grads at Llama-3-8B widths and 4 layers, through
    the kernels (flash attention and the fused cross-entropy) and through
    their plain versions: float32 (TF32 off) within
    TRAIN_LOSS_REL / TRAIN_GRAD_REL; bf16 held against the float32 kernel
    step, the kernel path's error at most LOWP_ERR_RATIO times the plain
    path's own (loss, and the relative L2 error of all grads)."""
    cfg4 = Config.from_name(cfg.name, n_layer=4)
    batch = train_batch(cfg4, SEED + 9)
    step = make_step(cfg4)
    p16 = {**params, "blocks": params["blocks"][:4]}
    p32 = _cast(p16, torch.float32)
    cudaex.reset_launches()
    loss_k, g_k = step.grads(p32, None, *batch)
    if cudaex.LAUNCHES["flash_ce"] != 1:
        raise AssertionError(f"the float32 step launched flash_ce {cudaex.LAUNCHES['flash_ce']} "
                             "times, not once")
    with plain_kernels():
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
    with plain_kernels():
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
    declines, finite losses, the last below the first; then two more steps
    under the profiler (``compare_train_profiles``)."""
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
                           flash_bwd_dkv=L * TRAIN_STEPS, flash_ce=TRAIN_STEPS)
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
    profiles = compare_train_profiles(step, params, opt_state, batch)
    return dict(launches=launches, losses=losses, step_ms=1e3 * step_s, peak_gib=peak / 2**30,
                profiles=profiles)


FLASH_GROUPS = ("flash fwd", "flash dq", "flash dk/dv")


def _kernel_group(name: str) -> str:
    low = name.lower()
    return ("flash fwd" if "flash_fwd" in low
            else "flash dq" if "flash_bwd_dq" in low
            else "flash dk/dv" if "flash_bwd_dkv" in low or "flash_dkv_sum" in low
            else "flash ce" if "flash_ce_kernel" in low
            else "cuBLAS GEMMs" if any(s in low for s in ("gemm", "gemv", "cutlass", "xmma",
                                                          "nvjet"))
            else "optimizer" if "adam" in low
            else "the rest")


def profile_train_step(step, params, opt_state, batch, label):
    """Device time of one more train step by kernel group, from the
    profiler's CUDA activity, the card's idle share of its kernel span, and
    the flash kernels' names; None when the profiler sees no CUDA
    activity."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        step(params, opt_state, *batch)[2].item()
        torch.cuda.synchronize()
    spans = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    if not spans:
        say(f"train step profile ({label}): not measured (the profiler saw no CUDA activity)")
        return None
    busy = sum(end - start for _, start, end in spans)
    window = max(end for *_, end in spans) - min(start for _, start, _ in spans)
    groups: dict[str, float] = {}
    names = set()
    for name, start, end in spans:
        key = _kernel_group(name)
        groups[key] = groups.get(key, 0.0) + (end - start)
        found = re.search(r"flash_\w+", name)
        if key in FLASH_GROUPS and found:
            names.add(found.group(0))
    groups = {k: v / 1e3 for k, v in groups.items()}
    say(f"train step profile ({label}): device busy {busy / 1e3:.3f} ms over a "
        f"{window / 1e3:.3f} ms kernel span (idle share {1 - busy / window:.4f}); device ms by "
        f"group: { {k: round(v, 3) for k, v in sorted(groups.items(), key=lambda kv: -kv[1])} }"
        f"; flash kernels: {sorted(names)}")
    return dict(busy_ms=busy / 1e3, span_ms=window / 1e3, groups=groups, names=sorted(names))


@contextlib.contextmanager
def wmma_flash_body():
    """The flash wrappers take the WMMA body (the earlier tensor-core body)
    where they would take the warpgroup body: the same run's yardstick for
    the redesign."""
    pick = cudaex.flash_body

    def wmma(kind, hs, dtype, tensors=()):
        body, R, KT = pick(kind, hs, dtype, tensors)
        if body != "wgmma":
            return body, R, KT
        R, KT = next(rk for rk in cudaex._FLASH_TILES
                     if cudaex._flash_smem(kind, *rk, hs, 2, "wmma") <= cudaex._MAX_SMEM_BYTES)
        return "wmma", R, KT

    cudaex.flash_body = wmma
    try:
        yield
    finally:
        cudaex.flash_body = pick


# the step's device time must fall by at least this share of the flash
# kernels' own saving, both read from profiles of two steps in one run
TRAIN_FALL_SHARE = 0.9


def compare_train_profiles(step, params, opt_state, batch):
    """One profiled step on the kernels the wrappers pick, one on the WMMA
    body: the flash groups' saving and the step's device-time fall."""
    new = profile_train_step(step, params, opt_state, batch, "redesigned flash body")
    with wmma_flash_body():
        old = profile_train_step(step, params, opt_state, batch, "WMMA flash body")
    if new is None or old is None:
        return None
    want = {"flash_fwd_wg_kernel", "flash_bwd_dq_wg_kernel", "flash_bwd_dkv_wg_kernel",
            "flash_dkv_sum_kernel"}
    if set(new["names"]) != want:
        raise AssertionError(f"the train step ran flash kernels {new['names']}, not the "
                             f"warpgroup body's {sorted(want)}")
    saving = sum(old["groups"].get(g, 0.0) - new["groups"].get(g, 0.0) for g in FLASH_GROUPS)
    fall = old["busy_ms"] - new["busy_ms"]
    ok = fall >= TRAIN_FALL_SHARE * saving
    say(f"train step device time: {old['busy_ms']:.3f} ms on the WMMA body, {new['busy_ms']:.3f} "
        f"ms redesigned: fell {fall:.3f} ms against the flash groups' saving {saving:.3f} ms "
        f"(at least {TRAIN_FALL_SHARE} of it) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the train step's device time fell by less than the flash kernels' "
                             "saving")
    return dict(redesigned=new, wmma=old, flash_saving_ms=saving, step_fall_ms=fall)


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
    # quantized arenas: the dequantizing attention bodies (extra rows of
    # their kernels' entries) and the two fused writes (the token write's
    # entry is its int8 form, which the chunked int8 serve's decode steps
    # run; fp8 rides beside it)
    check_head_sizes()
    recs["paged_attn_decode"]["quantized"] = check_decode_quant()
    recs["paged_attn_verify"]["quantized"] = check_verify_quant()
    tw = check_token_write_fused()
    recs["paged_token_write_fused"] = {**tw["int8"], "quantized": tw}
    cw = check_chunk_write_fused()
    recs["paged_chunk_write_fused"] = {**cw["int8"], "quantized": cw}
    recs["flash_ce"] = check_ce()
    recs["lora_delta_fused"] = check_lora()
    torch.cuda.empty_cache()
    torch.cuda.empty_cache()
    params, cfg = make_params()
    served = {"decode serve": serve_full_width(params, cfg)}
    crec, eng, prompts, tables, _ = chunked_serve(params, cfg)
    served["chunked serve"] = crec["launches"]
    chunk_case = (_compact(eng.pool.arenas, [tables[0]]), prompts[0])
    bf16_pool_bytes = eng.pool.arena_bytes()
    del eng
    torch.cuda.empty_cache()
    srec, eng, prompts, results, tables = spec_serve(params, cfg)
    served["speculative serve"] = srec["launches"]
    spec_case = (_compact(eng.pool.arenas, tables), prompts, results)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    # quantized serves: chunked int8 on a pool of the bf16 chunked pool's
    # bytes, speculative fp8 with the draft inheriting fp8
    nb_int8 = blocks_for_arena_bytes(cfg, 16, bf16_pool_bytes, torch.bfloat16, kv_dtype="int8")
    say(f"equal-bytes int8 pool: {bf16_pool_bytes} B buys {nb_int8} int8 blocks of "
        f"{arena_block_bytes(cfg, 16, torch.bfloat16, 'int8')} B against 2048 bf16 blocks of "
        f"{arena_block_bytes(cfg, 16, torch.bfloat16)} B")
    qrec, eng, prompts, tables, results = chunked_serve(params, cfg, kv_dtype="int8",
                                                        num_blocks=nb_int8)
    served["chunked int8 serve"] = qrec["launches"]
    qrec["decode_logits"] = compare_logits(eng, params, cfg, prompts, results, tables)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    frec, eng, *_ = spec_serve(params, cfg, kv_dtype="fp8", self_draft=False)
    served["speculative fp8 serve"] = frec["launches"]
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    # multi-tenant LoRA: the chunked and speculative serves again, two
    # requests per adapter and two base ones
    reg = make_registry(cfg)
    lrec, eng, prompts, tables, results = chunked_serve(params, cfg, lora=reg)
    served["chunked LoRA serve"] = lrec["launches"]
    lrec["decode_logits"] = compare_logits(
        eng, params, cfg, prompts, results, tables,
        slots=[reg.slot(a) if a is not None else 0 for a in LORA_IDS])
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    slrec, eng, *_ = spec_serve(params, cfg, lora=reg, self_draft=False)
    served["speculative LoRA serve"] = slrec["launches"]
    del eng, reg
    gc.collect()
    torch.cuda.empty_cache()
    keys = ("tokens_per_s", "ttft_p50_ms", "tpot_p50_ms")
    say("LoRA serves beside the same run's serves without LoRA: " + json.dumps({
        "chunked": {"lora": {k: lrec[k] for k in keys}, "base": {k: crec[k] for k in keys}},
        "speculative": {"lora": {k: slrec[k] for k in keys},
                        "base": {k: srec[k] for k in keys}}}))
    cfg4 = Config.from_name(cfg.name, n_layer=4)
    params32_4 = _cast({**params, "blocks": params["blocks"][:4]}, torch.float32)
    _exact_tokens(params32_4, cfg4)
    _exact_tokens_quant(params32_4, cfg4)
    _exact_tokens_lora(params32_4, cfg4)
    _exact_tokens_tiny()
    del params32_4
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
               "flash_bwd_dkv": "flash_attention.cu",
               "paged_token_write_fused": "paged_attention.cu",
               "paged_chunk_write_fused": "paged_verify.cu", "flash_ce": "cross_entropy.cu",
               "lora_delta_fused": "lora_delta.cu"}
    replaces = {"paged_attn_decode": 1165, "paged_token_write": 1249, "paged_attn_verify": 1376,
                "paged_chunk_write": 1535, "paged_token_write_masked": 1462, "flash_fwd": 293,
                "flash_bwd_dq": 460, "flash_bwd_dkv": 460, "paged_token_write_fused": 1672,
                "paged_chunk_write_fused": 1616, "flash_ce": 911, "lora_delta_fused": 1740}
    # the Pallas function and its pallas_call site, where they differ
    counterpart = {"flash_fwd": "_flash_fwd (pallas_call :322)",
                   "flash_bwd_dq": "_flash_bwd (dq pallas_call :495)",
                   "flash_bwd_dkv": "_flash_bwd (dk/dv pallas_call :526)",
                   "flash_ce": "_flash_ce (pallas_call :921; flash_cross_entropy :984)",
                   "lora_delta_fused": "lora_delta_fused (pallas_call :1756)"}
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
            **{k: rec[k] for k in ("shapes", "quantized", "dtypes", "library", "body")
               if k in rec}))
    say("quantized serves: " + json.dumps({"chunked int8": qrec, "speculative fp8": frec}))
    say("LoRA serves: " + json.dumps({"chunked": lrec, "speculative": slrec}))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
