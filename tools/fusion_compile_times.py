#!/usr/bin/env python3
"""First-compile seconds of the port's fusion regions, cold and warm.

Runs ``thunder_tpu_torch.jit(gpt_loss)`` and the traced ``TrainStep`` of
Llama-3-8B at full width and 4 layers (bf16, B=1, T=2048, ``full_block``)
on one card, and prints one ``RESULT`` JSON line: the seconds of each
program's first call (its regions' compiles included), the regions
compiled and their seconds (``inductorex.STATS``), the jit's device ms and
kernels a call, the step's ms, and the persistent cache's hits and misses.

    THUNDER_TPU_COMPILATION_CACHE=DIR python3 tools/fusion_compile_times.py

Run it on an empty cache directory for a cold compile, then again on the
same directory for a warm one (every region's graph then loads from the
cache).
"""
from __future__ import annotations

import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
import thunder_tpu_torch as ttt  # noqa: E402
from thunder_tpu_torch.executors import inductorex  # noqa: E402


def main() -> int:
    torch.backends.cuda.matmul.allow_tf32 = False
    cs._build.load_library()
    cfg = ttt.Config.from_name("Llama-3-8B", n_layer=4)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = ttt.init_params(cfg, generator=gen, dtype=torch.bfloat16, device="cuda")
    batch = cs.train_batch(cfg, 10)
    loss_fn = lambda p, i, t, c, s: ttt.gpt_loss(p, i, t, c, s, cfg)     # noqa: E731
    t0 = time.perf_counter()
    jfn = ttt.jit(loss_fn)
    jfn(params, *batch)
    torch.cuda.synchronize()
    jit_s = time.perf_counter() - t0
    dev, nk = cs.device_ms_all(lambda: jfn(params, *batch), iters=3)
    step = ttt.make_train_step(loss_fn, ttt.adamw(1e-4), remat="full_block")
    opt_state = step.init_optimizer_state(params)
    t0 = time.perf_counter()
    step(params, opt_state, *batch)[2].item()
    step_s = time.perf_counter() - t0
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        step(params, opt_state, *batch)[2].item()
        times.append(time.perf_counter() - t0)
    print("RESULT", json.dumps(dict(
        card=cs.card_line(), jit_first_s=jit_s, jit_device_ms=dev, kernels=nk,
        step_first_s=step_s, step_ms=1e3 * min(times), stats=inductorex.STATS,
        cache=ttt.compile_stats(jfn).persistent_cache)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
