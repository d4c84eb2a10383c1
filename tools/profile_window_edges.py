#!/usr/bin/env python3
"""Which kernels a profiled decode window loses against the launch counters.

Serves phase 4's eight Llama-3-8B prompts (full width and depth, bf16) on
one card, on an eager and on a graphed engine, and profiles windows of four
decode steps the way ``chip_smoke.profile_decode_steps`` does (a schedule
with one traced, dropped warm-up step; the card synchronized on both sides
of the counted steps).  Windows alternate between no idle time at their
edges and PAD_S seconds of host sleep on each side of the counted steps.
Each window prints one JSON line: the decode kernels the profiler saw and
the launches ``cudaex.LAUNCHES`` counted, the device records kept, the
first and last of them, the index of the first ``paged_attn_split``, and
the gaps (µs) from the window's opening to its first record and from its
last record to its close.  A last line per engine and edge counts the
windows that lost decode kernels.

    python3 tools/profile_window_edges.py [SECONDS_PER_ENGINE [PAD_S]]

Defaults: 150 s per engine (at most 44 windows), PAD_S 0.05.
"""
from __future__ import annotations

import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from thunder_tpu_torch.executors import _build, cudaex  # noqa: E402
from thunder_tpu_torch.serving import ServingEngine  # noqa: E402


def window(eng, pad, steps=4):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA],
            schedule=torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        eng.step()                                         # traced, dropped
        torch.cuda.synchronize()
        prof.step()
        if pad:
            time.sleep(pad)
        launched = dict(cudaex.LAUNCHES)
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        if pad:
            time.sleep(pad)
        delta = {k: n - launched.get(k, 0) for k, n in cudaex.LAUNCHES.items()}
        prof.step()
    kern = sorted(cs.device_kernels(prof), key=lambda e: e.time_range.start)
    marks = [e for e in prof.events() if e.name.startswith("ProfilerStep")]
    names = [e.name for e in kern]
    got = {k: sum(k in n for n in names) for k, _ in cs.DECODE_SPAN_COUNTERS}
    want = {k: sum(delta.get(c, 0) for c in cs_) for k, cs_ in cs.DECODE_SPAN_COUNTERS}
    s0 = min((e.time_range.start for e in marks), default=None)
    s1 = max((e.time_range.end for e in marks), default=None)
    return dict(pad=pad, ok=got == want, got=got, want=want, n=len(names),
                first=names[0][:40] if names else None, last=names[-1][:40] if names else None,
                first_attn_index=next((i for i, n in enumerate(names)
                                       if "paged_attn_split" in n), None),
                step_span_us=[s0, s1],
                gap_start_us=(kern[0].time_range.start - s0) if kern and s0 is not None else None,
                gap_end_us=(s1 - kern[-1].time_range.end) if kern and s1 is not None else None)


def main() -> int:
    mode_s = float(sys.argv[1]) if len(sys.argv) > 1 else 150.0
    pad_s = float(sys.argv[2]) if len(sys.argv) > 2 else 0.05
    cs.CARD = cs.card_line()
    print(cs.CARD, flush=True)
    _build.load_library()
    params, cfg = cs.make_params()
    prompts = cs.phase4_prompts(cfg)
    for graphs in (False, True):
        eng = ServingEngine(params, cfg, attn="paged", block_size=16, num_blocks=1024,
                            max_batch=8, device=cs.DEVICE, _graphs=graphs)
        eng.run(prompts, max_new_tokens=8)
        handles = [eng.submit(p, max_new_tokens=240) for p in prompts]
        while not all(h._req.generated for h in handles):
            eng.step()
        torch.cuda.synchronize()
        recs = []
        t_end = time.perf_counter() + mode_s
        while (time.perf_counter() < t_end and len(recs) < 44
               and not any(h.done() for h in handles)):
            r = window(eng, (0.0, pad_s)[len(recs) % 2])
            r["graphs"] = graphs
            recs.append(r)
            print(json.dumps(r), flush=True)
        for pad in (0.0, pad_s):
            sel = [r for r in recs if r["pad"] == pad]
            print(f"graphs={graphs} pad={pad}: {sum(not r['ok'] for r in sel)} of {len(sel)} "
                  f"windows lost kernels; n {sorted(set(r['n'] for r in sel))}", flush=True)
        eng.drain()
        del eng
    return 0


if __name__ == "__main__":
    sys.exit(main())
