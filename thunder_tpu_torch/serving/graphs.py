"""Bucket steps as CUDA graphs: one capture per (engine, kind, bucket), one
replay per step.

Counterpart of the reference's compiled bucket programs
(``thunder_tpu/serving/engine.py:2551 _program``): where the JAX engine
compiles each bucket geometry once and dispatches it with one call, the
port captures the step's kernels once into a ``torch.cuda.CUDAGraph`` and
replays it.

A step function has the signature ``fn(x, host) -> (out, carry)``:

- ``x``: the step's inputs by name, device tensors (or None);
- ``host(name, *args, like=[(shape, dtype), ...])``: a point where the
  step needs host-side work that a graph cannot hold, the per-request
  ``torch.Generator`` draws of temperature sampling.  It returns the
  eager function's output tensors, shaped as ``like``;
- ``out``: the step's output tensors by name;
- ``carry``: new values of some inputs, which the next step of the same
  batch consumes (the chained ``toks``/``pos`` of a decode step).

:func:`run_eager` runs such a function straight through (the CPU path,
which the caller asks for with ``device="cpu"``, and the first call of a
bucket on the card).  :class:`StepGraph` runs the first call eagerly —
its outputs are the real step's, and it fills the kernel wrappers' host
caches — and then captures the function once, without running it, into
the engine's memory pool.  Every later call copies the inputs that are
not already the graph's own buffers into them and replays.  The inputs
and outputs of a graph are buffers allocated outside the pool, before the
capture: the graphs of one engine share the pool and replay in any order,
and a graph captured later may take an earlier one's freed intermediates
for its own, so nothing that outlives a replay lives in the pool.  A ``host``
point splits the capture into segments: at replay, the segments run in
order with the eager function between them, whose outputs are copied into
buffers the next segment reads.  Greedy steps have no such point.

A graph holds the addresses of its engine's parameters, arenas and
buffers, so graphs are never shared across engines (the reference's
module-wide ``_program_cache`` has no counterpart).  A replay calls no
kernel wrapper, so each graph records the ``cudaex.LAUNCHES`` its capture
made and adds them at every replay.
"""
from __future__ import annotations

import gc
import time
from typing import Callable

import numpy as np
import torch

from thunder_tpu_torch.executors import cudaex

__all__ = ["GraphCaptureError", "StepGraph", "run_eager", "to_device"]


class GraphCaptureError(RuntimeError):
    """A bucket step could not be captured (a host synchronization or an
    operation a graph cannot hold on its path); names the kind and the
    bucket.  Nothing runs eagerly in its place."""


def to_device(v, device):
    """A step input on ``device``: tensors pass through, numpy arrays
    become tensors, None stays None."""
    if v is None or isinstance(v, torch.Tensor):
        return v
    return torch.as_tensor(np.asarray(v), device=device)


def run_eager(fn: Callable, x: dict, host_fns: dict | None = None, *,
              device) -> tuple[dict, dict]:
    """Runs step ``fn`` straight through; returns ``(out, inputs for the
    next step)``: every input, with the carried ones replaced."""
    xt = {k: to_device(v, device) for k, v in x.items()}
    fns = host_fns or {}

    def host(name, *args, like):
        return fns[name](*args)

    out, carry = fn(xt, host)
    return out, {**xt, **carry}


# one capture stream per card: the streams capture runs on (kernels read
# the current stream), never the one replays run on
_CAPTURE_STREAMS: dict = {}


def _capture_stream(device) -> torch.cuda.Stream:
    s = _CAPTURE_STREAMS.get(device.index)
    if s is None:
        s = _CAPTURE_STREAMS[device.index] = torch.cuda.Stream(device)
    return s


class StepGraph:
    """One bucket step on the card: eager at its first call, then captured
    and replayed.  ``versions`` returns the arena versions of the engine's
    pools (``PagedKVPool.arena_version``); when they change (installed
    arena tensors), the graph is dropped and the next call warms up and
    captures again."""

    def __init__(self, fn: Callable, *, kind: str, bucket: tuple, device, pool,
                 versions: Callable[[], tuple], on_capture: Callable[[str], None] | None = None):
        self.fn = fn
        self.kind = kind
        self.bucket = tuple(bucket)
        self.device = device
        self._pool = pool
        self._versions = versions
        self._on_capture = on_capture
        self._segments: list | None = None
        self._static: dict = {}
        self._out: dict = {}
        self._captured_at = None
        self.launches: dict[str, int] = {}
        self.replays = 0
        self.captures = 0
        self.capture_s = 0.0                   # host seconds spent capturing

    def __call__(self, x: dict, host_fns: dict | None = None) -> tuple[dict, dict]:
        if self._segments is not None and self._versions() != self._captured_at:
            self.drop()
        if self._segments is None:
            out, nxt = run_eager(self.fn, x, host_fns, device=self.device)
            self._capture(x, out)
            return out, nxt
        return self._replay(x, host_fns)

    def drop(self) -> None:
        """Forgets the captured graph (the card finishes its work first)."""
        if self._segments is not None:
            torch.cuda.synchronize(self.device)
        self._segments = None
        self._static, self._out = {}, {}

    def _capture(self, x: dict, like: dict) -> None:
        """Captures the step on inputs ``x``; ``like``: the warm-up's
        outputs, whose shapes the output buffers take."""
        dev = self.device
        out_bufs = {k: torch.empty_like(v) for k, v in like.items()}
        static = {}
        for k, v in x.items():
            if v is None:
                static[k] = None
            else:
                t = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))
                static[k] = torch.empty(t.shape, dtype=t.dtype, device=dev)
                static[k].copy_(t)
        segments: list = []
        state = {"graph": torch.cuda.CUDAGraph()}
        stream = _capture_stream(dev)
        launches_before = dict(cudaex.LAUNCHES)
        where = f"{self.kind} bucket {self.bucket}"

        def host(name, *args, like):
            # end this segment; the eager outputs land in buffers that the
            # next segment reads
            state["graph"].capture_end()
            holders = tuple(torch.empty(shape, dtype=dtype, device=dev) for shape, dtype in like)
            segments.append((state["graph"], name, args, holders))
            state["graph"] = torch.cuda.CUDAGraph()
            state["graph"].capture_begin(pool=self._pool)
            return holders

        # a graph freed while this capture runs would release pool memory
        # mid-capture, which invalidates it: the collector pauses (an
        # engine and its graphs form no reference cycle, so a dropped
        # engine frees them at once, outside any capture)
        t0 = time.perf_counter()
        gc_was_on = gc.isenabled()
        gc.disable()
        torch.cuda.synchronize(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        try:
            with torch.cuda.stream(stream):
                state["graph"].capture_begin(pool=self._pool)
                try:
                    out, carry = self.fn(static, host)
                    for k, v in out.items():
                        out_bufs[k].copy_(v)
                    for k, v in carry.items():
                        if v is not static[k]:
                            static[k].copy_(v)
                finally:
                    state["graph"].capture_end()
        except Exception as e:
            raise GraphCaptureError(f"capturing the {where} step failed: "
                                    f"{type(e).__name__}: {e}") from e
        finally:
            if gc_was_on:
                gc.enable()
            delta = {k: cudaex.LAUNCHES[k] - launches_before.get(k, 0) for k in cudaex.LAUNCHES}
            cudaex.LAUNCHES.update(launches_before)        # a capture runs nothing
        torch.cuda.current_stream(dev).wait_stream(stream)
        segments.append((state["graph"], None, (), ()))
        self.launches = {k: n for k, n in delta.items() if n}
        self._segments = segments
        self._static = static
        self._out = out_bufs
        self._captured_at = self._versions()
        self.captures += 1
        self.capture_s += time.perf_counter() - t0
        if self._on_capture is not None:
            self._on_capture(self.kind)

    def _replay(self, x: dict, host_fns: dict | None) -> tuple[dict, dict]:
        static = self._static
        for k, v in x.items():
            s = static[k]
            if v is None or v is s:
                continue
            if isinstance(v, torch.Tensor):
                s.copy_(v)
            else:
                s.copy_(torch.from_numpy(np.asarray(v)), non_blocking=True)
        for graph, name, args, holders in self._segments:
            graph.replay()
            if name is not None:
                for h, o in zip(holders, host_fns[name](*args)):
                    h.copy_(o)
        self.replays += 1
        for k, n in self.launches.items():
            cudaex.LAUNCHES[k] += n
        return self._out, dict(static)
