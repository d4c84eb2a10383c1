"""Training-step telemetry: structured per-step JSONL + registry mirror.

Counterpart of ``thunder_tpu/observability/telemetry.py``, copied, with
``trace_peak_bytes`` over the memory timeline (``observability/memory.py``);
the serving engine drives :meth:`StepLogger.log_request`.

Production pretraining stacks (TorchTitan, the arXiv:2410.06511 playbook)
treat step-level telemetry — loss, grad-norm, step time, tokens/sec, memory
watermark — as a first-class subsystem: a bad batch or an OOM-bound run must
be diagnosable from the log, not by rerunning under a debugger.
:class:`StepLogger` is that subsystem for thunder_tpu_torch: ``train_cli.py``
drives it once per optimizer step, it appends one JSON object per line to a
file (or any file-like sink) and mirrors the same numbers into the unified
metrics registry (``train.loss`` / ``train.grad_norm`` /
``train.tokens_per_sec`` / ``train.peak_bytes`` gauges, a ``train.step_s``
histogram, and a ``train.steps`` counter), so dashboards scraping
``observability.snapshot()`` and offline JSONL analysis see the same data.

The first line of a run is an ``{"event": "run_start", ...}`` record with
the run's static metadata; every step is ``{"event": "step", ...}``.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, IO

from thunder_tpu_torch.observability.metrics import registry

__all__ = ["StepLogger", "trace_peak_bytes", "REQUEST_SCHEMA_V", "REQUEST_FIELDS_V2"]

#: Version stamp every ``{"event": "request"}`` record carries.  Bumped
#: when the field set changes so offline readers can dispatch on it.
#: v2 added ``tokens_recomputed``/``recompute_causes`` from the
#: goodput ledger (and the ``v`` stamp itself; v1 records have no ``v``).
REQUEST_SCHEMA_V = 2

#: The complete closed field set a v2 request record may carry (optional
#: fields are omitted when None).  A reader-side test pins this tuple so
#: future additions are a deliberate schema bump, not drift.
REQUEST_FIELDS_V2 = (
    "event", "v", "rid", "time",
    "prompt_tokens", "new_tokens", "finish_reason",
    "ttft_s", "tpot_s", "tokens_per_sec", "queue_s", "e2e_s",
    "prefill_compiled", "shared_prefix_blocks",
    "session_id", "priority", "constrained", "preemptions", "error",
    "tokens_recomputed", "recompute_causes",
)


class StepLogger:
    """Appends one structured JSON line per training step.

    ``sink`` is a path (opened in append mode, closed by :meth:`close`) or
    an open file-like object (left open).  ``meta`` is written once as the
    run-start record.  ``mirror=False`` skips the metrics-registry mirror.
    """

    def __init__(
        self,
        sink: str | os.PathLike | IO[str],
        *,
        meta: dict | None = None,
        mirror: bool = True,
    ):
        self._owns_sink = isinstance(sink, (str, os.PathLike))
        self._f: IO[str] = open(sink, "a") if self._owns_sink else sink
        self._mirror = mirror
        self.steps_logged = 0
        if meta is not None:
            self._write({"event": "run_start", "time": time.time(),
                         "request_schema_v": REQUEST_SCHEMA_V,
                         "request_fields": list(REQUEST_FIELDS_V2),
                         **meta})

    def _write(self, rec: dict) -> None:
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def log_step(
        self,
        step: int,
        *,
        loss: float | None = None,
        grad_norm: float | None = None,
        step_time_s: float | None = None,
        tokens: int | None = None,
        peak_bytes: int | None = None,
        **extra: Any,
    ) -> dict:
        """Records one step; returns the record written.

        ``tokens`` is the number of tokens the step consumed —
        ``tokens_per_sec`` is derived from it and ``step_time_s``.  Unset
        fields are omitted from the JSON line (and not mirrored)."""
        rec: dict[str, Any] = {"event": "step", "step": int(step), "time": time.time()}
        if loss is not None:
            rec["loss"] = float(loss)
        if grad_norm is not None:
            rec["grad_norm"] = float(grad_norm)
        if step_time_s is not None:
            rec["step_time_s"] = float(step_time_s)
        if tokens is not None:
            rec["tokens"] = int(tokens)
            if step_time_s:
                rec["tokens_per_sec"] = int(tokens) / float(step_time_s)
        if peak_bytes is not None:
            rec["peak_bytes"] = int(peak_bytes)
        rec.update(extra)
        self._write(rec)
        self.steps_logged += 1

        if self._mirror:
            reg = registry()
            reg.counter("train.steps").inc()
            for key in ("loss", "grad_norm", "tokens_per_sec", "peak_bytes"):
                if key in rec:
                    reg.gauge(f"train.{key}").set(rec[key])
            if "step_time_s" in rec:
                reg.histogram("train.step_s").observe(rec["step_time_s"])
        return rec

    def log_request(
        self,
        *,
        rid: int,
        prompt_tokens: int,
        new_tokens: int,
        finish_reason: str,
        **extra: Any,
    ) -> dict:
        """Records one *served request* (the serving engine drives this once
        per completed/expired/evicted request): ``{"event": "request", ...}``
        with the request-level latency numbers (``ttft_s``, ``tpot_s``,
        ``tokens_per_sec``, ``queue_s``, ``e2e_s`` — submit→finish wall
        time) and the ``prefill_compiled`` cold-compile tag passed through
        ``extra``.  ``None`` values are omitted, mirroring
        :meth:`log_step`.

        Records are schema v2 (``"v": 2``, see :data:`REQUEST_FIELDS_V2`):
        v2 added the goodput-ledger recompute fields ``tokens_recomputed``
        and ``recompute_causes``."""
        rec: dict[str, Any] = {
            "event": "request",
            "v": REQUEST_SCHEMA_V,
            "rid": int(rid),
            "time": time.time(),
            "prompt_tokens": int(prompt_tokens),
            "new_tokens": int(new_tokens),
            "finish_reason": str(finish_reason),
        }
        rec.update({k: v for k, v in extra.items() if v is not None})
        self._write(rec)
        return rec

    def close(self) -> None:
        if self._owns_sink and not self._f.closed:
            self._f.close()

    def __enter__(self) -> "StepLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def trace_peak_bytes(trace) -> int:
    """Peak-bytes estimate for an execution trace, keyed to
    ``del_last_used`` placement (the pass is applied here when the trace has
    no ``del`` statements yet — e.g. TrainStep's fw/bw traces)."""
    from thunder_tpu_torch.core.prims import PrimIDs
    from thunder_tpu_torch.observability.memory import memory_timeline

    if not any(b.sym.id == PrimIDs.DEL for b in trace.bound_symbols):
        from thunder_tpu_torch.executors.passes import del_last_used

        trace = del_last_used(trace)
    return memory_timeline(trace)["peak_bytes_estimate"]
