"""Observability configuration: dynamic environment gates.

Counterpart of ``thunder_tpu/observability/config.py``, with the same
variable names.  Every gate here reads the environment at call time, so a
variable set after import takes effect; the per-call cost is one
``os.environ`` lookup, paid only on paths that are already instrumentation
(never on the uninstrumented hot path).
"""
from __future__ import annotations

import os

__all__ = [
    "annotations_enabled",
    "profiling_env_enabled",
    "anomaly_env_enabled",
    "event_buffer_capacity",
    "serving_trace_env_enabled",
    "flight_recorder_env_enabled",
    "flight_dump_dir",
]

_TRUTHY = ("1", "y", "Y", "true", "on")


def _env_flag(name: str) -> bool:
    return os.getenv(name, "") in _TRUTHY


def annotations_enabled() -> bool:
    """``torch.profiler.record_function`` ranges around instrumented
    symbols (visible in ``torch.profiler`` traces).  Gated by
    ``THUNDER_TPU_ANNOTATE_TRACES``, read dynamically."""
    return _env_flag("THUNDER_TPU_ANNOTATE_TRACES")


def profiling_env_enabled() -> bool:
    """``THUNDER_TPU_PROFILE=1`` turns on the runtime profiling transform
    for every ``jit`` that does not pass an explicit ``profile=`` option.
    Read at compile time (dynamically), so it can be flipped mid-process."""
    return _env_flag("THUNDER_TPU_PROFILE")


def anomaly_env_enabled() -> bool:
    """``THUNDER_TPU_DETECT_ANOMALIES=1`` turns on NaN/Inf anomaly detection
    for every ``jit`` that does not pass an explicit ``detect_anomalies=``
    option.  Read at compile time (dynamically)."""
    return _env_flag("THUNDER_TPU_DETECT_ANOMALIES")


def event_buffer_capacity() -> int:
    """Ring-buffer bound for compile-pipeline + serving events
    (``THUNDER_TPU_EVENT_BUFFER``, default 4096).  Re-read on every event
    append, so changing it after import takes effect."""
    try:
        return max(16, int(os.getenv("THUNDER_TPU_EVENT_BUFFER", "4096")))
    except ValueError:
        return 4096


def serving_trace_env_enabled() -> bool:
    """``THUNDER_TPU_TRACE_SERVING=1`` turns on request-lifecycle span
    tracing for every serving engine that does not pass an explicit
    ``trace=`` option.  Read at engine construction (dynamically)."""
    return _env_flag("THUNDER_TPU_TRACE_SERVING")


def flight_recorder_env_enabled() -> bool:
    """``THUNDER_TPU_FLIGHT_RECORDER=1`` arms the serving flight recorder
    for every engine that does not pass an explicit ``flight_recorder=``
    option.  Read at engine construction (dynamically)."""
    return _env_flag("THUNDER_TPU_FLIGHT_RECORDER")


def flight_dump_dir() -> str:
    """Directory crash dumps land in (``THUNDER_TPU_FLIGHT_DIR``, default
    the current working directory)."""
    return os.getenv("THUNDER_TPU_FLIGHT_DIR", ".")
