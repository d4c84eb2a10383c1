"""Observability for the port (counterpart of ``thunder_tpu/observability``).

The environment gates (``config.py``), the runtime profiling transform
(``profiler.py``: ``jit(fn, profile=True)``, queried with
``thunder_tpu_torch.profile_stats``), the debug hooks and NaN/Inf anomaly
scan (``debug.py``: ``debug_hooks=``, ``detect_anomalies=``), the metrics
registry and the user hooks (``metrics.py``), compile-pipeline
spans (``events.py``), and the glue ``jit`` calls on every dispatch and
compile (``dispatch_event``, ``compile_begin``, ``compile_end``,
reference ``thunder_tpu/observability/__init__.py:200-225``), which mirror
``dispatch.*`` and ``compile.*`` into ``registry()`` under the reference's
names.
"""
import contextlib

from thunder_tpu_torch.observability.config import (  # noqa: F401
    annotations_enabled,
    anomaly_env_enabled,
    event_buffer_capacity,
    flight_dump_dir,
    flight_recorder_env_enabled,
    profiling_env_enabled,
    serving_trace_env_enabled,
)
from thunder_tpu_torch.observability.metrics import (
    HOOK_EVENTS,
    clear_hooks,
    emit,
    has_hooks,
    register_hook,
    registry,
    unregister_hook,
)

__all__ = ["HOOK_EVENTS", "add_markers", "annotations_enabled", "anomaly_env_enabled",
           "clear_hooks", "compile_begin", "compile_end", "dispatch_event", "emit",
           "event_buffer_capacity", "flight_dump_dir", "flight_recorder_env_enabled", "has_hooks",
           "profiling_enabled", "profiling_env_enabled", "register_hook", "registry",
           "reset_observability", "serving_trace_env_enabled", "snapshot", "unregister_hook"]


def profiling_enabled() -> bool:
    """Legacy gate name (old ``core/profile.py``): True when trace
    annotations are on.  Reads ``THUNDER_TPU_ANNOTATE_TRACES`` on every
    call."""
    return annotations_enabled()


@contextlib.contextmanager
def add_markers(msg: str):
    """Annotates the enclosed work with ``msg`` in ``torch.profiler`` traces
    (``torch.profiler.record_function``), gated on every call."""
    if not annotations_enabled():
        yield
        return
    assert "\n" not in msg, msg
    import torch

    with torch.profiler.record_function(msg):
        yield


def snapshot() -> dict:
    """One plain dict of every registered metric (see ``metrics.py``)."""
    return registry().snapshot()


def reset_observability() -> None:
    """One call clearing all accumulated observability state: the metrics
    registry (values zeroed, metric objects stay registered), the compile-
    event ring buffer, and every live ProfileReport's accumulated per-symbol
    records.  Registered user hooks are not touched."""
    from thunder_tpu_torch.observability.events import clear_events
    from thunder_tpu_torch.observability.profiler import reset_profile_reports

    registry().reset()
    clear_events()
    reset_profile_reports()


#
# Glue the dispatch/compile paths call.  Kept to ONE function call per event
# so the hot path stays cheap: counters are attribute increments, and hook
# payload dicts are only built when a hook is actually registered.
#


def dispatch_event(fn_name: str, *, ns: int, hit: bool) -> None:
    """Called once per dispatch of a compiled function (post-timing)."""
    reg = registry()
    reg.counter("dispatch.calls").inc()
    reg.counter("dispatch.cache_hits" if hit else "dispatch.cache_misses").inc()
    reg.histogram("dispatch.ns").observe(ns)
    if has_hooks("on_dispatch"):
        emit("on_dispatch", {"fn": fn_name, "ns": ns, "cache_hit": hit})
    event = "on_cache_hit" if hit else "on_cache_miss"
    if has_hooks(event):
        emit(event, {"fn": fn_name})


def compile_begin(fn_name: str) -> None:
    registry().counter("compile.count").inc()
    if has_hooks("on_compile_start"):
        emit("on_compile_start", {"fn": fn_name})


def compile_end(fn_name: str, ns: int) -> None:
    registry().histogram("compile.ns").observe(ns)
    if has_hooks("on_compile_end"):
        emit("on_compile_end", {"fn": fn_name, "ns": ns})
