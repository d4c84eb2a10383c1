"""Observability for the port (counterpart of ``thunder_tpu/observability``).

The metrics registry and the user hooks (``metrics.py``), compile-pipeline
spans (``events.py``), and the glue ``jit`` calls on every dispatch and
compile (``dispatch_event``, ``compile_begin``, ``compile_end``,
reference ``thunder_tpu/observability/__init__.py:200-225``), which mirror
``dispatch.*`` and ``compile.*`` into ``registry()`` under the reference's
names.
"""
from thunder_tpu_torch.observability.metrics import (
    HOOK_EVENTS,
    clear_hooks,
    emit,
    has_hooks,
    register_hook,
    registry,
    unregister_hook,
)

__all__ = ["HOOK_EVENTS", "clear_hooks", "compile_begin", "compile_end", "dispatch_event",
           "emit", "has_hooks", "register_hook", "registry", "snapshot", "unregister_hook"]


def snapshot() -> dict:
    """One plain dict of every registered metric (see ``metrics.py``)."""
    return registry().snapshot()


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
