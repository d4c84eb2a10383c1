"""Event tracing: a ring buffer of begin/end events, exportable as
Chrome-trace / Perfetto JSON.

Counterpart of ``thunder_tpu/observability/events.py``, copied; the port's
trace acquisition and claiming passes record their spans here.

Every stage of the compile pipeline (interpretation, each transform,
lowering/claiming, codegen, XLA compile) records a ``B``/``E`` event pair
via :func:`span`, and the serving plane (``observability/tracing.py``)
records *async* per-request lifecycle spans (``ph: "b"/"e"`` keyed by
request id) into the same buffer — one :func:`export_chrome_trace` call
yields one merged Perfetto timeline.  Events live in a bounded ring buffer
(the oldest events drop first — an orphaned ``B`` from eviction is
tolerated by Perfetto), so long-running processes never grow unbounded.
Nothing on the *dispatch* hot path records events; recording happens only
on compile-time and explicitly-traced serving paths, where one
``perf_counter_ns`` + deque append is noise against tracing and XLA
compilation.

The ring capacity (``THUNDER_TPU_EVENT_BUFFER``, read through
``observability/config.py``) is re-read on every
append, so changing it after import takes effect on the next recorded
event (the old import-frozen ``deque(maxlen=...)`` silently ignored late
changes).

``span`` is built on ``contextlib.contextmanager`` and therefore also works
as a decorator (each call re-creates the context).
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from contextlib import contextmanager

from thunder_tpu_torch.observability.config import event_buffer_capacity

__all__ = [
    "record_event",
    "span",
    "events",
    "clear_events",
    "export_chrome_trace",
    "register_process_name",
    "register_thread_name",
]


_events: deque = deque(maxlen=event_buffer_capacity())
# display-name registries consulted at export time; serving tracers register
# their synthetic pid/tid tracks here ("thunder_tpu serving", "req 3", ...)
_process_names: dict[int, str] = {}
_thread_names: dict[tuple[int, int], str] = {}


def _ensure_capacity() -> None:
    """Re-applies the configured ring capacity when it changed since the
    last append (capacity is NOT frozen at import; see module docstring)."""
    global _events
    cap = event_buffer_capacity()
    if _events.maxlen != cap:
        _events = deque(_events, maxlen=cap)


def record_event(
    ph: str,
    name: str,
    args: dict | None = None,
    *,
    cat: str = "thunder_tpu",
    pid: int | None = None,
    tid: int | None = None,
    id: int | None = None,
) -> None:
    """Appends one Chrome-trace event (``ph``: "B"/"E"/"b"/"e"/"i"/"X"...)
    stamped with the monotonic clock in microseconds.  ``cat`` groups the
    event into a track family (``"thunder_tpu"`` = compile pipeline,
    ``"serving.*"`` = the serving plane); ``pid``/``tid`` default to the
    real process/thread but may name a synthetic display track; ``id`` keys
    async (``"b"``/``"e"``) span pairs — the serving tracer uses the
    request id."""
    ev = {
        "ph": ph,
        "name": name,
        "cat": cat,
        "ts": time.perf_counter_ns() / 1e3,
        "pid": os.getpid() if pid is None else pid,
        "tid": threading.get_ident() if tid is None else tid,
    }
    if id is not None:
        ev["id"] = id
    if args:
        ev["args"] = args
    _ensure_capacity()
    _events.append(ev)


@contextmanager
def span(name: str, **meta):
    """Records a ``B``/``E`` pair around the enclosed work (exception-safe).
    Usable as a context manager or as a decorator."""
    record_event("B", name, meta or None)
    try:
        yield
    finally:
        record_event("E", name)


def events() -> list[dict]:
    """Snapshot of the ring buffer, oldest first."""
    return list(_events)


def clear_events() -> None:
    _events.clear()


def register_process_name(pid: int, name: str) -> None:
    """Names a (possibly synthetic) pid's process row in exported traces."""
    _process_names[pid] = name


def register_thread_name(pid: int, tid: int, name: str) -> None:
    """Names a (possibly synthetic) (pid, tid) track in exported traces."""
    _thread_names[(pid, tid)] = name


def _process_label(cats: set[str]) -> str:
    """Default process name derived from the event categories recorded under
    a pid, so serving spans never masquerade as compile work: any
    ``serving*`` category makes it a serving row; the bare ``thunder_tpu``
    category is the compile pipeline."""
    if any(c.split(".")[0] == "serving" for c in cats):
        return "thunder_tpu serving"
    return "thunder_tpu compile pipeline"


def _metadata_events(evs: list[dict]) -> list[dict]:
    """``process_name``/``thread_name`` metadata (``ph: "M"``) records so
    Perfetto labels the rows instead of showing bare pid/tid numbers.
    Registered names win; otherwise the process name derives from the
    categories seen under that pid."""
    metas = []
    by_pid: dict[int, set[str]] = {}
    for e in evs:
        by_pid.setdefault(e["pid"], set()).add(e.get("cat", "thunder_tpu"))
    for pid in sorted(by_pid):
        metas.append({
            "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
            "args": {"name": _process_names.get(pid) or _process_label(by_pid[pid])},
        })
    for pid, tid in sorted({(e["pid"], e["tid"]) for e in evs}):
        metas.append({
            "ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
            "args": {"name": _thread_names.get((pid, tid), f"thread {tid}")},
        })
    return metas


def export_chrome_trace(path):
    """Writes the buffered events (compile pipeline + any traced serving
    spans) as a Chrome-trace JSON object (loadable in ``chrome://tracing``
    and https://ui.perfetto.dev), prefixed with process/thread-name metadata
    events.  ``path`` may be a filesystem path or an open file-like object
    (written to, left open).  Returns ``path``."""
    evs = list(_events)
    payload = {"traceEvents": _metadata_events(evs) + evs, "displayTimeUnit": "ms"}
    if hasattr(path, "write"):
        json.dump(payload, path)
        return path
    with open(path, "w") as f:
        json.dump(payload, f)
    return path
