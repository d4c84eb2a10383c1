"""Metrics registry: counters, gauges and histograms.

Counterpart of ``thunder_tpu/observability/metrics.py``, with the part the
serving engine touches: one process-wide get-or-create registry,
``snapshot()`` as a plain dict and ``reset()`` that zeroes values while the
metric objects stay registered (so handles held by an engine keep working).
Histograms keep exact count/sum/min/max over the whole stream and
nearest-rank p50/p95/p99 over a bounded window of recent observations.
The user hooks that ``jit``'s dispatch and compile events call
(``register_hook``, ``has_hooks``, ``emit``) are the reference's.
"""
from __future__ import annotations

import threading
import warnings
from typing import Any, Callable

__all__ = ["Counter", "Gauge", "Histogram", "HOOK_EVENTS", "MetricsRegistry", "clear_hooks",
           "emit", "has_hooks", "register_hook", "registry", "unregister_hook"]


class Counter:
    """Monotonic counter (resettable)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def snapshot(self):
        return self.value

    def reset(self) -> None:
        self.value = 0


class Gauge:
    """Last-written value (None until first ``set``)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = None

    def set(self, v) -> None:
        self.value = v

    def snapshot(self):
        return self.value

    def reset(self) -> None:
        self.value = None


class Histogram:
    """Streaming summary plus windowed nearest-rank percentiles over the
    most recent ``WINDOW`` observations."""

    WINDOW = 512

    __slots__ = ("name", "count", "sum", "min", "max", "_window")

    def __init__(self, name: str):
        self.name = name
        self.reset()

    def observe(self, v) -> None:
        self.count += 1
        self.sum += v
        if self.min is None or v < self.min:
            self.min = v
        if self.max is None or v > self.max:
            self.max = v
        self._window[self.count % self.WINDOW] = v

    def percentile(self, q: float):
        """Nearest-rank percentile (``q`` in [0, 100]) over the retained
        window; None before the first observation."""
        if not self.count:
            return None
        vals = sorted(v for v in self._window if v is not None)
        rank = max(int(-(-q / 100.0 * len(vals) // 1)), 1)  # ceil, >= 1
        return vals[min(rank, len(vals)) - 1]

    def snapshot(self) -> dict:
        return {
            "count": self.count,
            "sum": self.sum,
            "mean": (self.sum / self.count) if self.count else None,
            "min": self.min,
            "max": self.max,
            "p50": self.percentile(50),
            "p95": self.percentile(95),
            "p99": self.percentile(99),
            "window": self.WINDOW,
        }

    def reset(self) -> None:
        self.count = 0
        self.sum = 0
        self.min = None
        self.max = None
        self._window = [None] * self.WINDOW


class MetricsRegistry:
    """Get-or-create metric store; creation takes a lock."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, Any] = {}

    def _get(self, name: str, cls):
        m = self._metrics.get(name)
        if m is None:
            with self._lock:
                m = self._metrics.setdefault(name, cls(name))
        if not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} is already registered as {type(m).__name__}, "
                f"not {cls.__name__}"
            )
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def snapshot(self, prefix: str | None = None) -> dict:
        return {
            name: m.snapshot()
            for name, m in sorted(self._metrics.items())
            if prefix is None or name.startswith(prefix)
        }

    def reset(self) -> None:
        for m in self._metrics.values():
            m.reset()


_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process-wide registry every subsystem publishes into."""
    return _REGISTRY


#
# Hooks (reference thunder_tpu/observability/metrics.py)
#

HOOK_EVENTS = (
    "on_compile_start",
    "on_compile_end",
    "on_cache_hit",
    "on_cache_miss",
    "on_dispatch",
)

_hooks: dict[str, list[Callable]] = {e: [] for e in HOOK_EVENTS}


def _check_event(event: str) -> None:
    if event not in _hooks:
        raise ValueError(f"unknown hook event {event!r}; known: {HOOK_EVENTS}")


def register_hook(event: str, fn: Callable) -> Callable:
    """Registers ``fn(payload: dict)`` for ``event``; returns ``fn`` so it
    can be used as a decorator."""
    _check_event(event)
    _hooks[event].append(fn)
    return fn


def unregister_hook(event: str, fn: Callable) -> None:
    _check_event(event)
    try:
        _hooks[event].remove(fn)
    except ValueError:
        pass


def clear_hooks(event: str | None = None) -> None:
    if event is None:
        for hs in _hooks.values():
            hs.clear()
        return
    _check_event(event)
    _hooks[event].clear()


def has_hooks(event: str) -> bool:
    """Cheap pre-check so hot-path callers can skip building the payload
    dict when nobody is listening."""
    return bool(_hooks.get(event))


def emit(event: str, payload: dict) -> None:
    hs = _hooks.get(event)
    if not hs:
        _check_event(event)
        return
    for h in tuple(hs):
        try:
            h(payload)
        except Exception as e:  # a broken hook must not break dispatch —
            # but a silently swallowed failure must still be measurable
            registry().counter("hooks.errors").inc()
            warnings.warn(
                f"observability hook {getattr(h, '__name__', h)!r} for "
                f"{event} raised {e!r}; ignoring",
                stacklevel=2,
            )
