"""Serving flight recorder: a bounded ring of engine events + a state
snapshot, auto-dumped to JSON when ``step()`` raises.

Counterpart of ``thunder_tpu/observability/flight.py``, copied; its
environment gates (:func:`flight_recorder_env_enabled`,
:func:`flight_dump_dir`) are read through ``observability/config.py``.

The aviation black-box model: when a serving engine crashes mid-flight —
an :class:`AnomalyError` out of the model, a pool invariant violation, a
broken stream callback — the postmortem needs what the engine was *doing*,
not just the traceback.  The recorder keeps the last N engine events
(submit/admit/prefill/prefill_chunk/decode/expire/finish, each a tiny
host-side dict) in a ring, and on demand snapshots the scheduler/pool
state: batch occupancy, free-list and sharing (fragmentation) accounting,
prefix-share hit rate, which bucket geometries compiled when (the
per-bucket compile causes), and — on the async engine — the per-lane
state: the in-flight decode/prefill futures and every partially-prefilled
request (``state["lanes"]``), so a crash mid-overlap shows what was still
on the device.  Engines running with ``goodput=True`` tag each recorded
decode event with the dispatch's goodput breakdown (committed + non-zero
waste causes) and put the ledger's running brief in ``state["lanes"]
["goodput"]``, so the postmortem also answers "was the engine doing
*useful* work when it died".

Dump paths:

- **crash**: the engine wraps ``step()``; any exception triggers
  :meth:`FlightRecorder.dump` into ``THUNDER_TPU_FLIGHT_DIR`` (default cwd)
  before the exception propagates — the dump must never mask the error.
- **manual**: ``flight_record(path)`` exports the most recently active
  recorder's ring + state at any time (a live-engine "what is it doing").

Off by default: engines attach a recorder only under
``flight_recorder=True`` / ``THUNDER_TPU_FLIGHT_RECORDER=1``; the unarmed
path costs one ``is None`` check per step.
"""
from __future__ import annotations

import json
import os
import time
import warnings
import weakref
from collections import deque
from typing import Callable

from thunder_tpu_torch.observability.config import flight_dump_dir, flight_recorder_env_enabled
from thunder_tpu_torch.observability.metrics import registry

__all__ = ["FlightRecorder", "flight_record", "active_recorder",
           "flight_recorder_env_enabled", "flight_dump_dir"]



# the most recently activated recorder, weakly held so a dead engine's
# recorder (and through its state provider, the engine) can be collected
_last_recorder: "weakref.ref[FlightRecorder] | None" = None
_dump_seq = 0


def _activate(rec: "FlightRecorder") -> None:
    global _last_recorder
    _last_recorder = weakref.ref(rec)


def active_recorder() -> "FlightRecorder | None":
    """The most recently activated recorder still alive, else None."""
    return _last_recorder() if _last_recorder is not None else None


def flight_record(path) -> str:
    """Dumps the most recently active flight recorder's ring + state
    snapshot to ``path`` (the manual entry point).  Raises
    ``RuntimeError`` when no armed engine exists."""
    rec = active_recorder()
    if rec is None:
        raise RuntimeError(
            "no active flight recorder: construct the engine with "
            "flight_recorder=True (or THUNDER_TPU_FLIGHT_RECORDER=1)"
        )
    return rec.dump(path, reason="manual")


class FlightRecorder:
    """Bounded ring of engine events + on-demand state snapshot.

    ``state_provider`` is a zero-arg callable returning the engine-side
    state dict (scheduler/pool snapshot); the engine installs it at
    construction.  ``capacity`` bounds the ring — recording is one dict
    build + deque append, cheap enough for every engine event."""

    def __init__(self, capacity: int = 512, state_provider: Callable[[], dict] | None = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.state_provider = state_provider
        self._ring: deque[dict] = deque(maxlen=self.capacity)
        self.events_recorded = 0
        self.dumps = 0
        _activate(self)

    def record(self, kind: str, **fields) -> None:
        """Appends one engine event (ts is the shared monotonic clock so
        ring timestamps line up with exported trace spans)."""
        ev = {"ts": time.perf_counter_ns() / 1e3, "kind": kind}
        ev.update(fields)
        self._ring.append(ev)
        self.events_recorded += 1

    def events(self) -> list[dict]:
        return list(self._ring)

    def snapshot(self, *, reason: str, error: BaseException | None = None) -> dict:
        """The full dump payload: ring + engine state + metadata.  A broken
        state provider must not lose the ring — its failure is recorded in
        place of the state."""
        state: dict | None = None
        state_error: str | None = None
        if self.state_provider is not None:
            try:
                state = self.state_provider()
            except Exception as e:  # the dump is a postmortem tool; keep
                # what we have rather than dying inside the crash handler
                state_error = f"{type(e).__name__}: {e}"
        out = {
            "reason": reason,
            "time": time.time(),
            "pid": os.getpid(),
            "events_recorded": self.events_recorded,
            "events": self.events(),
            "state": state,
        }
        if state_error is not None:
            out["state_error"] = state_error
        if error is not None:
            out["error"] = {"type": type(error).__name__, "message": str(error)}
        return out

    def dump(self, path=None, *, reason: str = "manual",
             error: BaseException | None = None) -> str:
        """Writes the snapshot as JSON; ``path=None`` generates a file in
        ``THUNDER_TPU_FLIGHT_DIR``.  Returns the path written."""
        global _dump_seq
        if path is None:
            _dump_seq += 1
            path = os.path.join(
                flight_dump_dir(), f"tt_flight_{os.getpid()}_{_dump_seq}.json"
            )
        payload = self.snapshot(reason=reason, error=error)
        with open(path, "w") as f:
            json.dump(payload, f, indent=1, default=str)
        self.dumps += 1
        registry().counter("serving.flight.dumps").inc()
        return str(path)

    def crash_dump(self, error: BaseException) -> str | None:
        """The ``step()``-raised path: best-effort dump that must never
        mask the original exception.  Returns the path, or None when even
        the dump failed (counted + warned)."""
        try:
            path = self.dump(reason="crash", error=error)
        except Exception as e:
            registry().counter("serving.flight.dump_errors").inc()
            warnings.warn(
                f"flight-recorder crash dump failed ({e!r}); the original "
                f"engine error propagates unchanged", stacklevel=2,
            )
            return None
        warnings.warn(
            f"serving engine step() raised {type(error).__name__}; flight "
            f"record dumped to {path}", stacklevel=2,
        )
        return path
