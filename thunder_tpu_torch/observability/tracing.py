"""Serving-plane request-lifecycle tracing: async Chrome-trace spans.

Counterpart of ``thunder_tpu/observability/tracing.py``, copied; its
environment gate (:func:`serving_trace_env_enabled`) is read through
``observability/config.py``.

The compile-pipeline ring (``events.py``) answers "where did *compilation*
time go"; this module answers the serving question — where did *this
request's* time go.  A :class:`RequestTracer` emits Chrome-trace **async**
spans (``ph: "b"/"e"`` keyed by ``id=rid``) for every request phase:

- ``queued``     — submit → admission (or → finish, for requests that die
  in the queue);
- ``prefill``    — admission → first token on the host, annotated with
  ``compile`` (this run met a new bucket geometry) vs ``cached``, split into
  ``prefill.compile``/``prefill.dispatch`` and ``prefill.host``
  (device dispatch vs host materialization); a chunked prefill adds one
  ``prefill.chunk`` child span per intermediate piece;
- ``decode``     — one span per request per decode step (batched requests
  share wall time; each still gets its own span so a request's row reads
  start-to-finish), annotated with the step index; when the engine runs
  with ``goodput=True`` each decode-span end also carries the dispatch's
  goodput tag (committed slots + non-zero waste causes from
  :mod:`thunder_tpu_torch.observability.goodput`), so the timeline shows *which*
  steps burned device work on padding, dead rows, or rejected drafts;
- an instant ``finish``/``deadline``/``evicted``/``eos`` marker.

Spans from the async engine carry a ``lane`` arg (:data:`LANE_DECODE` /
:data:`LANE_PREFILL`) so a Perfetto query can split a request's time by
lane; under ``async_step=True`` a ``decode``/``prefill`` span covers
dispatch → harvest (the true token latency including the deliberately
deferred materialization), not just the host call.

Engine drive-loop work lands as synchronous ``engine.step`` spans on a
dedicated ``engine`` track.  Everything goes into the shared event ring, so
``events.export_chrome_trace(path)`` yields ONE Perfetto timeline where the
TTFT gap of any request decomposes visibly into queue wait vs cold compile
vs execute, next to the compile-pipeline rows.

Serving events carry ``cat="serving.request"`` / ``"serving.engine"`` and a
synthetic pid offset so the exporter names their process row
"thunder_tpu_torch serving" instead of letting request spans masquerade as
compile work; each request gets an ``rid``-named track.

Off by default: engines construct a tracer only under
``trace=True`` / ``THUNDER_TPU_TRACE_SERVING=1``, and the untraced path
never touches this module at call time.
"""
from __future__ import annotations

import os

from thunder_tpu_torch.observability.config import serving_trace_env_enabled
from thunder_tpu_torch.observability.events import (
    record_event,
    register_process_name,
    register_thread_name,
)

__all__ = ["RequestTracer", "serving_pid", "serving_trace_env_enabled", "ENGINE_TID",
           "REQUEST_TID_BASE", "LANE_DECODE", "LANE_PREFILL"]

# synthetic display tracks: the serving process row is the real pid shifted
# into a namespace no OS pid collides with (Linux pid_max < 2**22)
_SERVING_PID_OFFSET = 1 << 24
ENGINE_TID = 0
REQUEST_TID_BASE = 1

# lane tags the async engine stamps on lifecycle spans (span arg "lane")
LANE_DECODE = "decode"
LANE_PREFILL = "prefill"


def serving_pid() -> int:
    """The synthetic pid serving events display under."""
    return os.getpid() + _SERVING_PID_OFFSET


class RequestTracer:
    """Emits request-lifecycle spans into the shared event ring.

    All methods are cheap host-side appends (one ``perf_counter_ns`` +
    deque append each); the engine holds ``None`` instead of a tracer when
    tracing is off, so the off path costs one ``is None`` check."""

    CAT_REQUEST = "serving.request"
    CAT_ENGINE = "serving.engine"

    def __init__(self, engine_label: str = "engine"):
        self._pid = serving_pid()
        register_process_name(self._pid, "thunder_tpu_torch serving")
        register_thread_name(self._pid, ENGINE_TID, engine_label)

    def _tid(self, rid: int) -> int:
        return REQUEST_TID_BASE + rid

    def register_request(self, rid: int) -> None:
        """Names the request's display track (``req {rid}``)."""
        register_thread_name(self._pid, self._tid(rid), f"req {rid}")

    #
    # request-phase async spans (keyed by id=rid: one async track per
    # request in Perfetto, independent of which host thread drove the step)
    #

    def begin(self, rid: int, phase: str, **args) -> None:
        record_event("b", phase, args or None, cat=self.CAT_REQUEST,
                     pid=self._pid, tid=self._tid(rid), id=rid)

    def end(self, rid: int, phase: str, **args) -> None:
        record_event("e", phase, args or None, cat=self.CAT_REQUEST,
                     pid=self._pid, tid=self._tid(rid), id=rid)

    def instant(self, rid: int, name: str, **args) -> None:
        record_event("n", name, args or None, cat=self.CAT_REQUEST,
                     pid=self._pid, tid=self._tid(rid), id=rid)

    #
    # engine drive-loop spans (synchronous, one shared track)
    #

    def engine_begin(self, name: str, **args) -> None:
        record_event("B", name, args or None, cat=self.CAT_ENGINE,
                     pid=self._pid, tid=ENGINE_TID)

    def engine_end(self, name: str, **args) -> None:
        record_event("E", name, args or None, cat=self.CAT_ENGINE,
                     pid=self._pid, tid=ENGINE_TID)
