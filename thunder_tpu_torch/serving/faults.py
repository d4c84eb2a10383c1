"""Deterministic fault injection + retry/recovery policy.

Counterpart of ``thunder_tpu/serving/faults.py``, copied whole so the port
imports nothing of the JAX package.  The serving engine passes the
``prefill.dispatch``, ``decode.dispatch``, ``draft.dispatch``,
``verify.dispatch``, ``harvest`` and ``scatter`` points (a step's kernels
write the arenas in place, so a fault at ``scatter`` or ``harvest`` is past
the point of no return and recovers); the training loop passes
``train.step`` and the checkpointer ``checkpoint.save``.

- **Fault kinds** map to exception classes classified by blast radius:
  ``"fail"`` → :class:`TransientDispatchFault` (retryable), ``"nan"`` →
  :class:`RequestAnomalyFault` (per-request poison), ``"oom"`` →
  :class:`DeviceOOMFault` and ``"hang"`` → :class:`HarvestHangFault`
  (engine-wide).  A real ``torch.OutOfMemoryError`` says "out of memory"
  and classes as ``engine``, like the XLA ``RESOURCE_EXHAUSTED`` it stands
  for.
- A :class:`FaultPlan` is **deterministic**: an explicit list of
  :class:`FaultSpec` rows (fire at the ``at``-th arrival of a point,
  optionally only for a given rid) and/or a seeded random mode (``seed=``,
  ``rate=``), bounded by ``max_faults`` so any plan eventually allows
  progress.  Checks are pure host arithmetic; an unarmed caller holds
  ``None`` and pays one ``is None`` test per fault point.
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Sequence

import numpy as np

from thunder_tpu_torch.observability.metrics import registry

__all__ = [
    "FP_PREFILL",
    "FP_DECODE",
    "FP_DRAFT",
    "FP_VERIFY",
    "FP_HARVEST",
    "FP_SCATTER",
    "FP_TRAIN_STEP",
    "FP_CKPT_SAVE",
    "FAULT_POINTS",
    "FAULT_KINDS",
    "FaultSpec",
    "FaultPlan",
    "FaultError",
    "TransientDispatchFault",
    "RequestAnomalyFault",
    "DeviceOOMFault",
    "HarvestHangFault",
    "WatchdogTimeout",
    "RecoveryError",
    "RetryPolicy",
    "classify_fault",
    "fault_cause",
    "resolve_fault_plan",
]

# named fault points — where the event loop touches the device.  The
# speculative lane adds two dispatch sites: FP_DRAFT before the draft
# program and FP_VERIFY between draft and verify — both pre-donation (the
# draft rerun is deterministic and ``_spec_state`` only advances at
# harvest), so they retry/quarantine/recover exactly like FP_DECODE.
FP_PREFILL = "prefill.dispatch"
FP_DECODE = "decode.dispatch"
FP_DRAFT = "draft.dispatch"
FP_VERIFY = "verify.dispatch"
FP_HARVEST = "harvest"
FP_SCATTER = "scatter"
# training-plane fault points (thunder_tpu.train.loop / train.checkpoint):
# FP_TRAIN_STEP fires before the train-step dispatch (params/opt state
# intact, so transient faults retry the same step) and FP_CKPT_SAVE inside
# the async checkpoint worker (a failed save surfaces as a harvest record,
# never into the step path)
FP_TRAIN_STEP = "train.step"
FP_CKPT_SAVE = "checkpoint.save"
FAULT_POINTS = (FP_PREFILL, FP_DECODE, FP_DRAFT, FP_VERIFY, FP_HARVEST, FP_SCATTER,
                FP_TRAIN_STEP, FP_CKPT_SAVE)

FAULT_KINDS = ("fail", "nan", "oom", "hang")

# blast-radius classes the engine's _absorb_fault switches on
CLASS_REQUEST = "request"      # poison request → quarantine, keep serving
CLASS_TRANSIENT = "transient"  # retryable dispatch failure → backoff + retry
CLASS_ENGINE = "engine"        # device-wide → rebuild arenas + re-prefill


class FaultError(RuntimeError):
    """Base of every injected (or watchdog-synthesized) serving fault.

    Carries the structured cause the quarantine/recovery machinery threads
    into ``RequestResult.error``, flight-recorder entries, and telemetry:
    ``point`` (which fault point raised), ``kind``, ``rids`` (the requests
    in flight at the point), and ``injected`` (False for watchdog/real)."""

    kind = "fail"

    def __init__(self, point: str, rids: Sequence[int] = (), *,
                 injected: bool = True, message: str | None = None):
        self.point = point
        self.rids = tuple(int(r) for r in rids)
        self.injected = injected
        super().__init__(
            message if message is not None else
            f"injected {self.kind!r} fault at {point} (rids={list(self.rids)})"
        )

    def cause(self) -> dict:
        """The structured cause dict (JSON-safe) this fault propagates."""
        return {
            "type": type(self).__name__,
            "point": self.point,
            "kind": self.kind,
            "rids": list(self.rids),
            "injected": self.injected,
            "message": str(self),
        }


class TransientDispatchFault(FaultError):
    """A dispatch failed in a way worth retrying (the injected analogue of
    a transient RPC error out of the runtime)."""

    kind = "fail"


class RequestAnomalyFault(FaultError):
    """A request poisoned its own step (the injected analogue of a NaN/Inf
    anomaly traced to one request's math) — quarantine it, keep the rest."""

    kind = "nan"


class DeviceOOMFault(FaultError):
    """Device memory exhausted mid-step: the arenas are suspect, so the only
    way forward is arena rebuild + re-prefill."""

    kind = "oom"


class HarvestHangFault(FaultError):
    """Injectable stand-in for a harvest that never completes.  A real hang
    cannot raise; the engine's watchdog (``watchdog_timeout_s``) converts it
    to :class:`WatchdogTimeout` — both land in the same recovery path."""

    kind = "hang"


class WatchdogTimeout(FaultError):
    """An in-flight record aged past ``watchdog_timeout_s`` on the engine
    clock without being harvested: treat the step as lost and recover."""

    kind = "hang"

    def __init__(self, point: str, rids: Sequence[int] = (), *,
                 age_s: float | None = None):
        self.age_s = age_s
        super().__init__(
            point, rids, injected=False,
            message=(f"watchdog: in-flight {point} record aged "
                     f"{age_s:.3f}s past the timeout (rids={[int(r) for r in rids]})"
                     if age_s is not None else
                     f"watchdog: in-flight {point} record timed out"),
        )


class RecoveryError(RuntimeError):
    """Re-prefill recovery could not complete within the retry budget; the
    engine is not serviceable (carries the last underlying fault as
    ``__cause__``)."""


_KIND_EXC = {
    "fail": TransientDispatchFault,
    "nan": RequestAnomalyFault,
    "oom": DeviceOOMFault,
    "hang": HarvestHangFault,
}

# message fragments that classify *real* runtime exceptions the same way
# injected ones are: transient RPC-ish failures retry, allocation failures
# force an arena rebuild (the strings are the jax/XLA status-code surface)
_TRANSIENT_MARKERS = ("DEADLINE_EXCEEDED", "UNAVAILABLE", "ABORTED")
_ENGINE_MARKERS = ("RESOURCE_EXHAUSTED", "out of memory", "Out of memory")


def classify_fault(exc: BaseException) -> str | None:
    """Blast-radius class of an exception out of ``step()``:
    ``"request"`` / ``"transient"`` / ``"engine"``, or ``None`` for
    anything the recovery layer must not absorb (programming errors keep
    the existing crash-dump-and-raise contract)."""
    if isinstance(exc, RequestAnomalyFault):
        return CLASS_REQUEST
    if isinstance(exc, TransientDispatchFault):
        return CLASS_TRANSIENT
    if isinstance(exc, (DeviceOOMFault, HarvestHangFault, WatchdogTimeout)):
        return CLASS_ENGINE
    # NOTE: a real AnomalyError (debug_anomalies mode) stays un-absorbed on
    # purpose — the user armed that check to crash with symbol attribution,
    # and silently recovering would defeat the debugging tool.
    msg = str(exc)
    if any(m in msg for m in _TRANSIENT_MARKERS):
        return CLASS_TRANSIENT
    if any(m in msg for m in _ENGINE_MARKERS):
        return CLASS_ENGINE
    return None


def fault_cause(exc: BaseException) -> dict:
    """Structured cause for any classified exception (FaultErrors carry
    their own; real exceptions get a best-effort envelope)."""
    if isinstance(exc, FaultError):
        return exc.cause()
    return {
        "type": type(exc).__name__,
        "point": None,
        "kind": classify_fault(exc),
        "rids": [],
        "injected": False,
        "message": str(exc),
    }


@dataclass(frozen=True)
class FaultSpec:
    """One deterministic fault: fire at the ``at``-th (1-based) arrival of
    ``point`` — counted over arrivals matching ``rid`` when set — for
    ``count`` consecutive arrivals.  ``kind`` picks the exception class."""

    point: str
    kind: str = "fail"
    at: int = 1
    rid: int | None = None
    count: int = 1

    def __post_init__(self):
        if self.point not in FAULT_POINTS:
            raise ValueError(f"unknown fault point {self.point!r}; expected one of {FAULT_POINTS}")
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; expected one of {FAULT_KINDS}")
        if self.at < 1 or self.count < 1:
            raise ValueError(f"at/count must be >= 1, got at={self.at} count={self.count}")


@dataclass
class FaultPlan:
    """A deterministic schedule of injected faults.

    Two modes, composable: explicit ``specs`` fire by arrival count, and a
    seeded random mode (``seed`` + ``rate``) flips a biased coin per check —
    the same seed always yields the same fault sequence for the same
    workload.  ``max_faults`` bounds *total* injections (both modes), so any
    plan eventually stops interfering — the recovery guarantee ("drained
    tokens bit-identical to the fault-free run") is only meaningful for
    plans that allow progress."""

    specs: Sequence[FaultSpec] = ()
    seed: int | None = None
    rate: float = 0.0
    kinds: Sequence[str] = ("fail", "nan", "oom", "hang")
    max_faults: int = 8

    def __post_init__(self):
        self.specs = tuple(
            s if isinstance(s, FaultSpec) else FaultSpec(**s) for s in self.specs
        )
        for k in self.kinds:
            if k not in FAULT_KINDS:
                raise ValueError(f"unknown fault kind {k!r}; expected one of {FAULT_KINDS}")
        if not (0.0 <= float(self.rate) <= 1.0):
            raise ValueError(f"rate must be in [0, 1], got {self.rate}")
        self._rng = np.random.default_rng(self.seed) if self.seed is not None else None
        self._arrivals: dict = {}          # (point, rid-constraint) -> count
        self.injected = 0
        self.fired: list[dict] = []

    def _spec_matches(self, spec: FaultSpec, point: str, rids: Sequence[int]) -> bool:
        if spec.point != point:
            return False
        if spec.rid is not None and spec.rid not in rids:
            return False
        n = self._arrivals[(spec.point, spec.rid)]
        return spec.at <= n < spec.at + spec.count

    def check(self, point: str, rids: Sequence[int] = ()) -> None:
        """Called by the engine at each fault point; raises the scheduled
        fault (counted in ``serving.faults.injected``) or returns."""
        if self.injected >= self.max_faults:
            return
        rids = tuple(int(r) for r in rids)
        seen = set()
        for spec in self.specs:
            k = (spec.point, spec.rid)
            if k not in seen and (spec.rid is None or spec.rid in rids) and spec.point == point:
                self._arrivals[k] = self._arrivals.get(k, 0) + 1
                seen.add(k)
        for spec in self.specs:
            if self._spec_matches(spec, point, rids):
                # a rid-pinned anomaly blames exactly that request — the
                # quarantine blast radius is the poison request, never the
                # batch it happened to share a step with
                self._fire(spec.kind, point,
                           rids if spec.rid is None else (spec.rid,))
        if self._rng is not None and self.rate > 0.0:
            if float(self._rng.random()) < self.rate:
                kinds = [k for k in self.kinds
                         # a per-request anomaly needs a request to blame
                         if not (k == "nan" and not rids)]
                if kinds:
                    kind = kinds[int(self._rng.integers(len(kinds)))]
                    blame = ((rids[int(self._rng.integers(len(rids)))],)
                             if kind == "nan" else rids)
                    self._fire(kind, point, blame)

    def _fire(self, kind: str, point: str, rids: tuple[int, ...]):
        self.injected += 1
        exc = _KIND_EXC[kind](point, rids)
        self.fired.append(exc.cause())
        registry().counter("serving.faults.injected").inc()
        try:
            raise exc
        finally:
            del exc            # no frame-exception cycle keeps the engine's frames alive

    def snapshot(self) -> dict:
        """Plan state for ``engine.stats()`` / the flight recorder."""
        return {
            "injected": self.injected,
            "max_faults": self.max_faults,
            "seed": self.seed,
            "rate": self.rate,
            "specs": len(self.specs),
            "fired": list(self.fired),
        }


@dataclass
class RetryPolicy:
    """Bounded retry with exponential backoff on an injectable sleep.

    ``backoff(attempt)`` (1-based) returns ``backoff_s * multiplier**(n-1)``;
    the engine sleeps that between transient-fault retries and recovery
    attempts.  Tests inject ``sleep=`` to record delays without waiting."""

    max_retries: int = 3
    backoff_s: float = 0.05
    multiplier: float = 2.0
    sleep: Callable[[float], None] = field(default=time.sleep)

    def __post_init__(self):
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {self.max_retries}")
        if self.backoff_s < 0 or self.multiplier < 1.0:
            raise ValueError(
                f"backoff_s must be >= 0 and multiplier >= 1, got "
                f"backoff_s={self.backoff_s} multiplier={self.multiplier}"
            )

    def backoff(self, attempt: int) -> float:
        return self.backoff_s * self.multiplier ** (max(int(attempt), 1) - 1)


def resolve_fault_plan(plan) -> FaultPlan | None:
    """Engine-facing constructor: ``None`` → the ``THUNDER_TPU_FAULT_PLAN``
    env JSON (or no plan), ``False`` → force-off, a :class:`FaultPlan` /
    :class:`FaultSpec` / dict of plan kwargs / list of specs → armed."""
    if plan is None:
        raw = os.getenv("THUNDER_TPU_FAULT_PLAN", "").strip()
        if not raw:
            return None
        plan = json.loads(raw)
    if plan is False:
        return None
    if isinstance(plan, FaultPlan):
        return plan
    if isinstance(plan, FaultSpec):
        return FaultPlan(specs=(plan,))
    if isinstance(plan, dict):
        if "specs" in plan or "seed" in plan or "rate" in plan:
            return FaultPlan(**plan)
        return FaultPlan(specs=(FaultSpec(**plan),))
    if isinstance(plan, (list, tuple)):
        return FaultPlan(specs=tuple(s if isinstance(s, FaultSpec) else FaultSpec(**s)
                                     for s in plan))
    raise TypeError(f"fault_plan= expects None/False/FaultPlan/FaultSpec/dict/list, "
                    f"got {type(plan).__name__}")
