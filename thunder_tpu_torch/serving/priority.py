"""Priority classes, SLO-feedback admission, and evict-and-resume preemption.

Counterpart of ``thunder_tpu/serving/priority.py``, whole.
``serve(..., priorities=True)`` turns the strict-FIFO queue into a
class-ordered one: ``submit(..., priority="high"|"normal"|"low")`` tags
each request with a level (lower = more urgent); the scheduler inserts by
level with FIFO order preserved within a class.  Two mechanisms keep the
latency-critical class honest under load:

**SLO-feedback admission.**  The engine's SLO monitor computes windowed
burn rates (``bad_fraction / error_budget``) per latency dimension.  The
:class:`PriorityGate` turns those into per-class admission: when the worst
burn rate crosses a class's limit, that class is deferred at the admission
gate (the requests stay queued, more urgent classes keep flowing, and
admission resumes as soon as the window recovers).  ``high`` has no limit.

**Evict-and-resume preemption.**  When the queue head is strictly more
urgent than a running request and the pool cannot fund it, the engine
checkpoints the victim at its current position: prompt and generated
tokens are host state, and the victim's ``torch.Generator`` goes back to
the state the engine saved at its last harvest (a port generator advances
when a step draws, at dispatch, so a step still in flight may have drawn
for it; that step's record for the victim is dropped by its preemption
epoch).  The checkpoint is then "release the blocks and re-queue".  On
re-admission the victim's sequence is rebuilt through the sampling-free
chunk steps, bucket-wide pieces, and decode continues with the same
generator state, so a preempted-then-resumed stream is the undisturbed
run's.  With ``goodput=True`` the engine charges every replayed position
to the ``replay_preemption`` waste cause and bills the victim's
:class:`RequestResult` (``tokens_recomputed`` / ``recompute_causes``).

With ``priorities=None`` (default) nothing changes: every request takes
the same level, insertion degrades to append, and the gate never runs.
"""

from __future__ import annotations

import dataclasses

__all__ = [
    "PRIORITY_LEVELS",
    "PRIORITY_HIGH",
    "PRIORITY_NORMAL",
    "PRIORITY_LOW",
    "PriorityConfig",
    "PriorityGate",
    "priority_level",
    "resolve_priorities",
]

# Lower level = more urgent; "normal" is the engine-wide default and the
# level every request carries when priorities are disabled.
PRIORITY_HIGH = "high"
PRIORITY_NORMAL = "normal"
PRIORITY_LOW = "low"
PRIORITY_LEVELS: dict[str, int] = {
    PRIORITY_HIGH: 0,
    PRIORITY_NORMAL: 1,
    PRIORITY_LOW: 2,
}


@dataclasses.dataclass
class PriorityConfig:
    """Knobs for the admission gate and preemption.

    ``burn_limits`` maps a class name to the burn-rate threshold above
    which the class is deferred at admission (a burn rate of 1.0 means
    the window is consuming its error budget exactly at the objective
    rate).  Classes without an entry are never deferred.  ``preempt``
    turns evict-and-resume on; ``max_preemptions`` bounds how many times
    one request may be victimized (after that it is left to finish, so a
    busy high class cannot starve a low request forever).
    """

    burn_limits: dict[str, float] = dataclasses.field(
        default_factory=lambda: {PRIORITY_LOW: 1.0, PRIORITY_NORMAL: 4.0})
    preempt: bool = True
    max_preemptions: int = 8

    def __post_init__(self):
        for cls, lim in self.burn_limits.items():
            if cls not in PRIORITY_LEVELS:
                raise ValueError(
                    f"unknown priority class {cls!r} in burn_limits "
                    f"(expected one of {sorted(PRIORITY_LEVELS)})")
            if lim < 0:
                raise ValueError(f"burn limit for {cls!r} must be >= 0")
        if self.max_preemptions < 0:
            raise ValueError("max_preemptions must be >= 0")


def resolve_priorities(spec) -> "PriorityGate | None":
    """``priorities=`` engine kwarg → a :class:`PriorityGate` (or None)."""
    if spec is None or spec is False:
        return None
    if spec is True:
        cfg = PriorityConfig()
    elif isinstance(spec, PriorityConfig):
        cfg = spec
    elif isinstance(spec, dict):
        cfg = PriorityConfig(**spec)
    else:
        raise TypeError(
            f"priorities= must be None, True, a dict, or PriorityConfig; "
            f"got {type(spec).__name__}")
    return PriorityGate(cfg)


def priority_level(priority: str | None) -> tuple[str, int]:
    """Normalize a ``submit(priority=)`` value to ``(class, level)``."""
    cls = PRIORITY_NORMAL if priority is None else str(priority)
    if cls not in PRIORITY_LEVELS:
        raise ValueError(
            f"priority must be one of {sorted(PRIORITY_LEVELS)}, got {cls!r}")
    return cls, PRIORITY_LEVELS[cls]


class PriorityGate:
    """Per-class admission policy fed by SLO burn rates."""

    def __init__(self, config: PriorityConfig | None = None):
        self.config = config or PriorityConfig()
        self.deferrals: dict[str, int] = {c: 0 for c in PRIORITY_LEVELS}

    def admit_ok(self, priority_class: str, slo_monitor) -> bool:
        """May a request of this class be admitted right now?

        Consults the worst burn rate across the monitor's dimensions;
        with no monitor (``slo=None``) the gate is inert and always
        admits.
        """
        limit = self.config.burn_limits.get(priority_class)
        if limit is None or slo_monitor is None:
            return True
        burns = (slo_monitor.burn_rate(dim) for dim in slo_monitor._dims)
        worst = max((b for b in burns if b is not None), default=0.0)
        if worst > limit:
            self.deferrals[priority_class] = self.deferrals.get(priority_class, 0) + 1
            return False
        return True

    def pick_victim(self, running, head_level: int):
        """Choose the request to preempt for a head at ``head_level``.

        The victim is the least-urgent running request (ties broken by
        most-recent admission — the cheapest checkpoint to redo), and
        must be *strictly* less urgent than the head; requests already
        preempted ``max_preemptions`` times are exempt.
        """
        if not self.config.preempt:
            return None
        candidates = [r for r in running
                      if r.priority > head_level
                      and r.preemptions < self.config.max_preemptions]
        if not candidates:
            return None
        return max(candidates, key=lambda r: (r.priority, r.admit_t or 0.0))

    def snapshot(self) -> dict:
        return {
            "preempt": self.config.preempt,
            "burn_limits": dict(self.config.burn_limits),
            "deferrals": dict(self.deferrals),
        }
