"""Serving SLO monitor: windowed good/bad counters and burn-rate gauges.

Counterpart of ``thunder_tpu/observability/slo.py``, copied.

The SRE framing: an SLO is an objective ("95% of requests see TTFT under
200 ms"), the error budget is what the objective leaves on the table (5%),
and the **burn rate** is how fast recent traffic is spending that budget —
``bad_fraction_over_window / (1 - objective)``.  Burn rate 1.0 means the
window is exactly on budget; 2.0 means the budget burns twice as fast as
the objective allows (the classic page-on-burn-rate signal); 0 means the
window is clean.

:class:`SLOMonitor` watches four request-level dimensions, each optional:

- ``ttft_s``      — submit → first token (bad when above target, or when
  the request died without producing one);
- ``tpot_s``      — mean per-token latency after the first;
- ``queue_s``     — submit → admission;
- ``deadline``    — the request finished with reason ``"deadline"``.

Each observed request classifies good/bad per dimension over a bounded
window (deque), mirrors totals into ``serving.slo.<dim>.good``/``.bad``
counters and a ``serving.slo.<dim>.burn_rate`` gauge, and
:meth:`SLOMonitor.report` (surfaced as ``engine.slo_report()``) returns the
dashboard snapshot.  Pure host-side arithmetic per *finished* request —
nothing on the decode path — and engines build a monitor only when given an
``slo=`` config, so the default path never touches this module.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass

from thunder_tpu_torch.observability.metrics import registry

__all__ = ["SLOConfig", "SLOMonitor", "resolve_slo"]


@dataclass(frozen=True)
class SLOConfig:
    """Targets for the serving SLO dimensions; ``None`` disables a
    dimension.  ``objective`` is the good-fraction the SLO promises
    (shared across dimensions); ``window`` is how many recent requests the
    burn rate is computed over."""

    ttft_s: float | None = None
    tpot_s: float | None = None
    queue_s: float | None = None
    deadline_misses: bool = True
    objective: float = 0.95
    window: int = 256

    def __post_init__(self):
        if not (0.0 < self.objective < 1.0):
            raise ValueError(f"objective must be in (0, 1), got {self.objective}")
        if self.window < 1:
            raise ValueError(f"window must be >= 1, got {self.window}")


def resolve_slo(slo) -> "SLOMonitor | None":
    """Engine-facing constructor: ``None`` → no monitor (zero overhead),
    ``True`` → default targets off but deadline misses tracked, a dict →
    :class:`SLOConfig` kwargs, or a ready config/monitor."""
    if slo is None or slo is False:
        return None
    if isinstance(slo, SLOMonitor):
        return slo
    if slo is True:
        slo = SLOConfig()
    elif isinstance(slo, dict):
        slo = SLOConfig(**slo)
    if not isinstance(slo, SLOConfig):
        raise TypeError(f"slo= expects None/True/dict/SLOConfig, got {type(slo).__name__}")
    return SLOMonitor(slo)


class SLOMonitor:
    """Windowed good/bad accounting + burn rates for one engine."""

    def __init__(self, config: SLOConfig):
        self.config = config
        self._dims: dict[str, float | None] = {}
        for f in ("ttft_s", "tpot_s", "queue_s"):
            if getattr(config, f) is not None:
                self._dims[f] = float(getattr(config, f))
        if config.deadline_misses:
            self._dims["deadline"] = None
        # per-dim bounded window of bad flags + lifetime totals
        self._window: dict[str, deque[bool]] = {
            d: deque(maxlen=config.window) for d in self._dims
        }
        self._good = {d: 0 for d in self._dims}
        self._bad = {d: 0 for d in self._dims}

    def _classify(self, dim: str, result) -> bool:
        """True = bad.  A missing latency (the request died before the
        measurement existed) counts bad: the user never got the token."""
        if result.finish_reason == "error":
            # a quarantined request is a bad event on every dim — the user
            # got an error, whatever the partial latencies say
            return True
        if dim == "deadline":
            return result.finish_reason == "deadline"
        value = getattr(result, dim)
        if value is None:
            return True
        return value > self._dims[dim]

    def observe(self, result) -> None:
        """Classifies one finished request (a ``RequestResult`` or anything
        with the same latency attributes) across every configured dim."""
        reg = registry()
        for dim in self._dims:
            bad = self._classify(dim, result)
            self._window[dim].append(bad)
            if bad:
                self._bad[dim] += 1
            else:
                self._good[dim] += 1
            reg.counter(f"serving.slo.{dim}.bad" if bad else f"serving.slo.{dim}.good").inc()
            reg.gauge(f"serving.slo.{dim}.burn_rate").set(self.burn_rate(dim))

    def window_bad_fraction(self, dim: str) -> float | None:
        w = self._window[dim]
        if not w:
            return None
        return sum(w) / len(w)

    def burn_rate(self, dim: str) -> float | None:
        """``bad_fraction / error_budget`` over the window; None before the
        first observation."""
        frac = self.window_bad_fraction(dim)
        if frac is None:
            return None
        return frac / (1.0 - self.config.objective)

    def report(self) -> dict:
        """The ``engine.slo_report()`` snapshot."""
        out = {
            "enabled": True,
            "objective": self.config.objective,
            "window": self.config.window,
            "dimensions": {},
        }
        for dim in self._dims:
            burn = self.burn_rate(dim)
            out["dimensions"][dim] = {
                "target_s": self._dims[dim],
                "good": self._good[dim],
                "bad": self._bad[dim],
                "window_n": len(self._window[dim]),
                "window_bad_fraction": self.window_bad_fraction(dim),
                "burn_rate": burn,
                # on-budget = the window is not burning faster than the
                # objective allows (None = no traffic yet, trivially true)
                "on_budget": burn is None or burn <= 1.0,
            }
        return out
