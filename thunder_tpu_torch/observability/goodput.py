"""Serving goodput ledger: exact device-work attribution.

Counterpart of ``thunder_tpu/observability/goodput.py``, copied.

Every serving program dispatch performs ``rows x positions`` token-position
slots of device work: a prefill bucket is ``1 x Tb``, a decode visit is
``Bb x 1``, a multi-step visit ``Bb x N``, a draft round ``Bb x K`` plus a
``Bb x (K+1)`` verify.  Only some of those slots become tokens a user
streams; the rest is the price of static shapes, speculation, and replay.
The :class:`GoodputLedger` classifies **every** slot into exactly one
bucket -- ``committed`` or one of :data:`WASTE_CAUSES` -- and enforces the
per-dispatch conservation law

    ``committed + sum(waste) == rows * positions``

as exact integer arithmetic, so the report is an identity, not a sample.

The ledger is host-side only: it reads shapes, emit masks, and harvest
records the engine already holds and compiles **zero** new programs.  It
never enters the engine's steps, so ``goodput=True`` captures the same
graphs as ``goodput=False``.

Waste taxonomy
--------------

``pad_row``
    Batch-bucket padding: decode/verify rows beyond the running requests.
``pad_prefill``
    Prompt-bucket padding: prefill positions beyond the real chunk.
``dead_scan_row``
    Device work for rows that were (or went) dead before their tokens
    could stream: multi-step scan iterations frozen after a row's stop
    position, rows that finished or were discarded while the dispatch was
    in flight, and speculative positions accepted by verify but trimmed
    by an EOS/length finish before streaming.
``draft_rejected``
    Speculative positions the verifier rejected: drafted-but-rejected
    slots on the draft program plus unused verify positions.
``replay_recovery``
    Re-prefill replay after fault recovery (arena rebuild).
``replay_preemption``
    Re-prefill replay after a priority preemption resume.
``replay_session_tail``
    Session re-attach recomputing the parked turn's un-shared tail.
``replay_window``
    Replayed positions routed to the sink block because their KV fell
    outside the attention window (recomputed but never attended).

Committed semantics: real (non-replay) prefill positions count as
``committed`` -- building fresh KV is the useful work of the prefill
phase -- while decode-family committed slots are exactly the tokens
streamed to a user.  ``committed_tokens`` tracks the streamed-token count
separately so ``token_goodput_frac`` answers "what fraction of all device
slots became output tokens".  On the draft program, accepted positions are
counted from the verifier's acceptance length (trim-independent), so the
ledger's acceptance ratio reproduces the engine's
``spec_accepted_tokens / spec_draft_tokens`` integers exactly.
"""
from __future__ import annotations

from dataclasses import dataclass

from thunder_tpu_torch.observability.metrics import registry

__all__ = [
    "WASTE_CAUSES",
    "REPLAY_CAUSES",
    "ConservationError",
    "GoodputConfig",
    "GoodputLedger",
    "resolve_goodput",
    "fleet_goodput",
]

#: Every non-committed bucket a device token-position slot can land in.
WASTE_CAUSES = (
    "pad_row",
    "pad_prefill",
    "dead_scan_row",
    "draft_rejected",
    "replay_recovery",
    "replay_preemption",
    "replay_session_tail",
    "replay_window",
)

#: The causes attached to re-prefill replay (request-visible recompute).
REPLAY_CAUSES = (
    "replay_recovery",
    "replay_preemption",
    "replay_session_tail",
    "replay_window",
)


class ConservationError(AssertionError):
    """A dispatch's buckets did not sum to ``rows * positions``."""


@dataclass(frozen=True)
class GoodputConfig:
    """Knobs for the ledger.

    strict: raise :class:`ConservationError` on a per-dispatch
        conservation violation (default).  When False the violation is
        counted in ``violations`` and the dispatch is still recorded.
    device_time: attribute wall-clock dispatch->harvest seconds to each
        program kind from the records' existing span timings.
    """

    strict: bool = True
    device_time: bool = True


def _kind_entry():
    return {
        "dispatches": 0,
        "positions": 0,
        "committed": 0,
        "device_s": 0.0,
        "waste": dict.fromkeys(WASTE_CAUSES, 0),
    }


class GoodputLedger:
    """Exact host-side classification of dispatched device slots."""

    def __init__(self, config: GoodputConfig | None = None):
        self.config = config or GoodputConfig()
        self.dispatches = 0
        self.positions = 0
        self.committed = 0
        self.committed_tokens = 0
        self.violations = 0
        self.waste = dict.fromkeys(WASTE_CAUSES, 0)
        self.per_kind: dict[str, dict] = {}
        # paged-attention block-walk accounting (the ragged-decode
        # visibility figure): bucketed vs actually-streamed block counts,
        # aggregated and per program kind.  Blocks are not token-position
        # slots, so these NEVER enter the conservation law above.
        self.blocks_walked = 0
        self.blocks_real = 0
        self.blocks_per_kind: dict[str, dict] = {}
        reg = registry()
        self._m_positions = reg.counter("serving.goodput.positions")
        self._m_committed = reg.counter("serving.goodput.committed_positions")
        self._m_tokens = reg.counter("serving.goodput.committed_tokens")
        self._m_frac = reg.gauge("serving.goodput.frac")
        self._m_waste = {
            c: reg.counter(f"serving.goodput.waste.{c}") for c in WASTE_CAUSES
        }
        self._m_blocks_walked = reg.counter("serving.goodput.blocks_walked")
        self._m_blocks_real = reg.counter("serving.goodput.blocks_real")
        self._m_blocks_frac = reg.gauge("serving.goodput.blocks_real_frac")

    # -- accumulation -----------------------------------------------------

    def account(self, kind: str, rows: int, positions: int, *,
                committed: int = 0, **waste: int) -> dict:
        """Record one dispatch of ``rows x positions`` slots.

        ``waste`` maps cause names (members of :data:`WASTE_CAUSES`) to
        slot counts.  Enforces the conservation law and returns a compact
        tag dict (kind/rows/positions/committed + non-zero causes) for
        flight-recorder events and span ends.
        """
        total = int(rows) * int(positions)
        wsum = 0
        for cause, n in waste.items():
            if cause not in self.waste:
                raise KeyError(f"unknown waste cause {cause!r}; "
                               f"expected one of {WASTE_CAUSES}")
            n = int(n)
            if n < 0:
                raise ValueError(f"negative waste count {cause}={n}")
            wsum += n
        committed = int(committed)
        if committed + wsum != total:
            if self.config.strict:
                raise ConservationError(
                    f"goodput conservation violated for {kind}: "
                    f"committed={committed} + waste={wsum} != "
                    f"{rows}x{positions}={total} ({dict(waste)})")
            self.violations += 1

        self.dispatches += 1
        self.positions += total
        self.committed += committed
        ent = self.per_kind.get(kind)
        if ent is None:
            ent = self.per_kind[kind] = _kind_entry()
        ent["dispatches"] += 1
        ent["positions"] += total
        ent["committed"] += committed
        tag = {"kind": kind, "rows": int(rows), "positions": int(positions),
               "committed": committed}
        for cause, n in waste.items():
            n = int(n)
            if n:
                self.waste[cause] += n
                ent["waste"][cause] += n
                self._m_waste[cause].inc(n)
                tag[cause] = n
        self._m_positions.inc(total)
        self._m_committed.inc(committed)
        if self.positions:
            self._m_frac.set(self.committed / self.positions)
        return tag

    def commit_tokens(self, n: int) -> None:
        """Count ``n`` tokens actually streamed to users."""
        if n:
            self.committed_tokens += int(n)
            self._m_tokens.inc(int(n))

    def note_blocks(self, kind: str, walked: int, real: int) -> None:
        """Record one paged-attention dispatch's block-walk widths.

        ``walked`` is the bucketed count the compiled grid iterates
        (``rows x nbb x steps``); ``real`` is the count the ragged clamp
        actually streams from the arena (per-row ``ceil(pos / block_size)``,
        clamped to ``[1, nbb]``).  ``walked - real`` block-loads is exactly
        what ragged decode saves over bucketed walking — a visibility
        figure beside the slot ledger, never part of the conservation law.
        """
        walked, real = int(walked), int(real)
        if walked < real:
            raise ValueError(f"blocks_real={real} exceeds walked={walked}")
        self.blocks_walked += walked
        self.blocks_real += real
        ent = self.blocks_per_kind.setdefault(
            kind, {"dispatches": 0, "walked": 0, "real": 0})
        ent["dispatches"] += 1
        ent["walked"] += walked
        ent["real"] += real
        self._m_blocks_walked.inc(walked)
        self._m_blocks_real.inc(real)
        if self.blocks_walked:
            self._m_blocks_frac.set(self.blocks_real / self.blocks_walked)

    def note_device_s(self, kind: str, seconds: float) -> None:
        """Attribute dispatch->harvest wall seconds to a program kind."""
        if not self.config.device_time:
            return
        ent = self.per_kind.get(kind)
        if ent is None:
            ent = self.per_kind[kind] = _kind_entry()
        ent["device_s"] += float(seconds)

    # -- views ------------------------------------------------------------

    def snapshot(self) -> dict:
        """Compact integers for ``stats()["goodput"]`` (aggregatable)."""
        return {
            "dispatches": self.dispatches,
            "positions": self.positions,
            "committed": self.committed,
            "committed_tokens": self.committed_tokens,
            "goodput_frac": (self.committed / self.positions
                             if self.positions else 0.0),
            "token_goodput_frac": (self.committed_tokens / self.positions
                                   if self.positions else 0.0),
            "waste": {c: n for c, n in self.waste.items() if n},
            "violations": self.violations,
            "blocks": {
                "walked": self.blocks_walked,
                "real": self.blocks_real,
                "real_frac": (self.blocks_real / self.blocks_walked
                              if self.blocks_walked else None),
            },
        }

    def report(self) -> dict:
        """Full report: snapshot + per-kind breakdowns with device-time
        attribution (wasted seconds = kind seconds x kind waste frac)."""
        rep = self.snapshot()
        per_kind = {}
        for kind, ent in sorted(self.per_kind.items()):
            waste = {c: n for c, n in ent["waste"].items() if n}
            frac = (ent["committed"] / ent["positions"]
                    if ent["positions"] else 0.0)
            row = {
                "dispatches": ent["dispatches"],
                "positions": ent["positions"],
                "committed": ent["committed"],
                "goodput_frac": frac,
                "waste": waste,
            }
            if self.config.device_time:
                row["device_s"] = ent["device_s"]
                row["wasted_device_s"] = ent["device_s"] * (1.0 - frac)
            per_kind[kind] = row
        rep["per_kind"] = per_kind
        if self.blocks_per_kind:
            rep["blocks_per_kind"] = {
                kind: {**ent,
                       "real_frac": (ent["real"] / ent["walked"]
                                     if ent["walked"] else None)}
                for kind, ent in sorted(self.blocks_per_kind.items())
            }
        if self.config.device_time:
            rep["device_s"] = sum(e["device_s"] for e in self.per_kind.values())
            rep["wasted_device_s"] = sum(
                v.get("wasted_device_s", 0.0) for v in per_kind.values())
        return rep

    def brief(self) -> dict:
        """One-line view for flight-recorder lane state."""
        return {
            "positions": self.positions,
            "committed": self.committed,
            "goodput_frac": (self.committed / self.positions
                             if self.positions else 0.0),
        }


def resolve_goodput(spec) -> GoodputLedger | None:
    """Normalize the engine's ``goodput=`` knob.

    None/False -> off (no ledger object at all, the byte-identical
    off-path); True -> default config; a :class:`GoodputConfig`, kwargs
    dict, or pre-built ledger are accepted as-is.
    """
    if spec is None or spec is False:
        return None
    if spec is True:
        return GoodputLedger(GoodputConfig())
    if isinstance(spec, GoodputConfig):
        return GoodputLedger(spec)
    if isinstance(spec, GoodputLedger):
        return spec
    if isinstance(spec, dict):
        return GoodputLedger(GoodputConfig(**spec))
    raise TypeError(f"goodput must be bool, GoodputConfig, dict, or "
                    f"GoodputLedger, got {type(spec).__name__}")


def fleet_goodput(snaps: list[dict]) -> dict:
    """Aggregate per-lane ``snapshot()`` dicts into a fleet view.

    Sums the integer buckets and adds a committed-work imbalance figure:
    ``(max - min) / mean`` over per-lane committed positions -- the
    signal ROADMAP's work-stealing item needs to justify itself.
    """
    waste: dict[str, int] = {}
    for s in snaps:
        for c, n in s.get("waste", {}).items():
            waste[c] = waste.get(c, 0) + n
    walked = sum(s.get("blocks", {}).get("walked", 0) for s in snaps)
    real = sum(s.get("blocks", {}).get("real", 0) for s in snaps)
    positions = sum(s["positions"] for s in snaps)
    committed = sum(s["committed"] for s in snaps)
    per_lane = [s["committed"] for s in snaps]
    mean = (sum(per_lane) / len(per_lane)) if per_lane else 0.0
    return {
        "lanes": len(snaps),
        "dispatches": sum(s["dispatches"] for s in snaps),
        "positions": positions,
        "committed": committed,
        "committed_tokens": sum(s["committed_tokens"] for s in snaps),
        "goodput_frac": committed / positions if positions else 0.0,
        "token_goodput_frac": (sum(s["committed_tokens"] for s in snaps)
                               / positions if positions else 0.0),
        "waste": waste,
        "violations": sum(s.get("violations", 0) for s in snaps),
        "blocks": {"walked": walked, "real": real,
                   "real_frac": (real / walked) if walked else None},
        "committed_per_lane": per_lane,
        "committed_imbalance": ((max(per_lane) - min(per_lane)) / mean
                                if per_lane and mean else 0.0),
    }
