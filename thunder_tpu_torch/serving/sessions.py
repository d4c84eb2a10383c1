"""Session KV persistence: finished turns keep their prefix blocks resident.

Counterpart of ``thunder_tpu/serving/sessions.py``.  A multi-turn chat
re-submits its whole history every turn; ``submit(..., session_id=)``
changes the lifetime of a request's K/V, not its computation.  When a
session turn finishes normally (length or EOS), the engine parks the
block-aligned prefix of the served sequence (prompt + generated tokens)
here instead of freeing it.  The table holds its own ``pool.share()``
references and registers the parked tokens in the engine's
:class:`~thunder_tpu_torch.serving.kv_pool.PrefixIndex` under a synthetic
negative owner id, so turn k >= 2 re-attaches through the engine's
shared-prefix admission and prefills only the block-unaligned tail.

Every parked prefix is registered under the ``tag`` of the K/V it holds
(the (slot, version) of the adapter factors it was computed with, None
without a LoRA registry), as the port's prefix index keys every prefix:
a later turn re-attaches only under the adapter its session was parked
with.

The table is budgeted: an LRU over sessions with a count cap and a bytes
cap (in units of ``pool.block_bytes()``).  Parking evicts the least
recently used sessions until the new entry fits; ``close()`` (and the
engine's ``close_session()``) releases explicitly, and the blocks return to
the free list at once.

Recovery: parked K/V lives in the arenas, which a fault zeroes.  Each
entry keeps the exact tokens its blocks hold; the engine's recovery replays
every resident session through the sampling-free chunk steps, the replay
that rebuilds running requests, so a later turn still re-attaches.
"""
from __future__ import annotations

import dataclasses
import itertools
from collections import OrderedDict

import numpy as np

from thunder_tpu_torch.observability.metrics import registry
from thunder_tpu_torch.serving.kv_pool import SINK_BLOCK

__all__ = ["SessionConfig", "SessionEntry", "SessionTable", "resolve_sessions"]


@dataclasses.dataclass
class SessionConfig:
    """Budget for the resident-session table.

    ``max_bytes=None`` defaults to half the pool's arena bytes at resolve
    time: sessions may cache, but never crowd live requests out of more
    than half the arena."""

    max_sessions: int = 64
    max_bytes: int | None = None

    def __post_init__(self):
        if self.max_sessions < 1:
            raise ValueError("max_sessions must be >= 1")
        if self.max_bytes is not None and self.max_bytes < 0:
            raise ValueError("max_bytes must be >= 0")


def resolve_sessions(spec, pool, prefix_index) -> "SessionTable | None":
    """``sessions=`` engine kwarg → a :class:`SessionTable` (or None).

    Accepts ``None``/``False`` (off), ``True`` (defaults), a dict of
    :class:`SessionConfig` fields, or a ready config."""
    if spec is None or spec is False:
        return None
    if spec is True:
        cfg = SessionConfig()
    elif isinstance(spec, SessionConfig):
        cfg = spec
    elif isinstance(spec, dict):
        cfg = SessionConfig(**spec)
    else:
        raise TypeError(f"sessions= must be None, True, a dict, or SessionConfig; "
                        f"got {type(spec).__name__}")
    return SessionTable(pool, prefix_index, cfg)


@dataclasses.dataclass
class SessionEntry:
    """One resident session: the tokens its parked blocks hold."""

    session_id: str
    owner_rid: int            # synthetic negative id in the PrefixIndex
    tokens: np.ndarray        # exactly len(blocks) * block_size tokens
    blocks: tuple[int, ...]   # table-held pool.share() references
    adapter_slot: int         # LoRA slot the K/V was computed under
    nbytes: int
    # cache positions the parked turn had written in total: positions past
    # len(blocks) * block_size were cut at park and are recomputed on
    # re-attach (goodput cause "replay_session_tail")
    full_pos: int = 0
    tag: object = None        # the prefix index tag the tokens are registered under


class SessionTable:
    """LRU + bytes-budgeted table of parked session prefixes."""

    def __init__(self, pool, prefix_index, config: SessionConfig | None = None):
        cfg = config or SessionConfig()
        self.pool = pool
        self.index = prefix_index
        self.max_sessions = cfg.max_sessions
        self.max_bytes = pool.arena_bytes() // 2 if cfg.max_bytes is None else cfg.max_bytes
        self._entries: OrderedDict[str, SessionEntry] = OrderedDict()
        self._by_owner: dict[int, SessionEntry] = {}
        self._owner_ids = itertools.count(-1, -1)
        reg = registry()
        self._m_resident = reg.gauge("serving.session.resident_blocks")
        self._m_reattach = reg.counter("serving.session.reattach_hits")
        self._m_evictions = reg.counter("serving.session.evictions")
        self.reattach_hits = 0
        self.evictions = 0

    # -- queries ------------------------------------------------------------
    def __len__(self) -> int:
        return len(self._entries)

    def resident(self, session_id: str) -> bool:
        return session_id in self._entries

    @property
    def resident_blocks(self) -> int:
        return sum(len(e.blocks) for e in self._entries.values())

    @property
    def resident_bytes(self) -> int:
        return sum(e.nbytes for e in self._entries.values())

    def entries(self) -> list[SessionEntry]:
        """Snapshot of the live entries (the recovery replay walks it)."""
        return list(self._entries.values())

    def alive(self, owner_rid: int, blocks) -> bool:
        """Prefix-index liveness for parked owners (negative rids)."""
        entry = self._by_owner.get(owner_rid)
        if entry is None:
            return False
        blocks = tuple(blocks)
        return entry.blocks[:len(blocks)] == blocks

    def owner_entry(self, owner_rid: int) -> SessionEntry | None:
        return self._by_owner.get(owner_rid)

    # -- mutation -----------------------------------------------------------
    def park(self, session_id: str, tokens, blocks, *, adapter_slot: int = 0,
             full_pos: int = 0, tag=None) -> SessionEntry | None:
        """Retains ``blocks`` (holding exactly ``tokens``) for the session,
        registered under ``tag``.

        Shares the blocks before releasing any prior entry of the same id,
        so re-parking a grown turn never drops overlap blocks to refcount
        zero.  Returns None (parking nothing) when the entry alone exceeds
        the bytes budget or the block list is empty or sunk."""
        blocks = tuple(int(b) for b in blocks)
        tokens = np.asarray(tokens, dtype=np.int64)
        bs = self.pool.block_size
        if SINK_BLOCK in blocks:
            blocks = blocks[:blocks.index(SINK_BLOCK)]
        blocks = blocks[:len(tokens) // bs]
        tokens = tokens[:len(blocks) * bs]
        nbytes = len(blocks) * self.pool.block_bytes()
        if not blocks or nbytes > self.max_bytes:
            self.close(session_id)
            return None
        self.pool.share(blocks)
        self.close(session_id, _count_eviction=False)
        while self._entries and (len(self._entries) >= self.max_sessions
                                 or self.resident_bytes + nbytes > self.max_bytes):
            self.close(next(iter(self._entries)))
        entry = SessionEntry(session_id=session_id, owner_rid=next(self._owner_ids),
                             tokens=tokens, blocks=blocks, adapter_slot=int(adapter_slot),
                             nbytes=nbytes, full_pos=int(full_pos), tag=tag)
        self._entries[session_id] = entry
        self._by_owner[entry.owner_rid] = entry
        self.index.register(entry.owner_rid, tokens, list(blocks),
                            lambda hit: self.alive(*hit), full=True, tag=tag)
        self._m_resident.set(self.resident_blocks)
        return entry

    def touch(self, session_id: str) -> None:
        """LRU-bumps a session whose prefix a new turn just re-attached."""
        if session_id in self._entries:
            self._entries.move_to_end(session_id)

    def note_reattach(self, owner_rid: int) -> None:
        """Counts a shared-prefix hit served from a parked session."""
        entry = self._by_owner.get(owner_rid)
        if entry is not None:
            self._entries.move_to_end(entry.session_id)
            self.reattach_hits += 1
            self._m_reattach.inc()

    def close(self, session_id: str, *, _count_eviction: bool = True) -> int:
        """Releases a session's references; returns the blocks freed (0 if
        absent)."""
        entry = self._entries.pop(session_id, None)
        if entry is None:
            return 0
        self._by_owner.pop(entry.owner_rid, None)
        self.index.unregister(entry.owner_rid)
        self.pool.free(list(entry.blocks))
        if _count_eviction:
            self.evictions += 1
            self._m_evictions.inc()
        self._m_resident.set(self.resident_blocks)
        return len(entry.blocks)

    def clear(self) -> int:
        """Releases everything (engine shutdown); returns the blocks freed."""
        return sum(self.close(sid) for sid in list(self._entries))

    # -- introspection ------------------------------------------------------
    def snapshot(self) -> dict:
        return {
            "sessions": len(self._entries),
            "resident_blocks": self.resident_blocks,
            "resident_bytes": self.resident_bytes,
            "max_sessions": self.max_sessions,
            "max_bytes": self.max_bytes,
            "reattach_hits": self.reattach_hits,
            "evictions": self.evictions,
            "ids": list(self._entries),
        }
