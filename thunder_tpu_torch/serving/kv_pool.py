"""Paged KV-cache pool: a preallocated block arena + free-list allocator.

Counterpart of ``thunder_tpu/serving/kv_pool.py``.  All requests share one
arena of fixed-size blocks ``(num_blocks, L, n_query_groups, block_size,
hs)`` for K and V each (per-block geometry from
:func:`models.generate.kv_block_shape`), so a gather over a request's block
table reassembles exactly the dense cache layout ``forward_with_cache``
consumes.

- Quantized block storage (``kv_dtype="int8"`` or ``"fp8"``): the arenas
  store 1-byte values plus float32 scale arenas ``(num_blocks, L, ng, bs)``
  (:mod:`serving.quant`); ``dtype`` stays the compute dtype K/V are
  dequantized into.

- Physical block 0 is a reserved garbage sink: batch-padding rows and
  not-yet-reached table entries point at it, and it is never attended.
- Per-block reference counts enable prefix sharing: requests with the same
  block-aligned prompt prefix map their leading table entries to the same
  physical blocks, freed when the last owner releases them.
- The pool owns the host-side allocator and the arena tensors.  Arenas are
  updated in place (the JAX package donates and swaps them instead).
- Sliding-window models keep the positional layout (slot = position); the
  scheduler frees blocks that slid out of the window and their table
  entries fall back to the sink.
"""
from __future__ import annotations

from collections import deque
from typing import Sequence

import numpy as np
import torch

from thunder_tpu_torch._device import resolve_device
from thunder_tpu_torch.models.generate import kv_block_shape
from thunder_tpu_torch.serving.quant import (
    gather_dense_q,
    is_quantized_kv,
    resolve_kv_dtype,
    scatter_blocks_q,
    scatter_token_q,
)

__all__ = ["PoolExhaustedError", "ArenaMismatchError", "PagedKVPool", "PrefixIndex",
           "SINK_BLOCK", "OCCUPANCY_WINDOW", "chunk_tables", "gather_dense",
           "scatter_token", "scatter_blocks"]

SINK_BLOCK = 0  # reserved physical block for padding/expired table entries

OCCUPANCY_WINDOW = 128  # samples retained in the occupancy timeline ring


class PoolExhaustedError(RuntimeError):
    """Raised by :meth:`PagedKVPool.alloc` when fewer free blocks remain
    than requested.  Admission control catches this to queue the request."""


class ArenaMismatchError(ValueError):
    """An arena write does not match the pool's geometry or dtype.

    Attributes: ``arena`` ("k" | "v" | "k_scale" | "v_scale" | "arenas" |
    "scatter"), ``field`` ("shape" | "dtype" | "device"), ``expected``,
    ``got``."""

    def __init__(self, arena: str, field: str, expected, got, *, msg: str | None = None):
        self.arena = arena
        self.field = field
        self.expected = expected
        self.got = got
        super().__init__(
            msg if msg is not None else (
                f"refusing to write {arena}-arena with mismatched {field}: got "
                f"{got!r}, pool expects {expected!r}"
            )
        )


class PagedKVPool:
    """Block arena + free-list allocator + per-block reference counts.

    ``dtype`` is the compute dtype of the arenas; ``kv_dtype`` their storage
    dtype (None: ``dtype``; ``"int8"``/``"fp8"``: 1-byte values plus float32
    scale arenas ``k_scale``/``v_scale`` shaped ``(num_blocks, L, ng,
    bs)``).  Everything lives on ``device`` (default: the card)."""

    def __init__(self, cfg, num_blocks: int, block_size: int, dtype=torch.bfloat16,
                 *, kv_dtype=None, device="cuda"):
        if num_blocks < 2:
            raise ValueError(f"num_blocks must be >= 2 (block 0 is the sink), got {num_blocks}")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.cfg = cfg
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.dtype = dtype                                  # compute/dequant dtype
        self.kv_dtype = resolve_kv_dtype(kv_dtype, dtype)   # storage dtype
        self.quantized_kv = is_quantized_kv(self.kv_dtype, dtype)
        self.device = resolve_device(device)
        self._arena_shape = (self.num_blocks, *kv_block_shape(cfg, self.block_size))
        self._scale_shape = self._arena_shape[:-1]          # absmax over hs
        self.k_arena = torch.zeros(self._arena_shape, dtype=self.kv_dtype, device=self.device)
        self.v_arena = torch.zeros(self._arena_shape, dtype=self.kv_dtype, device=self.device)
        self.k_scale = self.v_scale = None
        if self.quantized_kv:
            self.k_scale = torch.zeros(self._scale_shape, dtype=torch.float32,
                                       device=self.device)
            self.v_scale = torch.zeros(self._scale_shape, dtype=torch.float32,
                                       device=self.device)
        # block 0 is permanently leased to the sink
        self._refcount = np.zeros(self.num_blocks, dtype=np.int32)
        self._refcount[SINK_BLOCK] = 1
        self._free: list[int] = list(range(self.num_blocks - 1, SINK_BLOCK, -1))  # pop() -> lowest id
        self._free_low_water = len(self._free)
        # occupancy timeline: bounded ring of (free, shared, leased) triples
        self._occ_ring: deque = deque(maxlen=OCCUPANCY_WINDOW)

    #
    # allocator
    #

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_usable(self) -> int:
        """Allocatable blocks (arena minus the sink)."""
        return self.num_blocks - 1

    @property
    def free_blocks_low_water(self) -> int:
        """Fewest free blocks ever observed (capacity headroom floor)."""
        return self._free_low_water

    def utilization(self) -> float:
        """Fraction of usable blocks currently leased."""
        return 1.0 - self.num_free / self.num_usable

    def blocks_for_tokens(self, n_tokens: int) -> int:
        """Blocks needed to hold ``n_tokens`` cache slots."""
        return -(-max(int(n_tokens), 0) // self.block_size)

    def can_alloc(self, n: int) -> bool:
        return n <= self.num_free

    def alloc(self, n: int) -> list[int]:
        """Leases ``n`` blocks (refcount 1 each); raises
        :class:`PoolExhaustedError` without side effects when short."""
        if n > self.num_free:
            raise PoolExhaustedError(
                f"need {n} blocks, {self.num_free} free of {self.num_usable}"
            )
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self._refcount[b] = 1
        self._free_low_water = min(self._free_low_water, len(self._free))
        return out

    def share(self, blocks: Sequence[int]) -> list[int]:
        """Increments the refcount of already-leased ``blocks`` (prefix
        sharing); returns the same ids."""
        for b in blocks:
            if b == SINK_BLOCK:
                continue
            if self._refcount[b] <= 0:
                raise ValueError(f"block {b} is not leased; cannot share")
            self._refcount[b] += 1
        return list(blocks)

    def free(self, blocks: Sequence[int]) -> int:
        """Releases one reference on each block; blocks whose count reaches
        zero return to the free list.  Returns how many became free."""
        released = 0
        for b in blocks:
            if b == SINK_BLOCK:
                continue
            if self._refcount[b] <= 0:
                raise ValueError(f"double free of block {b}")
            self._refcount[b] -= 1
            if self._refcount[b] == 0:
                self._free.append(b)
                released += 1
        return released

    def sample_occupancy(self) -> tuple[int, int, int]:
        """Append one ``(free, shared, leased)`` sample to the bounded
        occupancy ring and return it."""
        counts = self._refcount[SINK_BLOCK + 1:]
        sample = (self.num_free, int((counts > 1).sum()), int((counts > 0).sum()))
        self._occ_ring.append(sample)
        return sample

    def occupancy_snapshot(self) -> dict:
        tl = self._occ_ring
        return {
            "window": OCCUPANCY_WINDOW,
            "samples": len(tl),
            "last": tl[-1] if tl else None,
            "peak_leased": max((s[2] for s in tl), default=0),
            "occupancy_frac": self.utilization(),
        }

    def state_snapshot(self) -> dict:
        counts = self._refcount[SINK_BLOCK + 1:]
        return {
            "num_blocks": self.num_blocks,
            "block_size": self.block_size,
            "num_free": self.num_free,
            "free_blocks_low_water": self._free_low_water,
            "utilization": self.utilization(),
            "leased_blocks": int((counts > 0).sum()),
            "shared_blocks": int((counts > 1).sum()),
            "lease_refs": int(counts.sum()),
            "dtype": str(self.dtype),
            "kv_dtype": str(self.kv_dtype),
            "arena_bytes": self.arena_bytes(),
        }

    #
    # arena geometry
    #

    def capacity_tokens(self, n_blocks: int) -> int:
        return n_blocks * self.block_size

    def block_bytes(self) -> int:
        """Bytes one block costs across all arenas (K and V, plus the scale
        arenas on the quantized path) — the unit of byte-based admission
        accounting."""
        total = 2 * self.k_arena[0].numel() * self.k_arena.element_size()
        if self.quantized_kv:
            total += 2 * self.k_scale[0].numel() * self.k_scale.element_size()
        return total

    def arena_bytes(self) -> int:
        return self.block_bytes() * self.num_blocks

    @property
    def arenas(self) -> dict:
        """The arena dict the decode/prefill steps read and update in place:
        ``{"k", "v"}`` plus ``{"k_scale", "v_scale"}`` when quantized."""
        out = {"k": self.k_arena, "v": self.v_arena}
        if self.quantized_kv:
            out["k_scale"] = self.k_scale
            out["v_scale"] = self.v_scale
        return out

    @property
    def quantized_storage(self):
        """The storage dtype of a quantized pool (what the paged writers
        take as ``kv_dtype``), else None."""
        return self.kv_dtype if self.quantized_kv else None

    #
    # the gather steps' access to the arenas, quantized or not
    #

    def gather(self, tables) -> dict:
        """The dense ``{"k", "v"}`` cache (L, B, ng, nb*bs, hs) of
        ``tables``'s blocks at the compute dtype (dequantized from a
        quantized pool)."""
        if self.quantized_kv:
            kd, vd = gather_dense_q(self.k_arena, self.v_arena, self.k_scale, self.v_scale,
                                    tables, self.dtype)
        else:
            kd, vd = gather_dense(self.k_arena, self.v_arena, tables)
        return {"k": kd, "v": vd}

    def scatter_dense(self, cache: dict, dest) -> torch.Tensor | float:
        """Writes a B=1 dense cache back block by block through ``dest``
        (quantizing into a quantized pool); returns the quantization error
        ``0.5 * (k_rel + v_rel)`` over the blocks written, a float32 scalar
        tensor (the float 0.0 unquantized)."""
        if not self.quantized_kv:
            scatter_blocks(self.k_arena, cache["k"], dest)
            scatter_blocks(self.v_arena, cache["v"], dest)
            return 0.0
        _, _, k_err = scatter_blocks_q(self.k_arena, self.k_scale, cache["k"], dest)
        _, _, v_err = scatter_blocks_q(self.v_arena, self.v_scale, cache["v"], dest)
        return 0.5 * (k_err + v_err)

    def scatter_rows(self, cache: dict, p, rows, dest_block, dest_slot) -> None:
        """Writes row ``rows[i]``'s K/V at position ``p[i]`` of a dense
        cache (L, B, ng, T, hs) into (``dest_block[i]``, ``dest_slot[i]``),
        quantizing into a quantized pool."""
        for name, arena, scale in (("k", self.k_arena, self.k_scale),
                                   ("v", self.v_arena, self.v_scale)):
            fresh = cache[name][:, rows, :, p].contiguous()    # (B, L, ng, hs)
            if self.quantized_kv:
                scatter_token_q(arena, scale, fresh, dest_block, dest_slot)
            else:
                scatter_token(arena, fresh, dest_block, dest_slot)

    def _check_arena(self, name: str, new: torch.Tensor) -> None:
        scale = name.endswith("_scale")
        want_shape = self._scale_shape if scale else self._arena_shape
        want_dtype = torch.float32 if scale else self.kv_dtype
        if tuple(new.shape) != want_shape:
            raise ArenaMismatchError(name, "shape", want_shape, tuple(new.shape))
        if new.dtype != want_dtype:
            raise ArenaMismatchError(name, "dtype", want_dtype, new.dtype)
        if new.device != self.device:
            raise ArenaMismatchError(name, "device", self.device, new.device)

    def set_arenas(self, arenas: dict) -> None:
        """Installs replacement arena tensors (the steps update the pool's
        own tensors in place; this is for callers that build new ones).
        Validates the keys, geometry, dtype and device first, so a
        mismatched arena raises :class:`ArenaMismatchError` naming it
        instead of surfacing steps later as garbage KV."""
        expected = set(self.arenas)
        if set(arenas) != expected:
            raise ArenaMismatchError(
                "arenas", "shape", sorted(expected), sorted(arenas),
                msg=f"arena keys {sorted(arenas)}, pool expects {sorted(expected)} "
                    f"(kv_dtype={self.kv_dtype})",
            )
        for name, t in arenas.items():
            self._check_arena(name, t)
        self.k_arena, self.v_arena = arenas["k"], arenas["v"]
        if self.quantized_kv:
            self.k_scale, self.v_scale = arenas["k_scale"], arenas["v_scale"]


class PrefixIndex:
    """Block-aligned prompt-prefix → ``(owner rid, block ids)`` map.

    Liveness is delegated: every query takes an ``alive(hit) -> bool``
    callback (the engine checks that the owner is still running and every
    snapshot block id is still its live table entry).  :meth:`find` counts
    lookups/hits and scrubs stale entries.

    Every entry is keyed by a ``tag`` beside the prompt tokens: what else
    decided the K/V in those blocks.  A LoRA engine tags each prefix with
    the (slot, version) of the factors it was computed with, so requests of
    different adapters never share K/V (the reference keys on the tokens
    alone, ``thunder_tpu/serving/engine.py:1311-1340``, and lets a request
    reuse K/V computed with another adapter's ``wk``/``wv`` deltas)."""

    def __init__(self, block_size: int):
        self.block_size = int(block_size)
        self._index: dict[tuple, tuple[int, tuple[int, ...]]] = {}
        self.lookups = 0
        self.hits = 0

    def __len__(self) -> int:
        return len(self._index)

    def find(self, prompt: np.ndarray, alive, *, tag=None) -> list[int]:
        """Longest block-aligned prefix of ``prompt`` registered under
        ``tag`` with a live owner: the shared block ids (capped one token
        short of the full prompt, so the last prompt token always
        re-prefills), or ``[]``."""
        self.lookups += 1
        bs = self.block_size
        max_share = ((int(prompt.shape[0]) - 1) // bs) * bs
        for k in range(max_share, 0, -bs):
            key = (tag, tuple(prompt[:k].tolist()))
            hit = self._index.get(key)
            if hit is None:
                continue
            if alive(hit):
                self.hits += 1
                return list(hit[1])
            del self._index[key]                  # stale snapshot: never share it
        return []

    def register(self, rid: int, prompt: np.ndarray, block_table, alive, *,
                 upto: int | None = None, tag=None) -> None:
        """Registers every block-aligned prefix of ``prompt`` (owner
        ``rid``) up to ``upto`` written tokens, under ``tag``; live entries
        are never displaced."""
        bs = self.block_size
        n = int(prompt.shape[0])
        limit = n if upto is None else min(upto, n)
        hi = min((limit // bs) * bs, ((n - 1) // bs) * bs)
        toks = prompt.tolist()
        for k in range(bs, hi + 1, bs):
            key = (tag, tuple(toks[:k]))
            cur = self._index.get(key)
            if cur is None or not alive(cur):
                self._index[key] = (rid, tuple(block_table[: k // bs]))

    def unregister(self, rid: int) -> None:
        """Drops every entry owned by ``rid`` (before its blocks free)."""
        if self._index:
            stale = [k for k, (r, _) in self._index.items() if r == rid]
            for k in stale:
                del self._index[k]


def chunk_tables(block_table, pos: int, n_tokens: int, nbb: int,
                 block_size: int) -> tuple[np.ndarray, np.ndarray]:
    """Host-side gather/scatter tables for one prefill piece covering
    ``[pos, pos + n_tokens)``: ``table`` holds every leased block
    (sink-padded to ``nbb``); ``dest`` holds only the block range this piece
    writes, every other entry routed to the sink."""
    bs = block_size
    table = np.full(nbb, SINK_BLOCK, dtype=np.int32)
    table[: len(block_table)] = block_table
    dest = np.full(nbb, SINK_BLOCK, dtype=np.int32)
    lo, hi = pos // bs, min(len(block_table), -(-(pos + n_tokens) // bs))
    dest[lo:hi] = block_table[lo:hi]
    return table, dest


def gather_dense(k_arena, v_arena, tables):
    """Reassembles dense caches from block tables.

    ``tables``: (B, nb) int physical-block ids (sink-padded).  Returns
    ``k, v`` of shape (L, B, ng, nb*bs, hs) — new tensors in the layout
    ``forward_with_cache`` consumes."""
    idx = tables.long()

    def one(arena):
        g = arena[idx]                             # (B, nb, L, ng, bs, hs)
        g = g.permute(2, 0, 3, 1, 4, 5)            # (L, B, ng, nb, bs, hs)
        L, B, ng, nb, bs, hs = g.shape
        return g.reshape(L, B, ng, nb * bs, hs)

    return one(k_arena), one(v_arena)


def scatter_token(arena, new_kv, dest_block, dest_slot):
    """Writes one token's K (or V) per batch row into the arena, in place.

    ``new_kv``: (B, L, ng, hs) at the arena dtype; ``dest_block``/
    ``dest_slot``: (B,) integer tensors (sink-routed for padding rows)."""
    if new_kv.dtype != arena.dtype:
        raise ArenaMismatchError(
            "scatter", "dtype", arena.dtype, new_kv.dtype,
            msg=f"scatter_token source dtype {new_kv.dtype} != arena dtype {arena.dtype}",
        )
    arena[dest_block.long(), :, :, dest_slot.long(), :] = new_kv
    return arena


def scatter_blocks(arena, dense, dest_table):
    """Writes a request's dense cache back into the arena block by block,
    in place.  ``dense``: (L, 1, ng, nb*bs, hs); ``dest_table``: (nb,)
    integer tensor — sink entries absorb padding/garbage blocks."""
    if dense.dtype != arena.dtype:
        raise ArenaMismatchError(
            "scatter", "dtype", arena.dtype, dense.dtype,
            msg=f"scatter_blocks source dtype {dense.dtype} != arena dtype {arena.dtype}",
        )
    L, _, ng, cap, hs = dense.shape
    bs = arena.shape[3]
    blocks = dense[:, 0].reshape(L, ng, cap // bs, bs, hs).permute(2, 0, 1, 3, 4)
    arena[dest_table.long()] = blocks
    return arena
