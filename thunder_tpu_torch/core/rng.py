"""Global RNG state for compiled programs.

Counterpart of ``thunder_tpu/core/rng.py``.  Traces never touch implicit RNG
state: the random prims take an explicit ``(2,)`` uint32 key tensor that
``jit`` appends to each call of a program that uses RNG, derived from
``(seed, step)``.  ``manual_seed`` resets the stream; every call advances
``step``, so dropout masks differ per call and reproduce after a reseed.

The reference folds the step into a threefry key (``jax.random.fold_in``);
the port mixes ``(seed, step)`` into the key's two words, and ``torchex``
seeds a ``torch.Generator`` from the key and each op's offset.  Equal seeds
give equal masks; the values are not JAX's (``ROADMAP.md`` keeps this
divergence on purpose).  The key lives on the CPU, so reading it never
waits for the card.
"""
from __future__ import annotations

import threading

import torch

__all__ = ["manual_seed", "next_key"]

_lock = threading.Lock()
_seed: int = 0
_step: int = 0
_MASK32 = 0xFFFFFFFF


def manual_seed(seed: int) -> None:
    global _seed, _step
    with _lock:
        _seed = int(seed)
        _step = 0


def _mix(x: int) -> int:
    """splitmix64's finalizer: distinct (seed, step) pairs give distinct,
    well-spread 64-bit words."""
    x = (x + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return x ^ (x >> 31)


def next_key() -> torch.Tensor:
    """Returns a fresh ``(2,)`` uint32 key on the CPU; advances the global
    step."""
    global _step
    with _lock:
        step = _step
        _step += 1
    word = _mix(((_seed & _MASK32) << 32) | (step & _MASK32))
    return torch.tensor([word >> 32, word & _MASK32], dtype=torch.uint32)
