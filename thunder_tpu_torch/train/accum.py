"""Gradient accumulation: the microbatch split for
``TrainStep(..., accum_steps=k)``.

Counterpart of ``thunder_tpu/train/accum.py``.  The JAX package scans the
k microbatches inside one compiled program; the port loops over them
eagerly, with the same contract: a float32 accumulator summed in a fixed
order (microstep 0 first), grads divided by k, and the loss the mean of
the microbatch means.  Only the helpers live here; the loop is in
:mod:`thunder_tpu_torch.distributed.api`.
"""
from __future__ import annotations

from typing import Sequence

import torch

from thunder_tpu_torch._tree import tree_leaves

__all__ = ["accum_buffer_bytes", "microbatch_mask", "split_for_accum"]


def microbatch_mask(batch: Sequence) -> tuple[bool, ...]:
    """Which batch args carry the batch dim (and split into microbatches):
    leading dim equal to ``batch[0]``'s, and integer-typed (token ids,
    targets) or sharing its leading-shape prefix.  Side inputs such as the
    rope caches pass whole to every microstep."""
    b0_shape = tuple(batch[0].shape) if isinstance(batch[0], torch.Tensor) else ()
    bsz = b0_shape[0] if b0_shape else None

    def _split(b) -> bool:
        if not isinstance(b, torch.Tensor) or b.ndim == 0 or b.shape[0] != bsz:
            return False
        if not b.is_floating_point() and not b.is_complex():
            return True
        k = min(b.ndim, len(b0_shape))
        return tuple(b.shape[:k]) == b0_shape[:k]

    return tuple(_split(b) for b in batch)


def split_for_accum(batch: Sequence, accum_steps: int, mask: Sequence[bool] | None = None):
    """Each batch-dim arg ``(B, ...) -> (k, B//k, ...)``; side inputs pass
    through.  Raises ``ValueError`` when ``accum_steps`` does not divide the
    batch size (a silent drop would change the loss)."""
    if mask is None:
        mask = microbatch_mask(batch)
    k = int(accum_steps)
    out = []
    for b, m in zip(batch, mask):
        if not m:
            out.append(b)
            continue
        B = b.shape[0]
        if B % k != 0:
            raise ValueError(f"accum_steps={k} must divide the batch size {B} "
                             f"(arg shape {tuple(b.shape)})")
        out.append(b.reshape(k, B // k, *b.shape[1:]))
    return tuple(out), tuple(mask)


def accum_buffer_bytes(params) -> int:
    """Bytes of the float32 gradient accumulator (one f32 buffer per
    floating param leaf)."""
    return sum(4 * x.numel() for x in tree_leaves(params)
               if isinstance(x, torch.Tensor) and x.is_floating_point())
