"""Selectable rematerialization policies for the train step.

Counterpart of ``thunder_tpu/train/remat.py``, with its vocabulary:

- ``"none"``       — save every residual; nothing is recomputed.
- ``"attention"``  — the selective policy ``remat=True`` means: the matmul
  outputs are saved and the cheap ops between them (elementwise, norms,
  rope, softmax pieces) are recomputed in the backward.
- ``"full_block"`` — each transformer block is checkpointed whole: only its
  input is saved, and the backward reruns the block's forward.

Booleans and ``"auto"`` stay accepted (``True`` ≡ ``"attention"``,
``False`` ≡ ``"none"``; ``"auto"`` resolves by a device-memory probe), and
``zero3=True`` forces ``"full_block"`` as in the reference.

The JAX package rematerializes on the traced program; the port runs eager
autograd, so the policies are realised with ``torch.utils.checkpoint``
(non-reentrant) around each block: the train step opens
:func:`policy_scope` and the model calls :func:`run_block` for each block.
The flash-attention forward is a ``ctypes`` call inside an autograd
function, opaque to the selective policy, so under ``"attention"`` it reruns
in the recompute just as under ``"full_block"``.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, NamedTuple

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

__all__ = ["REMAT_POLICIES", "RematDecision", "policy_scope", "resolve_remat", "run_block",
           "validate_remat"]

#: the selectable policy names, weakest to strongest
REMAT_POLICIES = ("none", "attention", "full_block")


class RematDecision(NamedTuple):
    """Resolved policy: its name and whether anything is recomputed."""

    policy: str          # one of REMAT_POLICIES
    apply: bool


_BY_POLICY = {name: RematDecision(name, name != "none") for name in REMAT_POLICIES}


def validate_remat(remat) -> None:
    """Raises ``ValueError`` for anything outside the accepted vocabulary
    (bool, ``"auto"``, or a :data:`REMAT_POLICIES` name)."""
    if isinstance(remat, bool) or remat == "auto" or remat in REMAT_POLICIES:
        return
    raise ValueError(
        f"remat must be True, False, 'auto', or one of {REMAT_POLICIES}, got {remat!r}"
    )


def resolve_remat(remat, *, zero3: bool = False,
                  auto: Callable[[], bool] | None = None) -> RematDecision:
    """Maps the user-facing ``remat=`` value to a :class:`RematDecision`.
    ``auto`` is the deferred memory probe, called only for ``"auto"``."""
    validate_remat(remat)
    if zero3:
        return _BY_POLICY["full_block"]
    if remat == "auto":
        want = bool(auto()) if auto is not None else True
        return _BY_POLICY["attention" if want else "none"]
    if isinstance(remat, bool):
        return _BY_POLICY["attention" if remat else "none"]
    return _BY_POLICY[remat]


_ACTIVE = contextvars.ContextVar("thunder_tpu_torch_remat_policy", default="none")

# ATen ops whose outputs the selective policy keeps: the matmuls
_SAVED_OPS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                        torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default})


def _selective(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _SAVED_OPS else CheckpointPolicy.PREFER_RECOMPUTE


@contextlib.contextmanager
def policy_scope(policy: str):
    """Blocks run through :func:`run_block` inside take ``policy``."""
    if policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {policy!r}; expected one of {REMAT_POLICIES}")
    token = _ACTIVE.set(policy)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def run_block(fn: Callable, *args):
    """``fn(*args)`` under the active policy (``"none"`` outside a train
    step, or when no grad is recorded)."""
    policy = _ACTIVE.get()
    if policy == "none" or not torch.is_grad_enabled():
        return fn(*args)
    if policy == "full_block":
        return checkpoint(fn, *args, use_reentrant=False)
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=lambda: create_selective_checkpoint_contexts(_selective))
