"""Selectable rematerialization policies for the train step.

Counterpart of ``thunder_tpu/train/remat.py``, with its vocabulary and its
table of knobs for the trace's rematerialization
(:func:`thunder_tpu_torch.core.rematerialization.rematerialize_forward_and_backward`):

- ``"none"``       — save every residual; nothing is recomputed.
- ``"attention"``  — the selective policy ``remat=True`` means: cheap-op
  producer cones (elementwise, norm, rope chains) behind the anchor ops
  (matmul, reduction, RNG, embedding stay saved) are recomputed in the
  backward, ``max_cone=64``.
- ``"full_block"`` — aggressive: anchors (matmuls included) are recomputed
  too and the residuals shrink toward the layer inputs (``max_cone=256``,
  ``aggressive=True``).

Booleans and ``"auto"`` stay accepted (``True`` ≡ ``"attention"``,
``False`` ≡ ``"none"``; ``"auto"`` resolves by a device-memory probe), and
``zero3=True`` forces ``"full_block"`` as in the reference.

The traced step (:class:`~thunder_tpu_torch.distributed.api.TrainStep`)
reads the decision's ``apply``, ``max_cone`` and ``aggressive``.  The eager
twin (:class:`~thunder_tpu_torch.distributed.api.EagerTrainStep`) realises
the same policy names with ``torch.utils.checkpoint`` (non-reentrant)
around each block: it opens :func:`policy_scope` and the model calls
:func:`run_block` for each block, which under ``jit`` (proxies) calls the
block as it is.  The eager flash-attention forward is a ``ctypes`` call
inside an autograd function, opaque to the selective policy, so under
``"attention"`` it reruns in the eager recompute just as under
``"full_block"``.
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
    """Resolved policy: whether the pass runs and with which knobs."""

    policy: str          # one of REMAT_POLICIES
    apply: bool          # run rematerialize_forward_and_backward at all
    max_cone: int        # recompute-cone size cap
    aggressive: bool     # recompute anchor ops (matmuls) too


_BY_POLICY = {
    "none": RematDecision("none", False, 0, False),
    "attention": RematDecision("attention", True, 64, False),
    "full_block": RematDecision("full_block", True, 256, True),
}


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


def _traced(args) -> bool:
    from thunder_tpu_torch.core.proxies import TensorProxy

    return any(isinstance(x, TensorProxy) for x in args)


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
    step, or when no grad is recorded).  Under ``jit`` the block runs on
    proxies and is recorded into the trace as it is: a trace holds no
    autograd state to checkpoint."""
    policy = _ACTIVE.get()
    if policy == "none" or not torch.is_grad_enabled() or _traced(args):
        return fn(*args)
    if policy == "full_block":
        return checkpoint(fn, *args, use_reentrant=False)
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=lambda: create_selective_checkpoint_contexts(_selective))
