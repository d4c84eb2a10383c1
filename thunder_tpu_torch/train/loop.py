"""The elastic training loop: classify faults, restore, replay, converge.

Counterpart of ``thunder_tpu/train/loop.py``, with its recovery grammar:

- every optimizer step passes the ``train.step`` fault point (armed plans
  inject there; unarmed runs pay one ``is None`` check);
- a fault classified ``transient`` retries the SAME step after backoff (the
  fault fired before the step ran, so params and optimizer state are
  intact);
- ``engine``-class faults (OOM, hang, watchdog) trigger **elastic
  restart**: drain pending checkpoint saves, restore the newest committed
  checkpoint (torn ones are skipped with a structured warning), and replay
  from there; with none committed, replay from a host copy of the initial
  state;
- ``request``-class faults and unclassified exceptions re-raise.

Bit-identity: batches come from ``batch_for_step(step)`` — a pure function
of the step index — and checkpoints capture (params, opt_state) *after*
step ``s`` under the name ``s+1``.  A replay re-executes the same step on
the same inputs, so the loss curve equals the undisturbed run's bit for bit
where the step itself is deterministic (on the CPU; on the card the
embedding gradient's atomics reorder sums).

The port's train step updates params and optimizer state in place, so the
loop keeps its seed state as a host copy and restores into fresh tensors.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Sequence

import torch

from thunder_tpu_torch._tree import tree_map
from thunder_tpu_torch.observability.metrics import registry
from thunder_tpu_torch.serving.faults import (
    CLASS_ENGINE,
    CLASS_TRANSIENT,
    FP_TRAIN_STEP,
    RecoveryError,
    RetryPolicy,
    classify_fault,
    fault_cause,
)
from thunder_tpu_torch.train.checkpoint import AsyncCheckpointer, host_copy, restore_latest

__all__ = ["TrainLoopResult", "train_loop"]


@dataclass
class TrainLoopResult:
    """What a (possibly fault-interrupted) run produced."""

    params: object
    opt_state: object
    losses: list = field(default_factory=list)   # loss per step index, final values
    steps_run: int = 0                           # total step executions incl. replays
    restarts: int = 0                            # elastic restarts taken
    retries: int = 0                             # transient same-step retries
    resumed_from: int | None = None              # checkpoint step a restart used (last)
    faults: list = field(default_factory=list)   # structured causes absorbed
    checkpoint_failures: list = field(default_factory=list)


def _replace(template, host_state):
    """Fresh device tensors from the host copy (the copy stays pristine
    for another restart)."""
    return tree_map(lambda t, h: h.to(t.device, copy=True) if isinstance(t, torch.Tensor) else h,
                    template, host_state)


def train_loop(
    step_fn: Callable,
    params,
    opt_state,
    batch_for_step: Callable[[int], Sequence],
    *,
    steps: int,
    start_step: int = 0,
    checkpointer: AsyncCheckpointer | None = None,
    checkpoint_every: int = 0,
    fault_plan=None,
    retry: RetryPolicy | None = None,
    max_restarts: int = 4,
    on_step: Callable[[int, float], None] | None = None,
) -> TrainLoopResult:
    """Runs ``steps`` optimizer steps with elastic fault recovery.

    ``step_fn(params, opt_state, *batch) -> (params, opt_state, loss)`` is
    typically a :class:`~thunder_tpu_torch.distributed.api.TrainStep`;
    ``batch_for_step(s)`` must be a pure function of ``s`` (that purity IS
    the bit-identical-resume contract).  ``checkpoint_every=k`` dispatches
    an async save after every k-th completed step; the loop's initial state
    is snapshotted to host once so a restart with no committed checkpoint
    can still replay from step ``start_step``."""
    retry = retry or RetryPolicy()
    res = TrainLoopResult(params=params, opt_state=opt_state,
                          losses=[None] * steps)
    # host-side seed state: the restart-of-last-resort when no checkpoint
    # has committed yet (the step updates the device state in place, so a
    # copy is the only way back)
    seed_state = host_copy({"params": params, "opt_state": opt_state})
    reg = registry()

    s = start_step
    attempt = 0
    while s < steps:
        batch = batch_for_step(s)
        try:
            if fault_plan is not None:
                fault_plan.check(FP_TRAIN_STEP, ())
            params, opt_state, loss = step_fn(params, opt_state, *batch)
        except Exception as e:  # noqa: BLE001 — classified below, else re-raised
            cls = classify_fault(e)
            if cls is None:
                raise
            res.faults.append(fault_cause(e))
            reg.counter("train.faults.absorbed").inc()
            if cls == CLASS_TRANSIENT:
                if attempt >= retry.max_retries:
                    raise RecoveryError(
                        f"step {s}: transient fault persisted past "
                        f"{retry.max_retries} retries"
                    ) from e
                attempt += 1
                res.retries += 1
                retry.sleep(retry.backoff(attempt))
                continue  # same step, params/opt intact (fault pre-dispatch)
            if cls != CLASS_ENGINE:
                raise  # request-class has no training analogue: escalate
            if res.restarts >= max_restarts:
                raise RecoveryError(
                    f"step {s}: restart budget ({max_restarts}) exhausted"
                ) from e
            # elastic restart: drain pending saves, then newest committed wins
            res.restarts += 1
            reg.counter("train.restarts").inc()
            restored = None
            if checkpointer is not None:
                for rec in checkpointer.wait():
                    if "error" in rec:
                        res.checkpoint_failures.append(rec)
                restored = restore_latest(
                    checkpointer.directory,
                    {"params": params, "opt_state": opt_state},
                    config=checkpointer.config,
                )
            if restored is not None:
                ck_step, state = restored
            else:
                ck_step, state = start_step, _replace(
                    {"params": params, "opt_state": opt_state}, seed_state
                )
            params, opt_state = state["params"], state["opt_state"]
            res.resumed_from = ck_step
            s = ck_step
            attempt = 0
            continue
        attempt = 0
        res.steps_run += 1
        res.losses[s] = loss
        if on_step is not None:
            on_step(s, loss)
        s += 1
        if checkpointer is not None and checkpoint_every > 0 and s % checkpoint_every == 0:
            checkpointer.dispatch(s, {"params": params, "opt_state": opt_state})
            for rec in checkpointer.harvest():
                if "error" in rec:
                    res.checkpoint_failures.append(rec)

    if checkpointer is not None:
        for rec in checkpointer.wait():
            if "error" in rec:
                res.checkpoint_failures.append(rec)
    res.params, res.opt_state = params, opt_state
    return res
