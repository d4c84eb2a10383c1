"""The train step: forward, backward and optimizer update on one device.

Counterpart of ``thunder_tpu/distributed/api.py`` (``TrainStep`` :183,
``make_train_step`` :821) for a single device.  The JAX package traces
``loss_fn``, splits forward from backward, rematerializes on the trace and
compiles one program; the port runs eager PyTorch autograd:

- ``step(params, opt_state, *batch) -> (params, opt_state, loss)``, the
  same call contract, so the training loop carries over unchanged.  **The
  params and the optimizer state are updated in place** (the port's form of
  the reference's buffer donation) and returned; ``donate=False`` copies
  them first and leaves the caller's tensors as they were.
- ``remat=`` takes the reference's vocabulary (:mod:`..train.remat`); the
  policy applies to each transformer block the model runs through
  :func:`~thunder_tpu_torch.train.remat.run_block`.  ``"auto"`` resolves
  once per batch shape by device memory, as ``_auto_remat`` does.
- ``accum_steps=k`` splits the batch into k microbatches, sums their grads
  into a float32 accumulator in a fixed order (microstep 0 first), divides
  by k and takes the loss as the mean of the microbatch means.
- ``grads``, ``apply_gradients`` and ``accumulate`` are the reference's
  accumulation pieces (optimizer-free micro steps, then one update).

The optimizer is any object with ``init(params)`` and ``update(params,
grads, state)`` in place — :func:`thunder_tpu_torch.train.optim.adamw` is
the port's ``optax.adamw``.  A multi-device mesh, ``zero3``, ``quant``,
``overlap``, ``comm_combine_threshold_mb``, ``bucketer``, ``batch_specs``,
``donate_batch`` and ``executors`` are not ported and raise
``NotImplementedError``.
"""
from __future__ import annotations

import math
import os
from typing import Callable, Sequence

import torch

from thunder_tpu_torch._tree import tree_flatten, tree_leaves, tree_map, tree_unflatten
from thunder_tpu_torch.train import remat as _remat
from thunder_tpu_torch.train.accum import split_for_accum

__all__ = ["TrainStep", "make_train_step"]


def _nbytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree)
               if isinstance(x, torch.Tensor))


def _check_single_device(mesh) -> None:
    """``mesh``: None, or axis sizes (``{"dp": 1}``) whose product is 1."""
    if mesh is None:
        return
    if not isinstance(mesh, dict):
        raise TypeError(f"mesh must be None or a dict of axis sizes, got {type(mesh).__name__}")
    if math.prod(int(n) for n in mesh.values()) != 1:
        raise NotImplementedError(f"TrainStep: multi-device meshes ({mesh}) are not ported; "
                                  "the port trains on one device")


class TrainStep:
    """One training step over ``loss_fn(params, *batch) -> scalar``."""

    def __init__(self, loss_fn: Callable, optimizer, mesh=None, *, batch_specs=None,
                 donate: bool = True, donate_batch: bool = False, remat: bool | str = True,
                 zero3: bool = False, accum_steps: int = 1, overlap: bool = False,
                 overlap_bucket_mb: float = 4.0, executors=None, quant: str | None = None,
                 comm_combine_threshold_mb: float | None = None,
                 bucketer: Callable | None = None):
        _check_single_device(mesh)
        for name, value, default in (
                ("zero3", zero3, False), ("quant", quant, None), ("overlap", overlap, False),
                ("comm_combine_threshold_mb", comm_combine_threshold_mb, None),
                ("bucketer", bucketer, None), ("batch_specs", batch_specs, None),
                ("donate_batch", donate_batch, False), ("executors", executors, None)):
            if value != default:
                raise NotImplementedError(f"TrainStep: {name}= is not ported (the port's step "
                                          "is single-device eager autograd)")
        _remat.validate_remat(remat)
        if not isinstance(accum_steps, int) or accum_steps < 1:
            raise ValueError(f"accum_steps must be an int >= 1, got {accum_steps!r}")
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.donate = donate
        self.remat = remat
        self.accum_steps = accum_steps
        #: the resolved policy of the last call (train.remat.REMAT_POLICIES)
        self.last_remat_policy: str | None = None
        self.last_remat_applied: bool | None = None
        self._policies: dict = {}        # batch signature -> resolved policy

    def init_optimizer_state(self, params):
        return self.optimizer.init(params)

    @staticmethod
    def _batch_key(batch) -> tuple:
        return tuple((tuple(b.shape), str(b.dtype)) if isinstance(b, torch.Tensor)
                     else (type(b).__name__,) for b in batch)

    def _policy(self, params, opt_state, batch) -> str:
        key = self._batch_key(batch)
        if key not in self._policies:
            decision = _remat.resolve_remat(
                self.remat, auto=lambda: self._auto_remat(params, opt_state, batch))
            self._policies[key] = decision
        decision = self._policies[key]
        self.last_remat_policy, self.last_remat_applied = decision.policy, decision.apply
        return decision.policy

    def _auto_remat(self, params, opt_state, batch) -> bool:
        """``remat="auto"``: recompute only when the un-rematerialized step
        would not fit device memory with headroom (1.5×).  The budget is
        ``THUNDER_TPU_HBM_BYTES``, else the card's total memory; unknown
        (the CPU) means remat.  The residuals are measured by one forward
        whose saved tensors are counted and not kept."""
        env = os.environ.get("THUNDER_TPU_HBM_BYTES")
        budget = int(env) if env else None
        dev = next((x.device for x in tree_leaves(params) if isinstance(x, torch.Tensor)), None)
        if budget is None and dev is not None and dev.type == "cuda":
            budget = torch.cuda.mem_get_info(dev)[1]
        if not budget:
            return True
        saved = 0

        def pack(t):
            nonlocal saved
            if not (t.requires_grad and t.grad_fn is None):   # params are counted below
                saved += t.numel() * t.element_size()

        def unpack(_):
            raise RuntimeError("the residual probe's graph is never differentiated")

        leaves, spec = tree_flatten(params)
        inputs = [x.detach().requires_grad_() if _differentiable(x) else x for x in leaves]
        with torch.enable_grad(), torch.autograd.graph.saved_tensors_hooks(pack, unpack):
            self.loss_fn(tree_unflatten(spec, inputs), *batch)
        per_device = _nbytes(params) + _nbytes(opt_state) + _nbytes(batch) + saved
        return per_device * 1.5 > budget

    def _value_and_grad(self, params, batch, policy: str):
        """``(loss, grads)``: grads a list in the params' leaf order, zeros
        for leaves the loss does not reach."""
        leaves, spec = tree_flatten(params)
        inputs = [x.detach().requires_grad_() if _differentiable(x) else x for x in leaves]
        with torch.enable_grad(), _remat.policy_scope(policy):
            loss = self.loss_fn(tree_unflatten(spec, inputs), *batch)
        wrt = [x for x in inputs if isinstance(x, torch.Tensor) and x.requires_grad]
        got = iter(torch.autograd.grad(loss, wrt, allow_unused=True))
        grads = []
        for x in inputs:
            g = next(got) if isinstance(x, torch.Tensor) and x.requires_grad else None
            grads.append(torch.zeros_like(x) if g is None else g)
        return loss.detach(), grads

    def __call__(self, params, opt_state, *batch):
        policy = self._policy(params, opt_state, batch)
        if not self.donate:
            params, opt_state = _copy(params), _copy(opt_state)
        k = self.accum_steps
        if k == 1:
            loss, grads = self._value_and_grad(params, batch, policy)
        else:
            split, mask = split_for_accum(batch, k)
            acc = None
            loss_sum = None
            for i in range(k):
                micro = tuple(b[i] if m else b for b, m in zip(split, mask))
                loss_i, g_i = self._value_and_grad(params, micro, policy)
                if acc is None:
                    acc = [g.to(torch.float32, copy=True) for g in g_i]
                    loss_sum = loss_i.to(torch.float32, copy=True)
                else:
                    for a, g in zip(acc, g_i):
                        a.add_(g.to(torch.float32))
                    loss_sum = loss_sum + loss_i.to(torch.float32)
            grads = [(a / k).to(p.dtype) for a, p in zip(acc, tree_leaves(params))]
            loss = loss_sum / k        # mean of microbatch means == batch mean
        self.optimizer.update(params, grads, opt_state)
        return params, opt_state, loss

    def grads(self, params, opt_state, *batch):
        """One micro step: ``(loss, grads)`` with no optimizer update; grads
        in the params' tree structure."""
        loss, grads = self._value_and_grad(params, batch, self._policy(params, opt_state, batch))
        return loss, tree_unflatten(tree_flatten(params)[1], grads)

    def apply_gradients(self, params, opt_state, grads, *, batch_template=None):
        """Runs the optimizer on externally accumulated ``grads`` (a tree
        like the params); returns ``(params, opt_state)``, updated in place.
        ``batch_template`` is accepted for the reference's signature."""
        del batch_template
        if not self.donate:
            params, opt_state = _copy(params), _copy(opt_state)
        self.optimizer.update(params, grads, opt_state)
        return params, opt_state

    def accumulate(self, params, opt_state, micro_batches: Sequence):
        """Gradient accumulation: one optimizer update over N micro batches
        (grads summed in their dtype, then averaged).  Returns
        ``(params, opt_state, mean_loss)``."""
        n = len(micro_batches)
        if n == 0:
            raise ValueError("accumulate needs at least one micro batch")
        acc = None
        total = 0.0
        for mb in micro_batches:
            loss, g = self.grads(params, opt_state, *mb)
            acc = g if acc is None else tree_map(torch.add, acc, g)
            total = total + loss
        acc = tree_map(lambda x: x / n, acc)
        params, opt_state = self.apply_gradients(params, opt_state, acc)
        return params, opt_state, total / n


def _differentiable(x) -> bool:
    return isinstance(x, torch.Tensor) and x.is_floating_point()


def _copy(tree):
    return tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor) else x, tree)


def make_train_step(loss_fn: Callable, optimizer, mesh=None, **kwargs) -> TrainStep:
    """``TrainStep(loss_fn, optimizer, mesh, **kwargs)``."""
    return TrainStep(loss_fn, optimizer, mesh, **kwargs)
