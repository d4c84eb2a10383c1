"""The train step: forward, backward and optimizer update on one device.

Counterpart of ``thunder_tpu/distributed/api.py`` (``TrainStep`` :183,
``_build`` :322, ``make_train_step`` :821) for a single device.  As in the
reference, the step runs the traced loss: per batch signature it builds
once ``trace_from_fn(loss_fn, (params, *batch), grad_argnums=(0,))`` →
``dce``, ``cse``, ``absorb_ce_widening_converts`` → the forward/backward
split → ``rematerialize_forward_and_backward`` with the policy's knobs →
executor claiming of both traces → ``del_last_used`` and codegen, then
each call runs the forward program, the backward program with a ones
cotangent, and the optimizer:

- ``step(params, opt_state, *batch) -> (params, opt_state, loss)``, the
  same call contract, so the training loop carries over unchanged.  **The
  params and the optimizer state are updated in place** (the port's form of
  the reference's buffer donation) and returned; ``donate=False`` copies
  them first and leaves the caller's tensors as they were.  With
  ``donate=True`` each build also runs the donation analysis over both
  programs (the same pass ``jit`` uses): ``donation_report`` holds the
  per-region summaries and the donated-aware fw/bw peak estimates, and
  :meth:`profile_stats` the one-device keys of the reference's (the
  construction enables the persistent compile cache, as ``jit``'s does).
- ``remat=`` takes the reference's vocabulary (:mod:`..train.remat`):
  ``max_cone`` and ``aggressive`` of the resolved policy drive the trace's
  rematerialization; ``"auto"`` compares ``saved_bytes`` of the forward
  with the device memory, as ``_auto_remat`` does.
- ``executors=`` is the claiming order of both traces (default: cuda ≻
  inductor ≻ torch: the elementwise rest runs in ``torch.compile`` regions
  on the card).  ``quant="int8"|"fp8"`` (reference :407-419) claims the forward
  trace with ``[quantex.ex or quantex.fp8_ex, *executors]`` and the
  backward with ``executors`` alone: the forward's linears and matmuls run
  quantized, the grads stay full precision.  ``fw_trace``/``bw_trace``
  keep the last build's claimed traces,
  ``residual_bytes_no_remat``/``residual_bytes`` its saved residuals before
  and after remat, ``build_ms`` the host time of the build.
- ``accum_steps=k`` splits the batch into k microbatches (traced at
  microbatch shapes), sums their grads into a float32 accumulator in a
  fixed order (microstep 0 first), divides by k and takes the loss as the
  mean of the microbatch means.
- ``grads``, ``apply_gradients`` and ``accumulate`` are the reference's
  accumulation pieces (optimizer-free micro steps, then one update).

:func:`make_eager_train_step` builds the step's plain twin, which computes
the same loss and grads with eager PyTorch autograd (the remat policies as
``torch.utils.checkpoint`` scopes); it is used only where called by name.

The optimizer is any object with ``init(params)`` and ``update(params,
grads, state)`` in place — :func:`thunder_tpu_torch.train.optim.adamw` is
the port's ``optax.adamw``.  A multi-device mesh, ``zero3``,
``overlap``, ``comm_combine_threshold_mb``, ``bucketer``, ``batch_specs``
and ``donate_batch`` are not ported and raise ``NotImplementedError``.
"""
from __future__ import annotations

import math
import os
import time
from dataclasses import dataclass
from typing import Callable, Sequence

import torch

from thunder_tpu_torch._tree import tree_flatten, tree_leaves, tree_map, tree_unflatten
from thunder_tpu_torch.functional import _is_tensor_like
from thunder_tpu_torch.train import remat as _remat
from thunder_tpu_torch.train.accum import split_for_accum

__all__ = ["EagerTrainStep", "TrainStep", "make_eager_train_step", "make_train_step"]


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


def _budget(params) -> int | None:
    """Device memory for ``remat="auto"``: ``THUNDER_TPU_HBM_BYTES``, else
    the card's total memory; None on the CPU."""
    env = os.environ.get("THUNDER_TPU_HBM_BYTES")
    if env:
        return int(env)
    dev = next((x.device for x in tree_leaves(params) if isinstance(x, torch.Tensor)), None)
    if dev is not None and dev.type == "cuda":
        return torch.cuda.mem_get_info(dev)[1]
    return None


@dataclass(frozen=True)
class _Program:
    """One build of the step: the forward and backward programs of one
    input signature, and what the build measured."""

    fw_fn: Callable
    bw_fn: Callable
    fw_trace: object
    bw_trace: object
    decision: _remat.RematDecision
    residual_bytes_no_remat: int
    residual_bytes: int
    build_ms: float
    donation_report: dict | None


class TrainStep:
    """One training step over ``loss_fn(params, *batch) -> scalar``, run
    through the trace."""

    def __init__(self, loss_fn: Callable, optimizer, mesh=None, *, batch_specs=None,
                 donate: bool = True, donate_batch: bool = False, remat: bool | str = True,
                 zero3: bool = False, accum_steps: int = 1, overlap: bool = False,
                 overlap_bucket_mb: float = 4.0, executors=None, quant: str | None = None,
                 comm_combine_threshold_mb: float | None = None,
                 bucketer: Callable | None = None):
        _check_single_device(mesh)
        for name, value, default in (
                ("zero3", zero3, False), ("overlap", overlap, False),
                ("comm_combine_threshold_mb", comm_combine_threshold_mb, None),
                ("bucketer", bucketer, None), ("batch_specs", batch_specs, None),
                ("donate_batch", donate_batch, False)):
            if value != default:
                raise NotImplementedError(f"TrainStep: {name}= is not ported (the port's step "
                                          "runs on one device; ROADMAP.md Queue 1 item 11)")
        if quant not in (None, "int8", "fp8"):
            raise ValueError(f"quant must be None, 'int8', or 'fp8', got {quant!r}")
        _remat.validate_remat(remat)
        if not isinstance(accum_steps, int) or accum_steps < 1:
            raise ValueError(f"accum_steps must be an int >= 1, got {accum_steps!r}")
        from thunder_tpu_torch.core import compile_cache

        compile_cache.ensure_enabled()  # warm-start repeat processes
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.donate = donate
        self.remat = remat
        self.accum_steps = accum_steps
        self.quant = quant
        self._init_executors(executors)
        #: the resolved policy of the last call (train.remat.REMAT_POLICIES)
        self.last_remat_policy: str | None = None
        self.last_remat_applied: bool | None = None
        #: the last build's claimed forward and backward traces
        self.fw_trace = None
        self.bw_trace = None
        self.residual_bytes_no_remat: int | None = None
        self.residual_bytes: int | None = None
        self.build_ms: float | None = None
        #: donation analysis of the last build ({"forward", "backward"}
        #: summaries + donated-aware peak estimates); None until built or
        #: when donate=False
        self.donation_report: dict | None = None
        # input signature -> what its first call built (a _Program; the
        # eager twin keeps its remat decision)
        self._built: dict = {}

    def _init_executors(self, executors) -> None:
        from thunder_tpu_torch.extend import resolve_executors

        self.executors = resolve_executors(executors)

    def init_optimizer_state(self, params):
        return self.optimizer.init(params)

    @staticmethod
    def _signature(params, batch) -> tuple:
        return tuple((tuple(x.shape), x.dtype, x.device) if isinstance(x, torch.Tensor)
                     else (type(x).__name__, x if isinstance(x, (int, float, str, bool)) else None)
                     for x in (*tree_leaves(params), *batch))

    def _program(self, params, opt_state, batch) -> _Program:
        key = self._signature(params, batch)
        prog = self._built.get(key)
        if prog is None:
            prog = self._built[key] = self._build(params, opt_state, batch)
        self.fw_trace, self.bw_trace = prog.fw_trace, prog.bw_trace
        self.residual_bytes_no_remat = prog.residual_bytes_no_remat
        self.residual_bytes = prog.residual_bytes
        self.build_ms = prog.build_ms
        self.donation_report = prog.donation_report
        self.last_remat_policy = prog.decision.policy
        self.last_remat_applied = prog.decision.apply
        return prog

    def _build(self, params, opt_state, batch) -> _Program:
        """The reference's ``_build`` (``thunder_tpu/distributed/api.py:322``)
        for one device: trace, split, rematerialize, claim, generate."""
        from thunder_tpu_torch.core.rematerialization import (
            rematerialize_forward_and_backward,
            saved_bytes,
            saved_for_backward,
        )
        from thunder_tpu_torch.core.transform_common import absorb_ce_widening_converts, cse, dce
        from thunder_tpu_torch.core.transforms import forward_and_backward_from_trace
        from thunder_tpu_torch.executors.passes import (
            del_last_used,
            take_saved,
            transform_for_execution,
        )
        from thunder_tpu_torch.functional import trace_from_fn

        t0 = time.perf_counter()
        trace_results = trace_from_fn(self.loss_fn, (params, *batch), {}, grad_argnums=(0,))
        comp = dce(trace_results.computation_trace)
        comp = cse(comp)
        # before the split, so the backward rule sees the half-precision
        # logits directly (its dlogits cast back to logits.dtype covers it)
        comp = absorb_ce_widening_converts(comp)
        comp.args = trace_results.computation_trace.args
        fw_trace, bw_trace = forward_and_backward_from_trace(comp)
        residual_bytes_no_remat = saved_bytes(fw_trace)
        decision = _remat.resolve_remat(
            self.remat, auto=lambda: self._auto_remat(fw_trace, params, opt_state, batch))
        if decision.apply:
            fw_trace, bw_trace = rematerialize_forward_and_backward(
                fw_trace, bw_trace, max_cone=decision.max_cone, aggressive=decision.aggressive)
        residual_bytes = saved_bytes(fw_trace)
        n_saved = len(saved_for_backward(fw_trace))
        fw_executors = self.executors
        if self.quant is not None:
            from thunder_tpu_torch.executors import quantex

            fw_executors = (quantex.ex if self.quant == "int8" else quantex.fp8_ex,
                            *self.executors)
        fw_trace = transform_for_execution(fw_trace, fw_executors)
        bw_trace = transform_for_execution(bw_trace, self.executors)
        fw_deld, bw_deld = del_last_used(fw_trace), del_last_used(bw_trace)
        fw_fn = fw_deld.python_callable()
        bw_fn = take_saved(bw_deld, n_saved).python_callable()
        report = None
        if self.donate:
            report = self._donation_report(fw_deld, bw_deld, params, decision,
                                           residual_bytes_no_remat, residual_bytes)
        return _Program(fw_fn, bw_fn, fw_trace, bw_trace, decision, residual_bytes_no_remat,
                        residual_bytes, 1e3 * (time.perf_counter() - t0), report)

    def _donation_report(self, fw_deld, bw_deld, params, decision, residual_bytes_no_remat,
                         residual_bytes) -> dict:
        """The donation analysis of both programs (the pass ``jit`` uses,
        reference ``_build``, ``thunder_tpu/distributed/api.py:424-467``): it
        feeds the ``donation.*`` metrics and the donated-aware peak-bytes
        estimates.  The programs run as generated: their residuals already
        die at their ``del`` and the optimizer updates params in place."""
        from thunder_tpu_torch.executors.donation import donation_summary
        from thunder_tpu_torch.executors.passes import annotate_donations
        from thunder_tpu_torch.observability.memory import memory_timeline
        from thunder_tpu_torch.observability.metrics import registry
        from thunder_tpu_torch.train.accum import accum_buffer_bytes

        fw_annotated, fw_donation = annotate_donations(fw_deld, which="trainstep_forward",
                                                       arm=False)
        bw_annotated, bw_donation = annotate_donations(bw_deld, which="trainstep_backward",
                                                       arm=False)
        fw_peak = memory_timeline(fw_annotated)["peak_bytes_estimate"]
        bw_peak = memory_timeline(bw_annotated)["peak_bytes_estimate"]
        # accum_steps=k carries a float32 grad accumulator across the
        # microbatches, real memory the estimate must include
        acc_bytes = accum_buffer_bytes(params) if self.accum_steps > 1 else 0
        report = {
            "forward": donation_summary(fw_donation),
            "backward": donation_summary(bw_donation),
            "fw_peak_bytes_estimate": fw_peak,
            "bw_peak_bytes_estimate": bw_peak,
            "remat_policy": decision.policy,
            "residual_bytes_no_remat": residual_bytes_no_remat,
            "residual_bytes": residual_bytes,
            "accum_steps": self.accum_steps,
            "accum_buffer_bytes": acc_bytes,
            "peak_bytes_estimate": max(fw_peak, bw_peak) + acc_bytes,
        }
        registry().gauge("train.step.peak_bytes_estimate").set(report["peak_bytes_estimate"])
        registry().gauge("train.step.residual_bytes").set(residual_bytes)
        return report

    def profile_stats(self) -> dict:
        """Peak-bytes / policy accounting of the last build (reference
        ``TrainStep.profile_stats``, ``thunder_tpu/distributed/api.py:744``,
        its one-device keys): the resolved remat policy with its
        residual-bytes delta, the donated-aware fw/bw peak estimates and the
        float32 accumulator bytes ``accum_steps=k`` adds.  Needs a built
        step (call the TrainStep once)."""
        if self.last_remat_policy is None:
            raise RuntimeError("profile_stats() needs a built step — run the TrainStep once first")
        out: dict = {"remat_policy": self.last_remat_policy, "accum_steps": self.accum_steps}
        if self.donation_report is not None:
            out.update({k: v for k, v in self.donation_report.items()
                        if k not in ("forward", "backward")})
            if self.donation_report["residual_bytes_no_remat"]:
                out["remat_residual_reduction_frac"] = 1.0 - (
                    self.donation_report["residual_bytes"]
                    / self.donation_report["residual_bytes_no_remat"])
        return out

    def _auto_remat(self, fw_trace, params, opt_state, batch) -> bool:
        """``remat="auto"``: recompute only when the un-rematerialized step
        would not fit device memory with headroom (1.5×): params, optimizer
        state, batch and ``saved_bytes`` of the forward.  Unknown budget
        (the CPU) means remat."""
        from thunder_tpu_torch.core.rematerialization import saved_bytes

        budget = _budget(params)
        if not budget:
            return True
        per_device = _nbytes(params) + _nbytes(opt_state) + _nbytes(batch) + saved_bytes(fw_trace)
        return per_device * 1.5 > budget

    def _value_and_grad(self, params, opt_state, batch):
        """``(loss, grads)``: grads a list in the params' leaf order, zeros
        for leaves that are not floating point."""
        prog = self._program(params, opt_state, batch)
        leaves = tree_leaves(params)
        inputs = [x for x in (*leaves, *tree_leaves(list(batch))) if _is_tensor_like(x)]
        loss, saved = prog.fw_fn(*inputs)
        # the list is the residuals' only holder: the backward program empties
        # it once unpacked, so each residual dies at its last use
        saved = list(saved)
        ct = torch.ones((), dtype=loss.dtype, device=loss.device)
        flat = prog.bw_fn(saved, ct)
        flat = iter(flat if isinstance(flat, (tuple, list)) else (flat,))
        grads = [next(flat) if _differentiable(x) else torch.zeros_like(x) for x in leaves]
        return loss, grads

    def __call__(self, params, opt_state, *batch):
        if not self.donate:
            params, opt_state = _copy(params), _copy(opt_state)
        k = self.accum_steps
        if k == 1:
            loss, grads = self._value_and_grad(params, opt_state, batch)
        else:
            split, mask = split_for_accum(batch, k)
            acc = None
            loss_sum = None
            for i in range(k):
                micro = tuple(b[i] if m else b for b, m in zip(split, mask))
                loss_i, g_i = self._value_and_grad(params, opt_state, micro)
                if acc is None:
                    acc = [g.to(torch.float32, copy=True) for g in g_i]
                    loss_sum = loss_i.to(torch.float32, copy=True)
                else:
                    for a, g in zip(acc, g_i):
                        a.add_(g.to(torch.float32))
                    loss_sum = loss_sum + loss_i.to(torch.float32)
                del g_i
            grads = [(a / k).to(p.dtype) for a, p in zip(acc, tree_leaves(params))]
            loss = loss_sum / k        # mean of microbatch means == batch mean
        self.optimizer.update(params, grads, opt_state)
        return params, opt_state, loss

    def grads(self, params, opt_state, *batch):
        """One micro step: ``(loss, grads)`` with no optimizer update; grads
        in the params' tree structure."""
        loss, grads = self._value_and_grad(params, opt_state, batch)
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


class EagerTrainStep(TrainStep):
    """The step's plain twin: the same loss and grads by eager PyTorch
    autograd, each transformer block under the remat policy's
    ``torch.utils.checkpoint`` scope (:func:`~thunder_tpu_torch.train.remat.run_block`).
    ``"auto"`` measures the residuals by one forward whose saved tensors are
    counted and not kept."""

    def _init_executors(self, executors) -> None:
        if executors is not None or self.quant is not None:
            raise NotImplementedError("EagerTrainStep: executors= and quant= claim a trace; "
                                      "the eager twin runs none")
        self.executors = None

    def _policy(self, params, opt_state, batch) -> str:
        key = self._signature(params, batch)
        decision = self._built.get(key)
        if decision is None:
            decision = self._built[key] = _remat.resolve_remat(
                self.remat, auto=lambda: self._auto_remat(None, params, opt_state, batch))
        self.last_remat_policy, self.last_remat_applied = decision.policy, decision.apply
        return decision.policy

    def _auto_remat(self, fw_trace, params, opt_state, batch) -> bool:
        budget = _budget(params)
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

    def _value_and_grad(self, params, opt_state, batch):
        policy = self._policy(params, opt_state, batch)
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


def _differentiable(x) -> bool:
    return isinstance(x, torch.Tensor) and x.is_floating_point()


def _copy(tree):
    return tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor) else x, tree)


def make_train_step(loss_fn: Callable, optimizer, mesh=None, **kwargs) -> TrainStep:
    """``TrainStep(loss_fn, optimizer, mesh, **kwargs)``: the traced step."""
    return TrainStep(loss_fn, optimizer, mesh, **kwargs)


def make_eager_train_step(loss_fn: Callable, optimizer, mesh=None, **kwargs) -> EagerTrainStep:
    """``EagerTrainStep(loss_fn, optimizer, mesh, **kwargs)``: the traced
    step's plain twin, eager PyTorch autograd."""
    return EagerTrainStep(loss_fn, optimizer, mesh, **kwargs)
