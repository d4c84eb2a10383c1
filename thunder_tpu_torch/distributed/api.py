"""The train step: forward, backward and optimizer update, on one device or
sharded over a mesh of ranks.

Counterpart of ``thunder_tpu/distributed/api.py`` (``ddp`` :86, ``fsdp``
:92, ``tp_fsdp`` :107, ``default_batch_shardings`` :117, ``TrainStep``
:183, ``_build`` :322, ``make_train_step`` :821).  As in the reference, the
step runs the traced loss: per batch signature it builds once
``trace_from_fn(loss_fn, (params, *batch), grad_argnums=(0,))`` → ``dce``,
``cse``, ``absorb_ce_widening_converts`` → the forward/backward split →
``rematerialize_forward_and_backward`` with the policy's knobs → executor
claiming of both traces → ``del_last_used`` and codegen, then each call
runs the forward program, the backward program with a ones cotangent, and
the optimizer:

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
- ``grads``, ``apply_gradients``, ``accumulate`` and ``no_sync`` are the
  reference's accumulation pieces (optimizer-free micro steps, then one
  update).  ``bucketer=`` pads each batch first
  (:func:`~thunder_tpu_torch.models.llama.batch_bucketer`).

**Sharded steps** (``mesh=`` a ``DeviceMesh`` of
:func:`~thunder_tpu_torch.distributed.sharding.make_mesh`, or axis sizes
to build one) run explicit SPMD, the design of Lightning Thunder's own
DDP/FSDP transforms where the reference lets GSPMD partition one program:
each rank is one process with one device; the params are DTensors
placed by :func:`ddp`, :func:`fsdp` or :func:`tp_fsdp`; the programs see
plain local tensors and the collectives are prims in their traces
(:mod:`~thunder_tpu_torch.distributed.prims`):

- the caller passes the global batch, the same on every rank; each rank
  takes its slice by ``batch_specs`` (default
  :func:`default_batch_shardings`), and the returned loss is the mean over
  the data axes (``dp``, ``fsdp``), an ``all_reduce`` at the end of the
  forward program;
- the traced loss puts a ``synchronize`` on each param input: a param
  sharded over an axis is all-gathered there, and its grad leaves the
  backward as a reduce-scatter of the mean; a replicated param passes, and
  its grad leaves as an all-reduce of the mean over the data axes (a
  sharded param of a ``dp`` × ``fsdp`` mesh also takes the all-reduce over
  ``dp``).  ``comm_combine_threshold_mb`` coalesces them into buckets of
  at most that size, one collective per bucket (``combine_threshold_options``);
- ``zero3=True`` forces ``full_block`` remat, which recomputes the
  all-gathers in the backward (``regather``); ZeRO-2 keeps the gathered
  params as residuals;
- ``overlap=True`` (pure ``dp`` meshes) turns the grads' all-reduces into
  one asynchronous all-reduce per ``overlap_bucket_mb`` bucket
  (:func:`~thunder_tpu_torch.train.overlap.bucketed_grad_sync`);
- the optimizer runs on the local shards, and its state is placed as each
  param is (ZeRO's property: a sharded param's state is sharded);
- the flash kernels and ``flash_ce`` launch on each rank's local batch,
  counted in ``cudaex.DISPATCH["sharded"]``; ``collectives`` holds the
  last call's collectives by kind.

A mesh whose ``tp`` (or any non-data) axis is larger than 1 raises: tensor
parallelism is the next slice (``ROADMAP.md`` Queue 1 item 12).

:func:`make_eager_train_step` builds the step's plain twin, which computes
the same loss and grads with eager PyTorch autograd (the remat policies as
``torch.utils.checkpoint`` scopes), on one device; it is used only where
called by name.

The optimizer is any object with ``init(params)`` and ``update(params,
grads, state)`` in place — :func:`thunder_tpu_torch.train.optim.adamw` is
the port's ``optax.adamw``.
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

__all__ = ["EagerTrainStep", "TrainStep", "combine_threshold_options", "ddp",
           "default_batch_shardings", "fsdp", "make_eager_train_step", "make_train_step", "tp_fsdp"]

#: mesh axes a batch splits over; every other axis must be trivial here
DATA_AXES = ("dp", "fsdp")
_NEXT_SLICE = ("tensor parallelism (tp > 1) is the next slice of the port "
               "(ROADMAP.md Queue 1 item 12)")


def _nbytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree)
               if isinstance(x, torch.Tensor))


def _resolve_mesh(mesh):
    """``mesh`` as the step runs it: None for one device (no mesh, or axis
    sizes whose product is 1 when no process group is initialized), else a
    ``DeviceMesh`` (axis sizes build one with ``make_mesh``)."""
    import torch.distributed as dist

    from thunder_tpu_torch.distributed.sharding import make_mesh, mesh_shape

    if mesh is None:
        return None
    if isinstance(mesh, dict):
        if math.prod(int(n) for n in mesh.values()) == 1 and not (
                dist.is_available() and dist.is_initialized()):
            return None
        mesh = make_mesh(mesh)
    extra = {a: n for a, n in mesh_shape(mesh).items() if a not in DATA_AXES and n > 1}
    if extra:
        raise NotImplementedError(f"TrainStep: mesh axes {extra}: the port's sharded step splits "
                                  f"the data axes {DATA_AXES} only; {_NEXT_SLICE}")
    return mesh


def _check_tp(mesh) -> None:
    from thunder_tpu_torch.distributed.sharding import mesh_shape

    if mesh_shape(mesh).get("tp", 1) > 1:
        raise NotImplementedError(f"tp_fsdp on {mesh_shape(mesh)}: {_NEXT_SLICE}")


def ddp(params, mesh):
    """Replicates every param over the mesh (reference :86); each rank holds
    a copy, as a ``DTensor``.  The step all-reduces the grads."""
    from thunder_tpu_torch.distributed.sharding import apply_shardings, ddp_shardings

    return apply_shardings(params, ddp_shardings(params, mesh), mesh)


def fsdp(params, mesh, *, axis: str = "fsdp", min_size: int = 2**10):
    """Shards every large param's dim 0 over ``axis`` (reference :92); the
    step all-gathers them and reduce-scatters their grads.  ZeRO-2 or
    ZeRO-3 is the step's ``zero3=`` (keep or re-gather the gathered params
    for the backward)."""
    from thunder_tpu_torch.distributed.sharding import apply_shardings, fsdp_shardings

    return apply_shardings(params, fsdp_shardings(params, mesh, axis=axis, min_size=min_size),
                           mesh)


def tp_fsdp(params, mesh, rules=None):
    """Tensor-parallel × FSDP placement by model rules (reference :107;
    default the llama rules).  Only a ``tp`` axis of size 1 is ported: the
    rules' ``fsdp`` entries place the params."""
    from thunder_tpu_torch.distributed.sharding import apply_shardings, llama_shardings

    _check_tp(mesh)
    specs = llama_shardings(params, mesh) if rules is None else rules.shardings(params, mesh)
    return apply_shardings(params, specs, mesh)


def default_batch_shardings(mesh, batch: Sequence) -> tuple:
    """Default batch specs when no ``batch_specs`` are given (reference
    :117).  An arg is data-sharded iff its leading dim equals the batch size
    AND it is integer-typed (token ids / targets) or matches ``batch[0]``'s
    leading-shape prefix; a float side input whose dim 0 only happens to
    equal B (a (T, d) rope cache when T == B) replicates, with a warning."""
    import warnings

    from thunder_tpu_torch.distributed.sharding import P, _prune_spec, batch_spec

    bspec = batch_spec(mesh)
    b0_shape = tuple(getattr(batch[0], "shape", ()))
    bsz = b0_shape[0] if b0_shape else None

    def _data_sharded(b) -> bool:
        shp = tuple(getattr(b, "shape", ()))
        if not shp or shp[0] != bsz:
            return False
        if isinstance(b, torch.Tensor) and not (b.is_floating_point() or b.is_complex()):
            return True
        k = min(len(shp), len(b0_shape))
        return shp[:k] == b0_shape[:k]

    decisions = tuple(_data_sharded(b) for b in batch)
    for i, (b, sharded) in enumerate(zip(batch, decisions)):
        shp = tuple(getattr(b, "shape", ()))
        if not sharded and shp and shp[0] == bsz:
            warnings.warn(
                f"batch arg {i} (shape {shp}) has leading dim == batch size but is "
                f"replicated by the default heuristic; pass batch_specs to shard it",
                stacklevel=3,
            )
    return tuple(_prune_spec(bspec, tuple(b.shape), mesh) if sharded else P()
                 for b, sharded in zip(batch, decisions))


def combine_threshold_options(threshold_mb: float | None) -> dict[str, int]:
    """The collective-combining threshold (reference :77, where it becomes
    XLA compiler options): the byte cap of the buckets that coalesce the
    sharded step's param all-gathers, grad reduce-scatters and replicated
    grads' all-reduces.  Empty for None (one collective per param)."""
    if threshold_mb is None:
        return {}
    return {"combine_threshold_bytes": int(threshold_mb * 2**20)}


def _local(x):
    """A DTensor's local shard (its storage: in-place writes reach it); any
    other leaf as it is.  ``DTensor.from_local`` keeps a view of the tensor
    it was given; the programs take that tensor itself, so that a fusion
    region compiled for plain tensors (phase 10's, on the card) is not
    called with a view (a view input failed inside dynamo there)."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    t = x.to_local()
    base = t._base
    if (base is not None and base.dtype == t.dtype and base.shape == t.shape
            and base.stride() == t.stride() and base.storage_offset() == t.storage_offset()):
        return base
    return t


def _local_tree(tree):
    with torch.no_grad():
        return tree_map(_local, tree)


def _place_like(state, params, mesh):
    """The optimizer ``state``'s local tensors as DTensors on ``mesh``: a
    leaf of a subtree shaped like the params, whose shape is its param's
    local shape, takes that param's placements; every other tensor is
    replicated (so the state of a sharded param is sharded: ZeRO)."""
    from torch.distributed.tensor import DTensor, Replicate

    p_leaves, p_spec = tree_flatten(params)

    def place(sub):
        leaves, spec = tree_flatten(sub)
        like = p_leaves if spec == p_spec else [None] * len(leaves)
        out = []
        for x, p in zip(leaves, like):
            if not isinstance(x, torch.Tensor):
                out.append(x)
            elif isinstance(p, DTensor) and tuple(x.shape) == tuple(p.to_local().shape):
                out.append(DTensor.from_local(x, mesh, p.placements, run_check=False,
                                              shape=p.shape, stride=p.stride()))
            else:
                out.append(DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                                              run_check=False))
        return tree_unflatten(spec, out)

    if isinstance(state, dict):
        return {k: place(v) for k, v in state.items()}
    return place(state)


def _as_placed(grads, params):
    """Local grads (a leaf list in the params' order) as a tree placed like
    ``params``."""
    from torch.distributed.tensor import DTensor

    leaves, spec = tree_flatten(params)
    out = [DTensor.from_local(g, p.device_mesh, p.placements, run_check=False, shape=p.shape,
                              stride=p.stride()) if isinstance(p, DTensor) else g
           for g, p in zip(grads, leaves)]
    return tree_unflatten(spec, out)


@dataclass(frozen=True)
class _Sync:
    """One ``synchronize`` of the sharded step's loss: the param leaves it
    takes (one, or a combined bucket), the axes and size it gathers or
    reduces over, whether the params are sharded (on ``dim``), and the data
    axes a sharded param is replicated over (its grad's extra all-reduce)."""

    idx: tuple
    axes: object
    size: int
    sharded: bool
    dim: int = 0
    over: object = None
    over_size: int = 1


def _sync_plan(leaves, specs, mesh, data_axes, threshold_bytes, combine_replicated) -> list:
    """The synchronizes of the params' leaves, in leaf order; with a
    threshold, consecutive leaves of the same kind coalesce into buckets of
    at most that many bytes."""
    from thunder_tpu_torch.distributed.sharding import _axes, mesh_shape

    sizes = mesh_shape(mesh)
    data = tuple(data_axes)
    kinds = []
    for i, (x, spec) in enumerate(zip(leaves, specs)):
        if not (isinstance(x, torch.Tensor) and x.is_floating_point()):
            continue
        split = [(d, _axes(e)) for d, e in enumerate(spec) if e is not None]
        if len(split) > 1:
            raise NotImplementedError(f"param {i}: split on dims {[d for d, _ in split]}; the "
                                      f"sharded step gathers one dim")
        if not split:
            kinds.append((i, (_one(data), math.prod(sizes[a] for a in data), False, 0, None, 1)))
            continue
        dim, axes = split[0]
        rest = tuple(a for a in data if a not in axes and sizes[a] > 1)
        kinds.append((i, (_one(axes), math.prod(sizes[a] for a in axes), True, dim,
                          _one(rest) if rest else None, math.prod(sizes[a] for a in rest))))
    plan: list[_Sync] = []
    cur: list = []
    cur_bytes = 0
    for i, kind in kinds:
        nb = leaves[i].numel() * leaves[i].element_size()
        combine = threshold_bytes is not None and (kind[2] or combine_replicated)
        if cur and (not combine or cur[0][1] != kind or cur_bytes + nb > threshold_bytes):
            plan.append(_Sync(tuple(j for j, _ in cur), *cur[0][1]))
            cur, cur_bytes = [], 0
        cur.append((i, kind))
        cur_bytes += nb
    if cur:
        plan.append(_Sync(tuple(j for j, _ in cur), *cur[0][1]))
    return plan


def _one(axes):
    """An axis tuple as the prims print it: a lone axis by its name."""
    axes = tuple(axes)
    return axes[0] if len(axes) == 1 else axes


def _synchronized(loss_fn, plan):
    """``loss_fn`` over local params: each param leaf through its
    ``synchronize`` (after the data-axes one of a sharded leaf of a hybrid
    mesh), then the loss of the full params."""
    from thunder_tpu_torch.distributed import prims as dp

    def synced_loss(params, *batch):
        leaves, spec = tree_flatten(params)
        full = list(leaves)
        for s in plan:
            vals = tuple(full[i] for i in s.idx)
            one = len(vals) == 1
            x = vals[0] if one else vals
            if s.over is not None:
                x = dp.synchronize(x, s.over, s.over_size, False)
            x = dp.synchronize(x, s.axes, s.size, s.sharded, s.dim)
            for i, v in zip(s.idx, (x,) if one else x):
                full[i] = v
        return loss_fn(tree_unflatten(spec, full), *batch)

    return synced_loss


def _mean_loss(fw_trace, axes):
    """The forward trace with its loss replaced by the mean over the data
    axes (one all_reduce before the return)."""
    from thunder_tpu_torch.core.prims import PrimIDs, python_return
    from thunder_tpu_torch.core.trace import from_trace, tracectx
    from thunder_tpu_torch.distributed import prims as dp

    new = from_trace(fw_trace)
    body = [b for b in fw_trace.bound_symbols if b.sym.id is not PrimIDs.RETURN]
    ret = next(b for b in fw_trace.bound_symbols if b.sym.id is PrimIDs.RETURN)
    loss, saved = ret.args
    with tracectx(new), new.push_scope() as tail:
        mean = dp.all_reduce(loss, axes, dp.DistributedReduceOps.MEAN)
        python_return(mean, saved)
    new.bound_symbols = body + list(tail)
    new.set_provenance("The loss's mean over the data axes")
    return new


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
    overlap_report: dict | None = None


class TrainStep:
    """One training step over ``loss_fn(params, *batch) -> scalar``, run
    through the trace, on one device or sharded over ``mesh``."""

    def __init__(self, loss_fn: Callable, optimizer, mesh=None, *, batch_specs=None,
                 donate: bool = True, donate_batch: bool = False, remat: bool | str = True,
                 zero3: bool = False, accum_steps: int = 1, overlap: bool = False,
                 overlap_bucket_mb: float = 4.0, executors=None, quant: str | None = None,
                 comm_combine_threshold_mb: float | None = None,
                 bucketer: Callable | None = None):
        if quant not in (None, "int8", "fp8"):
            raise ValueError(f"quant must be None, 'int8', or 'fp8', got {quant!r}")
        _remat.validate_remat(remat)
        if not isinstance(accum_steps, int) or accum_steps < 1:
            raise ValueError(f"accum_steps must be an int >= 1, got {accum_steps!r}")
        from thunder_tpu_torch.core import compile_cache

        compile_cache.ensure_enabled()  # warm-start repeat processes
        self.mesh = _resolve_mesh(mesh)
        if overlap and self.mesh is not None:
            from thunder_tpu_torch.train.overlap import validate_overlap_mesh

            validate_overlap_mesh(self.mesh)
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.donate = donate
        #: accepted for the reference's signature: the port's programs never
        #: free a tensor the caller holds, so there is nothing to donate
        self.donate_batch = donate_batch
        self.remat = remat
        self.zero3 = zero3
        self.accum_steps = accum_steps
        self.quant = quant
        self.batch_specs = batch_specs
        self.overlap = overlap
        self.overlap_bucket_mb = overlap_bucket_mb
        self.comm_combine_threshold_mb = comm_combine_threshold_mb
        self.compiler_options = combine_threshold_options(comm_combine_threshold_mb)
        self.bucketer = bucketer
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
        #: bucket/overlap accounting of the last build (overlap=True)
        self.overlap_report: dict | None = None
        #: collectives the last call issued, by kind (a sharded step)
        self.collectives: dict | None = None
        # input signature -> what its first call built (a _Program; the
        # eager twin keeps its remat decision)
        self._built: dict = {}

    def _init_executors(self, executors) -> None:
        from thunder_tpu_torch.extend import resolve_executors

        self.executors = resolve_executors(executors)

    def init_optimizer_state(self, params):
        """The optimizer's state; on a mesh built on the local shards and
        placed as each param is (reference :307)."""
        if self.mesh is None:
            return self.optimizer.init(params)
        return _place_like(self.optimizer.init(_local_tree(params)), params, self.mesh)

    @property
    def data_axes(self) -> tuple:
        """The mesh axes the batch splits over (all of them when the mesh
        has neither ``dp`` nor ``fsdp``)."""
        names = tuple(self.mesh.mesh_dim_names)
        return tuple(a for a in names if a in DATA_AXES) or names

    @staticmethod
    def _signature(params, batch) -> tuple:
        return tuple((tuple(x.shape), x.dtype, x.device) if isinstance(x, torch.Tensor)
                     else (type(x).__name__, x if isinstance(x, (int, float, str, bool)) else None)
                     for x in (*tree_leaves(params), *batch))

    def _program(self, params, opt_state, batch, specs=()) -> _Program:
        key = (self._signature(params, batch), specs)
        prog = self._built.get(key)
        if prog is None:
            prog = self._built[key] = self._build(params, opt_state, batch, specs)
        self.fw_trace, self.bw_trace = prog.fw_trace, prog.bw_trace
        self.residual_bytes_no_remat = prog.residual_bytes_no_remat
        self.residual_bytes = prog.residual_bytes
        self.build_ms = prog.build_ms
        self.donation_report = prog.donation_report
        self.overlap_report = prog.overlap_report
        self.last_remat_policy = prog.decision.policy
        self.last_remat_applied = prog.decision.apply
        return prog

    def _build(self, params, opt_state, batch, specs=()) -> _Program:
        """The reference's ``_build`` (``thunder_tpu/distributed/api.py:322``):
        trace, split, rematerialize, claim, generate.  On a mesh ``params``
        are the local shards, ``specs`` their placements and ``batch`` this
        rank's slice."""
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

        loss_fn = self.loss_fn
        if self.mesh is not None:
            threshold = self.compiler_options.get("combine_threshold_bytes")
            plan = _sync_plan(tree_leaves(params), specs, self.mesh, self.data_axes, threshold,
                              combine_replicated=not self.overlap)
            loss_fn = _synchronized(self.loss_fn, plan)
        t0 = time.perf_counter()
        trace_results = trace_from_fn(loss_fn, (params, *batch), {}, grad_argnums=(0,))
        comp = dce(trace_results.computation_trace)
        comp = cse(comp)
        # before the split, so the backward rule sees the half-precision
        # logits directly (its dlogits cast back to logits.dtype covers it)
        comp = absorb_ce_widening_converts(comp)
        comp.args = trace_results.computation_trace.args
        fw_trace, bw_trace = forward_and_backward_from_trace(comp)
        residual_bytes_no_remat = saved_bytes(fw_trace)
        decision = _remat.resolve_remat(
            self.remat, zero3=self.zero3,
            auto=lambda: self._auto_remat(fw_trace, params, opt_state, batch))
        if decision.apply:
            fw_trace, bw_trace = rematerialize_forward_and_backward(
                fw_trace, bw_trace, max_cone=decision.max_cone, aggressive=decision.aggressive,
                regather=self.zero3)
        residual_bytes = saved_bytes(fw_trace)
        n_saved = len(saved_for_backward(fw_trace))
        overlap = None
        if self.mesh is not None:
            fw_trace = _mean_loss(fw_trace, _one(self.data_axes))
            if self.overlap:
                bw_trace, overlap = self._bucketed(bw_trace)
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
                        residual_bytes, 1e3 * (time.perf_counter() - t0), report, overlap)

    def _bucketed(self, bw_trace):
        """``overlap=True``: the backward with its grads' all-reduces in
        ``overlap_bucket_mb`` buckets (reference :521-536), and the
        bucket accounting."""
        from thunder_tpu_torch.core.prims import PrimIDs
        from thunder_tpu_torch.distributed import prims as dp
        from thunder_tpu_torch.train.overlap import (
            assign_buckets,
            bucketed_grad_sync,
            overlap_report,
        )

        producer = {o.name: b for b in bw_trace.bound_symbols for o in b.flat_proxy_outs}
        ret = next(b for b in bw_trace.bound_symbols if b.sym.id is PrimIDs.RETURN)
        grads = list(ret.args[0])
        synced = [j for j, g in enumerate(grads)
                  if getattr(producer.get(g.name), "sym", None) is not None
                  and producer[g.name].sym.id is dp.DistPrimIDs.ALL_REDUCE]
        leaves = [grads[j] for j in synced]
        buckets = [[synced[i] for i in b] for b in assign_buckets(leaves, self.overlap_bucket_mb)]
        report = overlap_report(leaves, assign_buckets(leaves, self.overlap_bucket_mb),
                                self.overlap_bucket_mb)
        return bucketed_grad_sync(bw_trace, axis=_one(self.data_axes), buckets=buckets), report

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
        if self.overlap_report is not None:
            out["overlap"] = dict(self.overlap_report)
        if self.collectives is not None:
            out["collectives"] = dict(self.collectives)
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
        for leaves that are not floating point.  On a mesh ``params`` and
        ``opt_state`` are placed, ``batch`` is this rank's slice and the
        grads are local."""
        specs = ()
        if self.mesh is not None:
            from thunder_tpu_torch.distributed.sharding import spec_of

            specs = tuple(spec_of(x) for x in tree_leaves(params))
            params, opt_state = _local_tree(params), _local_tree(opt_state)
        prog = self._program(params, opt_state, batch, specs)
        leaves = tree_leaves(params)
        inputs = [x for x in (*leaves, *tree_leaves(list(batch))) if _is_tensor_like(x)]
        with self._mesh_context():
            loss, saved = prog.fw_fn(*inputs)
            # the list is the residuals' only holder: the backward program
            # empties it once unpacked, so each residual dies at its last use
            saved = list(saved)
            ct = torch.ones((), dtype=loss.dtype, device=loss.device)
            flat = prog.bw_fn(saved, ct)
        flat = iter(flat if isinstance(flat, (tuple, list)) else (flat,))
        grads = [next(flat) if _differentiable(x) else torch.zeros_like(x) for x in leaves]
        return loss, grads

    def _mesh_context(self):
        """Publishes the mesh while the programs run: the collectives resolve
        their axes on it, and the kernels count their dispatches as sharded
        (reference ``_mesh_context`` :692)."""
        import contextlib

        if self.mesh is None:
            return contextlib.nullcontext()
        from thunder_tpu_torch.executors.cudaex import mesh_context

        return mesh_context(self.mesh)

    def _prepare(self, batch) -> tuple:
        """The bucketer's padded batch (reference :699), then on a mesh this
        rank's slice of it by ``batch_specs`` (default
        :func:`default_batch_shardings`)."""
        if self.bucketer is not None:
            batch = tuple(self.bucketer(batch))
        if self.mesh is None:
            return tuple(batch)
        from thunder_tpu_torch.distributed.sharding import _prune_spec, local_slices

        if self.batch_specs is None:
            specs = default_batch_shardings(self.mesh, batch)
        else:
            specs = tuple(_prune_spec(sp, tuple(b.shape), self.mesh) if hasattr(b, "shape")
                          else sp for sp, b in zip(self.batch_specs, batch))
        return tuple(b[local_slices(tuple(b.shape), sp, self.mesh)]
                     if isinstance(b, torch.Tensor) and len(sp) else b
                     for b, sp in zip(batch, specs))

    def _counted(self, fn, *args):
        """``fn(*args)``, with the collectives it issued kept in
        ``collectives`` (a sharded step)."""
        if self.mesh is None:
            return fn(*args)
        from thunder_tpu_torch.distributed.prims import COLLECTIVES

        before = dict(COLLECTIVES)
        out = fn(*args)
        self.collectives = {k: COLLECTIVES[k] - before[k] for k in COLLECTIVES}
        return out

    def _update(self, params, grads, opt_state) -> None:
        """The optimizer, in place on the local shards."""
        if self.mesh is None:
            self.optimizer.update(params, grads, opt_state)
            return
        with torch.no_grad():
            self.optimizer.update(_local_tree(params), [_local(g) for g in tree_leaves(grads)],
                                  _local_tree(opt_state))

    def __call__(self, params, opt_state, *batch):
        return self._counted(self._step, params, opt_state, self._prepare(batch))

    def _step(self, params, opt_state, batch):
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
        self._update(params, grads, opt_state)
        return params, opt_state, loss

    def grads(self, params, opt_state, *batch):
        """One micro step: ``(loss, grads)`` with no optimizer update; grads
        in the params' tree structure (and, on a mesh, their placements)."""
        loss, grads = self._counted(self._value_and_grad, params, opt_state,
                                    self._prepare(batch))
        if self.mesh is not None:
            return loss, _as_placed(grads, params)
        return loss, tree_unflatten(tree_flatten(params)[1], grads)

    def no_sync(self):
        """The reference's alias (``thunder/distributed/__init__.py:200``,
        reference :769): a context yielding the micro step :meth:`grads` —
        (loss, grads) with no optimizer update.  As in the reference the
        grads' collectives still run each micro step: this skips the
        optimizer, not the reduction."""
        import contextlib

        return contextlib.nullcontext(self.grads)

    def apply_gradients(self, params, opt_state, grads, *, batch_template=None):
        """Runs the optimizer on externally accumulated ``grads`` (a tree
        like the params, placed like them on a mesh); returns ``(params,
        opt_state)``, updated in place.  ``batch_template`` is accepted for
        the reference's signature."""
        del batch_template
        if not self.donate:
            params, opt_state = _copy(params), _copy(opt_state)
        self._update(params, grads, opt_state)
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
        if self.mesh is not None:
            raise NotImplementedError("EagerTrainStep runs on one device; the sharded step is "
                                      "TrainStep(mesh=...)")
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
