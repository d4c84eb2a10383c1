"""Bucketed gradient all-reduces that overlap the backward.

Counterpart of ``thunder_tpu/train/overlap.py``.  Production DDP stacks
bucket the gradients (torch DDP's ``bucket_cap_mb``) and issue one
collective per bucket as soon as its gradients exist, so the reductions of
the early buckets run under the rest of the backward.  The reference issues
one variadic ``psum`` per bucket inside ``shard_map`` and leaves their
placement to XLA's scheduler.  The port's sharded step runs its backward
program in trace order, so :func:`bucketed_grad_sync` rewrites that
program: the per-parameter all-reduces of the data-parallel grads become
one asynchronous all-reduce per bucket over a flat buffer
(``all_reduce(..., async_op=True)``), placed right after the bound symbol
that produces the bucket's last grad, and one ``wait`` per bucket before
the program returns, so the update reads reduced grads.  Buckets are filled
in reverse leaf order (the backward produces the late layers' grads first),
capped at ``bucket_mb``.

``assign_buckets``, ``overlap_fraction``, ``validate_overlap_mesh``,
``overlap_report``, ``bucket_cap_suggestion`` and ``expected_all_reduces``
are the reference's (:36-131), on torch tensors and the port's meshes.
"""
from __future__ import annotations

from typing import Sequence

from thunder_tpu_torch.observability.metrics import registry

__all__ = ["assign_buckets", "overlap_fraction", "bucketed_grad_sync", "validate_overlap_mesh",
           "overlap_report", "bucket_cap_suggestion", "expected_all_reduces"]


def _leaf_bytes(x) -> int:
    """Bytes of a tensor or a tensor proxy; 0 for anything else."""
    if not hasattr(x, "dtype") or not hasattr(x, "shape"):
        return 0
    n = 1
    for s in x.shape:
        n *= int(s)
    width = getattr(x, "itemsize", None)
    if not isinstance(width, int):
        from thunder_tpu_torch.core import dtypes

        width = dtypes.to_torch_dtype(x.dtype).itemsize
    return n * width


def assign_buckets(leaves: Sequence, bucket_mb: float) -> list[list[int]]:
    """Groups leaf *indices* into buckets of at most ``bucket_mb`` MiB, in
    reverse leaf order (the order backward produces them).  A single leaf
    larger than the cap gets its own bucket — never split, never dropped."""
    cap = max(float(bucket_mb), 0.0) * 2**20
    buckets: list[list[int]] = []
    cur: list[int] = []
    cur_bytes = 0
    for i in reversed(range(len(leaves))):
        nb = _leaf_bytes(leaves[i])
        if cur and cur_bytes + nb > cap:
            buckets.append(cur)
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += nb
    if cur:
        buckets.append(cur)
    return buckets


def overlap_fraction(leaves: Sequence, buckets: list[list[int]]) -> float:
    """Fraction of gradient bytes whose reduction can overlap backward
    compute: everything except the final bucket (which has no compute left
    to hide behind)."""
    total = sum(_leaf_bytes(x) for x in leaves)
    if total == 0 or not buckets:
        return 0.0
    last = sum(_leaf_bytes(leaves[i]) for i in buckets[-1])
    return 1.0 - last / total


def validate_overlap_mesh(mesh, axis: str = "dp") -> None:
    """Bucketed grad sync is the DDP design: it needs a pure data-parallel
    mesh (params replicated over ``axis``; any other axis must be trivial).
    FSDP/TP meshes keep the per-parameter collectives of their placements."""
    from thunder_tpu_torch.distributed.sharding import mesh_shape

    shape = mesh_shape(mesh)
    if axis not in shape:
        raise ValueError(f"overlap=True needs a {axis!r} mesh axis, mesh has {shape}")
    extra = {a: s for a, s in shape.items() if a != axis and s > 1}
    if extra:
        raise ValueError(
            f"overlap=True supports pure data-parallel ({axis!r}) meshes; "
            f"non-trivial axes {extra} keep the per-parameter grad collectives"
        )


def bucketed_grad_sync(trace, *, axis, buckets: list[list[int]]):
    """Rewrites a backward trace whose returned grads are each the mean
    ``all_reduce`` over ``axis`` of a local grad (the VJP of a replicated
    param's ``synchronize``): grad ``i`` of the return joins bucket ``b``
    where ``i`` is in ``buckets[b]``.  Each bucket's local grads are reduced
    by one ``all_reduce(..., async_op=True)`` placed after the last of their
    producers, and waited on just before the return.  Returns the new
    trace."""
    from thunder_tpu_torch.core.baseutils import check
    from thunder_tpu_torch.core.prims import PrimIDs, python_return
    from thunder_tpu_torch.core.trace import from_trace, tracectx
    from thunder_tpu_torch.distributed import prims as dp

    bsyms = list(trace.bound_symbols)
    ret_at = next(i for i, b in enumerate(bsyms) if b.sym.id is PrimIDs.RETURN)
    grads = list(bsyms[ret_at].args[0])
    producer = {o.name: i for i, b in enumerate(bsyms) for o in b.flat_proxy_outs}
    local, dropped = {}, set()
    for j in (j for bucket in buckets for j in bucket):
        at = producer.get(grads[j].name)
        b = None if at is None else bsyms[at]
        check(b is not None and b.sym.id is dp.DistPrimIDs.ALL_REDUCE
              and not isinstance(b.args[0], (tuple, list)),
              lambda: f"grad {j} ({grads[j].name}) is not a per-parameter all_reduce")
        local[j] = b.args[0]
        dropped.add(at)

    new = from_trace(trace)
    issue_after: dict[int, list] = {}
    waits: list = []
    with tracectx(new):
        for bucket in buckets:
            vals = tuple(local[j] for j in bucket)
            at = max(producer.get(v.name, -1) for v in vals)
            with new.push_scope() as scope:
                outs = dp.all_reduce(vals, axis, dp.DistributedReduceOps.MEAN, async_op=True)
            issue_after.setdefault(at, []).extend(scope)
            with new.push_scope() as scope:
                done = dp.wait(outs)
            waits.extend(scope)
            for j, g in zip(bucket, done):
                grads[j] = g
        with new.push_scope() as ret:
            python_return(tuple(grads))
    out = list(issue_after.pop(-1, ()))
    for i, b in enumerate(bsyms):
        if i == ret_at:
            out.extend(waits)
            out.extend(ret)
            continue
        if i not in dropped:
            out.append(b)
        out.extend(issue_after.get(i, ()))
    new.bound_symbols = out
    new.set_provenance("Bucketed gradient all-reduces (overlap)")
    return new


def overlap_report(grad_leaves: Sequence, buckets: list[list[int]], bucket_mb: float) -> dict:
    """The analytic overlap accounting TrainStep exposes and mirrors into
    the registry (``train.step.overlap_frac`` / ``train.step.grad_buckets``)."""
    total = sum(_leaf_bytes(x) for x in grad_leaves)
    frac = overlap_fraction(grad_leaves, buckets)
    reg = registry()
    reg.gauge("train.step.overlap_frac").set(frac)
    reg.gauge("train.step.grad_buckets").set(len(buckets))
    return {
        "bucket_mb": float(bucket_mb),
        "n_buckets": len(buckets),
        "total_grad_bytes": int(total),
        "bucket_bytes": [int(sum(_leaf_bytes(grad_leaves[i]) for i in b)) for b in buckets],
        "overlap_frac": float(frac),
    }


def bucket_cap_suggestion(total_bytes: int, target_buckets: int = 4) -> float:
    """A starting ``bucket_mb`` that yields roughly ``target_buckets``
    buckets (tuning helper; torch's default 25 MiB is sized for NCCL rings)."""
    if total_bytes <= 0 or target_buckets <= 0:
        return 25.0
    return max(total_bytes / target_buckets / 2**20, 1e-3)


def expected_all_reduces(buckets: list[list[int]]) -> int:
    """All-reduces one bucketed step issues: one per bucket plus one for the
    scalar loss mean."""
    return len(buckets) + 1
