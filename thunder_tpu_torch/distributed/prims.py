"""Distributed communication primitives.

Counterpart of ``thunder_tpu/distributed/prims.py``: every ``DistPrimIDs``
entry, ``DistributedReduceOps`` and the metas, copied.  The reference's
collectives are named-axis operations that lower to XLA collectives inside
``shard_map``/``pjit``; the port runs explicit SPMD (one process per
device), so the same prims get implementations on the ``torch`` executor
that call ``torch.distributed`` on the process group of the named mesh axes
(the counterpart of ``_register_impls``, :180).  An axis name — one mesh
axis, or a tuple of them — is resolved on the mesh of the innermost
:func:`thunder_tpu_torch.executors.cudaex.mesh_context`, which the sharded
train step enters while its programs run.  ``shard_map_compat`` (:45) has no
counterpart: each rank runs the local program.

The port's additions to the reference's metas:

- ``all_gather``, ``all_reduce``, ``reduce_scatter``, ``wait`` and
  ``synchronize`` take a tensor or a tuple of tensors (as ``jax.lax.psum``
  takes a pytree: the reference's ``bucketed_grad_sync``): a tuple travels
  as one flat buffer per dtype, one collective each — the bucketed and
  combined collectives of the step.
- ``all_reduce(..., async_op=True)`` issues the collective and returns at
  once; its outputs are valid after a ``wait`` of them (the reference's
  ``wait`` is an identity: XLA's scheduler overlaps its collectives).

The collectives never fuse (``executors/inductorex.py``).  Their VJP rules
are in ``core/transforms.py``.  ``COLLECTIVES`` counts the collectives the
implementations issued, by kind.
"""
from __future__ import annotations

import math
import sys
from enum import Enum, auto, unique
from numbers import Number

import torch

from thunder_tpu_torch.core.baseutils import check
from thunder_tpu_torch.core.proxies import TensorProxy
from thunder_tpu_torch.core.symbol import Symbol

_this_module = sys.modules[__name__]
__print_name__ = "dist_prims"

__all__ = [
    "COLLECTIVES",
    "DistPrimIDs",
    "DistributedReduceOps",
    "all_gather",
    "all_reduce",
    "reduce_scatter",
    "broadcast",
    "ppermute",
    "all_to_all",
    "axis_index",
    "axis_group",
    "wait",
    "synchronize",
]


@unique
class DistPrimIDs(Enum):
    ALL_GATHER = auto()
    ALL_REDUCE = auto()
    REDUCE_SCATTER = auto()
    BROADCAST = auto()
    PPERMUTE = auto()
    ALL_TO_ALL = auto()
    AXIS_INDEX = auto()
    WAIT = auto()
    SYNCHRONIZE = auto()


class DistributedReduceOps(Enum):
    """Reduction ops (the reference's: SUM, MEAN, MAX, MIN)."""

    SUM = auto()
    MEAN = auto()
    MAX = auto()
    MIN = auto()


#: collectives issued by the implementations, by kind (a tuple input's
#: flat buffer is one collective per dtype)
COLLECTIVES = {"all_gather": 0, "all_reduce": 0, "reduce_scatter": 0, "broadcast": 0,
               "ppermute": 0, "all_to_all": 0}


def _make_dist_prim(id: DistPrimIDs, name: str, meta):
    return Symbol(name=name, meta=meta, id=id, is_prim=True, module=_this_module)


def _is_seq(a) -> bool:
    return isinstance(a, (tuple, list))


def _each(a, fn):
    """``fn`` over a tensor, or over each tensor of a tuple."""
    return tuple(fn(x) for x in a) if _is_seq(a) else fn(a)


def _like(a: TensorProxy, shape=None) -> TensorProxy:
    return TensorProxy(
        shape=tuple(shape if shape is not None else a.shape),
        device=a.device,
        dtype=a.dtype,
        requires_grad=False,
    )


#
# meta functions (shape/dtype rules; all axis sizes static)
#


def _gathered_shape(a, axis_size: int, dim: int, tiled: bool) -> list:
    shape = list(a.shape)
    if tiled:
        shape[dim] = shape[dim] * int(axis_size)
    else:
        shape.insert(0, int(axis_size))
    return shape


def _all_gather_meta(a, axis_name, axis_size: int, dim: int = 0, tiled: bool = True):
    check(isinstance(axis_size, (int, Number)) and axis_size >= 1, lambda: f"bad axis_size {axis_size}")
    return _each(a, lambda x: _like(x, _gathered_shape(x, axis_size, dim, tiled)))


def _all_reduce_meta(a, axis_name, op: DistributedReduceOps = DistributedReduceOps.SUM,
                     async_op: bool = False):
    return _each(a, _like)


def _reduce_scatter_meta(
    a, axis_name, axis_size: int, dim: int = 0, op: DistributedReduceOps = DistributedReduceOps.SUM
):
    def one(x):
        shape = list(x.shape)
        check(
            shape[dim] % int(axis_size) == 0,
            lambda: f"reduce_scatter dim {dim} (={shape[dim]}) not divisible by axis size {axis_size}",
        )
        shape[dim] = shape[dim] // int(axis_size)
        return _like(x, shape)

    return _each(a, one)


def _broadcast_meta(a: TensorProxy, axis_name, root: int = 0):
    return _like(a)


def _ppermute_meta(a: TensorProxy, axis_name, perm):
    return _like(a)


def _all_to_all_meta(a: TensorProxy, axis_name, axis_size: int, split_dim: int, concat_dim: int):
    shape = list(a.shape)
    check(shape[split_dim] % int(axis_size) == 0, lambda: f"all_to_all split dim not divisible by {axis_size}")
    shape[split_dim] = shape[split_dim] // int(axis_size)
    shape[concat_dim] = shape[concat_dim] * int(axis_size)
    return _like(a, shape)


def _axis_index_meta(axis_name):
    from thunder_tpu_torch.core import dtypes
    from thunder_tpu_torch.core.devices import cpu

    return TensorProxy(shape=(), device=cpu, dtype=dtypes.int32, requires_grad=False)


def _wait_meta(a):
    return _each(a, _like)


def _synchronize_meta(a, axis_name, axis_size: int = 1, sharded: bool = False, dim: int = 0):
    if sharded:
        return _all_gather_meta(a, axis_name, axis_size, dim=dim, tiled=True)
    return _each(a, _like)


all_gather = _make_dist_prim(DistPrimIDs.ALL_GATHER, "all_gather", _all_gather_meta)
all_reduce = _make_dist_prim(DistPrimIDs.ALL_REDUCE, "all_reduce", _all_reduce_meta)
reduce_scatter = _make_dist_prim(DistPrimIDs.REDUCE_SCATTER, "reduce_scatter", _reduce_scatter_meta)
broadcast = _make_dist_prim(DistPrimIDs.BROADCAST, "broadcast", _broadcast_meta)
ppermute = _make_dist_prim(DistPrimIDs.PPERMUTE, "ppermute", _ppermute_meta)
all_to_all = _make_dist_prim(DistPrimIDs.ALL_TO_ALL, "all_to_all", _all_to_all_meta)
axis_index = _make_dist_prim(DistPrimIDs.AXIS_INDEX, "axis_index", _axis_index_meta)
wait = _make_dist_prim(DistPrimIDs.WAIT, "wait", _wait_meta)
synchronize = _make_dist_prim(DistPrimIDs.SYNCHRONIZE, "synchronize", _synchronize_meta)


#
# Process groups of named axes
#

# (mesh, axes) -> (group, size, this rank's index over the axes); the mesh
# is held so that its id is not reused while the entry lives
_GROUPS: dict[tuple[int, tuple], tuple] = {}


def _axes(axis_name) -> tuple:
    return (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)


def axis_group(mesh, axis_name):
    """``(group, size, index)`` of this rank over the mesh axes
    ``axis_name`` (a name or a tuple of names, outermost first): the process
    group of the ranks that differ only along them, its size, and this
    rank's row-major index over them (its rank in the group).  A tuple of
    several axes builds its groups once, collectively, on every rank of the
    mesh."""
    import torch.distributed as dist

    axes = _axes(axis_name)
    key = (id(mesh), axes)
    hit = _GROUPS.get(key)
    if hit is not None:
        return hit[1:]
    names = list(mesh.mesh_dim_names)
    for a in axes:
        check(a in names, lambda: f"axis {a!r} is not an axis of the mesh {names}")
    coord = dict(zip(names, mesh.get_coordinate()))
    size, index = 1, 0
    for a in axes:
        n = int(mesh.size(names.index(a)))
        size, index = size * n, index * n + coord[a]
    if len(axes) == 1:
        group = mesh.get_group(axes[0])
    else:
        # every group of ranks that differ only along ``axes``, enumerated
        # in the same order on every rank (new_group is collective)
        keep = [d for d, name in enumerate(names) if name not in axes]
        perm = keep + [names.index(a) for a in axes]
        rows = mesh.mesh.permute(perm).reshape(-1, size).tolist()
        me = dist.get_rank()
        group = None
        for ranks in rows:
            g = dist.new_group(ranks)
            if me in ranks:
                group = g
    _GROUPS[key] = (mesh, group, size, index)
    return group, size, index


def _group(axis_name):
    from thunder_tpu_torch.executors import cudaex

    mesh = cudaex.active_mesh()
    check(mesh is not None,
          lambda: "the dist prims run inside a sharded step's mesh_context (no mesh is active)")
    return axis_group(mesh, axis_name)


def _gather_into(out, x, group) -> None:
    """``all_gather_into_tensor``, by the name this torch has: 2.13 renamed it
    ``all_gather_single`` and deprecated the old name, which 2.11 alone has."""
    import torch.distributed as dist

    fn = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    fn(out, x, group=group)


def _scatter_into(out, x, group) -> None:
    """``reduce_scatter_tensor`` (sum), by the name this torch has (2.13:
    ``reduce_scatter_single``)."""
    import torch.distributed as dist

    fn = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
    fn(out, x, op=dist.ReduceOp.SUM, group=group)


def _reduce_op(op):
    import torch.distributed as dist

    return {DistributedReduceOps.SUM: dist.ReduceOp.SUM, DistributedReduceOps.MEAN: dist.ReduceOp.SUM,
            DistributedReduceOps.MAX: dist.ReduceOp.MAX,
            DistributedReduceOps.MIN: dist.ReduceOp.MIN}[op]


def _by_dtype(ts) -> list[list[int]]:
    """Indices of ``ts`` grouped by dtype, first appearance first: one flat
    buffer per group."""
    groups: dict = {}
    for i, t in enumerate(ts):
        groups.setdefault(t.dtype, []).append(i)
    return list(groups.values())


#
# torch.distributed implementations
#


def _all_gather_impl(a, axis_name, axis_size, dim=0, tiled=True):
    import torch.distributed as dist

    group, n, _ = _group(axis_name)
    check(n == int(axis_size), lambda: f"all_gather: axis {axis_name} has {n} ranks, not {axis_size}")
    ts = list(a) if _is_seq(a) else [a]
    outs: list = [None] * len(ts)
    for idx in _by_dtype(ts):
        moved = [ts[i].movedim(dim, 0) if tiled and dim else ts[i] for i in idx]
        flat = torch.cat([m.reshape(-1) for m in moved]) if len(idx) > 1 else \
            moved[0].contiguous().reshape(-1)
        got = torch.empty(n * flat.numel(), dtype=flat.dtype, device=flat.device)
        _gather_into(got, flat, group)
        got = got.view(n, flat.numel())
        COLLECTIVES["all_gather"] += 1
        off = 0
        for i, m in zip(idx, moved):
            k = m.numel()
            piece = got[:, off:off + k].reshape(n, *m.shape)
            off += k
            if tiled:
                piece = piece.reshape(n * m.shape[0], *m.shape[1:]) if m.ndim else piece
                piece = piece.movedim(0, dim) if dim else piece
            outs[i] = piece
    return tuple(outs) if _is_seq(a) else outs[0]


def _all_reduce_impl(a, axis_name, op=DistributedReduceOps.SUM, async_op=False):
    import torch.distributed as dist

    group, n, _ = _group(axis_name)
    ts = list(a) if _is_seq(a) else [a]
    outs: list = [None] * len(ts)
    works, flats = [], []
    for idx in _by_dtype(ts):
        # a fresh buffer: the reduction runs in place on it, never on an input
        flat = torch.cat([ts[i].reshape(-1) for i in idx]) if len(idx) > 1 else \
            ts[idx[0]].reshape(-1).clone()
        work = dist.all_reduce(flat, op=_reduce_op(op), group=group, async_op=async_op)
        COLLECTIVES["all_reduce"] += 1
        works.append(work)
        flats.append(flat)
        off = 0
        for i in idx:
            k = ts[i].numel()
            outs[i] = flat[off:off + k].view(ts[i].shape)
            off += k
    out = tuple(outs) if _is_seq(a) else outs[0]
    if async_op:
        _PENDING[id(outs[0])] = (works, flats, n, op, outs)
    else:
        _finish(flats, n, op)
    return out


# async all-reduces not yet waited on: id(first output) -> (works, flat
# buffers, group size, op, the outputs, held so their ids stay theirs)
_PENDING: dict[int, tuple] = {}


def _finish(flats, n: int, op) -> None:
    """The mean's division, in place (none over one rank: x / 1 is x)."""
    if op is DistributedReduceOps.MEAN and n != 1:
        for f in flats:
            f.div_(n)


def _wait_impl(a):
    first = a[0] if _is_seq(a) else a
    pending = _PENDING.pop(id(first), None)
    if pending is not None:
        works, flats, n, op, _ = pending
        for w in works:
            w.wait()
        _finish(flats, n, op)
    return a


def _reduce_scatter_impl(a, axis_name, axis_size, dim=0, op=DistributedReduceOps.SUM):
    import torch.distributed as dist

    check(op in (DistributedReduceOps.SUM, DistributedReduceOps.MEAN),
          lambda: "reduce_scatter supports SUM/MEAN")
    group, n, _ = _group(axis_name)
    check(n == int(axis_size), lambda: f"reduce_scatter: axis {axis_name} has {n} ranks, not {axis_size}")
    ts = list(a) if _is_seq(a) else [a]
    outs: list = [None] * len(ts)
    for idx in _by_dtype(ts):
        moved = [ts[i].movedim(dim, 0) if dim else ts[i] for i in idx]
        # rank r's part of every tensor side by side in row r
        flat = torch.cat([m.reshape(n, -1) for m in moved], dim=1) if len(idx) > 1 else \
            moved[0].contiguous().reshape(n, -1)
        got = torch.empty(flat.shape[1], dtype=flat.dtype, device=flat.device)
        _scatter_into(got, flat.reshape(-1), group)
        COLLECTIVES["reduce_scatter"] += 1
        _finish([got], n, op)
        off = 0
        for i, m in zip(idx, moved):
            shape = (m.shape[0] // n, *m.shape[1:])
            k = math.prod(shape)
            piece = got[off:off + k].view(shape)
            off += k
            outs[i] = piece.movedim(0, dim) if dim else piece
    return tuple(outs) if _is_seq(a) else outs[0]


def _broadcast_impl(a, axis_name, root=0):
    import torch.distributed as dist

    group, n, _ = _group(axis_name)
    out = a.contiguous().clone()
    dist.broadcast(out, src=dist.get_global_rank(group, int(root)), group=group)
    COLLECTIVES["broadcast"] += 1
    return out


def _ppermute_impl(a, axis_name, perm):
    """``out`` on the rank at axis index ``d`` is ``a`` of the rank at ``s``
    for each ``(s, d)`` of ``perm``; zeros where no pair ends (as
    ``jax.lax.ppermute``)."""
    import torch.distributed as dist

    group, n, me = _group(axis_name)
    x = a.contiguous()
    out = torch.zeros_like(x)
    ops = []
    for s, d in perm:
        s, d = int(s), int(d)
        if s == d == me:
            out.copy_(x)
        elif s == me:
            ops.append(dist.P2POp(dist.isend, x, dist.get_global_rank(group, d), group))
        elif d == me:
            ops.append(dist.P2POp(dist.irecv, out, dist.get_global_rank(group, s), group))
    if ops:
        for w in dist.batch_isend_irecv(ops):
            w.wait()
    COLLECTIVES["ppermute"] += 1
    return out


def _all_to_all_impl(a, axis_name, axis_size, split_dim, concat_dim):
    import torch.distributed as dist

    group, n, _ = _group(axis_name)
    check(n == int(axis_size), lambda: f"all_to_all: axis {axis_name} has {n} ranks, not {axis_size}")
    send = torch.stack(torch.chunk(a, n, dim=split_dim)).contiguous()
    got = torch.empty_like(send)
    dist.all_to_all_single(got, send, group=group)
    COLLECTIVES["all_to_all"] += 1
    return torch.cat(list(got.unbind(0)), dim=concat_dim)


def _axis_index_impl(axis_name):
    _, _, index = _group(axis_name)
    return torch.tensor(index, dtype=torch.int32)


def _synchronize_impl(a, axis_name, axis_size=1, sharded=False, dim=0):
    if sharded:
        return _all_gather_impl(a, axis_name, axis_size, dim, True)
    return tuple(a) if _is_seq(a) else a


def _register_impls():
    from thunder_tpu_torch.core.transforms import register_dist_backward_rules
    from thunder_tpu_torch.executors.inductorex import never_fuse_collectives
    from thunder_tpu_torch.executors.torchex import torch_ex

    for pid, sym, fn in (
            (DistPrimIDs.ALL_GATHER, all_gather, _all_gather_impl),
            (DistPrimIDs.ALL_REDUCE, all_reduce, _all_reduce_impl),
            (DistPrimIDs.REDUCE_SCATTER, reduce_scatter, _reduce_scatter_impl),
            (DistPrimIDs.BROADCAST, broadcast, _broadcast_impl),
            (DistPrimIDs.PPERMUTE, ppermute, _ppermute_impl),
            (DistPrimIDs.ALL_TO_ALL, all_to_all, _all_to_all_impl),
            (DistPrimIDs.AXIS_INDEX, axis_index, _axis_index_impl),
            (DistPrimIDs.WAIT, wait, _wait_impl),
            (DistPrimIDs.SYNCHRONIZE, synchronize, _synchronize_impl)):
        torch_ex.register_implementation(
            pid, torch_ex.register_operator(f"torch_{sym.name}", like=sym, fn=fn))
    register_dist_backward_rules(_this_module)
    never_fuse_collectives(DistPrimIDs)


_register_impls()
