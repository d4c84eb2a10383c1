"""Mesh construction and parameter-sharding rules.

Counterpart of ``thunder_tpu/distributed/sharding.py``.  The reference
expresses a parallelism strategy as a pytree of ``NamedSharding``s over a
``jax.sharding.Mesh`` and lets XLA's SPMD partitioner insert the
collectives.  The port keeps the same rules and specs but runs explicit
SPMD, as Lightning Thunder's own DDP/FSDP transforms do: one process per
device, a :class:`torch.distributed.device_mesh.DeviceMesh` with the
reference's axis names, params placed as
DTensors, and the collectives written
into the step's trace (:mod:`thunder_tpu_torch.distributed.prims`).

A spec is the port's own copy of ``PartitionSpec`` (:class:`P`): entry ``i``
names the mesh axis (or the tuple of axes, outermost first) dim ``i`` is
split over, ``None`` for a dim that is not split.  :func:`placements`
turns a spec into DTensor placements, one per mesh dim.

Axis convention (the reference's): ``dp`` pure data parallel (params
replicated), ``fsdp`` data parallel with ZeRO dim-0 sharding, ``tp``
Megatron tensor parallel.  The global batch is split over (``dp``,
``fsdp``); weights over (``tp``, ``fsdp``) per the rules below.
"""
from __future__ import annotations

import math
import re
from typing import Sequence

import torch

from thunder_tpu_torch._tree import tree_flatten, tree_flatten_with_path, tree_map, tree_unflatten

__all__ = [
    "P",
    "PartitionSpec",
    "make_mesh",
    "mesh_shape",
    "batch_spec",
    "kv_cache_spec",
    "fsdp_shardings",
    "ddp_shardings",
    "llama_shardings",
    "apply_shardings",
    "placements",
    "local_slices",
    "spec_of",
    "ShardingRules",
]


class PartitionSpec(tuple):
    """The port's copy of ``jax.sharding.PartitionSpec``: a tuple with one
    entry per leading tensor dim — an axis name, a tuple of axis names, or
    ``None``."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def _require_world() -> int:
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_mesh needs torch.distributed initialized (one process per device): call "
            "thunder_tpu_torch.distributed.initialize_multihost() under torchrun, or start "
            "ranks with thunder_tpu_torch.distributed.launch")
    return dist.get_world_size()


def make_mesh(axis_sizes: dict[str, int] | None = None, *, devices=None, device_type=None):
    """A ``DeviceMesh`` from ``{axis_name: size}`` over the ranks of the
    process group (``devices``: the ranks, default all of them).  A size of
    -1 absorbs the remaining ranks (like a reshape); default: all ranks on
    one ``dp`` axis.  The product of the sizes must equal the number of
    ranks.  ``device_type`` defaults to ``cuda`` under NCCL, else ``cpu``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    world = _require_world()
    ranks = torch.as_tensor(list(range(world)) if devices is None else devices).reshape(-1)
    n = ranks.numel()
    if axis_sizes is None:
        axis_sizes = {"dp": n}
    names = list(axis_sizes.keys())
    sizes = [int(s) for s in axis_sizes.values()]
    if any(s == -1 for s in sizes):
        fixed = math.prod(s for s in sizes if s != -1)
        sizes = [s if s != -1 else n // fixed for s in sizes]
    if math.prod(sizes) != n:
        raise ValueError(f"mesh {dict(zip(names, sizes))} != {n} ranks")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, ranks.reshape(sizes), mesh_dim_names=tuple(names))


def mesh_shape(mesh) -> dict[str, int]:
    """``{axis_name: size}`` of a ``DeviceMesh`` (the reference's
    ``Mesh.shape``), in mesh order."""
    return {name: int(mesh.size(i)) for i, name in enumerate(mesh.mesh_dim_names)}


def batch_spec(mesh) -> P:
    """Batch-dim sharding: over every data-parallel axis present (dp, fsdp)."""
    shape = mesh_shape(mesh)
    axes = tuple(a for a in ("dp", "fsdp") if a in shape and shape[a] > 1)
    if not axes:
        return P()
    return P(axes if len(axes) > 1 else axes[0])


def kv_cache_spec(cfg, mesh, *, axis: str = "tp") -> P:
    """Spec of a KV cache or paged arena with the heads dim at axis 2
    (``(L, B, n_query_groups, T, hs)`` and ``(num_blocks, L,
    n_query_groups, block_size, hs)``, and the quantized pools' scale
    arenas): heads over ``axis``; replicated (``P()``) when the mesh is
    absent, the axis is missing or trivial, or does not divide
    ``n_query_groups`` (reference :70)."""
    shape = {} if mesh is None else mesh_shape(mesh)
    if shape.get(axis, 1) <= 1 or cfg.n_query_groups % shape[axis] != 0:
        return P()
    return P(None, None, axis)


def _axes(entry) -> tuple:
    return () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)


def _divisible(dim_size: int, mesh, axes) -> bool:
    if axes is None:
        return True
    shape = mesh_shape(mesh)
    return dim_size % math.prod(shape[a] for a in _axes(axes)) == 0


def _prune_spec(spec: P, shape: Sequence[int], mesh) -> P:
    """Drops sharding on axes that don't exist in the mesh, are trivial
    (size 1), or don't divide the dimension — so tiny test configs and odd
    shapes degrade to replication instead of erroring."""
    sizes = mesh_shape(mesh)
    out = []
    for i, axes in enumerate(spec):
        if i >= len(shape):  # spec longer than rank: extra entries degrade too
            break
        if axes is None:
            out.append(None)
            continue
        axes_t = tuple(a for a in _axes(axes) if sizes.get(a, 1) > 1)
        if not axes_t or not _divisible(shape[i], mesh, axes_t):
            out.append(None)
        elif len(axes_t) == 1:
            out.append(axes_t[0])
        else:
            out.append(axes_t)
    while out and out[-1] is None:
        out.pop()
    return P(*out)


def _path(kp) -> str:
    return "/".join(str(k) for k in kp)


class ShardingRules:
    """Path-pattern → PartitionSpec rules (first match wins).

    Paths are '/'-joined pytree key paths, e.g. ``blocks/3/attn/wq``.
    Patterns are regexes matched with ``re.search``.  :meth:`shardings`
    returns a tree of specs (pruned against each leaf's shape and the
    mesh) where the reference returns ``NamedSharding``s."""

    def __init__(self, rules: Sequence[tuple[str, P]], default: P = P()):
        self.rules = [(re.compile(pat), spec) for pat, spec in rules]
        self.default = default

    def spec_for(self, path: str, shape, mesh) -> P:
        for pat, spec in self.rules:
            if pat.search(path):
                return _prune_spec(spec, shape, mesh)
        return _prune_spec(self.default, shape, mesh)

    def shardings(self, params, mesh):
        pairs, spec = tree_flatten_with_path(params)
        return tree_unflatten(spec, [self.spec_for(_path(kp), tuple(x.shape), mesh)
                                     for kp, x in pairs])


def ddp_shardings(params, mesh):
    """DDP (reference :161): every param replicated."""
    return tree_map(lambda x: P(), params)


def fsdp_shardings(params, mesh, *, axis: str = "fsdp", min_size: int = 2**10):
    """FSDP/ZeRO (reference :167): every param's dim 0 over ``axis``; params
    smaller than ``min_size`` elements or whose dim 0 the axis does not
    divide stay replicated."""

    def leaf(x):
        if x.ndim >= 1 and x.numel() >= min_size and _divisible(x.shape[0], mesh, axis):
            return _prune_spec(P(axis), tuple(x.shape), mesh)
        return P()

    return tree_map(leaf, params)


# Megatron-style TP + ZeRO FSDP rules for the llama param tree
# (thunder_tpu_torch/models/llama.py layout), the reference's
_LLAMA_RULES = [
    # attention: wq/wk/wv split heads (dim0=out_features) over tp, fsdp on dim1
    (r"attn/w[qkv]$", P("tp", "fsdp")),
    # wo: row-parallel (dim1=in_features over tp)
    (r"attn/wo$", P("fsdp", "tp")),
    # MLP: up/gate column-parallel; down row-parallel
    (r"mlp/fc(_[12])?$", P("tp", "fsdp")),
    (r"mlp/proj$", P("fsdp", "tp")),
    # embeddings / head: vocab dim over tp, embd over fsdp
    (r"^wte$", P("tp", "fsdp")),
    (r"^lm_head$", P("tp", "fsdp")),
    # norm scales: replicated (tiny)
    (r"norm|ln_f", P()),
]

llama_rules = ShardingRules(_LLAMA_RULES, default=P("fsdp"))


def llama_shardings(params, mesh):
    """Combined TP × FSDP × DP specs for the llama family (reference :208)."""
    return llama_rules.shardings(params, mesh)


def placements(spec: P, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(i)`` on each mesh
    dim that splits tensor dim ``i``, ``Replicate()`` elsewhere.  A dim split
    over several axes takes them outermost first, which DTensor expresses
    only in mesh order."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for i, entry in enumerate(spec):
        axes = _axes(entry)
        pos = [names.index(a) for a in axes]
        if pos != sorted(pos):
            raise NotImplementedError(f"spec {spec}: axes {axes} out of the mesh's order {names}")
        for p in pos:
            out[p] = Shard(i)
    return out


def spec_of(x, mesh=None) -> P:
    """The spec of a placed tensor: ``P()`` for a plain tensor, else read
    from its DTensor placements (tensor dim ``i`` split over the mesh dims
    that carry ``Shard(i)``, outermost first)."""
    from torch.distributed.tensor import DTensor, Shard

    if not isinstance(x, DTensor):
        return P()
    names = x.device_mesh.mesh_dim_names
    dims: dict[int, list[str]] = {}
    for name, pl in zip(names, x.placements):
        if isinstance(pl, Shard):
            dims.setdefault(pl.dim, []).append(name)
    entries = [None] * (max(dims) + 1 if dims else 0)
    for d, axes in dims.items():
        entries[d] = axes[0] if len(axes) == 1 else tuple(axes)
    return P(*entries)


def local_slices(shape: Sequence[int], spec: P, mesh) -> tuple[slice, ...]:
    """This rank's slice of a tensor of global ``shape`` under ``spec``:
    along each split dim, chunk ``i`` of ``n``, where ``n`` is the product of
    the dim's axis sizes and ``i`` the rank's row-major index over them."""
    sizes = mesh_shape(mesh)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    out = []
    for d, n_d in enumerate(shape):
        axes = _axes(spec[d]) if d < len(spec) else ()
        n, i = 1, 0
        for a in axes:
            n, i = n * sizes[a], i * sizes[a] + coord[a]
        chunk = n_d // n
        out.append(slice(i * chunk, (i + 1) * chunk))
    return tuple(out)


def _place(x, spec: P, mesh):
    """``x`` (the full tensor, the same on every rank) as a DTensor holding
    this rank's slice: a copy, never a view of ``x`` — the step updates
    placed params in place, and that must not reach the caller's tensor
    (reference ``_place_no_alias`` :213).  No collective runs: every rank
    already holds the full tensor."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, torch.Tensor):
        return x
    x = x.detach()
    local = x[local_slices(tuple(x.shape), spec, mesh)].clone(
        memory_format=torch.contiguous_format)
    return DTensor.from_local(local, mesh, placements(spec, mesh), run_check=False,
                              shape=x.shape, stride=x.contiguous().stride() if x.ndim else ())


def apply_shardings(tree, shardings, mesh):
    """Places a tree of full tensors onto ``mesh`` per a matching tree of
    specs (reference :237, whose ``NamedSharding``s carry their mesh)."""
    leaves, treedef = tree_flatten(tree)
    specs, _ = tree_flatten(shardings)        # a PartitionSpec is a leaf
    if len(specs) != len(leaves):
        raise ValueError(f"{len(specs)} specs for {len(leaves)} leaves")
    return tree_unflatten(treedef, [_place(x, s, mesh) for x, s in zip(leaves, specs)])
