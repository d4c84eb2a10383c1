"""Distributed checkpointing of placed state trees.

Counterpart of ``thunder_tpu/distributed/checkpoint.py`` (:38-128):
``StateDictOptions``, ``full_state_dict``, ``save_checkpoint``,
``load_checkpoint`` and ``latest_step``.  The reference writes orbax; the
port writes ``torch.distributed.checkpoint`` (DCP), and reads only that:

- the **sharded** path (default): every rank writes exactly its own shards
  of the tree's DTensors (plain tensors are written once);
- the **full** path (``full_state_dict=True``): every leaf is gathered to a
  CPU tensor first; with ``rank0_only`` only rank 0 keeps and writes it;
- :func:`load_checkpoint` takes a *template* tree whose leaves carry the
  target placements and returns fresh tensors placed like them, so a
  checkpoint saved from one mesh loads onto another mesh shape: DCP reads
  each rank's new shard from the saved ones.

The tree is flattened to ``"/"``-joined key paths (``blocks/3/attn/wq``)
for DCP; non-tensor leaves (step counters, config) travel with it.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any

import torch

from thunder_tpu_torch._tree import tree_flatten_with_path, tree_map, tree_unflatten

__all__ = [
    "StateDictOptions",
    "full_state_dict",
    "save_checkpoint",
    "load_checkpoint",
    "latest_step",
]


@dataclass
class StateDictOptions:
    """The reference's StateDictOptions (checkpoint.py:35)."""

    full_state_dict: bool = False
    cpu_offload: bool = False  # the full path always lands on the CPU; kept for parity
    rank0_only: bool = False


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def _world() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def full_state_dict(tree, *, rank0_only: bool = False):
    """Every leaf gathered to a full CPU tensor, a copy (the reference's
    ``_unshard_params`` + cpu_offload).  Every rank takes part in the
    gathers; with ``rank0_only`` the others then return an empty dict."""
    from torch.distributed.tensor import DTensor

    def full(x):
        # always a copy: a replicated leaf's full tensor is its local one,
        # which the step goes on updating in place
        if isinstance(x, DTensor):
            return x.full_tensor().to("cpu", copy=True)
        return x.detach().to("cpu", copy=True) if isinstance(x, torch.Tensor) else x

    out = tree_map(full, tree)
    if rank0_only and _rank() != 0:
        return {}
    return out


def _ckpt_dir(path: str | os.PathLike, step: int | None) -> str:
    p = os.path.abspath(os.fspath(path))
    return os.path.join(p, f"step_{step}") if step is not None else p


def _flat(tree) -> dict:
    pairs, _ = tree_flatten_with_path(tree)
    return {"/".join(str(k) for k in kp) or "_": x for kp, x in pairs}


def save_checkpoint(path: str | os.PathLike, state: Any, *, step: int | None = None,
                    options: StateDictOptions | None = None) -> str:
    """Saves a tree (params / opt_state / counters) under ``path`` (its
    ``step_N`` subdirectory when ``step`` is given) and returns the
    directory.  Default: sharded, every rank writes its own shards.
    ``options.full_state_dict``: gathered first; with ``rank0_only`` only
    rank 0 writes.  A full save of several ranks without ``rank0_only`` is
    refused, as in the reference (every rank would write the same tree)."""
    import torch.distributed.checkpoint as dcp

    options = options or StateDictOptions()
    where = _ckpt_dir(path, step)
    if options.full_state_dict:
        if _world() > 1 and not options.rank0_only:
            raise NotImplementedError(
                "a full_state_dict save from several ranks needs rank0_only=True; the default "
                "sharded save has every rank write exactly its own shards")
        state = full_state_dict(state, rank0_only=options.rank0_only)
        if _rank() != 0:
            return where
        dcp.save(_flat(state), checkpoint_id=where, no_dist=True)
        return where
    dcp.save(_flat(state), checkpoint_id=where)
    return where


def load_checkpoint(path: str | os.PathLike, template: Any, *, step: int | None = None):
    """Restores a tree saved by :func:`save_checkpoint` into fresh tensors
    shaped, typed and placed like ``template``'s leaves (a DTensor leaf on
    another mesh or placement than the saved one is resharded on read); the
    template itself is not written.  Non-tensor leaves take the saved
    values."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.tensor import DTensor

    def fresh(x):
        if isinstance(x, DTensor):
            return DTensor.from_local(torch.empty_like(x.to_local()), x.device_mesh, x.placements,
                                      run_check=False, shape=x.shape, stride=x.stride())
        return torch.empty_like(x) if isinstance(x, torch.Tensor) else x

    pairs, spec = tree_flatten_with_path(template)
    leaves = [fresh(x) for _, x in pairs]
    keys = ["/".join(str(k) for k in kp) or "_" for kp, _ in pairs]
    flat = dict(zip(keys, leaves))
    dcp.load(flat, checkpoint_id=_ckpt_dir(path, step), no_dist=_world() == 1)
    return tree_unflatten(spec, [flat[k] for k in keys])


def latest_step(path: str | os.PathLike) -> int | None:
    """Largest ``step_N`` subdirectory under ``path`` (resume helper)."""
    p = os.path.abspath(os.fspath(path))
    if not os.path.isdir(p):
        return None
    steps = [int(name[5:]) for name in os.listdir(p)
             if name.startswith("step_") and name[5:].isdigit()]
    return max(steps) if steps else None
