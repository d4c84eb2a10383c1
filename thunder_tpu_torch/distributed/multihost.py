"""Multi-host scale-out: process-group init and hybrid meshes.

Counterpart of ``thunder_tpu/distributed/multihost.py``.  The reference
starts JAX's multi-controller runtime; the port's runtime is
``torch.distributed``: one process per device, a process group over all of
them (NCCL between cards, gloo on the CPU), and meshes of ranks.  The
design rule is the reference's: model-parallel axes inside a host (NVLink),
data-parallel axes across hosts, whose network is an order of magnitude
slower and carries only the gradient reductions.
"""
from __future__ import annotations

import datetime
import math
import os

import torch

__all__ = ["initialize", "hybrid_mesh"]

#: how long a collective may wait for the other ranks before it fails
DEFAULT_TIMEOUT_S = 120


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    backend: str | None = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
    **kwargs,
) -> None:
    """Starts the process group (idempotent; reference :23).

    With no arguments the world comes from torchrun's environment
    (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``); a single
    process without that environment is a no-op, as in the reference.
    ``coordinator_address`` (``host:port``), ``num_processes`` and
    ``process_id`` set it explicitly.  ``backend`` defaults to ``nccl`` when
    a card is present, else ``gloo``; under NCCL the process binds to the
    card of its ``LOCAL_RANK``.  A real bring-up failure raises here."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    if num_processes == 1:
        return  # explicitly single-process: no coordinator to reach
    env_world = os.environ.get("WORLD_SIZE")
    if coordinator_address is None and num_processes is None and env_world is None:
        return  # single process, nothing to join
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", process_id or 0)))
    init = {"init_method": f"tcp://{coordinator_address}"} if coordinator_address else {}
    if num_processes is not None:
        init["world_size"] = int(num_processes)
    if process_id is not None:
        init["rank"] = int(process_id)
    dist.init_process_group(backend, timeout=datetime.timedelta(seconds=timeout_s),
                            **init, **kwargs)


def hybrid_mesh(ici_axes: dict[str, int], dcn_axes: dict[str, int] | None = None, *,
                devices=None):
    """A 2-level mesh (reference :65): the ``dcn_axes`` outer, across hosts
    (data parallel over the network), the ``ici_axes`` inner, within a host.
    Ranks are numbered host by host (torchrun's order), so the row-major
    layout of :func:`~thunder_tpu_torch.distributed.sharding.make_mesh` with
    the outer axes first keeps each inner group on one host.

    ``hybrid_mesh({"fsdp": 4}, {"dp": 2})`` on 2 hosts of 4 cards → a
    ``("dp", "fsdp")`` mesh whose ``fsdp`` groups are the hosts."""
    from thunder_tpu_torch.distributed.sharding import _require_world, make_mesh

    dcn_axes = dict(dcn_axes or {})
    axes = {**dcn_axes, **ici_axes}
    n = _require_world() if devices is None else len(list(devices))
    if math.prod(axes.values()) != n:
        raise ValueError(f"mesh {axes} != {n} ranks")
    return make_mesh(axes, devices=devices)
