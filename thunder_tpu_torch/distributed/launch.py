"""Start a world of ranks: one process per device, a process group over them.

The JAX package runs its meshes inside one process (virtual CPU devices, or
a host's chips); the port runs one process per device, so the CLI and the
tests start their worlds here.  :func:`launch` runs ``fn(rank, world,
*args)`` on ``nprocs`` ranks and returns each rank's result:

- ``device="cpu"``: gloo ranks, each on the CPU;
- ``device="cuda"``: NCCL ranks, rank ``r`` on card ``r``; more ranks than
  cards is refused;
- one rank runs in this process (its process group is made and destroyed
  around the call); more are spawned (``multiprocessing``'s ``spawn``) and
  rendezvous through a ``FileStore`` in a fresh directory, so concurrent
  worlds on one machine never share a port.

No rank can hang the caller: every collective fails after
``collective_timeout_s`` (the process group's timeout), and the caller
kills every child and raises once ``timeout_s`` has passed, or as soon as
one rank fails (its traceback in the error).
"""
from __future__ import annotations

import datetime
import os
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable

import torch

__all__ = ["launch"]


def _init(rank: int, world: int, backend: str, store: str, collective_timeout_s: float) -> None:
    import torch.distributed as dist

    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=f"file://{store}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=collective_timeout_s))


def _child(rank, world, backend, store, collective_timeout_s, threads, fn, args, out_dir):
    import torch.distributed as dist

    if threads is not None:
        torch.set_num_threads(threads)
    try:
        _init(rank, world, backend, store, collective_timeout_s)
        result = fn(rank, world, *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(fn: Callable, nprocs: int, *, args: tuple = (), device: str = "cpu",
           timeout_s: float = 300.0, collective_timeout_s: float = 120.0,
           threads: int | None = None, workdir: str | None = None) -> list[Any]:
    """``[fn(rank, nprocs, *args) for each rank]``, run on ``nprocs`` ranks
    (see the module docstring).  ``fn`` must be importable by name (a
    module-level function) when more than one rank runs; ``threads`` sets
    each spawned rank's PyTorch thread count."""
    import torch.distributed as dist

    dev = torch.device(device).type
    if dev == "cuda":
        from thunder_tpu_torch._device import resolve_device

        resolve_device("cuda")
        if nprocs > torch.cuda.device_count():
            raise ValueError(f"{nprocs} ranks need {nprocs} cards; this machine has "
                             f"{torch.cuda.device_count()}")
    elif dev != "cpu":
        raise ValueError(f"device must be cpu or cuda, got {device!r}")
    backend = "nccl" if dev == "cuda" else "gloo"
    tmp = tempfile.mkdtemp(prefix="tt_world_", dir=workdir)
    store = os.path.join(tmp, "store")
    try:
        if nprocs == 1:
            if dist.is_initialized():
                raise RuntimeError("launch(..., 1) makes its own process group; one exists")
            _init(0, 1, backend, store, collective_timeout_s)
            try:
                return [fn(0, 1, *args)]
            finally:
                dist.destroy_process_group()
        return _spawn(fn, nprocs, args, backend, store, collective_timeout_s, threads, tmp,
                      timeout_s)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _spawn(fn, nprocs, args, backend, store, collective_timeout_s, threads, out_dir,
           timeout_s) -> list:
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_child, args=(r, nprocs, backend, store, collective_timeout_s,
                                               threads, fn, args, out_dir), daemon=True)
             for r in range(nprocs)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    failed = None
    try:
        while any(p.is_alive() for p in procs):
            failed = next((r for r, p in enumerate(procs)
                           if not p.is_alive() and p.exitcode != 0), None)
            if failed is not None or time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(timeout=10)
    errors = {r: open(os.path.join(out_dir, f"rank{r}.err")).read()
              for r in range(nprocs) if os.path.exists(os.path.join(out_dir, f"rank{r}.err"))}
    codes = [p.exitcode for p in procs]
    if errors or any(c != 0 for c in codes):
        what = "\n".join(f"rank {r}:\n{e}" for r, e in sorted(errors.items()))
        late = failed is None and time.monotonic() > deadline
        raise RuntimeError(f"world of {nprocs} ranks failed (exit codes {codes}"
                           f"{f'; killed after {timeout_s} s' if late else ''})\n{what}")
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
            for r in range(nprocs)]
