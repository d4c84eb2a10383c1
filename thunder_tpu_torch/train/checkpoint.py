"""Async checkpointing with atomic commits and torn-file tolerance.

Counterpart of ``thunder_tpu/train/checkpoint.py``, with its protocol:

1. **Saves never block the step path.**  :class:`AsyncCheckpointer`
   dispatches: ``dispatch(step, state)`` copies the state to host memory
   (the only synchronous part — the port updates params in place, so the
   copy must be taken before the next step) and hands the file I/O to one
   worker thread; ``harvest()`` collects finished saves without blocking,
   ``wait()`` drains them.
2. **A kill at any instant leaves either a complete checkpoint or none.**
   Writes go to a hidden temp directory; every leaf file is fsynced;
   ``manifest.json`` — the step, a config fingerprint and a crc32 per leaf
   — is written and fsynced LAST; then one atomic ``os.rename`` publishes
   the directory and the parent directory is fsynced.
   :func:`restore_latest` walks committed checkpoints newest first and
   *skips* anything torn (missing manifest or leaf, checksum or
   fingerprint mismatch) with a structured :class:`CheckpointWarning`.

Leaves are ``.npy`` files.  numpy has no bfloat16, so a bf16 leaf is stored
as its raw 16-bit pattern (an int16 array) and the manifest records
``"storage": "bfloat16-bits"``; the checksum covers the stored bytes.  The
port's checkpoints are not meant to be read by the JAX package.

Fault injection rides :mod:`thunder_tpu_torch.serving.faults`: a
:class:`~thunder_tpu_torch.serving.faults.FaultPlan` armed at the
``checkpoint.save`` point makes save failures reproducible.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import warnings
import zlib
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np
import torch

from thunder_tpu_torch._tree import tree_flatten, tree_leaves, tree_map, tree_unflatten
from thunder_tpu_torch.observability.metrics import registry

__all__ = [
    "AsyncCheckpointer",
    "host_copy",
    "CheckpointWarning",
    "committed_steps",
    "config_fingerprint",
    "restore_latest",
    "save_checkpoint_atomic",
]

_MANIFEST = "manifest.json"
_STEP_PREFIX = "step_"


class CheckpointWarning(UserWarning):
    """A torn/partial/mismatched checkpoint was skipped during restore.

    Carries the structured cause as ``.info`` (checkpoint path, reason,
    step) so monitoring can key off fields, not message strings."""

    def __init__(self, info: dict):
        self.info = dict(info)
        super().__init__(f"skipping checkpoint: {json.dumps(self.info, sort_keys=True)}")


def config_fingerprint(config: dict | None) -> str:
    """Stable fingerprint of the run config stored in the manifest: resuming
    under a silently different config is a divergence, not a resume."""
    payload = json.dumps(config or {}, sort_keys=True, default=str)
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


_BF16_BITS = "bfloat16-bits"


def host_copy(state):
    """A host-memory copy of every tensor leaf of ``state`` (other leaves as
    they are): it stays valid while the device state is updated in place."""
    return tree_map(lambda x: x.detach().to("cpu", copy=True)
                    if isinstance(x, torch.Tensor) else x, state)


def _to_numpy(leaf) -> tuple[np.ndarray, str | None]:
    """``(array, storage)``: a bf16 tensor as its raw bits (int16)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), _BF16_BITS
        return t.numpy(), None
    return np.asarray(leaf), None


def _from_numpy(arr: np.ndarray, storage: str | None):
    t = torch.from_numpy(np.array(arr))          # an owned contiguous copy, 0-d kept
    return t.view(torch.bfloat16) if storage == _BF16_BITS else t


def _fsync_file(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:  # platforms without dir-fd fsync
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def save_checkpoint_atomic(
    directory: str | os.PathLike,
    state,
    *,
    step: int,
    config: dict | None = None,
) -> str:
    """Synchronously writes ``state`` (a tree of tensors, arrays or numbers) as
    ``{directory}/step_{step}`` with the full write hygiene: temp dir →
    per-leaf ``.npy`` + fsync → manifest (committed LAST) → atomic rename →
    parent-dir fsync.  Returns the committed path."""
    directory = os.fspath(directory)
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"{_STEP_PREFIX}{int(step)}")
    tmp = os.path.join(directory, f".tmp-{_STEP_PREFIX}{int(step)}-{os.getpid()}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    leaves = tree_leaves(state)
    entries = []
    for i, leaf in enumerate(leaves):
        arr, storage = _to_numpy(leaf)
        name = f"leaf_{i:05d}.npy"
        path = os.path.join(tmp, name)
        with open(path, "wb") as f:
            np.save(f, arr)
            f.flush()
            os.fsync(f.fileno())
        entries.append({
            "file": name,
            "shape": list(arr.shape),
            "dtype": str(arr.dtype),
            "crc32": zlib.crc32(arr.tobytes()) & 0xFFFFFFFF,
            **({"storage": storage} if storage else {}),
        })
    manifest = {
        "step": int(step),
        "n_leaves": len(entries),
        "leaves": entries,
        "config_fingerprint": config_fingerprint(config),
    }
    mpath = os.path.join(tmp, _MANIFEST)
    with open(mpath, "w") as f:
        json.dump(manifest, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):  # a replayed step overwrites its old commit
        shutil.rmtree(final)
    os.rename(tmp, final)
    _fsync_dir(directory)
    registry().counter("train.checkpoint.committed").inc()
    return final


def committed_steps(directory: str | os.PathLike) -> list[int]:
    """Steps with a *published* (renamed) checkpoint dir, ascending.  Temp
    dirs (in-flight or orphaned by a kill) are invisible by construction."""
    directory = os.fspath(directory)
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if name.startswith(_STEP_PREFIX) and not name.startswith("."):
            try:
                out.append(int(name[len(_STEP_PREFIX):]))
            except ValueError:
                continue
    return sorted(out)


def _validate_and_load(path: str, *, expect_fingerprint: str | None):
    """Returns (step, leaves) or raises ``CheckpointWarning``-shaped dicts
    via ValueError carrying the structured reason."""
    mpath = os.path.join(path, _MANIFEST)
    if not os.path.exists(mpath):
        raise ValueError(json.dumps({"reason": "missing_manifest"}))
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except Exception:
        raise ValueError(json.dumps({"reason": "corrupt_manifest"}))
    if expect_fingerprint is not None and manifest.get("config_fingerprint") != expect_fingerprint:
        raise ValueError(json.dumps({
            "reason": "config_fingerprint_mismatch",
            "manifest": manifest.get("config_fingerprint"),
            "expected": expect_fingerprint,
        }))
    leaves = []
    for entry in manifest["leaves"]:
        lpath = os.path.join(path, entry["file"])
        if not os.path.exists(lpath):
            raise ValueError(json.dumps({"reason": "missing_leaf", "file": entry["file"]}))
        arr = np.load(lpath)
        if (zlib.crc32(arr.tobytes()) & 0xFFFFFFFF) != entry["crc32"]:
            raise ValueError(json.dumps({"reason": "checksum_mismatch", "file": entry["file"]}))
        leaves.append(_from_numpy(arr, entry.get("storage")))
    if len(leaves) != manifest["n_leaves"]:
        raise ValueError(json.dumps({"reason": "leaf_count_mismatch"}))
    return int(manifest["step"]), leaves


def restore_latest(
    directory: str | os.PathLike,
    template,
    *,
    config: dict | None = None,
    strict_config: bool = False,
):
    """Restores the newest valid committed checkpoint.

    ``template`` supplies the tree structure, and each loaded leaf lands on
    the device and dtype of the template's tensor leaf.
    Returns ``(step, state)`` or ``None`` when nothing valid exists.  Torn
    or mismatched checkpoints are skipped — newest-first — with a
    :class:`CheckpointWarning` and a ``train.checkpoint.torn_skipped``
    counter tick, never an exception: elastic restart must always make
    progress from whatever survived."""
    directory = os.fspath(directory)
    expect = config_fingerprint(config) if (config is not None and strict_config) else None
    for step in reversed(committed_steps(directory)):
        path = os.path.join(directory, f"{_STEP_PREFIX}{step}")
        try:
            got_step, leaves = _validate_and_load(path, expect_fingerprint=expect)
        except ValueError as e:
            try:
                info = json.loads(str(e))
            except Exception:
                info = {"reason": "unreadable", "detail": str(e)}
            info.update({"path": path, "step": step})
            registry().counter("train.checkpoint.torn_skipped").inc()
            warnings.warn(CheckpointWarning(info), stacklevel=2)
            continue
        t_leaves, treedef = tree_flatten(template)
        if len(leaves) != len(t_leaves):
            registry().counter("train.checkpoint.torn_skipped").inc()
            warnings.warn(CheckpointWarning({
                "reason": "template_leaf_count_mismatch",
                "path": path, "step": step,
                "checkpoint_leaves": len(leaves), "template_leaves": len(t_leaves),
            }), stacklevel=2)
            continue
        placed = [arr.to(device=t.device, dtype=t.dtype) if isinstance(t, torch.Tensor)
                  else (arr.numpy() if isinstance(arr, torch.Tensor) else arr)
                  for arr, t in zip(leaves, t_leaves)]
        return got_step, tree_unflatten(treedef, placed)
    return None


class AsyncCheckpointer:
    """Per-shard checkpoint saves off the step path (dispatch/harvest).

    ``dispatch(step, state)`` copies the state to host memory (synchronous,
    and REQUIRED before returning: the caller's next step updates the params
    in place) and enqueues the write on the worker thread.
    ``harvest()`` returns completed ``{"step", "path"| "error"}`` records
    without blocking; ``wait()`` drains everything.  A failed save never
    raises into the step path — it surfaces as a harvest record (and the
    ``train.checkpoint.failed`` counter) for the elastic loop to classify."""

    def __init__(
        self,
        directory: str | os.PathLike,
        *,
        config: dict | None = None,
        fault_plan=None,
    ):
        self.directory = os.fspath(directory)
        self.config = config
        self.fault_plan = fault_plan
        os.makedirs(self.directory, exist_ok=True)
        self._pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="tt-ckpt")
        self._pending: list[tuple[int, Future]] = []
        self._done: list[dict] = []

    def dispatch(self, step: int, state) -> None:
        host_state = host_copy(state)
        registry().counter("train.checkpoint.dispatched").inc()
        self._pending.append((int(step), self._pool.submit(self._save, int(step), host_state)))

    def _save(self, step: int, host_state) -> str:
        if self.fault_plan is not None:
            from thunder_tpu_torch.serving.faults import FP_CKPT_SAVE

            self.fault_plan.check(FP_CKPT_SAVE, ())
        return save_checkpoint_atomic(self.directory, host_state, step=step, config=self.config)

    def _collect(self, block: bool) -> None:
        still = []
        for step, fut in self._pending:
            if block or fut.done():
                try:
                    self._done.append({"step": step, "path": fut.result()})
                except Exception as e:  # noqa: BLE001 — surfaced via harvest records
                    registry().counter("train.checkpoint.failed").inc()
                    self._done.append({"step": step, "error": e})
            else:
                still.append((step, fut))
        self._pending = still

    def harvest(self) -> list[dict]:
        """Completed save records since the last harvest (non-blocking)."""
        self._collect(block=False)
        out, self._done = self._done, []
        return out

    def wait(self) -> list[dict]:
        """Blocks until every dispatched save has committed or failed."""
        self._collect(block=True)
        out, self._done = self._done, []
        return out

    def close(self) -> None:
        self.wait()
        self._pool.shutdown(wait=True)

    def __enter__(self) -> "AsyncCheckpointer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
