"""Persistent compilation cache for the fusion regions.

Counterpart of ``thunder_tpu/core/compile_cache.py``, which points JAX's
persistent XLA cache at a directory.  Here the compiled programs are
inductor's (``executors/inductorex.py``), so the cache is inductor's own
on-disk caches: the FX-graph cache and the Triton kernels, both under
``TORCHINDUCTOR_CACHE_DIR``, which :func:`enable` points at
``<repo-root>/build/thunder_tpu_torch/inductor`` (``build/`` is git-ignored).
A second process that compiles the same region loads it from there.

Enabled lazily at the first ``thunder_tpu_torch.jit``/``TrainStep``
construction, so a plain ``import thunder_tpu_torch`` changes no setting.
Controls, as in the reference:

- ``THUNDER_TPU_COMPILATION_CACHE``: ``off``/``0`` disables it; otherwise a
  directory that replaces the default.
- ``THUNDER_TPU_CACHE_MIN_COMPILE_S``: the least seconds a region's compile
  must take for its FX-graph entries to stay on disk (default 0: keep
  everything).  Entries of a faster compile are removed after it.

Cross-process hits and misses are inductor's FX-graph-cache counters
(``fxgraph_cache_hit``/``fxgraph_cache_miss``), read by :func:`stats` and
surfaced as ``thunder_tpu_torch.compile_stats(jfn).persistent_cache``.
"""
from __future__ import annotations

import os
import threading

__all__ = ["enable", "ensure_enabled", "stats", "cache_dir"]

_lock = threading.Lock()
_enabled_dir: str | None = None
_min_compile_s = 0.0
_before: set | None = None


def _default_dir() -> str:
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return os.path.join(root, "build", "thunder_tpu_torch", "inductor")


def _fxgraph_files() -> set:
    root = os.path.join(_enabled_dir or "", "fxgraph")
    out = set()
    for dirpath, _, files in os.walk(root):
        out.update(os.path.join(dirpath, f) for f in files)
    return out


def enable(directory: str | None = None) -> str | None:
    """Points inductor's on-disk caches at ``directory`` (resolved against
    the env override / repo default when None).  Returns the active
    directory, or None when disabled via ``THUNDER_TPU_COMPILATION_CACHE=off``.
    Idempotent."""
    global _enabled_dir, _min_compile_s, _before
    with _lock:
        env = os.environ.get("THUNDER_TPU_COMPILATION_CACHE", "").strip()
        if env.lower() in ("off", "0", "false", "disabled"):
            return None
        directory = os.path.abspath(directory or (env or None) or _default_dir())
        if _enabled_dir == directory:
            return _enabled_dir
        os.makedirs(directory, exist_ok=True)
        os.environ["TORCHINDUCTOR_CACHE_DIR"] = directory
        import torch._inductor.config as inductor_config

        inductor_config.fx_graph_cache = True
        try:
            _min_compile_s = float(os.environ.get("THUNDER_TPU_CACHE_MIN_COMPILE_S", "0"))
        except ValueError:
            _min_compile_s = 0.0
        _enabled_dir = directory
        _before = _fxgraph_files() if _min_compile_s > 0 else None
        return _enabled_dir


def ensure_enabled() -> str | None:
    """Lazy default-on hook used by jit/TrainStep: enables the cache at its
    default location unless already configured or switched off.  Without a
    card and without an explicit directory it does nothing: CPU regions run
    their plain versions and compile nothing."""
    if _enabled_dir is not None:
        return _enabled_dir
    if not os.environ.get("THUNDER_TPU_COMPILATION_CACHE", "").strip():
        import torch

        if not torch.cuda.is_available():
            return None
    return enable()


def compiled(seconds: float) -> None:
    """Called after each region's first compile: with a positive
    ``THUNDER_TPU_CACHE_MIN_COMPILE_S``, removes the FX-graph entries a
    faster compile wrote."""
    global _before
    if _before is None:
        return
    now = _fxgraph_files()
    if seconds < _min_compile_s:
        for path in now - _before:
            try:
                os.remove(path)
            except OSError:
                pass
        now = _fxgraph_files()
    _before = now


def cache_dir() -> str | None:
    return _enabled_dir


def stats() -> dict:
    """Process-wide persistent-cache counters: ``persistent_cache_hits`` is
    region graphs loaded from disk instead of compiled (cross-process
    reuse), ``persistent_cache_misses`` graphs compiled and written."""
    from torch._dynamo.utils import counters

    inductor = counters["inductor"]
    return {"persistent_cache_hits": int(inductor["fxgraph_cache_hit"]),
            "persistent_cache_misses": int(inductor["fxgraph_cache_miss"]),
            "dir": _enabled_dir}
