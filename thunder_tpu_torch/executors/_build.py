"""Builds and loads the port's CUDA kernels (new in the port).

Every ``*.cu`` under ``thunder_tpu_torch/csrc/`` has a plain C interface
and includes no PyTorch header, so one ``nvcc`` call per source builds a
shared library in seconds; all the calls start together and run in
parallel, and the libraries are loaded with ``ctypes``.  The build happens
at first use, on the machine with the card, into ``build/thunder_tpu_torch/``
beside the package (a directory ``.gitignore`` lists), under names keyed by
one hash of every source and header in ``csrc/`` and the flags — any edited
source rebuilds, an unchanged tree is reused.  A failed build raises with
``nvcc``'s output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["NVCC_FLAGS", "build_dir", "build_info", "load_library", "nvcc_path", "sources"]

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_CSRC = Path(__file__).resolve().parents[1] / "csrc"

_P, _I = ctypes.c_void_p, ctypes.c_int
# every exported entry point: (argtypes, restype)
_SIGNATURES = {
    "tt_paged_attn_split": ([_P] * 11 + [_I] * 12 + [ctypes.c_float] + [_I] * 5 + [_P], _I),
    "tt_paged_token_write": ([_P] * 8 + [_I, _I, _P], _I),
    "tt_error_string": ([_I], ctypes.c_char_p),
    "tt_paged_attn_verify": ([_P] * 10 + [_I] * 10 + [ctypes.c_float, _I, _I, _I, _I, _P], _I),
    "tt_paged_chunk_write": ([_P] * 7 + [_I, _P], _I),
    "tt_paged_token_write_fused": ([_P] * 10 + [_I, ctypes.c_float, _I, _I, _I, _P], _I),
    "tt_paged_chunk_write_fused": ([_P] * 11 + [ctypes.c_float, _I, _I, _I, _P], _I),
    "tt_flash_fwd": ([_P] * 6 + [_I] * 13 + [ctypes.c_float, _I, _P], _I),
    "tt_flash_bwd_dq": ([_P] * 8 + [_I] * 13 + [ctypes.c_float, _I, _P], _I),
    "tt_flash_bwd_dkv": ([_P] * 10 + [_I] * 14 + [ctypes.c_float, _I, _P], _I),
    "tt_flash_ce": ([_P] * 4 + [_I] * 4 + [_P], _I),
    "tt_lora_delta": ([_P] * 7 + [_I, ctypes.c_float, _P], _I),
    "tt_lora_plan": ([ctypes.c_int64] * 4 + [_I, _P], _I),
}


class Kernels:
    """The entry points of every built library, as attributes."""

    def __init__(self, libs: list[ctypes.CDLL]):
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = next((getattr(lib, name) for lib in libs if hasattr(lib, name)), None)
            if fn is None:
                raise RuntimeError(f"no built library exports {name}")
            fn.argtypes, fn.restype = argtypes, restype
            setattr(self, name, fn)


# the loaded kernels and what the build reported (seconds, per-source ptxas log)
_lib: Kernels | None = None
build_info: dict = {}


def build_dir() -> Path:
    """``build/thunder_tpu_torch/`` at the root of the checkout."""
    return Path(__file__).resolve().parents[2] / "build" / "thunder_tpu_torch"


def sources() -> list[Path]:
    return sorted(_CSRC.glob("*.cu"))


def nvcc_path() -> str | None:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    return str(default) if default.exists() else None


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(_CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh", ".h"):
            h.update(path.name.encode() + b"\0" + path.read_bytes())
    return h.hexdigest()[:16]


def _compile_all(jobs: list[tuple[Path, Path]]) -> float:
    """Runs one ``nvcc`` per (source, output) pair, all at once; returns the
    wall seconds of the whole build."""
    nvcc = nvcc_path()
    if nvcc is None:
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): cannot build "
                           + ", ".join(src.name for src, _ in jobs))
    t0 = time.perf_counter()
    running = []
    for src, out in jobs:
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
        proc = subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((src, out, tmp, proc))
    failed = []
    for src, out, tmp, proc in running:
        try:
            log, _ = proc.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            proc.kill()
            log, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed (exit {proc.returncode}) building {src}:\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return time.perf_counter() - t0


def load_library() -> Kernels:
    """The kernels' entry points, built on first use and loaded once per
    process."""
    global _lib
    if _lib is not None:
        return _lib
    digest = _digest()
    outs = {src: build_dir() / f"{src.stem}_{digest}.so" for src in sources()}
    missing = [(src, out) for src, out in outs.items() if not out.exists()]
    seconds = _compile_all(missing) if missing else 0.0
    libs = [ctypes.CDLL(str(out)) for out in outs.values()]
    _lib = Kernels(libs)
    build_info.update(cached=not missing, seconds=seconds, sources={
        src.name: {"path": str(out),
                   "log": out.with_suffix(".log").read_text()
                   if out.with_suffix(".log").exists() else ""}
        for src, out in outs.items()})
    return _lib
