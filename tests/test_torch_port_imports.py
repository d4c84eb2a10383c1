"""thunder_tpu_torch imports neither JAX nor the JAX package.

An ``ast`` scan of every module of the port and of ``chip_smoke.py`` looks
at each import's top-level package name (exactly: ``thunder_tpu_torch``
starts with the string ``thunder_tpu``, so a prefix test would misfire), and
a subprocess with ``jax`` blocked imports the serving package.
"""
from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from torch_port_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "thunder_tpu"}
SOURCES = sorted((ROOT / "thunder_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_packages(path: Path) -> set[str]:
    found = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            found.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            found.add(node.module.split(".")[0])
    return found


def test_scan_covers_the_port():
    names = {p.relative_to(ROOT).as_posix() for p in SOURCES}
    for must in ("thunder_tpu_torch/serving/engine.py", "thunder_tpu_torch/executors/cudaex.py",
                 "thunder_tpu_torch/models/generate.py", "thunder_tpu_torch/core/prims.py",
                 "thunder_tpu_torch/functional.py", "thunder_tpu_torch/executors/torchex.py",
                 "thunder_tpu_torch/torch/__init__.py", "thunder_tpu_torch/__init__.py",
                 "thunder_tpu_torch/common.py", "thunder_tpu_torch/core/cache_key.py",
                 "thunder_tpu_torch/core/rng.py", "thunder_tpu_torch/core/sharp_edges.py",
                 "thunder_tpu_torch/core/interpreter.py", "thunder_tpu_torch/core/jit_ext.py",
                 "thunder_tpu_torch/distributed/sharding.py",
                 "thunder_tpu_torch/distributed/prims.py",
                 "thunder_tpu_torch/distributed/multihost.py",
                 "thunder_tpu_torch/distributed/checkpoint.py",
                 "thunder_tpu_torch/distributed/launch.py", "thunder_tpu_torch/train/overlap.py",
                 "chip_smoke.py"):
        assert must in names


@pytest.mark.parametrize("path", SOURCES, ids=[p.relative_to(ROOT).as_posix() for p in SOURCES])
def test_no_jax_or_reference_imports(path):
    assert not (_imported_packages(path) & FORBIDDEN)


def test_scanner_tells_the_packages_apart(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import thunder_tpu_torch.models\nfrom thunder_tpu.serving import x\n"
                   "def f():\n    import jax.numpy\n")
    assert _imported_packages(src) & FORBIDDEN == {"thunder_tpu", "jax"}


def test_serving_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'thunder_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import thunder_tpu_torch, thunder_tpu_torch.serving, chip_smoke\n"
        "from thunder_tpu_torch.serving import serve\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', "
        "'thunder_tpu') and sys.modules[m] is not None]\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """Without a card (as here) the smoke script exits non-zero and prints
    no result line; alone in a directory it fails at import."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    proc = subprocess.run([sys.executable, str(lone)], cwd=tmp_path, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout
