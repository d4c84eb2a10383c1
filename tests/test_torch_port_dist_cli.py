"""The port's CLI across ranks, and what stays refused.

One subprocess runs ``python -m thunder_tpu_torch.train_cli --device cpu
--devices 2 --mode zero3`` with the combining, bucketing and telemetry
flags: two gloo ranks (the CLI's own launcher), three steps of
tiny-llama-debug after the first; it must exit 0 with finite, falling
losses, the collectives of a combined ZeRO-3 step and one telemetry
record per step (with the grad norm) beside its run-start record.  Then
the refusals that remain: ``sp``/``pp``/``ep`` and ``--sp-impl`` (later
slices), ``ServingEngine(mesh=)``, more ranks than cards.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import thunder_tpu_torch as ttt
from thunder_tpu_torch import train_cli
from thunder_tpu_torch.distributed import launch
from torch_port_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


def test_zero3_on_two_ranks(tmp_path):
    tel = tmp_path / "steps.jsonl"
    proc = subprocess.run(
        [sys.executable, "-m", "thunder_tpu_torch.train_cli", "--device", "cpu", "--devices", "2",
         "--mode", "zero3", "--steps", "3", "--batch", "4", "--seq", "12", "--bucket",
         "--comm-combine-mb", "0.02", "--telemetry", str(tel), "--telemetry-grad-norm",
         "--checkpoint-dir", str(tmp_path / "ck")],
        cwd=ROOT, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert (out["mode"], out["devices"], out["device"]) == ("zero3", 2, "cpu")
    losses = out["losses"]
    assert len(losses) == 4 and all(math.isfinite(x) for x in losses)
    assert losses[-1] < losses[0]
    c = out["collectives"]
    assert c["all_gather"] > 0 and c["reduce_scatter"] > 0 and c["all_reduce"] >= 1
    recs = [json.loads(line) for line in tel.read_text().splitlines()]
    assert recs[0]["event"] == "run_start" and recs[0]["devices"] == 2
    steps = [r for r in recs if r["event"] == "step"]
    assert [r["loss"] for r in steps] == pytest.approx(losses[1:], rel=1e-5)
    assert all(r["grad_norm"] > 0 for r in steps)
    assert (tmp_path / "ck" / "step_3" / ".metadata").exists()


@pytest.mark.parametrize("argv,match", [
    (["--mode", "sp"], "--mode sp"), (["--mode", "pp"], "--mode pp"),
    (["--mode", "ep"], "--mode ep"), (["--mode", "ddp", "--sp-impl", "ulysses"], "--sp-impl")])
def test_later_slices_refuse(argv, match):
    with pytest.raises(NotImplementedError, match=match):
        train_cli.main([*argv, "--device", "cpu"])


def test_mesh_serving_refuses():
    cfg = ttt.Config.from_name("tiny-llama-debug")
    params = ttt.init_params(cfg, device="cpu", dtype=torch.float32)
    with pytest.raises(NotImplementedError, match="mesh"):
        ttt.serve(None, params, cfg, device="cpu", mesh={"tp": 2})


def test_more_ranks_than_cards_refuses(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="2 ranks need 2 cards"):
        launch(print, 2, device="cuda")
