"""thunder_tpu_torch's training slice against the JAX package, on the CPU.

The same numpy-made weights and batches go through ``thunder_tpu`` (JAX on
the CPU) and the port:

- ``gpt_loss`` and its grads against ``tt.value_and_grad`` of the JAX
  ``gpt_loss`` (``tiny-llama-debug``, and ``tiny-mistral-debug`` for the
  sliding window), float32, T=128 so the port runs the flash kernels'
  plain versions: loss within 1e-5 relative, each grad within 1e-4 of its
  own largest magnitude (the same math in other summation orders, and the
  JAX side's reference attention against the port's blockwise one);
- three ``TrainStep`` steps against the JAX ``make_train_step(...,
  optax.adamw(lr), make_mesh({"dp": 1}))`` (built as
  ``tests/test_train_loop.py`` builds it), plain and ``accum_steps=2``:
  per-step losses within 1e-5 relative, final params within a hundredth
  of lr per step (AdamW divides each grad by its own running rms, so a
  weight whose grad is near rounding noise moves by up to lr either way;
  measured 5.8e-6 after 3 steps at lr 1e-3);
- the remat policies give bitwise-equal losses and grads (the CPU is
  deterministic);
- the loop's recovery grammar (``tests/test_train_loop.py``'s
  ``TestLoopLogic``, ported), and a kill-and-restart run whose loss curve
  and params bitwise equal the undisturbed run's;
- a torn checkpoint is skipped with a warning; bf16 leaves round-trip
  bitwise;
- the CLI trains two steps with ``--device cpu``; unported options raise.
"""
from __future__ import annotations

import json
import subprocess
import sys
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import thunder_tpu as tt
import thunder_tpu_torch as ttt
from thunder_tpu import distributed as dist
from thunder_tpu.models import llama as jllama
from thunder_tpu_torch import train_cli
from thunder_tpu_torch._tree import tree_leaves
from thunder_tpu_torch.models import llama as tllama
from thunder_tpu_torch.serving.faults import (
    FP_CKPT_SAVE,
    FP_TRAIN_STEP,
    FaultPlan,
    FaultSpec,
    RecoveryError,
    RequestAnomalyFault,
    RetryPolicy,
    classify_fault,
)
from thunder_tpu_torch.train import remat as tremat
from thunder_tpu_torch.train.accum import accum_buffer_bytes, split_for_accum
from thunder_tpu_torch.train.checkpoint import (
    AsyncCheckpointer,
    CheckpointWarning,
    restore_latest,
    save_checkpoint_atomic,
)
from thunder_tpu_torch.train.loop import train_loop

ROOT = Path(__file__).resolve().parents[1]
B, T = 2, 128
LR = 1e-3


def _setup(name="tiny-llama-debug", seed=0):
    """JAX params (seed ``seed``) and numpy batch, as both packages take them."""
    jcfg = jllama.Config.from_name(name)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(seed), dtype=jnp.float32)
    rng = np.random.default_rng(seed + 1)
    idx = rng.integers(0, jcfg.vocab_size, (B, T)).astype(np.int32)
    tgt = rng.integers(0, jcfg.vocab_size, (B, T)).astype(np.int32)
    tgt[0, :5] = -100                                  # ignored targets, exact mean
    return jcfg, jparams, idx, tgt


def _port_params(jparams):
    return ttt.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")


def _port_batch(cfg, idx, tgt):
    cos, sin = tllama.build_rope_cache(cfg, T)
    return torch.as_tensor(idx), torch.as_tensor(tgt).long(), cos, sin


def _port_step(cfg, **kw):
    return ttt.make_train_step(lambda p, i, t, c, s: tllama.gpt_loss(p, i, t, c, s, cfg),
                               ttt.adamw(LR), {"dp": 1}, **kw)


def _rel_close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    bar = rel * max(float(np.abs(want).max()), 1e-30)
    assert np.abs(got - want).max() <= bar, (float(np.abs(got - want).max()), bar)


@pytest.mark.parametrize("name", ["tiny-llama-debug", "tiny-mistral-debug"])
def test_gpt_loss_and_grads_match_jax(name):
    jcfg, jparams, idx, tgt = _setup(name)
    cos, sin = jllama.build_rope_cache(jcfg, T)
    jl, jg = tt.value_and_grad(
        lambda p, i, t, c, s: jllama.gpt_loss(p, i, t, c, s, jcfg))(
            jparams, jnp.asarray(idx), jnp.asarray(tgt), cos, sin)
    cfg = tllama.Config.from_name(name)
    params = _port_params(jparams)
    step = _port_step(cfg, remat=False)
    ttt.ltorch.DECLINES.update(flash_sdpa=0, flash_sdpa_backward=0, flash_cross_entropy=0)
    loss, grads = step.grads(params, None, *_port_batch(cfg, idx, tgt))
    assert ttt.ltorch.DECLINES == {"flash_sdpa": 0, "flash_sdpa_backward": 0,
                                   "flash_cross_entropy": 0}
    _rel_close(loss.item(), float(jl), 1e-5)
    got, want = tree_leaves(grads), jax.tree_util.tree_leaves(jg)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert tuple(a.shape) == b.shape
        _rel_close(a.numpy(), np.asarray(b), 1e-4)


@pytest.fixture(scope="module")
def jax_runs():
    """Three JAX TrainStep steps, plain and accum_steps=2, from one start."""
    jcfg, jparams, idx, tgt = _setup()
    cos, sin = jllama.build_rope_cache(jcfg, T)
    mesh = dist.make_mesh({"dp": 1}, devices=jax.devices()[:1])
    out = {}
    for k in (1, 2):
        ts = dist.make_train_step(lambda p, i, t, c, s: jllama.gpt_loss(p, i, t, c, s, jcfg),
                                  optax.adamw(LR), mesh, accum_steps=k)
        p = dist.ddp(jparams, mesh)
        o = ts.init_optimizer_state(p)
        losses = []
        for _ in range(3):
            p, o, loss = ts(p, o, jnp.asarray(idx), jnp.asarray(tgt), cos, sin)
            losses.append(float(loss))
        out[k] = (losses, [np.asarray(x) for x in jax.tree_util.tree_leaves(p)])
    return jparams, idx, tgt, out


@pytest.mark.parametrize("accum_steps", [1, 2])
def test_train_steps_match_jax(jax_runs, accum_steps):
    jparams, idx, tgt, out = jax_runs
    want_losses, want_params = out[accum_steps]
    cfg = tllama.Config.from_name("tiny-llama-debug")
    step = _port_step(cfg, accum_steps=accum_steps)
    params = _port_params(jparams)
    opt_state = step.init_optimizer_state(params)
    batch = _port_batch(cfg, idx, tgt)
    losses = []
    for _ in range(3):
        params, opt_state, loss = step(params, opt_state, *batch)
        losses.append(loss.item())
    assert step.last_remat_policy == "attention"
    for got, want in zip(losses, want_losses):
        _rel_close(got, want, 1e-5)
    for a, b in zip(tree_leaves(params), want_params):
        assert np.abs(a.numpy() - b).max() <= 1e-2 * LR * 3


def test_remat_policies_give_equal_losses_and_grads():
    _, jparams, idx, tgt = _setup(seed=3)
    cfg = tllama.Config.from_name("tiny-llama-debug")
    params = _port_params(jparams)
    batch = _port_batch(cfg, idx, tgt)
    results = {}
    for policy in tremat.REMAT_POLICIES:
        step = _port_step(cfg, remat=policy)
        results[policy] = step.grads(params, None, *batch)
        assert step.last_remat_policy == policy
    loss0, grads0 = results["none"]
    for policy in ("attention", "full_block"):
        loss, grads = results[policy]
        assert torch.equal(loss, loss0)
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(grads), tree_leaves(grads0)))


def test_remat_vocabulary_and_unported_options():
    assert tremat.resolve_remat(True).policy == "attention"
    assert tremat.resolve_remat(False).policy == "none"
    assert tremat.resolve_remat("auto", auto=lambda: False).policy == "none"
    assert tremat.resolve_remat("none", zero3=True).policy == "full_block"
    with pytest.raises(ValueError, match="remat must be"):
        tremat.validate_remat("sometimes")
    cfg = tllama.Config.from_name("tiny-llama-debug")
    step = _port_step(cfg, remat="auto")
    params = ttt.init_params(cfg, device="cpu", dtype=torch.float32)
    step.grads(params, None, *_port_batch(cfg, *np.zeros((2, B, T), np.int32)))
    assert step.last_remat_policy == "attention"         # no device budget on the CPU
    for kw in ({"zero3": True}, {"quant": "int8"}, {"overlap": True}, {"bucketer": len},
               {"comm_combine_threshold_mb": 4.0}):
        with pytest.raises(NotImplementedError, match=next(iter(kw))):
            _port_step(cfg, **kw)
    with pytest.raises(NotImplementedError, match="multi-device"):
        ttt.make_train_step(len, ttt.adamw(LR), {"dp": 2})
    with pytest.raises(ValueError, match="must divide"):
        split_for_accum((torch.zeros(3, 4, dtype=torch.int32),), 2)
    assert accum_buffer_bytes(params) == 4 * tllama.param_count(params)
    cfg_moe = tllama.Config.from_name("tiny-moe-debug")
    with pytest.raises(NotImplementedError, match="MoE"):
        tllama.gpt_hidden({"wte": torch.zeros(4, 4), "blocks": []}, torch.zeros(1, 2), None, None,
                          cfg_moe)
    with pytest.raises(NotImplementedError, match="fused_head_ce"):
        tllama.gpt_loss({}, None, None, None, None,
                        tllama.Config.from_name("tiny-llama-debug", fused_head_ce=True))


def test_donate_false_keeps_the_callers_params():
    cfg = tllama.Config.from_name("tiny-llama-debug")
    params = ttt.init_params(cfg, device="cpu", dtype=torch.float32)
    before = [x.clone() for x in tree_leaves(params)]
    step = _port_step(cfg, donate=False)
    new, _, _ = step(params, step.init_optimizer_state(params),
                     *_port_batch(cfg, *np.ones((2, B, T), np.int32)))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(params), before))
    assert not torch.equal(tree_leaves(new)[0], before[0])


#
# the elastic loop (tests/test_train_loop.py TestLoopLogic, ported)
#

NO_SLEEP = lambda: RetryPolicy(max_retries=3, sleep=lambda s: None)  # noqa: E731
BATCH = lambda s: (s,)  # noqa: E731 — pure function of the step index


def _fake_step(params, opt_state, s):
    """Pure fake: params counts completed steps, loss encodes the step."""
    return {"w": params["w"] + 1.0}, opt_state, 100.0 + s


def _tensor_step(params, opt_state, s):
    """In place, like the port's TrainStep."""
    params["w"].add_(1.0)
    return params, opt_state, float(100 + s)


class TestLoopLogic:
    def test_clean_run(self):
        res = train_loop(_fake_step, {"w": 0.0}, {}, BATCH, steps=3)
        assert res.losses == [100.0, 101.0, 102.0]
        assert res.steps_run == 3 and res.restarts == 0 and res.retries == 0
        assert res.params["w"] == 3.0

    def test_transient_fault_retries_same_step(self):
        slept = []
        plan = FaultPlan([FaultSpec(point=FP_TRAIN_STEP, kind="fail", at=2)])
        retry = RetryPolicy(max_retries=3, backoff_s=0.05, sleep=slept.append)
        res = train_loop(_fake_step, {"w": 0.0}, {}, BATCH, steps=3, fault_plan=plan,
                         retry=retry)
        assert res.losses == [100.0, 101.0, 102.0]
        assert res.retries == 1 and res.restarts == 0
        assert res.steps_run == 3 and res.params["w"] == 3.0
        assert slept == [0.05]
        assert res.faults[0]["kind"] == "fail" and res.faults[0]["point"] == FP_TRAIN_STEP

    def test_transient_exhaustion_raises_recovery_error(self):
        plan = FaultPlan([FaultSpec(point=FP_TRAIN_STEP, kind="fail", at=1, count=5)])
        retry = RetryPolicy(max_retries=1, sleep=lambda s: None)
        with pytest.raises(RecoveryError, match="persisted past"):
            train_loop(_fake_step, {"w": 0.0}, {}, BATCH, steps=3, fault_plan=plan,
                       retry=retry)

    def test_engine_fault_restarts_from_seed_without_checkpointer(self):
        plan = FaultPlan([FaultSpec(point=FP_TRAIN_STEP, kind="oom", at=3)])
        res = train_loop(_tensor_step, {"w": torch.zeros(())}, {}, BATCH, steps=4,
                         fault_plan=plan, retry=NO_SLEEP())
        assert res.restarts == 1 and res.resumed_from == 0
        assert res.losses == [100.0, 101.0, 102.0, 103.0]
        assert float(res.params["w"]) == 4.0   # replayed from a pristine copy, not doubled
        assert res.steps_run == 6

    def test_engine_fault_restores_newest_checkpoint(self, tmp_path):
        plan = FaultPlan([FaultSpec(point=FP_TRAIN_STEP, kind="oom", at=5)])
        with AsyncCheckpointer(tmp_path) as ck:
            res = train_loop(_tensor_step, {"w": torch.zeros(())}, {"m": torch.zeros(())},
                             BATCH, steps=6, checkpointer=ck, checkpoint_every=2,
                             fault_plan=plan, retry=NO_SLEEP())
        assert res.restarts == 1 and res.resumed_from == 4
        assert res.steps_run == 4 + 2
        assert float(res.params["w"]) == 6.0
        assert res.losses == [100.0, 101.0, 102.0, 103.0, 104.0, 105.0]
        assert res.checkpoint_failures == []

    def test_restart_budget_exhausted(self):
        plan = FaultPlan([FaultSpec(point=FP_TRAIN_STEP, kind="oom", at=1, count=99)],
                         max_faults=99)
        with pytest.raises(RecoveryError, match="restart budget"):
            train_loop(_fake_step, {"w": 0.0}, {}, BATCH, steps=3, fault_plan=plan,
                       retry=NO_SLEEP(), max_restarts=2)

    def test_request_class_escalates(self):
        plan = FaultPlan([FaultSpec(point=FP_TRAIN_STEP, kind="nan", at=2, rid=None)])
        with pytest.raises(RequestAnomalyFault):
            train_loop(_fake_step, {"w": 0.0}, {}, BATCH, steps=3, fault_plan=plan)

    def test_unclassified_exception_reraises(self):
        def bad_step(params, opt_state, s):
            raise KeyError("programming error")

        with pytest.raises(KeyError):
            train_loop(bad_step, {"w": 0.0}, {}, BATCH, steps=2)

    def test_failed_save_recorded_not_raised(self, tmp_path):
        ck_plan = FaultPlan([FaultSpec(point=FP_CKPT_SAVE, kind="fail", at=1)])
        with AsyncCheckpointer(tmp_path, fault_plan=ck_plan) as ck:
            res = train_loop(_tensor_step, {"w": torch.zeros(())}, {}, BATCH, steps=4,
                             checkpointer=ck, checkpoint_every=2)
        assert res.losses == [100.0, 101.0, 102.0, 103.0]
        assert len(res.checkpoint_failures) == 1
        assert res.checkpoint_failures[0]["step"] == 2

    def test_on_step_sees_every_final_step_once(self):
        seen = []
        plan = FaultPlan([FaultSpec(point=FP_TRAIN_STEP, kind="fail", at=2)])
        train_loop(_fake_step, {"w": 0.0}, {}, BATCH, steps=3, fault_plan=plan,
                   retry=NO_SLEEP(), on_step=lambda s, loss: seen.append(s))
        assert seen == [0, 1, 2]


def test_torch_out_of_memory_classes_as_engine():
    assert classify_fault(torch.OutOfMemoryError("CUDA out of memory. Tried to allocate")) \
        == "engine"


def test_kill_and_restart_loss_curve_bit_identical(tmp_path):
    """A real TrainStep loop, clean, then under an injected engine fault
    with async checkpoints: the loss curves and final params bitwise equal."""
    cfg = tllama.Config.from_name("tiny-llama-debug")
    step = _port_step(cfg)
    cos, sin = tllama.build_rope_cache(cfg, T)

    def batch_for_step(s):
        rng = np.random.default_rng(100 + s)
        idx = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, T)))
        return idx, torch.roll(idx, -1, dims=1), cos, sin

    def fresh():
        params = ttt.init_params(cfg, device="cpu", dtype=torch.float32)
        return params, step.init_optimizer_state(params)

    clean = train_loop(step, *fresh(), batch_for_step, steps=5)
    plan = FaultPlan([FaultSpec(point=FP_TRAIN_STEP, kind="oom", at=4)])
    with AsyncCheckpointer(tmp_path) as ck:
        faulted = train_loop(step, *fresh(), batch_for_step, steps=5, checkpointer=ck,
                             checkpoint_every=2, fault_plan=plan, retry=NO_SLEEP())
    assert faulted.restarts == 1 and faulted.resumed_from == 2
    assert [x.numpy().tobytes() for x in faulted.losses] == \
        [x.numpy().tobytes() for x in clean.losses]
    for a, b in zip(tree_leaves((clean.params, clean.opt_state)),
                    tree_leaves((faulted.params, faulted.opt_state))):
        assert torch.equal(a, b)


def test_torn_checkpoint_skipped_with_warning(tmp_path):
    state = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
             "h": torch.randn(4, 5).to(torch.bfloat16), "n": [torch.tensor(7)]}
    save_checkpoint_atomic(tmp_path, state, step=2)
    bumped = {"w": state["w"] + 1, "h": state["h"], "n": state["n"]}
    path = save_checkpoint_atomic(tmp_path, bumped, step=4)
    leaf = Path(path) / "leaf_00000.npy"                    # flip one stored byte
    raw = bytearray(leaf.read_bytes())
    raw[-1] ^= 0xFF
    leaf.write_bytes(bytes(raw))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        step, got = restore_latest(tmp_path, state)
    assert step == 2
    torn = [w.message for w in caught if isinstance(w.message, CheckpointWarning)]
    assert len(torn) == 1 and torn[0].info["reason"] == "checksum_mismatch"
    assert got["h"].dtype == torch.bfloat16 and torch.equal(got["h"], state["h"])
    assert torch.equal(got["w"], state["w"]) and torch.equal(got["n"][0], state["n"][0])
    (Path(path) / "manifest.json").unlink()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert restore_latest(tmp_path, state)[0] == 2
    assert caught[0].message.info["reason"] == "missing_manifest"


def test_cli_trains_two_steps_on_the_cpu(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "thunder_tpu_torch.train_cli", "--device", "cpu", "--steps", "2",
         "--batch", "2", "--checkpoint-dir", str(tmp_path / "ck"), "--checkpoint-every", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["device"] == "cpu" and out["mode"] == "none" and np.isfinite(out["final_loss"])
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == ["step_1", "step_2"]


@pytest.mark.parametrize("argv,match", [
    (["--mode", "fsdp"], "--mode fsdp"), (["--fused-ce"], "--fused-ce"),
    (["--quant", "int8"], "--quant"), (["--devices", "2"], "--devices"),
    (["--overlap"], "--overlap"), (["--telemetry", "t.jsonl"], "--telemetry")])
def test_cli_refuses_unported_options(argv, match):
    with pytest.raises(NotImplementedError, match=match):
        train_cli.main([*argv, "--device", "cpu"])
