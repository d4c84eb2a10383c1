"""The port's sharded train steps against the JAX package and its own
single-device step.

One world of four gloo ranks (``tests/torch_port_dist_workers.py``, torch
and the port only; one thread each; a ``FileStore`` under ``tmp_path``)
runs every case; the JAX side runs here on ``jax.devices()[:4]`` of the
virtual CPU mesh while the world runs.  tiny-llama-debug, float32, B=8,
T=16, AdamW lr 1e-3, two steps, params from the JAX package's
``init_params`` through ``params_from_numpy``:

- DDP on ``{"dp": 4}`` with ``overlap=True``, ZeRO-2 on ``{"fsdp": 4}``
  and ZeRO-3 on ``{"dp": 2, "fsdp": 2}`` (``fsdp(min_size=64)``) against
  the JAX ``make_train_step`` on the same mesh shape: per-step losses
  within 1e-5 relative, params within lr/100 per step (the bar of
  ``tests/test_torch_port_train.py``);
- those, ZeRO-3 and DDP at world 2 (a half of the world) and a
  ``comm_combine_threshold_mb`` step, against the port's single-device
  ``TrainStep``: the grads at the start within 1e-6 of each grad's largest
  magnitude and each step's loss within 1e-6 relative; the params after
  each step within the JAX bar, lr/100 per step (AdamW divides each grad
  by its running rms, so a weight whose grad is rounding noise moves by up
  to lr either way: 1.26e-6 after the first step, measured here);
- the collectives each step issued, against the placements: DDP's
  all-reduces = ``expected_all_reduces(buckets)``, ZeRO-2 one gather and
  one reduce-scatter per param, ZeRO-3 the gathers again in the backward;
  the combined step fewer;
- the DDP step's fusion regions are the single-device step's under
  ``full_block`` (the regions phase 20 on the card must meet compiled, and
  its bitwise comparison with phase 10);
- the optimizer state placed where the param is; the caller's tensors
  untouched; ``no_sync``/``accumulate`` over two micro batches equal to
  the big batch; a new batch shape builds again and the bucketer maps two
  shapes to one program; ``tp`` > 1 refused;
- a checkpoint saved on ``{"fsdp": 4}`` and loaded on ``{"dp": 2, "fsdp":
  2}``, bitwise, on the template's placements.
"""
from __future__ import annotations

import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from thunder_tpu import distributed as jdist
from thunder_tpu.models import llama as jllama
import thunder_tpu_torch as ttt
from thunder_tpu_torch._tree import tree_leaves
from thunder_tpu_torch.distributed import launch
from thunder_tpu_torch.models import llama as tllama
from thunder_tpu_torch.train.overlap import expected_all_reduces
import torch_port_dist_workers as workers
from torch_port_threads import one_torch_thread  # noqa: F401

B, T, LR, STEPS = 8, 16, 1e-3, 2
WORLD_TIMEOUT_S = 180
JAX_CASES = {"ddp": ({"dp": 4}, dict(overlap=True, overlap_bucket_mb=0.05)),
             "zero2": ({"fsdp": 4}, {}),
             "zero3": ({"dp": 2, "fsdp": 2}, dict(zero3=True))}
PORT_CASES = [*JAX_CASES, "zero3_w2", "ddp_w2", "combined"]


def _jax_run(jparams, batch, axes, kw):
    cfg = jllama.Config.from_name("tiny-llama-debug")
    mesh = jdist.make_mesh(axes, devices=jax.devices()[:4])
    step = jdist.make_train_step(lambda p, i, t, c, s: jllama.gpt_loss(p, i, t, c, s, cfg),
                                 optax.adamw(LR), mesh, **kw)
    p = jdist.ddp(jparams, mesh) if "dp" in axes and len(axes) == 1 else \
        jdist.fsdp(jparams, mesh, min_size=64)
    o = step.init_optimizer_state(p)
    losses = []
    for _ in range(STEPS):
        p, o, loss = step(p, o, *batch)
        losses.append(float(loss))
    return losses, [np.asarray(x) for x in jax.tree_util.tree_leaves(p)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cfg = jllama.Config.from_name("tiny-llama-debug")
    jparams = jllama.init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    rng = np.random.default_rng(11)
    idx = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    tgt = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    params = ttt.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    tcfg = tllama.Config.from_name("tiny-llama-debug")
    batch = (torch.as_tensor(idx), torch.as_tensor(tgt).long(), *tllama.build_rope_cache(tcfg, T))
    got: dict = {}
    base = tmp_path_factory.mktemp("dist_train")

    def run():
        try:
            got["ranks"] = launch(workers.train_world, 4,
                                  args=(params, batch, LR, STEPS, str(base / "ckpt")), threads=1,
                                  timeout_s=WORLD_TIMEOUT_S, workdir=str(base))
        except Exception as e:      # re-raised in the test thread below
            got["error"] = e

    t = threading.Thread(target=run)
    t.start()
    jbatch = (jnp.asarray(idx), jnp.asarray(tgt), *jllama.build_rope_cache(cfg, T))
    jax_out = {name: _jax_run(jparams, jbatch, axes, kw) for name, (axes, kw) in JAX_CASES.items()}
    # the port's single-device step on the whole batch
    single = ttt.make_train_step(lambda p, i, t, c, s: tllama.gpt_loss(p, i, t, c, s, tcfg),
                                 ttt.adamw(LR))
    p1 = workers.tree_map_clone(params)
    o1 = single.init_optimizer_state(p1)
    grads = tree_leaves(single.grads(p1, o1, *batch)[1])
    losses, trail = [], []
    for _ in range(STEPS):
        p1, o1, loss = single(p1, o1, *batch)
        losses.append(float(loss))
        trail.append([x.clone() for x in tree_leaves(p1)])
    regions = workers.single_device_regions(params, batch, LR)
    t.join(WORLD_TIMEOUT_S + 30)
    assert not t.is_alive(), "the world outlived its timeout"
    if "error" in got:
        raise got["error"]
    return dict(ranks=got["ranks"], jax=jax_out, single=(losses, trail, grads),
                regions=regions)


@pytest.mark.parametrize("name", list(JAX_CASES))
def test_sharded_steps_match_jax(runs, name):
    want_losses, want_params = runs["jax"][name]
    for r in range(4):
        got = runs["ranks"][r][name]
        for a, b in zip(got["losses"], want_losses):
            assert abs(a - b) <= 1e-5 * abs(b), (a, b)
        for a, b in zip(tree_leaves(got["params"][-1]), want_params):
            assert np.abs(a.numpy() - b).max() <= 1e-2 * LR * STEPS


@pytest.mark.parametrize("name", PORT_CASES)
def test_sharded_steps_match_the_single_device_step(runs, name):
    losses, trail, grads = runs["single"]
    for r in range(4):
        got = runs["ranks"][r][name]
        for a, b in zip(tree_leaves(got["grads"]), grads):
            assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())
        for a, b in zip(got["losses"], losses):
            assert abs(a - b) <= 1e-6 * abs(b), (a, b)
        for k, (mine, want) in enumerate(zip(got["params"], trail)):
            for a, b in zip(tree_leaves(mine), want):
                assert float((a - b).abs().max()) <= 1e-2 * LR * (k + 1)


def _n_params():
    return len(tree_leaves(tllama.init_params(tllama.Config.from_name("tiny-llama-debug"),
                                              device="cpu")))


def test_collectives_follow_the_placements(runs):
    n = _n_params()
    got = runs["ranks"][0]
    ddp = got["ddp"]
    assert ddp["overlap"]["n_buckets"] > 1
    for c in ddp["collectives"]:
        assert c["all_reduce"] == expected_all_reduces([None] * ddp["overlap"]["n_buckets"])
        assert c["all_gather"] == c["reduce_scatter"] == 0
    assert ddp["programs"]["torch_wait"] == ddp["overlap"]["n_buckets"]
    # ZeRO-2: every param (all are sharded at min_size=64) gathered once,
    # reduce-scattered once; the loss's mean is the one all-reduce
    for c in got["zero2"]["collectives"]:
        assert (c["all_gather"], c["reduce_scatter"], c["all_reduce"]) == (n, n, 1)
    # ZeRO-3 on dp x fsdp: the backward gathers again (all but the
    # embedding, whose backward reads no weight values); each shard's grad
    # is also averaged over dp
    for c in got["zero3"]["collectives"]:
        assert c["reduce_scatter"] == n and c["all_reduce"] == n + 1
        assert n < c["all_gather"] < 2 * n + 1
    combined = got["combined"]["collectives"][0]
    assert sum(combined.values()) < sum(got["zero3"]["collectives"][0].values())


def test_ddp_regions_are_the_single_device_regions(runs):
    assert runs["ranks"][0]["ddp"]["regions"] == runs["regions"]


def test_optimizer_state_is_placed_like_the_params(runs):
    got = runs["ranks"][0]
    assert got["zero2_state_sharded"] and got["ddp_state_replicated"]


def test_user_tensors_are_not_aliased(runs):
    assert all(runs["ranks"][r]["not_aliased"] for r in range(4))
    assert all(runs["ranks"][r]["locals_not_views"] for r in range(4))


@pytest.mark.parametrize("how", ["accumulate", "no_sync"])
def test_micro_batches_equal_the_big_batch(runs, how):
    acc = runs["ranks"][0]["accum"]
    big_loss, big = acc["big"]
    if how == "accumulate":
        loss, got = acc["acc"]
        assert abs(loss - big_loss) <= 1e-6 * abs(big_loss)
    else:
        got = acc["no_sync"]
    for a, b in zip(tree_leaves(got), tree_leaves(big)):
        assert float((a - b).abs().max()) <= 1e-6


def test_new_shape_rebuilds_and_bucketer_shares(runs):
    assert runs["ranks"][0]["builds"] == {"plain": 2, "bucketed": 1}


def test_tensor_parallel_is_refused(runs):
    refused = runs["ranks"][0]["tp_refused"]
    assert len(refused) == 2 and all("next slice" in m for m in refused)


def test_checkpoint_reshards_bitwise(runs):
    for r in range(4):
        ck = runs["ranks"][r]["ckpt"]
        assert ck["n"] == 7 and ck["same_place"] and ck["template_untouched"]
        assert ck["latest"] == 1
        for a, b in zip(tree_leaves(ck["loaded"]), tree_leaves(ck["saved"])):
            assert torch.equal(a, b)
