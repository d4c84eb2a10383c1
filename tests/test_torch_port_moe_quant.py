"""thunder_tpu_torch's Mixtral path against the JAX package, on the CPU.

The non-mesh half of ``tests/test_moe_quant.py`` at tiny sizes, with the
inputs made once from numpy seeds and the JAX results shared through
module-scoped fixtures:

- the MoE MLP: the training ``moe_mlp`` (eager and traced by ``jit``)
  against ``tt.jit(llama.moe_mlp)`` on tiny-moe-debug, float32 within 1e-5
  of the output's largest magnitude, bf16 with an error against the
  float32 reference at most twice the JAX bf16 function's own; the serving
  ``mlp`` (float32 router) against the reference's ``generate._mlp``,
  plain and ``quantized=True``; planted router ties select the lower
  expert on every path, as ``jax.lax.top_k`` does;
- training: tiny-moe-debug's ``gpt_loss`` value and grads (the traced
  step and its eager twin) against ``tt.value_and_grad`` (loss 1e-5
  relative, each grad 1e-4 of its largest magnitude), the printed
  forward/backward split of the reference's model source against the
  reference's, and three AdamW steps of ``TrainStep`` against the JAX
  ``TrainStep`` (loss 1e-5, params within lr/100 per step);
- the quantizers: bytes and scales of ``quantize_lastdim`` /
  ``quantize_fp8_lastdim`` bitwise against the reference's functions run
  jitted (fp8 as ``uint8``), with all-zero rows and ±0.5 rounding ties; the
  four products against ``jax.jit(quantex.<name>)``: int8 matmul bitwise,
  the linears and fp8 within 1e-6 of the output's largest magnitude (XLA
  contracts the bias add into an FMA and sums fp8 products in float32 in
  its own order), plus the reference's own accuracy bars;
- claiming: ``int8_linear`` in the program of a ``jit`` with the int8
  executor first, a contraction below ``min_k`` left unclaimed;
  ``TrainStep(quant=...)`` claims the forward only and 12 steps track
  float32 (the reference's bars);
- the milestone: the quantized mixtral-like forward against the
  reference's float32 forward by the reference's bar, mean |Δ| / mean
  |ref| < 0.1;
- served greedy tokens on tiny-moe-debug equal the JAX engine's, exactly:
  paged and gather decode, ``prefill_chunk=8``, ``speculative=`` with a MoE
  draft, ``kv_dtype="int8"``, ``quantized=True`` and LoRA adapters on the
  attention targets (a MoE config has no MLP targets);
- the CLI trains tiny-moe-debug with ``--quant int8`` for two steps.

The JAX engines run ``attn="gather"``, whose tokens the reference's own
tests hold equal to its paged lanes.  Tests marked ``cuda`` hold the
quantized products' library calls against their plain versions on the
card and the MoE forward's selection there; they skip without one.
"""
from __future__ import annotations

import json
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

import thunder_tpu as tt
import thunder_tpu_torch as ttt
from thunder_tpu import distributed as dist
from thunder_tpu.executors import quantex as rquant
from thunder_tpu.models import generate as jgen
from thunder_tpu.models import llama as jllama
from thunder_tpu.serving import AdapterRegistry as JRegistry
from thunder_tpu.serving import SpecConfig as JSpecConfig
from thunder_tpu_torch import ltorch, train_cli
from thunder_tpu_torch._tree import tree_leaves
from thunder_tpu_torch.executors import quantex as pquant
from thunder_tpu_torch.models import llama as tllama
from test_torch_port_transforms import _assert_same_programs, _splits
from torch_port_threads import one_torch_thread  # noqa: F401

MOE = "tiny-moe-debug"
B, T = 2, 128
LR = 1e-3
LOWP_ERR_RATIO = 2.0
QUANT_REL = 1e-6
# the card's fp8 products against the exact plain sum, of the output's
# largest magnitude: the card's e4m3 product keeps fewer accumulator bits
# than a float32 sum (1.8e-4 read in float32), then one ulp of the output
# dtype (chip_smoke.fp8_bar)
FP8_ACC_REL = 1e-3


def _rel_close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    bar = rel * max(float(np.abs(want).max()), 1e-30)
    assert np.abs(got - want).max() <= bar, (float(np.abs(got - want).max()), bar)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _t(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


@pytest.fixture(scope="module", autouse=True)
def _leave_jax_program_cache_as_found():
    """The JAX engine memoizes compiled programs in a bounded module cache
    that other test files count; leave it exactly as found."""
    from thunder_tpu.serving import engine as jengine

    before = dict(jengine._program_cache)
    yield
    jengine._program_cache.clear()
    jengine._program_cache.update(before)


#
# the MoE MLP
#


def _mlp_case(seed=11, ties=False):
    """tiny-moe-debug MLP weights and activations of the reference test's
    scale (std 0.1).  ``ties``: router rows 1 and 2 equal, so every token's
    logits for experts 1 and 2 tie exactly, and row 3 the largest, so the
    tie decides the second slot."""
    cfg = jllama.Config.from_name(MOE)
    E, C, I = cfg.n_expert, cfg.n_embd, cfg.intermediate_size
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 8, C)).astype(np.float32)
    mp = {"gate": rng.standard_normal((E, C)).astype(np.float32) * 0.1,
          "fc_1": rng.standard_normal((E, I, C)).astype(np.float32) * 0.1,
          "fc_2": rng.standard_normal((E, I, C)).astype(np.float32) * 0.1,
          "proj": rng.standard_normal((E, C, I)).astype(np.float32) * 0.1}
    if ties:
        x = np.abs(x)
        mp["gate"][0] = -np.abs(mp["gate"][0])
        mp["gate"][1] = mp["gate"][2] = np.abs(mp["gate"][1])
        mp["gate"][3] = 3 * mp["gate"][1]
    return mp, x


@pytest.fixture(scope="module")
def mlp_case():
    mp, x = _mlp_case()
    cfg = jllama.Config.from_name(MOE)
    ref = {dt: _np(tt.jit(lambda p, t: jllama.moe_mlp(p, t, cfg))(
        jax.tree_util.tree_map(lambda a: jnp.asarray(a, dt), mp), jnp.asarray(x, dt)))
        for dt in (jnp.float32, jnp.bfloat16)}
    return mp, x, ref


@pytest.mark.parametrize("traced", [False, True], ids=["eager", "jit"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_mlp_matches_jax(mlp_case, traced, dtype):
    mp, x, ref = mlp_case
    cfg = tllama.Config.from_name(MOE)
    td = getattr(torch, dtype)
    fn = lambda p, t: tllama.moe_mlp(p, t, cfg)            # noqa: E731
    run = ttt.jit(fn) if traced else fn
    got = run({k: v.to(td) for k, v in _t(mp).items()}, torch.from_numpy(x).to(td))
    assert got.dtype == td and tuple(got.shape) == x.shape
    if dtype == "float32":
        _rel_close(_np(got), ref[jnp.float32], 1e-5)
        if traced:
            # the router's top-k is torch's, in the program or in a fusion
            # region's program
            final = ttt.last_traces(run)[-1]
            programs = final.python() + "".join(
                b._call_ctx[b.sym.name].trace.python() for b in final.bound_symbols
                if b.sym.is_fusion)
            assert "torch_topk" in programs
        return
    err = np.abs(_np(got) - ref[jnp.float32]).max()
    ref_err = np.abs(ref[jnp.bfloat16] - ref[jnp.float32]).max()
    assert err <= LOWP_ERR_RATIO * ref_err, (err, ref_err)


def test_serving_mlp_matches_jax_mlp(mlp_case):
    """The serving MLP routes in float32: equal to the training MLP in
    float32, another router in bf16; held against the reference's
    ``_mlp``, plain and with int8 weight matmuls."""
    mp, x, ref = mlp_case
    jcfg, cfg = jllama.Config.from_name(MOE), tllama.Config.from_name(MOE)
    jmp = jax.tree_util.tree_map(jnp.asarray, mp)
    tmp, tx = _t(mp), torch.from_numpy(x)
    got = tllama.mlp(tmp, tx, cfg)
    _rel_close(_np(got), _np(jgen._mlp(jmp, jnp.asarray(x), jcfg)), 1e-5)
    _rel_close(_np(got), ref[jnp.float32], 1e-5)
    want_q = _np(jax.jit(partial(jgen._mlp, cfg=jcfg, quantized=True))(jmp, jnp.asarray(x)))
    _rel_close(_np(tllama.mlp(tmp, tx, cfg, quantized=True)), want_q, 1e-5)
    b16 = {k: v.bfloat16() for k, v in tmp.items()}
    serving = tllama.mlp(b16, tx.bfloat16(), cfg)
    training = tllama.moe_mlp(b16, tx.bfloat16(), cfg)
    assert not torch.equal(serving, training)
    want = jgen._mlp(jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), jmp),
                     jnp.asarray(x, jnp.bfloat16), jcfg)
    err = np.abs(_np(serving) - ref[jnp.float32]).max()
    assert err <= LOWP_ERR_RATIO * np.abs(_np(want) - ref[jnp.float32]).max()


def test_planted_ties_select_the_lower_expert():
    """Experts 1 and 2 tie on every token's router logit; the reference's
    top_k takes expert 1.  The port's selection, eager and traced, training
    and serving MLPs, equals it."""
    mp, x = _mlp_case(seed=12, ties=True)
    jcfg, cfg = jllama.Config.from_name(MOE), tllama.Config.from_name(MOE)
    router = x @ mp["gate"].T
    assert (router[..., 1] == router[..., 2]).all()
    _, jidx = jax.lax.top_k(jnp.asarray(router), 2)
    _, tidx = ltorch.topk(torch.from_numpy(router), 2)
    assert np.array_equal(np.asarray(jidx), tidx.numpy()) and (np.asarray(jidx) == 1).any()
    jmp, tmp, tx = jax.tree_util.tree_map(jnp.asarray, mp), _t(mp), torch.from_numpy(x)
    want = _np(tt.jit(lambda p, t: jllama.moe_mlp(p, t, jcfg))(jmp, jnp.asarray(x)))
    _rel_close(_np(tllama.moe_mlp(tmp, tx, cfg)), want, 1e-5)
    _rel_close(_np(ttt.jit(lambda p, t: tllama.moe_mlp(p, t, cfg))(tmp, tx)), want, 1e-5)
    _rel_close(_np(tllama.mlp(tmp, tx, cfg)), _np(jgen._mlp(jmp, jnp.asarray(x), jcfg)), 1e-5)
    # the other pick of the tie is a different function
    swapped = {**tmp, "gate": tmp["gate"][[0, 2, 1, 3]],
               **{k: tmp[k][[0, 2, 1, 3]] for k in ("fc_1", "fc_2", "proj")}}
    assert not np.allclose(_np(tllama.moe_mlp(swapped, tx, cfg)), want, atol=1e-4)


#
# training
#


@pytest.fixture(scope="module")
def moe_train():
    """tiny-moe-debug numpy params and batch; the reference's value and
    grads, and three JAX TrainStep steps."""
    jcfg = jllama.Config.from_name(MOE)
    rng = np.random.default_rng(0)
    shapes = jllama.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    nparams = jax.tree_util.tree_map(
        lambda a: (0.02 * rng.standard_normal(a.shape) + (a.ndim == 1)).astype(np.float32),
        shapes)
    idx = rng.integers(0, jcfg.vocab_size, (B, T)).astype(np.int32)
    tgt = rng.integers(0, jcfg.vocab_size, (B, T)).astype(np.int32)
    tgt[0, :5] = -100
    cos, sin = jllama.build_rope_cache(jcfg, T)
    jparams = jax.tree_util.tree_map(jnp.asarray, nparams)
    loss_fn = lambda p, i, t, c, s: jllama.gpt_loss(p, i, t, c, s, jcfg)      # noqa: E731
    jl, jg = tt.value_and_grad(loss_fn)(jparams, jnp.asarray(idx), jnp.asarray(tgt), cos, sin)
    mesh = dist.make_mesh({"dp": 1}, devices=jax.devices()[:1])
    ts = dist.make_train_step(loss_fn, optax.adamw(LR), mesh)
    p = dist.ddp(jparams, mesh)
    o = ts.init_optimizer_state(p)
    losses = []
    for _ in range(3):
        p, o, loss = ts(p, o, jnp.asarray(idx), jnp.asarray(tgt), cos, sin)
        losses.append(float(loss))
    return dict(nparams=nparams, idx=idx, tgt=tgt, loss=float(jl),
                grads=[np.asarray(g) for g in jax.tree_util.tree_leaves(jg)],
                losses=losses, params=[np.asarray(x) for x in jax.tree_util.tree_leaves(p)])


def _port_batch(cfg, idx, tgt):
    cos, sin = tllama.build_rope_cache(cfg, T)
    return torch.as_tensor(idx), torch.as_tensor(tgt).long(), cos, sin


def _loss(cfg):
    return lambda p, i, t, c, s: tllama.gpt_loss(p, i, t, c, s, cfg)


@pytest.mark.parametrize("make", [ttt.make_train_step, ttt.make_eager_train_step],
                         ids=["traced", "eager"])
def test_moe_gpt_loss_and_grads_match_jax(moe_train, make):
    cfg = tllama.Config.from_name(MOE)
    params = ttt.params_from_numpy(moe_train["nparams"], device="cpu")
    step = make(_loss(cfg), ttt.adamw(LR), remat=False)
    loss, grads = step.grads(params, None, *_port_batch(cfg, moe_train["idx"], moe_train["tgt"]))
    _rel_close(loss.item(), moe_train["loss"], 1e-5)
    got = tree_leaves(grads)
    assert len(got) == len(moe_train["grads"])
    for a, b in zip(got, moe_train["grads"]):
        assert tuple(a.shape) == b.shape and bool(a.abs().max() > 0)
        _rel_close(a.numpy(), b, 1e-4)


def test_moe_split_prints_the_reference_split():
    """The reference's ``gpt_loss`` source over the port's language: the
    forward/backward split prints the reference's programs, the per-expert
    ``fc_1[e]`` grads padded into the stacked (E, I, C) shape included."""
    from thunder_tpu.core import rematerialization as rremat
    from thunder_tpu_torch.core import rematerialization as premat

    (rfw, rbw), (pfw, pbw) = _splits(MOE)
    _assert_same_programs((pfw, pbw), (rfw, rbw))
    assert premat.saved_bytes(pfw) == rremat.saved_bytes(rfw)
    names = {b.sym.name for b in pfw.bound_symbols + pbw.bound_symbols}
    assert {"topk", "eq", "pad"} <= names, sorted(names)


def test_moe_train_steps_match_jax(moe_train):
    cfg = tllama.Config.from_name(MOE)
    step = ttt.make_train_step(_loss(cfg), ttt.adamw(LR), {"dp": 1})
    params = ttt.params_from_numpy(moe_train["nparams"], device="cpu")
    opt_state = step.init_optimizer_state(params)
    batch = _port_batch(cfg, moe_train["idx"], moe_train["tgt"])
    losses = []
    for _ in range(3):
        params, opt_state, loss = step(params, opt_state, *batch)
        losses.append(loss.item())
    for got, want in zip(losses, moe_train["losses"]):
        _rel_close(got, want, 1e-5)
    for a, b in zip(tree_leaves(params), moe_train["params"]):
        assert np.abs(a.numpy() - b).max() <= 1e-2 * LR * 3


#
# the quantizers
#


def _quant_rows(kind, seed=3):
    """(16, 128) float32 rows: random scales, an all-zero row, and for int8
    a row at exactly ±qmax with ±0.5 rounding ties (its scale is exactly
    1)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((16, 128)).astype(np.float32) * rng.uniform(
        1e-3, 30.0, (16, 1)).astype(np.float32)
    x[3] = 0.0
    if kind == "int8":
        x[5] = np.resize(np.array([127.0, -127.0, 0.5, -0.5, 1.5, -2.5], np.float32), 128)
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_quantize_lastdim_bitwise_against_jitted_reference(kind, dtype):
    x = _quant_rows(kind)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    rfn = rquant._quantize_lastdim if kind == "int8" else rquant._quantize_fp8_lastdim
    pfn = pquant.quantize_lastdim if kind == "int8" else pquant.quantize_fp8_lastdim
    jq, js = jax.jit(rfn)(jx)
    tq, ts = pfn(tx)
    assert np.array_equal(np.asarray(jq).view(np.uint8), tq.contiguous().view(torch.uint8).numpy())
    assert np.array_equal(np.asarray(js), ts.numpy())
    assert float(ts[3]) == 1.0


def _prod_case(seed=4):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((2, 8, 256)).astype(np.float32)
    w = (rng.standard_normal((128, 256)) * 0.05).astype(np.float32)
    bias = (rng.standard_normal(128) * 0.1).astype(np.float32)
    b = (rng.standard_normal((2, 256, 64)) * 0.05).astype(np.float32)
    return a, w, bias, b


@pytest.mark.parametrize("name", ["int8_linear", "int8_matmul", "fp8_linear", "fp8_matmul"])
def test_quantized_products_match_the_reference(name):
    a, w, bias, b = _prod_case()
    rfn, pfn = getattr(rquant, name), getattr(pquant, name)
    if name.endswith("linear"):
        args = [(a, w, bias), (a, w)]
    else:
        args = [(a, b), (a, b[0])]
    for arg in args:
        want = np.asarray(jax.jit(rfn)(*arg))
        got = pfn(*(torch.from_numpy(v) for v in arg)).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape
        if name == "int8_matmul":
            assert np.array_equal(got, want)
        else:
            _rel_close(got, want, QUANT_REL)
        exact = arg[0] @ (arg[1].T if name.endswith("linear") else arg[1])
        if len(arg) == 3:
            exact = exact + arg[2]
        rel = np.abs(got - exact) / (np.abs(exact) + 1e-3)
        assert np.median(rel) < (2e-2 if name.startswith("int8") else 5e-2), np.median(rel)
    bf = pfn(torch.from_numpy(a).bfloat16(), torch.from_numpy(args[1][1]).bfloat16())
    assert bf.dtype == torch.bfloat16


@pytest.mark.parametrize("quant", ["int8", "fp8"])
def test_executor_claims_linear_and_leaves_small_k(quant):
    ex = pquant.ex if quant == "int8" else pquant.fp8_ex
    a, w, _, _ = _prod_case()
    a2 = torch.from_numpy(a[0])
    jfn = ttt.jit(lambda x, ww: F.linear(x, ww), executors=[ex, "torch"])
    got = jfn(a2, torch.from_numpy(w[:64]))
    assert f"{quant}_linear" in ttt.last_traces(jfn)[-1].python()
    _rel_close(got.numpy(), getattr(pquant, f"{quant}_linear")(a2, torch.from_numpy(w[:64])), 0)
    small = ttt.jit(lambda x, ww: F.linear(x, ww), executors=[ex, "torch"])
    x16, w16 = torch.from_numpy(a[0, :, :16].copy()), torch.from_numpy(w[:8, :16].copy())
    out = small(x16, w16)
    assert f"{quant}_linear" not in ttt.last_traces(small)[-1].python()
    torch.testing.assert_close(out, x16 @ w16.T, rtol=1e-5, atol=1e-6)
    assert pquant.min_k == rquant.min_k == 64
    assert ttt.extend.get_executor(f"quant_{quant}") is ex
    assert ex not in ttt.extend.get_default_executors()


#
# quantized training
#


def _train_tiny(quant, steps=12):
    cfg = tllama.Config.from_name("tiny-llama-debug")
    params = ttt.init_params(cfg, generator=torch.Generator().manual_seed(0),
                             dtype=torch.float32, device="cpu")
    gen = torch.Generator().manual_seed(1)
    idx = torch.randint(0, cfg.vocab_size, (4, 32), generator=gen)
    tgt = torch.randint(0, cfg.vocab_size, (4, 32), generator=gen)
    cos, sin = tllama.build_rope_cache(cfg, 32)
    step = ttt.make_train_step(_loss(cfg), ttt.adamw(3e-3), quant=quant)
    opt = step.init_optimizer_state(params)
    losses = []
    for _ in range(steps):
        params, opt, loss = step(params, opt, idx, tgt, cos, sin)
        losses.append(loss.item())
    return losses, step


@pytest.fixture(scope="module")
def float_run():
    return _train_tiny(None)[0]


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_quantized_training_claims_forward_only_and_tracks_float32(float_run, mode):
    l_q, step = _train_tiny(mode)
    fw, bw = step.fw_trace.python(), step.bw_trace.python()
    assert f"{mode}_linear" in fw
    assert f"{mode}_linear" not in bw and f"{mode}_matmul" not in bw
    assert float_run[-1] < float_run[0] - 0.2
    assert l_q[-1] < l_q[0] - 0.2
    assert abs(l_q[-1] - float_run[-1]) < 0.15, (l_q[-1], float_run[-1])
    with pytest.raises(NotImplementedError, match="quant="):
        ttt.make_eager_train_step(len, ttt.adamw(LR), quant=mode)


def test_quantized_mixtral_like_forward_holds_the_reference_bar():
    """Milestone E: the mixtral-like forward under the int8 executor against
    the reference's float32 forward, on the reference's weights."""
    jcfg = jllama.Config.from_name("mixtral-like")
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    idx = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 32)).astype(np.int32)
    cos, sin = jllama.build_rope_cache(jcfg, 32)
    ref = np.asarray(tt.jit(lambda p, i, c, s: jllama.gpt_forward(p, i, c, s, jcfg))(
        jparams, idx, cos, sin))
    cfg = tllama.Config.from_name("mixtral-like")
    params = ttt.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    tcos, tsin = tllama.build_rope_cache(cfg, 32)
    fwd = lambda p, i, c, s: tllama.gpt_forward(p, i, c, s, cfg)        # noqa: E731
    plain = fwd(params, torch.as_tensor(idx), tcos, tsin)
    _rel_close(plain.numpy(), ref, 1e-4)
    jfn = ttt.jit(fwd, executors=[pquant.ex, *ttt.extend.get_default_executors()])
    got = jfn(params, torch.as_tensor(idx), tcos, tsin).numpy()
    assert "int8_linear" in ttt.last_traces(jfn)[-1].python()
    assert got.shape == (2, 32, jcfg.padded_vocab_size) and np.isfinite(got).all()
    rel = np.abs(got - ref).mean() / np.abs(ref).mean()
    assert 0.0 < rel < 0.1, rel


#
# served tokens against the JAX engine
#

ENGINE = dict(block_size=4, num_blocks=32, max_batch=4, batch_buckets=(4,), block_buckets=(6,),
              prefill_buckets=(16,))
CHUNKED = dict(block_size=4, num_blocks=32, max_batch=4, batch_buckets=(4,),
               block_buckets=(6, 12), prefill_buckets=(8, 16), prefill_chunk=8)
SPEC = dict(block_size=4, num_blocks=64, max_batch=4, batch_buckets=(4,), block_buckets=(8,),
            prefill_buckets=(16,))
LENS, CHUNK_LENS, SPEC_LENS = (3, 5, 9, 14), (13, 21, 9), (7, 5, 11)
LANES = {"plain": ({}, ENGINE, LENS, 5), "int8_kv": ({"kv_dtype": "int8"}, ENGINE, LENS, 5),
         "quantized": ({"quantized": True}, ENGINE, LENS, 5),
         "chunked": ({}, CHUNKED, CHUNK_LENS, 4), "speculative": ({}, SPEC, SPEC_LENS, 9),
         "lora": ({}, ENGINE, LENS, 5)}
LORA_IDS = ["alice", "bob", None, "alice"]


def _prompts(lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 64, (n,)).astype(np.int32) for n in lens]


def _drive(eng, prompts, n, ids=None):
    ids = ids or [None] * len(prompts)
    handles = [eng.submit(p, max_new_tokens=n, adapter_id=a) for p, a in zip(prompts, ids)]
    eng.drain()
    return [tuple(int(t) for t in h.result(drive=False).tokens) for h in handles]


def _lora_factors(cfg, seed, rank=2):
    """An adapter on every attention target, drawn with numpy."""
    from thunder_tpu_torch.serving.lora import _target_features

    rng = np.random.default_rng(seed)
    return {t: ((rng.standard_normal((cfg.n_layer, rank, _target_features(cfg, t)[0])) * 0.5)
                .astype(np.float32),
                (rng.standard_normal((cfg.n_layer, _target_features(cfg, t)[1], rank)) * 0.5)
                .astype(np.float32))
            for t in ("wq", "wk", "wv", "wo")}


def _lane_kwargs(lane, draft, reg):
    kw, engine, lens, n = LANES[lane]
    if lane == "speculative":
        kw = {"speculative": draft}
    if lane == "lora":
        kw = {"lora": reg}
    ids = LORA_IDS if lane == "lora" else None
    return {**kw, **engine}, _prompts(lens, seed=int(lane == "speculative")), n, ids


def _moe_models(seed, **overrides):
    jcfg = jllama.Config.from_name(MOE, **overrides)
    tcfg = tllama.Config.from_name(MOE, **overrides)
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(seed), dtype=jnp.float32)
    return jcfg, tcfg, jp, ttt.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                                 device="cpu")


@pytest.fixture(scope="module")
def served():
    """The JAX engine's greedy tokens on each lane, with the models."""
    target, draft = _moe_models(0), _moe_models(9, n_layer=1)
    jcfg, tcfg, jp, _ = target
    jdcfg, _, jdp, _ = draft
    jreg = JRegistry(jcfg, rank=2, max_adapters=4)
    treg = ttt.AdapterRegistry(tcfg, rank=2, max_adapters=4, device="cpu")
    for i, name in enumerate(("alice", "bob")):
        jreg.register(name, _lora_factors(tcfg, 10 + i))
        treg.register(name, _lora_factors(tcfg, 10 + i))
    out = {}
    for lane in LANES:
        kw, prompts, n, ids = _lane_kwargs(lane, JSpecConfig(jdp, jdcfg, K=2), jreg)
        eng = tt.serve(None, jp, jcfg, attn="gather", cache_dtype=jnp.float32, **kw)
        out[lane] = _drive(eng, prompts, n, ids)
    return target, draft, treg, out


@pytest.mark.parametrize("attn", ["paged", "gather"])
@pytest.mark.parametrize("lane", list(LANES))
def test_moe_greedy_tokens_equal_jax_engine(served, lane, attn):
    (_, tcfg, _, tp), (_, dcfg, _, dp), treg, want = served
    kw, prompts, n, ids = _lane_kwargs(lane, ttt.SpecConfig(dp, dcfg, K=2), treg)
    eng = ttt.serve(None, tp, tcfg, device="cpu", attn=attn, **kw)
    assert _drive(eng, prompts, n, ids) == want[lane]
    st = eng.stats()
    assert st["attn"]["mode"] == attn and st["quantized"] is (lane == "quantized")
    if lane == "chunked":
        assert st["chunk_runs"] > 0 and st["attn"]["kinds"]["prefill_chunk"]["mode"] == attn
    if lane == "speculative":
        assert st["speculative"]["rounds"] > 0


def test_cli_trains_moe_with_int8(capsys):
    train_cli.main(["--config", MOE, "--quant", "int8", "--steps", "2", "--batch", "2",
                    "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["config"] == MOE and out["quant"] == "int8" and np.isfinite(out["final_loss"])


#
# on the card
#


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the library calls and the kernels run on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", [(8, 256, 128), (17, 512, 96), (512, 64, 256), (3, 4096, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_quantized_products_match_plain(card, M, K, N, dtype):
    """``_int_mm`` bitwise equal to the exact plain product, ``_scaled_mm``
    within 1e-6 of the output's largest magnitude; one call each, rows
    padded where the library needs them."""
    gen = torch.Generator(card).manual_seed(M + K + N)
    a = torch.randn((M, K), generator=gen, device=card).to(dtype)
    w = (torch.randn((N, K), generator=gen, device=card) * 0.05).to(dtype)
    for name in ("int8_linear", "fp8_linear"):
        pquant.reset_calls()
        got = getattr(pquant, name)(a, w)
        want = getattr(pquant, f"{name}_plain")(a, w)
        torch.cuda.synchronize()
        assert sum(pquant.CALLS.values()) == 1 and got.shape == (M, N)
        if name.startswith("int8"):
            assert torch.equal(got, want)
        else:
            _rel_close(_np(got), _np(want), max(FP8_ACC_REL, torch.finfo(dtype).eps))
        assert torch.equal(got, getattr(pquant, name)(a, w))
    bm = (torch.randn((2, K, N), generator=gen, device=card) * 0.05).to(dtype)
    am = a.expand(2, M, K)
    assert torch.equal(pquant.int8_matmul(am, bm), pquant.int8_matmul_plain(am, bm))


@pytest.mark.cuda
def test_cuda_topk_keeps_index_order_of_ties(card):
    x = torch.zeros((4096, 8), device=card)
    x[:, 3] = 1.0
    _, idx = ltorch.topk(x, 2)
    assert (idx[:, 0] == 3).all() and (idx[:, 1] == 0).all()


@pytest.mark.cuda
def test_cuda_moe_serves_quantized_through_the_library_and_the_kernels(card):
    from thunder_tpu_torch.executors import cudaex

    cfg = tllama.Config.from_name(MOE)
    params = ttt.init_params(cfg, generator=torch.Generator(card).manual_seed(0),
                             dtype=torch.float32, device=card)
    eng = ttt.serve(None, params, cfg, device=card, quantized=True, **ENGINE)
    pquant.reset_calls()
    cudaex.reset_launches()
    toks = _drive(eng, _prompts(LENS), 5)
    torch.cuda.synchronize()
    assert eng.attn == "paged" and all(0 <= t < cfg.padded_vocab_size for r in toks for t in r)
    assert pquant.CALLS["int_mm"] > 0 and cudaex.LAUNCHES["paged_attn_decode"] == (
        eng.decode_steps * cfg.n_layer)
