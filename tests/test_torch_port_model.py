"""thunder_tpu_torch models against the JAX package, on the CPU.

The same weights (drawn by the JAX package, carried over with
``params_from_numpy``) and the same numpy-made inputs go through both
packages' ``build_rope_cache``, ``forward_with_cache`` and ``generate``.
Tolerances: rope tables rtol 1e-6 (float32, the same formula); logits atol
1e-5 in float32 (the same math, other summation orders, logits of
magnitude ~1); greedy tokens exactly.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thunder_tpu.models import generate as jgen
from thunder_tpu.models import llama as jllama
from thunder_tpu_torch.models import generate as tgen
from thunder_tpu_torch.models import llama as tllama
from thunder_tpu_torch.models.weights import params_from_numpy
from torch_port_threads import one_torch_thread  # noqa: F401

CONFIGS = ["tiny-llama-debug", "tiny-pythia-debug", "tiny-gemma-debug"]
LLAMA31_SCALING = {"factor": 8.0, "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                   "original_max_position_embeddings": 8192}


@pytest.fixture(autouse=True)
def _leave_jax_generate_cache_as_found():
    """JAX ``generate()`` memoizes compiled programs in a bounded module
    cache that other test files count; leave it exactly as found."""
    before = dict(jgen._generate_cache)
    yield
    jgen._generate_cache.clear()
    jgen._generate_cache.update(before)


def _pair(name, **overrides):
    jcfg = jllama.Config.from_name(name, **overrides)
    tcfg = tllama.Config.from_name(name, **overrides)
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _leaves_with_paths(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_paths(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_paths(v, path + (i,))
    else:
        yield path, tree


@pytest.mark.parametrize("name,overrides", [
    ("Llama-3-8B", {}),
    ("Llama-3-8B", {"rope_scaling_llama3": LLAMA31_SCALING}),
    ("tiny-pythia-debug", {}),
    ("long-context-like", {}),
])
def test_rope_cache_matches_jax(name, overrides):
    jcfg = jllama.Config.from_name(name, **overrides)
    tcfg = tllama.Config.from_name(name, **overrides)
    for jt, tt_ in zip(jllama.build_rope_cache(jcfg, 300), tllama.build_rope_cache(tcfg, 300)):
        np.testing.assert_allclose(tt_.numpy(), np.asarray(jt), rtol=1e-6, atol=1e-7)


def test_llama3_rescale_changes_low_frequencies():
    plain = tllama.build_rope_cache(tllama.Config.from_name("Llama-3-8B"), 64)[0]
    cfg = tllama.Config.from_name("Llama-3-8B", rope_scaling_llama3=LLAMA31_SCALING)
    scaled = tllama.build_rope_cache(cfg, 64)[0]
    assert not torch.equal(plain, scaled)
    assert torch.equal(plain[:, :4], scaled[:, :4])       # high frequencies untouched


@pytest.mark.parametrize("name", CONFIGS)
def test_forward_with_cache_prefill_and_decode_match_jax(name):
    jcfg, tcfg, jp, tp = _pair(name)
    rng = np.random.default_rng(1)
    B, T, Tm = 2, 7, 16
    idx = rng.integers(0, jcfg.vocab_size, (B, T)).astype(np.int32)
    jcos, jsin = jllama.build_rope_cache(jcfg, Tm)
    tcos, tsin = tllama.build_rope_cache(tcfg, Tm)
    jfwd = jax.jit(lambda p, i, pos, c: jgen.forward_with_cache(p, i, pos, c, jcos, jsin, jcfg),
                   static_argnums=(2,))
    jl, jc = jfwd(jp, jnp.asarray(idx), 0, jgen.init_cache(jcfg, B, Tm, dtype=jnp.float32))
    tl, tc = tgen.forward_with_cache(tp, torch.as_tensor(idx), 0, tgen.init_cache(
        tcfg, B, Tm, torch.float32, device="cpu"), tcos, tsin, tcfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5, rtol=0)
    for k in ("k", "v"):
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), atol=1e-5, rtol=0)
    # one decode step at per-row positions (rows at different progress)
    pos = np.array([T, T - 3], np.int32)
    tok = rng.integers(0, jcfg.vocab_size, (B, 1)).astype(np.int32)
    jl2, _ = jax.jit(lambda p, i, ps, c: jgen.forward_with_cache(p, i, ps, c, jcos, jsin, jcfg))(
        jp, jnp.asarray(tok), jnp.asarray(pos), jc)
    tl2, _ = tgen.forward_with_cache(tp, torch.as_tensor(tok), torch.as_tensor(pos), tc,
                                     tcos, tsin, tcfg)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", CONFIGS)
def test_generate_greedy_tokens_equal_jax(name):
    jcfg, tcfg, jp, tp = _pair(name)
    prompt = np.random.default_rng(2).integers(0, jcfg.vocab_size, (2, 5)).astype(np.int32)
    want = np.asarray(jgen.generate(jp, prompt, jcfg, 8, cache_dtype=jnp.float32))
    got = tgen.generate(tp, prompt, tcfg, 8, device="cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_temperature_is_seeded():
    _, tcfg, _, tp = _pair("tiny-llama-debug")
    prompt = np.arange(4, dtype=np.int32)[None]

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        return tgen.generate(tp, prompt, tcfg, 6, temperature=0.8, generator=g, device="cpu")

    assert torch.equal(run(3), run(3))
    assert run(3).shape == (1, 10)


def test_params_from_numpy_is_key_for_key():
    jcfg = jllama.Config.from_name("tiny-pythia-debug")
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(3), dtype=jnp.bfloat16)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    jl = list(_leaves_with_paths(jax.tree_util.tree_map(np.asarray, jp)))
    tl = list(_leaves_with_paths(tp))
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (_, a), (_, b) in zip(jl, tl):
        assert b.dtype == torch.bfloat16 and tuple(b.shape) == a.shape
        np.testing.assert_array_equal(b.float().numpy(), a.astype(np.float32))
    cast = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu",
                             dtype=torch.float32)
    assert cast["wte"].dtype == torch.float32


@pytest.mark.parametrize("name", CONFIGS + ["nanogpt-debug", "tiny-falcon-debug"])
def test_init_params_layout_matches_jax(name):
    jcfg = jllama.Config.from_name(name)
    tcfg = tllama.Config.from_name(name)
    jp = jax.tree_util.tree_map(np.asarray, jllama.init_params(jcfg, jax.random.PRNGKey(0)))
    tp = tllama.init_params(tcfg, generator=torch.Generator().manual_seed(0), device="cpu")
    jl, tl = list(_leaves_with_paths(jp)), list(_leaves_with_paths(tp))
    assert [(p, a.shape) for p, a in jl] == [(p, tuple(b.shape)) for p, b in tl]
    assert all(b.dtype == torch.bfloat16 for _, b in tl)
    assert tllama.param_count(tp) == jllama.param_count(jp)


def test_init_params_is_seeded_and_draws_n002():
    cfg = tllama.Config.from_name("tiny-llama-debug")
    a = tllama.init_params(cfg, generator=torch.Generator().manual_seed(5), device="cpu",
                           dtype=torch.float32)
    b = tllama.init_params(cfg, generator=torch.Generator().manual_seed(5), device="cpu",
                           dtype=torch.float32)
    assert torch.equal(a["wte"], b["wte"])
    assert abs(a["wte"].std().item() - 0.02) < 2e-3
    assert torch.equal(a["blocks"][0]["norm_1"], torch.ones(cfg.n_embd))


def test_config_zoo_matches_jax():
    assert [c.name for c in tllama.configs] == [c.name for c in jllama.configs]
    for jc, tc in zip(jllama.configs, tllama.configs):
        assert vars(jc) == vars(tc)


def test_cache_geometry_matches_jax():
    for name in ("tiny-llama-debug", "tiny-mistral-debug", "Llama-3-8B"):
        jc, tc = jllama.Config.from_name(name), tllama.Config.from_name(name)
        assert tgen.cache_shape(tc, 3, 100) == jgen.cache_shape(jc, 3, 100)
        assert tgen.kv_block_shape(tc, 16) == jgen.kv_block_shape(jc, 16)
        assert tgen.cache_len(tc, 20) == jgen.cache_len(jc, 20)


def test_out_of_slice_paths_raise():
    # MoE params are built now, in the reference's stacked layout
    cfg = tllama.Config.from_name("tiny-moe-debug")
    mp = tllama.init_params(cfg, device="cpu")["blocks"][0]["mlp"]
    E, C, I = cfg.n_expert, cfg.n_embd, cfg.intermediate_size
    assert {k: tuple(v.shape) for k, v in mp.items()} == {
        "gate": (E, C), "fc_1": (E, I, C), "fc_2": (E, I, C), "proj": (E, C, I)}
    # the ring cache is ported; per-row positions with a ring cache stay
    # refused, as in the reference
    mcfg = tllama.Config.from_name("tiny-mistral-debug")
    mp = tllama.init_params(mcfg, device="cpu", dtype=torch.float32)
    W = mcfg.sliding_window
    cache = tgen.init_cache(mcfg, 2, W, torch.float32, device="cpu")
    cos, sin = tllama.build_rope_cache(mcfg, 2 * W)
    with pytest.raises(ValueError, match="ring cache"):
        tgen.forward_with_cache(mp, torch.zeros((2, 1), dtype=torch.int32),
                                torch.tensor([3, 5]), cache, cos, sin, mcfg)


@pytest.mark.parametrize("prompt_len,new_tokens", [(40, 12), (20, 30)],
                         ids=["prompt_past_the_window", "crosses_it_decoding"])
def test_generate_past_the_sliding_window_equals_jax(prompt_len, new_tokens):
    """tiny-mistral-debug (window 32) keeps a ring cache one window long:
    greedy tokens past the window equal the JAX package's."""
    jcfg, tcfg, jp, tp = _pair("tiny-mistral-debug")
    assert tgen.cache_len(tcfg, prompt_len + new_tokens) == tcfg.sliding_window == 32
    prompt = np.random.default_rng(5).integers(0, jcfg.vocab_size,
                                               (2, prompt_len)).astype(np.int32)
    want = np.asarray(jgen.generate(jp, prompt, jcfg, new_tokens, cache_dtype=jnp.float32))
    got = tgen.generate(tp, prompt, tcfg, new_tokens, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def test_entry_points_default_to_the_card():
    """With no card here, the default device raises instead of running on
    the CPU; ``device="cpu"`` is the explicit opt-in."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    cfg = tllama.Config.from_name("tiny-llama-debug")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tllama.init_params(cfg)
    tp = tllama.init_params(cfg, device="cpu", dtype=torch.float32)
    with pytest.raises(RuntimeError, match="NVIDIA GPU"):
        tgen.generate(tp, np.zeros((1, 3), np.int32), cfg, 2)
    with pytest.raises(RuntimeError, match="NVIDIA GPU"):
        params_from_numpy({"w": np.zeros(2)})
