"""thunder_tpu_torch multi-tenant LoRA serving against the JAX package, on the CPU.

With the micro config and buckets of ``tests/test_serving_lora.py`` (one
layer, two heads, rank 2), factors drawn once with numpy and registered in
both packages' registries, and JAX weights carried over with
``params_from_numpy``:

- the registry's policy cases (bounded slots, evict zeroes, unknown ids,
  gauges) and ``valid_targets``;
- ``lora_delta_fused_plain`` against ``pallasex.lora_delta_fused`` run
  interpreted: float32 within 1e-6 absolute (the same two products summed in
  another order), bf16 within one ulp of the output (the same three
  roundings), base-slot rows exactly 0;
- ``forward_with_cache(lora=...)`` and ``forward_paged(lora=...)`` (whose
  qkv and wo deltas take the kernel's wrapper) against the JAX functions,
  the latter with ``lora_fused=True``: float32 logits within 1e-5;
- served greedy float32 tokens equal to the JAX LoRA engine's, exactly:
  paged and gather decode, chunked prefill, speculative serving, int8 KV and
  MLP targets; within the port, a request's tokens are the same alone and
  batched, every adapter changes them, and a base request in a LoRA engine
  equals a registry-free engine's;
- tenant metrics, ``submit`` validation, and prefix sharing keyed by factor
  identity, where the port keeps the reference's stated contract and the
  reference's own engine does not (``thunder_tpu/serving/engine.py:1311-1340``);
- the training forward's single-adapter hook against the JAX ``gpt_forward``.

Tests marked ``cuda`` run the kernel and a LoRA engine on the card.
"""
from __future__ import annotations

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import thunder_tpu as tt
import thunder_tpu_torch as ttt
from thunder_tpu.executors import pallasex
from thunder_tpu.models import generate as jgen
from thunder_tpu.models import llama as jllama
from thunder_tpu.serving import AdapterRegistry as JRegistry
from thunder_tpu.serving import SpecConfig as JSpecConfig
from thunder_tpu.serving import lora as jlora
from thunder_tpu.serving import paged_attention as jpa
from thunder_tpu_torch.executors import cudaex
from thunder_tpu_torch.models import generate as tgen
from thunder_tpu_torch.models import llama as tllama
from thunder_tpu_torch.models import speculative as tspec
from thunder_tpu_torch.observability import registry as metrics
from thunder_tpu_torch.serving import paged_attention as tpa
from thunder_tpu_torch.serving.lora import _target_features, gather_adapter_slots

MICRO = dict(n_layer=1, n_head=2, n_embd=16, intermediate_size=32, vocab_size=32, block_size=64)
BUCKETS = dict(batch_buckets=(4,), block_buckets=(4,), prefill_buckets=(16,))
ENGINE = dict(block_size=4, num_blocks=32, max_batch=4, **BUCKETS)
CHUNKED = dict(block_size=4, num_blocks=32, max_batch=4, batch_buckets=(4,),
               block_buckets=(6, 12), prefill_buckets=(8, 16), prefill_chunk=8)
SPEC = dict(block_size=4, num_blocks=64, max_batch=4, batch_buckets=(4,), block_buckets=(8,),
            prefill_buckets=(16,))
RANK = 2
ADAPTERS = ("alice", "bob", "carol")
FULL = ("wq", "wk", "wv", "wo", "fc_1", "fc_2", "proj")
IDS = ["alice", "bob", "carol", None]
LENS = (4, 6, 9, 11)


def _pair(seed=0, **overrides):
    jcfg = jllama.Config.from_name("tiny-llama-debug", **{**MICRO, **overrides})
    tcfg = ttt.Config.from_name("tiny-llama-debug", **{**MICRO, **overrides})
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(seed), dtype=jnp.float32)
    tp = ttt.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _factors(cfg, seed, targets=("wq", "wk", "wv", "wo"), std=0.5, rank=RANK):
    """One adapter's factors, drawn with numpy: {target: (A, B)} float32."""
    rng = np.random.default_rng(seed)
    out = {}
    for t in targets:
        fin, fout = _target_features(cfg, t)
        out[t] = ((rng.standard_normal((cfg.n_layer, rank, fin)) * std).astype(np.float32),
                  (rng.standard_normal((cfg.n_layer, fout, rank)) * std).astype(np.float32))
    return out


def _registries(jcfg, tcfg, targets=("wq", "wk", "wv", "wo"), names=ADAPTERS, rank=RANK,
                std=0.5):
    jreg = JRegistry(jcfg, rank=rank, max_adapters=4, targets=targets)
    treg = ttt.AdapterRegistry(tcfg, rank=rank, max_adapters=4, targets=targets, device="cpu")
    for i, name in enumerate(names):
        f = _factors(tcfg, 10 + i, targets, std=std, rank=rank)
        jreg.register(name, f)
        treg.register(name, f)
    return jreg, treg


def _prompts(lens=LENS, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 32, (n,)).astype(np.int32) for n in lens]


def _drive(eng, prompts, ids, n=5):
    handles = [eng.submit(p, max_new_tokens=n, adapter_id=a) for p, a in zip(prompts, ids)]
    eng.drain()
    return [tuple(int(t) for t in h.result(drive=False).tokens) for h in handles]


def _jax(jcfg, jp, **kw):
    return tt.serve(None, jp, jcfg, cache_dtype=jnp.float32, **kw)


def _port(tcfg, tp, **kw):
    return ttt.serve(None, tp, tcfg, device="cpu", **kw)


@pytest.fixture(scope="module", autouse=True)
def _leave_jax_program_cache_as_found():
    """The JAX engine memoizes compiled programs in a bounded module cache
    that other test files count; leave it exactly as found."""
    from thunder_tpu.serving import engine as jengine

    before = dict(jengine._program_cache)
    yield
    jengine._program_cache.clear()
    jengine._program_cache.update(before)


@pytest.fixture(scope="module")
def micro():
    return _pair()


@pytest.fixture(scope="module")
def regs(micro):
    jcfg, tcfg, _, _ = micro
    return _registries(jcfg, tcfg)


@pytest.fixture(scope="module")
def jax_tokens(micro, regs):
    """The JAX engine's mixed-tenant tokens, paged (Pallas interpreted) and
    gather, built once per module."""
    jcfg, _, jp, _ = micro
    return {attn: _drive(_jax(jcfg, jp, attn=attn, lora=regs[0], **ENGINE), _prompts(), IDS)
            for attn in ("paged", "gather")}


#
# the registry (host-side policy, as tests/test_serving_lora.py:72-130)
#


class TestAdapterRegistry:
    def test_geometry_and_base_slot(self, micro, regs):
        jreg, treg = regs
        assert treg.geometry[:4] == jreg.geometry[:4] == (RANK, 5, ("wq", "wk", "wv", "wo"), 1.0)
        assert treg.slots_used == 3
        for t in treg.targets:
            assert float(treg.arenas[t]["a"][0].abs().sum()) == 0.0
            for name in ADAPTERS:
                s = treg.slot(name)
                assert s == jreg.slot(name) != 0
                np.testing.assert_array_equal(treg.arenas[t]["a"][s].numpy(),
                                              np.asarray(jreg.arenas[t]["a"][s]))
                np.testing.assert_array_equal(treg.arenas[t]["b"][s].numpy(),
                                              np.asarray(jreg.arenas[t]["b"][s]))

    def test_register_validates_shapes_and_targets(self, micro):
        _, tcfg, _, _ = micro
        reg = ttt.AdapterRegistry(tcfg, rank=RANK, max_adapters=2, device="cpu")
        good = _factors(tcfg, 0)
        with pytest.raises(ValueError, match="missing targets"):
            reg.register("x", {"wq": good["wq"]})
        bad = dict(good)
        bad["wq"] = (good["wq"][0][:, :1], good["wq"][1])
        with pytest.raises(ValueError, match="shapes"):
            reg.register("x", bad)
        with pytest.raises(ValueError, match="unknown LoRA targets"):
            ttt.AdapterRegistry(tcfg, rank=RANK, targets=("wq", "wq2"), device="cpu")
        with pytest.raises(ValueError, match="unknown LoRA targets"):
            ttt.AdapterRegistry(tcfg, rank=RANK, targets=("fc",), device="cpu")
        with pytest.raises(NotImplementedError, match="meshes"):
            reg.place(object())

    def test_bounded_register_evict_cycle(self, micro):
        _, tcfg, _, _ = micro
        reg = ttt.AdapterRegistry(tcfg, rank=RANK, max_adapters=2, device="cpu")
        f = _factors(tcfg, 1)
        reg.register("a", f)
        slot_b = reg.register("b", f)
        assert reg.version(slot_b) == 1
        with pytest.raises(ttt.RegistryFullError):
            reg.register("c", f)
        reg.evict("b")
        for t in reg.targets:
            assert float(reg.arenas[t]["a"][slot_b].abs().sum()) == 0.0
            assert float(reg.arenas[t]["b"][slot_b].abs().sum()) == 0.0
        assert reg.register("c", f) == slot_b
        with pytest.raises(KeyError, match="unknown adapter_id"):
            reg.slot("b")
        assert reg.register("c", f) == slot_b
        assert reg.version(slot_b) == 4 and reg.version(0) == 0

    def test_occupancy_gauges(self, micro):
        _, tcfg, _, _ = micro
        reg = ttt.AdapterRegistry(tcfg, rank=RANK, max_adapters=3, device="cpu")
        reg.register("t1", _factors(tcfg, 2))
        snap = metrics().snapshot("serving.lora.")
        assert snap["serving.lora.slots"] == 3
        assert snap["serving.lora.adapters"] == 1
        assert reg.state_snapshot()["adapters"] == ["t1"]

    def test_registry_defaults_to_the_card(self, micro):
        if torch.cuda.is_available():
            pytest.skip("a card is present: the default device is valid here")
        _, tcfg, _, _ = micro
        with pytest.raises(RuntimeError, match="NVIDIA GPU"):
            ttt.AdapterRegistry(tcfg, rank=RANK)

    def test_make_lora_factors_shapes_and_seed(self, micro):
        _, tcfg, _, _ = micro
        f1 = ttt.make_lora_factors(tcfg, RANK, torch.Generator().manual_seed(3), FULL)
        f2 = ttt.make_lora_factors(tcfg, RANK, torch.Generator().manual_seed(3), FULL)
        for t in FULL:
            fin, fout = _target_features(tcfg, t)
            assert tuple(f1[t][0].shape) == (1, RANK, fin)
            assert tuple(f1[t][1].shape) == (1, fout, RANK)
            assert torch.equal(f1[t][0], f2[t][0]) and float(f1[t][1].std()) > 0.02


@pytest.mark.parametrize("name,overrides", [
    ("tiny-llama-debug", {}), ("tiny-llama-debug", {"mlp_class": "GptNeoxMLP"}),
    ("tiny-gemma-debug", {}), ("tiny-moe-debug", {}), ("tiny-pythia-debug", {})])
def test_valid_targets_and_features_match_jax(name, overrides):
    jcfg = jllama.Config.from_name(name, **overrides)
    tcfg = ttt.Config.from_name(name, **overrides)
    assert ttt.valid_targets(tcfg) == jlora.valid_targets(jcfg)
    for t in ttt.valid_targets(tcfg):
        assert _target_features(tcfg, t) == jlora._target_features(jcfg, t)


#
# the kernel's plain version against the Pallas kernel run interpreted
#


def _delta_case(B, T, fin, fout, r, seed):
    """Unit activations and factors of ``make_lora_factors``' default std
    (0.05), one request on the base slot."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, fin)).astype(np.float32)
    a = (rng.standard_normal((B, r, fin)) * 0.05).astype(np.float32)
    b = (rng.standard_normal((B, fout, r)) * 0.05).astype(np.float32)
    a[0] = 0.0                                     # row 0 rides the base slot
    b[0] = 0.0
    return x, a, b


@pytest.mark.parametrize("x_dtype,f_dtype", [("float32", "float32"), ("bfloat16", "float32"),
                                             ("bfloat16", "bfloat16"), ("float32", "bfloat16")])
@pytest.mark.parametrize("B,T,fin,fout,r,scaling", [(3, 1, 64, 32, 8, 2.0),
                                                    (2, 5, 48, 80, 4, 0.3),
                                                    (1, 12, 32, 64, 16, 1.0),
                                                    (2, 3, 48, 40, 128, 0.5)],
                         ids=["decode", "verify", "chunk", "rank128"])
def test_lora_delta_plain_matches_pallas(B, T, fin, fout, r, scaling, x_dtype, f_dtype):
    """float32 within 1e-6 absolute; bf16 within one ulp of the output
    (both round d, the product and the scaled product to bf16, but sum in
    another order); the base-slot row exactly 0."""
    x, a, b = _delta_case(B, T, fin, fout, r, seed=fin + T)
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    want = pallasex.lora_delta_fused(jnp.asarray(x, jd[x_dtype]), jnp.asarray(a, jd[f_dtype]),
                                     jnp.asarray(b, jd[f_dtype]), scaling)
    got = cudaex.lora_delta_fused(torch.as_tensor(x).to(td[x_dtype]),
                                  torch.as_tensor(a).to(td[f_dtype]),
                                  torch.as_tensor(b).to(td[f_dtype]), scaling)
    assert got.dtype == td[x_dtype] and tuple(got.shape) == (B, T, fout)
    want = np.asarray(want.astype(jnp.float32))
    got = got.float().numpy()
    assert np.all(got[0] == 0.0) and np.all(want[0] == 0.0)
    if x_dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
        assert np.all(np.abs(got - want) <= ulp), float(np.max(np.abs(got - want) / ulp))


def test_lora_delta_wrapper_checks():
    x = torch.zeros(2, 1, 16)
    # any rank: 65 (past one 64-rank chunk of the kernel) takes the plain version here
    rng = np.random.default_rng(3)
    x65, a65, b65 = (torch.as_tensor(rng.standard_normal(s).astype(np.float32))
                     for s in ((2, 1, 16), (2, 65, 16), (2, 8, 65)))
    torch.testing.assert_close(cudaex.lora_delta_fused(x65, a65, b65, 1.0),
                               cudaex.lora_delta_fused_plain(x65, a65, b65, 1.0), rtol=0, atol=0)
    with pytest.raises(ValueError, match="rank must be at least 1"):
        cudaex.lora_delta_fused(x, torch.zeros(2, 0, 16), torch.zeros(2, 8, 0), 1.0)
    with pytest.raises(ValueError, match="want a"):
        cudaex.lora_delta_fused(x, torch.zeros(2, 4, 8), torch.zeros(2, 8, 4), 1.0)
    with pytest.raises(ValueError, match="float32/float16/bfloat16"):
        cudaex.lora_delta_fused(x, torch.zeros(2, 4, 16, dtype=torch.float64),
                                torch.zeros(2, 8, 4, dtype=torch.float64), 1.0)
    cudaex.reset_launches()
    cudaex.lora_delta_fused(x, torch.zeros(2, 4, 16), torch.zeros(2, 8, 4), 1.0)
    assert cudaex.LAUNCHES["lora_delta_fused"] == 0          # CPU calls run the plain version


#
# the model steps against the JAX functions
#


def _lora_pair(regs, slots):
    jreg, treg = regs
    return (jlora.gather_adapter_slots(jreg.arenas, jnp.asarray(slots, jnp.int32)),
            gather_adapter_slots(treg.arenas, torch.as_tensor(slots)))


def test_forward_with_cache_lora_matches_jax(micro, regs):
    jcfg, tcfg, jp, tp = micro
    slots = [1, 0, 3, 2]
    jl, tl = _lora_pair(regs, slots)
    idx = np.random.default_rng(4).integers(0, 32, (4, 6)).astype(np.int32)
    jcos, jsin = jllama.build_rope_cache(jcfg, 16)
    want, _ = jgen.forward_with_cache(jp, jnp.asarray(idx), 0, jgen.init_cache(
        jcfg, 4, 16, dtype=jnp.float32), jcos, jsin, jcfg, lora=jl, lora_scaling=1.0)
    tcos, tsin = tllama.build_rope_cache(tcfg, 16)
    got, _ = tgen.forward_with_cache(tp, torch.as_tensor(idx), 0, tgen.init_cache(
        tcfg, 4, 16, torch.float32, device="cpu"), tcos, tsin, tcfg, lora=tl, lora_scaling=1.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    base, _ = tgen.forward_with_cache(tp, torch.as_tensor(idx), 0, tgen.init_cache(
        tcfg, 4, 16, torch.float32, device="cpu"), tcos, tsin, tcfg)
    assert torch.equal(got[1], base[1])                       # slot 0: an exact-zero delta
    assert float((got[0] - base[0]).abs().max()) > 1e-3


@pytest.mark.parametrize("B,T,pos", [(4, 1, [0, 5, 8, 13]), (4, 3, [0, 5, 8, 13]),
                                     (1, 8, [8])], ids=["decode", "verify", "chunk"])
def test_forward_paged_lora_fused_matches_jax(micro, regs, B, T, pos):
    jcfg, tcfg, jp, tp = micro
    rng = np.random.default_rng(3)
    L, ng, hs, bs, nbb, nblk = tcfg.n_layer, tcfg.n_query_groups, tcfg.head_size, 4, 6, 24
    tables = np.zeros((B, nbb), np.int32)
    free = rng.permutation(np.arange(1, nblk))
    k = 0
    for i, p in enumerate(pos):
        n = -(-(p + T) // bs)
        tables[i, :n] = free[k:k + n]
        k += n
    ka = rng.standard_normal((nblk, L, ng, bs, hs)).astype(np.float32)
    va = rng.standard_normal((nblk, L, ng, bs, hs)).astype(np.float32)
    idx = rng.integers(0, 32, (B, T)).astype(np.int32)
    jl, tl = _lora_pair(regs, [1, 2, 0, 3][:B])
    cap = nbb * bs
    jcos, jsin = jllama.build_rope_cache(jcfg, cap)
    want, _ = jpa.forward_paged(jp, jnp.asarray(idx), jnp.asarray(pos, jnp.int32),
                                {"k": jnp.asarray(ka), "v": jnp.asarray(va)},
                                jnp.asarray(tables), jcos, jsin, jcfg, cdtype=jnp.float32,
                                lora=jl, lora_scaling=1.0, lora_fused=True)
    tcos, tsin = tllama.build_rope_cache(tcfg, cap)
    got, _ = tpa.forward_paged(tp, torch.as_tensor(idx), torch.as_tensor(pos, dtype=torch.int32),
                               {"k": torch.as_tensor(ka), "v": torch.as_tensor(va)},
                               torch.as_tensor(tables), tcos, tsin, tcfg, cdtype=torch.float32,
                               lora=tl, lora_scaling=1.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


#
# served tokens against the JAX LoRA engine
#


@pytest.mark.parametrize("attn", ["paged", "gather"])
def test_mixed_tenant_tokens_equal_jax_engine(micro, regs, jax_tokens, attn):
    _, tcfg, _, tp = micro
    eng = _port(tcfg, tp, attn=attn, lora=regs[1], **ENGINE)
    assert _drive(eng, _prompts(), IDS) == jax_tokens[attn]
    assert eng.stats()["attn"]["mode"] == attn


def test_paged_equals_gather_sync(micro, regs, jax_tokens):
    _, tcfg, _, tp = micro
    eng = _port(tcfg, tp, attn="paged", async_step=False, lora=regs[1], **ENGINE)
    assert _drive(eng, _prompts(), IDS) == jax_tokens["gather"]


def test_chunked_tokens_equal_jax_engine(micro, regs):
    jcfg, tcfg, jp, tp = micro
    prompts = _prompts((13, 21, 9), seed=2)
    ids = ["bob", None, "alice"]
    want = _drive(_jax(jcfg, jp, attn="paged", lora=regs[0], **CHUNKED), prompts, ids)
    eng = _port(tcfg, tp, attn="paged", lora=regs[1], **CHUNKED)
    assert _drive(eng, prompts, ids) == want
    assert eng.stats()["attn"]["kinds"]["prefill_chunk"]["mode"] == "paged"
    assert eng.chunk_runs > 0
    gather = _port(tcfg, tp, attn="gather", lora=regs[1], **CHUNKED)
    assert _drive(gather, prompts, ids) == want


def test_speculative_tokens_equal_jax_engine(micro, regs):
    jcfg, tcfg, jp, tp = micro
    jdcfg, dcfg, jdp, dp = _pair(seed=9)
    prompts = _prompts((5, 9, 12), seed=3)
    ids = ["carol", "alice", None]
    want = _drive(_jax(jcfg, jp, attn="paged", lora=regs[0],
                       speculative=JSpecConfig(jdp, jdcfg, K=2), **SPEC), prompts, ids, n=7)
    eng = _port(tcfg, tp, attn="paged", lora=regs[1], speculative=ttt.SpecConfig(dp, dcfg, K=2),
                **SPEC)
    assert _drive(eng, prompts, ids, n=7) == want
    assert eng.spec_rounds > 0
    plain = _port(tcfg, tp, lora=regs[1], **SPEC)
    assert _drive(plain, prompts, ids, n=7) == want         # greedy: speculation is exact


def test_speculative_generate_lora_equals_generate(micro, regs):
    _, tcfg, _, tp = micro
    _, dcfg, _, dp = _pair(seed=9)
    prompt = _prompts((7, 7), seed=5)
    slots = torch.as_tensor([regs[1].slot("bob"), 0])
    lora = gather_adapter_slots(regs[1].arenas, slots)
    got = tspec.speculative_generate(tp, dp, np.stack(prompt), tcfg, dcfg, 6, K=2,
                                     lora=lora, device="cpu")
    eng = _port(tcfg, tp, lora=regs[1], **SPEC)
    want = _drive(eng, prompt, ["bob", None], n=6)
    assert [tuple(r.tolist()) for r in got] == want


def test_int8_kv_tokens_equal_jax_engine(micro, regs):
    jcfg, tcfg, jp, tp = micro
    want = _drive(_jax(jcfg, jp, attn="paged", lora=regs[0], kv_dtype="int8", **ENGINE),
                  _prompts(), IDS)
    for attn in ("paged", "gather"):
        eng = _port(tcfg, tp, attn=attn, lora=regs[1], kv_dtype="int8", **ENGINE)
        assert _drive(eng, _prompts(), IDS) == want


@pytest.mark.parametrize("rank", [65, 128])
def test_high_rank_tokens_equal_jax_engine(micro, rank):
    """Ranks past the kernel's 64-rank chunk serve on the default attn (the
    paged lanes) with the JAX engine's tokens."""
    jcfg, tcfg, jp, tp = micro
    jreg, treg = _registries(jcfg, tcfg, rank=rank, std=0.1)
    want = _drive(_jax(jcfg, jp, lora=jreg, **ENGINE), _prompts(), IDS)
    eng = _port(tcfg, tp, lora=treg, **ENGINE)
    assert eng.attn == "paged"
    assert _drive(eng, _prompts(), IDS) == want


def test_mlp_targets_tokens_equal_jax_engine(micro):
    jcfg, tcfg, jp, tp = micro
    jreg, treg = _registries(jcfg, tcfg, targets=FULL, names=("full",))
    ids = ["full", None, "full", None]
    want = _drive(_jax(jcfg, jp, attn="paged", lora=jreg, **ENGINE), _prompts(), ids)
    eng = _port(tcfg, tp, attn="paged", lora=treg, **ENGINE)
    assert _drive(eng, _prompts(), ids) == want
    # the MLP deltas are live: the same factors without them move the logits
    attn_only = ttt.AdapterRegistry(tcfg, rank=RANK, max_adapters=2, device="cpu")
    attn_only.register("full", {t: _factors(tcfg, 10, FULL)[t] for t in attn_only.targets})
    tcos, tsin = tllama.build_rope_cache(tcfg, 8)
    idx = torch.as_tensor(_prompts()[0][None, :4])
    slot = torch.as_tensor([1])

    def logits(reg):
        cache = tgen.init_cache(tcfg, 1, 8, torch.float32, device="cpu")
        return tgen.forward_with_cache(tp, idx, 0, cache, tcos, tsin, tcfg,
                                       lora=gather_adapter_slots(reg.arenas, slot),
                                       lora_scaling=reg.scaling)[0]

    assert float((logits(treg) - logits(attn_only)).abs().max()) > 1e-3


#
# the contracts within the port (as tests/test_serving_lora.py)
#


@pytest.fixture(scope="module")
def mixed(micro, regs):
    _, tcfg, _, tp = micro
    metrics().reset()
    eng = _port(tcfg, tp, attn="paged", lora=regs[1], **ENGINE)
    toks = _drive(eng, _prompts(), IDS)
    return eng, toks, metrics().snapshot("serving.")


def test_solo_equals_mixed(micro, regs, mixed):
    _, tcfg, _, tp = micro
    _, toks, _ = mixed
    for p, a, row in zip(_prompts(), IDS, toks):
        solo = _port(tcfg, tp, attn="paged", lora=regs[1], **ENGINE)
        assert _drive(solo, [p], [a]) == [row]


def test_adapters_change_tokens_and_base_rides_slot_zero(micro, regs, mixed):
    _, tcfg, _, tp = micro
    _, toks, _ = mixed
    base = _drive(_port(tcfg, tp, attn="paged", lora=regs[1], **ENGINE), _prompts(), [None] * 4)
    for a, row, b in zip(IDS, toks, base):
        if a is not None:
            assert row != b, a
    plain = _drive(_port(tcfg, tp, attn="paged", **ENGINE), _prompts(), [None] * 4)
    assert plain == base and toks[3] == plain[3]


def test_tenant_metrics_stats_and_geometries(micro, regs, mixed):
    eng, _, snap = mixed
    for name in ADAPTERS:
        assert snap[f"serving.tenant.{name}.tokens"] == 5
        assert snap[f"serving.tenant.{name}.requests"] == 1
        assert snap[f"serving.tenant.{name}.e2e_s"]["count"] == 1
        assert snap[f"serving.tenant.{name}.ttft_s"]["count"] == 1
    assert not any(k.startswith("serving.tenant.None") for k in snap)
    st = eng.stats()
    assert st["lora"] == regs[1].state_snapshot() and st["lora"]["slots_used"] == 3
    assert sum(st["compile_counts"].values()) <= st["bucket_bound"]
    before = dict(st["compile_counts"])
    _drive(eng, _prompts(), ["carol", "alice", "bob", "alice"])
    assert eng.stats()["compile_counts"] == before            # adapter ids add no geometry


def test_submit_validation(micro, regs):
    _, tcfg, _, tp = micro
    with pytest.raises(ValueError, match="requires an engine built with"):
        _port(tcfg, tp, **ENGINE).submit(np.arange(3, dtype=np.int32), max_new_tokens=2,
                                         adapter_id="alice")
    eng = _port(tcfg, tp, lora=regs[1], **ENGINE)
    with pytest.raises(KeyError, match="unknown adapter_id"):
        eng.submit(np.arange(3, dtype=np.int32), max_new_tokens=2, adapter_id="nobody")
    wrong = ttt.Config.from_name("tiny-llama-debug", **{**MICRO, "n_embd": 32, "n_head": 4})
    wrong_params = ttt.init_params(wrong, device="cpu", dtype=torch.float32)
    with pytest.raises(ValueError, match="registry was built for"):
        _port(wrong, wrong_params, lora=regs[1], **ENGINE)
    big = ttt.AdapterRegistry(tcfg, rank=65, max_adapters=1, device="cpu")
    assert _port(tcfg, tp, lora=big, **ENGINE).attn == "paged"    # any rank serves paged
    _port(tcfg, tp, lora=big, attn="gather", **ENGINE)


def test_evicted_adapter_degrades_to_base(micro):
    _, tcfg, _, tp = micro
    reg = ttt.AdapterRegistry(tcfg, rank=RANK, max_adapters=2, device="cpu")
    reg.register("x", _factors(tcfg, 30))
    p = _prompts()[2]
    eng = _port(tcfg, tp, lora=reg, **ENGINE)
    adapted = _drive(eng, [p], ["x"])
    h = eng.submit(p, max_new_tokens=5, adapter_id="x")
    reg.evict("x")
    eng.drain()
    base = _drive(_port(tcfg, tp, **ENGINE), [p], [None])
    assert tuple(h.result(drive=False).tokens.tolist()) == base[0] != adapted[0]


#
# prefix sharing keyed by factor identity
#


def _shared_run(eng, prompt):
    """"alice" admitted and stepped once (her prefix registers), then "bob"
    with the same prompt."""
    ha = eng.submit(prompt, max_new_tokens=6, adapter_id="alice")
    eng.step()
    hb = eng.submit(prompt.copy(), max_new_tokens=6, adapter_id="bob")
    eng.drain()
    return ha.result(drive=False).new_tokens, hb.result(drive=False).new_tokens


def test_cross_adapter_prefix_is_not_shared(micro, regs):
    """The port's tokens equal the JAX engine's solo runs.  The JAX engine
    shares alice's prefix K/V with bob (``PrefixIndex.find`` keys on the
    prompt tokens alone and ``_prefix_alive`` checks only that the owner
    runs, ``thunder_tpu/serving/engine.py:1311-1340``), so its shared run
    gives bob other tokens than bob alone: the reference breaks its own
    solo = batched contract there, and the port does not copy that."""
    jcfg, tcfg, jp, tp = micro
    prompt = _prompts((10,), seed=1)[0]
    jeng = _jax(jcfg, jp, attn="paged", lora=regs[0], **ENGINE)
    j_alice, j_bob = _shared_run(jeng, prompt)
    assert jeng.stats()["prefix_hits"] == 1
    solo = {a: _jax(jcfg, jp, attn="paged", lora=regs[0], **ENGINE).submit(
        prompt, max_new_tokens=6, adapter_id=a).result().new_tokens for a in ("alice", "bob")}
    assert j_alice == solo["alice"] and j_bob != solo["bob"]
    for attn in ("paged", "gather"):
        eng = _port(tcfg, tp, attn=attn, lora=regs[1], **ENGINE)
        assert _shared_run(eng, prompt) == (solo["alice"], solo["bob"])
        assert eng.stats()["prefix_hits"] == 0


def test_same_adapter_prefix_is_shared_until_reregistered(micro):
    _, tcfg, _, tp = micro
    reg = ttt.AdapterRegistry(tcfg, rank=RANK, max_adapters=2, device="cpu")
    reg.register("alice", _factors(tcfg, 10))
    prompt = _prompts((10,), seed=1)[0]
    eng = _port(tcfg, tp, lora=reg, **ENGINE)
    ha = eng.submit(prompt, max_new_tokens=6, adapter_id="alice")
    eng.step()
    hb = eng.submit(prompt.copy(), max_new_tokens=6, adapter_id="alice")
    eng.drain()
    ra, rb = ha.result(drive=False), hb.result(drive=False)
    assert rb.shared_prefix_blocks == 2 and ra.new_tokens == rb.new_tokens
    hd = eng.submit(prompt.copy(), max_new_tokens=6, adapter_id="alice")
    eng.step()                                          # its prefix registers
    reg.register("alice", _factors(tcfg, 11))           # same slot, new factors
    hc = eng.submit(prompt.copy(), max_new_tokens=6, adapter_id="alice")
    eng.drain()
    assert hd.result(drive=False).shared_prefix_blocks == 0
    assert hc.result(drive=False).shared_prefix_blocks == 0
    assert eng.stats()["prefix_hits"] == 1


#
# the training forward's single-adapter hook (tests/test_serving_lora.py:253)
#


def test_llama_attention_lora_hook_matches_jax(micro):
    jcfg, tcfg, jp, tp = micro
    f = _factors(tcfg, 3, std=0.3)
    idx = (np.arange(6, dtype=np.int32) % 32)[None]

    def hooked(params, lib):
        out = copy.copy(params)
        out["blocks"] = [dict(b) for b in params["blocks"]]
        out["blocks"][0]["attn"] = dict(out["blocks"][0]["attn"])
        out["blocks"][0]["attn"]["lora"] = {t: (lib(f[t][0][0]), lib(f[t][1][0]))
                                            for t in ("wq", "wo")}
        return out

    jcos, jsin = jllama.build_rope_cache(jcfg, 6)
    want = tt.jit(lambda p, i, c, s: jllama.gpt_forward(p, i, c, s, jcfg))(
        hooked(jp, jnp.asarray), jnp.asarray(idx), jcos, jsin)
    tcos, tsin = tllama.build_rope_cache(tcfg, 6)
    with torch.no_grad():
        got = tllama.gpt_forward(hooked(tp, torch.as_tensor), torch.as_tensor(idx), tcos, tsin,
                                 tcfg)
        base = tllama.gpt_forward(tp, torch.as_tensor(idx), tcos, tsin, tcfg)
        merged = copy.copy(tp)
        merged["blocks"] = [dict(b) for b in tp["blocks"]]
        merged["blocks"][0]["attn"] = dict(merged["blocks"][0]["attn"])
        for t in ("wq", "wo"):
            merged["blocks"][0]["attn"][t] = (merged["blocks"][0]["attn"][t]
                                              + torch.as_tensor(f[t][1][0] @ f[t][0][0]))
        out_merged = tllama.gpt_forward(merged, torch.as_tensor(idx), tcos, tsin, tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    assert not np.allclose(got.numpy(), base.numpy())
    np.testing.assert_allclose(got.numpy(), out_merged.numpy(), rtol=2e-4, atol=2e-4)


#
# on the card
#


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("f_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,fin,fout,r", [(8, 1, 4096, 4096, 16), (8, 5, 4096, 1024, 64),
                                            (1, 40, 256, 300, 3), (3, 17, 130, 129, 8),
                                            (4, 3, 512, 300, 65), (2, 20, 1024, 512, 128),
                                            (8, 1, 4096, 1024, 256)])
def test_cuda_lora_delta_matches_plain(card, B, T, fin, fout, r, x_dtype, f_dtype):
    """float32 within 1e-5 of the output's largest magnitude (the same
    products in another order); bf16 within 2 ulps of the plain version's
    output (both round at the same three points, and a sum in another
    order may round d one ulp the other way); base-slot rows exactly 0."""
    gen = torch.Generator(card).manual_seed(B * T + r)
    x = torch.randn((B, T, fin), generator=gen, device=card).to(x_dtype)
    a = (torch.randn((B, r, fin), generator=gen, device=card) * 0.05).to(f_dtype)
    b = (torch.randn((B, fout, r), generator=gen, device=card) * 0.05).to(f_dtype)
    a[0], b[0] = 0, 0
    cudaex.reset_launches()
    got = cudaex.lora_delta_fused(x, a, b, 2.0)
    torch.cuda.synchronize()
    assert cudaex.LAUNCHES["lora_delta_fused"] == 1
    want = cudaex.lora_delta_fused_plain(x, a, b, 2.0)
    assert bool((got[0] == 0).all())
    err = (got.float() - want.float()).abs()
    if x_dtype == torch.float32:
        assert float(err.max()) <= 1e-5 * float(want.abs().max())
    else:
        ulp = torch.exp2(torch.floor(torch.log2(want.float().abs().clamp(min=1e-30))) - 7)
        assert bool((err <= 2 * ulp).all()), float((err / ulp).max())


@pytest.mark.cuda
def test_cuda_lora_engine_launches_and_tokens(card):
    """On the card the paged LoRA engine launches lora_delta_fused 4 times
    per layer per decode step and serves the gather engine's float32
    tokens."""
    cfg = ttt.Config.from_name("tiny-llama-debug", n_embd=256)          # hs 64
    params = ttt.init_params(cfg, generator=torch.Generator(card).manual_seed(0),
                             dtype=torch.float32, device=card)
    reg = ttt.AdapterRegistry(cfg, rank=8, max_adapters=2, alpha=16, device=card)
    for i, name in enumerate(("x", "y")):
        reg.register(name, ttt.make_lora_factors(cfg, 8, torch.Generator(card).manual_seed(i)))
    prompts = _prompts(lens=(3, 17, 30, 9))
    ids = ["x", None, "y", "x"]

    def run(attn):
        eng = ttt.serve(None, params, cfg, attn=attn, device=card, block_size=16,
                        num_blocks=32, max_batch=4, lora=reg)
        cudaex.reset_launches()
        toks = _drive(eng, prompts, ids, n=6)
        torch.cuda.synchronize()
        return toks, dict(cudaex.LAUNCHES), eng.decode_steps

    paged, launches, steps = run("paged")
    gather, none, _ = run("gather")
    assert launches["lora_delta_fused"] == 4 * cfg.n_layer * steps > 0
    assert none["lora_delta_fused"] == 0
    assert paged == gather
