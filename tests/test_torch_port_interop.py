"""``thunder_tpu_torch.jit`` of a ``torch.nn.Module`` against the JAX
package's, and the HF state-dict converters, on the CPU
(``torch_interop.py``, ``models/hf_weights.py``).

The same module object goes through ``thunder_tpu.jit(module)`` (JAX on
the CPU) and ``thunder_tpu_torch.jit(module)``; both return a
``ThunderModule`` whose forward runs a compiled program and whose backward
fills each ``nn.Parameter``'s ``.grad``.  Outputs and parameter grads agree
in float32 within 1e-5 of each value's largest magnitude (the two packages
sum in other orders; the port's values also agree with the eager module).
The modules: the reference tests' ``_mlp``; a 2-layer tiny Llama written
with stock ``torch``/``F`` calls (``chip_smoke.LlamaModule``, phase 18's
module at tiny widths); a tiny ``transformers.GPT2LMHeadModel`` built from
a config, with ``generate``'s greedy tokens equal.  Also: a training loop
whose losses fall and equal the JAX module's step by step (AdamW, 1e-5
relative); ``state_dict`` passthrough; tied weights; the in-place and
constant cases of the reference's ``TestInplaceAndConstants``; the
residuals released after backward.  Each family's HF-layout state dict,
built in memory from a seed, converts to params bitwise equal to
``params_from_numpy`` of the JAX converter's output (float32 and
bfloat16).  On the card (``cuda``-marked): the module's launches and no
declines.
"""
from __future__ import annotations

import copy
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

import chip_smoke
import thunder_tpu as tt
import thunder_tpu_torch as ttt
from thunder_tpu.models import hf_weights as rhf
from thunder_tpu_torch import torch_interop
from thunder_tpu_torch.models import hf_weights as phf
from torch_port_threads import one_torch_thread  # noqa: F401

REL = 1e-5          # float32: outputs and grads against the reference's, of each value's max


def _close(got, want, rel=REL, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = want.detach().float().numpy() if isinstance(want, torch.Tensor) else np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: max |diff| {err:.3e} > {rel} x {scale:.3e}"


def _mlp(seed=0):
    torch.manual_seed(seed)
    return nn.Sequential(nn.Linear(8, 16), nn.ReLU(), nn.Linear(16, 4))


def _tiny_llama(n_layer=2, T=32, seed=0):
    cfg = ttt.Config.from_name("tiny-llama-debug", n_layer=n_layer)
    params = ttt.init_params(cfg, generator=torch.Generator().manual_seed(seed), device="cpu",
                             dtype=torch.float32)
    return chip_smoke.llama_module(params, cfg, T), cfg


def _grads(module, run):
    for p in module.parameters():
        p.grad = None
    out = run()
    out.backward()
    return out.detach(), {n: p.grad.clone() for n, p in module.named_parameters()}


def _both(module, run):
    """(port, reference) results and grads of ``run(jitted)`` on one module."""
    port = _grads(module, lambda: run(ttt.jit(module)))
    ref = _grads(module, lambda: run(tt.jit(module)))
    return port, ref


def test_jit_of_a_module_returns_a_thunder_module():
    m = _mlp()
    tm = ttt.jit(m)
    assert isinstance(tm, torch_interop.ThunderModule)
    x = torch.randn(5, 8, generator=torch.Generator().manual_seed(1))
    assert torch.equal(tm(x), m(x)) or torch.allclose(tm(x), m(x), rtol=1e-6)
    assert ttt.cache_misses(tm) == 1 and len(ttt.last_traces(tm)) > 1
    with pytest.raises(RuntimeError, match="langctx"):
        ttt.jit(m, langctx="torch")


def test_mlp_outputs_and_grads_equal_the_reference():
    m = _mlp()
    x = torch.randn(5, 8, generator=torch.Generator().manual_seed(2))
    (pout, pg), (rout, rg) = _both(m, lambda tm: (tm(x) ** 2).mean())
    _close(pout, rout, what="loss")
    for n in rg:
        _close(pg[n], rg[n], what=n)
    _, eg = _grads(m, lambda: (m(x) ** 2).mean())
    for n in eg:
        _close(pg[n], eg[n], what=n)
    with torch.no_grad():
        _close(ttt.jit(m)(x), m(x), what="no_grad forward")


def test_tiny_llama_module_equals_the_reference():
    m, cfg = _tiny_llama()
    g = torch.Generator().manual_seed(3)
    idx = torch.randint(0, cfg.vocab_size, (2, 32), generator=g)
    tgt = torch.randint(0, cfg.vocab_size, (2, 32), generator=g)
    (pl, pg), (rl, rg) = _both(m, lambda tm: tm(idx, tgt))
    _close(pl, rl, what="loss")
    _, eg = _grads(m, lambda: m(idx, tgt))
    _close(pl, m(idx, tgt), what="eager loss")
    for n in rg:
        _close(pg[n], rg[n], what=n)
        _close(pg[n], eg[n], what=n)
    # the module's SDPA and CE reach the fused prims: the traced program
    # carries one SDPA per layer and one cross-entropy, and no decline
    tm = ttt.jit(m)
    tm(idx, tgt).backward()
    names = [b.sym.name for b in ttt.last_traces(tm)[-1].bound_symbols]
    assert names.count("torch_sdpa") == cfg.n_layer
    assert names.count("torch_cross_entropy_fwd") == 1
    bw = [b.sym.name for b in ttt.last_backward_traces(tm)[-1].bound_symbols]
    assert bw.count("torch_sdpa_backward") == cfg.n_layer


def test_training_loop_tracks_the_reference_step_by_step():
    m0, cfg = _tiny_llama(seed=4)
    mods = {"port": m0, "ref": copy.deepcopy(m0)}
    jits = {"port": ttt.jit(mods["port"]), "ref": tt.jit(mods["ref"])}
    opts = {k: torch.optim.AdamW(m.parameters(), lr=3e-3) for k, m in mods.items()}
    g = torch.Generator().manual_seed(5)
    idx = torch.randint(0, cfg.vocab_size, (2, 32), generator=g)
    tgt = torch.roll(idx, -1, 1)
    losses = {"port": [], "ref": []}
    for _ in range(5):
        for k in mods:
            opts[k].zero_grad()
            loss = jits[k](idx, tgt)
            loss.backward()
            opts[k].step()
            losses[k].append(float(loss))
    np.testing.assert_allclose(losses["port"], losses["ref"], rtol=REL)
    assert losses["port"][-1] < losses["port"][0]
    # the optimizer's in-place updates reach the compiled program without a
    # recompile: one specialization, every later call a cache hit
    assert ttt.cache_misses(jits["port"]) == 1 and ttt.cache_hits(jits["port"]) == 4


def test_state_dict_and_parameters_pass_through():
    m = _mlp()
    tm = ttt.jit(m)
    sd = tm.state_dict()
    assert set(sd) == set(m.state_dict())
    assert not any(k.startswith("_orig_mod") for k in sd)
    assert [p is q for p, q in zip(tm.parameters(), m.parameters())] == [True] * 4
    new = {k: v + 1 for k, v in sd.items()}
    tm.load_state_dict(new)
    x = torch.randn(3, 8)
    with torch.no_grad():
        _close(tm(x), m(x), what="after load_state_dict")
        assert torch.equal(m[0].weight, new["0.weight"])


class _Tied(nn.Module):
    def __init__(self):
        super().__init__()
        torch.manual_seed(6)
        self.wte = nn.Embedding(32, 16)
        self.head = nn.Linear(16, 32, bias=False)
        self.head.weight = self.wte.weight

    def forward(self, idx):
        return self.head(torch.tanh(self.wte(idx))).logsumexp(-1).mean()


def test_tied_weights():
    m = _Tied()
    assert len(list(m.parameters())) == 1
    idx = torch.randint(0, 32, (3, 5), generator=torch.Generator().manual_seed(7))
    (pl, pg), (rl, rg) = _both(m, lambda tm: tm(idx))
    _, eg = _grads(m, lambda: m(idx))
    _close(pl, rl, what="loss")
    _close(pg["wte.weight"], rg["wte.weight"], what="tied grad")
    _close(pg["wte.weight"], eg["wte.weight"], what="tied grad vs eager")


def test_residuals_are_released_after_backward(monkeypatch):
    """The pullback the bridge holds is dropped by backward, and the
    backward program empties the residual list it was handed."""
    held = []
    forward = torch_interop.ThunderFunction.forward

    def spy(ctx, holder, *params):
        out = forward(ctx, holder, *params)
        held.append(ctx._pullback)
        return out

    monkeypatch.setattr(torch_interop.ThunderFunction, "forward", staticmethod(spy))
    m, cfg = _tiny_llama()
    idx = torch.randint(0, cfg.vocab_size, (1, 32), generator=torch.Generator().manual_seed(8))
    loss = ttt.jit(m)(idx, idx)
    pullback = held[0]
    saved = pullback.__closure__[[c for c in pullback.__code__.co_freevars].index("saved")]
    assert len(saved.cell_contents) > 0
    node = loss.grad_fn
    loss.backward()
    assert saved.cell_contents == [] and not pullback.fresh
    assert not hasattr(node, "_pullback")


#
# In-place edits and constants (the reference's TestInplaceAndConstants)
#

def test_setitem_and_clone():
    def f(a, b):
        c = a.clone()
        c[:, 2:5] = b
        c[0, 0] = 9.0
        return c * 1.0

    a, b = np.zeros((3, 8), np.float32), np.full((3, 3), 7.0, np.float32)
    want = np.asarray(tt.jit(f)(jnp.asarray(a), jnp.asarray(b)))
    got = ttt.jit(f)(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(got.numpy(), want)


def test_setitem_on_an_input():
    def f(x):
        x[1:3] = 0.0
        return x * 2.0

    want = np.asarray(tt.jit(f)(jnp.ones((4,))))
    got = ttt.jit(f)(torch.ones(4))
    np.testing.assert_array_equal(got.numpy(), want)


def test_grad_through_setitem():
    def loss(a, b):
        c = a.clone()
        c[:, 1:3] = b
        return (c * c).sum()

    _, (rga, rgb) = tt.value_and_grad(loss, argnums=(0, 1))(jnp.ones((2, 4)), jnp.full((2, 2), 3.0))
    _, (pga, pgb) = ttt.value_and_grad(loss, argnums=(0, 1))(torch.ones(2, 4),
                                                             torch.full((2, 2), 3.0))
    np.testing.assert_array_equal(pga.numpy(), np.asarray(rga))
    np.testing.assert_array_equal(pgb.numpy(), np.asarray(rgb))


def test_real_tensor_receiver_with_a_traced_value():
    def g(x):
        m = torch.zeros(4)  # stays a real torch constant
        m[1:3] = x[0:2]  # a traced edit: the baked proxy follows it
        return m + x * 0.0 + m

    want = np.asarray(tt.jit(g)(jnp.full((4,), 5.0)))
    got = ttt.jit(g)(torch.full((4,), 5.0))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, [0, 10, 10, 0])


def test_no_raw_torch_tensors_in_recorded_bsyms():
    jm = ttt.jit(lambda x: x * torch.arange(4.0))
    np.testing.assert_array_equal(jm(torch.ones(4)).numpy(), [0, 1, 2, 3])
    for b in ttt.last_traces(jm)[0].bound_symbols:
        for a in b.flat_args:
            assert not isinstance(a, torch.Tensor), (b.sym.name, type(a))
    # a constant baked twice is one proxy
    from thunder_tpu_torch.core.trace import TraceCtx, tracectx

    t = torch.ones(3)
    with tracectx(TraceCtx(None)):
        assert torch_interop._const_tensor_proxy(t) is torch_interop._const_tensor_proxy(t)


def test_tracing_mode_puts_concrete_factories_on_the_module_device():
    from thunder_tpu_torch.core.trace import TraceCtx, tracectx

    mode = torch_interop.ThunderTracingMode(torch.device("meta"))
    with tracectx(TraceCtx(None)), mode:
        made = torch.ones(3)
        fin = torch.finfo(ttt.torch.float32 if hasattr(ttt.torch, "float32") else torch.float32)
    assert made.device.type == "meta" and fin.bits == 32
    assert torch.ones(2).device.type == "cpu" and torch.jit.is_tracing() is False


#
# A tiny transformers GPT-2
#

def _tiny_gpt2(transformers, **kw):
    base = dict(n_layer=2, n_head=4, n_embd=32, vocab_size=128, n_positions=64, attn_pdrop=0.0,
                resid_pdrop=0.0, embd_pdrop=0.0)
    base.update(kw)
    torch.manual_seed(0)
    return transformers.GPT2LMHeadModel(transformers.GPT2Config(**base)).eval()


def test_gpt2_forward_grads_and_generate_equal_the_reference():
    transformers = pytest.importorskip("transformers")
    m = _tiny_gpt2(transformers)
    ids = torch.randint(0, 128, (2, 16), generator=torch.Generator().manual_seed(9))
    (pl, pg), (rl, rg) = _both(m, lambda tm: tm(input_ids=ids, labels=ids, use_cache=False).loss)
    _close(pl, rl, what="loss")
    for n in rg:
        _close(pg[n], rg[n], rel=1e-4, what=n)
    tm = ttt.jit(m)
    out = tm(input_ids=ids, use_cache=False)
    assert type(out).__name__ == "CausalLMOutputWithCrossAttentions"
    _close(out.logits, tt.jit(m)(input_ids=ids, use_cache=False).logits, what="logits")
    prompt = ids[:1, :6]
    want = tt.jit(m).generate(prompt, max_new_tokens=4, do_sample=False, pad_token_id=0)
    got = tm.generate(prompt, max_new_tokens=4, do_sample=False, pad_token_id=0)
    eager = m.generate(prompt, max_new_tokens=4, do_sample=False, use_cache=False, pad_token_id=0)
    assert got.tolist() == want.tolist() == eager.tolist()
    with pytest.raises(NotImplementedError, match="use_cache"):
        tm.generate(prompt, max_new_tokens=1, do_sample=False, use_cache=True, pad_token_id=0)


#
# HF state dicts → params
#

def _ns(**kw):
    return types.SimpleNamespace(**kw)


def _family_configs():
    return {
        "gpt2": _ns(model_type="gpt2", n_positions=64, vocab_size=100, n_layer=2, n_head=4,
                    n_embd=32, n_inner=None, layer_norm_epsilon=1e-5,
                    activation_function="gelu_new"),
        "gpt_neox": _ns(model_type="gpt_neox", max_position_embeddings=64, vocab_size=100,
                        num_hidden_layers=2, num_attention_heads=4, hidden_size=32,
                        intermediate_size=64, layer_norm_eps=1e-5, rotary_pct=0.25,
                        rotary_emb_base=10000, use_parallel_residual=True, hidden_act="gelu",
                        tie_word_embeddings=False),
        "falcon": _ns(model_type="falcon", max_position_embeddings=64, vocab_size=100,
                      num_hidden_layers=2, num_attention_heads=4, hidden_size=32,
                      layer_norm_epsilon=1e-5, rope_theta=10000, parallel_attn=True,
                      alibi=False, bias=False, new_decoder_architecture=False, multi_query=True,
                      tie_word_embeddings=True),
        "falcon-new": _ns(model_type="falcon", max_position_embeddings=64, vocab_size=100,
                          num_hidden_layers=2, num_attention_heads=4, num_kv_heads=2,
                          hidden_size=32, layer_norm_epsilon=1e-5, rope_theta=10000,
                          parallel_attn=True, alibi=False, bias=False,
                          new_decoder_architecture=True, tie_word_embeddings=False),
        "llama": _ns(model_type="llama", max_position_embeddings=64, vocab_size=100,
                     num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                     hidden_size=32, intermediate_size=80, rope_theta=10000, rms_norm_eps=1e-5,
                     tie_word_embeddings=False, hidden_act="silu", rope_scaling=None),
        "gemma": _ns(model_type="gemma", max_position_embeddings=64, vocab_size=100,
                     num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=1,
                     hidden_size=32, intermediate_size=80, rope_theta=10000, rms_norm_eps=1e-6,
                     tie_word_embeddings=True, hidden_act="gelu_pytorch_tanh", head_dim=8,
                     rope_scaling=None),
    }


def _state_dict(family, hf, seed=0):
    """An HF-layout state dict of ``family`` from a seed, float32."""
    rng = np.random.default_rng(seed)
    sd = {}

    def put(name, *shape):
        sd[name] = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    if family == "gpt2":
        C, V, P = hf.n_embd, hf.vocab_size, hf.n_positions
        put("transformer.wte.weight", V, C), put("transformer.wpe.weight", P, C)
        put("transformer.ln_f.weight", C), put("transformer.ln_f.bias", C)
        for i in range(hf.n_layer):
            p = f"transformer.h.{i}."
            for ln in ("ln_1", "ln_2"):
                put(p + ln + ".weight", C), put(p + ln + ".bias", C)
            put(p + "attn.c_attn.weight", C, 3 * C), put(p + "attn.c_attn.bias", 3 * C)
            put(p + "attn.c_proj.weight", C, C), put(p + "attn.c_proj.bias", C)
            put(p + "mlp.c_fc.weight", C, 4 * C), put(p + "mlp.c_fc.bias", 4 * C)
            put(p + "mlp.c_proj.weight", 4 * C, C), put(p + "mlp.c_proj.bias", C)
    elif family == "gpt_neox":
        C, V, I = hf.hidden_size, hf.vocab_size, hf.intermediate_size
        put("gpt_neox.embed_in.weight", V, C), put("embed_out.weight", V, C)
        put("gpt_neox.final_layer_norm.weight", C), put("gpt_neox.final_layer_norm.bias", C)
        for i in range(hf.num_hidden_layers):
            p = f"gpt_neox.layers.{i}."
            for ln in ("input_layernorm", "post_attention_layernorm"):
                put(p + ln + ".weight", C), put(p + ln + ".bias", C)
            put(p + "attention.query_key_value.weight", 3 * C, C)
            put(p + "attention.query_key_value.bias", 3 * C)
            put(p + "attention.dense.weight", C, C), put(p + "attention.dense.bias", C)
            put(p + "mlp.dense_h_to_4h.weight", I, C), put(p + "mlp.dense_h_to_4h.bias", I)
            put(p + "mlp.dense_4h_to_h.weight", C, I), put(p + "mlp.dense_4h_to_h.bias", C)
    elif family.startswith("falcon"):
        C, V, nh = hf.hidden_size, hf.vocab_size, hf.num_attention_heads
        hs = C // nh
        ng = hf.num_kv_heads if hf.new_decoder_architecture else 1
        put("transformer.word_embeddings.weight", V, C)
        put("transformer.ln_f.weight", C), put("transformer.ln_f.bias", C)
        if not hf.tie_word_embeddings:
            put("lm_head.weight", V, C)
        for i in range(hf.num_hidden_layers):
            p = f"transformer.h.{i}."
            put(p + "self_attention.query_key_value.weight", (nh + 2 * ng) * hs, C)
            put(p + "self_attention.dense.weight", C, C)
            put(p + "mlp.dense_h_to_4h.weight", 4 * C, C), put(p + "mlp.dense_4h_to_h.weight", C, 4 * C)
            norms = ("ln_attn", "ln_mlp") if hf.new_decoder_architecture else ("input_layernorm",)
            for ln in norms:
                put(p + ln + ".weight", C), put(p + ln + ".bias", C)
    else:
        C, V, I = hf.hidden_size, hf.vocab_size, hf.intermediate_size
        nh, ng = hf.num_attention_heads, hf.num_key_value_heads
        hs = getattr(hf, "head_dim", None) or C // nh
        put("model.embed_tokens.weight", V, C), put("model.norm.weight", C)
        if not hf.tie_word_embeddings:
            put("lm_head.weight", V, C)
        for i in range(hf.num_hidden_layers):
            p = f"model.layers.{i}."
            put(p + "input_layernorm.weight", C), put(p + "post_attention_layernorm.weight", C)
            put(p + "self_attn.q_proj.weight", nh * hs, C)
            put(p + "self_attn.k_proj.weight", ng * hs, C)
            put(p + "self_attn.v_proj.weight", ng * hs, C)
            put(p + "self_attn.o_proj.weight", C, nh * hs)
            put(p + "mlp.gate_proj.weight", I, C), put(p + "mlp.up_proj.weight", I, C)
            put(p + "mlp.down_proj.weight", C, I)
    return sd


_CONVERTERS = {"gpt2": "from_gpt2_state_dict", "gpt_neox": "from_gpt_neox_state_dict",
               "falcon": "from_falcon_state_dict", "falcon-new": "from_falcon_state_dict",
               "llama": "from_hf_state_dict", "gemma": "from_hf_state_dict"}


def _leaves_equal(got, want):
    assert type(got) is type(want) or isinstance(got, type(want))
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _leaves_equal(got[k], want[k])
    elif isinstance(want, list):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _leaves_equal(a, b)
    else:
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got.view(torch.int16) if got.dtype == torch.bfloat16 else got,
                           want.view(torch.int16) if want.dtype == torch.bfloat16 else want)


@pytest.mark.parametrize("family", list(_CONVERTERS))
def test_hf_state_dicts_convert_to_the_reference_params(family):
    hf = _family_configs()[family]
    pcfg, rcfg = phf.config_from_hf(hf), rhf.config_from_hf(hf)
    shared = {f.name for f in dataclasses.fields(pcfg)} & {f.name for f in dataclasses.fields(rcfg)}
    assert {k: getattr(pcfg, k) for k in shared} == {k: getattr(rcfg, k) for k in shared}
    sd = _state_dict(family, hf)
    conv = _CONVERTERS[family]
    for pdt, rdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = getattr(phf, conv)(sd, pcfg, dtype=pdt, device="cpu")
        want = getattr(rhf, conv)(sd, rcfg, dtype=rdt)
        want = ttt.params_from_numpy(jax.tree_util.tree_map(np.asarray, want), device="cpu")
        _leaves_equal(got, want)
    # the converted params run: the port's forward at these widths is finite
    got = getattr(phf, conv)(sd, pcfg, dtype=torch.float32, device="cpu")
    cos, sin = ttt.models.llama.build_rope_cache(pcfg, 8)
    idx = torch.randint(0, hf.vocab_size, (1, 8), generator=torch.Generator().manual_seed(1))
    logits = ttt.models.llama.gpt_forward(got, idx, cos, sin, pcfg)
    assert logits.shape == (1, 8, pcfg.padded_vocab_size) and torch.isfinite(logits).all()


def test_hf_converters_refuse_what_the_reference_refuses():
    bad = [_ns(model_type="bert"),
           _ns(model_type="gpt2", activation_function="relu"),
           _ns(**{**vars(_family_configs()["llama"]), "rope_scaling": {"type": "yarn"}}),
           _ns(**{**vars(_family_configs()["falcon"]), "alibi": True})]
    for hf in bad:
        with pytest.raises(ValueError):
            phf.config_from_hf(hf)
        with pytest.raises(ValueError):
            rhf.config_from_hf(hf)
    hf = _family_configs()["llama"]
    sd = _state_dict("llama", hf)
    del sd["model.layers.1.mlp.up_proj.weight"]
    with pytest.raises(KeyError, match="up_proj"):
        phf.from_hf_state_dict(sd, phf.config_from_hf(hf), dtype=torch.float32, device="cpu")


#
# On the card
#

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the flash kernels run on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_module_launches_the_kernels_and_declines_nothing(card):
    from thunder_tpu_torch import ltorch
    from thunder_tpu_torch.executors import cudaex

    cfg = ttt.Config.from_name("tiny-llama-debug", n_layer=2, n_embd=256, n_head=4,
                               n_query_groups=2, intermediate_size=512)
    params = ttt.init_params(cfg, generator=torch.Generator(card).manual_seed(0), device=card,
                             dtype=torch.bfloat16)
    m = chip_smoke.llama_module(params, cfg, 128)
    idx = torch.randint(0, cfg.vocab_size, (1, 128), generator=torch.Generator(card).manual_seed(1),
                        device=card)
    for key in ltorch.DECLINES:
        ltorch.DECLINES[key] = 0
    tm = ttt.jit(m)
    cudaex.reset_launches()
    loss = tm(idx, idx)
    loss.backward()
    torch.cuda.synchronize()
    assert cudaex.LAUNCHES["flash_fwd"] >= cfg.n_layer
    assert cudaex.LAUNCHES["flash_bwd_dq"] == cudaex.LAUNCHES["flash_bwd_dkv"] == cfg.n_layer
    assert cudaex.LAUNCHES["flash_ce"] == 1
    assert not any(ltorch.DECLINES.values()), ltorch.DECLINES
    assert all(p.grad is not None for p in m.parameters())
