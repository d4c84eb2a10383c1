"""thunder_tpu_torch serving engine against the JAX package's engine, on the CPU.

The acceptance bar is token-exact: greedy requests served by the port —
paged decode (the kernels' plain versions here) and gather decode, async
and sync loops — equal the tokens the JAX engine serves with
``attn="paged"`` (Pallas kernels interpreted) on the same weights, with the
micro config and buckets of ``tests/test_paged_attention.py``.  Sampling is
checked within the port: a request's tokens at temperature > 0 do not
depend on what shares its batch.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import thunder_tpu as tt
import thunder_tpu_torch as ttt
from thunder_tpu.models import llama as jllama
from thunder_tpu_torch.executors import cudaex
from thunder_tpu_torch.models import generate as tgen
from thunder_tpu_torch.serving import AdmissionError, ServingEngine

# 2 layers (layer-indexed arena reads), GQA 4:2, tiny widths
MICRO = dict(
    n_layer=2, n_head=4, n_query_groups=2, n_embd=32,
    intermediate_size=64, vocab_size=64, block_size=64,
)
BUCKETS = dict(batch_buckets=(4,), block_buckets=(6,), prefill_buckets=(16,))
ENGINE = dict(block_size=4, num_blocks=32, max_batch=4, **BUCKETS)
LENS = (3, 5, 9, 14)
PREFIX = (np.arange(10) * 7 + 3).astype(np.int32) % 64


def _models(**overrides):
    jcfg = jllama.Config.from_name("tiny-llama-debug", **MICRO, **overrides)
    tcfg = ttt.Config.from_name("tiny-llama-debug", **MICRO, **overrides)
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = ttt.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _prompts(lens=LENS, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 64, (n,)).astype(np.int32) for n in lens]


def _drive(eng, prompts, n=5, **submit_kw):
    handles = [eng.submit(p, max_new_tokens=n, **submit_kw) for p in prompts]
    eng.drain()
    return [tuple(int(t) for t in h.result(drive=False).tokens) for h in handles]


def _drive_shared_prefix(eng):
    """A, one step (A's prefix registers), then B with the same prompt."""
    ha = eng.submit(PREFIX, max_new_tokens=4)
    eng.step()
    hb = eng.submit(PREFIX.copy(), max_new_tokens=4)
    eng.step()
    eng.drain()
    ra, rb = ha.result(drive=False), hb.result(drive=False)
    return tuple(ra.tokens.tolist()), tuple(rb.tokens.tolist()), rb.shared_prefix_blocks


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
    jcfg, tcfg, jp, tp = _models()
    ref = tt.serve(None, jp, jcfg, attn="paged", cache_dtype=jnp.float32, **ENGINE)
    tokens = _drive(ref, _prompts())
    shared = _drive_shared_prefix(
        tt.serve(None, jp, jcfg, attn="paged", cache_dtype=jnp.float32,
                 **{**ENGINE, "max_batch": 2}))
    return tcfg, tp, tokens, shared


def _port(tcfg, tp, **kw):
    return ttt.serve(None, tp, tcfg, device="cpu", **{**ENGINE, **kw})


@pytest.mark.parametrize("async_step", [True, False], ids=["async", "sync"])
@pytest.mark.parametrize("attn", ["paged", "gather", "auto"])
def test_greedy_tokens_equal_jax_engine(micro, attn, async_step):
    tcfg, tp, want, _ = micro
    eng = _port(tcfg, tp, attn=attn, async_step=async_step)
    assert _drive(eng, _prompts()) == want
    st = eng.stats()
    assert st["attn"]["mode"] == ("gather" if attn == "gather" else "paged")
    assert st["attn"]["kernel_steps"] == (0 if attn == "gather" else st["decode_steps"])


@pytest.mark.parametrize("async_step", [True, False], ids=["async", "sync"])
@pytest.mark.parametrize("attn", ["paged", "gather"])
def test_shared_prefix_tokens_equal_jax_engine(micro, attn, async_step):
    tcfg, tp, _, want = micro
    got = _drive_shared_prefix(_port(tcfg, tp, attn=attn, async_step=async_step, max_batch=2))
    assert got == want
    assert got[2] == 2                         # sharing actually happened


def test_served_tokens_equal_solo_generate(micro):
    tcfg, tp, want, _ = micro
    for p, row in zip(_prompts(), want):
        solo = tgen.generate(tp, p[None], tcfg, 5, device="cpu")[0]
        assert tuple(solo.tolist()) == row


def test_sliding_window_tokens_equal_jax_engine():
    jcfg, tcfg, jp, tp = _models(sliding_window=5)
    prompts = _prompts(lens=(3, 9))
    want = _drive(tt.serve(None, jp, jcfg, attn="paged", cache_dtype=jnp.float32, **ENGINE),
                  prompts, n=8)
    for attn in ("paged", "gather"):
        assert _drive(_port(tcfg, tp, attn=attn), prompts, n=8) == want


@pytest.mark.parametrize("attn", ["paged", "gather"])
def test_temperature_tokens_same_alone_and_batched(micro, attn):
    tcfg, tp, _, _ = micro
    prompts = _prompts()

    def gen(seed):
        return torch.Generator().manual_seed(seed)

    eng = _port(tcfg, tp, attn=attn, temperature=0.8)
    handles = [eng.submit(p, max_new_tokens=6, generator=gen(10 + i))
               for i, p in enumerate(prompts)]
    eng.drain()
    batched = [h.result(drive=False).new_tokens for h in handles]
    for i, p in enumerate(prompts):
        solo = _port(tcfg, tp, attn=attn, temperature=0.8)
        h = solo.submit(p, max_new_tokens=6, generator=gen(10 + i))
        assert h.result().new_tokens == batched[i]
    assert len(set(batched)) > 1


@pytest.mark.parametrize("attn", ["paged", "gather"])
def test_tokens_invariant_to_sink_block_garbage(micro, attn):
    """Block 0 backs every table's padding; poisoning it mid-run changes
    nothing."""
    tcfg, tp, want, _ = micro
    eng = _port(tcfg, tp, attn=attn)
    handles = [eng.submit(p, max_new_tokens=5) for p in _prompts()]
    for _ in range(3):
        eng.step()
        eng.pool.k_arena[0] = 1e4
        eng.pool.v_arena[0] = -1e4
    eng.drain()
    assert [tuple(h.result(drive=False).tokens.tolist()) for h in handles] == want


def test_cpu_serving_launches_no_kernels_and_counts_geometries(micro):
    tcfg, tp, _, _ = micro
    cudaex.reset_launches()
    eng = _port(tcfg, tp)
    _drive(eng, _prompts())
    assert set(cudaex.LAUNCHES.values()) == {0}
    st = eng.stats()
    assert {k: v for k, v in st["compile_counts"].items() if v} == {"prefill": 1,
                                                                   "decode_paged": 1}
    assert st["tokens_generated"] == 4 * 5 and st["running"] == 0
    assert st["pool_free_blocks"] == eng.pool.num_usable
    assert 0 < st["mean_batch_occupancy"] <= 4


def test_run_results_eos_and_evict(micro):
    tcfg, tp, want, _ = micro
    eos = want[0][LENS[0] + 1]                               # request 0's second token
    eng = _port(tcfg, tp, eos_id=eos)
    res = eng.run(_prompts()[:1], max_new_tokens=5)[0]
    assert res.finish_reason == "eos" and res.new_tokens[-1] == eos
    assert res.ttft_s is not None and res.e2e_s >= res.ttft_s
    eng2 = _port(tcfg, tp)
    h = eng2.submit(_prompts()[3], max_new_tokens=5)
    eng2.step()
    eng2.evict(h)
    assert h.result(drive=False).finish_reason == "evicted"
    assert eng2.pool.num_free == eng2.pool.num_usable
    eng2.shutdown()
    with pytest.raises(RuntimeError, match="shut down"):
        eng2.submit(_prompts()[0], max_new_tokens=2)


@pytest.mark.parametrize("async_step", [True, False], ids=["async", "sync"])
def test_deadline_finishes_a_running_request(micro, async_step):
    tcfg, tp, _, _ = micro
    now = [0.0]
    eng = _port(tcfg, tp, clock=lambda: now[0], async_step=async_step)
    h = eng.submit(_prompts()[1], max_new_tokens=5, deadline=1.0)
    eng.step()
    eng.step()
    now[0] = 2.0
    eng.drain()
    res = h.result(drive=False)
    assert res.finish_reason == "deadline" and 1 <= len(res.new_tokens) < 5
    assert eng.pool.num_free == eng.pool.num_usable


def test_admission_rejects_requests_that_never_fit(micro):
    tcfg, tp, _, _ = micro
    eng = _port(tcfg, tp)
    with pytest.raises(AdmissionError):
        eng.submit(np.zeros(17, np.int32), max_new_tokens=2)   # past the prefill bucket


DEFERRED = [
    ("quantized", True),
    ("mesh", object()), ("shardings", object()),
    ("decode_steps", 2), ("sessions", True), ("priorities", True),
    ("constraints", True), ("fault_plan", object()), ("trace", True), ("slo", {"ttft_s": 1}),
    ("flight_recorder", True), ("goodput", True), ("telemetry", "run.jsonl"),
    ("replicas", 2), ("model_fn", lambda *a: None),
]


@pytest.mark.parametrize("name,value", DEFERRED, ids=[d[0] for d in DEFERRED])
def test_out_of_slice_engine_options_raise(micro, name, value):
    tcfg, tp, _, _ = micro
    with pytest.raises(NotImplementedError, match=name):
        if name == "model_fn":
            ttt.serve(value, tp, tcfg, device="cpu", **ENGINE)
        else:
            _port(tcfg, tp, **{name: value})


@pytest.mark.parametrize("name", ["session_id", "priority", "constraint"])
def test_out_of_slice_submit_options_raise(micro, name):
    tcfg, tp, _, _ = micro
    with pytest.raises(NotImplementedError, match=name):
        _port(tcfg, tp).submit(_prompts()[0], max_new_tokens=2, **{name: "x"})


def test_out_of_slice_configs_raise():
    moe = ttt.Config.from_name("tiny-moe-debug")
    with pytest.raises(NotImplementedError, match="MoE"):
        ServingEngine({"wte": torch.zeros(1)}, moe, device="cpu")
    gpt = ttt.Config.from_name("nanogpt-debug")
    with pytest.raises(NotImplementedError, match="learned_pos_embedding"):
        ServingEngine({"wte": torch.zeros(1)}, gpt, device="cpu")


def test_serve_defaults_to_the_card(micro):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    tcfg, tp, _, _ = micro
    with pytest.raises(RuntimeError, match="NVIDIA GPU"):
        ttt.serve(None, tp, tcfg, **ENGINE)
    with pytest.raises(ValueError, match="params live on"):
        ttt.serve(None, tp, tcfg, device="meta", **ENGINE)


def test_engine_publishes_serving_metrics(micro):
    from thunder_tpu_torch.observability import registry

    tcfg, tp, _, _ = micro
    reg = registry()
    reg.reset()
    eng = _port(tcfg, tp)
    _drive(eng, _prompts())
    snap = reg.snapshot("serving.")
    assert snap["serving.tokens"] == 20
    assert snap["serving.requests.completed"] == 4
    assert snap["serving.finish.length"] == 4
    assert snap["serving.ttft_s"]["count"] == 4 and snap["serving.ttft_s"]["p50"] > 0
    assert snap["serving.attn.kernel_steps"] == eng.stats()["attn"]["kernel_steps"]
    reg.reset()
    assert reg.snapshot("serving.")["serving.tokens"] == 0
    assert eng._m_tokens is reg.counter("serving.tokens")     # handles survive reset


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_engine_decodes_through_the_kernels(card, dtype):
    """On the card the paged engine launches n_layer attention kernels and
    two writes per decode step, and serves the gather engine's tokens."""
    cfg = ttt.Config.from_name("tiny-llama-debug", n_embd=256)      # hs 64
    params = ttt.init_params(cfg, generator=torch.Generator(card).manual_seed(0),
                             dtype=dtype, device=card)
    prompts = _prompts(lens=(3, 17, 30, 9))

    def run(attn):
        eng = ttt.serve(None, params, cfg, attn=attn, device=card, block_size=16,
                        num_blocks=32, max_batch=4)
        cudaex.reset_launches()
        toks = _drive(eng, prompts, n=6)
        torch.cuda.synchronize()
        return toks, dict(cudaex.LAUNCHES), eng.decode_steps

    paged, launches, steps = run("paged")
    gather, none, _ = run("gather")
    assert launches == {**dict.fromkeys(cudaex.LAUNCHES, 0),
                        "paged_attn_decode": steps * cfg.n_layer, "paged_token_write": steps * 2}
    assert set(none.values()) == {0}
    if dtype == torch.float32:
        assert paged == gather


@pytest.mark.cuda
def test_cuda_tiny_llama_serves_paged_at_its_own_head_size(card):
    """tiny-llama-debug at its own hs 16 (no longer widened to a 64/128/256
    head): the default attn resolves paged on the card, every decode step
    goes through the kernels, and the float32 tokens equal gather's."""
    cfg = ttt.Config.from_name("tiny-llama-debug")
    assert cfg.head_size == 16
    params = ttt.init_params(cfg, generator=torch.Generator(card).manual_seed(0),
                             dtype=torch.float32, device=card)
    prompts = _prompts(lens=(3, 17, 30, 9))

    def run(attn):
        eng = ttt.serve(None, params, cfg, attn=attn, device=card, block_size=16,
                        num_blocks=32, max_batch=4)
        cudaex.reset_launches()
        toks = _drive(eng, prompts, n=6)
        torch.cuda.synchronize()
        return toks, dict(cudaex.LAUNCHES), eng

    paged, launches, eng = run("auto")
    assert eng.attn == "paged"
    assert launches["paged_attn_decode"] == eng.decode_steps * cfg.n_layer > 0
    gather, _, _ = run("gather")
    assert paged == gather


def test_paged_supported_declines_what_the_kernels_cannot_hold():
    """On the card the paged path declines, with the reason, a head size
    whose decode block does not fit shared memory; the CPU (plain versions)
    takes it; tiny-llama-debug's hs 16 fits."""
    from thunder_tpu_torch.serving.paged_attention import paged_supported

    tiny = ttt.Config.from_name("tiny-llama-debug")
    assert paged_supported(tiny, block_size=16, device="cuda") == (True, "")
    wide = ttt.Config.from_name("tiny-llama-debug", n_embd=8192, n_head=2, n_query_groups=1)
    assert wide.head_size == 4096
    ok, why = paged_supported(wide, block_size=16, device="cuda")
    assert not ok and "paged_attn_decode needs" in why and "hs=4096" in why
    assert paged_supported(wide, block_size=16, device="cpu") == (True, "")
    assert cudaex.paged_kernels_decline(4, 16, 4096).startswith("paged_attn_decode needs")
    assert cudaex.paged_kernels_decline(4, 16, 80) == ""


def test_auto_serves_gather_where_paged_declines(micro, monkeypatch):
    """attn="auto" falls back to the gather path where ``paged_supported``
    declines (as on the card for a head size the kernels cannot hold);
    attn="paged" raises at construction with the reason."""
    from thunder_tpu_torch.serving import engine as engine_mod

    tcfg, tp, _, _ = micro
    monkeypatch.setattr(engine_mod, "paged_supported", lambda cfg, **kw: (False, "too wide"))
    eng = _port(tcfg, tp)
    assert eng.attn == "gather"
    kinds = eng.stats()["attn"]["kinds"]
    assert kinds["decode"]["fallback_reason"] == kinds["prefill_chunk"]["fallback_reason"] \
        == "too wide"
    assert _drive(eng, _prompts()) == micro[2]                # the reference's tokens
    with pytest.raises(ValueError, match="too wide"):
        _port(tcfg, tp, attn="paged")
