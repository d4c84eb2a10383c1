"""thunder_tpu_torch multi-step decode (``decode_steps=N``) against the JAX engine's, on the CPU.

The bar is token-exact for greedy requests: the port's engine at
``decode_steps=N`` serves the JAX engine's ``decode_steps=N`` tokens (paged
with the Pallas kernels interpreted, and gather) across N in {2, 3, 4},
int8 KV, a LoRA mix, prefix sharing, chunked prefill and a sliding window,
with ``tests/test_torch_port_serving.py``'s micro config and buckets.  A
request that finishes inside a visit stops there (EOS with a poisoned sink
block, lengths on and just inside a visit boundary, a deadline at a visit
boundary).  At temperature > 0 the port's tokens at N equal its tokens at
N = 1 for the same generators.  The step bookkeeping (``_static_key``, the
bucket bound, host visits) follows the reference; on the card a
``cuda``-marked test holds every bucket step's graph replay bitwise against
the eager step and the launch counts per replay.
"""
from __future__ import annotations

import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import thunder_tpu as tt
import thunder_tpu_torch as ttt
from thunder_tpu.models import llama as jllama
from thunder_tpu.serving import AdapterRegistry as JRegistry
from thunder_tpu_torch.executors import cudaex
from thunder_tpu_torch.serving.lora import _target_features
from torch_port_threads import one_torch_thread  # noqa: F401

MICRO = dict(
    n_layer=2, n_head=4, n_query_groups=2, n_embd=32,
    intermediate_size=64, vocab_size=64, block_size=64,
)
BUCKETS = dict(batch_buckets=(4,), block_buckets=(8,), prefill_buckets=(16,))
ENGINE = dict(block_size=4, num_blocks=32, max_batch=4, **BUCKETS)
LENS = (3, 5, 9, 14)


@pytest.fixture(scope="module", autouse=True)
def _leave_jax_caches_as_found():
    """The JAX package memoizes compiled programs in bounded module caches
    that other test files count; leave them exactly as found."""
    from thunder_tpu.models import generate as jgen
    from thunder_tpu.serving import engine as jengine

    before = dict(jengine._program_cache), dict(jgen._generate_cache)
    yield
    for cache, saved in zip((jengine._program_cache, jgen._generate_cache), before):
        cache.clear()
        cache.update(saved)


def _models(**overrides):
    jcfg = jllama.Config.from_name("tiny-llama-debug", **MICRO, **overrides)
    tcfg = ttt.Config.from_name("tiny-llama-debug", **MICRO, **overrides)
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = ttt.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _prompts(lens=LENS, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 64, (n,)).astype(np.int32) for n in lens]


def _drive(eng, prompts, n=6, **submit_kw):
    handles = [eng.submit(p, max_new_tokens=n, **submit_kw) for p in prompts]
    eng.drain()
    return [tuple(int(t) for t in h.result(drive=False).tokens) for h in handles]


def _jax(jcfg, jp, **kw):
    return tt.serve(None, jp, jcfg, cache_dtype=jnp.float32, **{**ENGINE, **kw})


def _port(tcfg, tp, **kw):
    return ttt.serve(None, tp, tcfg, device="cpu", **{**ENGINE, **kw})


@pytest.fixture(scope="module")
def micro():
    return _models()


@pytest.fixture(scope="module")
def ref_tokens(micro):
    """The JAX engine's gather tokens at decode_steps 1..4, served once."""
    jcfg, _, jp, _ = micro
    return {N: _drive(_jax(jcfg, jp, attn="gather", decode_steps=N), _prompts())
            for N in (1, 2, 3, 4)}


@pytest.mark.parametrize("attn", ["paged", "gather"])
@pytest.mark.parametrize("N", [2, 3, 4])
def test_greedy_tokens_equal_jax_engine(micro, ref_tokens, N, attn):
    _, tcfg, _, tp = micro
    eng = _port(tcfg, tp, attn=attn, decode_steps=N)
    assert _drive(eng, _prompts()) == ref_tokens[N] == ref_tokens[1]
    st = eng.stats()
    assert st["decode_steps_per_visit"] == N
    kind = "decode_multi_paged" if attn == "paged" else "decode_multi"
    assert {k: v for k, v in st["compile_counts"].items() if v} == {"prefill": 1, kind: 1}


def test_paged_tokens_equal_jax_paged_engine(micro):
    """The JAX engine's paged multi-step program (its Pallas kernels run
    interpreted) against the port's paged engine, N = 4."""
    jcfg, tcfg, jp, tp = micro
    prompts = _prompts(lens=(3, 7))
    want = _drive(_jax(jcfg, jp, attn="paged", decode_steps=4, max_batch=2), prompts)
    assert _drive(_port(tcfg, tp, attn="paged", decode_steps=4, max_batch=2), prompts) == want


@pytest.mark.parametrize("async_step", [True, False], ids=["async", "sync"])
def test_sync_loop_serves_the_same_tokens(micro, ref_tokens, async_step):
    _, tcfg, _, tp = micro
    assert _drive(_port(tcfg, tp, decode_steps=3, async_step=async_step),
                  _prompts()) == ref_tokens[3]


@pytest.mark.parametrize("attn", ["paged", "gather"])
def test_int8_kv_tokens_equal_jax_engine(micro, attn):
    jcfg, tcfg, jp, tp = micro
    want = _drive(_jax(jcfg, jp, attn="gather", kv_dtype="int8", decode_steps=4), _prompts())
    got = _drive(_port(tcfg, tp, attn=attn, kv_dtype="int8", decode_steps=4), _prompts())
    assert got == want


def _factors(cfg, seed, targets, std=0.5, rank=2):
    rng = np.random.default_rng(seed)
    out = {}
    for t in targets:
        fin, fout = _target_features(cfg, t)
        out[t] = ((rng.standard_normal((cfg.n_layer, rank, fin)) * std).astype(np.float32),
                  (rng.standard_normal((cfg.n_layer, fout, rank)) * std).astype(np.float32))
    return out


@pytest.mark.parametrize("attn", ["paged", "gather"])
def test_lora_mix_tokens_equal_jax_engine(micro, attn):
    jcfg, tcfg, jp, tp = micro
    targets = ("wq", "wv", "fc_1")
    jreg = JRegistry(jcfg, rank=2, max_adapters=2, targets=targets)
    treg = ttt.AdapterRegistry(tcfg, rank=2, max_adapters=2, targets=targets, device="cpu")
    f = _factors(tcfg, 9, targets)
    jreg.register("alice", f)
    treg.register("alice", f)
    prompts = _prompts(lens=(3, 6))

    def serve(eng, ids=("alice", None)):
        hs = [eng.submit(p, max_new_tokens=6, adapter_id=a) for p, a in zip(prompts, ids)]
        eng.drain()
        return [tuple(h.result(drive=False).tokens.tolist()) for h in hs]

    want = serve(_jax(jcfg, jp, attn="gather", lora=jreg, decode_steps=4))
    eng = _port(tcfg, tp, attn=attn, lora=treg, decode_steps=4)
    assert serve(eng) == want
    assert serve(eng, ids=(None, None))[0] != want[0]              # the adapter acts


def test_prefix_sharing_tokens_equal_jax_engine(micro):
    jcfg, tcfg, jp, tp = micro
    base = _prompts(lens=(14,))[0]
    shared = [np.concatenate([base, np.array([1], np.int32)]),
              np.concatenate([base, np.array([2], np.int32)])]
    want = _drive(_jax(jcfg, jp, attn="gather", decode_steps=4), shared)
    eng = _port(tcfg, tp, decode_steps=4)
    assert _drive(eng, shared) == want
    assert eng.stats()["prefix_hits"] >= 1


def test_chunked_prefill_tokens_equal_jax_engine(micro):
    jcfg, tcfg, jp, tp = micro
    rng = np.random.default_rng(3)
    long = [rng.integers(0, 64, (22,)).astype(np.int32), _prompts(lens=(5,))[0]]
    kw = dict(prefill_chunk=8, prefill_buckets=(8, 16), block_buckets=(12,))
    want = _drive(_jax(jcfg, jp, attn="gather", decode_steps=4, **kw), long)
    eng = _port(tcfg, tp, decode_steps=4, **kw)
    assert _drive(eng, long) == want
    assert eng.stats()["attn"]["kinds"]["prefill_chunk"]["mode"] == "paged"
    assert eng.stats()["chunk_runs"] >= 2


@pytest.mark.parametrize("attn", ["paged", "gather"])
def test_sliding_window_tokens_equal_jax_engine(attn):
    jcfg, tcfg, jp, tp = _models(sliding_window=8)
    want = _drive(_jax(jcfg, jp, attn="gather", decode_steps=4), _prompts(), n=10)
    assert _drive(_port(tcfg, tp, attn=attn, decode_steps=4), _prompts(), n=10) == want


#
# stopping at and inside the visit boundary
#


@pytest.mark.parametrize("attn", ["paged", "gather"])
def test_eos_inside_visit_with_poisoned_sink(micro, ref_tokens, attn):
    """A request meeting EOS at step k < N stops there, and its later
    iterations write to the sink: poisoning the sink mid-run changes no
    token, and the co-running request is undisturbed."""
    jcfg, tcfg, jp, tp = micro
    prompts = _prompts(lens=(3, 7))
    one = _drive(_jax(jcfg, jp, attn="gather", max_batch=2), prompts, n=8)
    eos = int(one[0][len(prompts[0]) + 2])             # request 0's third token
    want = _drive(_jax(jcfg, jp, attn="gather", max_batch=2, eos_id=eos, decode_steps=4),
                  prompts, n=8)
    assert len(want[0]) < len(one[0])                  # EOS fired early
    eng = _port(tcfg, tp, attn=attn, max_batch=2, eos_id=eos, decode_steps=4, async_step=False)
    handles = [eng.submit(p, max_new_tokens=8) for p in prompts]
    for _ in range(3):
        eng.step()
        eng.pool.k_arena[0] = 997.0
        eng.pool.v_arena[0] = -997.0
    eng.drain()
    assert [tuple(h.result(drive=False).tokens.tolist()) for h in handles] == want
    assert handles[0].result(drive=False).finish_reason == "eos"


@pytest.mark.parametrize("n,visits", [(9, 2), (8, 2)], ids=["on", "inside"])
def test_length_on_and_inside_visit_boundary(micro, n, visits):
    """9 tokens = 1 (prefill) + two full visits of 4; 8 leaves the last
    iteration of the second visit dead.  Never more than max_new_tokens."""
    jcfg, tcfg, jp, tp = micro
    prompt = _prompts(lens=(5,))
    want = _drive(_jax(jcfg, jp, attn="gather", decode_steps=4), prompt, n=n)
    eng = _port(tcfg, tp, decode_steps=4)
    h = eng.submit(prompt[0], max_new_tokens=n)
    eng.drain()
    res = h.result(drive=False)
    assert (tuple(res.tokens.tolist()),) == tuple(want)
    assert res.finish_reason == "length" and len(res.new_tokens) == n
    assert eng.stats()["host_visits"] == visits


def test_deadline_at_visit_boundary_serves_no_extra_tokens(micro):
    _, tcfg, _, tp = micro
    now = [0.0]
    p = _prompts(lens=(5,))[0]
    eng = _port(tcfg, tp, decode_steps=4, clock=lambda: now[0])
    h = eng.submit(p, max_new_tokens=24, deadline=5.0)
    for _ in range(3):
        eng.step()
    now[0] = 10.0                                      # the deadline passes mid-stream
    eng.drain()
    res = h.result(drive=False)
    assert res.finish_reason == "deadline"
    gen = len(res.new_tokens)
    assert 0 < gen < 24 and (gen - 1) % 4 == 0         # whole visits after token 0
    full = _drive(_port(tcfg, tp), [p], n=24)[0]
    assert tuple(res.tokens.tolist()) == full[:len(p) + gen]


#
# temperature: within the port
#


@pytest.mark.parametrize("attn", ["paged", "gather"])
def test_temperature_tokens_equal_one_step(micro, attn):
    _, tcfg, _, tp = micro

    def serve(N, **kw):
        eng = _port(tcfg, tp, attn=attn, temperature=0.8, decode_steps=N, **kw)
        hs = [eng.submit(p, max_new_tokens=7, generator=torch.Generator().manual_seed(10 + i))
              for i, p in enumerate(_prompts())]
        eng.drain()
        return [h.result(drive=False).new_tokens for h in hs], [h._req.generator for h in hs]

    one, g1 = serve(1)
    for N in (2, 4):
        assert serve(N)[0] == one
    eos = int(one[0][2])
    one_eos, g1 = serve(1, eos_id=eos)
    four_eos, g4 = serve(4, eos_id=eos)
    assert four_eos == one_eos and len(one_eos[0]) == 3
    # a row that died of EOS inside a visit drew nothing more
    assert all(torch.equal(a.get_state(), b.get_state()) for a, b in zip(g1, g4))


#
# the step bookkeeping
#


def test_static_key_collapses_one_step_and_bucket_bound_holds(micro):
    _, tcfg, _, tp = micro
    default, one, four = _port(tcfg, tp), _port(tcfg, tp, decode_steps=1), \
        _port(tcfg, tp, decode_steps=4)
    assert default._static_key() == one._static_key()
    # the horizon, then the constraint knob (None: unconstrained)
    assert four._static_key() != default._static_key() and four._static_key()[-2:] == (4, None)
    _drive(four, _prompts())
    st = four.stats()
    decode = sum(st["compile_counts"][k] for k in ("decode", "decode_paged", "decode_multi",
                                                   "decode_multi_paged"))
    assert 1 <= decode <= st["bucket_bound"]
    assert st["graphs"] == {"enabled": False, "captures": {}, "replays": 0, "capture_s": 0}
    with pytest.raises(ValueError, match="decode_steps"):
        _port(tcfg, tp, decode_steps=0)


FREE_CASES = {
    "gather": dict(attn="gather"),
    "paged multi": dict(attn="paged", decode_steps=3),
    "chunked int8": dict(attn="paged", prefill_chunk=8, prefill_buckets=(8, 16),
                         kv_dtype="int8"),
    "speculative temperature": dict(attn="paged", spec=True, temperature=0.7, num_blocks=64),
    "faulted, observed": dict(attn="paged", fault="oom", trace=True, slo=True, goodput=True,
                              flight_recorder=True),
}


@pytest.mark.parametrize("case", sorted(FREE_CASES))
def test_dropped_engine_frees_without_the_collector(micro, case):
    """An engine forms no reference cycle with its steps, its flight
    recorder or a fault it absorbed: dropped after a serve, it is freed at
    once with the collector paused (on the card its graphs release their
    pool then, never inside another engine's capture)."""
    _, tcfg, _, tp = micro
    kw = dict(FREE_CASES[case])
    if kw.pop("spec", False):
        kw["speculative"] = ttt.SpecConfig(tp, tcfg, K=2)
    if kw.pop("fault", None):
        kw["fault_plan"] = ttt.serving.FaultPlan(
            specs=[ttt.serving.FaultSpec(point="decode.dispatch", kind="oom", at=2)])
    gc.collect()
    gc.disable()
    try:
        eng = _port(tcfg, tp, **kw)
        assert len(_drive(eng, _prompts(), n=5)) == len(LENS)
        ref = weakref.ref(eng)
        del eng
        assert ref() is None
    finally:
        gc.enable()


def test_multi_step_amortizes_host_visits(micro):
    _, tcfg, _, tp = micro
    e1, e4 = _port(tcfg, tp), _port(tcfg, tp, decode_steps=4)
    assert _drive(e1, _prompts(), n=9) == _drive(e4, _prompts(), n=9)
    s1, s4 = e1.stats(), e4.stats()
    assert s1["host_visits"] == s1["decode_steps"]
    v1 = s1["host_visits"] / s1["tokens_generated"]
    v4 = s4["host_visits"] / s4["tokens_generated"]
    assert v4 <= v1 / 4 * 1.1
    assert s4["tokens_per_host_visit"] > s1["tokens_per_host_visit"]


def test_speculative_rejects_a_horizon_with_the_reason(micro):
    _, tcfg, _, tp = micro
    ok, why = ttt.serving.speculative.multi_step_supported(ttt.SpecConfig(tp, tcfg, K=2))
    assert not ok and "data-dependent" in why
    with pytest.raises(ValueError, match="unsupported.*data-dependent"):
        _port(tcfg, tp, decode_steps=4, speculative=ttt.SpecConfig(tp, tcfg, K=2),
              num_blocks=64)


#
# on the card: graph replay against the eager step
#


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs and the CUDA kernels have no CPU mode")
    return torch.device("cuda")


CARD_CASES = {
    "decode_paged": dict(attn="paged"),
    "decode": dict(attn="gather"),
    "decode_multi_paged": dict(attn="paged", decode_steps=3),
    "decode_multi": dict(attn="gather", decode_steps=3),
    "int8 multi": dict(attn="paged", decode_steps=4, kv_dtype="int8"),
    "temperature": dict(attn="paged", temperature=0.8),
    "temperature multi": dict(attn="paged", temperature=0.8, decode_steps=2),
    "chunked": dict(attn="paged", prefill_chunk=16, prefill_buckets=(16, 32),
                    block_buckets=(8, 16)),
    "speculative": dict(attn="paged", spec=True),
    "speculative gather": dict(attn="gather", spec=True),
    "speculative temperature": dict(attn="paged", spec=True, temperature=0.8),
    "lora": dict(attn="paged", lora=True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_cuda_graph_replay_equals_eager_step(card, case):
    """tiny-llama-debug at hs 64 in float32 on the card: the engine with
    its bucket steps captured as CUDA graphs serves, bitwise, the tokens of
    the same engine run eagerly; every graph kind the serve ran captured
    once per bucket, later steps replayed, and the kernel launches equal
    the eager run's (each replay adds its capture's launches)."""
    kw = dict(CARD_CASES[case])
    cfg = ttt.Config.from_name("tiny-llama-debug", n_embd=256)
    params = ttt.init_params(cfg, generator=torch.Generator(card).manual_seed(0),
                             dtype=torch.float32, device=card)
    if kw.pop("spec", False):
        dcfg = ttt.Config.from_name("tiny-llama-debug", n_embd=256, n_layer=1)
        dparams = {**params, "blocks": params["blocks"][:1]}
        kw["speculative"] = ttt.SpecConfig(dparams, dcfg, K=3)
    lora = kw.pop("lora", False)
    prompts = _prompts(lens=(3, 17, 30, 9))

    def run(graphs):
        extra = {}
        if lora:
            reg = ttt.AdapterRegistry(cfg, rank=4, max_adapters=2, device=card)
            reg.register("a", ttt.make_lora_factors(cfg, 4, torch.Generator(card).manual_seed(1)))
            extra["lora"] = reg
        eng = ttt.ServingEngine(params, cfg, device=card, block_size=16, num_blocks=64,
                                max_batch=4, _graphs=graphs, **kw, **extra)
        cudaex.reset_launches()
        handles = [eng.submit(p, max_new_tokens=10, adapter_id="a" if lora and i % 2 else None,
                              generator=torch.Generator(card).manual_seed(i))
                   for i, p in enumerate(prompts)]
        eng.drain()
        torch.cuda.synchronize()
        return ([h.result(drive=False).new_tokens for h in handles], dict(cudaex.LAUNCHES),
                eng.stats())

    eager, eager_launches, est = run(False)
    graphed, launches, st = run(True)
    assert graphed == eager
    assert launches == eager_launches
    assert est["graphs"]["captures"] == {} and est["graphs"]["replays"] == 0
    caps = st["graphs"]["captures"]
    assert caps and all(n == st["compile_counts"][k] for k, n in caps.items())
    assert st["graphs"]["replays"] > 0


@pytest.mark.cuda
def test_cuda_graph_outputs_survive_another_graphs_replay(card):
    """Two steps captured into one pool: the second's output stays intact
    when the first, captured before it, replays between the second's
    replay and the read of its output (the first's intermediates are
    freed pool memory the second's capture may take)."""
    from thunder_tpu_torch.serving.graphs import StepGraph

    pool = torch.cuda.graph_pool_handle()
    n = 1 << 20

    def first(x, host):
        scratch = x["a"] * 3.0                             # an intermediate, freed after
        return {"s": scratch.sum()[None]}, {}

    def second(x, host):
        return {"y": x["a"] + 1.0}, {}

    graphs = [StepGraph(fn, kind=k, bucket=(n, 1), device=card, pool=pool, versions=tuple)
              for fn, k in ((first, "first"), (second, "second"))]
    a = torch.arange(n, dtype=torch.float32, device=card)
    for g in graphs:                                       # warm-up, then capture
        g({"a": a})
    graphs[1]({"a": a})
    y = graphs[1]._out["y"]
    graphs[0]({"a": torch.full((n,), 7.0, device=card)})
    torch.cuda.synchronize()
    assert [g.captures for g in graphs] == [1, 1] and [g.replays for g in graphs] == [1, 1]
    assert torch.equal(y, a + 1.0)


@pytest.mark.cuda
def test_cuda_chunk_replay_between_decode_dispatch_and_harvest(card):
    """Async paged chunked serving with graphs: a later prompt's chunk
    pieces replay their graph while a decode step is in flight, before its
    harvest reads the decode graph's tokens; the tokens equal the eager
    engine's."""
    cfg = ttt.Config.from_name("tiny-llama-debug", n_embd=256)
    params = ttt.init_params(cfg, generator=torch.Generator(card).manual_seed(0),
                             dtype=torch.float32, device=card)
    short, long = _prompts(lens=(5, 9)), _prompts(lens=(40, 50, 45), seed=1)

    def run(graphs):
        eng = ttt.ServingEngine(params, cfg, device=card, attn="paged", block_size=16,
                                num_blocks=64, max_batch=4, prefill_chunk=16,
                                prefill_buckets=(16, 32), block_buckets=(8, 16), _graphs=graphs)
        seen = []
        piece = eng._chunk_piece

        def logged(kind, *args):
            prog = eng._programs.get((eng._static_key(), kind, len(args[0]), len(args[2])))
            replay = getattr(prog, "replays", None)
            out = piece(kind, *args)
            if replay is not None and prog.replays > replay:
                seen.append(eng._inflight_decode is not None)
            return out

        eng._chunk_piece = logged
        handles = [eng.submit(p, max_new_tokens=16) for p in short]
        while not all(len(h._req.generated) >= 2 for h in handles):
            eng.step()
        handles += [eng.submit(p, max_new_tokens=8) for p in long]
        eng.drain()
        torch.cuda.synchronize()
        return [h.result(drive=False).new_tokens for h in handles], seen

    eager, _ = run(False)
    graphed, seen = run(True)
    assert any(seen), "no chunk piece replayed while a decode step was in flight"
    assert graphed == eager


#
# the model families beside Llama, against the JAX engine
#

FAMILIES = ["tiny-mistral-debug", "tiny-falcon-debug", "tiny-pythia-debug", "tiny-gemma-debug"]
FAMILY_ENGINE = dict(block_size=4, num_blocks=48, max_batch=4, batch_buckets=(4,),
                     block_buckets=(16,), prefill_buckets=(32,))


def family_models(name):
    """One layer of ``name`` at its own widths, the same weights on both
    sides."""
    jcfg = jllama.Config.from_name(name, n_layer=1)
    tcfg = ttt.Config.from_name(name, n_layer=1)
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(3), dtype=jnp.float32)
    tp = ttt.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def family_prompts():
    """Three prompts of vocabulary 256; the longest with its 8 new tokens
    crosses tiny-mistral-debug's 32-token window."""
    rng = np.random.default_rng(7)
    return [rng.integers(0, 256, (n,)).astype(np.int32) for n in (5, 17, 30)]


@pytest.mark.parametrize("name", FAMILIES)
def test_family_multistep_tokens_equal_jax_engine(name):
    """``decode_steps=3`` on the paged lane serves the JAX engine's tokens
    for the Mistral (window crossed), Falcon (one query group, parallel
    residual), Pythia (partial rotary) and Gemma (scaled embedding)
    families."""
    jcfg, tcfg, jp, tp = family_models(name)
    prompts = family_prompts()
    jeng = tt.serve(None, jp, jcfg, cache_dtype=jnp.float32, attn="gather", decode_steps=3,
                    **FAMILY_ENGINE)
    want = _drive(jeng, prompts, n=8)
    eng = ttt.serve(None, tp, tcfg, device="cpu", attn="paged", decode_steps=3,
                    **FAMILY_ENGINE)
    assert _drive(eng, prompts, n=8) == want
    assert eng.stats()["attn"]["kinds"]["decode"]["kernel_steps"] > 0
