"""thunder_tpu_torch chunked prefill and speculative serving against the JAX package.

On the CPU, with the tiny config and buckets of ``tests/test_ragged_chunk.py``
and ``tests/test_serving_spec.py`` and JAX weights carried over with
``params_from_numpy``:

- ``forward_paged`` at T > 1 (the verify / chunk forward) against the JAX
  ``forward_paged`` (Pallas interpreted off-TPU): float32 logits atol 1e-5
  (the same math in another summation order, logits of magnitude ~1);
- ``write_fresh_kv_masked``, ``write_fresh_kv_chunk`` and
  ``write_fresh_kv_live`` against their JAX counterparts, bitwise outside
  sink block 0;
- the acceptance rule fed the uniforms JAX drew from the same key: the same
  accepted length and the same residual distribution; its output
  distribution is the target's;
- served greedy tokens, exactly: the port's chunked engine against the JAX
  engine with ``prefill_chunk`` and ``attn="paged"`` and against the port's
  unchunked engine; the port's speculative engine against the JAX
  speculative engine and the port's plain engine;
- the per-kind chunk resolution, with its reasons, and the speculative
  options' validation.

Sampling is checked within the port: a request's speculative tokens are the
same alone and batched and equal solo ``speculative_generate`` with the same
generator seed.  Tests marked ``cuda`` serve through the kernels on the card.
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
from thunder_tpu.models import speculative as jspec
from thunder_tpu.serving import SpecConfig as JSpecConfig
from thunder_tpu.serving import paged_attention as jpa
from thunder_tpu_torch.executors import cudaex
from thunder_tpu_torch.models import generate as tgen
from thunder_tpu_torch.models import speculative as tspec
from thunder_tpu_torch.serving import paged_attention as tpa
from torch_port_threads import one_torch_thread  # noqa: F401

MICRO = dict(
    n_layer=2, n_head=4, n_query_groups=2, n_embd=32,
    intermediate_size=64, vocab_size=64, block_size=64,
)
# chunked engines: chunk 8 over block size 4, every boundary block-aligned
CHUNKED = dict(block_size=4, num_blocks=32, max_batch=4, batch_buckets=(4,),
               block_buckets=(6, 12), prefill_buckets=(8, 16), prefill_chunk=8)
SPEC = dict(block_size=4, num_blocks=64, max_batch=4, batch_buckets=(4,), block_buckets=(8,),
            prefill_buckets=(16,))
CHUNK_LENS = (13, 21, 9)


def _pair(seed=0, **overrides):
    jcfg = jllama.Config.from_name("tiny-llama-debug", **{**MICRO, **overrides})
    tcfg = ttt.Config.from_name("tiny-llama-debug", **{**MICRO, **overrides})
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(seed), dtype=jnp.float32)
    tp = ttt.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _prompts(lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 64, (n,)).astype(np.int32) for n in lens]


def _drive(eng, prompts, n=5, **submit_kw):
    handles = [eng.submit(p, max_new_tokens=n, **submit_kw) for p in prompts]
    eng.drain()
    return [tuple(int(t) for t in h.result(drive=False).tokens) for h in handles]


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
def target():
    return _pair()


@pytest.fixture(scope="module")
def draft():
    return _pair(seed=9, n_layer=1)


def _port(tcfg, tp, **kw):
    return ttt.serve(None, tp, tcfg, device="cpu", **kw)


#
# the model step at T > 1 and the three commits, against the JAX functions
#


def _arena_case(tcfg, B, T, pos, nbb=6, num_blocks=24, seed=3):
    rng = np.random.default_rng(seed)
    L, ng, hs, bs = tcfg.n_layer, tcfg.n_query_groups, tcfg.head_size, 4
    shape = (num_blocks, L, ng, bs, hs)
    tables = np.zeros((B, nbb), np.int32)
    free = rng.permutation(np.arange(1, num_blocks))
    k = 0
    for i, p in enumerate(pos):
        n = -(-(int(p) + T) // bs)
        tables[i, :n] = free[k:k + n]
        k += n
    return dict(k=rng.standard_normal(shape).astype(np.float32),
                v=rng.standard_normal(shape).astype(np.float32),
                tables=tables, pos=np.asarray(pos, np.int32),
                idx=rng.integers(0, 64, (B, T)).astype(np.int32))


@pytest.mark.parametrize("B,T,pos", [(4, 3, [0, 5, 8, 13]), (1, 8, [8])],
                         ids=["verify", "chunk"])
def test_forward_paged_multi_token_matches_jax(target, B, T, pos):
    jcfg, tcfg, jp, tp = target
    c = _arena_case(tcfg, B, T, pos)
    cap = c["tables"].shape[1] * 4
    jcos, jsin = jllama.build_rope_cache(jcfg, cap)
    want_logits, want_fresh = jpa.forward_paged(
        jp, jnp.asarray(c["idx"]), jnp.asarray(c["pos"]),
        {"k": jnp.asarray(c["k"]), "v": jnp.asarray(c["v"])}, jnp.asarray(c["tables"]),
        jcos, jsin, jcfg, cdtype=jnp.float32)
    tcos, tsin = ttt.models.llama.build_rope_cache(tcfg, cap, device="cpu")
    logits, fresh = tpa.forward_paged(
        tp, torch.as_tensor(c["idx"]), torch.as_tensor(c["pos"]),
        {"k": torch.as_tensor(c["k"]), "v": torch.as_tensor(c["v"])},
        torch.as_tensor(c["tables"]), tcos, tsin, tcfg, cdtype=torch.float32)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), atol=1e-5, rtol=0)
    for name in ("k", "v"):
        assert fresh[name].shape == (B, tcfg.n_layer, tcfg.n_query_groups, T, tcfg.head_size)
        np.testing.assert_allclose(fresh[name].numpy(), np.asarray(want_fresh[name]),
                                   atol=1e-5, rtol=0)
    _, no_head = tpa.forward_paged(
        tp, torch.as_tensor(c["idx"]), torch.as_tensor(c["pos"]),
        {"k": torch.as_tensor(c["k"]), "v": torch.as_tensor(c["v"])},
        torch.as_tensor(c["tables"]), tcos, tsin, tcfg, cdtype=torch.float32, head=False)
    assert torch.equal(no_head["k"], fresh["k"])


def _fresh(tcfg, B, T, seed=4):
    rng = np.random.default_rng(seed)
    shape = (B, tcfg.n_layer, tcfg.n_query_groups, T, tcfg.head_size)
    return {n: rng.standard_normal(shape).astype(np.float32) for n in ("k", "v")}


def _both_arenas(c):
    return ({n: jnp.asarray(c[n]) for n in ("k", "v")},
            {n: torch.as_tensor(c[n].copy()) for n in ("k", "v")})


def test_write_fresh_kv_masked_matches_jax(target):
    _, tcfg, _, _ = target
    c = _arena_case(tcfg, 4, 5, [0, 5, 8, 13])
    fresh = _fresh(tcfg, 4, 5)
    n_emit = np.asarray([0, 5, 2, 1], np.int32)
    ja, ta = _both_arenas(c)
    want = jpa.write_fresh_kv_masked(ja, {n: jnp.asarray(v) for n, v in fresh.items()},
                                     jnp.asarray(c["tables"]), jnp.asarray(c["pos"]),
                                     jnp.asarray(n_emit), block_size=4)
    got = tpa.write_fresh_kv_masked(ta, {n: torch.as_tensor(v) for n, v in fresh.items()},
                                    torch.as_tensor(c["tables"]), torch.as_tensor(c["pos"]),
                                    torch.as_tensor(n_emit), block_size=4)
    for n in ("k", "v"):
        np.testing.assert_array_equal(got[n].numpy()[1:], np.asarray(want[n])[1:])
        assert (got[n].numpy()[1:] != c[n][1:]).any()


def test_write_fresh_kv_live_matches_jax(target):
    _, tcfg, _, _ = target
    c = _arena_case(tcfg, 4, 1, [0, 5, 8, 13])
    fresh = {n: v[:, :, :, 0] for n, v in _fresh(tcfg, 4, 1).items()}
    live = np.asarray([False, True, False, True])
    ja, ta = _both_arenas(c)
    want = jpa.write_fresh_kv_live(ja, {n: jnp.asarray(v) for n, v in fresh.items()},
                                   jnp.asarray(c["tables"]), jnp.asarray(c["pos"]),
                                   jnp.asarray(live), block_size=4)
    got = tpa.write_fresh_kv_live(ta, {n: torch.as_tensor(v) for n, v in fresh.items()},
                                  torch.as_tensor(c["tables"]), torch.as_tensor(c["pos"]),
                                  torch.as_tensor(live), block_size=4)
    for n in ("k", "v"):
        np.testing.assert_array_equal(got[n].numpy()[1:], np.asarray(want[n])[1:])
    # a live row commits exactly like the unmasked single-step write
    plain = tpa.write_fresh_kv({n: torch.as_tensor(c[n].copy()) for n in ("k", "v")},
                               {n: torch.as_tensor(v) for n, v in fresh.items()},
                               torch.as_tensor(c["tables"]), torch.as_tensor(c["pos"]),
                               block_size=4)
    live_blocks = [int(c["tables"][i, c["pos"][i] // 4]) for i in (1, 3)]
    for n in ("k", "v"):
        assert torch.equal(got[n][live_blocks], plain[n][live_blocks])


@pytest.mark.parametrize("pos", [0, 8])
def test_write_fresh_kv_chunk_matches_jax(target, pos):
    from thunder_tpu.serving.kv_pool import chunk_tables

    _, tcfg, _, _ = target
    c = _arena_case(tcfg, 1, 8, [pos])
    fresh = _fresh(tcfg, 1, 8)
    _, dest = chunk_tables([int(b) for b in c["tables"][0] if b], pos, 8, 6, 4)
    ja, ta = _both_arenas(c)
    p = np.asarray([pos], np.int32)
    want, qerr = jpa.write_fresh_kv_chunk(ja, {n: jnp.asarray(v) for n, v in fresh.items()},
                                          jnp.asarray(dest), jnp.asarray(p), block_size=4)
    got, got_qerr = tpa.write_fresh_kv_chunk(ta, {n: torch.as_tensor(v) for n, v in fresh.items()},
                                             torch.as_tensor(dest), torch.as_tensor(p),
                                             block_size=4)
    assert float(qerr) == float(got_qerr) == 0.0
    for n in ("k", "v"):
        np.testing.assert_array_equal(got[n].numpy()[1:], np.asarray(want[n])[1:])
        assert (got[n].numpy()[1:] != c[n][1:]).any()


#
# the acceptance rule
#


def _accept_inputs(seed, K=3, V=8):
    rng = np.random.default_rng(seed)

    def probs(*shape):
        x = np.exp(1.5 * rng.standard_normal((*shape, V)))
        return (x / x.sum(-1, keepdims=True)).astype(np.float32)

    return rng.integers(0, V, K).astype(np.int32), probs(K + 1), probs(K)


@pytest.mark.parametrize("seed", range(6))
def test_acceptance_fed_jax_uniforms_matches_jax(seed):
    drafts, p_all, q_rows = _accept_inputs(seed)
    # make some drafts likely to be accepted: q below p at the draft
    q_rows[0, drafts[0]] = p_all[0, drafts[0]] * 0.5
    key = jax.random.PRNGKey(seed)
    m_j, y_j = jspec.accept_tokens(key, jnp.asarray(drafts), jnp.asarray(p_all),
                                   jnp.asarray(q_rows))
    ku, _ = jax.random.split(key)
    us = np.array(jax.random.uniform(ku, (len(drafts),)))
    m, res = tspec.acceptance(torch.as_tensor(us), torch.as_tensor(drafts),
                              torch.as_tensor(p_all), torch.as_tensor(q_rows))
    assert int(m) == int(m_j)
    q_ext = np.concatenate([q_rows, np.zeros_like(q_rows[:1])])
    want = np.maximum(p_all[int(m)] - q_ext[int(m)], 0.0)
    want = want / want.sum() if want.sum() > 0 else p_all[int(m)]
    np.testing.assert_allclose(res.numpy(), want, rtol=1e-5, atol=1e-7)
    assert res[int(y_j)] > 0                      # JAX drew its token from this support


def test_acceptance_preserves_target_distribution():
    """The first emitted token (the draft if accepted, else the residual
    draw) is distributed as the target's p, as tests/test_speculative.py
    checks for the JAX rule."""
    V, n = 8, 20000
    gen = torch.Generator().manual_seed(0)
    rng = np.random.default_rng(0)
    p = torch.softmax(torch.as_tensor(rng.standard_normal(V) * 1.5, dtype=torch.float32), 0)
    q = torch.softmax(torch.as_tensor(rng.standard_normal(V) * 1.5, dtype=torch.float32), 0)
    drafts = torch.multinomial(q.expand(n, V), 1, replacement=True, generator=gen).int()
    p_all = p.expand(n, 2, V)
    m, res = tspec.acceptance(torch.rand(n, 1, generator=gen), drafts, p_all, q.expand(n, 1, V))
    y = torch.multinomial(res, 1, generator=gen)[:, 0]
    first = torch.where(m > 0, drafts[:, 0].long(), y)
    emp = torch.bincount(first, minlength=V).double() / n
    assert 0.5 * (emp - p.double()).abs().sum().item() < 0.02


def test_accept_tokens_all_accepted_draws_the_bonus():
    drafts, p_all, _ = _accept_inputs(1)
    g = torch.Generator().manual_seed(3)
    m, y = tspec.accept_tokens(g, torch.as_tensor(drafts), torch.as_tensor(p_all),
                               torch.as_tensor(p_all[:-1]))        # q == p: always accept
    assert int(m) == len(drafts) and 0 <= int(y) < p_all.shape[-1]


#
# served tokens: chunked prefill
#


@pytest.fixture(scope="module")
def chunk_ref(target):
    jcfg, _, jp, _ = target
    eng = tt.serve(None, jp, jcfg, attn="paged", cache_dtype=jnp.float32, **CHUNKED)
    return _drive(eng, _prompts(CHUNK_LENS), n=4)


@pytest.mark.parametrize("attn", ["paged", "gather"])
def test_chunked_tokens_equal_jax_engine_and_unchunked(target, chunk_ref, attn):
    _, tcfg, _, tp = target
    eng = _port(tcfg, tp, attn=attn, **CHUNKED)
    got = _drive(eng, _prompts(CHUNK_LENS), n=4)
    assert got == chunk_ref
    unchunked = _port(tcfg, tp, **{**CHUNKED, "prefill_chunk": None,
                                   "prefill_buckets": (8, 16, 32)})
    assert _drive(unchunked, _prompts(CHUNK_LENS), n=4) == chunk_ref
    st = eng.stats()
    kinds = st["attn"]["kinds"]["prefill_chunk"]
    # 13 -> 8+5, 21 -> 8+8+5, 9 -> 8+1: four intermediate pieces
    assert st["prefill_chunk"] == 8 and st["chunk_runs"] == 4
    assert kinds["mode"] == attn
    assert (kinds["kernel_steps"], kinds["fallback_steps"]) == (
        (4, 0) if attn == "paged" else (0, 4))
    kind = "prefill_chunk_paged" if attn == "paged" else "prefill_chunk"
    assert st["compile_counts"][kind] >= 1 and st["compile_counts"]["prefill"] >= 1
    assert st["bucket_bound"] == (1 + 2 * 2) * len(eng._table_widths)


def test_chunked_shared_prefix_resumes_past_the_share(target):
    """A second request with the first's 16-token prefix shares four
    blocks and chunks only the rest; tokens equal an unshared engine's."""
    _, tcfg, _, tp = target
    base = _prompts((20,), seed=4)[0]
    prompts = [base, np.concatenate([base[:16], _prompts((9,), seed=5)[0]])]

    def run(sharing):
        eng = _port(tcfg, tp, prefix_sharing=sharing, **CHUNKED)
        h0 = eng.submit(prompts[0], max_new_tokens=6)
        for _ in range(4):
            eng.step()
        h1 = eng.submit(prompts[1], max_new_tokens=3)
        eng.drain()
        return [h.result(drive=False) for h in (h0, h1)]

    shared, alone = run(True), run(False)
    assert [r.new_tokens for r in shared] == [r.new_tokens for r in alone]
    assert shared[1].shared_prefix_blocks == 4


@pytest.mark.parametrize("engine_kw,mode,reason", [
    (dict(prefill_buckets=(8, 18)), "gather", "multiples of block_size"),
    (dict(attn="gather"), "gather", "gather"),
    (dict(), "paged", None),
], ids=["unaligned-buckets", "gather-engine", "aligned"])
def test_chunk_kind_resolution(target, engine_kw, mode, reason):
    _, tcfg, _, tp = target
    eng = _port(tcfg, tp, **{**CHUNKED, **engine_kw})
    kinds = eng.stats()["attn"]["kinds"]
    assert kinds["decode"]["mode"] == ("gather" if engine_kw.get("attn") == "gather"
                                       else "paged")
    assert kinds["prefill_chunk"]["mode"] == mode
    if reason is None:
        assert kinds["prefill_chunk"]["fallback_reason"] is None
    else:
        assert reason in kinds["prefill_chunk"]["fallback_reason"]


def test_chunk_kind_resolution_sliding_window_and_spec(target, draft):
    _, wcfg, _, wp = _pair(sliding_window=5)
    eng = _port(wcfg, wp, **CHUNKED)
    assert eng.stats()["attn"]["kinds"]["prefill_chunk"]["mode"] == "gather"
    assert "window" in eng.stats()["attn"]["kinds"]["prefill_chunk"]["fallback_reason"]
    _, tcfg, _, tp = target
    _, dcfg, _, dp = draft
    eng = _port(tcfg, tp, speculative=ttt.SpecConfig(dp, dcfg, K=2), **CHUNKED)
    kinds = eng.stats()["attn"]["kinds"]
    assert kinds["decode"]["mode"] == "paged" and kinds["prefill_chunk"]["mode"] == "gather"
    assert "speculative" in kinds["prefill_chunk"]["fallback_reason"]


def test_sliding_window_chunked_tokens_equal_jax_engine():
    jcfg, tcfg, jp, tp = _pair(sliding_window=5)
    prompts = _prompts((13, 9))
    want = _drive(tt.serve(None, jp, jcfg, attn="paged", cache_dtype=jnp.float32, **CHUNKED),
                  prompts, n=6)
    assert _drive(_port(tcfg, tp, **CHUNKED), prompts, n=6) == want


def test_prefill_chunk_needs_the_async_loop(target):
    _, tcfg, _, tp = target
    with pytest.raises(ValueError, match="async_step"):
        _port(tcfg, tp, async_step=False, **CHUNKED)
    with pytest.raises(ValueError, match="multiple"):
        _port(tcfg, tp, **{**CHUNKED, "prefill_chunk": 6})


#
# served tokens: speculative serving
#


SPEC_LENS, SPEC_NEW = (7, 5, 11), 9


@pytest.fixture(scope="module")
def spec_ref(target, draft):
    jcfg, _, jp, _ = target
    jdcfg, _, jdp, _ = draft
    eng = tt.serve(None, jp, jcfg, speculative=JSpecConfig(jdp, jdcfg, K=2), attn="paged",
                   cache_dtype=jnp.float32, **SPEC)
    return _drive(eng, _prompts(SPEC_LENS, seed=1), n=SPEC_NEW), eng.stats()["spec"]


@pytest.mark.parametrize("async_step", [True, False], ids=["async", "sync"])
@pytest.mark.parametrize("attn", ["paged", "gather"])
def test_spec_tokens_equal_jax_spec_engine_and_plain(target, draft, spec_ref, attn, async_step):
    _, tcfg, _, tp = target
    _, dcfg, _, dp = draft
    want, jstats = spec_ref
    eng = _port(tcfg, tp, speculative=ttt.SpecConfig(dp, dcfg, K=2), attn=attn,
                async_step=async_step, **SPEC)
    assert _drive(eng, _prompts(SPEC_LENS, seed=1), n=SPEC_NEW) == want
    plain = _port(tcfg, tp, attn=attn, **SPEC)
    assert _drive(plain, _prompts(SPEC_LENS, seed=1), n=SPEC_NEW) == want
    st = eng.stats()["speculative"]
    assert (st["rounds"], st["accepted_tokens"], st["draft_tokens"]) == (
        jstats["rounds"], jstats["accepted_tokens"], jstats["draft_tokens"])
    assert st["accept_len_hist"] == jstats["accept_len_hist"]
    assert eng.stats()["attn"]["kernel_steps"] == (st["rounds"] if attn == "paged" else 0)


def test_self_draft_accepts_every_draft(target):
    _, tcfg, _, tp = target
    eng = _port(tcfg, tp, speculative=ttt.SpecConfig(tp, tcfg, K=4), **SPEC)
    got = _drive(eng, _prompts((7,), seed=1), n=11)
    solo = tgen.generate(tp, _prompts((7,), seed=1)[0][None], tcfg, 11, device="cpu")[0]
    assert got == [tuple(solo.tolist())]
    st = eng.stats()["speculative"]
    assert st["acceptance_rate"] == 1.0 and st["accept_len_hist"][5] == 2
    assert st["tokens_per_round"] == 5.0


def test_spec_stats_and_metrics(target, draft):
    from thunder_tpu_torch.observability import registry

    _, tcfg, _, tp = target
    _, dcfg, _, dp = draft
    reg = registry()
    reg.reset()
    eng = _port(tcfg, tp, speculative=ttt.SpecConfig(dp, dcfg, K=2), **SPEC)
    _drive(eng, _prompts(SPEC_LENS, seed=1), n=SPEC_NEW)
    st = eng.stats()["speculative"]
    snap = reg.snapshot("serving.")
    assert snap["serving.spec.rounds"] == st["rounds"] == eng.spec_rounds
    assert snap["serving.spec.accept_len"]["count"] == sum(st["accept_len_hist"].values())
    assert snap["serving.spec.accepted_tokens"] == st["accepted_tokens"]
    assert snap["serving.tokens"] == len(SPEC_LENS) * SPEC_NEW
    assert st["draft_tokens"] == 2 * sum(st["accept_len_hist"].values())


def test_spec_eos_trims_the_round(target):
    """An EOS inside a round's accepted tokens finishes the request there
    and drops the rest, as with the plain engine."""
    _, tcfg, _, tp = target
    prompt = _prompts((7,), seed=1)[0]
    plain = _port(tcfg, tp, **SPEC).run([prompt], max_new_tokens=11)[0].new_tokens
    eos = plain[3]
    spec = _port(tcfg, tp, speculative=ttt.SpecConfig(tp, tcfg, K=4), eos_id=eos, **SPEC)
    res = spec.run([prompt], max_new_tokens=11)[0]
    assert res.finish_reason == "eos"
    assert res.new_tokens == plain[:plain.index(eos) + 1]
    assert spec.pool.num_free == spec.pool.num_usable


def test_spec_temperature_same_alone_batched_and_solo(target, draft):
    _, tcfg, _, tp = target
    _, dcfg, _, dp = draft
    prompts = _prompts(SPEC_LENS, seed=2)

    def gen(seed):
        return torch.Generator().manual_seed(seed)

    def engine():
        return _port(tcfg, tp, speculative=ttt.SpecConfig(dp, dcfg, K=2), temperature=0.8, **SPEC)

    eng = engine()
    handles = [eng.submit(p, max_new_tokens=8, generator=gen(20 + i))
               for i, p in enumerate(prompts)]
    eng.drain()
    batched = [h.result(drive=False).new_tokens for h in handles]
    for i, p in enumerate(prompts):
        alone = engine().submit(p, max_new_tokens=8, generator=gen(20 + i)).result().new_tokens
        solo = tspec.speculative_generate(tp, dp, p[None], tcfg, dcfg, 8, K=2, temperature=0.8,
                                          generator=gen(20 + i), device="cpu")[0, len(p):]
        assert alone == batched[i] == tuple(solo.tolist())
    assert len(set(batched)) > 1


def test_solo_speculative_generate_greedy_equals_generate(target, draft):
    _, tcfg, _, tp = target
    _, dcfg, _, dp = draft
    prompt = np.stack(_prompts((6, 6), seed=3))
    want = tgen.generate(tp, prompt, tcfg, 10, device="cpu")
    got = tspec.speculative_generate(tp, dp, prompt, tcfg, dcfg, 10, K=3, device="cpu")
    assert torch.equal(got, want)
    assert 1.0 <= tspec.speculative_generate.last_tokens_per_round <= 4.0


def test_spec_options_are_validated(target, draft):
    _, tcfg, _, tp = target
    _, dcfg, _, dp = draft
    with pytest.raises(TypeError, match="SpecConfig"):
        _port(tcfg, tp, speculative=42, **SPEC)
    with pytest.raises(ValueError, match="K must be"):
        _port(tcfg, tp, speculative=ttt.SpecConfig(dp, dcfg, K=0), **SPEC)
    _, bcfg, _, bp = _pair(n_layer=1, vocab_size=128)
    with pytest.raises(ValueError, match="vocab"):
        _port(tcfg, tp, speculative=ttt.SpecConfig(bp, bcfg, K=2), **SPEC)
    _, wcfg, _, wp = _pair(sliding_window=8)
    with pytest.raises(ValueError, match="[sS]liding"):
        _port(wcfg, wp, speculative=ttt.SpecConfig(dp, dcfg, K=2), **SPEC)
    with pytest.raises(ValueError, match="kv_dtype"):
        _port(tcfg, tp, speculative=ttt.SpecConfig(dp, dcfg, K=2, draft_kv_dtype="int4"), **SPEC)
    with pytest.raises(ValueError, match="decode_steps=2 with speculative"):
        _port(tcfg, tp, speculative=ttt.SpecConfig(dp, dcfg, K=2), decode_steps=2, **SPEC)
    # decode_steps=N serves without speculative= (multi-step decode); a
    # horizon below 1 is refused
    assert _port(tcfg, tp, decode_steps=2, **SPEC).stats()["decode_steps_per_visit"] == 2
    with pytest.raises(ValueError, match="decode_steps= must be >= 1"):
        _port(tcfg, tp, decode_steps=0, **SPEC)
    import thunder_tpu_torch.serving as serving

    assert "SpecConfig" in serving.__all__ and serving.SpecConfig is ttt.SpecConfig


def test_spec_engine_leaves_no_kernel_launches_on_cpu(target, draft):
    _, tcfg, _, tp = target
    _, dcfg, _, dp = draft
    cudaex.reset_launches()
    eng = _port(tcfg, tp, speculative=ttt.SpecConfig(dp, dcfg, K=2), **{**SPEC, **CHUNKED})
    _drive(eng, _prompts(CHUNK_LENS), n=4)
    assert set(cudaex.LAUNCHES.values()) == {0}
    st = eng.stats()
    assert st["chunk_runs"] == 4 and st["compile_counts"]["spec_prefill_chunk"] >= 1
    assert st["pool_free_blocks"] == eng.pool.num_usable


#
# on the card (skipped here)
#


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_chunked_and_spec_engines_run_the_kernels(card, dtype):
    """On the card the chunked engine launches n_layer verify kernels and
    one chunk write (K and V) per intermediate piece, the speculative engine n_layer
    verify kernels and one masked write per round (K and V of every
    offset in one launch); in float32 both serve the plain engine's
    tokens."""
    cfg = ttt.Config.from_name("tiny-llama-debug", n_embd=256)      # hs 64
    params = ttt.init_params(cfg, generator=torch.Generator(card).manual_seed(0),
                             dtype=dtype, device=card)
    prompts = _prompts((40, 70, 9, 33))
    common = dict(device=card, block_size=16, num_blocks=64, max_batch=4)
    plain = _drive(ttt.serve(None, params, cfg, **common), prompts, n=6)
    cudaex.reset_launches()
    eng = ttt.serve(None, params, cfg, prefill_chunk=32, prefill_buckets=(16, 32, 64),
                    **common)
    chunked = _drive(eng, prompts, n=6)
    torch.cuda.synchronize()
    assert eng.stats()["attn"]["kinds"]["prefill_chunk"]["mode"] == "paged"
    assert cudaex.LAUNCHES["paged_attn_verify"] == eng.chunk_runs * cfg.n_layer > 0
    assert cudaex.LAUNCHES["paged_chunk_write"] == eng.chunk_runs
    cudaex.reset_launches()
    dcfg = ttt.Config.from_name("tiny-llama-debug", n_embd=256, n_layer=1)
    spec_eng = ttt.serve(None, params, cfg, speculative=ttt.SpecConfig(
        {**params, "blocks": params["blocks"][:1]}, dcfg, K=3), **common)
    spec = _drive(spec_eng, prompts, n=6)
    torch.cuda.synchronize()
    rounds = spec_eng.spec_rounds
    assert cudaex.LAUNCHES == {**dict.fromkeys(cudaex.LAUNCHES, 0),
                               "paged_attn_verify": rounds * cfg.n_layer,
                               "paged_token_write_masked": rounds}
    if dtype == torch.float32:
        assert chunked == plain and spec == plain
