"""thunder_tpu_torch stateful serving against the JAX engine's, on the CPU.

Sessions (``sessions=``), priority classes with preemption
(``priorities=``), constrained decoding (``constraints=True``), a custom
``model_fn`` and learned position embeddings (GPT-2's ``wpe``) are served
by the port's engine and by the JAX engine on the same inputs (tiny
configs, float32, prompts drawn with numpy from seeds): greedy tokens are
exact, and ``reattach_hits``, ``shared_prefix_blocks``, ``preempted``,
``chunk_runs`` and the session table's snapshot equal the reference's.
The scenarios mirror ``tests/test_serving_{sessions,priority,constrain}.py``:
turn-2/3 re-attach on the gather, paged, int8 and LoRA lanes, LRU and
bytes-budget eviction, recovery with resident sessions, preemption (a
victim mid-decode, a victim without tokens, resume by chunk pieces, at
``decode_steps=2``), the SLO gate under a stub monitor, constrained token
0, ``decode_steps=3`` masks, ``ConstraintLookaheadError`` at submit, a
``model_fn`` that changes the logits, and ``nanogpt-debug`` served paged
and gather.  Temperature runs compare the port against itself (the
reference draws with threefry, the port with Philox): a preempted stream,
a re-attached turn and an unconstrained row equal their undisturbed runs.
The JAX engine's paged lane (the Pallas kernels interpreted) serves the
gather lane's tokens (its own tests hold that), so the port's paged lane is
held against the JAX gather lane's tokens.
"""
from __future__ import annotations

import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import thunder_tpu as tt
import thunder_tpu_torch as ttt
from thunder_tpu.models import generate as jgen
from thunder_tpu.models import llama as jllama
from thunder_tpu.serving import AdapterRegistry as JRegistry
from thunder_tpu.serving import ServingEngine as JEngine
from thunder_tpu.serving import constrain as jconstrain
from thunder_tpu_torch.models import generate as tgen
from thunder_tpu_torch.observability.metrics import registry
from thunder_tpu_torch.serving import constrain as tconstrain
from thunder_tpu_torch.serving import (
    ConstraintLookaheadError,
    DFAConstraint,
    PagedKVPool,
    PriorityConfig,
    PriorityGate,
    SessionConfig,
    SessionTable,
    TokenSetConstraint,
)
from thunder_tpu_torch.serving.kv_pool import SINK_BLOCK, PrefixIndex
from thunder_tpu_torch.serving.lora import _target_features
from thunder_tpu_torch.serving.priority import priority_level
from torch_port_threads import one_torch_thread  # noqa: F401

MICRO = dict(n_layer=1, n_head=2, n_embd=16, intermediate_size=32, vocab_size=32, block_size=64)
BUCKETS = dict(batch_buckets=(1, 2), block_buckets=(4, 8), prefill_buckets=(8, 16))
ENGINE = dict(block_size=4, num_blocks=16, max_batch=2, **BUCKETS)
# one batch row: a queued high request can only enter by preemption (the
# pool is ENGINE's, so the JAX engine reuses its compiled programs)
STARVED = dict(ENGINE, max_batch=1, max_queue=8)
V = 64                                   # MICRO's padded vocabulary: the logit width


@pytest.fixture(scope="module", autouse=True)
def _leave_jax_caches_as_found():
    """The JAX package memoizes compiled programs in bounded module caches
    that other test files count; leave them exactly as found."""
    from thunder_tpu.serving import engine as jengine

    before = dict(jengine._program_cache), dict(jgen._generate_cache)
    yield
    for cache, saved in zip((jengine._program_cache, jgen._generate_cache), before):
        cache.clear()
        cache.update(saved)


def _models(name="tiny-llama-debug", seed=0, **overrides):
    jcfg = jllama.Config.from_name(name, **overrides)
    tcfg = ttt.Config.from_name(name, **overrides)
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(seed), dtype=jnp.float32)
    tp = ttt.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module")
def micro():
    return _models(**MICRO)


def _prompt(seed, n, vocab=32):
    return np.random.default_rng(seed).integers(1, vocab, (n,)).astype(np.int32)


def _jax(pair, **kw):
    jcfg, _, jp, _ = pair
    return tt.serve(None, jp, jcfg, cache_dtype=jnp.float32, **{**ENGINE, **kw})


def _port(pair, **kw):
    _, tcfg, _, tp = pair
    return ttt.serve(None, tp, tcfg, device="cpu", **{**ENGINE, **kw})


def _both(pair, scenario, jkw=None, tkw=None, **kw):
    """Runs ``scenario(engine)`` on the JAX engine (its gather lane) and
    the port's, built with ``kw`` (plus each side's own ``jkw``/``tkw``);
    returns both summaries."""
    want = scenario(_jax(pair, **{**kw, "attn": "gather", **(jkw or {})}))
    got = scenario(_port(pair, **kw, **(tkw or {})))
    return want, got


def _cmod(eng):
    """The constraint module of ``eng``'s package."""
    return jconstrain if isinstance(eng, JEngine) else tconstrain


def _toks(res):
    return tuple(int(t) for t in res.new_tokens)


def _factors(cfg, seed, rank=2, std=0.5):
    rng = np.random.default_rng(seed)
    out = {}
    for t in ("wq", "wk", "wv", "wo"):
        fin, fout = _target_features(cfg, t)
        out[t] = (rng.normal(0, std, (cfg.n_layer, rank, fin)).astype(np.float32),
                  rng.normal(0, std, (cfg.n_layer, fout, rank)).astype(np.float32))
    return out


def _registries(pair):
    jcfg, tcfg, _, _ = pair
    jreg = JRegistry(jcfg, rank=2, max_adapters=2)
    treg = ttt.AdapterRegistry(tcfg, rank=2, max_adapters=2, device="cpu")
    f = _factors(tcfg, 3)
    jreg.register("tenant", f)
    treg.register("tenant", f)
    return jreg, treg


#
# sessions
#


def _turns(eng, n_turns=2, submit_kw=None, recover=False, first=7, new=(5, 4), extra=3):
    """Turns 1..n of one session: each later prompt is the history plus
    ``extra`` new tokens; turn k serves ``new[min(k, 1)]`` tokens (a
    ``recover`` after turn 1 zeroes the arenas).  Returns every turn's
    tokens, shared blocks and recomputed positions, the table's snapshot,
    the chunk pieces and the pool's free blocks."""
    kw = dict(submit_kw or {})
    p = _prompt(11, first)
    out = []
    for turn in range(n_turns):
        r = eng.submit(p, max_new_tokens=new[min(turn, 1)], session_id="chat", **kw).result()
        out.append((_toks(r), r.shared_prefix_blocks, r.tokens_recomputed))
        if recover and turn == 0:
            eng.recover()
        p = np.concatenate([p, np.asarray(r.new_tokens, np.int32), _prompt(12 + turn, extra)])
    return {"turns": out, "table": eng.stats()["sessions"], "chunk_runs": eng.chunk_runs,
            "free": eng.pool.num_free}


LANES = {
    "gather": dict(attn="gather"),
    "paged": dict(attn="paged"),
    "int8": dict(attn="paged", kv_dtype="int8"),
}


@pytest.mark.parametrize("lane", [*LANES, "lora"])
def test_turn2_reattach_equals_jax_engine(micro, lane):
    """Turn 2 re-attaches the parked prefix on every lane: its tokens, its
    shared blocks, the re-attach count and the table's snapshot equal the
    JAX engine's, and its tokens equal a cold engine's serving the full
    history."""
    kw, jkw, tkw, submit_kw = dict(LANES.get(lane, {})), {}, {}, {}
    if lane == "lora":
        jreg, treg = _registries(micro)
        jkw, tkw, submit_kw = {"lora": jreg}, {"lora": treg}, {"adapter_id": "tenant"}
    if lane != "gather":
        kw.setdefault("attn", "paged")
    want, got = _both(micro, lambda e: _turns(e, submit_kw=submit_kw), jkw, tkw, sessions=True,
                      **{"attn": "gather", **kw})
    assert got == want
    assert got["table"]["reattach_hits"] == 1 and got["turns"][1][1] > 0
    p2 = np.concatenate([_prompt(11, 7), np.asarray(got["turns"][0][0], np.int32),
                         _prompt(12, 3)])
    cold = _port(micro, **kw, **tkw).submit(p2, max_new_tokens=4, **submit_kw).result()
    assert _toks(cold) == got["turns"][1][0]


def test_turn3_keeps_growing(micro):
    want, got = _both(micro, lambda e: _turns(e, n_turns=3, first=6, new=(3, 3), extra=2),
                      sessions=True)
    assert got == want
    assert got["table"]["reattach_hits"] == 2 and all(t[1] > 0 for t in got["turns"][1:])


def test_reattach_survives_recovery(micro):
    """A recovery zeroes the arenas after turn 1; the parked session's
    tokens are replayed, so turn 2 re-attaches and serves the JAX engine's
    tokens (which equal a cold run's)."""
    want, got = _both(micro, lambda e: _turns(e, recover=True), sessions=True)
    assert got == want and got["table"]["reattach_hits"] == 1
    assert got["chunk_runs"] == want["chunk_runs"] > 0


def test_reattach_at_temperature_equals_cold_run(micro):
    """The port against itself at temperature 0.8: a re-attached turn 2
    draws what a cold engine draws for the full history from the same
    generator state."""
    eng = _port(micro, sessions=True, temperature=0.8)
    p1 = _prompt(11, 7)
    g = torch.Generator().manual_seed(7)
    r1 = eng.submit(p1, max_new_tokens=5, session_id="s", generator=g).result()
    p2 = np.concatenate([p1, np.asarray(r1.new_tokens, np.int32), _prompt(12, 3)])
    r2 = eng.submit(p2, max_new_tokens=4, session_id="s",
                    generator=torch.Generator().manual_seed(8)).result()
    cold = _port(micro, temperature=0.8).submit(
        p2, max_new_tokens=4, generator=torch.Generator().manual_seed(8)).result()
    assert _toks(r2) == _toks(cold) and r2.shared_prefix_blocks > 0


@pytest.mark.parametrize("budget", ["count", "bytes"])
def test_session_budget_eviction_equals_jax_engine(micro, budget):
    """Three sessions under a two-session (or two-block) budget: the LRU
    evictions, the table and the pool's free blocks equal the JAX
    engine's."""
    spec = ({"max_sessions": 2} if budget == "count"
            else {"max_bytes": 2 * PagedKVPool(micro[1], num_blocks=4, block_size=4,
                                               dtype=torch.float32,
                                               device="cpu").block_bytes()})

    def scenario(eng):
        for i in range(3):
            eng.submit(_prompt(20 + i, 7), max_new_tokens=3, session_id=f"s{i}").result()
        return {"table": eng.stats()["sessions"], "free": eng.pool.num_free}

    want, got = _both(micro, scenario, sessions=spec)
    assert got == want and got["table"]["evictions"] >= 1


def test_close_evict_and_shutdown_release_blocks(micro):
    eng = _port(micro, sessions=True)
    eng.submit(_prompt(51, 7), max_new_tokens=5, session_id="s").result()
    assert eng.pool.num_free < eng.pool.num_usable and eng.session_resident("s")
    assert eng.close_session("s") > 0 and eng.close_session("s") == 0
    assert eng.pool.num_free == eng.pool.num_usable
    h = eng.submit(_prompt(52, 7), max_new_tokens=8, session_id="t")
    for _ in range(3):
        eng.step()
    eng.evict(h)                                   # an abnormal turn parks nothing
    assert eng.stats()["sessions"]["sessions"] == 0
    assert eng.pool.num_free == eng.pool.num_usable
    eng.submit(_prompt(53, 7), max_new_tokens=4, session_id="u").result()
    eng.shutdown()
    assert eng.pool.num_free == eng.pool.num_usable


def test_session_validation_telemetry_and_metrics(micro):
    eng = _port(micro)
    with pytest.raises(ValueError, match="sessions"):
        eng.submit(_prompt(54, 7), max_new_tokens=2, session_id="s")
    with pytest.raises(ValueError, match="prefix"):
        _port(micro, sessions=True, prefix_sharing=False)
    from thunder_tpu_torch.observability.telemetry import StepLogger

    sink = io.StringIO()
    eng = _port(micro, sessions=True, trace=True, telemetry=StepLogger(sink))
    eng.submit(_prompt(55, 7), max_new_tokens=3, session_id="s").result()
    reqs = [r for r in map(json.loads, sink.getvalue().splitlines())
            if r.get("event") == "request"]
    assert reqs and reqs[0]["session_id"] == "s"
    assert eng._flight_state()["engine"]["sessions"]["ids"] == ["s"]
    assert registry().snapshot()["serving.session.resident_blocks"] > 0


def test_session_table_policy(micro):
    """The table alone (no device work): park shares, close frees, parking
    cuts to block-aligned tokens and stops at a sink block, a re-park keeps
    the overlap alive, and liveness follows ownership."""
    tcfg = micro[1]
    pool = PagedKVPool(tcfg, num_blocks=16, block_size=4, dtype=torch.float32, device="cpu")
    tab = SessionTable(pool, PrefixIndex(4), SessionConfig())
    blocks = pool.alloc(3)
    e = tab.park("s", np.arange(10), blocks)       # 10 tokens -> 2 blocks
    pool.free(blocks)
    assert len(e.blocks) == 2 and len(e.tokens) == 8
    assert pool.num_free == pool.num_usable - 2
    assert tab.alive(e.owner_rid, e.blocks) and not tab.alive(e.owner_rid, (99,))
    grown = list(e.blocks) + pool.alloc(1)
    tab.park("s", np.arange(12), grown)
    pool.free(grown[2:])
    assert tab.resident_blocks == 3 and tab.close("s") == 3
    assert pool.num_free == pool.num_usable
    b = pool.alloc(2)
    assert tab.park("t", np.arange(12), [SINK_BLOCK, *b]) is None
    pool.free(b)
    assert pool.num_free == pool.num_usable and not tab.alive(e.owner_rid, e.blocks)


#
# priorities and preemption
#


class _StubSLO:
    """A monitor double: fixed burn rates per dimension."""

    def __init__(self, burns):
        self._dims = dict.fromkeys(burns)
        self._burns = burns

    def burn_rate(self, dim):
        return self._burns[dim]

    def observe(self, res):
        pass

    def report(self):
        return {"enabled": True}


LOW_NEW = 12                             # the victim's tokens: it is mid-decode at step 4


def _preempt_scenario(eng, steps=4, low_new=LOW_NEW):
    """A low request mid-decode on a pool that funds one request, then a
    high one: the low request is preempted and resumes."""
    h_low = eng.submit(_prompt(31, 8), max_new_tokens=low_new, priority="low")
    for _ in range(steps):
        eng.step()
    h_high = eng.submit(_prompt(32, 8), max_new_tokens=4, priority="high")
    r_high, r_low = h_high.result(), h_low.result()
    return {"high": _toks(r_high), "low": _toks(r_low), "preempted": eng.preempted,
            "chunk_runs": eng.chunk_runs, "low_recomputed": r_low.tokens_recomputed,
            "low_causes": r_low.recompute_causes,
            "priority": eng.stats()["priority"], "free": eng.pool.num_free}


@pytest.mark.parametrize("N", [1, 2])
@pytest.mark.parametrize("attn", ["gather", "paged"])
def test_preempted_stream_equals_jax_engine(micro, attn, N):
    """The victim is preempted mid-decode (its in-flight decode record is
    dropped by its epoch) and resumes by chunk pieces: both streams, the
    preemption count, the replay's chunk pieces and the victim's
    recomputed positions equal the JAX engine's, and both streams equal an
    undisturbed engine's."""
    want, got = _both(micro, _preempt_scenario, priorities=True, attn=attn, decode_steps=N,
                      **STARVED)
    assert got == want
    assert got["preempted"] == 1 and got["chunk_runs"] > 0
    assert got["low_causes"] == ("replay_preemption",)
    solo = _port(micro, attn=attn, decode_steps=N, **STARVED)
    assert _toks(solo.submit(_prompt(31, 8), max_new_tokens=LOW_NEW).result()) == got["low"]
    assert _toks(solo.submit(_prompt(32, 8), max_new_tokens=4).result()) == got["high"]


@pytest.mark.parametrize("N", [1, 2])
def test_preempted_stream_at_temperature_equals_undisturbed(micro, N):
    """The port against itself at temperature 0.7: the victim's generator
    goes back to its last harvest's state, so the preempted and the high
    request draw what undisturbed solo runs draw."""
    def run(eng, preempt):
        g_low, g_high = torch.Generator().manual_seed(3), torch.Generator().manual_seed(5)
        h_low = eng.submit(_prompt(31, 8), max_new_tokens=LOW_NEW, generator=g_low,
                           **({"priority": "low"} if preempt else {}))
        if not preempt:
            return _toks(h_low.result()), _toks(eng.submit(
                _prompt(32, 8), max_new_tokens=4, generator=g_high).result())
        for _ in range(4):
            eng.step()
        h_high = eng.submit(_prompt(32, 8), max_new_tokens=4, generator=g_high,
                            priority="high")
        return _toks(h_low.result()), _toks(h_high.result())

    eng = _port(micro, priorities=True, temperature=0.7, decode_steps=N, **STARVED)
    got = run(eng, True)
    assert eng.preempted == 1
    assert got == run(_port(micro, temperature=0.7, decode_steps=N, **STARVED), False)


def test_victim_without_tokens_resumes_via_prefill(micro):
    """Preempted before its first token (sync loop): the victim re-queues
    and prefills again; tokens and counts equal the JAX engine's."""
    def scenario(eng):
        h_low = eng.submit(_prompt(35, 8), max_new_tokens=4, priority="low")
        h_high = eng.submit(_prompt(36, 8), max_new_tokens=3, priority="high")
        return {"high": _toks(h_high.result()), "low": _toks(h_low.result()),
                "preempted": eng.preempted, "chunk_runs": eng.chunk_runs}

    want, got = _both(micro, scenario, priorities=True, async_step=False, **STARVED)
    assert got == want
    solo = _port(micro, **STARVED)
    assert _toks(solo.submit(_prompt(35, 8), max_new_tokens=4).result()) == got["low"]


@pytest.mark.parametrize("steps", [1, 2])
def test_victim_mid_chunked_prefill(micro, steps):
    """Async loop with ``prefill_chunk=8``: the low request is preempted
    with no token yet and a chunk piece (``steps=1``) or its final piece
    (``steps=2``) in flight; the dropped record is drawn again on resume.
    Tokens and counts equal the JAX engine's and an undisturbed run's."""
    def scenario(eng):
        h_low = eng.submit(_prompt(37, 20), max_new_tokens=4, priority="low")
        for _ in range(steps):
            eng.step()
        h_high = eng.submit(_prompt(38, 8), max_new_tokens=3, priority="high")
        return {"high": _toks(h_high.result()), "low": _toks(h_low.result()),
                "preempted": eng.preempted, "chunk_runs": eng.chunk_runs}

    want, got = _both(micro, scenario, priorities=True, prefill_chunk=8, **STARVED)
    assert got == want and got["preempted"] == 1
    solo = _port(micro, prefill_chunk=8, **STARVED)
    assert _toks(solo.submit(_prompt(37, 20), max_new_tokens=4).result()) == got["low"]


def test_gate_defers_low_under_stub_slo(micro):
    def scenario(eng):
        eng._slo = _StubSLO({"ttft": 5.0})             # hot window: low is locked out
        h = eng.submit(_prompt(39, 7), max_new_tokens=2, priority="low")
        for _ in range(3):
            eng.step()
        state = h.state
        eng._slo = _StubSLO({"ttft": 0.1})             # the window recovered
        return {"state": state, "tokens": _toks(h.result()),
                "deferrals": eng.stats()["priority"]["deferrals"]}

    want, got = _both(micro, scenario, priorities={"burn_limits": {"low": 1.0}})
    assert got == want and got["state"] == "queued" and got["deferrals"]["low"] > 0


def test_queue_order_equals_jax_engine(micro):
    def scenario(eng):
        eng.submit(_prompt(1, 7), max_new_tokens=6)
        eng.step()
        for i, p in enumerate(["low", "normal", "high", "normal", "high"]):
            eng.submit(_prompt(2 + i, 7), max_new_tokens=2, priority=p)
        order = [(r.priority_class, r.rid) for r in eng.scheduler.queue]
        eng.drain()
        return order

    want, got = _both(micro, scenario, priorities=True, max_batch=1, max_queue=8)
    assert got == want and [c for c, _ in got] == ["high", "high", "normal", "normal", "low"]


def test_priority_policy_and_speculative_never_preempts(micro):
    assert priority_level(None) == ("normal", 1) and priority_level("high") == ("high", 0)
    with pytest.raises(ValueError, match="priority"):
        priority_level("urgent")
    with pytest.raises(ValueError, match="unknown priority class"):
        PriorityConfig(burn_limits={"vip": 1.0})
    assert PriorityGate(PriorityConfig(preempt=False)).pick_victim([], 0) is None
    with pytest.raises(ValueError, match="priorit"):
        _port(micro).submit(_prompt(20, 7), max_new_tokens=2, priority="high")
    _, tcfg, _, tp = micro
    eng = _port(micro, priorities=True, speculative=ttt.SpecConfig(tp, tcfg, K=2), **STARVED)
    h1 = eng.submit(_prompt(40, 8), max_new_tokens=4, priority="low")
    for _ in range(2):
        eng.step()
    h2 = eng.submit(_prompt(41, 8), max_new_tokens=3, priority="high")
    h2.result()
    assert eng.preempted == 0 and h1.result().finish_reason == "length"     # the head waited


#
# constrained decoding
#




@pytest.mark.parametrize("N", [1, 3])
@pytest.mark.parametrize("attn", ["gather", "paged"])
def test_constrained_tokens_equal_jax_engine(micro, attn, N):
    """A sequence constraint: token 0 (the prefill's draw) is forced, and
    at ``decode_steps=3`` every iteration of a visit takes its own mask;
    greedy tokens equal the JAX engine's and follow the automaton."""
    def scenario(eng):
        c = _cmod(eng).sequence_constraint(V, [[3], [5, 6], [7]])
        return _toks(eng.submit(_prompt(5, 7), max_new_tokens=5, constraint=c).result())

    want, got = _both(micro, scenario, constraints=True, attn=attn, decode_steps=N)
    assert got == want
    assert got[0] == 3 and got[1] in (5, 6) and got[2:] == (7, 7, 7)


def test_mixed_batch_and_lookahead_and_validation(micro):
    """An unconstrained row beside a constrained one serves the
    unconstrained engine's tokens (greedy, against the JAX engine too); a
    DFA whose masks diverge raises ``ConstraintLookaheadError`` at submit
    under ``decode_steps=2``; a wrong vocab width and a constraint on an
    unconstrained engine raise."""
    def scenario(eng):
        h1 = eng.submit(_prompt(3, 7), max_new_tokens=5)
        h2 = eng.submit(_prompt(4, 7), max_new_tokens=5,
                        constraint=_cmod(eng).TokenSetConstraint(V, [3, 9]))
        eng.drain()
        return _toks(h1.result(drive=False)), _toks(h2.result(drive=False))

    want, got = _both(micro, scenario, constraints=True)
    assert got == want and set(got[1]) <= {3, 9}
    plain = _port(micro).submit(_prompt(3, 7), max_new_tokens=5).result()
    assert _toks(plain) == got[0]
    t = np.full((2, V), -1)
    t[0, 1], t[0, 2], t[1, 3] = 1, 0, 1
    with pytest.raises(ConstraintLookaheadError):
        _port(micro, constraints=True, decode_steps=2).submit(
            _prompt(6, 7), max_new_tokens=4, constraint=DFAConstraint(t))
    with pytest.raises(ValueError, match="constraints"):
        _port(micro).submit(_prompt(7, 7), max_new_tokens=2,
                            constraint=TokenSetConstraint(V, [1]))
    with pytest.raises(ValueError, match="vocab"):
        _port(micro, constraints=True).submit(_prompt(8, 7), max_new_tokens=2,
                                              constraint=TokenSetConstraint(V + 64, [1]))
    _, tcfg, _, tp = micro
    with pytest.raises(ValueError, match="speculative"):
        _port(micro, constraints=True, speculative=ttt.SpecConfig(tp, tcfg, K=2))


@pytest.mark.parametrize("N", [1, 2])
def test_constrained_temperature_rows(micro, N):
    """At temperature 0.9 every constrained token lies in its allowed set,
    and an unconstrained row draws what an unconstrained engine draws from
    the same generator state."""
    eng = _port(micro, constraints=True, temperature=0.9, decode_steps=N)
    h1 = eng.submit(_prompt(3, 7), max_new_tokens=6, generator=torch.Generator().manual_seed(5))
    h2 = eng.submit(_prompt(4, 7), max_new_tokens=6, generator=torch.Generator().manual_seed(2),
                    constraint=TokenSetConstraint(V, [3, 4, 5, 9]))
    eng.drain()
    assert set(h2.result(drive=False).new_tokens) <= {3, 4, 5, 9}
    plain = _port(micro, temperature=0.9, decode_steps=N).submit(
        _prompt(3, 7), max_new_tokens=6, generator=torch.Generator().manual_seed(5)).result()
    assert h1.result(drive=False).new_tokens == plain.new_tokens


def test_constraint_survives_recovery_and_keys_the_steps(micro):
    """A recovery mid-stream continues the automaton untouched (host
    state); the knob joins the static key (None when off), and the
    unconstrained engine's stats carry no ``constrained`` entry."""
    def scenario(eng):
        c = _cmod(eng).sequence_constraint(V, [[3], [4], [5], [6], [7], [8]])
        h = eng.submit(_prompt(9, 7), max_new_tokens=6, constraint=c)
        for _ in range(4):
            eng.step()
        eng.recover()
        return _toks(h.result())

    want, got = _both(micro, scenario, constraints=True)
    assert got == want == (3, 4, 5, 6, 7, 8)
    off, on = _port(micro), _port(micro, constraints=True)
    assert off._static_key()[-1] is None and on._static_key()[-1] == "constrained"
    assert "constrained" not in off.stats() and on.stats()["constrained"] is True


#
# custom model_fn and learned positions
#


def test_custom_model_fn_equals_jax_engine(micro):
    """A ``model_fn`` that negates the logits (greedy then takes the least
    likely token), in the port and in JAX: the engines resolve the gather
    lane and serve equal tokens, which differ from the in-tree forward's;
    ``attn="paged"`` raises."""
    def jfn(*a, **kw):
        logits, cache = jgen.forward_with_cache(*a, **kw)
        return -logits, cache

    def tfn(*a, **kw):
        logits, cache = tgen.forward_with_cache(*a, **kw)
        return -logits, cache

    jcfg, tcfg, jp, tp = micro
    prompts = [_prompt(60 + i, 5 + 3 * i) for i in range(3)]
    want = [_toks(r) for r in tt.serve(jfn, jp, jcfg, cache_dtype=jnp.float32, **ENGINE).run(
        prompts, max_new_tokens=5)]
    eng = ttt.serve(tfn, tp, tcfg, device="cpu", **ENGINE)
    got = [_toks(r) for r in eng.run(prompts, max_new_tokens=5)]
    assert got == want
    st = eng.stats()["attn"]
    assert st["mode"] == "gather" and "custom model_fn" in st["kinds"]["decode"]["fallback_reason"]
    base = [_toks(r) for r in _port(micro).run(prompts, max_new_tokens=5)]
    assert base != got
    with pytest.raises(ValueError, match="custom model_fn"):
        ttt.serve(tfn, tp, tcfg, device="cpu", attn="paged", **ENGINE)
    with pytest.raises(ValueError, match="model_fn=None"):
        ttt.serve(tfn, tp, tcfg, device="cpu", speculative=ttt.SpecConfig(tp, tcfg, K=2),
                  **ENGINE)


@pytest.fixture(scope="module")
def gpt():
    return _models("nanogpt-debug", seed=1)


GPT = dict(block_size=16, num_blocks=24, max_batch=4)


@pytest.mark.parametrize("attn", ["paged", "gather"])
def test_learned_positions_equal_jax_engine(gpt, attn):
    """``nanogpt-debug`` (learned ``wpe``): the block and prefill buckets
    are capped at ``cfg.block_size`` and prefix sharing is off, as in the
    JAX engine, and the paged and gather lanes serve its tokens."""
    jcfg, tcfg, jp, tp = gpt
    prompts = [_prompt(70 + i, n, 256) for i, n in enumerate((5, 17, 40, 90))]
    jeng = tt.serve(None, jp, jcfg, cache_dtype=jnp.float32, attn="gather", **GPT)
    want = [_toks(r) for r in jeng.run(prompts, max_new_tokens=6)]
    eng = ttt.serve(None, tp, tcfg, device="cpu", attn=attn, **GPT)
    got = [_toks(r) for r in eng.run(prompts, max_new_tokens=6)]
    assert got == want and eng.attn == attn
    sch, jsch = eng.scheduler, jeng.scheduler
    assert (sch.block_buckets, sch.prefill_buckets, sch.prefill_chunk, eng.prefix_sharing) == (
        jsch.block_buckets, jsch.prefill_buckets, jsch.prefill_chunk, jeng.prefix_sharing)
    assert eng.prefix_sharing is False and max(sch.prefill_buckets) <= tcfg.block_size
    with pytest.raises(ValueError, match="learned position"):
        ttt.serve(None, tp, tcfg, device="cpu", block_size=16, num_blocks=24,
                  block_buckets=(16,))


def test_learned_position_draft_serves(gpt):
    """A learned-position draft behind ``SpecConfig`` serves the plain
    engine's greedy tokens."""
    _, tcfg, _, tp = gpt
    prompts = [_prompt(80 + i, n, 256) for i, n in enumerate((6, 21))]
    plain = [_toks(r) for r in ttt.serve(None, tp, tcfg, device="cpu", **GPT).run(
        prompts, max_new_tokens=6)]
    eng = ttt.serve(None, tp, tcfg, device="cpu", speculative=ttt.SpecConfig(tp, tcfg, K=2),
                    **GPT)
    assert [_toks(r) for r in eng.run(prompts, max_new_tokens=6)] == plain
    assert eng.stats()["speculative"]["rounds"] > 0
