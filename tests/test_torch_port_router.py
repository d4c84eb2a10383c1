"""thunder_tpu_torch's replica router (``serve(..., replicas=N)``) against the JAX package's, on the CPU.

The port's :class:`ReplicatedEngine` and the JAX package's serve the same
requests (a tiny config in float32, prompts drawn with numpy from seeds)
with the same router settings: greedy tokens are exact, and the replica
each request lands on, the router's counters (routed, affinity hits,
routed by replica, expired) and the lanes' prefix hits equal the
reference's.  The scenarios mirror ``tests/test_serving_router.py`` and
the router part of ``tests/test_serving_sessions.py``: prefix-family
affinity, routing history, least-loaded spread, session affinity and the
fleet-wide release of a dead session, per-replica ``fault_plans`` (a
retried fault and a recovery on one lane), eviction of a routed and of a
pending request, router-side deadline expiry, stalls that name their lane,
class-ordered global queueing, the aggregate statistics and the goodput
report.  Sampled requests keep their own generators: at temperature 0.8
routed tokens equal a solo engine's.  Each lane has its own step graphs
on the card (they hold its arenas' addresses), so the reference's shared
program cache has no counterpart here.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import thunder_tpu as tt
import thunder_tpu_torch as ttt
from thunder_tpu.models import generate as jgen
from thunder_tpu.models import llama as jllama
from thunder_tpu.serving import FaultPlan as JFaultPlan
from thunder_tpu.serving import FaultSpec as JFaultSpec
from thunder_tpu.serving import RetryPolicy as JRetryPolicy
from thunder_tpu_torch.observability.metrics import registry
from thunder_tpu_torch.serving import (
    AdmissionError,
    EngineStalledError,
    FaultPlan,
    FaultSpec,
    ReplicatedEngine,
    RetryPolicy,
    ServingEngine,
)
from torch_port_threads import one_torch_thread  # noqa: F401

MICRO = dict(n_layer=1, n_head=2, n_embd=16, intermediate_size=32, vocab_size=32, block_size=64)
FLEET = dict(replicas=2, block_size=4, num_blocks=16, max_batch=2, batch_buckets=(4,),
             block_buckets=(4, 16), prefill_buckets=(8, 16, 64))


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


@pytest.fixture(scope="module")
def micro():
    jcfg = jllama.Config.from_name("tiny-llama-debug", **MICRO)
    tcfg = ttt.Config.from_name("tiny-llama-debug", **MICRO)
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = ttt.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(0, 32, (n,)).astype(np.int32)


def _family(n, length=8):
    """n prompts sharing a block-aligned prefix (distinct last token)."""
    base = _prompt(77, length)
    out = []
    for i in range(n):
        p = base.copy()
        p[-1] = (i + 1) % 32
        out.append(p)
    return out


def _jax(pair, **kw):
    jcfg, _, jp, _ = pair
    return tt.serve(None, jp, jcfg, cache_dtype=jnp.float32, **{**FLEET, **kw})


def _port(pair, **kw):
    _, tcfg, _, tp = pair
    return ttt.serve(None, tp, tcfg, device="cpu", **{**FLEET, **kw})


def _both(pair, scenario, jkw=None, tkw=None, **kw):
    return (scenario(_jax(pair, **kw, **(jkw or {}))),
            scenario(_port(pair, **kw, **(tkw or {}))))


def _toks(res):
    return tuple(int(t) for t in res.new_tokens)


def _summary(fleet, handles):
    st = fleet.stats()
    return {"tokens": [_toks(h.result(drive=False)) for h in handles],
            "finish": [h.result(drive=False).finish_reason for h in handles],
            "lanes": [h.replica for h in handles],
            "router": {k: st["router"][k] for k in ("routed", "affinity_hits", "expired",
                                                     "routed_by_replica", "queue_depth")},
            "prefix_hits": [p["prefix_hits"] for p in st["per_replica"]]}


def test_serve_dispatch(micro):
    _, tcfg, _, tp = micro
    fleet = _port(micro)
    assert isinstance(fleet, ReplicatedEngine) and fleet.replicas == 2
    assert [e.replica_id for e in fleet.engines] == [0, 1]
    assert fleet.stats()["per_replica"][1]["replica"] == 1
    solo = _port(micro, replicas=1)
    assert isinstance(solo, ServingEngine) and "replica" not in solo.stats()
    with pytest.raises(ValueError, match="fault_plans"):
        _port(micro, fault_plan=FaultPlan(specs=[FaultSpec(point="decode.dispatch")]))
    with pytest.raises(ValueError, match="fault_plans"):
        _port(micro, fault_plans=[None])
    with pytest.raises(ValueError, match="fault_plans"):
        _port(micro, replicas=1, fault_plans=[None])
    with pytest.raises(NotImplementedError, match="mesh"):
        _port(micro, mesh=object())


@pytest.mark.parametrize("kv", [None, "int8"], ids=["f32", "int8"])
def test_routed_tokens_equal_jax_router_and_solo(micro, kv):
    reqs = [(_prompt(s, n), 7) for s, n in [(1, 5), (2, 8), (3, 3), (4, 6)]]

    def scenario(fleet):
        hs = [fleet.submit(p, max_new_tokens=n) for p, n in reqs]
        fleet.drain()
        return _summary(fleet, hs)

    want, got = _both(micro, scenario, kv_dtype=kv)
    assert got == want
    solo = _port(micro, replicas=1, max_batch=4, num_blocks=32, kv_dtype=kv)
    assert [_toks(r) for r in solo.run([{"prompt": p, "max_new_tokens": n}
                                        for p, n in reqs])] == got["tokens"]


@pytest.mark.parametrize("case", ["family", "history", "spread"])
def test_routing_policy_equals_jax_router(micro, case):
    """Resident affinity keeps a prefix family on one lane; the routing
    history sends a family member to its old lane after the family
    finished; distinct requests spread least-loaded.  The lanes and the
    router's counters equal the JAX router's."""
    def scenario(fleet):
        if case == "family":
            hs = [fleet.submit(p, max_new_tokens=4) for p in _family(3)]
            fleet.drain()
        elif case == "history":
            fam = _family(2)
            hs = [fleet.submit(fam[0], max_new_tokens=3)]
            fleet.drain()
            hs.append(fleet.submit(fam[1], max_new_tokens=3))
            fleet.drain()
        else:
            hs = [fleet.submit(_prompt(20 + i, 5), max_new_tokens=3) for i in range(4)]
            fleet.drain()
        return _summary(fleet, hs)

    kw = dict(max_batch=4, num_blocks=32) if case != "spread" else {}
    if case == "history":
        kw["prefix_sharing"] = False
    want, got = _both(micro, scenario, **kw)
    assert got == want
    if case == "family":
        assert len(set(got["lanes"])) == 1 and got["router"]["affinity_hits"] >= 2
    elif case == "history":
        assert got["lanes"][0] == got["lanes"][1]
    else:
        assert sorted(got["router"]["routed_by_replica"]) == [2, 2]


def test_temperature_tokens_are_row_local(micro):
    """Each request draws from its own generator: routed tokens equal a
    solo engine's whatever lane and batch company the router picks."""
    p = [_prompt(5, 6)] + [_prompt(6 + i, 4 + i) for i in range(1, 4)]

    def run(eng):
        hs = [eng.submit(q, max_new_tokens=6, generator=torch.Generator().manual_seed(100 + i))
              for i, q in enumerate(p)]
        eng.drain()
        return [_toks(h.result(drive=False)) for h in hs]

    assert run(_port(micro, temperature=0.8)) == run(
        _port(micro, replicas=1, max_batch=4, num_blocks=32, temperature=0.8))


def test_sessions_pin_their_lane_and_die_everywhere(micro):
    """A session's turn 2 routes to the lane holding its parked blocks and
    re-attaches them; a routed eviction and a router-side deadline close
    the session on every lane.  Lanes, tokens and counters equal the JAX
    router's."""
    def scenario(fleet):
        p1 = _prompt(61, 7)
        h1 = fleet.submit(p1, max_new_tokens=4, session_id="sA")
        r1 = h1.result()
        p2 = np.concatenate([p1, np.asarray(r1.new_tokens, np.int32), _prompt(62, 3)])
        h2 = fleet.submit(p2, max_new_tokens=3, session_id="sA")
        h2.result()
        agg = fleet.stats()["aggregate"]
        h3 = fleet.submit(_prompt(63, 7), max_new_tokens=8, session_id="sA")
        for _ in range(3):
            fleet.step()
        fleet.evict(h3)
        evicted_clean = [not e.session_resident("sA") and e.pool.num_free == e.pool.num_usable
                         for e in fleet.engines]
        fleet.submit(_prompt(65, 7), max_new_tokens=4, session_id="sC", deadline=60.0).result()
        h4 = fleet.submit(_prompt(66, 7), max_new_tokens=4, session_id="sC", deadline=-1.0)
        fleet.step()
        return {"lanes": [h1.replica, h2.replica], "turn2": _toks(h2.result(drive=False)),
                "shared": h2.result(drive=False).shared_prefix_blocks,
                "agg": {k: agg[k] for k in ("session_reattach_hits", "session_resident_blocks",
                                            "prefix_hits", "prefix_lookups")},
                "evicted_clean": evicted_clean,
                "deadline": h4.result(drive=False).finish_reason,
                "deadline_clean": [not e.session_resident("sC")
                                   and e.pool.num_free == e.pool.num_usable
                                   for e in fleet.engines],
                "expired": fleet.stats()["router"]["expired"]}

    want, got = _both(micro, scenario, sessions=True)
    assert got == want
    assert got["lanes"][0] == got["lanes"][1] and got["agg"]["session_reattach_hits"] == 1
    assert all(got["evicted_clean"]) and all(got["deadline_clean"])
    assert got["deadline"] == "deadline"


@pytest.mark.parametrize("kind", ["fail", "oom"])
def test_fault_plans_stay_on_their_lane(micro, kind):
    """A fault planned for lane 1 only (a retried ``fail``, a recovering
    ``oom``): lane 0 never sees it, every request finishes, and tokens,
    lanes and each lane's recoveries equal the JAX router's."""
    def scenario(fleet):
        out = fleet.run([{"prompt": _prompt(80 + i, 5), "max_new_tokens": 4}
                         for i in range(4)])
        per = fleet.stats()["per_replica"]
        return {"tokens": [_toks(r) for r in out], "finish": [r.finish_reason for r in out],
                "recoveries": [p["recoveries"] for p in per],
                "injected": [p["faults"]["injected"] if p["faults"] else 0 for p in per]}

    jplan = JFaultPlan(specs=[JFaultSpec(point="decode.dispatch", kind=kind, at=1, count=1)])
    tplan = FaultPlan(specs=[FaultSpec(point="decode.dispatch", kind=kind, at=1, count=1)])
    want, got = _both(micro, scenario,
                      jkw={"fault_plans": [None, jplan],
                           "retry": JRetryPolicy(sleep=lambda s: None)},
                      tkw={"fault_plans": [None, tplan],
                           "retry": RetryPolicy(sleep=lambda s: None)})
    assert got == want
    assert got["injected"] == [0, 1] and set(got["finish"]) == {"length"}
    assert got["recoveries"][0] == 0 and (got["recoveries"][1] >= 1) == (kind == "oom")


def test_eviction_deadline_and_queue_bound(micro):
    """A routed request evicted mid chunked prefill frees its own lane
    only; a pending one gets a synthetic result; a request whose deadline
    lapses in the global queue expires there; the global queue holds
    ``max_queue`` x replicas.  Equal to the JAX router's."""
    def scenario(fleet):
        p = np.arange(40, dtype=np.int32) % 32
        h = fleet.submit(p, max_new_tokens=8)
        fleet.step()
        own, other = fleet.engines[h.replica], fleet.engines[1 - h.replica]
        other_free = other.pool.num_free
        fleet.evict(h)
        out = {"evicted": h.result().finish_reason,
               "own_free": own.pool.num_free == own.pool.num_usable,
               "other_untouched": other.pool.num_free == other_free}
        h2 = fleet.submit(p, max_new_tokens=4)
        out["readmitted"] = (h2.result().finish_reason, h2.replica == h.replica)
        return out

    want, got = _both(micro, scenario, prefill_chunk=8, num_blocks=32, prefix_sharing=False)
    assert got == want == {"evicted": "evicted", "own_free": True, "other_untouched": True,
                           "readmitted": ("length", True)}

    def pending(fleet):
        busy = [fleet.submit(_prompt(41 + i, 4), max_new_tokens=12) for i in range(2)]
        fleet.step()
        h = fleet.submit(_prompt(72, 4), max_new_tokens=4)
        queued = (h.state, h.replica)
        fleet.evict(h)
        late = fleet.submit(_prompt(40, 4), max_new_tokens=4, deadline=1e-6)
        fleet.drain()
        return {"queued": queued, "evicted": h.result(drive=False).finish_reason,
                "late": (late.result(drive=False).finish_reason, late.replica),
                "busy": [_toks(b.result(drive=False)) for b in busy],
                "expired": fleet.stats()["router"]["expired"]}

    want, got = _both(micro, pending, max_batch=1, num_blocks=8)
    assert got == want and got["late"] == ("deadline", None) and got["expired"] == 1
    fleet = _port(micro, max_queue=1)
    with pytest.raises(AdmissionError, match="never be admitted"):
        fleet.submit(_prompt(50, 4), max_new_tokens=10_000)
    for i in range(2):
        fleet.submit(_prompt(51 + i, 4), max_new_tokens=2)
    with pytest.raises(AdmissionError, match="router queue full"):
        fleet.submit(_prompt(53, 4), max_new_tokens=2)
    fleet.drain()


def test_stalls_name_their_lane(micro):
    fleet = _port(micro)
    e0 = fleet.engines[0]
    leak = e0.pool.alloc(e0.pool.num_free - 2)     # 2 blocks left on lane 0
    h = e0.submit(np.arange(4, dtype=np.int32), max_new_tokens=8)
    with pytest.raises(EngineStalledError) as ei:
        fleet.drain()
    assert ei.value.replica == 0 and str(ei.value).startswith("replica 0:")
    assert ei.value.state["pool"]["num_free"] == 2
    e0.pool.free(leak)
    fleet.drain()
    assert h.done()
    fleet = _port(micro)
    leaks = [e.pool.alloc(e.pool.num_free - 1) for e in fleet.engines]
    h = fleet.submit(_prompt(60, 4), max_new_tokens=8)
    with pytest.raises(EngineStalledError) as ei:
        fleet.drain()
    assert ei.value.replica is None and "every replica is idle" in str(ei.value)
    assert ei.value.state["pending"][0]["rid"] == h.rid
    for e, leak in zip(fleet.engines, leaks):
        e.pool.free(leak)
    fleet.drain()
    assert h.done()


def test_priority_queue_aggregate_and_goodput(micro):
    """The global queue orders by class (FIFO within one); the aggregate
    sums the lanes' preemptions and goodput; the router's metrics land in
    the registry.  Lanes and tokens equal the JAX router's."""
    def scenario(fleet):
        busy = [fleet.submit(_prompt(90 + i, 5), max_new_tokens=6) for i in range(2)]
        fleet.step()
        hs = [fleet.submit(_prompt(92 + i, 5), max_new_tokens=3, priority=p)
              for i, p in enumerate(["low", "normal", "high"])]
        order = [h.rid for h in fleet._pending]
        fleet.drain()
        agg = fleet.stats()["aggregate"]
        return {"order": order, "summary": _summary(fleet, busy + hs),
                "preempted": agg["preempted"],
                "committed": agg["goodput"]["committed"] if "goodput" in agg else None,
                "report_replicas": fleet.goodput_report()["replicas"]}

    want, got = _both(micro, scenario, priorities=True, goodput=True, max_batch=1,
                      num_blocks=8)
    assert got == want and got["order"] == [4, 3, 2]
    snap = registry().snapshot()
    assert snap["serving.router.replicas"] == 2 and snap["serving.router.routed"] >= 1
    assert "serving.router.replica1.running" in snap and "serving.router.imbalance" in snap
