"""thunder_tpu_torch serving fault recovery against the JAX engine's, on the CPU.

Every fault point the engine passes (``prefill.dispatch``,
``decode.dispatch``, ``harvest``, ``scatter``; ``draft.dispatch`` and
``verify.dispatch`` on the speculative lane) and every fault kind (``fail``,
``nan``, ``oom``, ``hang``) is injected into the port's engine and the JAX
engine with the same plan: the served tokens, finish reasons, error causes,
recoveries, retries and quarantines agree, and greedy tokens after a
recovery equal an unfaulted run's.  Retry exhaustion, the watchdog on a fake
clock, a manual ``recover()``, int8 KV, LoRA, chunked prefill and
multi-step decode recover to the unfaulted tokens (of the port's engine,
which those features' own files hold against the JAX engine's); at temperature > 0 the
port's recovered tokens equal its unfaulted ones (each generator is
restored to its last harvest).  The arenas keep their addresses through a
recovery (zeroed in place), which captured CUDA graphs rely on.
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
from thunder_tpu.models import llama as jllama
from thunder_tpu.serving import FaultPlan as JFaultPlan
from thunder_tpu.serving import FaultSpec as JFaultSpec
from thunder_tpu.serving import RetryPolicy as JRetryPolicy
from thunder_tpu.serving import SpecConfig as JSpecConfig
from thunder_tpu_torch.observability.metrics import registry
from thunder_tpu_torch.serving.faults import (
    FAULT_KINDS,
    FP_DECODE,
    FP_DRAFT,
    FP_HARVEST,
    FP_PREFILL,
    FP_SCATTER,
    FP_VERIFY,
    FaultPlan,
    FaultSpec,
    RecoveryError,
    RetryPolicy,
    resolve_fault_plan,
)
from thunder_tpu_torch.serving.lora import _target_features
from torch_port_threads import one_torch_thread  # noqa: F401

MICRO = dict(
    n_layer=2, n_head=4, n_query_groups=2, n_embd=32,
    intermediate_size=64, vocab_size=64, block_size=64,
)
ENGINE = dict(block_size=4, num_blocks=32, max_batch=4, batch_buckets=(4,), block_buckets=(6,),
              prefill_buckets=(8, 16))
P0 = np.arange(1, 7, dtype=np.int32)
P1 = np.arange(3, 12, dtype=np.int32)
SERVE_POINTS = (FP_PREFILL, FP_DECODE, FP_HARVEST, FP_SCATTER)


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


@pytest.fixture(scope="module")
def micro():
    jcfg = jllama.Config.from_name("tiny-llama-debug", **MICRO)
    tcfg = ttt.Config.from_name("tiny-llama-debug", **MICRO)
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = ttt.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _jax(jcfg, jp, plan=None, slept=None, **kw):
    retry = kw.pop("retry", None) or JRetryPolicy(
        sleep=(slept.append if slept is not None else (lambda s: None)))
    jplan = None if plan is None else JFaultPlan(
        specs=[JFaultSpec(**vars(s)) for s in plan.specs])
    return tt.serve(None, jp, jcfg, cache_dtype=jnp.float32, fault_plan=jplan, retry=retry,
                    **{**ENGINE, **kw})


def _port(tcfg, tp, plan=None, slept=None, **kw):
    retry = kw.pop("retry", None) or RetryPolicy(
        sleep=(slept.append if slept is not None else (lambda s: None)))
    return ttt.serve(None, tp, tcfg, device="cpu", fault_plan=plan, retry=retry,
                     **{**ENGINE, **kw})


def _serve(eng, prompts=(P0, P1), n=8, **submit_kw):
    handles = [eng.submit(p, max_new_tokens=n, **submit_kw) for p in prompts]
    eng.drain()
    return [h.result(drive=False) for h in handles]


def _summary(eng, results):
    """What a faulted serve must agree on across the two engines."""
    return {
        "tokens": [tuple(int(t) for t in r.new_tokens) for r in results],
        "finish": [r.finish_reason for r in results],
        "errors": [None if r.error is None else
                   {k: r.error[k] for k in ("type", "point", "kind", "rids", "injected")}
                   for r in results],
        "recoveries": eng.stats()["recoveries"],
        "injected": eng.stats()["faults"]["injected"],
    }


def _pool_clean(eng):
    return eng.pool.num_free == eng.pool.num_usable


@pytest.fixture(scope="module")
def clean_tokens(micro):
    jcfg, _, jp, _ = micro
    return [tuple(int(t) for t in r.new_tokens) for r in _serve(_jax(jcfg, jp))]


@pytest.mark.parametrize("kind", FAULT_KINDS)
@pytest.mark.parametrize("point", SERVE_POINTS)
def test_fault_point_and_kind_agree_with_jax_engine(micro, clean_tokens, point, kind):
    """One fault per point and kind (a ``nan`` blames request 0): the
    port's engine absorbs it as the JAX engine does — quarantine, retry
    with the same backoff, or recovery — and serves the same tokens; every
    request that was not quarantined serves the unfaulted tokens."""
    jcfg, tcfg, jp, tp = micro
    plan = FaultPlan(specs=[FaultSpec(point=point, kind=kind, at=2,
                                      rid=0 if kind == "nan" else None)])
    jslept, tslept = [], []
    jeng = _jax(jcfg, jp, plan, jslept)
    want = _summary(jeng, _serve(jeng))
    reg = registry()
    reg.reset()
    teng = _port(tcfg, tp, plan, tslept, flight_recorder=True)
    got = _summary(teng, _serve(teng))
    assert got == want
    assert tslept == jslept
    for toks, fin, ref in zip(got["tokens"], got["finish"], clean_tokens):
        assert toks == ref if fin != "error" else toks == ref[:len(toks)]
    snap = reg.snapshot("serving.faults.")
    n = got["injected"]
    assert snap.get("serving.faults.injected", 0) == snap.get("serving.faults.observed", 0) == n
    assert snap.get("serving.faults.recoveries", 0) == got["recoveries"]
    events = [e["kind"] for e in teng._flight.events()]
    assert ("fault" in events) == bool(n)
    assert ("recovered" in events) == (got["recoveries"] > 0)
    assert _pool_clean(teng)


@pytest.mark.parametrize("kind", ["fail", "oom"])
@pytest.mark.parametrize("point", [FP_DRAFT, FP_VERIFY, FP_SCATTER])
def test_speculative_fault_points_agree_with_jax_engine(micro, point, kind):
    jcfg, tcfg, jp, tp = micro
    jdcfg = jllama.Config.from_name("tiny-llama-debug", **{**MICRO, "n_layer": 1})
    tdcfg = ttt.Config.from_name("tiny-llama-debug", **{**MICRO, "n_layer": 1})
    jdp = {**jp, "blocks": jp["blocks"][:1]}
    tdp = {**tp, "blocks": tp["blocks"][:1]}
    plan = FaultPlan(specs=[FaultSpec(point=point, kind=kind, at=2)])
    spec_kw = dict(num_blocks=64, block_buckets=(8,))
    jeng = _jax(jcfg, jp, plan, speculative=JSpecConfig(jdp, jdcfg, K=2), **spec_kw)
    want = _summary(jeng, _serve(jeng))
    teng = _port(tcfg, tp, plan, speculative=ttt.SpecConfig(tdp, tdcfg, K=2), **spec_kw)
    assert _summary(teng, _serve(teng)) == want
    clean = _port(tcfg, tp, speculative=ttt.SpecConfig(tdp, tdcfg, K=2), **spec_kw)
    assert want["tokens"] == [tuple(int(t) for t in r.new_tokens) for r in _serve(clean)]


def test_transient_prefill_fault_retries_with_backoff(micro, clean_tokens):
    _, tcfg, _, tp = micro
    slept = []
    eng = _port(tcfg, tp, FaultPlan(specs=[FaultSpec(point=FP_PREFILL, kind="fail", count=2)]),
                retry=RetryPolicy(backoff_s=0.05, multiplier=2.0, sleep=slept.append))
    res = _serve(eng)
    assert [tuple(r.new_tokens) for r in res] == clean_tokens
    assert slept == [0.05, 0.1] and eng.recoveries == 0


def test_retry_exhaustion_escalates_to_recovery(micro, clean_tokens):
    jcfg, tcfg, jp, tp = micro
    plan = FaultPlan(specs=[FaultSpec(point=FP_DECODE, kind="fail", at=2, count=2)])
    jeng = _jax(jcfg, jp, plan, retry=JRetryPolicy(max_retries=1, sleep=lambda s: None))
    want = _summary(jeng, _serve(jeng))
    teng = _port(tcfg, tp, plan, retry=RetryPolicy(max_retries=1, sleep=lambda s: None))
    got = _summary(teng, _serve(teng))
    assert got == want and got["recoveries"] >= 1
    assert got["tokens"] == clean_tokens


def test_recovery_that_keeps_failing_raises(micro):
    """A sync engine re-prefills inline during its recovery: a prefill
    that keeps failing exhausts the recovery's retries, as in the JAX
    engine."""
    jcfg, tcfg, jp, tp = micro
    plan = FaultPlan(specs=[FaultSpec(point=FP_PREFILL, kind="oom", count=8)], max_faults=20)
    jeng = _jax(jcfg, jp, plan, retry=JRetryPolicy(max_retries=1, sleep=lambda s: None),
                async_step=False)
    jeng.submit(P0, max_new_tokens=4)
    with pytest.raises(tt.serving.RecoveryError):
        jeng.drain()
    teng = _port(tcfg, tp, plan, retry=RetryPolicy(max_retries=1, sleep=lambda s: None),
                 async_step=False)
    teng.submit(P0, max_new_tokens=4)
    with pytest.raises(RecoveryError, match="failed 2 times"):
        teng.drain()


def test_watchdog_on_a_fake_clock_recovers(micro, clean_tokens):
    _, tcfg, _, tp = micro
    now = [0.0]
    eng = _port(tcfg, tp, clock=lambda: now[0], watchdog_timeout_s=5.0)
    handles = [eng.submit(p, max_new_tokens=8) for p in (P0, P1)]
    steps = 0
    while not all(h.done() for h in handles):
        eng.step()
        steps += 1
        if steps == 2:
            now[0] += 100.0                            # the in-flight decode is now "hung"
    assert [tuple(h.result(drive=False).new_tokens) for h in handles] == clean_tokens
    assert eng.recoveries == 1 and _pool_clean(eng)


def test_manual_recover_keeps_arena_addresses(micro, clean_tokens):
    _, tcfg, _, tp = micro
    eng = _port(tcfg, tp)
    handles = [eng.submit(p, max_new_tokens=8) for p in (P0, P1)]
    for _ in range(4):
        eng.step()
    ptrs = {k: t.data_ptr() for k, t in eng.pool.arenas.items()}
    eng.recover()
    assert {k: t.data_ptr() for k, t in eng.pool.arenas.items()} == ptrs
    eng.drain()
    assert [tuple(h.result(drive=False).new_tokens) for h in handles] == clean_tokens
    assert eng.recoveries == 1


def test_unclassified_exception_dumps_the_flight_record_and_raises(micro, tmp_path,
                                                                    monkeypatch):
    _, tcfg, _, tp = micro
    monkeypatch.setenv("THUNDER_TPU_FLIGHT_DIR", str(tmp_path))
    eng = _port(tcfg, tp, flight_recorder=True)
    eng.submit(P0, max_new_tokens=4)

    def boom():
        raise KeyError("programming bug")

    eng._decode_dispatch = boom
    with pytest.warns(UserWarning, match="flight record dumped"), pytest.raises(KeyError):
        eng.drain()
    (dump,) = list(tmp_path.glob("tt_flight_*.json"))
    rec = json.loads(dump.read_text())
    assert rec["reason"] == "crash" and rec["error"]["type"] == "KeyError"
    assert rec["state"]["scheduler"]["decode_horizon"] == 1
    assert set(rec["state"]["lanes"]) >= {"decode_inflight", "prefill_inflight", "prefilling"}


def test_fault_plan_forms_and_off_path(micro, monkeypatch):
    _, tcfg, _, tp = micro
    assert resolve_fault_plan(None) is None and resolve_fault_plan(False) is None
    one = resolve_fault_plan({"point": FP_DECODE, "kind": "oom"})
    assert len(one.specs) == 1 and one.specs[0].kind == "oom"
    assert resolve_fault_plan({"seed": 3, "rate": 0.5}).rate == 0.5
    assert len(resolve_fault_plan([{"point": FP_HARVEST}, FaultSpec(point=FP_SCATTER)]).specs) == 2
    monkeypatch.setenv("THUNDER_TPU_FAULT_PLAN", json.dumps({"point": FP_DECODE, "at": 10_000}))
    armed = _port(tcfg, tp)
    assert armed.stats()["faults"]["injected"] == 0 and armed.stats()["faults"]["specs"] == 1
    monkeypatch.delenv("THUNDER_TPU_FAULT_PLAN")
    assert _port(tcfg, tp).stats()["faults"] is None
    with pytest.raises(TypeError, match="fault_plan"):
        _port(tcfg, tp, plan=42)


#
# recovery parity across the serving features
#


def _factors(cfg, seed, targets=("wq", "wv")):
    rng = np.random.default_rng(seed)
    return {t: ((rng.standard_normal((cfg.n_layer, 2, _target_features(cfg, t)[0])) * 0.5)
                .astype(np.float32),
                (rng.standard_normal((cfg.n_layer, _target_features(cfg, t)[1], 2)) * 0.5)
                .astype(np.float32)) for t in targets}


@pytest.mark.parametrize("feature", ["int8", "lora", "chunked", "multistep", "gather", "sync"])
def test_recovery_parity_across_features(micro, feature):
    """A decode OOM and a scatter fault mid-serve: two recoveries, and the
    tokens of the same engine unfaulted (which the feature's own test file
    holds against the JAX engine: ``test_torch_port_{quant,lora,chunk_spec,
    multistep,serving}.py``)."""
    _, tcfg, _, tp = micro
    kw, submit = {}, {}
    prompts = (P0, P1)
    if feature == "int8":
        kw = dict(kv_dtype="int8")
    elif feature == "lora":
        treg = ttt.AdapterRegistry(tcfg, rank=2, max_adapters=2, targets=("wq", "wv"),
                                   device="cpu")
        treg.register("a", _factors(tcfg, 5))
        kw, submit = dict(lora=treg), dict(adapter_id="a")
    elif feature == "chunked":
        kw = dict(prefill_chunk=8)
        prompts = (np.arange(1, 14, dtype=np.int32), P0)
    elif feature == "multistep":
        kw = dict(decode_steps=3)
    elif feature == "gather":
        kw = dict(attn="gather")
    else:
        kw = dict(async_step=False)
    plan = FaultPlan(specs=[FaultSpec(point=FP_DECODE, kind="oom", at=2),
                            FaultSpec(point=FP_SCATTER, kind="fail", at=4)])
    teng = _port(tcfg, tp, plan, **kw)
    got = _summary(teng, _serve(teng, prompts, **submit))
    assert got["recoveries"] == got["injected"] == 2 and set(got["finish"]) == {"length"}
    clean = _port(tcfg, tp, **kw)
    assert got["tokens"] == [tuple(r.new_tokens) for r in _serve(clean, prompts, **submit)]
    assert _pool_clean(teng)


@pytest.mark.parametrize("point", SERVE_POINTS)
def test_temperature_recovers_to_the_unfaulted_draws(micro, point):
    """A port generator advances at dispatch: the recovery restores each
    request's generator to its last harvest, so the replayed draws — and
    every later one — are the unfaulted run's."""
    _, tcfg, _, tp = micro

    def serve(plan=None, **kw):
        eng = _port(tcfg, tp, plan, temperature=0.9, **kw)
        hs = [eng.submit(p, max_new_tokens=9, generator=torch.Generator().manual_seed(5 + i))
              for i, p in enumerate((P0, P1))]
        eng.drain()
        return [h.result(drive=False).new_tokens for h in hs], eng

    clean, _ = serve()
    for kw in ({}, {"decode_steps": 2}):
        got, eng = serve(FaultPlan(specs=[FaultSpec(point=point, kind="oom", at=2)]), **kw)
        assert got == clean and eng.recoveries == 1


def test_seeded_chaos_soak_no_divergence_no_leaks(micro):
    jcfg, tcfg, jp, tp = micro
    treg = ttt.AdapterRegistry(tcfg, rank=2, max_adapters=2, targets=("wq", "wv"), device="cpu")
    treg.register("a", _factors(tcfg, 5))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 64, (n,)).astype(np.int32) for n in (3, 6, 9, 5)]
    adapters = [None, "a", None, "a"]

    def drive(plan=None):
        eng = _port(tcfg, tp, plan, kv_dtype="int8", lora=treg, temperature=0.6)
        hs = [eng.submit(p, max_new_tokens=6, adapter_id=a,
                         generator=torch.Generator().manual_seed(100 + i))
              for i, (p, a) in enumerate(zip(prompts, adapters))]
        eng.drain()
        return eng, [h.result(drive=False) for h in hs]

    _, refs = drive()
    for seed in (1, 2):
        eng, results = drive(FaultPlan(seed=seed, rate=0.1, max_faults=4))
        for ref, res in zip(refs, results):
            if res.finish_reason == "error":
                assert res.new_tokens == ref.new_tokens[:len(res.new_tokens)]
                assert res.error is not None
            else:
                assert res.new_tokens == ref.new_tokens, f"seed={seed}"
        assert _pool_clean(eng) and not eng.scheduler.running and not eng.scheduler.queue


def test_error_finish_reaches_slo_telemetry_and_trace(micro):
    from thunder_tpu_torch.observability.events import clear_events, events
    from thunder_tpu_torch.observability.telemetry import StepLogger

    _, tcfg, _, tp = micro
    sink = io.StringIO()
    clear_events()
    eng = _port(tcfg, tp, FaultPlan(specs=[FaultSpec(point=FP_DECODE, kind="nan", at=2,
                                                      rid=0)]),
                slo={"ttft_s": 60.0, "tpot_s": 60.0}, telemetry=StepLogger(sink), trace=True)
    res = _serve(eng)
    assert res[0].finish_reason == "error" and res[1].finish_reason == "length"
    rep = eng.slo_report()
    for dim in ("ttft_s", "tpot_s"):
        assert rep["dimensions"][dim]["bad"] == 1 and rep["dimensions"][dim]["good"] == 1
    recs = [json.loads(line) for line in sink.getvalue().splitlines()]
    req0 = next(r for r in recs if r.get("event") == "request" and r["rid"] == 0)
    assert req0["finish_reason"] == "error" and req0["error"]["kind"] == "nan"
    finishes = [e for e in events() if e.get("name") == "finish"]
    assert any((e.get("args") or {}).get("error") == "RequestAnomalyFault" for e in finishes)


def test_shutdown_discards_inflight_records(micro):
    _, tcfg, _, tp = micro
    eng = _port(tcfg, tp, prefill_chunk=8)
    eng.submit(P0, max_new_tokens=8)
    eng.submit(np.arange(1, 14, dtype=np.int32), max_new_tokens=8)
    for _ in range(3):
        eng.step()
    assert eng._inflight_decode is not None or eng._inflight_prefill
    eng.shutdown(drain=False)
    assert eng._inflight_decode is None and eng._inflight_prefill == []
    assert _pool_clean(eng)


@pytest.mark.parametrize("name", ["tiny-mistral-debug", "tiny-falcon-debug", "tiny-pythia-debug",
                                  "tiny-gemma-debug"])
def test_family_recovery_equals_jax_engine(name):
    """A decode OOM mid-serve on the paged lane for the Mistral (window
    crossed before the fault), Falcon, Pythia and Gemma families: one
    recovery, and the JAX engine's recovered tokens, which are its
    unfaulted ones."""
    from test_torch_port_multistep import FAMILY_ENGINE, family_models, family_prompts

    jcfg, tcfg, jp, tp = family_models(name)
    prompts = family_prompts()
    plan = FaultPlan(specs=[FaultSpec(point=FP_DECODE, kind="oom", at=6)])
    jplan = JFaultPlan(specs=[JFaultSpec(**vars(s)) for s in plan.specs])
    retry = dict(retry=JRetryPolicy(sleep=lambda s: None))
    jeng = tt.serve(None, jp, jcfg, cache_dtype=jnp.float32, attn="gather", fault_plan=jplan,
                    **retry, **FAMILY_ENGINE)
    want = _summary(jeng, _serve(jeng, prompts))
    teng = ttt.serve(None, tp, tcfg, device="cpu", attn="paged", fault_plan=plan,
                     retry=RetryPolicy(sleep=lambda s: None), **FAMILY_ENGINE)
    got = _summary(teng, _serve(teng, prompts))
    assert got == want and got["recoveries"] == 1
    clean = ttt.serve(None, tp, tcfg, device="cpu", attn="paged", **FAMILY_ENGINE)
    assert got["tokens"] == [tuple(r.new_tokens) for r in _serve(clean, prompts)]
    assert _pool_clean(teng)
