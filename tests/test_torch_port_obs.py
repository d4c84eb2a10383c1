"""thunder_tpu_torch serving observability against the JAX engine's, on the CPU.

``trace=``, ``slo=``, ``flight_recorder=``, ``goodput=`` and
``telemetry=`` on the port's engine against the same options on the JAX
engine, serving the same requests with
``tests/test_torch_port_serving.py``'s micro config: the request spans
(names, phases, request ids, lanes, one ``decode`` span per host visit with
its harvested count), the SLO reports, the goodput ledgers (every slot
count, exact; multi-step, padding rows, chunk pieces, a speculative round),
the flight recorder's events and dumps, and the telemetry records are
compared by structure and counts.  Timings differ between the two and are
left out.  The five modules themselves are compared on the same inputs.
"""
from __future__ import annotations

import importlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import thunder_tpu as tt
import thunder_tpu_torch as ttt
from thunder_tpu.models import llama as jllama
from thunder_tpu.observability import flight as jflight
from thunder_tpu.observability import goodput as jgoodput
from thunder_tpu.observability import slo as jslo
from thunder_tpu.observability import telemetry as jtelemetry
from thunder_tpu.serving import SpecConfig as JSpecConfig
from thunder_tpu_torch.observability import events as tevents
from thunder_tpu_torch.observability import flight as tflight
from thunder_tpu_torch.observability import goodput as tgoodput
from thunder_tpu_torch.observability import slo as tslo
from thunder_tpu_torch.observability import telemetry as ttelemetry
from thunder_tpu_torch.serving.faults import FaultPlan, FaultSpec
from torch_port_threads import one_torch_thread  # noqa: F401

# the JAX package's observability namespace exports an ``events`` function
# beside its module of that name
jevents = importlib.import_module("thunder_tpu.observability.events")

MICRO = dict(
    n_layer=2, n_head=4, n_query_groups=2, n_embd=32,
    intermediate_size=64, vocab_size=64, block_size=64,
)
ENGINE = dict(block_size=4, num_blocks=32, max_batch=4, batch_buckets=(4,), block_buckets=(6,),
              prefill_buckets=(8, 16))
LENS = (3, 5, 9)


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


def _prompts(lens=LENS, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 64, (n,)).astype(np.int32) for n in lens]


def _engines(micro, **kw):
    jcfg, tcfg, jp, tp = micro
    jkw = {k: v for k, v in kw.items() if k != "speculative"}
    tkw = dict(jkw)
    if kw.get("speculative"):
        jdcfg = jllama.Config.from_name("tiny-llama-debug", **{**MICRO, "n_layer": 1})
        tdcfg = ttt.Config.from_name("tiny-llama-debug", **{**MICRO, "n_layer": 1})
        jkw["speculative"] = JSpecConfig({**jp, "blocks": jp["blocks"][:1]}, jdcfg, K=2)
        tkw["speculative"] = ttt.SpecConfig({**tp, "blocks": tp["blocks"][:1]}, tdcfg, K=2)
    j = tt.serve(None, jp, jcfg, cache_dtype=jnp.float32, **{**ENGINE, **jkw})
    t = ttt.serve(None, tp, tcfg, device="cpu", **{**ENGINE, **tkw})
    return j, t


def _serve(eng, prompts=None, n=6):
    prompts = _prompts() if prompts is None else prompts
    handles = [eng.submit(p, max_new_tokens=n) for p in prompts]
    eng.drain()
    return [h.result(drive=False) for h in handles]


#
# the engines side by side
#


def _spans(evs):
    """The request spans of the serving plane, timing left out: (ph, name,
    rid, lane, steps, harvested) in order; a cold prefill names its
    dispatch ``prefill.compile`` (a module cache may spare the JAX engine
    that compile)."""
    out = []
    for e in evs:
        if not e.get("cat", "").startswith("serving.request"):
            continue
        a = e.get("args") or {}
        name = "prefill.dispatch" if e["name"] == "prefill.compile" else e["name"]
        out.append((e["ph"], name, e.get("id"), a.get("lane"), a.get("steps"),
                    a.get("harvested"), a.get("reason")))
    return out


@pytest.mark.parametrize("kw", [dict(), dict(decode_steps=4), dict(prefill_chunk=8),
                                dict(speculative=True, num_blocks=64, block_buckets=(8,))],
                         ids=["one-step", "multistep", "chunked", "speculative"])
def test_request_spans_equal_jax_engine(micro, kw):
    prompts = _prompts(lens=(3, 13, 5)) if kw.get("prefill_chunk") else None
    j, t = _engines(micro, trace=True, **kw)
    jevents.clear_events()
    jres = _serve(j, prompts)
    tevents.clear_events()
    tres = _serve(t, prompts)
    assert [r.new_tokens for r in tres] == [r.new_tokens for r in jres]
    want, got = _spans(jevents.events()), _spans(tevents.events())
    assert got == want
    begins = [s for s in got if s[0] == "b" and s[1] == "decode" and s[2] == 0]
    assert len(begins) == sum(1 for s in got if s[0] == "e" and s[1] == "decode" and s[2] == 0)
    engine = [e["name"] for e in tevents.events() if e.get("cat") == "serving.engine"]
    assert engine.count("engine.step") == 2 * t.stats()["step_calls"]


def test_decode_spans_are_per_visit(micro):
    _, t = _engines(micro, trace=True, decode_steps=4)
    tevents.clear_events()
    h = t.submit(_prompts(lens=(5,))[0], max_new_tokens=9)   # 1 prefill + 2 visits
    t.drain()
    assert h.result(drive=False).finish_reason == "length"
    begins = [e for e in tevents.events() if e["ph"] == "b" and e["name"] == "decode"]
    ends = [e for e in tevents.events() if e["ph"] == "e" and e["name"] == "decode"]
    assert len(begins) == len(ends) == t.stats()["host_visits"] == 2
    assert all(e["args"]["steps"] == 4 for e in begins)
    assert sorted(e["args"]["harvested"] for e in ends) == [4, 4]


def test_slo_reports_equal_jax_engine(micro):
    """A frozen clock makes every latency 0: TTFT below -1 s is missed by
    every request, TPOT under 1 s met by all, and one request misses its
    deadline; the reports (counts, windows, burn rates) agree."""
    slo = {"ttft_s": -1.0, "tpot_s": 1.0, "objective": 0.9, "window": 2}
    now = [0.0]
    j, t = _engines(micro, slo=slo, clock=lambda: now[0])
    reports = []
    for eng in (j, t):
        now[0] = 0.0
        hs = [eng.submit(p, max_new_tokens=4) for p in _prompts()]
        late = eng.submit(_prompts(lens=(4,))[0], max_new_tokens=4, deadline=0.5)
        now[0] = 1.0
        eng.drain()
        assert late.result(drive=False).finish_reason == "deadline"
        assert all(h.result(drive=False).finish_reason == "length" for h in hs)
        reports.append(eng.slo_report())
    assert reports[1] == reports[0]
    dims = reports[1]["dimensions"]
    assert dims["ttft_s"]["bad"] == 4 and dims["deadline"]["bad"] == 1
    assert dims["ttft_s"]["burn_rate"] == pytest.approx(10.0)
    assert _engines(micro)[1].slo_report() == {"enabled": False}


@pytest.mark.parametrize("kw", [dict(attn="gather"), dict(attn="gather", decode_steps=4),
                                dict(attn="gather", prefill_chunk=8),
                                dict(attn="gather", speculative=True, num_blocks=64,
                                     block_buckets=(8,)),
                                dict(attn="paged", decode_steps=3)],
                         ids=["one-step", "multistep", "chunked", "speculative", "paged"])
def test_goodput_ledgers_equal_jax_engine(micro, kw):
    """Every slot of every dispatch in the same bucket: committed, padding
    rows and positions, dead scan rows, rejected drafts; exact."""
    prompts = _prompts(lens=(3, 13, 5)) if kw.get("prefill_chunk") else None
    j, t = _engines(micro, goodput=True, **kw)
    jres, tres = _serve(j, prompts, n=7), _serve(t, prompts, n=7)
    assert [r.new_tokens for r in tres] == [r.new_tokens for r in jres]
    want, got = j.stats()["goodput"], t.stats()["goodput"]
    assert got == want
    assert got["violations"] == 0 and got["committed_tokens"] == sum(len(r.new_tokens)
                                                                    for r in tres)
    jrep, trep = j.goodput_report(), t.goodput_report()
    strip = lambda rep: {k: {f: v for f, v in row.items() if "device_s" not in f}  # noqa: E731
                         for k, row in rep["per_kind"].items()}
    assert strip(trep) == strip(jrep)


def test_goodput_charges_a_recovery_replay(micro):
    """A decode OOM: the discarded dispatch and every replayed position are
    charged to ``replay_recovery``, as in the JAX engine."""
    from thunder_tpu.serving import FaultPlan as JFaultPlan
    from thunder_tpu.serving import FaultSpec as JFaultSpec

    jcfg, tcfg, jp, tp = micro
    j = tt.serve(None, jp, jcfg, cache_dtype=jnp.float32, attn="gather", goodput=True,
                 fault_plan=JFaultPlan(specs=[JFaultSpec(point="decode.dispatch", kind="oom",
                                                         at=3)]), **ENGINE)
    t = ttt.serve(None, tp, tcfg, device="cpu", attn="gather", goodput=True,
                  fault_plan=FaultPlan(specs=[FaultSpec(point="decode.dispatch", kind="oom",
                                                        at=3)]), **ENGINE)
    jres, tres = _serve(j), _serve(t)
    assert [r.new_tokens for r in tres] == [r.new_tokens for r in jres]
    assert [(r.tokens_recomputed, r.recompute_causes) for r in tres] == \
        [(r.tokens_recomputed, r.recompute_causes) for r in jres]
    assert t.stats()["goodput"] == j.stats()["goodput"]
    assert t.stats()["goodput"]["waste"]["replay_recovery"] > 0


def _flight_view(events):
    keep = ("rid", "bucket", "batch", "steps", "harvested", "rids", "reason", "new_tokens",
            "blocks", "shared_blocks", "pos", "fault_class", "spec", "accept_len")
    return [(e["kind"], {k: e[k] for k in keep if k in e}) for e in events]


@pytest.mark.parametrize("kw", [dict(), dict(decode_steps=4), dict(prefill_chunk=8)],
                         ids=["one-step", "multistep", "chunked"])
def test_flight_events_and_state_equal_jax_engine(micro, kw):
    prompts = _prompts(lens=(3, 13, 5)) if kw.get("prefill_chunk") else None
    jfr, tfr = jflight.FlightRecorder(capacity=256), tflight.FlightRecorder(capacity=256)
    j, t = _engines(micro, **kw)
    j._flight, t._flight = jfr, tfr
    jfr.state_provider, tfr.state_provider = j._flight_state, t._flight_state
    _serve(j, prompts), _serve(t, prompts)
    assert _flight_view(tfr.events()) == _flight_view(jfr.events())
    js, ts = j._flight_state(), t._flight_state()
    assert set(ts) <= set(js) and set(ts["lanes"]) <= set(js["lanes"])
    assert ts["scheduler"] == js["scheduler"]
    assert ts["engine"]["decode_steps_per_visit"] == js["engine"]["decode_steps_per_visit"]
    # the JAX engine's module cache may spare it a compile; the port keys per engine
    assert {c["kind"] for c in js["compiles"]} <= {c["kind"] for c in ts["compiles"]}


def test_flight_crash_dump_matches_the_reference_layout(micro, tmp_path, monkeypatch):
    monkeypatch.setenv("THUNDER_TPU_FLIGHT_DIR", str(tmp_path))
    dumps = []
    for eng in _engines(micro, flight_recorder=True, decode_steps=2):
        eng.submit(_prompts()[0], max_new_tokens=4)
        eng.step()

        def boom():
            raise KeyError("programming bug")

        eng._decode_dispatch = boom
        with pytest.warns(UserWarning, match="flight record dumped"), pytest.raises(KeyError):
            eng.drain()
        path = max(tmp_path.glob("tt_flight_*.json"), key=lambda p: p.stat().st_mtime_ns)
        dumps.append(json.loads(path.read_text()))
        path.unlink()
    jd, td = dumps
    assert set(td) == set(jd) and td["reason"] == jd["reason"] == "crash"
    assert td["error"] == jd["error"]
    assert [e["kind"] for e in td["events"]] == [e["kind"] for e in jd["events"]]
    assert td["state"]["scheduler"]["decode_horizon"] == 2


def test_telemetry_records_equal_jax_engine(micro):
    sinks = io.StringIO(), io.StringIO()
    jcfg, tcfg, jp, tp = micro
    j = tt.serve(None, jp, jcfg, cache_dtype=jnp.float32,
                 telemetry=jtelemetry.StepLogger(sinks[0]), **ENGINE)
    t = ttt.serve(None, tp, tcfg, device="cpu",
                  telemetry=ttelemetry.StepLogger(sinks[1]), **ENGINE)
    _serve(j), _serve(t)
    drop = ("time", "ttft_s", "tpot_s", "tokens_per_sec", "queue_s", "e2e_s",
            "prefill_compiled")
    recs = [[{k: v for k, v in json.loads(line).items() if k not in drop}
             for line in s.getvalue().splitlines()] for s in sinks]
    assert recs[1] == recs[0] and len(recs[1]) == len(LENS)
    assert all(r["v"] == ttelemetry.REQUEST_SCHEMA_V for r in recs[1])


def test_telemetry_path_is_owned_and_closed(micro, tmp_path):
    _, tcfg, _, tp = micro
    t = ttt.serve(None, tp, tcfg, device="cpu", telemetry=str(tmp_path / "serve.jsonl"), **ENGINE)
    _serve(t)
    t.shutdown()
    lines = [json.loads(x) for x in (tmp_path / "serve.jsonl").read_text().splitlines()]
    assert lines[0]["event"] == "run_start" and lines[0]["kind"] == "serving"
    assert [x["event"] for x in lines[1:]] == ["request"] * len(LENS)
    assert t.telemetry._f.closed


#
# the modules on the same inputs
#


def test_slo_monitor_equals_reference():
    from types import SimpleNamespace

    cfg = dict(ttft_s=0.2, tpot_s=0.05, queue_s=0.1, objective=0.8, window=3)
    jm, tm = jslo.resolve_slo(cfg), tslo.resolve_slo(cfg)
    rng = np.random.default_rng(0)
    for i in range(7):
        r = SimpleNamespace(ttft_s=float(rng.uniform(0, 0.4)), tpot_s=float(rng.uniform(0, 0.1)),
                            queue_s=None if i == 3 else float(rng.uniform(0, 0.2)),
                            finish_reason=("deadline", "length", "error")[i % 3])
        jm.observe(r)
        tm.observe(r)
        assert tm.report() == jm.report()
    assert tslo.resolve_slo(None) is None and isinstance(tslo.resolve_slo(True), tslo.SLOMonitor)
    with pytest.raises(ValueError, match="objective"):
        tslo.SLOConfig(objective=1.0)


def test_goodput_ledger_equals_reference():
    jl, tl = jgoodput.resolve_goodput(True), tgoodput.resolve_goodput({"strict": True})
    cases = [("decode", 4, 1, dict(committed=3, pad_row=1)),
             ("decode_multi", 4, 4, dict(committed=9, pad_row=4, dead_scan_row=3)),
             ("prefill", 1, 16, dict(committed=9, pad_prefill=7)),
             ("verify_paged", 2, 3, dict(committed=3, draft_rejected=3))]
    for kind, rows, pos, kw in cases:
        assert tl.account(kind, rows, pos, **kw) == jl.account(kind, rows, pos, **kw)
    for led in (jl, tl):
        led.commit_tokens(12)
        led.note_blocks("decode_paged", 24, 10)
        led.note_device_s("decode", 0.5)
    assert tl.report() == jl.report() and tl.brief() == jl.brief()
    with pytest.raises(tgoodput.ConservationError):
        tl.account("decode", 2, 1, committed=1)
    assert tgoodput.fleet_goodput([tl.snapshot()] * 2) == \
        jgoodput.fleet_goodput([jl.snapshot()] * 2)


def test_flight_recorder_and_step_logger_equal_reference(tmp_path):
    jr = jflight.FlightRecorder(capacity=3, state_provider=lambda: {"x": 1})
    tr = tflight.FlightRecorder(capacity=3, state_provider=lambda: {"x": 1})
    for rec in (jr, tr):
        for i in range(5):
            rec.record("decode", step=i)
    strip = lambda evs: [{k: v for k, v in e.items() if k != "ts"} for e in evs]  # noqa: E731
    assert strip(tr.events()) == strip(jr.events())
    snap_j, snap_t = jr.snapshot(reason="manual"), tr.snapshot(reason="manual")
    assert set(snap_t) == set(snap_j) and snap_t["state"] == snap_j["state"]
    assert tflight.active_recorder() is tr
    path = tflight.flight_record(tmp_path / "f.json")
    assert json.loads(open(path).read())["events_recorded"] == 5
    sinks = io.StringIO(), io.StringIO()
    for cls, sink in ((jtelemetry.StepLogger, sinks[0]), (ttelemetry.StepLogger, sinks[1])):
        log = cls(sink, meta={"kind": "t"})
        log.log_step(1, loss=2.0, step_time_s=0.5, tokens=100)
        log.log_request(rid=3, prompt_tokens=4, new_tokens=5, finish_reason="eos", ttft_s=None)
    recs = [[{k: v for k, v in json.loads(x).items() if k != "time"}
             for x in s.getvalue().splitlines()] for s in sinks]
    assert recs[1] == recs[0]


#
# the options the engine took over from its deferred list
#


OPTIONS = [
    ("decode_steps", 2), ("fault_plan", FaultPlan()), ("retry", ttt.serving.faults.RetryPolicy()),
    ("watchdog_timeout_s", 60.0), ("trace", True), ("slo", {"ttft_s": 1.0}),
    ("flight_recorder", True), ("goodput", True), ("telemetry", "telemetry"),
]


@pytest.mark.parametrize("name,value", OPTIONS, ids=[o[0] for o in OPTIONS])
def test_ported_engine_options_serve(micro, tmp_path, name, value):
    """Every engine option of the multi-step, recovery and observability
    layers serves through ``serve()`` and leaves the tokens as they
    were."""
    _, tcfg, _, tp = micro
    if name == "telemetry":
        value = str(tmp_path / "serve.jsonl")
    eng = ttt.serve(None, tp, tcfg, device="cpu", **{**ENGINE, name: value})
    plain = ttt.serve(None, tp, tcfg, device="cpu", **ENGINE)
    assert [r.new_tokens for r in _serve(eng)] == [r.new_tokens for r in _serve(plain)]
    eng.shutdown()
