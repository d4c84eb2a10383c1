"""Del-aware buffer donation (``executors/donation.py``, ``jit(...,
donate=)``, ``TrainStep``'s report) against the JAX package on the CPU.

The 24 scenarios of ``tests/test_donation.py``, each run through both
packages: the hand-built lowered traces of the analysis (the same trace
built in each package's IR) give equal donation summaries — donated names,
bytes, alias hints and rejections by reason; ``jit(donate=...)`` donates
the same buffers as the reference and consumes the caller's tensors (their
storage released), whose reuse raises :class:`DonationError` naming the
input; donated results equal undonated ones; the setting salts the
dispatch key; the memory timeline's donated integers equal the reference's;
``TrainStep`` publishes its report.  The reference's JAX-only warning
filter has no counterpart: the scenario that tested it checks its absence.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import thunder_tpu as tt
import thunder_tpu_torch as ttt
from thunder_tpu import distributed as rdist
from thunder_tpu.core import dtypes as rdtypes, prims as rprims
from thunder_tpu.core.proxies import TensorProxy as RTensorProxy
from thunder_tpu.core.symbol import Symbol as RSymbol
from thunder_tpu.core.trace import TraceCtx as RTraceCtx, tracectx as rtracectx
from thunder_tpu.executors import donation as rdonation
from thunder_tpu_torch.core import dtypes as pdtypes, prims as pprims
from thunder_tpu_torch.core.proxies import TensorProxy as PTensorProxy
from thunder_tpu_torch.core.symbol import Symbol as PSymbol
from thunder_tpu_torch.core.trace import TraceCtx as PTraceCtx, tracectx as ptracectx
from thunder_tpu_torch.executors import donation as pdonation
from thunder_tpu_torch.observability.metrics import registry as pregistry
from torch_port_threads import one_torch_thread  # noqa: F401

REF = dict(dtypes=rdtypes, prims=rprims, TensorProxy=RTensorProxy, Symbol=RSymbol,
           TraceCtx=RTraceCtx, tracectx=rtracectx, donation=rdonation)
PORT = dict(dtypes=pdtypes, prims=pprims, TensorProxy=PTensorProxy, Symbol=PSymbol,
            TraceCtx=PTraceCtx, tracectx=ptracectx, donation=pdonation)


@pytest.fixture(autouse=True)
def _leave_jax_caches_as_found():
    """The JAX package's module caches, which other files count entries of."""
    from thunder_tpu.models import generate as jgen
    from thunder_tpu.serving import engine as jengine

    before = dict(jgen._generate_cache), dict(jengine._program_cache)
    yield
    for cache, saved in zip((jgen._generate_cache, jengine._program_cache), before):
        cache.clear()
        cache.update(saved)


#
# the analysis, on hand-built lowered traces in each package's IR
#

def _proxies(ir, *names, shape=(4, 4)):
    tr = ir["TraceCtx"](lambda *a: None)
    with ir["tracectx"](tr):
        ps = tuple(ir["TensorProxy"](name=n, shape=shape, device="cpu",
                                     dtype=ir["dtypes"].float32) for n in names)
    return tr, ps


def _fusion(ir, name, inputs, outputs):
    return ir["Symbol"](name=name, meta=None, is_fusion=True).bind(*inputs, output=tuple(outputs))


def _two_regions(ir, move_a_into_region2):
    """region1(a, b) -> t2 ; region2(t2, b[, a]) -> t3 ; return t3."""
    tr, (a, b, t2, t3) = _proxies(ir, "a", "b", "t2", "t3")
    pdel, pret = ir["prims"].python_del, ir["prims"].python_return
    r1 = _fusion(ir, "R0", [a, b], [t2])
    if move_a_into_region2:
        tr.bound_symbols = [r1, _fusion(ir, "R1", [t2, b, a], [t3]),
                            pdel.bind(a, t2, b, output=None), pret.bind(t3, output=None)]
    else:
        tr.bound_symbols = [r1, pdel.bind(a, output=None), _fusion(ir, "R1", [t2, b], [t3]),
                            pdel.bind(t2, b, output=None), pret.bind(t3, output=None)]
    tr.args = (a, b)
    return tr


def _output_escapes(ir):
    tr, (a, b, t2) = _proxies(ir, "a", "b", "t2")
    tr.bound_symbols = [_fusion(ir, "R0", [a, b], [t2]),
                        ir["prims"].python_del.bind(b, output=None),
                        ir["prims"].python_return.bind(t2, a, output=None)]
    tr.args = (a, b)
    return tr


def _no_del(ir):
    tr, (a, b, t2) = _proxies(ir, "a", "b", "t2")
    tr.bound_symbols = [_fusion(ir, "R0", [a, b], [t2]),
                        ir["prims"].python_return.bind(t2, output=None)]
    tr.args = (a, b)
    return tr


def _eager_view(ir):
    tr = ir["TraceCtx"](lambda *a: None)
    with ir["tracectx"](tr):
        a = ir["TensorProxy"](name="a", shape=(4, 4), device="cpu", dtype=ir["dtypes"].float32)
        b = ir["TensorProxy"](name="b", shape=(4, 4), device="cpu", dtype=ir["dtypes"].float32)
        v = ir["prims"].reshape(a, (16,))
    view = tr.bound_symbols[-1]
    with ir["tracectx"](tr):
        t2 = ir["TensorProxy"](name="t2", shape=(4, 4), device="cpu", dtype=ir["dtypes"].float32)
    tr.bound_symbols = [view, _fusion(ir, "R0", [a, b], [t2]),
                        ir["prims"].python_del.bind(a, b, output=None),
                        ir["prims"].python_return.bind(t2, v, output=None)]
    tr.args = (a, b)
    return tr


def _alias_hint(ir):
    tr, (a, b, t2) = _proxies(ir, "a", "b", "t2")
    tr.bound_symbols = [_fusion(ir, "R0", [a, b], [t2]),
                        ir["prims"].python_del.bind(a, b, output=None),
                        ir["prims"].python_return.bind(t2, output=None)]
    tr.args = (a, b)
    return tr


ANALYSES = {
    "dead_after_region1_is_donated_there": (lambda ir: _two_regions(ir, False), None),
    "use_moved_into_region2_withdraws_the_donation": (lambda ir: _two_regions(ir, True), None),
    "trace_outputs_are_never_donated": (_output_escapes, None),
    "no_del_means_no_proof_means_no_donation": (_no_del, None),
    "eager_view_endpoints_are_never_donated": (_eager_view, None),
    "alias_hints_pair_dead_inputs_with_compatible_outputs": (_alias_hint, None),
    "candidate_names_restrict_the_analysis": (lambda ir: _two_regions(ir, False), {"a"}),
}


def _analysis(ir, build, candidates):
    report = ir["donation"].analyze_trace_donations(build(ir), candidate_names=candidates)
    blockers = {r.name: {n: (reason, b.sym.name if b is not None else None)
                         for n, (reason, b) in r.rejected.items()} for r in report.regions}
    return ir["donation"].donation_summary(report), blockers, sorted(report.view_names)


@pytest.mark.parametrize("name", sorted(ANALYSES))
def test_analysis_equals_the_reference(name):
    build, candidates = ANALYSES[name]
    port = _analysis(PORT, build, candidates)
    assert port == _analysis(REF, build, candidates)
    summary = port[0]
    if name == "dead_after_region1_is_donated_there":
        r1, r2 = summary["regions"]
        assert r1["donated"] == ["a"] and r1["rejected"]["b"] == pdonation.REJECT_LATER_USE
        assert sorted(r2["donated"]) == ["b", "t2"]
    if name == "eager_view_endpoints_are_never_donated":
        assert summary["regions"][0]["rejected"]["a"] == pdonation.REJECT_ALIASED_VIEW


def test_rejection_counters_published():
    reg = pregistry()
    before = {k: reg.counter(f"donation.rejected.{k}").value
              for k in (pdonation.REJECT_LATER_USE, pdonation.REJECT_TRACE_OUTPUT)}
    trace, report = pdonation.apply_donation(_two_regions(PORT, False))
    _, rreport = rdonation.apply_donation(_two_regions(REF, False))
    assert report.donated_buffers == rreport.donated_buffers == 3
    assert report.rejections() == rreport.rejections()
    assert (reg.counter(f"donation.rejected.{pdonation.REJECT_LATER_USE}").value
            == before[pdonation.REJECT_LATER_USE] + 1)
    snap = ttt.metrics_snapshot()
    assert snap["donation.buffers_donated"] >= 3
    assert f"donation.rejected.{pdonation.REJECT_LATER_USE}" in snap
    assert trace._donation_summary.startswith("3 buffer(s) / 192 bytes donated across 2 region(s)")


#
# jit(donate=...)
#

def _sgd(p, g):
    return p - 0.01 * g


def _tensors(shape=(16, 16)):
    return torch.ones(shape), torch.full(shape, 0.5)


def _arrays(shape=(16, 16)):
    return jnp.ones(shape), jnp.full(shape, 0.5)


def _consumed(t) -> bool:
    return t.untyped_storage().nbytes() == 0


def _callables(cfn, last_traces):
    return [(b._call_ctx or {})[b.sym.name] for b in last_traces(cfn)[-1].bound_symbols
            if b.sym.is_fusion]


def test_auto_donation_consumes_inputs_for_real():
    p, g = _tensors()
    f = ttt.jit(_sgd, donate=True)
    out = f(p, g)
    assert bool((out == 1.0 - 0.01 * 0.5).all())
    assert _consumed(p) and _consumed(g)
    fw = ttt.donation_stats(f)["forward"]
    rf = tt.jit(_sgd, donate=True)
    rf(*[a.copy() for a in _arrays()])
    rfw = tt.donation_stats(rf)["forward"]
    assert (fw["buffers_donated"], fw["bytes_donated"]) == (rfw["buffers_donated"],
                                                            rfw["bytes_donated"]) == (2, 2048)
    (region,), (rregion,) = fw["regions"], rfw["regions"]
    assert sorted(region["donated"]) == sorted(rregion["donated"]) == ["t0", "t1"]
    assert len(region["aliases"]) == len(rregion["aliases"]) == 1
    assert sorted(_callables(f, ttt.last_traces)[0].donate_argnums) == [0, 1]


def test_donated_results_equal_undonated_ones():
    g = torch.Generator().manual_seed(0)
    p, q = torch.randn(32, 32, generator=g), torch.randn(32, 32, generator=g)
    want = ttt.jit(_sgd)(p, q)
    got = ttt.jit(_sgd, donate=True)(p.clone(), q.clone())
    assert torch.equal(got, want)


def test_donate_false_program_is_identical():
    p, g = _tensors()
    f_off, f_plain = ttt.jit(_sgd, donate=False), ttt.jit(_sgd)
    assert torch.equal(f_off(p, g), f_plain(p, g))
    assert not _consumed(p) and not _consumed(g)
    assert str(ttt.last_traces(f_off)[-1]) == str(ttt.last_traces(f_plain)[-1])
    for cal in _callables(f_off, ttt.last_traces) + _callables(f_plain, ttt.last_traces):
        assert cal.donate_argnums == () and cal.out_aliases == {}
    with pytest.raises(Exception, match="no donation data"):
        ttt.donation_stats(f_off)


def test_donated_then_reused_raises_naming_the_input():
    p, g = _tensors()
    f = ttt.jit(_sgd, donate=True)
    f(p, g)
    with pytest.raises(ttt.DonationError, match=r"input 't\d' .*Inductor0.*donated by an earlier"):
        f(p, g)


def test_explicit_argnums_donate_only_those():
    p, g = _tensors()
    f = ttt.jit(_sgd, donate=(0,))
    f(p, g)
    assert _consumed(p) and not _consumed(g)
    rf = tt.jit(_sgd, donate=(0,))
    rf(*[a.copy() for a in _arrays()])
    assert (ttt.donation_stats(f)["forward"]["buffers_donated"]
            == tt.donation_stats(rf)["forward"]["buffers_donated"] == 1)


def test_explicit_unsafe_donation_raises_with_reason():
    def ident(a, b):
        return a, a + b

    with pytest.raises(ttt.DonationError, match=r"'t0'.*trace_output"):
        ttt.jit(ident, donate=(0,))(*_tensors())
    with pytest.raises(rdonation.DonationError, match=r"'t0'.*trace_output"):
        tt.jit(ident, donate=(0,))(*_arrays())


def test_explicit_unsafe_donation_names_the_blocking_source():
    def escape(a, b):
        c = a * b + b
        return a, c

    with pytest.raises(ttt.DonationError, match="trace_output"):
        ttt.jit(escape, donate=(0,))(*_tensors())


def test_bad_donate_values_fail_at_jit_time():
    with pytest.raises(Exception, match="donates nothing"):
        ttt.jit(_sgd, donate=())
    with pytest.raises(Exception, match="donate must be"):
        ttt.jit(_sgd, donate="yes")


def test_the_jax_only_warning_filter_has_no_counterpart():
    # the reference silences JAX's "donated buffers were not usable" note,
    # which torch never emits: the port keeps no copy of the helper
    assert hasattr(rdonation, "suppress_unusable_donation_warnings")
    assert not hasattr(pdonation, "suppress_unusable_donation_warnings")
    assert "suppress_unusable_donation_warnings" not in pdonation.__all__


#
# the dispatch key
#

def test_donation_setting_salts_the_dispatch_key():
    from thunder_tpu_torch.core.cache_key import compute_cache_key

    p, g = _tensors()
    keys = {compute_cache_key((p, g), {}), compute_cache_key((p, g), {}, salt=("donate", "auto")),
            compute_cache_key((p, g), {}, salt=("donate", (0,)))}
    assert len(keys) == 3


def test_entry_key_fn_recomputes_the_salted_key():
    from thunder_tpu_torch import _get_cs
    from thunder_tpu_torch.core.cache_key import compute_cache_key

    f = ttt.jit(_sgd, donate=True)
    f(*_tensors())
    (entry,) = _get_cs(f).interpreter_cache
    assert entry.key_meta.get("donate") == "auto"
    p, g = _tensors()
    assert entry.cache_key_fn((p, g), {}) == compute_cache_key((p, g), {},
                                                               salt=("donate", "auto"))
    f(p, g)
    assert ttt.dispatch_stats(f)["key_hits"] == 1


def test_distinct_settings_never_share_a_key():
    from thunder_tpu_torch import _get_cs

    f_on, f_off = ttt.jit(_sgd, donate=True), ttt.jit(_sgd, donate=False)
    f_on(*_tensors())
    p, g = _tensors()
    f_off(p, g)
    (e_on,), (e_off,) = _get_cs(f_on).interpreter_cache, _get_cs(f_off).interpreter_cache
    assert e_on.cache_key_fn((p, g), {}) != e_off.cache_key_fn((p, g), {})


#
# the memory timeline
#

def test_peak_estimate_reflects_donated_reuse():
    from thunder_tpu.examine import memory_timeline as rtimeline
    from thunder_tpu_torch.examine import memory_estimate, memory_timeline

    got = {}
    for donate in (True, False):
        f, rf = ttt.jit(_sgd, donate=donate), tt.jit(_sgd, donate=donate)
        f(*_tensors((32, 32)))
        rf(*[a.copy() for a in _arrays((32, 32))])
        t, rt = memory_timeline(ttt.last_traces(f)[-1]), rtimeline(tt.last_traces(rf)[-1])
        assert t == rt
        got[donate] = t
    nbytes = 32 * 32 * 4
    assert got[False]["peak_bytes_estimate"] == 3 * nbytes
    assert got[True]["peak_bytes_estimate"] == 2 * nbytes
    assert (got[True]["donated_bytes"], got[False]["donated_bytes"]) == (2 * nbytes, 0)
    f = ttt.jit(_sgd, donate=True)
    f(*_tensors((32, 32)))
    assert memory_estimate(ttt.last_traces(f)[-1])["donated_bytes"] == 2 * nbytes


def test_program_documents_its_donation():
    f = ttt.jit(_sgd, donate=True)
    f(*_tensors())
    src = str(ttt.last_traces(f)[-1])
    assert "# donation:" in src and "# donated:" in src


#
# TrainStep
#

def _train_setup():
    rs = np.random.RandomState(0)
    w = (rs.randn(8, 8) * 0.1).astype(np.float32)
    x = rs.randn(4, 8).astype(np.float32)
    y = np.zeros((4, 8), np.float32)

    def port_loss(p, x, y):
        h = torch.nn.functional.linear(x, p["w"])
        return ((h - y) ** 2.0).mean()

    def ref_loss(p, x, y):
        h = tt.ltorch.linear(x, p["w"])
        return ((h - y) ** 2.0).mean()

    return (w, x, y), port_loss, ref_loss


def test_train_step_reports_its_donation():
    (w, x, y), port_loss, ref_loss = _train_setup()
    step = ttt.make_train_step(port_loss, ttt.adamw(0.1))
    params = {"w": torch.as_tensor(w)}
    _, _, loss = step(params, step.init_optimizer_state(params), torch.as_tensor(x),
                      torch.as_tensor(y))
    assert np.isfinite(loss.item())
    rep = step.donation_report
    assert rep is not None and set(rep) >= {"forward", "backward", "fw_peak_bytes_estimate",
                                            "bw_peak_bytes_estimate", "peak_bytes_estimate"}
    assert rep["fw_peak_bytes_estimate"] > 0
    mesh = rdist.make_mesh({"dp": 1}, devices=jax.devices()[:1])
    rstep = rdist.make_train_step(ref_loss, optax.sgd(0.1), mesh)
    rparams = {"w": jnp.asarray(w)}
    rstep(rparams, rstep.init_optimizer_state(rparams), jnp.asarray(x), jnp.asarray(y))
    rrep = rstep.donation_report
    for half in ("forward", "backward"):
        assert rep[half]["rejections"] == rrep[half]["rejections"]
        assert rep[half]["buffers_donated"] == rrep[half]["buffers_donated"]
    # the analysis arms nothing: the step's programs run as generated
    for tr in (step.fw_trace, step.bw_trace):
        for b in tr.bound_symbols:
            if b.sym.is_fusion:
                assert b._call_ctx[b.sym.name].donate_argnums == ()


def test_donate_batch_waits_for_training_past_one_device():
    """``donate_batch=True`` is accepted since the sharded step (the
    reference's signature): the port's programs never free a tensor the
    caller holds, so the step's loss is the plain one and the batch is
    untouched."""
    (w, x, y), port_loss, _ = _train_setup()
    losses = []
    for donate_batch in (True, False):
        step = ttt.make_train_step(port_loss, ttt.adamw(0.1), donate_batch=donate_batch)
        params = {"w": torch.as_tensor(w.copy())}
        xb, yb = torch.as_tensor(x), torch.as_tensor(y)
        losses.append(step(params, step.init_optimizer_state(params), xb, yb)[2])
        assert step.donate_batch is donate_batch
        assert np.array_equal(xb.numpy(), x) and np.array_equal(yb.numpy(), y)
    assert torch.equal(losses[0], losses[1])


def test_donate_false_has_no_report_and_preserves_inputs():
    (w, x, y), port_loss, _ = _train_setup()
    step = ttt.make_train_step(port_loss, ttt.adamw(0.1), donate=False)
    params = {"w": torch.as_tensor(w.copy())}
    step(params, step.init_optimizer_state(params), torch.as_tensor(x), torch.as_tensor(y))
    assert step.donation_report is None
    assert np.array_equal(params["w"].numpy(), w)
