"""The port's runtime profiler and debug hooks against the JAX package's, on
the CPU (``observability/profiler.py``, ``observability/debug.py``,
``observability/config.py``, ``core/profile.py``).

Each case runs the same function through ``thunder_tpu.jit`` and
``thunder_tpu_torch.jit``: with every option off the generated program is
byte-identical to the uninstrumented one (the instrumented jit's last
program before the pass prints the plain jit's); the environment gates are
read on every call; profiled results equal unprofiled ones bitwise; the
per-symbol call counts equal the reference's under its eager executors
(``["torch"]`` against ``["jax"]``) and under the default fusion stacks
(one region each), forward and backward (labels normalized: ``torch_`` /
``jax_`` to ``EX_``, ``Inductor<n>`` / ``XLA<n>`` to ``FUSION<n>``); a
linear's FLOPs are 2·M·N·K and its bytes its inputs' and output's; the
debug hooks' tuple, dict and single-callable forms, their exceptions
propagating, the backward hooks under ``grad``; a NaN or Inf raised as
``AnomalyError`` at the same (normalized) symbol as the reference's, with
the user's line; the anomaly counter.  On the card (``cuda``-marked):
``profile=True`` with barriers around the flash kernels.
"""
from __future__ import annotations

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import thunder_tpu as tt
import thunder_tpu.torch as rl
import thunder_tpu_torch as ttt
import thunder_tpu_torch.torch as pl
from thunder_tpu import observability as robs
from thunder_tpu_torch import observability as pobs
from torch_port_threads import one_torch_thread  # noqa: F401

rng = np.random.default_rng(7)
EAGER = (["jax"], ["torch"])       # the reference's and the port's eager executors
FUSED = (None, None)               # the default stacks: one fusion region each


def _norm(label: str) -> str:
    label = re.sub(r"(XLA|Inductor)(\d+)", r"FUSION\2", label)
    return re.sub(r"\b(jax|torch)_", "EX_", label)


def _xw():
    return (rng.standard_normal((8, 16)).astype(np.float32),
            rng.standard_normal((4, 16)).astype(np.float32))


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _mlp(L):
    def mlp(a, b):
        return L.relu(L.matmul(a, L.transpose(b, 0, 1))).sum()

    return mlp


def _chain(L):
    def chain(x, w, b):
        h = L.softmax(L.linear(x, w, b), -1)
        return L.sum(L.tanh(h) * h, -1) + L.exp(x).mean(-1)

    return chain


def _nan_mid(L):
    def nan_mid(a):
        z = a - a
        return L.sum(z / z)  # 0/0 -> NaN mid-trace

    return nan_mid


def _inf_mid(L):
    def inf_mid(a):
        z = a - a
        return L.sum(1.0 / z)  # 1/0 -> Inf mid-trace

    return inf_mid


def _counts(report) -> dict:
    return {_norm(label): st["calls"] for label, st in report.items()}


#
# The zero-overhead contract and the environment gates
#

@pytest.mark.parametrize("option", [dict(profile=True), dict(detect_anomalies=True),
                                    dict(debug_hooks=lambda info, out: None)],
                         ids=["profile", "detect_anomalies", "debug_hooks"])
def test_program_is_byte_identical_when_off(option):
    x, w = _t(*_xw())
    plain = ttt.jit(_mlp(pl))
    plain(x, w)
    src = ttt.last_traces(plain)[-1].python()
    assert "_prof" not in src and "_dbg" not in src
    off = ttt.jit(_mlp(pl), profile=False, detect_anomalies=False)
    off(x, w)
    assert ttt.last_traces(off)[-1].python() == src
    on = ttt.jit(_mlp(pl), **option)
    on(x, w)
    traces = ttt.last_traces(on)
    assert ("_prof" if "profile" in option else "_dbg") in traces[-1].python()
    # instrumentation is purely additive, a final pass
    assert traces[-2].python() == src
    with pytest.raises(RuntimeError, match="no profiling data"):
        ttt.profile_stats(plain)


def test_env_gates_are_read_on_every_call(monkeypatch):
    x, w = _xw()
    monkeypatch.setenv("THUNDER_TPU_PROFILE", "1")
    rj, pj = tt.jit(_mlp(rl)), ttt.jit(_mlp(pl))
    rj(x, w)
    pj(*_t(x, w))
    assert _counts(ttt.profile_stats(pj)) == _counts(tt.profile_stats(rj))
    monkeypatch.delenv("THUNDER_TPU_PROFILE")
    monkeypatch.setenv("THUNDER_TPU_DETECT_ANOMALIES", "1")
    a = rng.standard_normal((8,)).astype(np.float32)
    with pytest.raises(tt.AnomalyError):
        tt.jit(_nan_mid(rl))(a)
    with pytest.raises(ttt.AnomalyError):
        ttt.jit(_nan_mid(pl))(torch.from_numpy(a))
    monkeypatch.delenv("THUNDER_TPU_DETECT_ANOMALIES")
    # the annotation gate and the legacy shim, set after import
    from thunder_tpu.core import profile as rprofile
    from thunder_tpu_torch.core import profile as pprofile

    monkeypatch.setenv("THUNDER_TPU_ANNOTATE_TRACES", "1")
    assert pobs.annotations_enabled() and pprofile.profiling_enabled() == rprofile.profiling_enabled()
    monkeypatch.delenv("THUNDER_TPU_ANNOTATE_TRACES")
    assert not pprofile.profiling_enabled() and not pobs.profiling_enabled()
    monkeypatch.setattr(pprofile, "_ENABLED", True)
    assert pprofile.profiling_enabled()
    with pprofile.add_markers("marked"):
        pass
    monkeypatch.setenv("THUNDER_TPU_EVENT_BUFFER", "32")
    assert pobs.event_buffer_capacity() == robs.event_buffer_capacity() == 32
    for name in ("serving_trace_env_enabled", "flight_recorder_env_enabled"):
        monkeypatch.setenv("THUNDER_TPU_" + {"serving_trace_env_enabled": "TRACE_SERVING",
                                             "flight_recorder_env_enabled": "FLIGHT_RECORDER"}[name],
                           "on")
        assert getattr(pobs, name)() and getattr(robs, name)()


#
# The profiler
#

@pytest.mark.parametrize("stacks", [EAGER, FUSED], ids=["eager", "fused"])
def test_call_counts_equal_the_reference(stacks):
    rex, pex = stacks
    x, w = _xw()
    b = np.ones(4, np.float32)
    rj = tt.jit(_chain(rl), profile=True, executors=rex)
    pj = ttt.jit(_chain(pl), profile=True, executors=pex)
    for _ in range(3):
        want = rj(x, w, b)
        got = pj(*_t(x, w, b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    report = ttt.profile_stats(pj)
    assert _counts(report) == _counts(tt.profile_stats(rj))
    wrapped = [s for s in ttt.last_traces(pj)[-1].bound_symbols if s.sym.name.startswith("_prof")]
    assert len(wrapped) == len(report)
    for label, st in report.items():
        assert st["calls"] == 3, (label, st)
        assert 0 < st["min_ns"] <= st["mean_ns"] <= st["max_ns"] <= st["total_ns"]
    table = str(report)
    assert all(label[:40] in table for label in report)

    # the backward program is instrumented under grad, with the same counts
    rg = tt.grad(lambda x, w, b: rl.sum(_chain(rl)(x, w, b)), profile=True, executors=rex)
    pg = ttt.grad(lambda x, w, b: pl.sum(_chain(pl)(x, w, b)), profile=True, executors=pex)
    rg(x, w, b)
    pg(*_t(x, w, b))
    counts = _counts(ttt.profile_stats(pg))
    assert counts == _counts(tt.profile_stats(rg))
    assert any(k.startswith("backward:") for k in counts)
    assert any(not k.startswith("backward:") for k in counts)


def test_profiled_results_equal_unprofiled():
    x, w = _t(*_xw())
    b = torch.ones(4)
    for pex in (["torch"], None):
        want = ttt.jit(_chain(pl), executors=pex)(x, w, b)
        got = ttt.jit(_chain(pl), executors=pex, profile=True)(x, w, b)
        assert torch.equal(got, want)
    vw, gw = ttt.value_and_grad(lambda x, w: _mlp(pl)(x, w), argnums=(0, 1))(x, w)
    vg, gg = ttt.value_and_grad(lambda x, w: _mlp(pl)(x, w), argnums=(0, 1), profile=True)(x, w)
    assert torch.equal(vw, vg) and all(torch.equal(a, b) for a, b in zip(gw, gg))


def test_linear_flops_and_bytes():
    M, K, N = 8, 16, 4
    x, w = torch.randn(M, K), torch.randn(N, K)
    pj = ttt.jit(lambda x, w: torch.nn.functional.linear(x, w), profile=True,
                 executors=["torch"])
    pj(x, w)
    st = ttt.profile_stats(pj)["torch_linear"]
    assert st["flops"] == 2 * M * N * K
    assert st["bytes"] == 4 * (M * K + N * K + M * N)
    assert st["live_bytes"] >= 4 * M * N
    fused = ttt.jit(lambda x, w: torch.nn.functional.linear(x, w).relu(), profile=True)
    fused(x, w)
    region = ttt.profile_stats(fused)["Inductor0"]
    assert region["flops"] == 2 * M * N * K and region["bytes"] == 4 * (M * K + N * K + M * N)


def test_reset_observability_clears_the_reports():
    pj = ttt.jit(_mlp(pl), profile=True)
    pj(*_t(*_xw()))
    assert len(ttt.profile_stats(pj)) == 1
    ttt.reset_observability()
    assert len(ttt.profile_stats(pj)) == 0
    pj(*_t(*_xw()))              # a cache hit: the report refills on a recompile only
    assert len(ttt.profile_stats(pj)) == 0


#
# Debug hooks
#

def test_pre_post_hooks_fire_with_symbol_info_and_provenance():
    calls = []

    def pre(info, args, kwargs):
        calls.append(("pre", info.name, info.trace))

    def post(info, out):
        calls.append(("post", info.name, info.trace))
        assert any(f.endswith("test_torch_port_profiler.py") for f, _ in info.provenance), info

    x, w = _t(*_xw())
    out = ttt.jit(_mlp(pl), debug_hooks=(pre, post))(x, w)
    assert torch.equal(out, ttt.jit(_mlp(pl))(x, w))
    assert {c[0] for c in calls} == {"pre", "post"}
    assert all(c[2] == "computation" for c in calls)

    rcalls = []
    tt.jit(_mlp(rl), debug_hooks=(lambda i, a, k: rcalls.append(("pre", i.name, i.trace)),
                                  lambda i, o: rcalls.append(("post", i.name, i.trace))))(*_xw())
    assert [(k, _norm(n), t) for k, n, t in calls] == [(k, _norm(n), t) for k, n, t in rcalls]


def test_single_callable_and_dict_forms():
    x, w = _t(*_xw())
    seen = []
    ttt.jit(_mlp(pl), debug_hooks=lambda info, out: seen.append(info.name))(x, w)
    seen2 = []
    ttt.jit(_mlp(pl), debug_hooks={"pre": lambda i, a, k: seen2.append(i.name)})(x, w)
    assert seen and seen == seen2
    from thunder_tpu.observability.debug import resolve_debug_hooks as rresolve
    from thunder_tpu_torch.observability.debug import resolve_debug_hooks as presolve

    f, g = print, repr
    for hooks in (None, (f, g), [f, g], {"pre": f}, {"post": g}, f):
        assert presolve(hooks) == rresolve(hooks)
    for bad in ({"pri": f}, (f,), 3):
        with pytest.raises(TypeError):
            presolve(bad)
        with pytest.raises(TypeError):
            rresolve(bad)


def test_hook_exceptions_propagate():
    def post(info, out):
        raise ValueError("stop here")

    with pytest.raises(ValueError, match="stop here"):
        ttt.jit(_mlp(pl), debug_hooks={"post": post})(*_t(*_xw()))


@pytest.mark.parametrize("stacks", [EAGER, FUSED], ids=["eager", "fused"])
def test_backward_hooks_under_grad(stacks):
    rex, pex = stacks
    a = rng.standard_normal((4, 4)).astype(np.float32)
    seen, rseen = [], []
    ttt.grad(lambda a: pl.relu(a).sum(), executors=pex,
             debug_hooks={"post": lambda i, o: seen.append((_norm(i.name), i.trace))})(
        torch.from_numpy(a))
    tt.grad(lambda a: rl.relu(a).sum(), executors=rex,
            debug_hooks={"post": lambda i, o: rseen.append((_norm(i.name), i.trace))})(a)
    assert {t for _, t in seen} == {"computation", "backward"}
    # the same symbols fire in both packages (the backward's order may differ)
    assert sorted(seen) == sorted(rseen)


#
# Anomaly detection
#

@pytest.mark.parametrize("stacks", [EAGER, FUSED], ids=["eager", "fused"])
@pytest.mark.parametrize("make,kind", [(_nan_mid, "nan"), (_inf_mid, "inf")], ids=["nan", "inf"])
def test_anomaly_names_the_reference_symbol_and_the_user_line(stacks, make, kind):
    rex, pex = stacks
    a = rng.standard_normal((8,)).astype(np.float32)
    with pytest.raises(tt.AnomalyError) as rei:
        tt.jit(make(rl), detect_anomalies=True, executors=rex)(a)
    with pytest.raises(ttt.AnomalyError) as pei:
        ttt.jit(make(pl), detect_anomalies=True, executors=pex)(torch.from_numpy(a))
    r, p = rei.value, pei.value
    assert p.kind == r.kind == kind and p.trace == r.trace == "computation"
    assert _norm(p.symbol) == _norm(r.symbol)
    assert (p.output_index, p.nan_count, p.inf_count) == (r.output_index, r.nan_count, r.inf_count)
    assert any(f.endswith("test_torch_port_profiler.py") for f, _ in p.provenance), p.provenance
    assert "test_torch_port_profiler.py" in str(p) and "repro" in str(p)


def test_no_false_positive_and_results_match():
    x, w = _t(*_xw())
    assert torch.equal(ttt.jit(_mlp(pl), detect_anomalies=True)(x, w), ttt.jit(_mlp(pl))(x, w))


def test_backward_nan_via_custom_grad(monkeypatch):
    """A grad rule that writes NaN into the backward program: the forward
    stays finite, so the raise comes from the backward's instrumentation,
    at the reference's symbol, naming the user's line."""
    from thunder_tpu import clang as rclang
    from thunder_tpu.core import transforms as RT
    from thunder_tpu.core.prims import PrimIDs as RPrimIDs
    from thunder_tpu_torch import clang as pclang
    from thunder_tpu_torch.core import transforms as PT
    from thunder_tpu_torch.core.prims import PrimIDs as PPrimIDs

    monkeypatch.setitem(RT.backward_rules, RPrimIDs.SIN,
                        lambda bsym, g: [(bsym.args[0], rclang.full_like(bsym.args[0], float("nan")))])
    monkeypatch.setitem(PT.backward_rules, PPrimIDs.SIN,
                        lambda bsym, g: [(bsym.args[0], pclang.full_like(bsym.args[0], float("nan")))])
    a = rng.standard_normal((4,)).astype(np.float32)
    with pytest.raises(tt.AnomalyError) as rei:
        tt.grad(lambda a: rl.sin(a).sum(), detect_anomalies=True, executors=["jax"])(a)
    with pytest.raises(ttt.AnomalyError) as pei:
        ttt.grad(lambda a: pl.sin(a).sum(), detect_anomalies=True, executors=["torch"])(
            torch.from_numpy(a))
    r, p = rei.value, pei.value
    assert p.kind == "nan" and p.trace == r.trace == "backward"
    assert _norm(p.symbol) == _norm(r.symbol)
    assert any(f.endswith("test_torch_port_profiler.py") for f, _ in p.provenance), p.provenance


def test_anomaly_counter_incremented():
    base = pobs.registry().counter("anomaly.detected").value
    a = torch.from_numpy(rng.standard_normal((8,)).astype(np.float32))
    with pytest.raises(ttt.AnomalyError):
        ttt.jit(_nan_mid(pl), detect_anomalies=True)(a)
    assert pobs.registry().counter("anomaly.detected").value == base + 1


@pytest.mark.parametrize("stacks", [EAGER, FUSED], ids=["eager", "fused"])
def test_a_planted_nan_weight_row(stacks):
    """The shape of ``chip_smoke.py`` phase 18 (c) at tiny widths: a NaN in
    one row of a linear's weight raises at the first symbol that reads the
    weight (the linear itself, or the region holding it), in both
    packages."""
    rex, pex = stacks
    x = rng.standard_normal((4, 16)).astype(np.float32)
    w = rng.standard_normal((8, 16)).astype(np.float32)
    w[3] = np.nan

    def loss(L):
        return lambda x, w: L.sum(L.tanh(L.linear(x, w)))

    def first_reader(isnan):
        seen = []

        def pre(info, args, kwargs):
            if not seen and any(hasattr(a, "shape") and tuple(a.shape) == w.shape
                                and bool(isnan(a).any()) for a in args):
                seen.append(info.name)

        return seen, pre

    rseen, rpre = first_reader(jnp.isnan)
    pseen, ppre = first_reader(torch.isnan)
    with pytest.raises(tt.AnomalyError) as rei:
        tt.jit(loss(rl), detect_anomalies=True, executors=rex, debug_hooks={"pre": rpre})(x, w)
    with pytest.raises(ttt.AnomalyError) as pei:
        ttt.jit(loss(pl), detect_anomalies=True, executors=pex, debug_hooks={"pre": ppre})(
            *_t(x, w))
    assert _norm(pei.value.symbol) == _norm(rei.value.symbol)
    assert pei.value.symbol == pseen[0] and rei.value.symbol == rseen[0]
    assert _norm(pei.value.symbol) == ("EX_linear" if stacks is EAGER else "FUSION0")
    # the eager linear's output holds the planted row's 4 NaNs; the one
    # region's output is the NaN sum
    assert pei.value.nan_count == rei.value.nan_count == (4 if stacks is EAGER else 1)


#
# On the card
#

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the flash kernels run on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_profile_with_barriers_times_the_flash_kernels(card):
    from thunder_tpu_torch.executors import cudaex

    g = torch.Generator(device=card).manual_seed(0)
    q, k, v = (torch.randn(1, 4, 256, 64, generator=g, device=card, dtype=torch.bfloat16)
               for _ in range(3))
    fn = lambda q, k, v: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        q, k, v, is_causal=True).float().sum()
    want = ttt.jit(fn)(q, k, v)
    pj = ttt.jit(fn, profile=True)
    cudaex.reset_launches()
    got = pj(q, k, v)
    assert cudaex.LAUNCHES["flash_fwd"] == 1
    assert torch.equal(got, want)
    report = ttt.profile_stats(pj)
    assert report["cuda_sdpa"]["calls"] == 1 and report["cuda_sdpa"]["total_ns"] > 0
