"""The memory timeline (``observability/memory.py``), ``examine`` and
``telemetry.trace_peak_bytes`` against the JAX package on the CPU.

The same functions through both packages, fused (cuda ≻ inductor ≻ torch
against xla ≻ jax) and unfused (torch against jax), jitted, differentiated
and trained: every trace the pipeline keeps gives the reference's integers
(per-symbol live and peak rows, input, output, peak and donated bytes);
``memory_estimate`` and ``trace_peak_bytes`` read them; ``TrainStep``'s
donated-aware peaks and ``profile_stats()`` (through
``train_memory_report``) equal the reference's one-device keys; the
fusion introspection (``get_fusion_symbols``, ``get_fusions``) names the
regions; ``examine`` reports a supported function; ``HW_PEAKS`` holds the
card's row alone and ``cost_analysis`` raises naming its ``ROADMAP.md``
item.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

import thunder_tpu as tt
import thunder_tpu.torch as rltorch
import thunder_tpu_torch as ttt
from thunder_tpu import distributed as rdist
from thunder_tpu.examine import memory_estimate as rmemory_estimate
from thunder_tpu.observability.memory import memory_timeline as rmemory_timeline
from thunder_tpu.observability.telemetry import trace_peak_bytes as rtrace_peak_bytes
from thunder_tpu_torch import examine
from thunder_tpu_torch.observability.memory import memory_timeline, tensor_nbytes
from thunder_tpu_torch.observability.telemetry import trace_peak_bytes
from torch_port_threads import one_torch_thread  # noqa: F401

RS = np.random.RandomState(0)
X = RS.randn(4, 8).astype(np.float32)
W = RS.randn(8, 8).astype(np.float32)
B = RS.randn(8).astype(np.float32)
Y = np.zeros((4, 8), np.float32)


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


def port_mlp(x, w, b):
    return torch.softmax(torch.tanh(F.linear(x, w, b)) * 2.0, -1).sum()


def ref_mlp(x, w, b):
    return rltorch.sum(rltorch.softmax(rltorch.tanh(rltorch.linear(x, w, b)) * 2.0, -1))


def port_sgd(p, g):
    return p - 0.01 * g


def _assert_same_memory(trace, rtrace):
    t, rt = memory_timeline(trace), rmemory_timeline(rtrace)
    assert t == rt
    assert examine.memory_timeline(trace) == t
    assert examine.memory_estimate(trace) == rmemory_estimate(rtrace)
    assert trace_peak_bytes(trace) == rtrace_peak_bytes(rtrace)
    return t


@pytest.mark.parametrize("stack", ["fused", "unfused"])
def test_jit_traces_give_the_reference_integers(stack):
    pex, rex = (None, None) if stack == "fused" else (["torch"], ["jax"])
    p, r = ttt.jit(port_mlp, executors=pex), tt.jit(ref_mlp, executors=rex)
    got = p(*map(torch.as_tensor, (X, W, B)))
    np.testing.assert_allclose(got.item(), float(r(X, W, B)), rtol=1e-5)
    traces, rtraces = ttt.last_traces(p), tt.last_traces(r)
    assert len(traces) == len(rtraces)
    for trace, rtrace in zip(traces, rtraces):
        t = _assert_same_memory(trace, rtrace)
        assert len(t["rows"]) == len(trace.bound_symbols)
    assert t["input_bytes"] == (X.size + W.size + B.size) * 4 and t["output_bytes"] == 4
    fusions = examine.get_fusion_symbols(traces[-1])
    assert len(fusions) == (1 if stack == "fused" else 0)
    assert [name for name, _ in examine.get_fusions(traces[-1])] == [b.sym.name for b in fusions]


def test_grad_traces_give_the_reference_integers():
    p, r = ttt.value_and_grad(port_mlp), tt.value_and_grad(ref_mlp)
    p(*map(torch.as_tensor, (X, W, B)))
    r(X, W, B)
    _assert_same_memory(ttt.last_traces(p)[-1], tt.last_traces(r)[-1])
    # the port's backward takes its residuals as one list (take_saved): the
    # trace before that rewrite is the reference's last backward trace
    _assert_same_memory(ttt.last_backward_traces(p)[-2], tt.last_backward_traces(r)[-1])


@pytest.mark.parametrize("donate", [True, (0,), False])
def test_donated_traces_give_the_reference_integers(donate):
    p, r = ttt.jit(port_sgd, donate=donate), tt.jit(port_sgd, donate=donate)
    p(torch.ones(16, 16), torch.full((16, 16), 0.5))
    r(jnp.ones((16, 16)), jnp.full((16, 16), 0.5))
    t = _assert_same_memory(ttt.last_traces(p)[-1], tt.last_traces(r)[-1])
    assert t["donated_bytes"] == {True: 2048, (0,): 1024, False: 0}[donate]


def _train_steps():
    def ploss(p, x, y):
        return ((F.linear(x, p["w"]) - y) ** 2.0).mean()

    def rloss(p, x, y):
        return ((rltorch.linear(x, p["w"]) - y) ** 2.0).mean()

    step = ttt.make_train_step(ploss, ttt.adamw(0.1))
    params = {"w": torch.as_tensor(W.copy())}
    step(params, step.init_optimizer_state(params), torch.as_tensor(X), torch.as_tensor(Y))
    mesh = rdist.make_mesh({"dp": 1}, devices=jax.devices()[:1])
    rstep = rdist.make_train_step(rloss, optax.sgd(0.1), mesh)
    rparams = {"w": jnp.asarray(W)}
    rstep(rparams, rstep.init_optimizer_state(rparams), X, Y)
    return step, rstep


def test_train_step_peaks_and_profile_stats_equal_the_reference():
    step, rstep = _train_steps()
    assert trace_peak_bytes(step.fw_trace) == rtrace_peak_bytes(rstep.fw_trace)
    assert trace_peak_bytes(step.bw_trace) == rtrace_peak_bytes(rstep.bw_trace)
    report = examine.train_memory_report(step)
    assert report == rstep.profile_stats()
    assert report["peak_bytes_estimate"] == max(report["fw_peak_bytes_estimate"],
                                                report["bw_peak_bytes_estimate"]) > 0
    snap = ttt.metrics_snapshot()
    assert snap["train.step.peak_bytes_estimate"] == report["peak_bytes_estimate"]


def test_profile_stats_needs_a_built_step():
    step = ttt.make_train_step(lambda p, x: (p["w"] * x).sum(), ttt.adamw(0.1))
    with pytest.raises(RuntimeError, match="built step"):
        step.profile_stats()


def test_tensor_nbytes_and_a_trace_without_dels():
    p = ttt.jit(port_mlp, executors=["torch"])
    p(*map(torch.as_tensor, (X, W, B)))
    claimed = ttt.last_traces(p)[-2]               # before del_last_used
    assert not any(b.sym.name == "python_del" for b in claimed.bound_symbols)
    assert trace_peak_bytes(claimed) == trace_peak_bytes(ttt.last_traces(p)[-1])
    x_proxy = ttt.last_traces(p)[-1].args[0]
    assert tensor_nbytes(x_proxy) == X.nbytes and tensor_nbytes(3) == 0


def test_examine_reports_a_supported_function(capsys):
    assert examine.examine(port_mlp, *map(torch.as_tensor, (X, W, B)))
    out = capsys.readouterr().out
    assert "supported by the tracer" in out and "matches eager torch" in out


def test_hw_peaks_hold_the_card_alone_and_cost_analysis_raises():
    assert examine.HW_PEAKS == {"cuda": (989e12, 3.35e12)}
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 7"):
        examine.cost_analysis(port_mlp, *map(torch.as_tensor, (X, W, B)))
