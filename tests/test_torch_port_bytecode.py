"""The general jit, ``jit(..., interpretation="bytecode")``, against the JAX
package's, on the CPU.

The same functions go through ``thunder_tpu.jit(..., interpretation=
"bytecode")`` and ``thunder_tpu_torch.jit(..., interpretation="bytecode")``.
After every call the two runs must agree in:

- the result: float32, within 1e-6 relative (and 1e-6 absolute, for
  elements near zero);
- the cache misses so far (the retrace sequence after each mutation);
- the entry's captured state: its guard count, its captured-tensor count
  and the roots they hang off (``jit_ext.state_key_meta``).

The cases: every test of ``test_interpreter.py``'s ``TestGeneralJit``,
``TestCrossModuleGuards`` and ``TestRunLogAndLookasides`` (their bodies run
once with each package bound to the module's ``tt`` and ``ltorch``; the few
whose bodies import the reference's own modules have a counterpart here that
runs both packages), ``test_guard_fuzz.py``'s seeds,
``test_einops.py::test_bytecode_frontend_einops``, the dispatch cache's
shadowing and recovery by a guard on captured state, the sharp-edges
policies for unguardable keys and external writes, a 2-layer Llama loss
written as user code that reads its weights from a global dict (equal to
``jit(gpt_loss)`` in both packages), and ``jit(GPT2LMHeadModel,
interpretation="bytecode")``.  The Llama loss is ``chip_smoke.py``'s
``user_loss``, the one phase 19 drives on the card at full width; the
``cuda``-marked tests are in ``tests/test_torch_port_bytecode_cuda.py``.
"""
from __future__ import annotations

import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import test_einops as _ref_einops
import test_guard_fuzz as _ref_gf
import test_interpreter as _ref_it
import thunder_tpu as tt
import thunder_tpu.torch as ref_ltorch
import thunder_tpu_torch as ttt
import thunder_tpu_torch.torch as port_ltorch
from thunder_tpu.models import llama as jllama
from thunder_tpu_torch.core import interpreter as port_itp
from thunder_tpu_torch.core import jit_ext as port_jit_ext
from thunder_tpu_torch.models import llama as tllama
from torch_port_threads import one_torch_thread  # noqa: F401

RTOL = ATOL = 1e-6


#
# The recording harness
#


def _leaves(x) -> list:
    """Float64 numpy leaves of a result (tensors, arrays, numbers)."""
    if isinstance(x, dict):
        return [leaf for k in sorted(x, key=str) for leaf in _leaves(x[k])]
    if isinstance(x, (list, tuple)):
        return [leaf for e in x for leaf in _leaves(e)]
    if isinstance(x, torch.Tensor):
        return [x.detach().cpu().double().numpy()]
    if x is None:
        return []
    return [np.asarray(x, dtype=np.float64)]


class _Recorder:
    """A package whose ``jit`` and ``value_and_grad`` record, after every
    call, the result, the misses so far and the used entry's captured state.
    Everything else is the package's own."""

    def __init__(self, pkg):
        self._pkg = pkg
        self.events: list = []

    def __getattr__(self, name):
        return getattr(self._pkg, name)

    def _wrap(self, cfn):
        if not callable(cfn) or not hasattr(cfn, "_lc_cs"):
            return cfn  # a ThunderModule: its own surface
        events = self.events

        def wrapped(*args, **kwargs):
            try:
                out = cfn(*args, **kwargs)
            except Exception as e:
                events.append(("raise", type(e).__name__, cfn._lc_cs.cache_misses))
                raise
            cs = cfn._lc_cs
            used = max(cs.interpreter_cache, key=lambda e: e.last_used, default=None)
            state = None if used is None else used.key_meta.get("state")
            events.append(("ok", _leaves(out), cs.cache_misses, state))
            return out

        wrapped._lc_cs = cfn._lc_cs
        wrapped._lc_cd = cfn._lc_cd
        return wrapped

    def jit(self, fn, **kw):
        return self._wrap(self._pkg.jit(fn, **kw))

    def value_and_grad(self, fn, *a, **kw):
        return self._wrap(self._pkg.value_and_grad(fn, *a, **kw))


def _assert_same_events(ref: list, port: list, label: str) -> None:
    assert len(ref) == len(port), (label, ref, port)
    for i, (r, p) in enumerate(zip(ref, port)):
        assert r[0] == p[0], (label, i, r, p)
        if r[0] == "raise":
            assert r[2] == p[2], (label, i, "misses", r, p)
            continue
        _, rl, rmiss, rstate = r
        _, pl, pmiss, pstate = p
        assert rmiss == pmiss, (label, i, "misses", rmiss, pmiss)
        assert rstate == pstate, (label, i, "captured state", rstate, pstate)
        assert len(rl) == len(pl), (label, i)
        for a, b in zip(rl, pl):
            assert a.shape == b.shape, (label, i, a.shape, b.shape)
            np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL, err_msg=f"{label} call {i}")


def _run_both(monkeypatch, module, body, *, port_ltorch_name="ltorch", reseed=None):
    """Runs ``body()`` with ``module.tt`` (and its torch language) bound to a
    recorder over each package in turn, the module's rng reseeded before
    each run so both draw the same inputs; returns both event lists."""
    runs = []
    for pkg, lang in ((tt, ref_ltorch), (ttt, port_ltorch)):
        rec = _Recorder(pkg)
        monkeypatch.setattr(module, "tt", rec)
        if port_ltorch_name is not None:
            monkeypatch.setattr(module, port_ltorch_name, lang)
        if reseed is not None:
            monkeypatch.setattr(module, "rng", np.random.default_rng(reseed))
        body()
        runs.append(rec.events)
    return runs


def _ref_tests(cls, skip=()) -> list[str]:
    return sorted(n for n in dir(cls) if n.startswith("test_") and n not in skip)


# tests whose bodies import the reference's own modules: counterparts below
_OWN_IMPORTS = {"test_lookaside_substitutes_calls", "test_registered_lookaside_and_opaque",
                "test_executor_replaces_lookaside_reaches_interpreter",
                "test_hf_model_traces_via_bytecode"}
_FOLD = "test_fold_builtins_guard_elements"   # parametrized: test_reference_fold_case
_CASES = ([("TestGeneralJit", n) for n in _ref_tests(_ref_it.TestGeneralJit, {_FOLD})]
          + [("TestCrossModuleGuards", n) for n in _ref_tests(_ref_it.TestCrossModuleGuards)]
          + [("TestRunLogAndLookasides", n)
             for n in _ref_tests(_ref_it.TestRunLogAndLookasides, _OWN_IMPORTS)])


def _case_params(cls_name: str, name: str) -> dict:
    fn = getattr(getattr(_ref_it, cls_name), name)
    import inspect

    return {p: None for p in inspect.signature(fn).parameters if p != "self"}


@pytest.mark.parametrize("cls_name,name", _CASES, ids=[f"{c}.{n}" for c, n in _CASES])
def test_reference_case(cls_name, name, monkeypatch, capsys):
    cls = getattr(_ref_it, cls_name)
    extra = _case_params(cls_name, name)
    if "capsys" in extra:
        extra["capsys"] = capsys

    def body():
        getattr(cls(), name)(**extra)

    ref, port = _run_both(monkeypatch, _ref_it, body, reseed=29)
    assert ref, f"{name} compiled nothing"
    _assert_same_events(ref, port, name)


_FOLD_CASES = [m.args[1] for m in _ref_it.TestGeneralJit.test_fold_builtins_guard_elements.pytestmark
               if m.name == "parametrize"][0]


@pytest.mark.parametrize("fold,expect", _FOLD_CASES)
def test_reference_fold_case(fold, expect, monkeypatch):
    """``TestGeneralJit.test_fold_builtins_guard_elements``, each of its cases."""
    def body():
        _ref_it.TestGeneralJit().test_fold_builtins_guard_elements(fold, expect)

    ref, port = _run_both(monkeypatch, _ref_it, body, reseed=29)
    _assert_same_events(ref, port, f"fold {fold}")


def test_cases_cover_the_reference_classes():
    for cls in (_ref_it.TestGeneralJit, _ref_it.TestCrossModuleGuards,
                _ref_it.TestRunLogAndLookasides):
        names = _ref_tests(cls)
        covered = {n for c, n in _CASES if c == cls.__name__} | _OWN_IMPORTS | {_FOLD}
        assert set(names) <= covered


#
# The reference cases whose bodies import the reference's modules
#


def test_lookaside_substitutes_calls():
    import math

    for itp in (port_itp, sys.modules["thunder_tpu.core.interpreter"]):
        calls = []

        def fake_exp(v, calls=calls):
            calls.append(v)
            return 42.0

        def g(x):
            return x * math.exp(1.0)

        res, ctx = itp.interpret(g, 2.0, lookasides={math.exp: fake_exp})
        assert res == 84.0 and calls == [1.0]
        assert any(e[0] == "lookaside" for e in ctx.log)


def test_registered_lookaside_and_opaque():
    def slow_helper(v):
        return v + 1

    def fast_helper(v):
        return v + 100

    def callee(v):
        return v * 3

    port_itp.register_lookaside(slow_helper)(fast_helper)
    port_itp.make_opaque(callee)
    try:
        assert port_itp.interpret(lambda x: slow_helper(x), 1)[0] == 101
        res, ctx = port_itp.interpret(lambda x: callee(x), 2)
        assert res == 6
        assert not any(e[0] == "op" and e[2] == "callee" for e in ctx.log)
        # the registries are the port's own: the reference's interpreter
        # still interprets both helpers
        from thunder_tpu.core import interpreter as ref_itp

        assert ref_itp.interpret(lambda x: slow_helper(x), 1)[0] == 2
        _, rctx = ref_itp.interpret(lambda x: callee(x), 2)
        assert any(e[0] == "op" and e[2] == "callee" for e in rctx.log)
    finally:
        port_itp._default_lookasides.pop(slow_helper, None)
        port_itp._default_opaque.discard(callee)


def test_executor_replaces_lookaside_reaches_interpreter():
    """``register_operator(replaces=fn)`` diverts direct calls to ``fn``
    inside interpreted code to the executor's symbol, in both packages."""
    from thunder_tpu.core.prims import PrimIDs as RIDs, prim_lookup as rlookup
    from thunder_tpu.extend import OperatorExecutor as RExec, register_executor as rreg
    from thunder_tpu_torch.core.prims import PrimIDs as PIDs, prim_lookup as plookup
    from thunder_tpu_torch.extend import OperatorExecutor as PExec, register_executor as preg

    def my_softplus(x):
        raise AssertionError("the host version must not run under tracing")

    def f(x):
        return my_softplus(x)

    xv = np.random.default_rng(7).standard_normal((8,)).astype(np.float32)
    rex = RExec("bytecode_lookaside_ref", version="0")
    rreg(rex)
    rex.register_operator("soft_plus", like=rlookup[RIDs.EXP], replaces=my_softplus,
                          fn=lambda x: jnp.log1p(jnp.exp(x)))
    pex = PExec("bytecode_lookaside_port", version="0")
    preg(pex)
    pex.register_operator("soft_plus", like=plookup[PIDs.EXP], replaces=my_softplus,
                          fn=lambda x: torch.log1p(torch.exp(x)))
    want = np.log1p(np.exp(xv))
    ref = np.asarray(tt.jit(f, interpretation="bytecode", executors=[rex])(xv))
    port = ttt.jit(f, interpretation="bytecode", executors=[pex])(torch.from_numpy(xv))
    np.testing.assert_allclose(ref, want, rtol=1e-5)
    np.testing.assert_allclose(port.numpy(), ref, rtol=RTOL, atol=ATOL)


_STATE: dict = {}


def _grad_fn_ref(x):
    return ref_ltorch.sum(ref_ltorch.sin(x * _STATE["w"]))


def _grad_fn_port(x):
    return port_ltorch.sum(port_ltorch.sin(x * _STATE["w"]))


def test_grad_through_the_bytecode_frontend_captures_state():
    """value_and_grad with a weight read from a global: the value and the
    grad of the explicit argument equal the reference's, and the global is
    a captured tensor in both."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((5,)).astype(np.float32)
    _STATE["w"] = rng.standard_normal((5,)).astype(np.float32)
    try:
        rvg = tt.value_and_grad(_grad_fn_ref, interpretation="bytecode")
        pvg = ttt.value_and_grad(_grad_fn_port, interpretation="bytecode")
        rv, rg = rvg(x)
        pv, pg = pvg(torch.from_numpy(x))
        np.testing.assert_allclose(pv.item(), float(rv), rtol=RTOL)
        np.testing.assert_allclose(pg.numpy(), np.asarray(rg), rtol=RTOL, atol=ATOL)
        rstate = tt.compile_stats(rvg).interpreter_cache[0].key_meta["state"]
        pstate = ttt.compile_stats(pvg).interpreter_cache[0].key_meta["state"]
        assert pstate == rstate and pstate["n_state_tensors"] == 1
        # grad and vjp pass the option through as well
        pgrad = ttt.grad(_grad_fn_port, interpretation="bytecode")
        np.testing.assert_allclose(pgrad(torch.from_numpy(x)).numpy(), np.asarray(rg),
                                   rtol=RTOL, atol=ATOL)
        pvjp = ttt.vjp(_grad_fn_port, interpretation="bytecode")
        _, pullback = pvjp(torch.from_numpy(x))
        np.testing.assert_allclose(pullback(torch.ones(())).numpy(), np.asarray(rg),
                                   rtol=RTOL, atol=ATOL)
        assert ttt.last_interpreter_log(pgrad) and ttt.last_interpreter_log(pvjp)
    finally:
        _STATE.clear()


#
# test_guard_fuzz.py's seeds and test_einops.py's bytecode case
#


@pytest.fixture
def _guard_helper_restored():
    import _guard_helper_mod as hm

    saved = hm.SCALE, dict(hm.CFG)
    yield
    hm.SCALE = saved[0]
    hm.CFG.clear()
    hm.CFG.update(saved[1])
    _ref_gf.STATE.clear()


@pytest.mark.usefixtures("_guard_helper_restored")
@pytest.mark.parametrize("seed", range(60))
def test_guard_fuzz(seed, monkeypatch):
    """Each seed's program, mutation sequence and native checks run once per
    package (the body resets the state it reads first): the same results,
    retraces and captured state after every call."""
    ref, port = _run_both(monkeypatch, _ref_gf, lambda: _ref_gf.test_guard_fuzz(seed),
                          port_ltorch_name=None)
    assert len(ref) >= 9
    _assert_same_events(ref, port, f"guard fuzz seed {seed}")


def test_bytecode_frontend_einops(monkeypatch):
    ref, port = _run_both(monkeypatch, _ref_einops, _ref_einops.test_bytecode_frontend_einops,
                          port_ltorch_name=None, reseed=7)
    assert len(ref) == 1
    _assert_same_events(ref, port, "einops")


#
# The dispatch cache: a guard on captured state shadows and recovers entries
#

DISPATCH_SCALE = 2.0


def _dispatch_fn(x):
    return x * DISPATCH_SCALE + 1.0


def test_dispatch_cache_state_guards(monkeypatch):
    """An entry with state guards: a key hit whose prologue fails on the
    rebound global shadows it (a guard eviction, then a miss); rebinding the
    old value finds it again by the bucket scan.  Every counter of
    ``dispatch_stats()`` equal in both packages after every call."""
    x = np.arange(4, dtype=np.float32)
    seqs = []
    for pkg, xin in ((tt, jnp.asarray(x)), (ttt, torch.from_numpy(x))):
        jfn = pkg.jit(_dispatch_fn, interpretation="bytecode")
        seq = []
        for scale in (2.0, 2.0, 5.0, 2.0, 5.0):
            monkeypatch.setattr(sys.modules[__name__], "DISPATCH_SCALE", scale)
            out = jfn(xin)
            stats = pkg.dispatch_stats(jfn)
            seq.append((np.asarray(out).tolist(), pkg.cache_hits(jfn), pkg.cache_misses(jfn),
                        {k: stats[k] for k in ("key_hits", "scan_hits", "guard_evictions",
                                                "cached_specializations", "prologue_runs")}))
        entries = pkg.compile_stats(jfn).interpreter_cache
        assert all(e.has_state_guards for e in entries)
        assert entries[0].key_meta["state"]["n_guards"] == 1
        seqs.append(seq)
    assert seqs[0] == seqs[1]
    assert [s[3]["guard_evictions"] for s in seqs[1]] == [0, 0, 1, 2, 3]
    assert [s[2] for s in seqs[1]] == [1, 1, 2, 2, 2]


#
# The sharp-edges policies of the interpreter
#

SHARP_STATE: dict = {}


class _Key:
    pass


def _iterate_unguardable(x):
    acc = x
    for k in SHARP_STATE:
        acc = acc + SHARP_STATE[k]
    return acc


def _external_write(x):
    SHARP_STATE["n"] = SHARP_STATE.get("n", 0) + 1
    return x * 2.0


@pytest.mark.parametrize("policy", ["allow", "warn", "error"])
@pytest.mark.parametrize("case", ["unguardable_keys", "external_write"])
def test_sharp_edges_policies(case, policy):
    """Iterating a global dict with keys no guard can check, and a write into
    external state while tracing: silent, a warning or an error by policy,
    the same in both packages."""
    from thunder_tpu.core.sharp_edges import SharpEdgeError as RError
    from thunder_tpu_torch.core.sharp_edges import SharpEdgeError as PError

    fn, what = ((_iterate_unguardable, "unguardable keys") if case == "unguardable_keys"
                else (_external_write, "write to external state"))
    x = np.ones(3, dtype=np.float32)
    seen = []
    for pkg, err, xin in ((tt, RError, jnp.asarray(x)), (ttt, PError, torch.from_numpy(x))):
        SHARP_STATE.clear()
        if case == "unguardable_keys":
            SHARP_STATE.update({_Key(): 1.0, _Key(): 2.0})
        jfn = pkg.jit(fn, interpretation="bytecode", sharp_edges=policy)
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            if policy == "error":
                with pytest.raises(err, match=what):
                    jfn(xin)
                out = None
            else:
                out = np.asarray(jfn(xin)).tolist()
        seen.append((out, sum(what in str(i.message) for i in w)))
    SHARP_STATE.clear()
    assert seen[0] == seen[1]
    assert seen[1][1] == (1 if policy == "warn" else 0)


#
# A 2-layer Llama loss written as user code, its weights in a global dict:
# chip_smoke.py's user_loss (phase 19), run on the CPU
#

T_LLAMA = 32


def _tiny_llama(seed=0):
    jcfg = jllama.Config.from_name("tiny-llama-debug")
    cfg = tllama.Config.from_name("tiny-llama-debug")
    rng = np.random.default_rng(seed)
    shapes = jllama.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    nparams = jax.tree_util.tree_map(
        lambda a: (0.02 * rng.standard_normal(a.shape) + (a.ndim == 1)).astype(np.float32),
        shapes)
    idx = rng.integers(0, cfg.vocab_size, (2, T_LLAMA)).astype(np.int64)
    tgt = rng.integers(0, cfg.vocab_size, (2, T_LLAMA)).astype(np.int64)
    return jcfg, cfg, nparams, idx, tgt


def _regions(trace) -> list:
    return [b._call_ctx[b.sym.name].key for b in trace.bound_symbols if b.sym.is_fusion]


def test_user_code_llama_loss_equals_jit_gpt_loss(monkeypatch):
    """The port: the bytecode loss over captured weights is bitwise the
    functional ``jit(gpt_loss)``'s, its program has the same fusion regions
    and no baked constant, and every weight and both rope tables are
    captured inputs; an in-place row edit is seen with no retrace, a
    rebound global scalar costs one retrace and gives the functional
    frontend's value.  Across packages: the reference's ``jit(gpt_loss)``
    within 1e-5 relative (the two frameworks' float32 products and sums;
    ``test_torch_port_jit.py``'s bar)."""
    jcfg, cfg, nparams, idx, tgt = _tiny_llama()
    params = ttt.params_from_numpy(nparams, device="cpu")
    cos, sin = tllama.build_rope_cache(cfg, T_LLAMA)
    monkeypatch.setattr(chip_smoke, "BYTECODE_CFG", cfg)
    monkeypatch.setattr(chip_smoke, "BYTECODE_STATE", {"params": params, "cos": cos, "sin": sin})
    ti, tt_ = torch.from_numpy(idx), torch.from_numpy(tgt)
    jfn = ttt.jit(chip_smoke.user_loss, interpretation="bytecode")
    loss = jfn(ti, tt_)
    ffn = ttt.jit(lambda p, i, t, c, s: ttt.gpt_loss(p, i, t, c, s, cfg))
    want = ffn(params, ti, tt_, cos, sin)
    assert torch.equal(loss, want)
    assert sorted(map(str, _regions(ttt.last_traces(jfn)[-1]))) == \
        sorted(map(str, _regions(ttt.last_traces(ffn)[-1])))
    assert not [b for t in ttt.last_traces(jfn) for b in t.bound_symbols
                if b.sym.name.startswith("TCONST")]
    state = ttt.compile_stats(jfn).interpreter_cache[0].key_meta["state"]
    assert state["n_state_tensors"] == len(jax.tree_util.tree_leaves(nparams)) + 2
    assert state["guard_roots"] == ("globals",)
    # the config's fields the loss reads are guards
    prologue = ttt.last_prologue_traces(jfn)[-1].python()
    for field in ("norm_eps", "head_size", "n_head", "n_query_groups", "rope_n_elem"):
        assert f"'{field}'" in prologue
    # the second call is a hit; an in-place weight edit is seen with no retrace
    assert torch.equal(jfn(ti, tt_), loss)
    w = params["blocks"][0]["attn"]["wq"]
    row = w[0].clone()
    w[0].add_(0.5)
    edited = jfn(ti, tt_)
    assert not torch.equal(edited, loss)
    assert torch.equal(edited, ffn(params, ti, tt_, cos, sin))
    w[0].copy_(row)
    assert torch.equal(jfn(ti, tt_), loss)
    assert (ttt.cache_hits(jfn), ttt.cache_misses(jfn)) == (3, 1)
    # a rebound global scalar: one retrace, the functional frontend's value
    monkeypatch.setattr(chip_smoke, "LOSS_SCALE", 2.0)
    scaled = jfn(ti, tt_)
    assert ttt.cache_misses(jfn) == 2
    assert torch.equal(scaled, ttt.jit(chip_smoke.user_loss_p)(params, ti, tt_, cos, sin))
    monkeypatch.setattr(chip_smoke, "LOSS_SCALE", 1.0)
    assert torch.equal(jfn(ti, tt_), loss) and ttt.cache_misses(jfn) == 2

    # the reference: its jit(gpt_loss) on the same numpy weights
    jcos, jsin = jllama.build_rope_cache(jcfg, T_LLAMA)
    ref = tt.jit(lambda p, i, t, c, s: jllama.gpt_loss(p, i, t, c, s, jcfg))(
        jax.tree_util.tree_map(jnp.asarray, nparams), jnp.asarray(idx.astype(np.int32)),
        jnp.asarray(tgt.astype(np.int32)), jcos, jsin)
    assert abs(loss.item() - float(ref)) <= 1e-5 * abs(float(ref))


def test_user_code_llama_value_and_grad(monkeypatch):
    """value_and_grad of the user-code loss with the params explicit and the
    config from a global: loss and every grad bitwise the functional
    frontend's; against the reference's
    ``value_and_grad(gpt_loss)``, the loss within 1e-5 relative and each
    grad within 1e-4 of its largest magnitude (``test_torch_port_train.py``'s
    bars)."""
    jcfg, cfg, nparams, idx, tgt = _tiny_llama(seed=1)
    params = ttt.params_from_numpy(nparams, device="cpu")
    cos, sin = tllama.build_rope_cache(cfg, T_LLAMA)
    monkeypatch.setattr(chip_smoke, "BYTECODE_CFG", cfg)
    ti, tt_ = torch.from_numpy(idx), torch.from_numpy(tgt)
    vg = ttt.value_and_grad(chip_smoke.user_loss_p, interpretation="bytecode")
    bv, bg = vg(params, ti, tt_, cos, sin)
    fv, fg = ttt.value_and_grad(chip_smoke.user_loss_p)(params, ti, tt_, cos, sin)
    assert torch.equal(bv, fv)
    bl, fl = jax.tree_util.tree_leaves(bg), jax.tree_util.tree_leaves(fg)
    assert len(bl) == len(fl) == len(jax.tree_util.tree_leaves(nparams))
    assert all(torch.equal(a, b) for a, b in zip(bl, fl))
    state = ttt.compile_stats(vg).interpreter_cache[0].key_meta["state"]
    assert state["n_state_tensors"] == 0 and state["n_guards"] > 0
    jcos, jsin = jllama.build_rope_cache(jcfg, T_LLAMA)
    rv, rg = tt.value_and_grad(lambda p, i, t, c, s: jllama.gpt_loss(p, i, t, c, s, jcfg))(
        jax.tree_util.tree_map(jnp.asarray, nparams), jnp.asarray(idx.astype(np.int32)),
        jnp.asarray(tgt.astype(np.int32)), jcos, jsin)
    assert abs(bv.item() - float(rv)) <= 1e-5 * abs(float(rv))
    for a, b in zip(bl, jax.tree_util.tree_leaves(rg)):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 1e-4 * max(np.abs(b).max(), 1e-30)


#
# A kept divergence: an instance of the package's own classes is user state
#

CFG_GLOBAL = None


def _cfg_scaled(x):
    return x * CFG_GLOBAL.norm_eps


def test_config_global_is_guarded(monkeypatch):
    """A model ``Config`` read from the user's globals: the port guards the
    attributes the program reads, so rebinding the global retraces.  The
    reference classes the instance by its class's module as its own
    tracing state and guards nothing: its second call replays the first
    program (``ROADMAP.md``'s kept divergences)."""
    import dataclasses

    mod = sys.modules[__name__]
    x = np.ones(3, dtype=np.float32)
    runs = {}
    for name, pkg, cfg, xin in (("ref", tt, jllama.Config.from_name("tiny-llama-debug"),
                                 jnp.asarray(x)),
                                ("port", ttt, tllama.Config.from_name("tiny-llama-debug"),
                                 torch.from_numpy(x))):
        monkeypatch.setattr(mod, "CFG_GLOBAL", cfg)
        jfn = pkg.jit(_cfg_scaled, interpretation="bytecode")
        first = float(np.asarray(jfn(xin))[0])
        monkeypatch.setattr(mod, "CFG_GLOBAL", dataclasses.replace(cfg, norm_eps=1e-3))
        second = float(np.asarray(jfn(xin))[0])
        runs[name] = (first, second, pkg.cache_misses(jfn))
    assert runs["port"] == (pytest.approx(1e-5), pytest.approx(1e-3), 2)
    assert runs["ref"] == (pytest.approx(1e-5), pytest.approx(1e-5), 1)


#
# Modules through the interpreter
#


def test_module_through_the_interpreter_guards_no_port_state():
    """``jit(module, interpretation="bytecode")`` interprets the port's
    functionalized forward: its reads of the port's own globals (the tracing
    mode) make no guard, so the second call is a hit; loss and grads equal
    ``jit(module)``'s."""
    torch.manual_seed(0)
    m = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.Tanh(), torch.nn.Linear(16, 1))
    x = torch.randn(4, 8)
    grads = []
    for kw in ({}, {"interpretation": "bytecode"}):
        tm = ttt.jit(m, **kw)
        for _ in range(2):
            m.zero_grad()
            out = tm(x).sum()
            out.backward()
        grads.append((out.detach(), [p.grad.clone() for p in m.parameters()]))
        assert (ttt.cache_hits(tm), ttt.cache_misses(tm)) == (1, 1)
        if kw:
            entry = ttt.compile_stats(tm).interpreter_cache[0]
            assert entry.key_meta["state"] is None
            assert "ThunderTracingMode" not in ttt.last_prologue_traces(tm)[-1].python()
            assert ttt.last_interpreter_log(tm)
    (l0, g0), (l1, g1) = grads
    assert torch.equal(l0, l1) and all(torch.equal(a, b) for a, b in zip(g0, g1))
    # the chain rooted at the tracing mode's class is framework state
    from thunder_tpu_torch import torch_interop

    fwd = ttt.jit(m, interpretation="bytecode")._make_functional_fwd()
    assert port_jit_ext._internal_root(fwd, (("globals", "ThunderTracingMode"),
                                             ("attr", "__init__")))
    assert port_jit_ext._internal_root(fwd, (("gmod", torch_interop.__name__), ("item", "x")))
    assert not port_jit_ext._internal_root(fwd, (("gmod", "thunder_tpu_torch_user"),
                                                 ("item", "x")))


def test_hf_gpt2_traces_via_bytecode():
    """``jit(GPT2LMHeadModel, interpretation="bytecode")`` in both packages:
    the logits equal eager's within 1e-4 relative (the reference's bar) and
    each other's."""
    transformers = pytest.importorskip("transformers")
    cfg = transformers.GPT2Config(n_layer=2, n_head=2, n_embd=32, vocab_size=64, n_positions=32,
                                  attn_pdrop=0.0, resid_pdrop=0.0, embd_pdrop=0.0)
    torch.manual_seed(0)
    model = transformers.GPT2LMHeadModel(cfg).eval()
    ids = torch.randint(0, 64, (1, 8), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = model(ids, use_cache=False).logits.numpy()
    ref = tt.jit(model, interpretation="bytecode")(input_ids=ids, use_cache=False).logits
    port = ttt.jit(model, interpretation="bytecode")(input_ids=ids, use_cache=False).logits
    np.testing.assert_allclose(ref.detach().numpy(), want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(port.detach().numpy(), want, rtol=1e-4, atol=1e-5)
