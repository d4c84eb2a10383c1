"""The port's bytecode interpreter against native Python and the reference's.

``thunder_tpu_torch/core/interpreter.py`` is held to the JAX package's own
interpreter corpora, imported from their test modules:

- every ``snip_*`` of ``test_interpreter_differential.py`` (and its
  alternate-argument cases) runs natively and through the port's
  ``interpret``: the same value, or the same exception type and message;
- the three seeded program generators of ``test_interpreter_fuzz.py`` at
  their seeds, under the same contract;
- the ``STORE_SLICE`` and in-place ``BINARY_OP`` scenarios of
  ``test_interpreter_handlers.py`` against the port's handlers;
- the classes of ``test_interpreter.py`` that need no tensor program of the
  reference: their bodies run with the module's ``interpret``,
  ``InterpreterError``, ``tt`` and ``ltorch`` bound to the port's;
- for pure-Python functions, the port's run log equals the reference's
  event by event.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import test_interpreter as _ref_it
import test_interpreter_differential as _ref_diff
import test_interpreter_fuzz as _ref_fuzz
import test_interpreter_handlers as _ref_handlers
import thunder_tpu_torch as ttt
import thunder_tpu_torch.torch as port_ltorch
from conftest import diff_native
from thunder_tpu.core import interpreter as ref_itp
from thunder_tpu_torch.core import interpreter as port_itp
from thunder_tpu_torch.core.proxies import Proxy as PortProxy
from torch_port_threads import one_torch_thread  # noqa: F401


def _port_interpreted(fn, *args):
    try:
        return ("ok", port_itp.interpret(fn, *args)[0])
    except BaseException as e:
        return ("raise", type(e).__name__, str(e))


def _check(fn, *args):
    native = diff_native(fn, *args)
    port = _port_interpreted(fn, *args)
    assert native == port, f"native={native!r} port={port!r}"


#
# The differential corpus
#


@pytest.mark.parametrize("fn", _ref_diff.ALL_SNIPPETS, ids=lambda f: f.__name__)
def test_differential(fn):
    _check(fn, 3)


_ALT_ARG = [_ref_diff.snip_chained_comparison, _ref_diff.snip_walrus, _ref_diff.snip_slice_zoo,
            _ref_diff.snip_try_in_loop_continue, _ref_diff.snip_else_clauses]


@pytest.mark.parametrize("fn", _ALT_ARG, ids=lambda f: f.__name__)
def test_differential_alt_arg(fn):
    _check(fn, 0)
    _check(fn, 7)


def _log_of(itp, fn, *args):
    """The run log of ``interpret(fn, *args)``, kept also when the function
    raises (``interpret`` returns its context only on success)."""
    ctx = itp.InterpreterCompileCtx(fn=fn, opaque=set(itp._default_opaque),
                                    lookasides=dict(itp._default_lookasides))
    ctx.track(fn, itp.ProvenanceRecord(itp.PseudoInst.INPUT_FN))
    ctx.root_globals = fn.__globals__
    try:
        itp._run_function(ctx, fn, args, {}, depth=0)
    except Exception:
        pass
    return ctx.log


@pytest.mark.parametrize("fn", _ref_diff.ALL_SNIPPETS, ids=lambda f: f.__name__)
def test_run_log_equals_reference(fn):
    """Pure Python: the port's per-opcode run log is the reference's, event
    for event (the same bytecode, the same calls, lookasides and host calls)."""
    port = _log_of(port_itp, fn, 3)
    ref = _log_of(ref_itp, fn, 3)
    assert port, "the interpreter logged nothing"
    assert port == ref


#
# The seeded program generators
#


def _fuzz_check(seed, src, arg_pairs):
    ns: dict = {}
    exec(src, ns)  # noqa: S102 - generated from the reference's seeded grammar
    fn = ns["f"]
    for a, b in arg_pairs:
        native = diff_native(fn, a, b)
        port = _port_interpreted(fn, a, b)
        assert native == port, f"seed={seed} args=({a},{b})\n{src}\nnative={native!r}\nport={port!r}"


@pytest.mark.parametrize("seed", range(150))
def test_fuzz_generator_program(seed):
    src = _ref_fuzz._gen_program(_ref_fuzz._Gen(seed + 50_000))
    _fuzz_check(seed, src, ((3, 2), (0, 5), (-4, 7)))


@pytest.mark.parametrize("seed", range(120))
def test_fuzz_class_program(seed):
    src = _ref_fuzz._class_program(_ref_fuzz._Gen(seed + 200_000))
    _fuzz_check(seed, src, ((3, 2), (0, 5), (-4, 7)))


@pytest.mark.parametrize("seed", range(300))
def test_fuzz_program(seed):
    src = _ref_fuzz._Gen(seed).program(n_stmts=4)
    _fuzz_check(seed, src, ((3, 2), (0, 7), (-4, 5)))


@pytest.mark.parametrize("seed", range(0, 300, 30))
def test_fuzz_program_run_log_equals_reference(seed):
    ns: dict = {}
    exec(_ref_fuzz._Gen(seed).program(n_stmts=4), ns)  # noqa: S102
    assert _log_of(port_itp, ns["f"], 3, 2) == _log_of(ref_itp, ns["f"], 3, 2)


#
# The handler scenarios, against the port's handlers
#


@pytest.fixture
def _port_handlers(monkeypatch):
    for name in ("InterpreterCompileCtx", "InterpreterError", "ProvenanceRecord", "PseudoInst",
                 "_handlers"):
        monkeypatch.setattr(_ref_handlers, name, getattr(port_itp, name))
    monkeypatch.setattr(_ref_handlers, "Proxy", PortProxy)


@pytest.mark.usefixtures("_port_handlers")
class TestPortStoreSlice(_ref_handlers.TestStoreSlice):
    pass


@pytest.mark.usefixtures("_port_handlers")
class TestPortInplaceBinaryOp(_ref_handlers.TestInplaceBinaryOp):
    pass


def test_handler_scenarios_reach_the_port():
    """The scenarios above run the port's handler table, not the reference's."""
    assert port_itp._handlers["STORE_SLICE"].__module__ == "thunder_tpu_torch.core.interpreter"
    assert port_itp._handlers is not ref_itp._handlers


#
# test_interpreter.py's classes that need no tensor program of the reference
#


@pytest.fixture
def _port_interpreter(monkeypatch):
    monkeypatch.setattr(_ref_it, "interpret", port_itp.interpret)
    monkeypatch.setattr(_ref_it, "InterpreterError", port_itp.InterpreterError)
    monkeypatch.setattr(_ref_it, "tt", ttt)
    monkeypatch.setattr(_ref_it, "ltorch", port_ltorch)


_rng = np.random.default_rng(29)


@pytest.mark.usefixtures("_port_interpreter")
class TestPortInterpreterCore(_ref_it.TestInterpreterCore):
    def test_except_in_jitted_function(self):
        # the reference's body imports its own torch language; this is the
        # same program over the port's
        def f(x, cfg):
            try:
                scale = cfg["scale"]
            except KeyError:
                scale = 2.0
            return port_ltorch.mul(x, scale)

        x = _rng.standard_normal((4,)).astype(np.float32)
        got = np.asarray(ttt.jit(f, interpretation="bytecode")(x, {}))
        np.testing.assert_allclose(got, x * 2.0, rtol=1e-6)
        got = np.asarray(ttt.jit(f, interpretation="bytecode")(x, {"scale": 3.0}))
        np.testing.assert_allclose(got, x * 3.0, rtol=1e-6)


@pytest.mark.usefixtures("_port_interpreter")
class TestPortExceptionStateSemantics(_ref_it.TestExceptionStateSemantics):
    pass


@pytest.mark.usefixtures("_port_interpreter")
class TestPortGenerators(_ref_it.TestGenerators):
    pass


@pytest.mark.usefixtures("_port_interpreter")
class TestPortAssertAndMatch(_ref_it.TestAssertAndMatch):
    pass


@pytest.mark.usefixtures("_port_interpreter")
class TestPortExceptionGroups(_ref_it.TestExceptionGroups):
    pass


@pytest.mark.usefixtures("_port_interpreter")
class TestPortAsync(_ref_it.TestAsync):
    # the two bodies below import jax.numpy in the reference; the programs
    # are the same over torch tensors
    def test_class_with_inheritance_and_traced_math(self):
        def model(t):
            class Base:
                def shift(self, v):
                    return v + 1.0

            class Doubler(Base):
                def run(self, v):
                    return self.shift(v) * 2.0

            return Doubler().run(t)

        jfn = ttt.jit(model, interpretation="bytecode")
        out = jfn(torch.ones((3,), dtype=torch.float32))
        np.testing.assert_allclose(np.asarray(out), 4.0)

    def test_traced_tensor_math_inside_coroutine(self):
        def model(x):
            async def scale(t):
                return t * 2.0

            async def pipeline(t):
                t = await scale(t)
                return t + 1.0

            coro = pipeline(x)
            try:
                coro.send(None)
            except StopIteration as e:
                return e.value

        jfn = ttt.jit(model, interpretation="bytecode")
        x = np.ones((4,), dtype=np.float32)
        out = jfn(torch.from_numpy(x))
        np.testing.assert_allclose(np.asarray(out), x * 2.0 + 1.0)


def test_port_classes_cover_the_reference_classes():
    """Each ported class runs every test of its reference class."""
    pairs = [(TestPortInterpreterCore, _ref_it.TestInterpreterCore),
             (TestPortExceptionStateSemantics, _ref_it.TestExceptionStateSemantics),
             (TestPortGenerators, _ref_it.TestGenerators),
             (TestPortAssertAndMatch, _ref_it.TestAssertAndMatch),
             (TestPortExceptionGroups, _ref_it.TestExceptionGroups),
             (TestPortAsync, _ref_it.TestAsync)]
    for port_cls, ref_cls in pairs:
        ref_tests = {n for n in dir(ref_cls) if n.startswith("test_")}
        assert ref_tests and ref_tests <= {n for n in dir(port_cls) if n.startswith("test_")}


def test_port_package_functions_run_as_host_calls():
    """The port's own functions are opaque to its interpreter: a call into
    ``thunder_tpu_torch`` is one host call, not interpreted frames."""
    from thunder_tpu_torch.core import baseutils

    def f(v):
        return baseutils.check(v > 0, lambda: "negative")

    _, ctx = port_itp.interpret(f, 1)
    assert ("opaque", 0, "check") in ctx.log
    assert not any(e[0] == "op" and e[2] == "check" for e in ctx.log)
    assert "thunder_tpu_torch" in port_itp._OPAQUE_TOP_PACKAGES
