"""The port's transforms against the JAX package's, on the CPU.

``thunder_tpu_torch.core.transforms`` (the VJP table, the forward/backward
split, ``grad``/``value_and_grad``/``vjp``), ``core.rematerialization`` and
``core.autocast`` against their ``thunder_tpu`` counterparts:

- every ``supports_grad`` row of ``tests/opinfos.py``: the port's
  ``value_and_grad`` of the row's torch function (summed) against
  ``torch.autograd`` at the reference's own tolerances
  (``tests/test_opinfos.py::test_grad_f32``), and the row's printed forward
  and backward traces from ``forward_and_backward_from_trace`` against the
  reference's (the reference side is traced, not compiled);
- ``grad``, ``value_and_grad`` and ``vjp`` against ``tt.grad``,
  ``tt.value_and_grad`` and ``tt.vjp``: pytree params, ``argnums``,
  non-scalar outputs through the ``vjp`` pullback (float32 within 1e-6
  relative), the non-scalar loss raising alike;
- the generic VJP (``torch.func.vjp`` over the torch executor's impl): the
  convolution fallback against the reference, and its operator cache
  bounded across recompiles (``tests/test_grad.py::
  test_generic_vjp_registry_bounded``);
- a tiny ``gpt_loss``, tiny-llama-debug and tiny-mistral-debug: the port's
  loss and grads against ``tt.value_and_grad`` (loss within 1e-5 relative,
  each grad within 1e-4 of its largest magnitude); the reference's
  ``gpt_loss`` source run through both languages gives printed split and
  rematerialized traces equal to the reference's under ``none``,
  ``attention`` and ``full_block`` (before the port's reorder), equal
  ``saved_bytes``, and a reordered backward holding the same multiset of
  bound symbols in a topological order;
- the reorder's purpose: the backward's live-bytes peak, after
  ``del_last_used``, grows from 2 to 4 layers by no more than the saved
  residuals grow under ``attention``, and no policy's peak is above the
  reference order's;
- the residual handover: a saved residual is dead before the backward
  program returns;
- ``autocast``: its printed trace and values against the reference's.

Divergences ``ROADMAP.md`` Queue 3 keeps on purpose are normalized by name:
the generic VJP operators' numbering (a process-wide counter in both
packages) and 64-bit dtypes (the reference narrows them to 32 bits).
"""
from __future__ import annotations

import functools
import re
import types
import weakref
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import thunder_tpu as tt
import thunder_tpu.torch as rlang
import thunder_tpu_torch as ttt
import thunder_tpu_torch.torch as plang
from opinfos import opinfos
from test_torch_port_ltorch import SYMBOL_ROWS, _port
from thunder_tpu.core import rematerialization as rremat
from thunder_tpu.core import transforms as rtransforms
from thunder_tpu.core.autocast import autocast as rautocast
from thunder_tpu.core.transform_common import absorb_ce_widening_converts as rabsorb
from thunder_tpu.core.transform_common import cse as rcse
from thunder_tpu.core.transform_common import dce as rdce
from thunder_tpu.functional import trace_from_fn as rtrace
from thunder_tpu.models import llama as jllama
from thunder_tpu_torch._tree import tree_leaves
from thunder_tpu_torch.core import rematerialization as premat
from thunder_tpu_torch.core import transforms as ptransforms
from thunder_tpu_torch.core.autocast import autocast as pautocast
from thunder_tpu_torch.core.transform_common import absorb_ce_widening_converts as pabsorb
from thunder_tpu_torch.core.transform_common import cse as pcse
from thunder_tpu_torch.core.transform_common import dce as pdce
from thunder_tpu_torch.executors.passes import del_last_used
from thunder_tpu_torch.functional import trace_from_fn as ptrace
from thunder_tpu_torch.models import llama as tllama
from torch_port_threads import one_torch_thread  # noqa: F401

SEED = 0


@pytest.fixture(autouse=True, scope="module")
def _leave_jax_caches_as_found():
    """The JAX package's module caches, which other files count entries of."""
    from thunder_tpu.models import generate as jgen
    from thunder_tpu.serving import engine as jengine

    before = dict(jgen._generate_cache), dict(jengine._program_cache)
    yield
    for cache, saved in zip((jgen._generate_cache, jengine._program_cache), before):
        cache.clear()
        cache.update(saved)


def _normalize(program: str) -> str:
    """Package and executor names, the generic VJP operators' numbering and
    64-bit dtypes (``ROADMAP.md`` Queue 3) made alike."""
    program = program.replace("thunder_tpu_torch", "thunder_tpu")
    program = re.sub(r"\b(jax|torch)_(?=[a-z])", "EX_", program)
    program = re.sub(r"\b(vjp_\w+?)_\d+\b", r"\1_N", program)
    program = program.replace("int64", "int32").replace("float64", "float32")
    return "\n".join(line for line in program.splitlines()
                     if not line.startswith("# Constructed by"))


def _to_ref(x):
    return jnp.asarray(x) if isinstance(x, np.ndarray) else x


def _to_port(x):
    return torch.from_numpy(x.copy()) if isinstance(x, np.ndarray) else x


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x)


def _split(trace_fn, tf, dce, cse, absorb, fn, args, argnums):
    """Acquire ``fn`` with ``argnums`` differentiable, then dce, cse and
    absorb_ce_widening_converts, then the forward/backward split."""
    tr = trace_fn(fn, args, {}, grad_argnums=argnums)
    comp = absorb(cse(dce(tr.computation_trace)))
    comp.args = tr.computation_trace.args
    return tf.forward_and_backward_from_trace(comp)


def _ref_split(fn, args, argnums):
    return _split(rtrace, rtransforms, rdce, rcse, rabsorb, fn, [_to_ref(a) for a in args],
                  argnums)


def _port_split(fn, args, argnums):
    return _split(ptrace, ptransforms, pdce, pcse, pabsorb, fn, [_to_port(a) for a in args],
                  argnums)


def _assert_same_programs(port_traces, ref_traces):
    for p, r in zip(port_traces, ref_traces):
        assert _normalize(p.python()) == _normalize(r.python())


#
# Every supports_grad row of tests/opinfos.py
#

_GRAD_ROWS = [o for o in opinfos if o.supports_grad]


def _argnums(info, samples) -> tuple:
    return info.grad_argnums or tuple(
        i for i, s in enumerate(samples) if isinstance(s, np.ndarray) and s.dtype == np.float32)


@pytest.mark.parametrize("info", _GRAD_ROWS, ids=[o.name for o in _GRAD_ROWS])
def test_row_grad_f32(info):
    samples = info.sample(np.float32)
    argnums = _argnums(info, samples)
    assert argnums, f"{info.name}: no differentiable inputs in sample"
    fn = _port(info.op) if info.name in SYMBOL_ROWS else info.torch_ref

    val, grads = ttt.value_and_grad(lambda *a: fn(*a).sum(), argnums=argnums)(
        *[_to_port(s) for s in samples])
    if len(argnums) == 1:
        grads = (grads,)
    targs = [_to_port(s).requires_grad_(True) if i in argnums else _to_port(s)
             for i, s in enumerate(samples)]
    tout = info.torch_ref(*targs)
    tout.sum().backward()
    np.testing.assert_allclose(_np(val), _np(tout.sum()), rtol=max(info.rtol, 1e-5),
                               atol=max(info.atol, 1e-5))
    rtol = info.grad_rtol if info.grad_rtol is not None else max(info.rtol, 1e-4)
    atol = info.grad_atol if info.grad_atol is not None else max(info.atol, 1e-5)
    for gi, argnum in zip(grads, argnums):
        tg = targs[argnum].grad
        assert tg is not None, f"{info.name}: torch produced no grad for arg {argnum}"
        np.testing.assert_allclose(_np(gi), _np(tg), rtol=rtol, atol=atol,
                                   err_msg=f"{info.name} darg{argnum}")

    # the printed split: the reference's loss and the same loss over the
    # port language's symbols
    ref_fw_bw = _ref_split(lambda *a: rlang.sum(info.op(*a)), samples, argnums)
    pop = _port(info.op)
    port_fw_bw = _port_split(lambda *a: plang.sum(pop(*a)), samples, argnums)
    _assert_same_programs(port_fw_bw, ref_fw_bw)


#
# grad, value_and_grad and vjp
#


def _rel_close(got, want, rel):
    got, want = _np(got).astype(np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    bar = rel * max(float(np.abs(want).max()), 1e-30)
    assert np.abs(got - want).max() <= bar, (float(np.abs(got - want).max()), bar)


def _mlp_loss(L):
    def loss(params, x, scale):
        h = L.tanh(L.linear(x, params["w"], params["b"]))
        return L.sum(h * h * scale) + L.sum(params["extra"]["v"] * x[0])
    return loss


def _mlp_inputs():
    rng = np.random.default_rng(SEED)
    params = {"w": rng.standard_normal((5, 4)).astype(np.float32),
              "b": rng.standard_normal(5).astype(np.float32),
              "extra": {"v": rng.standard_normal(4).astype(np.float32)}}
    x = rng.standard_normal((3, 4)).astype(np.float32)
    scale = rng.standard_normal((3, 5)).astype(np.float32)
    return params, x, scale


def _tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree(fn, v) for v in tree)
    return fn(tree)


@pytest.mark.parametrize("argnums", [0, (0, 1), (1, 2)], ids=["params", "params_x", "x_scale"])
def test_value_and_grad_and_grad_match_the_reference(argnums):
    params, x, scale = _mlp_inputs()
    rargs = (_tree(jnp.asarray, params), jnp.asarray(x), jnp.asarray(scale))
    pargs = (_tree(_to_port, params), _to_port(x), _to_port(scale))
    rv, rg = tt.value_and_grad(_mlp_loss(rlang), argnums=argnums)(*rargs)
    pv, pg = ttt.value_and_grad(_mlp_loss(plang), argnums=argnums)(*pargs)
    _rel_close(pv, rv, 1e-6)
    rleaves, pleaves = jax.tree_util.tree_leaves(rg), tree_leaves(pg)
    assert len(rleaves) == len(pleaves)
    assert jax.tree_util.tree_structure(rg) == jax.tree_util.tree_structure(
        _tree(lambda t: 0, pg))
    for p, r in zip(pleaves, rleaves):
        _rel_close(p, r, 1e-6)
    for p, r in zip(tree_leaves(ttt.grad(_mlp_loss(plang), argnums=argnums)(*pargs)),
                    jax.tree_util.tree_leaves(tt.grad(_mlp_loss(rlang), argnums=argnums)(*rargs))):
        _rel_close(p, r, 1e-6)


def _two_outputs(L):
    def f(x, w):
        y = L.matmul(x, w)
        return L.tanh(y), L.sum(x * x, 0), L.argmax(y, 1)
    return f


def test_vjp_pullback_matches_the_reference():
    rng = np.random.default_rng(SEED + 1)
    x, w = (rng.standard_normal(s).astype(np.float32) for s in ((3, 4), (4, 5)))
    ct_y, ct_s = (rng.standard_normal(s).astype(np.float32) for s in ((3, 5), (4,)))
    rout, rpb = tt.vjp(_two_outputs(rlang))(jnp.asarray(x), jnp.asarray(w))
    pout, ppb = ttt.vjp(_two_outputs(plang))(_to_port(x), _to_port(w))
    for p, r in zip(pout, rout):
        np.testing.assert_array_equal(_np(p).astype(np.float64), np.asarray(r, np.float64)) \
            if r.dtype.kind == "i" else _rel_close(p, r, 1e-6)
    rg = rpb((jnp.asarray(ct_y), jnp.asarray(ct_s), None))
    pg = ppb((_to_port(ct_y), _to_port(ct_s), None))
    assert len(pg) == len(rg) == 2
    for p, r in zip(pg, rg):
        _rel_close(p, r, 1e-6)
    # the pullback hands the residuals to the backward program: it runs once
    with pytest.raises(RuntimeError, match="runs once"):
        ppb((_to_port(ct_y), _to_port(ct_s), None))
    # argnums picks the inputs; a wrong cotangent count raises in both
    _, ppb1 = ttt.vjp(_two_outputs(plang), argnums=1)(_to_port(x), _to_port(w))
    _, rpb1 = tt.vjp(_two_outputs(rlang), argnums=1)(jnp.asarray(x), jnp.asarray(w))
    _rel_close(ppb1((_to_port(ct_y), _to_port(ct_s), None)),
               rpb1((jnp.asarray(ct_y), jnp.asarray(ct_s), None)), 1e-6)
    with pytest.raises(RuntimeError, match="cotangents for 2"):
        ttt.vjp(_two_outputs(plang))(_to_port(x), _to_port(w))[1]((_to_port(ct_y),))


def _raised(call):
    try:
        call()
    except Exception as e:  # noqa: BLE001 - the type and message are the result
        return type(e), str(e)
    return None


def test_non_scalar_loss_raises_alike():
    x = np.ones((3, 4), np.float32)
    ref = _raised(lambda: tt.value_and_grad(lambda a: rlang.tanh(a))(jnp.asarray(x)))
    port = _raised(lambda: ttt.value_and_grad(lambda a: plang.tanh(a))(_to_port(x)))
    assert ref is not None and port == ref
    ref = _raised(lambda: tt.vjp(lambda a: rlang.argmax(a, 1))(jnp.asarray(x)))
    port = _raised(lambda: ttt.vjp(lambda a: plang.argmax(a, 1))(_to_port(x)))
    assert ref is not None and port == ref


#
# The generic VJP: torch.func.vjp over the torch executor's impl
#


def _conv_loss(L):
    return lambda x, w: L.sum(L.tanh(L.conv2d(x, w, None, 1, 1)))


def test_generic_vjp_convolution_matches_the_reference():
    rng = np.random.default_rng(SEED + 2)
    x, w = rng.standard_normal((1, 2, 6, 6)).astype(np.float32), \
        rng.standard_normal((3, 2, 3, 3)).astype(np.float32)
    rv, rg = tt.value_and_grad(_conv_loss(rlang), argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    pv, pg = ttt.value_and_grad(_conv_loss(plang), argnums=(0, 1))(_to_port(x), _to_port(w))
    _rel_close(pv, rv, 1e-5)
    for p, r in zip(pg, rg):
        _rel_close(p, r, 1e-5)
    _assert_same_programs(_port_split(_conv_loss(plang), (x, w), (0, 1)),
                          _ref_split(_conv_loss(rlang), (x, w), (0, 1)))
    bw = ttt.last_backward_traces(ttt.value_and_grad(_conv_loss(plang), argnums=(0, 1)))
    assert bw == []                             # nothing compiled before the first call


def test_generic_vjp_registry_bounded():
    """The synthesized operator is cached by (prim, argument structure,
    static args): recompiles reuse it, and the executor's tables stay put."""
    from thunder_tpu_torch.extend import get_executor

    x, w = torch.randn(1, 2, 6, 6), torch.randn(3, 2, 3, 3)
    ttt.grad(_conv_loss(plang), argnums=(0, 1))(x, w)
    size0 = len(get_executor("torch").implmap)
    ops0 = len(ptransforms._generic_vjp_cache)
    for _ in range(5):
        ttt.grad(_conv_loss(plang), argnums=(0, 1))(x, w)      # a fresh compile every call
    assert len(get_executor("torch").implmap) == size0
    assert len(ptransforms._generic_vjp_cache) == ops0
    # another static argument is another operator; its tensors stay out of the closure
    ttt.grad(lambda x, w: plang.sum(plang.conv2d(x, w, None, 2, 1)), argnums=(0, 1))(x, w)
    assert len(ptransforms._generic_vjp_cache) == ops0 + 1
    for op in ptransforms._generic_vjp_cache.values():
        cells = [c.cell_contents for c in (op._fn or op.fn).__closure__ or ()]
        assert not any(isinstance(c, (torch.Tensor, ttt.core.proxies.TensorProxy))
                       for c in cells)


#
# A tiny gpt_loss
#

B, T = 2, 128
GPT_CONFIGS = ["tiny-llama-debug", "tiny-mistral-debug"]
POLICY_KNOBS = {"none": None, "attention": (64, False), "full_block": (256, True)}


def _ref_model_on_port():
    """The reference's ``models/llama.py`` functions, rebuilt over the port's
    torch language: the same source records the same program in both
    packages, so the printed traces compare the transforms alone."""
    g = dict(jllama.__dict__)
    g["ltorch"] = plang
    for name, obj in list(g.items()):
        if isinstance(obj, types.FunctionType) and obj.__module__ == jllama.__name__:
            g[name] = types.FunctionType(obj.__code__, g, obj.__name__, obj.__defaults__,
                                         obj.__closure__)
    return types.SimpleNamespace(**g)


_PORT_REF_MODEL = _ref_model_on_port()


def _gpt_inputs(name, n_layer=None):
    kw = {} if n_layer is None else {"n_layer": n_layer}
    jcfg = jllama.Config.from_name(name, **kw)
    rng = np.random.default_rng(SEED)
    shapes = jllama.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    nparams = jax.tree_util.tree_map(
        lambda a: (0.02 * rng.standard_normal(a.shape) + (a.ndim == 1)).astype(np.float32), shapes)
    idx = rng.integers(0, jcfg.vocab_size, (B, T)).astype(np.int32)
    tgt = rng.integers(0, jcfg.vocab_size, (B, T)).astype(np.int32)
    tgt[0, :5] = -100
    cos, sin = (np.asarray(a) for a in jllama.build_rope_cache(jcfg, T))
    return jcfg, nparams, idx, tgt, cos, sin


def _splits(name, n_layer=None):
    """The reference's gpt_loss split in both packages (``grad_argnums=(0,)``)."""
    jcfg, nparams, idx, tgt, cos, sin = _gpt_inputs(name, n_layer)
    rargs = (jax.tree_util.tree_map(jnp.asarray, nparams), idx, tgt, cos, sin)
    pargs = (ttt.params_from_numpy(nparams, device="cpu"), idx, tgt, cos, sin)
    ref = _ref_split(lambda p, i, t, c, s: jllama.gpt_loss(p, i, t, c, s, jcfg), rargs, (0,))
    port = _port_split(lambda p, i, t, c, s: _PORT_REF_MODEL.gpt_loss(p, i, t, c, s, jcfg),
                       pargs, (0,))
    return ref, port


@pytest.mark.parametrize("name", GPT_CONFIGS)
def test_gpt_loss_value_and_grad_matches_the_reference(name):
    jcfg, nparams, idx, tgt, cos, sin = _gpt_inputs(name)
    rl, rg = tt.value_and_grad(lambda p, i, t, c, s: jllama.gpt_loss(p, i, t, c, s, jcfg))(
        jax.tree_util.tree_map(jnp.asarray, nparams), jnp.asarray(idx), jnp.asarray(tgt),
        jnp.asarray(cos), jnp.asarray(sin))
    cfg = tllama.Config.from_name(name)
    pcos, psin = tllama.build_rope_cache(cfg, T)
    pl, pg = ttt.value_and_grad(lambda p, i, t, c, s: ttt.gpt_loss(p, i, t, c, s, cfg))(
        ttt.params_from_numpy(nparams, device="cpu"), torch.from_numpy(idx),
        torch.from_numpy(tgt).long(), pcos, psin)
    _rel_close(pl, rl, 1e-5)
    rleaves, pleaves = jax.tree_util.tree_leaves(rg), tree_leaves(pg)
    assert len(rleaves) == len(pleaves)
    for p, r in zip(pleaves, rleaves):
        _rel_close(p, r, 1e-4)


def _rematerialized(mod, fw, bw, policy, **kw):
    knobs = POLICY_KNOBS[policy]
    if knobs is None:
        return fw, bw
    return mod.rematerialize_forward_and_backward(fw, bw, max_cone=knobs[0],
                                                  aggressive=knobs[1], **kw)


@pytest.mark.parametrize("name", GPT_CONFIGS)
def test_gpt_loss_split_and_remat_print_the_reference_traces(name):
    (rfw, rbw), (pfw, pbw) = _splits(name)
    _assert_same_programs((pfw, pbw), (rfw, rbw))
    assert premat.saved_bytes(pfw) == rremat.saved_bytes(rfw)
    for policy in POLICY_KNOBS:
        rf, rb = _rematerialized(rremat, rfw, rbw, policy)
        pf, pb = _rematerialized(premat, pfw, pbw, policy, **(
            {} if POLICY_KNOBS[policy] is None else {"reorder": False}))
        _assert_same_programs((pf, pb), (rf, rb))
        assert premat.saved_bytes(pf) == rremat.saved_bytes(rf), policy
        if POLICY_KNOBS[policy] is None:
            continue
        # the port's reorder: the same bound symbols, each after its producers
        _, po = _rematerialized(premat, pfw, pbw, policy)
        assert Counter(map(id, po.bound_symbols)) == Counter(map(id, pb.bound_symbols))
        assert po.args == pb.args
        ready = {p.name for p in po.args}
        for bsym in po.bound_symbols:
            assert all(a.name in ready for a in bsym.flat_proxy_args), bsym.sym.name
            ready.update(o.name for o in bsym.flat_proxy_outs)


@functools.lru_cache(maxsize=None)
def _port_split_of(n_layer):
    return _splits("tiny-llama-debug", n_layer)[1]


def _bw_peak_and_saved(policy, n_layer, reorder):
    fw, bw = _port_split_of(n_layer)
    fw, bw = _rematerialized(premat, fw, bw, policy, reorder=reorder)
    return premat.peak_live_bytes(del_last_used(bw)), premat.saved_bytes(fw)


def test_recompute_placed_at_first_use_bounds_the_backward_peak():
    """Under ``attention`` each layer's recompute lives one layer at a time:
    the backward's peak grows from 2 to 4 layers by no more than the saved
    residuals grow; in the reference's order (every recompute first) it
    grows by each layer's recomputed values too.  Under ``full_block`` the
    reference's cones reach back to the trace inputs at these depths, so
    the backward reruns the whole forward before its first op and the order
    cannot help: its peak equals the reference order's."""
    peak2, saved2 = _bw_peak_and_saved("attention", 2, True)
    peak4, saved4 = _bw_peak_and_saved("attention", 4, True)
    assert peak4 - peak2 <= saved4 - saved2, (peak2, peak4, saved2, saved4)
    ref2, _ = _bw_peak_and_saved("attention", 2, False)
    ref4, _ = _bw_peak_and_saved("attention", 4, False)
    assert ref4 - ref2 > 2 * (saved4 - saved2) and peak4 < ref4
    for n_layer in (2, 4):
        assert _bw_peak_and_saved("full_block", n_layer, True)[0] <= \
            _bw_peak_and_saved("full_block", n_layer, False)[0]


#
# The residual handover
#


def test_saved_residual_dies_inside_the_backward():
    """The backward program empties the list it is handed: a residual the
    forward saved is dead before the program returns."""
    from thunder_tpu_torch.core.proxies import TensorProxy
    from thunder_tpu_torch.extend import OperatorExecutor

    def loss(a, b):
        return plang.sum(plang.tanh(plang.matmul(a, b)))

    a, b = torch.randn(8, 16), torch.randn(16, 4)
    jf = ttt.value_and_grad(loss, argnums=(0, 1), remat=False)
    jf(a, b)
    entry = ttt.compile_stats(jf).interpreter_cache[0]
    bw = ttt.last_backward_traces(jf)[-1]
    fw_ret = [x for x in entry.computation_trace.bound_symbols if x.sym.name == "python_return"]
    saved = fw_ret[0].args[1]
    inputs = {p.name for p in entry.computation_trace.args}
    (slot,) = [i for i, p in enumerate(saved) if p.name not in inputs]   # tanh's output
    seen = {}
    probe_ex = OperatorExecutor("handover_probe")
    probe = probe_ex.register_operator("probe", meta=lambda: None,
                                       fn=lambda: seen.setdefault("alive", ref() is not None))
    probed = ttt.core.trace.from_trace(bw)
    probed.bound_symbols = [*bw.bound_symbols[:-1], probe.bind(output=None), bw.bound_symbols[-1]]
    program = probed.python_callable()
    out, residuals = entry.computation_fn(a, b)
    residuals = list(residuals)
    ref = weakref.ref(residuals[slot])
    assert isinstance(saved[slot], TensorProxy) and ref() is not None
    grads = program(residuals, torch.ones(()))
    assert seen == {"alive": False} and residuals == []
    assert len(grads) == 2
    # the jitted call gives the same grads
    np.testing.assert_array_equal(_np(jf(a, b)[1][0]), _np(grads[0]))


#
# autocast
#


def _autocast_fn(L):
    def f(x, w, v):
        h = L.linear(x, w)
        return L.sum(L.softmax(h, -1) * L.matmul(x, v))
    return f


@pytest.mark.parametrize("target", ["bf16", "fp16"])
def test_autocast_matches_the_reference(target):
    rng = np.random.default_rng(SEED + 3)
    x, w, v = (rng.standard_normal(s).astype(np.float32) for s in ((4, 8), (6, 8), (8, 6)))
    rj = tt.jit(_autocast_fn(rlang), autocast=target, executors=["jax"])
    pj = ttt.jit(_autocast_fn(plang), autocast=target, executors=["torch"])
    rout = rj(*map(jnp.asarray, (x, w, v)))
    pout = pj(*map(_to_port, (x, w, v)))
    assert str(pout.dtype).removeprefix("torch.") == {"bf16": "bfloat16", "fp16": "float16"}[target]
    np.testing.assert_allclose(_np(pout.float()), np.asarray(rout, np.float32), rtol=1e-2,
                               atol=1e-2)
    _assert_same_programs((ttt.last_traces(pj)[-1],), (tt.last_traces(rj)[-1],))
    # the transform alone, over the same acquired program
    pt = pautocast(torch.float16 if target == "fp16" else None)(
        ptrace(_autocast_fn(plang), list(map(_to_port, (x, w, v))), {}).computation_trace)
    rt = rautocast(jnp.float16 if target == "fp16" else None)(
        rtrace(_autocast_fn(rlang), list(map(jnp.asarray, (x, w, v))), {}).computation_trace)
    _assert_same_programs((pt,), (rt,))
    with pytest.raises(RuntimeError, match="unknown autocast target"):
        ttt.jit(_autocast_fn(plang), autocast="int8")
