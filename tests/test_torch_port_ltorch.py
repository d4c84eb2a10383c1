"""The port's torch language against the JAX package's, on the CPU.

``thunder_tpu_torch.torch`` (the ``ltorch`` surface, registered as the
default language) against ``thunder_tpu.torch``:

- every row of ``tests/opinfos.py``: its numpy samples, built once, go
  through ``tt.jit(info.op)`` (the reference) and through
  ``thunder_tpu_torch.jit(info.torch_ref)``, so the real torch function
  called on proxies reaches the language through ``__torch_function__``
  (rows whose ``torch_ref`` reads a field of torch's named tuples,
  ``.values``, take the port language's symbol of the same name instead).
  Float32 at the row's ``rtol``/``atol``; bf16 at its bf16 bars for the rows
  the Llama forward runs;
- every row's error inputs raise the same exception type in both packages
  (the row's op with the port language's symbols);
- ``F.linear`` → ``F.softmax`` → ``torch.cat`` prints the reference's final
  program, package and executor names normalized;
- ``cross_entropy``'s decomposed cases (class weights, label smoothing with
  and without them, ``(N, C, d1, d2)`` logits, ``ignore_index``, every
  reduction): the reference's ``tt.jit`` against the port's eager
  ``ltorch.cross_entropy`` and ``thunder_tpu_torch.jit`` of
  ``torch.nn.functional.cross_entropy``, float32 within 1e-5; in eager the
  gradient against ``torch.autograd`` of ``F.cross_entropy`` within 1e-5
  of its largest magnitude;
- the language's registration: the default context, every reference
  symbol present, an unmapped torch function raising with its name.
"""
from __future__ import annotations

import re
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import thunder_tpu as tt
import thunder_tpu.torch as rlang
import thunder_tpu_torch as ttt
import thunder_tpu_torch.torch as plang
from opinfos import opinfos
from thunder_tpu.core.symbol import Symbol as RSymbol
from thunder_tpu_torch import ltorch as peager
from thunder_tpu_torch.core import langctxs as plangctxs
from torch_port_threads import one_torch_thread  # noqa: F401

SEED = 0
_BY_NAME = {o.name: o for o in opinfos}

# rows whose torch_ref reads ``.values`` of torch's named tuples; the
# language returns plain tuples, as the reference's does
SYMBOL_ROWS = {"max_dim", "min_dim", "topk", "sort"}
# the rows the Llama forward and loss run (models/llama.py gpt_loss)
LLAMA_ROWS = ("embedding", "type_convert", "mul", "mean", "add", "rsqrt", "linear", "reshape",
              "transpose", "getitem_basic", "neg", "cat", "sdpa_causal", "silu",
              "cross_entropy")


def _port(obj):
    """The same callable over the port language: a reference symbol becomes
    the port's symbol of the same name; a function is rebuilt with the
    module global ``ltorch`` (and any closed-over symbol) swapped."""
    if isinstance(obj, RSymbol):
        return plang._torchsymbols[obj.name]
    if isinstance(obj, types.FunctionType):
        g = dict(obj.__globals__)
        g["ltorch"] = plang
        closure = None
        if obj.__closure__:
            closure = tuple(types.CellType(_port(c.cell_contents)) for c in obj.__closure__)
        return types.FunctionType(obj.__code__, g, obj.__name__, obj.__defaults__, closure)
    return obj


def _to_ref(x, bf16=False):
    if isinstance(x, np.ndarray):
        return jnp.asarray(x, jnp.bfloat16) if bf16 and x.dtype == np.float32 else jnp.asarray(x)
    return x


def _to_port(x, bf16=False):
    if isinstance(x, np.ndarray):
        t = torch.from_numpy(x.copy())
        return t.to(torch.bfloat16) if bf16 and t.dtype == torch.float32 else t
    return x


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == jnp.bfloat16 else x


def _leaves(out):
    if isinstance(out, (tuple, list)):
        return [leaf for o in out for leaf in _leaves(o)]
    return [out]


def _run_row(info, bf16: bool):
    samples = info.sample(np.float32)
    ref = tt.jit(info.op)(*[_to_ref(s, bf16) for s in samples])
    fn = _port(info.op) if info.name in SYMBOL_ROWS else info.torch_ref
    port = ttt.jit(fn)(*[_to_port(s, bf16) for s in samples])
    rl, pl = _leaves(ref), _leaves(port)
    assert len(rl) == len(pl)
    rtol, atol = (info.bf16_rtol, info.bf16_atol) if bf16 else (info.rtol, info.atol)
    for r, p in zip(rl, pl):
        np.testing.assert_allclose(_np(p), _np(r), rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", [o.name for o in opinfos])
def test_row_f32(name):
    _run_row(_BY_NAME[name], bf16=False)


@pytest.mark.parametrize("name", LLAMA_ROWS)
def test_row_bf16(name):
    _run_row(_BY_NAME[name], bf16=True)


def _raised(call):
    try:
        call()
    except Exception as e:  # noqa: BLE001 - the type is the result
        return type(e)
    return None


@pytest.mark.parametrize("name", [o.name for o in opinfos])
def test_row_error_inputs_raise_alike(name):
    info = _BY_NAME[name]
    cases = info.error_inputs()
    assert cases
    for case in cases:
        fn, (args, _exc, _match) = (info.op, case) if len(case) == 3 else (case[0], case[1:])
        ref = _raised(lambda: tt.jit(fn)(*[_to_ref(a) for a in args]))
        port = _raised(lambda: ttt.jit(_port(fn))(*[_to_port(a) for a in args]))
        assert ref is not None and port is ref, (name, ref, port)


def _normalize(program: str) -> str:
    program = program.replace("thunder_tpu_torch", "thunder_tpu")
    program = re.sub(r"\b(jax|torch)_(?=[a-z])", "EX_", program)
    return "\n".join(line for line in program.splitlines()
                     if not line.startswith("# Constructed by"))


def _chain(x, w, b):
    y = F.linear(x, w, b)
    p = F.softmax(y, dim=-1)
    return torch.cat([p, y], dim=0)


def test_linear_softmax_cat_prints_the_reference_program():
    rng = np.random.default_rng(SEED)
    args = [rng.standard_normal(s).astype(np.float32) for s in ((3, 4), (5, 4), (5,))]
    rj = tt.jit(_chain, executors=["jax"])
    pj = ttt.jit(_chain, executors=["torch"])
    rout = rj(*[_to_ref(a) for a in args])
    pout = pj(*[_to_port(a) for a in args])
    np.testing.assert_allclose(_np(pout), _np(rout), rtol=1e-6, atol=1e-6)
    assert _normalize(ttt.last_traces(pj)[-1].python()) == \
        _normalize(tt.last_traces(rj)[-1].python())
    # the acquired program records the language's symbols, as the reference's does
    assert _normalize(ttt.last_traces(pj)[0].python()) == \
        _normalize(tt.last_traces(rj)[0].python())


#
# cross_entropy's decomposed cases
#

N, C = 6, 7
CE_CASES = {
    "weight": dict(weight=True),
    "label_smoothing": dict(label_smoothing=0.1),
    "weight_and_smoothing": dict(weight=True, label_smoothing=0.2),
    "nd_logits": dict(nd=True),
    "nd_logits_weight_smoothing": dict(nd=True, weight=True, label_smoothing=0.1),
}


def _ce_inputs(case):
    rng = np.random.default_rng(SEED)
    shape, tshape = ((N, C, 2, 3), (N, 2, 3)) if case.get("nd") else ((N, C), (N,))
    logits = rng.standard_normal(shape).astype(np.float32)
    target = rng.integers(0, C, tshape).astype(np.int32)
    target.reshape(-1)[[1, 4]] = -1                  # ignored rows
    weight = rng.uniform(0.5, 2.0, (C,)).astype(np.float32) if case.get("weight") else None
    return logits, target, weight


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("case", sorted(CE_CASES))
def test_cross_entropy_decomposed_cases(case, reduction):
    kw = dict(ignore_index=-1, reduction=reduction,
              label_smoothing=CE_CASES[case].get("label_smoothing", 0.0))
    logits, target, weight = _ce_inputs(CE_CASES[case])

    ref = tt.jit(lambda l, t, w: rlang.cross_entropy(l, t, w, **kw))(
        jnp.asarray(logits), jnp.asarray(target), None if weight is None else jnp.asarray(weight))
    pl = torch.from_numpy(logits).requires_grad_(True)
    pt = torch.from_numpy(target).long()
    pw = None if weight is None else torch.from_numpy(weight)
    eager = peager.cross_entropy(pl, pt, pw, **kw)
    jitted = ttt.jit(lambda l, t, w: F.cross_entropy(l, t, w, **kw))(pl.detach(), pt, pw)
    np.testing.assert_allclose(_np(eager), _np(ref), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(jitted), _np(ref), rtol=1e-5, atol=1e-6)

    # the eager decomposition differentiates as torch's own cross_entropy does
    (g,) = torch.autograd.grad(eager.sum(), pl)
    tl = torch.from_numpy(logits).requires_grad_(True)
    (tg,) = torch.autograd.grad(F.cross_entropy(tl, pt, pw, **kw).sum(), tl)
    np.testing.assert_allclose(_np(eager), _np(F.cross_entropy(tl, pt, pw, **kw)),
                               rtol=1e-5, atol=1e-6)
    assert (g - tg).abs().max().item() <= 1e-5 * tg.abs().max().item()


def test_cross_entropy_fast_path_still_takes_the_prim():
    logits, target, _ = _ce_inputs({})
    target = np.where(target < 0, -100, target)
    pt = torch.from_numpy(target).long()
    peager.DECLINES["flash_cross_entropy"] = 0
    out = peager.cross_entropy(torch.from_numpy(logits), pt)
    ref = tt.jit(lambda l, t: rlang.cross_entropy(l, t))(jnp.asarray(logits), jnp.asarray(target))
    np.testing.assert_allclose(_np(out), _np(ref), rtol=1e-6)
    jf = ttt.jit(lambda l, t: F.cross_entropy(l, t))
    jf(torch.from_numpy(logits), pt)
    names = {b.sym.name for b in ttt.last_traces(jf)[-1].bound_symbols}
    assert "torch_cross_entropy_fwd" in names
    assert peager.DECLINES["flash_cross_entropy"] == 0


#
# The language's registration
#


def test_torch_language_is_the_default():
    assert plangctxs.get_langctx() is plangctxs.resolve_language(plangctxs.Languages.TORCH)
    assert plangctxs.get_langctx().name == "torch"
    assert plang.__print_alias__ == "ltorch"


def test_every_reference_symbol_has_a_counterpart():
    assert set(rlang._torchsymbols) <= set(plang._torchsymbols)
    for name in rlang._torch_ctx._methods:
        assert plang._torch_ctx.has_method(name), name
    mapped = {getattr(k, "__qualname__", str(k)) for k in rlang._torch_to_thunder_function_map}
    pmapped = {getattr(k, "__qualname__", str(k)) for k in plang._torch_to_thunder_function_map}
    assert mapped <= pmapped


def test_unmapped_torch_function_raises_and_names_itself():
    with pytest.raises(NotImplementedError, match="bucketize"):
        ttt.jit(lambda x: torch.bucketize(x, x))(torch.ones(3))


def test_torch_dtypes_and_port_dtypes_both_convert():
    def f(x):
        return x.to(torch.bfloat16).float() + x.to(x.dtype).long().to(torch.float32)

    x = torch.linspace(-2, 2, 8)
    np.testing.assert_array_equal(_np(ttt.jit(f)(x)), _np(f(x)))
    out = ttt.jit(lambda x: plang.to(x, plang.bfloat16).type(torch.float16))(x)
    assert out.dtype == torch.float16
    assert torch.equal(out, x.to(torch.bfloat16).to(torch.float16))


def test_factories_need_a_device_off_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        ttt.jit(lambda x: x + plang.ones(3))(torch.ones(3))
    out = ttt.jit(lambda x: x + plang.ones(3, device="cpu"))(torch.ones(3))
    np.testing.assert_array_equal(_np(out), np.full(3, 2.0, np.float32))


def test_manual_seed_reproduces_dropout_masks():
    jf = ttt.jit(lambda x: F.dropout(x, 0.5))
    x = torch.ones(64)
    plang.manual_seed(3)
    a, b = jf(x), jf(x)
    plang.manual_seed(3)
    assert torch.equal(jf(x), a) and not torch.equal(a, b)
    assert set(torch.unique(a).tolist()) <= {0.0, 2.0}
