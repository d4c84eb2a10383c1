"""The port's front-end surfaces against the JAX package's, on the CPU:
``vmap``/``jvp`` (``core/batching.py``), the einops backend
(``einops_support.py``), the numpy language (``numpy/``), eager symbol
evaluation (``core/eager.py``) and ``Pattern``/``match_replace``
(``core/patterns.py``).

Each case of ``tests/test_vmap_jvp.py``, ``tests/test_einops.py`` (all but
the bytecode frontend's, which waits for the interpreter),
``tests/test_numpy_langctx.py`` and ``tests/test_eager.py`` runs through
both packages on the same numpy inputs; results agree in float32 within
1e-5 of the expected output's largest magnitude unless a case says
otherwise (bf16: by the cast's rounding, 5e-2).  The eager cases that run the reference's ltorch under ``jax.jit``
and ``jax.grad`` run the port's under ``torch.func.vmap`` and
``torch.func.grad``.  vmap of the kernel-backed prims (SDPA, its
backward, cross-entropy) folds the mapped dim into the kernel's batch or
row dim; on the CPU the fold runs the plain formula, checked against a
per-sample loop.  ``Pattern`` finds the same groups on the same trace as
the reference's and ``match_replace`` rewrites it into an equal program.
On the card (``cuda``-marked): a vmapped SDPA launches ``flash_fwd``.
"""
from __future__ import annotations

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import thunder_tpu as tt
import thunder_tpu.numpy as rnp
import thunder_tpu.torch as rl
import thunder_tpu_torch as ttt
import thunder_tpu_torch.numpy as pnp
import thunder_tpu_torch.torch as pl
from thunder_tpu_torch.core import batching
from torch_port_threads import one_torch_thread  # noqa: F401

einops = pytest.importorskip("einops")

REL = 1e-5


def _rng(seed):
    return np.random.default_rng(seed)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, dtype=np.float32)


def _close(got, want, rel=REL, atol=0.0):
    """Within ``rel`` of the expected output's largest magnitude (plus ``atol``)."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= rel * float(np.abs(want).max(initial=0.0)) + atol, err


def _t(x):
    return torch.from_numpy(np.asarray(x))


#
# vmap
#

def test_vmap_batched_matmul_unbatched_weight():
    xb = _rng(5).standard_normal((6, 4, 5)).astype(np.float32)
    w = _rng(6).standard_normal((5, 3)).astype(np.float32)
    want = tt.vmap(lambda x, ww: rl.tanh(rl.matmul(x, ww)), in_axes=(0, None))(xb, w)
    got = ttt.vmap(lambda x, ww: pl.tanh(pl.matmul(x, ww)), in_axes=(0, None))(xb, w)
    _close(got, want)


def test_vmap_both_batched():
    a, b = (_rng(s).standard_normal((6, 4)).astype(np.float32) for s in (7, 8))
    _close(ttt.vmap(lambda x, y: pl.sum(x * y))(a, b), tt.vmap(lambda x, y: rl.sum(x * y))(a, b))


def test_vmap_pytree_params():
    params = {"w1": _rng(9).standard_normal((5, 8)).astype(np.float32),
              "w2": _rng(10).standard_normal((8, 3)).astype(np.float32)}
    xb = _rng(11).standard_normal((4, 5)).astype(np.float32)

    def net(L):
        return lambda p, x: L.matmul(L.relu(L.matmul(x, p["w1"])), p["w2"])

    _close(ttt.vmap(net(pl), in_axes=(None, 0))(params, xb),
           tt.vmap(net(rl), in_axes=(None, 0))(params, xb))


def test_vmap_reduction_and_softmax():
    xb = _rng(12).standard_normal((3, 7)).astype(np.float32)
    _close(ttt.vmap(lambda x: pl.softmax(x, -1))(xb), tt.vmap(lambda x: rl.softmax(x, -1))(xb))


def test_vmap_over_model_example():
    """A per-example forward of tiny-llama-debug vmapped over examples: its
    SDPA is folded into the batch dim; against both packages' batched
    forward."""
    from thunder_tpu.models import llama as jllama
    from thunder_tpu_torch.models import llama as pllama

    cfg, pcfg = jllama.Config.from_name("tiny-llama-debug"), pllama.Config.from_name("tiny-llama-debug")
    jp = jllama.init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    pp = ttt.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    T = 16
    idx = _rng(13).integers(0, cfg.vocab_size, (4, T)).astype(np.int32)
    jc, js = jllama.build_rope_cache(cfg, T)
    pc, ps = pllama.build_rope_cache(pcfg, T)

    want = tt.vmap(lambda p, i, c, s: jllama.gpt_forward(p, rl.unsqueeze(i, 0), c, s, cfg)[0],
                   in_axes=(None, 0, None, None))(jp, jnp.asarray(idx), jc, js)
    got = ttt.vmap(lambda p, i, c, s: pllama.gpt_forward(p, pl.unsqueeze(i, 0), c, s, pcfg)[0],
                   in_axes=(None, 0, None, None))(pp, _t(idx), pc, ps)
    batched = pllama.gpt_forward(pp, _t(idx), pc, ps, pcfg)
    _close(got, want, rel=1e-4, atol=1e-4)
    _close(got, batched, rel=1e-4, atol=1e-4)


def test_vmap_scalar_leaf_in_batched_pytree():
    xb = _rng(14).standard_normal((6, 4)).astype(np.float32)
    d = {"x": xb, "scale": np.float32(2.0)}
    _close(ttt.vmap(lambda d: d["x"] * d["scale"])(d), tt.vmap(lambda d: d["x"] * d["scale"])(d))


def test_vmap_dtype_polymorphic_cache():
    a32 = _rng(15).standard_normal((4, 4)).astype(np.float32)
    f = lambda x: pl.mul(x, x)          # noqa: E731
    ttt.vmap(f)(a32)
    out16 = ttt.vmap(f)(torch.from_numpy(a32).to(torch.bfloat16))
    assert out16.dtype == torch.bfloat16
    want16 = tt.vmap(lambda x: rl.mul(x, x))(jnp.asarray(a32).astype(jnp.bfloat16))
    np.testing.assert_allclose(out16.float().numpy(), np.asarray(want16, dtype=np.float32),
                               rtol=5e-2, atol=5e-2)


def test_vmap_random_rejected():
    xb = _rng(16).standard_normal((3, 4)).astype(np.float32)
    with pytest.raises(Exception, match="random"):
        tt.vmap(lambda x: rl.dropout(x, 0.5))(xb)
    with pytest.raises(Exception, match="random"):
        ttt.vmap(lambda x: pl.dropout(x, 0.5))(xb)


@pytest.mark.parametrize("axes", [(0, 0, 0), (0, None, None)], ids=["all", "q only"])
def test_vmap_sdpa_folds_into_the_batch_dim(axes):
    q = _rng(17).standard_normal((3, 2, 4, 16, 8)).astype(np.float32)
    k, v = (_rng(s).standard_normal((3, 2, 2, 16, 8)).astype(np.float32) for s in (18, 19))
    args = (q, k if axes[1] == 0 else k[0], v if axes[2] == 0 else v[0])
    got = ttt.vmap(lambda q, k, v: pl.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                                    enable_gqa=True),
                   in_axes=axes)(*args)
    want = tt.vmap(lambda q, k, v: rl.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                                   enable_gqa=True),
                   in_axes=axes)(*args)
    per = torch.stack([torch.nn.functional.scaled_dot_product_attention(
        _t(q[i]), _t(args[1] if axes[1] is None else args[1][i]),
        _t(args[2] if axes[2] is None else args[2][i]), is_causal=True, enable_gqa=True)
        for i in range(3)])
    _close(got, want)
    _close(got, per, atol=1e-6)
    # the fold is one operator on the torch executor, not torch.func.vmap
    op = next(o for k_, o in batching._vmap_op_cache.items() if k_[1].name == "SDPA")
    assert op.fn.__name__ == "folded"


def test_vmap_cross_entropy_folds_into_the_row_dim():
    logits = _rng(20).standard_normal((3, 5, 11)).astype(np.float32)
    tgt = _rng(21).integers(0, 11, (3, 5)).astype(np.int64)
    f = lambda L: (lambda x, t: L.cross_entropy(x, t, reduction="none"))  # noqa: E731
    got = ttt.vmap(f(pl))(logits, tgt)
    want = tt.vmap(f(rl))(logits, tgt)
    per = torch.stack([torch.nn.functional.cross_entropy(_t(logits[i]), _t(tgt[i]), reduction="none")
                       for i in range(3)])
    _close(got, want)
    _close(got, per)


def test_vmap_and_jvp_carry_baked_constants():
    """A real tensor met in the traced function is a baked constant: vmap
    broadcasts it, jvp gives it no tangent."""
    xb = _rng(22).standard_normal((3, 4)).astype(np.float32)
    got = ttt.vmap(lambda x: x * torch.arange(4.0))(xb)
    _close(got, xb * np.arange(4.0, dtype=np.float32))
    y, dy = ttt.jvp(lambda x: pl.sum(x * torch.arange(4.0)), (xb[0],), (np.ones(4, np.float32),))
    _close(y, (xb[0] * np.arange(4.0)).sum())
    _close(dy, np.float32(6.0))


#
# jvp
#

def test_jvp_scalar_out():
    x, dx = (_rng(s).standard_normal((4, 5)).astype(np.float32) for s in (22, 23))
    y, dy = ttt.jvp(lambda a: pl.sum(pl.sin(a) * a), (x,), (dx,))
    jy, jdy = tt.jvp(lambda a: rl.sum(rl.sin(a) * a), (x,), (dx,))
    _close(y, jy)
    _close(dy, jdy, rel=1e-4)


def test_jvp_tensor_out():
    x, dx = (_rng(s).standard_normal((4, 5)).astype(np.float32) for s in (24, 25))
    y, dy = ttt.jvp(lambda a: pl.tanh(a), (x,), (dx,))
    jy, jdy = tt.jvp(lambda a: rl.tanh(a), (x,), (dx,))
    _close(y, jy)
    _close(dy, jdy)


def test_jvp_partial_tangents():
    x, dx = (_rng(s).standard_normal((4, 5)).astype(np.float32) for s in (26, 27))
    w = _rng(28).standard_normal((5, 3)).astype(np.float32)
    y, dy = ttt.jvp(lambda a, ww: pl.sum(pl.matmul(a, ww)), (x, w), (dx, None))
    jy, jdy = tt.jvp(lambda a, ww: rl.sum(rl.matmul(a, ww)), (x, w), (dx, None))
    _close(y, jy)
    _close(dy, jdy)


def test_jvp_leading_none_tangent_alignment():
    x, w, dw = (_rng(s).standard_normal((4, 4)).astype(np.float32) for s in (29, 30, 31))
    y, dy = ttt.jvp(lambda a, b: pl.sum(pl.matmul(a, b)), (x, w), (None, dw))
    jy, jdy = tt.jvp(lambda a, b: rl.sum(rl.matmul(a, b)), (x, w), (None, dw))
    _close(y, jy)
    _close(dy, jdy, rel=1e-4)


def test_jvp_composite_network():
    x, dx = (_rng(s).standard_normal((2, 6)).astype(np.float32) for s in (32, 33))
    w, dw = (_rng(s).standard_normal((4, 6)).astype(np.float32) for s in (34, 35))

    def f(L, **kw):
        return lambda a, ww: L.mse_loss(L.gelu(L.linear(a, ww)), L.zeros(2, 4, dtype=L.float32, **kw))

    y, dy = ttt.jvp(f(pl, device="cpu"), (x, w), (dx, dw))
    jy, jdy = tt.jvp(f(rl), (x, w), (dx, dw))
    _close(y, jy)
    _close(dy, jdy, rel=1e-4)


def test_jvp_of_sdpa_on_the_cpu_runs_the_plain_formula():
    q, k, v, dq = (_rng(s).standard_normal((1, 2, 8, 4)).astype(np.float32) for s in (36, 37, 38, 39))
    f = lambda L: (lambda q, k, v: L.sum(L.scaled_dot_product_attention(q, k, v, is_causal=True)))  # noqa: E731
    y, dy = ttt.jvp(f(pl), (q, k, v), (dq, None, None))
    jy, jdy = tt.jvp(f(rl), (q, k, v), (dq, None, None))
    _close(y, jy)
    _close(dy, jdy, rel=1e-4)


#
# einops
#

_REARRANGE_CASES = [
    ((2, 3, 4, 5), "b c h w -> b (c h w)", {}),
    ((2, 3, 4), "h w c -> w h c", {}),
    ((2, 3, 4, 5), "b h w c -> (b h) w c", {}),
    ((2, 3, 4, 5), "b h w c -> h (b w) c", {}),
    ((2, 3, 4, 5), "b h w c -> (b h w c)", {}),
    ((2, 12, 4), "b (h c) w -> b h c w", {"c": 3}),
    ((12, 2, 3), "(b1 b2) h w -> b1 b2 h w", {"b1": 4}),
    ((2, 3, 4), "a b c -> c b a", {}),
]


@pytest.mark.parametrize("shape,expr,kw", _REARRANGE_CASES, ids=[c[1] for c in _REARRANGE_CASES])
def test_einops_rearrange(shape, expr, kw):
    x = _rng(40).standard_normal(shape).astype(np.float32)
    got = ttt.jit(lambda a: einops.rearrange(a, expr, **kw))(_t(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(tt.jit(lambda a: einops.rearrange(a, expr, **kw))(x)))
    np.testing.assert_array_equal(got.numpy(), einops.rearrange(x, expr, **kw))


_REDUCE_CASES = [
    ("b c h w -> b c", "mean", {}),
    ("b c h w -> b c", "max", {}),
    ("b c h w -> b c", "min", {}),
    ("b c h w -> b", "sum", {}),
    ("b c h w -> b c h w", "prod", {}),
    ("b c (h h2) w -> b c h w", "mean", {"h2": 2}),
]


@pytest.mark.parametrize("expr,op,kw", _REDUCE_CASES, ids=[f"{c[1]}:{c[0]}" for c in _REDUCE_CASES])
def test_einops_reduce(expr, op, kw):
    x = _rng(41).standard_normal((2, 3, 4, 5)).astype(np.float32)
    got = ttt.jit(lambda a: einops.reduce(a, expr, op, **kw))(_t(x))
    _close(got, tt.jit(lambda a: einops.reduce(a, expr, op, **kw))(x), atol=1e-6)
    _close(got, einops.reduce(x, expr, op, **kw), atol=1e-6)


_REPEAT_CASES = [
    ("h w -> h w k", {"k": 3}),
    ("h w -> (h k) w", {"k": 2}),
    ("h w -> h (w k)", {"k": 4}),
    ("h w -> k h w", {"k": 2}),
]


@pytest.mark.parametrize("expr,kw", _REPEAT_CASES, ids=[c[0] for c in _REPEAT_CASES])
def test_einops_repeat(expr, kw):
    x = _rng(42).standard_normal((3, 4)).astype(np.float32)
    got = ttt.jit(lambda a: einops.repeat(a, expr, **kw))(_t(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(tt.jit(lambda a: einops.repeat(a, expr, **kw))(x)))


def test_einops_einsum():
    a = _rng(43).standard_normal((3, 4)).astype(np.float32)
    b = _rng(44).standard_normal((4, 5)).astype(np.float32)
    f = lambda a, b: einops.einsum(a, b, "i j, j k -> i k")  # noqa: E731
    _close(ttt.jit(f)(_t(a), _t(b)), tt.jit(f)(a, b), atol=1e-6)


def test_grad_through_einops():
    x = _rng(45).standard_normal((2, 3, 4)).astype(np.float32)

    def loss(L):
        def f(a):
            y = einops.rearrange(a, "b h w -> b (h w)")
            m = einops.reduce(a, "b h w -> b", "sum")
            return L.sum(y * y) + L.sum(m)

        return f

    _close(ttt.grad(loss(pl))(_t(x)), tt.grad(loss(rl))(x))
    _close(ttt.grad(loss(pl))(_t(x)), 2 * x + 1)


def test_einops_pack_unpack():
    a = _rng(46).standard_normal((3, 4)).astype(np.float32)
    b = _rng(47).standard_normal((3, 5)).astype(np.float32)

    def f(L):
        def g(a, b):
            packed, ps = einops.pack([a, b], "i *")
            x, y = einops.unpack(packed, ps, "i *")
            return L.sum(packed) + L.sum(x - a) + L.sum(y - b)

        return g

    _close(ttt.jit(f(pl))(_t(a), _t(b)), tt.jit(f(rl))(a, b))


def test_einops_backend_is_the_ports():
    from thunder_tpu_torch.core.proxies import TensorProxy
    from thunder_tpu_torch.einops_support import ThunderTpuBackend

    seen = []

    def f(a):
        backend = einops._backends.get_backend(a)
        seen.append((type(backend), isinstance(a, TensorProxy), backend.is_appropriate_type(a)))
        return a * 1

    ttt.jit(f)(torch.ones(2))
    assert seen == [(ThunderTpuBackend, True, True)]
    assert ThunderTpuBackend.framework_name == "thunder_tpu_torch"


#
# The numpy language
#

def test_numpy_ufunc_diversion():
    a, b = (_rng(s).standard_normal((4, 5)).astype(np.float32) for s in (50, 51))
    f = lambda x, y: np.add(np.multiply(x, y), np.exp(x))  # noqa: E731
    _close(ttt.jit(f)(_t(a), _t(b)), tt.jit(f)(a, b))


def test_numpy_array_function_diversion():
    a = _rng(52).standard_normal((4, 6)).astype(np.float32)
    f = lambda x: np.sum(np.reshape(x, (2, 12)), axis=1)  # noqa: E731
    _close(ttt.jit(f)(_t(a)), tt.jit(f)(a))


def test_numpy_matmul_and_where():
    a = _rng(53).standard_normal((4, 5)).astype(np.float32)
    b = _rng(54).standard_normal((5, 3)).astype(np.float32)

    def f(x, y):
        h = np.matmul(x, y)
        return np.where(np.greater(h, 0), h, 0.1 * h)

    _close(ttt.jit(f)(_t(a), _t(b)), tt.jit(f)(a, b))


def test_numpy_surface_direct():
    a = _rng(55).standard_normal((3, 4)).astype(np.float32)
    _close(ttt.jit(lambda x: pnp.mean(pnp.multiply(x, x), axis=1))(_t(a)),
           tt.jit(lambda x: rnp.mean(rnp.multiply(x, x), axis=1))(a))


def test_grad_through_numpy_surface():
    a = _rng(56).standard_normal((3, 4)).astype(np.float32)
    pv, pg = ttt.value_and_grad(lambda x: pnp.sum(pnp.multiply(pnp.sin(x), x)))(_t(a))
    rv, rg = tt.value_and_grad(lambda x: rnp.sum(rnp.multiply(rnp.sin(x), x)))(a)
    _close(pv, rv)
    _close(pg, rg)


def test_langctx_numpy_dispatch():
    a = _rng(57).standard_normal((3, 4)).astype(np.float32)

    def f(L):
        return lambda x: L.sqrt(L.abs(x)) + x.size

    _close(ttt.jit(f(pnp), langctx="numpy")(_t(a)), tt.jit(f(rnp), langctx="numpy")(a))
    with pytest.raises(LookupError, match="Unknown language context"):
        ttt.jit(f(pnp), langctx="not-a-language")


def test_numpy_unmapped_function_raises():
    with pytest.raises(NotImplementedError, match="numpy function"):
        ttt.jit(lambda x: np.fft.fft(x))(torch.ones(4))


#
# Eager evaluation
#

def test_eager_elementwise_and_linear():
    x = _rng(60).standard_normal((4, 8)).astype(np.float32)
    w = _rng(61).standard_normal((16, 8)).astype(np.float32)
    out = pl.linear(_t(x), _t(w))
    assert isinstance(out, torch.Tensor)
    _close(out, rl.linear(jnp.asarray(x), jnp.asarray(w)))
    _close(pl.gelu(_t(x)), rl.gelu(jnp.asarray(x)), atol=1e-6)


def test_eager_composite_softmax():
    x = _rng(62).standard_normal((3, 5)).astype(np.float32)
    _close(pl.softmax(_t(x), dim=-1), rl.softmax(jnp.asarray(x), dim=-1), atol=1e-6)


def test_eager_inside_torch_func_vmap():
    """ltorch calls on the tensors of a torch.func transform (the reference
    runs them under jax.jit)."""
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    b = np.full((2, 3), 2.0, np.float32)
    want = jax.jit(lambda a, b: rl.mul(rl.sin(a), b) + 1.0)(a, b)
    got = torch.func.vmap(lambda a, b: pl.mul(pl.sin(a), b) + 1.0)(_t(a), _t(b))
    _close(got, want)


def test_eager_grad_through_torch_func():
    x = np.asarray([0.3, -0.7, 1.1], np.float32)
    want = jax.grad(lambda x: jnp.sum(rl.tanh(x) ** 2))(jnp.asarray(x))
    got = torch.func.grad(lambda x: torch.sum(pl.tanh(x) ** 2))(_t(x))
    _close(got, want)


#
# Pattern / match_replace
#

def _prim_trace(pkg, f, args):
    if pkg == "port":
        from thunder_tpu_torch.core import transforms as T
        from thunder_tpu_torch.functional import trace_from_fn

        args = tuple(_t(a) for a in args)
    else:
        from thunder_tpu.core import transforms as T
        from thunder_tpu.functional import trace_from_fn
    tr = trace_from_fn(f, args, {}).computation_trace
    tr.bound_symbols = T.flatten_to_prims(tr.bound_symbols)
    return tr


def _mul_add_pattern(pkg, capture_add=False):
    if pkg == "port":
        from thunder_tpu_torch.core.patterns import Pattern
        from thunder_tpu_torch.core.prims import PrimIDs
    else:
        from thunder_tpu.core.patterns import Pattern
        from thunder_tpu.core.prims import PrimIDs
    p = Pattern()
    p.match(lambda bsym, ctx: (bsym.sym.id == PrimIDs.MUL, {"mul": bsym}))
    p.match(lambda bsym, ctx: (
        bsym.sym.id == PrimIDs.ADD
        and any(a.name in {o.name for o in ctx["mul"].flat_proxy_outs} for a in bsym.flat_proxy_args),
        {"add": bsym} if capture_add else {}))
    return p


def _groups(tr, matches):
    index = {id(b): i for i, b in enumerate(tr.bound_symbols)}
    return [([index[id(b)] for b in bsyms], [b.sym.name for b in bsyms], sorted(ctx))
            for bsyms, ctx in matches]


@pytest.mark.parametrize("case", ["mul_add", "two_chains", "across_dependency"])
def test_pattern_groups_equal_the_reference(case):
    fns = {
        "mul_add": (lambda a, b, c: a * b + c, 3),
        "two_chains": (lambda a, b, c: (a * b + c) * (b * c + a), 3),
        "across_dependency": (lambda a: (a * a).sum() + 1.0, 1),
    }
    f, n = fns[case]
    args = tuple(_rng(70 + i).standard_normal((4,)).astype(np.float32) for i in range(n))
    groups = {}
    for pkg in ("port", "ref"):
        tr = _prim_trace(pkg, f, args)
        groups[pkg] = _groups(tr, _mul_add_pattern(pkg)(tr))
    assert groups["port"] == groups["ref"]
    if case == "across_dependency":
        assert groups["port"] == []


def test_match_replace_rewrites_like_the_reference():
    from thunder_tpu import clang as rclang
    from thunder_tpu.core.patterns import match_replace as rmatch
    from thunder_tpu_torch import clang as pclang
    from thunder_tpu_torch.core.patterns import match_replace as pmatch
    from thunder_tpu_torch.executors.utils import eval_bsyms

    args = tuple(_rng(80 + i).standard_normal((4,)).astype(np.float32) for i in range(3))
    f = lambda a, b, c: a * b + c  # noqa: E731

    def builder(clang):
        def fma(ctx, mul_bsym, add_bsym):
            x, y = mul_bsym.args[0], mul_bsym.args[1]
            mul_out = {o.name for o in mul_bsym.flat_proxy_outs}
            other = next(x2 for x2 in add_bsym.flat_proxy_args if x2.name not in mul_out)
            return clang.add(clang.mul(clang.add(x, 0.0), y), other)

        return fma

    ptr, rtr = _prim_trace("port", f, args), _prim_trace("ref", f, args)
    pnew = pmatch(ptr, _mul_add_pattern("port", True), builder(pclang))
    rnew = rmatch(rtr, _mul_add_pattern("ref", True), builder(rclang))

    def norm(src):
        src = src.replace("thunder_tpu_torch", "thunder_tpu")
        return "\n".join(line for line in src.splitlines() if not line.startswith("# Constructed"))

    assert "Pattern rewrite" in pnew.python()
    assert norm(re.sub(r"\s+#.*", "", pnew.python())) == norm(re.sub(r"\s+#.*", "", rnew.python()))
    env = {p.name: _t(a) for p, a in zip(pnew.args, args)}
    eval_bsyms([b for b in pnew.bound_symbols if b.sym.name != "python_return"], env)
    out = next(b for b in pnew.bound_symbols if b.sym.name == "python_return").args[0]
    _close(env[out.name], args[0] * args[1] + args[2], atol=1e-6)


#
# On the card
#

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the flash kernels run on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_vmapped_sdpa_launches_flash_fwd(card):
    from thunder_tpu_torch import ltorch
    from thunder_tpu_torch.executors import cudaex

    g = torch.Generator(device=card).manual_seed(0)
    q = torch.randn(3, 1, 4, 256, 64, generator=g, device=card, dtype=torch.bfloat16)
    k, v = (torch.randn(3, 1, 2, 256, 64, generator=g, device=card, dtype=torch.bfloat16)
            for _ in range(2))
    for key in ltorch.DECLINES:
        ltorch.DECLINES[key] = 0
    f = ttt.vmap(lambda q, k, v: pl.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                                 enable_gqa=True))
    cudaex.reset_launches()
    got = f(q, k, v)
    torch.cuda.synchronize()
    assert cudaex.LAUNCHES["flash_fwd"] == 1
    assert not any(ltorch.DECLINES.values())
    want = torch.stack([cudaex.flash_sdpa(q[i], k[i], v[i], None, causal=True, scale=64 ** -0.5)[0]
                        for i in range(3)])
    assert torch.equal(got, want)
    with pytest.raises(NotImplementedError, match="jvp of sdpa"):
        ttt.jvp(lambda q: pl.sum(pl.scaled_dot_product_attention(q, k[0], v[0], is_causal=True,
                                                                 enable_gqa=True)),
                (q[0],), (q[0],))
