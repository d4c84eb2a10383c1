"""The port's trace IR against the JAX package's, on the CPU.

``thunder_tpu_torch``'s ``core`` (proxies, symbols, traces, prims, dtypes,
promotion), ``clang``, ``extend``, ``executors.passes``/``torchex`` and
``functional.trace_from_fn`` against their counterparts in ``thunder_tpu``.
Inputs are made with numpy from a seed and handed to both (JAX arrays on the
JAX CPU backend, torch CPU tensors); the dtypes are ones neither side narrows
(no 64-bit types: the reference's x64 mode is off).

- the frontend: small clang functions acquired by both ``trace_from_fn``s
  print the same computation and prologue programs (package and executor
  names normalized) and, claimed, run to equal outputs;
- every prim ``jaxex`` implements: the same meta (shape and dtype) on both
  sides, and the port's value within a stated bound of the reference's;
  random prims by shape, dtype, range and reproducibility only;
- the promotion table against ``jnp.promote_types``;
- the executors' claims on proxies that live on a CUDA device (no card is
  needed to claim);
- ``chip_smoke.ir_layer_loss`` at tiny-llama-debug widths through both
  stacks and against the port's eager layer.
"""
from __future__ import annotations

import collections
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import thunder_tpu.clang as rclang
import thunder_tpu_torch.clang as pclang
from thunder_tpu.core import dtypes as rdtypes
from thunder_tpu.core import prims as rprims
from thunder_tpu.core.devices import Device as RDevice
from thunder_tpu.core.langctxs import Languages as RLanguages
from thunder_tpu.core.proxies import tensorproxy as rtensorproxy
from thunder_tpu.core.trace import TraceCtx as RTraceCtx
from thunder_tpu.core.trace import tracectx as rtracectx
from thunder_tpu.executors import jaxex
from thunder_tpu.executors.passes import transform_for_execution as rtransform
from thunder_tpu.extend import resolve_executors as rresolve
from thunder_tpu.functional import trace_from_fn as rtrace_from_fn
from thunder_tpu_torch.core import dtypes as pdtypes
from thunder_tpu_torch.core import prims as pprims
from thunder_tpu_torch.core import utils as putils
from thunder_tpu_torch.core.devices import Device as PDevice
from thunder_tpu_torch.core.langctxs import Languages as PLanguages
from thunder_tpu_torch.core.proxies import TensorProxy as PTensorProxy
from thunder_tpu_torch.core.proxies import tensorproxy as ptensorproxy
from thunder_tpu_torch.core.trace import TraceCtx as PTraceCtx
from thunder_tpu_torch.core.trace import tracectx as ptracectx
from thunder_tpu_torch.executors import torchex
from thunder_tpu_torch.executors.passes import transform_for_execution as ptransform
from thunder_tpu_torch.extend import resolve_executors as presolve
from thunder_tpu_torch.functional import trace_from_fn as ptrace_from_fn
from torch_port_threads import one_torch_thread  # noqa: F401

SEED = 0
Pair = collections.namedtuple("Pair", ["first", "second"])


def _to_jax(tree):
    return _convert(tree, jnp.asarray)


def _to_torch(tree):
    return _convert(tree, lambda a: torch.from_numpy(np.array(a)))


def _convert(tree, fn):
    if isinstance(tree, np.ndarray):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _convert(v, fn) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_convert(v, fn) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_convert(v, fn) for v in tree)
    return tree


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x)


def _normalize(program: str) -> str:
    """A printed program with package and executor names made neutral and
    the claiming pass's timing comment dropped."""
    program = program.replace("thunder_tpu_torch", "thunder_tpu")
    program = re.sub(r"\b(jax|torch)_(?=[a-z])", "EX_", program)
    return "\n".join(line for line in program.splitlines()
                     if not line.startswith("# Constructed by"))


#
# The frontend: acquisition, printed programs, claiming and codegen
#


def _elementwise(c, x, y, s):
    # broadcasting (y over x's rows), a number argument, a mixed where
    return c.where(c.gt(c.add(x, y), 0.0), c.mul(c.exp(x), s), c.neg(c.sqrt(c.abs(y))))


def _promotion(c, x, i, h):
    # float32 with int32, int32 true division, float16 with float32
    return c.add(c.mul(x, i), c.true_divide(i, 2)), c.add(h, x), c.mul(h, 3)


def _reductions(c, x):
    return (c.sum(x, 1), c.mean(x, 0, True), c.amax(x, -1), c.var(x, 1), c.argmax(x, 1),
            c.cumsum(x, 0))


def _shapes(c, x, y):
    r = c.reshape(x, (4, 3))
    t = c.transpose(x, 0, 1)
    s = c.slice_in_dim(x, 1, 3, dim=1)
    return (c.cat([x, y], 0), c.flatten(c.unsqueeze(t, 0)), c.add(r, 1.0), s,
            c.movedim(c.reshape(x, (3, 2, 2)), 0, 2), c.flip(x, 1))


def _indexing(c, x, idx, idx2):
    return x[1:, ::2], x[0], c.take(x, idx, 0), c.take_along_axis(x, idx2, 1), x[:, -1]


def _numbers(c, x, n, k):
    return c.add(c.mul(x, n), k), c.pow(x, 2)


def _containers(c, d, pair):
    return c.sub(c.mul(d["b"], d["a"]), pair.first), c.add(pair.second, d["n"])


def _frontend_cases():
    rng = np.random.default_rng(SEED)

    def f32(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return {
        "elementwise": (_elementwise, (f32(3, 4), f32(4), 0.5)),
        "promotion": (_promotion, (f32(2, 3), rng.integers(-5, 5, (2, 3)).astype(np.int32),
                                   f32(2, 3).astype(np.float16))),
        "reductions": (_reductions, (f32(3, 4),)),
        "shapes": (_shapes, (f32(3, 4), f32(2, 4))),
        "indexing": (_indexing, (f32(3, 4), np.array([2, 0, 1], np.int32),
                                 rng.integers(0, 4, (3, 2)).astype(np.int32))),
        "numbers": (_numbers, (f32(2, 3), 3, -1.25)),
        "containers": (_containers, ({"b": f32(2, 3), "a": f32(2, 3), "n": 2},
                                     Pair(f32(2, 3), f32(3)))),
    }


FRONTEND = _frontend_cases()


def _acquire(trace_from_fn, clang_mod, lang, fn, args):
    return trace_from_fn(functools.partial(fn, clang_mod), args, {}, language=lang)


@pytest.mark.parametrize("case", sorted(FRONTEND))
def test_frontend_prints_the_reference_programs(case):
    fn, args = FRONTEND[case]
    rargs, pargs = _to_jax(args), _to_torch(args)
    ref = _acquire(rtrace_from_fn, rclang, RLanguages.CLANG, fn, rargs)
    port = _acquire(ptrace_from_fn, pclang, PLanguages.CLANG, fn, pargs)
    assert _normalize(port.computation_trace.python()) == _normalize(ref.computation_trace.python())
    assert _normalize(port.prologue_trace.python()) == _normalize(ref.prologue_trace.python())

    # claimed by the eager executors of each side, the programs print alike
    # too (the port's defaults fuse: cuda ≻ torch is its eager stack)
    rfinal = rtransform(ref.computation_trace, rresolve(["jax"]))
    pfinal = ptransform(port.computation_trace, presolve(["cuda", "torch"]))
    assert _normalize(pfinal.python()) == _normalize(rfinal.python())

    rout = rtransform(ref.computation_trace, rresolve(None)).python_callable()(
        *ref.prologue_trace.python_callable()(*rargs))
    pout = pfinal.python_callable()(*port.prologue_trace.python_callable()(*pargs))
    rflat, pflat = jax.tree_util.tree_leaves(rout), jax.tree_util.tree_leaves(
        pout, is_leaf=lambda x: isinstance(x, torch.Tensor))
    assert len(rflat) == len(pflat)
    for r, p in zip(rflat, pflat):
        assert _np(p).dtype == _np(r).dtype
        # float32 sums and the variance may sum in another order: 1e-6 relative
        np.testing.assert_allclose(_np(p), _np(r), rtol=1e-6, atol=1e-6)


def test_prologue_rejects_changed_inputs():
    fn, args = FRONTEND["numbers"]
    port = _acquire(ptrace_from_fn, pclang, PLanguages.CLANG, fn, _to_torch(args))
    prologue = port.prologue_trace.python_callable()
    x = torch.from_numpy(args[0])
    prologue(x, 3, -1.25)
    for bad, msg in (((x.double(), 3, -1.25), "dtype changed"),
                     ((x[:1], 3, -1.25), "shape changed"),
                     ((x, 4, -1.25), None)):
        with pytest.raises(RuntimeError, match=msg):
            prologue(*bad)


def test_deferred_seams_raise():
    fn, args = FRONTEND["elementwise"]
    pargs = _to_torch(args)

    # the bytecode frontend records the functional frontend's program
    def bound(*a):
        return fn(pclang, *a)

    byte = ptrace_from_fn(bound, pargs, {}, interpretation="bytecode", language=PLanguages.CLANG)
    func = ptrace_from_fn(bound, pargs, {}, language=PLanguages.CLANG)
    assert byte.computation_trace.python() == func.computation_trace.python()
    # the torch language is the default: with no language given the clang
    # function records the same program
    default = ptrace_from_fn(functools.partial(fn, pclang), pargs, {})
    clang_tr = ptrace_from_fn(functools.partial(fn, pclang), pargs, {}, language=PLanguages.CLANG)
    assert default.computation_trace.python() == clang_tr.computation_trace.python()

    # a torch call on proxies diverts into the torch language; an unmapped
    # one raises, naming itself
    def torch_call(c, x, y, s):
        return torch.exp(x)

    traced = ptrace_from_fn(functools.partial(torch_call, pclang), pargs, {},
                            language=PLanguages.CLANG)
    assert "ltorch.exp(" in traced.computation_trace.python()

    def unmapped(c, x, y, s):
        return torch.bucketize(x, y)

    with pytest.raises(NotImplementedError, match="bucketize"):
        ptrace_from_fn(functools.partial(unmapped, pclang), pargs, {},
                       language=PLanguages.CLANG)

    # a concrete tensor inside the trace bakes into a constant proxy (its
    # producer a zero-input TCONST symbol), as the reference's does
    def constant(c, x, y, s):
        return pprims.neg(torch.ones(4))

    const = ptrace_from_fn(functools.partial(constant, pclang), pargs, {},
                           language=PLanguages.CLANG).computation_trace
    names = [b.sym.name for b in const.bound_symbols]
    assert names[0].startswith("TCONST") and "neg" in names
    assert not any(isinstance(a, torch.Tensor) for b in const.bound_symbols for a in b.flat_args)
    # the donation pass runs since executors/donation.py was ported: on the
    # fused program of the elementwise case it analyzes every region
    from thunder_tpu_torch.executors.passes import annotate_donations, del_last_used

    fused = del_last_used(ptransform(default.computation_trace, presolve(None)))
    annotated, report = annotate_donations(fused)
    assert len(report.regions) == sum(b.sym.is_fusion for b in fused.bound_symbols) >= 1
    assert "# donation:" in annotated.python()
    # a future's wait records the dist prims' ``wait`` (ported with them)
    from thunder_tpu_torch.core.proxies import FutureTensorProxy

    ptrace = PTraceCtx()
    with ptracectx(ptrace):
        got = FutureTensorProxy(shape=(2,), device="cpu", dtype=pdtypes.float32).wait()
    assert tuple(got.shape) == (2,) and [b.sym.name for b in ptrace.bound_symbols] == ["wait"]


def test_mutated_container_writes_back():
    """An entry of an input dict replaced inside the traced function is
    written back by the epilogue, on both stacks alike."""

    def bump(c, state, x):
        state["acc"] = c.add(state["acc"], x)
        return c.mul(x, 2.0)

    rng = np.random.default_rng(SEED)
    acc, x = rng.standard_normal(3).astype(np.float32), rng.standard_normal(3).astype(np.float32)
    outs = []
    for trace_from_fn, transform, resolve, clang_mod, lang, conv in (
            (rtrace_from_fn, rtransform, rresolve, rclang, RLanguages.CLANG, _to_jax),
            (ptrace_from_fn, ptransform, presolve, pclang, PLanguages.CLANG, _to_torch)):
        state, xx = {"acc": conv(acc)}, conv(x)
        tr = trace_from_fn(functools.partial(bump, clang_mod), (state, xx), {}, language=lang)
        assert tr.computation_trace._mutations[0][0] == (0, 0, "acc")
        res, new = transform(tr.computation_trace, resolve(None)).python_callable()(
            *tr.prologue_trace.python_callable()(state, xx))
        tr.epilogue_trace.python_callable()((state, xx), {}, *new)
        outs.append((_np(res), _np(state["acc"])))
    np.testing.assert_array_equal(outs[1][0], outs[0][0])
    np.testing.assert_array_equal(outs[1][1], outs[0][1])
    np.testing.assert_array_equal(outs[1][1], acc + x)


def test_pytree_follows_jax_tree_util():
    """The port's pytree flattens as ``jax.tree_util`` does (the order fixes
    the prologue's unpacks and the trace's names) and rebuilds namedtuples."""
    from thunder_tpu_torch.core import pytree

    tree = ({"b": [1, None, (2.5, "s")], "a": Pair(3, {"z": 4, "y": ()})},
            collections.OrderedDict([("q", 5), ("p", 6)]), None, [7])
    leaves, spec = pytree.tree_flatten(tree)
    assert leaves == jax.tree_util.tree_leaves(tree)
    assert pytree.tree_unflatten(leaves, spec) == tree
    assert type(pytree.tree_unflatten(leaves, spec)[0]["a"]) is Pair
    is_pair = lambda x: isinstance(x, Pair)          # noqa: E731
    assert pytree.tree_leaves(tree, is_leaf=is_pair) == jax.tree_util.tree_leaves(
        tree, is_leaf=is_pair)
    assert pytree.tree_structure(tree) == pytree.tree_structure(
        jax.tree_util.tree_map(lambda x: 0, tree))
    doubled = pytree.tree_map(lambda x, y: (x, y), [1, {"k": 2}], [3, {"k": 4}])
    assert doubled == [(1, 3), {"k": (2, 4)}]
    paths = [p for p, _ in pytree.tree_flatten_with_path(tree)[0]]
    assert paths[:3] == [(0, "a", "first"), (0, "a", "second", "z"), (0, "b", 0)]


def test_tree_walks_hold_no_leaf_after_they_return():
    """Flattening and rebuilding leave no reference cycle behind: a leaf
    dies with its last holder, not at the next cyclic collection (a train
    step's gradients, gigabytes on the card, went through these walks)."""
    import gc
    import weakref

    from thunder_tpu_torch._tree import tree_flatten, tree_leaves, tree_map, tree_unflatten

    enabled = gc.isenabled()
    gc.disable()
    try:
        grads = {"w": [torch.ones(3), torch.ones(2)], "b": (torch.zeros(1),)}
        refs = [weakref.ref(x) for x in tree_leaves(grads)]
        leaves, spec = tree_flatten(grads)
        tree_unflatten(spec, leaves)
        tree_map(torch.neg, grads)
        del grads, leaves
        assert [r() for r in refs] == [None] * 3
    finally:
        if enabled:
            gc.enable()


#
# Every prim jaxex implements
#


class DT:
    """A dtype argument, resolved to each package's dtype object."""

    def __init__(self, name):
        self.name = name


class DEV:
    """The CPU device argument, resolved to each package's Device."""


def _resolve(arg, side: str):
    if isinstance(arg, DT):
        return getattr(rdtypes if side == "ref" else pdtypes, arg.name)
    if isinstance(arg, DEV):
        return (RDevice if side == "ref" else PDevice)("cpu")
    if isinstance(arg, list):
        return [_resolve(a, side) for a in arg]
    if isinstance(arg, dict):
        return {k: _resolve(v, side) for k, v in arg.items()}
    return arg


def _rng():
    return np.random.default_rng(SEED)


def _u(*shape, lo=-2.0, hi=2.0, dtype=np.float32):
    return _rng().uniform(lo, hi, shape).astype(dtype)


def _i(*shape, lo=-9, hi=10, dtype=np.int32):
    return _rng().integers(lo, hi, shape).astype(dtype)


def _specials():
    return np.array([[0.5, 1.5, 2.5, -0.5, -2.5, 0.0], [-0.0, np.inf, -np.inf, np.nan, 3.7, -1.2]],
                    np.float32)


# value bounds by family: IEEE-exact operations compare exactly
_TRANSCENDENTAL = dict(rtol=2e-6, atol=1e-6)
_SPECIAL_FN = dict(rtol=1e-4, atol=1e-5)     # erfinv, digamma, lgamma: other series
_SUMS = dict(rtol=1e-5, atol=1e-6)           # float32 sums and products in another order
TOL = {
    **{n: _TRANSCENDENTAL for n in ("acos", "acosh", "asin", "asinh", "atan", "atanh", "cos",
                                    "cosh", "erf", "erfc", "exp", "exp2", "expm1", "log",
                                    "log10", "log1p", "log2", "rsqrt", "sin", "sinh", "tan",
                                    "tanh", "atan2", "pow", "reciprocal", "remainder")},
    **{n: _SPECIAL_FN for n in ("erfinv", "digamma", "lgamma")},
    **{n: _SUMS for n in ("sum", "prod", "var", "var_mean", "cumsum", "cumprod", "matmul",
                          "linear", "einsum", "reduce_window", "resize", "convolution", "sdpa",
                          "sdpa_backward", "cross_entropy_fwd", "fused_linear_ce",
                          "fused_linear_ce_backward", "embedding_backward", "index_add",
                          "scatter_add", "uniform")},
}

_UNARY_DOMAIN = {"acos": (-0.9, 0.9), "asin": (-0.9, 0.9), "atanh": (-0.9, 0.9),
                 "acosh": (1.1, 4.0), "log": (0.1, 4.0), "log10": (0.1, 4.0),
                 "log2": (0.1, 4.0), "log1p": (-0.5, 4.0), "rsqrt": (0.1, 4.0),
                 "sqrt": (0.0, 4.0), "erfinv": (-0.9, 0.9), "digamma": (0.2, 4.0),
                 "lgamma": (0.2, 4.0), "tan": (-1.2, 1.2), "reciprocal": (0.2, 3.0)}


def _samples(pid):
    """``[(label, args, kwargs)]`` of one prim; numpy arrays become tensors."""
    P = rprims.PrimIDs
    name = rprims.prim_lookup[pid].name
    unary = {d[0] for d in rprims._unary_defs}
    if pid in unary:
        if name in ("bitwise_not",):
            return [("int32", (_i(3, 4),), {}), ("bool", (_i(3, 4, lo=0, hi=2).astype(bool),), {})]
        if name in ("ceil", "floor", "round", "trunc", "sign", "abs", "neg"):
            return [("float32", (_specials(),), {}), ("int32", (_i(3, 4),), {})]
        if name in ("isfinite", "isinf", "isnan", "signbit"):
            return [("float32", (_specials(),), {})]
        if name in ("real", "imag"):
            z = (_u(2, 3) + 1j * _u(2, 3, lo=-1)).astype(np.complex64)
            return [("complex64", (z,), {}), ("float32", (_u(2, 3),), {})]
        lo, hi = _UNARY_DOMAIN.get(name, (-2.0, 2.0))
        return [("float32", (_u(3, 4, lo=lo, hi=hi),), {})]
    binary = {d[0] for d in rprims._binary_defs}
    if pid in binary:
        a, b = _u(3, 4), _u(3, 4, lo=0.5, hi=2.0) * np.where(_i(3, 4, lo=0, hi=2) > 0, 1, -1)
        b = b.astype(np.float32)
        ia, ib = _i(3, 4), _i(3, 4, lo=1, hi=5) * np.where(_u(3, 4) > 0, 1, -1).astype(np.int32)
        if name in ("bitwise_and", "bitwise_or", "bitwise_xor"):
            return [("int32", (ia, _i(3, 4, lo=0, hi=100)), {}),
                    ("bool", (ia > 0, ib > 0), {})]
        if name in ("shift_left", "shift_right"):
            return [("int32", (ia, _i(3, 4, lo=0, hi=40)), {}),
                    ("uint8", (_i(3, 4, lo=0, hi=255, dtype=np.uint8),
                               _i(3, 4, lo=0, hi=10, dtype=np.uint8)), {})]
        if name == "pow":
            return [("float32", (np.abs(a) + 0.1, b), {}),
                    ("int32", (_i(3, 4, lo=-3, hi=4), _i(3, 4, lo=0, hi=4)), {})]
        if name in ("atan2", "copysign", "nextafter"):
            return [("float32", (a, b), {})]
        if name in ("maximum", "minimum"):
            return [("float32", (_specials(), _specials()[::-1].copy()), {}),
                    ("int32", (ia, ib), {})]
        if name in ("eq", "ne", "lt", "le", "gt", "ge"):
            return [("float32", (a, np.where(_u(3, 4) > 0, a, b).astype(np.float32)), {}),
                    ("int32", (ia, ib), {})]
        return [("float32", (a, b), {}), ("int32", (ia, ib), {})]
    i0 = _i(4, lo=0, hi=5)
    x34 = _u(3, 4)
    key = np.array([7, 2 ** 31 + 5], np.uint32)
    table = {
        P.WHERE: [("", (x34 > 0, x34, _u(3, 4, lo=5, hi=7)), {})],
        P.CLAMP: [("", (x34, np.full((3, 4), -0.5, np.float32), np.full((3, 4), 1.0, np.float32)),
                   {})],
        P.CONVERT_ELEMENT_TYPE: [("f32->i32", (_specials()[:1, :3] * 3.3, DT("int32")), {}),
                                 ("f32->f16", (x34, DT("float16")), {}),
                                 ("i32->bool", (_i(3, 4), DT("bool8")), {})],
        P.DEVICE_PUT: [("", (x34, DEV()), {})],
        P.ITEM: [("", (np.array([2.5], np.float32),), {})],
        P.COPY_: [("", (x34, _u(3, 4, lo=3, hi=5)), {})],
        P.FULL: [("", ((2, 3), 1.5), dict(device=DEV(), dtype=DT("float32"))),
                 ("int", ((4,), 7), dict(device=DEV(), dtype=DT("int32")))],
        P.IOTA: [("", (5,), dict(start=2, step=3, device=DEV(), dtype=DT("int32"))),
                 ("float", (4,), dict(start=0.5, step=0.25, device=DEV(), dtype=DT("float32")))],
        P.BROADCAST_IN_DIM: [("", (_u(4), (3, 4), (1,)), {}),
                             ("keep-1", (_u(3, 1), (2, 3, 5), (1, 2)), {})],
        P.CAT: [("", ([x34, _u(2, 4)], 0), {})],
        P.FLIP: [("", (x34, (0, 1)), {})],
        P.RESHAPE: [("", (x34, (2, 6)), {})],
        P.SLICE: [("", (_u(5, 6), (1, 0), (5, 6), (2, 3)), {})],
        P.SQUEEZE: [("", (_u(3, 1, 4, 1), (1, 3)), {})],
        P.TRANSPOSE: [("", (_u(2, 3, 4), (2, 0, 1)), {})],
        P.UNFOLD: [("", (_u(2, 7, 3), 1, 3, 2), {})],
        P.PAD: [("", (x34, 0.5, [(1, 2, 0), (0, 1, 1)]), {}),
                ("negative", (_u(5, 6), -1.0, [(-1, 2, 1), (2, -3, 2)]), {}),
                ("int", (_i(4, 3), 9, [(0, 0, 2), (-2, -1, 0)]), {})],
        P.AMAX: [("", (_u(3, 4, 5), (0, 2)), {})],
        P.AMIN: [("", (_u(3, 4, 5), (1,)), {})],
        P.PROD: [("", (_u(3, 4, 5, lo=0.5, hi=1.5), (0, 2)), {})],
        P.SUM: [("", (_u(3, 4, 5), (1, 2)), {}), ("int", (_i(3, 4), (0,)), {})],
        P.VAR: [("", (_u(3, 4, 5), (1, 2)), dict(correction=1.0))],
        P.VAR_MEAN: [("", (_u(3, 4, 5), (0,)), dict(correction=0.0))],
        P.ARGMAX: [("", (_i(3, 6, lo=0, hi=3).astype(np.float32), 1), {}),
                   ("flat", (x34, None), {})],
        P.ARGMIN: [("", (_i(3, 6, lo=0, hi=3).astype(np.float32), 0), {})],
        P.TOPK: [("largest", (_i(3, 6, lo=0, hi=3).astype(np.float32), 4, 1, True, True), {}),
                 ("smallest", (_i(3, 6, lo=0, hi=3).astype(np.float32), 2, 0, False, True), {})],
        P.SORT: [("", (_i(3, 6, lo=0, hi=3).astype(np.float32), 1, False), {}),
                 ("descending", (_i(3, 6, lo=0, hi=3).astype(np.float32), 0, True), {})],
        P.ARGSORT: [("", (_i(3, 6, lo=0, hi=3), 1, True), {})],
        P.CUMSUM: [("", (x34, 1), {})],
        P.CUMPROD: [("", (_u(3, 4, lo=0.5, hi=1.5), 0), {})],
        P.TAKE: [("", (_u(5, 3), np.array([4, -1, 0], np.int32), 0), {}),
                 ("scalar", (_u(5, 3), np.array(2, np.int32), 1), {})],
        P.TAKE_ALONG_AXIS: [("", (x34, _i(3, 2, lo=-4, hi=4), 1), {})],
        P.GATHER: [("", (x34, _i(3, 2, lo=0, hi=4), 1), {})],
        P.INDEX_ADD: [("", (x34, np.array([0, 2, 0], np.int32), _u(3, 3), 1), {})],
        P.INDEX_PUT: [("", (x34, [np.array([0, 2], np.int32), np.array([1, 3], np.int32)],
                            _u(2), False), {}),
                      ("accumulate", (x34, [np.array([1, 1], np.int32)], _u(2, 4), True), {})],
        P.SCATTER_ADD: [("", (x34, _i(2, 4, lo=0, hi=3), _u(2, 4), 0), {})],
        P.MATMUL: [("", (_u(2, 3, 4), _u(4, 5)), {}), ("vec", (_u(4), _u(4, 2)), {})],
        P.LINEAR: [("", (_u(2, 3, 4), _u(5, 4), _u(5)), {}), ("nobias", (x34, _u(2, 4), None), {})],
        P.EMBEDDING: [("", (_i(2, 3, lo=0, hi=6), _u(6, 4)), {})],
        P.EMBEDDING_BACKWARD: [("", (_u(2, 3, 4), _i(2, 3, lo=0, hi=5), 5, 1), {})],
        P.ONE_HOT: [("", (np.array([[0, 3], [-1, 5]], np.int32), 4), {})],
        P.EINSUM: [("", ("bij,bjk->bik", _u(2, 3, 4), _u(2, 4, 5)), {})],
        P.REDUCE_WINDOW: [("max", (_u(2, 6, 7), "max", (2, 3), (2, 2), [(0, 1), (1, 1)]), {}),
                          ("add", (_u(2, 6, 7), "add", (3,), (1,), [(1, 0)]), {})],
        P.RESIZE: [("linear", (_u(2, 4, 5), (2, 7, 3), "linear"), {}),
                   ("cubic", (_u(1, 5, 4), (1, 8, 6), "cubic"), {}),
                   ("nearest", (_u(2, 4, 5), (2, 7, 3), "nearest"), {})],
        P.CONVOLUTION: [("", (_u(2, 4, 7, 6), _u(6, 2, 3, 3), _u(6), (1, 2), (1, 0), (1, 1),
                              False, (0, 0), 2), {})],
        P.SDPA: [("gqa", (_u(1, 4, 8, 16), _u(1, 2, 8, 16), _u(1, 2, 8, 16), None, True, 0.25,
                          None), {}),
                 ("mask", (_u(2, 2, 6, 8), _u(2, 2, 5, 8), _u(2, 2, 5, 8), _u(2, 1, 6, 5), False,
                           0.3), {})],
        P.SDPA_BACKWARD: [],   # from the forward's outputs, below
        P.CROSS_ENTROPY_FWD: [("", (_u(6, 11), _i(6, lo=0, hi=11)), {})],
        P.FUSED_LINEAR_CE: [("", (_u(6, 8), _u(24, 8), np.array([0, 5, -100, 23, 8, 16],
                                                               np.int32)), {})],
        P.FUSED_LINEAR_CE_BACKWARD: [],   # from the forward's lse, below
        P.UNIFORM: [("", ((64, 32), -1.0, 3.0), dict(device=DEV(), dtype=DT("float32"), key=key,
                                                      offset=1))],
        P.RANDN: [("", ((64, 32),), dict(device=DEV(), dtype=DT("float32"), key=key, offset=2))],
        P.RANDINT: [("", ((64, 32), -3, 9), dict(device=DEV(), dtype=DT("int32"), key=key,
                                                 offset=3))],
        P.MULTINOMIAL: [("", (np.array([[0.1, 0.0, 0.9], [0.5, 0.5, 0.0]], np.float32), 6, True),
                         dict(key=key, offset=4))],
    }
    return table[pid]


RANDOM = {"uniform", "randn", "randint", "multinomial"}
# the core prims jaxex implements (the distributed prims, which register
# into the same table when their module is imported, are not ported yet)
JAX_PRIMS = sorted((p for p in jaxex.prim_impls if isinstance(p, rprims.PrimIDs)),
                   key=lambda p: p.name)
PRIM_CASES = [(pid, label, args, kwargs) for pid in JAX_PRIMS
              for label, args, kwargs in _samples(pid)]


def _sdpa_backward_cases():
    out = []
    for label, args, kwargs in _samples(rprims.PrimIDs.SDPA):
        q, k, v, mask, causal, scale = args[:6]
        o, lse = (_np(x) for x in jaxex.prim_impls[rprims.PrimIDs.SDPA](
            *(_to_jax(a) for a in args)))
        g = _u(*q.shape, lo=-1, hi=1)
        out.append((label, (g, q, k, v, o, lse, mask, causal, scale, *args[6:]), kwargs))
    return out


def _flce_backward_cases():
    (label, (h, w, t), kwargs), = _samples(rprims.PrimIDs.FUSED_LINEAR_CE)
    _, lse = jaxex.prim_impls[rprims.PrimIDs.FUSED_LINEAR_CE](*(_to_jax(a) for a in (h, w, t)))
    return [(label, (_u(6, lo=0.1, hi=1.0), h, w, t, _np(lse)), kwargs)]


PRIM_CASES += [(rprims.PrimIDs.SDPA_BACKWARD, *c) for c in _sdpa_backward_cases()]
PRIM_CASES += [(rprims.PrimIDs.FUSED_LINEAR_CE_BACKWARD, *c) for c in _flce_backward_cases()]


def _meta(side, pid, args, kwargs):
    """The prim's meta over proxies of ``args``: ``[(shape, dtype name)]``."""
    prims_mod, trace_cls, ctx, tp = ((rprims, RTraceCtx, rtracectx, rtensorproxy) if side == "ref"
                                     else (pprims, PTraceCtx, ptracectx, ptensorproxy))
    conv = _to_jax if side == "ref" else _to_torch

    def prox(a):
        if isinstance(a, np.ndarray):
            return tp(conv(a))
        if isinstance(a, list):
            return [prox(x) for x in a]
        return a

    with ctx(trace_cls()):
        sym = prims_mod.prim_lookup[getattr(prims_mod.PrimIDs, pid.name)]
        out = sym.meta(*(prox(_resolve(a, side)) for a in args),
                       **{k: prox(_resolve(v, side)) for k, v in kwargs.items()})
    outs = out if isinstance(out, tuple) else (out,)
    return [(tuple(o.shape), str(o.dtype)) if hasattr(o, "shape") else (None, type(o).__name__)
            for o in outs]


def _impl(side, pid, args, kwargs):
    conv = _to_jax if side == "ref" else _to_torch
    impls = jaxex.prim_impls if side == "ref" else torchex.prim_impls
    key = pid if side == "ref" else getattr(pprims.PrimIDs, pid.name)
    out = impls[key](*(conv(_resolve(a, side)) for a in args),
                     **{k: conv(_resolve(v, side)) for k, v in kwargs.items()})
    return out if isinstance(out, tuple) else (out,)


def test_torchex_implements_what_jaxex_does():
    assert {p.name for p in torchex.prim_impls} == {p.name for p in JAX_PRIMS}
    assert [p.name for p in pprims.PrimIDs] == [p.name for p in rprims.PrimIDs]
    assert {pid for pid, *_ in PRIM_CASES} == set(JAX_PRIMS)


@pytest.mark.parametrize("pid,label,args,kwargs", PRIM_CASES,
                         ids=[f"{c[0].name.lower()}-{c[1]}" if c[1] else c[0].name.lower()
                              for c in PRIM_CASES])
def test_prim_matches_the_reference(pid, label, args, kwargs):
    name = rprims.prim_lookup[pid].name
    rmeta, pmeta = _meta("ref", pid, args, kwargs), _meta("port", pid, args, kwargs)
    assert pmeta == rmeta
    pout = _impl("port", pid, args, kwargs)
    for (shape, dt), o in zip(pmeta, pout):
        if shape is None:                      # item: a Python number
            continue
        assert tuple(o.shape) == shape
        assert o.dtype == pdtypes.to_torch_dtype(getattr(pdtypes, dt.rstrip("_")))
    if name in RANDOM:
        again = _impl("port", pid, args, kwargs)
        other = _impl("port", pid, args, {**kwargs, "offset": kwargs["offset"] + 7})
        assert all(torch.equal(a, b) for a, b in zip(pout, again))
        assert not all(torch.equal(a, b) for a, b in zip(pout, other))
        v = pout[0].double()
        if name == "uniform":
            assert bool(((v >= -1.0) & (v < 3.0)).all()) and abs(v.mean().item() - 1.0) < 0.1
        elif name == "randn":
            assert abs(v.mean().item()) < 0.1 and abs(v.std().item() - 1.0) < 0.1
        elif name == "randint":
            assert bool(((v >= -3) & (v < 9)).all()) and len(v.unique()) == 12
        else:                                   # multinomial: zero-probability classes never
            assert not bool((pout[0][0] == 1).any()) and not bool((pout[0][1] == 2).any())
        return
    rout = _impl("ref", pid, args, kwargs)
    assert len(rout) == len(pout)
    for r, p in zip(rout, pout):
        r, p = _np(r), _np(p)
        assert p.dtype == r.dtype
        tol = TOL.get(name)
        if tol is None or not np.issubdtype(r.dtype, np.inexact):
            np.testing.assert_array_equal(p, r)
        else:
            np.testing.assert_allclose(p, r, **tol)


#
# Promotion
#

STRONG = ["bool8", "uint8", "uint16", "uint32", "uint64", "int8", "int16", "int32", "int64",
          "bfloat16", "float16", "float32", "float64", "float8_e4m3", "float8_e5m2",
          "complex64", "complex128"]


@pytest.mark.parametrize("a", STRONG)
def test_promotion_table_is_jax_lattice(a):
    for b in STRONG:
        ra, rb = getattr(rdtypes, a), getattr(rdtypes, b)
        try:
            want = str(rdtypes.from_jax_dtype(jnp.promote_types(rdtypes.to_jax_dtype(ra),
                                                                rdtypes.to_jax_dtype(rb))))
        except Exception:
            want = None
        try:
            got = str(putils._promote_dtypes(getattr(pdtypes, a), getattr(pdtypes, b)))
        except ValueError:
            got = None
        assert got == want, (a, b)


def test_dtypes_and_devices_map_to_torch():
    for name in STRONG:
        d = getattr(pdtypes, name)
        assert pdtypes.from_torch_dtype(pdtypes.to_torch_dtype(d)) is d
    assert pdtypes.to_torch_dtype(pdtypes.float8_e4m3) is torch.float8_e4m3fn
    assert pdtypes.canonicalize_dtype(pdtypes.int64) is pdtypes.int64
    from thunder_tpu_torch.core import devices

    assert devices.to_device(torch.device("cpu")) == devices.cpu
    assert devices.to_torch_device("cuda:1") == torch.device("cuda", 1)
    assert str(devices.Device("cuda:2")) == "cuda:2"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            devices.default_device()


#
# Claiming: proxies on a CUDA device need no card
#


def _claimed(build) -> list[str]:
    """The executed symbols' names of a trace that ``build`` records over
    CUDA proxies, claimed by the default executors."""
    trc = PTraceCtx()
    with ptracectx(trc):
        ins, outs = build()
        pprims.python_return(outs)
    trc.args = ins
    final = ptransform(trc, presolve(None))
    return [b.sym.name for b in final.bound_symbols if b.sym.id != pprims.PrimIDs.RETURN]


def _cuda(shape, dtype=pdtypes.bfloat16):
    return PTensorProxy(shape=shape, device="cuda:0", dtype=dtype)


@pytest.mark.parametrize("T,dtype,want", [(2048, "bfloat16", "cuda"), (256, "float32", "cuda"),
                                          (100, "bfloat16", "torch")])
def test_sdpa_claims(T, dtype, want):
    dt = getattr(pdtypes, dtype)

    def fwd():
        q, k, v = _cuda((1, 32, T, 128), dt), _cuda((1, 8, T, 128), dt), _cuda((1, 8, T, 128), dt)
        return (q, k, v), pprims.sdpa(q, k, v, None, True, 0.088, None)

    def bwd():
        g, q, o = (_cuda((1, 32, T, 128), dt) for _ in range(3))
        k, v = _cuda((1, 8, T, 128), dt), _cuda((1, 8, T, 128), dt)
        lse = _cuda((1, 32, T), pdtypes.float32)
        return (g, q, k, v, o, lse), pprims.sdpa_backward(g, q, k, v, o, lse, None, True, 0.088,
                                                          None)

    assert _claimed(fwd) == [f"{want}_sdpa"]
    assert _claimed(bwd) == [f"{want}_sdpa_backward"]


def test_cross_entropy_is_not_claimed_by_cuda():
    def ce():
        logits, target = _cuda((2048, 128256), pdtypes.float32), _cuda((2048,), pdtypes.int32)
        return (logits, target), pprims.cross_entropy_fwd(logits, target)

    assert _claimed(ce) == ["torch_cross_entropy_fwd"]


def test_cpu_sdpa_stays_with_torch():
    def fwd():
        q = PTensorProxy(shape=(1, 4, 128, 16), device="cpu", dtype=pdtypes.float32)
        return (q,), pprims.sdpa(q, q, q, None, True, 0.25, None)

    assert _claimed(fwd) == ["torch_sdpa"]


@pytest.mark.parametrize("device,counted", [("cpu", 0), ("meta", 1)])
def test_reference_formulas_count_declines_off_the_cpu(device, counted, monkeypatch):
    """torchex's SDPA, its backward and CE run their reference formulas where
    the kernels refuse (here: T=100, and float16 logits). Off the CPU (a
    ``meta`` tensor stands in for the card's) each such call counts one
    decline in ``ltorch.DECLINES``; on the CPU the formula is the intended
    path and counts nothing."""
    from thunder_tpu_torch import ltorch

    for key in ltorch.DECLINES:
        monkeypatch.setitem(ltorch.DECLINES, key, 0)
    q = torch.zeros((1, 4, 100, 16), device=device)
    k = v = torch.zeros((1, 2, 100, 16), device=device)
    out, lse = torchex.prim_impls[pprims.PrimIDs.SDPA](q, k, v, None, True, 0.25, None)
    torchex.prim_impls[pprims.PrimIDs.SDPA_BACKWARD](out, q, k, v, out, lse, None, True, 0.25,
                                                     None)
    logits = torch.zeros((8, 32), dtype=torch.float16, device=device)
    target = torch.zeros((8,), dtype=torch.int32, device=device)
    torchex.prim_impls[pprims.PrimIDs.CROSS_ENTROPY_FWD](logits, target)
    assert ltorch.DECLINES == {"flash_sdpa": counted, "flash_sdpa_backward": counted,
                               "flash_cross_entropy": counted}


#
# The chip phase's layer, at tiny widths
#


def test_ir_layer_loss_through_both_stacks():
    import chip_smoke
    from thunder_tpu_torch.models.llama import Config, build_rope_cache, init_params

    cfg = Config.from_name("tiny-llama-debug", n_layer=1)
    T = 32
    full = init_params(cfg, generator=torch.Generator().manual_seed(SEED), dtype=torch.float32,
                       device="cpu")
    rng = np.random.default_rng(SEED)
    cos, sin = (_np(t) for t in build_rope_cache(cfg, T, device="cpu"))
    params = _convert({"block": full["blocks"][0], "ln_f": full["ln_f"],
                       "lm_head": full["lm_head"]}, _np)
    params = jax.tree_util.tree_map(np.array, params)
    args = (rng.standard_normal((1, T, cfg.n_embd)).astype(np.float32), cos, sin, params,
            rng.integers(0, cfg.vocab_size, T).astype(np.int32))

    results = []
    for trace_from_fn, transform, resolve, clang_mod, prims_mod, lang, conv in (
            (rtrace_from_fn, rtransform, rresolve, rclang, rprims, RLanguages.CLANG, _to_jax),
            (ptrace_from_fn, ptransform, presolve, pclang, pprims, PLanguages.CLANG, _to_torch)):
        a = conv(args)
        tr = trace_from_fn(functools.partial(chip_smoke.ir_layer_loss, clang_mod, prims_mod), a,
                           {}, language=lang)
        final = transform(tr.computation_trace, resolve(None))
        loss, out = final.python_callable()(*tr.prologue_trace.python_callable()(*a))
        results.append((float(_np(loss)), _np(out)))
    targs = _to_torch(args)
    e_loss, e_out = chip_smoke.eager_layer_loss(*targs, cfg)
    (r_loss, r_out), (p_loss, p_out) = results
    for loss, out in ((p_loss, p_out), (r_loss, r_out)):
        assert abs(loss - e_loss.item()) <= 1e-5 * abs(e_loss.item())
        assert np.abs(out - _np(e_out)).max() <= 1e-5 * np.abs(_np(e_out)).max()
    assert abs(p_loss - r_loss) <= 1e-5 * abs(r_loss)
    assert np.abs(p_out - r_out).max() <= 1e-5 * np.abs(r_out).max()
