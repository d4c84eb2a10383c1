"""vmap and jvp: trace→trace batching and forward-mode transforms.

Counterpart of ``thunder_tpu/core/batching.py``.  Instead of a hand-written
rule per prim, every bound symbol is rewritten through one mechanically
derived rule: ``torch.func.vmap``/``torch.func.jvp`` of the prim's torch
executor implementation (``executors/torchex.py``) with the bsym's static
arguments closed over (the reference derives its rules from ``jax.vmap``/
``jax.jvp`` of jaxex's implementation, ``_bound_impl``).  The result is
still a printable, executable trace: each rewritten op is a symbol
registered on the torch executor.

Output metadata comes from the prim's own meta over per-sample proxies (a
vmapped output is the per-sample one with the batch dim in front; a
tangent has its primal's shape and dtype), so one operator serves every
shape and batch size of a (prim, axes, static args) key.

The kernel-backed prims (``SDPA``, ``SDPA_BACKWARD``, ``CROSS_ENTROPY_FWD``)
reach the flash kernels through ctypes on the card, where ``torch.func``
cannot see.  vmap folds the mapped dim into the kernel's batch dim (SDPA,
its backward) or row dim (cross-entropy) and calls the same implementation
on the folded tensors, so the kernel still launches; on the CPU the fold
runs the plain formula, as every prim there does.  jvp of those prims on
CUDA tensors raises: no forward-mode rule of the kernels exists, and the
plain formula is never swapped in on the card.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Sequence

import numpy as _np
import torch

from thunder_tpu_torch.core import dtypes, prims
from thunder_tpu_torch.core.baseutils import check
from thunder_tpu_torch.core.codeutils import SigInfo
from thunder_tpu_torch.core.prims import OpTags, PrimIDs
from thunder_tpu_torch.core.proxies import Proxy, TensorProxy
from thunder_tpu_torch.core.pytree import tree_flatten, tree_unflatten
from thunder_tpu_torch.core.symbol import BoundSymbol
from thunder_tpu_torch.core.trace import TraceCtx, from_trace, tracectx

__all__ = ["vmap", "jvp", "vmap_trace", "jvp_trace"]


_SKIP_IDS = {PrimIDs.DEL, PrimIDs.COMMENT, PrimIDs.PRINT}

# prims whose torch implementation launches a hand-written kernel on CUDA
# tensors (executors/torchex.py)
_KERNEL_IDS = {PrimIDs.SDPA, PrimIDs.SDPA_BACKWARD, PrimIDs.CROSS_ENTROPY_FWD}


def _flatten_prims(bsyms):
    out = []
    for b in bsyms:
        if b.sym.is_prim or not b.subsymbols:
            out.append(b)
        else:
            out.extend(_flatten_prims(b.subsymbols))
    return out


def _is_constant(bsym: BoundSymbol) -> bool:
    """A real tensor baked into the trace (``torch_interop._const_tensor_proxy``):
    no inputs, its value in the call context.  It is neither batched nor
    differentiated, and re-emitted as it is."""
    return bsym.sym.is_fusion and not bsym.args and bool(bsym._call_ctx)


def _static_key(x):
    # one keying implementation shared with the generic VJP cache
    from thunder_tpu_torch.core.transforms import static_arg_key

    return static_arg_key(x)


def _devalue(x):
    from thunder_tpu_torch.core.transforms import devalue_static_arg

    return devalue_static_arg(x, owner="a vmap/jvp rule")


def _bound_impl(bsym: BoundSymbol):
    """Returns (fn(*tensor_vals), tensor_args, tensor_positions, spec, static_sig)
    — the prim's torch impl with the bsym's non-tensor args closed over."""
    from thunder_tpu_torch.executors.torchex import prim_impls

    impl = prim_impls.get(bsym.sym.id)
    if impl is None:
        # executor-registered operators (quantex, ...) carry their fn
        impl = getattr(bsym.sym, "fn", None)
    if impl is None:
        raise NotImplementedError(f"no torch impl for {bsym.sym.name}; cannot derive vmap/jvp rule")

    flat_args, spec = tree_flatten((bsym.args, bsym.kwargs))
    flat_args = [_devalue(x) for x in flat_args]
    tensor_positions = [i for i, x in enumerate(flat_args) if isinstance(x, TensorProxy)]
    tensor_args = [flat_args[i] for i in tensor_positions]
    static_sig = tuple(_static_key(x) for x in flat_args)
    closure = [None if i in set(tensor_positions) else v for i, v in enumerate(flat_args)]

    def fn(*tensor_vals):
        vals = list(closure)
        for pos, v in zip(tensor_positions, tensor_vals):
            vals[pos] = v
        a2, k2 = tree_unflatten(vals, spec)
        return impl(*a2, **k2)

    return fn, tensor_args, tensor_positions, spec, static_sig


def _per_sample_meta(bsym: BoundSymbol, tensor_positions, spec, static_flat):
    """``meta(*per_sample_tensors)`` → the prim's output proxies for one
    sample, from the prim's own meta with the static args closed over."""
    meta = bsym.sym.meta

    def run(*tensors):
        vals = list(static_flat)
        for pos, t in zip(tensor_positions, tensors):
            vals[pos] = t
        a2, k2 = tree_unflatten(vals, spec)
        return meta(*a2, **k2)

    return run


def _proxy_like(p: TensorProxy, shape) -> TensorProxy:
    return TensorProxy(shape=tuple(shape), device=p.device, dtype=p.dtype, requires_grad=False)


_vmap_op_cache: dict = {}
_jvp_op_cache: dict = {}


def _get_executor():
    from thunder_tpu_torch.extend import get_executor

    return get_executor("torch")


def _fold_sdpa(fn, axes, pid):
    """vmap of a kernel-backed attention prim: the mapped dim folds into the
    batch dim of q/k/v (and g/out/lse of the backward), the mask is
    broadcast to it, and the implementation runs once on the folded
    tensors.  Per-sample q is (*lead, H, T, hs); results come back as
    (V, *lead, ...)."""
    backward = pid == PrimIDs.SDPA_BACKWARD
    q_slot = 1 if backward else 0
    mask_slot = 6 if backward else 3

    def folded(*vals):
        V = next(v.shape[0] for v, a in zip(vals, axes) if a == 0)
        q = vals[q_slot]
        lead = tuple(q.shape[1:-3] if axes[q_slot] == 0 else q.shape[:-3])
        n = V * math.prod(lead)
        out = []
        for i, (v, a) in enumerate(zip(vals, axes)):
            sample = tuple(v.shape[1:] if a == 0 else v.shape)
            vb = v if a == 0 else v.unsqueeze(0)
            if i == mask_slot:
                # pad the mask to (*lead, Hm, T, S), broadcast its lead dims
                padded = (1,) * (len(lead) + 3 - len(sample)) + sample
                vb = vb.reshape((vb.shape[0],) + padded)
                vb = vb.expand((V,) + lead + padded[-3:]).reshape((n,) + padded[-3:])
            else:
                core = sample[len(lead):]
                vb = vb.expand((V,) + sample).reshape((n,) + core)
            out.append(vb)
        res = fn(*out)
        flat = res if isinstance(res, tuple) else (res,)
        shaped = tuple(r.reshape((V,) + lead + tuple(r.shape[1:])) for r in flat)
        return shaped if isinstance(res, tuple) else shaped[0]

    return folded


def _fold_ce(fn, axes):
    """vmap of the cross-entropy prim: the mapped dim folds into the row dim
    of the (N, V) logits and the (N,) targets."""

    def folded(logits, target):
        B = logits.shape[0] if axes[0] == 0 else target.shape[0]
        if axes[0] != 0:
            logits = logits.unsqueeze(0).expand((B,) + tuple(logits.shape))
        if axes[1] != 0:
            target = target.unsqueeze(0).expand((B,) + tuple(target.shape))
        N = logits.shape[1]
        res = fn(logits.reshape(B * N, logits.shape[-1]), target.reshape(B * N))
        return tuple(r.reshape(B, N) for r in res) if isinstance(res, tuple) else res.reshape(B, N)

    return folded


def _vmapped_fn(bsym, fn, axes):
    pid = bsym.sym.id
    if pid in (PrimIDs.SDPA, PrimIDs.SDPA_BACKWARD):
        # one axis per tensor slot; an absent mask has no slot
        return _fold_sdpa(fn, axes, pid)
    if pid == PrimIDs.CROSS_ENTROPY_FWD:
        return _fold_ce(fn, axes)
    return torch.func.vmap(fn, in_dims=axes)


def vmap_trace(trace: TraceCtx, batched_in: Sequence[bool], batch_size: int) -> TraceCtx:
    """Rewrites ``trace`` so inputs flagged in ``batched_in`` (aligned with
    ``trace.args``) carry a leading batch dim of ``batch_size``; every op
    touching a batched value is replaced by its vmap-derived operator."""
    check(len(batched_in) == len(trace.args), lambda: "batched_in must align with trace args")

    new_trace = from_trace(trace)
    new_trace.names = set(trace.names)
    env: dict[str, Proxy] = {}
    batched: set[str] = set()

    with tracectx(new_trace):
        new_args = []
        for p, is_b in zip(trace.args, batched_in):
            if isinstance(p, TensorProxy) and is_b:
                np_ = TensorProxy(
                    p.name, shape=(batch_size,) + tuple(p.shape), device=p.device,
                    dtype=p.dtype, requires_grad=p.requires_grad,
                )
                batched.add(p.name)
            else:
                np_ = p
            env[getattr(p, "name", str(id(p)))] = np_
            new_args.append(np_)

        def lookup(x):
            if isinstance(x, Proxy) and x.name in env:
                return env[x.name]
            return x

        for bsym in _flatten_prims(trace.bound_symbols):
            if bsym.sym.id in _SKIP_IDS:
                continue
            if bsym.sym.id == PrimIDs.RETURN:
                from thunder_tpu_torch.core.pytree import tree_map

                new_out = tree_map(lookup, bsym.args[0] if len(bsym.args) == 1 else tuple(bsym.args))
                prims.python_return(new_out)
                continue
            if bsym.sym.tags and OpTags.RANDOM_OP in bsym.sym.tags:
                raise NotImplementedError(
                    "vmap over random ops is not supported yet (key-splitting semantics)"
                )
            if _is_constant(bsym):
                new_trace.record(bsym)
                continue

            fn, tensor_args, tpos, spec, static_sig = _bound_impl(bsym)
            in_tensors = [lookup(t) for t in tensor_args]
            axes = tuple(0 if t.name in batched else None for t in tensor_args)

            flat_outs, _ = tree_flatten(bsym.output)
            if not any(a == 0 for a in axes):
                # untouched by the batch: re-emit the original computation
                flat_in, in_spec = tree_flatten((bsym.args, bsym.kwargs))
                a2, k2 = tree_unflatten([lookup(_devalue(x)) for x in flat_in], in_spec)
                result = bsym.sym(*a2, **k2)
                new_flat, _ = tree_flatten(result)
                for old, new in zip(flat_outs, new_flat):
                    if isinstance(old, Proxy) and isinstance(new, Proxy):
                        env[old.name] = new
                continue

            # shape-polymorphic cache (one op per (prim, axes, static args),
            # not per shape or batch size: a loop over batch sizes must not
            # grow the executor registry)
            key = ("vmap", bsym.sym.id, axes, spec, static_sig)
            op = _vmap_op_cache.get(key)
            if op is None:
                static_flat = [None if isinstance(x, TensorProxy) else _devalue(x)
                               for x in tree_flatten((bsym.args, bsym.kwargs))[0]]
                sample_meta = _per_sample_meta(bsym, tpos, spec, static_flat)

                def meta(*a, _axes=axes, _sample=sample_meta):
                    per = [_proxy_like(t, t.shape[1:]) if ax == 0 else t for t, ax in zip(a, _axes)]
                    B = next(t.shape[0] for t, ax in zip(a, _axes) if ax == 0)
                    out = _sample(*per)
                    res = tuple(_proxy_like(o, (B,) + tuple(o.shape))
                                for o in tree_flatten(out)[0] if isinstance(o, TensorProxy))
                    return res[0] if len(res) == 1 else res

                op = _get_executor().register_operator(
                    f"vmap_{bsym.sym.name}_{len(_vmap_op_cache)}", meta=meta,
                    fn=_vmapped_fn(bsym, fn, axes),
                )
                _vmap_op_cache[key] = op

            result = op(*in_tensors)
            new_flat, _ = tree_flatten(result)
            for old, new in zip(flat_outs, new_flat):
                if isinstance(old, Proxy) and isinstance(new, Proxy):
                    env[old.name] = new
                    if isinstance(new, TensorProxy):
                        batched.add(new.name)
                        batched.add(old.name)

    new_trace.args = tuple(new_args)
    si = SigInfo(name="vmapped", args=[(getattr(p, "name", f"a{i}"), None) for i, p in enumerate(new_args)])
    new_trace.set_siginfo(si)
    new_trace.set_provenance("vmap transform")
    return new_trace


def jvp_trace(trace: TraceCtx, has_tangent: Sequence[bool]) -> TraceCtx:
    """Rewrites ``trace`` into a forward-mode program: signature becomes
    ``(*primals, *tangents_of_flagged)`` and the return becomes
    ``(primal_out, tangent_out)``."""
    check(len(has_tangent) == len(trace.args), lambda: "has_tangent must align with trace args")

    new_trace = from_trace(trace)
    new_trace.names = set(trace.names)
    env: dict[str, Proxy] = {}
    tangents: dict[str, Proxy] = {}

    with tracectx(new_trace):
        new_args = []
        tan_args = []
        for p, flag in zip(trace.args, has_tangent):
            env[getattr(p, "name", str(id(p)))] = p
            new_args.append(p)
            if isinstance(p, TensorProxy) and flag:
                check(
                    dtypes.is_inexact_dtype(p.dtype),
                    lambda: f"jvp tangent for non-float input {p.name}",
                )
                tp = TensorProxy(
                    shape=p.shape, device=p.device, dtype=p.dtype, requires_grad=False
                )
                tangents[p.name] = tp
                tan_args.append(tp)

        def lookup(x):
            if isinstance(x, Proxy) and x.name in env:
                return env[x.name]
            return x

        for bsym in _flatten_prims(trace.bound_symbols):
            if bsym.sym.id in _SKIP_IDS:
                continue
            if bsym.sym.id == PrimIDs.RETURN:
                from thunder_tpu_torch.core.pytree import tree_map

                out = bsym.args[0] if len(bsym.args) == 1 else tuple(bsym.args)
                primal_out = tree_map(lookup, out)

                def tan_lookup(x):
                    if isinstance(x, Proxy):
                        return tangents.get(x.name)
                    return None

                tangent_out = tree_map(tan_lookup, out)
                prims.python_return((primal_out, tangent_out))
                continue
            if bsym.sym.tags and OpTags.RANDOM_OP in bsym.sym.tags:
                raise NotImplementedError(
                    "jvp over random ops is not supported yet (randomness has no tangent)"
                )
            if _is_constant(bsym):
                new_trace.record(bsym)
                continue

            fn, tensor_args, tpos, spec, static_sig = _bound_impl(bsym)
            flat_outs, _ = tree_flatten(bsym.output)
            needs_tangent = [t.name in tangents for t in tensor_args]

            if not any(needs_tangent):
                flat_in, in_spec = tree_flatten((bsym.args, bsym.kwargs))
                a2, k2 = tree_unflatten([lookup(_devalue(x)) for x in flat_in], in_spec)
                result = bsym.sym(*a2, **k2)
                new_flat, _ = tree_flatten(result)
                for old, new in zip(flat_outs, new_flat):
                    if isinstance(old, Proxy) and isinstance(new, Proxy):
                        env[old.name] = new
                continue

            if bsym.sym.id in _KERNEL_IDS and any(t.device.type == "cuda" for t in tensor_args):
                raise NotImplementedError(
                    f"jvp of {bsym.sym.name} on CUDA tensors: its implementation is a "
                    "hand-written kernel with no forward-mode rule, and the plain formula "
                    "does not replace it on the card"
                )

            # differentiable tensor slots: float tensors get real tangents,
            # exact-dtype tensors are non-differentiable constants
            diff = [dtypes.is_inexact_dtype(t.dtype) for t in tensor_args]
            key = ("jvp", bsym.sym.id, tuple(diff), spec, static_sig)
            op = _jvp_op_cache.get(key)
            if op is None:
                def jfn(*vals, _fn=fn, _diff=tuple(diff), _n=len(tensor_args)):
                    pv = list(vals[:_n])
                    tv = list(vals[_n:])

                    def inner(*dvals):
                        it = iter(dvals)
                        full = [next(it) if d else pv[i] for i, d in enumerate(_diff)]
                        return _fn(*full)

                    # a dual tensor may not overlap itself in memory: an
                    # expanded (stride-0) primal or tangent is copied
                    dp = [pv[i].contiguous() for i, d in enumerate(_diff) if d]
                    tv = [t.contiguous() for t in tv]
                    outs, douts = torch.func.jvp(inner, tuple(dp), tuple(tv))
                    if not isinstance(outs, tuple):
                        return outs, douts
                    return tuple(outs) + tuple(douts)

                static_flat = [None if isinstance(x, TensorProxy) else _devalue(x)
                               for x in tree_flatten((bsym.args, bsym.kwargs))[0]]
                sample_meta = _per_sample_meta(bsym, tpos, spec, static_flat)

                def meta(*a, _sample=sample_meta, _n=len(tensor_args)):
                    # (primal outs..., tangent outs...): a tangent has its
                    # primal's shape and dtype
                    outs = [o for o in tree_flatten(_sample(*a[:_n]))[0]
                            if isinstance(o, TensorProxy)]
                    return tuple(_proxy_like(o, o.shape) for o in outs + outs)

                op = _get_executor().register_operator(
                    f"jvp_{bsym.sym.name}_{len(_jvp_op_cache)}", meta=meta, fn=jfn
                )
                _jvp_op_cache[key] = op

            in_primals = [lookup(t) for t in tensor_args]
            in_tangents = []
            for t, d in zip(tensor_args, diff):
                if not d:
                    continue
                tg = tangents.get(t.name)
                if tg is None:
                    # zero tangent for floats that have none
                    tg = clang_zero_like(lookup(t))
                in_tangents.append(tg)

            result = op(*in_primals, *in_tangents)
            new_flat, _ = tree_flatten(result)
            n_out = len(flat_outs)
            prim_outs, tan_outs = new_flat[:n_out], new_flat[n_out:]
            for old, new, tg in zip(flat_outs, prim_outs, tan_outs):
                if isinstance(old, Proxy) and isinstance(new, Proxy):
                    env[old.name] = new
                    if isinstance(tg, Proxy):
                        tangents[new.name] = tg
                        tangents[old.name] = tg

    new_trace.args = tuple(new_args + tan_args)
    si = SigInfo(
        name="jvp_program",
        args=[(getattr(p, "name", f"a{i}"), None) for i, p in enumerate(new_trace.args)],
    )
    new_trace.set_siginfo(si)
    new_trace.set_provenance("jvp transform")
    return new_trace


def clang_zero_like(p: TensorProxy):
    from thunder_tpu_torch import clang

    return clang.full_like(p, 0.0)


#
# User-facing wrappers
#


def _compile_trace(trace: TraceCtx):
    from thunder_tpu_torch.executors.passes import del_last_used, transform_for_execution
    from thunder_tpu_torch.extend import get_default_executors

    ex_trace = transform_for_execution(trace, get_default_executors())
    ex_trace = del_last_used(ex_trace)
    return ex_trace.python_callable()


def _as_torch(x):
    if isinstance(x, _np.ndarray):
        return torch.from_numpy(x)
    return x


def _coerce_leaves(tree):
    """Normalizes a user pytree for the vmap/jvp wrappers: numpy arrays →
    torch tensors; 0-d numpy scalars → python numbers (so they trace as
    number constants, matching the frontend's tensor predicate)."""
    from thunder_tpu_torch.core.pytree import tree_map

    def fix(x):
        if isinstance(x, _np.generic):
            return x.item()
        return _as_torch(x)

    return tree_map(fix, tree)


def vmap(fn: Callable, in_axes: int | Sequence[Any] = 0, out_axes: int = 0, **jit_kwargs) -> Callable:
    """Vectorizing transform over compiled traces (reference
    ``thunder_tpu.vmap``).

    ``in_axes``: 0 or None per positional arg (pytree args share one flag).
    Only leading-axis batching is supported (``out_axes=0``)."""
    check(out_axes == 0, lambda: "vmap: only out_axes=0 is supported")
    from thunder_tpu_torch.functional import _is_tensor_like, trace_from_fn

    cache: dict = {}

    def wrapped(*args):
        args = tuple(_coerce_leaves(a) for a in args)
        axes = in_axes if isinstance(in_axes, (tuple, list)) else (in_axes,) * len(args)
        check(len(axes) == len(args), lambda: "vmap: in_axes length mismatch")
        for a in axes:
            check(a in (0, None), lambda: "vmap: only axis 0 or None is supported")

        # unbatched sample args: first slice of each batched arg
        flat_per_arg = []
        samples = []
        B = None
        for a, ax in zip(args, axes):
            leaves, spec = tree_flatten(a)
            if ax == 0:
                s_leaves = []
                leaf_flags = []
                for leaf in leaves:
                    if hasattr(leaf, "shape") and getattr(leaf, "ndim", 0) > 0:
                        B_l = leaf.shape[0]
                        check(B is None or B == B_l, lambda: "vmap: inconsistent batch sizes")
                        B = B_l
                        s_leaves.append(leaf[0])
                        leaf_flags.append(True)
                    else:
                        # 0-d leaves in a batched pytree broadcast, they have
                        # no axis to map over
                        s_leaves.append(leaf)
                        leaf_flags.append(False)
                samples.append(tree_unflatten(s_leaves, spec))
                flat_per_arg.append(leaf_flags)
            else:
                samples.append(a)
                flat_per_arg.append([False] * len(leaves))
        check(B is not None, lambda: "vmap: no batched input found")

        key = tuple(
            (tuple(getattr(l, "shape", ())), str(getattr(l, "dtype", type(l))),
             str(getattr(l, "device", "")))
            for a in args
            for l in tree_flatten(a)[0]
        ) + (B,)
        entry = cache.get(key)
        if entry is None:
            tr = trace_from_fn(fn, tuple(samples), {})
            comp = tr.computation_trace
            check(
                getattr(comp, "_rng_key_proxy", None) is None,
                lambda: "vmap over random programs is not supported yet",
            )
            check(
                not getattr(comp, "_mutations", None),
                lambda: "vmap over functions that mutate input containers is not supported",
            )
            flat_flags = [f for fl in flat_per_arg for f in fl]
            # align flags with comp.args (tensor proxies in flatten order),
            # with the frontend's tensor predicate
            flat_all, _ = tree_flatten((tuple(samples), {}))
            tensor_flags = [f for f, leaf in zip(flat_flags, flat_all) if _is_tensor_like(leaf)]
            tensor_flags = tensor_flags[: len(comp.args)]
            while len(tensor_flags) < len(comp.args):
                tensor_flags.append(False)
            btrace = vmap_trace(comp, tensor_flags, B)
            entry = _compile_trace(btrace)
            cache[key] = entry

        flat_all, _ = tree_flatten((tuple(args), {}))
        tensors = [_as_torch(l) for l in flat_all if _is_tensor_like(l)]
        return entry(*tensors)

    wrapped.__wrapped__ = fn
    return wrapped


def jvp(fn: Callable, primals: Sequence, tangents: Sequence, **jit_kwargs):
    """Forward-mode AD over a compiled trace (reference ``thunder_tpu.jvp``):
    returns ``(fn(*primals), directional_derivative)``."""
    from thunder_tpu_torch.functional import _is_tensor_like, trace_from_fn

    check(len(primals) == len(tangents), lambda: "jvp: primals/tangents length mismatch")
    primals = tuple(_coerce_leaves(p) for p in primals)
    tangents = tuple(_coerce_leaves(t) if t is not None else None for t in tangents)

    tr = trace_from_fn(fn, primals, {})
    comp = tr.computation_trace
    check(
        getattr(comp, "_rng_key_proxy", None) is None,
        lambda: "jvp over random programs is not supported yet",
    )
    check(
        not getattr(comp, "_mutations", None),
        lambda: "jvp over functions that mutate input containers is not supported",
    )

    flat_p, _ = tree_flatten((primals, {}))
    tensor_leaves = [l for l in flat_p if _is_tensor_like(l)]
    # align tangents with primal tensor leaves.  Pytrees treat None as an
    # empty subtree (a flatten would silently drop it and shift every later
    # tangent onto the wrong primal), so flatten with None kept as a leaf
    flat_t_full, _ = tree_flatten((tuple(tangents), {}), is_leaf=lambda x: x is None)
    tan_leaves = [l for l in flat_t_full if l is None or hasattr(l, "shape") or hasattr(l, "dtype")]
    check(
        len(tan_leaves) == len(tensor_leaves),
        lambda: f"jvp: tangents structure must mirror primals ({len(tan_leaves)} tangent "
        f"leaves vs {len(tensor_leaves)} primal tensor leaves); use None for no-tangent slots",
    )
    tensor_flags = []
    tan_vals = []
    for pl, tl in zip(tensor_leaves, tan_leaves):
        if tl is not None and hasattr(tl, "shape"):
            tensor_flags.append(True)
            tan_vals.append(_as_torch(tl))
        else:
            tensor_flags.append(False)
    tensor_flags = tensor_flags[: len(comp.args)]
    while len(tensor_flags) < len(comp.args):
        tensor_flags.append(False)

    jtrace = jvp_trace(comp, tensor_flags)
    cfn = _compile_trace(jtrace)
    return cfn(*tensor_leaves, *tan_vals)
