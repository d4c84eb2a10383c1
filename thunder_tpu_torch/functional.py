"""The functional frontend: eager unpack + trace acquisition.

Counterpart of ``thunder_tpu/functional.py``: ``trace_from_fn`` (acquisition,
the prologue of unpack and check prims, mutation detection, and the
dispatch-cache key emitted next to the prologue) is copied over torch
tensors and numpy arrays.  The traced function runs in the torch language
(``thunder_tpu_torch/torch``) unless ``language=`` names another.  With
``interpretation="bytecode"`` the function runs through the bytecode
interpreter (``core/interpreter.py``, ``core/jit_ext.py``): reads of
globals, closures and the attribute and item chains off them become prologue
guards, and tensors found there extra computation inputs.

The reference is the analog of ``thunder/functional.py`` (eager-unpacking frontend,
``_eager_unpack*``/``_eager_validate*``): inputs are flattened and proxied up
front, the user function runs once over proxies to record the computation
trace, and a prologue trace of unpack+check prims is synthesized from the
flattened structure.  This covers everything except data-dependent Python on
tensor *values*.
"""
from __future__ import annotations

from numbers import Number
from typing import Any, Callable, Sequence

import numpy as np
import torch

from thunder_tpu_torch.core import dtypes, prims
from thunder_tpu_torch.core.baseutils import check
from thunder_tpu_torch.core.codeutils import SigInfo
from thunder_tpu_torch.core.langctxs import Languages, langctx
from thunder_tpu_torch.core.proxies import (
    CollectionProxy,
    NumberProxy,
    Proxy,
    StringProxy,
    TensorProxy,
    numberproxy,
    tensorproxy,
)
from thunder_tpu_torch.core.pytree import tree_flatten, tree_unflatten
from thunder_tpu_torch.core.trace import TraceCtx, TraceResults, TraceTag, tracectx

__all__ = ["trace_from_fn", "proxy_leaf"]


def _is_tensor_like(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray))


def proxy_leaf(x: Any, trace: TraceCtx):
    """Proxies one flattened input leaf for computation tracing."""
    if _is_tensor_like(x):
        return tensorproxy(x)
    from thunder_tpu_torch.core.devices import Device as _Device

    if isinstance(x, _Device):  # Device subclasses str; keep it a static leaf
        return x
    if isinstance(x, str):
        return StringProxy(x)
    if isinstance(x, bool):
        return numberproxy(bool, x)
    if isinstance(x, int):
        return numberproxy(int, x)
    if isinstance(x, float):
        return numberproxy(float, x)
    if isinstance(x, complex):
        return numberproxy(complex, x)
    # static leaves (dtypes, devices, configs, callables, …) pass through
    return x


def _dtype_str(x, proxy=None) -> str:
    # Guard on the proxy's dtype, by its torch name ("float32", "bfloat16");
    # numpy arrays enter unconverted and guard by their numpy name, which is
    # the same string for every dtype numpy has.
    if proxy is not None:
        return str(dtypes.to_torch_dtype(proxy.dtype)).removeprefix("torch.")
    if isinstance(x, np.ndarray):
        return str(np.dtype(x.dtype))
    return str(x.dtype).removeprefix("torch.")


def trace_from_fn(
    fn: Callable,
    args: tuple,
    kwargs: dict,
    *,
    grad_argnums: tuple | None = None,
    interpretation: str | None = None,
    symbolic_numbers: bool = False,
    language=None,
) -> TraceResults:
    """Runs ``fn`` over proxies, returning prologue/computation/epilogue traces.

    ``grad_argnums`` marks the float tensor leaves of those positional args
    with ``requires_grad=True`` so the fw/bw split differentiates them.

    ``interpretation="bytecode"`` runs ``fn`` through the bytecode interpreter
    (the general jit, reference jit_ext.py:1398): globals/closure reads become
    prologue guards and tensors found there become extra computation inputs.
    ``language`` defaults to the torch language.
    """
    from thunder_tpu_torch.core.pytree import tree_map

    import inspect as _inspect

    if _inspect.isgeneratorfunction(fn) or _inspect.iscoroutinefunction(fn):
        raise TypeError(
            f"cannot jit the generator/async function {getattr(fn, '__name__', fn)!r}: "
            "its body would execute lazily, outside the trace; wrap it in a function "
            "that materializes the outputs (e.g. list(gen(...)))"
        )

    flat, spec = tree_flatten((tuple(args), dict(kwargs)))

    # per-leaf differentiability flags, aligned with `flat`
    gset = set(grad_argnums or ())
    flag_args = tuple(tree_map(lambda _, _i=i: _i in gset, a) for i, a in enumerate(args))
    flag_kwargs = tree_map(lambda _: False, dict(kwargs))
    flat_flags, _ = tree_flatten((flag_args, flag_kwargs))

    #
    # Computation trace
    #
    computation_trace = TraceCtx(fn)
    proxies: list = []
    with tracectx(computation_trace):
        for leaf, flagged in zip(flat, flat_flags):
            if flagged and _is_tensor_like(leaf):
                p = tensorproxy(leaf, requires_grad=True)
                if not dtypes.is_inexact_dtype(p.dtype):
                    p = TensorProxy(
                        shape=p.shape, device=p.device, dtype=p.dtype, requires_grad=False
                    )
            elif symbolic_numbers and isinstance(leaf, (int, float)) and not isinstance(leaf, bool):
                # CACHE_OPTIONS.SYMBOLIC_VALUES (reference core/options.py:95):
                # int/float arguments stay SYMBOLIC — value-less NumberProxies
                # that enter the computation as runtime scalar inputs, so one
                # compiled entry serves every value of the same type.  A
                # number that must be concrete at trace time (a shape, a
                # static flag) raises the documented symbolic-values error at
                # its use site.  bools stay static (they steer control flow);
                # shapes are served by bucketing (llama.batch_bucketer).
                p = numberproxy(float if isinstance(leaf, float) else int, None)
            else:
                p = proxy_leaf(leaf, computation_trace)
            proxies.append(p)

    # per-argnum grad reconstruction metadata: (argnum, spec, per-leaf proxy-or-None)
    if gset:
        grad_meta = []
        offset = 0
        for i, a in enumerate(args):
            leaves_i, spec_i = tree_flatten(a)
            n = len(leaves_i)
            if i in gset:
                leaf_proxies = [
                    p if isinstance(p, TensorProxy) and p.requires_grad else None
                    for p in proxies[offset : offset + n]
                ]
                grad_meta.append((i, spec_i, leaf_proxies))
            offset += n
        computation_trace._grad_meta = grad_meta

    # the traced function receives RAW Python numbers/strings for
    # known-value leaves (under CONSTANT_VALUES they fold to literals at
    # every op boundary anyway) so user-code `isinstance(x, int)`/type
    # branches behave exactly as in eager (HF's logits_to_keep et al.); the
    # NumberProxy stays in `proxies` purely to emit the prologue VALUE guard.
    # Symbolic (value-less) scalars keep their proxies.
    comp_leaves = [
        p.value if isinstance(p, (NumberProxy, StringProxy)) and p.value is not None else p
        for p in proxies
    ]
    proxy_args, proxy_kwargs = tree_unflatten(comp_leaves, spec)
    # __setitem__ on an input proxy rebinds the OBJECT to the updated value's
    # name; the computation signature must keep binding the ORIGINAL name
    # (the pre-assignment value the body's early uses reference), so input
    # names are snapshotted here and restored onto same-named copies below
    input_names = [p.name if isinstance(p, TensorProxy) else None for p in proxies]

    from thunder_tpu_torch.observability.events import span as _phase_span

    state_cap = None
    with _phase_span(
        "interpret",
        fn=getattr(fn, "__name__", "fn"),
        frontend="bytecode" if interpretation == "bytecode" else "functional",
    ), tracectx(computation_trace):
        with langctx(language if language is not None else Languages.TORCH):
            if interpretation == "bytecode":
                from thunder_tpu_torch.core.jit_ext import interpret_with_state

                result, state_cap = interpret_with_state(fn, tuple(proxy_args), dict(proxy_kwargs))
                computation_trace._interpreter_log = state_cap.interpreter_log
            else:
                result = fn(*proxy_args, **proxy_kwargs)

        # epilogue: record mutations of the input containers (the reference
        # records setattrs into an epilogue trace, jit_ext.py:1336; here the
        # observable state is the argument pytree — d[key] = new_tensor in
        # the traced fn writes back into the caller's container after the
        # computation runs).  Runs BEFORE the input-name restore below: an
        # in-place ``x[k] = v`` REBINDS the same proxy object (new is old →
        # not a container mutation; the edit is functional), while a
        # container-slot replacement swaps in a different object.
        mutations = _detect_mutations(proxies, spec, proxy_args, proxy_kwargs)

        import copy as _copy

        for i, (p, n) in enumerate(zip(proxies, input_names)):
            if n is not None and isinstance(p, TensorProxy) and p.name != n:
                restored = _copy.copy(p)
                restored._name = n
                proxies[i] = restored
        # one value per DISTINCT proxy (a tensor written to two slots appears
        # once in the return and the epilogue signature)
        mutated_values = list({p.name: p for _, p in mutations}.values())
        if mutations:
            check(
                grad_argnums is None,
                lambda: "input-container mutation (epilogue) is not supported together "
                "with grad yet; return the updated state instead",
            )
            prims.python_return((result, tuple(mutated_values)))
        else:
            prims.python_return(result)
    computation_trace._mutations = mutations

    # computation inputs: tensor proxies (+ symbolic runtime scalars) in
    # flattening order (+ captured state tensors from the bytecode frontend,
    # + implicit rng key)
    comp_inputs: list = [
        p for p in proxies
        if isinstance(p, TensorProxy)
        or (isinstance(p, NumberProxy) and p.value is None)
    ]
    state_tensor_proxies = state_cap.tensor_proxies if state_cap is not None else []
    comp_inputs = comp_inputs + state_tensor_proxies
    rng_key = getattr(computation_trace, "_rng_key_proxy", None)
    uses_rng = rng_key is not None
    if uses_rng:
        comp_inputs = comp_inputs + [rng_key]

    si = SigInfo(name="computation", args=[(p.name, None) for p in comp_inputs])
    computation_trace.set_siginfo(si)
    computation_trace.args = tuple(comp_inputs)

    # tensor-leaf proxy name -> POSITIONAL argnum (kwargs leaves absent):
    # the donation pass's explicit ``donate=argnums`` form resolves user
    # argument positions to computation inputs through this map
    arg_leaf_argnums: dict[str, int] = {}
    offset = 0
    for i, a in enumerate(args):
        leaves_i, _ = tree_flatten(a)
        for p in proxies[offset : offset + len(leaves_i)]:
            if isinstance(p, TensorProxy):
                arg_leaf_argnums[p.name] = i
        offset += len(leaves_i)
    computation_trace._input_argnums = arg_leaf_argnums

    #
    # Prologue trace: unpack every leaf, check it, return computation inputs
    #
    prologue_trace = TraceCtx(fn)
    prologue_trace.tags.add(TraceTag.PROLOGUE)
    with tracectx(prologue_trace):
        args_p = CollectionProxy(args, name="args")
        kwargs_p = CollectionProxy(kwargs, name="kwargs")
        flat_p = CollectionProxy(flat, name="flat")

        bsym = prims.unpack_flatten.bind(args_p, kwargs_p, spec, output=flat_p)
        prologue_trace.record(bsym)

        pro_leaf_proxies: list = []
        for i, (leaf, cproxy) in enumerate(zip(flat, proxies)):
            if isinstance(cproxy, Proxy):
                # mirror the computation proxy's name in the prologue
                leaf_p = (
                    cproxy.replace_name(cproxy.name)
                    if isinstance(cproxy, TensorProxy)
                    else cproxy
                )
                b = prims.unpack_getitem.bind(flat_p, i, output=leaf_p)
                prologue_trace.record(b)
                pro_leaf_proxies.append(leaf_p)
                if isinstance(cproxy, TensorProxy):
                    # guard the *input's* own requires_grad (torch tensors), not
                    # the grad-transform's forced flag on the proxy
                    prims.check_tensor_metadata(
                        leaf_p,
                        tuple(cproxy.shape),
                        cproxy.device.device_str(),
                        _dtype_str(leaf, cproxy),
                        bool(getattr(leaf, "requires_grad", False)),
                    )
                elif isinstance(cproxy, NumberProxy):
                    if cproxy.value is None:  # symbolic: guard the type only
                        prims.check_number_type(leaf_p, cproxy.python_type.__name__)
                    else:
                        prims.check_number_type_and_value(leaf_p, cproxy.value)
                elif isinstance(cproxy, StringProxy):
                    prims.check_string_value(leaf_p, cproxy.value)
            else:
                pro_leaf_proxies.append(None)

        # captured-state unpack chains + guards (bytecode frontend)
        state_out: list[TensorProxy] = []
        if state_cap is not None and (state_cap.guards or state_cap.tensors):
            from thunder_tpu_torch.core.jit_ext import build_state_prologue

            state_out = build_state_prologue(prologue_trace, fn, state_cap, _dtype_str)

        # return the tensors (+ symbolic scalars) the computation consumes,
        # in order
        out_tensors = tuple(
            p for p in pro_leaf_proxies
            if isinstance(p, TensorProxy)
            or (isinstance(p, NumberProxy) and p.value is None)
        ) + tuple(state_out)
        prims.python_return(out_tensors)

    pro_si = SigInfo(name="prologue")
    pro_si.varargs = ("args", None)
    pro_si.varkwargs = ("kwargs", None)
    prologue_trace.set_siginfo(pro_si)

    #
    # Epilogue: write mutated container leaves back into the caller's objects
    # (reference TraceResults epilogue, jit_ext.py:1336-1365)
    #
    epilogue_trace = None
    if mutations:
        epilogue_trace = TraceCtx(None)
        e_args = CollectionProxy(None, name="e_args")
        e_kwargs = CollectionProxy(None, name="e_kwargs")
        with tracectx(epilogue_trace):
            for path, p in mutations:
                b = prims.write_path.bind(e_args, e_kwargs, path, p, output=None)
                epilogue_trace.record(b)
            prims.python_return(None)
        e_si = SigInfo(
            name="epilogue",
            args=[("e_args", None), ("e_kwargs", None)] + [(p.name, None) for p in mutated_values],
        )
        epilogue_trace.set_siginfo(e_si)
        epilogue_trace.args = (e_args, e_kwargs) + tuple(mutated_values)
        epilogue_trace.set_provenance("Epilogue (input-container mutations)")

    #
    # Key emission (next to the prologue): the structural dispatch key for
    # these inputs plus the key function that recomputes it — tier 1 of the
    # two-tier cache.  External state observed by the bytecode frontend can
    # never be keyed (it lives outside the arguments); its summary rides
    # along so the dispatcher knows tier-2 prologue validation is load-bearing
    #
    from thunder_tpu_torch.core.cache_key import compute_cache_key, make_cache_key_fn
    from thunder_tpu_torch.core.jit_ext import state_key_meta

    cache_key_meta = {
        "cache_key": compute_cache_key(args, kwargs, symbolic=symbolic_numbers),
        "cache_key_fn": make_cache_key_fn(symbolic_numbers),
        "state": state_key_meta(state_cap),
    }

    return TraceResults(
        prologue_trace, computation_trace, epilogue_trace, [], cache_key_meta
    )


def _detect_mutations(orig_proxies, spec, proxy_args, proxy_kwargs):
    """Compares the post-trace argument containers against the originally
    unpacked leaves; a replaced TensorProxy leaf is a recorded mutation.
    Returns [(path, new_proxy)], each path of plain keys."""
    from thunder_tpu_torch.core.pytree import tree_flatten_with_path

    new_paths_leaves, new_spec = tree_flatten_with_path((tuple(proxy_args), dict(proxy_kwargs)))
    if new_spec != spec:
        raise NotImplementedError(
            "the traced function changed the *structure* of an input container "
            "(added/removed keys); only replacing existing entries is supported"
        )

    mutations = []
    for (path, new), old in zip(new_paths_leaves, orig_proxies):
        if new is old:
            continue
        if isinstance(old, (NumberProxy, StringProxy)) and not isinstance(new, Proxy):
            # number/string leaves are handed to the traced fn as raw values
            # (see trace_from_fn); an UNCHANGED raw value is not a mutation
            if new == old.value:
                continue
            raise NotImplementedError(
                f"input container entry at {tuple(path)} was "
                f"reassigned from {old.value!r} to {new!r}; number/string state "
                "updates are not written back — return the new value instead"
            )
        if not isinstance(new, TensorProxy):
            raise NotImplementedError(
                f"input container entry at {tuple(path)} was replaced "
                f"by a non-tensor ({type(new).__name__}); only tensor state updates are supported"
            )
        mutations.append((tuple(path), new))
    return mutations
