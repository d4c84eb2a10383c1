"""Executor utilities: regions and trace evaluation over concrete values.

Counterpart of ``thunder_tpu/executors/utils.py``, copied; ``resolve_impl``
reads ``torchex``'s prim table where the reference reads ``jaxex``'s.
``Region`` is the analog of the reference's ``thunder/executors/utils.py:29``;
``eval_bsyms`` re-executes a list of bound symbols over concrete tensors
(the analog of the reference's ``eval_trace``).
"""
from __future__ import annotations

from numbers import Number
from typing import Any, Callable, Sequence

from thunder_tpu_torch.core.proxies import AnyProxy, NumberProxy, Proxy, StringProxy, TensorProxy, variableify
from thunder_tpu_torch.core.pytree import tree_flatten, tree_unflatten
from thunder_tpu_torch.core.symbol import BoundSymbol
from thunder_tpu_torch.core.utils import OrderedSet, consumers, producers

__all__ = ["Region", "eval_bsyms", "resolve_impl", "resolve_args", "trace_return_names"]


def trace_return_names(trace) -> set[str]:
    """Names of every proxy the trace returns — the buffers that must outlive
    the program.  Shared by ``del_last_used`` (they are never deleted) and
    the donation pass (they are never donated)."""
    from thunder_tpu_torch.core.prims import PrimIDs

    out: set[str] = set()
    for bsym in trace.bound_symbols:
        if bsym.sym.id == PrimIDs.RETURN:
            for p in bsym.flat_proxy_args:
                out.add(p.name)
    return out


class Region:
    """Computes the proxy inputs and outputs of a group of bound symbols."""

    def __init__(self, producers_map, consumers_map, bsyms: Sequence[BoundSymbol]):
        self.bsyms = list(bsyms)

        produced: OrderedSet = OrderedSet()
        consumed: OrderedSet = OrderedSet()

        def visit(bsym: BoundSymbol) -> None:
            # walk the WHOLE composite tree: a proxy consumed only by a
            # subsymbol (e.g. the implicit rng_key inside dropout's uniform)
            # is still a region input — evaluation descends into subsymbols,
            # so the top-level arg list alone under-reports consumption
            for out in bsym.flat_proxy_outs:
                produced.add(variableify(out))
            for arg in bsym.flat_proxy_args:
                consumed.add(variableify(arg))
            for sub in bsym.subsymbols:
                visit(sub)

        for bsym in self.bsyms:
            visit(bsym)

        self.inputs = OrderedSet(v for v in consumed if v not in produced)

        # outputs: produced proxies consumed by bsyms outside the region
        in_region = set(id(b) for b in self.bsyms)
        outputs: OrderedSet = OrderedSet()
        for bsym in self.bsyms:
            for out in bsym.flat_proxy_outs:
                v = variableify(out)
                cons = consumers_map.get(out, ())
                for c in cons:
                    if id(c) not in in_region:
                        outputs.add(v)
                        break
        self.outputs = outputs


def resolve_impl(bsym: BoundSymbol) -> Callable | None:
    """Finds a concrete callable for a bound symbol."""
    if bsym.sym.fn is not None:
        return bsym.sym.fn
    from thunder_tpu_torch.executors.torchex import prim_impls

    fn = prim_impls.get(bsym.sym.id)
    if fn is not None:
        return fn
    if bsym.sym.python_impl is not None:
        return bsym.sym.python_impl
    return None


def resolve_args(env: dict[str, Any], args, kwargs):
    """Substitutes proxies with concrete values from ``env``."""

    def sub(x):
        if isinstance(x, (NumberProxy, StringProxy, AnyProxy)):
            if x.value is not None:
                return x.value
            # unknown at trace time (e.g. an item() result): runtime value
            if x.name in env:
                return env[x.name]
            raise RuntimeError(f"Number proxy {x.name} has no static or runtime value")
        if isinstance(x, Proxy):
            if x.name not in env:
                raise RuntimeError(f"Proxy {x.name} has no value during evaluation")
            return env[x.name]
        return x

    flat, spec = tree_flatten((tuple(args), dict(kwargs)))
    flat = [sub(x) for x in flat]
    return tree_unflatten(flat, spec)


def bind_outputs(env: dict[str, Any], output, result) -> None:
    flat_out, _ = tree_flatten(output)
    proxies = [o for o in flat_out if isinstance(o, Proxy)]
    if len(proxies) == 0:
        return
    if len(proxies) == 1 and not isinstance(result, (tuple, list)):
        env[proxies[0].name] = result
        return
    flat_res, _ = tree_flatten(result)
    vals = []
    ri = 0
    for o in flat_out:
        if isinstance(o, Proxy):
            env[o.name] = flat_res[ri]
        ri += 1


def eval_bsyms(bsyms: Sequence[BoundSymbol], env: dict[str, Any]) -> None:
    """Executes bound symbols over concrete values, updating ``env`` in place.

    Composites without a concrete implementation are evaluated through their
    subsymbols, so any trace level is executable.
    """
    from thunder_tpu_torch.core.prims import PrimIDs

    for bsym in bsyms:
        if bsym.sym.id in (PrimIDs.DEL, PrimIDs.RETURN, PrimIDs.COMMENT):
            continue
        fn = resolve_impl(bsym)
        if fn is None:
            if bsym.subsymbols:
                eval_bsyms(bsym.subsymbols, env)
                continue
            raise RuntimeError(f"No implementation found for {bsym.sym.name} ({bsym.sym.id})")
        args, kwargs = resolve_args(env, bsym.args, bsym.kwargs)
        result = fn(*args, **kwargs)
        bind_outputs(env, bsym.output, result)
