"""The general jit: bytecode interpretation + provenance-driven prologues.

Counterpart of ``thunder_tpu/core/jit_ext.py``, copied over this package's
``core``: a tensor is what ``functional._is_tensor_like`` says (a
``torch.Tensor``, ``nn.Parameter`` and CUDA tensors included, or a numpy
array), and the framework state that is never guarded is this package's
(``_internal_root``).  That file is itself a capability analog of
Lightning Thunder's ``thunder/core/jit_ext.py`` (
``thunder_general_jit`` :1398 — configures the interpreter to proxy tensors
on first touch and to build prologue unpack/check chains from provenance).
The shape of the idea:

- the interpreter (``core/interpreter.py``) runs the user's bytecode and
  reports every read rooted in *function state* — globals, closure cells,
  and attr/item chains hanging off them;
- tensors found there are proxied on first touch and become **extra
  computation inputs**, re-fetched by the prologue through the same access
  path (``unpack_getitem``/``unpack_attr`` chains);
- plain-value reads (hyperparameters, flags, shapes) become **guards**:
  the prologue re-reads them and ``check``s equality, so mutating a global
  triggers a retrace instead of stale results — the CONSTANT_VALUES caching
  contract extended beyond explicit arguments.
"""
from __future__ import annotations

import sys
import types

from typing import Any, Callable

from thunder_tpu_torch.core import prims
from thunder_tpu_torch.core.interpreter import ProvenanceRecord, interpret
from thunder_tpu_torch.core.proxies import CollectionProxy, Proxy, TensorProxy, tensorproxy

__all__ = ["interpret_with_state", "StateCapture", "build_state_prologue", "state_key_meta"]


def _is_tensor_like(x) -> bool:
    # one predicate shared with the functional frontend (deferred import to
    # avoid a cycle: functional imports this module for the bytecode path)
    from thunder_tpu_torch.functional import _is_tensor_like as _itl

    return _itl(x)


_GUARDABLE = (int, float, bool, str, bytes, type(None))


def _guardable(v) -> bool:
    if isinstance(v, _GUARDABLE):
        return True
    # tuples only, NOT lists: a whole-list value guard would alias mutable
    # scratch containers that traced code writes mid-call (HF's
    # out_cls_cell = [None] pattern), baking post-mutation contents.  List
    # state still guards at the right granularity — elements via the
    # subscript chain, lengths via check_len (PseudoInst.LEN).  Nested
    # tuples allowed (dict-key tuples inside a KEYS guard value).
    if type(v) is tuple and all(isinstance(e, _GUARDABLE) or _guardable(e) for e in v):
        return True
    # small all-primitive dicts guard as literal-likes (match-statement
    # subjects: a failed `case {"k": _}` must retrace when the dict changes)
    # EXACT types only: a dict/tuple subclass (HF config, namedtuple) may
    # carry custom semantics, and its baked literal repr would reconstruct
    # the plain builtin anyway — subclass instances guard per-element
    if (
        type(v) is dict
        and len(v) <= 16
        and all(isinstance(k, _GUARDABLE) and isinstance(e, _GUARDABLE) for k, e in v.items())
    ):
        return True
    return False


class StateCapture:
    """What the interpreter observed outside the explicit arguments."""

    def __init__(self):
        # path -> (value,) guards to re-check in the prologue
        self.guards: dict[tuple, Any] = {}
        # path -> (concrete value, proxy) extra tensor inputs
        self.tensors: dict[tuple, tuple[Any, TensorProxy]] = {}
        # the interpreter's per-opcode run log (ctx.log) for introspection
        self.interpreter_log: list = []

    @property
    def tensor_proxies(self) -> list[TensorProxy]:
        return [p for _, p in self.tensors.values()]


def state_key_meta(cap: StateCapture | None) -> dict | None:
    """Summary of captured external state for the dispatch cache's key
    metadata.  Guards and captured tensors are rooted OUTSIDE the call
    arguments (globals, closures, live module dicts), so the structural key
    cannot cover them — entries carrying any are exactly why a key hit still
    runs the prologue once (tier-2 validation).  Returned alongside the key
    emission so introspection can see what keeps an entry guard-dependent."""
    if cap is None or (not cap.guards and not cap.tensors):
        return None
    return {
        "n_guards": len(cap.guards),
        "n_state_tensors": len(cap.tensors),
        "guard_roots": tuple(sorted(
            {p[0][0] for p in cap.guards} | {p[0][0] for p in cap.tensors}
        )),
    }


class _LiveModuleGlobals:
    """Prologue-time resolver for helper-module globals: ``['pkg.mod']`` →
    that module's LIVE ``__dict__`` via sys.modules, so guards re-read
    current values on every call (a snapshot would freeze them)."""

    def __getitem__(self, modname: str) -> dict:
        mod = sys.modules.get(modname)
        if mod is None:
            raise KeyError(modname)
        return mod.__dict__


class _LiveModules:
    """Like _LiveModuleGlobals but yields the module OBJECT — MODULE-rooted
    paths (in-function imports) take attr steps through real getattr, so
    PEP 562 module-level __getattr__ keeps working."""

    def __getitem__(self, modname: str):
        mod = sys.modules.get(modname)
        if mod is None:
            raise KeyError(modname)
        return mod


def _is_internal_module(name) -> bool:
    return isinstance(name, str) and (
        name == "thunder_tpu_torch" or name.startswith("thunder_tpu_torch.")
    )


def _internal_root(fn: Callable, path: tuple) -> bool:
    """True when the access chain is rooted at a thunder_tpu_torch-internal global
    (e.g. ``ThunderTracingMode._patch_depth`` read inside the torch-interop
    wrapper): framework tracing state is not program state — guarding it
    would pin trace-time-only values and fail every post-trace prologue.

    A global of a function of this package is internal, and so is a class or
    function of this package read from the user's globals.  An *instance* of
    one of its classes there (a model ``Config``) is the user's state and is
    guarded: the reference tests the instance's class module, so a config
    global is never guarded there and rebinding it replays the old program."""
    if not path:
        return False
    if path[0][0] in ("gmod", "gmodule"):
        return _is_internal_module(path[0][1])
    if path[0][0] != "globals":
        return False
    if _is_internal_module(getattr(fn, "__module__", None)):
        return True
    try:
        base = fn.__globals__.get(path[0][1])
    except Exception:
        return False
    return isinstance(base, (type, types.FunctionType)) and _is_internal_module(base.__module__)


def interpret_with_state(fn: Callable, proxy_args: tuple, proxy_kwargs: dict):
    """Runs ``fn`` through the bytecode interpreter (under an active trace
    context) and returns ``(result, StateCapture)``."""
    cap = StateCapture()

    def read_cb(record: ProvenanceRecord, value):
        path = record.path()
        if path is None:
            return value
        if path in cap.tensors:
            return cap.tensors[path][1]
        if _internal_root(fn, path):
            return value
        if _is_tensor_like(value):
            p = tensorproxy(value)
            cap.tensors[path] = (value, p)
            return p
        if _guardable(value) and path not in cap.guards:
            cap.guards[path] = value
        return value

    # executor-registered lookasides (register_operator(replaces=...),
    # reference extend/__init__.py:31-124) divert direct Python calls inside
    # interpreted code to the executor's symbol
    from thunder_tpu_torch.core.compile_data import get_compile_data

    lookasides: dict = {}
    cd = get_compile_data()
    if cd is not None:
        for ex in getattr(cd, "executors_list", None) or ():
            la = getattr(ex, "_lookasides", None)
            if la:
                for target, repl in la.items():
                    # first executor wins, matching the claiming pass's
                    # priority order (executors/passes.py)
                    lookasides.setdefault(target, repl)

    result, _ctx = interpret(
        fn, *proxy_args, read_callback=read_cb, lookasides=lookasides, **proxy_kwargs
    )
    cap.interpreter_log = _ctx.log

    # drop read guards superseded by trace-time WRITES to the same external
    # location: the written value is produced by the program, not an input —
    # keeping the pre-write guard would fail the fresh prologue immediately
    # (e.g. the counter-increment pattern COUNTER[0] = COUNTER[0] + 1)
    if _ctx.writes and cap.guards:
        _refresh_tainted_guards(fn, cap, _ctx.writes)
    return result, cap


_PSEUDO_GUARD_STEPS = frozenset({
    "len", "keys", "type_name", "absent_item", "absent_attr", "present_item",
    "present_attr", "absent_member", "present_member",
})


def _resolve_steps(fn, steps):
    """Re-reads the CURRENT value at an access path (the Python mirror of
    the prologue's unpack chain).  Returns (found, value)."""
    kind, key = steps[0]
    try:
        if kind == "globals":
            obj = fn.__globals__[key]
        elif kind == "closure":
            cells = dict(zip(fn.__code__.co_freevars, fn.__closure__ or ()))
            obj = cells[key].cell_contents
        elif kind == "gmod":
            obj = sys.modules[key].__dict__
        elif kind == "gmodule":
            obj = sys.modules[key]
        elif kind == "gdict":
            obj = fn.__globals__
        else:
            return False, None
        for kind, key in steps[1:]:
            obj = getattr(obj, key) if kind == "attr" else obj[key]
        return True, obj
    except Exception:
        return False, None


def _refresh_tainted_guards(fn, cap, writes) -> None:
    """Trace-time writes into tracked containers changed state AFTER the
    guards were captured, so the captured values would fail their own
    prologue.  Every guard under a written container is RE-EVALUATED against
    the post-trace state: value guards update to the current value (keeping
    sensitivity to LATER external mutations), population/membership guards
    recompute, and anything no longer readable (or whose observation
    flipped) is dropped."""
    bases = set()
    for base_rec, _kind, _key in writes:
        base = base_rec.path()
        if base is not None:
            bases.add(base)
    if not bases:
        return
    for path in list(cap.guards):
        if not any(path[: len(b)] == b for b in bases):
            continue
        step = path[-1][0]
        if step in _PSEUDO_GUARD_STEPS:
            found, container = _resolve_steps(fn, path[:-1])
            if not found:
                del cap.guards[path]
                continue
            try:
                if step == "len":
                    cap.guards[path] = len(container)
                elif step == "keys":
                    cap.guards[path] = tuple(container.keys())
                elif step == "type_name":
                    cap.guards[path] = (
                        f"{type(container).__module__}.{type(container).__qualname__}")
                else:
                    key = path[-1][1]
                    if step.endswith("_attr"):
                        present = hasattr(container, key)
                    else:
                        present = key in container
                    if present != step.startswith("present"):
                        del cap.guards[path]  # observation flipped
            except Exception:
                del cap.guards[path]
            continue
        found, value = _resolve_steps(fn, path)
        if found and _guardable(value):
            cap.guards[path] = value
        else:
            del cap.guards[path]


def build_state_prologue(prologue_trace, fn: Callable, cap: StateCapture, dtype_str_fn) -> list[TensorProxy]:
    """Emits unpack chains + guards for captured state into the (active)
    prologue trace.  Returns the extra tensor proxies, in capture order.

    Must run inside ``tracectx(prologue_trace)``.
    """
    if not cap.guards and not cap.tensors:
        return []

    closure = {}
    if fn.__closure__:
        closure = dict(zip(fn.__code__.co_freevars, fn.__closure__))
    state = {"globals": fn.__globals__, "closure": closure,
             "gmod": _LiveModuleGlobals(), "gmodule": _LiveModules()}

    root = CollectionProxy(None, name="fn_state")
    b = prims.unpack_trivial.bind(root, name="fn_state", output=root, _call_ctx={"fn_state": state})
    prologue_trace.record(b)

    # chain-unpack cache: partial path -> proxy
    unpacked: dict[tuple, Proxy] = {}

    def root_coll(kind: str) -> Proxy:
        key = ("__root__", kind)
        coll = unpacked.get(key)
        if coll is None:
            coll = CollectionProxy(None, name=f"fn_{kind}")
            prologue_trace.record(prims.unpack_getitem.bind(root, kind, output=coll))
            unpacked[key] = coll
        return coll

    def unpack(path: tuple, out_proxy: Proxy | None = None) -> Proxy:
        """Emits the unpack chain for ``path``; ``out_proxy`` names the final
        step's output (tensor leaves reuse the computation proxy's name so the
        prologue's returned tensors line up with the computation signature)."""
        if out_proxy is None and path in unpacked:
            return unpacked[path]
        kind, key = path[-1]
        if kind == "gdict":
            # globals() root: the path's collection IS the globals dict
            out = root_coll("globals")
            if out_proxy is None:
                unpacked[path] = out
            return out
        if kind in ("globals", "closure", "gmod", "gmodule"):
            coll = root_coll(kind)
            if kind == "closure":
                cell = CollectionProxy(None)
                prologue_trace.record(prims.unpack_getitem.bind(coll, key, output=cell))
                out = out_proxy if out_proxy is not None else CollectionProxy(None)
                prologue_trace.record(prims.unpack_attr.bind(cell, "cell_contents", output=out))
            else:
                out = out_proxy if out_proxy is not None else CollectionProxy(None)
                prologue_trace.record(prims.unpack_getitem.bind(coll, key, output=out))
        else:
            base = unpack(path[:-1])
            out = out_proxy if out_proxy is not None else CollectionProxy(None)
            prim = prims.unpack_attr if kind == "attr" else prims.unpack_getitem
            prologue_trace.record(prim.bind(base, key, output=out))
        if out_proxy is None:
            unpacked[path] = out
        return out

    # steps the prologue will already unpack THROUGH: unpack_attr/getitem
    # raising there (→ retrace) covers the member vanishing, so a present_*
    # membership guard on the same step is redundant noise
    _PSEUDO_STEPS = (
        "len", "absent_item", "absent_attr", "present_item", "present_attr",
        "absent_member", "present_member", "keys", "type_name",
    )
    unpack_covered: set[tuple] = set()
    for p in list(cap.guards) + list(cap.tensors):
        real = p[:-1] if p[-1][0] in _PSEUDO_STEPS else p
        for i in range(1, len(real) + 1):
            unpack_covered.add(real[:i])

    for path, value in cap.guards.items():
        if path[-1][0] == "len":
            # length guard: re-read the CONTAINER and check len() — the
            # container itself is not value-guarded (see _guardable)
            prims.check_len(unpack(path[:-1]), value)
            continue
        if path[-1][0] == "keys":
            # dict-iteration guard: key set AND order must be unchanged
            # (iteration unrolled over the observed keys)
            prims.check_keys(unpack(path[:-1]), value)
            continue
        if path[-1][0] == "type_name":
            # isinstance() observation: the object's class is baked into
            # the traced branch
            prims.check_type_name(unpack(path[:-1]), value)
            continue
        if path[-1][0] in _PSEUDO_STEPS and path[-1][0] != "len":
            # membership guard: the traced program baked a branch on
            # key/attr/value presence (dict.get / getattr-default / hasattr /
            # `in`, or a read whose value cannot be value-guarded) — re-read
            # the container and check membership is UNCHANGED, so inserting
            # (or removing) the key/attr retraces
            step, key = path[-1]
            kind = "attr" if step.endswith("_attr") else "item"
            present = step.startswith("present")
            # subsumption (an unpack through the same step already raises →
            # retraces when the member vanishes) applies only where the
            # membership namespace IS the getitem namespace: dict keys and
            # attrs.  Sequence `in` (*_member) tests VALUES, not indices —
            # an unpack through lst[v] proves nothing about `v in lst`.
            if present and not step.endswith("_member") and path[:-1] + ((kind, key),) in unpack_covered:
                continue
            prims.check_contains(unpack(path[:-1]), key, kind, present)
            continue
        leaf = unpack(path)
        if isinstance(value, str):
            prims.check_string_value(leaf, value)
        elif isinstance(value, (dict, tuple)):
            prims.check_literal_like(leaf, value)
        else:
            prims.check_number_type_and_value(leaf, value)

    extra: list[TensorProxy] = []
    for path, (value, proxy) in cap.tensors.items():
        leaf_p = unpack(path, out_proxy=proxy.replace_name(proxy.name))
        prims.check_tensor_metadata(
            leaf_p,
            tuple(proxy.shape),
            proxy.device.device_str(),
            dtype_str_fn(value, proxy),
            bool(getattr(value, "requires_grad", False)),
        )
        extra.append(leaf_p)
    return extra
