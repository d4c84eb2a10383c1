"""A CPython bytecode interpreter with provenance tracking.

Counterpart of ``thunder_tpu/core/interpreter.py``, copied: only the deferred
imports (which name this package's ``core`` modules), the package named in
``_OPAQUE_TOP_PACKAGES`` and one error message's advice change.  That file
is itself a capability analog of Lightning Thunder's
``thunder/core/interpreter.py`` (a full
Python-in-Python interpreter with ``WrappedValue``/``ProvenanceRecord``
provenance, :131/:910, entry ``interpret`` :6595).  This is the acquisition
engine behind the general jit: running the user's *bytecode* (instead of
calling their function) lets the tracer observe where every value came from —
globals, closure cells, attribute and item chains — so the prologue can
re-validate exactly those reads as cache guards and unpack tensors found
outside the explicit arguments.

Scope (deliberate, documented): the common Python subset model code uses —
arithmetic, containers, control flow, comprehensions, nested function calls,
closures, imports, try/except/finally (full 3.12 exception-table dispatch),
``with`` blocks (incl. exception suppression), generators (suspendable
interpreted frames with send/throw/close, ``yield from``, genexprs, PEP-479),
and async (``async def``/``await``/``async for``/``async with``, natively
interpreted as suspendable coroutine frames — see TestAsync).
Targets CPython 3.12 bytecode.
"""
from __future__ import annotations

import builtins as _builtins
import collections.abc as _abc
import dis
import inspect
import operator
import sys
import types
import weakref
from dataclasses import dataclass, field
from enum import Enum, auto
from typing import Any, Callable

__all__ = [
    "interpret",
    "InterpreterError",
    "ProvenanceRecord",
    "PseudoInst",
    "InterpreterCompileCtx",
]


class InterpreterError(RuntimeError):
    pass


class PseudoInst(Enum):
    """Provenance tree node kinds (reference interpreter.py ProvenanceRecord
    pseudo-instructions)."""

    INPUT_ARGS = auto()
    INPUT_FN = auto()
    LOAD_GLOBAL = auto()
    LOAD_ATTR = auto()
    BINARY_SUBSCR = auto()
    LOAD_DEREF = auto()
    LEN = auto()
    ABSENT_ITEM = auto()  # key observed missing (dict.get miss / `in` False)
    ABSENT_ATTR = auto()  # attribute observed missing (getattr/hasattr miss)
    PRESENT_ITEM = auto()  # dict key observed present (`in` True / .get hit)
    PRESENT_ATTR = auto()  # attribute observed present (hasattr / attr read)
    ABSENT_MEMBER = auto()  # VALUE observed absent via `in` on a sequence
    PRESENT_MEMBER = auto()  # VALUE observed present via `in` on a sequence
    KEYS = auto()  # dict key tuple observed (iteration / keys()/items())
    TYPE_NAME = auto()  # object class observed via isinstance()
    MODULE = auto()  # a module object (in-function import), root = sys.modules
    GLOBALS_DICT = auto()  # a frame's globals dict via globals()
    CONSTANT = auto()
    OPAQUE = auto()


@dataclass(frozen=True)
class ProvenanceRecord:
    inst: PseudoInst
    inputs: tuple = ()
    key: Any = None

    def __str__(self):
        if self.inst is PseudoInst.INPUT_FN:
            return "<fn>"
        if self.inst is PseudoInst.INPUT_ARGS:
            return "<args>"
        if self.inst is PseudoInst.LOAD_GLOBAL:
            return f"globals()[{self.key!r}]"
        if self.inst is PseudoInst.LOAD_ATTR:
            return f"{self.inputs[0]}.{self.key}"
        if self.inst is PseudoInst.BINARY_SUBSCR:
            return f"{self.inputs[0]}[{self.key!r}]"
        if self.inst is PseudoInst.LOAD_DEREF:
            return f"<closure {self.key}>"
        return self.inst.name

    def path(self) -> tuple | None:
        """Root-relative access path as typed steps:
        (('globals', name), ('attr', a), ('item', k), ...) — or None when the
        value is not rooted at function state (so not re-locatable by a
        prologue).  Globals of OTHER modules (helper functions interpreted
        through) root at ('gmod', module_name) and re-resolve via
        sys.modules at prologue time."""
        if self.inst is PseudoInst.LOAD_GLOBAL:
            if isinstance(self.key, tuple):  # (module_name, var_name)
                modname, name = self.key
                return (("gmod", modname), ("item", name))
            return (("globals", self.key),)
        if self.inst is PseudoInst.LOAD_DEREF:
            return (("closure", self.key),)
        if self.inst is PseudoInst.LOAD_ATTR and self.inputs:
            base = self.inputs[0].path()
            return None if base is None else base + (("attr", self.key),)
        if self.inst is PseudoInst.BINARY_SUBSCR and self.inputs:
            base = self.inputs[0].path()
            return None if base is None else base + (("item", self.key),)
        if self.inst is PseudoInst.LEN and self.inputs:
            base = self.inputs[0].path()
            return None if base is None else base + (("len", None),)
        if self.inst is PseudoInst.ABSENT_ITEM and self.inputs:
            base = self.inputs[0].path()
            return None if base is None else base + (("absent_item", self.key),)
        if self.inst is PseudoInst.ABSENT_ATTR and self.inputs:
            base = self.inputs[0].path()
            return None if base is None else base + (("absent_attr", self.key),)
        if self.inst is PseudoInst.PRESENT_ITEM and self.inputs:
            base = self.inputs[0].path()
            return None if base is None else base + (("present_item", self.key),)
        if self.inst is PseudoInst.PRESENT_ATTR and self.inputs:
            base = self.inputs[0].path()
            return None if base is None else base + (("present_attr", self.key),)
        if self.inst is PseudoInst.ABSENT_MEMBER and self.inputs:
            base = self.inputs[0].path()
            return None if base is None else base + (("absent_member", self.key),)
        if self.inst is PseudoInst.PRESENT_MEMBER and self.inputs:
            base = self.inputs[0].path()
            return None if base is None else base + (("present_member", self.key),)
        if self.inst is PseudoInst.KEYS and self.inputs:
            base = self.inputs[0].path()
            return None if base is None else base + (("keys", None),)
        if self.inst is PseudoInst.TYPE_NAME and self.inputs:
            base = self.inputs[0].path()
            return None if base is None else base + (("type_name", None),)
        if self.inst is PseudoInst.MODULE:
            # resolves to the module OBJECT (sys.modules[name]) so attr
            # steps use real getattr — PEP 562 module __getattr__ included
            return (("gmodule", self.key),)
        if self.inst is PseudoInst.GLOBALS_DICT:
            # root frame (key None): the prologue's own globals root;
            # helper frames: the module-qualified dict root
            return (("gdict", None),) if self.key is None else (("gmod", self.key),)
        return None


@dataclass
class InterpreterCompileCtx:
    """Observation state shared across frames during one interpretation."""

    fn: Callable
    # id(value) → ProvenanceRecord for tracked non-primitive objects
    provenance: dict[int, ProvenanceRecord] = field(default_factory=dict)
    # pinned values so CPython cannot recycle a tracked id
    _pins: list = field(default_factory=list)
    # leaf reads eligible for guards/unpacks: (ProvenanceRecord, value)
    reads: list = field(default_factory=list)
    # value substitution requested by the caller when a read occurs
    # (general_jit proxifies tensors here); returns the value to use
    read_callback: Callable | None = None
    # thread-level "currently handled exception" stack (CPython's
    # tstate->exc_info chain): a bare `raise` in a helper function re-raises
    # the exception its *caller* is handling, so the state must span frames.
    # Entries are (frame, exc) so a frame's residue can be removed on its
    # exit even when suspended generator frames interleave pushes
    exc_stack: list = field(default_factory=list)
    max_depth: int = 32
    # callables never interpreted (treated as opaque host calls)
    opaque: set = field(default_factory=set)
    # function substitution: target callable → replacement, consulted before
    # interpretability (the reference's lookaside registry,
    # interpreter.py:1234-1298) — routes e.g. ``torch.foo`` → ltorch inside
    # interpreted code without relying on __torch_function__
    lookasides: dict = field(default_factory=dict)
    # per-run event log: ("op", depth, co_name, opname, argrepr) for every
    # executed instruction plus ("call"/"lookaside"/"opaque", depth, name)
    # at call boundaries (reference's interpreter log, interpreter.py:6683)
    log: list = field(default_factory=list)
    # the TRACED fn's globals dict — frames over OTHER modules qualify their
    # global reads with the module name (see _global_record)
    root_globals: dict | None = None
    # writes INTO tracked external state during tracing: (base_rec, kind,
    # key) — kind "item"/"attr", key None when the key is not a guardable
    # literal.  Deduplicated; the general jit prunes the read guards these
    # writes supersede (a guard captured pre-write would fail its own
    # prologue immediately)
    writes: set = field(default_factory=set)
    log_limit: int = 200_000

    def record(self, *event):
        if len(self.log) < self.log_limit:
            self.log.append(event)
        elif len(self.log) == self.log_limit:
            self.log.append(("truncated", self.log_limit))

    def track(self, value, record: ProvenanceRecord):
        if value is None or isinstance(value, (int, float, bool, str, bytes, complex)):
            return
        self.provenance[id(value)] = record
        self._pins.append(value)

    def record_read(self, record: ProvenanceRecord, value):
        self.reads.append((record, value))
        if self.read_callback is not None:
            return self.read_callback(record, value)
        return value

    def prov_of(self, value) -> ProvenanceRecord | None:
        return self.provenance.get(id(value))


_handlers: dict[str, Callable] = {}


def register_opcode_handler(name: str):
    def deco(fn):
        _handlers[name] = fn
        return fn

    return deco


# process-wide lookaside/opaque registries, merged into every interpretation
# (per-call sets passed to ``interpret`` add to these)
_default_lookasides: dict[Callable, Callable] = {}
_default_opaque: set = set()

# top-level packages whose functions always run as opaque host calls
_OPAQUE_TOP_PACKAGES = frozenset({
    "thunder_tpu_torch", "torch", "torchvision", "torchaudio", "torch_xla",
    "jax", "jaxlib", "flax", "flaxlib", "optax", "numpy", "scipy", "einops",
    "transformers", "accelerate", "safetensors", "tokenizers",
    "asyncio", "selectors", "signal", "concurrent", "threading",
})


def register_lookaside(target: Callable):
    """Registers a replacement for ``target`` inside interpreted code:
    ``@register_lookaside(some_fn) def _(args...)`` — whenever interpreted
    bytecode calls ``some_fn``, the replacement runs (as a host call)
    instead.  The reference's lookaside mechanism (interpreter.py:1234)."""

    def deco(replacement: Callable):
        _default_lookasides[target] = replacement
        return replacement

    return deco


def make_opaque(fn: Callable) -> Callable:
    """Marks ``fn`` as never-interpreted: calls run as host calls (the
    reference's ``interpreter_needs_wrap``/opaque contract)."""
    _default_opaque.add(fn)
    return fn


class Frame:
    __slots__ = ("code", "localsplus", "stack", "globals_", "builtins_", "cells", "instrs", "offset_to_idx", "names", "ctx", "depth", "kw_names", "fn_prov", "current_exc")

    def __init__(self, code: types.CodeType, globals_: dict, ctx: InterpreterCompileCtx, depth: int, fn_prov: "ProvenanceRecord | None" = None):
        self.code = code
        self.localsplus: dict[str, Any] = {}
        self.cells: dict[str, types.CellType] = {}
        self.stack: list = []
        self.globals_ = globals_
        self.builtins_ = globals_.get("__builtins__", _builtins)
        if isinstance(self.builtins_, types.ModuleType):
            self.builtins_ = self.builtins_.__dict__
        # dis folds EXTENDED_ARG into the following instruction's arg/argval,
        # so both it and CACHE are transparent — but a jump may TARGET an
        # EXTENDED_ARG offset, so those offsets must map to the next real
        # instruction's index
        raw = list(dis.get_instructions(code))
        self.instrs = []
        self.offset_to_idx = {}
        pending_offsets: list[int] = []
        for ins in raw:
            if ins.opname in ("CACHE", "EXTENDED_ARG"):
                pending_offsets.append(ins.offset)
                continue
            idx = len(self.instrs)
            for off in pending_offsets:
                self.offset_to_idx[off] = idx
            pending_offsets.clear()
            self.offset_to_idx[ins.offset] = idx
            self.instrs.append(ins)
        self.ctx = ctx
        self.depth = depth
        self.kw_names: tuple = ()
        self.fn_prov = fn_prov
        self.current_exc: BaseException | None = None

    def push(self, v):
        self.stack.append(v)

    def pop(self):
        return self.stack.pop()

    def jump_to_offset(self, offset: int) -> int:
        idx = self.offset_to_idx.get(offset)
        if idx is None:
            raise InterpreterError(f"jump to unknown offset {offset} in {self.code.co_name}")
        return idx


# CPython's stack NULL is a real null pointer, distinct from Py_None — the
# call convention depends on the difference ([NULL, callable] plain call vs
# [callable, self] method call with None as a legitimate self/argument)
class _NullType:
    __slots__ = ()

    def __repr__(self):
        return "<NULL>"


_NULL = _NullType()


def _nb_op(opname_arg: int, a, b):
    import operator as op

    ops = {
        0: op.add, 1: op.and_, 2: op.floordiv, 3: op.lshift, 4: op.matmul,
        5: op.mul, 6: op.mod, 7: op.or_, 8: op.pow, 9: op.rshift,
        10: op.sub, 11: op.truediv, 12: op.xor,
        # in-place variants fall back to the binary op (proxies are immutable)
        13: op.iadd, 14: op.iand, 15: op.ifloordiv, 16: op.ilshift, 17: op.imatmul,
        18: op.imul, 19: op.imod, 20: op.ior, 21: op.ipow, 22: op.irshift,
        23: op.isub, 24: op.itruediv, 25: op.ixor,
    }
    return ops[opname_arg](a, b)


def _is_interpretable(fn) -> bool:
    return isinstance(fn, types.FunctionType) and fn.__code__ is not None


# values the prologue can guard BY VALUE (mirror of jit_ext's _GUARDABLE
# leaves); reads producing anything else get a membership guard instead so
# the key/attr DISAPPEARING later still retraces.  Also the key types a
# guard path can carry (hashable, repr-safe literals).
_PRIMITIVE = (int, float, bool, str, bytes, type(None))


def _std_mapping_method(fn, names: tuple) -> bool:
    """True when ``fn`` is a bound mapping method with STOCK semantics the
    lookasides may emulate: a C method of a dict-like (dict, mappingproxy),
    or the collections.abc.Mapping mixin itself.  A Python override with
    custom behavior falls through to interpretation, which preserves its
    semantics (and still guards the state it reads)."""
    if getattr(fn, "__name__", None) not in names:
        return False
    if isinstance(fn, types.BuiltinMethodType):
        return _is_mappinglike(getattr(fn, "__self__", None))
    if isinstance(fn, types.MethodType):
        std = getattr(_abc.Mapping, fn.__name__, None)
        return fn.__func__ is std and _is_mappinglike(getattr(fn, "__self__", None))
    return False


def _is_mappinglike(obj) -> bool:
    # containers whose `in`/getitem operate on KEYS: dicts and Mapping
    # implementations (os.environ, ChainMap, ...).  Sequences test VALUES
    # with `in`, so they are excluded from item-membership guards.
    return isinstance(obj, (dict, _abc.Mapping))


def _guardable_key(k) -> bool:
    # key shapes a guard path can carry: hashable, repr-safe literals —
    # primitives plus all-primitive tuples (a common dict-key shape)
    return isinstance(k, _PRIMITIVE) or (
        isinstance(k, tuple) and all(isinstance(e, _PRIMITIVE) for e in k)
    )


def _tracked_read(ctx: "InterpreterCompileCtx", base_rec, key, value, *, is_attr: bool, container=None):
    """Records a provenance-preserving attr/item read.  When the value
    itself cannot become a value guard (arbitrary object, tensor), also
    records a PRESENT membership guard — the dual of the miss-side absence
    guards: without it, `del d[k]` / `del o.a` after tracing would silently
    replay the baked present-branch.  Item guards cover mapping-like
    containers (dicts, os.environ, ChainMap — `in` on a sequence tests
    VALUES, not indices); attr guards skip names resolved on
    the CLASS (methods/descriptors — effectively static) and module
    attributes, which keeps the per-call prologue free of hasattr noise for
    every method access.  Returns the (possibly substituted) value."""
    inst = PseudoInst.LOAD_ATTR if is_attr else PseudoInst.BINARY_SUBSCR
    rec = ProvenanceRecord(inst, inputs=(base_rec,), key=key)
    value = ctx.record_read(rec, value)
    ctx.track(value, rec)
    if isinstance(value, _PRIMITIVE):
        return value
    if is_attr:
        if isinstance(container, types.ModuleType) or hasattr(type(container), key):
            return value
    elif not _is_mappinglike(container):
        return value
    pinst = PseudoInst.PRESENT_ATTR if is_attr else PseudoInst.PRESENT_ITEM
    ctx.record_read(ProvenanceRecord(pinst, inputs=(base_rec,), key=key), True)
    return value


def _read_elements(ctx: "InterpreterCompileCtx", obj, *, primitive_only: bool = False) -> list | None:
    """Eagerly reads a TRACKED list/tuple's elements with provenance — a
    LEN guard plus one per-element read (value guards for primitives,
    proxification for tensors) — so iterating or folding external state
    retraces when any element (or the length) changes.  Returns the
    (possibly substituted) elements, or None when obj is untracked or not a
    sequence.  ``primitive_only`` peeks BEFORE recording anything and bails
    on non-primitive content: host folds (sorted/min/...) must compute on
    real values, and proxifying tensors only to discard them would leave
    dead unpack chains in the prologue."""
    base_rec = ctx.prov_of(obj)
    if base_rec is None or not isinstance(obj, (list, tuple)):
        return None
    if primitive_only and not all(isinstance(e, _PRIMITIVE) for e in obj):
        return None
    n = len(obj)
    ctx.record_read(ProvenanceRecord(PseudoInst.LEN, inputs=(base_rec,)), n)
    return [
        _tracked_read(ctx, base_rec, idx, obj[idx], is_attr=False, container=obj)
        for idx in range(n)
    ]


def _read_keys(ctx: "InterpreterCompileCtx", d: dict) -> list | None:
    """Records a KEYS read for a TRACKED dict — the key tuple (set AND
    order) becomes a prologue check_keys guard, since iteration unrolls in
    key order.  When keys are not guardable only a LEN guard is possible,
    and the observed keys/values still bake into the trace — an UNDER-guard
    (same-length key replacement replays stale results), so it is surfaced
    through the sharp-edges policy (warn/error; ADVICE r5 low).  Returns the
    key list, or None when d is untracked."""
    base_rec = ctx.prov_of(d)
    if base_rec is None:
        return None
    keys = list(d.keys())
    if all(_guardable_key(k) for k in keys):
        ctx.record_read(ProvenanceRecord(PseudoInst.KEYS, inputs=(base_rec,)), tuple(keys))
    else:
        from thunder_tpu_torch.core.compile_data import get_compile_data
        from thunder_tpu_torch.core.sharp_edges import report_unguardable_keys

        cd = get_compile_data()
        if cd is not None:
            offending = sorted({type(k).__name__ for k in keys if not _guardable_key(k)})
            report_unguardable_keys(
                cd.sharp_edges, f"key types: {', '.join(offending)}"
            )
        ctx.record_read(ProvenanceRecord(PseudoInst.LEN, inputs=(base_rec,)), len(d))
    return keys


def _read_dict_values(ctx: "InterpreterCompileCtx", d: dict, keys: list) -> list:
    base_rec = ctx.prov_of(d)
    return [
        _tracked_read(ctx, base_rec, k, d[k], is_attr=False, container=d)
        if _guardable_key(k)
        else d[k]
        for k in keys
    ]


# container-folding builtins interpreted through when fed a tracked sequence
# of PRIMITIVES (host semantics are only safe on real values — tensor-proxy
# elements fall through to the opaque path like before)
_FOLD_BUILTINS = {sorted, min, max, any, all, sum, list, tuple, reversed}


def _provenance_builtin_call(ctx: "InterpreterCompileCtx", depth: int, fn, args, kwargs):
    """Provenance-preserving interpretation of the builtins most likely to
    reach guarded state: ``getattr``/``hasattr``, ``operator.getitem``,
    bound ``dict.get``/``keys``/``values``/``items``, ``isinstance``, the
    container-folding builtins (``sorted``/``min``/``max``/``any``/``all``/
    ``sum``/``list``/``tuple``/``reversed``) and ``enumerate``/``zip``
    (reference interpreter.py:1324-2200 interprets *through* ~60 builtins
    for the same reason).  An opaque host call would lose the access chain —
    a hyperparameter read via ``cfg.get("lr")`` or ``max(SCHEDULE)`` could
    never become a prologue guard, so mutating it would silently replay the
    stale program.  Returns ``(handled, value)``."""
    # container-walking builtins come BEFORE the kwargs bail: a variant we
    # don't interpret (sorted(xs, reverse=True), sum(xs, start), enumerate
    # start=) must still RECORD the element guards, then run opaque on the
    # raw container — the host result stays consistent because the guards
    # pin exactly the values it computes on
    def read_seq(obj, *, primitive_only: bool):
        # the iterable view the builtins consume: elements for sequences,
        # KEYS for dicts (iteration/folds over a dict walk its keys) — the
        # dict case guards via check_keys, same as _get_iter
        if isinstance(obj, dict):
            if ctx.prov_of(obj) is None:
                return None
            return _read_keys(ctx, obj)
        return _read_elements(ctx, obj, primitive_only=primitive_only)

    try:
        is_fold = fn in _FOLD_BUILTINS
    except TypeError:  # unhashable callable
        is_fold = False
    if (is_fold or fn is enumerate) and args:
        will_handle = not kwargs and (len(args) == 1 if is_fold else len(args) <= 2)
        elems = read_seq(args[0], primitive_only=is_fold or not will_handle)
        if elems is None or not will_handle:
            return False, None
        if is_fold and not all(isinstance(e, _PRIMITIVE) for e in elems):
            return False, None  # host folds need real values (dict keys are)
        ctx.record("lookaside", depth, f"builtins.{fn.__name__}")
        return True, (fn(elems) if is_fold else enumerate(elems, *args[1:]))
    if fn is zip and args:
        will_handle = not kwargs
        mapped, any_tracked = [], False
        for a in args:
            elems = read_seq(a, primitive_only=not will_handle)
            mapped.append(a if elems is None else elems)
            any_tracked = any_tracked or elems is not None
        if not any_tracked or not will_handle:
            return False, None
        ctx.record("lookaside", depth, "builtins.zip")
        return True, zip(*mapped)
    if kwargs:
        return False, None
    if fn is getattr and len(args) in (2, 3) and isinstance(args[1], str):
        obj, name = args[0], args[1]
        base_rec = ctx.prov_of(obj)
        try:
            v = getattr(obj, name)
        except AttributeError:
            if base_rec is not None:
                # absence observed: emit a dedicated absent-attr guard
                # (prologue check_absent) so ADDING the attribute later
                # retraces — a whole-object value guard would only work for
                # _guardable containers, silently missing e.g. config objects
                rec = ProvenanceRecord(PseudoInst.ABSENT_ATTR, inputs=(base_rec,), key=name)
                ctx.record_read(rec, True)
            if len(args) == 3:
                return True, args[2]
            raise
        if base_rec is not None:
            ctx.record("lookaside", depth, "builtins.getattr")
            v = _tracked_read(ctx, base_rec, name, v, is_attr=True, container=obj)
        return True, v
    if fn is hasattr and len(args) == 2 and isinstance(args[1], str):
        # the most common spelling of branch-on-attribute-presence: guard
        # the observed membership so adding/removing the attr retraces
        obj, name = args
        found = hasattr(obj, name)
        base_rec = ctx.prov_of(obj)
        if base_rec is not None:
            ctx.record("lookaside", depth, "builtins.hasattr")
            inst = PseudoInst.PRESENT_ATTR if found else PseudoInst.ABSENT_ATTR
            ctx.record_read(ProvenanceRecord(inst, inputs=(base_rec,), key=name), True)
        return True, found
    if fn is len and len(args) == 1:
        obj = args[0]
        base_rec = ctx.prov_of(obj)
        n = len(obj)
        if base_rec is not None:
            # a LENGTH guard (prologue check_len), NOT a container-value
            # guard: scratch lists mutated mid-call (HF's out_cls_cell
            # pattern) would otherwise bake post-mutation contents
            ctx.record("lookaside", depth, "builtins.len")
            rec = ProvenanceRecord(PseudoInst.LEN, inputs=(base_rec,))
            n = ctx.record_read(rec, n)
        return True, n
    if fn is operator.getitem and len(args) == 2:
        obj, k = args
        base_rec = ctx.prov_of(obj)
        try:
            v = obj[k]
        except (KeyError, IndexError):
            # EAFP miss: guard the observed absence (mapping-like only) so
            # inserting the key later retraces instead of replaying the
            # handler branch
            if base_rec is not None and _is_mappinglike(obj) and _guardable_key(k):
                ctx.record_read(ProvenanceRecord(PseudoInst.ABSENT_ITEM, inputs=(base_rec,), key=k), True)
            raise
        if base_rec is not None and _guardable_key(k):
            ctx.record("lookaside", depth, "operator.getitem")
            v = _tracked_read(ctx, base_rec, k, v, is_attr=False, container=obj)
        return True, v
    if (
        _std_mapping_method(fn, ("get",))
        and len(args) in (1, 2)
        and _guardable_key(args[0])
    ):
        d = fn.__self__
        base_rec = ctx.prov_of(d)
        if args[0] not in d:
            if base_rec is not None:
                # a miss must also guard: a dedicated absent-key guard
                # (prologue check_absent) retraces when the key is INSERTED
                # later, on any dict — a whole-dict value guard would only
                # cover small all-primitive dicts (_guardable)
                rec = ProvenanceRecord(PseudoInst.ABSENT_ITEM, inputs=(base_rec,), key=args[0])
                ctx.record_read(rec, True)
            return True, (args[1] if len(args) == 2 else None)
        v = d[args[0]]
        if base_rec is not None:
            ctx.record("lookaside", depth, "dict.get")
            v = _tracked_read(ctx, base_rec, args[0], v, is_attr=False, container=d)
        return True, v
    if _std_mapping_method(fn, ("keys", "values", "items")) and not args:
        d = fn.__self__
        keys = _read_keys(ctx, d)
        if keys is None:
            return False, None
        ctx.record("lookaside", depth, f"dict.{fn.__name__}")
        # return REAL view objects over a guarded snapshot so dict-view set
        # algebra (cfg.keys() & {...}, a.items() - b.items()) keeps working.
        # keys() observes only the KEY SET — reading values there would
        # value-guard (and proxify) data the program never touched, causing
        # spurious retraces and dead prologue unpacks
        if fn.__name__ == "keys":
            return True, dict.fromkeys(keys).keys()
        snap = dict(zip(keys, _read_dict_values(ctx, d, keys)))
        return True, getattr(snap, fn.__name__)()
    if fn is __import__ and args:
        # the functional spelling of import: track the module like the
        # IMPORT_NAME opcode does, so reads off it guard
        mod = __import__(*args)
        if isinstance(mod, types.ModuleType):
            modname = getattr(mod, "__name__", None)
            if isinstance(modname, str) and sys.modules.get(modname) is mod:
                ctx.track(mod, ProvenanceRecord(PseudoInst.MODULE, key=modname))
        return True, mod
    if fn is isinstance and len(args) == 2:
        from thunder_tpu_torch.core.proxies import Proxy

        obj = args[0]
        if isinstance(obj, Proxy):
            # trace-time proxies are not the runtime values: guarding their
            # class would fail every post-trace prologue (retrace loop)
            return False, None
        res = isinstance(obj, args[1])
        base_rec = ctx.prov_of(obj)
        if base_rec is not None and not isinstance(obj, _PRIMITIVE):
            # the branch baked on this object's CLASS: swapping it for an
            # instance of another class must retrace (guarded by qualified
            # type name — repr-safe in generated prologue source)
            ctx.record("lookaside", depth, "builtins.isinstance")
            name = f"{type(obj).__module__}.{type(obj).__qualname__}"
            ctx.record_read(ProvenanceRecord(PseudoInst.TYPE_NAME, inputs=(base_rec,)), name)
        return True, res
    return False, None


def _call_value(ctx: InterpreterCompileCtx, depth: int, fn, args, kwargs):
    """Calls ``fn``: lookasides substitute first, user Python functions
    recurse through the interpreter; everything else runs as an opaque host
    call."""
    from thunder_tpu_torch.core.proxies import Proxy

    try:
        la = ctx.lookasides.get(fn)
    except TypeError:  # unhashable callable (e.g. dataclass(eq=True) instance)
        la = None
    if la is None and isinstance(fn, types.MethodType):
        la = ctx.lookasides.get(fn.__func__)
        if la is not None:
            args = (fn.__self__, *args)
    if la is not None:
        ctx.record("lookaside", depth, getattr(fn, "__qualname__", repr(fn)))
        return la(*args, **kwargs)
    handled, v = _provenance_builtin_call(ctx, depth, fn, args, kwargs)
    if handled:
        return v
    if depth >= ctx.max_depth:
        out = fn(*args, **kwargs)
        _record_method_mutation(ctx, fn)
        return out
    if isinstance(fn, types.MethodType) and _is_interpretable(fn.__func__) and fn.__func__ not in ctx.opaque:
        ctx.record("call", depth, getattr(fn, "__qualname__", repr(fn)))
        return _run_function(ctx, fn.__func__, (fn.__self__, *args), kwargs, depth + 1)
    if _is_interpretable(fn) and fn not in ctx.opaque:
        # torch-surface functions keep their __torch_function__ diversion:
        # they are interpretable but the diversion triggers inside; recursing
        # is also fine — prefer the host call for functions from installed
        # packages (site-packages) to keep the interpreter on user code
        mod = getattr(fn, "__module__", "") or ""
        # Host-call opacity matches exact top packages — naming every
        # ecosystem root explicitly (torchvision/torch_xla/jaxlib, not a
        # "torch*" prefix) so a user module merely *named* jax_helpers.py or
        # signals.py still interprets.  asyncio and friends are runtime
        # machinery: the loop runs host-side and drives InterpretedCoroutines
        # via send(); interpreting its internals only manufactures prologue
        # guards on loop/signal state that can never replay.
        top = mod.split(".", 1)[0]
        if top in _OPAQUE_TOP_PACKAGES:
            ctx.record("opaque", depth, getattr(fn, "__qualname__", repr(fn)))
            return fn(*args, **kwargs)
        ctx.record("call", depth, getattr(fn, "__qualname__", repr(fn)))
        return _run_function(ctx, fn, args, kwargs, depth + 1)
    out = fn(*args, **kwargs)
    _record_method_mutation(ctx, fn)
    return out


# container methods that MUTATE their receiver: calling one on TRACKED
# external state is a trace-time write — the guards captured before it must
# be re-evaluated (jit_ext._refresh_tainted_guards), same as opcode writes
_MUTATING_METHODS = frozenset({
    "append", "extend", "insert", "remove", "clear", "sort", "reverse",
    "pop", "popitem", "update", "setdefault", "add", "discard",
    "difference_update", "intersection_update", "symmetric_difference_update",
    "appendleft", "extendleft", "popleft", "rotate",
    "__setitem__", "__delitem__", "__iadd__", "__ior__",
})


def _record_method_mutation(ctx: InterpreterCompileCtx, fn) -> None:
    # bound dunders of builtin containers are MethodWrapperType, not
    # BuiltinMethodType (type([].__setitem__) is method-wrapper)
    if not isinstance(fn, (types.BuiltinMethodType, types.MethodType,
                           types.MethodWrapperType)):
        return
    if getattr(fn, "__name__", None) not in _MUTATING_METHODS:
        return
    recv = getattr(fn, "__self__", None)
    base_rec = ctx.prov_of(recv)
    if base_rec is None:
        return
    if _is_module_globals(ctx, recv):
        raise InterpreterError(
            f"mutating module globals via globals().{fn.__name__}(...) during "
            f"tracing is not supported (the store would not replay on cache "
            f"hits); return the value or pass state explicitly"
        )
    _add_write(ctx, (base_rec, "method", fn.__name__), f"{base_rec}.{fn.__name__}(...)")


def _bind_args(code: types.CodeType, fn: types.FunctionType | None, args: tuple, kwargs: dict) -> dict:
    """Binds call args to local variable names (defaults, *args, **kwargs)."""
    import inspect

    names = code.co_varnames[: code.co_argcount]
    if any(n.startswith(".") for n in names):
        # genexpr/comprehension codes take the compiler-named '.0' iterator,
        # which inspect.signature cannot represent — bind positionally
        return dict(zip(names, args))
    if fn is not None:
        sig = inspect.signature(fn)
        bound = sig.bind(*args, **kwargs)
        bound.apply_defaults()
        return dict(bound.arguments)
    # codes without a function object (comprehensions): positional only
    names = code.co_varnames[: code.co_argcount]
    return dict(zip(names, args))


def _run_function(ctx: InterpreterCompileCtx, fn: types.FunctionType, args: tuple, kwargs: dict, depth: int):
    frame = Frame(fn.__code__, fn.__globals__, ctx, depth, fn_prov=ctx.prov_of(fn))
    bound = _bind_args(fn.__code__, fn, args, kwargs)
    # inspect collapses *args/**kwargs into single entries keyed by name
    code = fn.__code__
    n_named = code.co_argcount + code.co_kwonlyargcount
    varnames = code.co_varnames
    for name, val in bound.items():
        frame.localsplus[name] = val
    # closure cells
    if fn.__closure__:
        for name, cell in zip(code.co_freevars, fn.__closure__):
            frame.cells[name] = cell
    if code.co_flags & 0x200:  # CO_ASYNC_GENERATOR
        return InterpretedAsyncGenerator(frame)
    if code.co_flags & 0x80:  # CO_COROUTINE
        return InterpretedCoroutine(frame)
    if code.co_flags & 0x20:  # CO_GENERATOR: suspend-capable frame
        return InterpretedGenerator(frame)
    return _run_frame(frame)


def _run_frame(frame: Frame):
    instrs = frame.instrs
    # CPython 3.12 zero-cost exceptions: handlers are located via the code
    # object's exception table (instruction-range → target/depth/lasti)
    exc_table = dis._parse_exception_table(frame.code)
    # balance the thread-level handled-exception stack on ANY exit from this
    # frame: an exception propagating out of an except block skips POP_EXCEPT,
    # and a stale entry would leak into sibling calls' bare-raise lookups
    try:
        loop = _frame_loop(frame, instrs, exc_table)
        try:
            next(loop)
        except StopIteration as e:
            return e.value
        except _StopIterationCarrier as c:
            # a user StopIteration crossing a NON-generator interpreted frame
            # must keep its identity; _frame_loop smuggles it out in a
            # carrier so the host doesn't PEP-479-wrap it (while a genuine
            # wrap from a generator frame passes through untouched)
            raise c.exc
        raise InterpreterError(f"unexpected yield in non-generator frame {frame.code.co_name}")
    finally:
        frame.ctx.exc_stack[:] = [p for p in frame.ctx.exc_stack if p[0] is not frame]


def _gen_driver(frame: Frame):
    """The resumable loop behind an InterpretedGenerator (a real Python
    generator, so suspend/resume/throw/close and StopIteration.value all come
    from the host machinery)."""
    exc_table = dis._parse_exception_table(frame.code)
    try:
        return (yield from _frame_loop(frame, frame.instrs, exc_table))
    finally:
        frame.ctx.exc_stack[:] = [p for p in frame.ctx.exc_stack if p[0] is not frame]


class InterpretedGenerator:
    """A suspended interpreted frame exposing the generator protocol
    (reference: the interpreter runs generator frames natively;
    thunder/core/interpreter.py generator handling)."""

    def __init__(self, frame: Frame):
        self._frame = frame
        self._loop = _gen_driver(frame)

    def __iter__(self):
        return self

    def __next__(self):
        return self._loop.send(None)

    def send(self, value):
        return self._loop.send(value)

    def throw(self, *exc):
        return self._loop.throw(*exc)

    def close(self):
        return self._loop.close()


class InterpretedCoroutine(_abc.Coroutine):
    """A suspended interpreted CO_COROUTINE frame exposing the coroutine
    protocol.  Subclassing ``collections.abc.Coroutine`` makes
    ``asyncio.iscoroutine`` true, so an opaque event loop (``asyncio.run``)
    can drive interpreted coroutines exactly as CPython ones: ``send(None)``
    resumes to the next suspension, ``StopIteration.value`` carries the
    result.  (Reference interpreter runs coroutine frames natively; its
    3.10/3.11 opcode set reaches them via the same generator machinery.)"""

    def __init__(self, frame: Frame):
        self._frame = frame
        self._loop = _gen_driver(frame)
        self._done = False

    def __await__(self):
        # like CPython's coroutine_wrapper: an iterator over the same frame,
        # routed through send/throw so the reuse guard still applies
        return _CoroWrapper(self)

    def send(self, value):
        if self._done:
            raise RuntimeError("cannot reuse already awaited coroutine")
        try:
            return self._loop.send(value)
        except BaseException:  # StopIteration (completion) or error: dead either way
            self._done = True
            raise

    def throw(self, *exc):
        if self._done:
            raise RuntimeError("cannot reuse already awaited coroutine")
        try:
            return self._loop.throw(*exc)
        except BaseException:
            self._done = True
            raise

    def close(self):
        self._done = True
        return self._loop.close()


class _CoroWrapper:
    """Iterator view of an InterpretedCoroutine (CPython's coroutine_wrapper)."""

    __slots__ = ("_coro",)

    def __init__(self, coro):
        self._coro = coro

    def __iter__(self):
        return self

    def __next__(self):
        return self._coro.send(None)

    def send(self, value):
        return self._coro.send(value)

    def throw(self, *exc):
        return self._coro.throw(*exc)

    def close(self):
        return self._coro.close()


class _ThrowIn:
    """In-band exception delivery into a suspended interpreted frame: sent as
    a value through the host generator channel and raised at the suspension
    point.  Used for GeneratorExit, which host ``gen.throw`` would forbid
    resuming from (no yield after throw(GeneratorExit)) — but async-gen
    cleanup is allowed to await."""

    __slots__ = ("exc",)

    def __init__(self, exc: BaseException):
        self.exc = exc


class _AsyncGenWrapped:
    """Marker around values yielded by an async generator (CPython's
    internal _PyAsyncGenWrappedValue, produced by CALL_INTRINSIC_1
    INTRINSIC_ASYNC_GEN_WRAP): distinguishes ``yield x`` (ends one
    ``__anext__`` step) from yields forwarded out of an ``await`` inside the
    generator body (which go to the event loop)."""

    __slots__ = ("value",)

    def __init__(self, value):
        self.value = value


class _Awaitable:
    """Minimal awaitable over a host generator (the __anext__/asend/athrow
    driver below)."""

    __slots__ = ("_gen",)

    def __init__(self, gen):
        self._gen = gen

    def __await__(self):
        return self._gen


class InterpretedAsyncGenerator:
    """A suspended interpreted CO_ASYNC_GENERATOR frame exposing the async
    generator protocol (__anext__/asend/athrow/aclose return awaitables).

    One async-iteration step drives the frame until a wrapped ``yield`` (its
    value is the step's result), a bare return (→ StopAsyncIteration), or a
    suspension from an inner ``await`` (forwarded to the outer event loop).
    GeneratorExit is delivered in-band (``_ThrowIn``) so cleanup code may
    await — host ``gen.throw(GeneratorExit)`` would forbid the subsequent
    suspension."""

    def __init__(self, frame: Frame):
        self._frame = frame
        self._loop = _gen_driver(frame)
        self._started = False
        self._running = False
        self._closed = False
        self._finalizer = None

    def __aiter__(self):
        return self

    def __del__(self):
        # PEP 525 finalization: a partially-consumed async generator must
        # still run its cleanup.  The event loop's finalizer hook (captured
        # at first iteration, like CPython's firstiter/finalizer pair)
        # schedules aclose(); without a loop, best-effort close the frame.
        if self._closed or not self._started:
            return
        if self._finalizer is not None:
            try:
                self._finalizer(self)
                return
            except Exception:
                pass
        try:
            self._loop.close()
        except Exception:
            pass

    def _deliver(self, meth, args):
        if meth == "throw":
            exc = args[0] if args else None
            is_ge = isinstance(exc, GeneratorExit) or (
                isinstance(exc, type) and issubclass(exc, GeneratorExit)
            )
            if is_ge and self._started:
                inst = exc if isinstance(exc, BaseException) else GeneratorExit()
                return self._loop.send(_ThrowIn(inst))
            return self._loop.throw(*args)
        if not self._started:
            # PEP 525 firstiter hook (asyncio registers the generator so
            # loop.shutdown_asyncgens() can finalize it)
            import sys as _sys

            hooks = _sys.get_asyncgen_hooks()
            self._finalizer = hooks.finalizer
            if hooks.firstiter is not None:
                hooks.firstiter(self)
        self._started = True
        return self._loop.send(*args)

    def _step(self, meth, args):
        if self._running:
            raise RuntimeError("anext(): asynchronous generator is already running")
        self._running = True
        try:
            try:
                res = self._deliver(meth, args)
            except StopIteration:
                self._closed = True
                raise StopAsyncIteration
            while True:
                if isinstance(res, _AsyncGenWrapped):
                    return res.value  # → StopIteration(value) for the awaiter
                try:
                    sent = yield res  # inner await: forward to the event loop
                except BaseException as e:  # athrow/cancellation during the await
                    try:
                        res = self._deliver("throw", (e,))
                    except StopIteration:
                        self._closed = True
                        raise StopAsyncIteration
                    continue
                try:
                    res = self._deliver("send", (sent,))
                except StopIteration:
                    self._closed = True
                    raise StopAsyncIteration
        finally:
            self._running = False

    def __anext__(self):
        return _Awaitable(self._step("send", (None,)))

    def asend(self, value):
        return _Awaitable(self._step("send", (value,)))

    def athrow(self, *exc):
        return _Awaitable(self._step("throw", exc))

    def aclose(self):
        def _close():
            # throw GeneratorExit; the generator may run cleanup awaits
            # (forwarded to the loop) but may not yield another value
            self._closed = True
            if not self._started:
                self._loop.close()
                return
            step = self._step("throw", (GeneratorExit,))
            try:
                res = next(step)
            except (StopAsyncIteration, GeneratorExit):
                return
            except StopIteration:  # a wrapped yield completed the step
                raise RuntimeError("async generator ignored GeneratorExit")
            while True:
                try:
                    sent = yield res
                except BaseException as e:
                    try:
                        res = step.throw(e)
                        continue
                    except (StopAsyncIteration, GeneratorExit):
                        return
                    except StopIteration:
                        raise RuntimeError("async generator ignored GeneratorExit")
                try:
                    res = step.send(sent)
                except (StopAsyncIteration, GeneratorExit):
                    return
                except StopIteration:
                    raise RuntimeError("async generator ignored GeneratorExit")

        return _Awaitable(_close())


def _unwind(frame: Frame, ins, exc_table, e: BaseException) -> int:
    """Dispatches ``e`` raised at ``ins`` to the frame's exception table:
    truncates the value stack to the handler depth and returns the handler's
    instruction index.  Re-raises when no handler covers the offset."""
    entry = next((t for t in exc_table if t.start <= ins.offset < t.end), None)
    if entry is None:
        raise e
    del frame.stack[entry.depth :]
    if entry.lasti:
        frame.push(ins.offset)
    frame.push(e)
    # current_exc is NOT set here: the handler's PUSH_EXC_INFO saves the
    # outer state first, then installs e — setting it early would make
    # POP_EXCEPT "restore" the exception being handled
    return frame.jump_to_offset(entry.target)


# per-code-object handler resolution: one list indexed by instruction, built
# once — removes the opname attribute access + dict hash from the hot loop.
# Weak keys: code objects of dynamically generated functions must not be
# pinned forever in long-lived processes (ADVICE r3)
_resolved_handlers: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def _handlers_for(code, instrs):
    hs = _resolved_handlers.get(code)
    if hs is None:
        hs = [_handlers.get(ins.opname) for ins in instrs]
        _resolved_handlers[code] = hs
    return hs


def _frame_loop(frame: Frame, instrs, exc_table):
    # For NON-generator frames an escaping user StopIteration is smuggled out
    # in a carrier (the try wraps the whole loop below) — _frame_loop is a
    # host generator, and letting StopIteration escape it raw would PEP-479
    # wrap it into RuntimeError, changing exception identity at interpreted
    # frame boundaries.  Generator frames keep the wrap: that IS CPython.
    is_gen_frame = bool(frame.code.co_flags & 0x20)
    try:
        i = 0
        n = len(instrs)
        ctx_log = frame.ctx
        log = ctx_log.log
        log_limit = ctx_log.log_limit
        co_name = frame.code.co_name
        depth = frame.depth
        handlers = _handlers_for(frame.code, instrs)
        while i < n:
            ins = instrs[i]
            # skip tuple construction once truncated; <= (not <) because at
            # len == limit record() still appends its truncation MARKER
            if len(log) <= log_limit:
                ctx_log.record("op", depth, co_name, ins.opname, ins.argrepr)
            h = handlers[i]
            if h is None:
                raise InterpreterError(
                    f"opcode {ins.opname} is not supported by the bytecode interpreter yet "
                    f"(in {frame.code.co_name}); use the functional frontend or mark the callee opaque"
                )
            try:
                res = h(frame, ins, i)
            except InterpreterError:
                raise  # interpreter-machinery faults never unwind to user handlers
            except BaseException as e:
                # BaseException, not Exception: SystemExit/KeyboardInterrupt must
                # still run finally blocks and reach `except BaseException:`
                # handlers (the table entry exists for them like any other)
                i = _unwind(frame, ins, exc_table, _chain_context(frame, e))
                continue
            if isinstance(res, _Return):
                return res.value
            if isinstance(res, _Yield):
                # Suspend.  CPython swaps the generator's handled-exception state
                # out of the thread state across the yield, keeps the value slot
                # on the stack (the sent value replaces it on resume), and
                # delegates throw() to the sub-iterator when suspended at a
                # yield-from (YIELD_VALUE directly after SEND).
                to_yield = res.value
                ctx_stack = frame.ctx.exc_stack
                while True:
                    mine = [p for p in ctx_stack if p[0] is frame]
                    if mine:
                        ctx_stack[:] = [p for p in ctx_stack if p[0] is not frame]
                    thrown = None
                    try:
                        sent = yield to_yield
                    except BaseException as e:
                        thrown = e
                    else:
                        # in-band exception delivery (_ThrowIn): a host
                        # generator may not yield after throw(GeneratorExit),
                        # which would forbid async-gen cleanup awaits — so
                        # aclose() sends the exception as a value instead
                        if isinstance(sent, _ThrowIn):
                            thrown = sent.exc
                    ctx_stack.extend(mine)
                    if thrown is None:
                        frame.stack[-1] = sent
                        i += 1
                        break
                    in_yield_from = i > 0 and instrs[i - 1].opname == "SEND"
                    recv = frame.stack[-2] if in_yield_from and len(frame.stack) >= 2 else None
                    if recv is not None and hasattr(recv, "throw"):
                        try:
                            to_yield = recv.throw(thrown)
                            continue  # sub-iterator yielded again: re-suspend
                        except StopIteration as si:
                            # sub-iterator finished: SEND-exhaustion contract
                            frame.stack[-1] = getattr(si, "value", None)
                            i = frame.jump_to_offset(instrs[i - 1].argval)
                            break
                        except BaseException as e2:
                            thrown = e2
                    i = _unwind(frame, ins, exc_table, thrown)
                    break
                continue
            i = res if isinstance(res, int) else i + 1
        raise InterpreterError(f"fell off the end of {frame.code.co_name}")
    except StopIteration as e:
        if is_gen_frame:
            raise
        raise _StopIterationCarrier(e) from None


class _Return:
    __slots__ = ("value",)

    def __init__(self, value):
        self.value = value


class _Yield:
    __slots__ = ("value",)

    def __init__(self, value):
        self.value = value


class _StopIterationCarrier(Exception):
    """Smuggles a user StopIteration out of _frame_loop (a host generator)
    for non-generator frames, so the host's PEP-479 wrap doesn't change its
    identity at interpreted frame boundaries."""

    __slots__ = ("exc",)

    def __init__(self, exc):
        self.exc = exc


#
# Handlers.  Each returns None (advance), an int (next instruction index), or
# _Return.
#


@register_opcode_handler("RESUME")
@register_opcode_handler("NOP")
@register_opcode_handler("PRECALL")
@register_opcode_handler("MAKE_CELL")  # cells are materialized lazily in this design
@register_opcode_handler("COPY_FREE_VARS")
def _nop(frame, ins, i):
    return None


@register_opcode_handler("LOAD_CONST")
def _load_const(frame, ins, i):
    frame.push(ins.argval)


@register_opcode_handler("RETURN_CONST")
def _return_const(frame, ins, i):
    return _Return(ins.argval)


@register_opcode_handler("RETURN_VALUE")
def _return_value(frame, ins, i):
    return _Return(frame.pop())


@register_opcode_handler("LOAD_FAST")
@register_opcode_handler("LOAD_FAST_CHECK")
def _load_fast(frame, ins, i):
    name = ins.argval
    if name not in frame.localsplus:
        if name in frame.cells:
            try:
                frame.push(frame.cells[name].cell_contents)
            except ValueError:
                raise UnboundLocalError(
                    f"cannot access local variable {name!r} where it is not "
                    "associated with a value"
                ) from None
            return None
        # user-catchable, like CPython — NOT InterpreterError (which handlers
        # in interpreted code can never catch)
        raise UnboundLocalError(
            f"cannot access local variable {name!r} where it is not associated with a value"
        )
    frame.push(frame.localsplus[name])


@register_opcode_handler("LOAD_FAST_AND_CLEAR")
def _load_fast_and_clear(frame, ins, i):
    frame.push(frame.localsplus.pop(ins.argval, _MISSING))


_MISSING = object()


@register_opcode_handler("STORE_FAST")
def _store_fast(frame, ins, i):
    v = frame.pop()
    if v is _MISSING:
        frame.localsplus.pop(ins.argval, None)
    else:
        frame.localsplus[ins.argval] = v


@register_opcode_handler("DELETE_FAST")
def _delete_fast(frame, ins, i):
    frame.localsplus.pop(ins.argval, None)


@register_opcode_handler("LOAD_GLOBAL")
def _load_global(frame, ins, i):
    name = ins.argval
    push_null = bool(ins.arg & 1)
    if name in frame.globals_:
        v = frame.globals_[name]
        rec = _global_record(frame, name)
        if rec is not None:
            v = frame.ctx.record_read(rec, v)
            frame.ctx.track(v, rec)
    elif name in frame.builtins_:
        v = frame.builtins_[name]  # builtins are not guarded (stable)
    else:
        raise NameError(f"name {name!r} is not defined")
    if push_null:
        # 3.12 layout: NULL below the callable ([NULL, callable, args...])
        frame.push(_NULL)
        frame.push(v)
    else:
        frame.push(v)


@register_opcode_handler("LOAD_NAME")
def _load_name(frame, ins, i):
    name = ins.argval
    if name in frame.localsplus:
        frame.push(frame.localsplus[name])
    elif name in frame.globals_:
        rec = ProvenanceRecord(PseudoInst.LOAD_GLOBAL, key=name)
        v = frame.ctx.record_read(rec, frame.globals_[name])
        frame.ctx.track(v, rec)
        frame.push(v)
    elif name in frame.builtins_:
        frame.push(frame.builtins_[name])
    else:
        raise NameError(f"name {name!r} is not defined")


def _tracked_frame_globals(frame) -> dict:
    """globals() inside interpreted code: returns the real frame globals,
    TRACKED so item reads off it guard.  Root-frame globals root at the
    prologue's own globals dict; helper frames use the module-qualified
    root; un-relocatable namespaces return untracked (reads bake, as
    before)."""
    g = frame.globals_
    ctx = frame.ctx
    if ctx.prov_of(g) is None:
        if g is ctx.root_globals:
            ctx.track(g, ProvenanceRecord(PseudoInst.GLOBALS_DICT))
        else:
            modname = g.get("__name__")
            if (isinstance(modname, str)
                    and getattr(sys.modules.get(modname), "__dict__", None) is g):
                ctx.track(g, ProvenanceRecord(PseudoInst.GLOBALS_DICT, key=modname))
    return g


def _global_record(frame, name: str) -> "ProvenanceRecord | None":
    """Provenance for a LOAD_GLOBAL.  The TRACED fn's own globals use the
    bare-name root (the prologue holds that exact dict); globals of OTHER
    interpreted modules (helpers called through) qualify with the module
    name and re-resolve via sys.modules at prologue time.  A namespace the
    prologue cannot re-locate (exec'd dict, mismatched __name__) records
    nothing — unguarded rather than a guaranteed prologue KeyError."""
    ctx = frame.ctx
    if frame.globals_ is ctx.root_globals:
        return ProvenanceRecord(PseudoInst.LOAD_GLOBAL, key=name)
    modname = frame.globals_.get("__name__")
    if (
        isinstance(modname, str)
        and getattr(sys.modules.get(modname), "__dict__", None) is frame.globals_
    ):
        return ProvenanceRecord(PseudoInst.LOAD_GLOBAL, key=(modname, name))
    return None


@register_opcode_handler("LOAD_DEREF")
def _load_deref(frame, ins, i):
    name = ins.argval
    cell = frame.cells.get(name)
    if cell is None:
        # a MAKE_CELL local promoted to a cell in this frame
        if name in frame.localsplus:
            frame.push(frame.localsplus[name])
            return None
        raise NameError(
            f"cannot access free variable {name!r} where it is not associated "
            "with a value in enclosing scope"
        )
    def contents():
        try:
            return cell.cell_contents
        except ValueError:
            raise NameError(
                f"cannot access free variable {name!r} where it is not "
                "associated with a value in enclosing scope"
            ) from None

    if frame.depth == 0:
        # the ROOT function's closure is re-locatable via fn.__closure__
        rec = ProvenanceRecord(PseudoInst.LOAD_DEREF, key=name)
        v = frame.ctx.record_read(rec, contents())
        frame.ctx.track(v, rec)
        frame.push(v)
    elif frame.fn_prov is not None and name in frame.code.co_freevars:
        # a provenance-tracked callee (e.g. a factory-made helper loaded from
        # globals): its cells ARE re-locatable —
        # <fn>.__closure__[idx].cell_contents — so record/guard/proxy them
        idx = frame.code.co_freevars.index(name)
        rec = ProvenanceRecord(
            PseudoInst.LOAD_ATTR,
            inputs=(
                ProvenanceRecord(
                    PseudoInst.BINARY_SUBSCR,
                    inputs=(
                        ProvenanceRecord(PseudoInst.LOAD_ATTR, inputs=(frame.fn_prov,), key="__closure__"),
                    ),
                    key=idx,
                ),
            ),
            key="cell_contents",
        )
        v = frame.ctx.record_read(rec, contents())
        frame.ctx.track(v, rec)
        frame.push(v)
    else:
        # trace-local cell (MAKE_FUNCTION inside the traced code)
        frame.push(contents())


@register_opcode_handler("STORE_DEREF")
def _store_deref(frame, ins, i):
    name = ins.argval
    v = frame.pop()
    if name in frame.cells:
        frame.cells[name].cell_contents = v
    else:
        frame.localsplus[name] = v


@register_opcode_handler("LOAD_ATTR")
def _load_attr(frame, ins, i):
    obj = frame.pop()
    name = ins.argval
    is_method = bool(ins.arg & 1)
    base_rec = frame.ctx.prov_of(obj)
    try:
        v = getattr(obj, name)
    except AttributeError:
        # EAFP miss (`try: o.a except AttributeError:`): guard the observed
        # absence so adding the attribute later retraces instead of
        # replaying the baked handler branch
        if base_rec is not None:
            frame.ctx.record_read(ProvenanceRecord(PseudoInst.ABSENT_ATTR, inputs=(base_rec,), key=name), True)
        raise
    if base_rec is not None:
        v = _tracked_read(frame.ctx, base_rec, name, v, is_attr=True, container=obj)
    if is_method:
        # getattr already bound the method, so use the plain-call layout
        # ([NULL, callable]) — CALL accepts either convention
        frame.push(_NULL)
        frame.push(v)
    else:
        frame.push(v)


@register_opcode_handler("LOAD_SUPER_ATTR")
def _load_super_attr(frame, ins, i):
    """3.12 super() access: pops (self, class, the global ``super``); oparg
    bit 0 = method form (push [NULL, bound] like LOAD_ATTR), bit 1 = the
    source spelled a two-argument ``super(cls, self)``; name = arg >> 2
    (dis resolves ``argval`` already)."""
    self_obj = frame.pop()
    cls = frame.pop()
    sup = frame.pop()  # usually builtins.super, but it may be shadowed
    if sup is super:
        obj = super(cls, self_obj)
    else:
        # oparg bit 2: the source spelled two-argument super(cls, self);
        # otherwise CPython calls a shadowing super with NO arguments
        obj = sup(cls, self_obj) if ins.arg & 2 else sup()
    v = getattr(obj, ins.argval)
    if ins.arg & 1:
        # getattr already bound, so plain-call layout ([NULL, callable])
        frame.push(_NULL)
        frame.push(v)
    else:
        frame.push(v)


@register_opcode_handler("LOAD_ASSERTION_ERROR")
def _load_assertion_error(frame, ins, i):
    frame.push(AssertionError)


@register_opcode_handler("STORE_GLOBAL")
def _store_global(frame, ins, i):
    v = frame.pop()
    from thunder_tpu_torch.core.trace import get_tracectx

    if get_tracectx() is not None:
        # a trace-time global store is NOT replayed on cache hits (the
        # compiled program never re-executes it) and invalidates any guard on
        # the same name — refuse instead of silently diverging from eager
        raise InterpreterError(
            f"writing the global {ins.argval!r} during tracing is not supported "
            f"(the store would not replay on cache hits); return the value or "
            f"pass state explicitly"
        )
    frame.globals_[ins.argval] = v


@register_opcode_handler("DELETE_GLOBAL")
def _delete_global(frame, ins, i):
    from thunder_tpu_torch.core.trace import get_tracectx

    if get_tracectx() is not None:
        # same non-replay contract as STORE_GLOBAL: the compiled program
        # would never re-execute the delete on cache hits
        raise InterpreterError(
            f"deleting the global {ins.argval!r} during tracing is not supported "
            f"(the delete would not replay on cache hits)"
        )
    try:
        del frame.globals_[ins.argval]
    except KeyError:
        raise NameError(f"name {ins.argval!r} is not defined") from None


@register_opcode_handler("DELETE_NAME")
def _delete_name(frame, ins, i):
    # CPython DELETE_NAME deletes from the LOCAL namespace only (unlike
    # LOAD_NAME, which falls back to globals on reads)
    name = ins.argval
    if name in frame.localsplus:
        del frame.localsplus[name]
        return
    raise NameError(f"name {name!r} is not defined")


@register_opcode_handler("DELETE_ATTR")
def _delete_attr(frame, ins, i):
    obj = frame.pop()
    delattr(obj, ins.argval)
    _record_external_write(frame, obj, "attr", ins.argval)


@register_opcode_handler("DELETE_DEREF")
def _delete_deref(frame, ins, i):
    name = ins.argval
    if name in frame.cells:
        cell = frame.cells[name]
        try:
            cell.cell_contents  # raises ValueError when already unbound
        except ValueError:
            raise NameError(f"name {name!r} is not defined") from None
        del cell.cell_contents
        return
    try:
        del frame.localsplus[name]
    except KeyError:
        raise NameError(f"name {name!r} is not defined") from None


#
# match statements (3.12 structural pattern matching)
#


@register_opcode_handler("GET_LEN")
def _get_len(frame, ins, i):
    frame.push(len(frame.stack[-1]))


@register_opcode_handler("MATCH_SEQUENCE")
def _match_sequence(frame, ins, i):
    from collections.abc import Sequence

    v = frame.stack[-1]
    frame.push(isinstance(v, Sequence) and not isinstance(v, (str, bytes, bytearray)))


@register_opcode_handler("MATCH_MAPPING")
def _match_mapping(frame, ins, i):
    from collections.abc import Mapping

    frame.push(isinstance(frame.stack[-1], Mapping))


_MATCH_MISSING = object()

# builtins with Py_TPFLAGS_MATCH_SELF: `case int(n)` binds the subject itself
_SELF_MATCH_TYPES = (bool, bytearray, bytes, dict, float, frozenset, int, list, set, str, tuple)


@register_opcode_handler("MATCH_KEYS")
def _match_keys(frame, ins, i):
    # stack [subject, keys] → [subject, keys, values-tuple | None].  CPython
    # probes with .get(key, sentinel) — NOT __getitem__ — so __missing__
    # (defaultdict) neither fires nor mutates the subject
    keys = frame.stack[-1]
    subject = frame.stack[-2]
    base_rec = frame.ctx.prov_of(subject)
    values = []
    for k in keys:
        v = subject.get(k, _MATCH_MISSING)
        if v is _MATCH_MISSING:
            if base_rec is not None:
                # a FAILED match against guarded state must also guard: read
                # the whole subject so a later key insertion retraces instead
                # of replaying the baked no-match branch
                frame.ctx.record_read(base_rec, subject)
            frame.push(None)
            return
        if base_rec is not None:
            # destructured reads guard/proxify like BINARY_SUBSCR would
            rec = ProvenanceRecord(PseudoInst.BINARY_SUBSCR, inputs=(base_rec,), key=k)
            v = frame.ctx.record_read(rec, v)
            frame.ctx.track(v, rec)
        values.append(v)
    frame.push(tuple(values))


@register_opcode_handler("MATCH_CLASS")
def _match_class(frame, ins, i):
    # stack [subject, cls, kw-names] → [values-tuple | None]; arg = count of
    # positional sub-patterns (bound via cls.__match_args__)
    kw_names = frame.pop()
    cls = frame.pop()
    subject = frame.pop()
    n_pos = ins.arg or 0
    base_rec = frame.ctx.prov_of(subject)
    if not isinstance(subject, cls):
        if base_rec is not None:
            frame.ctx.record_read(base_rec, subject)  # guard the failed match
        frame.push(None)
        return

    def read_attr(name):
        v = getattr(subject, name)
        if base_rec is not None:
            # destructured reads guard/proxify like LOAD_ATTR would
            rec = ProvenanceRecord(PseudoInst.LOAD_ATTR, inputs=(base_rec,), key=name)
            v = frame.ctx.record_read(rec, v)
            frame.ctx.track(v, rec)
        return v

    try:
        attrs = []
        seen: set = set()
        match_args = getattr(cls, "__match_args__", ())
        if n_pos > len(match_args):
            # self-matching builtins (Py_TPFLAGS_MATCH_SELF, inherited by
            # subclasses): `case int(n)` binds the subject itself
            if issubclass(cls, _SELF_MATCH_TYPES) and not match_args and n_pos == 1:
                attrs.append(subject)
            else:
                raise TypeError(
                    f"{cls.__name__}() accepts {len(match_args)} positional "
                    f"sub-patterns ({n_pos} given)"
                )
        else:
            for name in match_args[:n_pos]:
                seen.add(name)
                attrs.append(read_attr(name))
        for name in kw_names:
            if name in seen:
                raise TypeError(f"{cls.__name__}() got multiple sub-patterns for attribute {name!r}")
            attrs.append(read_attr(name))
        frame.push(tuple(attrs))
    except AttributeError:
        frame.push(None)


@register_opcode_handler("STORE_ATTR")
def _store_attr(frame, ins, i):
    obj = frame.pop()
    v = frame.pop()
    from thunder_tpu_torch.core.proxies import Proxy

    if frame.ctx.prov_of(obj) is not None and isinstance(v, Proxy):
        raise InterpreterError(
            f"storing a traced tensor into external state ({frame.ctx.prov_of(obj)}.{ins.argval}) "
            f"is not supported; pass the state as an explicit argument (epilogue handles those)"
        )
    setattr(obj, ins.argval, v)
    _record_external_write(frame, obj, "attr", ins.argval)


@register_opcode_handler("BINARY_SUBSCR")
def _binary_subscr(frame, ins, i):
    k = frame.pop()
    obj = frame.pop()
    base_rec = frame.ctx.prov_of(obj)
    try:
        v = obj[k]
    except (KeyError, IndexError):
        # EAFP miss (`try: d[k] except KeyError:`): guard the observed
        # absence (mapping-like only) so inserting the key later retraces
        # instead of replaying the baked handler branch
        if base_rec is not None and _is_mappinglike(obj) and _guardable_key(k):
            frame.ctx.record_read(ProvenanceRecord(PseudoInst.ABSENT_ITEM, inputs=(base_rec,), key=k), True)
        raise
    if base_rec is not None and _guardable_key(k):
        v = _tracked_read(frame.ctx, base_rec, k, v, is_attr=False, container=obj)
    frame.push(v)


@register_opcode_handler("STORE_SUBSCR")
def _store_subscr(frame, ins, i):
    from thunder_tpu_torch.core.proxies import Proxy

    k = frame.pop()
    obj = frame.pop()
    v = frame.pop()
    if frame.ctx.prov_of(obj) is not None and isinstance(v, Proxy):
        raise InterpreterError(
            f"storing a traced tensor into external state ({frame.ctx.prov_of(obj)}[{k!r}]) "
            f"is not supported; pass the state as an explicit argument (epilogue handles those)"
        )
    obj[k] = v
    _record_external_write(frame, obj, "item", k)  # after: a failed write is no write


@register_opcode_handler("DELETE_SUBSCR")
def _delete_subscr(frame, ins, i):
    k = frame.pop()
    obj = frame.pop()
    del obj[k]
    _record_external_write(frame, obj, "item", k)


@register_opcode_handler("BINARY_SLICE")
def _binary_slice(frame, ins, i):
    end = frame.pop()
    start = frame.pop()
    obj = frame.pop()
    frame.push(obj[slice(start, end)])


@register_opcode_handler("STORE_SLICE")
def _store_slice(frame, ins, i):
    from thunder_tpu_torch.core.proxies import Proxy

    end = frame.pop()
    start = frame.pop()
    obj = frame.pop()
    v = frame.pop()
    if frame.ctx.prov_of(obj) is not None and (
        isinstance(v, Proxy)
        or (isinstance(v, (list, tuple)) and any(isinstance(e, Proxy) for e in v))
    ):
        raise InterpreterError(
            f"storing a traced tensor into external state ({frame.ctx.prov_of(obj)}[{start!r}:{end!r}]) "
            f"is not supported; pass the state as an explicit argument (epilogue handles those)"
        )
    obj[slice(start, end)] = v
    # key=None: a slice write can touch any range of the container, so every
    # guard under it must re-evaluate (same contract as STORE_SUBSCR with an
    # unguardable key); after the assignment — a failed write is no write
    _record_external_write(frame, obj, "item", None)


@register_opcode_handler("BUILD_SLICE")
def _build_slice(frame, ins, i):
    if ins.arg == 3:
        step = frame.pop()
        stop = frame.pop()
        start = frame.pop()
        frame.push(slice(start, stop, step))
    else:
        stop = frame.pop()
        start = frame.pop()
        frame.push(slice(start, stop))


# NB_INPLACE arg → the dunder that mutated (for the write record/refusal)
_INPLACE_OP_NAMES = {
    13: "__iadd__", 14: "__iand__", 15: "__ifloordiv__", 16: "__ilshift__",
    17: "__imatmul__", 18: "__imul__", 19: "__imod__", 20: "__ior__",
    21: "__ipow__", 22: "__irshift__", 23: "__isub__", 24: "__itruediv__",
    25: "__ixor__",
}


@register_opcode_handler("BINARY_OP")
def _binary_op(frame, ins, i):
    b = frame.pop()
    a = frame.pop()
    # in-place op on a TRACKED container through a local alias
    # (`lst = CFG['lst']; lst += [x]`) mutates external state without a
    # STORE_* opcode or a visible method call: when the in-place result IS
    # the same (mutated) object, record the write like _record_method_mutation
    # would for the equivalent `lst.extend(x)` — incl. the module-globals
    # refusal (`g = globals(); g |= ...` must not dodge STORE_GLOBAL's ban;
    # checked BEFORE the op runs so the real module dict is never touched)
    op_name = _INPLACE_OP_NAMES.get(ins.arg)
    if op_name is not None and frame.ctx.prov_of(a) is not None and _is_module_globals(frame.ctx, a):
        raise InterpreterError(
            f"mutating module globals via {op_name} during tracing is "
            f"not supported (the store would not replay on cache "
            f"hits); return the value or pass state explicitly"
        )
    r = _nb_op(ins.arg, a, b)
    if op_name is not None and r is a:
        base_rec = frame.ctx.prov_of(a)
        if base_rec is not None:
            _add_write(frame.ctx, (base_rec, "method", op_name),
                       f"{base_rec}.{op_name}(...)")
    frame.push(r)


@register_opcode_handler("UNARY_NEGATIVE")
def _unary_negative(frame, ins, i):
    frame.push(-frame.pop())


@register_opcode_handler("UNARY_NOT")
def _unary_not(frame, ins, i):
    frame.push(not frame.pop())


@register_opcode_handler("UNARY_INVERT")
def _unary_invert(frame, ins, i):
    frame.push(~frame.pop())


@register_opcode_handler("COMPARE_OP")
def _compare_op(frame, ins, i):
    import operator as op

    b = frame.pop()
    a = frame.pop()
    cmp = {"<": op.lt, "<=": op.le, "==": op.eq, "!=": op.ne, ">": op.gt, ">=": op.ge}[ins.argval]
    frame.push(cmp(a, b))


@register_opcode_handler("IS_OP")
def _is_op(frame, ins, i):
    b = frame.pop()
    a = frame.pop()
    frame.push((a is not b) if ins.arg else (a is b))


@register_opcode_handler("CONTAINS_OP")
def _contains_op(frame, ins, i):
    b = frame.pop()
    a = frame.pop()
    found = a in b
    # membership on guarded state is a branch condition: guard the observed
    # presence/absence of the key so inserting (or removing) it retraces
    # instead of replaying the baked branch
    if _guardable_key(a):
        base_rec = frame.ctx.prov_of(b)
        if base_rec is not None:
            # dict `in` tests KEYS (same namespace as getitem/unpack, so the
            # guard can be subsumed by an unpack through the key); sequence
            # `in` tests VALUES — a distinct *_member step that unpacks
            # through an INDEX must never subsume
            if _is_mappinglike(b):
                inst = PseudoInst.PRESENT_ITEM if found else PseudoInst.ABSENT_ITEM
            else:
                inst = PseudoInst.PRESENT_MEMBER if found else PseudoInst.ABSENT_MEMBER
            rec = ProvenanceRecord(inst, inputs=(base_rec,), key=a)
            frame.ctx.record_read(rec, True)
    frame.push((not found) if ins.arg else found)


@register_opcode_handler("POP_TOP")
def _pop_top(frame, ins, i):
    frame.pop()


@register_opcode_handler("COPY")
def _copy(frame, ins, i):
    frame.push(frame.stack[-ins.arg])


@register_opcode_handler("SWAP")
def _swap(frame, ins, i):
    frame.stack[-1], frame.stack[-ins.arg] = frame.stack[-ins.arg], frame.stack[-1]


@register_opcode_handler("PUSH_NULL")
def _push_null(frame, ins, i):
    frame.push(_NULL)


@register_opcode_handler("BUILD_TUPLE")
def _build_tuple(frame, ins, i):
    vals = frame.stack[len(frame.stack) - ins.arg :] if ins.arg else []
    del frame.stack[len(frame.stack) - ins.arg :]
    frame.push(tuple(vals))


@register_opcode_handler("BUILD_LIST")
def _build_list(frame, ins, i):
    vals = frame.stack[len(frame.stack) - ins.arg :] if ins.arg else []
    del frame.stack[len(frame.stack) - ins.arg :]
    frame.push(list(vals))


@register_opcode_handler("BUILD_SET")
def _build_set(frame, ins, i):
    vals = frame.stack[len(frame.stack) - ins.arg :] if ins.arg else []
    del frame.stack[len(frame.stack) - ins.arg :]
    frame.push(set(vals))


@register_opcode_handler("BUILD_MAP")
def _build_map(frame, ins, i):
    d = {}
    pairs = frame.stack[len(frame.stack) - 2 * ins.arg :] if ins.arg else []
    del frame.stack[len(frame.stack) - 2 * ins.arg :]
    for j in range(0, len(pairs), 2):
        d[pairs[j]] = pairs[j + 1]
    frame.push(d)


@register_opcode_handler("BUILD_CONST_KEY_MAP")
def _build_const_key_map(frame, ins, i):
    keys = frame.pop()
    vals = frame.stack[len(frame.stack) - ins.arg :]
    del frame.stack[len(frame.stack) - ins.arg :]
    frame.push(dict(zip(keys, vals)))


@register_opcode_handler("LIST_APPEND")
def _list_append(frame, ins, i):
    v = frame.pop()
    frame.stack[-ins.arg].append(v)


@register_opcode_handler("LIST_EXTEND")
def _list_extend(frame, ins, i):
    v = frame.pop()
    frame.stack[-ins.arg].extend(v)


@register_opcode_handler("SET_ADD")
def _set_add(frame, ins, i):
    v = frame.pop()
    frame.stack[-ins.arg].add(v)


@register_opcode_handler("SET_UPDATE")
def _set_update(frame, ins, i):
    v = frame.pop()
    frame.stack[-ins.arg].update(v)


@register_opcode_handler("MAP_ADD")
def _map_add(frame, ins, i):
    v = frame.pop()
    k = frame.pop()
    frame.stack[-ins.arg][k] = v


@register_opcode_handler("DICT_UPDATE")
@register_opcode_handler("DICT_MERGE")
def _dict_update(frame, ins, i):
    v = frame.pop()
    frame.stack[-ins.arg].update(v)


@register_opcode_handler("UNPACK_SEQUENCE")
def _unpack_sequence(frame, ins, i):
    seq = list(frame.pop())
    if len(seq) != ins.arg:
        raise InterpreterError(f"cannot unpack {len(seq)} values into {ins.arg}")
    for v in reversed(seq):
        frame.push(v)


@register_opcode_handler("UNPACK_EX")
def _unpack_ex(frame, ins, i):
    before = ins.arg & 0xFF
    after = ins.arg >> 8
    seq = list(frame.pop())
    rest = seq[before : len(seq) - after if after else None]
    tail = seq[len(seq) - after :] if after else []
    for v in reversed(tail):
        frame.push(v)
    frame.push(rest)
    for v in reversed(seq[:before]):
        frame.push(v)


@register_opcode_handler("FORMAT_VALUE")
def _format_value(frame, ins, i):
    flags = ins.arg
    fmt_spec = frame.pop() if flags & 0x04 else ""
    v = frame.pop()
    conv = flags & 0x03
    if conv == 1:
        v = str(v)
    elif conv == 2:
        v = repr(v)
    elif conv == 3:
        v = ascii(v)
    frame.push(format(v, fmt_spec))


@register_opcode_handler("BUILD_STRING")
def _build_string(frame, ins, i):
    parts = frame.stack[len(frame.stack) - ins.arg :]
    del frame.stack[len(frame.stack) - ins.arg :]
    frame.push("".join(parts))


@register_opcode_handler("JUMP_FORWARD")
@register_opcode_handler("JUMP_BACKWARD")
@register_opcode_handler("JUMP_BACKWARD_NO_INTERRUPT")
def _jump(frame, ins, i):
    return frame.jump_to_offset(ins.argval)


def _truthy(v) -> bool:
    from thunder_tpu_torch.core.proxies import NumberProxy, TensorProxy

    if isinstance(v, TensorProxy):
        raise InterpreterError(
            "data-dependent control flow: branching on a traced tensor's value; "
            "use torch.where-style ops instead"
        )
    if isinstance(v, NumberProxy):
        pv = v.value
        if pv is None:
            raise InterpreterError("branching on an unknown traced number (item() result)")
        return bool(pv)
    return bool(v)


@register_opcode_handler("POP_JUMP_IF_TRUE")
def _pjit(frame, ins, i):
    return frame.jump_to_offset(ins.argval) if _truthy(frame.pop()) else None


@register_opcode_handler("POP_JUMP_IF_FALSE")
def _pjif(frame, ins, i):
    return None if _truthy(frame.pop()) else frame.jump_to_offset(ins.argval)


@register_opcode_handler("POP_JUMP_IF_NONE")
def _pjin(frame, ins, i):
    return frame.jump_to_offset(ins.argval) if frame.pop() is None else None


@register_opcode_handler("POP_JUMP_IF_NOT_NONE")
def _pjinn(frame, ins, i):
    return None if frame.pop() is None else frame.jump_to_offset(ins.argval)


@register_opcode_handler("GET_ITER")
def _get_iter(frame, ins, i):
    from thunder_tpu_torch.core.proxies import TensorProxy

    v = frame.pop()
    if isinstance(v, TensorProxy):
        # iterate the leading dim (torch semantics) — static shape, so the
        # loop unrolls at trace time
        frame.push(iter([v[j] for j in range(v.shape[0])]))
        return
    # iterating TRACKED state unrolls the loop over the observed contents,
    # so the contents must guard: per-element reads + len for sequences,
    # the key tuple (set + order) for dicts — otherwise `for x in CFG_LIST`
    # bakes stale elements with no retrace
    elems = _read_elements(frame.ctx, v)
    if elems is not None:
        frame.push(iter(elems))
        return
    if isinstance(v, dict):
        keys = _read_keys(frame.ctx, v)
        if keys is not None:
            frame.push(iter(keys))
            return
    frame.push(iter(v))


@register_opcode_handler("FOR_ITER")
def _for_iter(frame, ins, i):
    it = frame.stack[-1]
    try:
        frame.push(next(it))
        return None
    except StopIteration:
        frame.pop()  # the exhausted iterator; jump past the END_FOR
        return frame.jump_to_offset(ins.argval) + 1


@register_opcode_handler("END_FOR")
def _end_for(frame, ins, i):
    # reached only via fallthrough in our FOR_ITER scheme (which skips it);
    # defensive no-op for odd codegen
    return None


@register_opcode_handler("KW_NAMES")
def _kw_names(frame, ins, i):
    frame.kw_names = ins.argval
    return None


@register_opcode_handler("CALL")
def _call(frame, ins, i):
    argc = ins.arg
    kw = frame.kw_names or ()
    frame.kw_names = ()
    args = frame.stack[len(frame.stack) - argc :] if argc else []
    del frame.stack[len(frame.stack) - argc :]
    b = frame.pop()  # self-or-NULL... actually the callable when a is NULL
    a = frame.pop()  # [a, b, args...]: a = callable-or-NULL, b = self-or-callable
    if a is _NULL:
        fn = b  # plain call: [NULL, callable, args...]
    elif b is _NULL:
        fn = a  # bound-method pushed via our LOAD_ATTR layout
    elif callable(a):
        fn = a  # method call: [callable, self, args...] — None is a real self
        args = [b, *args]
    else:  # pragma: no cover - malformed stack
        raise InterpreterError(f"CALL could not resolve a callable from ({type(a)}, {type(b)})")
    kwargs = {}
    if kw:
        n_kw = len(kw)
        kw_vals = args[len(args) - n_kw :]
        args = args[: len(args) - n_kw]
        kwargs = dict(zip(kw, kw_vals))
    if fn is globals and not args and not kwargs:
        # the calling FRAME's globals dict, tracked so reads off it guard
        # exactly like direct LOAD_GLOBALs (globals()['x'] is just the
        # functional spelling)
        frame.push(_tracked_frame_globals(frame))
        return
    frame.push(_call_value(frame.ctx, frame.depth, fn, tuple(args), kwargs))


@register_opcode_handler("CALL_FUNCTION_EX")
def _call_function_ex(frame, ins, i):
    kwargs = frame.pop() if ins.arg & 1 else {}
    args = frame.pop()
    fn = frame.pop()
    if frame.stack and frame.stack[-1] is _NULL:
        frame.pop()  # NULL slot
    if fn is globals and not args and not kwargs:
        frame.push(_tracked_frame_globals(frame))
        return
    frame.push(_call_value(frame.ctx, frame.depth, fn, tuple(args), dict(kwargs)))


@register_opcode_handler("CALL_INTRINSIC_1")
def _call_intrinsic_1(frame, ins, i):
    v = frame.pop()
    if ins.arg == 5:  # UNARY_POSITIVE
        frame.push(+v)
    elif ins.arg == 6:  # LIST_TO_TUPLE
        frame.push(tuple(v))
    elif ins.arg == 3:  # STOPITERATION_ERROR (PEP 479 in generator frames)
        if isinstance(v, StopIteration):
            e = RuntimeError("generator raised StopIteration")
            e.__cause__ = v
            frame.push(e)
        else:
            frame.push(v)
    elif ins.arg == 4:  # ASYNC_GEN_WRAP: tag a ``yield`` in an async generator
        frame.push(_AsyncGenWrapped(v))
    # PEP 695 generic syntax (def f[T](...), type Alias[U] = ...).  The
    # compiler passes lazy compute-functions for bounds/constraints/alias
    # values; the interpreter evaluates them eagerly (it does not model
    # CPython's deferred evaluation)
    elif ins.arg == 7:  # TYPEVAR
        import typing

        frame.push(typing.TypeVar(v, infer_variance=True))
    elif ins.arg == 8:  # PARAMSPEC
        import typing

        frame.push(typing.ParamSpec(v))
    elif ins.arg == 9:  # TYPEVARTUPLE
        import typing

        frame.push(typing.TypeVarTuple(v))
    elif ins.arg == 10:  # SUBSCRIPT_GENERIC
        import typing

        frame.push(typing.Generic[v])
    elif ins.arg == 11:  # TYPEALIAS: (name, type_params, value-or-compute-fn)
        import typing

        name, type_params, value = v
        if callable(value) and not isinstance(value, type):
            value = value()
        frame.push(typing.TypeAliasType(name, value, type_params=type_params or ()))
    else:
        raise InterpreterError(f"CALL_INTRINSIC_1 {ins.arg} is not supported")


@register_opcode_handler("LOAD_BUILD_CLASS")
def _load_build_class(frame, ins, i):
    # class statement: [NULL, __build_class__, body_fn, name, *bases] — the
    # host builtin runs the MAKE_FUNCTION-synthesized body (a real function
    # over the original code object), so class creation is CPython-exact
    frame.push(_builtins.__build_class__)


@register_opcode_handler("CHECK_EG_MATCH")
def _check_eg_match(frame, ins, i):
    # except* matching (PEP 654): pop match_type and the active exception,
    # push (rest, match).  Group exceptions split; a naked exception that
    # matches is wrapped into a group for the handler (CPython
    # exception_group_match semantics)
    typ = frame.pop()
    exc = frame.pop()
    for t in (typ if isinstance(typ, tuple) else (typ,)):
        if isinstance(t, type) and issubclass(t, BaseExceptionGroup):
            raise TypeError(
                "catching ExceptionGroup with except* is not allowed. Use except instead."
            )
    if isinstance(exc, BaseExceptionGroup):
        match, rest = exc.split(typ)
    elif isinstance(exc, typ if isinstance(typ, tuple) else (typ,)):
        wrap = ExceptionGroup if isinstance(exc, Exception) else BaseExceptionGroup
        match, rest = wrap("", [exc]), None
    else:
        match, rest = None, exc
    frame.push(rest)
    frame.push(match)


def _prep_reraise_star(orig: BaseException, excs: list):
    """CALL_INTRINSIC_2 INTRINSIC_PREP_RERAISE_STAR: combine the unmatched
    rest subgroups and handler-raised exceptions into the exception to
    re-raise after an except* chain (None = fully handled).  Metadata
    (cause/context/traceback) carries over from the original exception."""
    res = [e for e in excs if e is not None]
    if not res:
        return None
    if len(res) == 1:
        out = res[0]
    else:
        wrap = ExceptionGroup if all(isinstance(e, Exception) for e in res) else BaseExceptionGroup
        out = wrap("", res)
        out.__cause__ = orig.__cause__
        out.__context__ = orig.__context__
    if out.__traceback__ is None:
        out.__traceback__ = orig.__traceback__
    return out


@register_opcode_handler("CALL_INTRINSIC_2")
def _call_intrinsic_2(frame, ins, i):
    b = frame.pop()
    a = frame.pop()
    if ins.arg == 1:  # PREP_RERAISE_STAR(orig, excs_list)
        frame.push(_prep_reraise_star(a, b))
    elif ins.arg == 2:  # TYPEVAR_WITH_BOUND(name, bound-or-compute-fn)
        import typing

        if callable(b) and not isinstance(b, type):
            b = b()
        frame.push(typing.TypeVar(a, bound=b, infer_variance=True))
    elif ins.arg == 3:  # TYPEVAR_WITH_CONSTRAINTS(name, constraints-or-compute-fn)
        import typing

        if callable(b) and not isinstance(b, tuple):
            b = b()
        frame.push(typing.TypeVar(a, *b, infer_variance=True))
    elif ins.arg == 4:  # SET_FUNCTION_TYPE_PARAMS(fn, type_params)
        a.__type_params__ = b
        frame.push(a)
    else:
        raise InterpreterError(f"CALL_INTRINSIC_2 {ins.arg} is not supported")


@register_opcode_handler("MAKE_FUNCTION")
def _make_function(frame, ins, i):
    code = frame.pop()
    flags = ins.arg or 0
    closure = frame.pop() if flags & 0x08 else None
    annotations = frame.pop() if flags & 0x04 else None
    kwdefaults = frame.pop() if flags & 0x02 else None
    defaults = frame.pop() if flags & 0x01 else None
    fn = types.FunctionType(code, frame.globals_, code.co_name, defaults, closure)
    if kwdefaults:
        fn.__kwdefaults__ = kwdefaults
    frame.push(fn)


@register_opcode_handler("LOAD_CLOSURE")
def _load_closure(frame, ins, i):
    name = ins.argval
    cell = frame.cells.get(name)
    if cell is None:
        # an unassigned local must become an EMPTY cell (reading it raises),
        # not a cell holding None
        if name in frame.localsplus:
            cell = types.CellType(frame.localsplus[name])
        else:
            cell = types.CellType()
        frame.cells[name] = cell
    frame.push(cell)


@register_opcode_handler("IMPORT_NAME")
def _import_name(frame, ins, i):
    fromlist = frame.pop()
    level = frame.pop()
    mod = __import__(ins.argval, frame.globals_, None, fromlist, level)
    # track the module so attribute reads off it guard: natively, an
    # in-function import re-reads module state EVERY call — a baked value
    # with no guard would replay stale after the module mutates
    if isinstance(mod, types.ModuleType):
        modname = getattr(mod, "__name__", None)
        if isinstance(modname, str) and sys.modules.get(modname) is mod:
            frame.ctx.track(mod, ProvenanceRecord(PseudoInst.MODULE, key=modname))
    frame.push(mod)


@register_opcode_handler("IMPORT_FROM")
def _import_from(frame, ins, i):
    mod = frame.stack[-1]
    name = ins.argval
    v = getattr(mod, name)
    base_rec = frame.ctx.prov_of(mod)
    if base_rec is not None:
        v = _tracked_read(frame.ctx, base_rec, name, v, is_attr=True, container=mod)
    frame.push(v)


def _is_module_globals(ctx, obj) -> bool:
    if not isinstance(obj, dict):
        return False
    if obj is ctx.root_globals:
        return True
    modname = obj.get("__name__")
    return (isinstance(modname, str)
            and getattr(sys.modules.get(modname), "__dict__", None) is obj)


def _record_external_write(frame, obj, kind: str, key) -> None:
    """A write into TRACKED external state happens once, at trace time (like
    any Python side effect under constant-values caching) — record it so the
    general jit drops the read guards it supersedes, and surface it through
    the sharp-edges policy.  Writes THROUGH a module-globals dict (reached
    via globals()/module __dict__) are refused outright, matching
    STORE_GLOBAL's contract — the functional spelling must not be a
    loophole."""
    base_rec = frame.ctx.prov_of(obj)
    if base_rec is None:
        return
    if _is_module_globals(frame.ctx, obj):
        raise InterpreterError(
            f"writing the global {key!r} during tracing is not supported "
            f"(the store would not replay on cache hits); return the value or "
            f"pass state explicitly"
        )
    entry = (base_rec, kind, key if kind == "attr" or _guardable_key(key) else None)
    _add_write(frame.ctx, entry,
               f"{base_rec}[{key!r}]" if kind == "item" else f"{base_rec}.{key}")


def _add_write(ctx: InterpreterCompileCtx, entry: tuple, desc: str) -> None:
    """Dedups a trace-time external write and surfaces it once through the
    sharp-edges policy (shared by opcode writes and mutating methods)."""
    if entry in ctx.writes:
        return
    ctx.writes.add(entry)
    try:
        from thunder_tpu_torch.core.compile_data import get_compile_data
        from thunder_tpu_torch.core.sharp_edges import report_external_write

        cd = get_compile_data()
        if cd is not None:
            report_external_write(cd.sharp_edges, desc)
    except ImportError:  # pragma: no cover
        pass


def _chain_context(frame, exc: BaseException) -> BaseException:
    """Implicit exception chaining (CPython _PyErr_SetObject): an exception
    raised while another is being handled records it as __context__.  The
    handled exception is thread-level VIRTUAL state (frame.current_exc /
    ctx.exc_stack), so the host raise cannot do this for us; it is applied
    centrally at the frame loop's dispatch catch.  Only fresh exceptions
    (no context yet) chain — a propagating exception keeps the context it
    was raised with — and re-raising an exception already in the current
    chain breaks the inner link first, exactly like CPython's do_raise."""
    if not isinstance(exc, BaseException):  # host raise makes the TypeError
        return exc
    cur = frame.current_exc
    if cur is None and frame.ctx.exc_stack:
        cur = frame.ctx.exc_stack[-1][1]
    if cur is None or cur is exc or exc.__context__ is not None:
        return exc
    o = cur
    while o is not None:  # break a would-be context cycle at its inner link
        nxt = o.__context__
        if nxt is exc:
            o.__context__ = None
            break
        o = nxt
    exc.__context__ = cur
    return exc


@register_opcode_handler("RAISE_VARARGS")
def _raise_varargs(frame, ins, i):
    if ins.arg == 1:
        exc = frame.pop()
        if isinstance(exc, type) and issubclass(exc, BaseException):
            exc = exc()
        raise exc  # chaining happens centrally at the dispatch catch
    if ins.arg == 2:
        cause = frame.pop()
        exc = frame.pop()
        if isinstance(exc, type) and issubclass(exc, BaseException):
            exc = exc()
        raise exc from cause
    # bare raise: re-raise the active exception (CPython semantics).  The
    # active exception is thread-level state, not frame-level: a bare raise
    # in a helper called from an except block re-raises the caller's
    # exception, hence the ctx.exc_stack fallback.
    if frame.current_exc is not None:
        raise frame.current_exc
    if frame.ctx.exc_stack:
        raise frame.ctx.exc_stack[-1][1]
    raise RuntimeError("No active exception to reraise")


#
# Exception-handler opcodes (3.12 zero-cost exceptions; the dispatch itself
# happens in _run_frame's exception-table unwinder)
#


@register_opcode_handler("PUSH_EXC_INFO")
def _push_exc_info(frame, ins, i):
    # stack [.., exc] → [.., prev_exc_state, exc]; saves the OUTER state and
    # installs the incoming exception as current
    exc = frame.pop()
    frame.push(frame.current_exc)
    frame.push(exc)
    if isinstance(exc, BaseException):
        frame.current_exc = exc
        frame.ctx.exc_stack.append((frame, exc))


@register_opcode_handler("CHECK_EXC_MATCH")
def _check_exc_match(frame, ins, i):
    match_type = frame.pop()
    exc = frame.stack[-1]
    frame.push(isinstance(exc, match_type))


@register_opcode_handler("POP_EXCEPT")
def _pop_except(frame, ins, i):
    prev = frame.pop()  # the saved exception state from PUSH_EXC_INFO
    frame.current_exc = prev if isinstance(prev, BaseException) else None
    # pop THIS frame's most recent entry (a suspended generator's entry may
    # sit above it on the shared thread-level stack)
    stack = frame.ctx.exc_stack
    for j in range(len(stack) - 1, -1, -1):
        if stack[j][0] is frame:
            del stack[j]
            break


#
# Generator opcodes (3.12).  Generator frames are created suspended at call
# time (_run_function returns InterpretedGenerator), so RETURN_GENERATOR at
# the top of the body only needs a placeholder for the following POP_TOP.
#


@register_opcode_handler("RETURN_GENERATOR")
def _return_generator(frame, ins, i):
    frame.push(None)


@register_opcode_handler("YIELD_VALUE")
def _yield_value(frame, ins, i):
    # peek, don't pop: CPython keeps the value slot across the suspension
    # (the sent value replaces it on resume), and the exception-table depths
    # for yield-from regions assume the slot is present
    return _Yield(frame.stack[-1])


@register_opcode_handler("GET_YIELD_FROM_ITER")
def _get_yield_from_iter(frame, ins, i):
    v = frame.stack[-1]
    if not isinstance(v, (types.GeneratorType, InterpretedGenerator)):
        frame.stack[-1] = iter(v)


@register_opcode_handler("SEND")
def _send(frame, ins, i):
    # stack [receiver, v] → [receiver, receiver.send(v)]; on StopIteration
    # push its value and jump to the target (END_SEND)
    v = frame.pop()
    recv = frame.stack[-1]
    try:
        if hasattr(recv, "send"):
            res = recv.send(v)
        else:
            if v is not None:
                raise InterpreterError(f"cannot send non-None into {type(recv).__name__}")
            res = next(recv)
    except StopIteration as e:
        frame.push(getattr(e, "value", None))
        return frame.jump_to_offset(ins.argval)
    frame.push(res)


@register_opcode_handler("END_SEND")
def _end_send(frame, ins, i):
    # del STACK[-2]: drop the exhausted sub-iterator under the result
    res = frame.pop()
    frame.pop()
    frame.push(res)


#
# Async opcodes (3.12).  ``await`` compiles to GET_AWAITABLE + the same
# SEND/YIELD_VALUE/END_SEND loop as ``yield from``, so coroutine frames ride
# the generator machinery; only awaitable resolution and the async-for/with
# entry points are new.
#


def _resolve_awaitable(v):
    """GET_AWAITABLE semantics: coroutines pass through, @types.coroutine
    generators (CO_ITERABLE_COROUTINE) pass through, everything else goes
    via type(v).__await__."""
    if isinstance(v, InterpretedCoroutine) or inspect.iscoroutine(v):
        return v
    if isinstance(v, types.GeneratorType) and v.gi_code.co_flags & 0x100:
        return v  # CO_ITERABLE_COROUTINE (@types.coroutine)
    if isinstance(v, InterpretedGenerator) and v._frame.code.co_flags & 0x100:
        return v  # interpreted @types.coroutine generator (asyncio.sleep's __sleep0)
    if isinstance(v, _Awaitable):
        return v.__await__()
    await_m = getattr(type(v), "__await__", None)
    if await_m is None:
        raise TypeError(f"object {type(v).__name__} can't be used in 'await' expression")
    return await_m(v)


@register_opcode_handler("GET_AWAITABLE")
def _get_awaitable(frame, ins, i):
    frame.stack[-1] = _resolve_awaitable(frame.stack[-1])


@register_opcode_handler("GET_AITER")
def _get_aiter(frame, ins, i):
    v = frame.stack[-1]
    aiter_m = getattr(type(v), "__aiter__", None)
    if aiter_m is None:
        raise TypeError(f"'async for' requires an object with __aiter__ method, got {type(v).__name__}")
    frame.stack[-1] = aiter_m(v)


@register_opcode_handler("GET_ANEXT")
def _get_anext(frame, ins, i):
    # keep the iterator; push the resolved awaitable of its __anext__()
    v = frame.stack[-1]
    anext_m = getattr(type(v), "__anext__", None)
    if anext_m is None:
        raise TypeError(f"'async for' requires an iterator with __anext__ method, got {type(v).__name__}")
    frame.push(_resolve_awaitable(anext_m(v)))


@register_opcode_handler("END_ASYNC_FOR")
def _end_async_for(frame, ins, i):
    # stack [aiter, exc]: StopAsyncIteration ends the loop; anything else
    # re-raises out of the frame
    exc = frame.pop()
    frame.pop()
    if not isinstance(exc, StopAsyncIteration):
        raise exc


@register_opcode_handler("BEFORE_ASYNC_WITH")
def _before_async_with(frame, ins, i):
    mgr = frame.pop()
    aexit = getattr(type(mgr), "__aexit__", None)
    aenter = getattr(type(mgr), "__aenter__", None)
    if aexit is None or aenter is None:
        raise TypeError(
            f"'async with' requires an object with __aenter__/__aexit__ methods, got {type(mgr).__name__}"
        )
    frame.push(aexit.__get__(mgr))
    frame.push(aenter(mgr))  # the following GET_AWAITABLE awaits it


@register_opcode_handler("CLEANUP_THROW")
def _cleanup_throw(frame, ins, i):
    # handles an exception raised by throw()/close() at a SEND suspension.
    # CPython contract: (sub_iter, last_sent_val, exc_value -- none, value)
    # for StopIteration (the following END_SEND drops the none); anything
    # else re-raises
    exc = frame.stack[-1]
    if isinstance(exc, StopIteration):
        frame.pop()
        frame.pop()
        frame.pop()
        frame.push(None)
        frame.push(exc.value)
        return None
    raise exc


@register_opcode_handler("BEFORE_WITH")
def _before_with(frame, ins, i):
    mgr = frame.pop()
    exit_fn = type(mgr).__exit__.__get__(mgr)
    enter_fn = type(mgr).__enter__
    frame.push(exit_fn)
    frame.push(enter_fn(mgr))


@register_opcode_handler("WITH_EXCEPT_START")
def _with_except_start(frame, ins, i):
    # stack: [exit_fn, lasti, prev_exc, exc]; calls
    # exit_fn(type(exc), exc, exc.__traceback__) and pushes the result
    exc = frame.stack[-1]
    exit_fn = frame.stack[-4]
    res = exit_fn(type(exc), exc, getattr(exc, "__traceback__", None))
    frame.push(res)


@register_opcode_handler("RERAISE")
def _reraise(frame, ins, i):
    exc = frame.pop()
    if ins.arg:
        frame.pop()  # the saved lasti slot
    if isinstance(exc, BaseException):
        raise exc
    raise InterpreterError(f"RERAISE on a non-exception: {type(exc)}")


#
# Entry point
#


def interpret(
    fn: Callable,
    *args,
    read_callback: Callable | None = None,
    opaque: set | None = None,
    lookasides: dict | None = None,
    **kwargs,
):
    """Interprets ``fn(*args, **kwargs)`` instruction by instruction.

    Returns ``(result, ctx)`` where ``ctx.reads`` records every provenance-
    tracked read (globals, closure cells, attr/item chains off them) and
    ``ctx.log`` the per-opcode run log.  ``read_callback(record, value) ->
    value`` may substitute values at read time (the general jit proxifies
    tensors there).  ``lookasides`` (merged over the process registry,
    ``register_lookaside``) substitutes callables before interpretation.
    """
    if not _is_interpretable(fn):
        raise InterpreterError(f"cannot interpret {fn!r}: not a pure-Python function")
    ctx = InterpreterCompileCtx(
        fn=fn,
        read_callback=read_callback,
        opaque=_default_opaque | (opaque or set()),
        lookasides={**_default_lookasides, **(lookasides or {})},
    )
    ctx.track(fn, ProvenanceRecord(PseudoInst.INPUT_FN))
    ctx.root_globals = fn.__globals__
    result = _run_function(ctx, fn, args, kwargs, depth=0)
    return result, ctx


def format_interpreter_log(log: list, *, max_lines: int | None = None) -> str:
    """Renders a run log (``ctx.log`` / ``CompileStats.last_interpreter_log``)
    as an indented instruction listing (the reference's
    print_last_interpreter_log, interpreter.py:6683-6789)."""
    lines = []
    for ev in log[: max_lines if max_lines is not None else len(log)]:
        kind = ev[0]
        if kind == "op":
            _, depth, co_name, opname, argrepr = ev
            lines.append(f"{'  ' * depth}[{co_name}] {opname}" + (f" {argrepr}" if argrepr else ""))
        elif kind in ("call", "lookaside", "opaque"):
            _, depth, name = ev
            lines.append(f"{'  ' * depth}-> {kind} {name}")
        elif kind == "truncated":
            lines.append(f"... log truncated at {ev[1]} events")
    if max_lines is not None and len(log) > max_lines:
        lines.append(f"... {len(log) - max_lines} more events")
    return "\n".join(lines)
