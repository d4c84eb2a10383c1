"""The inductor fusion executor: trace regions → one ``torch.compile`` program each.

Counterpart of ``thunder_tpu/executors/xlaex.py``.  The reference hands each
maximal fusible region of a claimed trace to ``jax.jit``, so XLA fuses it;
here each region becomes one :class:`FusionCallable` whose program is the
region's sub-trace claimed by the ``torch`` executor and generated as Python
(the port's codegen).  What runs depends on the tensors a call gets:

- **CUDA tensors** (any input on the card; beside one, a CPU tensor only as
  a 0-dim scalar): the generated function traced on fake tensors into an
  FX graph (``make_fx``) and compiled by ``torch.compile(..., fullgraph=True,
  dynamic=False)`` (inductor: Triton kernels on the card, large products as
  library calls), run under
  ``torch.no_grad()`` (the traced programs compute their own gradients, so
  no joint graph is built).  A graph break, a compile failure or a launch
  failure raises :class:`FusionError` naming the region and the source line
  of its first op; no region runs eagerly on a CUDA tensor.
- **CPU tensors alone:** the region's plain version, the same generated function
  uncompiled: its ``torchex`` impls in trace order.

Compiled programs are keyed on the region's structure (its claimed op list
with proxies numbered in order of appearance, and which of them it returns)
plus its inputs' shapes, strides and dtypes, so the structurally equal
regions of a model's layers compile once per process.  Each first compile
is recorded as an ``inductor_compile`` span and counted in :data:`STATS`.

What fuses (``_is_fusible``, as the reference's, with the port's limits): a
bound symbol whose prim ``torchex`` implements, or a composite whose
subsymbols all fuse.  Never fusible: the reference's ``_NONFUSIBLE_IDS``,
``UNPACK``/``CHECK`` ops, random prims (a region cannot carry the
``torch.Generator`` that ``torchex`` seeds from ``(key, offset)``), the
collectives of ``distributed/prims.py`` (a process group cannot enter a
compiled program, and every rank issues them in trace order), the prims
whose ``torchex`` impls launch a hand-written kernel on CUDA tensors (SDPA,
its backward and the cross-entropy forward reach ``cudaex``'s ``ctypes``
calls, which dynamo cannot trace), the fused linear cross-entropy and its
backward (their impls loop over vocabulary chunks to bound memory, which a
region would unroll), and anything an operator executor
claimed (``cuda_sdpa``, ``quantex``'s products).  ``xla_min_fusion_size``
keeps the reference's name and meaning: regions that weigh less (flattened
prims, a matmul-class prim 1000) stay unfused.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Sequence

import torch

from thunder_tpu_torch.core.compile_data import get_compile_option
from thunder_tpu_torch.core.prims import OpTags, PrimIDs, python_return
from thunder_tpu_torch.core.proxies import Proxy, TensorProxy, unvariableify
from thunder_tpu_torch.core.symbol import BoundSymbol, Symbol, gather_provenance
from thunder_tpu_torch.core.trace import TraceCtx, TraceProvenance, from_trace
from thunder_tpu_torch.core.utils import consumers, producers
from thunder_tpu_torch.extend import FusionExecutor, add_default_executor, register_executor
from thunder_tpu_torch.executors.utils import Region
from thunder_tpu_torch.observability.events import span as _phase_span

__all__ = ["FusionCallable", "FusionError", "InductorFusionExecutor", "STATS", "compile_fusion",
           "ex", "inductor_ex", "input_views", "never_fuse_collectives", "region_violations",
           "region_weight"]

_NONFUSIBLE_IDS = {
    PrimIDs.RETURN,
    PrimIDs.DEL,
    PrimIDs.COMMENT,
    PrimIDs.PRINT,
    PrimIDs.ITEM,
    PrimIDs.DEVICE_PUT,
    PrimIDs.GET_GRAD,
    PrimIDs.PUT_GRAD,
}
# torchex's impls of these call cudaex's kernels on CUDA tensors
_KERNEL_IDS = {PrimIDs.SDPA, PrimIDs.SDPA_BACKWARD, PrimIDs.CROSS_ENTROPY_FWD}
# torchex's impls of these loop over vocabulary chunks to bound their
# memory; a region would unroll the loop into one graph
_CHUNKED_IDS = {PrimIDs.FUSED_LINEAR_CE, PrimIDs.FUSED_LINEAR_CE_BACKWARD}
# collectives (distributed/prims.py registers its DistPrimIDs here): they
# call torch.distributed on a process group, which a compiled region cannot
# carry, and every rank must issue them in the trace's order
_COLLECTIVE_IDS: set = set()


def never_fuse_collectives(ids) -> None:
    """Registers the ids of collective prims, which no region may hold."""
    _COLLECTIVE_IDS.update(ids)

#: process-wide counters: ``compiles`` (distinct compiled programs),
#: ``compile_s`` (seconds of their first calls, the compile included),
#: ``calls`` (compiled calls, first ones included)
STATS = {"compiles": 0, "compile_s": 0.0, "calls": 0}

# structure key -> its number: a region hashes its (long) key once
_STRUCTURES: dict = {}
# (structure number, input metadata, backend) -> compiled callable
_COMPILED: dict = {}


class FusionError(RuntimeError):
    """A fusion region failed to compile or to run on the card."""


def region_violations(trace: TraceCtx) -> list[str]:
    """Everything no fusion region of ``trace`` may hold: a symbol an
    operator executor claimed (``cuda_*``, ``quantex``'s products), a random
    prim, a prim whose ``torchex`` impl launches a hand-written kernel, or a
    claimed op of the region's program other than a ``torch_*`` call.  Empty
    when every region holds only torch-implementable, non-random prims."""
    out: list[str] = []

    def walk(region: str, b: BoundSymbol) -> None:
        sym = b.sym
        if sym.executor is not None or sym.name.startswith("cuda_"):
            out.append(f"{region}: {sym.name} (claimed by {getattr(sym.executor, 'name', None)})")
        elif OpTags.RANDOM_OP in sym.tags:
            out.append(f"{region}: {sym.name} (random)")
        elif sym.id in _KERNEL_IDS:
            out.append(f"{region}: {sym.name} (a kernel's prim)")
        elif sym.id in _COLLECTIVE_IDS:
            out.append(f"{region}: {sym.name} (a collective)")
        for sub in b.subsymbols:
            walk(region, sub)

    for b in trace.bound_symbols:
        if not b.sym.is_fusion:
            continue
        for sub in b.subsymbols:
            walk(b.sym.name, sub)
        fusion = (b._call_ctx or {}).get(b.sym.name)
        for c in fusion.trace.bound_symbols if fusion is not None else ():
            if c.sym.id not in (PrimIDs.RETURN, PrimIDs.DEL) and not c.sym.name.startswith("torch_"):
                out.append(f"{b.sym.name}: runs {c.sym.name}")
    return out


def _flat_prims(bsym: BoundSymbol) -> list[BoundSymbol]:
    if not bsym.subsymbols:
        return [bsym]
    return [p for s in bsym.subsymbols for p in _flat_prims(s)]


def _is_slice_view(bsym: BoundSymbol) -> bool:
    """A slice (``x[e]``, ``x[a:b]``), with the squeezes and reshapes that
    follow it: views whose constants pick a part of their input."""
    prims = _flat_prims(bsym)
    return (any(p.sym.id == PrimIDs.SLICE for p in prims)
            and all(OpTags.SHAPE_OP in p.sym.tags and p.sym.id != PrimIDs.CAT for p in prims))


def input_views(trace: TraceCtx) -> set[int]:
    """The bound symbols of ``trace`` that slice its inputs: views (a slice,
    with its squeezes and reshapes; no concatenation) whose tensors are
    trace inputs or such views, as ``fc_1[e]`` takes expert ``e``'s weight
    from a stacked parameter.  They stay out of the regions: eagerly they
    cost no kernel, and a region taking the slice as an input keeps the
    structure of its twins (each expert's region the same program) where
    the slice's index inside it would make each one a program of its own."""
    from thunder_tpu_torch.core.proxies import TensorProxy

    viewed = {p.name for p in trace.args or () if isinstance(p, TensorProxy)}
    out: set[int] = set()
    for b in trace.bound_symbols:
        tensors = [p for p in b.flat_proxy_args if isinstance(p, TensorProxy)]
        if tensors and all(p.name in viewed for p in tensors) and _is_slice_view(b):
            out.add(id(b))
            viewed.update(p.name for p in b.flat_proxy_outs)
    return out


def region_weight(bsyms: Sequence[BoundSymbol]) -> int:
    """A region's size as ``xla_min_fusion_size`` reads it (reference
    ``xlaex.fusion_pass``'s ``weight``): flattened prims, since one
    composite call is many ops; a matmul-class prim counts 1000."""
    total = 0
    for b in bsyms:
        if b.subsymbols:
            total += region_weight(b.subsymbols)
        else:
            total += 1_000 if OpTags.MATMUL_OP in b.sym.tags else 1
    return total


def _token(x, names: dict) -> Any:
    """A hashable token of one argument: proxies by their number of first
    appearance, containers element by element, constants by type and repr."""
    if isinstance(x, Proxy):
        n = names.get(x.name)
        if n is None:
            n = names[x.name] = len(names)
        return ("p", n)
    if isinstance(x, (tuple, list)):
        return (type(x).__name__, tuple(_token(e, names) for e in x))
    if isinstance(x, dict):
        return ("dict", tuple((k, _token(v, names)) for k, v in sorted(x.items())))
    return (type(x).__name__, repr(x))


def _structure(bsyms: Sequence[BoundSymbol], inputs: Sequence, outputs: Sequence) -> tuple:
    names = {p.name: i for i, p in enumerate(inputs)}
    ops = tuple((b.sym.name, _token(b.args, names), _token(b.kwargs, names),
                 _token(b.output, names)) for b in bsyms)
    return ops, tuple(_token(o, names) for o in outputs)


def _meta(vals) -> tuple:
    return tuple((tuple(v.shape), v.stride(), v.dtype, v.device) if isinstance(v, torch.Tensor)
                 else (type(v).__name__, v) for v in vals)


def _claim_region(bsyms: Sequence[BoundSymbol]) -> list[BoundSymbol]:
    """The region's bound symbols claimed by the ``torch`` executor alone."""
    from thunder_tpu_torch.executors.passes import _claim_bsym
    from thunder_tpu_torch.executors.torchex import torch_ex

    trace = TraceCtx()
    out: list[BoundSymbol] = []
    for b in bsyms:
        out.extend(_claim_bsym(trace, b, (torch_ex,)))
    return out


class FusionCallable:
    """A region's program; keeps the region's bound symbols and its claimed
    sub-trace for inspection (reference ``xlaex.FusionCallable``)."""

    def __init__(self, name: str, bsyms: Sequence[BoundSymbol], inputs: Sequence[Proxy],
                 outputs: Sequence[Proxy]):
        self.name = name
        self.bsyms = list(bsyms)
        self.input_names = [p.name for p in inputs]
        self.output_names = [p.name for p in outputs]
        #: positions whose storage the region releases after it runs (set by
        #: the donation pass, executors/donation.py; never at construction)
        self.donate_argnums: tuple[int, ...] = ()
        #: input name -> output name alias hints (introspection and metrics)
        self.out_aliases: dict[str, str] = {}
        from thunder_tpu_torch.core.codeutils import SigInfo
        from thunder_tpu_torch.executors.passes import del_last_used

        claimed = _claim_region(self.bsyms)
        sub = TraceCtx()
        sub.args = tuple(inputs)
        sub.bound_symbols = [*claimed, python_return.bind(tuple(outputs), output=None)]
        sub.set_siginfo(SigInfo(name=name, args=[(p.name, None) for p in inputs]))
        self.trace = del_last_used(sub)
        self.trace.set_provenance(TraceProvenance(f"Fusion region {name}"))
        #: the region's structure: equal keys compute the same function of
        #: their positional inputs
        self.key = _structure(claimed, inputs, outputs)
        self._key_id = _STRUCTURES.setdefault(self.key, len(_STRUCTURES))
        # the last (metadata, backend, program) this region ran: a layer's
        # region meets the same inputs call after call
        self._last: tuple | None = None
        self.plain = self.trace._python_callable_impl()
        self._cuda = any(isinstance(p, TensorProxy) and str(p.device).startswith("cuda")
                         for p in (*inputs, *outputs))

    def set_donation(self, argnums: Sequence[int], aliases: dict | None = None) -> None:
        """Arms the region with ``argnums`` (donation pass only)."""
        self.donate_argnums = tuple(sorted(argnums))
        self.out_aliases = dict(aliases or {})

    def provenance(self) -> str:
        """`` (region built from file:line)`` of its first op with one, or ""."""
        for b in self.bsyms:
            entries = gather_provenance(b)
            if entries:
                fname, pos = entries[0]
                return f" (region built from {fname}:{getattr(pos, 'lineno', pos)})"
        return ""

    def _on_cuda(self, vals) -> bool:
        """Whether the region compiles: any of ``vals`` a CUDA tensor.  Beside
        one, a CPU tensor may only be a 0-dim scalar (torch mixes those with
        CUDA tensors); any other mix raises."""
        tensors = [(n, v) for n, v in zip(self.input_names, vals) if isinstance(v, torch.Tensor)]
        if not tensors:
            return self._cuda
        if not any(v.is_cuda for _, v in tensors):
            return False
        mixed = [n for n, v in tensors if not v.is_cuda and v.dim() != 0]
        if mixed:
            raise FusionError(f"fusion region {self.name} got CUDA tensors beside CPU tensors "
                              f"{mixed}{self.provenance()}")
        return True

    def __call__(self, *vals):
        if self._on_cuda(vals):
            out = self._run_compiled(vals, "inductor")
        else:
            out = self.plain(*vals)
        if self.donate_argnums:
            from thunder_tpu_torch.executors.donation import release_donated

            release_donated(self, vals)
        return out

    def _lookup(self, vals, backend: str) -> tuple:
        """``(program, result of a compiling call or None, compiled now)``."""
        meta = _meta(vals)
        last = self._last
        if last is not None and last[0] == meta and last[1] == backend:
            return last[2], None, False
        key = (self._key_id, meta, backend)
        fn = _COMPILED.get(key)
        if fn is not None:
            self._last = (meta, backend, fn)
            return fn, None, False
        from torch.fx.experimental.proxy_tensor import make_fx

        t0 = time.perf_counter()
        with _phase_span("inductor_compile", fusion=self.name, ops=len(self.bsyms)):
            # the generated function traced on fake tensors into an FX graph
            # of aten ops, which dynamo then captures whole: no object of the
            # port's IR (dtypes, devices) reaches dynamo
            fn = self._call(lambda *a: torch.compile(
                make_fx(self.trace._python_callable_impl(), tracing_mode="fake")(*a),
                fullgraph=True, dynamic=False, backend=backend), vals, "trace")
            out = self._call(fn, vals, "compile")
        from thunder_tpu_torch.core import compile_cache

        seconds = time.perf_counter() - t0
        compile_cache.compiled(seconds)
        STATS["compiles"] += 1
        STATS["compile_s"] += seconds
        _COMPILED[key] = fn
        self._last = (meta, backend, fn)
        return fn, out, True

    def _call(self, fn, vals, what: str):
        try:
            with torch.no_grad():
                return fn(*vals)
        except Exception as e:
            # an error inside a compiled region can reach us as dynamo's
            # refusal to trace the traceback walk FX runs to report it: name
            # the card's out-of-memory count, the usual cause
            ooms = (torch.cuda.memory_stats().get("num_ooms", 0)
                    if self._cuda and torch.cuda.is_available() else 0)
            note = f" (this process ran out of card memory {ooms} times)" if ooms else ""
            raise FusionError(f"fusion region {self.name} ({len(self.bsyms)} ops) failed to "
                              f"{what}{self.provenance()}: {type(e).__name__}: {e}{note}") from e

    def _run_compiled(self, vals, backend: str):
        STATS["calls"] += 1
        fn, out, fresh = self._lookup(vals, backend)
        return out if fresh else self._call(fn, vals, "run")

    def __repr__(self):
        return f"<FusionCallable {self.name}: {len(self.bsyms)} ops>"


def compile_fusion(fusion: FusionCallable, vals, backend: str = "inductor") -> Callable:
    """``fusion``'s program compiled under ``backend`` for inputs like
    ``vals`` (compiled, and run once, on first use; the tests compile CPU
    regions with ``"aot_eager"``); calling it runs the compiled region."""
    fn = fusion._lookup(vals, backend)[0]
    return lambda *a: fusion._call(fn, a, "run")


class InductorFusionExecutor(FusionExecutor):
    def __init__(self):
        super().__init__("inductor", version=torch.__version__)

    def _is_fusible(self, bsym: BoundSymbol) -> bool:
        sym = bsym.sym
        if sym.id in _NONFUSIBLE_IDS or sym.id in _KERNEL_IDS or sym.id in _CHUNKED_IDS \
                or sym.id in _COLLECTIVE_IDS or sym.is_fusion:
            return False
        if sym.executor is not None or OpTags.RANDOM_OP in sym.tags:
            return False
        from thunder_tpu_torch.executors.torchex import prim_impls

        if sym.id in prim_impls:
            return True
        if OpTags.UNPACK_OP in sym.tags or OpTags.CHECK_OP in sym.tags:
            return False
        # composites whose subsymbols are all fusible
        if bsym.subsymbols:
            return all(self._is_fusible(s) for s in bsym.subsymbols)
        return False

    def can_fuse(self, bsym: BoundSymbol) -> bool:
        return self._is_fusible(bsym)

    def should_fuse(self, trace: TraceCtx) -> Callable[[BoundSymbol], bool]:
        """The fusion pass's predicate over ``trace``'s bound symbols:
        fusible, and not a view of the trace's inputs (:func:`input_views`)."""
        views = input_views(trace)
        return lambda b: id(b) not in views and self._is_fusible(b)

    def fuse(self, region_bsyms: list[BoundSymbol], fusion_counter: int, producers_map,
             consumers_map, return_proxies) -> BoundSymbol:
        region = Region(producers_map, consumers_map, region_bsyms)
        inputs = [unvariableify(v) for v in region.inputs]
        outputs = [unvariableify(v) for v in region.outputs]
        # proxies returned from the trace must also escape the fusion
        out_names = {p.name for p in outputs}
        produced = {o.name for b in region_bsyms for o in b.flat_proxy_outs}
        for p in return_proxies:
            if p.name in produced and p.name not in out_names:
                outputs.append(p)
                out_names.add(p.name)

        name = f"Inductor{fusion_counter}"
        fusion = FusionCallable(name, region_bsyms, inputs, outputs)
        sym = Symbol(name=name, meta=None, is_fusion=True, executor=self)
        bsym = sym.bind(*inputs, output=tuple(outputs), subsymbols=tuple(region_bsyms),
                        _call_ctx={name: fusion})
        # the region keeps the provenance of every op it absorbed
        bsym.source_positions = list(gather_provenance(bsym))
        return bsym

    @_phase_span("lower:inductor_fusion")
    def fusion_pass(self, trace: TraceCtx) -> TraceCtx:
        from thunder_tpu_torch.core.trace import _execution_file

        if _execution_file.get() is not None:
            # execution-callback-file debugging: the dumped program must stay
            # hand-editable, so every prim runs as its own call
            return trace
        start = time.perf_counter_ns()
        min_size = get_compile_option(
            "xla_min_fusion_size",
            "Minimum number of bound symbols in a region for it to be compiled as one "
            "program (default 2).",
            default=2,
        )
        producers_map = producers(trace)
        consumers_map = consumers(trace)
        return_proxies: list[Proxy] = []
        for bsym in trace.bound_symbols:
            if bsym.sym.id == PrimIDs.RETURN:
                return_proxies.extend(bsym.flat_proxy_args)

        from thunder_tpu_torch.executors.data_dependent_partition import fuse_bound_symbols

        groups = fuse_bound_symbols(trace.bound_symbols, self.should_fuse(trace))

        new_bsyms: list[BoundSymbol] = []
        fusion_counter = 0
        for g in groups:
            if (not g.fusible or region_weight(g.bsyms) < int(min_size)
                    or not self.get_fuel()):
                new_bsyms.extend(g.bsyms)
            else:
                new_bsyms.append(self.fuse(g.bsyms, fusion_counter, producers_map,
                                           consumers_map, return_proxies))
                fusion_counter += 1

        ntrace = from_trace(trace)
        ntrace.bound_symbols = new_bsyms
        elapsed = (time.perf_counter_ns() - start) // 1000000
        ntrace.set_provenance(TraceProvenance(f"Inductor Fusion (took {elapsed} milliseconds)"))
        return ntrace


ex = InductorFusionExecutor()
register_executor(ex)
inductor_ex = ex
add_default_executor(ex)
