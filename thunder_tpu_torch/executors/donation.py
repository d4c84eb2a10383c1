"""Del-aware buffer donation analysis for lowered traces.

Counterpart of ``thunder_tpu/executors/donation.py``.  The analysis is the
reference's, copied: :func:`analyze_trace_donations` proves, from the
lowered trace alone, which fusion-region inputs are safe to donate, and
:func:`apply_donation` arms each region's
:class:`~thunder_tpu_torch.executors.inductorex.FusionCallable` with the
proven positions (plus shape/dtype-compatible input→output alias hints,
reported as the reference reports them: hints only).

The runtime has torch semantics.  Where the reference hands
``donate_argnums`` to XLA, which deletes the donated buffer, a region here
releases each donated input's storage right after it runs
(``untyped_storage().resize_(0)``, :func:`release_donated`): the caching
allocator gets the bytes back at once, and the caller's tensor is consumed.
A storage another live tensor shares (a view, an alias a region returned)
is kept.  A consumed tensor passed again raises :class:`DonationError`
naming the input, the region and its source line before the program runs
(``jit``'s dispatch checks the program's donated inputs,
:func:`consumed_error`).  The reference's
``suppress_unusable_donation_warnings`` silences a JAX message torch never
emits, so the port has no counterpart of it.

Safety contract — an input of fusion region R is donatable iff:

- its last (non-``del``) consumer is R: a ``DEL`` of it follows R in the
  lowered trace and no later bound symbol reads it (this also covers "input
  to a later region");
- it is not a trace output (``RETURN`` operand — the caller receives it);
- it is not an endpoint of an eagerly-executed view-class op
  (``SHAPE_OP``-tagged bsyms outside fusion regions may alias buffers, so
  donating one endpoint could invalidate the other).

Every rejection is counted per reason in the ``donation.*`` metrics
(``thunder_tpu_torch.observability``).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

from thunder_tpu_torch.core.prims import OpTags, PrimIDs
from thunder_tpu_torch.core.proxies import TensorProxy
from thunder_tpu_torch.core.symbol import BoundSymbol, gather_provenance
from thunder_tpu_torch.core.trace import TraceCtx, TraceProvenance, from_trace

__all__ = [
    "DonationError",
    "DonationReport",
    "RegionDonation",
    "analyze_trace_donations",
    "apply_donation",
    "donation_summary",
    "consumed_error",
    "release_donated",
    "REJECT_TRACE_OUTPUT",
    "REJECT_LATER_USE",
    "REJECT_ALIASED_VIEW",
    "REJECT_NO_DEL",
]

class DonationError(RuntimeError):
    """An explicitly requested donation is provably unsafe.

    Raised by :func:`apply_donation` in strict mode (``ttt.jit(fn,
    donate=(argnums,))``): the user asserted an input's buffer may be
    consumed, but the lowered trace shows it escaping — the message names
    the proxy, the rejection reason, and the source provenance of the
    blocking use so the fix is one hop away.  Also raised when a tensor a
    donated call consumed is passed again (:func:`consumed_error`)."""


REJECT_TRACE_OUTPUT = "trace_output"
REJECT_LATER_USE = "later_use"
REJECT_ALIASED_VIEW = "aliased_view"
REJECT_NO_DEL = "no_del"
# strict-mode only: the candidate never reached any fusion region (the trace
# has none, or only eager symbols consume it) — there is nowhere to donate it
REJECT_UNFUSED = "unfused"


@dataclass
class RegionDonation:
    """Donation decision for one fusion region."""

    name: str                                   # fusion symbol name (Inductor0, ...)
    index: int                                  # position in trace.bound_symbols
    bsym: BoundSymbol
    donated: list = field(default_factory=list)       # [(arg_pos, TensorProxy)]
    aliases: dict = field(default_factory=dict)       # input name -> output name
    rejected: dict = field(default_factory=dict)      # input name -> (reason, blocking_bsym|None)
    donated_bytes: int = 0


@dataclass
class DonationReport:
    """The full analysis result for one lowered trace."""

    regions: list = field(default_factory=list)        # [RegionDonation]
    protected_names: frozenset = frozenset()           # RETURN operands
    view_names: frozenset = frozenset()                # endpoints of eager view-class ops

    @property
    def donated_buffers(self) -> int:
        return sum(len(r.donated) for r in self.regions)

    @property
    def donated_bytes(self) -> int:
        return sum(r.donated_bytes for r in self.regions)

    def rejections(self) -> dict:
        out: dict[str, int] = {}
        for r in self.regions:
            for reason, _ in r.rejected.values():
                out[reason] = out.get(reason, 0) + 1
        return out


def _proxy_nbytes(p) -> int:
    from thunder_tpu_torch.observability.memory import tensor_nbytes

    return tensor_nbytes(p)


def analyze_trace_donations(
    trace: TraceCtx, *, candidate_names: set | None = None
) -> DonationReport:
    """Proves which fusion-region inputs are safe to donate, from the lowered
    trace alone (requires ``del_last_used`` to have run so buffer death is
    explicit as ``DEL`` bound symbols).

    ``candidate_names`` restricts the candidate set (the ``donate=argnums``
    form); ``None`` considers every tensor input of every region.  Inputs
    outside the candidate set are skipped silently — they are neither donated
    nor counted as rejections."""
    from thunder_tpu_torch.executors.utils import trace_return_names

    bsyms = trace.bound_symbols
    protected: set[str] = trace_return_names(trace)

    # last non-del, non-return read and first del AFTER each position
    last_use: dict[str, int] = {}
    del_index: dict[str, int] = {}
    view_names: set[str] = set()
    for i, bsym in enumerate(bsyms):
        if bsym.sym.id == PrimIDs.DEL:
            for p in bsym.flat_proxy_args:
                del_index[p.name] = i
            continue
        if bsym.sym.id == PrimIDs.RETURN:
            continue
        for p in bsym.flat_proxy_args:
            last_use[p.name] = i
        # an eagerly-executed (unfused) view-class op may alias its operand's
        # buffer at runtime; both endpoints are unsafe to donate anywhere
        if not bsym.sym.is_fusion and bsym.sym.tags and OpTags.SHAPE_OP in bsym.sym.tags:
            for p in list(bsym.flat_proxy_args) + list(bsym.flat_proxy_outs):
                if isinstance(p, TensorProxy):
                    view_names.add(p.name)

    report = DonationReport(
        protected_names=frozenset(protected), view_names=frozenset(view_names)
    )

    for i, bsym in enumerate(bsyms):
        if not bsym.sym.is_fusion:
            continue
        region = RegionDonation(name=bsym.sym.name, index=i, bsym=bsym)
        for pos, p in enumerate(bsym.args):
            if not isinstance(p, TensorProxy):
                continue
            name = p.name
            if candidate_names is not None and name not in candidate_names:
                continue
            if name in protected:
                region.rejected[name] = (REJECT_TRACE_OUTPUT, None)
            elif last_use.get(name, -1) > i:
                region.rejected[name] = (REJECT_LATER_USE, bsyms[last_use[name]])
            elif name in view_names:
                region.rejected[name] = (REJECT_ALIASED_VIEW, None)
            elif del_index.get(name, -1) <= i:
                # no DEL after the region: liveness was not (or could not be)
                # established — without the proof, keep the buffer
                region.rejected[name] = (REJECT_NO_DEL, None)
            else:
                region.donated.append((pos, p))
                region.donated_bytes += _proxy_nbytes(p)
        _match_aliases(region)
        report.regions.append(region)
    return report


def _match_aliases(region: RegionDonation) -> None:
    """Greedy input→output alias hints: each donated dead input is paired
    with the first unclaimed region output of identical shape/dtype — the
    ``copy_``/optimizer-update pattern, where the new value can take the
    donated buffer's bytes.  Purely informational (the region releases the
    donated storage; the caching allocator hands the bytes out again): the
    hints feed the donation metrics and the memory timeline's reuse
    accounting."""
    outs = [o for o in region.bsym.flat_proxy_outs if isinstance(o, TensorProxy)]
    claimed: set[str] = set()
    for _, p in region.donated:
        for o in outs:
            if o.name in claimed:
                continue
            if tuple(o.shape) == tuple(p.shape) and o.dtype == p.dtype:
                region.aliases[p.name] = o.name
                claimed.add(o.name)
                break


def _format_provenance(bsym: BoundSymbol | None) -> str:
    if bsym is None:
        return ""
    entries = gather_provenance(bsym)
    if not entries:
        return ""
    fname, pos = entries[0]
    lineno = getattr(pos, "lineno", pos)
    return f" (blocking use: {bsym.sym.name} from {fname}:{lineno})"


def apply_donation(
    trace: TraceCtx,
    *,
    candidate_names: set | None = None,
    strict: bool = False,
    which: str = "forward",
    arm: bool = True,
) -> tuple[TraceCtx, DonationReport]:
    """Runs the analysis and arms the trace's fusion callables (``arm=False``:
    the analysis, its metrics and annotations alone, for a program that runs
    as generated, as ``TrainStep``'s do).

    Returns a new trace (provenance-stamped, fusion bsyms annotated with a
    ``_donation`` record and a codegen header comment) plus the report.
    Publishes the ``donation.*`` metrics.  In strict mode (explicit
    ``donate=argnums``), a rejected candidate raises :class:`DonationError`
    instead of being skipped."""
    from thunder_tpu_torch.observability.metrics import registry

    report = analyze_trace_donations(trace, candidate_names=candidate_names)

    if strict:
        # a candidate rejected at one region may legally donate at a LATER
        # region (its true last consumer); only a nowhere-donated candidate
        # violates the user's explicit assertion.  Report the most specific
        # rejection (anything beats later_use, which only says "not here").
        donated_names = {p.name for r in report.regions for _, p in r.donated}
        worst: dict[str, tuple] = {}
        for region in report.regions:
            for name, (reason, blocker) in region.rejected.items():
                if name in donated_names:
                    continue
                if name not in worst or worst[name][0] == REJECT_LATER_USE:
                    worst[name] = (reason, blocker, region)
        # a candidate no fusion region consumes is rejected nowhere above —
        # classify it here (trace output / aliased view / simply unfused) and
        # point at its last reader so the error still lands on a source line
        for name in sorted(candidate_names or ()):
            if name in donated_names or name in worst:
                continue
            blocker = None
            for b in trace.bound_symbols:
                if b.sym.id == PrimIDs.DEL:
                    continue
                if any(p.name == name for p in b.flat_proxy_args):
                    blocker = b
            if name in report.protected_names:
                worst[name] = (REJECT_TRACE_OUTPUT, blocker, None)
            elif name in report.view_names:
                worst[name] = (REJECT_ALIASED_VIEW, blocker, None)
            else:
                worst[name] = (REJECT_UNFUSED, blocker, None)
        for name, (reason, blocker, region) in worst.items():
            at = f" at fusion region {region.name}" if region is not None else ""
            raise DonationError(
                f"donation of {name!r} was requested explicitly but is unsafe: "
                f"{reason}{at}"
                f"{_format_provenance(blocker) or (_format_provenance(region.bsym) if region is not None else '')} — "
                f"drop it from donate= or stop reusing the buffer"
            )

    reg = registry()
    annotated: dict[int, BoundSymbol] = {}
    total_aliases = 0
    for region in report.regions:
        for reason, _ in region.rejected.values():
            reg.counter(f"donation.rejected.{reason}").inc()
        if not region.donated:
            continue
        reg.counter("donation.regions").inc()
        reg.counter("donation.buffers_donated").inc(len(region.donated))
        reg.counter("donation.bytes_donated").inc(region.donated_bytes)
        total_aliases += len(region.aliases)

        names = [p.name for _, p in region.donated]
        info = {
            "donated": names,
            "aliases": dict(region.aliases),
            "bytes": region.donated_bytes,
        }
        alias_note = "".join(
            f"; {a} reused for {b}" for a, b in region.aliases.items()
        )
        header = f"donated: {', '.join(names)} ({region.donated_bytes} bytes{alias_note})"
        bsym = region.bsym
        new_bsym = bsym.from_bsym(
            header=f"{bsym.header}\n{header}" if bsym.header else header
        )
        new_bsym._donation = info
        annotated[region.index] = new_bsym
        region.bsym = new_bsym

        # arm the compiled region: positions follow the callable's own input
        # order (identical to the bsym arg order by construction, but matched
        # by name so hand-built traces and re-lowered regions stay safe)
        fusion = (bsym._call_ctx or {}).get(bsym.sym.name)
        if arm and fusion is not None and hasattr(fusion, "set_donation"):
            argnums = tuple(
                fusion.input_names.index(n) for n in names if n in fusion.input_names
            )
            fusion.set_donation(argnums, region.aliases)
    if total_aliases:
        reg.counter("donation.aliased_outputs").inc(total_aliases)

    ntrace = from_trace(trace)
    ntrace.bound_symbols = [
        annotated.get(i, b) for i, b in enumerate(trace.bound_symbols)
    ]
    rej = report.rejections()
    rej_note = (
        " rejected " + ", ".join(f"{k}={v}" for k, v in sorted(rej.items()))
        if rej
        else ""
    )
    ntrace._donation_summary = (
        f"{report.donated_buffers} buffer(s) / {report.donated_bytes} bytes donated"
        f" across {sum(1 for r in report.regions if r.donated)} region(s);{rej_note}"
        if report.regions
        else "no fusion regions"
    )
    ntrace.set_provenance(
        TraceProvenance(
            f"Donation analysis ({which}): {report.donated_buffers} buffers / "
            f"{report.donated_bytes} bytes donated"
        )
    )
    return ntrace, report


def donation_summary(report: DonationReport) -> dict:
    """Plain-dict view of a report (what ``ttt.donation_stats`` returns)."""
    return {
        "buffers_donated": report.donated_buffers,
        "bytes_donated": report.donated_bytes,
        "regions": [
            {
                "name": r.name,
                "donated": [p.name for _, p in r.donated],
                "aliases": dict(r.aliases),
                "bytes": r.donated_bytes,
                "rejected": {n: reason for n, (reason, _) in r.rejected.items()},
            }
            for r in report.regions
        ],
        "rejections": report.rejections(),
    }


def _storage_shared(t) -> bool:
    """True unless ``t`` is the only tensor on its storage (a view or
    another alias of it keeps the bytes alive)."""
    use_count = getattr(torch._C, "_storage_Use_Count", None)
    if use_count is None:
        return True
    # the temporary UntypedStorage holds one reference, ``t`` the other
    return use_count(t.untyped_storage()._cdata) > 2


def consumed_error(input_name: str, position: int, region: str, provenance: str) -> DonationError:
    return DonationError(
        f"input {input_name!r} (position {position}) of fusion region {region} was donated "
        f"by an earlier call and its storage is released{provenance} — donated inputs are "
        f"CONSUMED: pass a fresh tensor (feed the outputs forward) or compile with "
        f"donate=False")


def release_donated(fusion, vals) -> int:
    """Releases the storage of every donated input of ``fusion`` that no
    other tensor shares; returns the bytes released (``donation.bytes_released``)."""
    freed = 0
    for i in fusion.donate_argnums:
        v = vals[i] if i < len(vals) else None
        if not isinstance(v, torch.Tensor) or _storage_shared(v):
            continue
        storage = v.untyped_storage()
        n = storage.nbytes()
        try:
            storage.resize_(0)
        except RuntimeError:        # a storage that cannot resize (from_numpy) stays
            continue
        freed += n
    if freed:
        from thunder_tpu_torch.observability.metrics import registry

        registry().counter("donation.bytes_released").inc(freed)
    return freed
