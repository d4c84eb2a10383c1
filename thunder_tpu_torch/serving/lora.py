"""Per-request LoRA adapter serving: one engine, many fine-tunes.

Counterpart of ``thunder_tpu/serving/lora.py``.  The engine holds a bounded
registry of LoRA adapters: stacked A/B factor arenas on the engine's device,
one slot per adapter.  Every step gathers each request's factors by its slot
index and applies the low-rank delta ``scaling * B(A(x))`` next to each
target weight's matmul, so a batch mixes tenants freely and the bucket
geometries never grow with adapter ids.

- **Slot 0 is the reserved base slot** (all-zero factors): requests without
  an ``adapter_id`` ride the same steps with an exact-zero delta.
- **Register and evict are in-place writes** into the arenas; evicting
  zeroes the slot, so an in-flight request of an evicted adapter degrades to
  the base model, never to a later tenant's factors.
- **Factor identity.** Each slot carries a version that every register and
  evict of the slot bumps.  The engine keys shared prompt prefixes by
  ``(slot, version)``: K/V computed with one adapter's ``wk``/``wv`` deltas
  are never reused by a request of another adapter, nor after the slot's
  factors changed.
- Determinism: the delta of request *i* depends only on row *i*'s
  activations and factors, so a request's tokens are the same whether it
  runs alone or batched with other tenants.

Default targets are the attention projections (``wq``/``wk``/``wv``/``wo``);
the MLP matmuls (``fc_1``/``fc_2``/``proj`` for gated MLPs, ``fc``/``proj``
for GptNeox-style) may be added; MoE has none.  Meshes are not ported:
:meth:`AdapterRegistry.place` raises.
"""
from __future__ import annotations

import numpy as np
import torch

from thunder_tpu_torch._device import resolve_device
from thunder_tpu_torch.observability.metrics import registry as _metrics

__all__ = [
    "AdapterRegistry",
    "RegistryFullError",
    "gather_adapter_slots",
    "make_lora_factors",
    "valid_targets",
]

BASE_SLOT = 0  # reserved all-zero adapter slot (requests without adapter_id)

_TARGETS = ("wq", "wk", "wv", "wo")


class RegistryFullError(RuntimeError):
    """``register`` found no free slot: the registry is at capacity.
    Evict an adapter (or build a bigger registry) first."""


def valid_targets(cfg) -> tuple[str, ...]:
    """Every LoRA target the model class supports: the attention
    projections always, plus the MLP matmuls by ``mlp_class`` (gated MLPs
    ``fc_1``/``fc_2``/``proj``, GptNeox-style ``fc``/``proj``, MoE none)."""
    if cfg.mlp_class == "LLaMAMoE":
        return _TARGETS
    if cfg.mlp_class in ("LLaMAMLP", "GemmaMLP"):
        return _TARGETS + ("fc_1", "fc_2", "proj")
    return _TARGETS + ("fc", "proj")


def _target_features(cfg, target: str) -> tuple[int, int]:
    """(in_features, out_features) of one target weight."""
    hs, nh, ng, C = cfg.head_size, cfg.n_head, cfg.n_query_groups, cfg.n_embd
    I = cfg.intermediate_size
    return {
        "wq": (C, nh * hs),
        "wk": (C, ng * hs),
        "wv": (C, ng * hs),
        "wo": (nh * hs, C),
        "fc_1": (C, I),
        "fc_2": (C, I),
        "fc": (C, I),
        "proj": (I, C),
    }[target]


class AdapterRegistry:
    """Bounded slot arena of LoRA A/B factors on ``device`` (default: the
    card; raises without one unless ``device="cpu"``), shared by the engines
    serving one base model.

    Storage per target ``t``: ``arenas[t]["a"]`` of shape
    ``(slots, L, rank, in_t)`` and ``arenas[t]["b"]`` of shape
    ``(slots, L, out_t, rank)``; the delta is ``scaling * (x @ a[slot].T) @
    b[slot].T`` per layer, with ``scaling = alpha / rank`` (``alpha``
    defaults to ``rank``: scaling 1.0)."""

    def __init__(self, cfg, *, rank: int, max_adapters: int = 8, targets=_TARGETS,
                 alpha: float | None = None, dtype=torch.float32, device="cuda"):
        if rank < 1:
            raise ValueError(f"rank must be >= 1, got {rank}")
        if max_adapters < 1:
            raise ValueError(f"max_adapters must be >= 1, got {max_adapters}")
        supported = valid_targets(cfg)
        unknown = [t for t in targets if t not in supported]
        if unknown:
            raise ValueError(f"unknown LoRA targets {unknown}; supported for "
                             f"mlp_class={cfg.mlp_class!r}: {supported}")
        self.cfg = cfg
        self.rank = int(rank)
        self.max_adapters = int(max_adapters)
        self.n_slots = self.max_adapters + 1           # + the base slot
        self.targets = tuple(targets)
        self.scaling = float(alpha if alpha is not None else rank) / rank
        self.dtype = dtype
        self.device = resolve_device(device)
        L = cfg.n_layer
        self.arenas = {}
        for t in self.targets:
            fin, fout = _target_features(cfg, t)
            self.arenas[t] = {
                "a": torch.zeros((self.n_slots, L, self.rank, fin), dtype=dtype,
                                 device=self.device),
                "b": torch.zeros((self.n_slots, L, fout, self.rank), dtype=dtype,
                                 device=self.device),
            }
        self._slot_of: dict[str, int] = {}
        self._free: list[int] = list(range(self.n_slots - 1, BASE_SLOT, -1))
        self._versions = [0] * self.n_slots
        self._gauges()

    @property
    def geometry(self) -> tuple:
        """Everything the steps' shapes and math depend on, and nothing an
        adapter registration changes: (rank, slots, targets, scaling, dtype)."""
        return (self.rank, self.n_slots, self.targets, self.scaling, str(self.dtype))

    @property
    def adapter_ids(self) -> tuple[str, ...]:
        return tuple(self._slot_of)

    @property
    def slots_used(self) -> int:
        return len(self._slot_of)

    def slot(self, adapter_id: str) -> int:
        """Slot index of a registered adapter (KeyError when unknown:
        admission-time validation, not a silent base fallback)."""
        if adapter_id not in self._slot_of:
            raise KeyError(f"unknown adapter_id {adapter_id!r}; registered: "
                           f"{sorted(self._slot_of)}")
        return self._slot_of[adapter_id]

    def version(self, slot: int) -> int:
        """How many times ``slot``'s factors were written (register or
        evict): two K/V computations with one (slot, version) used the same
        factors."""
        return self._versions[slot]

    def register(self, adapter_id: str, factors: dict) -> int:
        """Installs (or overwrites) one adapter's factors; returns its slot.

        ``factors``: ``{target: (A, B)}`` (numpy arrays or tensors) with
        ``A`` of shape ``(n_layer, rank, in_t)`` and ``B`` of shape
        ``(n_layer, out_t, rank)`` for every registry target.  Raises
        :class:`RegistryFullError` when no slot is free."""
        missing = [t for t in self.targets if t not in factors]
        if missing:
            raise ValueError(f"factors missing targets {missing} (registry targets "
                             f"{self.targets})")
        L = self.cfg.n_layer
        staged = {}
        for t in self.targets:
            fin, fout = _target_features(self.cfg, t)
            a, b = (torch.as_tensor(x if isinstance(x, torch.Tensor) else np.array(x))
                    .to(device=self.device, dtype=self.dtype) for x in factors[t])
            want_a, want_b = (L, self.rank, fin), (L, fout, self.rank)
            if tuple(a.shape) != want_a or tuple(b.shape) != want_b:
                raise ValueError(f"adapter {adapter_id!r} target {t!r}: A/B shapes "
                                 f"{tuple(a.shape)}/{tuple(b.shape)} != expected "
                                 f"{want_a}/{want_b}")
            staged[t] = (a, b)
        slot = self._slot_of.get(adapter_id)
        if slot is None:
            if not self._free:
                raise RegistryFullError(f"registry full ({self.max_adapters} adapters); evict "
                                        f"one before registering {adapter_id!r}")
            slot = self._free.pop()
        for t, (a, b) in staged.items():
            self.arenas[t]["a"][slot].copy_(a)
            self.arenas[t]["b"][slot].copy_(b)
        self._slot_of[adapter_id] = slot
        self._versions[slot] += 1
        self._gauges()
        return slot

    def evict(self, adapter_id: str) -> None:
        """Removes an adapter and zeroes its slot (an in-flight request
        still carrying the slot degrades to the base model)."""
        slot = self.slot(adapter_id)
        for t in self.targets:
            self.arenas[t]["a"][slot].zero_()
            self.arenas[t]["b"][slot].zero_()
        del self._slot_of[adapter_id]
        self._free.append(slot)
        self._versions[slot] += 1
        self._gauges()

    def place(self, mesh) -> None:
        """Replicating the arenas across a mesh belongs to the mesh slice of
        the port, which is not ported."""
        raise NotImplementedError("AdapterRegistry.place: meshes are not ported to "
                                  "thunder_tpu_torch yet")

    def state_snapshot(self) -> dict:
        """Registry occupancy for the engine's stats."""
        return {
            "rank": self.rank,
            "slots": self.max_adapters,
            "slots_used": self.slots_used,
            "targets": list(self.targets),
            "scaling": self.scaling,
            "adapters": sorted(self._slot_of),
        }

    def _gauges(self) -> None:
        reg = _metrics()
        reg.gauge("serving.lora.slots").set(self.max_adapters)
        reg.gauge("serving.lora.adapters").set(self.slots_used)


def gather_adapter_slots(arenas: dict, slots: torch.Tensor) -> dict:
    """Each request's factors by slot index: ``{t: {"a": (S, L, r, fin),
    "b": (S, L, fout, r)}}`` and ``slots`` (B,) integer → ``{t: {"a":
    (B, L, r, fin), "b": (B, L, fout, r)}}``, the per-request layout
    ``forward_with_cache(lora=...)`` consumes (one copy per call)."""
    idx = slots.to(device=next(iter(arenas.values()))["a"].device, dtype=torch.long)
    return {t: {"a": ab["a"].index_select(0, idx), "b": ab["b"].index_select(0, idx)}
            for t, ab in arenas.items()}


def make_lora_factors(cfg, rank: int, generator: torch.Generator, targets=_TARGETS, *,
                      std: float = 0.05, dtype=torch.float32) -> dict:
    """Random LoRA factors for tests and benches, drawn N(0, std) in float32
    from ``generator`` on its device, then cast to ``dtype`` (both A and B
    nonzero, so the delta moves the logits; real fine-tunes start B at
    zero).  ``torch.Generator`` and ``jax.random`` give different numbers:
    tests that compare the two packages register the same arrays in both."""
    dev = generator.device
    out = {}
    for t in targets:
        fin, fout = _target_features(cfg, t)
        a = torch.randn((cfg.n_layer, rank, fin), generator=generator, device=dev) * std
        b = torch.randn((cfg.n_layer, fout, rank), generator=generator, device=dev) * std
        out[t] = (a.to(dtype), b.to(dtype))
    return out
