"""Serving subsystem of the port (counterpart of ``thunder_tpu/serving``):
``serve(None, params, cfg, ...)`` → a continuous-batching engine over a
paged KV pool, decoding through the hand-written paged-attention kernels,
with chunked prefill (``prefill_chunk=``), speculative serving
(``speculative=SpecConfig(...)``), int8/fp8 KV storage (``kv_dtype=``) and
multi-tenant LoRA adapters (``lora=AdapterRegistry(...)``), multi-step
decode (``decode_steps=N``) and fault recovery (``fault_plan=FaultPlan(...)``,
``retry=RetryPolicy(...)``); on the card the bucket steps run as CUDA
graphs (:mod:`serving.graphs`).  Stateful serving: resident sessions
(``sessions=``, :mod:`serving.sessions`), priority classes with SLO-gated
admission and preemption (``priorities=``, :mod:`serving.priority`),
constrained decoding (``constraints=True``, :mod:`serving.constrain`);
``replicas=N`` returns the replica router (:mod:`serving.router`)."""
from thunder_tpu_torch.serving.engine import (
    AdmissionError,
    EngineStalledError,
    RecoveryError,
    RequestHandle,
    RequestResult,
    ServingEngine,
    serve,
)
from thunder_tpu_torch.serving.constrain import (
    Constraint,
    ConstraintLookaheadError,
    DFAConstraint,
    TokenSetConstraint,
    sequence_constraint,
)
from thunder_tpu_torch.serving.faults import FaultPlan, FaultSpec, RetryPolicy
from thunder_tpu_torch.serving.kv_pool import PagedKVPool, PoolExhaustedError
from thunder_tpu_torch.serving.lora import (
    AdapterRegistry,
    RegistryFullError,
    make_lora_factors,
    valid_targets,
)
from thunder_tpu_torch.serving.priority import (
    PRIORITY_HIGH,
    PRIORITY_LEVELS,
    PRIORITY_LOW,
    PRIORITY_NORMAL,
    PriorityConfig,
    PriorityGate,
)
from thunder_tpu_torch.serving.router import ReplicatedEngine, RoutedHandle
from thunder_tpu_torch.serving.sessions import SessionConfig, SessionEntry, SessionTable
from thunder_tpu_torch.serving.speculative import SpecConfig

__all__ = [
    "AdapterRegistry",
    "AdmissionError",
    "Constraint",
    "ConstraintLookaheadError",
    "DFAConstraint",
    "EngineStalledError",
    "FaultPlan",
    "FaultSpec",
    "PRIORITY_HIGH",
    "PRIORITY_LEVELS",
    "PRIORITY_LOW",
    "PRIORITY_NORMAL",
    "PagedKVPool",
    "PoolExhaustedError",
    "PriorityConfig",
    "PriorityGate",
    "RecoveryError",
    "RegistryFullError",
    "ReplicatedEngine",
    "RequestHandle",
    "RequestResult",
    "RetryPolicy",
    "RoutedHandle",
    "ServingEngine",
    "SessionConfig",
    "SessionEntry",
    "SessionTable",
    "SpecConfig",
    "TokenSetConstraint",
    "make_lora_factors",
    "sequence_constraint",
    "serve",
    "valid_targets",
]
