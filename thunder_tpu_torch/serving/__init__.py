"""Serving subsystem of the port (counterpart of ``thunder_tpu/serving``):
``serve(None, params, cfg, ...)`` → a continuous-batching engine over a
paged KV pool, decoding through the hand-written paged-attention kernels,
with chunked prefill (``prefill_chunk=``), speculative serving
(``speculative=SpecConfig(...)``), int8/fp8 KV storage (``kv_dtype=``) and
multi-tenant LoRA adapters (``lora=AdapterRegistry(...)``)."""
from thunder_tpu_torch.serving.engine import (
    AdmissionError,
    EngineStalledError,
    RequestHandle,
    RequestResult,
    ServingEngine,
    serve,
)
from thunder_tpu_torch.serving.kv_pool import PagedKVPool, PoolExhaustedError
from thunder_tpu_torch.serving.lora import (
    AdapterRegistry,
    RegistryFullError,
    make_lora_factors,
    valid_targets,
)
from thunder_tpu_torch.serving.speculative import SpecConfig

__all__ = [
    "AdapterRegistry",
    "AdmissionError",
    "EngineStalledError",
    "PagedKVPool",
    "PoolExhaustedError",
    "RegistryFullError",
    "RequestHandle",
    "RequestResult",
    "ServingEngine",
    "SpecConfig",
    "make_lora_factors",
    "serve",
    "valid_targets",
]
