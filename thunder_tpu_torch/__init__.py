"""thunder_tpu_torch: the PyTorch/CUDA port of thunder_tpu.

A package beside the JAX reference (``thunder_tpu/``) that imports neither
JAX nor the reference package.  Its layout mirrors ``thunder_tpu/`` module
for module.  This slice carries the serving path: the Llama model family
(``models``, with speculative decoding), the serving engine (``serving``:
paged decode, chunked prefill, speculative serving, quantized KV,
multi-tenant LoRA), the single-device train step, and the hand-written
Hopper kernels of those paths (``executors.cudaex`` over ``csrc/``).  Entry points run on the card unless the
caller passes ``device="cpu"``.
"""
from thunder_tpu_torch.distributed.api import TrainStep, make_train_step
from thunder_tpu_torch.models.generate import generate
from thunder_tpu_torch.models.llama import Config, gpt_loss, init_params
from thunder_tpu_torch.models.weights import params_from_numpy
from thunder_tpu_torch.serving.engine import ServingEngine, serve
from thunder_tpu_torch.serving.lora import (
    AdapterRegistry,
    RegistryFullError,
    make_lora_factors,
    valid_targets,
)
from thunder_tpu_torch.serving.speculative import SpecConfig
from thunder_tpu_torch.train.loop import TrainLoopResult, train_loop
from thunder_tpu_torch.train.optim import adamw

__all__ = ["AdapterRegistry", "Config", "RegistryFullError", "ServingEngine", "SpecConfig",
           "TrainLoopResult", "TrainStep", "adamw", "generate", "gpt_loss", "init_params",
           "make_lora_factors", "make_train_step", "params_from_numpy", "serve", "train_loop",
           "valid_targets"]
