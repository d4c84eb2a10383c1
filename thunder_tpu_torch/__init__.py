"""thunder_tpu_torch: the PyTorch/CUDA port of thunder_tpu.

A package beside the JAX reference (``thunder_tpu/``) that imports neither
JAX nor the reference package.  Its layout mirrors ``thunder_tpu/`` module
for module.  This slice carries the serving path: the Llama model family
(``models``, with speculative decoding), the serving engine (``serving``:
paged decode, chunked prefill, speculative serving), and the hand-written
Hopper kernels of those paths (``executors.cudaex`` over ``csrc/``).  Entry points run on the card unless the
caller passes ``device="cpu"``.
"""
from thunder_tpu_torch.models.generate import generate
from thunder_tpu_torch.models.llama import Config, init_params
from thunder_tpu_torch.models.weights import params_from_numpy
from thunder_tpu_torch.serving.engine import ServingEngine, serve
from thunder_tpu_torch.serving.speculative import SpecConfig

__all__ = ["Config", "ServingEngine", "SpecConfig", "generate", "init_params",
           "params_from_numpy", "serve"]
