"""Executors of the port (counterpart of ``thunder_tpu/executors``).

Importing the package registers the built-in executors in priority order:
``cuda`` (``cudaex``: the hand-written kernels' claims of SDPA and its
backward) ≻ ``inductor`` (``inductorex``: maximal fusible regions, each one
``torch.compile`` program on the card) ≻ ``torch`` (``torchex``: every prim
as a torch call, also the always-executor), the reference's order of
``pallas`` ≻ ``xla`` ≻ ``jax``.  ``quantex`` registers the opt-in
quantization executors ``quant_int8`` and ``quant_fp8`` without making them
defaults.
"""
from thunder_tpu_torch.executors import torchex  # noqa: F401  (registers "torch", default+always)
from thunder_tpu_torch.executors import inductorex  # noqa: F401  (registers "inductor", default)
from thunder_tpu_torch.executors import cudaex  # noqa: F401  (registers "cuda")
from thunder_tpu_torch.executors import quantex  # noqa: F401  (registers "quant_int8", "quant_fp8")
from thunder_tpu_torch.executors.cudaex import cuda_ex
from thunder_tpu_torch.executors.inductorex import inductor_ex
from thunder_tpu_torch.extend import add_default_executor
from thunder_tpu_torch.executors.torchex import torch_ex

add_default_executor(cuda_ex)  # ahead of the fusion executor, so the claiming pass prefers the kernels

__all__ = ["cuda_ex", "inductor_ex", "quantex", "torch_ex"]
