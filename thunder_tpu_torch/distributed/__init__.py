"""Training step of the port (counterpart of ``thunder_tpu/distributed``):
single-device ``make_train_step``/``TrainStep``; meshes and sharded modes
are not ported yet."""
from thunder_tpu_torch.distributed.api import TrainStep, make_train_step

__all__ = ["TrainStep", "make_train_step"]
