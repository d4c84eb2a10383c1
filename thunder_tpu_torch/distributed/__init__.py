"""Training step of the port (counterpart of ``thunder_tpu/distributed``):
single-device ``make_train_step``/``TrainStep`` over the trace, and its
plain twin ``make_eager_train_step``; meshes and sharded modes are not
ported yet."""
from thunder_tpu_torch.distributed.api import (
    EagerTrainStep,
    TrainStep,
    make_eager_train_step,
    make_train_step,
)

__all__ = ["EagerTrainStep", "TrainStep", "make_eager_train_step", "make_train_step"]
