"""Training steps of the port (counterpart of ``thunder_tpu/distributed``):
``make_train_step``/``TrainStep`` over the trace, on one device or sharded
over a mesh of ranks (DDP, FSDP ZeRO-2/3, ``tp_fsdp`` at ``tp`` = 1), the
collective prims, the sharding rules, checkpoints of placed trees,
process-group bring-up and the launcher; ``make_eager_train_step`` is the
single-device step's plain twin.  Ring/Ulysses sequence parallelism,
pipelines, expert parallelism and tensor parallelism are later slices."""
from thunder_tpu_torch.distributed import prims  # noqa: F401  (registers the torch impls)
from thunder_tpu_torch.distributed.api import (
    EagerTrainStep,
    TrainStep,
    combine_threshold_options,
    ddp,
    default_batch_shardings,
    fsdp,
    make_eager_train_step,
    make_train_step,
    tp_fsdp,
)
from thunder_tpu_torch.distributed.checkpoint import (
    StateDictOptions,
    full_state_dict,
    latest_step,
    load_checkpoint,
    save_checkpoint,
)
from thunder_tpu_torch.distributed.launch import launch
from thunder_tpu_torch.distributed.multihost import hybrid_mesh, initialize as initialize_multihost
from thunder_tpu_torch.distributed.prims import DistributedReduceOps
from thunder_tpu_torch.distributed.sharding import (
    P,
    PartitionSpec,
    ShardingRules,
    apply_shardings,
    batch_spec,
    ddp_shardings,
    fsdp_shardings,
    kv_cache_spec,
    llama_shardings,
    make_mesh,
)

__all__ = [
    "EagerTrainStep",
    "TrainStep",
    "ddp",
    "fsdp",
    "tp_fsdp",
    "make_train_step",
    "make_eager_train_step",
    "combine_threshold_options",
    "default_batch_shardings",
    "DistributedReduceOps",
    "P",
    "PartitionSpec",
    "ShardingRules",
    "apply_shardings",
    "batch_spec",
    "ddp_shardings",
    "fsdp_shardings",
    "kv_cache_spec",
    "llama_shardings",
    "make_mesh",
    "prims",
    "StateDictOptions",
    "full_state_dict",
    "save_checkpoint",
    "load_checkpoint",
    "latest_step",
    "hybrid_mesh",
    "initialize_multihost",
    "launch",
]
