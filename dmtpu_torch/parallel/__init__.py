"""Parallelism layer: the (data, fsdp) mesh, shardings, the train step,
ring attention, tensor and pipeline parallelism."""
from dmtpu_torch.parallel.mesh import (
    DATA_AXIS,
    FSDP_AXIS,
    batch_sharding,
    make_mesh,
    param_sharding,
    replicated_sharding,
    shard_batch,
)
from dmtpu_torch.parallel.pp import dit_pipeline_forward, pipeline_apply, stack_block_params
from dmtpu_torch.parallel.sp import sp_attention
from dmtpu_torch.parallel.tp import shard_params_tp, tp_param_sharding
from dmtpu_torch.parallel.train import (
    TrainState,
    make_diffusion_loss_fn,
    make_train_step,
    shard_train_state,
    step_generator,
)

__all__ = [
    "DATA_AXIS",
    "FSDP_AXIS",
    "make_mesh",
    "batch_sharding",
    "param_sharding",
    "replicated_sharding",
    "shard_batch",
    "TrainState",
    "make_train_step",
    "make_diffusion_loss_fn",
    "shard_train_state",
    "step_generator",
    "tp_param_sharding",
    "shard_params_tp",
    "sp_attention",
    "pipeline_apply",
    "stack_block_params",
    "dit_pipeline_forward",
]
