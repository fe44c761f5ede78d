"""Data, ZeRO-1 and tensor parallelism over ``torch.distributed`` (port of
``sd_tpu/parallel``): ``mesh.py`` (process groups, the mesh, data
parallelism, ZeRO-1 over an LDM's AdamW or a first stage's two Adams), ``tp.py`` (Megatron tensor parallelism of the UNet)
and ``sharded_sampling.py``."""

from sd_tpu_torch.parallel.mesh import (
    init_distributed,
    is_main_process,
    make_mesh,
    shard_batch,
    shard_params,
    zero_optimizer,
    zero_sharding,
    zero_state_sharding,
)

__all__ = ["init_distributed", "is_main_process", "make_mesh", "shard_batch", "shard_params",
           "zero_optimizer", "zero_sharding", "zero_state_sharding"]
