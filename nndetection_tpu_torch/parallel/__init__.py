from nndetection_tpu_torch.parallel.mesh import (
    batch_sharding,
    make_mesh,
    replicate_sharding,
    shard_batch,
)

__all__ = ["make_mesh", "batch_sharding", "replicate_sharding", "shard_batch"]
