from situation3d_tpu_torch.parallel.mesh import (  # noqa: F401
    batch_sharding,
    make_mesh,
    replicated,
    shard_batch,
)
