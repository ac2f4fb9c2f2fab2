from misonet_tpu_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    make_mesh_for_batch,
    replicate,
    shard_batch,
)

__all__ = ["Mesh", "make_mesh", "make_mesh_for_batch", "replicate",
           "shard_batch"]
