"""The multi-device layer: meshes, sharded tensors, collectives, the mesh
bodies of the server ops, the batched evaluator (``parallel.batch``) and
the distributed NTT (port of ``seal_tpu/parallel``)."""

from .mesh import (
    DeviceMesh,
    HEMesh,
    PartitionSpec,
    ShardedTensor,
    make_mesh,
    shard,
    shard_batch,
    shard_kswitch_key,
)
