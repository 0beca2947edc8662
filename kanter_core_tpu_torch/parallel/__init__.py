"""Scale-out over a device mesh: the row-sharded evaluation of one canvas
(`TextureProcessor(mesh=...)`) and the batched evaluation of many
(`BatchedGraph`, `BatchedLiveSession`, batch-sharded over a `"batch"`
mesh). Port of `kanter_core_tpu/parallel/`; a mesh of both axes is not yet
ported.
"""

from .session import BatchedLiveSession
from .sharded import (
    BATCH_AXIS,
    MESH_COUNTERS,
    ROW_AXIS,
    BatchedGraph,
    BatchShards,
    Mesh,
    ShardedPlane,
    make_mesh,
    map_bands,
    place,
    shard_planes_batch,
    shard_planes_rows,
)

__all__ = [
    "BATCH_AXIS",
    "MESH_COUNTERS",
    "ROW_AXIS",
    "BatchShards",
    "BatchedGraph",
    "BatchedLiveSession",
    "Mesh",
    "ShardedPlane",
    "make_mesh",
    "map_bands",
    "place",
    "shard_planes_batch",
    "shard_planes_rows",
]
