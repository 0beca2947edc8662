"""Row-sharded evaluation over a device mesh (`TextureProcessor(mesh=...)`).

Port of the row side of `kanter_core_tpu/parallel/`. The batch side
(`BatchedGraph`, `BatchedLiveSession`) is not ported yet.
"""

from .sharded import (
    MESH_COUNTERS,
    ROW_AXIS,
    Mesh,
    ShardedPlane,
    make_mesh,
    map_bands,
    place,
    shard_planes_rows,
)

__all__ = [
    "MESH_COUNTERS",
    "ROW_AXIS",
    "Mesh",
    "ShardedPlane",
    "make_mesh",
    "map_bands",
    "place",
    "shard_planes_rows",
]
