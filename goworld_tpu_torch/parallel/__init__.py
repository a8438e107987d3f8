"""Sharded AOI tiers of the port: the entity-sharded engine over a list of
devices (``mesh``), the strip+halo engine (``spatial``) and the
multi-process engine over ``torch.distributed`` (``multihost``).

The JAX package's ``parallel/compat.py`` has no counterpart: it resolves
``shard_map`` across jax versions, and PyTorch has no ``shard_map``; a
per-shard body here is a loop over the mesh's shards, and a collective is
device-side tensor movement (``mesh.all_gather``) or, between processes, a
Gloo gather (``multihost``).
"""

from goworld_tpu_torch.parallel.mesh import ShardedNeighborEngine, make_mesh
from goworld_tpu_torch.parallel.multihost import (
    MultiHostNeighborEngine,
    init_multihost,
)
from goworld_tpu_torch.parallel.spatial import SpatialShardedNeighborEngine

__all__ = [
    "MultiHostNeighborEngine",
    "ShardedNeighborEngine",
    "SpatialShardedNeighborEngine",
    "init_multihost",
    "make_mesh",
]
