"""Sharded AOI tiers of the port: the strip+halo engine over a list of
devices (``spatial``) and the all-gather pieces it falls back to
(``mesh``)."""

from goworld_tpu_torch.parallel.mesh import make_mesh
from goworld_tpu_torch.parallel.spatial import SpatialShardedNeighborEngine

__all__ = ["SpatialShardedNeighborEngine", "make_mesh"]
