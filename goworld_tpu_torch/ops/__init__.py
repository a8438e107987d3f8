"""Compute plane of the port: the AOI neighbor engine and its event kernel."""

from goworld_tpu_torch.ops.neighbor import NeighborEngine, NeighborParams

__all__ = ["NeighborEngine", "NeighborParams"]
