"""AOI (area-of-interest) managers.

The seam mirrors the reference's ``aoi.AOIManager`` interface
(Space.go:33,105: Enter/Leave/Moved + OnEnterAOI/OnLeaveAOI callbacks on
entities). Two implementations:

- ``XZListAOIManager`` — CPU sweep-list, per-space, synchronous callbacks
  (reimplementation of the go-aoi XZList idea, SURVEY.md §2.4).
- ``BatchAOIService`` + ``BatchSpaceAOIManager`` — the GPU path: all spaces'
  positions batched into one NeighborEngine launch per tick; enter/leave
  diffs delivered at tick boundaries (SURVEY.md §7.1).
"""

from goworld_tpu_torch.entity.aoi.base import AOIManagerBase
from goworld_tpu_torch.entity.aoi.xzlist import XZListAOIManager
from goworld_tpu_torch.entity.aoi.batched import BatchAOIService, BatchSpaceAOIManager

__all__ = [
    "AOIManagerBase",
    "XZListAOIManager",
    "BatchAOIService",
    "BatchSpaceAOIManager",
]
