"""Gate process: client socket ownership + protocol fan-in.

Reference parity: ``components/gate`` — the gate owns client connections,
assigns ClientIDs, generates boot-entity IDs, forwards client RPCs into the
dispatcher fabric and pushes entity/attr/position updates back out to clients
(gate.go:57-101, GateService.go).
"""

from goworld_tpu_torch.gate.filter_tree import FilterTree
from goworld_tpu_torch.gate.service import GateService, run

__all__ = ["FilterTree", "GateService", "run"]
