"""Message protocol: the wire ABI between game / gate / dispatcher / client.

Reference parity: ``engine/proto`` — MsgType ranges (proto.go:19-133):
1..999 dispatcher-handled, 1001..1499 redirected by dispatcher to the owning
client's gate, 1501..1999 gate-handled broadcast, 2001+ gate↔client direct.
"""

from goworld_tpu_torch.proto.msgtypes import MsgType, FilterOp
from goworld_tpu_torch.proto.conn import GoWorldConnection, SYNC_RECORD_SIZE

__all__ = ["MsgType", "FilterOp", "GoWorldConnection", "SYNC_RECORD_SIZE"]
