"""msgpack codec helpers.

Reference parity: ``engine/netutil/MessagePackMsgPacker.go:13-29`` — all
structured payloads (RPC args, attrs, migrate data) travel as msgpack.
"""

from __future__ import annotations

import msgpack


def pack_msg(obj) -> bytes:
    return msgpack.packb(obj, use_bin_type=True)


def unpack_msg(data: bytes):
    return msgpack.unpackb(data, raw=False, strict_map_key=False)
