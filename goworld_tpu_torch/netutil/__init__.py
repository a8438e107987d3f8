"""Framed packet transport.

Reference parity: ``engine/netutil`` — 4-byte little-endian length prefix +
payload (PacketConnection.go:50-61), ``Packet`` append/read codecs
(Packet.go:210-503), msgpack for structured fields (MsgPacker.go:3-12), and
``ServeTCPForever`` (TCPServer.go:22). Async IO replaces goroutine-per-conn.
"""

from goworld_tpu_torch.netutil.packet import Packet
from goworld_tpu_torch.netutil.packet_conn import PacketConnection, ConnectionClosed
from goworld_tpu_torch.netutil.msgpacker import pack_msg, unpack_msg
from goworld_tpu_torch.netutil.tcp import serve_tcp_forever, connect_tcp

__all__ = [
    "Packet",
    "PacketConnection",
    "ConnectionClosed",
    "pack_msg",
    "unpack_msg",
    "serve_tcp_forever",
    "connect_tcp",
]
