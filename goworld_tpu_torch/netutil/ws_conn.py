"""WebSocket packet transport.

Reference parity: the gate serves WebSocket clients next to TCP/KCP
(gate.go:92-95 via golang.org/x/net/websocket; GateService.go:167-172).
Python-native design: the ``websockets`` library carries one packet per
binary message — WS frames preserve boundaries, so no length prefix is
needed; the wire body is [u16 msgtype][payload], identical to the TCP
framing minus the length word. Compression rides WS permessage-deflate
(negotiated by the library) instead of the TCP path's explicit zlib flag.

``WSPacketConnection`` presents the same surface as ``PacketConnection``
so ``GoWorldConnection`` and the gate logic are transport-agnostic. Sends
are serialized through one writer task per connection, mirroring how the
TCP path's pending-buffer flush keeps per-connection FIFO order.
"""

from __future__ import annotations

import asyncio
import struct

from goworld_tpu_torch import consts
from goworld_tpu_torch.netutil.packet import Packet
from goworld_tpu_torch.netutil.packet_conn import ConnectionClosed


class WSPacketConnection:
    """PacketConnection-shaped adapter over a websockets protocol object."""

    # A stalled client may never drain its socket; beyond this many queued
    # packets the connection is evicted rather than growing without bound
    # (the TCP path gets the same protection from SO_SNDBUF + drop counters).
    MAX_QUEUED = 4096

    def __init__(self, ws) -> None:
        self._ws = ws
        self._closed = False
        self._outq: asyncio.Queue = asyncio.Queue()
        self._writer_task = asyncio.get_running_loop().create_task(self._writer())
        self.dropped = 0

    @property
    def peername(self):
        try:
            return self._ws.remote_address
        except Exception:
            return None

    def enable_compression(self, fmt: str = "snappy") -> None:
        pass  # permessage-deflate is negotiated at the WS handshake

    # --- send --------------------------------------------------------------

    def send_packet(self, msgtype: int, packet: Packet) -> None:
        if self._closed:
            self.dropped += 1
            return
        body = struct.pack("<H", msgtype) + packet.payload
        if len(body) > consts.MAX_PACKET_SIZE:
            raise ValueError(f"packet too large: {len(body)}")
        if self._outq.qsize() >= self.MAX_QUEUED:
            self.dropped += 1
            self.close()  # stalled client: evict instead of growing forever
            return
        self._outq.put_nowait(body)

    async def _writer(self) -> None:
        """Single writer → per-connection FIFO send order."""
        try:
            while True:
                body = await self._outq.get()
                await self._ws.send(body)
        except asyncio.CancelledError:
            pass
        except Exception:
            # Packets already queued will never reach the peer: account for
            # them as dropped and tear the socket down.
            self.close()
        finally:
            while not self._outq.empty():
                self._outq.get_nowait()
                self.dropped += 1

    def flush(self) -> None:
        pass  # the writer task drains continuously

    async def drain(self) -> None:
        pass  # the writer task drains continuously

    # --- recv --------------------------------------------------------------

    async def recv_packet(self) -> tuple[int, Packet]:
        try:
            msg = await self._ws.recv()
        except Exception:
            raise ConnectionClosed("websocket closed")
        if isinstance(msg, str):
            msg = msg.encode()
        if len(msg) < 2 or len(msg) > consts.MAX_PACKET_SIZE:
            raise ConnectionClosed(f"bad ws packet length {len(msg)}")
        msgtype = struct.unpack_from("<H", msg, 0)[0]
        return msgtype, Packet(bytes(msg[2:]))

    # --- close -------------------------------------------------------------

    def close(self) -> None:
        self._closed = True
        self._writer_task.cancel()
        try:
            task = asyncio.get_running_loop().create_task(self._ws.close())
            # Retrieve the result so the loop doesn't log "exception was
            # never retrieved" — but a CANCELLED close (loop teardown)
            # must be probed with cancelled() first: t.exception() raises
            # CancelledError out of the callback and spams the log.
            task.add_done_callback(
                lambda t: None if t.cancelled() else t.exception())
        except RuntimeError:
            pass

    @property
    def closed(self) -> bool:
        return self._closed
