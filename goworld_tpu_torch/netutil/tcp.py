"""TCP server/client helpers.

Reference parity: ``engine/netutil/TCPServer.go:22-65`` (ServeTCPForever with
retry) and the dial side used by dispatcherclient. Socket buffer sizes follow
consts (reference consts.go:14-61).
"""

from __future__ import annotations

import asyncio
import socket
from typing import Awaitable, Callable

from goworld_tpu_torch import consts
from goworld_tpu_torch.utils import gwlog

ConnHandler = Callable[[asyncio.StreamReader, asyncio.StreamWriter], Awaitable[None]]


def _tune_socket(sock: socket.socket) -> None:
    try:
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        sock.setsockopt(
            socket.SOL_SOCKET, socket.SO_SNDBUF, consts.CONNECTION_WRITE_BUFFER_SIZE
        )
        sock.setsockopt(
            socket.SOL_SOCKET, socket.SO_RCVBUF, consts.CONNECTION_READ_BUFFER_SIZE
        )
    except OSError:
        pass


async def serve_tcp_forever(
    host: str, port: int, handler: ConnHandler
) -> asyncio.AbstractServer:
    """Start a TCP server; each connection runs ``handler`` in its own task
    (the asyncio analog of goroutine-per-conn, TCPServer.go:49-64)."""

    async def wrapped(reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        sock = writer.get_extra_info("socket")
        if sock is not None:
            _tune_socket(sock)
        try:
            await handler(reader, writer)
        except Exception as e:  # noqa: BLE001 - connection handlers must not kill the server
            gwlog.errorf("connection handler error from %s: %s",
                         writer.get_extra_info("peername"), e)
        finally:
            try:
                writer.close()
            except Exception:
                pass

    server = await asyncio.start_server(wrapped, host, port)
    return server


async def connect_tcp(
    host: str, port: int
) -> tuple[asyncio.StreamReader, asyncio.StreamWriter]:
    reader, writer = await asyncio.open_connection(host, port)
    sock = writer.get_extra_info("socket")
    if sock is not None:
        _tune_socket(sock)
    return reader, writer
