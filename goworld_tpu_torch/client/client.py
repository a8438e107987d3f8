"""Headless game client: entity mirrors, attr sync, RPC, position sync.

Reference parity: ``examples/test_client/ClientBot.go:40-579`` (connection,
packet pump, entity bookkeeping, sync records) and ``ClientEntity.go:99-242``
(client-side entity with attrs applied from NOTIFY_*_ON_CLIENT messages and
server-callable methods dispatched by name).

``strict`` mode promotes any protocol inconsistency to :class:`StrictError`
(the reference's ``-strict`` flag turns errors fatal, ClientBot.go:571-578).
"""

from __future__ import annotations

import asyncio
import ssl
from typing import Callable, Optional

from goworld_tpu_torch.netutil.packet import Packet
from goworld_tpu_torch.netutil.packet_conn import ConnectionClosed, PacketConnection
from goworld_tpu_torch.proto.conn import (
    DELTA_SYNC_RECORD_SIZE,
    SYNC_RECORD_SIZE,
    GoWorldConnection,
    pack_sync_record,
)
from goworld_tpu_torch.proto.msgtypes import MsgType
from goworld_tpu_torch.utils import gwlog


class StrictError(Exception):
    """A protocol inconsistency observed in strict mode."""


class ClientEntity:
    """Client-side mirror of a server entity (ClientEntity.go:99-242)."""

    def __init__(
        self, bot: "ClientBot", eid: str, typename: str, is_player: bool,
        attrs: dict, x: float, y: float, z: float, yaw: float,
    ) -> None:
        self.bot = bot
        self.id = eid
        self.typename = typename
        self.is_player = is_player
        self.attrs = attrs
        self.x, self.y, self.z, self.yaw = x, y, z, yaw
        self.destroyed = False
        # v6 adaptive sync: deltas are only decodable after a full-
        # precision keyframe established the baseline — the CREATE
        # position deliberately does NOT count (the server forces a
        # keyframe as every pair's first emission, so a delta arriving
        # first is a stale-baseline protocol violation, strict-checked).
        self.delta_ready = False
        self.keyframes = 0
        self.deltas = 0

    # --- server → client ----------------------------------------------------

    def _navigate(self, path: list):
        """Walk the attr tree along ``path`` (root first)."""
        node = self.attrs
        for key in path:
            node = node[key]
        return node

    def apply_attr_change(self, msgtype: int, path: list, args: tuple) -> None:
        try:
            node = self._navigate(path)
            if msgtype == MsgType.NOTIFY_MAP_ATTR_CHANGE_ON_CLIENT:
                node[args[0]] = args[1]
            elif msgtype == MsgType.NOTIFY_MAP_ATTR_DEL_ON_CLIENT:
                node.pop(args[0], None)
            elif msgtype == MsgType.NOTIFY_MAP_ATTR_CLEAR_ON_CLIENT:
                node.clear()
            elif msgtype == MsgType.NOTIFY_LIST_ATTR_CHANGE_ON_CLIENT:
                node[args[0]] = args[1]
            elif msgtype == MsgType.NOTIFY_LIST_ATTR_APPEND_ON_CLIENT:
                node.append(args[0])
            elif msgtype == MsgType.NOTIFY_LIST_ATTR_POP_ON_CLIENT:
                node.pop()
        except (KeyError, IndexError, TypeError) as exc:
            self.bot.error(f"attr change {msgtype} at path {path!r} failed: {exc}")

    def on_call(self, method: str, args: list) -> None:
        """Dispatch a server→client RPC to ``method`` on this mirror, if the
        user subclass/handler defines it (ClientEntity method dispatch)."""
        fn = getattr(self, method, None)
        if callable(fn):
            fn(*args)
        else:
            handler = self.bot.rpc_handlers.get((self.typename, method)) or (
                self.bot.rpc_handlers.get((None, method))
            )
            if handler is not None:
                handler(self, *args)
            else:
                self.bot.error(f"no client method {self.typename}.{method}")

    # --- client → server ----------------------------------------------------

    def call_server(self, method: str, *args) -> None:
        self.bot.call_server_method(self.id, method, args)

    def sync_position(self, x: float, y: float, z: float, yaw: float) -> None:
        self.x, self.y, self.z, self.yaw = x, y, z, yaw
        self.bot.send_sync_position(self.id, x, y, z, yaw)

    def __repr__(self) -> str:
        return f"ClientEntity<{self.typename}|{self.id}|player={self.is_player}>"


class ClientBot:
    """One headless client connection to a gate."""

    def __init__(
        self,
        name: str = "bot",
        strict: bool = False,
        heartbeat_interval: float = 5.0,
        tls: bool = False,
        compress: bool = False,
        compress_format: str = "snappy",
    ) -> None:
        self.name = name
        self.strict = strict
        self.heartbeat_interval = heartbeat_interval
        self.tls = tls
        self.compress = compress
        self.compress_format = compress_format
        self.conn: Optional[GoWorldConnection] = None
        self.entities: dict[str, ClientEntity] = {}
        self.player: Optional[ClientEntity] = None
        self.errors: list[str] = []
        # (typename|None, method) → handler(entity, *args); plus subclass hooks
        self.rpc_handlers: dict[tuple[Optional[str], str], Callable] = {}
        self.on_create_entity: Optional[Callable[[ClientEntity], None]] = None
        self.on_destroy_entity: Optional[Callable[[ClientEntity], None]] = None
        self._player_waiters: list[asyncio.Future] = []
        self._tasks: list[asyncio.Task] = []
        self.entity_class: type[ClientEntity] = ClientEntity

    # --- lifecycle ----------------------------------------------------------

    async def connect(self, host: str, port: int) -> None:
        ssl_ctx = None
        if self.tls:
            ssl_ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
            ssl_ctx.check_hostname = False
            ssl_ctx.verify_mode = ssl.CERT_NONE
        reader, writer = await asyncio.open_connection(host, port, ssl=ssl_ctx)
        pconn = PacketConnection(reader, writer)
        if self.compress:
            pconn.enable_compression(self.compress_format)
        self.conn = GoWorldConnection(pconn)
        self._start_pumps()

    async def connect_ws(self, host: str, port: int) -> None:
        """Connect over WebSocket (reference bots pick -mode ws,
        ClientBot.go transport selection)."""
        import websockets

        from goworld_tpu_torch.netutil.ws_conn import WSPacketConnection

        scheme = "wss" if self.tls else "ws"
        ssl_ctx = None
        if self.tls:
            # Same relaxed context as the TCP path: the gate's cert is
            # self-signed in dev/test deployments.
            ssl_ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
            ssl_ctx.check_hostname = False
            ssl_ctx.verify_mode = ssl.CERT_NONE
        from goworld_tpu_torch import consts

        ws = await websockets.connect(
            f"{scheme}://{host}:{port}/", max_size=consts.MAX_PACKET_SIZE, ssl=ssl_ctx
        )
        self.conn = GoWorldConnection(WSPacketConnection(ws))
        self._start_pumps()

    async def connect_rudp(
        self, host: str, port: int, loss_simulation: float = 0.0,
        protocol: str = "kcp", fec: tuple[int, int] | None = (10, 3),
    ) -> None:
        """Connect over reliable UDP. ``protocol``: "kcp" = the real KCP
        wire protocol (the reference's -mode kcp; netutil/kcp.py) or
        "native" = the in-repo ARQ (netutil/rudp.py). ``fec`` (kcp only)
        must MATCH the gate's [gate] rudp_fec — the FEC framing is not
        self-identifying; (10, 3) is both sides' default.
        ``loss_simulation`` drops that fraction of outgoing datagrams —
        the ARQ layer must recover (tests). Protocol must match the
        gate's [gate] rudp_protocol."""
        if protocol == "kcp":
            from goworld_tpu_torch.netutil.kcp import connect_kcp

            pconn = await connect_kcp(host, port, loss_simulation, fec=fec)
        else:
            from goworld_tpu_torch.netutil.rudp import connect_rudp

            pconn = await connect_rudp(host, port, loss_simulation)
        if self.compress:
            pconn.enable_compression(self.compress_format)
        self.conn = GoWorldConnection(pconn)
        self._start_pumps()

    def _start_pumps(self) -> None:
        loop = asyncio.get_running_loop()
        self._tasks.append(loop.create_task(self._recv_loop()))
        self._tasks.append(loop.create_task(self._heartbeat_loop()))

    async def close(self) -> None:
        for t in self._tasks:
            t.cancel()
        for t in self._tasks:
            try:
                await t
            except (asyncio.CancelledError, Exception):
                pass
        self._tasks.clear()
        if self.conn is not None:
            self.conn.close()

    async def wait_player(self, timeout: float = 10.0) -> ClientEntity:
        """Wait until the server assigns this client a player entity."""
        if self.player is not None:
            return self.player
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._player_waiters.append(fut)
        return await asyncio.wait_for(fut, timeout)

    def error(self, msg: str) -> None:
        full = f"{self.name}: {msg}"
        self.errors.append(full)
        if self.strict:
            raise StrictError(full)
        gwlog.warnf("client %s", full)

    # --- send side ----------------------------------------------------------

    def call_server_method(self, eid: str, method: str, args: tuple) -> None:
        assert self.conn is not None
        p = Packet()
        p.append_entity_id(eid)
        p.append_varstr(method)
        p.append_args(args)
        self.conn.send(MsgType.CALL_ENTITY_METHOD_FROM_CLIENT, p)

    def send_sync_position(self, eid: str, x: float, y: float, z: float, yaw: float) -> None:
        assert self.conn is not None
        self.conn.send_packet_raw(
            MsgType.SYNC_POSITION_YAW_FROM_CLIENT, pack_sync_record(eid, x, y, z, yaw)
        )

    async def _heartbeat_loop(self) -> None:
        while True:
            await asyncio.sleep(self.heartbeat_interval)
            if self.conn is not None:
                self.conn.send_heartbeat()

    # --- recv side ----------------------------------------------------------

    async def _recv_loop(self) -> None:
        assert self.conn is not None
        try:
            while True:
                msgtype, packet = await self.conn.recv()
                try:
                    self._handle(msgtype, packet)
                except StrictError:
                    raise
                except Exception:
                    gwlog.trace_error("client %s: error handling msgtype %s", self.name, msgtype)
        except ConnectionClosed:
            pass

    def _handle(self, msgtype: int, packet: Packet) -> None:
        if msgtype == MsgType.CREATE_ENTITY_ON_CLIENT:
            self._handle_create_entity(packet)
        elif msgtype == MsgType.DESTROY_ENTITY_ON_CLIENT:
            typename = packet.read_varstr()
            eid = packet.read_entity_id()
            e = self.entities.pop(eid, None)
            if e is None:
                # No-op by protocol contract: the reference client ignores
                # destroys of unknown entities (ClientBot.go:474-480) — the
                # server legitimately re-derives interest after a restore
                # and timing windows can double-report.
                gwlog.debugf("%s: destroy of unknown entity %s %s",
                             self.name, typename, eid)
                return
            e.destroyed = True
            if e.is_player and self.player is e:
                self.player = None
            if self.on_destroy_entity is not None:
                self.on_destroy_entity(e)
        elif msgtype == MsgType.CALL_ENTITY_METHOD_ON_CLIENT:
            eid = packet.read_entity_id()
            method = packet.read_varstr()
            args = packet.read_args()
            e = self.entities.get(eid)
            if e is None:
                self.error(f"call {method} on unknown entity {eid}")
                return
            e.on_call(method, args)
        elif msgtype == MsgType.CALL_FILTERED_CLIENTS:
            method = packet.read_varstr()
            args = packet.read_args()
            # Filtered calls target the player entity (reference behavior).
            if self.player is not None:
                self.player.on_call(method, args)
        elif msgtype in (
            MsgType.NOTIFY_MAP_ATTR_CHANGE_ON_CLIENT,
            MsgType.NOTIFY_MAP_ATTR_DEL_ON_CLIENT,
            MsgType.NOTIFY_MAP_ATTR_CLEAR_ON_CLIENT,
            MsgType.NOTIFY_LIST_ATTR_CHANGE_ON_CLIENT,
            MsgType.NOTIFY_LIST_ATTR_POP_ON_CLIENT,
            MsgType.NOTIFY_LIST_ATTR_APPEND_ON_CLIENT,
        ):
            self._handle_attr_change(msgtype, packet)
        elif msgtype == MsgType.SYNC_POSITION_YAW_ON_CLIENTS:
            data = packet.payload
            for off in range(0, len(data), SYNC_RECORD_SIZE):
                rec = data[off : off + SYNC_RECORD_SIZE]
                eid = rec[:16].decode("ascii")
                e = self.entities.get(eid)
                if e is not None:
                    import struct

                    e.x, e.y, e.z, e.yaw = struct.unpack_from("<4f", rec, 16)
                    e.delta_ready = True
                    e.keyframes += 1
        elif msgtype == MsgType.SYNC_POSITION_YAW_DELTA_ON_CLIENTS:
            self._handle_sync_delta(packet)
        else:
            self.error(f"unhandled server msgtype {msgtype}")

    def _handle_sync_delta(self, packet: Packet) -> None:
        """Decode v6 quantized-delta sync records: [u8 quantize_bits] +
        concatenated 24 B [eid + dx,dy,dz,dyaw int16] records. The
        position advances in FLOAT32 arithmetic — the server's baseline
        column is float32, and matching its rounding bit-for-bit is what
        keeps decode error bounded by the quantization step forever
        (entity/slabs.py encoding contract)."""
        import struct

        import numpy as np

        data = packet.payload
        if not data:
            return
        step = np.float32(2.0 ** -data[0])
        for off in range(1, len(data) - DELTA_SYNC_RECORD_SIZE + 1,
                         DELTA_SYNC_RECORD_SIZE):
            rec = data[off : off + DELTA_SYNC_RECORD_SIZE]
            eid = rec[:16].decode("ascii")
            e = self.entities.get(eid)
            if e is None:
                continue  # same contract as full records for unknown eids
            if not e.delta_ready:
                self.error(
                    f"delta sync for {eid} before any keyframe — stale "
                    f"baseline (server must keyframe first)")
                continue
            dx, dy, dz, dyaw = struct.unpack_from("<4h", rec, 16)
            e.x = float(np.float32(e.x) + np.float32(dx) * step)
            e.y = float(np.float32(e.y) + np.float32(dy) * step)
            e.z = float(np.float32(e.z) + np.float32(dz) * step)
            e.yaw = float(np.float32(e.yaw) + np.float32(dyaw) * step)
            e.deltas += 1

    def _handle_create_entity(self, packet: Packet) -> None:
        is_player = packet.read_bool()
        eid = packet.read_entity_id()
        typename = packet.read_varstr()
        attrs = packet.read_data()
        x = packet.read_float32()
        y = packet.read_float32()
        z = packet.read_float32()
        yaw = packet.read_float32()
        if eid in self.entities and not is_player:
            old = self.entities[eid]
            if not old.is_player:
                # Idempotent by protocol contract: the reference server
                # re-sends creates when AOI re-derives interest after a
                # freeze/restore, and its client KEEPS the existing mirror
                # untouched (ClientBot.go:459-471) — replacing it would
                # orphan references scenario code still holds.
                gwlog.debugf("%s: create for existing entity %s (kept)",
                             self.name, eid)
                return
        e = self.entity_class(self, eid, typename, is_player, attrs, x, y, z, yaw)
        self.entities[eid] = e
        if is_player:
            self.player = e
            for fut in self._player_waiters:
                if not fut.done():
                    fut.set_result(e)
            self._player_waiters.clear()
        if self.on_create_entity is not None:
            self.on_create_entity(e)

    def _handle_attr_change(self, msgtype: int, packet: Packet) -> None:
        eid = packet.read_entity_id()
        path = packet.read_data()
        if msgtype == MsgType.NOTIFY_MAP_ATTR_CHANGE_ON_CLIENT:
            args: tuple = (packet.read_varstr(), packet.read_data())
        elif msgtype == MsgType.NOTIFY_MAP_ATTR_DEL_ON_CLIENT:
            args = (packet.read_varstr(),)
        elif msgtype == MsgType.NOTIFY_LIST_ATTR_CHANGE_ON_CLIENT:
            args = (packet.read_uint32(), packet.read_data())
        elif msgtype == MsgType.NOTIFY_LIST_ATTR_APPEND_ON_CLIENT:
            args = (packet.read_data(),)
        else:  # clear / pop carry no extra fields
            args = ()
        e = self.entities.get(eid)
        if e is None:
            self.error(f"attr change for unknown entity {eid}")
            return
        e.apply_attr_change(msgtype, path, args)

    # --- introspection ------------------------------------------------------

    def entities_of_type(self, typename: str) -> list[ClientEntity]:
        return [e for e in self.entities.values() if e.typename == typename]
