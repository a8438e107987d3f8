"""GateService: client sockets, boot flow, filter broadcast, sync batching.

Reference parity: ``components/gate/GateService.go`` —

- One recv task per client connection feeding a single logic loop (no locks
  in logic, :427-448).
- The gate (not the game) generates the boot EntityID and announces the fresh
  client to a dispatcher selected by that id (:213-218).
- Client→server position syncs are coalesced per dispatcher and flushed every
  ``position_sync_interval`` (:398-425); server→client syncs arrive batched
  per gate and are de-multiplexed per clientid (:346-371).
- Redirect-range packets (game→client) carry a [u16 gateid][clientid] prefix
  which the gate strips before forwarding; is-player CREATE_ENTITY_ON_CLIENT
  packets are sniffed to track each proxy's owner entity (:262-293).
- Filter-prop trees per key serve CALL_FILTERED_CLIENTS with 6 comparison
  ops (FilterTree.go:12-102).
- Heartbeat timeouts kill client proxies (:201-211), counted on
  ``gate_clients_killed_total{reason}`` with ONE aggregated warn per sweep.
  Deviation: the reference gate exits when a dispatcher connection dies
  (gate.go:138-143); this gate rides out dispatcher restarts — sends
  buffer in the per-link replay ring and flush after reconnect.

Transports: TCP (+ optional TLS via asyncio ssl, mirroring the reference's
crypto/tls wrap, gate.go:97-118), reliable UDP on the same port number
(the reference's KCP slot, GateService.go:134-165 — in-repo ARQ protocol,
netutil/rudp.py), WebSocket when ``ws_addr`` is set (gate.go:92-95;
netutil/ws_conn.py), and optional per-packet zlib compression (the
reference uses snappy, ClientProxy.go:42-45 — snappy is not in this
image).
"""

from __future__ import annotations

import asyncio
import ssl
import time
from typing import Optional

import numpy as np

from goworld_tpu_torch import consts
from goworld_tpu_torch.common import gen_client_id, gen_entity_id, hash_entity_id
from goworld_tpu_torch.config import GateConfig, GoWorldConfig
from goworld_tpu_torch.dispatchercluster.cluster import ClusterClient
from goworld_tpu_torch.gate.filter_tree import FilterTree
from goworld_tpu_torch.netutil.packet import Packet
from goworld_tpu_torch.netutil.packet_conn import ConnectionClosed, PacketConnection
from goworld_tpu_torch.proto.conn import (
    CLIENT_DELTA_SYNC_DTYPE,
    CLIENT_SYNC_DTYPE,
    DELTA_SYNC_RECORD_SIZE,
    SYNC_RECORD_SIZE,
    GoWorldConnection,
)
from goworld_tpu_torch.proto.msgtypes import FilterOp, MsgType, is_gate_redirect
from goworld_tpu_torch.telemetry import tracing
from goworld_tpu_torch.utils import gwlog, opmon

_CLIENT_BLOCK_SIZE = 16 + SYNC_RECORD_SIZE  # clientid + sync record
_CLIENT_DELTA_BLOCK_SIZE = 16 + DELTA_SYNC_RECORD_SIZE  # cid + delta record

# Client proxies killed by the gate itself (vs. orderly client disconnects):
# reason="heartbeat" = silent past [gateN] heartbeat_timeout (swept in
# batches — the sweep logs ONE aggregated warn, so a mass timeout after a
# network partition cannot flood the log), reason="error" = the recv pump
# died on a non-clean error. Process-wide series, same churn reasoning as
# net_packets_total.
from goworld_tpu_torch import telemetry as _telemetry

_CLIENT_KILLS = _telemetry.counter(
    "gate_clients_killed_total",
    "Client proxies killed by the gate, by reason.", ("reason",))
_KILLS_HEARTBEAT = _CLIENT_KILLS.labels("heartbeat")
_KILLS_ERROR = _CLIENT_KILLS.labels("error")

# Sync fan-out per-hop attribution (shared family with game_pack and
# dispatcher_route; bench.py --fanout reads the deltas into shares):
# gate_demux = the argsort demux of one sync packet, client_write = the
# end-of-batch uncork sweep that actually writes the corked client conns.
_HOP_SECONDS = _telemetry.counter(
    "fanout_hop_seconds_total",
    "Busy wall seconds per sync fan-out hop (game_collect|game_pack|"
    "game_send|dispatcher_route|gate_demux|client_write).",
    ("hop",))
_HOP_GATE_DEMUX = _HOP_SECONDS.labels("gate_demux")
_HOP_CLIENT_WRITE = _HOP_SECONDS.labels("client_write")


class ClientProxy:
    """Server-side handle of one connected client (ClientProxy.go:39-52)."""

    __slots__ = ("clientid", "conn", "owner_eid", "heartbeat_time",
                 "filter_props", "_gate")

    def __init__(self, conn: GoWorldConnection, gate=None) -> None:
        self.clientid = gen_client_id()
        self.conn = conn
        self.owner_eid: str = ""
        self.heartbeat_time = time.monotonic()
        self.filter_props: dict[str, str] = {}
        self._gate = gate  # owning GateService (None for bare-proxy tests)

    def send(self, msgtype: int, payload: bytes) -> None:
        # Tick-scoped write coalescing: while the gate logic loop is inside
        # an event batch, the first write corks the connection (buffer, no
        # flush task) and registers it for the end-of-batch uncork — N
        # packets to one client leave in ONE transport write per tick.
        gate = self._gate
        if gate is not None and gate._batch_active:
            conn = self.conn
            if conn not in gate._corked_conns:
                conn.cork()
                gate._corked_conns.add(conn)
        self.conn.send_packet_raw(msgtype, payload)

    def close(self) -> None:
        self.conn.close()

    def __repr__(self) -> str:
        return f"ClientProxy<{self.clientid}|owner={self.owner_eid or '-'}>"


class GateService:
    """One gate process. Construct, then ``await service.run_async()``."""

    def __init__(self, gateid: int, cfg: Optional[GoWorldConfig] = None) -> None:
        from goworld_tpu_torch.config import get as get_config

        self.gateid = gateid
        self.cfg = cfg or get_config()
        self.gate_cfg: GateConfig = self.cfg.gates.get(gateid) or GateConfig()
        self.clients: dict[str, ClientProxy] = {}
        self.filter_trees: dict[str, FilterTree] = {}
        # Dispatcher indices this instance has handshaked at least once
        # (the "fresh process" bit of SET_GATE_ID derives from it).
        self._handshaked: set[int] = set()
        # Boot generation of this gate process (non-zero): clients carry
        # it on NOTIFY_CLIENT_CONNECTED; a restart's stale-client detach
        # broadcast names it as the valid generation (game_client.py).
        import random as _random

        self.generation: int = _random.getrandbits(32) | 1
        self.cluster: Optional[ClusterClient] = None
        self._server: Optional[asyncio.base_events.Server] = None
        self._queue: asyncio.Queue = asyncio.Queue()
        self._tasks: list[asyncio.Task] = []
        self._stopped = asyncio.Event()
        # client→server sync coalescing: dispatcher index → 32 B records;
        # a buffer reaching [cluster] sync_flush_bytes flushes immediately
        # instead of waiting out position_sync_interval (0 = tick only).
        self._pending_syncs: dict[int, bytearray] = {}
        ccfg = getattr(self.cfg, "cluster", None)
        self._sync_flush_bytes = (
            ccfg.sync_flush_bytes if ccfg is not None
            else consts.DISPATCHER_SYNC_FLUSH_BYTES)
        # server→client write coalescing (tick-scoped): True while the
        # logic loop is inside one event batch; conns corked this batch.
        self._batch_active = False
        self._corked_conns: set = set()
        self.port: int = 0
        self._ws_server = None
        self._rudp_listener = None
        self.ws_port: int = 0
        self._debug_srv = None
        self.exit_code: Optional[int] = None

    # --- lifecycle (gate.go:57-101) ----------------------------------------

    async def run_async(self) -> int:
        await self.start()
        await self._stopped.wait()
        await self.stop()
        return self.exit_code or 0

    async def start(self) -> None:
        self._started_at = time.monotonic()
        tcfg = getattr(self.cfg, "telemetry", None)
        if tcfg is not None:
            tracing.configure_from_config(tcfg)
        from goworld_tpu_torch.dispatchercluster.cluster import (
            cluster_knobs,
            dispatcher_addrs,
        )

        self.cluster = ClusterClient(
            dispatcher_addrs(self.cfg), self._handshake,
            self._on_dispatcher_packet,
            self._on_dispatcher_disconnect, **cluster_knobs(self.cfg)
        )
        self.cluster.start()

        ssl_ctx = self._make_ssl_context()
        self._server = await asyncio.start_server(
            self._serve_client, self.gate_cfg.host, self.gate_cfg.port, ssl=ssl_ctx
        )
        self.port = self._server.sockets[0].getsockname()[1]
        await self._start_rudp_server()
        await self._start_ws_server(ssl_ctx)
        from goworld_tpu_torch.utils import gwvar
        from goworld_tpu_torch.utils.debug_http import setup_http_server

        gwvar.set_var("NumClients", lambda: len(self.clients))
        self._register_metrics()
        from goworld_tpu_torch.utils import debug_http

        debug_http.set_health_provider(self._health)
        self._debug_srv = await setup_http_server(self.gate_cfg.http_addr)
        loop = asyncio.get_running_loop()
        if tcfg is not None and getattr(tcfg, "history_dir", ""):
            # Black-box history ring (telemetry/history.py) — the gate
            # has no flight recorder, so frames carry health + metric
            # deltas only.
            import os as _os

            from goworld_tpu_torch.telemetry import history as history_mod

            self._hist_writer = history_mod.HistoryWriter(
                _os.path.join(tcfg.history_dir, f"gate{self.gateid}"),
                f"gate{self.gateid}",
                interval=tcfg.history_interval,
                segment_bytes=tcfg.history_segment_bytes,
                segments=tcfg.history_segments,
                health=self._health)
            history_mod.set_active_writer(self._hist_writer)
            self._tasks.append(loop.create_task(self._hist_writer.run()))
        self._tasks.append(loop.create_task(self._logic_loop()))
        self._tasks.append(loop.create_task(self._tick_loop()))
        gwlog.infof("gate %d listening on %s:%d (tls=%s)",
                    self.gateid, self.gate_cfg.host, self.port, ssl_ctx is not None)
        gwlog.infof(consts.GATE_STARTED_TAG)

    def _register_metrics(self) -> None:
        """Queue-depth / client-count gauges on /metrics, labeled by
        gateid (pull-sampled — zero logic-loop cost). Per-packet in/out
        volume is counted transport-uniformly in proto/conn.py
        (net_*_total), which covers TCP, WS, and KCP client conns alike."""
        from goworld_tpu_torch import telemetry

        g = str(self.gateid)
        telemetry.gauge(
            "gate_queue_depth",
            "Events waiting in the gate logic queue.", ("gateid",),
        ).labels(g).set_function(self._queue.qsize)
        telemetry.gauge(
            "gate_clients", "Connected client proxies.", ("gateid",),
        ).labels(g).set_function(lambda: len(self.clients))

    def _unregister_metrics(self) -> None:
        from goworld_tpu_torch import telemetry

        g = str(self.gateid)
        for name in ("gate_queue_depth", "gate_clients"):
            fam = telemetry.family(name)
            if fam is not None:
                fam.remove(g)

    def _health(self) -> dict:
        """One JSON object for GET /healthz (and the /snapshot row the
        cluster collector aggregates — ``generation`` is the value every
        game binding and dispatcher registration must carry for this
        gate, or the /cluster summary flags a stale generation row)."""
        return {
            "kind": "gate",
            "id": self.gateid,
            "uptime_s": round(
                time.monotonic() - getattr(self, "_started_at", 0.0), 3),
            "generation": self.generation,
            "clients": len(self.clients),
            "queue_depth": self._queue.qsize(),
            "dispatcher_links": (
                self.cluster.link_states() if self.cluster is not None
                else []),
        }

    async def stop(self) -> None:
        from goworld_tpu_torch.utils import debug_http

        debug_http.clear_health_provider(self._health)
        self._unregister_metrics()
        hist_writer = getattr(self, "_hist_writer", None)
        if hist_writer is not None:
            from goworld_tpu_torch.telemetry import history as history_mod

            hist_writer.close()
            history_mod.clear_active_writer(hist_writer)
            self._hist_writer = None
        for t in self._tasks:
            t.cancel()
        for t in self._tasks:
            try:
                await t
            except (asyncio.CancelledError, Exception):
                pass
        self._tasks.clear()
        if self._server is not None:
            self._server.close()
            # Close live client sockets BEFORE wait_closed(): since 3.12.1
            # it waits for connection handlers, which only exit once their
            # sockets close (same fix as DispatcherService.stop).
            for cp in list(self.clients.values()):
                cp.close()
            await self._server.wait_closed()
        if self._ws_server is not None:
            self._ws_server.close()
            await self._ws_server.wait_closed()
        if self._rudp_listener is not None:
            self._rudp_listener.close()
            self._rudp_listener = None
        if getattr(self, "_debug_srv", None) is not None:
            await self._debug_srv.stop()
            self._debug_srv = None
        from goworld_tpu_torch.utils import gwvar

        gwvar.unset("NumClients")
        for cp in list(self.clients.values()):
            cp.close()
        self.clients.clear()
        if self.cluster is not None:
            await self.cluster.stop()

    def terminate(self) -> None:
        self.exit_code = 0
        self._stopped.set()

    def _make_ssl_context(self) -> Optional[ssl.SSLContext]:
        if not self.gate_cfg.encrypt_connection:
            return None
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.load_cert_chain(self.gate_cfg.rsa_cert, self.gate_cfg.rsa_key)
        return ctx

    def _handshake(self, index: int, proxy: GoWorldConnection) -> None:
        # fresh = first contact between THIS gate process and dispatcher
        # ``index``: a brand-new gate introduces itself so the dispatcher
        # detaches the dead predecessor's client bindings on every game
        # (crash + restart inside the reconnect-grace window); a surviving
        # gate re-dialing after a link blip keeps its live clients.
        fresh = index not in self._handshaked
        self._handshaked.add(index)
        proxy.send_set_gate_id(self.gateid, fresh=fresh,
                               gen=self.generation)

    def _on_dispatcher_disconnect(self, index: int) -> None:
        # Deliberate deviation from the reference, which EXITS the whole
        # gate (dropping every connected client) when one dispatcher link
        # dies (gate.go:138-143). With the replay ring + reconnect loop
        # (dispatchercluster/cluster.py) the gate now rides out dispatcher
        # restarts: sends buffer up to [cluster] down_buffer_bytes and
        # replay after the reconnect handshake, and clients never notice.
        gwlog.warnf("gate %d: dispatcher %d disconnected; buffering sends "
                    "until reconnect", self.gateid, index)

    # --- client connections (GateService.go:125-199) ------------------------

    async def _serve_client(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        pconn = PacketConnection(reader, writer)
        if self.gate_cfg.compress_connection:
            pconn.enable_compression(self.gate_cfg.compress_format)
        await self._pump_client(GoWorldConnection(pconn))

    async def _start_rudp_server(self) -> None:
        """Serve the reliable-UDP transport on the SAME port number as TCP
        (the reference serves KCP beside TCP on one address,
        GateService.go:134-165). [gate] rudp_protocol picks the wire
        protocol: "kcp" = the real KCP segment protocol (netutil/kcp.py,
        stock-KCP interoperable) or "native" = the in-repo ARQ
        (netutil/rudp.py)."""
        loop = asyncio.get_running_loop()

        def accept(pconn) -> None:
            if self.gate_cfg.compress_connection:
                pconn.enable_compression(self.gate_cfg.compress_format)
            loop.create_task(self._pump_client(GoWorldConnection(pconn)))

        if self.gate_cfg.rudp_protocol == "kcp":
            from goworld_tpu_torch.config.read_config import parse_fec
            from goworld_tpu_torch.netutil.kcp import KCPListener

            self._rudp_listener = KCPListener(
                accept, fec=parse_fec(self.gate_cfg.rudp_fec))
        else:
            from goworld_tpu_torch.netutil.rudp import RUDPListener

            self._rudp_listener = RUDPListener(accept)
        try:
            await loop.create_datagram_endpoint(
                lambda: self._rudp_listener,
                local_addr=(self.gate_cfg.host, self.port),
            )
        except OSError as exc:
            # UDP port taken is non-fatal: TCP/WS clients still work.
            gwlog.errorf("gate %d: rudp listener failed: %s", self.gateid, exc)
            self._rudp_listener = None
            return
        gwlog.infof("gate %d rudp (reliable udp) listening on %s:%d",
                    self.gateid, self.gate_cfg.host, self.port)

    async def _start_ws_server(self, ssl_ctx) -> None:
        """Serve WebSocket clients next to TCP when [gateN] ws_addr is set
        (gate.go:92-95; transport adapter in netutil/ws_conn.py)."""
        if not self.gate_cfg.ws_addr:
            return
        import websockets

        from goworld_tpu_torch.netutil.ws_conn import WSPacketConnection

        host, _, port = self.gate_cfg.ws_addr.rpartition(":")

        async def handler(ws):
            await self._pump_client(GoWorldConnection(WSPacketConnection(ws)))

        self._ws_server = await websockets.serve(
            handler, host or "127.0.0.1", int(port), ssl=ssl_ctx, max_size=consts.MAX_PACKET_SIZE
        )
        self.ws_port = self._ws_server.sockets[0].getsockname()[1]
        gwlog.infof("gate %d websocket listening on %s:%d", self.gateid,
                    host or "127.0.0.1", self.ws_port)

    async def _pump_client(self, conn: GoWorldConnection) -> None:
        """Per-connection recv pump → single logic queue (any transport)."""
        cp = ClientProxy(conn, self)
        self._queue.put_nowait(("connect", cp, 0, None))
        try:
            while True:
                msgtype, packet = await conn.recv()
                self._queue.put_nowait(("packet", cp, msgtype, packet))
        except ConnectionClosed:
            pass
        except Exception:
            _KILLS_ERROR.inc()
            gwlog.trace_error("gate %d: client %s recv pump error; killing",
                              self.gateid, cp.clientid)
        finally:
            conn.close()
            self._queue.put_nowait(("disconnect", cp, 0, None))

    async def _logic_loop(self) -> None:
        while True:
            # Drain the whole burst without yielding (the game loop batches
            # its packet queue the same way), with client connections
            # corked for the span of the batch: a dispatcher sync packet
            # fanning out to hundreds of proxies costs each client ONE
            # transport write per batch instead of one per packet.
            batch = [await self._queue.get()]
            while True:
                try:
                    batch.append(self._queue.get_nowait())
                except asyncio.QueueEmpty:
                    break
            self._batch_active = True
            try:
                for kind, cp, msgtype, packet in batch:
                    try:
                        if kind == "packet":
                            # opmon wraps gate packet handling like the
                            # reference (GateService.go:431-438); slow ops
                            # warn at 100 ms.
                            op = opmon.Operation("gate.handleClientPacket")
                            self._handle_client_packet(cp, msgtype, packet)
                            op.finish(warn_threshold=0.1)
                        elif kind == "connect":
                            self._on_new_client(cp)
                        elif kind == "disconnect":
                            self._on_client_gone(cp)
                        elif kind == "dispatcher":
                            self._handle_dispatcher_packet(msgtype, packet)
                    except Exception:
                        gwlog.trace_error("gate %d: error handling %s/%s",
                                          self.gateid, kind, msgtype)
            finally:
                self._batch_active = False
                t0 = time.perf_counter()
                for conn in self._corked_conns:
                    try:
                        conn.uncork()
                    except Exception:  # a dead conn must not strand others
                        pass
                if self._corked_conns:
                    _HOP_CLIENT_WRITE.inc(time.perf_counter() - t0)
                self._corked_conns.clear()

    async def _tick_loop(self) -> None:
        last_flush = time.monotonic()
        while True:
            await asyncio.sleep(consts.GATE_SERVICE_TICK_INTERVAL)
            now = time.monotonic()
            if now - last_flush >= self.gate_cfg.position_sync_interval:
                last_flush = now
                self._flush_pending_syncs()
            self._sweep_heartbeats(now)

    def _select_by_eid(self, eid: str):
        """Entity-id-hash dispatcher selection over the gate's OWN cluster —
        never the process-global one, which belongs to the game side."""
        assert self.cluster is not None
        return self.cluster.select(hash_entity_id(eid) % self.cluster.count())

    def _on_new_client(self, cp: ClientProxy) -> None:
        """Register the proxy and announce it with a fresh boot-entity id
        (GateService.go:213-218)."""
        self.clients[cp.clientid] = cp
        boot_eid = gen_entity_id()
        self._select_by_eid(boot_eid).send_notify_client_connected(
            cp.clientid, self.gateid, boot_eid, gate_gen=self.generation
        )
        gwlog.debugf("gate %d: client %s connected, boot entity %s", self.gateid, cp.clientid, boot_eid)

    def _on_client_gone(self, cp: ClientProxy) -> None:
        if self.clients.pop(cp.clientid, None) is None:
            return  # already removed (heartbeat kill)
        self._clear_filter_props(cp)
        if cp.owner_eid:
            self._select_by_eid(cp.owner_eid).send_notify_client_disconnected(
                cp.clientid, cp.owner_eid
            )

    def _sweep_heartbeats(self, now: float) -> None:
        timeout = self.gate_cfg.heartbeat_timeout
        if timeout <= 0:
            return
        killed: list[str] = []
        for cp in list(self.clients.values()):
            if now - cp.heartbeat_time > timeout:
                killed.append(cp.clientid)
                cp.close()  # recv task will enqueue the disconnect
        if killed:
            _KILLS_HEARTBEAT.inc(len(killed))
            # One aggregated warn per sweep: a mass timeout (network
            # partition upstream of thousands of clients) must not emit
            # one log line per client.
            gwlog.warnf(
                "gate %d: killed %d client(s) past the %.0fs heartbeat "
                "timeout (e.g. %s)", self.gateid, len(killed), timeout,
                ", ".join(killed[:3]))

    # --- client → server (GateService.go:245-248,398-425) -------------------

    def _handle_client_packet(self, cp: ClientProxy, msgtype: int, packet: Packet) -> None:
        cp.heartbeat_time = time.monotonic()
        if msgtype == MsgType.HEARTBEAT_FROM_CLIENT:
            return
        if msgtype == MsgType.SYNC_POSITION_YAW_FROM_CLIENT:
            record = packet.payload[:SYNC_RECORD_SIZE]
            eid = record[:16].decode("ascii")
            idx = hash_entity_id(eid) % max(1, self.cluster.count() if self.cluster else 1)
            buf = self._pending_syncs.setdefault(idx, bytearray())
            buf += record
            if (self._sync_flush_bytes
                    and len(buf) >= self._sync_flush_bytes
                    and self.cluster is not None):
                # Size-triggered early flush: a burst never sits out the
                # rest of position_sync_interval.
                del self._pending_syncs[idx]
                self.cluster.select(idx).send_sync_position_yaw_from_client(
                    bytes(buf))
            return
        if msgtype == MsgType.CALL_ENTITY_METHOD_FROM_CLIENT:
            eid = packet.read_entity_id()
            # Ingress seam 1: a client RPC entering the cluster head-
            # samples a fresh root trace (1/[telemetry] trace_sample_rate).
            # The method name is parsed only on the sampled path.
            scope = tracing.root_scope("gate.client_rpc")
            if scope is not None:
                scope.args = {"eid": eid, "method": packet.read_varstr(),
                              "gateid": self.gateid}
            packet.set_read_pos(0)
            packet.append_client_id(cp.clientid)
            if scope is None:
                self._select_by_eid(eid).send(
                    MsgType.CALL_ENTITY_METHOD_FROM_CLIENT, packet)
            else:
                with scope:
                    self._select_by_eid(eid).send(
                        MsgType.CALL_ENTITY_METHOD_FROM_CLIENT, packet)
            return
        gwlog.warnf("gate %d: unexpected client msgtype %s", self.gateid, msgtype)

    def _flush_pending_syncs(self) -> None:
        if not self._pending_syncs or self.cluster is None:
            return
        for idx, buf in self._pending_syncs.items():
            self.cluster.select(idx).send_sync_position_yaw_from_client(bytes(buf))
        self._pending_syncs.clear()

    # --- dispatcher → gate ---------------------------------------------------

    def _on_dispatcher_packet(self, index: int, msgtype: int, packet: Packet) -> None:
        self._queue.put_nowait(("dispatcher", None, msgtype, packet))

    def _handle_dispatcher_packet(self, msgtype: int, packet: Packet) -> None:
        if packet.trace is not None:
            # Tail of a sampled trace: the client fan-out span (queue
            # dwell child + redirect strip + client write). Client links
            # carry no trailer, so the trace ends here by design.
            scope = tracing.continue_from_packet(
                packet, "gate.client_fanout", dwell_name="gate.queue_dwell")
            scope.args["msgtype"] = int(msgtype)
            scope.args["gateid"] = self.gateid
            with scope:
                self._dispatch_dispatcher_packet(msgtype, packet)
            return
        self._dispatch_dispatcher_packet(msgtype, packet)

    def _dispatch_dispatcher_packet(self, msgtype: int, packet: Packet) -> None:
        if is_gate_redirect(msgtype):
            self._handle_redirect(msgtype, packet)
        elif msgtype == MsgType.SYNC_POSITION_YAW_ON_CLIENTS:
            self._handle_sync_on_clients(packet)
        elif msgtype == MsgType.SYNC_POSITION_YAW_DELTA_ON_CLIENTS:
            self._handle_sync_delta_on_clients(packet)
        elif msgtype == MsgType.CALL_FILTERED_CLIENTS:
            self._handle_call_filtered_clients(packet)
        else:
            gwlog.warnf("gate %d: unhandled dispatcher msgtype %s", self.gateid, msgtype)

    def _handle_redirect(self, msgtype: int, packet: Packet) -> None:
        """Strip the [u16 gateid][clientid] prefix and forward to the client;
        sniff is-player creates for owner tracking (GateService.go:262-293)."""
        packet.read_uint16()  # gateid (it is ours; dispatcher routed on it)
        clientid = packet.read_client_id()
        cp = self.clients.get(clientid)
        if msgtype == MsgType.SET_CLIENTPROXY_FILTER_PROP:
            if cp is not None:
                self._set_filter_prop(cp, packet.read_varstr(), packet.read_varstr())
            return
        if msgtype == MsgType.CLEAR_CLIENTPROXY_FILTER_PROPS:
            if cp is not None:
                self._clear_filter_props(cp)
            return
        if cp is None:
            return  # client already gone; drop quietly (reference behavior)
        rest = packet.read_rest()
        if msgtype == MsgType.CREATE_ENTITY_ON_CLIENT:
            if len(rest) < 17:  # bool is_player + eid(16), proto/schema.py
                raise ValueError(
                    f"CREATE_ENTITY_ON_CLIENT payload truncated "
                    f"({len(rest)} bytes after the redirect prefix)")
            is_player = rest[0] != 0
            if is_player:
                cp.owner_eid = rest[1:17].decode("ascii")
        cp.send(msgtype, rest)

    def _handle_sync_on_clients(self, packet: Packet) -> None:
        """De-multiplex [clientid + 32 B record] blocks per client
        (GateService.go:346-371) — vectorized: one structured-array view,
        then each maximal run of equal clientids leaves as a single
        contiguous ``tobytes()`` slice. The game packs each collection's
        rows grouped by destination client (slabs.py collect_sync_selection
        orders by destination slot), so the adjacent-run scan recovers the
        per-client grouping without the argsort this path used to pay; an
        ungrouped producer only costs extra (smaller) sends, never a wrong
        route. Wall time lands on
        fanout_hop_seconds_total{hop="gate_demux"} (the corked client
        writes themselves are costed under client_write at the
        end-of-batch uncork sweep)."""
        t0 = time.perf_counter()
        packet.read_uint16()  # gateid
        data = packet.read_rest()  # raw [clientid + record] blocks
        k = len(data) // _CLIENT_BLOCK_SIZE
        if not k:
            return
        arr = np.frombuffer(data, CLIENT_SYNC_DTYPE, count=k)
        cids = arr["cid"]
        if k == 1:
            cp = self.clients.get(cids[0].decode("ascii"))
            if cp is not None:
                cp.send(MsgType.SYNC_POSITION_YAW_ON_CLIENTS,
                        arr["rec"].tobytes())
            _HOP_GATE_DEMUX.inc(time.perf_counter() - t0)
            return
        rec = arr["rec"]
        bounds = [0] + (np.flatnonzero(cids[1:] != cids[:-1]) + 1).tolist() + [k]
        clients = self.clients
        for i in range(len(bounds) - 1):
            lo, hi = bounds[i], bounds[i + 1]
            cp = clients.get(cids[lo].decode("ascii"))
            if cp is not None:
                cp.send(MsgType.SYNC_POSITION_YAW_ON_CLIENTS,
                        rec[lo:hi].tobytes())
        _HOP_GATE_DEMUX.inc(time.perf_counter() - t0)

    def _handle_sync_delta_on_clients(self, packet: Packet) -> None:
        """De-multiplex the v6 quantized-delta variant: [u16 gateid]
        [u8 quantize_bits] + fixed 40 B [clientid + 24 B delta record]
        blocks, same vectorized run-slicing as the full-precision demux.
        Each client's forward re-carries the quantize_bits header byte so
        the client decode stays self-describing — one small concat per
        RUN, not per record."""
        t0 = time.perf_counter()
        packet.read_uint16()  # gateid
        qb = packet.read_byte()
        data = packet.read_rest()
        k = len(data) // _CLIENT_DELTA_BLOCK_SIZE
        if not k:
            return
        header = bytes((qb,))
        arr = np.frombuffer(data, CLIENT_DELTA_SYNC_DTYPE, count=k)
        cids = arr["cid"]
        rec = arr["rec"]
        bounds = [0] + (np.flatnonzero(cids[1:] != cids[:-1]) + 1).tolist() + [k]
        clients = self.clients
        for i in range(len(bounds) - 1):
            lo, hi = bounds[i], bounds[i + 1]
            cp = clients.get(cids[lo].decode("ascii"))
            if cp is not None:
                cp.send(MsgType.SYNC_POSITION_YAW_DELTA_ON_CLIENTS,
                        header + rec[lo:hi].tobytes())
        _HOP_GATE_DEMUX.inc(time.perf_counter() - t0)

    # --- filter props (FilterTree.go, GateService.go:300-344) ----------------

    def _set_filter_prop(self, cp: ClientProxy, key: str, val: str) -> None:
        old = cp.filter_props.get(key)
        tree = self.filter_trees.get(key)
        if tree is None:
            tree = self.filter_trees[key] = FilterTree()
        if old is not None:
            tree.remove(old, cp.clientid)
        cp.filter_props[key] = val
        tree.insert(val, cp.clientid)

    def _clear_filter_props(self, cp: ClientProxy) -> None:
        for key, val in cp.filter_props.items():
            tree = self.filter_trees.get(key)
            if tree is not None:
                tree.remove(val, cp.clientid)
        cp.filter_props.clear()

    def _handle_call_filtered_clients(self, packet: Packet) -> None:
        op = FilterOp(packet.read_byte())
        key = packet.read_varstr()
        val = packet.read_varstr()
        payload = packet.read_rest()  # [method][args] forwarded verbatim
        if key == "":
            # Empty key = every client on this gate (GateService.go:378-384,
            # the "world channel" broadcast).
            for cp in list(self.clients.values()):
                cp.send(MsgType.CALL_FILTERED_CLIENTS, payload)
            return
        tree = self.filter_trees.get(key)
        if tree is None:
            return
        for clientid in list(tree.visit(op, val)):
            cp = self.clients.get(clientid)
            if cp is not None:
                cp.send(MsgType.CALL_FILTERED_CLIENTS, payload)


def run(gateid: int | None = None) -> int:
    """Process entry point (gate.go:46-55)."""
    import argparse

    from goworld_tpu_torch.config import get as get_config, set_config_file

    parser = argparse.ArgumentParser(description="goworld_tpu_torch gate process")
    parser.add_argument("-gid", type=int, default=gateid or 1)
    parser.add_argument("-configfile", type=str, default="")
    parser.add_argument("-log", type=str, default="")
    parser.add_argument("-d", action="store_true", help="daemonize")
    args, _ = parser.parse_known_args()
    if args.configfile:
        set_config_file(args.configfile)
    cfg = get_config()
    gate_cfg = cfg.gates.get(args.gid)
    if args.d:
        from goworld_tpu_torch.utils.binutil import daemonize

        daemonize((gate_cfg.log_file if gate_cfg else None)
                  or f"gate{args.gid}.daemon.log")
    gwlog.setup(
        level=(args.log or (gate_cfg.log_level if gate_cfg else "info")),
        logfile=(gate_cfg.log_file if gate_cfg else None) or None,
        fmt=cfg.log.format,
    )
    gwlog.set_source(f"gate{args.gid}")
    svc = GateService(args.gid, cfg)

    async def main() -> int:
        import signal

        loop = asyncio.get_running_loop()
        try:
            loop.add_signal_handler(signal.SIGTERM, svc.terminate)
        except (NotImplementedError, RuntimeError):
            pass
        return await svc.run_async()

    return asyncio.run(main())
