"""The dispatcher message loop: entity-table routing with blocking queues.

Reference parity: ``components/dispatcher/DispatcherService.go`` —

- ``entityDispatchInfos: {EntityID → (gameid, blockUntil, pendingQueue)}``
  (:28-32,184): written on NOTIFY_CREATE_ENTITY / REAL_MIGRATE / SET_GAME_ID,
  erased on NOTIFY_DESTROY_ENTITY and game-down cleanup (:643-661,627-640).
- Blocking semantics (:34-80): per-entity blockUntil + bounded pending queue
  during load/migrate; per-game bounded queue while a game is frozen (:82-169).
- Load-balanced choose-game = CPU-min-heap for anywhere-creates (:529-542);
  round-robin over non-banned games for boot entities (:545-555).
- Client→server position syncs are aggregated per target game and flushed per
  5 ms tick (:786-824).
- Deployment-ready barrier when desired counts connect (:446-476).
- kvreg replication (:734-748); freeze handshake (:478-494); reconnect
  reconciliation rejecting entities whose home moved (:376-398).

Concurrency model mirrors the reference: per-connection recv tasks feed one
logic queue drained by a single task — no locks in routing logic.
"""

from __future__ import annotations

import asyncio
import collections
import os
import struct
import time
from typing import Deque, Optional

import numpy as np

from goworld_tpu_torch import consts, telemetry
from goworld_tpu_torch.dispatcher.lbc import LBCHeap
from goworld_tpu_torch.netutil.packet import Packet
from goworld_tpu_torch.netutil.packet_conn import ConnectionClosed, PacketConnection
from goworld_tpu_torch.proto.conn import (
    DELTA_SYNC_RECORD_SIZE,
    SYNC_DTYPE,
    SYNC_RECORD_SIZE,
    GoWorldConnection,
)
from goworld_tpu_torch.proto.msgtypes import PROTO_VERSION, MsgType, is_gate_redirect
from goworld_tpu_torch.telemetry import tracing
from goworld_tpu_torch.utils import gwlog

_CLIENT_SYNC_BLOCK = 16 + SYNC_RECORD_SIZE  # [clientid + record] (downstream)
_CLIENT_DELTA_BLOCK = 16 + DELTA_SYNC_RECORD_SIZE  # v6 delta variant

# Records-per-packet amortization made visible: the whole point
# of batch routing is that one packet carries MANY records — these count
# records at the dispatcher seam so /metrics shows the ratio directly
# (dir="up" = client→game position syncs, dir="down" = game→gate fan-out
# blocks). Families are process-wide; children resolve per instance.
_SYNC_RECORDS = telemetry.counter(
    "dispatcher_sync_records_total",
    "Position-sync records routed through the dispatcher, by direction.",
    ("dispid", "dir"))
# Wall seconds spent in each hop of the sync fan-out pipeline (game pack →
# dispatcher route → gate demux → client write); bench.py --fanout turns
# deltas of these into the per-hop shares in its headline JSON.
_HOP_SECONDS = telemetry.counter(
    "fanout_hop_seconds_total",
    "Busy wall seconds per sync fan-out hop (game_collect|game_pack|"
    "game_send|dispatcher_route|gate_demux|client_write).",
    ("hop",))
_HOP_ROUTE = _HOP_SECONDS.labels("dispatcher_route")
# Migration routing events at the dispatcher seam: routed = REAL_MIGRATE
# forwarded to its target game, bounced = target game dead so the payload
# went HOME to the source game instead of dropping (the zero-loss clause),
# cancel = CANCEL_MIGRATE unblocked an entity's stream. The multigame
# bench reads these for its done/rolled-back headline.
_MIGRATE_EVENTS = telemetry.counter(
    "dispatcher_migrates_total",
    "Migration routing events (routed|bounced|cancel) per dispatcher.",
    ("dispid", "kind"))


class _EntityDispatchInfo:
    """Routing record for one entity (DispatcherService.go:28-80)."""

    __slots__ = ("gameid", "block_until", "pending")

    def __init__(self, gameid: int = 0) -> None:
        self.gameid = gameid
        self.block_until = 0.0
        self.pending: Deque[tuple[int, Packet]] = collections.deque()

    def blocked(self, now: float) -> bool:
        return self.block_until > now

    def block(self, now: float, duration: float) -> None:
        self.block_until = now + duration

    def unblock(self) -> None:
        self.block_until = 0.0

    def push_pending(self, msgtype: int, packet: Packet) -> bool:
        if len(self.pending) >= consts.ENTITY_PENDING_PACKET_QUEUE_MAX_LEN:
            return False
        self.pending.append((msgtype, packet))
        return True


class _GameInfo:
    """Per-game connection state (DispatcherService.go:82-169,180-182)."""

    def __init__(self, gameid: int) -> None:
        self.gameid = gameid
        self.proxy: Optional[GoWorldConnection] = None
        self.is_banned_boot = False
        self.block_until = 0.0  # frozen / reconnect window
        self.pending: Deque[tuple[int, Packet]] = collections.deque()

    @property
    def connected(self) -> bool:
        return self.proxy is not None and not self.proxy.closed

    def blocked(self, now: float) -> bool:
        return self.block_until > now

    def dispatch(self, msgtype: int, packet: Packet, now: float) -> None:
        if self.connected and not self.blocked(now):
            self.proxy.send(msgtype, packet)
        elif self.blocked(now):
            if len(self.pending) < consts.GAME_PENDING_PACKET_QUEUE_MAX_LEN:
                self.pending.append((msgtype, packet))
        # else: game is gone and not frozen — drop (reference handleGameDown)

    def unblock_and_flush(self) -> None:
        self.block_until = 0.0
        if self.proxy is None:
            return
        while self.pending:
            msgtype, packet = self.pending.popleft()
            self.proxy.send(msgtype, packet)


class _SpaceHandoff:
    """A whole-space handoff this dispatcher serves: from the donor's
    SPACE_MIGRATE_PREPARE (or the bundle, where no PREPARE came here) to
    the receiver's SPACE_MIGRATE_ACK, the donor's abort or the deadline."""

    __slots__ = ("deadline", "parked", "inflight")

    def __init__(self, deadline: float, parked: list) -> None:
        self.deadline = deadline
        self.parked = parked  # member eids whose streams are parked
        # The SPACE_MIGRATE_DATA once written to the target's link and
        # until the target acks it: (target game, packet, source game).
        # The bundle is the space's last copy. A target killed as it is
        # routed can leave it unread in a socket that outlives the process
        # by the milliseconds the kernel takes to tear the process down;
        # when that target is declared dead, or cold-boots under the same
        # gameid, the kept packet bounces home.
        self.inflight: Optional[tuple[int, Packet, int]] = None


class _GateInfo:
    """Per-gate connection state with a reconnect-grace buffer.

    No reference analog: GoWorld's gate EXITS on dispatcher loss, so a gate
    never reconnects and the dispatcher can forget it instantly. Here a
    gate link blip is expected steady-state — during the grace window
    gate-bound packets buffer (bounded) and NOTIFY_GATE_DISCONNECTED is
    withheld, because broadcasting it would make every game detach the
    LIVE gate's client bindings."""

    def __init__(self, gateid: int) -> None:
        self.gateid = gateid
        self.proxy: Optional[GoWorldConnection] = None
        self.block_until = 0.0  # reconnect-grace window while down
        self.pending: Deque[tuple[int, Packet]] = collections.deque()
        # Boot generation announced at the gate's SET_GATE_ID handshake
        # (0 until one registers): /healthz reports it so the cluster
        # collector can cross-check every binding against the gate's own
        # announced generation (telemetry/collector.py summarize).
        self.generation = 0

    @property
    def connected(self) -> bool:
        return self.proxy is not None and not self.proxy.closed

    def blocked(self, now: float) -> bool:
        return self.block_until > now

    def dispatch(self, msgtype: int, packet: Packet, now: float) -> None:
        if self.connected:
            self.proxy.send(msgtype, packet)
        elif self.blocked(now):
            if len(self.pending) < consts.GAME_PENDING_PACKET_QUEUE_MAX_LEN:
                self.pending.append((msgtype, packet))
        # else: gate is gone for good — drop

    def unblock_and_flush(self) -> None:
        self.block_until = 0.0
        if self.proxy is None:
            return
        while self.pending:
            msgtype, packet = self.pending.popleft()
            self.proxy.send(msgtype, packet)


class DispatcherService:
    """One dispatcher process. Run with :meth:`start`, stop with :meth:`stop`."""

    def __init__(self, dispid: int, desired_games: int = 1, desired_gates: int = 1,
                 peer_heartbeat_timeout: Optional[float] = None,
                 sync_flush_bytes: Optional[int] = None,
                 rebalance=None) -> None:
        self.dispid = dispid
        self.desired_games = desired_games
        self.desired_gates = desired_gates
        # Size trigger for the position-sync aggregation buffers
        # ([cluster] sync_flush_bytes; 0 disables): a burst larger than
        # this flushes to its game IMMEDIATELY instead of sitting out the
        # rest of the 5 ms tick interval.
        self.sync_flush_bytes = (
            consts.DISPATCHER_SYNC_FLUSH_BYTES
            if sync_flush_bytes is None else sync_flush_bytes)
        # Liveness deadline for game/gate links ([cluster]
        # peer_heartbeat_timeout; 0 disables): HEARTBEAT is sent on idle
        # links and peers silent past the deadline are closed, converting
        # half-open connections into the peers' reconnect path.
        self.peer_heartbeat_timeout = (
            consts.CLUSTER_PEER_HEARTBEAT_TIMEOUT
            if peer_heartbeat_timeout is None else peer_heartbeat_timeout)
        self.entities: dict[str, _EntityDispatchInfo] = {}
        self.games: dict[int, _GameInfo] = {}
        self.gates: dict[int, _GateInfo] = {}
        # Not-yet-routed entities holding buffered packets: eid → expiry.
        # Gives a gate's ring replay racing the game's re-handshake into a
        # restarted dispatcher a grace window instead of a drop.
        self._unrouted: dict[str, float] = {}
        # Boot requests that arrived while NO boot-capable game had a live
        # link (flap / rolling restart): retried each tick until the grace
        # window lapses.
        self._pending_boots: list[tuple[Packet, float]] = []
        self.kvreg: dict[str, str] = {}
        # Whole-space handoffs this dispatcher parked member streams for
        # or routed a bundle of. Entries clear on SPACE_MIGRATE_ACK
        # (receiver restored), SPACE_MIGRATE_ABORT (donor unfroze in
        # place), or the deadline sweep.
        self._space_handoffs: dict[str, _SpaceHandoff] = {}
        self.deployment_ready = False
        self._boot_rr = 0
        self._lbc = LBCHeap()
        self._server: Optional[asyncio.base_events.Server] = None
        self._conns: set = set()  # all live peer connections
        self._queue: asyncio.Queue = asyncio.Queue(maxsize=consts.DISPATCHER_MESSAGE_QUEUE_LEN)
        self._tasks: list[asyncio.Task] = []
        # position-sync aggregation: gameid → bytearray of 32 B records
        self._pending_syncs: dict[int, bytearray] = {}
        # sender identity, populated at handshake (reference stores the id on
        # the connection proxy itself)
        self._proxy_games: dict[GoWorldConnection, int] = {}
        self._proxy_gates: dict[GoWorldConnection, int] = {}
        # Liveness bookkeeping: proxy → monotonic last-packet time (updated
        # by the per-connection recv task), proxy → sent_packets mark at
        # the last heartbeat tick (idle-link detection).
        self._peer_last_seen: dict[GoWorldConnection, float] = {}
        self._hb_sent_marks: dict[GoWorldConnection, int] = {}
        self._last_hb_tick = 0.0
        # Chaos/testing hook: while cleared, the logic and tick loops stop
        # draining — models a stalled (SIGSTOP-like) process whose sockets
        # stay open. pause()/resume().
        self._resume_event = asyncio.Event()
        self._resume_event.set()
        self._started_at = 0.0
        self.port: int = 0
        self._uds_server: Optional[asyncio.base_events.Server] = None
        self.uds_path: Optional[str] = None
        d = str(dispid)
        self._sync_records_up = _SYNC_RECORDS.labels(d, "up")
        self._sync_records_down = _SYNC_RECORDS.labels(d, "down")
        self._mig_routed = _MIGRATE_EVENTS.labels(d, "routed")
        self._mig_bounced = _MIGRATE_EVENTS.labels(d, "bounced")
        self._mig_cancel = _MIGRATE_EVENTS.labels(d, "cancel")
        # Plain mirrors of the counters above: harnesses sum these across
        # dispatcher OBJECTS (dead ones included) — the telemetry children
        # are unregistered at stop(), so family sums go backwards across a
        # restart.
        self.migrates_routed = 0
        self.migrates_bounced = 0
        self.migrates_cancelled = 0
        # Live rebalancer ([rebalance] ini section / RebalanceConfig):
        # every dispatcher keeps the report table (feeds game_load_score
        # and /healthz), the configured driver additionally PLANS.
        from goworld_tpu_torch.config.read_config import RebalanceConfig
        from goworld_tpu_torch.rebalance import RebalancePlanner

        self.rebalance_cfg = rebalance or RebalanceConfig()
        self.planner = RebalancePlanner(self.rebalance_cfg)
        self._last_plan = 0.0
        # Harness hook: pause/resume planning without reconstructing the
        # service (the multigame bench measures convergence from a known
        # t0; a paused planner still ingests reports).
        self._rebalance_active = True

    # --- lifecycle ----------------------------------------------------------

    async def start(self, host: str = "127.0.0.1", port: int = 0,
                    uds_dir: Optional[str] = None) -> None:
        """Bind the TCP listener (always — port discovery and remote
        peers) and, when ``uds_dir`` is not None ([cluster] transport =
        uds), ALSO a Unix-domain listener whose path derives from the
        bound TCP port (uds_path_for) so co-located games/gates can dial
        it without extra configuration. Both listeners feed the same
        connection handler: framing, handshakes, heartbeats, and replay
        semantics are transport-identical."""
        self._server = await asyncio.start_server(self._on_conn, host, port)
        self.port = self._server.sockets[0].getsockname()[1]
        if uds_dir is not None:
            from goworld_tpu_torch.dispatchercluster.cluster import uds_path_for

            path = uds_path_for(self.port, uds_dir)
            try:
                os.unlink(path)  # stale socket from a dead predecessor
            except OSError:
                pass
            self._uds_server = await asyncio.start_unix_server(
                self._on_conn, path)
            self.uds_path = path
        self._started_at = time.monotonic()
        self._tasks.append(asyncio.get_running_loop().create_task(self._logic_loop()))
        self._tasks.append(asyncio.get_running_loop().create_task(self._tick_loop()))
        self._register_metrics()
        from goworld_tpu_torch.utils import debug_http

        debug_http.set_health_provider(self._health)
        gwlog.infof("dispatcher %d listening on %s:%d%s", self.dispid, host,
                    self.port,
                    f" + uds {self.uds_path}" if self.uds_path else "")
        gwlog.infof(consts.DISPATCHER_STARTED_TAG)

    def _health(self) -> dict:
        """One JSON object for GET /healthz (chaos/ops liveness probes —
        no /metrics text parsing needed)."""
        now = time.monotonic()

        def age(proxy) -> Optional[float]:
            last = self._peer_last_seen.get(proxy)
            return round(now - last, 3) if last is not None else None

        return {
            "kind": "dispatcher",
            "id": self.dispid,
            "uptime_s": round(now - self._started_at, 3),
            "deployment_ready": self.deployment_ready,
            "queue_depth": self._queue.qsize(),
            "entities_routed": len(self.entities),
            "rebalance": {
                "enabled": self.rebalance_cfg.enabled,
                "driver": (self.rebalance_cfg.driver_dispatcher
                           == self.dispid),
                "planner_service": self.rebalance_cfg.planner_service,
                "last_result": self.planner.last_result,
                "reporting_games": self.planner.reports.games(),
                "space_handoffs": len(self._space_handoffs),
            },
            "games": {
                str(gid): {"connected": gi.connected,
                           "last_seen_age_s": age(gi.proxy)}
                for gid, gi in self.games.items()
            },
            "gates": {
                str(gid): {"connected": gt.connected,
                           "last_seen_age_s": age(gt.proxy),
                           "gen": gt.generation}
                for gid, gt in self.gates.items()
            },
        }

    def _register_metrics(self) -> None:
        """Pull-sampled gauges on /metrics, labeled by dispid. set_function
        costs the logic loop nothing — collection walks the tables only
        when a scraper asks (telemetry/metrics.py). Wire-level packet/byte
        counters live one layer down in proto/conn.py (net_*_total) so
        every transport this dispatcher speaks is counted uniformly."""
        from goworld_tpu_torch import telemetry

        d = str(self.dispid)
        telemetry.gauge(
            "dispatcher_queue_depth",
            "Packets waiting in the dispatcher logic queue.", ("dispid",),
        ).labels(d).set_function(self._queue.qsize)
        telemetry.gauge(
            "dispatcher_pending_entities",
            "Entities currently blocked (load/migrate window) or holding "
            "buffered packets.", ("dispid",),
        ).labels(d).set_function(
            lambda: sum(
                1 for i in self.entities.values()
                if i.pending or i.blocked(time.monotonic())
            ))
        telemetry.gauge(
            "dispatcher_connections",
            "Live peer connections (games + gates + handshaking).",
            ("dispid",),
        ).labels(d).set_function(lambda: len(self._conns))
        telemetry.gauge(
            "dispatcher_entity_table_size",
            "Entries in the entity routing table.", ("dispid",),
        ).labels(d).set_function(lambda: len(self.entities))

    def _track_peer_gauge(self, peer: str) -> None:
        """Pull-sampled ``cluster_peer_last_seen_seconds{dispid,peer}``:
        seconds since the named peer's last packet (NaN once gone). One
        child per registered game/gate; removed on disconnect."""
        from goworld_tpu_torch import telemetry

        def age() -> float:
            table = self.games if peer.startswith("game") else self.gates
            info = table.get(int(peer[4:]))
            proxy = info.proxy if info is not None else None
            last = self._peer_last_seen.get(proxy) if proxy is not None else None
            return time.monotonic() - last if last is not None else float("nan")

        telemetry.gauge(
            "cluster_peer_last_seen_seconds",
            "Seconds since the last packet from each registered peer.",
            ("dispid", "peer"),
        ).labels(str(self.dispid), peer).set_function(age)

    def _untrack_peer_gauge(self, peer: str) -> None:
        from goworld_tpu_torch import telemetry

        fam = telemetry.family("cluster_peer_last_seen_seconds")
        if fam is not None:
            fam.remove(str(self.dispid), peer)

    def _unregister_metrics(self) -> None:
        from goworld_tpu_torch import telemetry

        d = str(self.dispid)
        for name in ("dispatcher_queue_depth", "dispatcher_pending_entities",
                     "dispatcher_connections", "dispatcher_entity_table_size"):
            fam = telemetry.family(name)
            if fam is not None:
                fam.remove(d)
        fam = telemetry.family("dispatcher_sync_records_total")
        if fam is not None:
            for direction in ("up", "down"):
                fam.remove(d, direction)
        fam = telemetry.family("dispatcher_migrates_total")
        if fam is not None:
            for kind in ("routed", "bounced", "cancel"):
                fam.remove(d, kind)
        fam = telemetry.family("game_load_score")
        if fam is not None:
            for gid in self.planner.reports.games():
                fam.remove(str(gid))
        fam = telemetry.family("cluster_peer_last_seen_seconds")
        if fam is not None:
            for gid in list(self.games):
                fam.remove(d, f"game{gid}")
            for gid in list(self.gates):
                fam.remove(d, f"gate{gid}")

    async def stop(self) -> None:
        from goworld_tpu_torch.utils import debug_http

        debug_http.clear_health_provider(self._health)
        self._unregister_metrics()
        for t in self._tasks:
            t.cancel()
        for t in self._tasks:
            try:
                await t
            except (asyncio.CancelledError, Exception):
                pass
        self._tasks.clear()
        if self._uds_server is not None:
            self._uds_server.close()
        if self._server is not None:
            self._server.close()
            # Close live connections BEFORE wait_closed(): since 3.12.1
            # Server.wait_closed() waits for connection handlers, which only
            # exit once their sockets close — closing after would deadlock.
            for proxy in list(self._conns):
                proxy.close()
            await self._server.wait_closed()
        if self._uds_server is not None:
            await self._uds_server.wait_closed()
            self._uds_server = None
            if self.uds_path is not None:
                try:
                    os.unlink(self.uds_path)
                except OSError:
                    pass
        for gi in self.games.values():
            if gi.proxy is not None:
                gi.proxy.close()
        for gt in self.gates.values():
            if gt.proxy is not None:
                gt.proxy.close()

    # --- connection handling -------------------------------------------------

    async def _on_conn(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        proxy = GoWorldConnection(
            PacketConnection(reader, writer), trace_wire=True)
        self._conns.add(proxy)
        self._peer_last_seen[proxy] = time.monotonic()
        try:
            while True:
                msgtype, packet = await proxy.recv()
                self._peer_last_seen[proxy] = time.monotonic()
                await self._queue.put((proxy, msgtype, packet))
        except ConnectionClosed:
            await self._queue.put((proxy, -1, None))  # disconnect sentinel
        finally:
            self._conns.discard(proxy)
            self._peer_last_seen.pop(proxy, None)
            self._hb_sent_marks.pop(proxy, None)
            proxy.close()

    async def _logic_loop(self) -> None:
        queue = self._queue
        while True:
            # Drain the whole burst without yielding (the gate and game
            # loops batch the same way): routing cost then scales with
            # PACKETS handled back to back, and peer links are corked for
            # the span of the burst so N forwards to one game/gate leave
            # in ONE transport write at batch end — skipping the
            # FLUSH_INTERVAL timer the tracecat soak measured as the worst
            # per-hop latency. No awaits between cork and uncork, so the
            # tick loop's heartbeats can never interleave into a corked
            # span.
            batch = [await queue.get()]
            while True:
                try:
                    batch.append(queue.get_nowait())
                except asyncio.QueueEmpty:
                    break
            await self._resume_event.wait()  # chaos pause hook (no-op live)
            corked: list[GoWorldConnection] = []
            if len(batch) > 1:
                corked = [gi.proxy for gi in self.games.values()
                          if gi.connected]
                corked += [gt.proxy for gt in self.gates.values()
                           if gt.connected]
                for p in corked:
                    p.cork()
            try:
                for proxy, msgtype, packet in batch:
                    try:
                        if msgtype == -1:
                            self._handle_disconnect(proxy)
                        elif packet is not None and packet.trace is not None:
                            # Sampled packet: the handling span covers queue
                            # dwell (recv → here, its own child span — THE
                            # number the paper's routing path hides) +
                            # routing, and any forward inside re-attaches
                            # the trailer downstream.
                            scope = tracing.continue_from_packet(
                                packet, "dispatcher.route",
                                dwell_name="dispatcher.queue_dwell")
                            scope.args["msgtype"] = int(msgtype)
                            scope.args["dispid"] = self.dispid
                            records = self._record_count(msgtype, packet)
                            if records is not None:
                                scope.args["records"] = records
                            with scope:
                                self._handle(proxy, msgtype, packet)
                        else:
                            self._handle(proxy, msgtype, packet)
                    except Exception:
                        gwlog.trace_error(
                            "dispatcher %d: error handling msgtype %s",
                            self.dispid, msgtype)
            finally:
                for p in corked:
                    try:
                        p.uncork()
                    except Exception:
                        pass  # a dead link must not strand the others

    @staticmethod
    def _record_count(msgtype: int, packet: Packet) -> Optional[int]:
        """Sync records carried by this packet (None for non-sync types) —
        the ``records`` attribute on dispatcher.route spans."""
        if msgtype == MsgType.SYNC_POSITION_YAW_FROM_CLIENT:
            return packet.payload_len() // SYNC_RECORD_SIZE
        if msgtype == MsgType.SYNC_POSITION_YAW_ON_CLIENTS:
            return (packet.payload_len() - 2) // _CLIENT_SYNC_BLOCK
        if msgtype == MsgType.SYNC_POSITION_YAW_DELTA_ON_CLIENTS:
            return (packet.payload_len() - 3) // _CLIENT_DELTA_BLOCK
        return None

    async def _tick_loop(self) -> None:
        while True:
            await asyncio.sleep(consts.DISPATCHER_SERVICE_TICK_INTERVAL)
            await self._resume_event.wait()  # chaos pause hook (no-op live)
            self._send_pending_syncs()
            self._sweep_dead_frozen_games()
            self._sweep_dead_gates()
            self._sweep_unrouted_entities()
            self._sweep_space_handoffs()
            self._retry_pending_boots()
            self._heartbeat_tick()
            self._rebalance_tick()

    # --- rebalance driving (rebalance/planner.py) ----------------------------

    def rebalance_pause(self) -> None:
        self._rebalance_active = False

    def rebalance_resume(self) -> None:
        self._rebalance_active = True

    def _rebalance_tick(self) -> None:
        """One planning round per [rebalance] interval on the driver
        dispatcher: plan against live links + fresh reports, then command
        each donor game. A move's REBALANCE_MIGRATE rides the same
        buffered per-game dispatch as every other packet, so a game in a
        reconnect-grace window receives it after the handshake — or never,
        if it dies, which the planner's next round simply observes."""
        rb = self.rebalance_cfg
        if (not rb.enabled or self.dispid != rb.driver_dispatcher
                or not self._rebalance_active):
            return
        if rb.planner_service:
            # The sharded RebalancePlannerService plans instead; its
            # REBALANCE_PLAN pushes arrive at _handle_rebalance_plan.
            return
        now = self._now()
        if now - self._last_plan < rb.interval:
            return
        self._last_plan = now
        connected = {gid for gid, gi in self.games.items() if gi.connected}
        self._dispatch_plan(self.planner.plan(connected, now), now)

    def _dispatch_plan(self, plan: list, now: float) -> None:
        """Turn a planning round's Move/SpaceMove list into dispatcher
        commands toward each donor game."""
        from goworld_tpu_torch.rebalance.planner import Move

        for move in plan:
            gi = self.games.get(move.from_game)
            if gi is None or not gi.connected:
                continue  # link dropped since planning; next round re-sees
            if isinstance(move, Move):
                p = Packet()
                p.append_entity_id(move.from_space)
                p.append_entity_id(move.to_space)
                p.append_uint16(move.to_game)
                p.append_uint16(move.count)
                gi.dispatch(MsgType.REBALANCE_MIGRATE, p, now)
            else:
                p = Packet()
                p.append_entity_id(move.spaceid)
                p.append_uint16(move.to_game)
                gi.dispatch(MsgType.REBALANCE_MIGRATE_SPACE, p, now)

    def _handle_rebalance_plan(self, proxy: GoWorldConnection,
                               packet: Packet) -> None:
        """A plan computed by the sharded RebalancePlannerService (planner
        failover). The dispatcher stays the authority on command
        DISPATCH: it validates the config gate and per-game liveness, so a
        stale service (e.g. one racing its own destruction after losing a
        registration race) cannot move entities on a cluster that turned
        rebalancing off."""
        from goworld_tpu_torch.rebalance.planner import plan_from_wire

        plan = plan_from_wire(packet.read_data())
        rb = self.rebalance_cfg
        if not (rb.enabled and rb.planner_service
                and self._rebalance_active):
            gwlog.warnf(
                "dispatcher %d: dropping REBALANCE_PLAN (%d commands) — "
                "planner-service rebalancing not active here",
                self.dispid, len(plan))
            return
        self._dispatch_plan(plan, self._now())

    # --- chaos/testing hooks -------------------------------------------------

    def pause(self) -> None:
        """Stall the process without closing sockets: the logic and tick
        loops stop draining (recv tasks keep filling the bounded queue —
        kernel-level ACKs continue, exactly like a SIGSTOPped process).
        Peers' liveness watchdogs are expected to kill the silent links."""
        self._resume_event.clear()

    def resume(self) -> None:
        self._resume_event.set()

    # --- peer liveness (no reference analog) ---------------------------

    def _peer_proxies(self) -> list[tuple[str, GoWorldConnection]]:
        peers = [
            (f"game{gid}", gi.proxy)
            for gid, gi in self.games.items() if gi.connected
        ]
        peers.extend(
            (f"gate{gid}", gt.proxy)
            for gid, gt in self.gates.items() if gt.connected
        )
        return peers

    def _heartbeat_tick(self) -> None:
        """Every timeout/3: HEARTBEAT every idle registered link, and close
        links silent past the timeout (the peer's reconnect loop takes it
        from there — a half-open link must not stall forever)."""
        timeout = self.peer_heartbeat_timeout
        if timeout <= 0:
            return
        now = self._now()
        if now - self._last_hb_tick < max(0.05, timeout / 3.0):
            return
        self._last_hb_tick = now
        for name, proxy in self._peer_proxies():
            last = self._peer_last_seen.get(proxy)
            if last is not None and now - last > timeout:
                gwlog.warnf(
                    "dispatcher %d: %s silent for %.1fs (> %.1fs heartbeat "
                    "deadline); closing half-open link",
                    self.dispid, name, now - last, timeout)
                proxy.close()
                continue
            if self._hb_sent_marks.get(proxy) == proxy.conn.sent_packets:
                try:
                    proxy.send_cluster_heartbeat()
                except Exception:
                    pass  # dying link; its recv task reports the disconnect
            self._hb_sent_marks[proxy] = proxy.conn.sent_packets

    def _sweep_dead_frozen_games(self) -> None:
        """A game that disconnected — frozen for a reload, or unplanned
        (which now gets a reconnect-grace buffer window too) — and never
        came back: once its window lapses, clean it up like any dead game
        (the reference only buffers for the freeze timeout,
        DispatcherService.go:82-169)."""
        now = self._now()
        for gameid, gi in list(self.games.items()):
            if gi.proxy is None and gi.block_until and not gi.blocked(now):
                gi.block_until = 0.0
                # Buffered REAL_MIGRATE / SPACE_MIGRATE_DATA payloads are
                # entities' (or a whole space's) LAST copies: bounce each
                # home before the buffer drops (the trailing source-gameid
                # makes this possible without the long-gone forwarding
                # proxy).
                for msgtype, packet in gi.pending:
                    if msgtype not in (MsgType.REAL_MIGRATE,
                                       MsgType.SPACE_MIGRATE_DATA):
                        continue
                    eid = packet.read_entity_id()
                    packet.set_read_pos(0)
                    if not self._bounce_migrate_home(
                            eid, packet,
                            self._real_migrate_source(packet), now,
                            msgtype=msgtype):
                        gwlog.errorf(
                            "dispatcher %d: %s of %s buffered "
                            "for dead game %d has no live source; "
                            "state dropped", self.dispid,
                            MsgType(msgtype).name, eid, gameid)
                gi.pending.clear()
                self._bounce_inflight_spaces(gameid, now)
                self._handle_game_down(gameid)

    def _bounce_inflight_spaces(self, gameid: int, now: float) -> None:
        """Every space bundle routed to ``gameid`` that it never
        acknowledged goes home to its source game: the game died with the
        bundle unread, or restored it and died before its ack left (then
        the restored copy died with it). Either way the kept packet is the
        only live copy."""
        for spaceid, entry in self._space_handoffs.items():
            if entry.inflight is None or entry.inflight[0] != gameid:
                continue
            _target, packet, source = entry.inflight
            entry.inflight = None
            packet.set_read_pos(0)
            if not self._bounce_migrate_home(
                    spaceid, packet, source, now,
                    msgtype=MsgType.SPACE_MIGRATE_DATA):
                gwlog.errorf(
                    "dispatcher %d: SPACE_MIGRATE_DATA of %s routed to dead "
                    "game %d has no live source; space state dropped",
                    self.dispid, spaceid, gameid)

    def _sweep_dead_gates(self) -> None:
        """A gate whose reconnect-grace window lapsed is really dead: NOW
        broadcast NOTIFY_GATE_DISCONNECTED (games detach its clients) and
        forget it."""
        now = self._now()
        for gateid, gt in list(self.gates.items()):
            if gt.proxy is None and gt.block_until and not gt.blocked(now):
                self.gates.pop(gateid, None)
                self._untrack_peer_gauge(f"gate{gateid}")
                dropped = len(gt.pending)
                gt.pending.clear()
                p = Packet()
                p.append_uint16(gateid)
                p.append_uint32(0)  # gone entirely: every generation is dead
                self._broadcast_games(MsgType.NOTIFY_GATE_DISCONNECTED, p)
                gwlog.infof(
                    "dispatcher %d: gate %d never reconnected (%d buffered "
                    "packets dropped); declared dead", self.dispid, gateid,
                    dropped)

    def _sweep_unrouted_entities(self) -> None:
        """Drop buffered packets for entities no game claimed within the
        grace window (the packets raced a re-handshake that never came, or
        named a destroyed/bogus entity)."""
        if not self._unrouted:
            return
        now = self._now()
        for eid, expiry in list(self._unrouted.items()):
            if now < expiry:
                continue
            del self._unrouted[eid]
            info = self.entities.get(eid)
            if info is not None and info.gameid == 0:
                gwlog.warnf(
                    "dispatcher %d: dropping %d buffered packets for "
                    "never-routed entity %s", self.dispid,
                    len(info.pending), eid)
                del self.entities[eid]

    # --- dispatch helpers ----------------------------------------------------

    def _now(self) -> float:
        return time.monotonic()

    def _game(self, gameid: int) -> _GameInfo:
        gi = self.games.get(gameid)
        if gi is None:
            gi = self.games[gameid] = _GameInfo(gameid)
        return gi

    def _gate(self, gateid: int) -> _GateInfo:
        gt = self.gates.get(gateid)
        if gt is None:
            gt = self.gates[gateid] = _GateInfo(gateid)
        return gt

    def _entity(self, eid: str) -> _EntityDispatchInfo:
        info = self.entities.get(eid)
        if info is None:
            info = self.entities[eid] = _EntityDispatchInfo()
        return info

    def _gameid_of(self, proxy: GoWorldConnection) -> int:
        return self._proxy_games.get(proxy, 0)

    def _gateid_of(self, proxy: GoWorldConnection) -> int:
        return self._proxy_gates.get(proxy, 0)

    def _dispatch_to_entity(self, eid: str, msgtype: int, packet: Packet) -> None:
        """Route a packet by the entity table, honoring blocks
        (DispatcherService.go:34-80,826-844). An UNKNOWN entity gets a
        short buffered grace window instead of an instant drop (deviation
        from the reference): after a dispatcher restart, a gate's replay
        ring can legitimately land packets before the owning game's
        re-handshake installs the route — the handshake/NOTIFY_CREATE
        flush delivers them; _sweep_unrouted_entities drops unclaimed
        buffers when the window lapses."""
        now = self._now()
        info = self.entities.get(eid)
        if info is None or info.gameid == 0:
            if info is None:
                info = self._entity(eid)
            if eid not in self._unrouted:
                self._unrouted[eid] = (
                    now + consts.DISPATCHER_RECONNECT_BUFFER_WINDOW)
            if not info.push_pending(msgtype, packet):
                gwlog.warnf(
                    "dispatcher %d: unrouted-entity buffer overflow for %s "
                    "(msgtype %s dropped)", self.dispid, eid, msgtype)
            return
        if info.blocked(now):
            if not info.push_pending(msgtype, packet):
                gwlog.warnf("dispatcher %d: pending queue overflow for %s", self.dispid, eid)
            return
        self._game(info.gameid).dispatch(msgtype, packet, now)

    def _flush_entity_pending(self, info: _EntityDispatchInfo) -> None:
        now = self._now()
        info.unblock()
        while info.pending:
            msgtype, packet = info.pending.popleft()
            self._game(info.gameid).dispatch(msgtype, packet, now)

    def _broadcast_games(self, msgtype: int, packet: Packet, except_game: int = 0) -> None:
        now = self._now()
        for gid, gi in self.games.items():
            if gid != except_game:
                gi.dispatch(msgtype, packet, now)

    def _broadcast_gates(self, msgtype: int, packet: Packet) -> None:
        now = self._now()
        for gt in self.gates.values():
            gt.dispatch(msgtype, packet, now)

    # --- message handling ----------------------------------------------------

    def _handle(self, proxy: GoWorldConnection, msgtype: int, packet: Packet) -> None:
        if is_gate_redirect(msgtype):
            # Payload starts [u16 gateid][clientid...]; route on gateid
            # (DispatcherService.go:841-844).
            self._route_to_gate(msgtype, packet)
            return
        if msgtype == MsgType.SYNC_POSITION_YAW_ON_CLIENTS:
            t0 = time.perf_counter()
            self._sync_records_down.inc(
                (packet.payload_len() - 2) // _CLIENT_SYNC_BLOCK)
            self._route_to_gate(msgtype, packet)
            _HOP_ROUTE.inc(time.perf_counter() - t0)
            return
        if msgtype == MsgType.SYNC_POSITION_YAW_DELTA_ON_CLIENTS:
            # v6 quantized-delta sync: same gateid-prefix routing as the
            # full-precision stream (the extra quantize_bits byte rides
            # the payload untouched).
            t0 = time.perf_counter()
            self._sync_records_down.inc(
                (packet.payload_len() - 3) // _CLIENT_DELTA_BLOCK)
            self._route_to_gate(msgtype, packet)
            _HOP_ROUTE.inc(time.perf_counter() - t0)
            return
        if msgtype == MsgType.CALL_FILTERED_CLIENTS:
            self._broadcast_gates(msgtype, packet)
            return

        handler = self._HANDLERS.get(msgtype)
        if handler is None:
            gwlog.warnf("dispatcher %d: unhandled msgtype %s", self.dispid, msgtype)
            return
        handler(self, proxy, packet)

    def _route_to_gate(self, msgtype: int, packet: Packet) -> None:
        """Route a [u16 gateid]-prefixed packet, parsing the header ONCE:
        forwarding serializes the whole payload regardless of the read
        cursor, so the old read → set_read_pos(0) → re-parse dance was
        two parses per redirect packet for nothing. A gate in its
        reconnect-grace window buffers; an unknown gateid drops (as the
        reference)."""
        gt = self.gates.get(packet.read_uint16())
        if gt is not None:
            gt.dispatch(msgtype, packet, self._now())

    # --- handshakes ----------------------------------------------------------

    def _check_proto_version(
        self, proxy: GoWorldConnection, packet: Packet, peer: str
    ) -> bool:
        """Reject a handshake whose PROTO_VERSION trailer is absent or
        different — a mixed-version pair would otherwise mis-frame packets
        whose layouts changed (e.g. the migrate-nonce fields) and fail far
        from the cause. Pre-version peers send no trailer."""
        ver = packet.read_uint32() if packet.unread_len() >= 4 else 0
        if ver == PROTO_VERSION:
            return True
        gwlog.errorf(
            "dispatcher %d: %s speaks protocol version %d, this dispatcher "
            "speaks %d — deploy dispatchers and games/gates in lockstep "
            "(restart the cluster with one build); closing the connection",
            self.dispid, peer, ver, PROTO_VERSION,
        )
        proxy.close()
        return False

    def _handle_set_game_id(self, proxy: GoWorldConnection, packet: Packet) -> None:
        gameid = packet.read_uint16()
        is_reconnect = packet.read_bool()
        is_restore = packet.read_bool()
        is_ban_boot = packet.read_bool()
        entity_ids = packet.read_data()
        if not isinstance(entity_ids, list) or not all(
                isinstance(e, str) for e in entity_ids):
            # Parser contract (gwlint R3 / the schema fuzz): hostile or
            # corrupt payloads raise ValueError, never leak a TypeError
            # out of the reconciliation loop below.
            raise ValueError(
                f"SET_GAME_ID from game {gameid}: entity list is "
                f"{type(entity_ids).__name__}, expected list[str]")
        if not self._check_proto_version(proxy, packet, f"game {gameid}"):
            return
        now = self._now()
        if not is_reconnect and not is_restore:
            # Space bundles written to the dead incarnation's link were
            # never read: bounce them home before its routes go.
            self._bounce_inflight_spaces(gameid, now)
            # A COLD-booted game (neither a surviving process re-dialing
            # nor a freeze restore) owns no prior entities: any routing
            # entries still homed to this gameid belong to a dead
            # incarnation (crash + recreate inside the reconnect-grace
            # window, before the down-sweep wiped them). Purge them now —
            # stale routes would otherwise forward RPCs and sync records
            # at a game that never heard of those entities.
            stale = [eid for eid, info in self.entities.items()
                     if info.gameid == gameid]
            for eid in stale:
                del self.entities[eid]
                self._unrouted.pop(eid, None)
            if stale:
                gwlog.warnf(
                    "dispatcher %d: game %d cold boot replaces a dead "
                    "incarnation; purged %d stale entity routes",
                    self.dispid, gameid, len(stale))
        gi = self._game(gameid)
        gi.proxy = proxy
        gi.is_banned_boot = is_ban_boot
        self._proxy_games[proxy] = gameid
        self._lbc.update(gameid, 0.0)
        self._track_peer_gauge(f"game{gameid}")

        # Reconnect reconciliation: reject entities homed elsewhere
        # (DispatcherService.go:376-398).
        rejected: list[str] = []
        for eid in entity_ids:
            info = self.entities.get(eid)
            if info is not None and info.gameid not in (0, gameid):
                rejected.append(eid)
            else:
                info = self._entity(eid)
                info.gameid = gameid
                # The game just proved this entity LIVES there: any migrate
                # block (whose REAL_MIGRATE died with the pre-restore
                # process) is stale — without this, a lost migration leaves
                # the entity's RPC stream buffered for the full 60 s window.
                if info.blocked(now) or info.pending:
                    self._flush_entity_pending(info)
        proxy.send_set_game_id_ack(
            online_games=sorted(
                gid for gid, g in self.games.items() if g.connected
            ),
            rejected_entity_ids=rejected,
            kvreg_map=dict(self.kvreg),
            deployment_ready=self.deployment_ready,
        )
        notify = Packet()
        notify.append_uint16(gameid)
        self._broadcast_games(MsgType.NOTIFY_GAME_CONNECTED, notify, except_game=gameid)
        self._keep_buffered_spaces(gi, now)
        gi.unblock_and_flush()
        self._check_deployment_ready()
        gwlog.infof(
            "dispatcher %d: game %d connected (reconnect=%s restore=%s, %d entities, %d rejected)",
            self.dispid, gameid, is_reconnect, is_restore, len(entity_ids), len(rejected),
        )

    def _handle_set_gate_id(self, proxy: GoWorldConnection, packet: Packet) -> None:
        gateid = packet.read_uint16()
        fresh = packet.read_bool()
        gen = packet.read_uint32()
        if not self._check_proto_version(proxy, packet, f"gate {gateid}"):
            return
        if fresh and gateid in self.gates:
            # A brand-new gate PROCESS replacing a registered predecessor
            # (crash + restart inside the reconnect-grace window): the old
            # process's client bindings are dead — no socket will ever
            # serve those clientids again. Tell the games to detach them
            # BEFORE registering the new proxy, and drop the buffered
            # packets (they address clients of the dead incarnation). The
            # broadcast names the NEW generation as valid, so a game that
            # processes it AFTER a new-generation client already connected
            # (cross-dispatcher ordering) cannot detach the live client. A
            # surviving gate re-dialing after a link blip sends
            # fresh=False and keeps its bindings + buffer.
            old = self.gates[gateid]
            dropped = len(old.pending)
            old.pending.clear()
            p = Packet()
            p.append_uint16(gateid)
            p.append_uint32(gen)
            self._broadcast_games(MsgType.NOTIFY_GATE_DISCONNECTED, p)
            gwlog.warnf(
                "dispatcher %d: gate %d is a FRESH process (gen %d); "
                "detached the dead predecessor's clients on all games "
                "(%d buffered packets dropped)", self.dispid, gateid, gen,
                dropped)
        gt = self._gate(gateid)
        gt.proxy = proxy
        gt.generation = gen
        gt.block_until = 0.0
        self._proxy_gates[proxy] = gateid
        self._track_peer_gauge(f"gate{gateid}")
        gt.unblock_and_flush()  # reconnect within the grace window
        self._check_deployment_ready()
        gwlog.infof("dispatcher %d: gate %d connected (fresh=%s)",
                    self.dispid, gateid, fresh)

    def _check_deployment_ready(self) -> None:
        """Readiness barrier (DispatcherService.go:446-476)."""
        if self.deployment_ready:
            return
        n_games = sum(1 for g in self.games.values() if g.connected)
        n_gates = sum(1 for g in self.gates.values() if g.connected)
        if n_games >= self.desired_games and n_gates >= self.desired_gates:
            self.deployment_ready = True
            p = Packet()
            self._broadcast_games(MsgType.NOTIFY_DEPLOYMENT_READY, p)
            gwlog.infof("dispatcher %d: deployment ready (%d games, %d gates)",
                        self.dispid, n_games, n_gates)

    # --- entity table ---------------------------------------------------------

    def _handle_notify_create_entity(self, proxy: GoWorldConnection, packet: Packet) -> None:
        eid = packet.read_entity_id()
        gameid = self._gameid_of(proxy)
        info = self._entity(eid)
        info.gameid = gameid
        self._flush_entity_pending(info)

    def _handle_notify_destroy_entity(self, proxy: GoWorldConnection, packet: Packet) -> None:
        eid = packet.read_entity_id()
        self.entities.pop(eid, None)

    # --- client lifecycle -----------------------------------------------------

    def _handle_notify_client_connected(self, proxy: GoWorldConnection, packet: Packet) -> None:
        """Gate announced a fresh client; choose a boot game round-robin
        over non-banned games (DispatcherService.go:545-555,663-667).

        No game available — every boot-capable game mid-reconnect (a link
        flap under load, a rolling restart) — used to DROP the boot
        forever: the client sat connected with no player until it gave
        up. Boots now buffer for the reconnect-grace window and retry
        each tick; only a window that lapses with still no game drops
        (with the same warn)."""
        gameid = self._choose_game_for_boot()
        if gameid == 0:
            self._pending_boots.append(
                (packet, self._now() + consts.DISPATCHER_RECONNECT_BUFFER_WINDOW))
            gwlog.warnf(
                "dispatcher %d: no game available for boot entity; "
                "buffering %.0fs for a game (re)connect", self.dispid,
                consts.DISPATCHER_RECONNECT_BUFFER_WINDOW)
            return
        boot_eid = Packet(packet.payload)  # peek boot eid: clientid(16)+u16+eid(16)
        boot_eid.read_client_id()
        boot_eid.read_uint16()
        eid = boot_eid.read_entity_id()
        info = self._entity(eid)
        info.gameid = gameid
        self._game(gameid).dispatch(MsgType.NOTIFY_CLIENT_CONNECTED, packet, self._now())

    def _retry_pending_boots(self) -> None:
        """Tick-driven retry of boots that arrived while no boot-capable
        game had a live link (see _handle_notify_client_connected)."""
        if not self._pending_boots:
            return
        now = self._now()
        pending = self._pending_boots
        self._pending_boots = []
        for packet, expiry in pending:
            if now >= expiry:
                gwlog.warnf(
                    "dispatcher %d: boot entity request expired with no "
                    "game available; dropped", self.dispid)
                continue
            self._handle_notify_client_connected(None, packet)  # type: ignore[arg-type]

    def _handle_notify_client_disconnected(self, proxy: GoWorldConnection, packet: Packet) -> None:
        packet.read_client_id()
        owner_eid = packet.read_entity_id()
        packet.set_read_pos(0)
        self._dispatch_to_entity(owner_eid, MsgType.NOTIFY_CLIENT_DISCONNECTED, packet)

    def _choose_game_for_boot(self) -> int:
        candidates = sorted(
            gid for gid, g in self.games.items() if g.connected and not g.is_banned_boot
        )
        if not candidates:
            return 0
        self._boot_rr = (self._boot_rr + 1) % len(candidates)
        return candidates[self._boot_rr]

    # --- RPC routing ----------------------------------------------------------

    def _handle_call_entity_method(self, proxy: GoWorldConnection, packet: Packet) -> None:
        eid = packet.read_entity_id()
        packet.set_read_pos(0)
        self._dispatch_to_entity(eid, MsgType.CALL_ENTITY_METHOD, packet)

    def _handle_call_entity_method_from_client(self, proxy: GoWorldConnection, packet: Packet) -> None:
        eid = packet.read_entity_id()
        packet.set_read_pos(0)
        self._dispatch_to_entity(eid, MsgType.CALL_ENTITY_METHOD_FROM_CLIENT, packet)

    def _handle_call_nil_spaces(self, proxy: GoWorldConnection, packet: Packet) -> None:
        except_game = packet.read_uint16()
        packet.set_read_pos(0)
        self._broadcast_games(MsgType.CALL_NIL_SPACES, packet, except_game=except_game)

    # --- create / load somewhere ----------------------------------------------

    def _handle_create_entity_somewhere(self, proxy: GoWorldConnection, packet: Packet) -> None:
        gameid = packet.read_uint16()
        packet.read_varstr()
        eid = packet.read_entity_id()
        packet.set_read_pos(0)
        if gameid == 0:
            gameid = self._lbc.choose() or self._choose_game_for_boot()
        if gameid == 0:
            gwlog.warnf("dispatcher %d: no game for CREATE_ENTITY_SOMEWHERE", self.dispid)
            return
        self._entity(eid).gameid = gameid
        self._game(gameid).dispatch(MsgType.CREATE_ENTITY_SOMEWHERE, packet, self._now())

    def _handle_load_entity_somewhere(self, proxy: GoWorldConnection, packet: Packet) -> None:
        gameid = packet.read_uint16()
        packet.read_varstr()
        eid = packet.read_entity_id()
        packet.set_read_pos(0)
        info = self.entities.get(eid)
        if info is not None and info.gameid != 0:
            return  # already loaded somewhere; calls will route there
        if gameid == 0:
            gameid = self._lbc.choose() or self._choose_game_for_boot()
        if gameid == 0:
            return
        info = self._entity(eid)
        info.gameid = gameid
        # Block RPCs while the entity loads (consts.go load timeout).
        info.block(self._now(), consts.DISPATCHER_LOAD_TIMEOUT)
        self._game(gameid).dispatch(MsgType.LOAD_ENTITY_SOMEWHERE, packet, self._now())

    # --- migration (DispatcherService.go:850-907) -----------------------------

    def _ack_requester(self, proxy: GoWorldConnection, msgtype: int, p: Packet) -> None:
        """Send a migration ack back to the requesting game THROUGH its
        buffered dispatch: a raw proxy write to a game that is mid-freeze
        lands in a socket its process never reads again, while the buffered
        path survives until the restore (a restored entity simply ignores a
        stale ack via _enter_space_request_valid)."""
        gameid = self._gameid_of(proxy)
        if gameid:
            self._game(gameid).dispatch(msgtype, p, self._now())
        else:
            proxy.send(msgtype, p)

    def _handle_query_space_gameid_for_migrate(self, proxy: GoWorldConnection, packet: Packet) -> None:
        spaceid = packet.read_entity_id()
        eid = packet.read_entity_id()
        nonce = packet.read_uint32()
        space_info = self.entities.get(spaceid)
        gameid = space_info.gameid if space_info is not None else 0
        # Ack goes back to the entity's current game (the requester); the
        # request nonce is echoed verbatim (proto/conn.py).
        p = Packet()
        p.append_entity_id(spaceid)
        p.append_entity_id(eid)
        p.append_uint16(gameid)
        p.append_uint32(nonce)
        self._ack_requester(proxy, MsgType.QUERY_SPACE_GAMEID_FOR_MIGRATE_ACK, p)

    def _handle_migrate_request(self, proxy: GoWorldConnection, packet: Packet) -> None:
        eid = packet.read_entity_id()
        spaceid = packet.read_entity_id()
        space_gameid = packet.read_uint16()
        nonce = packet.read_uint32()
        info = self._entity(eid)
        info.block(self._now(), consts.DISPATCHER_MIGRATE_TIMEOUT)
        p = Packet()
        p.append_entity_id(eid)
        p.append_entity_id(spaceid)
        p.append_uint16(space_gameid)
        p.append_uint32(nonce)
        self._ack_requester(proxy, MsgType.MIGRATE_REQUEST_ACK, p)

    @staticmethod
    def _real_migrate_source(packet: Packet) -> int:
        """Trailing u16 source gameid of a REAL_MIGRATE payload (0 when a
        pre-trailer build sent it) — readable without parsing the bson
        body, so sweep-time bounces need no proxy context."""
        payload = packet.payload
        if len(payload) < 20:  # eid(16) + target(2) + trailer(2)
            return 0
        return struct.unpack_from("<H", payload, len(payload) - 2)[0]

    def _handle_real_migrate(self, proxy: GoWorldConnection, packet: Packet) -> None:
        """Route the packed entity to its target game — or BOUNCE IT HOME.

        The packet carries the entity's entire state; the source game
        already destroyed its copy. Forwarding into a game that is gone
        would therefore destroy the entity's last copy — the exact loss
        the rebalancer's zero-loss contract forbids. Three target states:

        - connected / blocked (freeze or reconnect grace): route normally
          (gi.dispatch buffers through blocks);
        - UNKNOWN (no registration — e.g. THIS dispatcher restarted and a
          replayed REAL_MIGRATE raced the target's re-handshake): grant
          the target the standard reconnect-grace window and buffer; the
          handshake flush delivers, and _sweep_dead_frozen_games bounces
          any still-buffered payloads home if the window lapses;
        - declared DEAD (registered, link gone, grace over): bounce home
          now — the source game restores the entity in place (the
          migrator counts the bounce as a rollback)."""
        eid = packet.read_entity_id()
        target_game = packet.read_uint16()
        packet.set_read_pos(0)
        now = self._now()
        info = self._entity(eid)
        gi = self.games.get(target_game)
        if gi is None:
            gi = self._game(target_game)
            gi.block_until = now + consts.DISPATCHER_RECONNECT_BUFFER_WINDOW
            gwlog.warnf(
                "dispatcher %d: REAL_MIGRATE of %s targets unknown game "
                "%d; buffering %.0fs for its handshake", self.dispid, eid,
                target_game, consts.DISPATCHER_RECONNECT_BUFFER_WINDOW)
        elif not (gi.connected or gi.blocked(now)):
            source_game = (self._gameid_of(proxy)
                           or self._real_migrate_source(packet))
            if self._bounce_migrate_home(eid, packet, source_game, now):
                return
            gwlog.errorf(
                "dispatcher %d: REAL_MIGRATE of %s targets dead game %d "
                "and the source link is gone; entity state dropped",
                self.dispid, eid, target_game)
            self.entities.pop(eid, None)
            return
        info.gameid = target_game
        self._mig_routed.inc()
        self.migrates_routed += 1
        gi.dispatch(MsgType.REAL_MIGRATE, packet, now)
        self._flush_entity_pending(info)

    def _bounce_migrate_home(self, eid: str, packet: Packet,
                             source_game: int, now: float,
                             msgtype: int = MsgType.REAL_MIGRATE) -> bool:
        """Redirect a migrate payload (REAL_MIGRATE entity or
        SPACE_MIGRATE_DATA space bundle) back to its source game, which
        restores it in place. False if the source is gone too."""
        si = self.games.get(source_game) if source_game else None
        if si is None or not (si.connected or si.blocked(now)):
            return False
        gwlog.warnf(
            "dispatcher %d: %s of %s targets a dead game; "
            "bouncing home to game %d", self.dispid,
            MsgType(msgtype).name, eid, source_game)
        info = self._entity(eid)
        info.gameid = source_game
        self._mig_bounced.inc()
        self.migrates_bounced += 1
        si.dispatch(msgtype, packet, now)
        self._flush_entity_pending(info)
        return True

    def _handle_cancel_migrate(self, proxy: GoWorldConnection, packet: Packet) -> None:
        eid = packet.read_entity_id()
        info = self.entities.get(eid)
        if info is not None:
            self._mig_cancel.inc()
            self.migrates_cancelled += 1
            self._flush_entity_pending(info)

    # --- whole-space handoff (modelcheck space_handoff) -------------

    def _handle_space_migrate_prepare(self, proxy: GoWorldConnection,
                                      packet: Packet) -> None:
        """Donor game froze a space: park the LISTED member streams this
        dispatcher routes to the donor, then ack on the donor's own FIFO.

        Same fence contract as _handle_start_freeze_game: the ack is
        written strictly after the blocks, on the same stream as every
        packet already forwarded, so receiving it proves all of this
        dispatcher's pre-park traffic has been delivered to the donor —
        the pack after the last ack misses nothing.

        The list is the freeze-time membership, and only eids CURRENTLY
        routed to the donor park: a member that completed its own entity
        migrate before the freeze must not have its stream at the NEW
        game parked (modelcheck space_member_race found exactly this).

        A dead target game refuses the PREPARE outright — SPACE_MIGRATE_
        ABORT back to the donor, nothing parked — so the handoff fails in
        one hop instead of timing out against a corpse."""
        spaceid = packet.read_entity_id()
        to_game = packet.read_uint16()
        member_eids = packet.read_data()
        donor_game = self._gameid_of(proxy)
        now = self._now()
        tgt = self.games.get(to_game)
        if tgt is None or not (tgt.connected or tgt.blocked(now)):
            p = Packet()
            p.append_entity_id(spaceid)
            p.append_varstr("target_game_down")
            self._ack_requester(proxy, MsgType.SPACE_MIGRATE_ABORT, p)
            gwlog.warnf(
                "dispatcher %d: refusing SPACE_MIGRATE_PREPARE of %s — "
                "target game %d is dead", self.dispid, spaceid, to_game)
            return
        parked: list = []
        for eid in list(member_eids) + [spaceid]:
            info = self.entities.get(eid)
            if info is None or info.gameid != donor_game:
                continue  # moved or destroyed since the freeze snapshot
            info.block(now, consts.DISPATCHER_MIGRATE_TIMEOUT)
            parked.append(eid)
        self._space_handoffs[spaceid] = _SpaceHandoff(
            now + consts.DISPATCHER_MIGRATE_TIMEOUT, parked)
        p = Packet()
        p.append_entity_id(spaceid)
        p.append_uint16(self.dispid)
        self._ack_requester(proxy, MsgType.SPACE_MIGRATE_PREPARE_ACK, p)

    def _handle_space_migrate_data(self, proxy: GoWorldConnection,
                                   packet: Packet) -> None:
        """Route the packed SPACE (with every member) to its target game —
        or bounce it home. Exactly REAL_MIGRATE's three-state contract,
        because the payload is the space's and members' last copy: route
        through blocks, grace-buffer for an unknown target's handshake,
        bounce home to the trailing source gameid when the target is
        declared dead. A bundle written to a live target's link stays
        kept (``_SpaceHandoff.inflight``) until the target acknowledges
        it, and bounces home if the target is declared dead or cold-boots
        first."""
        spaceid = packet.read_entity_id()
        target_game = packet.read_uint16()
        packet.set_read_pos(0)
        now = self._now()
        info = self._entity(spaceid)
        gi = self.games.get(target_game)
        if gi is None:
            gi = self._game(target_game)
            gi.block_until = now + consts.DISPATCHER_RECONNECT_BUFFER_WINDOW
            gwlog.warnf(
                "dispatcher %d: SPACE_MIGRATE_DATA of %s targets unknown "
                "game %d; buffering %.0fs for its handshake", self.dispid,
                spaceid, target_game,
                consts.DISPATCHER_RECONNECT_BUFFER_WINDOW)
        elif not (gi.connected or gi.blocked(now)):
            source_game = (self._gameid_of(proxy)
                           or self._real_migrate_source(packet))
            if self._bounce_migrate_home(
                    spaceid, packet, source_game, now,
                    msgtype=MsgType.SPACE_MIGRATE_DATA):
                return
            gwlog.errorf(
                "dispatcher %d: SPACE_MIGRATE_DATA of %s targets dead "
                "game %d and the source link is gone; space state dropped",
                self.dispid, spaceid, target_game)
            self.entities.pop(spaceid, None)
            return
        info.gameid = target_game
        self._mig_routed.inc()
        self.migrates_routed += 1
        if gi.connected and not gi.blocked(now):  # written to the link now
            self._keep_inflight_space(
                spaceid, target_game, packet,
                self._gameid_of(proxy) or self._real_migrate_source(packet),
                now)
        gi.dispatch(MsgType.SPACE_MIGRATE_DATA, packet, now)
        self._flush_entity_pending(info)

    def _handle_space_migrate_abort(self, proxy: GoWorldConnection,
                                    packet: Packet) -> None:
        """Donor broadcast: the handoff died (deadline, dead target, space
        destroyed) and the space unfroze in place — unpark every member."""
        spaceid = packet.read_entity_id()
        reason = packet.read_varstr()
        if self._release_space_handoff(spaceid):
            gwlog.infof(
                "dispatcher %d: space %s handoff aborted (%s); member "
                "streams unparked", self.dispid, spaceid, reason)

    def _handle_space_migrate_ack(self, proxy: GoWorldConnection,
                                  packet: Packet) -> None:
        """Receiver broadcast: the space restored. Member routes already
        moved with each NOTIFY_CREATE (which also flushed their streams);
        this clears the handoff entry and unparks any leftover parked eid
        (a member destroyed mid-handoff never gets a NOTIFY_CREATE)."""
        spaceid = packet.read_entity_id()
        packet.read_uint16()  # receiver gameid (logged at the receiver)
        self._release_space_handoff(spaceid)

    def _keep_inflight_space(self, spaceid: str, target: int, packet: Packet,
                             source: int, now: float) -> None:
        entry = self._space_handoffs.get(spaceid)
        if entry is None:  # no PREPARE reached this dispatcher
            entry = self._space_handoffs[spaceid] = _SpaceHandoff(
                now + consts.DISPATCHER_MIGRATE_TIMEOUT, [])
        entry.inflight = (target, packet, source)

    def _keep_buffered_spaces(self, gi: _GameInfo, now: float) -> None:
        """Bundles buffered while the game was away are written to its new
        link by the flush: keep each until the game acks it."""
        for msgtype, packet in gi.pending:
            if msgtype != MsgType.SPACE_MIGRATE_DATA:
                continue
            spaceid = packet.read_entity_id()
            packet.set_read_pos(0)
            self._keep_inflight_space(
                spaceid, gi.gameid, packet,
                self._real_migrate_source(packet), now)

    def _release_space_handoff(self, spaceid: str) -> bool:
        entry = self._space_handoffs.pop(spaceid, None)
        if entry is None:
            return False
        for eid in entry.parked:
            info = self.entities.get(eid)
            if info is not None:
                self._flush_entity_pending(info)
        return True

    def _sweep_space_handoffs(self) -> None:
        """Backstop: a handoff whose donor died before broadcasting an
        abort (or whose ack never reached us) must not park member streams
        past the migrate window — the deadline unparks unconditionally
        (modelcheck liveness: no stream stays parked forever)."""
        if not self._space_handoffs:
            return
        now = self._now()
        for spaceid, entry in list(self._space_handoffs.items()):
            if now >= entry.deadline:
                if entry.inflight is not None:
                    gwlog.errorf(
                        "dispatcher %d: SPACE_MIGRATE_DATA of %s routed to "
                        "game %d was never acknowledged; its kept copy is "
                        "dropped with the handoff", self.dispid, spaceid,
                        entry.inflight[0])
                self._release_space_handoff(spaceid)
                gwlog.warnf(
                    "dispatcher %d: space %s handoff hit the dispatcher "
                    "deadline; member streams unparked", self.dispid,
                    spaceid)

    # --- position sync aggregation (DispatcherService.go:786-824) -------------

    def _handle_sync_position_yaw_from_client(self, proxy: GoWorldConnection, packet: Packet) -> None:
        """Demux one packet of concatenated 32 B records per destination
        game in ONE vectorized pass: a structured-array view over the
        payload, routing-table lookups per UNIQUE entity (not per record),
        and one boolean-mask ``tobytes`` per destination — the dispatcher's
        cost scales with packets and distinct entities, not records.
        Unknown / not-yet-routed entities drop, exactly like the legacy
        per-record loop (the parity oracle in tests/test_dispatcher.py
        pins batched == legacy on randomized streams); a trailing partial
        record is ignored. Per-game aggregation buffers flush on the 5 ms
        tick OR as soon as they exceed sync_flush_bytes, so a burst never
        sits out a full tick."""
        t0 = time.perf_counter()
        data = packet.payload
        k = len(data) // SYNC_RECORD_SIZE
        if not k:
            return
        self._sync_records_up.inc(k)
        entities = self.entities
        pending = self._pending_syncs
        now = self._now()
        if k == 1:
            info = entities.get(data[:16].decode("ascii"))
            if info is not None and info.gameid:
                if info.blocked(now):
                    # Migrate window: the route points at the game the
                    # entity is LEAVING. Park the record with the entity's
                    # pending queue; _flush_entity_pending delivers it to
                    # wherever REAL_MIGRATE (or a bounce) lands it — no
                    # record is ever delivered to a stale game.
                    info.push_pending(
                        MsgType.SYNC_POSITION_YAW_FROM_CLIENT,
                        Packet(data[:SYNC_RECORD_SIZE]))
                else:
                    buf = pending.setdefault(info.gameid, bytearray())
                    buf += data[:SYNC_RECORD_SIZE]
                    if self.sync_flush_bytes and len(buf) >= self.sync_flush_bytes:
                        self._flush_pending_sync(info.gameid)
            _HOP_ROUTE.inc(time.perf_counter() - t0)
            return
        arr = np.frombuffer(data, SYNC_DTYPE, count=k)
        uniq, inv = np.unique(arr["eid"], return_inverse=True)
        lut = np.empty(len(uniq), np.int32)
        blocked: list[tuple[int, _EntityDispatchInfo]] = []
        for j, eb in enumerate(uniq.tolist()):
            info = entities.get(eb.decode("ascii"))
            if info is None:
                lut[j] = 0
            elif info.gameid and info.blocked(now):
                # Steady state never takes this branch (blocked() is one
                # float compare per UNIQUE entity); records for migrating
                # entities divert to the per-entity pending queue below.
                lut[j] = 0
                blocked.append((j, info))
            else:
                lut[j] = info.gameid
        gameids = lut[inv]
        for gid in np.unique(lut).tolist():
            if gid == 0:
                continue  # unknown/unrouted entities drop (legacy semantics)
            buf = pending.setdefault(gid, bytearray())
            buf += arr[gameids == gid].tobytes()
            if self.sync_flush_bytes and len(buf) >= self.sync_flush_bytes:
                self._flush_pending_sync(gid)
        for j, info in blocked:
            info.push_pending(
                MsgType.SYNC_POSITION_YAW_FROM_CLIENT,
                Packet(arr[inv == j].tobytes()))
        _HOP_ROUTE.inc(time.perf_counter() - t0)

    def _flush_pending_sync(self, gameid: int) -> None:
        """Size-triggered early flush of one game's aggregation buffer."""
        buf = self._pending_syncs.pop(gameid, None)
        if buf:
            self._game(gameid).dispatch(
                MsgType.SYNC_POSITION_YAW_FROM_CLIENT, Packet(bytes(buf)),
                self._now())

    def _send_pending_syncs(self) -> None:
        if not self._pending_syncs:
            return
        now = self._now()
        for gameid, buf in self._pending_syncs.items():
            self._game(gameid).dispatch(
                MsgType.SYNC_POSITION_YAW_FROM_CLIENT, Packet(bytes(buf)), now
            )
        self._pending_syncs.clear()

    # --- kvreg (DispatcherService.go:734-748) ---------------------------------

    def _handle_kvreg_register(self, proxy: GoWorldConnection, packet: Packet) -> None:
        key = packet.read_varstr()
        value = packet.read_varstr()
        force = packet.read_bool()
        packet.set_read_pos(0)
        if value == "":
            # Deletion convention (planner failover): a forced
            # empty value POPS the key — the game-side reconcile must see
            # the shard as unclaimed, not as owned by "". Replicated so
            # every game's map drops it too.
            if force and key in self.kvreg:
                del self.kvreg[key]
                self._broadcast_games(MsgType.KVREG_REGISTER, packet)
            return
        if not force and key in self.kvreg:
            return  # first registration wins unless forced
        self.kvreg[key] = value
        self._broadcast_games(MsgType.KVREG_REGISTER, packet)

    # --- load balance / freeze ------------------------------------------------

    def _handle_heartbeat(self, proxy: GoWorldConnection, packet: Packet) -> None:
        """Liveness only: the recv task already refreshed last-seen."""

    def _handle_game_lbc_info(self, proxy: GoWorldConnection, packet: Packet) -> None:
        cpu = packet.read_float32()
        gameid = self._gameid_of(proxy)
        if gameid:
            self._lbc.update(gameid, cpu)

    def _handle_game_load_report(self, proxy: GoWorldConnection, packet: Packet) -> None:
        """Rich load report (rebalance/report.py schema): feeds the LBC
        choose-game heap (cpu, as GAME_LBC_INFO did), the planner's
        report table, and the game_load_score gauge."""
        from goworld_tpu_torch import rebalance
        from goworld_tpu_torch.rebalance.report import coerce_report, load_score

        # coerce_report validates shape + numeric fields (ValueError on
        # anything malformed — the wire-parser contract).
        report = coerce_report(packet.read_data())
        gameid = self._gameid_of(proxy)
        if not gameid:
            return
        self._lbc.update(gameid, float(report.get("cpu", 0.0)))
        self.planner.on_report(gameid, report, self._now())
        rebalance.LOAD_SCORE.labels(str(gameid)).set(load_score(report))

    def _handle_start_freeze_game(self, proxy: GoWorldConnection, packet: Packet) -> None:
        """Buffer the game's packets for the freeze window then ack
        (DispatcherService.go:478-494).

        FENCE CONTRACT (relied on by the game's freeze path): the ack is
        written to the SAME stream as every packet this dispatcher has
        forwarded to the game, strictly AFTER the block is installed, in
        the single logic task — game-bound sends here are synchronous
        transport writes, so there is no side queue the ack could
        overtake. Receiving this ack therefore proves all of this
        dispatcher's pre-block packets have been delivered."""
        gameid = self._gameid_of(proxy)
        if not gameid:
            return
        gi = self._game(gameid)
        gi.block_until = self._now() + consts.DISPATCHER_FREEZE_GAME_TIMEOUT
        proxy.send_start_freeze_game_ack()

    # --- disconnects ----------------------------------------------------------

    def _handle_disconnect(self, proxy: GoWorldConnection) -> None:
        gameid = self._proxy_games.pop(proxy, 0)
        if gameid:
            gi = self.games[gameid]
            if gi.proxy is not proxy:
                return  # stale disconnect: the game already reconnected
            gi.proxy = None
            self._untrack_peer_gauge(f"game{gameid}")
            if gi.blocked(self._now()):
                gwlog.infof("dispatcher %d: game %d down while frozen; buffering", self.dispid, gameid)
                return
            # Unplanned disconnect: a link blip, not necessarily a death.
            # Buffer like the freeze window (shorter) instead of instantly
            # wiping routes — the reconnect handshake flushes; the sweep
            # declares the game dead when the window lapses. (Deviation:
            # the reference declares game-down immediately,
            # DispatcherService.go:592-640.)
            gi.block_until = (
                self._now() + consts.DISPATCHER_RECONNECT_BUFFER_WINDOW)
            gwlog.warnf(
                "dispatcher %d: game %d link lost; buffering %.0fs for a "
                "reconnect", self.dispid, gameid,
                consts.DISPATCHER_RECONNECT_BUFFER_WINDOW)
            return
        gateid = self._proxy_gates.pop(proxy, 0)
        if gateid:
            gt = self.gates.get(gateid)
            if gt is None or gt.proxy is not proxy:
                return  # stale disconnect: the gate already reconnected
            gt.proxy = None
            self._untrack_peer_gauge(f"gate{gateid}")
            # Same grace window: broadcasting NOTIFY_GATE_DISCONNECTED for
            # a blip would make every game detach the live gate's client
            # bindings. _sweep_dead_gates broadcasts when the window
            # lapses without a reconnect.
            gt.block_until = (
                self._now() + consts.DISPATCHER_RECONNECT_BUFFER_WINDOW)
            gwlog.warnf(
                "dispatcher %d: gate %d link lost; buffering %.0fs for a "
                "reconnect", self.dispid, gateid,
                consts.DISPATCHER_RECONNECT_BUFFER_WINDOW)

    def _handle_game_down(self, gameid: int) -> None:
        """Unplanned game death: drop its routing entries, tell the others
        (DispatcherService.go:592-640)."""
        from goworld_tpu_torch import rebalance

        self._lbc.remove(gameid)
        self.planner.on_game_down(gameid)
        rebalance.LOAD_SCORE.remove(str(gameid))
        dead = [eid for eid, info in self.entities.items() if info.gameid == gameid]
        for eid in dead:
            del self.entities[eid]
        p = Packet()
        p.append_uint16(gameid)
        self._broadcast_games(MsgType.NOTIFY_GAME_DISCONNECTED, p, except_game=gameid)
        self._purge_dead_game_services(gameid)
        gwlog.infof("dispatcher %d: game %d down, %d entities dropped", self.dispid, gameid, len(dead))

    def _purge_dead_game_services(self, gameid: int) -> None:
        """Release the dead game's service-shard claims (planner
        failover): pop every ``Service/…`` key it owned — and the
        ``/EntityID`` companion, or the reconcile would see a half-
        registered shard — and replicate the deletions so every surviving
        game's reconcile races to re-claim. Without this, a shard owned by
        a corpse stays claimed forever and its service (e.g. the
        RebalancePlannerService) never fails over."""
        from goworld_tpu_torch.service import SERVICE_KVREG_PREFIX

        owner = f"game{gameid}"
        owned = [
            k for k, v in self.kvreg.items()
            if v == owner and k.startswith(SERVICE_KVREG_PREFIX)
            and "/" not in k[len(SERVICE_KVREG_PREFIX):]
        ]
        for k in owned:
            for key in (k, k + "/EntityID"):
                if self.kvreg.pop(key, None) is None:
                    continue
                p = Packet()
                p.append_varstr(key)
                p.append_varstr("")
                p.append_bool(True)
                self._broadcast_games(MsgType.KVREG_REGISTER, p,
                                      except_game=gameid)
        if owned:
            gwlog.warnf(
                "dispatcher %d: purged %d service shard claims of dead "
                "game %d (%s); survivors will re-claim", self.dispid,
                len(owned), gameid, ", ".join(sorted(owned)))

    _HANDLERS = {
        MsgType.SET_GAME_ID: _handle_set_game_id,
        MsgType.SET_GATE_ID: _handle_set_gate_id,
        MsgType.NOTIFY_CREATE_ENTITY: _handle_notify_create_entity,
        MsgType.NOTIFY_DESTROY_ENTITY: _handle_notify_destroy_entity,
        MsgType.NOTIFY_CLIENT_CONNECTED: _handle_notify_client_connected,
        MsgType.NOTIFY_CLIENT_DISCONNECTED: _handle_notify_client_disconnected,
        MsgType.CALL_ENTITY_METHOD: _handle_call_entity_method,
        MsgType.CALL_ENTITY_METHOD_FROM_CLIENT: _handle_call_entity_method_from_client,
        MsgType.CALL_NIL_SPACES: _handle_call_nil_spaces,
        MsgType.CREATE_ENTITY_SOMEWHERE: _handle_create_entity_somewhere,
        MsgType.LOAD_ENTITY_SOMEWHERE: _handle_load_entity_somewhere,
        MsgType.QUERY_SPACE_GAMEID_FOR_MIGRATE: _handle_query_space_gameid_for_migrate,
        MsgType.MIGRATE_REQUEST: _handle_migrate_request,
        MsgType.REAL_MIGRATE: _handle_real_migrate,
        MsgType.CANCEL_MIGRATE: _handle_cancel_migrate,
        MsgType.SPACE_MIGRATE_PREPARE: _handle_space_migrate_prepare,
        MsgType.SPACE_MIGRATE_DATA: _handle_space_migrate_data,
        MsgType.SPACE_MIGRATE_ABORT: _handle_space_migrate_abort,
        MsgType.SPACE_MIGRATE_ACK: _handle_space_migrate_ack,
        MsgType.REBALANCE_PLAN: _handle_rebalance_plan,
        MsgType.SYNC_POSITION_YAW_FROM_CLIENT: _handle_sync_position_yaw_from_client,
        MsgType.KVREG_REGISTER: _handle_kvreg_register,
        MsgType.GAME_LBC_INFO: _handle_game_lbc_info,
        MsgType.GAME_LOAD_REPORT: _handle_game_load_report,
        MsgType.START_FREEZE_GAME: _handle_start_freeze_game,
        MsgType.HEARTBEAT: _handle_heartbeat,
    }
