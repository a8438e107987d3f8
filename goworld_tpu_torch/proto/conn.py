"""Typed message senders over a PacketConnection.

Reference parity: ``engine/proto/GoWorldConnection.go:16-497`` — one SendXxx
method per message type, so payload layouts live in exactly one place.
Position-sync records are fixed 32 B = EntityID(16) + x,y,z,yaw float32
(proto.go:135-139).
"""

from __future__ import annotations

import struct

import numpy as np

from goworld_tpu_torch.netutil.packet import Packet
from goworld_tpu_torch.netutil.packet_conn import PacketConnection
from goworld_tpu_torch.proto.msgtypes import (
    MSGTYPE_TRACE_FLAG,
    PROTO_VERSION,
    FilterOp,
    MsgType,
)
from goworld_tpu_torch.telemetry import tracing as _tracing

SYNC_RECORD_SIZE = 16 + 4 * 4  # EntityID + x,y,z,yaw (proto.go:135-139)
_SYNC = struct.Struct("<16s4f")

# Numpy views of the same wire layouts (packed — field offsets match the
# struct formats byte for byte), used by the batch pack/unpack paths: one
# C-level conversion per tick instead of one struct call per record.
SYNC_DTYPE = np.dtype(
    [("eid", "S16"), ("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
     ("yaw", "<f4")]
)
# [clientid(16) + sync record] block (game→dispatcher→gate). The record
# half is kept as one opaque 32 B field so the gate's demux can slice
# per-client record runs with a single .tobytes() per client.
CLIENT_SYNC_DTYPE = np.dtype([("cid", "S16"), ("rec", "V32")])
# The same wire block with the record half split into named fields — the
# layout the columnar sync collect fills by column assignment
# (entity/slabs.py pack_sync; pack_client_sync_columns below).
CLIENT_SYNC_BLOCK_DTYPE = np.dtype(
    [("cid", "S16"), ("eid", "S16"), ("x", "<f4"), ("y", "<f4"),
     ("z", "<f4"), ("yaw", "<f4")]
)
assert SYNC_DTYPE.itemsize == SYNC_RECORD_SIZE
assert CLIENT_SYNC_DTYPE.itemsize == 16 + SYNC_RECORD_SIZE
assert CLIENT_SYNC_BLOCK_DTYPE.itemsize == 16 + SYNC_RECORD_SIZE

# --- v6 compact sync records (adaptive per-client sync, ROADMAP item 5) ------
# Quantized position DELTAS against a per-client baseline: EntityID(16) +
# dx,dy,dz,dyaw int16, each in units of 2^-quantize_bits (the packet
# header names the step, proto/schema.py). 24 B on the client wire vs the
# full record's 32 B; the real win is the cadence tiers gating how often
# a record is emitted at all (entity/slabs.py).
DELTA_SYNC_RECORD_SIZE = 16 + 4 * 2
DELTA_SYNC_DTYPE = np.dtype(
    [("eid", "S16"), ("dx", "<i2"), ("dy", "<i2"), ("dz", "<i2"),
     ("dyaw", "<i2")]
)
# [clientid(16) + 24 B delta record] block (game→dispatcher→gate); the
# record half stays opaque so the gate demux slices per-client runs with
# one tobytes() per client, exactly like CLIENT_SYNC_DTYPE.
CLIENT_DELTA_SYNC_DTYPE = np.dtype([("cid", "S16"), ("rec", "V24")])
# The same block with named fields — the layout the tiered columnar
# collect fills by column assignment (entity/slabs.py).
CLIENT_DELTA_SYNC_BLOCK_DTYPE = np.dtype(
    [("cid", "S16"), ("eid", "S16"), ("dx", "<i2"), ("dy", "<i2"),
     ("dz", "<i2"), ("dyaw", "<i2")]
)
assert DELTA_SYNC_DTYPE.itemsize == DELTA_SYNC_RECORD_SIZE
assert CLIENT_DELTA_SYNC_DTYPE.itemsize == 16 + DELTA_SYNC_RECORD_SIZE
assert CLIENT_DELTA_SYNC_BLOCK_DTYPE.itemsize == 16 + DELTA_SYNC_RECORD_SIZE

# Process-wide wire volume (telemetry): counted HERE because every peer
# connection of every process — dispatcher↔game/gate streams AND gate
# client conns over TCP/WS/KCP — goes through GoWorldConnection, so one
# seam covers all transports. Direction-labeled totals rather than
# per-connection series: connections churn (one label set per client
# would grow the registry unboundedly); per-service breakdowns come from
# the queue/client gauges beside them. Children are pre-resolved so the
# per-packet hot path is a single Counter.inc.
from goworld_tpu_torch import telemetry as _telemetry

_PKT = _telemetry.counter(
    "net_packets_total",
    "Framed packets through GoWorldConnection (all transports).",
    ("direction",))
_BYTES = _telemetry.counter(
    "net_bytes_total",
    "Framed payload bytes through GoWorldConnection (pre-compression).",
    ("direction",))
_PKT_IN, _PKT_OUT = _PKT.labels("in"), _PKT.labels("out")
_BYTES_IN, _BYTES_OUT = _BYTES.labels("in"), _BYTES.labels("out")


def pack_sync_record(eid: str, x: float, y: float, z: float, yaw: float) -> bytes:
    return _SYNC.pack(eid.encode("ascii"), x, y, z, yaw)


def unpack_sync_records(data: bytes) -> list[tuple[str, float, float, float, float]]:
    """Decode concatenated 32 B sync records — one vectorized frombuffer
    instead of a struct.unpack per record (same tuples, same float32
    rounding). A trailing partial record is ignored, as the struct loop
    before it would have raised only on a *fully* malformed tail."""
    k = len(data) // SYNC_RECORD_SIZE
    if not k:
        return []
    arr = np.frombuffer(data, SYNC_DTYPE, count=k)
    return list(
        zip(
            [e.decode("ascii") for e in arr["eid"].tolist()],
            arr["x"].tolist(),
            arr["y"].tolist(),
            arr["z"].tolist(),
            arr["yaw"].tolist(),
        )
    )


def pack_client_sync_blocks(
    rows: list[tuple[str, str, float, float, float, float]]
) -> bytes:
    """Batch-pack [clientid(16) + 32 B sync record] blocks from
    (clientid, eid, x, y, z, yaw) rows — ONE structured-array conversion
    per gate per tick (the game's sync fan-out hot path) instead of a
    struct.pack + bytearray append per record."""
    if not rows:
        return b""
    return np.array(rows, dtype=CLIENT_SYNC_BLOCK_DTYPE).tobytes()


def pack_client_delta_sync_blocks(
    rows: list[tuple[str, str, int, int, int, int]]
) -> bytes:
    """Batch-pack [clientid(16) + 24 B delta record] blocks from
    (clientid, eid, dx, dy, dz, dyaw) rows of pre-quantized int16 deltas
    (tests + the schema fuzz seed; the hot path fills
    CLIENT_DELTA_SYNC_BLOCK_DTYPE by column assignment in slabs.py)."""
    if not rows:
        return b""
    return np.array(rows, dtype=CLIENT_DELTA_SYNC_BLOCK_DTYPE).tobytes()


def pack_client_sync_columns(cid: np.ndarray, eid: np.ndarray,
                             x: np.ndarray, y: np.ndarray,
                             z: np.ndarray, yaw: np.ndarray) -> bytes:
    """Columnar variant of :func:`pack_client_sync_blocks`: fill the wire
    blocks by column assignment from parallel arrays (the slab store's
    collect path builds its per-gate buffers this way — zero Python row
    tuples; this helper is the standalone seam for tests and tools)."""
    out = np.empty(len(cid), CLIENT_SYNC_BLOCK_DTYPE)
    out["cid"] = cid
    out["eid"] = eid
    out["x"] = x
    out["y"] = y
    out["z"] = z
    out["yaw"] = yaw
    return out.tobytes()


class GoWorldConnection:
    """Wraps a PacketConnection with typed senders.

    ``trace_wire=True`` (cluster links only: game/gate↔dispatcher, both
    directions) piggybacks the active sampled TraceContext as a 17-byte
    packet trailer flagged by MSGTYPE_TRACE_FLAG — absent for unsampled
    packets, so the untraced fast path pays exactly one branch per send
    and the wire stays byte-identical to v3 framing. The recv seam strips
    the trailer on ANY connection (ignored-compatible), attaching the
    context to ``packet.trace``. Gate↔client links keep trace_wire off:
    the client protocol is unchanged and traces terminate at the gate's
    fan-out span.
    """

    def __init__(self, conn: PacketConnection, *,
                 trace_wire: bool = False) -> None:
        self.conn = conn
        self.trace_wire = trace_wire

    # --- generic -----------------------------------------------------------

    def _trace_ctx(
        self, packet_trace: "_tracing.TraceContext | None"
    ) -> "_tracing.TraceContext | None":
        """The context to piggyback: the active span's, else the one the
        packet itself arrived with (dispatcher buffered/replayed forwards
        outside any handling scope must not lose the trace)."""
        ctx = _tracing.current()
        return ctx if ctx is not None else packet_trace

    def send(self, msgtype: int, packet: Packet) -> None:
        _PKT_OUT.inc()
        _BYTES_OUT.inc(packet.payload_len())
        if self.trace_wire:
            ctx = self._trace_ctx(packet.trace)
            if ctx is not None:
                # Copy-on-trace: broadcasts reuse one Packet across links,
                # so the original payload must stay trailer-free.
                self.conn.send_packet(
                    msgtype | MSGTYPE_TRACE_FLAG,
                    Packet(packet.payload + _tracing.encode_trailer(ctx)))
                return
        self.conn.send_packet(msgtype, packet)

    def send_packet_raw(self, msgtype: int, payload: bytes) -> None:
        _PKT_OUT.inc()
        _BYTES_OUT.inc(len(payload))
        if self.trace_wire:
            ctx = self._trace_ctx(None)
            if ctx is not None:
                self.conn.send_packet(
                    msgtype | MSGTYPE_TRACE_FLAG,
                    Packet(payload + _tracing.encode_trailer(ctx)))
                return
        self.conn.send_packet(msgtype, Packet(payload))

    async def recv(self) -> tuple[int, Packet]:
        msgtype, packet = await self.conn.recv_packet()
        _PKT_IN.inc()
        _BYTES_IN.inc(packet.payload_len())
        if msgtype & MSGTYPE_TRACE_FLAG:
            msgtype &= ~MSGTYPE_TRACE_FLAG
            if packet.payload_len() >= _tracing.TRAILER_SIZE:
                packet.trace = _tracing.decode_trailer(
                    packet.pop_tail(_tracing.TRAILER_SIZE))
        return msgtype, packet

    def flush(self) -> None:
        self.conn.flush()

    def cork(self) -> None:
        """Tick-scoped write coalescing, where the transport supports it
        (TCP PacketConnection). KCP coalesces in stream mode and WS has a
        dedicated writer task, so for those this is a no-op."""
        fn = getattr(self.conn, "cork", None)
        if fn is not None:
            fn()

    def uncork(self) -> None:
        fn = getattr(self.conn, "uncork", None)
        if fn is not None:
            fn()

    def close(self) -> None:
        self.conn.close()

    @property
    def closed(self) -> bool:
        return self.conn.closed

    # --- handshakes --------------------------------------------------------

    def send_set_game_id(
        self,
        gameid: int,
        is_reconnect: bool,
        is_restore: bool,
        is_ban_boot_entity: bool,
        entity_ids: list[str],
    ) -> None:
        """Game→dispatcher handshake (DispatcherConnMgr.go:66-88); carries the
        game's live entity list for reconnect reconciliation
        (DispatcherService.go:327-402)."""
        p = Packet()
        p.append_uint16(gameid)
        p.append_bool(is_reconnect)
        p.append_bool(is_restore)
        p.append_bool(is_ban_boot_entity)
        p.append_data(entity_ids)
        p.append_uint32(PROTO_VERSION)
        self.send(MsgType.SET_GAME_ID, p)

    def send_set_game_id_ack(
        self,
        online_games: list[int],
        rejected_entity_ids: list[str],
        kvreg_map: dict[str, str],
        deployment_ready: bool,
    ) -> None:
        p = Packet()
        p.append_data(
            {
                "online_games": online_games,
                "rejected": rejected_entity_ids,
                "kvreg": kvreg_map,
                "ready": deployment_ready,
            }
        )
        self.send(MsgType.SET_GAME_ID_ACK, p)

    def send_set_gate_id(self, gateid: int, fresh: bool = False,
                         gen: int = 0) -> None:
        """``fresh`` = this is a brand-new gate process introducing itself
        (not a surviving gate re-dialing after a link blip): the dispatcher
        then detaches the dead predecessor's client bindings on every game
        before registering the new proxy (stale GameClient bindings would
        otherwise route syncs/RPCs at clientids no socket serves).
        ``gen`` = the gate process's boot generation; the detach broadcast
        names it as the VALID generation so a late-arriving broadcast can
        never detach clients that connected through the new process."""
        p = Packet()
        p.append_uint16(gateid)
        p.append_bool(fresh)
        p.append_uint32(gen)
        p.append_uint32(PROTO_VERSION)
        self.send(MsgType.SET_GATE_ID, p)

    # --- entity lifecycle notifications ------------------------------------

    def send_notify_create_entity(self, eid: str) -> None:
        p = Packet()
        p.append_entity_id(eid)
        self.send(MsgType.NOTIFY_CREATE_ENTITY, p)

    def send_notify_destroy_entity(self, eid: str) -> None:
        p = Packet()
        p.append_entity_id(eid)
        self.send(MsgType.NOTIFY_DESTROY_ENTITY, p)

    # --- client lifecycle --------------------------------------------------

    def send_notify_client_connected(self, clientid: str, gateid: int,
                                     boot_eid: str, gate_gen: int = 0) -> None:
        p = Packet()
        p.append_client_id(clientid)
        p.append_uint16(gateid)
        p.append_entity_id(boot_eid)
        # Gate boot generation LAST (the dispatcher's boot-eid peek reads
        # the prefix positionally): pairs with NOTIFY_GATE_DISCONNECTED's
        # valid-generation field (GameClient.gate_gen).
        p.append_uint32(gate_gen)
        self.send(MsgType.NOTIFY_CLIENT_CONNECTED, p)

    def send_notify_client_disconnected(self, clientid: str, owner_eid: str) -> None:
        p = Packet()
        p.append_client_id(clientid)
        p.append_entity_id(owner_eid)
        self.send(MsgType.NOTIFY_CLIENT_DISCONNECTED, p)

    # --- RPC ---------------------------------------------------------------

    def send_call_entity_method(self, eid: str, method: str, args: tuple) -> None:
        p = Packet()
        p.append_entity_id(eid)
        p.append_varstr(method)
        p.append_args(args)
        self.send(MsgType.CALL_ENTITY_METHOD, p)

    def send_call_entity_method_from_client(
        self, eid: str, method: str, args: tuple, clientid: str
    ) -> None:
        p = Packet()
        p.append_entity_id(eid)
        p.append_varstr(method)
        p.append_args(args)
        p.append_client_id(clientid)
        self.send(MsgType.CALL_ENTITY_METHOD_FROM_CLIENT, p)

    def send_call_nil_spaces(self, except_game: int, method: str, args: tuple) -> None:
        p = Packet()
        p.append_uint16(except_game)
        p.append_varstr(method)
        p.append_args(args)
        self.send(MsgType.CALL_NIL_SPACES, p)

    # --- create/load somewhere ---------------------------------------------

    def send_create_entity_somewhere(self, gameid: int, typename: str, eid: str, attrs: dict) -> None:
        """gameid 0 = dispatcher picks the least-loaded game
        (DispatcherService.go:529-542)."""
        p = Packet()
        p.append_uint16(gameid)
        p.append_varstr(typename)
        p.append_entity_id(eid)
        p.append_data(attrs)
        self.send(MsgType.CREATE_ENTITY_SOMEWHERE, p)

    def send_load_entity_somewhere(self, typename: str, eid: str, gameid: int) -> None:
        p = Packet()
        p.append_uint16(gameid)
        p.append_varstr(typename)
        p.append_entity_id(eid)
        self.send(MsgType.LOAD_ENTITY_SOMEWHERE, p)

    # --- migration (Entity.go:956-1115, DispatcherService.go:850-907) ------

    # The migration query/request acks carry a per-request NONCE, echoed
    # verbatim by the dispatcher: ack validity must bind to the exact
    # request instance, not just the space id — a stale buffered ack for a
    # canceled request must never satisfy a newer same-space request (its
    # dispatcher block was released by the cancel).

    def send_query_space_gameid_for_migrate(
        self, spaceid: str, eid: str, nonce: int = 0
    ) -> None:
        p = Packet()
        p.append_entity_id(spaceid)
        p.append_entity_id(eid)
        p.append_uint32(nonce)
        self.send(MsgType.QUERY_SPACE_GAMEID_FOR_MIGRATE, p)

    def send_query_space_gameid_for_migrate_ack(
        self, spaceid: str, eid: str, gameid: int, nonce: int = 0
    ) -> None:
        p = Packet()
        p.append_entity_id(spaceid)
        p.append_entity_id(eid)
        p.append_uint16(gameid)
        p.append_uint32(nonce)
        self.send(MsgType.QUERY_SPACE_GAMEID_FOR_MIGRATE_ACK, p)

    def send_migrate_request(
        self, eid: str, spaceid: str, space_gameid: int, nonce: int = 0
    ) -> None:
        p = Packet()
        p.append_entity_id(eid)
        p.append_entity_id(spaceid)
        p.append_uint16(space_gameid)
        p.append_uint32(nonce)
        self.send(MsgType.MIGRATE_REQUEST, p)

    def send_migrate_request_ack(
        self, eid: str, spaceid: str, space_gameid: int, nonce: int = 0
    ) -> None:
        p = Packet()
        p.append_entity_id(eid)
        p.append_entity_id(spaceid)
        p.append_uint16(space_gameid)
        p.append_uint32(nonce)
        self.send(MsgType.MIGRATE_REQUEST_ACK, p)

    def send_real_migrate(self, eid: str, target_game: int,
                          migrate_data: dict, source_game: int = 0) -> None:
        """``source_game`` rides as a TRAILING u16 so the dispatcher can
        bounce the payload home without parsing the bson body — the
        packet is the entity's only copy, and when the target game turns
        out dead the sender's identity may no longer be derivable from
        the connection (a sweep-time bounce happens long after the
        forwarding proxy is gone)."""
        p = Packet()
        p.append_entity_id(eid)
        p.append_uint16(target_game)
        p.append_data(migrate_data)
        p.append_uint16(source_game)
        self.send(MsgType.REAL_MIGRATE, p)

    def send_cancel_migrate(self, eid: str) -> None:
        p = Packet()
        p.append_entity_id(eid)
        self.send(MsgType.CANCEL_MIGRATE, p)

    # --- position sync -----------------------------------------------------

    def send_sync_position_yaw_from_client(self, records: bytes) -> None:
        """records = concatenated 32 B sync records (gate→dispatcher,
        GateService.go:398-425)."""
        self.send_packet_raw(MsgType.SYNC_POSITION_YAW_FROM_CLIENT, records)

    def send_sync_position_yaw_on_clients(self, gateid: int, records: bytes) -> None:
        """records = concatenated [clientid(16) + 32 B sync record] blocks
        (game→dispatcher→gate, Entity.go:1221-1267). Built as one bytes
        payload so the Packet rides the zero-copy constructor (the sync
        fan-out's largest per-tick buffer pays exactly one copy here)."""
        self.send(MsgType.SYNC_POSITION_YAW_ON_CLIENTS,
                  Packet(struct.pack("<H", gateid) + records))

    def send_sync_position_yaw_delta_on_clients(
        self, gateid: int, quantize_bits: int, records: bytes
    ) -> None:
        """records = concatenated [clientid(16) + 24 B delta record]
        blocks (the v6 compact sync variant). ``quantize_bits`` rides the
        payload so the gate/client decode is self-describing: deltas are
        int16 multiples of 2^-quantize_bits world units."""
        self.send(MsgType.SYNC_POSITION_YAW_DELTA_ON_CLIENTS,
                  Packet(struct.pack("<HB", gateid, quantize_bits) + records))

    # --- process / deployment events ---------------------------------------

    def send_notify_game_connected(self, gameid: int) -> None:
        p = Packet()
        p.append_uint16(gameid)
        self.send(MsgType.NOTIFY_GAME_CONNECTED, p)

    def send_notify_game_disconnected(self, gameid: int) -> None:
        p = Packet()
        p.append_uint16(gameid)
        self.send(MsgType.NOTIFY_GAME_DISCONNECTED, p)

    def send_notify_gate_disconnected(self, gateid: int,
                                      valid_gen: int = 0) -> None:
        """``valid_gen`` != 0 narrows the detach to clients of OTHER gate
        generations (the gate process restarted: its old clients are dead
        but its new ones — which carry valid_gen — are live). 0 = the
        gate is gone entirely; detach every client of that gateid."""
        p = Packet()
        p.append_uint16(gateid)
        p.append_uint32(valid_gen)
        self.send(MsgType.NOTIFY_GATE_DISCONNECTED, p)

    def send_notify_deployment_ready(self) -> None:
        self.send(MsgType.NOTIFY_DEPLOYMENT_READY, Packet())

    def send_cluster_heartbeat(self) -> None:
        """Cluster-link liveness probe (game/gate↔dispatcher, both
        directions); consumed at the recv seam, never routed."""
        self.send(MsgType.HEARTBEAT, Packet())

    def send_start_freeze_game(self) -> None:
        self.send(MsgType.START_FREEZE_GAME, Packet())

    def send_start_freeze_game_ack(self) -> None:
        self.send(MsgType.START_FREEZE_GAME_ACK, Packet())

    def send_kvreg_register(self, key: str, value: str, force: bool) -> None:
        p = Packet()
        p.append_varstr(key)
        p.append_varstr(value)
        p.append_bool(force)
        self.send(MsgType.KVREG_REGISTER, p)

    def send_game_lbc_info(self, cpu_percent: float) -> None:
        p = Packet()
        p.append_float32(cpu_percent)
        self.send(MsgType.GAME_LBC_INFO, p)

    def send_game_load_report(self, report: dict) -> None:
        """Rich per-game load report (rebalance/report.py schema): cpu%,
        entities, tick p95, queue depth, per-space populations. Feeds the
        LBC heap AND the dispatcher-side rebalancer."""
        p = Packet()
        p.append_data(report)
        self.send(MsgType.GAME_LOAD_REPORT, p)

    def send_rebalance_migrate(
        self, from_space: str, to_space: str, to_game: int, count: int
    ) -> None:
        """Dispatcher→game rebalance command: the receiving (donor) game
        selects up to ``count`` movable entities in ``from_space`` and
        drives each through the hardened migrate path into ``to_space``
        on ``to_game`` (rebalance/migrator.py)."""
        p = Packet()
        p.append_entity_id(from_space)
        p.append_entity_id(to_space)
        p.append_uint16(to_game)
        p.append_uint16(count)
        self.send(MsgType.REBALANCE_MIGRATE, p)

    # --- whole-space migration (v7) ------------------------------

    def send_space_migrate_prepare(
        self, spaceid: str, to_game: int, member_eids: list
    ) -> None:
        """Donor game → EVERY dispatcher: the space froze; park the
        LISTED member streams you own, then ack on this same link so the
        ack fences all traffic you forwarded before parking.  The list
        is the freeze-time membership — a member that already migrated
        out must NOT be parked (modelcheck space_member_race)."""
        p = Packet()
        p.append_entity_id(spaceid)
        p.append_uint16(to_game)
        p.append_data(member_eids)
        self.send(MsgType.SPACE_MIGRATE_PREPARE, p)

    def send_space_migrate_prepare_ack(
        self, spaceid: str, dispatcherid: int
    ) -> None:
        p = Packet()
        p.append_entity_id(spaceid)
        p.append_uint16(dispatcherid)
        self.send(MsgType.SPACE_MIGRATE_PREPARE_ACK, p)

    def send_space_migrate_data(
        self, spaceid: str, target_game: int, space_data: dict,
        source_game: int = 0
    ) -> None:
        """The whole-space snapshot (space + members + queued joins),
        routed by the space-owner dispatcher exactly like REAL_MIGRATE.
        ``source_game`` rides as a TRAILING u16 for the same reason as
        REAL_MIGRATE's: a sweep-time bounce-home happens long after the
        forwarding proxy is gone, and the packet is the space's only
        copy."""
        p = Packet()
        p.append_entity_id(spaceid)
        p.append_uint16(target_game)
        p.append_data(space_data)
        p.append_uint16(source_game)
        self.send(MsgType.SPACE_MIGRATE_DATA, p)

    def send_space_migrate_abort(self, spaceid: str, reason: str) -> None:
        """Either direction: dispatcher→donor (target dead at PREPARE
        time) or donor→dispatchers (deadline fired — unpark the members;
        the donor has already unfrozen in place)."""
        p = Packet()
        p.append_entity_id(spaceid)
        p.append_varstr(reason)
        self.send(MsgType.SPACE_MIGRATE_ABORT, p)

    def send_space_migrate_ack(self, spaceid: str, gameid: int) -> None:
        """Receiver game → space-owner dispatcher: restore completed
        (closes the dispatcher's handoff telemetry entry; member
        routing rides each NOTIFY_CREATE_ENTITY, not this ack)."""
        p = Packet()
        p.append_entity_id(spaceid)
        p.append_uint16(gameid)
        self.send(MsgType.SPACE_MIGRATE_ACK, p)

    def send_rebalance_migrate_space(
        self, spaceid: str, to_game: int
    ) -> None:
        """Dispatcher→game: move the WHOLE space (members, slab columns,
        interest edges) to ``to_game`` via the two-phase handoff
        (rebalance/migrator.py space states)."""
        p = Packet()
        p.append_entity_id(spaceid)
        p.append_uint16(to_game)
        self.send(MsgType.REBALANCE_MIGRATE_SPACE, p)

    def send_rebalance_plan(self, plan: dict) -> None:
        """Planner-service game → its owner dispatcher: a rebalance plan
        computed on the service plane (planner failover); the
        dispatcher validates liveness and dispatches the commands."""
        p = Packet()
        p.append_data(plan)
        self.send(MsgType.REBALANCE_PLAN, p)

    # --- redirect range: game → client via gate ----------------------------
    # Payloads start with [u16 gateid][clientid]; the dispatcher routes on the
    # gateid (DispatcherService.go:841-844) and the gate strips the prefix
    # before forwarding to the client (GateService.go:262-293).

    def _client_packet(self, gateid: int, clientid: str) -> Packet:
        p = Packet()
        p.append_uint16(gateid)
        p.append_client_id(clientid)
        return p

    def send_create_entity_on_client(
        self,
        gateid: int,
        clientid: str,
        is_player: bool,
        eid: str,
        typename: str,
        client_attrs: dict,
        x: float,
        y: float,
        z: float,
        yaw: float,
    ) -> None:
        p = self._client_packet(gateid, clientid)
        p.append_bool(is_player)
        p.append_entity_id(eid)
        p.append_varstr(typename)
        p.append_data(client_attrs)
        p.append_float32(x).append_float32(y).append_float32(z).append_float32(yaw)
        self.send(MsgType.CREATE_ENTITY_ON_CLIENT, p)

    def send_destroy_entity_on_client(
        self, gateid: int, clientid: str, typename: str, eid: str
    ) -> None:
        p = self._client_packet(gateid, clientid)
        p.append_varstr(typename)
        p.append_entity_id(eid)
        self.send(MsgType.DESTROY_ENTITY_ON_CLIENT, p)

    def send_notify_map_attr_change_on_client(
        self, gateid: int, clientid: str, eid: str, path: list, key: str,
        val: object,
    ) -> None:
        p = self._client_packet(gateid, clientid)
        p.append_entity_id(eid)
        p.append_data(path)
        p.append_varstr(key)
        p.append_data(val)
        self.send(MsgType.NOTIFY_MAP_ATTR_CHANGE_ON_CLIENT, p)

    def send_notify_map_attr_del_on_client(
        self, gateid: int, clientid: str, eid: str, path: list, key: str
    ) -> None:
        p = self._client_packet(gateid, clientid)
        p.append_entity_id(eid)
        p.append_data(path)
        p.append_varstr(key)
        self.send(MsgType.NOTIFY_MAP_ATTR_DEL_ON_CLIENT, p)

    def send_notify_map_attr_clear_on_client(
        self, gateid: int, clientid: str, eid: str, path: list
    ) -> None:
        p = self._client_packet(gateid, clientid)
        p.append_entity_id(eid)
        p.append_data(path)
        self.send(MsgType.NOTIFY_MAP_ATTR_CLEAR_ON_CLIENT, p)

    def send_notify_list_attr_change_on_client(
        self, gateid: int, clientid: str, eid: str, path: list, index: int,
        val: object,
    ) -> None:
        p = self._client_packet(gateid, clientid)
        p.append_entity_id(eid)
        p.append_data(path)
        p.append_uint32(index)
        p.append_data(val)
        self.send(MsgType.NOTIFY_LIST_ATTR_CHANGE_ON_CLIENT, p)

    def send_notify_list_attr_pop_on_client(
        self, gateid: int, clientid: str, eid: str, path: list
    ) -> None:
        p = self._client_packet(gateid, clientid)
        p.append_entity_id(eid)
        p.append_data(path)
        self.send(MsgType.NOTIFY_LIST_ATTR_POP_ON_CLIENT, p)

    def send_notify_list_attr_append_on_client(
        self, gateid: int, clientid: str, eid: str, path: list, val: object
    ) -> None:
        p = self._client_packet(gateid, clientid)
        p.append_entity_id(eid)
        p.append_data(path)
        p.append_data(val)
        self.send(MsgType.NOTIFY_LIST_ATTR_APPEND_ON_CLIENT, p)

    def send_call_entity_method_on_client(
        self, gateid: int, clientid: str, eid: str, method: str, args: tuple
    ) -> None:
        p = self._client_packet(gateid, clientid)
        p.append_entity_id(eid)
        p.append_varstr(method)
        p.append_args(args)
        self.send(MsgType.CALL_ENTITY_METHOD_ON_CLIENT, p)

    def send_set_clientproxy_filter_prop(
        self, gateid: int, clientid: str, key: str, val: str
    ) -> None:
        p = self._client_packet(gateid, clientid)
        p.append_varstr(key)
        p.append_varstr(val)
        self.send(MsgType.SET_CLIENTPROXY_FILTER_PROP, p)

    def send_clear_clientproxy_filter_props(self, gateid: int, clientid: str) -> None:
        p = self._client_packet(gateid, clientid)
        self.send(MsgType.CLEAR_CLIENTPROXY_FILTER_PROPS, p)

    # --- gate-handled broadcast --------------------------------------------

    def send_call_filtered_client_proxies(
        self, op: FilterOp, key: str, val: str, method: str, args: tuple
    ) -> None:
        """Broadcast an RPC to every client whose filter prop ``key`` compares
        to ``val`` under ``op`` (gate FilterTree, GateService.go / FilterTree.go)."""
        p = Packet()
        p.append_byte(int(op))
        p.append_varstr(key)
        p.append_varstr(val)
        p.append_varstr(method)
        p.append_args(args)
        self.send(MsgType.CALL_FILTERED_CLIENTS, p)

    # --- client → gate -----------------------------------------------------

    def send_heartbeat(self) -> None:
        self.send(MsgType.HEARTBEAT_FROM_CLIENT, Packet())
