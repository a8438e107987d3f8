"""Message type space.

Reference parity: ``engine/proto/proto.go:19-151``. The numeric ranges are
semantic routing classes (the dispatcher routes by range, not by individual
type — DispatcherService.go:214-285):

- 1..999:      handled by the dispatcher itself
- 1001..1499:  "redirect" range — game→dispatcher→gate→client; payload starts
               with [u16 gateid][clientid] which the gate strips
- 1501..1999:  handled by the gate (broadcast/filtered operations)
- 2001..:      gate↔client only
"""

from __future__ import annotations

import enum

# Cluster wire-protocol version, carried in the SET_GAME_ID / SET_GATE_ID
# handshakes and verified by the dispatcher. Bump on ANY payload layout
# change (e.g. the migrate-nonce addition) so a mixed-version
# dispatcher/game pair — mid rolling upgrade, or a dispatcher not restarted
# during `reload` — fails loudly at connect instead of mis-framing packets.
#
# The AUTHORITATIVE payload layouts live in proto/schema.py (one field
# sequence per MsgType), checked against every pack/unpack site by gwlint
# R7 — which also pins a digest of the whole table per version
# (SCHEMA_HISTORY), so forgetting this bump on a layout change fails the
# lint instead of a production rollout.  The per-version notes below stay
# as the human changelog of WHY each bump happened.
# v3: cluster-link HEARTBEAT + liveness kills — a v2 peer would neither
# send heartbeats nor expect them, so a v3 end would kill its (healthy)
# idle links; fail the mixed pair at the handshake instead.
# v4: optional distributed-tracing trailer on cluster packets — a SAMPLED
# packet sets MSGTYPE_TRACE_FLAG (bit 15 of the u16 msgtype, far above
# every type id) and appends a 17-byte TraceContext after the payload,
# stripped at the recv seam (telemetry/tracing.py). Unsampled packets and
# HEARTBEAT are byte-identical to v3, but a v3 peer would route a flagged
# msgtype to "unhandled" and mis-read the trailer as payload bytes — fail
# the mixed pair at the handshake instead.
# v5: rebalancing + crash hygiene — SET_GATE_ID gains a ``fresh`` bool
# BEFORE the version field (a restarted gate process announces itself so
# the dispatcher can detach its dead predecessor's client bindings — a v4
# dispatcher would mis-read the bool as the version's first byte), plus
# the new GAME_LOAD_REPORT / REBALANCE_MIGRATE types a v4 peer would drop
# as unhandled.
# v6: adaptive per-client sync — the new SYNC_POSITION_YAW_DELTA_ON_CLIENTS
# type carries quantized position DELTAS against per-client baselines
# ([u16 gateid][u8 quantize_bits] + fixed 40 B [cid + delta record]
# blocks, proto/conn.py CLIENT_DELTA_SYNC_DTYPE). A v5 gate would drop
# the type as unhandled and its clients would silently stop seeing
# tiered neighbors move — fail the mixed pair at the handshake instead.
# v7: whole-space migration + crash-survivable rebalance plane — the new
# SPACE_MIGRATE_PREPARE / PREPARE_ACK / DATA / ABORT / ACK handoff types,
# REBALANCE_MIGRATE_SPACE commands, and the planner-service REBALANCE_PLAN
# push. A v6 peer would drop every one as unhandled, silently wedging a
# space handoff mid-PREPARE (members parked until the deadline on every
# round) — fail the mixed pair at the handshake instead.
PROTO_VERSION = 7

# High bit of the wire msgtype: a tracing trailer follows the payload.
# Never a routing class — masked off before any msgtype comparison.
MSGTYPE_TRACE_FLAG = 0x8000


class MsgType(enum.IntEnum):
    # --- dispatcher-handled (proto.go:19-76) -------------------------------
    SET_GAME_ID = 1
    SET_GAME_ID_ACK = 2
    SET_GATE_ID = 3
    NOTIFY_CREATE_ENTITY = 4
    NOTIFY_DESTROY_ENTITY = 5
    NOTIFY_CLIENT_CONNECTED = 6
    NOTIFY_CLIENT_DISCONNECTED = 7
    CALL_ENTITY_METHOD = 8
    CALL_ENTITY_METHOD_FROM_CLIENT = 9
    QUERY_SPACE_GAMEID_FOR_MIGRATE = 10
    QUERY_SPACE_GAMEID_FOR_MIGRATE_ACK = 11
    MIGRATE_REQUEST = 12
    MIGRATE_REQUEST_ACK = 13
    REAL_MIGRATE = 14
    CANCEL_MIGRATE = 15
    LOAD_ENTITY_SOMEWHERE = 16
    CREATE_ENTITY_SOMEWHERE = 17
    CALL_NIL_SPACES = 18
    SYNC_POSITION_YAW_FROM_CLIENT = 19
    NOTIFY_GAME_CONNECTED = 20
    NOTIFY_GAME_DISCONNECTED = 21
    NOTIFY_GATE_DISCONNECTED = 22
    NOTIFY_DEPLOYMENT_READY = 23
    START_FREEZE_GAME = 24
    START_FREEZE_GAME_ACK = 25
    KVREG_REGISTER = 26
    GAME_LBC_INFO = 27
    # Cluster-link liveness probe (no reference analog — GoWorld has
    # heartbeats only on gate↔client): sent on idle game/gate↔dispatcher
    # links by BOTH ends, swallowed at the recv seam (never queued to
    # logic); its only effect is refreshing the peer's last-seen clock.
    HEARTBEAT = 28
    # Rich per-game load report (no reference analog; supersedes the
    # cpu-only GAME_LBC_INFO, which stays wired for reference parity):
    # one bson dict per second per game — cpu%, entity count, tick-phase
    # p95, queue depth, per-space populations — feeding both the LBC
    # choose-game heap and the dispatcher-side rebalancer (rebalance/).
    GAME_LOAD_REPORT = 29
    # Dispatcher→game rebalance command: migrate up to ``count`` entities
    # out of one space into a same-kind space on another game via the
    # hardened cross-game migration path (rebalance/migrator.py).
    REBALANCE_MIGRATE = 30
    # --- whole-space migration (no reference analog — GoWorld
    # never moves a live space).  The handoff is freeze-fence + fat
    # transfer: PREPARE broadcast parks the listed members' streams on
    # every owning dispatcher, each acks on its own FIFO (the freeze-ack
    # fence), the donor packs only after every ack, and the one DATA
    # payload routes exactly like REAL_MIGRATE — buffer behind a grace
    # window, bounce HOME to the donor on a dead target.  Proved in
    # analysis/modelcheck.py (space_handoff / space_member_race) BEFORE
    # this implementation landed.
    # Donor game → EVERY dispatcher: freeze announcement + member list.
    SPACE_MIGRATE_PREPARE = 31
    # Each dispatcher → donor game, after parking its listed members.
    SPACE_MIGRATE_PREPARE_ACK = 32
    # Donor → space-owner dispatcher → receiver game: the whole-space
    # snapshot, with a source-game trailer for the bounce-home path.
    SPACE_MIGRATE_DATA = 33
    # Abort, either direction: dispatcher→donor (target dead at
    # PREPARE) or donor→dispatchers (deadline fired; unpark members).
    SPACE_MIGRATE_ABORT = 34
    # Receiver game → space-owner dispatcher: restore completed
    # (telemetry + handoff-entry cleanup; routing rides NOTIFY_CREATE).
    SPACE_MIGRATE_ACK = 35
    # Dispatcher → donor game: move one whole space to another game
    # (the bin-packer's whole-space analog of REBALANCE_MIGRATE).
    REBALANCE_MIGRATE_SPACE = 36
    # Planner-service game → its owner dispatcher: an externally
    # computed rebalance plan to validate and dispatch (planner
    # failover rides the sharded-service plane).
    REBALANCE_PLAN = 37

    # --- redirected to client via gate (proto.go:85-114) -------------------
    CREATE_ENTITY_ON_CLIENT = 1001
    DESTROY_ENTITY_ON_CLIENT = 1002
    NOTIFY_MAP_ATTR_CHANGE_ON_CLIENT = 1003
    NOTIFY_MAP_ATTR_DEL_ON_CLIENT = 1004
    NOTIFY_MAP_ATTR_CLEAR_ON_CLIENT = 1005
    NOTIFY_LIST_ATTR_CHANGE_ON_CLIENT = 1006
    NOTIFY_LIST_ATTR_POP_ON_CLIENT = 1007
    NOTIFY_LIST_ATTR_APPEND_ON_CLIENT = 1008
    CALL_ENTITY_METHOD_ON_CLIENT = 1009
    SET_CLIENTPROXY_FILTER_PROP = 1010
    CLEAR_CLIENTPROXY_FILTER_PROPS = 1011

    # --- gate-handled (proto.go:116-123) -----------------------------------
    CALL_FILTERED_CLIENTS = 1501
    SYNC_POSITION_YAW_ON_CLIENTS = 1502
    # Compact sync variant (no reference analog; ROADMAP item 5): quantized
    # position deltas against a per-client baseline, sent beside the full-
    # precision keyframes that ride SYNC_POSITION_YAW_ON_CLIENTS. The
    # payload self-describes its quantization step ([u8 quantize_bits]
    # after the gateid) so gates and clients need no config coupling.
    SYNC_POSITION_YAW_DELTA_ON_CLIENTS = 1503

    # --- gate↔client direct (proto.go:126-133) -----------------------------
    HEARTBEAT_FROM_CLIENT = 2001


REDIRECT_MIN = 1001
REDIRECT_MAX = 1499
GATE_MIN = 1501
GATE_MAX = 1999
CLIENT_MIN = 2001


def is_dispatcher_handled(t: int) -> bool:  # gwlint: keep — msgtype classification API beside is_gate_*
    return t < 1000


def is_gate_redirect(t: int) -> bool:
    return REDIRECT_MIN <= t <= REDIRECT_MAX


def is_gate_handled(t: int) -> bool:  # gwlint: keep — msgtype classification API beside is_gate_redirect
    return GATE_MIN <= t <= GATE_MAX


class FilterOp(enum.IntEnum):
    """Filtered-client broadcast comparison ops (proto.go:142-151)."""

    EQ = 0
    NE = 1
    LT = 2
    LTE = 3
    GT = 4
    GTE = 5
