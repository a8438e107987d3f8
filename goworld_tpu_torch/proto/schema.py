"""Declarative wire schema: the single source of truth for payload layouts.

Every ``MsgType`` gets ONE field-sequence spec here.  The typed senders in
``proto/conn.py`` and the handler-side reads in ``dispatcher/``, ``gate/``,
``game/`` and ``rebalance/`` are checked against these specs by gwlint's
R7 proto-conformance rule (analysis/rules.py), which ALSO pins a digest of
the whole table against ``SCHEMA_HISTORY`` below — so a layout edit that
forgets to bump ``PROTO_VERSION`` fails the lint instead of mis-framing a
mixed-version cluster (the SET_GATE_ID fresh-before-version footgun,
msgtypes.py:33-39, is now machine-checked).

Field kinds map 1:1 onto the Packet codec (netutil/packet.py):

========  ==========================  ======================
kind      append primitive            read primitive
========  ==========================  ======================
u8        append_byte                 read_byte
bool      append_bool                 read_bool
u16       append_uint16               read_uint16
u32       append_uint32               read_uint32
u64       append_uint64               read_uint64
f32       append_float32              read_float32
f64       append_float64              read_float64
eid       append_entity_id            read_entity_id
cid       append_client_id            read_client_id
varstr    append_varstr               read_varstr
varbytes  append_varbytes             read_varbytes
data      append_data (msgpack)       read_data
args      append_args                 read_args
========  ==========================  ======================

Structural rules the table encodes (validated at import):

- every msgtype in the redirect range (1001..1499) starts with the
  ``[u16 gateid][cid clientid]`` prefix the dispatcher routes on and the
  gate strips (msgtypes.py:8-9);
- ``raw`` names a trailing region of raw bytes after the declared fields
  (the fixed-record sync payloads, proto/conn.py SYNC_DTYPE /
  CLIENT_SYNC_DTYPE) — senders build it wholesale, readers slice it;
- the tracing trailer (v4) is NOT a schema field: a sampled packet sets
  MSGTYPE_TRACE_FLAG and appends TRACE_TRAILER_BYTES after the payload,
  stripped at the recv seam before any handler read — the digest covers
  the rule so changing the trailer size is a layout change too.

Declared-but-in-transit fields: ``gate_appended`` marks a suffix the GATE
appends while forwarding a client-originated packet (today only the
trailing clientid of CALL_ENTITY_METHOD_FROM_CLIENT) — the client's pack
site legitimately stops right before it.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Iterable, Optional, Sequence

from goworld_tpu_torch.netutil.packet import Packet
from goworld_tpu_torch.proto.msgtypes import (
    PROTO_VERSION,
    REDIRECT_MAX,
    REDIRECT_MIN,
    MsgType,
)

#: v4 tracing-trailer size (telemetry/tracing.py TRAILER_SIZE) — declared
#: here as a plain literal so the digest covers it without importing the
#: telemetry stack; test_modelcheck pins it equal to the live constant.
TRACE_TRAILER_BYTES = 17

#: Field kind -> Packet append/read method names.  R7 uses these tables to
#: translate call sites into kind sequences; keep them exhaustive.
KIND_APPEND: dict[str, str] = {
    "u8": "append_byte", "bool": "append_bool", "u16": "append_uint16",
    "u32": "append_uint32", "u64": "append_uint64", "f32": "append_float32",
    "f64": "append_float64", "eid": "append_entity_id",
    "cid": "append_client_id", "varstr": "append_varstr",
    "varbytes": "append_varbytes", "data": "append_data",
    "args": "append_args",
}
KIND_READ: dict[str, str] = {
    "u8": "read_byte", "bool": "read_bool", "u16": "read_uint16",
    "u32": "read_uint32", "u64": "read_uint64", "f32": "read_float32",
    "f64": "read_float64", "eid": "read_entity_id", "cid": "read_client_id",
    "varstr": "read_varstr", "varbytes": "read_varbytes", "data": "read_data",
    "args": "read_args",
}
APPEND_TO_KIND: dict[str, str] = {v: k for k, v in KIND_APPEND.items()}
READ_TO_KIND: dict[str, str] = {v: k for k, v in KIND_READ.items()}

Field = tuple[str, str]  # (field name, kind)

#: The routing prefix of every redirect-range payload
#: (DispatcherService.go:841-844 routes on it; the gate strips it).
REDIRECT_PREFIX: tuple[Field, ...] = (("gateid", "u16"), ("clientid", "cid"))


@dataclasses.dataclass(frozen=True)
class MessageSchema:
    msgtype: MsgType
    fields: tuple[Field, ...]
    #: name of a trailing raw-bytes region after the declared fields
    #: (None = the fields ARE the whole payload).
    raw: Optional[str] = None
    #: number of TRAILING fields appended by the gate in transit (the
    #: originating client's pack site stops before them).
    gate_appended: int = 0

    def kinds(self) -> tuple[str, ...]:
        return tuple(kind for _name, kind in self.fields)


def schema(msgtype: MsgType, *fields: Field, raw: Optional[str] = None,
           gate_appended: int = 0) -> MessageSchema:
    """Declarator — called with literal tuples only, so gwlint R7 can
    re-read the whole table from this module's AST without importing it
    (fixture trees lint the same way the real tree does)."""
    return MessageSchema(msgtype, tuple(fields), raw=raw,
                         gate_appended=gate_appended)


def _redirect(msgtype: MsgType, *fields: Field) -> MessageSchema:
    return schema(msgtype, *REDIRECT_PREFIX, *fields)


SCHEMAS: tuple[MessageSchema, ...] = (
    # --- dispatcher-handled (1..999) ---------------------------------------
    schema(MsgType.SET_GAME_ID,
           ("gameid", "u16"), ("is_reconnect", "bool"),
           ("is_restore", "bool"), ("is_ban_boot_entity", "bool"),
           ("entity_ids", "data"), ("proto_version", "u32")),
    schema(MsgType.SET_GAME_ID_ACK, ("ack", "data")),
    # v5: ``fresh`` BEFORE ``gen``/``proto_version`` — the documented
    # mixed-pair footgun (msgtypes.py:33-39): a v4 reader parses the bool
    # as the version's first byte.  The digest pin mechanizes the bump.
    schema(MsgType.SET_GATE_ID,
           ("gateid", "u16"), ("fresh", "bool"), ("gen", "u32"),
           ("proto_version", "u32")),
    schema(MsgType.NOTIFY_CREATE_ENTITY, ("eid", "eid")),
    schema(MsgType.NOTIFY_DESTROY_ENTITY, ("eid", "eid")),
    # Gate boot generation LAST: the dispatcher's boot-eid peek reads the
    # prefix positionally (dispatcher/service.py).
    schema(MsgType.NOTIFY_CLIENT_CONNECTED,
           ("clientid", "cid"), ("gateid", "u16"), ("boot_eid", "eid"),
           ("gate_gen", "u32")),
    schema(MsgType.NOTIFY_CLIENT_DISCONNECTED,
           ("clientid", "cid"), ("owner_eid", "eid")),
    schema(MsgType.CALL_ENTITY_METHOD,
           ("eid", "eid"), ("method", "varstr"), ("args", "args")),
    # The trailing clientid is appended by the GATE while forwarding the
    # client's packet (gate/service.py _handle_client_packet).
    schema(MsgType.CALL_ENTITY_METHOD_FROM_CLIENT,
           ("eid", "eid"), ("method", "varstr"), ("args", "args"),
           ("clientid", "cid"), gate_appended=1),
    schema(MsgType.QUERY_SPACE_GAMEID_FOR_MIGRATE,
           ("spaceid", "eid"), ("eid", "eid"), ("nonce", "u32")),
    schema(MsgType.QUERY_SPACE_GAMEID_FOR_MIGRATE_ACK,
           ("spaceid", "eid"), ("eid", "eid"), ("gameid", "u16"),
           ("nonce", "u32")),
    schema(MsgType.MIGRATE_REQUEST,
           ("eid", "eid"), ("spaceid", "eid"), ("space_gameid", "u16"),
           ("nonce", "u32")),
    schema(MsgType.MIGRATE_REQUEST_ACK,
           ("eid", "eid"), ("spaceid", "eid"), ("space_gameid", "u16"),
           ("nonce", "u32")),
    # v5: trailing source gameid — readable without parsing the bson body
    # so a sweep-time bounce needs no proxy context (proto/conn.py).
    schema(MsgType.REAL_MIGRATE,
           ("eid", "eid"), ("target_game", "u16"), ("migrate_data", "data"),
           ("source_game", "u16")),
    schema(MsgType.CANCEL_MIGRATE, ("eid", "eid")),
    schema(MsgType.LOAD_ENTITY_SOMEWHERE,
           ("gameid", "u16"), ("typename", "varstr"), ("eid", "eid")),
    schema(MsgType.CREATE_ENTITY_SOMEWHERE,
           ("gameid", "u16"), ("typename", "varstr"), ("eid", "eid"),
           ("attrs", "data")),
    schema(MsgType.CALL_NIL_SPACES,
           ("except_game", "u16"), ("method", "varstr"), ("args", "args")),
    # Concatenated fixed 32 B records: EntityID(16) + x,y,z,yaw float32
    # (proto/conn.py SYNC_DTYPE); built and sliced wholesale.
    schema(MsgType.SYNC_POSITION_YAW_FROM_CLIENT, raw="sync_records"),
    schema(MsgType.NOTIFY_GAME_CONNECTED, ("gameid", "u16")),
    schema(MsgType.NOTIFY_GAME_DISCONNECTED, ("gameid", "u16")),
    # v5: valid_gen != 0 narrows the detach to OTHER gate generations.
    schema(MsgType.NOTIFY_GATE_DISCONNECTED,
           ("gateid", "u16"), ("valid_gen", "u32")),
    schema(MsgType.NOTIFY_DEPLOYMENT_READY),
    schema(MsgType.START_FREEZE_GAME),
    schema(MsgType.START_FREEZE_GAME_ACK),
    schema(MsgType.KVREG_REGISTER,
           ("key", "varstr"), ("value", "varstr"), ("force", "bool")),
    schema(MsgType.GAME_LBC_INFO, ("cpu_percent", "f32")),
    schema(MsgType.HEARTBEAT),
    schema(MsgType.GAME_LOAD_REPORT, ("report", "data")),
    schema(MsgType.REBALANCE_MIGRATE,
           ("from_space", "eid"), ("to_space", "eid"), ("to_game", "u16"),
           ("count", "u16")),
    # v7 whole-space handoff (msgtypes.py:31-37 protocol notes).  The
    # member list rides msgpack: dispatchers park exactly the LISTED
    # eids (the freeze-time membership — a member that already migrated
    # out is not parked; modelcheck space_member_race found the hole).
    schema(MsgType.SPACE_MIGRATE_PREPARE,
           ("spaceid", "eid"), ("to_game", "u16"),
           ("member_eids", "data")),
    schema(MsgType.SPACE_MIGRATE_PREPARE_ACK,
           ("spaceid", "eid"), ("dispatcherid", "u16")),
    # Mirrors REAL_MIGRATE: trailing source gameid readable without
    # parsing the bson body, so the sweep-time bounce-home needs no
    # proxy context.
    schema(MsgType.SPACE_MIGRATE_DATA,
           ("spaceid", "eid"), ("target_game", "u16"),
           ("space_data", "data"), ("source_game", "u16")),
    schema(MsgType.SPACE_MIGRATE_ABORT,
           ("spaceid", "eid"), ("reason", "varstr")),
    schema(MsgType.SPACE_MIGRATE_ACK,
           ("spaceid", "eid"), ("gameid", "u16")),
    schema(MsgType.REBALANCE_MIGRATE_SPACE,
           ("spaceid", "eid"), ("to_game", "u16")),
    schema(MsgType.REBALANCE_PLAN, ("plan", "data")),
    # --- redirect range (1001..1499): [u16 gateid][clientid] prefix --------
    _redirect(MsgType.CREATE_ENTITY_ON_CLIENT,
              ("is_player", "bool"), ("eid", "eid"), ("typename", "varstr"),
              ("client_attrs", "data"), ("x", "f32"), ("y", "f32"),
              ("z", "f32"), ("yaw", "f32")),
    _redirect(MsgType.DESTROY_ENTITY_ON_CLIENT,
              ("typename", "varstr"), ("eid", "eid")),
    _redirect(MsgType.NOTIFY_MAP_ATTR_CHANGE_ON_CLIENT,
              ("eid", "eid"), ("path", "data"), ("key", "varstr"),
              ("val", "data")),
    _redirect(MsgType.NOTIFY_MAP_ATTR_DEL_ON_CLIENT,
              ("eid", "eid"), ("path", "data"), ("key", "varstr")),
    _redirect(MsgType.NOTIFY_MAP_ATTR_CLEAR_ON_CLIENT,
              ("eid", "eid"), ("path", "data")),
    _redirect(MsgType.NOTIFY_LIST_ATTR_CHANGE_ON_CLIENT,
              ("eid", "eid"), ("path", "data"), ("index", "u32"),
              ("val", "data")),
    _redirect(MsgType.NOTIFY_LIST_ATTR_POP_ON_CLIENT,
              ("eid", "eid"), ("path", "data")),
    _redirect(MsgType.NOTIFY_LIST_ATTR_APPEND_ON_CLIENT,
              ("eid", "eid"), ("path", "data"), ("val", "data")),
    _redirect(MsgType.CALL_ENTITY_METHOD_ON_CLIENT,
              ("eid", "eid"), ("method", "varstr"), ("args", "args")),
    _redirect(MsgType.SET_CLIENTPROXY_FILTER_PROP,
              ("key", "varstr"), ("val", "varstr")),
    _redirect(MsgType.CLEAR_CLIENTPROXY_FILTER_PROPS),
    # --- gate-handled (1501..1999) -----------------------------------------
    schema(MsgType.CALL_FILTERED_CLIENTS,
           ("op", "u8"), ("key", "varstr"), ("val", "varstr"),
           ("method", "varstr"), ("args", "args")),
    # [u16 gateid] + concatenated [clientid(16) + 32 B record] blocks
    # (proto/conn.py CLIENT_SYNC_DTYPE).
    schema(MsgType.SYNC_POSITION_YAW_ON_CLIENTS,
           ("gateid", "u16"), raw="client_sync_blocks"),
    # v6: [u16 gateid][u8 quantize_bits] + concatenated [clientid(16) +
    # 24 B delta record] blocks (proto/conn.py CLIENT_DELTA_SYNC_DTYPE).
    # The quantize step (2^-quantize_bits world units) rides the payload
    # so the gate/client decode needs no config coupling with the game.
    schema(MsgType.SYNC_POSITION_YAW_DELTA_ON_CLIENTS,
           ("gateid", "u16"), ("quantize_bits", "u8"),
           raw="client_delta_sync_blocks"),
    # --- gate<->client (2001..) --------------------------------------------
    schema(MsgType.HEARTBEAT_FROM_CLIENT),
)

SCHEMAS_BY_TYPE: dict[int, MessageSchema] = {
    int(s.msgtype): s for s in SCHEMAS
}


# --- digest pinning ----------------------------------------------------------


def canonical_lines(
    version: int,
    entries: Iterable[tuple[str, int, Sequence[str], Optional[str]]],
    trailer_bytes: int = TRACE_TRAILER_BYTES,
) -> list[str]:
    """Canonical rendering of a schema table: one line per msgtype in
    value order plus a header carrying the version and the trace-trailer
    rule.  Shared by the runtime digest below and R7's AST-extracted
    digest (analysis/rules.py) so the two can never diverge in format.
    ``entries`` = (msgtype name, value, kind sequence, raw-region name)."""
    lines = [f"proto_version={version};trace_trailer={trailer_bytes}"]
    for name, value, kinds, raw in sorted(entries, key=lambda e: e[1]):
        body = ",".join(kinds)
        if raw is not None:
            body = f"{body}+raw:{raw}" if body else f"raw:{raw}"
        lines.append(f"{value}:{name}={body}")
    return lines


def digest_of(
    version: int,
    entries: Iterable[tuple[str, int, Sequence[str], Optional[str]]],
    trailer_bytes: int = TRACE_TRAILER_BYTES,
) -> str:
    text = "\n".join(canonical_lines(version, entries, trailer_bytes))
    return hashlib.sha256(text.encode("utf-8")).hexdigest()[:16]


def schema_digest() -> str:
    """Digest of the table above under the CURRENT PROTO_VERSION."""
    return digest_of(
        PROTO_VERSION,
        [(s.msgtype.name, int(s.msgtype), s.kinds(), s.raw)
         for s in SCHEMAS])


#: Append-only version -> digest pin.  gwlint R7 fails when the computed
#: digest differs from this table's entry for the CURRENT PROTO_VERSION —
#: i.e. any layout change must land as a new (version, digest) pair, with
#: the PROTO_VERSION bump in msgtypes.py, in the same commit.  Earlier
#: entries stay forever: deleting or rewriting one is visible in review
#: and means the mixed-version handshake guard no longer matches history.
SCHEMA_HISTORY: dict[int, str] = {
    5: "6707328a4b365972",
    6: "3f2d7dd284f1af13",
    7: "08a4c48960727504",
}


# --- structural validation (runs at import; cheap tuple scans) ---------------


def validate() -> None:
    seen: set[int] = set()
    for s in SCHEMAS:
        v = int(s.msgtype)
        if v in seen:
            raise AssertionError(f"duplicate schema for {s.msgtype!r}")
        seen.add(v)
        for _name, kind in s.fields:
            if kind not in KIND_APPEND:
                raise AssertionError(
                    f"{s.msgtype.name}: unknown field kind {kind!r}")
        if REDIRECT_MIN <= v <= REDIRECT_MAX:
            if s.fields[:2] != REDIRECT_PREFIX:
                raise AssertionError(
                    f"{s.msgtype.name} is in the redirect range but does "
                    f"not start with the [u16 gateid][clientid] prefix")
        if s.gate_appended and not s.fields:
            raise AssertionError(
                f"{s.msgtype.name}: gate_appended without fields")
    missing = [t for t in MsgType if int(t) not in seen]
    if missing:
        raise AssertionError(
            f"msgtypes without a wire schema: {[t.name for t in missing]} "
            f"— declare the layout here before adding the type")


validate()


# --- example payloads (schema-driven fuzz + tests) ---------------------------

_EXAMPLE_EID = "E" * 16  # ENTITYID_LENGTH (common/entity_id.py)

#: Per-kind example values.  ``data`` defaults to a dict because most
#: bson-ish fields carry mappings; per-field overrides below fix the rest.
_KIND_EXAMPLES: dict[str, object] = {
    "u8": 3, "bool": True, "u16": 7, "u32": 99, "u64": 1 << 40,
    "f32": 1.5, "f64": 2.5, "eid": _EXAMPLE_EID, "cid": _EXAMPLE_EID,
    "varstr": "method_name", "varbytes": b"\x01\x02", "data": {"k": 1},
    "args": ("a", 2),
}

#: (msgtype, field name) -> example value, where the kind default would
#: not satisfy the handler's structural expectations.
_FIELD_EXAMPLES: dict[tuple[int, str], object] = {
    (int(MsgType.SET_GAME_ID), "entity_ids"): [_EXAMPLE_EID],
    (int(MsgType.SET_GAME_ID), "proto_version"): PROTO_VERSION,
    (int(MsgType.SET_GATE_ID), "proto_version"): PROTO_VERSION,
    (int(MsgType.SET_GAME_ID_ACK), "ack"): {
        "online_games": [1], "rejected": [], "kvreg": {}, "ready": True},
    (int(MsgType.GAME_LOAD_REPORT), "report"): {
        "cpu": 1.0, "entities": 1, "spaces": {}},
    (int(MsgType.SPACE_MIGRATE_PREPARE), "member_eids"): [_EXAMPLE_EID],
    (int(MsgType.SPACE_MIGRATE_DATA), "space_data"): {
        "space": {}, "members": {}},
    (int(MsgType.SPACE_MIGRATE_ABORT), "reason"): "deadline",
    (int(MsgType.REBALANCE_PLAN), "plan"): {
        "moves": [], "space_moves": []},
    (int(MsgType.NOTIFY_MAP_ATTR_CHANGE_ON_CLIENT), "path"): [],
    (int(MsgType.NOTIFY_MAP_ATTR_DEL_ON_CLIENT), "path"): [],
    (int(MsgType.NOTIFY_MAP_ATTR_CLEAR_ON_CLIENT), "path"): [],
    (int(MsgType.NOTIFY_LIST_ATTR_CHANGE_ON_CLIENT), "path"): [],
    (int(MsgType.NOTIFY_LIST_ATTR_POP_ON_CLIENT), "path"): [],
    (int(MsgType.NOTIFY_LIST_ATTR_APPEND_ON_CLIENT), "path"): [],
}

#: Example raw-region payloads (one sync record / one client block).
_RAW_EXAMPLES: dict[str, bytes] = {
    "sync_records": b"",  # filled lazily to avoid an import cycle
    "client_sync_blocks": b"",
    "client_delta_sync_blocks": b"",
}


def _raw_example(region: str) -> bytes:
    from goworld_tpu_torch.proto.conn import (
        pack_client_delta_sync_blocks,
        pack_client_sync_blocks,
        pack_sync_record,
    )

    if region == "sync_records":
        return pack_sync_record(_EXAMPLE_EID, 1.0, 2.0, 3.0, 0.5)
    if region == "client_sync_blocks":
        return pack_client_sync_blocks(
            [(_EXAMPLE_EID, _EXAMPLE_EID, 1.0, 2.0, 3.0, 0.5)])
    if region == "client_delta_sync_blocks":
        return pack_client_delta_sync_blocks(
            [(_EXAMPLE_EID, _EXAMPLE_EID, 1, -2, 3, 0)])
    raise KeyError(region)


def example_packet(msgtype: int) -> Packet:
    """A structurally valid payload for ``msgtype`` built strictly from
    its schema — the seed the truncation/mutation fuzz cuts up."""
    s = SCHEMAS_BY_TYPE[int(msgtype)]
    p = Packet()
    for name, kind in s.fields:
        value = _FIELD_EXAMPLES.get((int(s.msgtype), name),
                                    _KIND_EXAMPLES[kind])
        getattr(p, KIND_APPEND[kind])(value)
    if s.raw is not None:
        p.append_bytes(_raw_example(s.raw))
    return p


def read_fields(packet: Packet, msgtype: int) -> dict[str, object]:
    """Read a payload field-by-field per its schema (tests + the v4/v5
    mis-framing demo).  Raises ValueError on truncation like every other
    parser (netutil/packet.py PacketReadError)."""
    s = SCHEMAS_BY_TYPE[int(msgtype)]
    out: dict[str, object] = {}
    for name, kind in s.fields:
        out[name] = getattr(packet, KIND_READ[kind])()
    if s.raw is not None:
        out[s.raw] = packet.read_rest()
    return out
