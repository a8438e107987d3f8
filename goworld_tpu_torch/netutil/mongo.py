"""From-scratch MongoDB wire-protocol client (OP_MSG).

Fills the reference's mongodb backend slots
(``engine/storage/backend/mongodb/mongodb.go``,
``engine/kvdb/backend/kvdb_mongodb.go``, ``ext/db/gwmongo``) without a
driver: modern servers speak OP_MSG (opcode 2013) — one kind-0 section
carrying a command document, reply likewise. Like the RESP2 client
(netutil/resp.py) this is a blocking socket + lock, run from the serial
storage/kvdb worker threads.

Supported commands: ping/hello, insert, update (upsert), delete, find (+
getMore cursor pagination). No auth/TLS/compression — connect to a local
or trusted mongod (the reference's CI services ran the same way).
"""

from __future__ import annotations

import socket
import struct
import threading
from typing import Optional

from goworld_tpu_torch.netutil import bson

_OP_MSG = 2013
_HEADER = struct.Struct("<iiii")  # messageLength, requestID, responseTo, opCode


class MongoError(Exception):
    """Server-reported command failure ({ok: 0, ...} or writeErrors)."""

    def __init__(self, msg: str, code: int = 0) -> None:
        super().__init__(msg)
        self.code = code


DUPLICATE_KEY = 11000


class MongoClient:
    def __init__(self, host: str = "127.0.0.1", port: int = 27017,
                 timeout: float = 10.0) -> None:
        self.host = host
        self.port = port
        self.timeout = timeout
        self._sock: Optional[socket.socket] = None
        self._req_id = 0
        self._lock = threading.Lock()

    # --- transport ----------------------------------------------------------

    def _connect(self) -> None:
        self.close()
        s = socket.create_connection((self.host, self.port), self.timeout)
        s.settimeout(self.timeout)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock = s

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def _read_exact(self, n: int) -> bytes:
        chunks = []
        while n:
            b = self._sock.recv(n)
            if not b:
                raise ConnectionError("mongo: connection closed")
            chunks.append(b)
            n -= len(b)
        return b"".join(chunks)

    def _roundtrip(self, command: dict) -> dict:
        self._req_id += 1
        sections = b"\x00" + bson.encode(command)  # kind-0 section + doc
        msg = (
            _HEADER.pack(16 + 4 + len(sections), self._req_id, 0, _OP_MSG)
            + struct.pack("<i", 0)  # flagBits
            + sections
        )
        self._sock.sendall(msg)
        length, _, _, opcode = _HEADER.unpack(self._read_exact(16))
        payload = self._read_exact(length - 16)
        if opcode != _OP_MSG:
            raise MongoError(f"unexpected reply opcode {opcode}")
        # payload = flagBits i32, then sections; kind-0 section = one doc.
        off = 4
        if payload[off] != 0:
            raise MongoError(f"unexpected section kind {payload[off]}")
        reply = bson.decode(payload[off + 1:])
        return reply

    # --- commands -----------------------------------------------------------

    def command(self, db: str, command: dict) -> dict:
        """Run one command; transparent single reconnect on transport error
        (kvdb auto-reopen parity, kvdb.go:40-207)."""
        command = dict(command)
        command["$db"] = db
        with self._lock:
            if self._sock is None:
                self._connect()
            try:
                reply = self._roundtrip(command)
            except (OSError, ConnectionError):
                self._connect()
                reply = self._roundtrip(command)
        if not reply.get("ok"):
            raise MongoError(
                str(reply.get("errmsg", reply)), int(reply.get("code", 0))
            )
        errs = reply.get("writeErrors")
        if errs:
            first = errs[0]
            raise MongoError(
                str(first.get("errmsg", first)), int(first.get("code", 0))
            )
        return reply

    def ping(self, db: str = "admin") -> bool:
        return bool(self.command(db, {"ping": 1}).get("ok"))

    def insert(self, db: str, coll: str, docs: list[dict]) -> None:
        self.command(db, {"insert": coll, "documents": docs})

    def upsert(self, db: str, coll: str, query: dict, doc: dict) -> None:
        self.command(db, {
            "update": coll,
            "updates": [{"q": query, "u": doc, "upsert": True, "multi": False}],
        })

    def delete(self, db: str, coll: str, query: dict, limit: int = 0) -> int:
        r = self.command(db, {
            "delete": coll, "deletes": [{"q": query, "limit": limit}],
        })
        return int(r.get("n", 0))

    def find(self, db: str, coll: str, query: dict,
             projection: Optional[dict] = None, sort: Optional[dict] = None,
             limit: int = 0) -> list[dict]:
        cmd: dict = {"find": coll, "filter": query, "batchSize": 1000}
        if projection is not None:
            cmd["projection"] = projection
        if sort is not None:
            cmd["sort"] = sort
        if limit:
            cmd["limit"] = limit
        r = self.command(db, cmd)
        cursor = r.get("cursor", {})
        out = list(cursor.get("firstBatch", []))
        cid = cursor.get("id", 0)
        while cid:
            r = self.command(db, {"getMore": cid, "collection": coll,
                                  "batchSize": 1000})
            cursor = r.get("cursor", {})
            out.extend(cursor.get("nextBatch", []))
            cid = cursor.get("id", 0)
        return out

    def find_one(self, db: str, coll: str, query: dict) -> Optional[dict]:
        docs = self.find(db, coll, query, limit=1)
        return docs[0] if docs else None


def parse_mongo_url(url: str) -> dict:
    """``mongodb://host[:port]`` → MongoClient kwargs (no auth/options)."""
    rest = url
    if "://" in rest:
        scheme, rest = rest.split("://", 1)
        if scheme != "mongodb":
            raise ValueError(f"unsupported url scheme {scheme!r}")
    rest = rest.split("/", 1)[0]
    host, _, port = rest.partition(":")
    return {"host": host or "127.0.0.1", "port": int(port) if port else 27017}
