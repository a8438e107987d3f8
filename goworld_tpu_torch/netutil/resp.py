"""From-scratch RESP2 (REdis Serialization Protocol) client.

Closes the reference's network-DB gap without any
driver dependency: the reference ships redigo-backed storage/kvdb backends
(``engine/kvdb/backend/kvdb_redis.go:11-69``,
``engine/storage/backend/redis/entity_storage_redis.go``); this is the
in-repo equivalent speaking the wire protocol directly.

Protocol (RESP2): requests are arrays of bulk strings
``*N\\r\\n$len\\r\\n<arg>\\r\\n...``; replies are ``+simple``, ``-error``,
``:integer``, ``$bulk`` (-1 = nil) or ``*array`` (recursive, -1 = nil).

The client is a blocking socket with a lock — storage/kvdb backends run on
serial worker threads (storage/__init__.py), so latency hiding happens at
the job-queue layer, exactly like the reference's storageRoutine. One
transparent reconnect per command covers idle-timeout disconnects.
"""

from __future__ import annotations

import socket
import threading
from typing import Optional, Union

Reply = Union[None, int, bytes, list]


class RespError(Exception):
    """Server-reported error reply (``-ERR ...``)."""


class RespClient:
    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 6379,
        db: int = 0,
        password: Optional[str] = None,
        timeout: float = 10.0,
    ) -> None:
        self.host = host
        self.port = port
        self.db = db
        self.password = password
        self.timeout = timeout
        self._sock: Optional[socket.socket] = None
        self._buf = b""
        self._lock = threading.Lock()

    # --- connection ---------------------------------------------------------

    def _connect(self) -> None:
        self.close()
        s = socket.create_connection((self.host, self.port), self.timeout)
        s.settimeout(self.timeout)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock = s
        self._buf = b""
        if self.password:
            self._roundtrip(("AUTH", self.password))
        if self.db:
            self._roundtrip(("SELECT", str(self.db)))

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    # --- protocol -----------------------------------------------------------

    @staticmethod
    def _serialize(args: tuple) -> bytes:
        parts = [b"*%d\r\n" % len(args)]
        for a in args:
            b = a if isinstance(a, bytes) else str(a).encode("utf-8")
            parts.append(b"$%d\r\n%s\r\n" % (len(b), b))
        return b"".join(parts)

    def _read_line(self) -> bytes:
        while b"\r\n" not in self._buf:
            chunk = self._sock.recv(65536)
            if not chunk:
                raise ConnectionError("resp: connection closed")
            self._buf += chunk
        line, self._buf = self._buf.split(b"\r\n", 1)
        return line

    def _read_exact(self, n: int) -> bytes:
        while len(self._buf) < n:
            chunk = self._sock.recv(65536)
            if not chunk:
                raise ConnectionError("resp: connection closed")
            self._buf += chunk
        data, self._buf = self._buf[:n], self._buf[n:]
        return data

    def _read_reply(self) -> Reply:
        line = self._read_line()
        kind, rest = line[:1], line[1:]
        if kind == b"+":
            return rest
        if kind == b"-":
            raise RespError(rest.decode("utf-8", "replace"))
        if kind == b":":
            return int(rest)
        if kind == b"$":
            n = int(rest)
            if n < 0:
                return None
            data = self._read_exact(n)
            self._read_exact(2)  # trailing \r\n
            return data
        if kind == b"*":
            n = int(rest)
            if n < 0:
                return None
            return [self._read_reply() for _ in range(n)]
        raise RespError(f"resp: bad reply type {line!r}")

    def _roundtrip(self, args: tuple) -> Reply:
        self._sock.sendall(self._serialize(args))
        return self._read_reply()

    # --- public -------------------------------------------------------------

    def execute(self, *args) -> Reply:
        """Send one command; RespError for server errors, one transparent
        reconnect for transport errors (auto-reopen, kvdb.go:40-207)."""
        with self._lock:
            if self._sock is None:
                self._connect()
            try:
                return self._roundtrip(args)
            except (OSError, ConnectionError):
                self._connect()
                return self._roundtrip(args)

    def execute_once(self, *args) -> Reply:
        """Single attempt, NO reconnect-retry: for liveness probes whose
        worst case must be bounded by one timeout, not two (the transparent
        retry in :meth:`execute` would double a dead node's cost)."""
        with self._lock:
            if self._sock is None:
                self._connect()
            return self._roundtrip(args)

    # Typed helpers (str in/out; values are UTF-8).

    def get(self, key: str) -> Optional[str]:
        v = self.execute("GET", key)
        return None if v is None else v.decode("utf-8")

    def set(self, key: str, val: str) -> None:
        self.execute("SET", key, val)

    def setnx(self, key: str, val: str) -> bool:
        return self.execute("SETNX", key, val) == 1

    def delete(self, key: str) -> int:
        return self.execute("DEL", key)

    def exists(self, key: str) -> bool:
        return self.execute("EXISTS", key) == 1

    def scan_keys(self, pattern: str) -> list[str]:
        """Full SCAN cursor loop with MATCH (never KEYS: SCAN is the
        non-blocking form a live server tolerates)."""
        out: list[str] = []
        cursor = "0"
        while True:
            reply = self.execute("SCAN", cursor, "MATCH", pattern, "COUNT", "512")
            cursor = reply[0].decode()
            out.extend(k.decode("utf-8") for k in reply[1])
            if cursor == "0":
                return out

    def mget(self, keys: list[str]) -> list[Optional[str]]:
        if not keys:
            return []
        vals = self.execute("MGET", *keys)
        return [None if v is None else v.decode("utf-8") for v in vals]

    def ping(self) -> bool:
        return self.execute("PING") in (b"PONG", b"pong")


def parse_redis_url(url: str) -> dict:
    """``redis://[:password@]host[:port][/db]`` → RespClient kwargs."""
    rest = url
    if "://" in rest:
        scheme, rest = rest.split("://", 1)
        if scheme != "redis":
            raise ValueError(f"unsupported url scheme {scheme!r}")
    password = None
    if "@" in rest:
        auth, rest = rest.rsplit("@", 1)
        password = auth.lstrip(":") or None
    db = 0
    if "/" in rest:
        rest, dbs = rest.split("/", 1)
        if dbs:
            db = int(dbs)
    host, _, port = rest.partition(":")
    return {
        "host": host or "127.0.0.1",
        "port": int(port) if port else 6379,
        "db": db,
        "password": password,
    }
