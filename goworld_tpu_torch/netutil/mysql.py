"""From-scratch MySQL client-protocol implementation (text protocol).

Fills the reference's mysql backend slots
(``engine/storage/backend/mysql/entity_storage_mysql.go``,
``engine/kvdb/backend/kvdb_mysql.go``) without a driver. Implements the
classic wire protocol: [3-byte length][seq] framing, HandshakeV10 →
HandshakeResponse41 with ``mysql_native_password`` auth (auth-switch
handled; servers defaulting to caching_sha2_password should create the
user WITH mysql_native_password, the usual arrangement for thin clients),
then COM_QUERY with text result sets.

Like the RESP2/OP_MSG clients: blocking socket + lock, driven from the
serial storage/kvdb worker threads; one transparent reconnect.
"""

from __future__ import annotations

import hashlib
import socket
import struct
import threading
from typing import Optional

_CLIENT_LONG_PASSWORD = 0x1
_CLIENT_PROTOCOL_41 = 0x200
_CLIENT_SECURE_CONNECTION = 0x8000
_CLIENT_PLUGIN_AUTH = 0x80000
_CLIENT_CONNECT_WITH_DB = 0x8

_COM_QUIT = 0x01
_COM_QUERY = 0x03
_COM_PING = 0x0E


class MySQLError(Exception):
    def __init__(self, msg: str, code: int = 0) -> None:
        super().__init__(msg)
        self.code = code


def _native_password_token(password: str, scramble: bytes) -> bytes:
    """SHA1(pass) XOR SHA1(scramble + SHA1(SHA1(pass))) — the
    mysql_native_password proof."""
    if not password:
        return b""
    h1 = hashlib.sha1(password.encode("utf-8")).digest()
    h2 = hashlib.sha1(h1).digest()
    h3 = hashlib.sha1(scramble + h2).digest()
    return bytes(a ^ b for a, b in zip(h1, h3))


def _read_lenenc(data: bytes, off: int) -> tuple[Optional[int], int]:
    if off >= len(data):
        raise ValueError("mysql: truncated length-encoded integer")
    first = data[off]
    if first < 0xFB:
        return first, off + 1
    if first == 0xFB:  # NULL (in row context)
        return None, off + 1
    width = {0xFC: 2, 0xFD: 3}.get(first, 8)
    if off + 1 + width > len(data):
        raise ValueError("mysql: truncated length-encoded integer")
    if first == 0xFC:
        return struct.unpack_from("<H", data, off + 1)[0], off + 3
    if first == 0xFD:
        return int.from_bytes(data[off + 1:off + 4], "little"), off + 4
    return struct.unpack_from("<Q", data, off + 1)[0], off + 9


def escape(val: str) -> str:
    """SQL string-literal escaping for the text protocol."""
    out = val.replace("\\", "\\\\").replace("'", "\\'")
    return out.replace("\x00", "\\0").replace("\n", "\\n").replace("\r", "\\r")


class MySQLClient:
    def __init__(self, host: str = "127.0.0.1", port: int = 3306,
                 user: str = "root", password: str = "",
                 database: str = "", timeout: float = 10.0) -> None:
        self.host = host
        self.port = port
        self.user = user
        self.password = password
        self.database = database
        self.timeout = timeout
        self._sock: Optional[socket.socket] = None
        self._seq = 0
        self._lock = threading.Lock()

    # --- framing ------------------------------------------------------------

    def _read_exact(self, n: int) -> bytes:
        bufs = []
        while n:
            b = self._sock.recv(n)
            if not b:
                raise ConnectionError("mysql: connection closed")
            bufs.append(b)
            n -= len(b)
        return b"".join(bufs)

    def _read_packet(self) -> bytes:
        hdr = self._read_exact(4)
        length = int.from_bytes(hdr[:3], "little")
        self._seq = hdr[3] + 1
        return self._read_exact(length)

    def _send_packet(self, payload: bytes) -> None:
        self._sock.sendall(
            len(payload).to_bytes(3, "little") + bytes([self._seq & 0xFF])
            + payload
        )
        self._seq += 1

    # --- connect + auth -----------------------------------------------------

    def _connect(self) -> None:
        self.close()
        s = socket.create_connection((self.host, self.port), self.timeout)
        s.settimeout(self.timeout)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock = s
        self._seq = 0
        greeting = self._read_packet()
        if greeting[0] == 0xFF:
            raise MySQLError(greeting[9:].decode("utf-8", "replace"))
        if greeting[0] != 10:
            raise MySQLError(f"unsupported protocol {greeting[0]}")
        off = 1
        off = greeting.index(b"\x00", off) + 1  # server version
        off += 4  # thread id
        scramble = greeting[off:off + 8]
        off += 8 + 1  # filler
        off += 2 + 1 + 2 + 2  # caps-low, charset, status, caps-high
        auth_len = greeting[off]
        off += 1 + 10  # reserved
        scramble += greeting[off:off + max(13, auth_len - 8)][:12]
        caps = (_CLIENT_LONG_PASSWORD | _CLIENT_PROTOCOL_41
                | _CLIENT_SECURE_CONNECTION | _CLIENT_PLUGIN_AUTH)
        if self.database:
            caps |= _CLIENT_CONNECT_WITH_DB
        token = _native_password_token(self.password, scramble)
        resp = struct.pack("<IIB23x", caps, 1 << 24, 33)  # utf8_general_ci
        resp += self.user.encode("utf-8") + b"\x00"
        resp += bytes([len(token)]) + token
        if self.database:
            resp += self.database.encode("utf-8") + b"\x00"
        resp += b"mysql_native_password\x00"
        self._send_packet(resp)
        reply = self._read_packet()
        if reply[0] == 0xFE:  # auth switch request
            plugin_end = reply.index(b"\x00", 1)
            new_scramble = reply[plugin_end + 1:].rstrip(b"\x00")
            self._send_packet(
                _native_password_token(self.password, new_scramble)
            )
            reply = self._read_packet()
        if reply[0] == 0xFF:
            code = struct.unpack_from("<H", reply, 1)[0]
            raise MySQLError(reply[9:].decode("utf-8", "replace"), code)

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._seq = 0
                self._send_packet(bytes([_COM_QUIT]))
            except OSError:
                pass
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    # --- queries ------------------------------------------------------------

    def _query_once(self, sql: str) -> tuple[int, list[list[Optional[str]]]]:
        self._seq = 0
        self._send_packet(bytes([_COM_QUERY]) + sql.encode("utf-8"))
        first = self._read_packet()
        if first[0] == 0xFF:
            code = struct.unpack_from("<H", first, 1)[0]
            raise MySQLError(first[9:].decode("utf-8", "replace"), code)
        if first[0] == 0x00:  # OK packet: lenenc affected_rows follows
            affected, _ = _read_lenenc(first, 1)
            return int(affected or 0), []
        ncols, _ = _read_lenenc(first, 0)
        for _ in range(ncols):  # column definitions (ignored)
            self._read_packet()
        pkt = self._read_packet()
        if pkt[0] == 0xFE and len(pkt) < 9:  # EOF after columns
            pkt = self._read_packet()
        rows: list[list[Optional[str]]] = []
        while not (pkt[0] == 0xFE and len(pkt) < 9):
            if pkt[0] == 0xFF:
                raise MySQLError(pkt[9:].decode("utf-8", "replace"))
            row: list[Optional[str]] = []
            off = 0
            while off < len(pkt):
                n, off = _read_lenenc(pkt, off)
                if n is None:
                    row.append(None)
                else:
                    row.append(pkt[off:off + n].decode("utf-8"))
                    off += n
            rows.append(row)
            pkt = self._read_packet()
        return 0, rows

    def query(self, sql: str) -> list[list[Optional[str]]]:
        """Run a statement, returning rows (SELECT) or [] (DML); see
        :meth:`execute` for affected-row counts."""
        return self._with_reconnect(sql)[1]

    def execute(self, sql: str) -> int:
        """Run a statement, returning the affected-row count."""
        return self._with_reconnect(sql)[0]

    def _with_reconnect(self, sql: str):
        with self._lock:
            if self._sock is None:
                self._connect()
            try:
                return self._query_once(sql)
            except (OSError, ConnectionError):
                self._connect()
                return self._query_once(sql)

    def ping(self) -> bool:
        with self._lock:
            if self._sock is None:
                self._connect()
            self._seq = 0
            self._send_packet(bytes([_COM_PING]))
            return self._read_packet()[0] == 0x00


def parse_mysql_url(url: str) -> dict:
    """``mysql://[user[:password]@]host[:port][/database]``."""
    rest = url
    if "://" in rest:
        scheme, rest = rest.split("://", 1)
        if scheme != "mysql":
            raise ValueError(f"unsupported url scheme {scheme!r}")
    user, password = "root", ""
    if "@" in rest:
        auth, rest = rest.rsplit("@", 1)
        user, _, password = auth.partition(":")
    database = ""
    if "/" in rest:
        rest, database = rest.split("/", 1)
    host, _, port = rest.partition(":")
    return {
        "host": host or "127.0.0.1",
        "port": int(port) if port else 3306,
        "user": user or "root",
        "password": password,
        "database": database,
    }
