"""SQLite KVDB backend: ordered keys make GetRange a btree scan.

Fills the reference's ``kvdb_mysql``/``kvdb_mongodb`` slot (kvdb_types.go:4-25)
with a serverless local store.
"""

from __future__ import annotations

import os
import sqlite3
import threading
import time
from typing import Optional


def enable_wal(conn: sqlite3.Connection) -> None:
    """Switch ``conn``'s file to WAL. Every game of a deployment opens the
    same file at boot; when several switch a fresh file at once, SQLite
    can answer "database is locked" at once, without waiting out the
    busy timeout, so the switch is retried for as long as that timeout
    (10 s, as both backends connect)."""
    deadline = time.monotonic() + 10.0
    while True:
        try:
            conn.execute("PRAGMA journal_mode=WAL")
            return
        except sqlite3.OperationalError as exc:
            if "locked" not in str(exc) or time.monotonic() > deadline:
                raise
            time.sleep(0.05)


class SQLiteKVDB:
    def __init__(self, directory: str, filename: str = "kvdb.sqlite") -> None:
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(directory, filename)
        self._conn = sqlite3.connect(
            self.path, check_same_thread=False, timeout=10.0
        )
        self._lock = threading.Lock()
        with self._lock:
            # WAL lets the other game processes read while one writes;
            # busy_timeout rides out cross-process write contention (every
            # game in a deployment shares this file, like the reference's
            # shared kvdb service).
            enable_wal(self._conn)
            self._conn.execute("PRAGMA busy_timeout=10000")
            self._conn.execute(
                "CREATE TABLE IF NOT EXISTS kv (k TEXT PRIMARY KEY, v TEXT NOT NULL)"
            )
            self._conn.commit()

    def get(self, key: str) -> Optional[str]:
        with self._lock:
            row = self._conn.execute("SELECT v FROM kv WHERE k = ?", (key,)).fetchone()
        return row[0] if row else None

    def put(self, key: str, val: str) -> None:
        with self._lock:
            self._conn.execute(
                "INSERT INTO kv (k, v) VALUES (?, ?)"
                " ON CONFLICT(k) DO UPDATE SET v = excluded.v",
                (key, val),
            )
            self._conn.commit()

    def get_or_put(self, key: str, val: str) -> Optional[str]:
        with self._lock:
            row = self._conn.execute("SELECT v FROM kv WHERE k = ?", (key,)).fetchone()
            if row is not None:
                return row[0]
            self._conn.execute("INSERT INTO kv (k, v) VALUES (?, ?)", (key, val))
            self._conn.commit()
            return None

    def get_range(self, begin: str, end: str) -> list[tuple[str, str]]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT k, v FROM kv WHERE k >= ? AND k < ? ORDER BY k",
                (begin, end),
            ).fetchall()
        return [(k, v) for k, v in rows]

    def close(self) -> None:
        with self._lock:
            self._conn.close()
