"""SQLite entity storage (stdlib).

Fills the reference's SQL-backend slot (``engine/storage/backend/mysql/
entity_storage_mysql.go``) without an external server: same schema shape —
one row per entity keyed by (typename, entityid) with a JSON document column.
All access happens on the single storage worker, so one connection with
``check_same_thread=False`` is safe.
"""

from __future__ import annotations

import json
import os
import sqlite3
import threading
from typing import Optional

from goworld_tpu_torch.kvdb.sqlite import enable_wal


class SQLiteEntityStorage:
    def __init__(self, directory: str, filename: str = "entities.sqlite") -> None:
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(directory, filename)
        self._conn = sqlite3.connect(
            self.path, check_same_thread=False, timeout=10.0
        )
        self._lock = threading.Lock()
        with self._lock:
            # WAL + busy_timeout: every game process in a deployment shares
            # this file (see kvdb/sqlite.py).
            enable_wal(self._conn)
            self._conn.execute("PRAGMA busy_timeout=10000")
            self._conn.execute(
                "CREATE TABLE IF NOT EXISTS entities ("
                " typename TEXT NOT NULL, eid TEXT NOT NULL, data TEXT NOT NULL,"
                " PRIMARY KEY (typename, eid))"
            )
            self._conn.commit()

    def write(self, typename: str, eid: str, data: dict) -> None:
        with self._lock:
            self._conn.execute(
                "INSERT INTO entities (typename, eid, data) VALUES (?, ?, ?)"
                " ON CONFLICT(typename, eid) DO UPDATE SET data = excluded.data",
                (typename, eid, json.dumps(data)),
            )
            self._conn.commit()

    def read(self, typename: str, eid: str) -> Optional[dict]:
        with self._lock:
            row = self._conn.execute(
                "SELECT data FROM entities WHERE typename = ? AND eid = ?",
                (typename, eid),
            ).fetchone()
        return json.loads(row[0]) if row else None

    def exists(self, typename: str, eid: str) -> bool:
        with self._lock:
            row = self._conn.execute(
                "SELECT 1 FROM entities WHERE typename = ? AND eid = ?",
                (typename, eid),
            ).fetchone()
        return row is not None

    def list_entity_ids(self, typename: str) -> list[str]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT eid FROM entities WHERE typename = ? ORDER BY eid",
                (typename,),
            ).fetchall()
        return [r[0] for r in rows]

    def close(self) -> None:
        with self._lock:
            self._conn.close()
