"""MySQL KVDB backend over the in-repo wire-protocol client.

Reference parity: ``engine/kvdb/backend/kvdb_mysql.go`` — ordered VARCHAR
keys make GetRange a btree range scan; get_or_put is INSERT IGNORE racing
the primary key (affected-rows 1 = claimed).
"""

from __future__ import annotations

from typing import Optional

from goworld_tpu_torch.netutil.mysql import MySQLClient, escape, parse_mysql_url

_TABLE = "gw_kv"


class MySQLKVDB:
    def __init__(self, url: str) -> None:
        self._client = MySQLClient(**parse_mysql_url(url))
        self._client.execute(
            f"CREATE TABLE IF NOT EXISTS {_TABLE} ("
            " k VARCHAR(255) NOT NULL PRIMARY KEY,"
            " v TEXT NOT NULL)"
        )

    def get(self, key: str) -> Optional[str]:
        rows = self._client.query(
            f"SELECT v FROM {_TABLE} WHERE k='{escape(key)}'"
        )
        return rows[0][0] if rows else None

    def put(self, key: str, val: str) -> None:
        self._client.execute(
            f"REPLACE INTO {_TABLE} VALUES ('{escape(key)}', '{escape(val)}')"
        )

    def get_or_put(self, key: str, val: str) -> Optional[str]:
        claimed = self._client.execute(
            f"INSERT IGNORE INTO {_TABLE} VALUES "
            f"('{escape(key)}', '{escape(val)}')"
        )
        if claimed:
            return None
        return self.get(key)

    def get_range(self, begin: str, end: str) -> list[tuple[str, str]]:
        rows = self._client.query(
            f"SELECT k, v FROM {_TABLE} WHERE k>='{escape(begin)}'"
            f" AND k<'{escape(end)}' ORDER BY k"
        )
        return [(r[0], r[1]) for r in rows]

    def close(self) -> None:
        self._client.close()
