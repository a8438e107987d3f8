"""MySQL entity storage over the in-repo wire-protocol client.

Reference parity: ``engine/storage/backend/mysql/entity_storage_mysql.go``
— one row per entity in a shared table keyed (typename, eid), JSON data.
"""

from __future__ import annotations

import json
from typing import Optional

from goworld_tpu_torch.netutil.mysql import MySQLClient, escape, parse_mysql_url

_TABLE = "gw_entities"


class MySQLEntityStorage:
    def __init__(self, url: str) -> None:
        self._client = MySQLClient(**parse_mysql_url(url))
        self._client.execute(
            f"CREATE TABLE IF NOT EXISTS {_TABLE} ("
            " typename VARCHAR(64) NOT NULL,"
            " eid CHAR(16) NOT NULL,"
            " data MEDIUMTEXT NOT NULL,"
            " PRIMARY KEY (typename, eid))"
        )

    def write(self, typename: str, eid: str, data: dict) -> None:
        self._client.execute(
            f"REPLACE INTO {_TABLE} VALUES ('{escape(typename)}', "
            f"'{escape(eid)}', '{escape(json.dumps(data))}')"
        )

    def read(self, typename: str, eid: str) -> Optional[dict]:
        rows = self._client.query(
            f"SELECT data FROM {_TABLE} WHERE typename='{escape(typename)}'"
            f" AND eid='{escape(eid)}'"
        )
        return json.loads(rows[0][0]) if rows else None

    def exists(self, typename: str, eid: str) -> bool:
        rows = self._client.query(
            f"SELECT 1 FROM {_TABLE} WHERE typename='{escape(typename)}'"
            f" AND eid='{escape(eid)}'"
        )
        return bool(rows)

    def list_entity_ids(self, typename: str) -> list[str]:
        rows = self._client.query(
            f"SELECT eid FROM {_TABLE} WHERE typename='{escape(typename)}'"
            f" ORDER BY eid"
        )
        return [r[0] for r in rows]

    def close(self) -> None:
        self._client.close()
