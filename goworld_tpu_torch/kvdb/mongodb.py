"""MongoDB KVDB backend over the in-repo OP_MSG client.

Reference parity: ``engine/kvdb/backend/kvdb_mongodb.go`` — one ``kvdb``
collection of {_id: key, v: val}; GetRange is an ordered ``_id`` range
query; get_or_put is an insert racing the unique ``_id`` index (duplicate
key = somebody else holds it — the login-claim primitive).
"""

from __future__ import annotations

from typing import Optional

from goworld_tpu_torch.netutil.mongo import (
    DUPLICATE_KEY,
    MongoClient,
    MongoError,
    parse_mongo_url,
)


class MongoKVDB:
    def __init__(self, url: str, db: str = "goworld",
                 collection: str = "kvdb") -> None:
        self._client = MongoClient(**parse_mongo_url(url))
        self._db = db
        self._coll = collection

    def get(self, key: str) -> Optional[str]:
        doc = self._client.find_one(self._db, self._coll, {"_id": key})
        return None if doc is None else doc.get("v")

    def put(self, key: str, val: str) -> None:
        self._client.upsert(
            self._db, self._coll, {"_id": key}, {"_id": key, "v": val}
        )

    def get_or_put(self, key: str, val: str) -> Optional[str]:
        try:
            self._client.insert(self._db, self._coll, [{"_id": key, "v": val}])
            return None
        except MongoError as err:
            if err.code != DUPLICATE_KEY:
                raise
            return self.get(key)

    def get_range(self, begin: str, end: str) -> list[tuple[str, str]]:
        docs = self._client.find(
            self._db, self._coll,
            {"_id": {"$gte": begin, "$lt": end}},
            sort={"_id": 1},
        )
        return [(d["_id"], d.get("v", "")) for d in docs]

    def close(self) -> None:
        self._client.close()
