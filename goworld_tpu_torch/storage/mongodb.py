"""MongoDB entity storage over the in-repo OP_MSG client.

Reference parity: ``engine/storage/backend/mongodb/mongodb.go`` — one
collection per entity type, one document per entity (``_id`` = entity id,
``data`` = the attr document).
"""

from __future__ import annotations

from typing import Optional

from goworld_tpu_torch.netutil.mongo import MongoClient, parse_mongo_url


class MongoEntityStorage:
    def __init__(self, url: str, db: str = "goworld") -> None:
        self._client = MongoClient(**parse_mongo_url(url))
        self._db = db

    def write(self, typename: str, eid: str, data: dict) -> None:
        self._client.upsert(
            self._db, typename, {"_id": eid}, {"_id": eid, "data": data}
        )

    def read(self, typename: str, eid: str) -> Optional[dict]:
        doc = self._client.find_one(self._db, typename, {"_id": eid})
        return None if doc is None else doc.get("data", {})

    def exists(self, typename: str, eid: str) -> bool:
        return self._client.find_one(self._db, typename, {"_id": eid}) is not None

    def list_entity_ids(self, typename: str) -> list[str]:
        docs = self._client.find(self._db, typename, {}, projection={"_id": 1})
        return sorted(d["_id"] for d in docs)

    def close(self) -> None:
        self._client.close()
