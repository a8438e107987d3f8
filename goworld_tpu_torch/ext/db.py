"""Async document-DB helpers for game code.

Reference parity: ``ext/db/gwmongo`` + ``ext/db/gwredis`` — thin wrappers
that run driver calls on a dedicated serial async job group and post
callbacks back to the game loop (gwmongo.go:31-346, gwredis.go:16-44).

No DB drivers ship in this image, so all three helpers are real and
driver-free: :class:`DocDB` over sqlite (one table per collection, JSON
documents, indexable id), :class:`GwRedis` over the in-repo RESP2 client
(netutil/resp.py) and :class:`GwMongo` over the in-repo OP_MSG client
(netutil/mongo.py). Every method is fire-and-forget with
``callback(result, err)`` marshalled back to the main loop via the async
job group, matching gwmongo/gwredis call shapes.
"""

from __future__ import annotations

import json
import os
import sqlite3
from typing import Any, Callable, Optional

from goworld_tpu_torch.utils import async_jobs

_ASYNC_JOB_GROUP = "_docdb"

AsyncCallback = Optional[Callable[[Any, Optional[Exception]], None]]


class DocDB:
    """Sqlite-backed document store with gwmongo's async call shape."""

    def __init__(self) -> None:
        self._conn: sqlite3.Connection | None = None
        self._path: str | None = None
        # Per-instance serial worker: one slow scan on this DB must not
        # stall operations on an unrelated DocDB.
        self._group = f"{_ASYNC_JOB_GROUP}:{id(self)}"

    # --- connection (gwmongo.go:31-70) --------------------------------------

    def dial(self, path: str, callback: AsyncCallback = None) -> None:
        def routine():
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._conn = sqlite3.connect(path, check_same_thread=False)
            self._path = path
            return self

        self._submit(routine, callback)

    def close(self, callback: AsyncCallback = None) -> None:
        def routine():
            if self._conn is not None:
                self._conn.close()
                self._conn = None

        self._submit(routine, callback)

    # --- internals ----------------------------------------------------------

    def _submit(self, routine: Callable, callback: AsyncCallback) -> None:
        async_jobs.append_job(self._group, routine, callback)

    def _table(self, collection: str) -> str:
        if not collection.replace("_", "").isalnum():
            raise ValueError(f"bad collection name {collection!r}")
        if self._conn is None:
            raise RuntimeError("not connected (dial first)")
        self._conn.execute(
            f"CREATE TABLE IF NOT EXISTS c_{collection} "
            "(id TEXT PRIMARY KEY, doc TEXT NOT NULL)"
        )
        return f"c_{collection}"

    @staticmethod
    def _matches(doc: dict, query: dict) -> bool:
        return all(doc.get(k) == v for k, v in query.items())

    def _iter_docs(self, collection: str):
        t = self._table(collection)
        for rid, raw in self._conn.execute(f"SELECT id, doc FROM {t}"):
            yield rid, json.loads(raw)

    # --- queries (gwmongo.go:84-146) ----------------------------------------

    def find_id(self, collection: str, doc_id: str, callback: AsyncCallback) -> None:
        def routine():
            t = self._table(collection)
            row = self._conn.execute(
                f"SELECT doc FROM {t} WHERE id=?", (doc_id,)
            ).fetchone()
            return json.loads(row[0]) if row else None

        self._submit(routine, callback)

    def find_one(self, collection: str, query: dict, callback: AsyncCallback) -> None:
        def routine():
            for rid, doc in self._iter_docs(collection):
                if self._matches(doc, query):
                    return {"_id": rid, **doc}
            return None

        self._submit(routine, callback)

    def find_all(self, collection: str, query: dict, callback: AsyncCallback) -> None:
        def routine():
            return [{"_id": rid, **doc} for rid, doc in self._iter_docs(collection)
                    if self._matches(doc, query)]

        self._submit(routine, callback)

    def count(self, collection: str, query: dict, callback: AsyncCallback) -> None:
        def routine():
            return sum(1 for _, doc in self._iter_docs(collection)
                       if self._matches(doc, query))

        self._submit(routine, callback)

    # --- writes (gwmongo.go:148-283) ----------------------------------------

    def insert(self, collection: str, doc_id: str, doc: dict,
               callback: AsyncCallback = None) -> None:
        def routine():
            t = self._table(collection)
            self._conn.execute(
                f"INSERT INTO {t} (id, doc) VALUES (?, ?)", (doc_id, json.dumps(doc))
            )
            self._conn.commit()

        self._submit(routine, callback)

    def upsert_id(self, collection: str, doc_id: str, doc: dict,
                  callback: AsyncCallback = None) -> None:
        def routine():
            t = self._table(collection)
            self._conn.execute(
                f"INSERT INTO {t} (id, doc) VALUES (?, ?) "
                "ON CONFLICT(id) DO UPDATE SET doc=excluded.doc",
                (doc_id, json.dumps(doc)),
            )
            self._conn.commit()

        self._submit(routine, callback)

    def update_id(self, collection: str, doc_id: str, fields: dict,
                  callback: AsyncCallback = None) -> None:
        def routine():
            t = self._table(collection)
            row = self._conn.execute(
                f"SELECT doc FROM {t} WHERE id=?", (doc_id,)
            ).fetchone()
            if row is None:
                raise KeyError(f"{collection}/{doc_id} not found")
            doc = json.loads(row[0])
            doc.update(fields)
            self._conn.execute(
                f"UPDATE {t} SET doc=? WHERE id=?", (json.dumps(doc), doc_id)
            )
            self._conn.commit()

        self._submit(routine, callback)

    def remove_id(self, collection: str, doc_id: str,
                  callback: AsyncCallback = None) -> None:
        def routine():
            t = self._table(collection)
            n = self._conn.execute(f"DELETE FROM {t} WHERE id=?", (doc_id,)).rowcount
            self._conn.commit()
            if n == 0:
                raise KeyError(f"{collection}/{doc_id} not found")

        self._submit(routine, callback)

    def remove_all(self, collection: str, query: dict,
                   callback: AsyncCallback = None) -> None:
        def routine():
            t = self._table(collection)
            removed = 0
            for rid, doc in list(self._iter_docs(collection)):
                if self._matches(doc, query):
                    self._conn.execute(f"DELETE FROM {t} WHERE id=?", (rid,))
                    removed += 1
            self._conn.commit()
            return removed

        self._submit(routine, callback)

    def drop_collection(self, collection: str, callback: AsyncCallback = None) -> None:
        def routine():
            t = self._table(collection)
            self._conn.execute(f"DROP TABLE {t}")
            self._conn.commit()

        self._submit(routine, callback)


class GwMongo:
    """Async mongo helper over the in-repo OP_MSG client (gwmongo.go:31-346
    call shape): every call runs on a serial worker and posts
    ``callback(result, err)`` back to the game loop."""

    def __init__(self, dbname: str) -> None:
        self._client = None
        self._db = dbname
        self._group = f"{_ASYNC_JOB_GROUP}:mongo:{id(self)}"

    def _submit(self, routine: Callable, callback: AsyncCallback) -> None:
        async_jobs.append_job(self._group, routine, callback)

    def dial(self, url: str, callback: AsyncCallback = None) -> None:
        from goworld_tpu_torch.netutil.mongo import MongoClient, parse_mongo_url

        def routine():
            self._client = MongoClient(**parse_mongo_url(url))
            self._client.ping()
            return self

        self._submit(routine, callback)

    def insert(self, coll: str, doc: dict, callback: AsyncCallback = None) -> None:
        self._submit(lambda: self._client.insert(self._db, coll, [doc]), callback)

    def upsert_id(self, coll: str, _id: str, doc: dict,
                  callback: AsyncCallback = None) -> None:
        doc = dict(doc, _id=_id)
        self._submit(
            lambda: self._client.upsert(self._db, coll, {"_id": _id}, doc),
            callback,
        )

    def find_id(self, coll: str, _id: str, callback: AsyncCallback = None) -> None:
        self._submit(
            lambda: self._client.find_one(self._db, coll, {"_id": _id}), callback
        )

    def find_one(self, coll: str, query: dict, callback: AsyncCallback = None) -> None:
        self._submit(
            lambda: self._client.find_one(self._db, coll, query), callback
        )

    def find_all(self, coll: str, query: dict, callback: AsyncCallback = None) -> None:
        self._submit(lambda: self._client.find(self._db, coll, query), callback)

    def remove_id(self, coll: str, _id: str, callback: AsyncCallback = None) -> None:
        self._submit(
            lambda: self._client.delete(self._db, coll, {"_id": _id}), callback
        )

    def command(self, command: dict, callback: AsyncCallback = None) -> None:
        self._submit(lambda: self._client.command(self._db, command), callback)

    def close(self, callback: AsyncCallback = None) -> None:
        def routine():
            if self._client is not None:
                self._client.close()
                self._client = None

        self._submit(routine, callback)


def dial_mongo(url: str, dbname: str, callback: AsyncCallback = None) -> GwMongo:
    """Connect a :class:`GwMongo` (async; callback fires on the game loop
    with (client, err) — gwmongo.go dial shape)."""
    m = GwMongo(dbname)
    m.dial(url, callback)
    return m


class GwRedis:
    """Async redis helper over the in-repo RESP2 client (gwredis.go:16-44):
    every call runs on a serial worker and posts ``callback(result, err)``
    back to the game loop."""

    def __init__(self) -> None:
        self._client = None
        self._group = f"{_ASYNC_JOB_GROUP}:redis:{id(self)}"

    def _submit(self, routine: Callable, callback: AsyncCallback) -> None:
        async_jobs.append_job(self._group, routine, callback)

    def dial(self, url: str, callback: AsyncCallback = None) -> None:
        from goworld_tpu_torch.netutil.resp import RespClient, parse_redis_url

        def routine():
            self._client = RespClient(**parse_redis_url(url))
            self._client.ping()
            return self

        self._submit(routine, callback)

    def command(self, *args, callback: AsyncCallback = None) -> None:
        """Run any redis command (gwredis exposes the raw Do)."""
        self._submit(lambda: self._client.execute(*args), callback)

    def get(self, key: str, callback: AsyncCallback = None) -> None:
        self._submit(lambda: self._client.get(key), callback)

    def set(self, key: str, val: str, callback: AsyncCallback = None) -> None:
        self._submit(lambda: self._client.set(key, val), callback)

    def delete(self, key: str, callback: AsyncCallback = None) -> None:
        self._submit(lambda: self._client.delete(key), callback)

    def close(self, callback: AsyncCallback = None) -> None:
        def routine():
            if self._client is not None:
                self._client.close()
                self._client = None

        self._submit(routine, callback)


def dial_redis(url: str, callback: AsyncCallback = None) -> GwRedis:
    """Connect a :class:`GwRedis` (async; callback fires on the game loop
    with (client, err) — gwredis.go dial shape)."""
    r = GwRedis()
    r.dial(url, callback)
    return r
