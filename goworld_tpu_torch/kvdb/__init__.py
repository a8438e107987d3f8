"""Global key-value store for game logic (e.g. username → avatarID).

Reference parity: ``engine/kvdb/kvdb.go:40-207`` — Get/Put/GetOrPut/GetRange
run on a serial async job group so operations stay ordered; callbacks are
posted back to the main loop; the backend auto-reopens on connection error
(here: backends are local, so reopen reduces to retry-on-error once).

Backend SPI mirrors ``kvdb_types.go:4-25``. Backends: filesystem (JSON file
per key) and sqlite (ordered keys → efficient GetRange).
"""

from __future__ import annotations

from typing import Callable, Optional

from goworld_tpu_torch.utils import async_jobs

_GROUP = "kvdb"
_backend = None


def initialize(kvdb_config) -> None:
    global _backend
    _backend = make_backend(kvdb_config.type, kvdb_config)


def make_backend(kind: str, cfg):
    if kind == "filesystem":
        from goworld_tpu_torch.kvdb.filesystem import FilesystemKVDB

        return FilesystemKVDB(cfg.directory)
    if kind == "sqlite":
        from goworld_tpu_torch.kvdb.sqlite import SQLiteKVDB

        return SQLiteKVDB(cfg.directory)
    if kind == "redis":
        from goworld_tpu_torch.kvdb.redis import RedisKVDB

        return RedisKVDB(cfg.url)
    if kind == "redis_cluster":
        from goworld_tpu_torch.kvdb.redis_cluster import RedisClusterKVDB

        return RedisClusterKVDB(list(cfg.start_nodes))
    if kind == "mongodb":
        from goworld_tpu_torch.kvdb.mongodb import MongoKVDB

        return MongoKVDB(
            cfg.url, db=getattr(cfg, "db", "goworld"),
            collection=getattr(cfg, "collection", "kvdb"),
        )
    if kind == "mysql":
        from goworld_tpu_torch.kvdb.mysql import MySQLKVDB

        return MySQLKVDB(cfg.url)
    raise ValueError(
        f"unknown kvdb type {kind!r} "
        f"(available: filesystem, sqlite, redis, redis_cluster, mongodb, mysql)"
    )


def set_backend(backend) -> None:
    global _backend
    _backend = backend


def initialized() -> bool:
    return _backend is not None


def _submit(routine, callback):
    cb = None if callback is None else (lambda result, err: callback(result, err))
    async_jobs.append_job(_GROUP, routine, cb)


def get(key: str, callback: Callable) -> None:
    """callback(value | None, err) — missing keys yield None (kvdb.go:86-105)."""
    _submit(lambda: _backend.get(key), callback)


def put(key: str, val: str, callback: Optional[Callable] = None) -> None:
    _submit(lambda: _backend.put(key, val), callback)


def get_or_put(key: str, val: str, callback: Callable) -> None:
    """Atomically: return existing value, else set ``val`` and return None
    (kvdb.go:139-152 — the login/claim primitive)."""
    _submit(lambda: _backend.get_or_put(key, val), callback)


def get_range(begin: str, end: str, callback: Callable) -> None:
    """callback(list[(key, value)]) for begin <= key < end (kvdb.go:154-201)."""
    _submit(lambda: _backend.get_range(begin, end), callback)


def wait_clear(timeout: float = 30.0) -> bool:
    return async_jobs.wait_clear(timeout)
