"""Entity persistence: one ordered op queue + one storage worker.

Reference parity: ``engine/storage/storage.go:23-286`` — all storage
operations go through a single serial queue drained by one worker
(storageRoutine), so saves/loads for one entity never race; completion
callbacks are posted back to the main loop. Backend SPI mirrors
``storage_common.go:6-13``: write/read/exists/list.

Resilience deviation (the reference retries a failed save FOREVER at
a fixed 1 s inside the single worker, wedging every other entity's
persistence behind one sick backend): save retries back off exponentially
(``[storage] retry_base_interval`` → ``retry_max_interval``), and a
per-backend **circuit breaker** (storage/circuit.py) opens after
``circuit_failure_threshold`` consecutive failures. While the circuit is
open, saves defer into a byte-capped FIFO (``deferred_bytes_cap``,
drop-oldest, counted on ``storage_dropped_ops_total``) and the worker keeps
serving other ops; after ``circuit_cooldown`` the next save probes the
backend half-open and a success flushes the deferred queue in order.
Observability: ``storage_circuit_state`` (0 closed / 1 open / 2 half-open),
``storage_retries_total``, ``storage_deferred_bytes``.

Backends: filesystem (one JSON file per entity, the reference's de-facto
"fake DB" for local runs, filesystem.go:22-121), sqlite (stdlib), and the
reference's three network backends — redis, mongodb, mysql — over in-repo
wire-protocol clients (netutil/{resp,mongo,mysql}.py; no drivers).
"""

from __future__ import annotations

import collections
import json
import time
from typing import Callable, Deque, Optional

from goworld_tpu_torch import consts, telemetry
from goworld_tpu_torch.storage.circuit import CircuitBreaker
from goworld_tpu_torch.utils import async_jobs, gwlog, opmon, post

_GROUP = "storage"

_backend = None
_breaker = CircuitBreaker(
    failure_threshold=consts.STORAGE_CIRCUIT_FAILURE_THRESHOLD,
    cooldown=consts.STORAGE_CIRCUIT_COOLDOWN,
)
_retry_base = consts.STORAGE_RETRY_BASE_INTERVAL
_retry_max = consts.STORAGE_RETRY_MAX_INTERVAL
_deferred_cap = consts.STORAGE_DEFERRED_BYTES_CAP


class _SaveOp:
    __slots__ = ("typename", "eid", "data", "callback", "nbytes", "trace")

    def __init__(self, typename: str, eid: str, data: dict,
                 callback: Optional[Callable]) -> None:
        self.typename = typename
        self.eid = eid
        self.data = data
        self.callback = callback
        # Sampled TraceContext active when the save was QUEUED (e.g. a
        # traced RPC calling entity.save()): the backend write records a
        # storage.save span under it, even though the write lands later
        # on the worker thread (tracing's ring is thread-safe).
        self.trace = telemetry.tracing.current()
        try:
            self.nbytes = len(json.dumps(data, default=str))
        except Exception:
            self.nbytes = len(repr(data))


# Saves awaiting a closed circuit, oldest first (order matters: a newer
# save of the same entity must never be overwritten by a replayed older
# one, so _run_save flushes this queue before touching a fresh op).
_deferred: Deque[_SaveOp] = collections.deque()
_deferred_bytes = 0

_STATE = telemetry.gauge(
    "storage_circuit_state",
    "Storage circuit breaker: 0=closed 1=open 2=half-open.")
_STATE.set_function(lambda: _breaker.state)
_RETRIES = telemetry.counter(
    "storage_retries_total", "Failed storage save attempts (each retry).")
_DEFERRED_BYTES_G = telemetry.gauge(
    "storage_deferred_bytes",
    "Bytes of save ops deferred while the storage circuit is open.")
_DEFERRED_BYTES_G.set_function(lambda: _deferred_bytes)
_DROPPED_OPS = telemetry.counter(
    "storage_dropped_ops_total",
    "Deferred save ops dropped before reaching the backend.", ("reason",))


def initialize(storage_config) -> None:
    """Create the backend from a StorageConfig (read_config.go [storage])
    and configure the retry/circuit knobs."""
    global _backend, _retry_base, _retry_max, _deferred_cap
    _backend = make_backend(storage_config.type, storage_config)
    _retry_base = getattr(storage_config, "retry_base_interval",
                          consts.STORAGE_RETRY_BASE_INTERVAL)
    _retry_max = getattr(storage_config, "retry_max_interval",
                         consts.STORAGE_RETRY_MAX_INTERVAL)
    _deferred_cap = getattr(storage_config, "deferred_bytes_cap",
                            consts.STORAGE_DEFERRED_BYTES_CAP)
    _breaker.configure(
        getattr(storage_config, "circuit_failure_threshold",
                consts.STORAGE_CIRCUIT_FAILURE_THRESHOLD),
        getattr(storage_config, "circuit_cooldown",
                consts.STORAGE_CIRCUIT_COOLDOWN),
    )
    _breaker.reset()


def make_backend(kind: str, cfg):
    if kind == "filesystem":
        from goworld_tpu_torch.storage.filesystem import FilesystemEntityStorage

        return FilesystemEntityStorage(cfg.directory)
    if kind == "sqlite":
        from goworld_tpu_torch.storage.sqlite import SQLiteEntityStorage

        return SQLiteEntityStorage(cfg.directory)
    if kind == "redis":
        from goworld_tpu_torch.storage.redis import RedisEntityStorage

        return RedisEntityStorage(cfg.url)
    if kind == "redis_cluster":
        from goworld_tpu_torch.storage.redis_cluster import RedisClusterEntityStorage

        return RedisClusterEntityStorage(list(cfg.start_nodes))
    if kind == "mongodb":
        from goworld_tpu_torch.storage.mongodb import MongoEntityStorage

        return MongoEntityStorage(cfg.url, db=getattr(cfg, "db", "goworld"))
    if kind == "mysql":
        from goworld_tpu_torch.storage.mysql import MySQLEntityStorage

        return MySQLEntityStorage(cfg.url)
    raise ValueError(
        f"unknown storage type {kind!r} "
        f"(available: filesystem, sqlite, redis, redis_cluster, mongodb, mysql)"
    )


def set_backend(backend) -> None:
    """Swap the backend (tests / embedded use): a fresh backend means a
    fresh circuit — deferred ops targeting the OLD backend are discarded."""
    global _backend, _deferred_bytes
    _backend = backend
    if _deferred:
        gwlog.warnf("storage: discarding %d deferred save op(s) on backend swap",
                    len(_deferred))
        _deferred.clear()
        _deferred_bytes = 0
    _breaker.reset()


def get_backend():
    return _backend


def initialized() -> bool:
    return _backend is not None


# --- async API (storage.go:66-130) ------------------------------------------


def save(typename: str, eid: str, data: dict, callback: Optional[Callable] = None) -> None:
    """Queue a save. Retries back off up to ``retry_max_interval``; once the
    circuit opens the op defers (byte-capped) instead of blocking the
    worker. ``callback(None, err)`` fires when the write lands (err None)
    or the op is dropped (err set)."""
    op = _SaveOp(typename, eid, data, callback)
    async_jobs.append_job(_GROUP, lambda: _run_save(op), None)


def _run_save(op: _SaveOp) -> None:
    """Worker-thread entry for one save: older deferred ops flush first
    (per-entity write order must hold across circuit transitions)."""
    _flush_deferred()
    if _deferred or not _breaker.allow():
        # Circuit (still) open, or older ops are still queued behind it.
        _defer(op)
        return
    _write_with_retries(op)


def _flush_deferred() -> None:
    while _deferred:
        if not _breaker.allow():
            return
        op = _pop_deferred()
        if not _write_with_retries(op):
            return  # circuit re-opened; op went back to the queue front


def _write_with_retries(op: _SaveOp) -> bool:
    """Attempt the write with capped exponential backoff; K consecutive
    failures open the circuit and park the op at the deferred-queue FRONT
    (it is the oldest unwritten op). Returns True once written."""
    delay = _retry_base
    while True:
        try:
            mon = opmon.Operation("storage.save")
            t0 = time.monotonic()
            _backend.write(op.typename, op.eid, op.data)
            mon.finish(warn_threshold=1.0)  # storage.go:194,234
            if op.trace is not None:
                tr = telemetry.tracing
                tr.record_span(
                    "storage.save", t0, time.monotonic() - t0,
                    op.trace.trace_id, tr.new_span_id(), op.trace.span_id,
                    {"typename": op.typename, "eid": op.eid,
                     "bytes": op.nbytes})
            _breaker.record_success()
            _complete(op, None)
            return True
        except Exception as e:  # noqa: BLE001
            _breaker.record_failure()
            _RETRIES.inc()
            if _breaker.state != CircuitBreaker.CLOSED:
                gwlog.errorf(
                    "storage: save %s.%s failed (%s); circuit OPEN — "
                    "deferring (probe in %.1fs)",
                    op.typename, op.eid, e, _breaker.cooldown)
                _defer(op, front=True)
                return False
            gwlog.errorf("storage: save %s.%s failed (%s); retrying in %.1fs",
                         op.typename, op.eid, e, delay)
            time.sleep(delay)
            delay = min(delay * 2.0, _retry_max)


def _defer(op: _SaveOp, front: bool = False) -> None:
    global _deferred_bytes
    if front:
        _deferred.appendleft(op)
    else:
        _deferred.append(op)
    _deferred_bytes += op.nbytes
    # Drop-OLDEST at the byte cap: the freshest save of an entity is the
    # one worth keeping. (A single op bigger than the whole cap is kept —
    # dropping it could never make room for itself.)
    while _deferred_bytes > _deferred_cap and len(_deferred) > 1:
        old = _pop_deferred()
        _DROPPED_OPS.labels("overflow").inc()
        _complete(old, RuntimeError(
            "storage deferred-queue overflow (circuit open)"))


def _pop_deferred() -> _SaveOp:
    global _deferred_bytes
    op = _deferred.popleft()
    _deferred_bytes -= op.nbytes
    return op


def _complete(op: _SaveOp, err: Optional[BaseException]) -> None:
    if op.callback is not None:
        post.post(lambda cb=op.callback, e=err: cb(None, e))


def _final_flush() -> None:
    """Last-chance drain at process exit (wait_clear): ONE attempt per
    deferred op, no sleeps — a still-dead backend must not stall the
    freeze/terminate path, so the remainder drops (counted, callbacks
    errored) the moment one write fails."""
    while _deferred:
        op = _pop_deferred()
        try:
            _backend.write(op.typename, op.eid, op.data)
            _breaker.record_success()
            _complete(op, None)
        except Exception as e:  # noqa: BLE001
            _breaker.record_failure()
            _DROPPED_OPS.labels("shutdown").inc()
            _complete(op, e)
            while _deferred:
                _DROPPED_OPS.labels("shutdown").inc()
                _complete(_pop_deferred(), e)
            gwlog.errorf(
                "storage: backend still failing at shutdown (%s); deferred "
                "saves dropped (bounded loss — see storage_dropped_ops_total)",
                e)
            return


def load(typename: str, eid: str, callback: Callable) -> None:
    async_jobs.append_job(_GROUP, lambda: _backend.read(typename, eid), _wrap(callback))


def exists(typename: str, eid: str, callback: Callable) -> None:
    async_jobs.append_job(_GROUP, lambda: _backend.exists(typename, eid), _wrap(callback))


def list_entity_ids(typename: str, callback: Callable) -> None:
    async_jobs.append_job(_GROUP, lambda: _backend.list_entity_ids(typename), _wrap(callback))


def _wrap(callback):
    if callback is None:
        return None
    return lambda result, err: callback(result, err)


def deferred_count() -> int:
    """Saves parked behind an open circuit (chaos harness / diagnostics)."""
    return len(_deferred)


def circuit_state() -> int:
    return _breaker.state


def wait_clear(timeout: float = 30.0) -> bool:
    """Drain the op queue (storage.go:118-121). Circuit-deferred saves
    stay deferred — they are waiting on the BACKEND, not the worker; use
    :func:`drain_for_shutdown` on the process-exit path."""
    return async_jobs.wait_clear(timeout)


def drain_for_shutdown(timeout: float = 30.0) -> bool:
    """Terminate path: drain the queue AND give circuit-deferred saves one
    last no-sleep probe each — a healed backend gets the data, a dead one
    drops it (bounded, counted loss) without stalling process exit."""
    if _deferred:
        async_jobs.append_job(_GROUP, _final_flush, None)
    return async_jobs.wait_clear(timeout)


class SyncStorageAdapter:
    """Synchronous facade bound to the module backend; plugs into
    ``entity_manager.Runtime.storage`` for in-process use and tests."""

    def save(self, typename: str, eid: str, data: dict) -> None:
        if _backend is not None:
            _backend.write(typename, eid, data)

    def load(self, typename: str, eid: str) -> Optional[dict]:
        if _backend is None:
            return None
        return _backend.read(typename, eid)

    def exists(self, typename: str, eid: str) -> bool:
        return _backend is not None and _backend.exists(typename, eid)
