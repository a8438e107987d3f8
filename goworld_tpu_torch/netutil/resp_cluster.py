"""Cluster-aware Redis client over the from-scratch RESP2 client.

Reference parity: the reference ships redis_cluster backends for both
persistence planes via the ``chasex/redis-go-cluster`` driver
(``engine/storage/backend/redis_cluster/entity_storage_redis_cluster.go:1``,
``engine/kvdb/backend/kvdbrediscluster/kvdb_redis_cluster.go:1``); this is
the in-repo equivalent speaking the Redis Cluster protocol directly:

- key → slot via CRC16/XMODEM mod 16384, honoring ``{hash tag}`` sub-keys;
- topology from ``CLUSTER SLOTS`` against any live seed node;
- ``-MOVED <slot> host:port`` → refresh the slot map, retry on the new
  owner (permanent resharding);
- ``-ASK <slot> host:port`` → one-shot redirect preceded by ``ASKING``
  (slot mid-migration; the map is NOT updated);
- multi-key ops split per slot (cluster MGET across slots is CROSSSLOT);
- keyspace scans fan out over every master and merge.

Like RespClient, blocking sockets + a lock: the storage/kvdb job queues are
the concurrency layer (storage/__init__.py), mirroring the reference's
single storageRoutine.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from goworld_tpu_torch.netutil.resp import Reply, RespClient, RespError

SLOTS = 16384

# CRC16/XMODEM (poly 0x1021, init 0) — the Redis Cluster key hash
# (cluster spec "Keys distribution model"). Table-driven, computed once.
_CRC_TABLE = []
for _byte in range(256):
    _crc = _byte << 8
    for _ in range(8):
        _crc = ((_crc << 1) ^ 0x1021) if (_crc & 0x8000) else (_crc << 1)
    _CRC_TABLE.append(_crc & 0xFFFF)


def crc16(data: bytes) -> int:
    crc = 0
    for b in data:
        crc = ((crc << 8) & 0xFFFF) ^ _CRC_TABLE[((crc >> 8) ^ b) & 0xFF]
    return crc


def key_slot(key: str | bytes) -> int:
    """Slot of a key, honoring ``{hash tag}``: when the key contains a
    non-empty brace section, only that section is hashed (lets callers pin
    related keys to one slot)."""
    k = key if isinstance(key, bytes) else key.encode("utf-8")
    start = k.find(b"{")
    if start >= 0:
        end = k.find(b"}", start + 1)
        if end > start + 1:  # non-empty tag only
            k = k[start + 1 : end]
    return crc16(k) % SLOTS


class ClusterDownError(Exception):
    """No seed/known node answered, or redirects did not converge."""


class RespClusterClient:
    """Slot-routed command execution over a pool of RespClients."""

    _MAX_REDIRECTS = 5

    def __init__(
        self,
        start_nodes: list[str],
        password: Optional[str] = None,
        timeout: float = 10.0,
        probe_timeout: Optional[float] = None,
    ) -> None:
        if not start_nodes:
            raise ValueError("redis_cluster requires at least one start node")
        self._seeds = [self._parse_addr(a) for a in start_nodes]
        self._password = password
        self._timeout = timeout
        self._conns: dict[tuple[str, int], RespClient] = {}
        # slot → (host, port) of the owning master; rebuilt on MOVED.
        self._slot_owner: dict[int, tuple[str, int]] = {}
        self._masters: list[tuple[str, int]] = []
        self._lock = threading.Lock()
        # Topology probes use a short timeout and skip recently-dead
        # nodes, so one unreachable master costs at most ~_probe_timeout
        # per refresh instead of the full command timeout per candidate.
        # Scales with the command timeout (slow/cross-region clusters
        # stay reachable) but never exceeds it.
        if probe_timeout is None:
            probe_timeout = max(2.0, timeout * 0.2)
        self._probe_timeout = min(timeout, probe_timeout)
        self._dead_until: dict[tuple[str, int], float] = {}
        self._DEAD_BACKOFF = 5.0

    @staticmethod
    def _parse_addr(addr: str) -> tuple[str, int]:
        host, _, port = addr.rpartition(":")
        return (host or "127.0.0.1", int(port))

    def _conn(self, addr: tuple[str, int]) -> RespClient:
        c = self._conns.get(addr)
        if c is None:
            # db is always 0: Redis Cluster supports only database 0.
            c = RespClient(
                host=addr[0], port=addr[1], db=0,
                password=self._password, timeout=self._timeout,
            )
            self._conns[addr] = c
        return c

    # --- topology -----------------------------------------------------------

    def _refresh_slots(self) -> None:
        """Rebuild the slot map from CLUSTER SLOTS via any live node.

        Probes use ``_probe_timeout`` (not the command timeout) on a
        throwaway connection and skip nodes marked dead within the last
        ``_DEAD_BACKOFF`` seconds, bounding the stall a dead node can
        inject into the refresh sweep."""
        last_err: Exception | None = None
        now = time.monotonic()
        # dict.fromkeys: dedupe (a seed that is also a listed master must
        # not be probed twice per sweep) while preserving masters-first order.
        candidates = list(dict.fromkeys(list(self._masters) + self._seeds))
        dead = {a for a in candidates if self._dead_until.get(a, 0) > now}
        live_first = [a for a in candidates if a not in dead]
        live_first += [a for a in candidates if a in dead]  # last, not never
        for addr in live_first:
            probe = RespClient(
                host=addr[0], port=addr[1], db=0,
                password=self._password, timeout=self._probe_timeout,
            )
            try:
                reply = probe.execute_once("CLUSTER", "SLOTS")
            except (OSError, ConnectionError, RespError) as e:
                self._dead_until[addr] = time.monotonic() + self._DEAD_BACKOFF
                last_err = e
                continue
            finally:
                probe.close()
            owner: dict[int, tuple[str, int]] = {}
            masters: list[tuple[str, int]] = []
            for rng in reply or []:
                start, end = int(rng[0]), int(rng[1])
                master = rng[2]  # [ip, port, id?]
                maddr = (master[0].decode(), int(master[1]))
                if maddr not in masters:
                    masters.append(maddr)
                for slot in range(start, end + 1):
                    owner[slot] = maddr
            if not owner:
                last_err = ClusterDownError(f"{addr}: empty CLUSTER SLOTS")
                continue
            self._slot_owner = owner
            self._masters = masters
            self._dead_until.pop(addr, None)
            return
        raise ClusterDownError(f"no cluster node reachable: {last_err}")

    def _masters_locked(self) -> list[tuple[str, int]]:
        if not self._masters:
            self._refresh_slots()
        return list(self._masters)

    def masters(self) -> list[tuple[str, int]]:
        with self._lock:
            return self._masters_locked()

    # --- command execution --------------------------------------------------

    @staticmethod
    def _parse_redirect(
        msg: str, issuer: tuple[str, int] | None = None
    ) -> tuple[str, tuple[str, int]] | None:
        """``MOVED 3999 127.0.0.1:6381`` / ``ASK ...`` → (kind, addr).

        Redis emits ``MOVED 3999 :6381`` (empty host) when
        cluster-announce-ip is unset; standard cluster-client behavior is
        to reuse the host of the node that issued the redirect."""
        parts = msg.split()
        if len(parts) == 3 and parts[0] in ("MOVED", "ASK"):
            host, _, port = parts[2].rpartition(":")
            if not host and issuer is not None:
                host = issuer[0]
            return parts[0], (host, int(port))
        return None

    def execute(self, *args, key: str | bytes | None = None) -> Reply:
        """Route one command by ``key`` (defaults to args[1]) and follow
        MOVED/ASK redirects, refreshing the slot map on MOVED."""
        if key is None:
            if len(args) < 2:
                raise ValueError("cluster execute needs a routing key")
            key = args[1]
        with self._lock:
            if not self._slot_owner:
                self._refresh_slots()
            addr = self._slot_owner.get(key_slot(key))
            if addr is None:
                self._refresh_slots()
                addr = self._slot_owner.get(key_slot(key))
                if addr is None:
                    raise ClusterDownError(
                        f"slot {key_slot(key)} has no owner"
                    )
            asking = False
            for _ in range(self._MAX_REDIRECTS):
                conn = self._conn(addr)
                try:
                    if asking:
                        conn.execute("ASKING")
                    return conn.execute(*args)
                except RespError as e:
                    redirect = self._parse_redirect(str(e), issuer=addr)
                    if redirect is None:
                        raise
                    kind, addr = redirect
                    if kind == "MOVED":
                        # Permanent move: the whole map is stale.
                        self._refresh_slots()
                        asking = False
                    else:  # ASK: one-shot, no map update
                        asking = True
                except (OSError, ConnectionError):
                    # Node died: re-discover and retry on the new owner.
                    self._dead_until[addr] = (
                        time.monotonic() + self._DEAD_BACKOFF
                    )
                    self._refresh_slots()
                    naddr = self._slot_owner.get(key_slot(key))
                    if naddr is None or naddr == addr:
                        raise
                    addr = naddr
                    asking = False
            raise ClusterDownError(
                f"redirect loop for key {key!r} (> {self._MAX_REDIRECTS})"
            )

    # --- typed helpers (mirror RespClient) ----------------------------------

    def get(self, key: str) -> Optional[str]:
        v = self.execute("GET", key)
        return None if v is None else v.decode("utf-8")

    def set(self, key: str, val: str) -> None:
        self.execute("SET", key, val)

    def setnx(self, key: str, val: str) -> bool:
        return self.execute("SETNX", key, val) == 1

    def delete(self, key: str) -> int:
        return self.execute("DEL", key)

    def exists(self, key: str) -> bool:
        return self.execute("EXISTS", key) == 1

    def mget(self, keys: list[str]) -> list[Optional[str]]:
        """MGET split per slot (CROSSSLOT otherwise), order preserved."""
        if not keys:
            return []
        by_slot: dict[int, list[int]] = {}
        for i, k in enumerate(keys):
            by_slot.setdefault(key_slot(k), []).append(i)
        out: list[Optional[str]] = [None] * len(keys)
        for idxs in by_slot.values():
            vals = self.execute(
                "MGET", *[keys[i] for i in idxs], key=keys[idxs[0]]
            )
            for i, v in zip(idxs, vals):
                out[i] = None if v is None else v.decode("utf-8")
        return out

    def scan_keys(self, pattern: str) -> list[str]:
        """Full SCAN loop on EVERY master, merged (the keyspace is
        partitioned; reference List() runs the same loop through its
        cluster driver)."""
        out: list[str] = []
        with self._lock:
            for addr in self._masters_locked():
                conn = self._conn(addr)
                cursor = "0"
                while True:
                    reply = conn.execute(
                        "SCAN", cursor, "MATCH", pattern, "COUNT", "512"
                    )
                    cursor = reply[0].decode()
                    out.extend(k.decode("utf-8") for k in reply[1])
                    if cursor == "0":
                        break
        return sorted(set(out))

    def ping(self) -> bool:
        with self._lock:
            return all(
                self._conn(a).ping() for a in self._masters_locked()
            )

    def close(self) -> None:
        with self._lock:
            for c in self._conns.values():
                c.close()
            self._conns.clear()
            self._slot_owner.clear()
            self._masters.clear()
