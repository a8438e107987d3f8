"""Redis Cluster KVDB backend.

Reference parity:
``engine/kvdb/backend/kvdbrediscluster/kvdb_redis_cluster.go:1`` — same
``_KV_`` namespace and contract as the single-node backend, routed through
the cluster client: get_or_put stays an atomic SETNX on the key's owning
master; get_range scans every master and MGETs per slot group.
"""

from __future__ import annotations

from typing import Optional

from goworld_tpu_torch.kvdb.redis import RedisKVDB
from goworld_tpu_torch.netutil.resp_cluster import RespClusterClient


class RedisClusterKVDB(RedisKVDB):
    """All method bodies inherited — only the client construction differs
    (both clients expose the same get/set/setnx/mget/scan_keys surface)."""

    def __init__(
        self, start_nodes: list[str], password: Optional[str] = None
    ) -> None:
        self._client = RespClusterClient(start_nodes, password=password)
