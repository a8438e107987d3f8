"""Redis Cluster entity storage.

Reference parity:
``engine/storage/backend/redis_cluster/entity_storage_redis_cluster.go:1``
— identical contract, key scheme and JSON values as the single-node redis
backend (so either can read the other's data after a migration copy loop),
routed through the cluster client: MOVED/ASK slot redirects per key,
list_entity_ids scans every master.
"""

from __future__ import annotations

from typing import Optional

from goworld_tpu_torch.netutil.resp_cluster import RespClusterClient
from goworld_tpu_torch.storage.redis import RedisEntityStorage


class RedisClusterEntityStorage(RedisEntityStorage):
    """All method bodies inherited — only the client construction differs
    (both clients expose the same get/set/exists/scan_keys surface)."""

    def __init__(
        self, start_nodes: list[str], password: Optional[str] = None
    ) -> None:
        self._client = RespClusterClient(start_nodes, password=password)
