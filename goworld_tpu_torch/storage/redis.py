"""Redis entity storage over the in-repo RESP2 client.

Reference parity: ``engine/storage/backend/redis/entity_storage_redis.go``
— entities serialize to one value per key. Key scheme
``gwes:<typename>$<eid>`` (reference uses the same type-prefixed flat
space); values are JSON like the filesystem backend, so entities can be
migrated between backends with a copy loop.
"""

from __future__ import annotations

import json
from typing import Optional

from goworld_tpu_torch.netutil.resp import RespClient, parse_redis_url

_PREFIX = "gwes:"


class RedisEntityStorage:
    def __init__(self, url: str) -> None:
        self._client = RespClient(**parse_redis_url(url))

    @staticmethod
    def _key(typename: str, eid: str) -> str:
        return f"{_PREFIX}{typename}${eid}"

    def write(self, typename: str, eid: str, data: dict) -> None:
        self._client.set(self._key(typename, eid), json.dumps(data))

    def read(self, typename: str, eid: str) -> Optional[dict]:
        raw = self._client.get(self._key(typename, eid))
        return None if raw is None else json.loads(raw)

    def exists(self, typename: str, eid: str) -> bool:
        return self._client.exists(self._key(typename, eid))

    def list_entity_ids(self, typename: str) -> list[str]:
        prefix = f"{_PREFIX}{typename}$"
        keys = self._client.scan_keys(prefix + "*")
        return sorted(k[len(prefix):] for k in keys)

    def close(self) -> None:
        self._client.close()
