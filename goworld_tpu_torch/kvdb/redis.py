"""Redis KVDB backend over the in-repo RESP2 client.

Reference parity: ``engine/kvdb/backend/kvdb_redis.go:11-69`` — keys carry
a ``_KV_`` namespace prefix; get_or_put is the atomic login-claim
primitive (SETNX); GetRange is a SCAN + sort + MGET, since redis has no
ordered key space (the reference's redis backend shares this shape).
"""

from __future__ import annotations

from typing import Optional

from goworld_tpu_torch.netutil.resp import RespClient, parse_redis_url

_PREFIX = "_KV_"


class RedisKVDB:
    def __init__(self, url: str) -> None:
        self._client = RespClient(**parse_redis_url(url))

    def get(self, key: str) -> Optional[str]:
        return self._client.get(_PREFIX + key)

    def put(self, key: str, val: str) -> None:
        self._client.set(_PREFIX + key, val)

    def get_or_put(self, key: str, val: str) -> Optional[str]:
        # SETNX first: the claim must be atomic under concurrent logins.
        if self._client.setnx(_PREFIX + key, val):
            return None
        return self._client.get(_PREFIX + key)

    def get_range(self, begin: str, end: str) -> list[tuple[str, str]]:
        keys = [
            k[len(_PREFIX):]
            for k in self._client.scan_keys(_PREFIX + "*")
        ]
        keys = sorted(k for k in keys if begin <= k < end)
        vals = self._client.mget([_PREFIX + k for k in keys])
        return [(k, v) for k, v in zip(keys, vals) if v is not None]

    def close(self) -> None:
        self._client.close()
