"""Filesystem KVDB backend: one JSON file holding the whole map.

The kvdb analog of the reference's filesystem entity storage — a zero-dep
local backend for tests and single-host runs. The map is small (login names,
service registrations); every put rewrites the file atomically.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Optional


class FilesystemKVDB:
    def __init__(self, directory: str, filename: str = "kvdb.json") -> None:
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(directory, filename)
        self._lock = threading.Lock()
        self._data: dict[str, str] = {}
        if os.path.exists(self.path):
            with open(self.path, encoding="utf-8") as f:
                self._data = json.load(f)

    def _flush(self) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(self._data, f)
        os.replace(tmp, self.path)

    def get(self, key: str) -> Optional[str]:
        with self._lock:
            return self._data.get(key)

    def put(self, key: str, val: str) -> None:
        with self._lock:
            self._data[key] = val
            self._flush()

    def get_or_put(self, key: str, val: str) -> Optional[str]:
        with self._lock:
            existing = self._data.get(key)
            if existing is not None:
                return existing
            self._data[key] = val
            self._flush()
            return None

    def get_range(self, begin: str, end: str) -> list[tuple[str, str]]:
        with self._lock:
            return sorted(
                (k, v) for k, v in self._data.items() if begin <= k < end
            )

    def close(self) -> None:
        pass
