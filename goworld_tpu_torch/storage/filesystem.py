"""Filesystem entity storage: one JSON file per entity.

Reference parity: ``engine/storage/backend/filesystem/filesystem.go:22-121``
— the simplest durable backend and the de-facto fake DB for local runs.
Layout: ``<dir>/<typename>$<eid>.json`` (reference uses the same flat-dir,
type-prefixed scheme). Writes go through a temp file + rename so a crash
mid-write never leaves a torn entity file.
"""

from __future__ import annotations

import json
import os
from typing import Optional


class FilesystemEntityStorage:
    def __init__(self, directory: str) -> None:
        self.directory = directory
        os.makedirs(directory, exist_ok=True)

    def _path(self, typename: str, eid: str) -> str:
        return os.path.join(self.directory, f"{typename}${eid}.json")

    def write(self, typename: str, eid: str, data: dict) -> None:
        path = self._path(typename, eid)
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(data, f)
        os.replace(tmp, path)

    def read(self, typename: str, eid: str) -> Optional[dict]:
        try:
            with open(self._path(typename, eid), encoding="utf-8") as f:
                return json.load(f)
        except FileNotFoundError:
            return None

    def exists(self, typename: str, eid: str) -> bool:
        return os.path.exists(self._path(typename, eid))

    def list_entity_ids(self, typename: str) -> list[str]:
        prefix = f"{typename}$"
        out = []
        for name in os.listdir(self.directory):
            if name.startswith(prefix) and name.endswith(".json"):
                out.append(name[len(prefix) : -len(".json")])
        return sorted(out)

    def close(self) -> None:
        pass
