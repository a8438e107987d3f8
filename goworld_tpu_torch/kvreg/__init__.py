"""Cluster-wide key-value registry for service discovery.

Reference parity: ``engine/kvreg/kvreg.go:13-58`` — a small map replicated
through the dispatchers: ``register`` routes to the dispatcher selected by
the key (srvid), the dispatcher stores + broadcasts to every game
(DispatcherService.go:734-748), and each game applies the update to its local
map and fires watch callbacks. The full map replays on reconnect inside
SET_GAME_ID_ACK (GameService.go:365-369).
"""

from __future__ import annotations

from typing import Callable, Optional

from goworld_tpu_torch import dispatchercluster

_kvmap: dict[str, str] = {}
_watchers: list[Callable[[str, str], None]] = []


def register(key: str, value: str, force: bool = False) -> None:
    """Claim ``key``; first registration wins unless ``force``
    (kvreg.go:34-46)."""
    dispatchercluster.select_by_srv_id(key).send_kvreg_register(key, value, force)


def get(key: str) -> Optional[str]:
    return _kvmap.get(key)


def get_all() -> dict[str, str]:
    return dict(_kvmap)


def watch(callback: Callable[[str, str], None]) -> None:
    """Subscribe to registry updates; fired for every replicated change."""
    _watchers.append(callback)


def on_registered(key: str, value: str) -> None:
    """Apply one replicated registration (KVREG_REGISTER from a dispatcher).

    An empty value POPS the key (dispatcher game-down purge):
    the service reconcile must see a dead owner's shard as UNCLAIMED —
    storing ``""`` would instead parse as a malformed owner forever."""
    if value == "":
        _kvmap.pop(key, None)
    else:
        _kvmap[key] = value
    for cb in list(_watchers):
        cb(key, value)


def replay(kvmap: dict[str, str]) -> None:
    """Apply the full-map replay carried by SET_GAME_ID_ACK."""
    for key, value in kvmap.items():
        on_registered(key, value)


def clear_for_tests() -> None:
    _kvmap.clear()
    _watchers.clear()
