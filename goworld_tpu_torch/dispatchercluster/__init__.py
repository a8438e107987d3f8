"""Client side of the dispatcher fabric.

Reference parity: ``engine/dispatchercluster`` — every game/gate process keeps
one connection per dispatcher, selects a dispatcher per entity by id-hash
(``hashEntityID % N``, hash.go:7-12 → per-entity FIFO ordering), and fans out
broadcast sends to all dispatchers (dispatchercluster.go:18-137).

Until ``initialize`` runs, all sends are silently dropped — this mirrors the
reference where entity unit tests run without a dispatcher and senders no-op
(SURVEY.md §4.1).
"""

from __future__ import annotations

from typing import Callable, Optional

from goworld_tpu_torch.common import hash_entity_id

_cluster: Optional["DispatcherClusterBase"] = None


class DispatcherClusterBase:
    """Interface of the cluster client (real impl: cluster.ClusterClient)."""

    def select(self, idx: int):  # → GoWorldConnection-like sender
        raise NotImplementedError

    def count(self) -> int:
        raise NotImplementedError

    def flush_all(self) -> None:
        pass


class _NullSender:
    """Swallows every send_* call (disconnected / test mode)."""

    def __getattr__(self, name: str) -> Callable:
        if name.startswith("send_"):
            return lambda *a, **kw: None
        raise AttributeError(name)


_NULL_SENDER = _NullSender()


def set_cluster(cluster: Optional[DispatcherClusterBase]) -> None:
    global _cluster
    _cluster = cluster


def get_cluster() -> Optional[DispatcherClusterBase]:  # gwlint: keep — accessor beside set_cluster/is_connected
    return _cluster


def is_connected() -> bool:
    return _cluster is not None


def select_by_entity_id(eid: str):
    """Route by entity id → the same dispatcher always sees the same entity
    (dispatchercluster.go:116-119)."""
    if _cluster is None:
        return _NULL_SENDER
    return _cluster.select(hash_entity_id(eid) % _cluster.count())


def select_by_gate_id(gateid: int):
    if _cluster is None:
        return _NULL_SENDER
    return _cluster.select(gateid % _cluster.count())


def select_by_srv_id(srvid: str):
    from goworld_tpu_torch.common import hash_string

    if _cluster is None:
        return _NULL_SENDER
    return _cluster.select(hash_string(srvid) % _cluster.count())


def select_all():
    """All dispatcher connections (broadcast fan-out)."""
    if _cluster is None:
        return []
    return [_cluster.select(i) for i in range(_cluster.count())]
