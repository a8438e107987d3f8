"""Stable string hashing used for shard routing.

Reference parity: ``engine/common/hash.go:13-57`` (LevelDB-style hash used for
service shard-by-key) and ``engine/dispatchercluster/hash.go:7-12`` (EntityID →
dispatcher routing uses the *last two bytes* of the id so that an entity's
traffic always transits the same dispatcher, giving per-entity FIFO ordering).

Python's builtin ``hash`` is salted per-process, so we implement a fixed FNV-1a
variant: routing decisions must agree across processes.
"""

from __future__ import annotations


def hash_string(s: str) -> int:
    """Deterministic 32-bit hash of a string (FNV-1a)."""
    h = 0x811C9DC5
    for b in s.encode("utf-8"):
        h ^= b
        h = (h * 0x01000193) & 0xFFFFFFFF
    return h


def hash_entity_id(eid: str) -> int:
    """Hash an entity id for dispatcher selection.

    Mirrors the reference's scheme of using the trailing bytes of the id
    (dispatchercluster/hash.go:7-12): ids share a timestamp/machine prefix, so
    the tail carries the entropy.
    """
    tail = eid[-4:]
    h = 0
    for ch in tail:
        h = (h * 64 + ord(ch)) & 0x7FFFFFFF
    return h
