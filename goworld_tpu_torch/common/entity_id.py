"""Entity / client identifier generation.

Reference parity: ``engine/uuid/uuid.go:15-59`` — Mongo-ObjectId-style 12-byte
ids (4B timestamp + 5B machine/pid + 3B counter) encoded with a custom 64-char
alphabet into exactly 16 characters — and ``engine/common/types.go:8-47`` which
defines EntityID/ClientID as 16-char strings.

``gen_fixed_entity_id`` reproduces the deterministic "nil space" id scheme
(reference: engine/entity/space_ops.go:32-46 uses ``GenFixedUUID(gameid)`` so
every process can compute any game's nil-space id without coordination).
"""

from __future__ import annotations

import hashlib
import os
import secrets
import threading
import time

# Type aliases (ids travel as str on the wire, like the reference's string types).
EntityID = str
ClientID = str
GateID = int
GameID = int
DispatcherID = int

ENTITYID_LENGTH = 16
CLIENTID_LENGTH = 16

# 64-char URL-safe alphabet: 12 raw bytes → 16 chars, 6 bits per char.
_ALPHABET = "0123456789abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ-_"

_machine = secrets.token_bytes(3)
_pid = os.getpid() & 0xFFFF
_counter_lock = threading.Lock()
_counter = secrets.randbelow(1 << 24)


def _reseed_after_fork() -> None:
    """Forked children must not replay the parent's id sequence."""
    global _machine, _pid, _counter
    _machine = secrets.token_bytes(3)
    _pid = os.getpid() & 0xFFFF
    _counter = secrets.randbelow(1 << 24)


if hasattr(os, "register_at_fork"):
    os.register_at_fork(after_in_child=_reseed_after_fork)


def _encode12(raw: bytes) -> str:
    """Encode exactly 12 bytes into 16 chars (6 bits each)."""
    assert len(raw) == 12
    n = int.from_bytes(raw, "big")
    out = []
    for shift in range(90, -6, -6):
        out.append(_ALPHABET[(n >> shift) & 0x3F])
    return "".join(out)


def gen_entity_id() -> EntityID:
    """Generate a globally-unique 16-char entity id."""
    global _counter
    with _counter_lock:
        _counter = (_counter + 1) & 0xFFFFFF
        c = _counter
    ts = int(time.time()) & 0xFFFFFFFF
    raw = (
        ts.to_bytes(4, "big")
        + _machine
        + _pid.to_bytes(2, "big")
        + c.to_bytes(3, "big")
    )
    return _encode12(raw)


def gen_client_id() -> ClientID:
    return gen_entity_id()


def gen_fixed_entity_id(key: int | str) -> EntityID:
    """Deterministic 16-char id derived only from ``key``.

    Used for per-game nil spaces so any process can address game N's nil space
    without a lookup (reference: space_ops.go:32-46, uuid.go GenFixedUUID).
    """
    digest = hashlib.sha256(f"goworld_tpu-fixed-{key}".encode()).digest()[:12]
    return _encode12(digest)


def is_entity_id(s: object) -> bool:
    return (
        isinstance(s, str)
        and len(s) == ENTITYID_LENGTH
        and all(ch in _ALPHABET for ch in s)
    )
