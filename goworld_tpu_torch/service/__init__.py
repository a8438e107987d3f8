"""Sharded singleton "service entities" with kvreg-based discovery.

Reference parity: ``engine/service/service.go:65-362`` —

- ``register_service(cls, shard_count)`` registers the entity type and the
  desired shard count (service.go:65-76).
- A reconcile pass (service.go:106-238) runs on deployment-ready, then
  periodically and on every kvreg update: it reads the ``Service/`` keyspace,
  rebuilds the name→[shard eids] map, destroys local service entities that
  lost their registration race, creates entities for shards this game won,
  and registers (with random delay, so games race fairly) any shard nobody
  owns yet. Keys: ``Service/<Name>#<shard>`` → ``game<N>`` claims ownership;
  ``Service/<Name>#<shard>/EntityID`` → the created entity id (force-written).
- Call routing (service.go:258-328): any (random shard), all, by shard index,
  by hashed shard key (``hash_string(key) % shard_count``).
"""

from __future__ import annotations

import random
from typing import Optional, Type

from goworld_tpu_torch import kvreg
from goworld_tpu_torch.common import hash_string
from goworld_tpu_torch.entity import entity_manager
from goworld_tpu_torch.entity.entity import Entity
from goworld_tpu_torch.utils import gwlog

SERVICE_KVREG_PREFIX = "Service/"
SHARD_SEP = "#"  # must not be "/" (service.go:28)
MAX_SHARD_COUNT = 8192
CHECK_INTERVAL = 60.0  # seconds (service.go:23)
CHECK_DELAY_MAX = 0.5  # random delay before a reconcile pass (service.go:26)

_registered: dict[str, int] = {}  # service name → shard count
_service_map: dict[str, list[str]] = {}  # service name → [eid or ""] per shard
_gameid: int = 0
_check_handle = None
_started = False

# Calls issued before the target shard finished registering (cold start,
# post-restore window). The reference drops these with an error log
# (service.go:262-266), which silently breaks anything fired from an early
# OnCreated (e.g. pubsub subscribes — the subscription is then missing for
# the entity's whole life). We queue and replay them on the next reconcile
# instead; undeliverable calls are dropped loudly after a TTL.
PENDING_CALL_TTL = 30.0
PENDING_RETRY_INTERVAL = 0.5
MAX_PENDING_CALLS = 10000
_pending_calls: list = []  # (deadline, label, attempt() -> bool)
_flush_handle = None


def _defer(label: str, attempt) -> None:
    if len(_pending_calls) >= MAX_PENDING_CALLS:
        gwlog.errorf("service: pending-call queue full, dropping %s", label)
        return
    _pending_calls.append(
        (entity_manager.now() + PENDING_CALL_TTL, label, attempt)
    )
    # Reconcile passes flush the queue too, but they stop firing once
    # registration settles (next periodic is up to CHECK_INTERVAL away) —
    # a call deferred after the last kvreg update needs its own retry tick.
    _schedule_flush()


def _schedule_flush() -> None:
    global _flush_handle
    if _flush_handle is not None:
        return

    def fire() -> None:
        global _flush_handle
        _flush_handle = None
        _flush_pending()
        if _pending_calls:
            _schedule_flush()

    _flush_handle = entity_manager.runtime.timer_service.add_callback(
        PENDING_RETRY_INTERVAL, fire
    )


def _flush_pending() -> None:
    global _pending_calls
    if not _pending_calls:
        return
    now = entity_manager.now()
    remaining = []
    for deadline, label, attempt in _pending_calls:
        try:
            if attempt():
                continue
        except Exception:
            gwlog.trace_error("service: pending call %s raised", label)
            continue
        if now >= deadline:
            gwlog.errorf(
                "service: %s undeliverable for %gs, dropped",
                label, PENDING_CALL_TTL,
            )
        else:
            remaining.append((deadline, label, attempt))
    _pending_calls = remaining


def _service_id(name: str, shard: int) -> str:
    return f"{name}{SHARD_SEP}{shard}"


def _split_service_id(sid: str) -> tuple[str, int]:
    name, _, idx = sid.partition(SHARD_SEP)
    return name, int(idx)


def _reg_key(sid: str) -> str:
    return SERVICE_KVREG_PREFIX + sid


def register_service(entity_class: Type[Entity], shard_count: int = 1,
                     typename: Optional[str] = None) -> None:
    """Register a service entity type (service.go:65-76)."""
    if not 1 <= shard_count <= MAX_SHARD_COUNT:
        raise ValueError(f"invalid shard count {shard_count}")
    name = typename or entity_class.__name__
    if SHARD_SEP in name:
        raise ValueError(f"service name must not contain {SHARD_SEP!r}")
    entity_manager.register_entity(entity_class, name)
    _registered[name] = shard_count


def setup(gameid: int) -> None:
    """Wire the reconcile trigger into kvreg updates (service.go:78-81)."""
    global _gameid
    _gameid = gameid
    kvreg.watch(lambda key, val: check_services_later()
                if key.startswith(SERVICE_KVREG_PREFIX) else None)


def on_deployment_ready() -> None:
    """Start periodic reconcile (service.go:83-86)."""
    global _started
    if _started or not _registered:
        return
    _started = True
    entity_manager.runtime.timer_service.add_timer(CHECK_INTERVAL, check_services_later)
    check_services_later()


def check_services_later() -> None:
    """Schedule one reconcile pass after a small random delay, coalescing
    bursts of kvreg updates (service.go:92-102)."""
    global _check_handle
    if _check_handle is not None:
        _check_handle.cancel()

    def fire():
        global _check_handle
        _check_handle = None
        check_services()

    _check_handle = entity_manager.runtime.timer_service.add_callback(
        random.random() * CHECK_DELAY_MAX, fire
    )


def check_services() -> None:
    """One reconcile pass (service.go:106-238)."""
    global _service_map
    if not _registered:
        return
    registered_on_disp: dict[str, dict] = {}  # sid → {"owner": gameid, "eid": str}
    local_sids: set[str] = set()

    for key, val in kvreg.get_all().items():
        if not key.startswith(SERVICE_KVREG_PREFIX):
            continue
        path = key[len(SERVICE_KVREG_PREFIX):].split("/")
        if len(path) == 1:
            sid = path[0]
            info = registered_on_disp.setdefault(sid, {"owner": 0, "eid": ""})
            try:
                info["owner"] = int(val[4:])  # "game<N>"
            except ValueError:
                gwlog.errorf("service: bad owner value %s = %s", key, val)
                continue
            if info["owner"] == _gameid:
                local_sids.add(sid)
        elif len(path) == 2 and path[1] == "EntityID":
            registered_on_disp.setdefault(path[0], {"owner": 0, "eid": ""})["eid"] = val
        else:
            gwlog.errorf("service: unknown kvreg key %s", key)

    # Rebuild the global service map from fully-registered shards.
    new_map: dict[str, list[str]] = {}
    for sid, info in registered_on_disp.items():
        if not info["owner"] or not info["eid"]:
            continue
        name, shard = _split_service_id(sid)
        count = _registered.get(name, 0)
        if shard >= count:
            gwlog.errorf("service: shard index out of range: %s", sid)
            continue
        new_map.setdefault(name, [""] * count)[shard] = info["eid"]
    _service_map = new_map

    # Local service entities that lost the registration race → destroy.
    local_reg_eids = {
        registered_on_disp[sid]["eid"] for sid in local_sids if registered_on_disp[sid]["eid"]
    }
    for name in _registered:
        for e in entity_manager.get_entities_by_type(name):
            if e.id not in local_reg_eids:
                gwlog.warnf("service: destroying unregistered local %s %s", name, e.id)
                e.destroy()

    # Shards this game owns but has not created/announced yet.
    for sid in local_sids:
        eid = registered_on_disp[sid]["eid"]
        if not eid or entity_manager.get_entity(eid) is None:
            _create_service_entity(sid)

    # Shards nobody owns: race to claim them after a random delay.
    for name, count in _registered.items():
        for shard in range(count):
            sid = _service_id(name, shard)
            if registered_on_disp.get(sid, {}).get("owner"):
                continue
            gwlog.infof("service: %s unclaimed, registering", sid)
            entity_manager.runtime.timer_service.add_callback(
                random.random(),
                lambda sid=sid: kvreg.register(_reg_key(sid), f"game{_gameid}", False),
            )

    # Newly-registered shards may unblock queued early calls.
    _flush_pending()


def _create_service_entity(sid: str) -> None:
    name, _shard = _split_service_id(sid)
    e = entity_manager.create_entity_locally(name)
    kvreg.register(_reg_key(sid) + "/EntityID", e.id, True)
    gwlog.infof("service: created service entity %s: %s", sid, e)


# --- call routing (service.go:258-328) ---------------------------------------


def _eids(name: str) -> list[str]:
    return _service_map.get(name, [])


def _try_any(name: str, method: str, args: tuple) -> bool:
    eids = [e for e in _eids(name) if e]
    if not eids:
        return False
    entity_manager.call_entity(random.choice(eids), method, *args)
    return True


def call_service_any(name: str, method: str, *args) -> None:
    if not _try_any(name, method, args):
        _defer(f"any {name}.{method}",
               lambda: _try_any(name, method, args))


def _try_all(name: str, method: str, args: tuple) -> bool:
    # All shards must be live: a partial broadcast would silently skip the
    # still-registering shards, so wait for full readiness instead.
    if not check_service_entities_ready(name):
        return False
    for eid in _eids(name):
        entity_manager.call_entity(eid, method, *args)
    return True


def call_service_all(name: str, method: str, *args) -> None:
    if not _try_all(name, method, args):
        _defer(f"all {name}.{method}",
               lambda: _try_all(name, method, args))


def _try_shard(name: str, shard: int, method: str, args: tuple) -> bool:
    eids = _eids(name)
    if not 0 <= shard < len(eids):
        count = _registered.get(name, 0)
        if not 0 <= shard < count:  # permanently out of range: drop loudly
            gwlog.errorf(
                "call_service_shard %s.%s: bad shard %d", name, method, shard
            )
            return True
        return False
    if not eids[shard]:
        return False
    entity_manager.call_entity(eids[shard], method, *args)
    return True


def call_service_shard_index(name: str, shard: int, method: str, *args) -> None:
    if not _try_shard(name, shard, method, args):
        _defer(f"shard {name}#{shard}.{method}",
               lambda: _try_shard(name, shard, method, args))


def call_service_shard_key(name: str, key: str, method: str, *args) -> None:
    count = _registered.get(name, 0) or len(_eids(name))
    if not count:
        # Service name unknown on this game (not registered here): the shard
        # count is undiscoverable, so defer until the map reveals it.
        def attempt() -> bool:
            eids = _eids(name)
            if not eids:
                return False
            return _try_shard(name, shard_by_key(key, len(eids)), method, args)

        _defer(f"key {name}.{method}", attempt)
        return
    call_service_shard_index(name, shard_by_key(key, count), method, *args)


def shard_by_key(key: str, shard_count: int) -> int:
    return hash_string(key) % shard_count


def get_service_entity_id(name: str, shard: int = 0) -> str:
    eids = _eids(name)
    return eids[shard] if 0 <= shard < len(eids) else ""


def get_service_shard_count(name: str) -> int:
    return _registered.get(name, 0)


def check_service_entities_ready(name: str) -> bool:
    """All shards registered with live entity ids (service.go:340-362)."""
    count = _registered.get(name, 0)
    eids = _eids(name)
    return count > 0 and len(eids) == count and all(eids)


def clear_for_tests() -> None:
    global _service_map, _gameid, _check_handle, _started, _flush_handle
    _registered.clear()
    _service_map = {}
    _pending_calls.clear()
    if _flush_handle is not None:
        _flush_handle.cancel()
    _flush_handle = None
    _gameid = 0
    if _check_handle is not None:
        _check_handle.cancel()
    _check_handle = None
    _started = False
