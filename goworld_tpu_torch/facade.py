"""Public API facade.

Reference parity: ``goworld.go:17-256`` — the single module game developers
import: Run, RegisterEntity/Space/Service, CreateSpace*/CreateEntity*/
LoadEntity*, Call/CallService*/CallNilSpaces, KVDB helpers, timers, crontab.

Symbols are re-exported lazily so that importing ``goworld_tpu_torch`` never drags
in networking or JAX until used.
"""

from __future__ import annotations

from goworld_tpu_torch.common import (  # noqa: F401
    EntityID,
    ClientID,
    gen_entity_id,
    gen_fixed_entity_id,
)

# goworld.go symbol → (module, attr). Names follow the reference's facade
# (snake_cased); each maps to the subsystem that implements it.
_LAZY: dict[str, tuple[str, str]] = {
    # process entry points (goworld.Run → game.Run, goworld.go:34)
    "run": ("goworld_tpu_torch.game", "run"),
    "run_gate": ("goworld_tpu_torch.gate", "run"),
    "run_dispatcher": ("goworld_tpu_torch.dispatcher", "run"),
    # types
    "Entity": ("goworld_tpu_torch.entity.entity", "Entity"),
    "Space": ("goworld_tpu_torch.entity.space", "Space"),
    "Vector3": ("goworld_tpu_torch.entity.vector", "Vector3"),
    "GameClient": ("goworld_tpu_torch.entity.game_client", "GameClient"),
    # registration (goworld.go:44-76)
    "register_entity": ("goworld_tpu_torch.entity.entity_manager", "register_entity"),
    "register_space": ("goworld_tpu_torch.entity.entity_manager", "register_space"),
    "register_service": ("goworld_tpu_torch.service", "register_service"),
    # entity / space creation (goworld.go:78-140)
    "create_entity_locally": ("goworld_tpu_torch.entity.entity_manager", "create_entity_locally"),
    "create_entity_somewhere": ("goworld_tpu_torch.entity.entity_manager", "create_entity_somewhere"),
    "create_space_locally": ("goworld_tpu_torch.entity.entity_manager", "create_space_locally"),
    "create_space_somewhere": ("goworld_tpu_torch.entity.entity_manager", "create_space_somewhere"),
    "load_entity_locally": ("goworld_tpu_torch.entity.entity_manager", "load_entity_locally"),
    "load_entity_somewhere": ("goworld_tpu_torch.entity.entity_manager", "load_entity_somewhere"),
    "get_entity": ("goworld_tpu_torch.entity.entity_manager", "get_entity"),
    "get_space": ("goworld_tpu_torch.entity.entity_manager", "get_space"),
    "get_nil_space": ("goworld_tpu_torch.entity.entity_manager", "get_nil_space"),
    "get_nil_space_id": ("goworld_tpu_torch.entity.entity_manager", "get_nil_space_id"),
    "get_entities_by_type": ("goworld_tpu_torch.entity.entity_manager", "get_entities_by_type"),
    "get_game_id": ("goworld_tpu_torch.entity.entity_manager", "get_game_id"),
    "get_online_games": ("goworld_tpu_torch.entity.entity_manager", "get_online_games"),
    "now": ("goworld_tpu_torch.entity.entity_manager", "now"),
    # RPC (goworld.go:142-178)
    "call_entity": ("goworld_tpu_torch.entity.entity_manager", "call_entity"),
    "call_nil_spaces": ("goworld_tpu_torch.entity.entity_manager", "call_nil_spaces"),
    "call_service_any": ("goworld_tpu_torch.service", "call_service_any"),
    "call_service_all": ("goworld_tpu_torch.service", "call_service_all"),
    "call_service_shard_index": ("goworld_tpu_torch.service", "call_service_shard_index"),
    "call_service_shard_key": ("goworld_tpu_torch.service", "call_service_shard_key"),
    "get_service_entity_id": ("goworld_tpu_torch.service", "get_service_entity_id"),
    "get_service_shard_count": ("goworld_tpu_torch.service", "get_service_shard_count"),
    "check_service_entities_ready": ("goworld_tpu_torch.service", "check_service_entities_ready"),
    # kvdb (goworld.go:200-232)
    "kvdb_get": ("goworld_tpu_torch.kvdb", "get"),
    "kvdb_put": ("goworld_tpu_torch.kvdb", "put"),
    "kvdb_get_or_put": ("goworld_tpu_torch.kvdb", "get_or_put"),
    "kvdb_get_range": ("goworld_tpu_torch.kvdb", "get_range"),
    # kvreg
    "kvreg_register": ("goworld_tpu_torch.kvreg", "register"),
    "kvreg_get": ("goworld_tpu_torch.kvreg", "get"),
    # storage
    "list_entity_ids": ("goworld_tpu_torch.storage", "list_entity_ids"),
    "entity_storage_exists": ("goworld_tpu_torch.storage", "exists"),
    # scheduling (goworld.go:236-256)
    "post": ("goworld_tpu_torch.utils.post", "post"),
    "register_crontab": ("goworld_tpu_torch.utils.crontab", "register"),
    # config
    "get_config": ("goworld_tpu_torch.config", "get"),
    "set_config_file": ("goworld_tpu_torch.config", "set_config_file"),
}

__all__ = [
    "EntityID",
    "ClientID",
    "gen_entity_id",
    "gen_fixed_entity_id",
    *_LAZY,
]


def __getattr__(name: str):
    if name in _LAZY:
        module, attr = _LAZY[name]
        import importlib

        mod = importlib.import_module(module)
        return getattr(mod, attr)
    raise AttributeError(f"module 'goworld_tpu_torch' has no attribute {name!r}")
