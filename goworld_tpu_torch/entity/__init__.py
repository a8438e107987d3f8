"""Entity runtime: Entity/Space lifecycle, nested attrs with client sync,
RPC dispatch, AOI interest management, timers, migration and freeze/restore.

Reference parity: ``engine/entity`` (SURVEY.md §2.1, §2.6).
"""

from goworld_tpu_torch.entity.attrs import MapAttr, ListAttr
from goworld_tpu_torch.entity.columns import ColumnSpec, columnar_tick
from goworld_tpu_torch.entity.entity import Entity
from goworld_tpu_torch.entity.slabs import (
    EntitySlabs,
    SlabTickView,
    vmapped_position_tick,
)
from goworld_tpu_torch.entity.space import Space
from goworld_tpu_torch.entity.vector import Vector3
from goworld_tpu_torch.entity.entity_manager import (
    register_entity,
    register_space,
    create_entity_locally,
    create_entity_somewhere,
    load_entity_locally,
    load_entity_somewhere,
    get_entity,
    get_entities_by_type,
    call_entity,
    call_nil_spaces,
    get_nil_space_id,
    get_nil_space,
    set_save_interval,
    entities,
    cleanup_for_tests,
    collect_entity_sync_infos,
    freeze_entities,
    restore_freezed_entities,
    on_game_ready,
    get_space,
    create_space_locally,
    create_space_somewhere,
    create_nil_space,
)

__all__ = [
    "MapAttr",
    "ListAttr",
    "ColumnSpec",
    "columnar_tick",
    "Entity",
    "EntitySlabs",
    "SlabTickView",
    "vmapped_position_tick",
    "Space",
    "Vector3",
    "register_entity",
    "register_space",
    "create_entity_locally",
    "create_entity_somewhere",
    "load_entity_locally",
    "load_entity_somewhere",
    "get_entity",
    "get_entities_by_type",
    "call_entity",
    "call_nil_spaces",
    "get_nil_space_id",
    "get_nil_space",
    "set_save_interval",
    "entities",
    "cleanup_for_tests",
    "collect_entity_sync_infos",
    "freeze_entities",
    "restore_freezed_entities",
    "on_game_ready",
    "get_space",
    "create_space_locally",
    "create_space_somewhere",
    "create_nil_space",
]
