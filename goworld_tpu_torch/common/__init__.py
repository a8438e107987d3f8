"""Common identifier types, hashing and small collections.

Reference parity: ``engine/common`` (types.go:8-47, collections.go,
entityid_set.go, hash.go:13-57) and ``engine/uuid`` (uuid.go:15-59).
"""

from goworld_tpu_torch.common.entity_id import (
    ENTITYID_LENGTH,
    CLIENTID_LENGTH,
    EntityID,
    ClientID,
    GateID,
    GameID,
    DispatcherID,
    gen_entity_id,
    gen_client_id,
    gen_fixed_entity_id,
    is_entity_id,
)
from goworld_tpu_torch.common.hashing import hash_string, hash_entity_id

__all__ = [
    "ENTITYID_LENGTH",
    "CLIENTID_LENGTH",
    "EntityID",
    "ClientID",
    "GateID",
    "GameID",
    "DispatcherID",
    "gen_entity_id",
    "gen_client_id",
    "gen_fixed_entity_id",
    "is_entity_id",
    "hash_string",
    "hash_entity_id",
]
