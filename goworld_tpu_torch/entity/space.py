"""Spaces: containers of entities with optional AOI.

Reference parity: ``engine/entity/Space.go`` — Space is itself an entity
(Space.go:26-34); enter/leave/move with AOI bookkeeping (Space.go:188-261);
``EnableAOI`` picks the manager (Space.go:105-125); one **nil space** per game
with a deterministic id for cross-game placement and CallNilSpaces broadcast
(space_ops.go:32-46); the persisted ``_EnableAOI`` attr re-enables AOI after
freeze/restore (Space.go:117-125).
"""

from __future__ import annotations

from goworld_tpu_torch.entity.entity import Entity
from goworld_tpu_torch.entity.vector import Vector3
from goworld_tpu_torch.utils import gwlog, gwutils

_ENABLE_AOI_KEY = "_EnableAOI"
SPACE_KIND_NIL = 0


class Space(Entity):
    """Base class for spaces; user spaces subclass this (MySpace etc.)."""

    def __init__(self) -> None:
        super().__init__()
        self.entities: set[Entity] = set()
        self.kind = SPACE_KIND_NIL
        self.aoi_mgr = None
        # Whole-space migration: while frozen, membership is
        # immutable — the freeze-time member list IS the handoff snapshot,
        # so a join landing mid-handoff queues instead of entering (the
        # modelcheck ``no_frozen_join_guard`` mutant shows the alternative:
        # the joiner is absent from the snapshot and destroyed by the pack).
        self.frozen = False
        self._pending_enters: list[tuple[Entity, Vector3]] = []

    # --- lifecycle ---------------------------------------------------------

    def on_space_init(self) -> None:
        pass

    def on_space_created(self) -> None:
        pass

    def on_space_destroy(self) -> None:
        pass

    def on_entity_enter_space(self, entity: Entity) -> None:
        pass

    def on_entity_leave_space(self, entity: Entity) -> None:
        pass

    def on_game_ready(self) -> None:
        """Nil space's on_game_ready is the user code entry point
        (Space.go:324-326)."""

    def on_destroy(self) -> None:
        # Evict remaining entities, then drop the AOI manager.
        for e in list(self.entities):
            self._leave(e)
        if self.aoi_mgr is not None:
            self.aoi_mgr.destroy()
            self.aoi_mgr = None
        gwutils.run_panicless(self.on_space_destroy)
        from goworld_tpu_torch.entity import entity_manager

        entity_manager.on_space_destroyed(self)

    # --- nil space ---------------------------------------------------------

    def is_nil(self) -> bool:
        return self.kind == SPACE_KIND_NIL

    # --- AOI ---------------------------------------------------------------

    def enable_aoi(self, distance: float) -> None:
        """Turn on AOI for this space (Space.go:105-125). Backend comes from
        [aoi] config: xzlist (CPU, synchronous) or the batched engine."""
        if self.aoi_mgr is not None:
            gwlog.errorf("%s: AOI already enabled", self)
            return
        if len(self.entities) > 0:
            # Mirror of the reference's constraint (Space.go:118: panics if
            # entities exist): enabling late would miss existing members.
            raise RuntimeError("enable_aoi must be called before entities enter")
        self.attrs.set(_ENABLE_AOI_KEY, float(distance))
        self._create_aoi_manager(distance)

    def _create_aoi_manager(self, distance: float) -> None:
        from goworld_tpu_torch.entity import entity_manager

        self.aoi_mgr = entity_manager.runtime.new_aoi_manager(distance)

    def _maybe_restore_aoi(self) -> None:
        """Re-enable AOI from the persisted attr after load/restore."""
        dist = self.attrs.get(_ENABLE_AOI_KEY)
        if dist and self.aoi_mgr is None:
            self._create_aoi_manager(float(dist))

    # --- whole-space migration freeze -------------------------------------

    def freeze_space(self) -> None:
        """Pin membership for a whole-space handoff: no entity may enter
        or re-enter until :meth:`unfreeze_space` (abort) or the pack
        destroys the space (commit). Joins queue in ``_pending_enters``."""
        self.frozen = True

    def unfreeze_space(self) -> None:
        """Abort path: unfreeze in place and replay every queued join —
        the space was never in zero places, so the joiners simply enter
        late (bounded by the handoff deadline)."""
        self.frozen = False
        pending, self._pending_enters = self._pending_enters, []
        for entity, pos in pending:
            if not entity.is_destroyed():
                self._enter(entity, pos)

    # --- membership (Space.go:188-261) -------------------------------------

    def _enter(self, entity: Entity, pos: Vector3) -> None:
        if self.is_nil():
            # Entering the nil space is membership by pointer only: no
            # hooks, no AOI, no entities set (Space.go:197-199).
            entity.space = self
            entity.position = pos
            return
        if self.frozen:
            # Mid-handoff join: queue it. unfreeze_space replays (abort);
            # the pack re-dispatches each joiner's enter_space AFTER the
            # SPACE_MIGRATE_DATA on the same dispatcher FIFO (commit), so
            # the re-routed join finds the updated space route.
            self._pending_enters.append((entity, pos))
            return
        entity.space = self
        entity.position = pos
        self.entities.add(entity)
        if self.aoi_mgr is not None and entity.type_desc.use_aoi:
            self.aoi_mgr.enter(entity, pos.x, pos.z)
        gwutils.run_panicless(entity.on_enter_space)
        gwutils.run_panicless(lambda: self.on_entity_enter_space(entity))

    def _leave(self, entity: Entity) -> None:
        if entity.space is not self:
            return
        if self.is_nil():
            return  # leaving the nil space does nothing (Space.go:233-236)
        if self.aoi_mgr is not None and entity.type_desc.use_aoi:
            self.aoi_mgr.leave(entity)
        self.entities.discard(entity)
        # Back to the default membership (Space.go:240 entity.Space = nilSpace).
        from goworld_tpu_torch.entity import entity_manager

        entity.space = entity_manager.get_nil_space()
        gwutils.run_panicless(lambda: entity.on_leave_space(self))
        gwutils.run_panicless(lambda: self.on_entity_leave_space(entity))

    def _move(self, entity: Entity, pos: Vector3) -> None:
        if self.aoi_mgr is not None and entity.type_desc.use_aoi:
            self.aoi_mgr.moved(entity, pos.x, pos.z)

    # --- helpers -----------------------------------------------------------

    def create_entity(self, typename: str, pos: Vector3 | None = None, attrs: dict | None = None):
        """Create an entity directly into this space."""
        from goworld_tpu_torch.entity import entity_manager

        return entity_manager.create_entity_locally(
            typename, attrs=attrs, space=self, pos=pos or Vector3()
        )

    def get_entity_count(self) -> int:
        return len(self.entities)

    def count_entities(self, typename: str) -> int:
        """Number of entities of one type in this space (Space.go CountEntities)."""
        return sum(1 for e in self.entities if e.typename == typename)

    def __repr__(self) -> str:
        return f"Space<{self.typename}|{self.id}|kind={self.kind}>"
