"""The Entity: unit of state, logic, RPC and interest.

Reference parity: ``engine/entity/Entity.go`` — lifecycle hooks
(Entity.go:100-120), attrs with client streaming (Entity.go:814-917), client
ownership (SetClient/GiveClientTo, Entity.go:678-765), AOI interest sets
(Entity.go:227-246), per-entity timers surviving migration
(Entity.go:268-390,637), RPC dispatch with caller-permission flags derived
from the ``_Client``/``_AllClients`` method-name suffixes (rpc_desc.go:8-46,
enforcement Entity.go:483-540), migration pack/unpack (Entity.go:631-651,
956-1115) and position/yaw sync (Entity.go:430-440,1221-1267).
"""

from __future__ import annotations

from typing import Optional

from goworld_tpu_torch import dispatchercluster
from goworld_tpu_torch.entity.attrs import (
    LIST_APPEND,
    LIST_CHANGE,
    LIST_POP,
    MAP_CHANGE,
    MAP_CLEAR,
    MAP_DEL,
    MapAttr,
)
from goworld_tpu_torch.entity.columns import ColumnSpec
from goworld_tpu_torch.entity.game_client import GameClient
# sync-info flags (Entity.go sifSyncOwnClient / sifSyncNeighborClients) —
# defined beside the columnar flag slab they index, re-exported here.
from goworld_tpu_torch.entity.slabs import (
    SIF_SYNC_NEIGHBOR_CLIENTS,
    SIF_SYNC_OWN_CLIENT,
)
from goworld_tpu_torch.entity.vector import Vector3
from goworld_tpu_torch.proto import FilterOp
from goworld_tpu_torch.utils import gwlog, gwutils


class EntityTypeDesc:
    """Declarative per-type attr flags and AOI participation
    (EntityManager.go:24-36,65-101)."""

    def __init__(self, typename: str, entity_class: type) -> None:
        self.typename = typename
        self.entity_class = entity_class
        self.is_space = False
        self.use_aoi = False
        self.aoi_distance = 0.0
        self.client_attrs: set[str] = set()
        self.all_clients_attrs: set[str] = set()
        self.persistent_attrs: set[str] = set()
        # Declared Column attrs (entity/columns.py): numeric attrs whose
        # storage is a slab column instead of the per-entity dict.
        self.column_attrs: dict[str, "ColumnSpec"] = {}

    def set_use_aoi(self, use: bool, distance: float = 100.0) -> None:
        self.use_aoi = use
        self.aoi_distance = distance

    def define_attr(self, name: str, *flags: str,
                    dtype: str = "float32", default: float = 0.0) -> None:
        """Flags: "Client", "AllClients", "Persistent" (attr.go:5-10;
        AllClients implies Client) plus "Column" (entity/columns.py): a
        numeric attr stored in a process-wide slab column — reads/writes
        through ``entity.attrs`` proxy to the column, per-class batched
        tick hooks (``columnar_tick``) vectorize over it, and with
        ``[aoi] fuse_logic`` the batched AOI step updates it on-device.
        ``dtype``/``default`` apply to Column attrs only."""
        for f in flags:
            if f == "Client":
                self.client_attrs.add(name)
            elif f == "AllClients":
                self.client_attrs.add(name)
                self.all_clients_attrs.add(name)
            elif f == "Persistent":
                self.persistent_attrs.add(name)
            elif f == "Column":
                self.column_attrs[name] = ColumnSpec(
                    name, dtype=dtype, default=default)
            else:
                raise ValueError(f"unknown attr flag {f!r}")

    @property
    def is_persistent(self) -> bool:
        return bool(self.persistent_attrs)


class Entity:
    """Base class of all game entities (and, via Space, of spaces)."""

    # Set per-subclass at registration.
    _type_desc: EntityTypeDesc = None  # type: ignore[assignment]

    def __init__(self) -> None:
        # Filled by entity_manager.create; kept minimal here so subclasses
        # never need to call super().__init__ with args.
        # Hot state (position/yaw, sync flags, client binding) lives in the
        # process slab store (entity/slabs.py); this object holds the slot
        # and the descriptors below view the columns.
        from goworld_tpu_torch.entity import entity_manager

        slabs = entity_manager.runtime.slabs
        self._slabs = slabs
        self._slot = slabs.alloc(self)
        self._id: str = ""
        self.attrs: MapAttr = None  # type: ignore[assignment]
        self.space = None  # Optional[Space]
        self._client: Optional[GameClient] = None
        self.interested_in: set[Entity] = set()
        self.interested_by: set[Entity] = set()
        self._destroyed = False
        # Snapshot of (x, y, z, yaw) taken when the slot is released, so
        # post-destroy reads stay valid after the slot is recycled.
        self._final_pos_yaw = (0.0, 0.0, 0.0, 0.0)
        self._timers: dict[int, tuple] = {}  # tid → (handle, interval, method, args)
        self._timer_seq = 0
        self._save_timer = None
        self._enter_space_request: tuple | None = None  # (spaceid, pos, time, nonce)
        self._enter_space_nonce = 0  # per-entity request sequence

    # --- slab-backed hot state (entity/slabs.py) ---------------------------

    @property
    def id(self) -> str:
        return self._id

    @id.setter
    def id(self, value: str) -> None:
        self._id = value
        if self._slot >= 0:
            self._slabs.eid[self._slot] = value.encode("ascii", "replace")
            # The eid column is baked into cached sync selections.
            self._slabs.touch_sync_topology()

    @property
    def position(self) -> Vector3:
        i = self._slot
        if i < 0:
            x, y, z, _ = self._final_pos_yaw
            return Vector3(x, y, z)
        s = self._slabs
        return Vector3(float(s.xz[i, 0]), float(s.y[i]), float(s.xz[i, 1]))

    @position.setter
    def position(self, pos: Vector3) -> None:
        i = self._slot
        if i < 0:
            self._final_pos_yaw = (
                pos.x, pos.y, pos.z, self._final_pos_yaw[3])
            return
        s = self._slabs
        s.xz[i] = (pos.x, pos.z)
        s.y[i] = pos.y
        # Host write fence: an in-flight fused tick must not clobber this
        # (entity/slabs.py fused_dirty; aoi/batched.py _consume_fused).
        s.fused_dirty[i] = True

    @property
    def yaw(self) -> float:
        i = self._slot
        if i < 0:
            return self._final_pos_yaw[3]
        return float(self._slabs.yaw[i])

    @yaw.setter
    def yaw(self, value: float) -> None:
        i = self._slot
        if i < 0:
            x, y, z, _ = self._final_pos_yaw
            self._final_pos_yaw = (x, y, z, value)
            return
        self._slabs.yaw[i] = value
        self._slabs.fused_dirty[i] = True

    @property
    def client(self) -> Optional[GameClient]:
        return self._client

    @client.setter
    def client(self, c: Optional[GameClient]) -> None:
        # Mirrors the binding into the cid/gateid columns so the vectorized
        # sync collect routes (or drops) rows without touching the object.
        self._client = c
        i = self._slot
        if i < 0:
            return
        s = self._slabs
        if c is None:
            s.cid[i] = b""
            s.has_client[i] = False
            s.gateid[i] = 0
        else:
            s.cid[i] = c.clientid.encode("ascii", "replace")
            s.has_client[i] = True
            s.gateid[i] = c.gateid
        s.touch_sync_topology()

    @property
    def _sync_info_flag(self) -> int:
        i = self._slot
        return int(self._slabs.flags[i]) if i >= 0 else 0

    @_sync_info_flag.setter
    def _sync_info_flag(self, value: int) -> None:
        if self._slot >= 0:
            self._slabs.flags[self._slot] = value

    @property
    def _syncing_from_client(self) -> bool:
        i = self._slot
        return bool(self._slabs.syncing[i]) if i >= 0 else False

    @_syncing_from_client.setter
    def _syncing_from_client(self, value: bool) -> None:
        if self._slot >= 0:
            self._slabs.syncing[self._slot] = 1 if value else 0
            self._slabs.touch_sync_topology()

    def _release_slab_slot(self) -> None:
        i = self._slot
        if i < 0:
            return
        s = self._slabs
        self._final_pos_yaw = (
            float(s.xz[i, 0]), float(s.y[i]), float(s.xz[i, 1]),
            float(s.yaw[i]))
        # Column-backed attr roots snapshot their cells the same way the
        # final position is snapshotted, so post-destroy reads stay valid
        # after the slot is recycled (entity/columns.py).
        snap = getattr(self.attrs, "_snapshot_columns", None)
        if snap is not None:
            snap()
        self._slot = -1
        s.release(i, self)

    # --- identity ----------------------------------------------------------

    @property
    def typename(self) -> str:
        return self._type_desc.typename

    @property
    def type_desc(self) -> EntityTypeDesc:
        return self._type_desc

    def is_space_entity(self) -> bool:
        return self._type_desc.is_space

    def is_destroyed(self) -> bool:
        return self._destroyed

    def is_persistent(self) -> bool:
        return self._type_desc.is_persistent

    def __repr__(self) -> str:
        return f"{self.typename}<{self.id}>"

    # --- lifecycle hooks (Entity.go:100-120) -------------------------------

    def on_init(self) -> None:
        pass

    def on_attrs_ready(self) -> None:
        pass

    def on_created(self) -> None:
        pass

    def on_game_ready(self) -> None:
        pass

    def on_destroy(self) -> None:
        pass

    def on_migrate_out(self) -> None:
        pass

    def on_migrate_in(self) -> None:
        pass

    def on_freeze(self) -> None:
        pass

    def on_restored(self) -> None:
        pass

    def on_enter_space(self) -> None:
        pass

    def on_leave_space(self, space) -> None:
        pass

    def on_client_connected(self) -> None:
        pass

    def on_client_disconnected(self) -> None:
        pass

    # --- destroy -----------------------------------------------------------

    def destroy(self) -> None:
        self._destroy(is_migrate=False)

    def _destroy(self, is_migrate: bool) -> None:
        """Entity.go:136-157: leave space, run OnDestroy (unless migrating),
        save persistent state, drop client quietly on migrate."""
        if self._destroyed:
            return
        self._destroyed = True
        if self.space is not None:
            self.space._leave(self)
        if not is_migrate:
            gwutils.run_panicless(self.on_destroy)
            if self.client is not None:
                self.client.send_destroy_entity(self)
                self._set_client_locally(None)
            if self.is_persistent():
                self._save()
        elif self.client is not None:
            # Migrate-out: drop the binding quietly (no client-side destroy;
            # the target game reattaches the same client, Entity.go:1092-1101)
            # but DO release the local clientid→entity ownership mapping.
            self._set_client_locally(None)
        self._cancel_all_timers()
        from goworld_tpu_torch.entity import entity_manager

        entity_manager.on_entity_destroyed(self, is_migrate)
        # Last: release the slab slot (clears flag/client columns so the
        # vectorized sync collect cannot emit for this entity; quarantined
        # while a batched AOI step may still deliver its leave events).
        self._release_slab_slot()

    # --- attrs -------------------------------------------------------------

    def _bind_attrs(self, attrs: MapAttr) -> None:
        self.attrs = attrs
        attrs._owner_cb = self._on_attr_change

    def client_attrs(self) -> dict:
        """Attrs visible to the entity's own client (Client + AllClients)."""
        return self.attrs.to_dict_filtered(self._type_desc.client_attrs)

    def all_client_attrs(self) -> dict:
        """Attrs visible to *other* clients (AllClients only)."""
        return self.attrs.to_dict_filtered(self._type_desc.all_clients_attrs)

    def persistent_attrs(self) -> dict:
        return self.attrs.to_dict_filtered(self._type_desc.persistent_attrs)

    def _on_attr_change(self, kind: str, path: list, *args) -> None:
        """Stream attr mutations to interested clients (Entity.go:814-917).

        The change's top-level key decides visibility: "Client" keys go to the
        own client only; "AllClients" keys also go to every client that has
        this entity in its AOI view.
        """
        desc = self._type_desc
        targets: list[GameClient] = []
        if not path and kind == MAP_CLEAR:
            # Root clear wipes every key: each client mirror holds only its
            # visible subset, so a clear is correct for all of them.
            if desc.client_attrs and self.client is not None:
                targets.append(self.client)
            if desc.all_clients_attrs:
                for other in self.interested_by:
                    if other.client is not None:
                        targets.append(other.client)
            for t in targets:
                self._send_attr_change(t, kind, path, args)
            return
        top = path[0] if path else (args[0] if kind in (MAP_CHANGE, MAP_DEL) else None)
        if top is None:
            return
        if top in desc.client_attrs and self.client is not None:
            targets.append(self.client)
        if top in desc.all_clients_attrs:
            for other in self.interested_by:
                if other.client is not None:
                    targets.append(other.client)
        if not targets:
            return
        for t in targets:
            self._send_attr_change(t, kind, path, args)

    def _send_attr_change(self, t: GameClient, kind: str, path: list, args: tuple) -> None:
        eid = self.id
        if kind == MAP_CHANGE:
            t.send_map_attr_change(eid, path, args[0], args[1])
        elif kind == MAP_DEL:
            t.send_map_attr_del(eid, path, args[0])
        elif kind == MAP_CLEAR:
            t.send_map_attr_clear(eid, path)
        elif kind == LIST_CHANGE:
            t.send_list_attr_change(eid, path, args[0], args[1])
        elif kind == LIST_APPEND:
            t.send_list_attr_append(eid, path, args[0])
        elif kind == LIST_POP:
            t.send_list_attr_pop(eid, path)

    # --- timers (Entity.go:268-390) ----------------------------------------

    def add_callback(self, delay: float, method: str, *args) -> int:
        """One-shot timer calling ``self.<method>(*args)``; survives migration."""
        return self._add_timer(delay, 0.0, method, args)

    def add_timer(self, interval: float, method: str, *args) -> int:
        """Repeating timer; survives migration."""
        return self._add_timer(interval, interval, method, args)

    def _add_timer(self, first_delay: float, repeat: float, method: str, args: tuple) -> int:
        """Repeating timers are one-shot chains: every fire re-arms, so the
        packed remaining-time is always exact for migrate/freeze."""
        if not isinstance(method, str):
            raise TypeError(
                "entity timers take a method NAME so they can migrate "
                "with the entity (Entity.go:268-281)"
            )
        from goworld_tpu_torch.entity import entity_manager

        self._timer_seq += 1
        tid = self._timer_seq
        svc = entity_manager.runtime.timer_service_for(self)
        h = svc.add_callback(first_delay, lambda: self._fire_timer(tid))
        deadline = entity_manager.runtime.now() + first_delay
        self._timers[tid] = (h, repeat, method, args, deadline)
        return tid

    def cancel_timer(self, tid: int) -> None:
        t = self._timers.pop(tid, None)
        if t is not None:
            t[0].cancel()

    def _cancel_all_timers(self) -> None:
        for h, *_ in self._timers.values():
            h.cancel()
        self._timers.clear()
        if self._save_timer is not None:
            self._save_timer.cancel()
            self._save_timer = None

    def _fire_timer(self, tid: int) -> None:
        t = self._timers.get(tid)
        if t is None or self._destroyed:
            return
        _, repeat, method, args, _ = t
        if repeat > 0:
            from goworld_tpu_torch.entity import entity_manager

            svc = entity_manager.runtime.timer_service_for(self)
            h = svc.add_callback(repeat, lambda: self._fire_timer(tid))
            self._timers[tid] = (h, repeat, method, args,
                                 entity_manager.runtime.now() + repeat)
        else:
            self._timers.pop(tid, None)
        fn = getattr(self, method, None)
        if fn is None:
            gwlog.errorf("%s: timer method %s not found", self, method)
            return
        fn(*args)

    def _pack_timers(self) -> list:
        """Serialize timers as (remaining, repeat, method, args) for
        migrate/freeze (Entity.go:637)."""
        from goworld_tpu_torch.entity import entity_manager

        now = entity_manager.runtime.now()
        out = []
        for h, repeat, method, args, deadline in self._timers.values():
            out.append([max(0.0, deadline - now), repeat, method, list(args)])
        return out

    def _restore_timers(self, packed: list) -> None:
        for remaining, repeat, method, args in packed:
            # First fire after the packed remaining time, then the interval.
            self._add_timer(remaining, repeat, method, tuple(args))

    # --- RPC (Entity.go:442-540) -------------------------------------------

    def call(self, eid: str, method: str, *args) -> None:
        """Call a method on any entity anywhere (EntityManager.go:433-446)."""
        from goworld_tpu_torch.entity import entity_manager

        entity_manager.call_entity(eid, method, *args)

    def call_local(self, method: str, args: tuple) -> None:
        fn = getattr(self, method, None)
        if fn is None:
            gwlog.errorf("%s: local call to unknown method %s", self, method)
            return
        gwutils.run_panicless(lambda: fn(*args))

    def on_call_from_remote(self, method: str, args: tuple, from_clientid: str | None) -> None:
        """Dispatch an incoming RPC with permission checks
        (Entity.go:483-540): methods named ``*_Client`` may only be called by
        the entity's own client; ``*_AllClients`` by any client; others only
        server-side (from_clientid None)."""
        if method.startswith("_"):
            gwlog.errorf("%s: refusing RPC to private method %s", self, method)
            return
        fn = getattr(self, method, None)
        if fn is None or not callable(fn) or not _is_rpc_method(type(self), method):
            gwlog.errorf("%s: RPC to unknown method %s", self, method)
            return
        if from_clientid is not None:
            if method.endswith("_Client"):
                if self.client is None or self.client.clientid != from_clientid:
                    gwlog.errorf(
                        "%s: client %s may not call %s (owner only)",
                        self, from_clientid, method,
                    )
                    return
            elif method.endswith("_AllClients"):
                pass
            else:
                gwlog.errorf(
                    "%s: client %s may not call server-only method %s",
                    self, from_clientid, method,
                )
                return
        gwutils.run_panicless(lambda: fn(*args))

    # --- client ownership (Entity.go:678-765) ------------------------------

    def set_client(self, client: Optional[GameClient]) -> None:
        """Attach/detach the entity's client; replays world state to a newly
        attached client: own entity (as player), current space, AOI neighbors."""
        old = self.client
        if old is not None and client is not None and old.clientid == client.clientid:
            return
        if old is not None:
            old.send_destroy_entity(self)
            self._set_client_locally(None)
            gwutils.run_panicless(self.on_client_disconnected)
        if client is not None:
            client.owner_id = self.id
            self._set_client_locally(client)
            client.send_create_entity(self, is_player=True)
            # Replay neighbors to the fresh client (Entity.go:698-718).
            for other in self.interested_in:
                client.send_create_entity(other, is_player=False)
            gwutils.run_panicless(self.on_client_connected)

    def _set_client_locally(self, client: Optional[GameClient]) -> None:
        from goworld_tpu_torch.entity import entity_manager

        if self.client is not None:
            entity_manager.on_client_detached(self.client.clientid, self)
        self.client = client
        if client is not None:
            entity_manager.on_client_attached(client.clientid, self)

    def give_client_to(self, other: "Entity") -> None:
        """Transfer this entity's client to ``other`` (Entity.go:752-765)."""
        client = self.client
        if client is None:
            return
        # Detach quietly: no destroy-entity — the new owner's create replaces
        # the player entity on the client.
        self._set_client_locally(None)
        gwutils.run_panicless(self.on_client_disconnected)
        other.set_client(client)

    def notify_client_disconnected(self) -> None:
        """Called when the gate reports the client's socket died."""
        self._set_client_locally(None)
        gwutils.run_panicless(self.on_client_disconnected)

    # --- client RPC convenience -------------------------------------------

    def call_client(self, method: str, *args) -> None:
        if self.client is not None:
            self.client.call(self.id, method, args)

    def call_all_clients(self, method: str, *args) -> None:
        """Call own client + every client seeing this entity (AllClients RPC)."""
        if self.client is not None:
            self.client.call(self.id, method, args)
        for other in self.interested_by:
            if other.client is not None:
                other.client.call(self.id, method, args)

    def call_filtered_clients(self, key: str, op: str | FilterOp, val: str, method: str, *args) -> None:
        """Broadcast to clients by gate-held filter props (Entity.go:1150-1170).

        Deviation from the reference: routed through exactly ONE dispatcher
        (any dispatcher reaches every gate). The reference broadcasts to all
        dispatchers AND each dispatcher re-broadcasts to all gates
        (dispatchercluster.go:50-62 + DispatcherService.go:846-848), which
        delivers D copies per client in a D-dispatcher deployment.
        """
        ops = {"=": FilterOp.EQ, "!=": FilterOp.NE, "<": FilterOp.LT,
               "<=": FilterOp.LTE, ">": FilterOp.GT, ">=": FilterOp.GTE}
        fop = ops[op] if isinstance(op, str) else op
        dispatchercluster.select_by_entity_id(self.id).send_call_filtered_client_proxies(
            fop, key, val, method, args
        )

    def set_filter_prop(self, key: str, val: str) -> None:
        if self.client is not None:
            self.client.set_filter_prop(key, val)

    # --- AOI interest (Entity.go:227-246) ----------------------------------

    def on_enter_aoi(self, other: "Entity") -> None:
        self.interest(other)

    def on_leave_aoi(self, other: "Entity") -> None:
        self.uninterest(other)

    def on_aoi_batch(self, enters: list, leaves: list) -> None:
        """One batched AOI callback per entity per tick (the vectorized
        delivery path, aoi/batched.py): ``leaves`` then ``enters`` are all
        the neighbors this entity lost/gained this tick, in engine event
        order. The default preserves the per-pair contract exactly —
        leave-before-enter within the tick, per-pair destroyed checks at
        fire time (a hook may destroy entities mid-batch) — so subclasses
        overriding only the per-pair hooks behave identically whether the
        service routes them through here or through the legacy fallback.
        Override THIS hook to consume the whole tick's diff in one call
        (batch client pushes, group spawn logic) without per-pair Python
        dispatch."""
        for other in leaves:
            if self._destroyed:
                return
            self.on_leave_aoi(other)
        for other in enters:
            if self._destroyed:
                return
            if not other.is_destroyed():
                self.on_enter_aoi(other)

    def interest(self, other: "Entity") -> None:
        # Idempotent by design: the batched AOI plane delivers diffs one
        # tick late (aoi/batched.py), so edge races — an entity destroyed
        # inside the window suppresses its enter but its leave still arrives
        # next tick — are reconciled HERE, not in the engine. go-aoi fires
        # exactly-once synchronously and needs no such guard
        # (Entity.go:236-246); our pipelined model does: without it a
        # client receives destroys for entities it never saw (found live by
        # the strict bot fleet).
        if other in self.interested_in:
            return
        self.interested_in.add(other)
        other.interested_by.add(self)
        self._edge_update(other, add=True)
        if self.client is not None:
            gwlog.debugf("%s interest %s -> create on client %s",
                         self, other, self.client)
            self.client.send_create_entity(other, is_player=False)

    def uninterest(self, other: "Entity") -> None:
        if other not in self.interested_in:
            return  # see interest(): leave may arrive without its enter
        self.interested_in.discard(other)
        other.interested_by.discard(self)
        self._edge_update(other, add=False)
        if self.client is not None:
            gwlog.debugf("%s uninterest %s -> destroy on client %s",
                         self, other, self.client)
            self.client.send_destroy_entity(other)

    def is_interested_in(self, other: "Entity") -> bool:
        return other in self.interested_in

    def _edge_update(self, other: "Entity", add: bool) -> None:
        """Mirror the interest relation into the slot-indexed edge table
        the vectorized sync collect reads (subject=other, watcher=self).
        Skipped for cross-store pairs (test harnesses mixing runtimes)."""
        oslot = getattr(other, "_slot", -1)
        if (
            self._slot < 0
            or oslot < 0
            or getattr(other, "_slabs", None) is not self._slabs
        ):
            return
        if add:
            self._slabs.edge_add(oslot, self._slot)
        else:
            self._slabs.edge_remove(oslot, self._slot)

    # --- position / movement (Entity.go:430-440,1189-1205) -----------------

    def distance_to(self, other: "Entity") -> float:
        """Distance to another entity (Entity.go DistanceTo)."""
        return self.position.distance_to(other.position)

    def face_to(self, other: "Entity") -> None:
        """Turn to face another entity (Entity.go FaceTo)."""
        self.set_yaw((other.position - self.position).dir_to_yaw())

    def set_position(self, pos: Vector3) -> None:
        self._set_position_yaw(pos, self.yaw)

    def set_yaw(self, yaw: float) -> None:
        self._set_position_yaw(self.position, yaw)

    def _set_position_yaw(self, pos: Vector3, yaw: float) -> None:
        self.position = pos
        self.yaw = yaw
        if self.space is not None:
            self.space._move(self, pos)
        self._sync_info_flag |= SIF_SYNC_NEIGHBOR_CLIENTS | SIF_SYNC_OWN_CLIENT

    def set_client_syncing(self, syncing: bool) -> None:
        """Allow the entity's client to drive position/yaw (Entity.go:430-440)."""
        self._syncing_from_client = syncing

    def on_sync_position_yaw_from_client(self, x: float, y: float, z: float, yaw: float) -> None:
        if not self._syncing_from_client or self._destroyed:
            return
        self.position = Vector3(x, y, z)
        self.yaw = yaw
        if self.space is not None:
            self.space._move(self, self.position)
        # Own client already knows; only neighbors need the update.
        self._sync_info_flag |= SIF_SYNC_NEIGHBOR_CLIENTS

    # --- space entry / migration (Entity.go:956-1115) ----------------------

    def enter_space(self, spaceid: str, pos: Vector3) -> None:
        """Enter a space: local fast path, else cross-game migration."""
        from goworld_tpu_torch.entity import entity_manager

        if self._enter_space_request is not None:
            # The LATEST enter wins: cancel the pending request and proceed.
            # The reference instead rejects while isEnteringSpace
            # (Entity.go:1000-1004) — safe for it because its bots never
            # race a reload — but an ack lost to a freeze window would then
            # wedge the entity's space-hopping for the whole migrate
            # window. Superseding is protocol-safe here: CANCEL_MIGRATE
            # releases any dispatcher block, and the per-request NONCE
            # guarantees the old request's late acks can't drive the new
            # one into an unblocked migration.
            gwlog.debugf("%s: enter_space supersedes a pending enter", self)
            self.cancel_enter_space()
        space = entity_manager.get_space(spaceid)
        if space is not None:
            entity_manager.runtime.post(lambda: self._enter_local_space(space, pos))
            return
        # Cross-game: ask the dispatcher which game owns the space. Routed by
        # the SPACE id — its dispatch record lives on hash(spaceid)'s
        # dispatcher (reference SelectByEntityID(spaceID), Entity.go:1006-1012).
        self._enter_space_nonce += 1
        nonce = self._enter_space_nonce
        self._enter_space_request = (
            spaceid, pos, entity_manager.runtime.now(), nonce
        )
        dispatchercluster.select_by_entity_id(spaceid).send_query_space_gameid_for_migrate(
            spaceid, self.id, nonce
        )

    def _enter_local_space(self, space, pos: Vector3) -> None:
        if self._destroyed or space.is_destroyed():
            return
        if space is self.space:
            return
        if self.space is not None:
            self.space._leave(self)
        space._enter(self, pos)

    def cancel_enter_space(self) -> None:
        if self._enter_space_request is None:
            return
        self._enter_space_request = None
        dispatchercluster.select_by_entity_id(self.id).send_cancel_migrate(self.id)

    def _enter_space_request_valid(self, spaceid: str, nonce: int) -> bool:
        """Validity checks on migration acks (Entity.go:1026-1058): entity
        destroyed, request superseded, or request timed out → cancel."""
        from goworld_tpu_torch import consts
        from goworld_tpu_torch.entity import entity_manager

        req = self._enter_space_request
        if req is None:
            return False
        rspaceid, _, t0, rnonce = req
        if rspaceid != spaceid or rnonce != nonce:
            # Stale ack for a superseded request — ignore it; the current
            # request stays live. The NONCE check matters even for the same
            # space id: a buffered ack for an expired-and-canceled request
            # must not drive a newer request into REAL_MIGRATE, because the
            # cancel already released the dispatcher's block (the reference
            # compares space ids only, but it also never replaces a pending
            # request before the full migrate window elapses).
            return False
        if self._destroyed:
            self.cancel_enter_space()
            return False
        if entity_manager.runtime.now() - t0 > consts.DISPATCHER_MIGRATE_TIMEOUT:
            gwlog.warnf("%s: enter space %s timed out", self, spaceid)
            self.cancel_enter_space()
            return False
        return True

    def on_query_space_gameid_ack(self, spaceid: str, gameid: int,
                                  nonce: int = 0) -> None:
        """Step 2 of cross-game EnterSpace (Entity.go:1026-1058): the
        dispatcher told us which game owns the target space."""
        from goworld_tpu_torch.entity import entity_manager

        if not self._enter_space_request_valid(spaceid, nonce):
            return
        if gameid == 0:
            gwlog.warnf("%s: space %s not found anywhere", self, spaceid)
            self.cancel_enter_space()
            return
        if gameid == entity_manager.runtime.gameid:
            # The space appeared locally since we asked — fast path after all.
            space = entity_manager.get_space(spaceid)
            if space is None:
                gwlog.warnf("%s: space %s reported local but not found", self, spaceid)
                self.cancel_enter_space()
                return
            _, pos, _, _ = self._enter_space_request
            self._enter_space_request = None
            entity_manager.runtime.post(lambda: self._enter_local_space(space, pos))
            return
        dispatchercluster.select_by_entity_id(self.id).send_migrate_request(
            self.id, spaceid, gameid, nonce
        )

    def on_migrate_request_ack(self, spaceid: str, space_gameid: int,
                               nonce: int = 0) -> None:
        """Step 3: dispatcher blocked our RPC stream; pack and really migrate
        (Entity.go:1092-1101)."""
        from goworld_tpu_torch.entity import entity_manager

        if not self._enter_space_request_valid(spaceid, nonce):
            return
        from goworld_tpu_torch.entity import entity_manager

        _, pos, _, _ = self._enter_space_request
        self._enter_space_request = None
        data = self.get_migrate_data()
        # Rebuild into the *target* space at the requested position; keep
        # the ORIGINAL space so a bounce-home (dead target game) restores
        # the entity where it was, not into the nil space.
        data["prev_space_id"] = data.get("space_id")
        data["space_id"] = spaceid
        data["pos"] = [pos.x, pos.y, pos.z]
        sender = dispatchercluster.select_by_entity_id(self.id)
        gwutils.run_panicless(self.on_migrate_out)
        self._destroy(is_migrate=True)
        sender.send_real_migrate(
            self.id, space_gameid, data,
            source_game=entity_manager.runtime.gameid)

    def get_migrate_data(self) -> dict:
        """Everything needed to rebuild the entity elsewhere
        (Entity.go:631-651): all attrs, client binding, pos/yaw, timers,
        space id, sync flag."""
        client = None
        if self.client is not None:
            client = {"clientid": self.client.clientid,
                      "gateid": self.client.gateid,
                      "gen": self.client.gate_gen}
        return {
            "type": self.typename,
            "attrs": self.attrs.to_dict(),
            "client": client,
            "pos": [self.position.x, self.position.y, self.position.z],
            "yaw": self.yaw,
            "timers": self._pack_timers(),
            "space_id": self.space.id if self.space is not None else None,
            "syncing": self._syncing_from_client,
            # A pending-but-uncollected sync flag travels with the entity:
            # a move flagged just before migrate-out would otherwise be
            # silently dropped with the slab slot (the clients never see
            # the final pre-hop position). restore_entity re-arms it.
            "sync_flag": self._sync_info_flag,
        }

    get_freeze_data = get_migrate_data  # freeze data ≡ migrate data (§5.4)

    # --- persistence (Entity.go:150,215-217) -------------------------------

    def save(self) -> None:
        if self.is_persistent():
            self._save()

    def _save(self) -> None:
        from goworld_tpu_torch.entity import entity_manager

        entity_manager.runtime.save_entity(self.typename, self.id, self.persistent_attrs())

    def _start_save_timer(self, interval: float) -> None:
        from goworld_tpu_torch.entity import entity_manager

        if interval > 0 and self.is_persistent():
            self._save_timer = entity_manager.runtime.timer_service_for(self).add_timer(
                interval, self._on_save_timer
            )

    def _on_save_timer(self) -> None:
        if not self._destroyed:
            self._save()


def _is_rpc_method(cls: type, method: str) -> bool:
    """A method is RPC-exposed iff defined on a subclass of Entity (not on
    Entity/Space base themselves) — the analog of the reference scanning only
    user-defined methods into the rpc table (rpc_desc.go:8-46)."""
    from goworld_tpu_torch.entity.space import Space

    fn = getattr(cls, method, None)
    if fn is None or not callable(fn):
        return False
    for klass in cls.__mro__:
        if method in vars(klass):
            return klass not in (Entity, Space)
    return False
