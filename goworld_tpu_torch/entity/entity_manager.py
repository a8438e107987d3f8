"""Entity registration, creation, routing and process-level operations.

Reference parity: ``engine/entity/EntityManager.go`` — type registry with
declarative attr flags (:154-193), createEntity (:233-277), restoreEntity
(:279-339), load-with-persistent-filter (:341-375), Call routing (:433-446),
CallNilSpaces (:448-459), Freeze/RestoreFreezedEntities (:554-656) — plus
``SpaceManager.go`` and the nil-space bookkeeping of ``space_ops.go:32-50``.

The ``Runtime`` object is the seam between pure entity logic and the process
around it (timers, post queue, storage, AOI backend, dispatcher presence); a
default Runtime makes the whole runtime unit-testable in-process, matching
how reference entity tests run without a dispatcher (SURVEY.md §4.1).
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Optional, Type

import numpy as np

from goworld_tpu_torch import consts, dispatchercluster, telemetry
from goworld_tpu_torch.common import gen_entity_id, gen_fixed_entity_id
from goworld_tpu_torch.entity.columns import ColumnBackedMapAttr, make_attr_root
from goworld_tpu_torch.entity.entity import (
    Entity,
    EntityTypeDesc,
)
from goworld_tpu_torch.entity.game_client import GameClient
from goworld_tpu_torch.entity.slabs import EntitySlabs
from goworld_tpu_torch.entity.space import SPACE_KIND_NIL, Space
from goworld_tpu_torch.entity.vector import Vector3
from goworld_tpu_torch.utils import gwlog, gwutils, post as post_mod
from goworld_tpu_torch.utils.timer import TimerService

# Sync fan-out per-hop attribution (shared family with game_pack in
# game/service.py and the dispatcher/gate hops): the game-side half is
# split into collect (flag scan + interest-edge gather over the slabs)
# and pack (per-gate structured-array build + wire bytes) so a fan-out
# regression names the sub-stage (bench.py --fanout hop_shares).
_HOP = telemetry.counter(
    "fanout_hop_seconds_total",
    "Busy wall seconds per sync fan-out hop (game_collect|game_pack|"
    "game_send|dispatcher_route|gate_demux|client_write).",
    ("hop",))
_HOP_COLLECT = _HOP.labels("game_collect")
_HOP_PACK = _HOP.labels("game_pack")

# Host-phase attribution, persist half (the delivery half lives in
# aoi/batched.py — telemetry.counter get-or-creates, so both modules share
# one family): wall seconds spent building freeze/migrate/save snapshots,
# including the columnar batch gather that feeds them.
_PHASE_PERSIST = telemetry.counter(
    "aoi_host_phase_seconds_total",
    "Busy wall seconds per host-side tick phase (delivery|persist).",
    ("phase",)).labels("persist")


class Runtime:
    """Process context for entity logic (see module docstring)."""

    def __init__(self) -> None:
        self.gameid: int = 1
        # Columnar hot-state store (entity/slabs.py): every Entity gets a
        # slot at construction; the batched AOI engine allocates from the
        # SAME slot space.
        self.slabs = EntitySlabs()
        self.timer_service = TimerService()
        self.save_interval: float = 0.0  # 0 = no periodic save (tests)
        self.position_sync_interval: float = consts.POSITION_SYNC_INTERVAL
        self.aoi_backend: str = "xzlist"  # xzlist | batched
        self.aoi_service = None  # BatchAOIService, lazily created
        self.aoi_params = None  # NeighborParams override
        self.aoi_mesh_shards: int = 1  # [aoi] mesh_shards: devices to shard over
        # [aoi] shard_mode: spatial (grid-strip halo exchange) | entity
        # (all-gather rows); only read when mesh_shards > 1.
        self.aoi_shard_mode: str = "spatial"
        # [aoi] strip_placement: topology (AoiZora-style strip→device
        # placement from mesh coords) | ring (mesh order as given).
        self.aoi_strip_placement: str = "topology"
        # [aoi] pallas_strip_cols: static strip-width cap of the Pallas
        # spatial tier's kernel slab (0 = derive: 2x the uniform strip).
        self.aoi_pallas_strip_cols: int = 0
        # [aoi] pallas_inkernel_drain: the Pallas spatial tier's kernel
        # launch emits the compacted event pairs itself (steady strip
        # ticks run no XLA rank-select pass).
        self.aoi_pallas_inkernel_drain: bool = True
        # Multi-process tier: True once this process has joined the
        # torch.distributed group ([aoi] multihost_coordinator; the game
        # service calls init_multihost before building the AOI service).
        self.aoi_multihost: bool = False
        # Device of the batched AOI engines and of the columnar tick
        # programs (entity/columns.py): None means "cuda", which raises
        # where no CUDA device exists; "cpu" runs the plain versions.
        self.aoi_device: Optional[str] = None
        self.aoi_delivery: str = "pipelined"  # [aoi] delivery: pipelined | sync
        # [aoi] fuse_logic: compile per-class columnar tick programs INTO
        # the batched engine's step launch (entity/columns.py; one device
        # launch per steady-state tick).
        self.aoi_fuse_logic: bool = False
        # [aoi] sync_wait_budget: sync-mode stall ceiling before degrading
        # to deferred delivery (batched.py SYNC_WAIT_BUDGET rationale).
        self.aoi_sync_wait_budget: float = 0.5
        self.storage = None  # object with .save/.load/.exists (storage module)
        self.game_service = None  # the running GameService, if any

    def post(self, cb) -> None:
        post_mod.post(cb)

    def now(self) -> float:
        return time.monotonic()

    def timer_service_for(self, entity) -> TimerService:
        return self.timer_service

    # --- AOI backend -------------------------------------------------------

    def logic_device(self):
        """The torch device the runtime's device work runs on: the batched
        AOI service's when one exists, else ``aoi_device`` resolved as the
        service would resolve it."""
        if self.aoi_service is not None:
            return self.aoi_service.device
        import torch

        if self.aoi_device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "the runtime's device work runs on CUDA unless told "
                    "otherwise, and no CUDA device is available; set "
                    "runtime.aoi_device = 'cpu'")
            return torch.device("cuda")
        return torch.device(self.aoi_device)

    def get_aoi_service(self):
        if self.aoi_service is None:
            from goworld_tpu_torch.entity.aoi.batched import BatchAOIService
            from goworld_tpu_torch.ops.neighbor import NeighborParams

            params = self.aoi_params or NeighborParams()
            self.aoi_service = BatchAOIService(
                params, mesh_shards=self.aoi_mesh_shards,
                multihost=self.aoi_multihost,
                shard_mode=self.aoi_shard_mode,
                fuse_logic=self.aoi_fuse_logic,
                strip_placement=self.aoi_strip_placement,
                pallas_strip_cols=self.aoi_pallas_strip_cols,
                pallas_inkernel_drain=self.aoi_pallas_inkernel_drain,
                device=self.aoi_device,
            )
            self.aoi_service.delivery = self.aoi_delivery
            self.aoi_service.sync_wait_budget = self.aoi_sync_wait_budget
        return self.aoi_service

    def new_aoi_manager(self, distance: float):
        if self.aoi_backend == "xzlist":
            from goworld_tpu_torch.entity.aoi.xzlist import XZListAOIManager

            return XZListAOIManager(distance)
        from goworld_tpu_torch.entity.aoi.batched import BatchSpaceAOIManager

        return BatchSpaceAOIManager(self.get_aoi_service(), distance)

    # --- persistence -------------------------------------------------------

    def save_entity(self, typename: str, eid: str, data: dict) -> None:
        if self.storage is not None:
            self.storage.save(typename, eid, data)

    def load_entity(self, typename: str, eid: str) -> Optional[dict]:
        if self.storage is not None:
            return self.storage.load(typename, eid)
        return None

    # --- ticking (tests / embedded) ----------------------------------------

    def tick(self) -> None:
        self.timer_service.tick()
        self.slabs.run_tick_batches(self.now())
        if self.aoi_service is not None:
            self.aoi_service.tick()
        post_mod.tick()


runtime = Runtime()

_registry: dict[str, EntityTypeDesc] = {}
_space_class: Optional[Type[Space]] = None
_entities: dict[str, Entity] = {}
_spaces: dict[str, Space] = {}
_client_owners: dict[str, Entity] = {}
_save_interval_override: Optional[float] = None


# --- registration (EntityManager.go:154-193) --------------------------------


def register_entity(entity_class: Type[Entity], typename: str | None = None) -> EntityTypeDesc:
    name = typename or entity_class.__name__
    if name in _registry:
        raise ValueError(f"entity type {name!r} already registered")
    desc = EntityTypeDesc(name, entity_class)
    desc.is_space = issubclass(entity_class, Space)
    if desc.is_space:
        # AOI enablement must survive storage round-trips (Space.go:117-125).
        desc.define_attr("_EnableAOI", "Persistent")
    describe = getattr(entity_class, "describe_entity_type", None)
    if describe is not None:
        describe(desc)
    entity_class._type_desc = desc
    _registry[name] = desc
    return desc


def register_space(space_class: Type[Space]) -> EntityTypeDesc:
    """Register THE space class of this game (reference RegisterSpace)."""
    global _space_class
    desc = register_entity(space_class)
    _space_class = space_class
    return desc


def get_entity_type_desc(typename: str) -> EntityTypeDesc:
    return _registry[typename]


# --- creation (EntityManager.go:233-277) ------------------------------------


def create_entity_locally(
    typename: str,
    eid: str | None = None,
    attrs: dict | None = None,
    space: Space | None = None,
    pos: Vector3 | None = None,
) -> Entity:
    desc = _registry.get(typename)
    if desc is None:
        raise KeyError(f"entity type {typename!r} not registered")
    if desc.is_space:
        raise TypeError(f"{typename} is a space type; use create_space_locally")
    return _new_entity(desc, eid, attrs, space, pos)


def _new_entity(
    desc: EntityTypeDesc,
    eid: str | None,
    attrs: dict | None,
    space: Space | None,
    pos: Vector3 | None,
    kind: int | None = None,
) -> Entity:
    e = desc.entity_class()
    e.id = eid or gen_entity_id()
    if e.id in _entities:
        raise ValueError(f"entity id {e.id} already exists")
    # Column-declaring types get a column-backed root (entity/columns.py):
    # Column keys proxy to the slab columns, everything else stays dict.
    root = make_attr_root(desc, e)
    e._bind_attrs(root)
    if attrs:
        root.assign(attrs)
    if isinstance(e, Space) and kind is not None:
        e.kind = kind
    _entities[e.id] = e
    if isinstance(e, Space):
        _spaces[e.id] = e
    elif space is None:
        # Default membership: every entity lives in the nil space until it
        # enters a real one (EntityManager.go:250 `entity.Space = nilSpace`;
        # pointer-only, no AOI/entity-set bookkeeping). Without this a
        # freshly loaded Avatar answers GetSpaceID with "" and the Account
        # re-login flow dies on enter_space("").
        e.space = get_nil_space()
    gwutils.run_panicless(e.on_init)
    if isinstance(e, Space):
        e._maybe_restore_aoi()
        gwutils.run_panicless(e.on_space_init)
    gwutils.run_panicless(e.on_attrs_ready)
    # Tell the dispatcher this entity lives here (DispatcherService.go:643-661).
    dispatchercluster.select_by_entity_id(e.id).send_notify_create_entity(e.id)
    interval = _save_interval_override if _save_interval_override is not None else runtime.save_interval
    e._start_save_timer(interval)
    gwutils.run_panicless(e.on_created)
    if isinstance(e, Space):
        gwutils.run_panicless(e.on_space_created)
    if space is not None:
        space._enter(e, pos or Vector3())
    gwlog.debugf("created %r in space %s", e,
                 e.space.id if not isinstance(e, Space) and e.space else "-")
    return e


def create_space_locally(kind: int, eid: str | None = None, attrs: dict | None = None) -> Space:
    if _space_class is None:
        raise RuntimeError("no space class registered (register_space)")
    if kind == SPACE_KIND_NIL:
        raise ValueError("kind 0 is reserved for nil spaces")
    return _new_entity(_space_class._type_desc, eid, attrs, None, None, kind=kind)  # type: ignore[union-attr]


def create_space_somewhere(kind: int) -> None:
    """Ask the dispatcher to create a space on the least-loaded game."""
    if not dispatchercluster.is_connected():
        create_space_locally(kind)
        return
    eid = gen_entity_id()
    dispatchercluster.select_by_entity_id(eid).send_create_entity_somewhere(
        0, _space_class._type_desc.typename, eid, {"_kind": kind}  # type: ignore[union-attr]
    )


def create_nil_space(gameid: int) -> Space:
    """The per-game nil space with deterministic id (space_ops.go:32-46)."""
    if _space_class is None:
        raise RuntimeError("no space class registered (register_space)")
    eid = get_nil_space_id(gameid)
    return _new_entity(_space_class._type_desc, eid, None, None, None, kind=SPACE_KIND_NIL)


def get_nil_space_id(gameid: int) -> str:
    return gen_fixed_entity_id(gameid)


def get_nil_space() -> Optional[Space]:
    return _spaces.get(get_nil_space_id(runtime.gameid))


def get_game_id() -> int:
    """This game process's id (goworld.GetGameID)."""
    return runtime.gameid


def get_online_games() -> set[int]:
    """Ids of the games currently connected to the cluster
    (goworld.GetOnlineGames, fed by NOTIFY_GAME_CONNECTED/DISCONNECTED).
    Embedded/test runtimes without a GameService know only themselves."""
    gs = runtime.game_service
    games = {runtime.gameid}
    if gs is not None:
        games |= set(gs.online_games)
    return games


def now() -> float:
    """Monotonic engine time (drives timers and service bookkeeping)."""
    return runtime.now()


def create_entity_somewhere(typename: str, attrs: dict | None = None, gameid: int = 0) -> str:
    """Create on some game (0 = dispatcher load-balanced choose,
    DispatcherService.go:529-542). Returns the pre-generated entity id."""
    eid = gen_entity_id()
    if not dispatchercluster.is_connected():
        create_entity_locally(typename, eid=eid, attrs=attrs)
        return eid
    dispatchercluster.select_by_entity_id(eid).send_create_entity_somewhere(
        gameid, typename, eid, attrs or {}
    )
    return eid


# --- load from storage (EntityManager.go:341-375) ---------------------------


def load_entity_locally(typename: str, eid: str) -> Optional[Entity]:
    if eid in _entities:
        return _entities[eid]
    data = runtime.load_entity(typename, eid)
    if data is None:
        return None
    desc = _registry[typename]
    persistent = {k: v for k, v in data.items() if k in desc.persistent_attrs}
    return _new_entity(desc, eid, persistent, None, None)


def load_entity_somewhere(typename: str, eid: str, gameid: int = 0) -> None:
    if not dispatchercluster.is_connected():
        load_entity_locally(typename, eid)
        return
    dispatchercluster.select_by_entity_id(eid).send_load_entity_somewhere(
        typename, eid, gameid
    )


# --- lookup / call (EntityManager.go:103-152,433-446) -----------------------


def get_entity(eid: str) -> Optional[Entity]:
    return _entities.get(eid)


def get_space(eid: str) -> Optional[Space]:
    return _spaces.get(eid)


def get_entities_by_type(typename: str) -> list[Entity]:
    return [e for e in _entities.values() if e.typename == typename]


def entities() -> dict[str, Entity]:
    return _entities


def call_entity(eid: str, method: str, *args) -> None:
    """Local direct dispatch, else route via the entity's dispatcher."""
    e = _entities.get(eid)
    if e is not None:
        e.on_call_from_remote(method, args, None)
        return
    dispatchercluster.select_by_entity_id(eid).send_call_entity_method(eid, method, args)


def call_nil_spaces(method: str, *args) -> None:
    """Call a method on every game's nil space (EntityManager.go:448-459)."""
    ns = get_nil_space()
    if ns is not None:
        ns.on_call_from_remote(method, args, None)
    if dispatchercluster.is_connected():
        dispatchercluster.select_by_entity_id(
            get_nil_space_id(runtime.gameid)
        ).send_call_nil_spaces(runtime.gameid, method, args)


def handle_call(eid: str, method: str, args: tuple, clientid: str | None) -> None:
    e = _entities.get(eid)
    if e is None:
        gwlog.warnf("call %s on unknown entity %s (migrated away?)", method, eid)
        return
    e.on_call_from_remote(method, args, clientid)


# --- client bookkeeping ------------------------------------------------------


def on_client_attached(clientid: str, entity: Entity) -> None:
    _client_owners[clientid] = entity


def on_client_detached(clientid: str, entity: Entity) -> None:
    if _client_owners.get(clientid) is entity:
        del _client_owners[clientid]


def get_client_owner(clientid: str) -> Optional[Entity]:
    return _client_owners.get(clientid)


def on_gate_disconnected(gateid: int, valid_gen: int = 0) -> None:
    """Detach the clients of a dead gate (EntityManager.go:145-152).

    ``valid_gen`` != 0: the gate RESTARTED — its clients of other
    generations are dead, but clients that already connected through the
    new process (carrying valid_gen) stay attached. This makes the detach
    broadcast safe under cross-dispatcher reordering: it can arrive after
    the new gate's first clients and still only touch the dead ones."""
    for e in [e for e in _client_owners.values()
              if e.client and e.client.gateid == gateid
              and (valid_gen == 0 or e.client.gate_gen != valid_gen)]:
        e.notify_client_disconnected()


# --- destroy bookkeeping -----------------------------------------------------


def on_entity_destroyed(entity: Entity, is_migrate: bool) -> None:
    _entities.pop(entity.id, None)
    if not is_migrate:
        dispatchercluster.select_by_entity_id(entity.id).send_notify_destroy_entity(
            entity.id
        )


def on_space_destroyed(space: Space) -> None:
    _spaces.pop(space.id, None)


# --- save interval -----------------------------------------------------------


def set_save_interval(interval: float) -> None:
    global _save_interval_override
    _save_interval_override = interval


# --- game-ready --------------------------------------------------------------


def on_game_ready() -> None:
    """Deployment became ready: notify nil space first, then all entities."""
    ns = get_nil_space()
    if ns is not None:
        gwutils.run_panicless(ns.on_game_ready)
    for e in list(_entities.values()):
        if e is not ns:
            gwutils.run_panicless(e.on_game_ready)


# --- position sync collection (Entity.go:1221-1267) --------------------------


def collect_entity_sync_infos() -> dict[int, tuple[bytes, bytes]]:
    """Build the coalesced sync buffers per gate — a (full_records,
    delta_records) pair: full = [clientid(16) + 32B keyframe] blocks,
    delta = [clientid(16) + 24B quantized-delta] blocks (empty under the
    default [sync] config, where this is exactly the legacy full-rate
    path). Pure column ops over the entity slabs: the own-client rows are
    one boolean-mask gather over the flag slab and the neighbor fan-out
    rows come from the slot-indexed interest-edge table gated by each
    pair's cadence tier, so cost scales with flagged rows + DUE edges,
    not entity count x neighbors. Destroyed entities and unbound clients
    are dropped STRUCTURALLY: slot release / client unbind clear the flag
    and cid columns the masks read. Wall time lands on
    fanout_hop_seconds_total{hop=game_collect|game_pack} (the two
    game-side sub-hops of bench.py --fanout's breakdown)."""
    slabs = runtime.slabs
    t0 = time.perf_counter()
    if not slabs.sync.enabled:
        sel = slabs.collect_sync_selection()
        t1 = time.perf_counter()
        _HOP_COLLECT.inc(t1 - t0)
        if sel is None:
            return {}
        out = {
            gateid: (arr.tobytes(), b"")
            for gateid, arr in slabs.pack_sync(sel).items()
        }
        _HOP_PACK.inc(time.perf_counter() - t1)
        return out
    out = slabs.collect_sync_packets()
    _HOP_COLLECT.inc(time.perf_counter() - t0)
    return out


# --- migration receive side (EntityManager.go:279-339) -----------------------


def restore_entity(eid: str, data: dict, is_migrate: bool) -> Entity:
    """Rebuild an entity from migrate/freeze data: struct, attrs, timers,
    client binding, space membership."""
    desc = _registry[data["type"]]
    e = desc.entity_class()
    e.id = eid
    if e.id in _entities:
        raise ValueError(f"restore: entity {eid} already exists")
    # Column attrs travel inside data["attrs"] as plain scalars (they are
    # merged into to_dict by the column-backed root); assign() routes them
    # straight back into the slab columns of the fresh slot.
    root = make_attr_root(desc, e)
    e._bind_attrs(root)
    root.assign(data["attrs"])
    if isinstance(e, Space):
        e.kind = data.get("kind", SPACE_KIND_NIL)
    _entities[e.id] = e
    if isinstance(e, Space):
        _spaces[e.id] = e
    else:
        e.space = get_nil_space()  # default membership, as in _new_entity
    gwutils.run_panicless(e.on_init)
    if isinstance(e, Space):
        e._maybe_restore_aoi()
        gwutils.run_panicless(e.on_space_init)
    gwutils.run_panicless(e.on_attrs_ready)
    if is_migrate:
        dispatchercluster.select_by_entity_id(e.id).send_notify_create_entity(e.id)
    interval = _save_interval_override if _save_interval_override is not None else runtime.save_interval
    e._start_save_timer(interval)
    e._syncing_from_client = data.get("syncing", False)
    e._restore_timers(data.get("timers", []))
    client = data.get("client")
    if client is not None:
        # Reattach quietly: the client already has the entity mirror.
        gc = GameClient(client["clientid"], client["gateid"], e.id,
                        gate_gen=client.get("gen", 0))
        e.client = gc
        on_client_attached(gc.clientid, e)
    pos = data.get("pos") or [0.0, 0.0, 0.0]
    e.position = Vector3(*pos)
    e.yaw = data.get("yaw", 0.0)
    # Re-arm a sync flag that was pending at pack time (see
    # get_migrate_data): the next collect delivers the position the old
    # game never got to send.
    flag = data.get("sync_flag", 0)
    if flag:
        e._sync_info_flag = flag
    spaceid = data.get("space_id")
    if spaceid:
        space = _spaces.get(spaceid)
        if space is None:
            # Bounce-home rollback: the payload names the TARGET space,
            # which only exists on the (dead) target game — fall back to
            # the space the entity was packed out of, so a rolled-back
            # migration puts it exactly where it was.
            space = _spaces.get(data.get("prev_space_id") or "")
        if space is not None:
            space._enter(e, e.position)
    if is_migrate:
        gwutils.run_panicless(e.on_migrate_in)
    else:
        gwutils.run_panicless(e.on_restored)
    return e


# --- whole-space migration (no reference analog) ------------------------------


def pack_space(space: Space) -> tuple[dict, list]:
    """Pack a FROZEN space and every member into one transferable bundle
    and destroy the local copies (migrate semantics: no on_destroy hooks,
    no NOTIFY_DESTROY — the receiver's restore re-announces everything).

    Returns ``(bundle, queued_joins)``: the bundle is the one
    SPACE_MIGRATE_DATA payload; ``queued_joins`` are the (entity, pos)
    pairs that tried to enter while frozen — the caller re-dispatches each
    via ``enter_space`` AFTER sending the bundle, so the re-routed join
    rides the same dispatcher FIFO behind the data and finds the updated
    space route. Membership is frozen, so every packed member is in the
    PREPARE-time member list whose streams the dispatchers parked — no
    member can slip into the snapshot unparked."""
    if not space.frozen:
        raise ValueError(f"pack_space: space {space.id} is not frozen")
    members: dict[str, dict] = {}
    # Deterministic order (by id): restore replays in sorted order too,
    # so donor-side pack and receiver-side restore walk the same sequence.
    # on_migrate_out hooks run BEFORE the primed window — they may mutate
    # column attrs, which the batch gather must see.
    ordered = sorted(space.entities, key=lambda e: e.id)
    for e in ordered:
        gwutils.run_panicless(e.on_migrate_out)
    with primed_column_snapshot(ordered):
        for e in ordered:
            members[e.id] = e.get_migrate_data()
    sdata = space.get_migrate_data()
    sdata["kind"] = space.kind
    bundle = {"space": sdata, "members": members}
    queued = list(space._pending_enters)
    space._pending_enters = []
    # The migrate-destroy's release-time column snapshot (_snapshot_columns)
    # walks every declared column per entity — ride one primed gather too.
    with primed_column_snapshot(ordered):
        for e in ordered:
            e._destroy(is_migrate=True)
    space._destroy(is_migrate=True)
    # Migrate-destroy skips on_destroy (user hooks must not fire for a
    # move), which is also where a space normally drops its AOI manager
    # and its _spaces index entry — do both explicitly.
    if space.aoi_mgr is not None:
        space.aoi_mgr.destroy()
        space.aoi_mgr = None
    _spaces.pop(space.id, None)
    return bundle, queued


def restore_space_bundle(spaceid: str, bundle: dict) -> Space:
    """Receiver side of SPACE_MIGRATE_DATA (and the donor's bounce-home
    rollback): restore the space FIRST — its NOTIFY_CREATE re-routes the
    space id — then every member (whose ``space_id`` now resolves locally;
    each member's NOTIFY_CREATE re-routes its eid and flushes the packets
    its dispatcher parked at PREPARE)."""
    sdata = bundle["space"]
    space = restore_entity(spaceid, sdata, is_migrate=True)
    if not isinstance(space, Space):
        raise ValueError(
            f"restore_space_bundle: {spaceid} restored as "
            f"{type(space).__name__}, expected a Space")
    for eid in sorted(bundle.get("members", {})):
        restore_entity(eid, bundle["members"][eid], is_migrate=True)
    return space


# --- columnar batch persistence ---------------------------------------------


def _gather_column(spec, arr, n_slots, slots):
    """O(entities) core of the columnar snapshot gather (gwlint R2 hot
    path — loop-free by design; the per-entity cache stitch stays in
    ``primed_column_snapshot``, outside the guarded set, because it is
    plain dict stores): one fancy-index + bulk ``tolist`` per (type,
    column). ``ndarray.tolist()`` performs the identical numpy→Python
    widening as ``ColumnSpec.to_python`` for every allowed column dtype,
    so the gathered values are bit-identical to the per-entity slab-read
    walk they replace."""
    if arr is None:  # column never materialized: default everywhere
        return [spec.to_python(spec.default)] * n_slots
    return arr[slots].tolist()


@contextmanager
def primed_column_snapshot(entities):
    """Columnar batch persistence: pre-gather every declared Column attr
    for *entities* with ONE fancy-index gather per (entity type, column)
    and prime each entity's attr root, so the per-entity snapshot walk
    inside the ``with`` block (``get_freeze_data`` / ``get_migrate_data``
    / ``persistent_attrs``) reads the pre-gathered plain-Python cache
    instead of one slab-row read + scalar conversion per entity per key.

    Exactness: ``ndarray.tolist()`` performs the identical numpy→Python
    widening as ``ColumnSpec.to_python`` for every allowed column dtype,
    so the produced blobs are bit-identical to the unprimed walk
    (asserted by tests/test_columns.py and the chaos freeze→restore
    scenario). Entities without Column attrs, or whose slot is already
    released (reads fall back to the release-time ``_final`` snapshot),
    pass through untouched; a host write inside the window invalidates
    that key's primed value (columns.py ``_col_set``), so overridden
    snapshot hooks that mutate state stay correct.

    The whole window — gather plus the caller's walk — lands on
    ``aoi_host_phase_seconds_total{phase=persist}``."""
    t0 = time.perf_counter()
    by_type: dict[int, list] = {}
    for e in entities:
        root = getattr(e, "attrs", None)
        if isinstance(root, ColumnBackedMapAttr) and e._slot >= 0:
            by_type.setdefault(id(root._colspecs), []).append(e)
    primed: list[ColumnBackedMapAttr] = []
    for ents in by_type.values():
        colspecs = ents[0].attrs._colspecs
        columns = ents[0].attrs._slabs.columns
        slots = np.fromiter((e._slot for e in ents), np.int64, len(ents))
        caches: list[dict] = [{} for _ in ents]
        for name, spec in colspecs.items():
            vals = _gather_column(spec, columns.get(name), len(ents), slots)
            for cache, v in zip(caches, vals):
                cache[name] = v
        for e, cache in zip(ents, caches):
            e.attrs.prime_columns(cache)
            primed.append(e.attrs)
    try:
        yield
    finally:
        for root in primed:
            root.unprime_columns()
        _PHASE_PERSIST.inc(time.perf_counter() - t0)


def save_entities_batch(entities=None) -> int:
    """Save every persistent entity (default: all live entities) through
    one primed-column snapshot round — the bulk analog of ``Entity.save``
    for terminate/checkpoint sweeps. Returns the number saved."""
    if entities is None:
        entities = list(_entities.values())
    saved = 0
    with primed_column_snapshot(entities):
        for e in entities:
            if e.is_persistent() and not e.is_destroyed():
                gwutils.run_panicless(e.save)
                saved += 1
    return saved


# --- freeze / restore (EntityManager.go:554-656) -----------------------------


def freeze_entities(gameid: int) -> dict:
    """Pack every entity for process freeze. Requires exactly one nil space
    (EntityManager.go:578-584)."""
    nil_id = get_nil_space_id(gameid)
    if nil_id not in _spaces:
        raise RuntimeError("freeze requires the nil space to exist")
    frozen_spaces: dict[str, dict] = {}
    frozen_entities: dict[str, dict] = {}
    # on_freeze hooks run OUTSIDE the primed window: they may mutate column
    # attrs, and the batch gather must see those writes.
    for e in _entities.values():
        gwutils.run_panicless(e.on_freeze)
    with primed_column_snapshot(_entities.values()):
        for e in _entities.values():
            data = e.get_freeze_data()
            if isinstance(e, Space):
                data["kind"] = e.kind
                frozen_spaces[e.id] = data
            else:
                frozen_entities[e.id] = data
    return {
        "gameid": gameid,
        "nil_space_id": nil_id,
        "spaces": frozen_spaces,
        "entities": frozen_entities,
    }


def restore_freezed_entities(data: dict) -> None:
    """3-pass restore: nil space → other spaces → entities
    (EntityManager.go:630-643)."""
    nil_id = data["nil_space_id"]
    spaces = data["spaces"]
    if nil_id in spaces:
        restore_entity(nil_id, spaces[nil_id], is_migrate=False)
    for sid, sdata in spaces.items():
        if sid != nil_id:
            restore_entity(sid, sdata, is_migrate=False)
    for eid, edata in data["entities"].items():
        restore_entity(eid, edata, is_migrate=False)


# --- test / process reset ----------------------------------------------------


def cleanup_for_tests() -> None:
    """Reset all module state (tests and process teardown)."""
    global _space_class, _save_interval_override, runtime
    _entities.clear()
    _spaces.clear()
    _registry.clear()
    _client_owners.clear()
    _space_class = None
    _save_interval_override = None
    runtime = Runtime()
    post_mod.clear()


def reset_world() -> None:
    """Drop every entity, space, client binding, timer and slab slot but
    KEEP the type registry — models a game-process crash inside one test
    process (the chaos harness kills and recreates a GameService without
    forking): the "new process" starts from an empty world but the same
    registered entity classes."""
    global runtime
    _entities.clear()
    _spaces.clear()
    _client_owners.clear()
    runtime = Runtime()
    post_mod.clear()
