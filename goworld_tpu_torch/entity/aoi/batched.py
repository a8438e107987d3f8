"""Batched AOI on the GPU: all spaces of a game in one device step per tick
(the port of ``goworld_tpu.entity.aoi.batched``).

This is the device replacement for per-move sweep updates (SURVEY.md
§3.3): each game process owns one ``BatchAOIService`` wrapping a
``NeighborEngine``; every AOI-enabled Space gets a ``BatchSpaceAOIManager``
view onto it. Position updates only write a numpy row; the actual neighbor
query + diff runs once per tick in ``service.tick()``, which then delivers
the diff host-side as ONE ``on_aoi_batch(enters, leaves)`` callback per
entity (numpy-grouped by subject slot; classes overriding the per-pair
``on_enter_aoi``/``on_leave_aoi`` hooks keep the legacy per-pair calls) —
one tick later at most, by design (SURVEY.md §7.3 hard part #1; the
freeze/migration semantics tolerate this because diffs are always
reconciled against live entities at delivery time).

Slot lifecycle: freed slots are quarantined until the *next* tick has
delivered the leave events generated by their deactivation, then recycled —
otherwise a slot reused in the same tick would mis-attribute diffs.

Device: the service builds its engines on ``device`` (None means
``"cuda"``, and raises where no CUDA device exists, as ``NeighborEngine``
does; pass ``"cpu"`` for the plain versions): the single-device engine,
the strip tier (``shard_mode="spatial"``), the entity-sharded tier
(``shard_mode="entity"``) or the multi-process tier (``multihost=True``).
PyTorch compiles nothing, so every engine variant is ready from its first
dispatch: the JAX service's compile-stall guards stay in place with
"ready" always true (``_variant_ready``).
"""

from __future__ import annotations

import dataclasses
import inspect
import threading
import time

import numpy as np
import torch

from goworld_tpu_torch import telemetry
from goworld_tpu_torch.entity.aoi.base import AOIManagerBase
from goworld_tpu_torch.entity.slabs import (
    SIF_SYNC_NEIGHBOR_CLIENTS,
    SIF_SYNC_OWN_CLIENT,
)
from goworld_tpu_torch.ops.neighbor import NeighborEngine, NeighborParams

# Fused-tick observability ([aoi] fuse_logic; module-scope families per
# gwlint R5): how many classes/slots ran inside the device launch at the
# last dispatch, and why a class fell back to the host-side hook.
_M_FUSED_CLASSES = telemetry.gauge(
    "aoi_fused_classes",
    "Entity classes whose tick program ran INSIDE the AOI device launch "
    "at the last fused dispatch.")
_M_FUSED_SLOTS = telemetry.gauge(
    "aoi_fused_slots",
    "Entity slots covered by fused tick programs at the last dispatch.")
_M_FUSED_FALLBACK = telemetry.counter(
    "aoi_fused_fallback_total",
    "Fused-eligible classes that ran host-side instead for a dispatch "
    "(slot_overflow: entities beyond the engine tier; missing_column: "
    "program names a column no live type declares).",
    ("reason",))

# Fused interest-edge delivery observability:
# class census of the delivery split, the per-phase host wall-clock the
# fusion is meant to shrink, and the applied-event volume proving the
# thin decode actually ran (all module-scope per gwlint R5).
_M_DELIVERY_FUSED_CLASSES = telemetry.gauge(
    "aoi_fused_delivery_classes",
    "Entity classes whose AOI event delivery rides the fused device-"
    "verdict decode (stock interest pipeline end to end).")
_M_DELIVERY_FALLBACK_CLASSES = telemetry.gauge(
    "aoi_host_fallback_classes",
    "Entity classes kept on the host on_aoi_batch delivery path "
    "(custom AOI/interest hooks, or non-Entity harness doubles).")
_M_HOST_PHASE = telemetry.counter(
    "aoi_host_phase_seconds_total",
    "Host wall seconds per tick phase (delivery: event decode + "
    "interest-edge application; persist: entity snapshot packing).",
    ("phase",))
_M_FUSED_DELIVERY_EVENTS = telemetry.counter(
    "aoi_fused_delivery_events_total",
    "AOI events routed through the fused interest-edge decode "
    "(applied: bulk edge mutations; dropped: device-verdict no-ops "
    "skipped wholesale).",
    ("kind",))

# Smallest engine tier (slots). A step's cost follows the engine's capacity,
# so the service starts small and grows toward the config ceiling as the
# world fills — a 30-entity world must not pay a 16k-slot step every tick.
_MIN_TIER = 256
_GROW_FACTOR = 4  # tier jumps are rare and pre-warmed in a thread


def _class_uses_batch_hook(cls: type) -> bool:
    """Decide (once per class, cached on the service) whether delivery may
    use the batched ``on_aoi_batch`` hook or must fall back to per-pair
    calls: classes overriding only the legacy per-pair hooks keep their
    exact call pattern; an explicit ``on_aoi_batch`` override always wins;
    duck-typed test doubles without the batch hook stay per-pair."""
    from goworld_tpu_torch.entity.entity import Entity

    if getattr(cls, "on_aoi_batch", None) is None:
        return False
    if not issubclass(cls, Entity):
        return True  # non-Entity object exposing its own batch hook
    if cls.on_aoi_batch is not Entity.on_aoi_batch:
        return True
    return (
        cls.on_enter_aoi is Entity.on_enter_aoi
        and cls.on_leave_aoi is Entity.on_leave_aoi
    )


def _class_fused_delivery(cls: type) -> bool:
    """Fused-delivery eligibility (once per class, cached on the service):
    the device-verdict decode may apply this class's enter/leave events as
    bulk interest-edge mutations ONLY when the class keeps the stock
    delivery pipeline end to end — default ``on_aoi_batch``, default
    per-pair hooks, default ``interest``/``uninterest`` (the decode
    replicates exactly those bodies, including the client create/destroy
    sends). Anything custom keeps the host path, counted on the
    aoi_host_fallback_classes gauge."""
    from goworld_tpu_torch.entity.entity import Entity

    return (
        isinstance(cls, type)
        and issubclass(cls, Entity)
        and cls.on_aoi_batch is Entity.on_aoi_batch
        and cls.on_enter_aoi is Entity.on_enter_aoi
        and cls.on_leave_aoi is Entity.on_leave_aoi
        and cls.interest is Entity.interest
        and cls.uninterest is Entity.uninterest
    )


def _apply_edge_rows(slabs, ents, rows, is_enter: bool) -> None:
    """Thin guarded application of fused-delivery rows — the exact default
    ``interest()``/``uninterest()`` bodies inlined over (watcher, other)
    slot pairs. Deliberately a per-row loop OUTSIDE the gwlint hot-path
    set: each row is a handful of set/dict mutations with no vectorizable
    structure (swap-remove indices come from the live edge map), and every
    vectorizable decision (class split, verdict no-op drop) already
    happened in ``_deliver_fused``. Guards mirror the host path bit for
    bit: destroyed watchers skip their rows, enters require the other side
    alive and not already interested, leaves require live interest (set
    membership, not edge-map membership — the purge backstop can drop map
    entries while the sets still hold the pair)."""
    for wat, subj in rows.tolist():
        a = ents[wat]
        if a is None or a.is_destroyed():
            continue
        b = ents[subj]
        if b is None:
            continue
        if is_enter:
            if b.is_destroyed() or b in a.interested_in:
                continue
            a.interested_in.add(b)
            b.interested_by.add(a)
            slabs.edge_add(subj, wat)
            if a.client is not None:
                a.client.send_create_entity(b, is_player=False)
        else:
            if b not in a.interested_in:
                continue
            a.interested_in.discard(b)
            b.interested_by.discard(a)
            slabs.edge_remove(subj, wat)
            if a.client is not None:
                a.client.send_destroy_entity(b)


def params_from_config(aoi_cfg, params: NeighborParams | None = None) -> NeighborParams:
    """Map the ``[aoi]`` config section onto engine params.

    ``capacity`` is rounded up to the alignment the engines require
    (multiples of 8 sublanes; sharded additionally needs capacity % (8*D)
    and max_events % D — ShardedNeighborEngine.__init__).

    Grid geometry: explicit ``grid`` / ``cell_size`` / ``space_slots`` ini
    knobs win; otherwise the grid scales with capacity (~16 cells/side at
    4k entities) so small worlds don't pay the headline config's table —
    the per-tick table build/scatter work is proportional to
    space_slots*grid²*cell_capacity, and the 64x64x8 engine default cost a
    single-core host ~30 ms/step for a 30-entity demo world (seen live).
    """
    shards = max(1, int(getattr(aoi_cfg, "mesh_shards", 1)))
    align = 8 * shards
    cap = int(getattr(aoi_cfg, "max_entities", 16384))
    cap = ((cap + align - 1) // align) * align
    base = params or NeighborParams()
    max_events = base.max_events
    if max_events % shards:
        max_events = ((max_events + shards - 1) // shards) * shards
    grid = int(getattr(aoi_cfg, "grid", 0) or 0)
    if grid <= 0:
        # Floor of 32: grid*cell_size is the world extent the torus can
        # represent WITHOUT folding distant world cells onto one bucket
        # (folding doesn't create false neighbors — distance math is raw —
        # but it multiplies bucket occupancy and silently drops entities
        # past cell_capacity). Maps wider than 3200 units should set
        # [aoi] grid / cell_size explicitly (goworld.ini.sample).
        grid = int(round(16 * (max(cap, 1) / 4096.0) ** 0.5))
        grid = min(128, max(32, (grid + 7) // 8 * 8))
        # The spatial shard layout needs >= 4 columns per strip
        # (parallel/spatial.MIN_STRIP_COLS); grow the derived grid to
        # host the configured mesh. Explicit [aoi] grid values are the
        # operator's own contract and are validated at engine build.
        grid = max(grid, ((4 * shards + 7) // 8) * 8)
    space_slots = int(getattr(aoi_cfg, "space_slots", 0) or 0) or 4
    cell_size = float(getattr(aoi_cfg, "cell_size", 0.0) or 0.0) or base.cell_size
    return NeighborParams(
        capacity=cap,
        cell_size=cell_size,
        grid_x=grid,
        grid_z=grid,
        space_slots=space_slots,
        cell_capacity=min(int(getattr(aoi_cfg, "cell_capacity", 64)), 128),
        max_events=max_events,
    )


class BatchAOIService:
    """Game-wide batched AOI state: one engine, slot-allocated entities.

    ``mesh_shards > 1`` builds a sharded engine over a 1-D mesh of
    ``mesh_shards`` shards on ``device`` (``[aoi] mesh_shards`` in the ini;
    the shards may share one card): with ``shard_mode="spatial"`` the
    strip-sharded ``SpatialShardedNeighborEngine`` (grid-column strips with
    a halo exchange, parallel/spatial.py), with ``shard_mode="entity"`` the
    entity-sharded ``ShardedNeighborEngine`` (rows sharded, positions
    all-gathered each tick, parallel/mesh.py). The host-facing surface is
    identical — every engine speaks step_async()/collect() with one packed
    readback per tick.

    ``multihost=True`` is the multi-process tier (``[aoi]
    multihost_coordinator``, after ``parallel.multihost.init_multihost``):
    one ``MultiHostNeighborEngine`` spanning every game process, this
    service owning only its process's row slab on its own device. Capacity
    is GLOBAL (split across games), built at full size immediately (tier
    growth is not lockstep-safe), space ids are globally unique, and every
    process dispatches the same sequence of ticks, each one gather of
    every process's rows (game/service.py main loop).

    ``device``: where the engines run; None means ``"cuda"`` and raises
    where no CUDA device exists.
    """

    def __init__(
        self,
        params: NeighborParams,
        mesh_shards: int = 1,
        multihost: bool = False,
        slabs=None,
        shard_mode: str = "spatial",
        fuse_logic: bool = False,
        strip_placement: str = "topology",
        pallas_strip_cols: int = 0,
        pallas_inkernel_drain: bool = True,
        device: str | torch.device | None = None,
    ) -> None:
        if shard_mode not in ("spatial", "entity"):
            raise ValueError(
                f"[aoi] shard_mode must be spatial|entity, got {shard_mode!r}"
            )
        if strip_placement not in ("topology", "ring"):
            raise ValueError(
                f"[aoi] strip_placement must be topology|ring, "
                f"got {strip_placement!r}"
            )
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "BatchAOIService runs on CUDA unless told otherwise, and "
                    "no CUDA device is available; pass device='cpu' for the "
                    "plain versions")
            device = "cuda"
        self.device = torch.device(device)
        self.shard_mode = shard_mode
        # Strip→device placement + strip-width cap for the spatial
        # sharded engine ([aoi] strip_placement / pallas_strip_cols). A
        # torch.device has no coords, so every placement keeps mesh order.
        self.strip_placement = strip_placement
        self.pallas_strip_cols = int(pallas_strip_cols)
        self.pallas_inkernel_drain = bool(pallas_inkernel_drain)
        # The service's slot space IS the entity slab store's
        # (entity/slabs.py): positions/active/space/radius are slab
        # columns, the engine reads them as [:capacity] views, and slot
        # alloc/free/quarantine live in the store. ``slabs=None`` attaches
        # to the process runtime's store.
        if slabs is None:
            from goworld_tpu_torch.entity import entity_manager

            slabs = entity_manager.runtime.slabs
        self.slabs = slabs
        self.multihost = multihost
        if multihost:
            # Multi-process tier: one engine over every game process, one
            # shard each (parallel/multihost.py). Built at FULL capacity
            # immediately — tier growth is a per-process decision and every
            # process must dispatch the same sequence of gathers, so
            # growing lazily would wedge the group. Capacity / max_events
            # are rounded up to the global shard alignment here (not in
            # params_from_config: the process count is only known after
            # init_multihost).
            from goworld_tpu_torch.parallel import multihost as mh
            from goworld_tpu_torch.parallel.mesh import make_mesh

            self._nprocs = mh.process_count()
            self._pid = mh.process_index()
            if self.device.type == "cuda" and self.device.index is None:
                # The card init_multihost gave this process's rank.
                self.device = torch.device("cuda",
                                           torch.cuda.current_device())
            n_dev = self._nprocs
            align = 8 * n_dev
            cap = ((params.capacity + align - 1) // align) * align
            ev = ((params.max_events + n_dev - 1) // n_dev) * n_dev
            full = dataclasses.replace(params, capacity=cap, max_events=ev)
            self.max_params = full
            self.params = full
            self.mesh_shards = 1
            self._align = align
            # The reference backend: ENTITY-row ownership, so each
            # process's events are exactly its own entities' events (the
            # slab kernel delivers by CELL ownership and would need an
            # event-routing layer across games; parallel/multihost.py).
            self.engine = mh.MultiHostNeighborEngine(
                full, make_mesh(1, self.device), backend="reference")
            self.engine.reset()
            # Host arrays cover only this process's row slab; engine
            # events carry GLOBAL ids, mapped back in _deliver.
            self._id_base = self.engine.local_lo
            n = self.engine.local_capacity
            # Fixed-size local slab: growth is not lockstep-safe, so the
            # store is built out to the engine's local capacity now and
            # capped there (the alloc error names the per-process bound).
            slabs.ensure_capacity(n)
            slabs.max_capacity = max(slabs.capacity, n)
            slabs.exhausted_hint = (
                f"BatchAOIService local slab {slabs.capacity} exhausted "
                f"(global [aoi] max_entities split across "
                f"{self._nprocs} processes); raise max_entities")
        else:
            self.max_params = params  # config ceiling ([aoi] max_entities)
            self.mesh_shards = mesh_shards
            self._align = 8 * max(1, mesh_shards)
            self._id_base = 0
            self._nprocs = 1
            self._pid = 0
            tier = min(params.capacity, self._round_up(_MIN_TIER))
            self.params = dataclasses.replace(params, capacity=tier)
            self.engine = self._build_engine(self.params)
            self.engine.reset()
            slabs.ensure_capacity(tier)
        slabs.aoi_service = self  # released slots now quarantine (slabs.py)
        # Fused entity logic ([aoi] fuse_logic): per-class tick programs
        # run INSIDE the engine step dispatch. Effective only on engines
        # that speak the logic= dispatch contract (the single-device
        # engine and the spatial sharded engine); the entity-sharded and
        # multihost tiers fall back to host-side hooks.
        self.fuse_logic = bool(fuse_logic)
        self._fuse_enabled = (
            self.fuse_logic
            and getattr(self.engine, "supports_fused_logic", False)
            and not multihost
        )
        if self.fuse_logic and not self._fuse_enabled:
            from goworld_tpu_torch.utils import gwlog

            gwlog.warnf(
                "[aoi] fuse_logic requested but the %s engine does not "
                "support fused dispatch; tick hooks stay host-side",
                type(self.engine).__name__)
        # Per-class fused program cache (None = host-side) and the LIVE
        # takeover decision slabs.run_tick_batches consults every tick.
        self._fused_progs: dict[type, object] = {}
        self._fused_take: dict[type, bool] = {}
        self._last_logic_t: float | None = None
        # The clock the fused programs' dt is read from (seconds); a seam
        # for drivers that need a reproducible dt sequence.
        self.clock = time.monotonic
        # Per-class batch-vs-legacy delivery decision (_dispatch_events).
        self._batch_hook_cache: dict[type, bool] = {}
        # Fused interest-edge delivery: per-slot
        # eligibility stamped at alloc from the class predicate, the
        # per-class decision cache, and the class census behind the
        # aoi_fused_delivery_classes / aoi_host_fallback_classes gauges.
        self._fused_delivery_cache: dict[type, bool] = {}
        self._delivery_fused = np.zeros(slabs.capacity, bool)
        self._fused_classes: set = set()
        self._fallback_classes: set = set()
        # Device edge verdicts need the whole edge-key space in int32
        # inside the launch; oversized deployments keep host-side
        # verdicts (the decode is exact either way — verdicts only let
        # it drop no-op rows without consulting the live edge map).
        self._verdicts_enabled = (
            not multihost
            and getattr(self.engine, "supports_tier_pass", False)
            and (self.max_params.capacity + 1) ** 2 < 2 ** 31
        )
        self._space_seq = 0
        # In-flight dispatched step + the slots whose deactivation it saw
        # (recyclable once ITS events have been delivered).
        self._pending: tuple | None = None
        # active/space/radius changed since the last dispatch? (position
        # moves don't count — engines elide the meta upload when clean)
        self._meta_dirty = True
        self._prewarm_thread: threading.Thread | None = None
        # Tiered-variant prewarm thread ([sync] tier pass; _prewarm_tiers).
        self._tier_warm_thread: threading.Thread | None = None
        # Largest tier that was pre-warmed. Written from the aoi-prewarm
        # daemon thread, read on the game loop with NO lock: a single int
        # attribute write is atomic under the GIL, and the worst race is one
        # redundant prewarm. A free-threaded or multi-process refactor must
        # add synchronization here.
        self._prewarmed_cap = 0
        self.last_step_duration = 0.0  # measured dispatch→ready, seconds
        self._turnaround_stamped = False  # in-flight step measured yet?
        # Dispatches by tick()/tick_sync() (warmup excluded: it is uniform
        # across processes) and the flush round: the multihost tier's
        # pre-freeze alignment protocol reads both.
        self._dispatch_count = 0
        self._flush_round = 0
        self._flush_target = 0
        # Delivery model: "pipelined" (default; diffs land one tick late,
        # one blocking fetch per tick) or "sync" ([aoi] delivery; diffs
        # land same-tick, loop stalls on device compute — tick_sync).
        self.delivery = "pipelined"
        # Sync-mode stall ceiling, config-exposed ([aoi] sync_wait_budget;
        # entity_manager wires it through). See SYNC_WAIT_BUDGET.
        self.sync_wait_budget = self.SYNC_WAIT_BUDGET
        # AOI stage telemetry (goworld_tpu/telemetry): stage *timings*
        # (aoi.dispatch/deliver/drain) flow in via the opmon shim; these
        # cover the volume/degradation axes. Counters are process-wide
        # accumulators (get-or-create returns the shared child); the
        # gauges describe the most recently constructed service — one per
        # game process in production.
        self._m_backlog = telemetry.gauge(
            "aoi_event_backlog",
            "enter+leave events delivered by the last AOI tick.")
        self._m_overflow = telemetry.counter(
            "aoi_grid_overflow_dropped_total",
            "Active entities invisible for a tick because their grid cell "
            "overflowed cell_capacity (the '14 invisible entities' class "
            "of warning).")
        self._m_sync_degrade = telemetry.counter(
            "aoi_sync_degrade_total",
            "Times sync delivery exceeded sync_wait_budget and degraded "
            "to deferred (pipelined-style) delivery.")
        telemetry.gauge(
            "aoi_in_flight_age_seconds",
            "Seconds the in-flight AOI step has been dispatched without "
            "being observed ready (wedge indicator; 0 when idle/ready).",
        ).set_function(self.in_flight_age)

    # Slot-space views over the shared slab store (full arrays; engine
    # dispatches slice them to the current engine capacity).
    @property
    def pos(self) -> np.ndarray:
        return self.slabs.xz

    @property
    def active(self) -> np.ndarray:
        return self.slabs.active

    @property
    def space_ids(self) -> np.ndarray:
        return self.slabs.space_ids

    @property
    def radius(self) -> np.ndarray:
        return self.slabs.radius

    @property
    def _entities(self) -> list:
        return self.slabs.entities

    @property
    def _free(self) -> list:
        return self.slabs._free

    @property
    def _quarantine(self) -> list:
        return self.slabs._quarantine

    def _round_up(self, cap: int) -> int:
        return ((cap + self._align - 1) // self._align) * self._align

    def _build_engine(self, params: NeighborParams):
        """The port's engine for ``params`` on the service's device: the
        single-device engine (its "auto" backend: the CUDA kernel path on a
        card, the reference path on the CPU), or with ``mesh_shards > 1``
        the strip tier or the entity-sharded tier, every shard on that
        device."""
        if self.mesh_shards > 1:
            from goworld_tpu_torch.parallel.mesh import make_mesh

            mesh = make_mesh(self.mesh_shards, self.device)
            if self.shard_mode == "spatial":
                # Grid-strip halo exchange (parallel/spatial.py):
                # O(boundary) traffic instead of the all-gather's O(N)
                # broadcast; the strip knobs ride the [aoi] config.
                from goworld_tpu_torch.parallel.spatial import (
                    SpatialShardedNeighborEngine,
                )

                return SpatialShardedNeighborEngine(
                    params, mesh,
                    strip_cols=self.pallas_strip_cols or None,
                    inkernel_drain=self.pallas_inkernel_drain,
                )
            # Entity rows sharded, positions all-gathered: the slab-kernel
            # program ("auto"; its plain versions on the CPU).
            from goworld_tpu_torch.parallel.mesh import ShardedNeighborEngine

            return ShardedNeighborEngine(params, mesh)
        return NeighborEngine(params, device=self.device)

    def warmup(self) -> None:
        """Execute one all-inactive step synchronously, and each tiered
        variant the first login storm dispatches.

        PyTorch compiles nothing, but the first dispatch still pays lazy
        CUDA initialisation, the kernel libraries' loading and the caching
        allocator's first blocks; called at game boot, before the
        deployment-ready barrier admits clients, as the JAX service's
        compile warmup is. In the multihost tier this step is the group's
        first gather: every game warms up at boot."""
        n = (self.engine.local_capacity if self.multihost
             else self.params.capacity)
        self.engine.step_async(
            np.zeros((n, 2), np.float32), np.zeros(n, bool),
            np.zeros(n, np.int32), np.zeros(n, np.float32),
        ).collect()
        if self._tier_pass_active():
            # Boot-time run of the base tiered variant (first edge tier,
            # no fused programs), before the first login storm's tier
            # pass.
            sy = self.slabs.sync
            self.engine.warmup_tiered(
                None, (), (len(sy.cadences), sy.near_ratio, sy.far_ratio),
                256, self._verdicts_enabled)
        if self._verdicts_enabled:
            # First-dispatch verdict variant (empty edge table → no tier
            # config): the fused delivery decode should have device
            # verdicts from the very first login storm, not after a
            # prewarm-thread window.
            self.engine.warmup_tiered(None, (), None, 256, True)
        self.engine.reset()

    # --- capacity tiers -----------------------------------------------------

    def _next_tier(self) -> NeighborParams | None:
        if self.multihost:
            return None  # built at full capacity; growth is not lockstep
        cur = self.params.capacity
        if cur >= self.max_params.capacity:
            return None
        tier = min(
            self.max_params.capacity, self._round_up(cur * _GROW_FACTOR)
        )
        return dataclasses.replace(self.max_params, capacity=tier)

    def _prewarm_next_tier(self) -> None:
        """Run the next tier's step once OFF the game loop.

        A throwaway engine at the next capacity steps once in a daemon
        thread (the JAX service compiles the next tier's jit there); here
        it takes the device's first blocks of that size, so _grow() pays
        no first-use cost inside alloc_slot (the game loop)."""
        nxt = self._next_tier()
        if nxt is None or nxt.capacity <= self._prewarmed_cap:
            return  # already warmed this tier
        if self._prewarm_thread is not None and self._prewarm_thread.is_alive():
            return

        def work(params=nxt):
            try:
                eng = self._build_engine(params)
                eng.reset()
                n = params.capacity
                eng.step_async(
                    np.zeros((n, 2), np.float32), np.zeros(n, bool),
                    np.zeros(n, np.int32), np.zeros(n, np.float32),
                ).collect()
                if self._fuse_enabled:
                    # Warm the next tier's FUSED step too (best-effort,
                    # current program set).
                    progs, dtypes = self._live_programs()
                    if progs:
                        eng.warmup_fused(progs, dtypes)
                # Recorded only on SUCCESS — a failed prewarm (transient
                # device error) stays retryable on the next alloc.
                self._prewarmed_cap = params.capacity
            except Exception:  # pragma: no cover - prewarm is best-effort
                pass

        self._prewarm_thread = threading.Thread(
            target=work, name="aoi-prewarm", daemon=True
        )
        self._prewarm_thread.start()

    def _grow(self) -> None:
        """Move to a larger engine tier with EXACT event semantics.

        Seed the new engine's previous epoch by stepping it once with the
        OLD engine's carried epoch arrays (padded) and DISCARDING the
        events: that epoch is exactly what the in-flight step's events (if
        any) bring interest sets up to once delivered, so the next real
        dispatch diffs against it precisely — no duplicate enters, no lost
        leaves. The in-flight step is deliberately NOT delivered here (its
        pager closes over the old engine, which stays alive until then) and
        quarantined slots are NOT recycled: _grow may run re-entrantly from
        an AOI delivery callback that spawns an entity at a tier boundary,
        and recycling mid-delivery would re-issue slots the outer
        delivery's remaining events still reference.
        """
        nxt = self._next_tier()
        assert nxt is not None
        from goworld_tpu_torch.utils import gwlog

        n = nxt.capacity

        def pad(arr, shape, dtype):
            out = np.zeros(shape, dtype)
            out[: arr.shape[0]] = np.asarray(arr)
            return out

        # The old engine's carried epoch = the last DISPATCHED world, in
        # SLOT space (the spatial engine's device state is row-permuted,
        # so it is asked rather than peeked at — carried_epoch()).
        st = self.engine.carried_epoch()
        engine = self._build_engine(nxt)
        engine.reset()
        engine.step_async(
            pad(st[0], (n, 2), np.float32),
            pad(st[1], (n,), bool),
            pad(st[2], (n,), np.int32),
            pad(st[3], (n,), np.float32),
        ).collect()
        self.engine = engine
        self.params = nxt
        # Slot storage lives in the slab store; only make sure it covers
        # the new engine capacity (slot allocation itself is store-side).
        self.slabs.ensure_capacity(n)
        self._meta_dirty = True
        gwlog.infof("AOI engine grew to %d slots (max %d)", n,
                    self.max_params.capacity)

    # --- space / slot allocation -------------------------------------------

    def alloc_space_id(self) -> int:
        """Process-unique space id. In multihost mode ids are GLOBALLY
        unique (seq * nprocs + pid + 1): the pair predicate compares exact
        space ids, so two games' spaces can never produce cross-game pairs
        even though they share one global engine."""
        self._space_seq += 1
        return self._space_seq * self._nprocs + self._pid + 1

    def alloc_slot(self, entity, space_id: int, x: float, z: float, radius: float) -> int:
        """Activate ``entity``'s slab slot in the engine (AOI space entry).

        Entities already own a store slot for life (entity/slabs.py);
        duck-typed harness objects without one get a slot allocated here.
        The engine tier grows to cover the slot index when the store has
        outgrown it."""
        slabs = self.slabs
        slot = getattr(entity, "_slot", -1)
        if slot < 0 or getattr(entity, "_slabs", None) is not slabs:
            slot = slabs.alloc(entity)
            try:
                entity._slabs = slabs
                entity._slot = slot
            except AttributeError:  # __slots__'d duck: slot still works
                pass
        engine_cap = (self.engine.local_capacity if self.multihost
                      else self.params.capacity)
        while slot >= engine_cap:
            if self._next_tier() is None:
                raise RuntimeError(
                    f"BatchAOIService capacity {engine_cap} "
                    f"exhausted; raise [aoi] max_entities"
                )
            self._grow()
            engine_cap = self.params.capacity
        slabs.xz[slot] = (x, z)
        slabs.active[slot] = True
        slabs.space_ids[slot] = space_id
        slabs.radius[slot] = radius
        # Space-entry position is a host write: fence it against an
        # in-flight fused writeback (entity/slabs.py fused_dirty).
        slabs.fused_dirty[slot] = True
        if slot >= len(self._delivery_fused):
            grown = np.zeros(max(slabs.capacity, slot + 1), bool)
            grown[: len(self._delivery_fused)] = self._delivery_fused
            self._delivery_fused = grown
        cls = type(entity)
        fused = self._fused_delivery_cache.get(cls)
        if fused is None:
            fused = self._fused_delivery_cache[cls] = _class_fused_delivery(cls)
            (self._fused_classes if fused else self._fallback_classes).add(cls)
            _M_DELIVERY_FUSED_CLASSES.set(len(self._fused_classes))
            _M_DELIVERY_FALLBACK_CLASSES.set(len(self._fallback_classes))
        self._delivery_fused[slot] = fused
        self._meta_dirty = True
        # Kick the next tier's warm-up off-thread once 3/4 full.
        if slabs.used * 4 > self.params.capacity * 3:
            self._prewarm_next_tier()
        return slot

    def free_slot(self, slot: int) -> None:
        """AOI space exit: deactivate only. The slot stays bound to its
        (still-live) entity; destroy-time quarantine/recycling is the slab
        store's (slabs.release)."""
        self.active[slot] = False
        self._meta_dirty = True

    def move_slot(self, slot: int, x: float, z: float) -> None:
        self.slabs.xz[slot] = (x, z)
        self.slabs.fused_dirty[slot] = True

    # --- tick --------------------------------------------------------------

    def tick(self, wait: bool = True) -> tuple[int, int] | None:
        """Pipelined tick: dispatch this tick's step, deliver the PREVIOUS
        tick's events. Returns the delivered (enters, leaves) counts, or
        ``None`` when a ``wait=False`` call frame-skipped (nothing was
        dispatched or delivered).

        ``self.delivery == "sync"`` (``[aoi] delivery``) reroutes to
        :meth:`tick_sync` — same-tick delivery for games that need diffs
        within milliseconds of the step completing (the BASELINE p99 < 5 ms
        axis) at the cost of the loop stalling on device compute.

        Dispatch-then-collect hides the device round trip behind a full game
        tick (one blocking fetch per tick, one tick of extra diff latency —
        the documented delivery model). Slots freed since the last dispatch
        ride along with the step that observes their deactivation and are
        recycled only after that step's leave events have been delivered.

        ``wait=False`` adds frame-skipping backpressure for latency-critical
        callers (the live game loop): if the in-flight step hasn't finished
        computing, do NOTHING this tick — neither deliver (would block the
        single-threaded loop on device compute, starving every RPC; seen
        live: ~200 ms jnp ticks froze a cluster's Account logins) nor
        dispatch (unbounded queueing). Positions keep accumulating in the
        host arrays; the next dispatch simply sees the latest world, and
        diffs stay exact because the engine always diffs against the last
        DISPATCHED epoch, not wall-clock ticks. The default (blocking) keeps
        back-to-back ticks deterministic for tests and embedded drivers.

        Known bound on the no-stall guarantee: is_ready() covers the inline
        packed result only; an event STORM beyond max_events (mass login)
        makes collect() page extra device round trips synchronously. Storms
        are rare and bounded by spawn bursts — the aoi.deliver opmon warn
        (>50 ms) flags it when it happens.
        """
        from goworld_tpu_torch.utils import opmon

        if self.delivery == "sync":
            return self.tick_sync()
        prev = self._pending
        if not wait and prev is not None and not prev[0].is_ready():
            # Still computing: frame-skip — no dispatch, no delivery. None
            # (vs a counts tuple) lets the game loop keep probing every
            # loop iteration instead of restarting its cadence timer.
            return None
        if (
            prev is not None
            and not self._turnaround_stamped
            and prev[0].is_ready()
        ):
            # Fallback stamp for callers that never poll (tests, flush) —
            # only when the step is OBSERVED ready: in the blocking path
            # readiness isn't known yet here, and stamping anyway would
            # measure dispatch→next-tick, baking the caller's cadence into
            # the adaptive-duty sample. A stale-but-accurate
            # sample from a later poll beats a cadence-biased one.
            self._stamp_ready(prev)
        pending, quarantined_now, t0 = self._dispatch()
        self._pending = (pending, quarantined_now, t0)
        self._turnaround_stamped = False
        if prev is None:
            return 0, 0
        op = opmon.Operation("aoi.deliver")
        delivered = self._deliver(prev)
        op.finish(warn_threshold=0.05)
        return delivered

    # --- fused entity logic ([aoi] fuse_logic) ------------------------------

    def _static_prog(self, cls: type):
        """The class's fused program, or None for host-side hooks
        (decided once per class and cached — consulted per dispatch)."""
        if cls in self._fused_progs:
            return self._fused_progs[cls]
        hook = inspect.getattr_static(cls, "on_tick_batch", None)
        prog = getattr(getattr(hook, "__func__", None),
                       "fused_program", None)
        self._fused_progs[cls] = prog
        return prog

    def takes_over_tick(self, cls: type) -> bool:
        """Does the fused dispatch own this class's tick? Consulted by
        slabs.run_tick_batches every loop tick (so the host hook and the
        fused program can never both run); refreshed per dispatch by
        _build_logic when a class overflows the engine tier."""
        if not self._fuse_enabled:
            return False
        t = self._fused_take.get(cls)
        if t is None:
            t = self._static_prog(cls) is not None
            self._fused_take[cls] = t
        return t

    def _build_logic(self):
        """Assemble this dispatch's fused-logic payload from the live
        tick buckets: (programs, sel, y, yaw, dt, cols) in SLOT space, or
        None when no fused class has live entities. A class whose slots
        outgrew the engine tier — or whose program names a column no live
        type declared — falls back to the host-side hook for now (counted
        on aoi_fused_fallback_total) and re-fuses automatically once the
        condition clears."""
        slabs = self.slabs
        cap = self.params.capacity
        progs: list = []
        cols: list = []
        sel = None
        for cls, bucket in list(slabs._tick_buckets.items()):
            prog = self._static_prog(cls)
            if prog is None:
                continue
            n = len(bucket.entities)
            if n == 0:
                self._fused_take[cls] = True
                continue
            slots = bucket.slots[:n]
            if int(slots.max()) >= cap:  # gwlint: ok R1 slots is a numpy slab column; host arithmetic
                if self._fused_take.get(cls, True):
                    _M_FUSED_FALLBACK.labels("slot_overflow").inc()
                self._fused_take[cls] = False
                continue
            if any(c not in slabs.columns for c in prog.columns):
                if self._fused_take.get(cls, True):
                    _M_FUSED_FALLBACK.labels("missing_column").inc()
                self._fused_take[cls] = False
                continue
            self._fused_take[cls] = True
            if sel is None:
                sel = np.zeros(cap, np.int32)
            sel[slots] = len(progs) + 1
            for name in prog.columns:
                cols.append(slabs.columns[name][:cap])
            progs.append(prog)
        if not progs or sel is None:
            _M_FUSED_CLASSES.set(0)
            _M_FUSED_SLOTS.set(0)
            return None
        _M_FUSED_CLASSES.set(len(progs))
        _M_FUSED_SLOTS.set(int(np.count_nonzero(sel)))
        now = self.clock()
        dt = (0.0 if self._last_logic_t is None
              else max(0.0, now - self._last_logic_t))
        self._last_logic_t = now
        return (tuple(progs), sel, slabs.y[:cap], slabs.yaw[:cap],
                dt, tuple(cols))

    def _consume_fused(self, pending) -> None:
        """Write a fused step's logic outputs back into the slabs (called
        just before the NEXT dispatch, and at flush/sync delivery). Slots
        marked fused_dirty since that dispatch — host teleports, client
        sync, release/re-alloc — keep their host values: host writes win.
        Written slots get both sync flags, exactly like the host hook's
        set_position_yaw. Blocks only if the step is still computing
        (the game loop's wait=False gate means it never is there)."""
        f = getattr(pending, "fused", None)
        if f is None:
            return
        pending.fused = None
        programs, sel, perm, outs = f
        new_pos = np.asarray(outs[0])  # gwlint: ok R1 waits for the previous fused step's outputs, which are this dispatch's epoch (chip_smoke.py sync_check records it)
        new_y = np.asarray(outs[1])  # gwlint: ok R1 waits for the previous fused step's outputs, which are this dispatch's epoch (chip_smoke.py sync_check records it)
        new_yaw = np.asarray(outs[2])  # gwlint: ok R1 waits for the previous fused step's outputs, which are this dispatch's epoch (chip_smoke.py sync_check records it)
        slabs = self.slabs
        row_sel = sel if perm is None else sel[perm]
        rows = np.flatnonzero(row_sel)
        if rows.size:
            slots = rows if perm is None else perm[rows]
            keep = ~slabs.fused_dirty[slots]
            rows = rows[keep]
            slots = slots[keep]
            if rows.size:
                slabs.xz[slots] = new_pos[rows]
                slabs.y[slots] = new_y[rows]
                slabs.yaw[slots] = new_yaw[rows]
                off = 0
                sel_rows = row_sel[rows]
                for k, prog in enumerate(programs):
                    nc = len(prog.columns)
                    if nc:
                        m = sel_rows == k + 1
                        krows = rows[m]
                        kslots = slots[m]
                        for i, name in enumerate(prog.columns):
                            slabs.columns[name][kslots] = np.asarray(  # gwlint: ok R1 waits for the previous fused step's outputs, which are this dispatch's epoch (chip_smoke.py sync_check records it)
                                outs[3 + off + i])[krows]
                    off += nc
                slabs.flags[slots] |= (
                    SIF_SYNC_OWN_CLIENT | SIF_SYNC_NEIGHBOR_CLIENTS)
        slabs.fused_dirty[:] = False

    def _live_programs(self) -> tuple[tuple, tuple]:
        """(programs, flat column dtypes) of the classes a fused dispatch
        would cover right now — the prewarm surfaces' input."""
        slabs = self.slabs
        progs: list = []
        dtypes: list = []
        for cls, bucket in list(slabs._tick_buckets.items()):
            prog = self._static_prog(cls)
            if prog is None or not bucket.entities:
                continue
            if any(c not in slabs.column_specs for c in prog.columns):
                continue
            progs.append(prog)
            dtypes.extend(
                slabs.column_specs[c].dtype for c in prog.columns)
        return tuple(progs), tuple(dtypes)

    def prewarm_fused(self) -> None:
        """Warm the fused step for the CURRENT program set at full engine
        capacity (restore path: slabs.prewarm_tick_hooks calls this before
        the first post-restore fused dispatch)."""
        if not self._fuse_enabled:
            return
        progs, dtypes = self._live_programs()
        if progs:
            self.engine.warmup_fused(progs, dtypes)

    def _tier_pass_active(self) -> bool:
        """Run the [sync] cadence tier pass inside the engine dispatch?
        Needs a tiering-enabled slab config, an engine that speaks the
        ``tiers=`` dispatch contract (the single-device engine), and a
        single-process deployment (the multihost tier's lockstep sequence
        of ticks must not diverge on per-process edge counts)."""
        return (
            not self.multihost
            and getattr(self.engine, "supports_tier_pass", False)
            and len(self.slabs.sync.cadences) > 1
        )

    def _build_device_edges(self, programs: tuple | None, want_tiers: bool,
                            want_verdicts: bool) -> tuple | None:
        """Assemble the edge-snapshot payload for the dispatch-resident
        passes — [sync] cadence tiering and/or the fused-delivery edge
        verdicts: the edge snapshot padded to a power-of-two capacity
        (ops/neighbor.tier_edge_capacity) plus the static classification
        thresholds (None when only verdicts ride).

        Stall discipline: a variant that is not ready is never dispatched
        from the game loop; it is warmed in a daemon thread
        (``_prewarm_tiers``) while the host classification in
        entity/slabs.py keeps tiers fresh and the delivery decode falls
        back to all-guarded application. The JAX service's variants need
        an XLA compile first; PyTorch compiles nothing, so every variant is
        ready (``_variant_ready``) — the branch stays as the place where a
        CUDA-graph capture would gate."""
        from goworld_tpu_torch.ops.neighbor import tier_edge_capacity

        s = self.slabs
        ver, n, subj, wat = s.snapshot_edges_for_tiering()
        if n == 0 and not want_verdicts:
            return None
        cap = self.params.capacity
        ecap = tier_edge_capacity(n)
        tcfg = None
        if want_tiers and n > 0:
            sy = s.sync
            tcfg = (len(sy.cadences), sy.near_ratio, sy.far_ratio)
        if tcfg is None and not want_verdicts:
            return None
        if not self._variant_ready(programs, tcfg, ecap, want_verdicts):
            self._prewarm_tiers(programs, tcfg, ecap, want_verdicts)
            return None
        subj_pad = np.full(ecap, cap, np.int32)
        wat_pad = np.full(ecap, cap, np.int32)
        subj_pad[:n] = subj
        wat_pad[:n] = wat
        return (ver, n, subj_pad, wat_pad, tcfg, want_verdicts)

    def _variant_ready(self, programs: tuple | None, tcfg: tuple | None,
                       ecap: int, verdicts: bool) -> bool:
        """Can this tiered variant dispatch from the game loop without a
        stall? Always: nothing is compiled lazily in PyTorch."""
        return True

    def _prewarm_tiers(self, programs: tuple | None, tcfg: tuple | None,
                       ecap: int, verdicts: bool = False) -> None:
        """Warm a tiered step variant OFF the game loop (daemon thread;
        best-effort like _prewarm_next_tier). Column dtypes for a fused
        variant come from the live program set."""
        if (self._tier_warm_thread is not None
                and self._tier_warm_thread.is_alive()):
            return

        dtypes: tuple = ()
        if programs:
            dtypes = tuple(
                self.slabs.column_specs[c].dtype
                for prog in programs for c in prog.columns
                if c in self.slabs.column_specs)

        def work(eng=self.engine, programs=programs, tcfg=tcfg,
                 ecap=ecap, dtypes=dtypes, verdicts=verdicts):
            try:
                eng.warmup_tiered(programs, dtypes, tcfg, ecap, verdicts)
            except Exception:  # pragma: no cover - prewarm is best-effort
                pass

        self._tier_warm_thread = threading.Thread(
            target=work, name="aoi-tier-prewarm", daemon=True)
        self._tier_warm_thread.start()

    def _consume_tiers(self, pending) -> None:
        """Write a step's device-computed tiers back into the edge table
        (discarded by apply_device_tiers on edge churn — affected pairs
        keep their previous tier, new pairs default to full rate)."""
        t = getattr(pending, "tiers", None)
        if t is None:
            return
        pending.tiers = None
        ver, n, arr = t
        self.slabs.apply_device_tiers(ver, n, np.asarray(arr))  # gwlint: ok R1 waits for the previous step's tier vector, written into the edge table before this dispatch snapshots it (chip_smoke.py sync_check records it)

    def _dispatch(self) -> tuple:
        """Shared dispatch bookkeeping for both delivery modes: swap the
        quarantine list, launch the device step, count it (the freeze-
        fence alignment and cadence sampling both key off this exact
        sequence — keep it single-sourced)."""
        from goworld_tpu_torch.utils import opmon

        quarantined_now = self.slabs.take_quarantine()
        cap = (self.engine.local_capacity if self.multihost
               else self.params.capacity)
        s = self.slabs
        logic = None
        prev = self._pending
        if prev is not None:
            self._consume_tiers(prev[0])
        if self._fuse_enabled:
            # The PREVIOUS fused step's outputs become this dispatch's
            # epoch: write them back first, then read the slabs. After
            # the consume NOTHING is in flight, so every host-write fence
            # is stale — clear them all (a mark set while no fused step
            # was pending protects nothing and would only delay the next
            # writeback for that slot by one tick).
            if prev is not None:
                self._consume_fused(prev[0])
            s.fused_dirty[:] = False
            logic = self._build_logic()
        tiers = None
        edge_log = None
        want_tiers = self._tier_pass_active()
        if self._verdicts_enabled:
            # Fresh edge delta log, swapped in BEFORE the edge snapshot
            # below: every edge mutation between this snapshot and the
            # step's decode lands in one of the live logs, so the decode
            # re-checks exactly the keys whose device verdict could be
            # stale (_deliver_fused).
            edge_log = []
            s.edge_log = edge_log
        if want_tiers or self._verdicts_enabled:
            tiers = self._build_device_edges(
                tuple(logic[0]) if logic is not None else None,
                want_tiers, self._verdicts_enabled)
            # The device pass owns classification only while it actually
            # ships payloads; while a variant is not ready the host
            # re-tier keeps running so tiers never go stale
            # (entity/slabs.py).
            s.device_tiers = tiers is not None and tiers[4] is not None
        op = opmon.Operation("aoi.dispatch")
        kwargs: dict = {"meta_dirty": self._meta_dirty}
        if logic is not None:
            kwargs["logic"] = logic
        if tiers is not None:
            kwargs["tiers"] = tiers
        pending = self.engine.step_async(
            s.xz[:cap], s.active[:cap], s.space_ids[:cap],
            s.radius[:cap], **kwargs,
        )
        if edge_log is not None:
            pending.edge_log = edge_log
        self._meta_dirty = False
        op.finish(warn_threshold=0.05)
        self._dispatch_count += 1
        return pending, quarantined_now, time.monotonic()

    # Default ceiling on how long a sync-mode tick may stall the logic
    # loop waiting for the device, overridable per deploy via
    # [aoi] sync_wait_budget (self.sync_wait_budget). SUB-SECOND on
    # purpose: the old 30 s default turned a wedged
    # device into a 30 s freeze-equivalent stall of every RPC before
    # degrading; 0.5 s fails toward the pipelined delivery the rest of
    # the system already tolerates — the step is parked for deferred
    # delivery (events land when observed ready, exactly the pipelined
    # contract) and aoi_sync_degrade_total counts the incident. A growth
    # -tier recompile or slow step that overruns the budget degrades the
    # same benign way; deploys that prefer stalling over one-tick-late
    # diffs raise the ini knob.
    SYNC_WAIT_BUDGET = 0.5

    def tick_sync(self) -> tuple[int, int] | None:
        """Synchronous tick: dispatch this tick's step and deliver ITS
        events in the same call ([aoi] delivery = sync).

        The pipelined model bounds dispatch→delivery at one full tick by
        design; games whose logic needs enter/leave diffs within
        milliseconds of the world moving (fast-twitch combat, server-side
        hit validation) opt into this mode instead: events land within
        one aoi.drain (readback + unpack, the BASELINE p99 < 5 ms axis)
        of the device step completing. The cost is explicit — the logic
        loop stalls for the step's device time every AOI tick, so the
        sustainable cadence is bounded by step time, not hidden behind
        it. Same event-stream semantics: the engine diffs against the
        last dispatched epoch either way, so the only difference from
        pipelined delivery is WHEN a tick's events fire (same tick vs one
        later), not what they are.

        The stall is BOUNDED: the wait polls readiness
        against ``self.sync_wait_budget`` ([aoi] sync_wait_budget, default
        0.5 s), and on expiry the step is parked as an ordinary in-flight
        pending (deferred delivery) so the loop keeps running,
        in_flight_age() ages, and the game loop's wedge watchdog fires —
        a wedged device degrades exactly like pipelined mode instead of
        hanging the loop forever; aoi_sync_degrade_total counts each
        degrade. A later tick delivers the
        parked step the moment it is observed ready, or returns ``None``
        (frame-skip) while it is not. Incompatible with the multihost
        tier (read_config validation): there a dead peer would make every
        sync wait run into its budget."""
        from goworld_tpu_torch.utils import gwlog, opmon

        # Mode-switch / parked-step safety: deliver any leftover in-flight
        # step first so its events are not lost and slot recycling stays
        # ordered — but only once observed ready (a parked wedged step
        # must keep frame-skipping, not re-block the loop).
        prev = self._pending
        if prev is not None:
            if not prev[0].is_ready():
                return None
            self._pending = None
            if not self._turnaround_stamped:
                self._stamp_ready(prev)
            self._consume_fused(prev[0])
            e0, l0 = self._deliver(prev)
        else:
            e0, l0 = 0, 0
        pending, quarantined_now, t0 = self._dispatch()
        deadline = t0 + self.sync_wait_budget
        while not pending.is_ready():
            if time.monotonic() >= deadline:
                self._m_sync_degrade.inc()
                gwlog.errorf(
                    "AOI sync delivery: step not ready after %.2f s "
                    "([aoi] sync_wait_budget) — slow or wedged device; "
                    "parking it for deferred (pipelined-style) delivery; "
                    "the loop keeps running",
                    self.sync_wait_budget,
                )
                self._pending = (pending, quarantined_now, t0)
                self._turnaround_stamped = False
                return e0, l0
            # 0.5 ms poll granularity: bounded-wait latency slop well
            # under the 5 ms delivery budget (aoi.drain itself times only
            # readback + unpack, after readiness).
            time.sleep(0.0005)
        # Honest adaptive-cadence sample: device time of THIS step (the
        # pipelined path stamps dispatch→observed-ready the same way).
        self.last_step_duration = time.monotonic() - t0
        self._turnaround_stamped = True
        op = opmon.Operation("aoi.deliver")
        # Sync mode delivers the step immediately; its fused logic
        # outputs land now too (nothing is pending to consume them later).
        self._consume_fused(pending)
        e1, l1 = self._deliver((pending, quarantined_now, t0))
        op.finish(warn_threshold=0.05)
        return e0 + e1, l0 + l1

    def _stamp_ready(self, prev: tuple) -> None:
        self._turnaround_stamped = True
        self.last_step_duration = time.monotonic() - prev[2]

    def poll_ready(self) -> None:
        """Record the in-flight step's dispatch→ready turnaround the FIRST
        time it is observed ready. Called by the game loop EVERY iteration,
        independent of the AOI cadence gate — measuring inside the gated
        tick() would observe readiness no earlier than the gate opens,
        baking the current cadence into the sample; with cadence = 2x the
        sample, that feedback doubles the AOI interval forever (caught by
        a simulation of the loop: 0.1 → 51.8 s gaps in 200 s)."""
        prev = self._pending
        if (
            prev is not None
            and not self._turnaround_stamped
            and prev[0].is_ready()
        ):
            self._stamp_ready(prev)

    def in_flight_age(self) -> float:
        """Seconds the in-flight step has been dispatched without being
        observed ready; 0.0 when idle or ready. The game loop watchdogs this:
        with wait=False a step that NEVER becomes ready (wedged device — a
        single-client device transport failure mode) would otherwise
        frame-skip forever while AOI silently stops delivering."""
        prev = self._pending
        if prev is None or self._turnaround_stamped or prev[0].is_ready():
            return 0.0
        return time.monotonic() - prev[2]

    # Seconds the multihost flush waits, in all, on its peers' dispatch
    # counts and then on the in-flight step: one shared deadline each, well
    # inside the CLI's 30 s freeze budget.
    MULTIHOST_FLUSH_DEADLINE = 10.0

    def _align_multihost_for_flush(self) -> bool:
        """Equalize dispatch counts across processes before flush.

        Pipelined delivery lets a process run at most ONE dispatch ahead of
        a peer (its step waits in the gather for the peer's rows); if the
        leader flushed now, its collect would wait on a gather the
        (also-freezing) peer will never join — a permanent wedge. Every
        process publishes its dispatch count through the process group's
        key-value store (``parallel.multihost.store``; no collective — one
        here would itself need count agreement), reads all peers', and
        ticks up to the max so everyone collects the same final step.

        Returns False when peers are unreachable (died mid-freeze): the
        in-flight step is then ABANDONED rather than wedging — safe because
        a restored game re-enters every entity into a fresh engine, and the
        idempotent interest guards absorb the missed diffs."""
        import datetime

        from goworld_tpu_torch.parallel import multihost as mh
        from goworld_tpu_torch.utils import gwlog

        kv = mh.store()
        if kv is None:  # not actually distributed (single-process rig)
            return True
        self._flush_round += 1
        prefix = f"gwt/aoi_flush/{self._flush_round}"
        keys = [f"{prefix}/{p}" for p in range(self._nprocs)]
        try:
            kv.set(keys[self._pid], str(self._dispatch_count))
            # ONE shared deadline across every peer's key, not one each:
            # this runs inside the freeze path, and N dead peers must not
            # stack N timeouts. A peer that froze first already set its
            # key (set happens before the wait), so the healthy case never
            # waits.
            kv.wait(keys, datetime.timedelta(
                seconds=self.MULTIHOST_FLUSH_DEADLINE))
            counts = [int(kv.get(k)) for k in keys]
        except Exception:
            gwlog.errorf(
                "AOI multihost flush: peer dispatch counts unreachable; "
                "abandoning the in-flight step (interest is rebuilt on "
                "restore)"
            )
            self._pending = None
            return False
        self._flush_target = max(counts)
        return True

    def flush(self) -> tuple[int, int]:
        """Deliver the in-flight step's events without dispatching another
        (freeze/teardown barrier: no diffs may be outstanding afterwards)."""
        if self.multihost:
            return self._flush_multihost_bounded()
        prev = self._pending
        self._pending = None
        if prev is None:
            return 0, 0
        # Freeze/teardown: the in-flight fused tick's logic outputs must
        # land in the slabs BEFORE freeze_entities packs them.
        self._consume_fused(prev[0])
        return self._deliver(prev)

    def _wait_ready_bounded(self, deadline: float) -> bool:
        """Poll the in-flight step's non-blocking readiness probe until it
        is ready or the deadline passes. False = a gather that will never
        complete (a peer died before joining it)."""
        prev = self._pending
        if prev is None:
            return True
        while not prev[0].is_ready():
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.005)
        return True

    def _flush_multihost_bounded(self) -> tuple[int, int]:
        """Multihost flush with a liveness bound.

        Publishing a dispatch count is not a liveness proof: a peer can
        set its key and die before dispatching its catch-up steps, and
        then every surviving process's catch-up tick or final collect
        would wait inside a gather the dead peer never joins. So never
        issue an unbounded wait here: before each blocking step, poll
        ``is_ready()`` (non-blocking) against one shared deadline, and on
        expiry abandon the in-flight step exactly like the unreachable-peer
        path (safe for the same reason: restore rebuilds interest from
        scratch). Event DELIVERY stays on this thread — entity hooks send
        client packets via the thread's asyncio loop and must never run
        off-loop."""
        from goworld_tpu_torch.utils import gwlog

        if not self._align_multihost_for_flush():
            return 0, 0
        deadline = time.monotonic() + self.MULTIHOST_FLUSH_DEADLINE
        while self._dispatch_count < self._flush_target:
            if not self._wait_ready_bounded(deadline):
                break
            self.tick(wait=True)  # collect is instant (observed ready)
        else:
            if self._wait_ready_bounded(deadline):
                prev = self._pending
                self._pending = None
                return self._deliver(prev) if prev is not None else (0, 0)
        gwlog.errorf(
            "AOI multihost flush: in-flight step never became ready "
            "within budget (peer died after publishing its count?); "
            "abandoning it (interest is rebuilt on restore)"
        )
        self._pending = None
        return 0, 0

    def _deliver(self, prev: tuple) -> tuple[int, int]:
        from goworld_tpu_torch.utils import opmon

        pending, recyclable = prev[0], prev[1]
        # Interest sets are exact (no max_neighbors truncation since the
        # event-native engine); the only capacity diagnostic is grid-cell
        # overflow, which collect() itself logs via gwlog.
        # aoi.drain is the BASELINE p99 delivery-latency axis measured in
        # the PRODUCT: packed-readback + unpack cost after the step has
        # finished computing. Blocking callers (tick(wait=True), flush)
        # reach here before the step is ready, so wait for the device
        # FIRST — otherwise those samples time device compute and poison
        # the /opmon p99 exactly where it's meant to be authoritative.
        pending.wait_device()
        op = opmon.Operation("aoi.drain")
        enters, leaves, _dropped = pending.collect()
        op.finish()
        self._m_backlog.set(len(enters) + len(leaves))
        if _dropped:
            # collect() already warned via gwlog; the counter makes the
            # "N invisible entities" condition scrapeable over time.
            self._m_overflow.inc(_dropped)
        if self._id_base or self.multihost:
            # Multihost events carry GLOBAL row ids; this process's slab is
            # [id_base, id_base + local_capacity). Entity-row sharding plus
            # globally-unique space ids make both pair sides local. The
            # filter is vectorized: at storm scale this runs over 100k+
            # pairs on the single-threaded game loop.
            base, n = self._id_base, len(self._entities)

            def _local(pairs):
                arr = np.asarray(pairs, dtype=np.int64)
                if arr.size == 0:
                    return arr.reshape(0, 2)
                arr = arr - base
                m = ((arr >= 0) & (arr < n)).all(axis=1)
                return arr[m]

            enters = _local(enters)
            leaves = _local(leaves)
        n_e, n_l = len(enters), len(leaves)
        t_deliver = time.perf_counter()
        enters, leaves = self._deliver_fused(pending, enters, leaves)
        self._dispatch_events(enters, leaves)
        _M_HOST_PHASE.labels("delivery").inc(time.perf_counter() - t_deliver)
        # Recycle quarantined slots whose leave events have now been emitted.
        self.slabs.recycle(recyclable)
        return n_e, n_l

    def _deliver_fused(self, pending, enters, leaves):
        """Fused interest-edge decode: split the
        tick's event stream by the WATCHER slot's per-class delivery
        eligibility, bulk-apply the fused rows' edge mutations directly
        (vectorized pre-filter + the thin guarded loop in
        ``_apply_edge_rows``), and return every other row for the host
        ``on_aoi_batch`` path unchanged.

        When the launch carried the edge-verdict pass, verdict-0 rows
        (no-ops against the dispatched edge snapshot) are dropped
        WHOLESALE without consulting the live edge map — except rows
        whose key appears in the edge delta logs accumulated since that
        snapshot (pipelined delivery means host mutations can postdate
        it), which are re-checked by the guarded loop. Fused rows apply
        BEFORE the host rows so arbitrary host-hook edge mutations never
        race the verdict decisions; cross-subject ordering between the
        two halves was already relaxed by the per-subject grouping
        contract (see _dispatch_events)."""
        flags = self._delivery_fused
        e_arr = np.asarray(enters, np.int64).reshape(-1, 2)
        l_arr = np.asarray(leaves, np.int64).reshape(-1, 2)
        if not len(e_arr) and not len(l_arr):
            return e_arr, l_arr
        fe = flags[e_arr[:, 0]]
        fl = flags[l_arr[:, 0]]
        if not fe.any() and not fl.any():
            return e_arr, l_arr
        keep_e, keep_l = fe, fl
        v = getattr(pending, "verdicts", None)
        if v is not None:
            v = np.asarray(v) != 0
            emax = self.params.max_events
            log = getattr(pending, "edge_log", None)
            suspects = set(log or ())
            cur_log = self.slabs.edge_log
            if cur_log is not None and cur_log is not log:
                suspects.update(cur_log)

            def _apply_mask(arr, verd):
                # Rows beyond the inline window (storm paging) have no
                # device verdict — keep them for the guarded loop.
                keep = np.ones(len(arr), bool)
                k = min(len(arr), emax)
                keep[:k] = verd[:k]
                if suspects:
                    keys = (arr[:, 1] << 32) | arr[:, 0]
                    keep |= np.isin(
                        keys, np.fromiter(suspects, np.int64, len(suspects)))
                return keep

            keep_e = fe & _apply_mask(e_arr, v[:emax])
            keep_l = fl & _apply_mask(l_arr, v[emax:])
            _M_FUSED_DELIVERY_EVENTS.labels("dropped").inc(
                int((fe & ~keep_e).sum() + (fl & ~keep_l).sum()))
        ents = self._entities
        _apply_edge_rows(self.slabs, ents, l_arr[keep_l], False)
        _apply_edge_rows(self.slabs, ents, e_arr[keep_e], True)
        _M_FUSED_DELIVERY_EVENTS.labels("applied").inc(
            int(keep_e.sum() + keep_l.sum()))
        return e_arr[~fe], l_arr[~fl]

    def _dispatch_events(self, enters, leaves) -> None:
        """Vectorized event delivery: group the tick's pair stream by
        subject slot (one stable argsort + segment boundaries) and fire ONE
        ``on_aoi_batch(enters, leaves)`` callback per entity instead of one
        Python call per pair — at 100k entities the per-pair loop was the
        dominant host cost of the AOI tick (~4.2 s/tick).

        Ordering contract: within each subject's batch, leaves precede
        enters and both keep engine event order (leaves are concatenated
        before enters, and the argsort is stable). The legacy path ordered
        ALL leaves before ALL enters across subjects; per-subject grouping
        relaxes only the cross-subject interleaving, which the idempotent
        interest guards make unobservable in the interest sets.

        Entity classes that override the per-pair ``on_enter_aoi`` /
        ``on_leave_aoi`` hooks without overriding ``on_aoi_batch`` are
        routed through the legacy per-pair fallback (same checks, same
        order) — decided once per class and cached."""
        n_l = len(leaves)
        if not n_l and not len(enters):
            return
        ev = np.concatenate(
            [
                np.asarray(leaves, np.int64).reshape(-1, 2),
                np.asarray(enters, np.int64).reshape(-1, 2),
            ]
        )
        order = np.argsort(ev[:, 0], kind="stable")
        subj_s = ev[order, 0]
        obj_s = ev[order, 1].tolist()
        is_enter_s = order >= n_l  # stable: leaves stay first per subject
        bounds = np.flatnonzero(
            np.r_[True, subj_s[1:] != subj_s[:-1]]
        ).tolist() + [len(subj_s)]
        subj_list = subj_s.tolist()
        ents = self._entities
        cache = self._batch_hook_cache
        for i in range(len(bounds) - 1):
            lo, hi = bounds[i], bounds[i + 1]
            a = ents[subj_list[lo]]
            if a is None or a.is_destroyed():
                continue
            # Within [lo, hi) the enter flags are 0...0,1...1 (see above).
            k = lo + int(np.searchsorted(is_enter_s[lo:hi], True))
            leave_others = [
                o for o in (ents[s] for s in obj_s[lo:k]) if o is not None
            ]
            enter_others = [
                o for o in (ents[s] for s in obj_s[k:hi]) if o is not None
            ]
            cls = type(a)
            batched = cache.get(cls)
            if batched is None:
                batched = cache[cls] = _class_uses_batch_hook(cls)
            if batched:
                a.on_aoi_batch(enter_others, leave_others)
            else:
                # Legacy per-pair fallback: identical checks and order to
                # the pre-batch delivery loop (leaves first; enter requires
                # both sides alive at fire time).
                for o in leave_others:
                    if a.is_destroyed():
                        break
                    a.on_leave_aoi(o)
                for o in enter_others:
                    if a.is_destroyed():
                        break
                    if not o.is_destroyed():
                        a.on_enter_aoi(o)


class BatchSpaceAOIManager(AOIManagerBase):
    """Per-space view onto the game-wide BatchAOIService."""

    # Positions flow through the entity slab columns the engine reads
    # directly — batched movers (SlabTickView.set_position_yaw) skip the
    # per-entity moved() notification for spaces managed by this class.
    positions_in_slabs = True

    def __init__(self, service: BatchAOIService, distance: float) -> None:
        self.service = service
        self.distance = float(distance)
        self.space_id = service.alloc_space_id()
        self._slots: dict[object, int] = {}

    def enter(self, entity, x: float, z: float) -> None:
        if entity in self._slots:
            return
        self._slots[entity] = self.service.alloc_slot(
            entity, self.space_id, x, z, self.distance
        )

    def leave(self, entity) -> None:
        slot = self._slots.pop(entity, None)
        if slot is not None:
            self.service.free_slot(slot)
            # Sever interest SYNCHRONOUSLY, exactly like go-aoi firing
            # OnLeaveAOI inside Leave() (reference Space.go:243): the
            # engine's leave diffs land a tick later, by which time a
            # migrating avatar's entity (and its client binding) is gone —
            # its client would keep stale neighbor mirrors and see
            # 'duplicate create' on re-encounter (found live by the strict
            # bot fleet). The late engine diffs for these pairs are then
            # swallowed by the idempotent (un)interest guards.
            for other in list(getattr(entity, "interested_in", ())):
                entity.uninterest(other)
            for other in list(getattr(entity, "interested_by", ())):
                other.uninterest(entity)

    def moved(self, entity, x: float, z: float) -> None:
        slot = self._slots.get(entity)
        if slot is not None:
            self.service.move_slot(slot, x, z)

    def tick(self) -> None:
        """Ticking happens game-wide via the service; spaces delegate."""

    def destroy(self) -> None:
        for entity in list(self._slots):
            self.leave(entity)
