"""Columnar entity slabs: structure-of-arrays storage for hot entity state.

The "Essence of Entity Component System" refactor (ROADMAP item 2): the
per-entity hot fields — position/yaw, sync flags, client binding — live in
process-wide numpy columns indexed by a per-entity SLOT, and the Python
``Entity`` object holds only the slot (its ``position``/``yaw``/``client``
attributes are descriptor views over these columns, entity/entity.py).
What this buys:

- ``collect_entity_sync_infos`` becomes pure column ops: the own-client
  rows are one boolean-mask gather over the flag slab and the neighbor
  fan-out rows come from a slot-indexed interest-edge table instead of a
  Python loop over every entity's ``interested_by`` set — the per-gate
  wire buffers are built by column assignment with zero Python row tuples
  (the ``game_pack`` hop that dominated the fan-out pipeline in a
  per-hop breakdown).
- The batched AOI engine reads positions STRAIGHT from the slab: the
  ``xz`` column is the (N, 2) float32 array ``NeighborEngine.step_async``
  takes, so a position write IS the AOI update (aoi/batched.py allocates
  its slots from this store — one slot space, no mirroring).
- Per-class batched behaviors: a class defining a classmethod
  ``on_tick_batch(view)`` gets ONE call per tick over a
  :class:`SlabTickView` of all its live entities (``run_tick_batches``),
  replacing N per-entity timer callbacks; ``vmapped_position_tick`` lifts
  a pure numeric elementwise function into that hook, run on whole torch
  tensors (AsyncTaichi's imperative-to-batched lowering, PAPERS.md).

Slot lifecycle (mirrors the AOI engine's quarantine contract): a slot is
allocated at entity construction and released at destroy; while a batched
AOI service is attached, released slots are QUARANTINED until the engine
step that observed their deactivation has delivered its events — the
entity mapping survives quarantine so in-flight leave diffs still resolve,
and a slot can never be re-issued (aliased) mid-tick. Release always
clears the flag/client/eid columns first, so the vectorized sync collect
structurally cannot emit rows for destroyed entities or unbound clients.
"""

from __future__ import annotations

import inspect
import time
from typing import Optional

import numpy as np

from goworld_tpu_torch import telemetry
from goworld_tpu_torch.entity.columns import ColumnSpec, columnar_tick
from goworld_tpu_torch.utils import gwutils

# sync-info flags (Entity.go sifSyncOwnClient / sifSyncNeighborClients).
# Defined HERE (entity/entity.py re-exports them) so the columnar collect
# needs no import of the entity module.
SIF_SYNC_OWN_CLIENT = 1
SIF_SYNC_NEIGHBOR_CLIENTS = 2

_INITIAL_CAPACITY = 256
_INITIAL_EDGES = 256

# One wire block of the game→dispatcher→gate sync fan-out:
# [clientid(16)][sync record: eid(16) + x,y,z,yaw float32] — the canonical
# layout lives with the other wire dtypes in proto/conn.py.
from goworld_tpu_torch.proto.conn import (  # noqa: E402
    CLIENT_DELTA_SYNC_BLOCK_DTYPE,
    CLIENT_SYNC_BLOCK_DTYPE,
)

# --- adaptive per-client sync telemetry ([sync]; module-scope per R5) --------
_M_TIER_EDGES = telemetry.gauge(
    "sync_tier_edges",
    "Interest pairs per sync cadence tier at the last classification "
    "(tier 0 = full rate; higher tiers sync at 1/cadence).", ("tier",))
_M_SYNC_RECORDS = telemetry.counter(
    "sync_records_total",
    "Position-sync records emitted by the tiered collect, by encoding "
    "(keyframe = full-precision 48 B block, delta = quantized 40 B block).",
    ("kind",))
_M_SYNC_BYTES = telemetry.counter(
    "sync_wire_bytes_total",
    "Wire bytes of the game-side sync buffers, by encoding.", ("kind",))
_M_SYNC_SUPPRESSED = telemetry.counter(
    "sync_records_suppressed_total",
    "Neighbor sync rows gated off by their pair's cadence tier (the "
    "sublinear fan-out win, as a live counter).")
_M_BYTES_PER_CLIENT = telemetry.gauge(
    "sync_bytes_per_client_per_s",
    "Rolling sync wire bytes per bound client per second served by this "
    "game (~1 s window; live while [sync] tiering/quantization is on — "
    "the gwtop SYNC column's bytes half).")
_M_KEYFRAMES_FORCED = telemetry.counter(
    "sync_keyframes_forced_total",
    "Full-precision keyframes forced outside the periodic schedule "
    "(new_pair: first emission for a pair; rebind: the watcher's client "
    "changed since the baseline; teleport: delta overflowed the int16 "
    "range).", ("reason",))
_EMPTY = b""
_KIND_KEY = _M_SYNC_RECORDS.labels("keyframe")
_KIND_DELTA = _M_SYNC_RECORDS.labels("delta")
_BYTES_KEY = _M_SYNC_BYTES.labels("keyframe")
_BYTES_DELTA = _M_SYNC_BYTES.labels("delta")
_FORCED_NEW = _M_KEYFRAMES_FORCED.labels("new_pair")
_FORCED_REBIND = _M_KEYFRAMES_FORCED.labels("rebind")
_FORCED_TELEPORT = _M_KEYFRAMES_FORCED.labels("teleport")


class SyncTuning:
    """Resolved [sync] knobs on the slab store (config/read_config.py
    SyncConfig; defaults = the legacy full-rate/full-precision path)."""

    __slots__ = ("cadences", "quantize_bits", "step", "keyframe_interval",
                 "near_ratio", "far_ratio", "retier_interval", "enabled")

    def __init__(self, tier_cadences=(1,), quantize_bits=0,
                 keyframe_interval=32, near_ratio=0.5, far_ratio=0.8,
                 retier_interval=8) -> None:
        self.cadences = np.asarray(tier_cadences, np.int32)
        self.quantize_bits = int(quantize_bits)
        self.step = np.float32(2.0 ** -self.quantize_bits)
        self.keyframe_interval = int(keyframe_interval)
        self.near_ratio = float(near_ratio)
        self.far_ratio = float(far_ratio)
        self.retier_interval = int(retier_interval)
        # The legacy path is the special case of one full-rate tier and
        # full precision; anything else takes the tiered collect.
        self.enabled = len(self.cadences) > 1 or self.quantize_bits > 0


def classify_tiers(d2: np.ndarray, radius: np.ndarray, n_tiers: int,
                   near_ratio: float, far_ratio: float,
                   last_d2: np.ndarray | None = None) -> np.ndarray:
    """Distance/approach-rate tier classification, shared verbatim by the
    host re-tier pass and the test oracles (the device pass in
    ops/neighbor.py ``_tier_pass`` mirrors this formula in torch — pinned
    by parity tests).

    ratio = dist / watcher AOI radius: <= near_ratio -> tier 0,
    >= far_ratio -> the last tier, linear spread between. A pair whose
    distance SHRANK since the previous classification (``last_d2``) is
    approaching and drops one tier toward full rate — an inbound player
    must sharpen before arrival, not after."""
    r2 = np.maximum(radius.astype(np.float32) ** 2, np.float32(1e-12))
    ratio2 = d2 / r2
    span = max(far_ratio - near_ratio, 1e-9)
    frac = (np.sqrt(ratio2) - near_ratio) / span
    tier = 1 + np.floor(frac * (n_tiers - 1)).astype(np.int32)
    tier = np.clip(tier, 0, n_tiers - 1)
    tier[ratio2 <= near_ratio * near_ratio] = 0
    if last_d2 is not None:
        tier = np.where(d2 < last_d2, np.maximum(tier - 1, 0), tier)
    return tier.astype(np.uint8)


class _TickBucket:
    """Live entities of one on_tick_batch class: a dense entity list with a
    mirrored slot array (swap-remove keeps both O(1) per add/remove)."""

    __slots__ = ("entities", "slots", "index", "last_tick")

    def __init__(self) -> None:
        self.entities: list = []
        self.slots = np.empty(8, np.int32)
        self.index: dict[int, int] = {}  # id(entity) -> dense position
        self.last_tick = 0.0

    def add(self, entity, slot: int) -> None:
        key = id(entity)
        if key in self.index:
            return
        n = len(self.entities)
        if n == len(self.slots):
            self.slots = np.resize(self.slots, n * 2)
        self.entities.append(entity)
        self.slots[n] = slot
        self.index[key] = n

    def remove(self, entity) -> None:
        pos = self.index.pop(id(entity), None)
        if pos is None:
            return
        last = len(self.entities) - 1
        if pos != last:
            moved = self.entities[last]
            self.entities[pos] = moved
            self.slots[pos] = self.slots[last]
            self.index[id(moved)] = pos
        self.entities.pop()


class SlabTickView:
    """One class's entities as columns, handed to ``on_tick_batch``.

    ``x``/``y``/``z``/``yaw`` are float32 gathers (copies — mutate freely);
    ``entities`` is the matching object list and ``dt`` the seconds since
    this class's previous batch tick. ``set_position_yaw`` writes columns
    back, marks every written entity for own+neighbor client sync (the
    exact ``_set_position_yaw`` contract), and notifies non-columnar AOI
    backends; entities destroyed by the hook mid-batch are skipped.
    """

    __slots__ = ("_slabs", "_slots", "entities", "dt")

    def __init__(self, slabs: "EntitySlabs", slots: np.ndarray,
                 entities: list, dt: float) -> None:
        self._slabs = slabs
        self._slots = slots
        self.entities = entities
        self.dt = dt

    def __len__(self) -> int:
        return len(self.entities)

    @property
    def slots(self) -> np.ndarray:
        return self._slots

    @property
    def x(self) -> np.ndarray:
        return self._slabs.xz[self._slots, 0]

    @property
    def y(self) -> np.ndarray:
        return self._slabs.y[self._slots]

    @property
    def z(self) -> np.ndarray:
        return self._slabs.xz[self._slots, 1]

    @property
    def yaw(self) -> np.ndarray:
        return self._slabs.yaw[self._slots]

    def col(self, name: str) -> np.ndarray:
        """Gathered copy of a declared Column attr for this view's rows
        (entity/columns.py); mutate freely, write back via set_col."""
        return self._slabs.columns[name][self._slots]

    def set_col(self, name: str, values) -> None:
        """Write a Column attr for every row of the view. No sync flags —
        Column attrs stream per-entity via attrs.set(), not via the batch
        path (columns.py module docstring). Rows whose entity was
        destroyed mid-batch are quarantined slots; the stale write is
        harmless (defaults are rewritten at re-allocation)."""
        s = self._slabs
        s.columns[name][self._slots] = values
        # Host-side hook writes win over an in-flight fused tick's
        # writeback (aoi/batched.py _consume_fused).
        s.fused_dirty[self._slots] = True

    def set_position_yaw(self, x=None, y=None, z=None, yaw=None) -> None:
        s = self._slabs
        slots = self._slots
        entities = self.entities
        # A hook may destroy entities mid-batch (their slots are released/
        # quarantined); write only the still-live rows.
        alive = np.fromiter(
            (not getattr(e, "_destroyed", False) for e in entities),
            bool, count=len(entities))
        if not alive.all():
            idx = np.flatnonzero(alive)
            slots = slots[idx]
            entities = [entities[i] for i in idx]
            x = x if x is None else np.asarray(x)[idx]
            y = y if y is None else np.asarray(y)[idx]
            z = z if z is None else np.asarray(z)[idx]
            yaw = yaw if yaw is None else np.asarray(yaw)[idx]
        if x is not None:
            s.xz[slots, 0] = x
        if y is not None:
            s.y[slots] = y
        if z is not None:
            s.xz[slots, 1] = z
        if yaw is not None:
            s.yaw[slots] = yaw
        s.flags[slots] |= SIF_SYNC_OWN_CLIENT | SIF_SYNC_NEIGHBOR_CLIENTS
        # Host hook wrote positions: an in-flight fused tick's writeback
        # must not clobber them (aoi/batched.py _consume_fused).
        s.fused_dirty[slots] = True
        # Non-columnar AOI backends (xzlist) keep per-entity structures;
        # the batched manager reads positions from the slab directly
        # (positions_in_slabs) and needs no per-entity notification.
        if x is not None or z is not None:
            nx = s.xz[slots, 0]
            nz = s.xz[slots, 1]
            for i, e in enumerate(entities):
                sp = getattr(e, "space", None)
                if sp is None:
                    continue
                mgr = getattr(sp, "aoi_mgr", None)
                if mgr is None or getattr(mgr, "positions_in_slabs", False):
                    continue
                desc = getattr(e, "_type_desc", None)
                if desc is not None and desc.use_aoi:
                    mgr.moved(e, float(nx[i]), float(nz[i]))


def vmapped_position_tick(fn):
    """Lift a pure per-entity numeric function into an ``on_tick_batch``
    classmethod: ``fn(x, y, z, yaw, dt) -> (x, y, z, yaw)``, elementwise,
    applied to every live entity of the class in ONE call per tick on
    torch tensors. The column-free case of
    :func:`goworld_tpu_torch.entity.columns.columnar_tick`, which this
    delegates to — and therefore fusion-eligible like any columnar hook
    (``[aoi] fuse_logic`` runs ``fn`` inside the AOI step dispatch)."""
    return columnar_tick(fn, ())


class EntitySlabs:
    """The process-wide slab store: one slot per live entity."""

    def __init__(self, capacity: int = _INITIAL_CAPACITY) -> None:
        capacity = max(8, int(capacity))
        self.capacity = capacity
        self.xz = np.zeros((capacity, 2), np.float32)
        self.y = np.zeros(capacity, np.float32)
        self.yaw = np.zeros(capacity, np.float32)
        self.flags = np.zeros(capacity, np.uint8)
        self.syncing = np.zeros(capacity, np.uint8)
        self.gateid = np.zeros(capacity, np.int32)
        self.cid = np.zeros(capacity, "S16")
        # Mirror of `cid != b""` kept as bool so the per-collect masks are
        # byte-flag gathers, not 16-byte string compares.
        self.has_client = np.zeros(capacity, bool)
        self.eid = np.zeros(capacity, "S16")
        # Batched-AOI meta columns (the engine's active/space/radius inputs
        # live here so one growth path covers every per-slot array).
        self.active = np.zeros(capacity, bool)
        self.space_ids = np.zeros(capacity, np.int32)
        self.radius = np.zeros(capacity, np.float32)
        # Declared attr columns (entity/columns.py): one process-wide
        # array per Column attr name, allocated lazily on the first
        # entity of a declaring type and shared across types (specs must
        # match). Ride the same grow/quarantine/recycle machinery as the
        # built-in columns.
        self.columns: dict[str, np.ndarray] = {}
        self.column_specs: dict[str, ColumnSpec] = {}
        # Host-write fence for the fused tick (aoi/batched.py): a slot
        # whose position/yaw/columns were written host-side since the
        # last fused dispatch is skipped by that dispatch's writeback —
        # host writes (teleports, client sync, restore, release/realloc)
        # win over the in-flight device logic for that slot.
        self.fused_dirty = np.zeros(capacity, bool)
        self.entities: list = [None] * capacity
        self._free: list[int] = list(range(capacity - 1, -1, -1))
        self._quarantine: list[int] = []
        self.used = 0
        # Hard ceiling (multihost AOI slabs are fixed-size); None = grow.
        self.max_capacity: Optional[int] = None
        self.exhausted_hint = ""
        # The attached batched-AOI service, if any: released slots then
        # defer recycling to its dispatch/deliver cycle (see module doc).
        self.aoi_service = None
        # Interest edges, slot-indexed: edge (subject, watcher) exists iff
        # watcher.interested_in contains subject (maintained by
        # Entity.interest/uninterest). _edge_refs[slot] counts edges
        # touching a slot so release() can skip the purge scan when the
        # interest sets were already severed (the normal path).
        self._e_subj = np.zeros(_INITIAL_EDGES, np.int32)
        self._e_wat = np.zeros(_INITIAL_EDGES, np.int32)
        self._e_n = 0
        self._e_map: dict[int, int] = {}
        self._edge_refs = np.zeros(capacity, np.int32)
        # Adaptive-sync per-edge state ([sync]; swap-removed in tandem
        # with the edge itself): cadence tier, delta baseline (the exact
        # position the watcher's client last converged to), whether that
        # baseline is live, the clientid it was established against
        # (self-healing rebind detection), the collection at/after which
        # a periodic keyframe is due, unsent-movement pending, and the
        # distance^2 at the last classification (approach detection).
        self._e_tier = np.zeros(_INITIAL_EDGES, np.uint8)
        self._e_base = np.zeros((_INITIAL_EDGES, 4), np.float32)
        self._e_bvalid = np.zeros(_INITIAL_EDGES, bool)
        self._e_bcid = np.zeros(_INITIAL_EDGES, "S16")
        self._e_key_at = np.zeros(_INITIAL_EDGES, np.int64)
        self._e_pending = np.zeros(_INITIAL_EDGES, bool)
        self._e_last_d2 = np.full(_INITIAL_EDGES, np.inf, np.float32)
        # Edge-churn-only version (the broader _topo_version also counts
        # bindings/flags): guards the device tier writeback — a tier
        # vector computed against a different edge layout is discarded.
        self._edge_version = 0
        # Edge delta log for the fused interest-edge delivery (aoi/
        # batched.py): while a list is installed here (swapped fresh at
        # every AOI dispatch that ships device edge verdicts), every
        # edge add/remove appends its key so the decode can tell which
        # verdicts the pipelined delivery window made stale. None = off.
        self.edge_log: list | None = None
        # Own-client delta baselines, per SLOT (an entity syncing to its
        # own client rides full rate but still delta-encodes).
        self.own_base = np.zeros((capacity, 4), np.float32)
        self.own_bvalid = np.zeros(capacity, bool)
        self.own_bcid = np.zeros(capacity, "S16")
        self.own_key_at = np.zeros(capacity, np.int64)
        # [sync] tuning + collection sequence; device-pass bookkeeping
        # (True while an attached batched AOI service ships tiers inside
        # the engine launch — host re-tiering then stands down).
        self.sync = SyncTuning()
        self._collect_seq = 0
        self.device_tiers = False
        # ~1 s rolling window feeding sync_bytes_per_client_per_s.
        self._rate_stamp = time.monotonic()
        self._rate_bytes = 0
        # Per-class batched tick hooks (on_tick_batch classes only).
        self._tick_buckets: dict[type, _TickBucket] = {}
        # Steady-state sync-selection cache: a mover population that flags
        # the same slots with the same bits every collection (the common
        # case — avatars moving every tick) re-derives an IDENTICAL
        # selection, so the row selection, the per-gate grouping, and the
        # cid/eid halves of the wire blocks are reused verbatim and only
        # the position columns are refilled. Keyed by a topology version
        # bumped on every input the selection reads besides the flags
        # (interest edges, client bindings, syncing marks, slot release) +
        # a memcmp of the flagged slots/bits.
        self._topo_version = 0
        self._sync_cache = None  # (flagged, f, version, sel, out, gates_dict)
        telemetry.gauge(
            "entity_slab_capacity",
            "Allocated slot capacity of the entity slab store.",
        ).set_function(lambda: self.capacity)
        telemetry.gauge(
            "entity_slab_used",
            "Live (allocated, unreleased) entity slab slots.",
        ).set_function(lambda: self.used)

    # --- allocation ---------------------------------------------------------

    def alloc(self, entity) -> int:
        """Allocate a slot for ``entity`` (its row starts zeroed)."""
        if not self._free:
            if (self.max_capacity is not None
                    and self.capacity >= self.max_capacity):
                raise RuntimeError(
                    self.exhausted_hint
                    or f"entity slab capacity {self.capacity} exhausted")
            self._grow(self.capacity * 2)
        slot = self._free.pop()
        self.entities[slot] = entity
        self.used += 1
        cls = type(entity)
        desc = getattr(cls, "_type_desc", None)
        colspecs = getattr(desc, "column_attrs", None)
        if colspecs:
            for spec in colspecs.values():
                self.ensure_column(spec)[slot] = spec.default
        # A fresh allocation invalidates any in-flight fused writeback
        # aimed at this slot's previous tenant (aoi/batched.py).
        self.fused_dirty[slot] = True
        if getattr(cls, "on_tick_batch", None) is not None:
            self._tick_register(cls, entity, slot)
        return slot

    def ensure_column(self, spec: ColumnSpec) -> np.ndarray:
        """Get-or-create the slab column for ``spec``. Two entity types
        may share a column name only with an identical (dtype, default)
        spec — the storage is one array."""
        cur = self.column_specs.get(spec.name)
        if cur is not None:
            if cur != spec:
                raise ValueError(
                    f"Column {spec.name!r} redeclared with a different "
                    f"spec: {cur} vs {spec}")
            return self.columns[spec.name]
        arr = np.full(self.capacity, spec.default, spec.np_dtype)
        self.columns[spec.name] = arr
        self.column_specs[spec.name] = spec
        return arr

    def release(self, slot: int, entity=None) -> None:
        """Destroy-time release: clear the row's sync-visible columns (so
        the vectorized collect can never emit for it), purge any interest
        edges still referencing it, and quarantine or recycle the slot."""
        e = self.entities[slot] if entity is None else entity
        self._topo_version += 1
        self.flags[slot] = 0
        self.syncing[slot] = 0
        self.cid[slot] = b""
        self.has_client[slot] = False
        self.eid[slot] = b""
        self.gateid[slot] = 0
        # Delta-sync baselines die with the tenant: the next entity on
        # this slot must keyframe before any delta (own_bcid mismatch
        # would also catch it, but an explicit clear is cheaper to reason
        # about than a 16-byte compare saving us).
        self.own_bvalid[slot] = False
        self.own_bcid[slot] = b""
        # Columns reset to their declared defaults (a quarantined slot's
        # stale values must never leak into its next tenant) and the slot
        # is fenced against any in-flight fused writeback.
        for name, arr in self.columns.items():
            arr[slot] = self.column_specs[name].default
        self.fused_dirty[slot] = True
        if self.active[slot]:
            self.active[slot] = False
            if self.aoi_service is not None:
                self.aoi_service._meta_dirty = True
        if self._edge_refs[slot]:
            self._purge_edges(slot)
        if e is not None:
            cls = type(e)
            bucket = self._tick_buckets.get(cls)
            if bucket is not None:
                bucket.remove(e)
        self.used -= 1
        if self.aoi_service is not None:
            # The entity mapping survives quarantine: the in-flight engine
            # step may still deliver this slot's leave events.
            self._quarantine.append(slot)
        else:
            self.entities[slot] = None
            self._free.append(slot)

    def take_quarantine(self) -> list[int]:
        """Hand the current quarantine to the AOI dispatch that will observe
        these slots' deactivation (recycled via :meth:`recycle` after that
        step's events have been delivered)."""
        q = self._quarantine
        self._quarantine = []
        return q

    def recycle(self, slots) -> None:
        for slot in slots:
            self.entities[slot] = None
            self._free.append(slot)

    def ensure_capacity(self, n: int) -> None:
        if n > self.capacity:
            cap = self.capacity
            while cap < n:
                cap *= 2
            self._grow(max(cap, n))

    def _grow(self, n: int) -> None:
        old = self.capacity

        def pad(arr, shape, dtype):
            out = np.zeros(shape, dtype)
            out[: arr.shape[0]] = arr
            return out

        self.xz = pad(self.xz, (n, 2), np.float32)
        self.y = pad(self.y, (n,), np.float32)
        self.yaw = pad(self.yaw, (n,), np.float32)
        self.flags = pad(self.flags, (n,), np.uint8)
        self.syncing = pad(self.syncing, (n,), np.uint8)
        self.gateid = pad(self.gateid, (n,), np.int32)
        self.cid = pad(self.cid, (n,), "S16")
        self.has_client = pad(self.has_client, (n,), bool)
        self.eid = pad(self.eid, (n,), "S16")
        self.active = pad(self.active, (n,), bool)
        self.space_ids = pad(self.space_ids, (n,), np.int32)
        self.radius = pad(self.radius, (n,), np.float32)
        self.fused_dirty = pad(self.fused_dirty, (n,), bool)
        self.own_base = pad(self.own_base, (n, 4), np.float32)
        self.own_bvalid = pad(self.own_bvalid, (n,), bool)
        self.own_bcid = pad(self.own_bcid, (n,), "S16")
        self.own_key_at = pad(self.own_key_at, (n,), np.int64)
        for name, arr in self.columns.items():
            # New rows start at the column's declared default, not zero.
            spec = self.column_specs[name]
            grown = np.full(n, spec.default, arr.dtype)
            grown[: arr.shape[0]] = arr
            self.columns[name] = grown
        self._edge_refs = pad(self._edge_refs, (n,), np.int32)
        self.entities.extend([None] * (n - old))
        # New slots go UNDER existing free ones so pop() hands out the
        # lowest unused index first (keeps engine-visible slots dense).
        self._free = list(range(n - 1, old - 1, -1)) + self._free
        self.capacity = n

    # --- interest edges -----------------------------------------------------

    def edge_add(self, subj: int, watcher: int) -> None:
        key = (subj << 32) | watcher
        if key in self._e_map:
            return
        n = self._e_n
        if n == len(self._e_subj):
            self._e_subj = np.resize(self._e_subj, n * 2)
            self._e_wat = np.resize(self._e_wat, n * 2)
            self._e_tier = np.resize(self._e_tier, n * 2)
            base = np.zeros((n * 2, 4), np.float32)
            base[:n] = self._e_base
            self._e_base = base
            self._e_bvalid = np.resize(self._e_bvalid, n * 2)
            self._e_bcid = np.resize(self._e_bcid, n * 2)
            self._e_key_at = np.resize(self._e_key_at, n * 2)
            self._e_pending = np.resize(self._e_pending, n * 2)
            self._e_last_d2 = np.resize(self._e_last_d2, n * 2)
        self._e_subj[n] = subj
        self._e_wat[n] = watcher
        # Fresh pair: full rate until classified, no baseline — the
        # FIRST emission (the subject's next movement) is a forced
        # keyframe; until then the client renders the position the
        # CREATE_ENTITY_ON_CLIENT carried, exactly like the legacy path.
        self._e_tier[n] = 0
        self._e_bvalid[n] = False
        self._e_pending[n] = False
        self._e_last_d2[n] = np.inf
        self._e_map[key] = n
        self._e_n = n + 1
        self._edge_refs[subj] += 1
        self._edge_refs[watcher] += 1
        self._topo_version += 1
        self._edge_version += 1
        if self.edge_log is not None:
            self.edge_log.append(key)

    def edge_remove(self, subj: int, watcher: int) -> None:
        key = (subj << 32) | watcher
        idx = self._e_map.pop(key, None)
        if idx is None:
            return
        last = self._e_n - 1
        if idx != last:
            ls, lw = int(self._e_subj[last]), int(self._e_wat[last])
            self._e_subj[idx] = ls
            self._e_wat[idx] = lw
            self._e_tier[idx] = self._e_tier[last]
            self._e_base[idx] = self._e_base[last]
            self._e_bvalid[idx] = self._e_bvalid[last]
            self._e_bcid[idx] = self._e_bcid[last]
            self._e_key_at[idx] = self._e_key_at[last]
            self._e_pending[idx] = self._e_pending[last]
            self._e_last_d2[idx] = self._e_last_d2[last]
            self._e_map[(ls << 32) | lw] = idx
        self._e_n = last
        self._edge_refs[subj] -= 1
        self._edge_refs[watcher] -= 1
        self._topo_version += 1
        self._edge_version += 1
        if self.edge_log is not None:
            self.edge_log.append(key)

    def edge_count(self) -> int:
        return self._e_n

    def _purge_edges(self, slot: int) -> None:
        """Backstop for release(): drop edges still naming a slot whose
        interest sets were not severed (destroy outside any AOI space)."""
        n = self._e_n
        subj, wat = self._e_subj[:n], self._e_wat[:n]
        hits = np.flatnonzero((subj == slot) | (wat == slot))
        for s, w in [(int(subj[i]), int(wat[i])) for i in hits]:
            self.edge_remove(s, w)

    # --- vectorized sync collection ----------------------------------------

    def touch_sync_topology(self) -> None:
        """Invalidate the steady-state sync-selection cache. Called on every
        selection input EXCEPT the flags themselves: interest-edge changes,
        client bind/unbind, syncing-mark changes, slot release."""
        self._topo_version += 1

    def collect_sync_selection(self):
        """Stage 1 of the columnar ``collect_entity_sync_infos`` (the
        ``game_collect`` hop): select which (subject, destination) slot
        pairs emit a sync row this collection. Own-client rows are one
        boolean-mask gather over the flag slab (client bound, not
        client-driven); neighbor rows come from the slot-indexed interest
        edges (watcher has a client). Flags clear for every flagged slot,
        row or not — the legacy per-entity contract. Returns ``None`` when
        nothing is flagged, else an opaque selection for :meth:`pack_sync`.

        Steady-state fast path: when the flagged slots+bits are memcmp-
        identical to the previous collection and nothing the selection
        reads has changed since (``_topo_version``), the previous
        selection — including the per-gate grouping and the cid/eid halves
        of the wire blocks — is reused verbatim; only the float columns
        are refilled by pack_sync."""
        flags = self.flags
        flagged = np.flatnonzero(flags)
        if flagged.size == 0:
            return None
        f = flags[flagged]
        cache = self._sync_cache
        if (
            cache is not None
            and cache[2] == self._topo_version
            and np.array_equal(cache[0], flagged)
            and np.array_equal(cache[1], f)
        ):
            flags[flagged] = 0
            return cache
        has_client = self.has_client
        own = flagged[
            (f & SIF_SYNC_OWN_CLIENT).astype(bool)
            & has_client[flagged]
            & (self.syncing[flagged] == 0)
        ]
        n = self._e_n
        if n:
            subj, wat = self._e_subj[:n], self._e_wat[:n]
            m = (
                (flags[subj] & SIF_SYNC_NEIGHBOR_CLIENTS).astype(bool)
                & has_client[wat]
            )
            nsubj, nwat = subj[m], wat[m]
        else:
            nsubj = nwat = np.empty(0, np.int64)
        flags[flagged] = 0
        subjects = np.concatenate([own, nsubj])
        if subjects.size == 0:
            return None
        dests = np.concatenate([own, nwat])
        gates = self.gateid[dests]
        # Order rows by (gate, destination slot): per-gate buffers come out
        # as ONE contiguous slice each, and within a gate every client's
        # rows form a contiguous run — the gate's demux then slices runs
        # straight off the wire buffer without re-sorting (gate/service.py
        # _handle_sync_on_clients).
        if (gates == gates[0]).all():
            order = np.argsort(dests, kind="stable")
        else:
            order = np.argsort(
                (gates.astype(np.int64) << 32) | dests, kind="stable")
        so, do, gs = subjects[order], dests[order], gates[order]
        out = np.empty(len(so), CLIENT_SYNC_BLOCK_DTYPE)
        out["cid"] = self.cid[do]
        out["eid"] = self.eid[so]
        bounds = [0] + (np.flatnonzero(gs[1:] != gs[:-1]) + 1).tolist()
        bounds.append(len(gs))
        per_gate = {
            int(gs[bounds[i]]): out[bounds[i]:bounds[i + 1]]
            for i in range(len(bounds) - 1)
        }
        cache = (flagged, f, self._topo_version, (so, do, gs), out, per_gate)
        self._sync_cache = cache
        return cache

    def pack_sync(self, selection) -> dict[int, np.ndarray]:
        """Stage 2 (the ``game_pack`` hop): one structured array of
        [cid + sync record] wire blocks per destination gate, built by
        column assignment — zero Python row tuples. The cid/eid halves were
        filled when the selection was built (they are selection-invariant);
        this refills the position/yaw columns from the live slabs. The
        returned per-gate arrays are views into one shared buffer, valid
        until the next collection."""
        so = selection[3][0]
        out = selection[4]
        out["x"] = self.xz[so, 0]
        out["y"] = self.y[so]
        out["z"] = self.xz[so, 1]
        out["yaw"] = self.yaw[so]
        return selection[5]

    def collect_sync(self) -> dict[int, np.ndarray]:
        """Both stages in one call (tests / embedded drivers)."""
        sel = self.collect_sync_selection()
        return {} if sel is None else self.pack_sync(sel)

    # --- adaptive per-client sync ([sync]; ROADMAP item 5) -------------------

    def configure_sync(self, cfg) -> None:
        """Apply a [sync] section (config/read_config.py SyncConfig — any
        object with its fields works — or a pre-built SyncTuning).
        Defaults keep the legacy path."""
        if isinstance(cfg, SyncTuning):
            self.sync = cfg
            return
        self.sync = SyncTuning(
            tier_cadences=tuple(cfg.tier_cadences),
            quantize_bits=cfg.quantize_bits,
            keyframe_interval=cfg.keyframe_interval,
            near_ratio=cfg.near_ratio,
            far_ratio=cfg.far_ratio,
            retier_interval=cfg.retier_interval,
        )

    def _set_tier_gauges(self, tier: np.ndarray) -> None:
        counts = np.bincount(tier, minlength=len(self.sync.cadences))
        for i, c in enumerate(counts.tolist()):
            _M_TIER_EDGES.labels(str(i)).set(c)

    def retier_host(self) -> None:
        """Host-side tier classification of every interest pair: ONE
        vectorized sweep over the edge table amortizing all clients'
        range queries (the batched AOI engine's in-launch tier pass
        supersedes this — ops/neighbor.py — and writes the same column
        via :meth:`apply_device_tiers`)."""
        n = self._e_n
        if n == 0:
            return
        subj, wat = self._e_subj[:n], self._e_wat[:n]
        d = self.xz[subj] - self.xz[wat]
        d2 = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]
        sy = self.sync
        tier = classify_tiers(d2, self.radius[wat], len(sy.cadences),
                              sy.near_ratio, sy.far_ratio,
                              self._e_last_d2[:n])
        self._e_tier[:n] = tier
        self._e_last_d2[:n] = d2
        self._set_tier_gauges(tier)

    def snapshot_edges_for_tiering(self):
        """(edge_version, count, subj copy, wat copy) — what the batched
        AOI dispatch ships to the device tier pass. Copies, because the
        edge table swap-removes while the step is in flight."""
        n = self._e_n
        return (self._edge_version, n,
                self._e_subj[:n].copy(), self._e_wat[:n].copy())

    def apply_device_tiers(self, edge_version: int, count: int,
                           tiers: np.ndarray) -> bool:
        """Write a device-computed tier vector back, iff the edge layout
        is unchanged since the snapshot (edge churn between dispatch and
        writeback discards it — affected pairs keep their previous tier
        and brand-new pairs default to full rate: conservative, never
        stale)."""
        if edge_version != self._edge_version or count != self._e_n:
            return False
        if count:
            self._e_tier[:count] = tiers[:count]
            self._set_tier_gauges(self._e_tier[:count])
        return True

    def collect_sync_packets(self) -> dict[int, tuple[bytes, bytes]]:
        """The game-facing sync collection: per destination gate, a
        (full_records, delta_records) byte-buffer pair — full = 48 B
        [cid + keyframe] blocks for SYNC_POSITION_YAW_ON_CLIENTS, delta =
        40 B [cid + quantized delta] blocks for the v6
        SYNC_POSITION_YAW_DELTA_ON_CLIENTS. With the default [sync]
        config this is exactly the legacy full-rate path (same cache,
        same bytes, empty delta halves)."""
        if not self.sync.enabled:
            sel = self.collect_sync_selection()
            if sel is None:
                return {}
            return {g: (arr.tobytes(), b"")
                    for g, arr in self.pack_sync(sel).items()}
        out = self._collect_sync_tiered()
        return out if out is not None else {}

    def _emit_mask(self, seq: int):
        """Stage 1 of the tiered collect: which edges emit THIS collection.
        Movement latches per edge (``_e_pending``) so a mover's final
        position always flows out when its pair's tier next comes due —
        a tier-k pair is never staler than its cadence, and a stationary
        world emits nothing at any tier."""
        n = self._e_n
        if n == 0:
            return None
        sy = self.sync
        flags = self.flags
        subj, wat = self._e_subj[:n], self._e_wat[:n]
        pend = self._e_pending[:n]
        pend |= (flags[subj] & SIF_SYNC_NEIGHBOR_CLIENTS).astype(bool)
        watc = self.has_client[wat]
        cad = sy.cadences[self._e_tier[:n]]
        phase = (subj.astype(np.int64) * 2654435761 + wat) % cad
        due = (seq % cad) == phase
        bvalid = self._e_bvalid[:n]
        rebind = bvalid & (self._e_bcid[:n] != self.cid[wat])
        forced = (~bvalid) | rebind | (self._e_key_at[:n] <= seq)
        emit = pend & watc & (due | forced)
        suppressed = int(np.count_nonzero(pend & watc & ~emit))
        if suppressed:
            _M_SYNC_SUPPRESSED.inc(suppressed)
        eidx = np.flatnonzero(emit)
        pend[eidx] = False
        return eidx

    def _collect_sync_tiered(self) -> dict[int, tuple[bytes, bytes]] | None:
        """The tiered + delta-encoded collection (single stage: selection,
        quantization, baseline advance and wire pack in one vectorized
        pass — the steady-state cache doesn't apply because the due
        pattern cycles with the tier cadences).

        Encoding contract (mirrored by the client decode and pinned by the
        roundtrip fuzz in tests/test_synctier.py): a pair's first emission
        — and any emission after a client rebind, past the periodic
        keyframe schedule, or whose delta overflows int16 — is a KEYFRAME
        carrying exact float32 position/yaw; every other emission is a
        delta record of int16 multiples of 2^-quantize_bits. The sender's
        baseline advances by the QUANTIZED delta (never to the true
        position), so the receiver reconstructs the baseline bit-exactly
        and the error vs truth stays <= step/2 forever — quantization
        error cannot accumulate."""
        sy = self.sync
        seq = self._collect_seq
        self._collect_seq = seq + 1
        if (not self.device_tiers and len(sy.cadences) > 1
                and seq % sy.retier_interval == 0):
            self.retier_host()
        flags = self.flags
        flagged = np.flatnonzero(flags)
        eidx = self._emit_mask(seq)
        if flagged.size == 0 and (eidx is None or eidx.size == 0):
            return None
        if flagged.size:
            f = flags[flagged]
            own = flagged[
                (f & SIF_SYNC_OWN_CLIENT).astype(bool)
                & self.has_client[flagged]
                & (self.syncing[flagged] == 0)
            ]
            flags[flagged] = 0
        else:
            own = np.empty(0, np.int64)
        if eidx is None:
            eidx = np.empty(0, np.int64)
        es = self._e_subj[eidx]
        ew = self._e_wat[eidx]
        k_own = own.size
        rs = np.concatenate([own, es])  # subject slot per row
        rd = np.concatenate([own, ew])  # destination slot per row
        if rs.size == 0:
            return None
        pos = np.empty((rs.size, 4), np.float32)
        pos[:, 0] = self.xz[rs, 0]
        pos[:, 1] = self.y[rs]
        pos[:, 2] = self.xz[rs, 1]
        pos[:, 3] = self.yaw[rs]
        base = np.concatenate([self.own_base[own], self._e_base[eidx]])
        bvalid_raw = np.concatenate(
            [self.own_bvalid[own], self._e_bvalid[eidx]])
        cid_ok = np.concatenate(
            [self.own_bcid[own] == self.cid[own],
             self._e_bcid[eidx] == self.cid[ew]])
        bvalid = bvalid_raw & cid_ok
        key_at = np.concatenate(
            [self.own_key_at[own], self._e_key_at[eidx]])
        if sy.quantize_bits == 0:
            key = np.ones(rs.size, bool)
            qd = np.zeros((rs.size, 4), np.int16)
            new_base = pos
        else:
            qf = np.rint((pos - base) / sy.step)
            over = (np.abs(qf) > 32767.0).any(axis=1)
            key = (~bvalid) | over | (key_at <= seq)
            qd = qf.astype(np.int16)
            new_base = np.where(
                key[:, None], pos,
                base + qf.astype(np.float32) * sy.step)
            new_n = int(np.count_nonzero(~bvalid_raw))
            rebind_n = int(np.count_nonzero(bvalid_raw & ~cid_ok))
            tele_n = int(np.count_nonzero(over & bvalid))
            if new_n:
                _FORCED_NEW.inc(new_n)
            if rebind_n:
                _FORCED_REBIND.inc(rebind_n)
            if tele_n:
                _FORCED_TELEPORT.inc(tele_n)
        # Baseline/schedule advance, written back per source table.
        keyed = np.flatnonzero(key)
        new_key_at = np.where(key, seq + sy.keyframe_interval, key_at)
        self.own_base[own] = new_base[:k_own]
        self.own_bvalid[own] = True
        self.own_bcid[own] = self.cid[own]
        self.own_key_at[own] = new_key_at[:k_own]
        self._e_base[eidx] = new_base[k_own:]
        self._e_bvalid[eidx] = True
        self._e_bcid[eidx] = self.cid[ew]
        self._e_key_at[eidx] = new_key_at[k_own:]
        gates_r = self.gateid[rd]
        full = self._pack_rows(
            np.flatnonzero(key), rs, rd, gates_r, pos, qd,
            CLIENT_SYNC_BLOCK_DTYPE)
        delta = self._pack_rows(
            np.flatnonzero(~key), rs, rd, gates_r, pos, qd,
            CLIENT_DELTA_SYNC_BLOCK_DTYPE)
        if keyed.size:
            _KIND_KEY.inc(int(keyed.size))
            _BYTES_KEY.inc(int(keyed.size) * CLIENT_SYNC_BLOCK_DTYPE.itemsize)
        n_delta = rs.size - keyed.size
        if n_delta:
            _KIND_DELTA.inc(n_delta)
            _BYTES_DELTA.inc(n_delta * CLIENT_DELTA_SYNC_BLOCK_DTYPE.itemsize)
        self._rate_bytes += (
            int(keyed.size) * CLIENT_SYNC_BLOCK_DTYPE.itemsize
            + n_delta * CLIENT_DELTA_SYNC_BLOCK_DTYPE.itemsize)
        now = time.monotonic()
        if now - self._rate_stamp >= 1.0:
            clients = int(np.count_nonzero(self.has_client))
            _M_BYTES_PER_CLIENT.set(
                self._rate_bytes / (now - self._rate_stamp)
                / max(1, clients))
            self._rate_stamp = now
            self._rate_bytes = 0
        merged = {
            g: (full.get(g, _EMPTY), delta.get(g, _EMPTY))
            for g in (full.keys() | delta.keys())
        }
        return merged or None

    def _pack_rows(self, idx: np.ndarray, rs: np.ndarray, rd: np.ndarray,
                   gates_r: np.ndarray, pos: np.ndarray, qd: np.ndarray,
                   dtype: np.dtype) -> dict[int, bytes]:
        """Pack one encoding's rows into per-gate wire buffers, ordered by
        (gate, destination slot) so each client's records form one
        contiguous run for the gate's run-slicing demux."""
        if idx.size == 0:
            return {}
        g = gates_r[idx]
        order = np.argsort(
            (g.astype(np.int64) << 32) | rd[idx], kind="stable")
        idx = idx[order]
        g = g[order]
        out = np.empty(idx.size, dtype)
        out["cid"] = self.cid[rd[idx]]
        out["eid"] = self.eid[rs[idx]]
        if dtype is CLIENT_SYNC_BLOCK_DTYPE:
            out["x"] = pos[idx, 0]
            out["y"] = pos[idx, 1]
            out["z"] = pos[idx, 2]
            out["yaw"] = pos[idx, 3]
        else:
            out["dx"] = qd[idx, 0]
            out["dy"] = qd[idx, 1]
            out["dz"] = qd[idx, 2]
            out["dyaw"] = qd[idx, 3]
        bounds = [0] + (np.flatnonzero(g[1:] != g[:-1]) + 1).tolist()
        bounds.append(idx.size)
        return {
            int(g[bounds[i]]): out[bounds[i]:bounds[i + 1]].tobytes()
            for i in range(len(bounds) - 1)
        }

    # --- per-class batched tick hooks --------------------------------------

    def _tick_register(self, cls: type, entity, slot: int) -> None:
        bucket = self._tick_buckets.get(cls)
        if bucket is None:
            hook = inspect.getattr_static(cls, "on_tick_batch", None)
            if not isinstance(hook, (classmethod, staticmethod)):
                raise TypeError(
                    f"{cls.__name__}.on_tick_batch must be a classmethod "
                    f"(one call per CLASS per tick over a SlabTickView)")
            bucket = self._tick_buckets[cls] = _TickBucket()
            bucket.last_tick = time.monotonic()
        bucket.add(entity, slot)

    def prewarm_tick_hooks(self) -> None:
        """Dummy-shaped run of every adopted class's batched tick program
        at its CURRENT live population (columnar_tick.prewarm, with the
        class's declared column dtypes). The restore path calls this
        before the cluster re-handshake so the first live tick triggers
        no fresh trace; hooks without a prewarm surface (hand-written
        on_tick_batch bodies) are skipped — whatever they lazily build is
        their own contract. Classes the attached AOI service runs FUSED
        skip the per-class jit (it never executes there) and are instead
        covered by the service's fused-step prewarm, called at the end."""
        svc = self.aoi_service
        take = getattr(svc, "takes_over_tick", None)  # duck test doubles
        for cls, bucket in list(self._tick_buckets.items()):
            n = len(bucket.entities)
            if n == 0:
                continue
            if take is not None and take(cls):
                continue
            hook = inspect.getattr_static(cls, "on_tick_batch", None)
            fn = getattr(hook, "__func__", None)
            pw = getattr(fn, "prewarm", None)
            if pw is None:
                continue
            prog = getattr(fn, "fused_program", None)
            dtypes = None
            if prog is not None and prog.columns:
                dtypes = tuple(
                    self.column_specs[c].dtype for c in prog.columns
                    if c in self.column_specs) or None
            gwutils.run_panicless(
                lambda p=pw, k=n, d=dtypes: p(k, col_dtypes=d))
        pf = getattr(svc, "prewarm_fused", None)
        if pf is not None:
            gwutils.run_panicless(pf)

    def run_tick_batches(self, now: float | None = None) -> None:
        """Fire each adopted class's ``on_tick_batch`` once over its live
        entities (the vectorized replacement for per-entity timers).
        Classes the attached AOI service runs FUSED ([aoi] fuse_logic) are
        skipped: their program executes inside the engine step at the AOI
        cadence instead (aoi/batched.py). Their ``last_tick`` stays fresh
        so a later fallback to host-side execution resumes with a sane
        dt, not one spanning the whole fused period."""
        if not self._tick_buckets:
            return
        if now is None:
            now = time.monotonic()
        take = getattr(self.aoi_service, "takes_over_tick", None)
        for cls, bucket in list(self._tick_buckets.items()):
            n = len(bucket.entities)
            if n == 0:
                continue
            if take is not None and take(cls):
                bucket.last_tick = now
                continue
            dt = now - bucket.last_tick
            bucket.last_tick = now
            view = SlabTickView(
                self, bucket.slots[:n].copy(), list(bucket.entities), dt)
            gwutils.run_panicless(lambda c=cls, v=view: c.on_tick_batch(v))
