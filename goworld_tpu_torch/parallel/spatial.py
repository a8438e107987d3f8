"""Spatially sharded AOI: grid-column strips with halo exchange, the port of
``goworld_tpu.parallel.spatial``.

The torus's columns are split into D contiguous strips; each strip owns the
entity rows whose cell lies in it, and per tick the only cross-strip
traffic is the boundary bands (cells within one interaction radius of a
seam, both epochs) sent to the two ring neighbors. Two backends share that
halo layout, as in the JAX module:

- ``"kernel"`` (the JAX ``"pallas"``): each strip scatters its own + ghost
  rows into a strip-local dense cell slab
  ``[space_slots, gz+2, strip_cols+4, F, LANES]`` and runs the event kernel
  there, so the table sort, the kernel grid and the event drain are all
  strip-local.
- ``"reference"`` (the JAX ``"jnp"``): each strip queries its own rows
  through strip-local candidate-id matrices over its own + ghost rows
  (``_spatial_step_impl``), paged by flat index (``_spatial_drain``).

Ticks the strip invariants cannot cover (a teleport past the halo, a band
past ``halo_cap``, a strip past its row budget) run the exact all-gather
program (``parallel.mesh._sharded_step``) instead, on either backend.

A strip's device comes from the mesh (``parallel.mesh.make_mesh``), a list
of ``torch.device`` with repeats allowed, so D strips may share one card.
The collectives of the JAX ``shard_map`` body become device-side tensor
movement: a ``ppermute`` is a ``.to(neighbor's device)`` of the packed
bands, ``psum``/``pmax`` reduce per-strip device scalars, ``all_gather``
stacks them. Nothing in ``step_async`` waits on the device: the fast/slow
choice of the JAX ``lax.cond`` is a device-side select, as in
``ops.neighbor._step_pallas``.

Host-side layout (numpy, as in the JAX engine): entity->strip assignment
with one column of hysteresis, density re-plans, and a row permutation;
strip d's device rows hold the slots assigned to it, then inactive fill.
When any slot migrates, the previous epoch is re-uploaded in the new
layout, so the device diff never reads a migration as despawn + spawn.

Exactness contract (the same event sets as the single-device engine):
each query's 3x3 neighborhood, in both epochs, is fully present on its
owner; cell-capacity drops break ties by SLOT id
(``ops.neighbor.sorted_ranks_by``), so a seam cell's surviving set is the
same on every strip holding a copy, and the single-device engine's.

Fused entity logic (``logic=``, the service's ``[aoi] fuse_logic``) runs
each program on the strips' local rows, in the row-permuted layout, on the
strip tick and on the fallback tick alike.

Telemetry, under the JAX engine's family names (module scope here): the
strip count and the structural per-tick payloads at construction
(``aoi_shard_count``, ``aoi_halo_bytes_per_tick``,
``aoi_allgather_equiv_bytes_per_tick``); each dispatch's strip populations
(``aoi_shard_entities{shard}``) and migrations
(``aoi_shard_migrations_total``); on a strip tick the structural halo
bytes (``aoi_halo_bytes_total``) and each seam link's occupied band rows
(``aoi_link_bytes_total{tier="halo"}``); on a fallback tick its reason
(``aoi_shard_fallback_total{reason}``) and ``aoi_allgather_bytes_total``;
adopted re-plans (``aoi_shard_replans_total``) and seam-free fast ticks
(``aoi_spatial_fast_ticks_total``). A traced dispatch records a
``tick.halo`` span over its host layout with its ``migrations`` and
``mode``. ``aoi_strip_ring_distance{order}`` is registered and never set:
the JAX engine sets it only for devices with coords, and a
``torch.device`` has none, as a GPU rig's JAX device has none.

Each step program counts its own launches, ``jit_launches_total{fn}``
with ``fn`` ``spatial_step_kernel`` (``_spatial_step_pallas_impl``),
``spatial_step_reference`` (``_spatial_step_impl``) or, on a fallback tick,
``sharded_step`` (``parallel.mesh._sharded_step``), with ``_fused``
appended when entity logic rides it, as the JAX module's ``SentinelJit``
wrappers count calls of the programs themselves: a dispatch that ran two
programs counts two. The paging drains (``_spatial_drain_bits``,
``_spatial_drain``) are not steps and stay uncounted. Not ported: the
fallback prewarm thread (nothing compiles lazily here) and the
``placement`` option (a ``torch.device`` has no coords).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from goworld_tpu_torch import telemetry

from goworld_tpu_torch.ops.event_kernel import event_drain, event_mask
from goworld_tpu_torch.ops.neighbor import (
    LANES,
    _PACK,
    _FUSED_VARIANTS,
    HostArray,
    NeighborParams,
    _bins,
    _drain_bits,
    _f32,
    _drain_ids,
    _gather_cands,
    _pair_valid,
    _popcount16,
    _scatter_feats,
    bins_reference,
    check_radius,
    check_space_ids,
    sorted_ranks_by,
)
from goworld_tpu_torch.parallel.mesh import (
    _M_ALLGATHER_EQUIV,
    _M_ALLGATHER_TOTAL,
    _M_LINK_BYTES,
    ShardedPendingStep,
    _fused_rows,
    _sharded_drain,
    _sharded_step,
    _sharded_step_fused,
    all_gather,
    shard_rows,
)
from goworld_tpu_torch.telemetry import sentinel, tracing

_W = 9 * LANES // _PACK  # words per packed mask row

# The strip tier's families (the JAX engine's names, help texts and
# labels; see the module docstring).
_M_FAST_TICKS = telemetry.counter(
    "aoi_spatial_fast_ticks_total",
    "Spatial-engine ticks served by the seam-free single-pass fast path "
    "(replicated displacement guard held; leave diff rode the current "
    "grid).",
)
_M_RING_DISTANCE = telemetry.gauge(
    "aoi_strip_ring_distance",
    "Sum of interconnect (manhattan coord) distances between ring-adjacent "
    "strip devices, per placement order.",
    ("order",),
)
_M_SHARD_COUNT = telemetry.gauge(
    "aoi_shard_count",
    "Device shards of the spatially sharded AOI engine.",
)
_M_SHARD_ENTITIES = telemetry.gauge(
    "aoi_shard_entities",
    "Active entity rows owned by each AOI grid-strip shard at the last "
    "dispatch.",
    ("shard",),
)
_M_HALO_BYTES = telemetry.counter(
    "aoi_halo_bytes_total",
    "Bytes ppermuted between shards for AOI halo exchange (structural: "
    "halo_cap rows x 2 directions x D shards per spatial tick).",
)
_M_HALO_PER_TICK = telemetry.gauge(
    "aoi_halo_bytes_per_tick",
    "Structural ppermute payload of one spatial tick (halo_cap rows x 2 "
    "directions x D shards).",
)
_M_MIGRATIONS = telemetry.counter(
    "aoi_shard_migrations_total",
    "Entities reassigned to a different AOI grid-strip shard (hysteresis: "
    "one full cell past the seam).",
)
_M_FALLBACK = telemetry.counter(
    "aoi_shard_fallback_total",
    "Ticks the spatial engine ran the exact all-gather program instead of "
    "the halo exchange.",
    ("reason",),
)
_M_REPLANS = telemetry.counter(
    "aoi_shard_replans_total",
    "Density-driven strip re-plans adopted (equal-population boundary "
    "moves).",
)

# Halo feature-block bytes per exchanged row: f32 (px, pz, x, z) + i32
# (pspc, spc, slot) + bool (pact, act). Radius does NOT travel: the pair
# predicate only reads the QUERY side's radius, and queries never leave
# their owner.
HALO_ROW_BYTES = 4 * 4 + 3 * 4 + 2 * 1

# Minimum strip width (columns). 3 is the correctness floor (a 3-column
# halo band must not reach past the adjacent strip); 4 adds one column of
# margin so the band arithmetic never wraps into the same strip twice.
MIN_STRIP_COLS = 4


def _reduce(vals: list, op, mesh: list[torch.device]) -> list:
    """``psum``/``pmax`` of per-strip device scalars: ``op`` over the stack
    of every strip's value, on each strip's device. No host copy."""
    return [op(s) for s in all_gather(vals, mesh, stacked=True)]


def _exchange_halo(
    p: NeighborParams, mesh: list[torch.device],
    ppos_l, pact_l, pspc_l, prad_l,
    pos_l, act_l, spc_l, rad_l,
    slot_l, send_lo_idx, send_hi_idx,
):
    """The halo ``ppermute``: pack both seam bands of every strip, hand each
    to its ring neighbor (a ``.to`` of its device; on one card no copy),
    and return per strip the combined own+ghost feature arrays
    ([chunk + 2h] rows, own rows first). Band rows ``idx >= chunk`` are
    padding: slot ``capacity`` and inactive. Ghost rows' radius is zero:
    ghost queries are never extracted."""
    n = p.capacity
    n_dev = len(mesh)
    chunk = pos_l[0].shape[0]

    def pack_band(d, idx):
        safe = torch.clamp(idx, max=chunk - 1).long()
        pad = idx >= chunk
        f32b = torch.stack([ppos_l[d][safe, 0], ppos_l[d][safe, 1],
                            pos_l[d][safe, 0], pos_l[d][safe, 1]], dim=1)
        i32b = torch.stack([pspc_l[d][safe], spc_l[d][safe],
                            torch.where(pad, n, slot_l[d][safe])], dim=1)
        boolb = torch.stack([pact_l[d][safe] & ~pad,
                             act_l[d][safe] & ~pad], dim=1)
        return f32b, i32b, boolb

    lo_bands = [pack_band(d, send_lo_idx[d]) for d in range(n_dev)]
    hi_bands = [pack_band(d, send_hi_idx[d]) for d in range(n_dev)]
    out = []
    for d, dev in enumerate(mesh):
        # from_left = my predecessor's high-seam band; from_right = my
        # successor's low-seam band.
        fl = [b.to(dev) for b in hi_bands[(d - 1) % n_dev]]  # gwlint: ok R1 a device-to-device copy between shards; the host does not wait
        fr = [b.to(dev) for b in lo_bands[(d + 1) % n_dev]]  # gwlint: ok R1 a device-to-device copy between shards; the host does not wait
        zeros_h = torch.zeros(2 * fl[0].shape[0], dtype=torch.float32,
                              device=dev)
        out.append((
            torch.cat([pos_l[d], fl[0][:, 2:4], fr[0][:, 2:4]]),
            torch.cat([ppos_l[d], fl[0][:, 0:2], fr[0][:, 0:2]]),
            torch.cat([act_l[d], fl[2][:, 1], fr[2][:, 1]]),
            torch.cat([pact_l[d], fl[2][:, 0], fr[2][:, 0]]),
            torch.cat([spc_l[d], fl[1][:, 1], fr[1][:, 1]]),
            torch.cat([pspc_l[d], fl[1][:, 0], fr[1][:, 0]]),
            torch.cat([slot_l[d], fl[1][:, 2], fr[1][:, 2]]),
            torch.cat([rad_l[d], zeros_h]),
            torch.cat([prad_l[d], zeros_h]),
        ))
    return out


def _fast_guard_strip(p: NeighborParams, mesh: list[torch.device],
                      ppos_l, pact_l, pspc_l, prad_l, pos_l, act_l, spc_l,
                      dropped_total):
    """The seam-free single-pass guard, replicated across strips: the same
    eligibility as ``ops.neighbor._fast_guard`` (no deactivation, no space
    change, zero capacity drops, displacement small enough that every pair
    valid in EITHER epoch sits inside the CURRENT grid's 3x3 halo), with
    the per-strip scalars reduced over the mesh on the devices. Own rows
    partition the slot space, so the reductions cover every entity once.
    Returns one device bool per strip."""
    deact, spchg, disp2, prad_max = [], [], [], []
    for d in range(len(mesh)):
        both = pact_l[d] & act_l[d]
        deact.append(torch.any(pact_l[d] & ~act_l[d]).to(torch.int32))
        spchg.append(torch.any(both & (pspc_l[d] != spc_l[d])).to(torch.int32))
        dv = pos_l[d] - ppos_l[d]
        disp2.append(torch.max(torch.where(
            both, dv[:, 0] * dv[:, 0] + dv[:, 1] * dv[:, 1], 0.0)))
        prad_max.append(torch.max(torch.where(pact_l[d], prad_l[d], 0.0)))
    vmax = lambda s: s.max()  # noqa: E731
    deact_g = _reduce(deact, vmax, mesh)
    spchg_g = _reduce(spchg, vmax, mesh)
    disp_g = _reduce(disp2, vmax, mesh)
    prad_g = _reduce(prad_max, vmax, mesh)
    return [
        (deact_g[d] == 0) & (spchg_g[d] == 0) & (dropped_total[d] == 0)
        & (2.0 * torch.sqrt(disp_g[d]) + prad_g[d]
           <= _f32(p.cell_size, mesh[d]))
        for d in range(len(mesh))
    ]


# --- the reference strip backend ---------------------------------------------


def _build_table_spatial(p: NeighborParams, bucket, active, slots,
                         chunk: int):
    """Strip-local table build over the combined (own + ghost) rows, at the
    cell_capacity stride of the reference path. Table values are
    COMBINED-ROW indices (sentinel n_rows), and cell-capacity ties break by
    SLOT id, so every strip holding a copy of a seam cell drops the members
    the single-device engine drops. Returns (table, in_table bool[n_rows],
    own_dropped)."""
    n_rows = bucket.shape[0]
    dev = bucket.device
    m = p.cell_capacity
    key = torch.where(active, bucket, p.num_buckets)
    order, sorted_key, rank = sorted_ranks_by(key, slots, n_rows)
    ok = (sorted_key < p.num_buckets) & (rank < m)
    table_size = p.num_buckets * m
    dst = torch.where(ok, sorted_key * m + rank, table_size)
    # Dropped rows all land in one trailing trash entry, cut off after.
    table = torch.full((table_size + 1,), n_rows, dtype=torch.int32,
                       device=dev)
    table[dst.long()] = order
    in_table = torch.zeros(n_rows, dtype=torch.bool, device=dev)
    in_table[order.long()] = ok
    dropped_sorted = (sorted_key < p.num_buckets) & ~ok
    own_dropped = (dropped_sorted & (order < chunk)).sum(dtype=torch.int32)
    return table[:table_size], in_table, own_dropped


def _spatial_step_body(
    p: NeighborParams,
    events_inline: int,
    halo_cap: int,
    mesh: list[torch.device],
    ppos_l, pact_l, pspc_l, prad_l,
    pos_l, act_l, spc_l, rad_l,
    slot_l,
    send_lo_idx,
    send_hi_idx,
):
    """Every strip's reference step: the halo exchange, strip-local tables
    of both epochs over own + ghost rows, the own rows' candidate-id
    matrices and epoch masks. Each argument after ``mesh`` is a list over
    the strips. Returns lists over the strips of (enter_ids [chunk, 9M],
    leave_ids [chunk, 9M], out [3 + D + 2E, 2]); the id matrices hold SLOT
    ids (sentinel N), the inline pairs are slot-valued.

    The JAX body branches its leave pass with ``lax.cond`` on the
    replicated guard; here both branches run and the guard selects on the
    device."""
    n = p.capacity
    n_dev = len(mesh)
    chunk = pos_l[0].shape[0]
    n_all = chunk + 2 * halo_cap
    combined = _exchange_halo(
        p, mesh, ppos_l, pact_l, pspc_l, prad_l,
        pos_l, act_l, spc_l, rad_l, slot_l, send_lo_idx, send_hi_idx,
    )
    grids, own_drop = [], []
    for d in range(n_dev):
        (pos_all, ppos_all, act_all, pact_all, spc_all, pspc_all, slot_all,
         _, _) = combined[d]
        cxc, czc, smc = _bins(p, pos_all, spc_all)
        cxp, czp, smp = _bins(p, ppos_all, pspc_all)
        buc_c = (smc * p.grid_z + czc) * p.grid_x + cxc
        buc_p = (smp * p.grid_z + czp) * p.grid_x + cxp
        # Strip-local sorts over chunk + 2h keys.
        table_c, av_c, drop_c = _build_table_spatial(
            p, buc_c, act_all, slot_all, chunk)
        table_p, av_p, _ = _build_table_spatial(
            p, buc_p, pact_all, slot_all, chunk)
        own_drop.append(drop_c)
        grids.append((cxc, czc, smc, table_c, av_c,
                      cxp, czp, smp, table_p, av_p))
    dropped_total = _reduce(own_drop, lambda s: s.sum(dtype=torch.int32),
                            mesh)
    fast = _fast_guard_strip(p, mesh, ppos_l, pact_l, pspc_l, prad_l,
                             pos_l, act_l, spc_l, dropped_total)

    enter_ids, leave_ids, headers, pairs = [], [], [], []
    for d in range(n_dev):
        (pos_all, ppos_all, _, _, spc_all, pspc_all, slot_all, _,
         _) = combined[d]
        (cxc, czc, smc, table_c, av_c,
         cxp, czp, smp, table_p, av_p) = grids[d]
        f = fast[d]
        q_iota = torch.arange(chunk, dtype=torch.int32, device=mesh[d])

        def emask(cand, q_pos, q_av, q_spc, q_rad, pos_a, av_a, spc_a):
            safe = torch.clamp(cand, max=n_all - 1).long()
            not_self = (cand < n_all) & (cand != q_iota[:, None])
            return _pair_valid(
                q_av[:, None], q_spc[:, None], (q_rad * q_rad)[:, None],
                q_pos[:, 0][:, None], q_pos[:, 1][:, None],
                av_a[safe], spc_a[safe], pos_a[:, 0][safe],
                pos_a[:, 1][safe], not_self,
            )

        # Enter pass: candidates from the current grid, own rows as queries.
        cand_c = _gather_cands(p, table_c, cxc[:chunk], czc[:chunk],
                               smc[:chunk])
        vc = emask(cand_c, pos_l[d], av_c[:chunk], spc_l[d], rad_l[d],
                   pos_all, av_c, spc_all)
        vp_on_c = emask(cand_c, ppos_l[d], av_p[:chunk], pspc_l[d],
                        prad_l[d], ppos_all, av_p, pspc_all)
        enter_mask = vc & ~vp_on_c
        # Leave pass on both grids; the guard picks one.
        cand_p = _gather_cands(p, table_p, cxp[:chunk], czp[:chunk],
                               smp[:chunk])
        vp = emask(cand_p, ppos_l[d], av_p[:chunk], pspc_l[d], prad_l[d],
                   ppos_all, av_p, pspc_all)
        vc_on_p = emask(cand_p, pos_l[d], av_c[:chunk], spc_l[d], rad_l[d],
                        pos_all, av_c, spc_all)
        leave_mask = torch.where(f, vp_on_c & ~vc, vp & ~vc_on_p)
        cand_l = torch.where(f, cand_c, cand_p)
        del vc, vp_on_c, vp, vc_on_p, cand_p

        def slot_of(cand):
            return slot_all[torch.clamp(cand, max=n_all - 1).long()]

        e_ids = torch.where(enter_mask, slot_of(cand_c), n)
        l_ids = torch.where(leave_mask, slot_of(cand_l), n)
        n_enters = enter_mask.sum(dtype=torch.int32)
        n_leaves = leave_mask.sum(dtype=torch.int32)
        del enter_mask, leave_mask, cand_c, cand_l

        def slotize(pr):
            ent = pr[:, 0]
            ent = torch.where(
                ent < chunk,
                slot_l[d][torch.clamp(ent, max=chunk - 1).long()], n)
            return torch.stack([ent, pr[:, 1]], dim=1)

        ep, ei = _drain_ids(e_ids, n, events_inline, 0)
        lp, li = _drain_ids(l_ids, n, events_inline, 0)
        headers.append(torch.stack([
            torch.stack([n_enters, n_leaves]),
            torch.stack([dropped_total[d], f.to(torch.int32)]),
            torch.stack([ei[events_inline - 1], li[events_inline - 1]]),
        ]).to(torch.int32))
        pairs.append((slotize(ep), slotize(lp)))
        enter_ids.append(e_ids)
        leave_ids.append(l_ids)
    # Replicated per-strip counts, as parallel.mesh._sharded_step.
    counts_all = all_gather([h[0] for h in headers], mesh, stacked=True)
    outs = [
        torch.cat([headers[d], counts_all[d], *pairs[d]], dim=0)
        for d in range(n_dev)
    ]
    return enter_ids, leave_ids, outs


def _spatial_step_impl(*args):
    """The reference strip step (``_spatial_step_body``'s arguments and
    results), counted as one ``spatial_step_reference`` launch."""
    sentinel.note_launch("spatial_step_reference")
    return _spatial_step_body(*args)


def _spatial_step_fused_impl(
    p: NeighborParams,
    events_inline: int,
    halo_cap: int,
    mesh: list[torch.device],
    programs,
    ppos_l, pact_l, pspc_l, prad_l,
    pos_l, act_l, spc_l, rad_l,
    slot_l,
    send_lo_idx,
    send_hi_idx,
    y_l, yaw_l, sel_l, dt_l, *cols_l,
):
    """The reference strip step plus fused entity logic on each strip's
    LOCAL rows (row-permuted inputs, perm-snapshot writeback, as the kernel
    tier's). Returns the step's (enter_ids, leave_ids, out) and the fused
    outputs in ROW order on the first strip's device. One
    ``spatial_step_reference_fused`` launch."""
    sentinel.note_launch("spatial_step_reference_fused")
    res = _spatial_step_body(
        p, events_inline, halo_cap, mesh,
        ppos_l, pact_l, pspc_l, prad_l,
        pos_l, act_l, spc_l, rad_l,
        slot_l, send_lo_idx, send_hi_idx,
    )
    fused = _fused_rows(programs, mesh, pos_l, y_l, yaw_l, sel_l, dt_l,
                        cols_l)
    return res + (fused,)


def _spatial_drain(
    p: NeighborParams, events_inline: int, chunk: int,
    ids_l: torch.Tensor,  # [chunk, 9M] this strip's SLOT-id event matrix
    slot_l: torch.Tensor,  # [chunk] row -> slot (dispatch-time perm)
    start: int,  # resume cursor (local flat index)
):
    """Reference strip storm paging: (pairs [E, 2] slot-valued, flat
    positions [E])."""
    n = p.capacity
    pairs, idx = _drain_ids(ids_l, n, events_inline, start)
    ent = pairs[:, 0]
    ent = torch.where(ent < chunk,
                      slot_l[torch.clamp(ent, max=chunk - 1).long()], n)
    return torch.stack([ent, pairs[:, 1]], dim=1), idx


# --- the strip kernel slab ----------------------------------------------------
#
# Column geometry per strip (w = this strip's width, offsets mod grid_x):
#
#   world column:  lo-2  lo-1  lo ... hi-1   hi   hi+1
#   local column:    0     1    2 ...  w+1   w+2   w+3      (lx)
#   role:          ghost  QUERY ...... QUERY QUERY ghost
#
# Own rows may sit one column outside the strip (the hysteresis slack), so
# query columns span [lo-1, hi] and candidate columns [lo-2, hi+1]: exactly
# the 3-column seam bands the halo exchange ships. The slab's x extent is
# the static cols_cap + 4; z keeps the torus wrap; columns past this
# strip's width are NaN cells the kernel skims through.


def _build_table_strip(p: NeighborParams, bucket, active, slots,
                       num_buckets: int, chunk: int):
    """Strip-local LANES-stride table for the kernel slab. Capacity ties
    break by SLOT id (seam cells exist as copies on two strips: the drop
    set must be identical everywhere, and the single-device engine's).
    Table values are SLOT ids (sentinel N); ``tpos`` is each combined row's
    flat table position (-1 = dropped/absent), whose % LANES is the row's
    kernel lane. Returns (table, tpos, own_dropped, order, dst)."""
    n_rows = bucket.shape[0]
    dev = bucket.device
    cap = min(p.cell_capacity, LANES)
    key = torch.where(active, bucket, num_buckets)
    order, sorted_key, rank = sorted_ranks_by(key, slots, n_rows)
    ok = (sorted_key < num_buckets) & (rank < cap)
    table_size = num_buckets * LANES
    dst = torch.where(ok, sorted_key * LANES + rank, table_size)
    # Dropped rows all land in one trailing trash entry, cut off after.
    table = torch.full((table_size + 1,), p.capacity, dtype=torch.int32,
                       device=dev)
    table[dst.long()] = slots[order.long()].to(torch.int32)
    tpos = torch.empty(n_rows, dtype=torch.int32, device=dev)
    tpos[order.long()] = torch.where(ok, dst, -1).to(torch.int32)
    dropped_sorted = (sorted_key < num_buckets) & ~ok
    own_dropped = (dropped_sorted & (order < chunk)).sum(dtype=torch.int32)
    return table[:table_size], tpos, own_dropped, order, dst


def _scatter_slotown(p: NeighborParams, dst, order, slot_all, chunk: int,
                     gx_ext: int):
    """Dense slot/own plane for the in-kernel drain: the cell slab's
    geometry with two i32 planes per lane in place of the F float features.
    Plane 0 is the tabled lane's SLOT id (sentinel ``capacity``), plane 1
    its OWN flag (row < chunk: ghost rows emit nothing; their owner strip
    emits their events). Same one-scatter build and z-wrap ring as
    ``_scatter_feats``; x ghost columns are physical."""
    dev = dst.device
    n_rows = slot_all.shape[0]
    gz = p.grid_z
    table_size = p.space_slots * gz * gx_ext * LANES
    own = (torch.arange(n_rows, device=dev) < chunk).to(torch.int32)
    vals = torch.stack([slot_all.to(torch.int32), own], dim=1)  # [N, 2]
    flat = torch.zeros((table_size + 1, 2), dtype=torch.int32, device=dev)
    flat[:, 0] = p.capacity
    flat[dst.long()] = vals[order.long()]
    plane = flat[:table_size].view(p.space_slots, gz, gx_ext, LANES, 2)
    plane = plane.permute(0, 1, 2, 4, 3)  # [S, gz, gxe, 2, LANES]
    zi = torch.remainder(torch.arange(-1, gz + 1, device=dev), gz)
    return plane[:, zi].contiguous()


def _spatial_step_strips(
    p: NeighborParams,
    events_inline: int,
    halo_cap: int,
    cols_cap: int,
    drain_inline: int,
    mesh: list[torch.device],
    ppos_l, pact_l, pspc_l, prad_l,
    pos_l, act_l, spc_l, rad_l,
    slot_l,
    send_lo_idx,
    send_hi_idx,
    strip_lo: list[int],  # each strip's first owned column
):
    """Every strip's step on its kernel slab (see the section comment).
    Each argument after ``mesh`` is a list over the strips. Returns
    (enter_ctx, leave_ctx, out) lists over the strips: the paging contexts
    (packed words, strip-local bin coords and slot table of the pass) and
    the packed block [3 + D + 2E, 2].

    ``drain_inline > 0`` takes the event kernel's drain form: the launch
    itself emits the compacted (query slot, other slot) pairs. The JAX body
    branches with ``lax.cond``; here the dual form always runs on the
    current slab (its enter words and pairs are the single form's), the
    single form runs on the previous slab with ``skip`` = the guard, and
    the leave words, pairs and grid are selected on the device."""
    n = p.capacity
    n_dev = len(mesh)
    chunk = pos_l[0].shape[0]
    gz = p.grid_z
    gxe = cols_cap + 4  # slab x extent: query cols + 2 ghost cols per side
    qcols = cols_cap + 2  # kernel grid columns (strip + hysteresis slack)
    nb_local = p.space_slots * gz * gxe
    nan = float("nan")

    combined = _exchange_halo(
        p, mesh, ppos_l, pact_l, pspc_l, prad_l,
        pos_l, act_l, spc_l, rad_l, slot_l, send_lo_idx, send_hi_idx,
    )
    grids, own_drop = [], []
    for d in range(n_dev):
        (pos_all, ppos_all, act_all, pact_all, spc_all, pspc_all, slot_all,
         _, _) = combined[d]
        cxc, czc, smc = _bins(p, pos_all, spc_all)
        cxp, czp, smp = _bins(p, ppos_all, pspc_all)
        base = int(strip_lo[d]) - 2  # gwlint: ok R1 strip_lo is the host plan's numpy column bounds
        lxc = torch.remainder(cxc - base, p.grid_x).to(torch.int32)
        lxp = torch.remainder(cxp - base, p.grid_x).to(torch.int32)
        # Rows outside the slab's column span (a ghost's OTHER epoch far
        # from the seam) are absent from that epoch's strip table,
        # NaN-poisoned like a capacity drop: exact, since any pair they
        # could carry with an own query is > cell_size apart there.
        in_c = lxc < gxe
        in_p = lxp < gxe
        buc_c = torch.where(in_c, (smc * gz + czc) * gxe + lxc, nb_local)
        buc_p = torch.where(in_p, (smp * gz + czp) * gxe + lxp, nb_local)
        table_c, tpos_c, drop_c, order_c, dst_c = _build_table_strip(
            p, buc_c, act_all & in_c, slot_all, nb_local, chunk)
        table_p, tpos_p, _, order_p, dst_p = _build_table_strip(
            p, buc_p, pact_all & in_p, slot_all, nb_local, chunk)
        own_drop.append(drop_c)
        grids.append((lxc, czc, smc, table_c, tpos_c, order_c, dst_c,
                      lxp, czp, smp, table_p, tpos_p, order_p, dst_p))
    dropped_total = _reduce(own_drop, lambda s: s.sum(dtype=torch.int32),
                            mesh)
    fast = _fast_guard_strip(p, mesh, ppos_l, pact_l, pspc_l, prad_l,
                             pos_l, act_l, spc_l, dropped_total)

    def extract(packed_cells, lx, cz, sm, tpos):
        """Packed event words of the OWN rows binned in this slab."""
        lane = torch.remainder(tpos[:chunk], LANES)
        ocol = lx[:chunk] - 1  # kernel output col: slab col minus ghost col
        flat = packed_cells.reshape(-1, packed_cells.shape[-1])
        oflat = ((sm[:chunk] * gz + cz[:chunk]) * qcols + ocol) * LANES + lane
        mine = (tpos[:chunk] >= 0) & (ocol >= 0) & (ocol < qcols)
        safe = torch.clamp(oflat, 0, flat.shape[0] - 1).long()
        return torch.where(mine[:, None], flat[safe], 0)

    enter_ctx, leave_ctx, headers, pairs = [], [], [], []
    for d in range(n_dev):
        (pos_all, ppos_all, _, _, spc_all, pspc_all, slot_all, rad_all,
         prad_all) = combined[d]
        (lxc, czc, smc, table_c, tpos_c, order_c, dst_c,
         lxp, czp, smp, table_p, tpos_p, order_p, dst_p) = grids[d]
        f = fast[d]
        # Each epoch's x row poisoned by its OWN table validity.
        xs_c = torch.where(tpos_c >= 0, pos_all[:, 0], nan)
        xs_p = torch.where(tpos_p >= 0, ppos_all[:, 0], nan)
        cur_feats = (xs_c, pos_all[:, 1], spc_all, rad_all)
        prev_feats = (xs_p, ppos_all[:, 1], pspc_all, prad_all)
        cells_c = _scatter_feats(p, dst_c, order_c, cur_feats, prev_feats,
                                 gx_ext=gxe)
        cells_p = _scatter_feats(p, dst_p, order_p, prev_feats, cur_feats,
                                 gx_ext=gxe)
        if drain_inline:
            so_c = _scatter_slotown(p, dst_c, order_c, slot_all, chunk, gxe)
            so_p = _scatter_slotown(p, dst_p, order_p, slot_all, chunk, gxe)
            pk2, prs2 = event_drain(cells_c, so_c, True, drain_inline, n)
            # Epoch symmetry: the previous slab's "enter" mask
            # (valid_prev & ~valid_cur) IS the leave set.
            pk_p, prs_p = event_drain(cells_p, so_p, False, drain_inline, n,
                                      skip=f)
        else:
            pk2 = event_mask(cells_c, True)
            pk_p = event_mask(cells_p, False, skip=f)
        del cells_c, cells_p
        rows2 = extract(pk2, lxc, czc, smc, tpos_c)  # [chunk, 2W]
        rows_p = extract(pk_p, lxp, czp, smp, tpos_p)  # [chunk, W]
        del pk2, pk_p
        packed_e = rows2[:, :_W]
        packed_l = torch.where(f, rows2[:, _W:], rows_p)
        l_lx = torch.where(f, lxc[:chunk], lxp[:chunk])
        l_cz = torch.where(f, czc[:chunk], czp[:chunk])
        l_sm = torch.where(f, smc[:chunk], smp[:chunk])
        l_table = torch.where(f, table_c, table_p)
        n_enters = _popcount16(packed_e).sum(dtype=torch.int32)
        n_leaves = _popcount16(packed_l).sum(dtype=torch.int32)

        if drain_inline:
            # Kernel pairs are slot-valued and own-masked already.
            ep = prs2[:, :drain_inline].T
            lp = torch.where(f, prs2[:, drain_inline:2 * drain_inline],
                             prs_p[:, :drain_inline]).T
        else:
            def slotize(pr):
                ent = pr[:, 0]
                ent = torch.where(
                    ent < chunk,
                    slot_l[d][torch.clamp(ent, max=chunk - 1).long()], n)
                return torch.stack([ent, pr[:, 1]], dim=1)

            ep, _ = _drain_bits(p, packed_e, lxc[:chunk], czc[:chunk],
                                smc[:chunk], table_c, 0,
                                max_events=events_inline, gx_ext=gxe,
                                wrap_x=False)
            lp, _ = _drain_bits(p, packed_l, l_lx, l_cz, l_sm, l_table, 0,
                                max_events=events_inline, gx_ext=gxe,
                                wrap_x=False)
            ep, lp = slotize(ep), slotize(lp)
        zero = torch.zeros((), dtype=torch.int32, device=mesh[d])
        headers.append(torch.stack([
            torch.stack([n_enters, n_leaves]),
            torch.stack([dropped_total[d], f.to(torch.int32)]),
            torch.stack([zero, zero]),  # rank paging resumes at E
        ]).to(torch.int32))
        pairs.append((ep, lp))
        enter_ctx.append((packed_e, lxc[:chunk], czc[:chunk], smc[:chunk],
                          table_c))
        leave_ctx.append((packed_l, l_lx, l_cz, l_sm, l_table))
    # Replicated per-strip counts, as parallel.mesh._sharded_step.
    counts_all = all_gather([h[0] for h in headers], mesh, stacked=True)
    outs = [
        torch.cat([headers[d], counts_all[d], *pairs[d]], dim=0)
        for d in range(n_dev)
    ]
    return enter_ctx, leave_ctx, outs


def _spatial_step_pallas_impl(*args):
    """The strip step program (``_spatial_step_strips``'s arguments and
    results), counted as one ``spatial_step_kernel`` launch."""
    sentinel.note_launch("spatial_step_kernel")
    return _spatial_step_strips(*args)


def _spatial_step_pallas_fused_impl(
    p: NeighborParams,
    events_inline: int,
    halo_cap: int,
    cols_cap: int,
    drain_inline: int,
    mesh: list[torch.device],
    programs,
    ppos_l, pact_l, pspc_l, prad_l,
    pos_l, act_l, spc_l, rad_l,
    slot_l,
    send_lo_idx,
    send_hi_idx,
    strip_lo: list[int],
    y_l, yaw_l, sel_l, dt_l, *cols_l,
):
    """The strip step plus fused entity logic on each strip's LOCAL rows:
    the same logic contract as the fallback's ``_sharded_step_fused``
    (row-permuted inputs, perm-snapshot writeback). Returns the strip
    step's (enter_ctx, leave_ctx, out) and the fused outputs in ROW order
    on the first strip's device. One ``spatial_step_kernel_fused``
    launch."""
    sentinel.note_launch("spatial_step_kernel_fused")
    res = _spatial_step_strips(
        p, events_inline, halo_cap, cols_cap, drain_inline, mesh,
        ppos_l, pact_l, pspc_l, prad_l,
        pos_l, act_l, spc_l, rad_l,
        slot_l, send_lo_idx, send_hi_idx, strip_lo,
    )
    fused = _fused_rows(programs, mesh, pos_l, y_l, yaw_l, sel_l, dt_l,
                        cols_l)
    return res + (fused,)


def _spatial_drain_bits(
    p: NeighborParams, events_inline: int, cols_cap: int,
    packed_l,  # [chunk, W] this strip's own-row packed event words
    lx_l, cz_l, sm_l,  # [chunk] strip-local bin coords of the pass's grid
    table_l,  # [nb_local * LANES] slot-id table of the pass's grid
    slot_l,  # [chunk] row -> slot (dispatch-time perm snapshot)
    start: int,  # resume EVENT RANK
):
    """Strip storm paging: rank-select past the inline budget, own rows
    mapped to slots through the dispatch-time perm snapshot."""
    n = p.capacity
    chunk = packed_l.shape[0]
    pairs, total = _drain_bits(
        p, packed_l, lx_l, cz_l, sm_l, table_l, start,
        max_events=events_inline, gx_ext=cols_cap + 4, wrap_x=False,
    )
    ent = pairs[:, 0]
    ent = torch.where(ent < chunk,
                      slot_l[torch.clamp(ent, max=chunk - 1).long()], n)
    return torch.stack([ent, pairs[:, 1]], dim=1), total


def plan_strips(
    col_pop: np.ndarray, n_dev: int, min_cols: int = MIN_STRIP_COLS,
    max_cols: int | None = None,
) -> np.ndarray:
    """Equal-population strip boundaries from an observed column histogram.

    Returns int32[D+1] with boundaries[0] == 0 and boundaries[D] == grid_x.
    Each strip gets >= min_cols columns (the halo-correctness floor); the
    split otherwise walks the population cumsum so every strip carries
    ~1/D of the entities. ``max_cols`` caps every strip's width (the kernel
    slab's static extent); requires n_dev * max_cols >= grid_x.
    """
    gx = len(col_pop)
    if gx < n_dev * min_cols:
        raise ValueError(
            f"grid_x {gx} < {n_dev} shards * {min_cols} min columns"
        )
    if max_cols is not None and gx > n_dev * max_cols:
        raise ValueError(
            f"grid_x {gx} > {n_dev} shards * {max_cols} max columns"
        )
    cum = np.concatenate([[0], np.cumsum(col_pop, dtype=np.int64)])
    total = cum[-1]
    bounds = np.zeros(n_dev + 1, np.int32)
    bounds[n_dev] = gx
    for d in range(1, n_dev):
        target = total * d // n_dev
        b = int(np.searchsorted(cum, target, side="left"))
        # Clamp so every strip (including the ones still to come) keeps
        # its minimum width, and, under a width cap, so no strip placed
        # or remaining can exceed it.
        b = max(b, int(bounds[d - 1]) + min_cols)
        b = min(b, gx - (n_dev - d) * min_cols)
        if max_cols is not None:
            b = min(b, int(bounds[d - 1]) + max_cols)
            b = max(b, gx - (n_dev - d) * max_cols)
        bounds[d] = b
    return bounds


def ring_link_distance(coords: list, order: np.ndarray) -> int:
    """Total interconnect distance of the strip ring under a device order:
    the sum of manhattan distances between consecutive (and wrap-around)
    devices' coordinates."""
    k = len(order)
    total = 0
    for i in range(k):
        a = coords[int(order[i])]
        b = coords[int(order[(i + 1) % k])]
        total += sum(abs(int(x) - int(y)) for x, y in zip(a, b))
    return total


def plan_placement(devices: list) -> np.ndarray:
    """Topology-aware strip->device placement: an index permutation
    ``order`` such that ``devices[order[i]]`` hosts strip i. Devices that
    expose mesh ``coords`` are walked in a boustrophedon (snake) over
    (z, y, x), same-chip cores consecutive; the snake is adopted only when
    it strictly beats the given order's ring distance. Devices without
    coords (``torch.device`` has none) keep ring order (identity)."""
    k = len(devices)
    ident = np.arange(k, dtype=np.int64)
    coords = [getattr(d, "coords", None) for d in devices]
    if k < 2 or any(c is None for c in coords):
        return ident
    coords = [tuple(int(v) for v in c) + (0, 0, 0) for c in coords]
    coords = [c[:3] for c in coords]
    ys = sorted({c[1] for c in coords})
    yi = {v: i for i, v in enumerate(ys)}

    def key(i: int):
        x, y, z = coords[i]
        core = int(getattr(devices[i], "core_on_chip", 0) or 0)
        yr = yi[y] if z % 2 == 0 else len(ys) - 1 - yi[y]
        xr = x if (z + yi[y]) % 2 == 0 else -x
        return (z, yr, xr, core)

    snake = np.asarray(sorted(range(k), key=key), dtype=np.int64)
    if ring_link_distance(coords, snake) < ring_link_distance(coords, ident):
        return snake
    return ident


class SpatialShardedNeighborEngine:
    """Grid-strip sharded AOI engine (see the module docstring).

        mesh = make_mesh(8)            # 8 strips on the current card
        eng = SpatialShardedNeighborEngine(params, mesh)
        eng.reset()
        enters, leaves, dropped = eng.step(pos, active, space, radius)

    ``reset`` / ``step_async`` / ``step``, one packed readback per tick,
    paging past the per-strip inline budget. Observability: ``last_mode``
    ("spatial" | "fallback:<reason>"), ``last_fast_tick`` (the seam-free
    guard held on the last collected tick), ``shard_population`` (active
    rows per strip at the last dispatch), ``halo_bytes_per_tick`` and
    ``allgather_bytes_per_tick`` (structural payloads), and the counters
    ``total_fast_ticks``, ``total_migrations``, ``total_fallbacks``,
    ``total_replans``, each also on ``/metrics`` (the module docstring).

    ``backend``: "kernel" ("auto" means "kernel"), the strip-local event
    kernel slab, or "reference", the strip-local candidate-id matrices.
    ``inkernel_drain`` (kernel backend): the kernel's drain form emits the
    inline pairs (default); False takes the mask forms and the strip-local
    rank-select drain, the same events. ``strip_cols`` caps a strip's width
    (the kernel slab's static extent; the reference backend has no cap). Strip i lives at ``mesh[i]``: a
    ``torch.device`` has no coords, so ``plan_placement`` would keep this
    order anyway.
    """

    def __init__(
        self,
        params: NeighborParams,
        mesh: list[torch.device],
        halo_cap: int | None = None,
        replan_interval: int = 64,
        backend: str = "auto",
        strip_cols: int | None = None,
        inkernel_drain: bool = True,
    ) -> None:
        if backend == "auto":
            backend = "kernel"
        if backend not in ("reference", "kernel"):
            raise ValueError(f"unknown backend {backend!r}")
        mesh = [torch.device(d) for d in mesh]
        n_dev = len(mesh)
        if n_dev < 2:
            raise ValueError("spatial sharding needs >= 2 strips")
        if params.capacity % (8 * n_dev) != 0:
            raise ValueError(
                f"capacity {params.capacity} must be a multiple of 8*{n_dev}"
            )
        if params.max_events % n_dev != 0:
            raise ValueError(
                f"max_events {params.max_events} must be divisible by {n_dev}"
            )
        if params.grid_x < MIN_STRIP_COLS * n_dev:
            raise ValueError(
                f"grid_x {params.grid_x} < {MIN_STRIP_COLS}*{n_dev} "
                f"(each strip needs >= {MIN_STRIP_COLS} columns for the "
                f"halo contract); raise [aoi] grid or lower mesh_shards"
            )
        if backend == "kernel" and params.cell_capacity > LANES:
            raise ValueError(
                f"kernel path supports cell_capacity <= {LANES}, "
                f"got {params.cell_capacity}"
            )
        # Re-plans move strip boundaries, never strip order.
        self.params = params
        self.mesh = mesh
        self.backend = backend
        self.n_devices = n_dev
        self.chunk = params.capacity // n_dev
        self.events_inline = params.max_events // n_dev
        gx = params.grid_x
        if backend == "kernel":
            # Static kernel-slab width cap. Default: 2x the uniform strip,
            # clamped to planner feasibility on both sides.
            ceil_w = -(-gx // n_dev)
            if strip_cols is None:
                strip_cols = min(gx - (n_dev - 1) * MIN_STRIP_COLS,
                                 2 * ceil_w)
            strip_cols = int(strip_cols)
            if strip_cols < ceil_w:
                raise ValueError(
                    f"strip_cols {strip_cols} < ceil(grid_x/{n_dev}) = "
                    f"{ceil_w}: {n_dev} capped strips cannot cover "
                    f"{gx} columns"
                )
            if strip_cols + 4 > gx:
                raise ValueError(
                    f"strip_cols {strip_cols} + 4 ghost columns exceeds "
                    f"grid_x {gx}; lower strip_cols (the strip slab must "
                    f"not wrap onto itself)"
                )
        else:
            strip_cols = None
        self.strip_cols = strip_cols
        if halo_cap is None:
            # ~6 band columns of the uniform-density column population,
            # doubled for clustering, clamped to the chunk (an overflow
            # past this budget falls back for the tick, it never breaks).
            est = 12 * params.capacity // params.grid_x
            halo_cap = max(64, min(self.chunk, ((est + 7) // 8) * 8))
        self.halo_cap = int(halo_cap)
        self.replan_interval = int(replan_interval)
        self.halo_bytes_per_tick = n_dev * 2 * self.halo_cap * HALO_ROW_BYTES
        # What the all-gather formulation moves instead: every OTHER
        # strip's rows, both epochs (pos 8B + act 1B + spc 4B + rad 4B
        # each), received by each of the D strips.
        self.allgather_bytes_per_tick = (
            n_dev * (params.capacity - self.chunk) * 34
        )
        # A tick whose events overflow the inline budget repages WHOLLY
        # through the rank-select drain: kernel emission is cell-major, so
        # its partial window cannot be rank-resumed.
        self.inkernel_drain = bool(inkernel_drain)
        self.drain_inline = (
            self.events_inline if (backend == "kernel" and inkernel_drain)
            else 0)
        self._flat_end = self.chunk * 9 * params.cell_capacity
        self._state: tuple | None = None
        self.last_grid_dropped = 0
        self.last_mode = "spatial"
        self.last_fast_tick = False
        self.total_fast_ticks = 0
        self.shard_population = np.zeros(n_dev, np.int64)
        self.total_migrations = 0
        self.total_fallbacks = 0
        self.total_replans = 0
        _M_SHARD_COUNT.set(n_dev)
        _M_HALO_PER_TICK.set(self.halo_bytes_per_tick)
        _M_ALLGATHER_EQUIV.set(self.allgather_bytes_per_tick)
        # Each directed seam link's halo child: the wire moves the
        # structural halo_cap envelope, these count the bands' OCCUPIED
        # rows (_build_bands records them).
        self._halo_link_children = tuple(
            (_M_LINK_BYTES.labels("halo", f"{s}->{(s - 1) % n_dev}"),
             _M_LINK_BYTES.labels("halo", f"{s}->{(s + 1) % n_dev}"))
            for s in range(n_dev))
        self._last_band_counts: np.ndarray | None = None

    # --- host-side shard layout ---------------------------------------------

    def _put(self, a: np.ndarray, dtype) -> list:
        return shard_rows(a, self.mesh, dtype)

    def reset(self) -> None:
        n = self.params.capacity
        gx = self.params.grid_x
        d = self.n_devices
        self.boundaries = np.array(
            [round(i * gx / d) for i in range(d)] + [gx], np.int32
        )
        self._rebuild_col_owner()
        self.perm = np.arange(n, dtype=np.int32)
        self.row_of = np.arange(n, dtype=np.int32)
        self.assign = (self.perm // self.chunk).astype(np.int32)
        zeros = (
            np.zeros((n, 2), np.float32),
            np.zeros((n,), bool),
            np.zeros((n,), np.int32),
            np.zeros((n,), np.float32),
        )
        self._host_prev = zeros
        self._prev_cx = bins_reference(self.params, zeros[0], zeros[2])[0]
        self._dispatches = 0
        self._perm_dirty = False
        self._state = tuple(self._put(a, a.dtype.type) for a in zeros)
        self._perm_dev = self._put(self.perm, np.int32)

    def _rebuild_col_owner(self) -> None:
        gx = self.params.grid_x
        owner = np.empty(gx, np.int32)
        for d in range(self.n_devices):
            owner[self.boundaries[d]:self.boundaries[d + 1]] = d
        self._col_owner = owner
        # Hysteresis band columns, one per side of each strip.
        self._band_lo = (self.boundaries[:-1] - 1) % gx
        self._band_hi = self.boundaries[1:] % gx

    def carried_epoch(self) -> tuple:
        """The last dispatched world in SLOT space (the device state is
        row-permuted here)."""
        return tuple(np.array(a) for a in self._host_prev)

    def _in_strip_or_band(self, cx: np.ndarray, shard: np.ndarray):
        """Hysteresis keep-test: column inside the shard's strip, or in
        its one-column slack band on either side."""
        return (
            (self._col_owner[cx] == shard)
            | (cx == self._band_lo[shard])
            | (cx == self._band_hi[shard])
        )

    def _rehome_prev_only(self, prev_act, cur_act) -> int:
        """Re-home rows active ONLY in the previous epoch onto the strip
        owning their PREVIOUS cell (keeps an adopted re-plan from stranding
        a despawned row's prev cell outside its band). Returns the number
        of rows moved."""
        prev_only = np.flatnonzero(prev_act & ~cur_act)
        if not len(prev_only):
            return 0
        keep = self._in_strip_or_band(
            self._prev_cx[prev_only], self.assign[prev_only]
        )
        movers = prev_only[~keep]
        if len(movers):
            self.assign[movers] = self._col_owner[self._prev_cx[movers]]
            self._perm_dirty = True
        return int(len(movers))

    def _replan(self, cx: np.ndarray, active: np.ndarray) -> bool:
        """Re-split strips from the observed column density; adopt only
        when the split meaningfully improves the worst strip load."""
        pop = np.bincount(cx[active], minlength=self.params.grid_x)
        new = plan_strips(pop, self.n_devices, max_cols=self.strip_cols)
        if np.array_equal(new, self.boundaries):
            return False
        cum = np.concatenate([[0], np.cumsum(pop, dtype=np.int64)])

        def worst(bounds):
            loads = cum[bounds[1:]] - cum[bounds[:-1]]
            return int(loads.max()) if len(loads) else 0

        if worst(new) > 0.9 * worst(self.boundaries):
            return False
        self.boundaries = new
        self._rebuild_col_owner()
        self.total_replans += 1
        _M_REPLANS.inc()
        return True

    def _rebuild_perm(self, placed: np.ndarray) -> None:
        """Row layout from the current assignment: strip d's rows hold its
        PLACED slots (active in either epoch: a freshly despawned slot must
        stay on the strip its previous-epoch pairs live on) in slot order,
        then free fill (deterministic)."""
        n = self.params.capacity
        chunk = self.chunk
        perm = np.empty(n, np.int32)
        inactive = np.flatnonzero(~placed).astype(np.int32)
        cursor = 0
        for s in range(self.n_devices):
            mine = np.flatnonzero(placed & (self.assign == s)).astype(
                np.int32
            )
            k = len(mine)
            if k > chunk:
                raise RuntimeError("strip overflow must fall back first")
            perm[s * chunk:s * chunk + k] = mine
            fill = chunk - k
            pad = inactive[cursor:cursor + fill]
            perm[s * chunk + k:(s + 1) * chunk] = pad
            # Inactive slots inherit the strip of the row that parks them
            # (keeps the keep-test well-defined when they activate).
            self.assign[pad] = s
            cursor += fill
        self.perm = perm
        self.row_of = np.empty(n, np.int32)
        self.row_of[perm] = np.arange(n, dtype=np.int32)

    # --- dispatch -----------------------------------------------------------

    def step_async(
        self,
        pos: np.ndarray,
        active: np.ndarray,
        space: np.ndarray,
        radius: np.ndarray,
        meta_dirty: bool = True,
        logic: tuple | None = None,
    ) -> ShardedPendingStep:
        """Dispatch one tick without waiting on the device; collect() fetches
        the events. ``meta_dirty=False`` asserts active/space/radius are
        unchanged since the previous step (reused unless the row layout
        changed).

        ``logic = (programs, sel, y, yaw, dt, cols)`` (slot space, as
        ``NeighborEngine.step_async`` takes it) runs the fused programs in
        the same dispatch on the row-permuted layout; ``pending.fused``
        carries the outputs in ROW space with the perm snapshot that maps
        them back to slots."""
        if self._state is None:
            raise RuntimeError("call reset() first")
        check_radius(self.params, radius, active)
        if self.backend == "kernel":
            check_space_ids(space, active)
        p = self.params
        # Copies, not views: these become the host prev mirror and must
        # not alias caller buffers.
        cur = (
            np.array(pos, np.float32),
            np.array(active, bool),
            np.array(space, np.int32),
            np.array(radius, np.float32),
        )
        cur_pos, cur_act, cur_spc, _ = cur
        cx = bins_reference(p, cur_pos, cur_spc)[0]
        self._dispatches += 1
        halo_span = tracing.child_scope("tick.halo")
        t0 = time.monotonic()

        perm_rebuilt = False
        migrations = 0
        prev_act = self._host_prev[1]
        # Slow-cadence density re-plan.
        if (
            self.replan_interval
            and self._dispatches % self.replan_interval == 0
            and self._replan(cx, cur_act)
        ):
            self._perm_dirty = True
        # Hysteresis migration: move a row only when its cell is a full
        # column past the seam.
        act_idx = np.flatnonzero(cur_act)
        keep = self._in_strip_or_band(cx[act_idx], self.assign[act_idx])
        movers = act_idx[~keep]
        if len(movers):
            self.assign[movers] = self._col_owner[cx[movers]]
            migrations += len(movers)
            self._perm_dirty = True
        # Prev-epoch-only rows (freshly despawned) re-home by their
        # PREVIOUS column: their only remaining job is hosting their
        # prev-epoch pairs.
        migrations += self._rehome_prev_only(prev_act, cur_act)

        fallback_reason = None
        # Row placement covers slots live in EITHER epoch.
        placed_idx = np.flatnonzero(cur_act | prev_act)
        counts = np.bincount(
            self.assign[placed_idx], minlength=self.n_devices
        ).astype(np.int64)
        if counts.max(initial=0) > self.chunk:
            # A strip outgrew its row budget: re-plan NOW; if one column
            # is hotter than a whole strip's budget even alone, spatial
            # sharding cannot represent it: exact fallback.
            if self._replan(cx, cur_act):
                new_assign = self._col_owner[cx[act_idx]]
                migrations += int((new_assign != self.assign[act_idx]).sum())  # gwlint: ok R1 numpy assignment arrays; host arithmetic
                self.assign[act_idx] = new_assign
                self._perm_dirty = True
                migrations += self._rehome_prev_only(prev_act, cur_act)
                counts = np.bincount(
                    self.assign[placed_idx], minlength=self.n_devices
                ).astype(np.int64)
            if counts.max(initial=0) > self.chunk:
                fallback_reason = "strip_overflow"
        self.shard_population = counts

        if fallback_reason is None:
            # Teleport guard: every row active in the PREVIOUS epoch must
            # have its previous cell inside its (current) strip's slack
            # band, or its leave pass would reach past the halo.
            pa_idx = np.flatnonzero(prev_act)
            ok = self._in_strip_or_band(
                self._prev_cx[pa_idx], self.assign[pa_idx]
            )
            if not ok.all():
                fallback_reason = "teleport"

        if self._perm_dirty and fallback_reason != "strip_overflow":
            # Bands are LOCAL row indices, so the layout is rebuilt before
            # they are selected. (A strip-overflow fallback tick defers the
            # rebuild without losing it.)
            self._rebuild_perm(cur_act | prev_act)
            self._perm_dirty = False
            perm_rebuilt = True
        send_lo = send_hi = None
        if fallback_reason is None:
            send_lo, send_hi, overflow = self._build_bands(
                cx, cur_act, prev_act
            )
            if overflow:
                fallback_reason = "halo_overflow"
        if migrations:
            self.total_migrations += migrations
            _M_MIGRATIONS.inc(migrations)
        for d in range(self.n_devices):
            _M_SHARD_ENTITIES.labels(str(d)).set(int(counts[d]))  # gwlint: ok R1 numpy strip populations; host arithmetic
        if halo_span is not None:
            halo_span.args["migrations"] = migrations
            halo_span.args["mode"] = fallback_reason or "spatial"
            tracing.record_span(
                halo_span.name, t0, time.monotonic() - t0,
                halo_span.ctx.trace_id, halo_span.ctx.span_id,
                halo_span.parent_id, halo_span.args)

        put = self._put
        perm = self.perm
        if perm_rebuilt:
            # The previous epoch must live in the NEW layout or the device
            # diff would read a migration as despawn + spawn.
            hp = self._host_prev
            self._state = (
                put(hp[0][perm], np.float32), put(hp[1][perm], np.bool_),
                put(hp[2][perm], np.int32), put(hp[3][perm], np.float32),
            )
            self._perm_dev = put(perm, np.int32)
        if meta_dirty or perm_rebuilt:
            meta = (put(cur[1][perm], np.bool_), put(cur[2][perm], np.int32),
                    put(cur[3][perm], np.float32))
        else:
            meta = self._state[1:4]
        cur_dev = (put(cur[0][perm], np.float32),) + meta

        fused_out = None
        logic_dev: tuple = ()
        if logic is not None:
            # Row-permuted upload of the fused-logic inputs: the programs
            # run per LOCAL row, so sel/y/yaw/columns travel through the
            # same perm as the positions; dt is one scalar per strip.
            programs, sel, y, yaw, dt, cols = logic
            programs = tuple(programs)
            logic_dev = (
                put(np.asarray(y, np.float32)[perm], np.float32),  # gwlint: ok R1 np.asarray of the caller's numpy world; host layout
                put(np.asarray(yaw, np.float32)[perm], np.float32),  # gwlint: ok R1 np.asarray of the caller's numpy world; host layout
                put(np.asarray(sel, np.int32)[perm], np.int32),  # gwlint: ok R1 np.asarray of the caller's numpy world; host layout
                [_f32(dt, dev) for dev in self.mesh],
            ) + tuple(put(np.asarray(c)[perm], np.asarray(c).dtype.type)  # gwlint: ok R1 np.asarray of the caller's numpy columns; host layout
                      for c in cols)

        if fallback_reason is None and self.backend == "reference":
            ref_args = (p, self.events_inline, self.halo_cap, self.mesh)
            band_args = (self._perm_dev, put(send_lo, np.int32),
                         put(send_hi, np.int32))
            if logic is not None:
                enter_ids, leave_ids, outs, fused_out = (
                    _spatial_step_fused_impl(
                        *ref_args, programs, *self._state, *cur_dev,
                        *band_args, *logic_dev))
            else:
                enter_ids, leave_ids, outs = _spatial_step_impl(
                    *ref_args, *self._state, *cur_dev, *band_args)
            self.last_mode = "spatial"
            pending = ShardedPendingStep(
                self, ("spatial", enter_ids, self._perm_dev),
                ("spatial", leave_ids, self._perm_dev), outs)
            # The reference drain pages by flat matrix index.
            pending.rank_paging = False
        elif fallback_reason is None:
            strip_args = (
                p, self.events_inline, self.halo_cap, self.strip_cols,
                self.drain_inline, self.mesh)
            band_args = (
                self._perm_dev, put(send_lo, np.int32),
                put(send_hi, np.int32), list(self.boundaries[:-1]))
            if logic is not None:
                enter_ctx, leave_ctx, outs, fused_out = (
                    _spatial_step_pallas_fused_impl(
                        *strip_args, programs, *self._state, *cur_dev,
                        *band_args, *logic_dev))
            else:
                enter_ctx, leave_ctx, outs = _spatial_step_pallas_impl(
                    *strip_args, *self._state, *cur_dev, *band_args)
            self.last_mode = "spatial"
            pending = ShardedPendingStep(
                self, ("pallas", enter_ctx, self._perm_dev),
                ("pallas", leave_ctx, self._perm_dev), outs)
            # The strip-local bit drain pages by event RANK.
            pending.rank_paging = True
            pending.full_repage = self.drain_inline > 0
        else:
            if logic is not None:
                enter_ids, leave_ids, outs, fused_out = _sharded_step_fused(
                    p, self.events_inline, self.mesh, programs,
                    *self._state, *cur_dev, *logic_dev)
            else:
                enter_ids, leave_ids, outs = _sharded_step(
                    p, self.events_inline, self.mesh, *self._state,
                    *cur_dev)
            self.last_mode = f"fallback:{fallback_reason}"
            self.total_fallbacks += 1
            _M_FALLBACK.labels(fallback_reason).inc()
            _M_ALLGATHER_TOTAL.inc(self.allgather_bytes_per_tick)
            pending = _FallbackPendingStep(
                self, ("fallback", enter_ids), ("fallback", leave_ids),
                outs, perm.copy(),
            )
            # The all-gather program's cursors are flat matrix indices.
            pending.rank_paging = False

        if fallback_reason is None:
            self._note_halo()
        if fused_out is not None:
            _FUSED_VARIANTS.add((p, "strips", self.backend, programs))
            # Outputs are in ROW space: the perm SNAPSHOT maps row→slot at
            # writeback time, immune to later migrations and re-plans.
            pending.fused = (programs, np.asarray(logic[1]), perm.copy(),
                             tuple(HostArray(a) for a in fused_out))

        self._state = cur_dev
        self._host_prev = cur
        self._prev_cx = cx
        return pending

    # Fused entity logic is supported: per-row elementwise programs ride
    # the strip dispatch in row-permuted layout.
    supports_fused_logic = True

    def warmup_fused(self, programs: tuple, col_dtypes: tuple) -> None:
        """Run both fused programs (strip tick and exact fallback) for this
        program set once, at full capacity on all-zero inputs, WITHOUT
        touching engine state: the strip analog of
        ``NeighborEngine.warmup_fused``."""
        p = self.params
        n = p.capacity
        put = self._put
        zeros = (
            put(np.zeros((n, 2), np.float32), np.float32),
            put(np.zeros(n, bool), np.bool_),
            put(np.zeros(n, np.int32), np.int32),
            put(np.zeros(n, np.float32), np.float32),
        )
        logic_dev = (
            put(np.zeros(n, np.float32), np.float32),
            put(np.zeros(n, np.float32), np.float32),
            put(np.zeros(n, np.int32), np.int32),
            [_f32(0.0, dev) for dev in self.mesh],
        ) + tuple(put(np.zeros(n, np.dtype(d)), np.dtype(d).type)
                  for d in col_dtypes)
        programs = tuple(programs)
        empty_band = put(np.full(self.n_devices * self.halo_cap, self.chunk,
                                 np.int32), np.int32)
        perm = put(np.arange(n, dtype=np.int32), np.int32)
        if self.backend == "reference":
            _spatial_step_fused_impl(
                p, self.events_inline, self.halo_cap, self.mesh, programs,
                *zeros, *zeros, perm, empty_band, empty_band, *logic_dev)
        else:
            strip_lo = [round(i * p.grid_x / self.n_devices)
                        for i in range(self.n_devices)]
            _spatial_step_pallas_fused_impl(
                p, self.events_inline, self.halo_cap, self.strip_cols,
                self.drain_inline, self.mesh, programs, *zeros, *zeros,
                perm, empty_band, empty_band, strip_lo, *logic_dev)
        _sharded_step_fused(p, self.events_inline, self.mesh, programs,
                            *zeros, *zeros, *logic_dev)
        for dev in dict.fromkeys(self.mesh):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        _FUSED_VARIANTS.add((p, "strips", self.backend, programs))

    def fused_trace_count(self, programs: tuple) -> int:
        """1 once a fused strip step for ``programs`` has run or been warmed
        at these params, else 0 (the JAX engine's trace count of its fused
        strip jit; see ``NeighborEngine.fused_trace_count``)."""
        return int((self.params, "strips", self.backend, tuple(programs))
                   in _FUSED_VARIANTS)

    def _note_step_flags(self, flags: int) -> None:
        """Header-flag hook (ShardedPendingStep.collect): bit 0 = the
        seam-free single-pass guard held for the collected tick."""
        self.last_fast_tick = bool(flags & 1)
        if flags & 1:
            self.total_fast_ticks += 1
            _M_FAST_TICKS.inc()

    def _note_halo(self) -> None:
        """A strip tick's halo bytes: the structural payload, and each
        seam link's occupied band rows."""
        _M_HALO_BYTES.inc(self.halo_bytes_per_tick)
        for s, (lo_n, hi_n) in enumerate(self._last_band_counts):
            if lo_n:
                self._halo_link_children[s][0].inc(int(lo_n) * HALO_ROW_BYTES)  # gwlint: ok R1 numpy band counts; host arithmetic
            if hi_n:
                self._halo_link_children[s][1].inc(int(hi_n) * HALO_ROW_BYTES)  # gwlint: ok R1 numpy band counts; host arithmetic

    def _build_bands(self, cx, cur_act, prev_act):
        """Per-strip send-index arrays for both seams (flattened
        [D*halo_cap], sentinel chunk) from current AND previous columns."""
        gx = self.params.grid_x
        d = self.n_devices
        h = self.halo_cap
        rel = np.flatnonzero(cur_act | prev_act)
        sh = self.assign[rel]
        lo = self.boundaries[sh]
        hi = self.boundaries[sh + 1]
        c = cx[rel]
        pc = self._prev_cx[rel]

        def in_lo_band(col, act_mask):
            return act_mask & (((col - (lo - 1)) % gx) < 3)

        def in_hi_band(col, act_mask):
            return act_mask & (((col - (hi - 2)) % gx) < 3)

        ca = cur_act[rel]
        pa = prev_act[rel]
        low = in_lo_band(c, ca) | in_lo_band(pc, pa)
        high = in_hi_band(c, ca) | in_hi_band(pc, pa)
        if d == 2:
            # Ring of two: both bands land on the same peer: one copy.
            high &= ~low
        send_lo = np.full(d * h, self.chunk, np.int32)
        send_hi = np.full(d * h, self.chunk, np.int32)
        counts = np.zeros((d, 2), np.int64)
        for s in range(d):
            for i, (mask, buf) in enumerate(((low, send_lo),
                                             (high, send_hi))):
                slots = rel[mask & (sh == s)]
                if len(slots) > h:
                    self._last_band_counts = None
                    return None, None, True
                rows = np.sort(self.row_of[slots] - s * self.chunk)
                buf[s * h:s * h + len(rows)] = rows
                counts[s, i] = len(rows)
        self._last_band_counts = counts
        return send_lo, send_hi, False

    def _page(self, ctx: tuple, deficit: np.ndarray, starts: np.ndarray):
        """Per-strip chunked drain for events beyond the inline budget;
        ctx[0] picks the program: "pallas" = the strip-local bit drain
        (event-RANK paging), "spatial" = the reference strip drain and
        "fallback" = the all-gather program's id drain (both flat-index
        paging). One host copy per round."""
        mode = ctx[0]
        e = self.events_inline
        dev0 = self.mesh[0]
        chunks: list[np.ndarray] = []
        starts = starts.copy()
        deficit = deficit.copy()
        while deficit.any():
            work = [(d, int(min(e, deficit[d])))
                    for d in range(self.n_devices) if deficit[d] > 0]
            pairs, aux = [], []
            for d, take in work:
                if mode == "pallas":
                    pr, _ = _spatial_drain_bits(
                        self.params, e, self.strip_cols, *ctx[1][d],
                        ctx[2][d], int(starts[d]))
                    aux.append(torch.zeros(1, dtype=torch.int32,
                                           device=dev0))
                elif mode == "spatial":
                    pr, idx = _spatial_drain(
                        self.params, e, self.chunk, ctx[1][d], ctx[2][d],
                        int(starts[d]))
                    aux.append(idx[take - 1:take].to(dev0))
                else:
                    pr, idx = _sharded_drain(
                        self.params, e, self.chunk, d, ctx[1][d],
                        int(starts[d]))
                    aux.append(idx[take - 1:take].to(dev0))
                pairs.append(pr[:take].to(dev0))
            host_pairs = torch.cat(pairs).cpu().numpy()
            host_aux = torch.cat(aux).cpu().numpy()
            at = 0
            for k, (d, take) in enumerate(work):
                chunks.append(host_pairs[at:at + take])
                at += take
                deficit[d] -= take
                if mode == "pallas":
                    starts[d] += take
                elif deficit[d] > 0:
                    starts[d] = int(host_aux[k]) + 1
                else:
                    starts[d] = self._flat_end
        return chunks

    def step(self, pos, active, space, radius):
        """Run one tick; returns (enter_pairs, leave_pairs, dropped)."""
        return self.step_async(pos, active, space, radius).collect()


class _FallbackPendingStep(ShardedPendingStep):
    """A fallback tick's pending step: the all-gather program speaks ROW
    ids; the collected pairs map back to entity slots through the row
    permutation snapshotted at dispatch (the live perm may change under a
    pipelined consumer before collect())."""

    __slots__ = ("_perm",)

    def __init__(self, engine, enter_ctx, leave_ctx, outs, perm) -> None:
        super().__init__(engine, enter_ctx, leave_ctx, outs)
        self._perm = perm

    def collect(self):
        enters, leaves, dropped = super().collect()
        if len(enters):
            enters = self._perm[enters]
        if len(leaves):
            leaves = self._perm[leaves]
        return enters, leaves, dropped
