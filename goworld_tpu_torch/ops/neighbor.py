"""Batched AOI neighbor engine in PyTorch, the port of
``goworld_tpu.ops.neighbor``.

The engine computes, for all entities of all spaces at once, the enter and
leave events of one tick as a pairwise predicate diff:

    valid_t(i, j) = av_t(i) ∧ av_t(j) ∧ space_t(i) = space_t(j)
                    ∧ dist_t(i, j) ≤ radius_t(i) ∧ i ≠ j
    enter(t) = valid_t ∧ ¬valid_{t-1}        leave(t) = valid_{t-1} ∧ ¬valid_t

where ``av`` (active and visible) folds grid-capacity drops into validity.
Pairs are enumerated through a spatial-hash grid of the current positions
(enter pass) and of the previous ones (leave pass); both epochs' features
ride along, so any per-tick movement is exact. The JAX module's docstring
has the full design.

Backends (the JAX engine's names in brackets):

- ``"reference"`` [``"jnp"``]: candidate-id matrices gathered through the
  cell table, in plain torch (``_step_jnp``, ``_drain_ids``).
- ``"kernel"`` [``"pallas"`` / ``"pallas_interpret"``]: the dense cell
  layout and the event kernel (``ops/event_kernel.py``), then the
  rank-select drain (``_step_pallas``, ``_drain_bits``). On a CUDA device the
  kernel is the hand-written CUDA one; on the CPU its plain version runs.

Passes that ride the step (``step_async(logic=, tiers=)``): the fused
entity programs, the ``[sync]`` cadence tier pass and the fused-delivery
edge verdicts, plain torch on the step's device, in the JAX module's output
order (``_step_packed_tiered``).

The private functions keep the JAX module's names, so each has an obvious
counterpart there. Every tensor is made on the engine's device, and
``step_async`` never waits on the device: the fast/slow choice of the JAX
step's ``lax.cond`` is a device-side select here (see ``_step_pallas``).
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch

from goworld_tpu_torch.ops.event_kernel import LANES, _F, _PACK, event_mask
from goworld_tpu_torch.telemetry import sentinel

log = logging.getLogger(__name__)

_W = 9 * LANES // _PACK  # words per packed mask row

# The two multiplicative space hashes of _bins, applied with int32
# wraparound.
_HASH_X = -1640531527
_HASH_Z = 40503


@dataclasses.dataclass(frozen=True)
class NeighborParams:
    """Static configuration of a neighbor engine (the same fields,
    defaults and validation as the JAX engine's ``NeighborParams``)."""

    capacity: int = 16384  # max entity slots (N)
    cell_size: float = 100.0  # grid cell side; must be >= max AOI distance
    grid_x: int = 64  # grid extent in cells (wraps modulo)
    grid_z: int = 64
    space_slots: int = 8  # space-id folding slots for the shared grid
    cell_capacity: int = 64  # M: max entities visible per grid cell
    max_events: int = 65536  # enter/leave pairs fetched per host round trip
    # Kernel-path drain select strategy (identical results):
    #   bsearch: searchsorted row-find + binary-search word-find
    #   grouped: searchsorted row-find + two contiguous-row gathers
    #   scatter: one [N]→[E] scatter + cummax row-find + grouped word-find
    drain_mode: str = "bsearch"

    def __post_init__(self) -> None:
        if self.drain_mode not in ("bsearch", "grouped", "scatter"):
            raise ValueError(
                f"drain_mode must be bsearch|grouped|scatter, "
                f"got {self.drain_mode!r}"
            )
        if self.grid_x < 4 or self.grid_z < 4:
            # 3x3 neighborhoods must touch 9 distinct buckets after wrap.
            raise ValueError("grid_x and grid_z must be >= 4")
        if self.capacity % 8 != 0:
            raise ValueError("capacity must be a multiple of 8 (TPU sublanes)")
        # The kernel drain's flat event-index space is capacity*9*LANES
        # held in int32.
        if self.capacity * 9 * LANES >= 2**31:
            raise ValueError(
                f"capacity {self.capacity} overflows the int32 event index "
                f"space (capacity * 9 * {LANES} must be < 2^31); shard the "
                f"engine instead (parallel.mesh)"
            )

    @property
    def num_buckets(self) -> int:
        return self.space_slots * self.grid_z * self.grid_x


def params_from_reference(fields: dict) -> NeighborParams:
    """A port ``NeighborParams`` from ``dataclasses.asdict`` of a JAX one."""
    names = {f.name for f in dataclasses.fields(NeighborParams)}
    if set(fields) != names:
        raise ValueError(
            f"fields differ from NeighborParams: missing "
            f"{sorted(names - set(fields))}, unknown "
            f"{sorted(set(fields) - names)}"
        )
    return NeighborParams(**fields)


def _f32(value: float, device) -> torch.Tensor:
    # A device scalar made by a fill, not a host copy (which would sync), and
    # a tensor operand, not a Python one: CUDA divides by a Python scalar
    # through its reciprocal, which is not correctly rounded.
    return torch.full((), value, dtype=torch.float32, device=device)


# --- shared binning ----------------------------------------------------------


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """The low 32 bits of int64 ``x`` as a signed int32 value (kept int64)."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= 2**31, x - 2**32, x)


def _bins(p: NeighborParams, pos: torch.Tensor, space: torch.Tensor):
    """Wrapped (cell_x, cell_z, space_slot) coordinates per entity, int32.

    Spaces sharing a slot are spread across the torus by a per-space hash
    offset in whole cells, so folded spaces do not pile their origin cells
    onto the same buckets."""
    cell = _f32(p.cell_size, pos.device)
    cx = torch.remainder(torch.floor(pos[:, 0] / cell).to(torch.int32), p.grid_x)
    cz = torch.remainder(torch.floor(pos[:, 1] / cell).to(torch.int32), p.grid_z)
    s64 = space.to(torch.int64)
    ox = torch.remainder(_wrap_i32(s64 * _HASH_X), p.grid_x)
    oz = torch.remainder(_wrap_i32(s64 * _HASH_Z), p.grid_z)
    cx = torch.remainder(cx + ox, p.grid_x).to(torch.int32)
    cz = torch.remainder(cz + oz, p.grid_z).to(torch.int32)
    sm = torch.remainder(space, p.space_slots).to(torch.int32)
    return cx, cz, sm


def bins_reference(p: NeighborParams, pos: np.ndarray, space: np.ndarray):
    """Numpy mirror of :func:`_bins` (same hash constants, same int32
    wraparound) for host-side oracles."""
    s32 = space.astype(np.int32)
    with np.errstate(over="ignore"):
        ox = (s32 * np.int32(_HASH_X)) % np.int32(p.grid_x)
        oz = (s32 * np.int32(_HASH_Z)) % np.int32(p.grid_z)
    cx = (
        np.floor(pos[:, 0] / np.float32(p.cell_size)).astype(np.int32)
        % p.grid_x + ox
    ) % p.grid_x
    cz = (
        np.floor(pos[:, 1] / np.float32(p.cell_size)).astype(np.int32)
        % p.grid_z + oz
    ) % p.grid_z
    sm = s32 % p.space_slots
    return cx, cz, sm


def sorted_ranks(key: torch.Tensor, n: int, num_buckets: int):
    """Stable sort of bucket keys + within-bucket ranks.

    Returns (order, sorted_key, rank): ``order`` is the stable argsort of
    ``key``, ``rank`` the position of each sorted row within its key run.
    One fused sort of ``key*n + iota`` when that fits int32 (unique values,
    ordered by (key, iota) exactly as the stable argsort), else a stable
    argsort."""
    iota = torch.arange(n, dtype=torch.int32, device=key.device)
    if (num_buckets + 1) * n < 2**31:
        fused = torch.sort(key * n + iota).values
        order = torch.remainder(fused, n)
        sorted_key = torch.div(fused, n, rounding_mode="floor")
    else:
        order = torch.argsort(key, stable=True).to(torch.int32)
        sorted_key = key[order.long()]
    boundary = torch.cat([
        torch.ones(1, dtype=torch.bool, device=key.device),
        sorted_key[1:] != sorted_key[:-1],
    ])
    first = torch.cummax(torch.where(boundary, iota, 0), 0).values
    return order, sorted_key, iota - first


def sorted_ranks_by(key: torch.Tensor, tie: torch.Tensor, n_rows: int):
    """Stable (key, tie) lexicographic sort + within-key-run ranks.

    Like :func:`sorted_ranks`, but ties within a bucket break by ``tie``
    (the entity SLOT id) instead of row position: a seam cell's rows exist
    as copies on two strips in different local orders, so cell-capacity
    drops must key on something globally stable (parallel/spatial.py).
    Two stable sorts, least significant key first, give the order of the
    JAX ``lax.sort((key, tie, iota), num_keys=2)``. Returns (order,
    sorted_key, rank)."""
    iota = torch.arange(n_rows, dtype=torch.int32, device=key.device)
    by_tie = torch.argsort(tie, stable=True)
    order = by_tie[torch.argsort(key[by_tie], stable=True)].to(torch.int32)
    sorted_key = key[order.long()]
    boundary = torch.cat([
        torch.ones(1, dtype=torch.bool, device=key.device),
        sorted_key[1:] != sorted_key[:-1],
    ])
    first = torch.cummax(torch.where(boundary, iota, 0), 0).values
    return order, sorted_key, iota - first


def _slot_table(bucket: torch.Tensor, active: torch.Tensor, n: int,
                num_buckets: int, stride: int, cap: int):
    """Bin ``n`` rows into a [num_buckets * stride] slot table, at most
    ``cap`` rows a bucket; later rows of a full bucket are dropped.

    Returns (table i32[num_buckets*stride] with sentinel n, slot i32[n] with
    -1 for dropped/inactive, order, dst), where ``dst`` is each sorted row's
    table index or ``table_size`` for a dropped one."""
    dev = bucket.device
    key = torch.where(active, bucket, num_buckets)
    order, sorted_key, rank = sorted_ranks(key, n, num_buckets)
    ok = (sorted_key < num_buckets) & (rank < cap)
    table_size = num_buckets * stride
    dst = torch.where(ok, sorted_key * stride + rank, table_size)
    # Dropped rows all land in one trailing trash entry, cut off after.
    table = torch.full((table_size + 1,), n, dtype=torch.int32, device=dev)
    table[dst.long()] = order
    slot = torch.empty(n, dtype=torch.int32, device=dev)
    slot[order.long()] = torch.where(ok, dst, -1)
    return table[:table_size], slot, order, dst


def _build_table(p: NeighborParams, bucket: torch.Tensor,
                 active: torch.Tensor, stride: int):
    """Bin entities into a [num_buckets * stride] slot table.

    Entities beyond ``min(cell_capacity, stride)`` in a cell are dropped:
    invisible this tick. Returns (table, slot, dropped_count, order, dst)
    as :func:`_slot_table` describes them."""
    table, slot, order, dst = _slot_table(
        bucket, active, p.capacity, p.num_buckets, stride,
        min(p.cell_capacity, stride))
    dropped = (active & (slot < 0)).sum(dtype=torch.int32)
    return table, slot, dropped, order, dst


def _fast_guard(p: NeighborParams, ppos, pact, pspc, prad, pos, act, spc,
                dropped_c):
    """Device bool: True when every pair valid in EITHER epoch provably sits
    inside the CURRENT grid's 3x3 halo: no entity deactivated, changed
    space, was capacity-dropped this tick, or moved more than
    (cell_size − r_prev)/2. The same f32 operations in the same order as
    the JAX guard."""
    both = pact & act
    deact = torch.any(pact & ~act)
    spchg = torch.any(both & (pspc != spc))
    d = pos - ppos
    d2 = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]
    disp = torch.sqrt(torch.max(torch.where(both, d2, 0.0)))
    prad_max = torch.max(torch.where(pact, prad, 0.0))
    return (
        ~deact
        & ~spchg
        & (dropped_c == 0)
        & (2.0 * disp + prad_max <= _f32(p.cell_size, pos.device))
    )


def _pair_valid(q_av, q_space, q_r2, q_x, q_z, c_av, c_space, c_x, c_z,
                not_self):
    """The per-pair interest predicate for one epoch."""
    dx = c_x - q_x
    dz = c_z - q_z
    d2 = dx * dx + dz * dz
    return q_av & c_av & (q_space == c_space) & (d2 <= q_r2) & not_self


# --- reference path ----------------------------------------------------------


def _gather_cands(p: NeighborParams, table, cx, cz, sm) -> torch.Tensor:
    """Candidate id matrix [Q, 9*M] from each query's 3x3 cell block."""
    m = p.cell_capacity
    lanes = torch.arange(m, dtype=torch.int32, device=table.device)
    parts = []
    for dz in (-1, 0, 1):
        for dx in (-1, 0, 1):
            cxx = torch.remainder(cx + dx, p.grid_x)
            czz = torch.remainder(cz + dz, p.grid_z)
            b = (sm * p.grid_z + czz) * p.grid_x + cxx
            idx = (b * m)[:, None] + lanes[None, :]
            parts.append(table[idx.long()])
    return torch.cat(parts, dim=1)  # [Q, 9M]


def _epoch_mask(p: NeighborParams, cand, q_ids, q_pos, q_av, q_space,
                q_radius, pos, av, space) -> torch.Tensor:
    n = p.capacity
    safe = torch.clamp(cand, max=n - 1).long()
    not_self = (cand < n) & (cand != q_ids[:, None])
    return _pair_valid(
        q_av[:, None],
        q_space[:, None],
        (q_radius * q_radius)[:, None],
        q_pos[:, 0][:, None],
        q_pos[:, 1][:, None],
        av[safe],
        space[safe],
        pos[:, 0][safe],
        pos[:, 1][safe],
        not_self,
    )


def _step_jnp(p: NeighborParams, ppos, pact, pspc, prad, pos, act, spc, rad):
    """Two-grid pairwise diff, reference path. Returns (enter_ids [N, 9M],
    leave_ids [N, 9M], n_enters, n_leaves, dropped, fast).

    The JAX step picks the leave branch with ``lax.cond``; here both are
    computed and ``fast`` selects on the device, so nothing waits."""
    n = p.capacity
    m = p.cell_capacity
    q_ids = torch.arange(n, dtype=torch.int32, device=pos.device)

    cxc, czc, smc = _bins(p, pos, spc)
    cxp, czp, smp = _bins(p, ppos, pspc)
    buc_c = (smc * p.grid_z + czc) * p.grid_x + cxc
    buc_p = (smp * p.grid_z + czp) * p.grid_x + cxp
    table_c, slot_c, dropped_c, _, _ = _build_table(p, buc_c, act, m)
    table_p, slot_p, _, _, _ = _build_table(p, buc_p, pact, m)
    av_c = slot_c >= 0
    av_p = slot_p >= 0

    # Enter pass: candidates from the current grid.
    cand_c = _gather_cands(p, table_c, cxc, czc, smc)
    vc = _epoch_mask(p, cand_c, q_ids, pos, av_c, spc, rad, pos, av_c, spc)
    vp_on_c = _epoch_mask(p, cand_c, q_ids, ppos, av_p, pspc, prad,
                          ppos, av_p, pspc)
    enter_mask = vc & ~vp_on_c

    # Leave pass: on the current grid when the fast guard holds, else on
    # the previous grid.
    fast = _fast_guard(p, ppos, pact, pspc, prad, pos, act, spc, dropped_c)
    cand_p = _gather_cands(p, table_p, cxp, czp, smp)
    vp = _epoch_mask(p, cand_p, q_ids, ppos, av_p, pspc, prad,
                     ppos, av_p, pspc)
    vc_on_p = _epoch_mask(p, cand_p, q_ids, pos, av_c, spc, rad,
                          pos, av_c, spc)
    leave_mask = torch.where(fast, vp_on_c & ~vc, vp & ~vc_on_p)
    cand_l = torch.where(fast, cand_c, cand_p)

    enter_ids = torch.where(enter_mask, cand_c, n)
    leave_ids = torch.where(leave_mask, cand_l, n)
    n_enters = enter_mask.sum(dtype=torch.int32)
    n_leaves = leave_mask.sum(dtype=torch.int32)
    return enter_ids, leave_ids, n_enters, n_leaves, dropped_c, fast


def _drain_ids(ids: torch.Tensor, n: int, max_events: int, start_flat):
    """Compact one chunk of events from an id matrix.

    ``ids`` is i32[Q, W] with sentinel ``n`` in non-event slots. Returns
    (pairs i32[max_events, 2], flat_positions i32[max_events]) for the
    first ``max_events`` events at flat index >= start_flat; the host pages
    through by passing last_flat+1 as the next start."""
    q, w = ids.shape
    total = q * w
    dev = ids.device
    flat = ids.reshape(-1)
    iota = torch.arange(total, dtype=torch.int32, device=dev)
    mask = (flat < n) & (iota >= start_flat)
    # Event k lives at the first flat index whose inclusive running count
    # reaches k+1.
    csum = torch.cumsum(mask, 0, dtype=torch.int32)
    ranks = torch.arange(1, max_events + 1, dtype=torch.int32, device=dev)
    idx = torch.searchsorted(csum, ranks, out_int32=True)
    valid = idx < total
    idx = torch.where(valid, idx, total)
    safe = torch.clamp(idx, max=total - 1)
    ent = torch.where(valid, safe // w, n)
    oth = torch.where(valid, flat[safe.long()], n)
    return torch.stack([ent, oth], dim=1), idx


def _pack_out(p: NeighborParams, enter_pairs, enter_idx, leave_pairs,
              leave_idx, n_enters, n_leaves, dropped):
    """Assemble the single packed host readback, i32[3 + 2*max_events, 2]:

        out[0] = (n_enters, n_leaves)          total event counts
        out[1] = (dropped, 0)                  grid-capacity drop diagnostic
        out[2] = (enter_last_flat, leave_last_flat)  resume cursors
        out[3          : 3+E]  = first E enter pairs (slot, other)
        out[3+E : 3+2E]        = first E leave pairs
    """
    e = p.max_events
    zero = torch.zeros((), dtype=torch.int32, device=enter_pairs.device)
    header = torch.stack([
        torch.stack([n_enters, n_leaves]),
        torch.stack([dropped, zero]),
        torch.stack([enter_idx[e - 1], leave_idx[e - 1]]),
    ]).to(torch.int32)
    return torch.cat([header, enter_pairs, leave_pairs], dim=0)


def _step_packed_jnp(p: NeighborParams, ppos, pact, pspc, prad, pos, act,
                     spc, rad):
    enter_ids, leave_ids, n_e, n_l, dropped, fast = _step_jnp(
        p, ppos, pact, pspc, prad, pos, act, spc, rad
    )
    n = p.capacity
    ep, ei = _drain_ids(enter_ids, n, p.max_events, 0)
    lp, li = _drain_ids(leave_ids, n, p.max_events, 0)
    out = _pack_out(p, ep, ei, lp, li, n_e, n_l, dropped)
    return enter_ids, leave_ids, out, fast


# --- kernel path -------------------------------------------------------------


def _scatter_feats(p: NeighborParams, dst, order, feats_a, feats_b,
                   gx_ext: int | None = None):
    """The dense cell feature layout, by one row-vector scatter.

    ``order``/``dst`` come from _build_table. feats_a = (x, z, space,
    radius) of the epoch the grid is binned by; feats_b = the same four for
    the other epoch. Returns f32[space_slots, gz+2, gx+2, F, LANES]: NaN in
    empty lanes, and a torus-wrapped halo ring.

    ``gx_ext`` is the x extent of a STRIP-LOCAL slab (parallel/spatial.py),
    ghost columns included: real rows from the neighbor strips live there,
    so only z gets the torus wrap ring and the result is
    f32[space_slots, gz+2, gx_ext, F, LANES]."""
    dev = dst.device
    gz = p.grid_z
    gx = p.grid_x if gx_ext is None else gx_ext
    table_size = p.space_slots * gz * gx * LANES
    vals = torch.stack(
        [f.to(torch.float32) for f in feats_a]
        + [f.to(torch.float32) for f in feats_b],
        dim=1,
    )  # [N, F]
    # Dropped rows land in one trailing trash row, cut off after.
    flat = torch.full((table_size + 1, _F), float("nan"),
                      dtype=torch.float32, device=dev)
    flat[dst.long()] = vals[order.long()]
    cells = flat[:table_size].view(p.space_slots, gz, gx, LANES, _F)
    cells = cells.permute(0, 1, 2, 4, 3)  # [S, gz, gx, F, LANES]
    zi = torch.remainder(torch.arange(-1, gz + 1, device=dev), gz)
    if gx_ext is not None:
        return cells[:, zi].contiguous()
    xi = torch.remainder(torch.arange(-1, gx + 1, device=dev), gx)
    return cells[:, zi][:, :, xi].contiguous()


def _popcount16(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each 16-bit word held in int32."""
    x = x - ((x >> 1) & 0x5555)
    x = (x & 0x3333) + ((x >> 2) & 0x3333)
    x = (x + (x >> 4)) & 0x0F0F
    return (x + (x >> 8)) & 0x1F


def _drain_bits(
    p: NeighborParams,
    packed_e: torch.Tensor,  # i32[N, W] per-entity packed event mask
    cx, cz, sm,  # i32[N] bin coords of the pass's grid
    table: torch.Tensor,  # i32[num_buckets * LANES] id table of that grid
    start_flat,  # EVENT RANK to resume from (name kept for the pager)
    max_events: int | None = None,
    gx_ext: int | None = None,  # strip-local x extent (parallel/spatial.py)
    wrap_x: bool = True,  # False: x is a strip slab, halo cols are physical
):
    """Kernel-path drain: the (entity, other) pairs of event RANKS
    [start_rank, start_rank + max_events) of the packed bit mask, by
    hierarchical rank-select: each requested event finds its row, then its
    word (by ``p.drain_mode``), then its bit by prefix counts.

    Candidate c of entity i is halo cell c // LANES (row-major 3x3), lane
    c % LANES. Returns (pairs i32[max_events, 2], total events).

    ``gx_ext``/``wrap_x`` give the candidate-cell arithmetic of a
    STRIP-LOCAL slab (parallel/spatial.py): ``cx`` is then the local slab
    column, the bucket space is ``space_slots * grid_z * gx_ext``, and x
    offsets index physical ghost columns instead of wrapping the torus.
    ``packed_e`` may hold fewer rows than ``capacity`` there (own rows
    only); the pair's entity side is then a ROW index the caller maps to
    a slot."""
    if max_events is None:
        max_events = p.max_events
    start_rank = start_flat
    n = p.capacity
    gxl = p.grid_x if gx_ext is None else gx_ext
    dev = packed_e.device
    n_rows = packed_e.shape[0]
    pc = _popcount16(packed_e)  # [N, W]
    row_counts = pc.sum(1, dtype=torch.int32)
    row_cum = torch.cumsum(row_counts, 0, dtype=torch.int32)  # inclusive
    row_starts = row_cum - row_counts  # exclusive
    total = row_cum[-1]

    j = start_rank + torch.arange(max_events, dtype=torch.int32, device=dev)
    valid = j < total
    if p.drain_mode == "scatter":
        # Row-of-rank over the contiguous range is a monotonic step
        # function: each row intersecting it claims its first output
        # position, and cummax fills forward.
        first_pos = row_starts - start_rank
        intersects = (row_counts > 0) & (row_cum > start_rank) & (
            first_pos < max_events
        )
        target = torch.where(
            intersects, torch.clamp(first_pos, min=0), max_events
        )
        seed = torch.full((max_events + 1,), -1, dtype=torch.int32,
                          device=dev)
        seed.scatter_reduce_(
            0, target.long(),
            torch.arange(n_rows, dtype=torch.int32, device=dev), "amax",
        )
        row = torch.cummax(seed[:max_events], 0).values
        row = torch.clamp(row, 0, n_rows - 1)
    else:
        row = torch.searchsorted(row_starts, j, right=True, out_int32=True) - 1
        row = torch.clamp(row, 0, n_rows - 1)
    rl = row.long()
    k = j - row_starts[rl]  # event rank within its row

    nw = pc.shape[1]
    word_cum = torch.cumsum(pc, 1, dtype=torch.int32)  # [N, W] inclusive
    if p.drain_mode in ("grouped", "scatter"):
        # Two-level select: word w holds rank k iff word_cum[w] > k and
        # word_cum[w-1] <= k, so index = count of inclusive cumsums <= k.
        gsz = 8
        ng = (nw + gsz - 1) // gsz
        pad = ng * gsz - nw
        wc_pad = word_cum
        if pad:  # padded words repeat the last cumsum (popcount 0)
            wc_pad = torch.cat(
                [word_cum, word_cum[:, -1:].expand(-1, pad)], dim=1
            )
        group_cum = wc_pad[:, gsz - 1::gsz]  # [N, G] inclusive per group
        g_rows = group_cum[rl]  # [E, G]
        g = (g_rows <= k[:, None]).sum(1, dtype=torch.int32)
        g = torch.clamp(g, max=ng - 1)
        idx = (row * (ng * gsz) + g * gsz)[:, None] + torch.arange(
            gsz, dtype=torch.int32, device=dev
        )[None, :]
        wg = wc_pad.reshape(-1)[idx.long()]  # [E, gsz]
        wi = (wg <= k[:, None]).sum(1, dtype=torch.int32)
        w = torch.clamp(g * gsz + wi, max=nw - 1)
        ev = torch.arange(max_events, device=dev)
        prev_in_group = wg[ev, torch.clamp(wi - 1, min=0).long()]
        prev_group_end = torch.where(
            g > 0, g_rows[ev, torch.clamp(g - 1, min=0).long()], 0
        )
        word_start = torch.where(wi > 0, prev_in_group, prev_group_end)
    else:
        # Binary search over the row's inclusive word-count cumsum.
        wc_flat = word_cum.reshape(-1)
        pc_flat = pc.reshape(-1)
        base = row * nw
        lo = torch.zeros(max_events, dtype=torch.int32, device=dev)
        hi = torch.full((max_events,), nw, dtype=torch.int32, device=dev)
        for _ in range(max(1, nw.bit_length())):
            mid = torch.clamp((lo + hi) // 2, max=nw - 1)
            gt = wc_flat[(base + mid).long()] > k
            hi = torch.where(gt, mid, hi)
            lo = torch.where(gt, lo, mid + 1)
        w = torch.clamp(lo, max=nw - 1)
        bw = (base + w).long()
        word_start = wc_flat[bw] - pc_flat[bw]
    kk = k - word_start  # set-bit rank within the word

    word = packed_e[rl, w.long()]
    shifts = torch.arange(_PACK, dtype=torch.int32, device=dev)
    bits = (word[:, None] >> shifts) & 1
    bcum = torch.cumsum(bits, 1, dtype=torch.int32)  # inclusive
    b = (bcum <= kk[:, None]).sum(1, dtype=torch.int32)
    b = torch.clamp(b, max=_PACK - 1)

    c = w * _PACK + b  # candidate index within the row's 3x3 halo
    hc = c // LANES
    lane = c % LANES
    dzo = hc // 3 - 1
    dxo = hc % 3 - 1
    czz = torch.remainder(cz[rl] + dzo, p.grid_z)
    if wrap_x:
        cxx = torch.remainder(cx[rl] + dxo, gxl)
    else:
        cxx = cx[rl] + dxo  # strip slab: ghost columns are physical
    bucket = (sm[rl] * p.grid_z + czz) * gxl + cxx
    # Clamped as JAX clamps a gather: only a rank past the total (masked
    # below) can fall outside a strip slab's table.
    tidx = torch.clamp(bucket * LANES + lane, 0, table.shape[0] - 1)
    other = table[tidx.long()]
    ent = torch.where(valid, row, n)
    other = torch.where(valid, other, n)
    return torch.stack([ent, other], dim=1), total


def _per_entity(packed_cells: torch.Tensor, slot: torch.Tensor):
    """Each entity's mask row out of the per-cell kernel output (zeros for
    an entity outside the grid)."""
    flat = packed_cells.reshape(-1, packed_cells.shape[-1])
    rows = flat[torch.clamp(slot, min=0).long()]
    return torch.where((slot >= 0)[:, None], rows, 0)


def _step_pallas(
    p: NeighborParams,
    ppos, pact, pspc, prad,  # previous-tick inputs
    pcx, pcz, psm, ptable, pslot, porder, pdst,  # prev tick's CARRIED grid
    pos, act, spc, rad,  # current-tick inputs
):
    """The kernel step. The previous grid's bins/table/slot are carried in
    engine state, so one table build runs per tick.

    When the fast guard holds, one dual-form launch on the current grid
    yields both masks; otherwise the leave mask comes from a single-form
    launch on the previous grid. The JAX step branches with ``lax.cond``;
    here the dual form always runs on the current grid (its enter half is
    bit-identical to the single form there), the single form runs on the
    previous grid with ``skip=fast`` so it does no work on a fast tick, and
    the leave mask and its grid are selected on the device.

    Returns (enter_ctx, leave_ctx, out, next_grid, fast): the paging
    contexts, the packed readback, the grid artifacts to carry, and the
    device-side guard."""
    cxc, czc, smc = _bins(p, pos, spc)
    buc_c = (smc * p.grid_z + czc) * p.grid_x + cxc
    table_c, slot_c, dropped_c, order_c, dst_c = _build_table(
        p, buc_c, act, LANES
    )

    # Each epoch's x row is poisoned by its OWN slot validity: an entity
    # outside epoch E's table must be invalid under E even when its row is
    # written through the other epoch's table.
    nan = float("nan")
    xs_c = torch.where(slot_c >= 0, pos[:, 0], nan)
    xs_p = torch.where(pslot >= 0, ppos[:, 0], nan)
    cur_feats = (xs_c, pos[:, 1], spc, rad)
    prev_feats = (xs_p, ppos[:, 1], pspc, prad)
    cells_c = _scatter_feats(p, dst_c, order_c, cur_feats, prev_feats)
    cells_p = _scatter_feats(p, pdst, porder, prev_feats, cur_feats)

    # dropped_c == 0 is part of the guard: a capacity-dropped entity is
    # absent from table_c, so its leaves must come from the previous grid.
    fast = _fast_guard(p, ppos, pact, pspc, prad, pos, act, spc, dropped_c)

    pk2 = _per_entity(event_mask(cells_c, dual=True), slot_c)  # [N, 2W]
    pk_p = _per_entity(event_mask(cells_p, dual=False, skip=fast), pslot)
    packed_e = pk2[:, :_W]
    packed_l = torch.where(fast, pk2[:, _W:], pk_p)
    lcx = torch.where(fast, cxc, pcx)
    lcz = torch.where(fast, czc, pcz)
    lsm = torch.where(fast, smc, psm)
    ltable = torch.where(fast, table_c, ptable)

    n_enters = _popcount16(packed_e).sum(dtype=torch.int32)
    n_leaves = _popcount16(packed_l).sum(dtype=torch.int32)
    ep, _ = _drain_bits(p, packed_e, cxc, czc, smc, table_c, 0)
    lp, _ = _drain_bits(p, packed_l, lcx, lcz, lsm, ltable, 0)
    # Rank-based paging resumes at max_events, so the cursor row is unused.
    zero = torch.zeros((), dtype=torch.int32, device=pos.device)
    header = torch.stack([
        torch.stack([n_enters, n_leaves]),
        torch.stack([dropped_c, zero]),
        torch.stack([zero, zero]),
    ])
    out = torch.cat([header, ep, lp], dim=0)
    enter_ctx = (packed_e, cxc, czc, smc, table_c)
    leave_ctx = (packed_l, lcx, lcz, lsm, ltable)
    next_grid = (cxc, czc, smc, table_c, slot_c, order_c, dst_c)
    return enter_ctx, leave_ctx, out, next_grid, fast


# --- fused entity logic ------------------------------------------------------
#
# [aoi] fuse_logic: per-class pure tick programs (entity/columns.columnar_tick)
# ride the same dispatch as the AOI step. The fused step computes exactly
# what the plain step computes; it additionally applies each program
# elementwise to the dispatched (pos, y, yaw, columns) and returns the
# results as extra outputs, which the service writes back just before the
# NEXT dispatch (entity/aoi/batched.py _consume_fused). The unfused host
# hook (columns.columnar_tick) calls the same ``_fused_program_apply``, so
# both trajectories come from the same arithmetic.


def _fused_program_apply(prog, x, y, z, yaw, dt, cols):
    """One program over every row (masking is the caller's): ``prog.fn``
    is elementwise, so it runs on the row tensors as they are (the JAX
    module vmaps it). Outputs come back as tensors of the rows' shape."""
    outs = prog.fn(x, y, z, yaw, dt, *cols)
    return tuple(
        torch.as_tensor(o, device=x.device).expand(x.shape) for o in outs  # gwlint: ok R1 as_tensor of an output that is already a tensor on the rows' device is a no-op
    )


def _apply_fused_logic(programs, pos, y, yaw, sel, dt, cols):
    """Apply each fused program to its rows (``sel == k+1``; 0 = no
    program). ``cols`` is the flat per-program concatenation of column
    tensors. Returns (new_pos [N,2], new_y, new_yaw, new_cols tuple)."""
    x = pos[:, 0]
    z = pos[:, 1]
    new = [x, y, z, yaw]
    out_cols = list(cols)
    off = 0
    for k, prog in enumerate(programs):
        nc = len(prog.columns)
        pc = tuple(cols[off + i] for i in range(nc))
        outs = _fused_program_apply(prog, x, y, z, yaw, dt, pc)
        m = sel == k + 1
        for i in range(4):
            new[i] = torch.where(m, outs[i].to(new[i].dtype), new[i])
        for i in range(nc):
            base = out_cols[off + i]
            out_cols[off + i] = torch.where(m, outs[4 + i].to(base.dtype),
                                            base)
        off += nc
    new_pos = torch.stack([new[0], new[2]], dim=1)
    return new_pos, new[1], new[3], tuple(out_cols)


# The (params, backend, programs) variants a fused step ran or warmed, the
# counterpart of the JAX module's per-variant jit cache
# (``fused_trace_count``). PyTorch compiles nothing, so the set only records
# which variants have been run.
_FUSED_VARIANTS: set = set()


# --- sync cadence tier pass ([sync]; rides the step dispatch) ---------------
#
# Each (subject, watcher) interest pair is classified into a sync cadence
# tier by distance and approach rate in one batched sweep over the edge
# list, in the same dispatch as the AOI step. The formula mirrors
# entity/slabs.classify_tiers, the host fallback.


def _tier_pass(pos, ppos, radius, subj, wat, n_tiers: int,
               near_ratio: float, far_ratio: float):
    """uint8[Ecap] tier per padded edge: subj/wat are int32 slot ids with
    sentinel >= capacity on pad rows (tier 0 there: full rate is the
    conservative default). Distance uses the CURRENT epoch; a pair whose
    distance shrank since the PREVIOUS epoch is approaching and drops one
    tier toward full rate. Every constant is a float32 tensor, as the JAX
    pass's weakly typed Python floats are: the arithmetic stays float32 and
    a division is a true division on every device."""
    n = pos.shape[0]
    dev = pos.device
    valid = (subj >= 0) & (subj < n) & (wat >= 0) & (wat < n)
    s = torch.clamp(subj, 0, n - 1).long()
    w = torch.clamp(wat, 0, n - 1).long()
    d = pos[s] - pos[w]
    d2 = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]
    pd = ppos[s] - ppos[w]
    pd2 = pd[:, 0] * pd[:, 0] + pd[:, 1] * pd[:, 1]
    r = radius[w]
    r2 = torch.maximum(r * r, _f32(1e-12, dev))
    ratio = torch.sqrt(d2 / r2)
    near = _f32(near_ratio, dev)
    span = _f32(max(far_ratio - near_ratio, 1e-9), dev)
    steps = _f32(n_tiers - 1, dev)
    tier = 1 + torch.floor((ratio - near) / span * steps).to(torch.int32)
    tier = torch.clamp(tier, 0, n_tiers - 1)
    tier = torch.where(ratio <= near, 0, tier)
    tier = torch.where(d2 < pd2, torch.clamp(tier - 1, min=0), tier)
    return torch.where(valid, tier, 0).to(torch.uint8)


def _edge_verdicts(p: NeighborParams, out, subj, wat):
    """uint8[2*max_events]: per INLINE event row of the packed ``out``,
    1 = the event is a real edge-state change against the dispatched edge
    snapshot (an enter whose (subj, wat) edge is absent / a leave whose
    edge is present), 0 = a no-op the idempotent interest guards would
    swallow. The host decode applies verdict-1 rows through a bulk edge
    update and drops verdict-0 rows (aoi/batched.py _deliver_fused).

    Keys are ``subj * (capacity+1) + wat`` in int32, so the caller must
    guarantee ``(capacity+1)**2 < 2**31`` (the batched service gates on
    this). Pad rows of the edge snapshot carry the slot sentinel
    ``capacity`` on both sides: their key is the maximum, so real keys
    never collide with them."""
    e = p.max_events
    n1 = p.capacity + 1
    keys = torch.sort(subj.to(torch.int32) * n1
                      + wat.to(torch.int32)).values
    rows = out[3:3 + 2 * e]
    # Event pairs are (watcher, other); the edge table keys
    # (subject=other, watcher) — see Entity._edge_update.
    k = rows[:, 1] * n1 + rows[:, 0]
    idx = torch.clamp(torch.searchsorted(keys, k), 0, keys.shape[0] - 1)
    present = keys[idx] == k
    return torch.cat([~present[:e], present[e:]]).to(torch.uint8)


def _step_packed_tiered(p: NeighborParams, backend: str, programs,
                        tier_cfg, verdicts: bool, subj, wat, state, cur,
                        extra):
    """The step (plain or fused) with the edge-snapshot passes attached,
    in the JAX module's output order (``_jitted_step_packed_tiered``): the
    step's outputs, then the tier vector when ``tier_cfg`` is a
    (n_tiers, near, far) tuple, then the verdict vector when ``verdicts``.
    The step's outputs are (enter_ids, leave_ids, out, fast) on the
    reference backend and (enter_ctx, leave_ctx, out, next_grid, fast) on
    the kernel backend, followed by the fused outputs when ``programs``.
    One launch of the step program, counted under the JAX labels
    (neighbor.py's ``SentinelJit`` wrappers): ``aoi_step_{backend}`` or
    ``aoi_step_fused_{backend}``; the riding tier and verdict passes are
    not split out."""
    sentinel.note_launch(
        f"aoi_step_fused_{backend}" if programs is not None
        else f"aoi_step_{backend}")
    if backend == "reference":
        outs = _step_packed_jnp(p, *state, *cur)
    else:
        outs = _step_pallas(p, *state, *cur)
    if programs is not None:
        y, yaw, sel, dt, *cols = extra
        new_pos, new_y, new_yaw, new_cols = _apply_fused_logic(
            programs, cur[0], y, yaw, sel, dt, cols)
        outs = outs + ((new_pos, new_y, new_yaw) + new_cols,)
    if tier_cfg is not None:
        n_tiers, near_ratio, far_ratio = tier_cfg
        outs = outs + (_tier_pass(cur[0], state[0], cur[3], subj, wat,
                                  n_tiers, near_ratio, far_ratio),)
    if verdicts:
        outs = outs + (_edge_verdicts(p, outs[2], subj, wat),)
    return outs


def tier_edge_capacity(n_edges: int) -> int:
    """Padded edge-array size for ``n_edges`` live edges: power-of-two
    tiers from 256, so the padded shapes change only on capacity growth
    (a handful of times over a process's life), never per edge churn."""
    cap = 256
    while cap < n_edges:
        cap *= 2
    return cap


# --- host-facing engine ------------------------------------------------------


class PendingStep:
    """An in-flight tick: dispatched to the device, result not yet fetched.

    On CUDA the packed result's copy into pinned host memory is queued
    behind the step at once; ``collect()`` blocks only on what is still
    outstanding. Dispatching tick t+1 before collecting tick t hides the
    fetch behind compute.

    ``fast`` is the step's guard as a device bool (True: the leave mask came
    from the single dual-form launch); reading it waits for the device.

    The payloads of the passes that rode the step are queued to the host
    behind the packed result, and ``np.asarray`` of each waits for its own
    copy only: ``fused`` = (programs, sel, row→slot perm or None, fused
    outputs), consumed by the service's ``_consume_fused`` before the next
    dispatch; ``tiers`` = (edge_version, edge count, tier vector);
    ``verdicts`` = the edge-verdict vector, with ``edge_log`` the edge delta
    log that was live when its snapshot was taken (batched.py
    ``_deliver_fused``).
    """

    __slots__ = ("_engine", "_pager", "_host", "_done", "_copied",
                 "_collected", "fast", "fused", "tiers", "verdicts",
                 "edge_log")

    def __init__(self, engine: NeighborEngine, pager, out: torch.Tensor,
                 fast: torch.Tensor) -> None:
        self._engine = engine
        self._pager = pager  # pager(which, remaining, start_flat) -> pairs
        self._collected = False
        self.fast = fast
        self._host, self._done, self._copied = start_host_copy(out)
        self.fused = None
        self.tiers = None
        self.verdicts = None
        self.edge_log = None

    def is_ready(self) -> bool:
        """True when collect() will not block on device compute."""
        return self._done is None or self._done.query()

    def wait_device(self) -> None:
        """Block until the device step has finished computing the packed
        result (collect() after this times only the host copy + unpack)."""
        if self._done is not None:
            self._done.synchronize()

    def collect(self) -> tuple[np.ndarray, np.ndarray, int]:
        """Fetch (enter_pairs, leave_pairs, dropped); one blocking read."""
        if self._collected:
            raise RuntimeError("PendingStep already collected")
        self._collected = True
        if self._copied is not None:
            self._copied.synchronize()
        eng = self._engine
        p = eng.params
        e = p.max_events
        out = self._host.numpy()
        n_e, n_l = int(out[0, 0]), int(out[0, 1])
        dropped = int(out[1, 0])
        enter_last, leave_last = int(out[2, 0]), int(out[2, 1])
        # Copies, so the pinned buffer goes back to the allocator for the
        # next tick however long the caller keeps the pairs.
        enters = out[3:3 + min(n_e, e)].copy()
        leaves = out[3 + e:3 + e + min(n_l, e)].copy()
        self._host = None
        # Storm paging: the kernel drain pages by event RANK (resume at e),
        # the reference drain by flat matrix index (resume after the last
        # drained position).
        rank_paging = eng.backend == "kernel"
        if n_e > e:
            enters = np.concatenate([
                enters,
                self._pager("enter", n_e - e,
                            e if rank_paging else enter_last + 1),
            ])
        if n_l > e:
            leaves = np.concatenate([
                leaves,
                self._pager("leave", n_l - e,
                            e if rank_paging else leave_last + 1),
            ])
        eng.last_grid_dropped = dropped
        if dropped:
            log.warning(
                "AOI grid overflow: %d active entities exceeded "
                "cell_capacity=%d and are invisible this tick; raise "
                "cell_capacity, or raise [aoi] grid/cell_size — the torus "
                "covers grid*cell_size (%.0f) world units, and a wider map "
                "FOLDS distant cells onto shared buckets",
                dropped, p.cell_capacity, p.grid_x * p.cell_size,
            )
        return enters, leaves, dropped


class NeighborEngine:
    """Stateful wrapper around the step functions.

        eng = NeighborEngine(NeighborParams(capacity=1024))
        eng.reset()
        enters, leaves, dropped = eng.step(pos, active, space, radius)

    ``enters`` / ``leaves`` are numpy ``[E, 2]`` arrays of (slot,
    other_slot) pairs.

    ``device``: None means ``"cuda"``, and raises when no CUDA device is
    available; pass ``"cpu"`` to run the plain versions on the CPU.
    ``backend``: ``"auto"`` picks ``"kernel"`` on CUDA and ``"reference"``
    elsewhere.
    """

    def __init__(self, params: NeighborParams, backend: str = "auto",
                 device: str | torch.device | None = None):
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "NeighborEngine runs on CUDA unless told otherwise, and "
                    "no CUDA device is available; pass device='cpu' for the "
                    "plain versions"
                )
            device = "cuda"
        self.device = torch.device(device)
        if backend == "auto":
            backend = "kernel" if self.device.type == "cuda" else "reference"
        if backend not in ("reference", "kernel"):
            raise ValueError(f"unknown backend {backend!r}")
        if backend == "kernel" and params.cell_capacity > LANES:
            raise ValueError(
                f"kernel path supports cell_capacity <= {LANES}, "
                f"got {params.cell_capacity}"
            )
        self.params = params
        self.backend = backend
        self._state: tuple | None = None
        self.last_grid_dropped = 0

    def reset(self) -> None:
        """Clear device state: the next step sees an all-inactive previous
        tick and emits the full enter storm."""
        self._state = self._zero_state()

    def _zero_state(self) -> tuple:
        """The state of an all-inactive previous tick."""
        n = self.params.capacity
        dev = self.device
        state = (
            torch.zeros((n, 2), dtype=torch.float32, device=dev),
            torch.zeros(n, dtype=torch.bool, device=dev),
            torch.zeros(n, dtype=torch.int32, device=dev),
            torch.zeros(n, dtype=torch.float32, device=dev),
        )
        if self.backend == "kernel":
            # The grid of an all-inactive tick: sentinel table, -1 slots,
            # all-dropped dst; bins and order are irrelevant then.
            table_size = self.params.num_buckets * LANES
            i32 = dict(dtype=torch.int32, device=dev)
            state += (
                torch.zeros(n, **i32),  # pcx
                torch.zeros(n, **i32),  # pcz
                torch.zeros(n, **i32),  # psm
                torch.full((table_size,), n, **i32),  # ptable
                torch.full((n,), -1, **i32),  # pslot
                torch.arange(n, **i32),  # porder
                torch.full((n,), table_size, **i32),  # pdst
            )
        return state

    def load_state(self, arrays: tuple[np.ndarray, ...]) -> None:
        """Take over another engine's state: the previous epoch (pos,
        active, space, radius) and, on the kernel path, the 7 carried grid
        arrays, as numpy in the JAX engine's ``_state`` order."""
        n = self.params.capacity
        specs = [((n, 2), np.float32), ((n,), np.bool_),
                 ((n,), np.int32), ((n,), np.float32)]
        if self.backend == "kernel":
            table_size = self.params.num_buckets * LANES
            specs += [((n,), np.int32)] * 3  # pcx, pcz, psm
            specs += [((table_size,), np.int32)]  # ptable
            specs += [((n,), np.int32)] * 3  # pslot, porder, pdst
        if len(arrays) != len(specs):
            raise ValueError(
                f"{self.backend} state has {len(specs)} arrays, "
                f"got {len(arrays)}"
            )
        for k, (a, (shape, _)) in enumerate(zip(arrays, specs)):
            if np.shape(a) != shape:
                raise ValueError(
                    f"state array {k} has shape {np.shape(a)}, want {shape}"
                )
        self._state = tuple(
            self._upload(a, dt) for a, (_, dt) in zip(arrays, specs)
        )

    def carried_epoch(self) -> tuple:
        """The last dispatched (pos, active, space, radius) as numpy."""
        if self._state is None:
            raise RuntimeError("call reset() first")
        return tuple(a.cpu().numpy() for a in self._state[0:4])

    def _upload(self, arr, dtype) -> torch.Tensor:
        return upload(arr, dtype, self.device)

    def _page(self, ctx, remaining: int, start_flat: int) -> np.ndarray:
        p = self.params
        chunks = []
        start = start_flat
        rank_paging = self.backend == "kernel"
        while remaining > 0:
            if rank_paging:
                pairs, aux = _drain_bits(p, *ctx, start)
            else:
                pairs, aux = _drain_ids(*ctx, p.capacity, p.max_events, start)
            take = min(p.max_events, remaining)
            chunks.append(pairs[:take].cpu().numpy())
            remaining -= take
            if remaining > 0:
                start = start + take if rank_paging else aux[take - 1] + 1
        return np.concatenate(chunks)

    # The batched service may hand this engine a fused-logic payload
    # (aoi/batched.py _build_logic) and ride the [sync] cadence tier pass
    # and the edge-verdict pass on the step (``tiers=``).
    supports_fused_logic = True
    supports_tier_pass = True

    def step_async(
        self,
        pos: np.ndarray,
        active: np.ndarray,
        space: np.ndarray,
        radius: np.ndarray,
        meta_dirty: bool = True,
        logic: tuple | None = None,
        tiers: tuple | None = None,
    ) -> PendingStep:
        """Dispatch one tick without blocking; collect() fetches the events.

        State advances immediately, so back-to-back step_async calls
        pipeline: tick t+1 computes while tick t's packed result is in
        flight to the host.

        ``meta_dirty=False`` asserts that active/space/radius are unchanged
        since the previous step: the device-resident copies are reused and
        only positions are uploaded.

        ``logic = (programs, sel, y, yaw, dt, cols)`` fuses the per-class
        entity-logic programs into the same dispatch: the AOI diff is
        computed exactly as without logic, and the programs' outputs over
        the dispatched epoch ride back on ``pending.fused``. ``sel`` is
        int32[capacity] (program index + 1, 0 = none), ``cols`` the flat
        per-program column arrays.

        ``tiers = (edge_version, n_edges, subj_pad, wat_pad,
        (n_tiers, near_ratio, far_ratio)[, want_verdicts])`` rides the
        [sync] cadence tier pass and/or the edge-verdict pass on the same
        dispatch (``pending.tiers``, ``pending.verdicts``). A 5-tuple is
        the tiers-only payload; the 6-tuple may set the tier config to None
        for a verdicts-only dispatch."""
        if self._state is None:
            raise RuntimeError("call reset() first")
        n = self.params.capacity
        if np.shape(pos) != (n, 2):
            raise ValueError(f"pos must be [{n}, 2], got {np.shape(pos)}")
        for name, a in (("active", active), ("space", space),
                        ("radius", radius)):
            if np.shape(a) != (n,):
                raise ValueError(f"{name} must be [{n}], got {np.shape(a)}")
        check_radius(self.params, radius, active)
        if self.backend == "kernel":
            check_space_ids(space, active)
        if meta_dirty:
            meta = (
                self._upload(active, np.bool_),
                self._upload(space, np.int32),
                self._upload(radius, np.float32),
            )
        else:
            meta = self._state[1:4]
        cur = (self._upload(pos, np.float32),) + meta

        programs = None
        extra: tuple = ()
        if logic is not None:
            programs, sel, y, yaw, dt, cols = logic
            programs = tuple(programs)
            extra = self._logic_inputs(sel, y, yaw, dt, cols)
        tcfg = None
        want_verdicts = False
        subj = wat = None
        if tiers is not None:
            if len(tiers) == 5:
                t_ver, t_n, subj_pad, wat_pad, tcfg = tiers
            else:
                t_ver, t_n, subj_pad, wat_pad, tcfg, want_verdicts = tiers
            if tcfg is not None:
                tcfg = tuple(tcfg)
            subj = self._upload(subj_pad, np.int32)
            wat = self._upload(wat_pad, np.int32)
        outs = _step_packed_tiered(
            self.params, self.backend, programs, tcfg, want_verdicts,
            subj, wat, self._state, cur, extra)
        verdict_out = tier_out = fused_out = None
        if want_verdicts:
            verdict_out, outs = outs[-1], outs[:-1]
        if tcfg is not None:
            tier_out, outs = outs[-1], outs[:-1]
        if programs is not None:
            fused_out, outs = outs[-1], outs[:-1]

        if self.backend == "reference":
            enter_ids, leave_ids, out, fast = outs
            self._state = cur

            def pager(which, remaining, start):
                ids = enter_ids if which == "enter" else leave_ids
                return self._page((ids,), remaining, start)
        else:
            enter_ctx, leave_ctx, out, next_grid, fast = outs
            self._state = cur + next_grid

            def pager(which, remaining, start):
                ctx = enter_ctx if which == "enter" else leave_ctx
                return self._page(ctx, remaining, start)

        pending = PendingStep(self, pager, out, fast)
        # The extra outputs' copies queue behind the packed result's.
        if fused_out is not None:
            _FUSED_VARIANTS.add((self.params, self.backend, programs))  # gwlint: ok R1 a host set of the fused variants run (the one-launch gate); no device state
            pending.fused = (programs, np.asarray(logic[1]), None,
                             tuple(HostArray(a) for a in fused_out))
        if tier_out is not None:
            pending.tiers = (t_ver, t_n, HostArray(tier_out))
        if verdict_out is not None:
            pending.verdicts = HostArray(verdict_out)
        return pending

    def _logic_inputs(self, sel, y, yaw, dt, cols) -> tuple:
        """The fused programs' inputs on the device: (y, yaw, sel, dt,
        *cols), dt a float32 scalar tensor, each column in its own dtype."""
        return (
            self._upload(y, np.float32),
            self._upload(yaw, np.float32),
            self._upload(sel, np.int32),
            _f32(dt, self.device),
        ) + tuple(self._upload(c, np.asarray(c).dtype.type) for c in cols)  # gwlint: ok R1 the fused programs' inputs are the service's numpy slab columns

    def _warm_variant(self, programs, col_dtypes, tier_cfg, edge_cap,
                      verdicts: bool) -> None:
        """One all-zero step of a variant at full capacity, on a state of
        its own: engine state is untouched."""
        n = self.params.capacity
        state = self._zero_state()
        extra: tuple = ()
        if programs:
            programs = tuple(programs)
            extra = self._logic_inputs(
                np.zeros(n, np.int32), np.zeros(n, np.float32),
                np.zeros(n, np.float32), 0.0,
                tuple(np.zeros(n, np.dtype(d)) for d in col_dtypes))
            _FUSED_VARIANTS.add((self.params, self.backend, programs))
        else:
            programs = None
        subj = wat = None
        if edge_cap:
            subj = torch.full((edge_cap,), n, dtype=torch.int32,
                              device=self.device)
            wat = subj
        outs = _step_packed_tiered(
            self.params, self.backend, programs, tier_cfg, verdicts,
            subj, wat, state, state[0:4], extra)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        del outs

    def warmup_fused(self, programs: tuple, col_dtypes: tuple) -> None:
        """Run the fused step for ``programs`` once, WITHOUT touching engine
        state: an all-zero step at full capacity. PyTorch compiles nothing;
        the service calls this at boot, after a restore and before a
        capacity jump, as the JAX engine's compile warmup.
        ``col_dtypes`` are the flat per-program column dtypes."""
        self._warm_variant(tuple(programs), col_dtypes, None, 0, False)

    def warmup_tiered(self, programs: tuple | None, col_dtypes: tuple,
                      tier_cfg: tuple | None, edge_cap: int,
                      verdicts: bool = False) -> None:
        """Run the tiered step (plain or fused variant) once at full
        capacity and ``edge_cap`` padded edges, WITHOUT touching engine
        state: the warmup_fused analog for the [sync] tier pass and the
        edge verdicts."""
        self._warm_variant(
            programs, col_dtypes,
            tuple(tier_cfg) if tier_cfg is not None else None,
            edge_cap, verdicts)

    def fused_trace_count(self, programs: tuple) -> int:
        """1 once a fused step for ``programs`` has run or been warmed at
        this engine's params and backend, else 0: the counterpart of the
        JAX engine's compiled-trace count. The one-launch gate asserts it
        stays at 1 across steady ticks and across a restore."""
        key = (self.params, self.backend, tuple(programs))
        return int(key in _FUSED_VARIANTS)

    def step(
        self,
        pos: np.ndarray,
        active: np.ndarray,
        space: np.ndarray,
        radius: np.ndarray,
    ) -> tuple[np.ndarray, np.ndarray, int]:
        """Run one tick; returns (enter_pairs, leave_pairs, dropped)."""
        return self.step_async(pos, active, space, radius).collect()


_TORCH_DTYPE = {
    np.float32: torch.float32,
    np.float64: torch.float64,
    np.int32: torch.int32,
    np.int64: torch.int64,
    np.bool_: torch.bool,
}


def upload(arr, dtype, device: torch.device) -> torch.Tensor:
    """A copy of host ``arr`` as ``dtype`` on ``device``. Never a view of
    the caller's buffer: an engine keeps the tensor as next tick's PREVIOUS
    state, and in-place game updates must not rewrite it. On CUDA the copy
    goes through pinned memory without blocking."""
    a = np.asarray(arr)  # gwlint: ok R1 arr is the caller's host array
    if device.type == "cuda":
        host = torch.empty(a.shape, dtype=_TORCH_DTYPE[dtype], pin_memory=True)
        host.numpy()[...] = a
        return host.to(device, non_blocking=True)
    return torch.tensor(a.astype(dtype, copy=False), device=device)  # gwlint: ok R1 the CPU branch: nothing crosses a bus


def start_host_copy(out: torch.Tensor):
    """Queue ``out``'s copy to the host behind the work that computes it.
    Returns (host tensor, done event, copied event); on the CPU the events
    are None and the host tensor is ``out`` itself."""
    if out.device.type != "cuda":
        return out, None, None
    stream = torch.cuda.current_stream(out.device)
    done = torch.cuda.Event()
    done.record(stream)
    host, copied = _copy_to_pinned(out, stream)
    return host, done, copied


def _copy_to_pinned(t: torch.Tensor, stream):
    """Queue ``t``'s copy into a pinned host buffer on ``stream``; returns
    (host tensor, event recorded after the copy)."""
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    copied = torch.cuda.Event()
    copied.record(stream)
    return host, copied


class HostArray:
    """A device tensor's copy to the host, queued at once without waiting
    on the device; ``np.asarray`` of it waits for that copy only. On the CPU
    it holds the tensor itself."""

    __slots__ = ("_host", "_copied")

    def __init__(self, t: torch.Tensor) -> None:
        if t.device.type == "cuda":
            self._host, self._copied = _copy_to_pinned(
                t, torch.cuda.current_stream(t.device))
        else:
            self._host, self._copied = t, None

    def __array__(self, dtype=None, copy=None):
        if self._copied is not None:
            self._copied.synchronize()
            self._copied = None
        a = self._host.numpy()
        return a if dtype is None else a.astype(dtype, copy=False)


def check_space_ids(space: np.ndarray, active: np.ndarray) -> None:
    """The kernel path carries space ids as f32 cell features; ids >= 2^24
    lose integer precision and distinct spaces could compare equal."""
    s = np.asarray(space)
    a = np.asarray(active)
    if a.any() and int(s[a].max()) >= (1 << 24):
        raise ValueError(
            f"space id {int(s[a].max())} not exactly representable as f32 "
            f"(>= 2^24); the kernel backend requires space ids < {1 << 24}"
        )


def check_radius(params: NeighborParams, radius: np.ndarray,
                 active: np.ndarray) -> None:
    """The 3x3 cell gather only covers AOI distance <= cell_size: a larger
    radius would silently miss true neighbors, so reject it loudly."""
    r = np.asarray(radius)
    a = np.asarray(active)
    if a.any() and float(r[a].max()) > params.cell_size:
        raise ValueError(
            f"AOI radius {float(r[a].max())} exceeds cell_size "
            f"{params.cell_size}; enlarge cell_size (it must be >= "
            f"the maximum AOI distance)"
        )
