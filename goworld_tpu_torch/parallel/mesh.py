"""Entity-sharded AOI over a list of devices, the port of
``goworld_tpu.parallel.mesh``.

The JAX module shards entity rows over a mesh axis and runs one body per
device under ``shard_map``. Here a "mesh" is a list of ``torch.device``, one
per shard, and repeats are allowed: eight shards may live on one card. A
per-shard body is a loop over the shards, and each collective becomes
device-side tensor movement: ``all_gather`` is a concatenation of every
shard's rows onto each shard's device, with no host round trip. The part of
a body that every shard computes alike (the all-gathered world, both
epochs' grids, the guard) is built once per device and shared by the shards
on it, so eight shards on one card build it once, not eight times.

Two programs, as in the JAX module:

- the all-gather program ``_sharded_step`` (backend ``"reference"``, and
  the strip tier's exact fallback): each shard's queries are its own entity
  rows, through candidate-id matrices; ``_sharded_drain`` pages it by flat
  index.
- the slab-kernel program ``_sharded_step_kernel`` (backend ``"kernel"``,
  the port of ``_sharded_step_pallas``): the inputs stay row-sharded and
  are all-gathered, but the WORK is sharded over grid rows. Each device
  builds both epochs' grids and dense cell layouts once; shard d launches
  the event kernel's mask forms on its slab of ``grid_z / D`` rows plus the
  halo rows, ``cells[:, d*rows : d*rows + rows + 2]``, and drains the events
  of the entities binned in that slab. Every event comes out exactly once,
  since each entity lies in one cell per pass, but a shard's events are
  those of its CELLS, not of its rows. ``_sharded_drain_bits`` pages it by
  event rank. With several space slots the slab view is not contiguous and
  is copied before the launch (``event_mask`` takes contiguous cells); with
  one space slot it is a view.

``ShardedNeighborEngine`` drives either, with the single-device engine's
host interface: ``step_async`` never waits on the device, and
``ShardedPendingStep.collect`` makes one blocking read of the stacked
per-shard blocks, then pages each shard past its inline budget.

Each call of ``_sharded_step`` (``_sharded_step_fused``,
``_sharded_step_kernel``) counts one ``sharded_step`` (``sharded_step_fused``,
``sharded_step_kernel``) launch in ``telemetry.sentinel``, as the JAX
module's ``SentinelJit`` wrappers count calls of the programs; the drains
are pages, not steps, and are not counted. The transfer counters
(``aoi_allgather_*``, ``aoi_link_bytes_total``) count what one tick
structurally moves between shards, as the JAX module counts them.
"""

from __future__ import annotations

import numpy as np
import torch

from goworld_tpu_torch import telemetry
from goworld_tpu_torch.ops.event_kernel import event_mask
from goworld_tpu_torch.ops.neighbor import (
    LANES,
    _PACK,
    NeighborParams,
    _apply_fused_logic,
    _bins,
    _build_table,
    _drain_bits,
    _drain_ids,
    _epoch_mask,
    _fast_guard,
    _gather_cands,
    _popcount16,
    _scatter_feats,
    check_radius,
    check_space_ids,
    start_host_copy,
    upload,
)
from goworld_tpu_torch.telemetry import sentinel

_W = 9 * LANES // _PACK  # words per packed mask row

# Transfer accounting for the all-gather tiers: what one entity-sharded
# tick structurally moves between shards (every other shard's rows, both
# epochs), beside the strip tier's halo figures on /metrics, /cluster and
# gwtop.
_M_ALLGATHER_EQUIV = telemetry.gauge(
    "aoi_allgather_equiv_bytes_per_tick",
    "What the all-gather formulation moves per tick at this tier (every "
    "other shard's rows, both epochs, on D devices).",
)
_M_ALLGATHER_TOTAL = telemetry.counter(
    "aoi_allgather_bytes_total",
    "Bytes moved between shards by all-gather AOI ticks (the entity-"
    "sharded tier every tick; the spatial tier only on exact-fallback "
    "ticks).",
)
# Per-link transfer accounting: what each receiving shard or process pulls
# per tick. tier: ici-allgather (between the shards of one process),
# dcn-allgather (between processes, parallel/multihost.py), halo (the strip
# tier's seam bands).
_M_LINK_BYTES = telemetry.counter(
    "aoi_link_bytes_total",
    "Per-link device-comms bytes by tier (ici-allgather / dcn-allgather "
    "/ halo) and link (receiving device, host slice, or strip seam).",
    ("tier", "link"),
)

# Bytes of one entity row of both epochs' all-gathered features: pos 8 B +
# active 1 B + space 4 B + radius 4 B, twice.
ALLGATHER_ROW_BYTES = 34


def _normalize(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(n_strips: int, device=None) -> list[torch.device]:
    """A 1-D mesh of ``n_strips`` shards: the device of each.

    ``device`` None means the current CUDA device, and raises when there is
    none; a device (or its name) puts every shard on it; a list of devices
    spreads the shards over them in contiguous runs, so ring-adjacent
    strips share a card where they can."""
    if n_strips < 1:
        raise ValueError(f"need at least one shard, got {n_strips}")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh places shards on CUDA unless told otherwise, and "
                "no CUDA device is available; pass device='cpu'"
            )
        device = "cuda"
    if isinstance(device, (list, tuple)):
        devs = [_normalize(d) for d in device]
        if not devs:
            raise ValueError("empty device list")
        return [devs[k * len(devs) // n_strips] for k in range(n_strips)]
    return [_normalize(device)] * n_strips


def shard_rows(a: np.ndarray, mesh: list[torch.device], dtype) -> list:
    """Host array ``a`` cut into ``len(mesh)`` equal row chunks, chunk d on
    ``mesh[d]``; shards on one device share one upload (their chunks are
    views of it)."""
    n = len(mesh)
    chunk = len(a) // n
    out: list = [None] * n
    for dev in dict.fromkeys(mesh):
        idx = [d for d in range(n) if mesh[d] == dev]
        host = a if len(idx) == n else np.concatenate(
            [a[d * chunk:(d + 1) * chunk] for d in idx])
        t = upload(host, dtype, dev)
        for k, d in enumerate(idx):
            out[d] = t[k * chunk:(k + 1) * chunk]
    return out


def all_gather(xs: list, mesh: list[torch.device], stacked: bool = False):
    """``jax.lax.all_gather`` over the shards: each shard's device gets every
    shard's ``xs[d]``, concatenated (``tiled``) or stacked on a new leading
    axis. Shards on one device share one result."""
    joined = {}
    for dev in dict.fromkeys(mesh):
        parts = [x.to(dev) for x in xs]  # gwlint: ok R1 a device-to-device copy between shards; the host does not wait
        joined[dev] = torch.stack(parts) if stacked else torch.cat(parts)
    return [joined[dev] for dev in mesh]


def _gathered_worlds(mesh: list[torch.device], arrays_l: tuple) -> dict:
    """The all-gather of both epochs' rows: per device of the mesh, the
    eight full-capacity arrays (ppos, pact, pspc, prad, pos, act, spc,
    rad), each the concatenation of every shard's chunk."""
    return {dev: tuple(torch.cat([x.to(dev) for x in xs]) for xs in arrays_l)  # gwlint: ok R1 a device-to-device copy between shards; the host does not wait
            for dev in dict.fromkeys(mesh)}


def _pack_blocks(headers: list, pairs: list, counts_rows: list) -> list:
    """Each shard's packed block [3 + D + 2E, 2]: its header rows, the
    per-shard counts rows, its enter pairs, its leave pairs."""
    return [torch.cat([h, c, *pr], dim=0)
            for h, c, pr in zip(headers, counts_rows, pairs)]


# --- the all-gather program ---------------------------------------------------


def _reference_world(p: NeighborParams, ppos, pact, pspc, prad, pos, act,
                     spc, rad) -> tuple:
    """The all-gather program's replicated part on one device: both epochs'
    bins and tables (cell_capacity stride) and the guard."""
    m = p.cell_capacity
    cxc, czc, smc = _bins(p, pos, spc)
    cxp, czp, smp = _bins(p, ppos, pspc)
    buc_c = (smc * p.grid_z + czc) * p.grid_x + cxc
    buc_p = (smp * p.grid_z + czp) * p.grid_x + cxp
    table_c, slot_c, dropped_c, _, _ = _build_table(p, buc_c, act, m)
    table_p, slot_p, _, _, _ = _build_table(p, buc_p, pact, m)
    fast = _fast_guard(p, ppos, pact, pspc, prad, pos, act, spc, dropped_c)
    return (ppos, pact, pspc, prad, pos, act, spc, rad,
            cxc, czc, smc, cxp, czp, smp, table_c, table_p,
            slot_c >= 0, slot_p >= 0, dropped_c, fast)


def _reference_shard(p: NeighborParams, events_inline: int, chunk: int,
                     shard: int, world: tuple):
    """One shard's queries, rows [shard*chunk, (shard+1)*chunk), against the
    world of ``_reference_world``. Returns (enter_ids [chunk, 9M],
    leave_ids [chunk, 9M], header [3, 2], (enter pairs [E, 2], leave pairs
    [E, 2])), the pairs with global entity ids.

    The JAX body branches its leave pass with ``lax.cond``; here both
    branches run and the replicated guard selects on the device."""
    n = p.capacity
    (ppos, pact, pspc, prad, pos, act, spc, rad, cxc, czc, smc, cxp,
     czp, smp, table_c, table_p, av_c, av_p, dropped_c, fast) = world
    dev = pos.device
    lo = shard * chunk
    sl = slice(lo, lo + chunk)
    q_ids = lo + torch.arange(chunk, dtype=torch.int32, device=dev)

    # Enter pass: candidates from the current grid, this shard's queries.
    cand_c = _gather_cands(p, table_c, cxc[sl], czc[sl], smc[sl])
    vc = _epoch_mask(p, cand_c, q_ids, pos[sl], av_c[sl], spc[sl],
                     rad[sl], pos, av_c, spc)
    vp_on_c = _epoch_mask(p, cand_c, q_ids, ppos[sl], av_p[sl],
                          pspc[sl], prad[sl], ppos, av_p, pspc)
    enter_mask = vc & ~vp_on_c
    # Leave pass on both grids; the guard picks one.
    cand_p = _gather_cands(p, table_p, cxp[sl], czp[sl], smp[sl])
    vp = _epoch_mask(p, cand_p, q_ids, ppos[sl], av_p[sl], pspc[sl],
                     prad[sl], ppos, av_p, pspc)
    vc_on_p = _epoch_mask(p, cand_p, q_ids, pos[sl], av_c[sl], spc[sl],
                          rad[sl], pos, av_c, spc)
    leave_mask = torch.where(fast, vp_on_c & ~vc, vp & ~vc_on_p)
    cand_l = torch.where(fast, cand_c, cand_p)
    del vc, vp_on_c, vp, vc_on_p, cand_p

    e_ids = torch.where(enter_mask, cand_c, n)
    l_ids = torch.where(leave_mask, cand_l, n)
    n_enters = enter_mask.sum(dtype=torch.int32)
    n_leaves = leave_mask.sum(dtype=torch.int32)
    del enter_mask, leave_mask, cand_c, cand_l

    def globalize(pr):
        ent = torch.where(pr[:, 0] < chunk, pr[:, 0] + lo, n)
        return torch.stack([ent, pr[:, 1]], dim=1)

    ep, ei = _drain_ids(e_ids, n, events_inline, 0)
    lp, li = _drain_ids(l_ids, n, events_inline, 0)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    header = torch.stack([
        torch.stack([n_enters, n_leaves]),
        torch.stack([dropped_c, zero]),
        torch.stack([ei[events_inline - 1], li[events_inline - 1]]),
    ]).to(torch.int32)
    return e_ids, l_ids, header, (globalize(ep), globalize(lp))


def _sharded_step_body(
    p: NeighborParams,
    events_inline: int,  # per-shard inline event budget E
    mesh: list[torch.device],
    ppos_l, pact_l, pspc_l, prad_l,  # each shard's previous-tick rows
    pos_l, act_l, spc_l, rad_l,  # each shard's current-tick rows
):
    """The all-gather program, every shard's body. Each argument after
    ``mesh`` is a list of per-shard row chunks. Returns lists over the
    shards of (enter_ids [chunk, 9M], leave_ids [chunk, 9M],
    out [3 + D + 2E, 2]). The replicated grid is built once per device and
    shared by the shards on it."""
    worlds = {
        dev: _reference_world(p, *arrays)
        for dev, arrays in _gathered_worlds(
            mesh, (ppos_l, pact_l, pspc_l, prad_l,
                   pos_l, act_l, spc_l, rad_l)).items()
    }
    enter_ctx, leave_ctx, headers, pairs = _shard_steps(
        p, events_inline, "reference", len(mesh), worlds,
        range(len(mesh)), mesh)
    # EVERY shard's counts, replicated into each block.
    counts_all = all_gather([h[0] for h in headers], mesh, stacked=True)
    return ([c[0] for c in enter_ctx], [c[0] for c in leave_ctx],
            _pack_blocks(headers, pairs, counts_all))


def _sharded_step(*args):
    """The all-gather program (``_sharded_step_body``'s arguments and
    results), counted as one ``sharded_step`` launch."""
    sentinel.note_launch("sharded_step")
    return _sharded_step_body(*args)


def _fused_rows(programs, mesh: list[torch.device], pos_l, y_l, yaw_l,
                sel_l, dt_l, cols_l):
    """The fused entity logic on every shard's LOCAL rows (elementwise, so
    no rows travel), joined on the first shard's device in ROW order:
    (new_pos [N, 2], new_y, new_yaw, *new_cols). ``cols_l`` holds one list
    over the shards per column; ``dt_l`` one float32 scalar per shard."""
    parts = []
    for d in range(len(mesh)):
        new_pos, new_y, new_yaw, new_cols = _apply_fused_logic(
            programs, pos_l[d], y_l[d], yaw_l[d], sel_l[d], dt_l[d],
            tuple(c[d] for c in cols_l))
        parts.append((new_pos, new_y, new_yaw) + new_cols)
    dev0 = mesh[0]
    return tuple(torch.cat([part[i].to(dev0) for part in parts])  # gwlint: ok R1 a device-to-device copy between shards; the host does not wait
                 for i in range(len(parts[0])))


def _sharded_step_fused(
    p: NeighborParams, events_inline: int, mesh: list[torch.device],
    programs,
    ppos_l, pact_l, pspc_l, prad_l,
    pos_l, act_l, spc_l, rad_l,
    y_l, yaw_l, sel_l, dt_l, *cols_l,
):
    """The all-gather step plus fused entity logic on each shard's LOCAL
    rows. The spatial engine's exact-fallback ticks use it, so a teleport
    or overflow tick still advances the fused programs; the outputs are in
    ROW space, mapped back through the dispatch-time perm snapshot by the
    caller. One ``sharded_step_fused`` launch."""
    sentinel.note_launch("sharded_step_fused")
    enter_ids, leave_ids, outs = _sharded_step_body(
        p, events_inline, mesh,
        ppos_l, pact_l, pspc_l, prad_l,
        pos_l, act_l, spc_l, rad_l,
    )
    fused = _fused_rows(programs, mesh, pos_l, y_l, yaw_l, sel_l, dt_l,
                        cols_l)
    return enter_ids, leave_ids, outs, fused


def _sharded_drain(
    p: NeighborParams, events_inline: int, chunk: int, shard: int,
    ids_l: torch.Tensor,  # [chunk, 9M] this shard's event-id matrix
    start: int,  # this shard's resume cursor (local flat index)
):
    """One shard's storm page: (pairs [E, 2] with global entity ids, flat
    positions [E])."""
    n = p.capacity
    pairs, idx = _drain_ids(ids_l, n, events_inline, start)
    ent = torch.where(pairs[:, 0] < chunk, pairs[:, 0] + shard * chunk, n)
    return torch.stack([ent, pairs[:, 1]], dim=1), idx


# --- the slab-kernel program --------------------------------------------------


def _kernel_world(p: NeighborParams, ppos, pact, pspc, prad, pos, act, spc,
                  rad) -> tuple:
    """The slab program's replicated part on one device: both epochs'
    grids (LANES stride) and dense cell layouts, the guard, and the leave
    pass's grid selected by it. Returns (cells_c, cells_p, cur grid,
    leave grid, dropped, fast), each grid (cx, cz, sm, table, slot).

    The JAX body scatters the previous grid's layout only on slow ticks,
    under ``lax.cond``; here both layouts are scattered every tick and the
    single form's launch on the previous one is skipped on the device when
    the guard holds, so nothing waits on the device."""
    gz, gx = p.grid_z, p.grid_x

    def grid(xpos, xact, xspc):
        cx, cz, sm = _bins(p, xpos, xspc)
        table, slot, dropped, order, dst = _build_table(
            p, (sm * gz + cz) * gx + cx, xact, LANES)
        return (cx, cz, sm, table, slot), dropped, order, dst

    cur, dropped_c, order_c, dst_c = grid(pos, act, spc)
    prev, _, order_p, dst_p = grid(ppos, pact, pspc)
    # Each epoch's x row poisoned by its OWN slot validity
    # (ops/neighbor._step_pallas).
    nan = float("nan")
    xs_c = torch.where(cur[4] >= 0, pos[:, 0], nan)
    xs_p = torch.where(prev[4] >= 0, ppos[:, 0], nan)
    cur_feats = (xs_c, pos[:, 1], spc, rad)
    prev_feats = (xs_p, ppos[:, 1], pspc, prad)
    cells_c = _scatter_feats(p, dst_c, order_c, cur_feats, prev_feats)
    cells_p = _scatter_feats(p, dst_p, order_p, prev_feats, cur_feats)
    fast = _fast_guard(p, ppos, pact, pspc, prad, pos, act, spc, dropped_c)
    leave = tuple(torch.where(fast, a, b) for a, b in zip(cur, prev))
    return cells_c, cells_p, cur, leave, dropped_c, fast


def _slab(cells: torch.Tensor, lo: int, rows: int) -> torch.Tensor:
    """Rows [lo, lo + rows) of the layout with their halo rows:
    ``cells[:, lo:lo + rows + 2]``. A view when there is one space slot;
    with several the view is not contiguous, and this copies it."""
    slab = cells[:, lo:lo + rows + 2]
    return slab if slab.is_contiguous() else slab.contiguous()


def _slab_rows(p: NeighborParams, packed_cells: torch.Tensor, rows: int,
               lo: int, grid: tuple) -> torch.Tensor:
    """Per-entity packed words [N, W] of the entities binned in the slab
    (the first W words of each lane's row); zeros for every other entity."""
    cx, cz, sm, _, slot = grid
    flat = packed_cells.reshape(-1, packed_cells.shape[-1])
    local = ((sm * rows + (cz - lo)) * p.grid_x + cx) * LANES \
        + torch.remainder(slot, LANES)
    mine = (slot >= 0) & (cz >= lo) & (cz < lo + rows)
    safe = torch.clamp(local, 0, flat.shape[0] - 1).long()
    return torch.where(mine[:, None], flat[safe, :_W], 0)


def _kernel_shard(p: NeighborParams, events_inline: int, rows: int,
                  shard: int, world: tuple):
    """Shard ``shard``'s slab of the world of ``_kernel_world``: the dual
    mask form on the current layout's slab, the single form on the previous
    one's (skipped when the guard holds), the slab's entities' words, and
    the rank-select drain at the inline budget. Returns (enter_ctx,
    leave_ctx, header [3, 2], (enter pairs, leave pairs)); the contexts are
    the pager's (packed words [N, W], cx, cz, sm, table)."""
    cells_c, cells_p, cur, leave, dropped_c, fast = world
    lo = shard * rows
    pk2 = event_mask(_slab(cells_c, lo, rows), dual=True)
    pk_p = event_mask(_slab(cells_p, lo, rows), dual=False, skip=fast)
    # The dual form's enter words are the single form's on the same slab.
    packed_e = _slab_rows(p, pk2, rows, lo, cur)
    pk_l = torch.where(fast, pk2[..., _W:], pk_p)
    del pk2, pk_p
    packed_l = _slab_rows(p, pk_l, rows, lo, leave)
    del pk_l
    n_enters = _popcount16(packed_e).sum(dtype=torch.int32)
    n_leaves = _popcount16(packed_l).sum(dtype=torch.int32)
    ep, _ = _drain_bits(p, packed_e, *cur[:4], 0, max_events=events_inline)
    lp, _ = _drain_bits(p, packed_l, *leave[:4], 0,
                        max_events=events_inline)
    zero = torch.zeros((), dtype=torch.int32, device=packed_e.device)
    header = torch.stack([
        torch.stack([n_enters, n_leaves]),
        torch.stack([dropped_c, zero]),
        torch.stack([zero, zero]),  # rank paging resumes at E
    ])
    return ((packed_e,) + cur[:4], (packed_l,) + leave[:4], header,
            (ep, lp))


_WORLDS = {"kernel": _kernel_world, "reference": _reference_world}


def _shard_steps(p: NeighborParams, events_inline: int, backend: str,
                 n_dev: int, worlds: dict, shards, devices):
    """The bodies of the shards ``shards`` (global indices of ``n_dev``,
    each on its entry of ``devices``) on their devices' worlds, built by
    ``_WORLDS[backend]``. Returns lists over those shards of enter_ctx,
    leave_ctx (the pager's payloads), header [3, 2] and (enter pairs,
    leave pairs)."""
    enter_ctx, leave_ctx, headers, pairs = [], [], [], []
    for shard, dev in zip(shards, devices):
        if backend == "kernel":
            e_ctx, l_ctx, header, pr = _kernel_shard(
                p, events_inline, p.grid_z // n_dev, shard, worlds[dev])
        else:
            e_ids, l_ids, header, pr = _reference_shard(
                p, events_inline, p.capacity // n_dev, shard, worlds[dev])
            e_ctx, l_ctx = (e_ids,), (l_ids,)
        enter_ctx.append(e_ctx)
        leave_ctx.append(l_ctx)
        headers.append(header)
        pairs.append(pr)
    return enter_ctx, leave_ctx, headers, pairs


def _sharded_step_kernel(
    p: NeighborParams,
    events_inline: int,
    mesh: list[torch.device],
    ppos_l, pact_l, pspc_l, prad_l,
    pos_l, act_l, spc_l, rad_l,
):
    """The slab-kernel program (the port of ``_sharded_step_pallas``):
    lists over the shards of (enter_ctx, leave_ctx, out [3 + D + 2E, 2]).
    The grids and layouts are built once per device; each shard launches
    the mask forms on its own slab of ``grid_z / D`` rows. One
    ``sharded_step_kernel`` launch."""
    sentinel.note_launch("sharded_step_kernel")
    worlds = {
        dev: _kernel_world(p, *arrays)
        for dev, arrays in _gathered_worlds(
            mesh, (ppos_l, pact_l, pspc_l, prad_l,
                   pos_l, act_l, spc_l, rad_l)).items()
    }
    enter_ctx, leave_ctx, headers, pairs = _shard_steps(
        p, events_inline, "kernel", len(mesh), worlds, range(len(mesh)),
        mesh)
    counts_all = all_gather([h[0] for h in headers], mesh, stacked=True)
    return enter_ctx, leave_ctx, _pack_blocks(headers, pairs, counts_all)


def _sharded_drain_bits(
    p: NeighborParams, events_inline: int,
    packed_l, cx_l, cz_l, sm_l, table_l,  # one shard's drain context
    start: int,  # resume EVENT RANK
):
    """Slab-kernel storm paging: (pairs [E, 2], total events). Rows are
    global entity ids already."""
    return _drain_bits(p, packed_l, cx_l, cz_l, sm_l, table_l, start,
                       max_events=events_inline)


def _page_shards(engine, ctx: list, shards: list[int], deficit: np.ndarray,
                 starts: np.ndarray) -> list[np.ndarray]:
    """Chunked drains for events past the inline budget, for the shards
    ``shards`` (global indices; ``ctx``, ``deficit`` and ``starts`` follow
    their order): the slab program's by event rank, the all-gather
    program's by flat index. One host copy a round."""
    p = engine.params
    e = engine.events_inline
    rank_paging = engine.backend == "kernel"
    dev0 = ctx[0][0].device
    chunks: list[np.ndarray] = []
    starts = starts.copy()
    deficit = deficit.copy()
    while deficit.any():
        work = [(k, int(min(e, deficit[k])))
                for k in range(len(shards)) if deficit[k] > 0]
        pairs, aux = [], []
        for k, take in work:
            if rank_paging:
                pr, _ = _sharded_drain_bits(p, e, *ctx[k], int(starts[k]))
            else:
                pr, idx = _sharded_drain(p, e, engine.chunk, shards[k],
                                         ctx[k][0], int(starts[k]))
                aux.append(idx[take - 1:take].to(dev0))
            pairs.append(pr[:take].to(dev0))
        host_pairs = torch.cat(pairs).cpu().numpy()
        host_aux = torch.cat(aux).cpu().numpy() if aux else None
        at = 0
        for i, (k, take) in enumerate(work):
            chunks.append(host_pairs[at:at + take])
            at += take
            deficit[k] -= take
            if rank_paging:
                starts[k] += take
            elif deficit[k] > 0:
                starts[k] = int(host_aux[i]) + 1
    return chunks


class ShardedPendingStep:
    """In-flight sharded tick; ``collect()`` = ONE blocking host read of the
    stacked per-shard packed blocks, then (rare) storm paging.

    The blocks are concatenated on the first shard's device and their copy
    to pinned host memory is queued behind the step at dispatch."""

    __slots__ = ("_engine", "_enter_ctx", "_leave_ctx", "_host", "_done",
                 "_copied", "_collected", "rank_paging", "full_repage",
                 "paged", "fused")

    def __init__(self, engine, enter_ctx, leave_ctx, outs: list) -> None:
        self._engine = engine
        self._enter_ctx = enter_ctx  # per-program paging payload tuple
        self._leave_ctx = leave_ctx
        self._collected = False
        # Paging cursor semantics of THIS tick's program: event ranks (the
        # bit drains) or flat indices (the all-gather program).
        self.rank_paging = True
        # In-kernel-drain ticks emit inline pairs in cell-major order: a
        # shard whose events overflow the inline budget cannot resume that
        # window by rank, so collect() discards the shard's inline rows and
        # repages it from rank 0 through the bit drain.
        self.full_repage = False
        # After collect(): the (shard, side) pairs paged past the inline
        # block.
        self.paged = 0
        # Fused-logic payload (programs, sel, row→slot perm snapshot, row-
        # space outputs), set by the strip engine's step_async.
        self.fused = None
        dev0 = outs[0].device
        out = torch.cat([o.to(dev0) for o in outs])  # gwlint: ok R1 a device-to-device copy between shards; the host does not wait
        self._host, self._done, self._copied = start_host_copy(out)

    def is_ready(self) -> bool:
        """True when collect() will not block on device compute."""
        return self._done is None or self._done.query()

    def wait_device(self) -> None:
        """Block until the step has computed its packed blocks."""
        if self._done is not None:
            self._done.synchronize()

    def collect(self) -> tuple[np.ndarray, np.ndarray, int]:
        if self._collected:
            raise RuntimeError("ShardedPendingStep already collected")
        self._collected = True
        if self._copied is not None:
            self._copied.synchronize()  # THE round trip
        eng = self._engine
        e = eng.events_inline
        nd = eng.n_devices
        # Block layout: 3 header rows, nd replicated-counts rows, e enter
        # pairs, e leave pairs. One block for each shard this process
        # steps: every shard, except on the multi-process tier.
        block = 3 + nd + 2 * e
        out = self._host.numpy()
        self._host = None
        nb = len(out) // block
        enters, leaves = [], []
        enter_deficit = np.zeros(nb, np.int64)
        leave_deficit = np.zeros(nb, np.int64)
        enter_starts = np.zeros(nb, np.int64)
        leave_starts = np.zeros(nb, np.int64)
        dropped = 0
        for d in range(nb):
            o = out[d * block:(d + 1) * block]
            n_e, n_l = int(o[0, 0]), int(o[0, 1])
            dropped = int(o[1, 0])  # replicated diagnostic, same on all
            if self.full_repage and n_e > e:
                enter_deficit[d] = n_e  # the whole shard through the drain
            else:
                enters.append(o[3 + nd:3 + nd + min(n_e, e)].copy())
                enter_deficit[d] = max(0, n_e - e)
                enter_starts[d] = e if self.rank_paging else int(o[2, 0]) + 1
            if self.full_repage and n_l > e:
                leave_deficit[d] = n_l
            else:
                leaves.append(o[3 + nd + e:3 + nd + e + min(n_l, e)].copy())
                leave_deficit[d] = max(0, n_l - e)
                leave_starts[d] = e if self.rank_paging else int(o[2, 1]) + 1
        self.paged = int((enter_deficit > 0).sum() + (leave_deficit > 0).sum())
        if enter_deficit.any():
            enters += eng._page(self._enter_ctx, enter_deficit, enter_starts)
        if leave_deficit.any():
            leaves += eng._page(self._leave_ctx, leave_deficit, leave_starts)
        # The paging contexts hold each shard's packed words (or id
        # matrices): let them go however long the caller keeps this step.
        self._enter_ctx = self._leave_ctx = None
        eng.last_grid_dropped = dropped
        # Header flags (out[1, 1], replicated): the strip engine reports the
        # seam-free fast-tick bit there; the other programs write 0.
        eng._note_step_flags(int(out[1, 1]))
        return (
            np.concatenate(enters) if enters else np.empty((0, 2), np.int32),
            np.concatenate(leaves) if leaves else np.empty((0, 2), np.int32),
            dropped,
        )


def check_mesh_params(params: NeighborParams, n_dev: int,
                      backend: str) -> None:
    """The entity-sharded tiers' constructor checks: whole 8-row chunks per
    shard, an even split of the inline budget, and for the slab kernel one
    whole slab of rows per shard (and the kernel's 128 lanes a cell)."""
    if params.capacity % (8 * n_dev) != 0:
        raise ValueError(
            f"capacity {params.capacity} must be a multiple of 8*{n_dev}"
        )
    if params.max_events % n_dev != 0:
        raise ValueError(
            f"max_events {params.max_events} must be divisible by {n_dev}"
        )
    if backend == "kernel":
        if params.grid_z % n_dev != 0:
            raise ValueError(
                f"kernel path needs grid_z {params.grid_z} divisible by "
                f"{n_dev} (one slab of rows per shard)"
            )
        if params.cell_capacity > LANES:
            raise ValueError(
                f"kernel path supports cell_capacity <= {LANES}, "
                f"got {params.cell_capacity}"
            )


class ShardedNeighborEngine:
    """Multi-shard AOI engine: the same semantics and event stream as the
    single-device engine, with entity rows sharded over a mesh (slot i lives
    on shard i // (N / D)).

        eng = ShardedNeighborEngine(params, make_mesh(8))  # 8 shards, 1 card
        eng.reset()
        enters, leaves, dropped = eng.step(pos, active, space, radius)

    ``backend``: ``"kernel"`` (what ``"auto"`` means) runs the slab-kernel
    program, the event kernel's mask forms on ``grid_z / D`` rows a shard
    (on a CPU mesh their plain versions); ``"reference"`` runs the
    all-gather program. The enter and leave arrays come in the JAX engine's
    order: each shard's inline pairs in shard order, then the paged chunks
    round by round.
    """

    def __init__(self, params: NeighborParams, mesh: list[torch.device],
                 backend: str = "auto"):
        if backend == "auto":
            backend = "kernel"
        if backend not in ("reference", "kernel"):
            raise ValueError(f"unknown backend {backend!r}")
        mesh = [torch.device(d) for d in mesh]
        n_dev = len(mesh)
        check_mesh_params(params, n_dev, backend)
        self.params = params
        self.mesh = mesh
        self.backend = backend
        self.n_devices = n_dev
        self.chunk = params.capacity // n_dev
        # Inline budget per shard; total inline capacity stays max_events.
        self.events_inline = params.max_events // n_dev
        # Structural traffic of one tick: every other shard's rows, both
        # epochs, on D shards.
        self._link_bytes = (params.capacity - self.chunk) * ALLGATHER_ROW_BYTES
        self.allgather_bytes_per_tick = n_dev * self._link_bytes
        _M_ALLGATHER_EQUIV.set(self.allgather_bytes_per_tick)
        self._link_children = tuple(
            _M_LINK_BYTES.labels("ici-allgather", f"dev{d}")
            for d in range(n_dev))
        self._state: tuple | None = None
        self.last_grid_dropped = 0

    def reset(self) -> None:
        """An all-inactive previous tick: the next step emits the full
        enter storm."""
        n = self.params.capacity
        self._state = (
            shard_rows(np.zeros((n, 2), np.float32), self.mesh, np.float32),
            shard_rows(np.zeros(n, bool), self.mesh, np.bool_),
            shard_rows(np.zeros(n, np.int32), self.mesh, np.int32),
            shard_rows(np.zeros(n, np.float32), self.mesh, np.float32),
        )

    def carried_epoch(self) -> tuple:
        """The last dispatched world (rows == slots here) as numpy."""
        if self._state is None:
            raise RuntimeError("call reset() first")
        return tuple(torch.cat([x.cpu() for x in xs]).numpy()
                     for xs in self._state)

    def _page(self, ctx: list, deficit: np.ndarray,
              starts: np.ndarray) -> list[np.ndarray]:
        return _page_shards(self, ctx, list(range(self.n_devices)),
                            deficit, starts)

    def _note_step_flags(self, flags: int) -> None:
        """Header flags: both programs write 0 here."""

    def step_async(
        self,
        pos: np.ndarray,
        active: np.ndarray,
        space: np.ndarray,
        radius: np.ndarray,
        meta_dirty: bool = True,
    ) -> ShardedPendingStep:
        """Dispatch one tick without waiting on the device (the single-device
        engine's contract, including ``meta_dirty=False``: active, space and
        radius unchanged since the previous step, their device copies
        reused)."""
        if self._state is None:
            raise RuntimeError("call reset() first")
        n = self.params.capacity
        if np.shape(pos) != (n, 2):
            raise ValueError(f"pos must be [{n}, 2], got {np.shape(pos)}")
        check_radius(self.params, radius, active)
        if self.backend == "kernel":
            check_space_ids(space, active)
        mesh = self.mesh
        if meta_dirty:
            meta = (
                shard_rows(np.asarray(active), mesh, np.bool_),
                shard_rows(np.asarray(space), mesh, np.int32),
                shard_rows(np.asarray(radius), mesh, np.float32),
            )
        else:
            meta = self._state[1:4]
        cur = (shard_rows(np.asarray(pos), mesh, np.float32),) + meta
        args = (self.params, self.events_inline, mesh, *self._state, *cur)
        if self.backend == "kernel":
            enter_ctx, leave_ctx, outs = _sharded_step_kernel(*args)
        else:
            enter_ids, leave_ids, outs = _sharded_step(*args)
            enter_ctx = [(x,) for x in enter_ids]
            leave_ctx = [(x,) for x in leave_ids]
        self._state = cur
        _M_ALLGATHER_TOTAL.inc(self.allgather_bytes_per_tick)
        for child in self._link_children:
            child.inc(self._link_bytes)
        pending = ShardedPendingStep(self, enter_ctx, leave_ctx, outs)
        pending.rank_paging = self.backend == "kernel"
        return pending

    def step(
        self,
        pos: np.ndarray,
        active: np.ndarray,
        space: np.ndarray,
        radius: np.ndarray,
    ) -> tuple[np.ndarray, np.ndarray, int]:
        """Run one tick; returns host (enter_pairs, leave_pairs, dropped)."""
        return self.step_async(pos, active, space, radius).collect()
