"""Entity-sharded AOI over a list of devices, the port of
``goworld_tpu.parallel.mesh`` (the parts the strip tier runs).

The JAX module shards entity rows over a mesh axis and runs one body per
device under ``shard_map``. Here a "mesh" is a list of ``torch.device``, one
per shard, and repeats are allowed: eight strips may live on one card. A
per-shard body is a loop over the shards, and each collective becomes
device-side tensor movement: ``all_gather`` is a concatenation of every
shard's rows onto each shard's device, with no host round trip.

Ported: ``make_mesh``, the all-gather program ``_sharded_step`` (the strip
tier's exact fallback) and its fused-logic variant ``_sharded_step_fused``,
``_sharded_drain`` and ``ShardedPendingStep``.
``ShardedNeighborEngine`` and the kernel slab ``_sharded_step_pallas`` come
in a later slice. Each call of ``_sharded_step`` (``_sharded_step_fused``)
counts one ``sharded_step`` (``sharded_step_fused``) launch in
``telemetry.sentinel``, as the JAX module's ``SentinelJit`` wrappers count
calls of the programs; ``_sharded_drain`` is a page, not a step, and is not
counted.
"""

from __future__ import annotations

import numpy as np
import torch

from goworld_tpu_torch.ops.neighbor import (
    NeighborParams,
    _apply_fused_logic,
    _bins,
    _build_table,
    _drain_ids,
    _epoch_mask,
    _fast_guard,
    _gather_cands,
    start_host_copy,
    upload,
)
from goworld_tpu_torch.telemetry import sentinel


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
        parts = [x.to(dev) for x in xs]
        joined[dev] = torch.stack(parts) if stacked else torch.cat(parts)
    return [joined[dev] for dev in mesh]


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
    out [3 + D + 2E, 2]).

    The JAX body branches its leave pass with ``lax.cond``; here both
    branches run and the replicated guard selects on the device. The
    replicated grid (both epochs' tables, the guard) is built once per
    device and shared by the shards on it."""
    n = p.capacity
    m = p.cell_capacity
    n_dev = len(mesh)
    chunk = pos_l[0].shape[0]
    world = {}
    for dev in dict.fromkeys(mesh):
        # All-gather: the full world of both epochs on this device.
        ppos, pact, pspc, prad, pos, act, spc, rad = (
            torch.cat([x.to(dev) for x in xs])
            for xs in (ppos_l, pact_l, pspc_l, prad_l,
                       pos_l, act_l, spc_l, rad_l)
        )
        cxc, czc, smc = _bins(p, pos, spc)
        cxp, czp, smp = _bins(p, ppos, pspc)
        buc_c = (smc * p.grid_z + czc) * p.grid_x + cxc
        buc_p = (smp * p.grid_z + czp) * p.grid_x + cxp
        table_c, slot_c, dropped_c, _, _ = _build_table(p, buc_c, act, m)
        table_p, slot_p, _, _, _ = _build_table(p, buc_p, pact, m)
        fast = _fast_guard(p, ppos, pact, pspc, prad, pos, act, spc,
                           dropped_c)
        world[dev] = (ppos, pact, pspc, prad, pos, act, spc, rad,
                      cxc, czc, smc, cxp, czp, smp, table_c, table_p,
                      slot_c >= 0, slot_p >= 0, dropped_c, fast)

    enter_ids, leave_ids, headers, pairs = [], [], [], []
    for shard, dev in enumerate(mesh):
        (ppos, pact, pspc, prad, pos, act, spc, rad, cxc, czc, smc, cxp,
         czp, smp, table_c, table_p, av_c, av_p, dropped_c, fast) = world[dev]
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
        headers.append(torch.stack([
            torch.stack([n_enters, n_leaves]),
            torch.stack([dropped_c, zero]),
            torch.stack([ei[events_inline - 1], li[events_inline - 1]]),
        ]).to(torch.int32))
        pairs.append((globalize(ep), globalize(lp)))
        enter_ids.append(e_ids)
        leave_ids.append(l_ids)
    # EVERY shard's counts, replicated into each block (paging convergence
    # in the JAX multi-controller tier; read the same way here).
    counts_all = all_gather([h[0] for h in headers], mesh, stacked=True)
    outs = [
        torch.cat([headers[d], counts_all[d], *pairs[d]], dim=0)
        for d in range(n_dev)
    ]
    return enter_ids, leave_ids, outs


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
    return tuple(torch.cat([part[i].to(dev0) for part in parts])
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
        # strip-local bit drain) or flat indices (the all-gather fallback).
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
        out = torch.cat([o.to(dev0) for o in outs])
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
        # pairs, e leave pairs.
        block = 3 + nd + 2 * e
        out = self._host.numpy()
        self._host = None
        enters, leaves = [], []
        enter_deficit = np.zeros(nd, np.int64)
        leave_deficit = np.zeros(nd, np.int64)
        enter_starts = np.zeros(nd, np.int64)
        leave_starts = np.zeros(nd, np.int64)
        dropped = 0
        for d in range(nd):
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
        # seam-free fast-tick bit there; the fallback program writes 0.
        eng._note_step_flags(int(out[1, 1]))
        return (
            np.concatenate(enters) if enters else np.empty((0, 2), np.int32),
            np.concatenate(leaves) if leaves else np.empty((0, 2), np.int32),
            dropped,
        )
