"""The plain reference of the AOI tick: interest sets and their diff,
recomputed from the generated positions in plain PyTorch.

The deployment's semantics, as the configuration states them:

- entity ``i`` is interested in ``j`` at a tick when both are visible,
  they share a space, ``i != j`` and ``dx*dx + dz*dz <= r_i*r_i`` in
  float32, each operation rounded (``dx = x_j - x_i``);
- the world is binned into square cells of ``cell_size`` on a torus of
  ``grid_x`` by ``grid_z`` cells (``floor(x / cell_size)`` modulo the
  grid); a cell shows at most ``cell_capacity`` active entities of a space,
  the lowest row ids first, and the rest are invisible that tick
  (``dropped`` counts them);
- a tick's enters are the pairs interested now and not at the tick before,
  its leaves the pairs interested before and not now.

Pairs are enumerated through the cells: a query's candidates are the
visible entities of its 3x3 block of cells, which holds every entity
within ``cell_size`` of it. Pairs are returned as sorted int64 keys
``i * n + j``.

This module imports nothing of the program: it works on the positions,
flags and settings the benchmark generated.
"""

from __future__ import annotations

import torch

# Queries a block: bounds the candidate temporaries (~9 x 128 a query).
QUERY_BLOCK = 65536


def visibility(pos, active, space, cell_size: float, grid_x: int,
               grid_z: int, cell_capacity: int):
    """(visible bool[n], bucket int64[n], dropped int): each entity's cell
    bucket ``(space, cz, cx)`` and whether the cell's capacity shows it."""
    n = pos.shape[0]
    dev = pos.device
    cell = torch.full((), cell_size, dtype=torch.float32, device=dev)
    cx = torch.remainder(torch.floor(pos[:, 0] / cell).to(torch.int64), grid_x)
    cz = torch.remainder(torch.floor(pos[:, 1] / cell).to(torch.int64), grid_z)
    bucket = (space.to(torch.int64) * grid_z + cz) * grid_x + cx
    ids = torch.arange(n, dtype=torch.int64, device=dev)
    none = (int(space.max()) + 1 if n else 1) * grid_z * grid_x
    key = torch.where(active, bucket, none)
    order = torch.sort(key * n + ids).values % n  # by (bucket, id)
    sk = key[order]
    first = torch.ones(n, dtype=torch.bool, device=dev)
    first[1:] = sk[1:] != sk[:-1]
    start = torch.cummax(torch.where(first, torch.arange(n, device=dev), 0),
                         0).values
    rank = torch.empty(n, dtype=torch.int64, device=dev)
    rank[order] = torch.arange(n, device=dev) - start
    visible = active & (rank < cell_capacity)
    dropped = int(active.sum()) - int(visible.sum())
    return visible, bucket, dropped


def interest(pos, active, space, radius, cell_size: float, grid_x: int,
             grid_z: int, cell_capacity: int, queries=None,
             dtype=torch.float32):
    """(sorted int64 keys of the interested pairs, dropped): the pairs
    ``(i, j)`` of one tick, ``i`` among ``queries`` (a bool mask; None:
    every row). ``dtype`` is the precision the distance test runs in: the
    configuration states float32; the control runs it lower."""
    n = pos.shape[0]
    dev = pos.device
    visible, bucket, dropped = visibility(pos, active, space, cell_size,
                                          grid_x, grid_z, cell_capacity)
    n_buckets = (int(space.max()) + 1 if n else 1) * grid_z * grid_x
    vis_ids = torch.nonzero(visible).reshape(-1)
    vb = bucket[vis_ids]
    by_bucket = vis_ids[torch.argsort(vb)]
    counts = torch.bincount(vb, minlength=n_buckets)
    starts = torch.cumsum(counts, 0) - counts
    q_all = vis_ids if queries is None else vis_ids[queries[vis_ids]]
    x = pos[:, 0].to(dtype)
    z = pos[:, 1].to(dtype)
    r2 = radius.to(dtype) * radius.to(dtype)
    plane = grid_z * grid_x
    keys = []
    for lo in range(0, len(q_all), QUERY_BLOCK):
        q = q_all[lo:lo + QUERY_BLOCK]
        b = bucket[q]
        s_plane = b // plane
        cz = (b % plane) // grid_x
        cx = b % grid_x
        for oz in (-1, 0, 1):
            for ox in (-1, 0, 1):
                nb = (s_plane * grid_z + torch.remainder(cz + oz, grid_z)) \
                    * grid_x + torch.remainder(cx + ox, grid_x)
                c = counts[nb]
                total = int(c.sum())
                if total == 0:
                    continue
                qi = torch.repeat_interleave(q, c, output_size=total)
                base = torch.repeat_interleave(starts[nb] - (torch.cumsum(c, 0) - c),
                                               c, output_size=total)
                j = by_bucket[base + torch.arange(total, device=dev)]
                dx = x[j] - x[qi]
                dz = z[j] - z[qi]
                d2 = dx * dx + dz * dz
                ok = (d2 <= r2[qi]) & (j != qi) & (space[j] == space[qi])
                keys.append(qi[ok] * n + j[ok])
    if not keys:
        return torch.empty(0, dtype=torch.int64, device=dev), dropped
    # Adjacent cells of a small torus can be the same bucket: keep each
    # pair once.
    return torch.unique(torch.cat(keys)), dropped


def diff(before, now):
    """(enters, leaves): keys in ``now`` and not ``before``, and the
    reverse; both sorted."""
    enters = now[~torch.isin(now, before, assume_unique=True)]
    leaves = before[~torch.isin(before, now, assume_unique=True)]
    return enters, leaves


def pair_keys(pairs, n: int, device):
    """Keys ``i * n + j`` of an int [k, 2] array of (i, j) pairs."""
    p = torch.as_tensor(pairs, device=device).to(torch.int64).reshape(-1, 2)
    return p[:, 0] * n + p[:, 1]


def cell_occupancy(pos, visible, space, cell_size: float, grid_x: int,
                   grid_z: int):
    """Visible entities per cell, int64 [spaces, grid_z, grid_x]."""
    dev = pos.device
    cell = torch.full((), cell_size, dtype=torch.float32, device=dev)
    cx = torch.remainder(torch.floor(pos[:, 0] / cell).to(torch.int64), grid_x)
    cz = torch.remainder(torch.floor(pos[:, 1] / cell).to(torch.int64), grid_z)
    n_sp = int(space.max()) + 1 if len(space) else 1
    b = (space.to(torch.int64) * grid_z + cz) * grid_x + cx
    occ = torch.bincount(b[visible], minlength=n_sp * grid_z * grid_x)
    return occ.reshape(n_sp, grid_z, grid_x)
