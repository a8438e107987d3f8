"""The boids kernel's plain version at inputs laid out to test a kernel that
walks only occupied candidates, shares lanes across a sparse cell's queries
and divides by the world size only across the seam, against the JAX Pallas
kernel under the interpreter, on the CPU; the inputs' own properties; and
the counts behind the kernel's bound.

``chip_smoke.boids_skip_edge_cells`` makes the inputs. The CUDA kernel is
held against the same plain version on them in ``tests/test_torch_port.py``
and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import torch

from chip_smoke import (
    BOIDS_SKIP_EDGE, OPS_PER_CLOSE, OPS_PER_IMAGE, OPS_PER_NEIGHBOR,
    OPS_PER_PAIR, OPS_PER_QUERY, boids_five_row_bytes, boids_read_bytes,
    boids_skip_edge_cells, boids_work,
)
from goworld_tpu.ops import boids as jb
from goworld_tpu_torch.ops import boids as tb
from goworld_tpu_torch.ops import boids_kernel as bk

CELLS = boids_skip_edge_cells()
P = tb.BoidsParams(**BOIDS_SKIP_EDGE)


def pairs(cells, p):
    """Every (cell, query lane, candidate) of the 3x3 blocks: the plain
    version's image offsets, d2 and neighbor flag, and the raw differences,
    each [gz * gx, 128, 1152]."""
    idx = torch.arange(p.grid_z * p.grid_x)
    q, cand, dx, dz, d2, nb = bk.halo_pairs(torch.tensor(cells), idx, p)
    raw_x = cand[:, 0][:, None, :] - q[:, 0][:, :, None]
    raw_z = cand[:, 1][:, None, :] - q[:, 1][:, :, None]
    return dx, dz, d2, nb, raw_x, raw_z


def test_boids_skip_edge_cells_hold_every_edge():
    gz, gx = P.grid_z, P.grid_x
    assert CELLS.shape == (gz + 2, gx + 2, 8, 128)
    core = CELLS[1:-1, 1:-1]
    zi, xi = np.arange(-1, gz + 1) % gz, np.arange(-1, gx + 1) % gx
    assert np.array_equal(CELLS, core[zi][:, xi])  # the ring wraps
    occ = core[:, :, 4] > 0
    n = occ.sum(-1)
    assert (n == 0).any() and (n == 128).any()
    prefix = occ == (np.arange(128) < n[..., None])
    assert (~prefix.all(-1)).any()  # lanes not filled from 0
    assert (occ == (np.arange(128) == 127)).all(-1).any()
    assert (occ == np.isin(np.arange(128), [31, 32])).all(-1).any()
    # Empty lanes: finite garbage in x, z, vx and vz; valid 0, -0 or -1.
    garbage = core[:, :, :4].transpose(0, 1, 3, 2)[~occ]
    assert np.isfinite(garbage).all() and (np.abs(garbage) > 1.0).mean() > 0.9
    valid = core[:, :, 4][~occ]
    assert set(np.unique(valid)) == {-1.0, 0.0}
    assert (np.signbit(valid) & (valid == 0)).any()

    dx, dz, d2, nb, raw_x, raw_z = pairs(CELLS, P)
    r2, sep_r2 = bk.step_constants(P)[2:4]
    # Cell (0, 0): its agent has neighbors, all across the z seam (halo row
    # 0), so the image runs for each.
    cell0 = nb[0].reshape(128, 3, 384)
    assert cell0.any() and not cell0[:, 1:].any()
    assert (raw_z[0][nb[0]].abs() > P.world_z / 2).all()
    # Pairs in range at d2 == r2 exactly, close ones, coincident agents.
    assert (d2[nb] == r2).any() and (d2[nb] < sep_r2).any()
    assert (d2[nb] == 0).any()
    # Pairs in range at |dx| = wx/2 and one float above it, which the image
    # takes across the seam (+128 and -127.99999).
    half = np.float32(P.world_x / 2)
    above = np.nextafter(half, np.float32(P.world_x))
    at_half = raw_x[nb].abs() == half
    assert at_half.any() and (dx[nb][at_half].abs() == half).all()
    sel = raw_x[nb] == float(above)
    assert sel.any()
    assert (dx[nb][sel] == float(above - np.float32(P.world_x))).all()


def test_plain_matches_pallas_at_boids_skip_edges():
    jp = jb.BoidsParams(**BOIDS_SKIP_EDGE)
    want = np.asarray(jb._compiled_accel(jp, True)(jnp.asarray(CELLS)))
    got = bk.boids_accel(torch.tensor(CELLS), P)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    # Every occupied lane steers here; empty ones are 0.
    occ = CELLS[1:-1, 1:-1, 4] > 0
    assert np.array_equal(np.abs(want).max(2) > 0, occ)


def test_plain_image_is_the_oracles_past_half_world():
    """One float above |dx| = wx/2 the image crosses the seam, as the
    float64 oracle's d - w * round(d / w) does. (XLA lowers the Pallas
    body's division by the constant world size to a multiplication by its
    reciprocal, whose quotient rounds to 0.5 there and keeps the image: the
    two differ where w/2 <= r, two cells on an axis, unless w is a power of
    two, as in BOIDS_SKIP_EDGE.)"""
    p = tb.BoidsParams(capacity=8, cell_size=100.0, grid_x=2, grid_z=4)
    core = np.zeros((4, 2, 8, 128), np.float32)
    x = np.nextafter(np.float32(100), np.float32(200))
    core[0, 0, :5, 0] = (0.0, 50.0, 1.0, 0.0, 1.0)
    core[0, 1, :5, 0] = (x, 50.0, -1.0, 0.0, 1.0)
    cells = core[np.arange(-1, 5) % 4][:, np.arange(-1, 3) % 2]
    dx, _, _, nb, raw_x, _ = pairs(np.ascontiguousarray(cells), p)
    oracle = np.float64(x) - 200.0 * np.round(np.float64(x) / 200.0)
    assert float(raw_x[0, 0, 5 * 128]) == x
    assert float(dx[0, 0, 5 * 128]) == np.float32(oracle) < 0
    assert bool(nb[0, 0, 5 * 128])


def test_pallas_keeps_the_image_the_oracle_and_port_cross():
    """The divergence itself, between the JAX package's own functions: at
    the input above (wx = 200, two agents 100.00001 apart in x) the Pallas
    body under the interpreter keeps the image, so the pair lies past r and
    neither agent steers, while the float64 oracle ``reference_accel`` and
    the port's plain version take the image across the seam, where the pair
    is in range. A fix of the reciprocal in JAX or XLA fails this test."""
    jp = jb.BoidsParams(capacity=8, cell_size=100.0, grid_x=2, grid_z=4)
    p = tb.BoidsParams(capacity=8, cell_size=100.0, grid_x=2, grid_z=4)
    x = np.nextafter(np.float32(100), np.float32(200))
    core = np.zeros((4, 2, 8, 128), np.float32)
    core[0, 0, :5, 0] = (0.0, 50.0, 1.0, 0.0, 1.0)
    core[0, 1, :5, 0] = (x, 50.0, -1.0, 0.0, 1.0)
    zi, xi = np.arange(-1, 5) % 4, np.arange(-1, 3) % 2
    cells = np.ascontiguousarray(core[zi][:, xi])
    pallas = np.asarray(jb._compiled_accel(jp, True)(jnp.asarray(cells)))
    assert not pallas.any()  # no neighbor: the image stayed at +100.00001
    pos = np.array([[0.0, 50.0], [x, 50.0]])
    vel = np.array([[1.0, 0.0], [-1.0, 0.0]])
    oracle = jb.reference_accel(jp, pos, vel, np.array([True, True]))
    assert (np.abs(oracle) > 0.1).any(1).all()  # each steers by the other
    port = bk.boids_accel(torch.tensor(cells), p).numpy()
    np.testing.assert_allclose(port[0, :, :, 0], oracle, rtol=1e-5, atol=1e-5)


def test_boids_work_counts_the_pairs_of_occupied_lanes():
    """boids_work's operations against a count in numpy, cell by cell: the
    pairs of an occupied query and another occupied candidate, the axes on
    which they lie more than half the world apart, the neighbors and the
    close ones, and the occupied queries; its bytes are the valid row of
    every cell, 16 B per occupied lane and the output (the five-row count:
    x, z, vx, vz and valid of every cell, and the output)."""
    wx, wz, r2, sep_r2 = (np.float32(v) for v in bk.step_constants(P)[:4])
    n_pairs = images = neighbors = close = queries = 0
    for i in range(P.grid_z):
        for j in range(P.grid_x):
            blk = CELLS[i:i + 3, j:j + 3].transpose(2, 0, 1, 3).reshape(8, -1)
            q = CELLS[i + 1, j + 1]
            q_ok, c_ok = q[4] > 0, blk[4] > 0
            lane = np.arange(128)[:, None]
            other = np.arange(9 * 128)[None, :] != 4 * 128 + lane
            both = q_ok[:, None] & c_ok[None, :] & other
            raw = [blk[f][None, :] - q[f][:, None] for f in (0, 1)]
            d = [r - w * np.round(r / w) for r, w in zip(raw, (wx, wz))]
            d2 = d[0] * d[0] + d[1] * d[1]
            n_pairs += int(both.sum())
            images += sum(int((both & (np.abs(r) > w / 2)).sum())
                          for r, w in zip(raw, (wx, wz)))
            neighbors += int((both & (d2 <= r2)).sum())
            close += int((both & (d2 <= r2) & (d2 < sep_r2)).sum())
            queries += int(q_ok.sum())
    assert images > 0 and close > 0
    want = (OPS_PER_PAIR * n_pairs + OPS_PER_IMAGE * images
            + OPS_PER_NEIGHBOR * neighbors + OPS_PER_CLOSE * close
            + OPS_PER_QUERY * queries)
    n_cells = CELLS.shape[0] * CELLS.shape[1]
    occupied = int((CELLS[:, :, 4] > 0).sum())
    out_bytes = P.grid_z * P.grid_x * 2 * 128 * 4
    assert boids_work(bk, P, torch.tensor(CELLS)) == (
        n_cells * 128 * 4 + occupied * 16 + out_bytes, want)
    assert boids_five_row_bytes(torch.tensor(CELLS)) == (
        5 * n_cells * 128 * 4 + out_bytes)


def test_boids_read_bytes_counts_valid_rows_and_occupied_sectors():
    occupied_sectors = 0
    for cell in CELLS.reshape(-1, 8, 128):
        for s in range(16):
            occupied_sectors += bool((cell[4, 8 * s:8 * s + 8] > 0).any())
    valid_rows = CELLS.shape[0] * CELLS.shape[1] * 512
    assert boids_read_bytes(torch.tensor(CELLS)) == (
        valid_rows + occupied_sectors * 128)
    assert occupied_sectors < CELLS.shape[0] * CELLS.shape[1] * 16
