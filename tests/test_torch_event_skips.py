"""The event kernel's plain versions at inputs laid out to test a kernel
that skips empty query lanes and empty 32-lane candidate chunks, against the
JAX Pallas kernel under the interpreter, on the CPU; and the operation count
behind the kernel's bound.

``chip_smoke.skip_edge_cells`` makes the inputs: lanes occupied at random
and as a prefix, a query warp whose only lane is 31, a cell whose only lane
is 127, lanes present in one epoch only, empty and full cells, one space
id in slot 0 and three in slot 1. The CUDA
kernel is held against the same plain versions on these inputs in
``tests/test_torch_port.py`` and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import (
    LATTICE_CAPACITY, OPS_PER_PAIR_EPOCH, event_ops, lattice_cells,
    lattice_plane, skip_edge_cells,
)
from goworld_tpu.ops import neighbor as jn
from goworld_tpu_torch.ops import event_kernel as ek
from test_torch_spatial import pallas_store  # noqa: F401  (a fixture)

SLOTS, ROWS, COLS = 2, 4, 4
JP = jn.NeighborParams(capacity=LATTICE_CAPACITY, grid_x=COLS, grid_z=ROWS,
                       space_slots=SLOTS, cell_capacity=64)
CELLS = skip_edge_cells(SLOTS, ROWS, COLS, seed=5)
PLANE = lattice_plane(CELLS, seed=2, either_epoch=True)


def t(a):
    return torch.tensor(np.asarray(a))


def lanes(cells):
    """Per core cell and lane: (x_A set, x_B set)."""
    core = cells[:, 1:-1, 1:-1]
    return ~np.isnan(core[..., 0, :]), ~np.isnan(core[..., 4, :])


def test_skip_edge_cells_hold_every_edge():
    has_a, has_b = lanes(CELLS)
    occ = (has_a | has_b).reshape(-1, 128)
    n = occ.sum(1)
    prefix = occ == (np.arange(128) < n[:, None])
    assert (n == 0).any() and (n == 128).any()
    assert (~prefix.all(1)).any()  # occupied at random, not from lane 0
    assert (prefix.all(1) & (n >= 40) & (n <= 64)).any()  # engine density
    # A query warp whose only lane is 31; a cell whose only lane is 127,
    # the only candidate of its chunk.
    assert (occ[:, :32] == (np.arange(32) == 31)).all(1).any()
    assert (occ == (np.arange(128) == 127)).all(1).any()
    assert (has_b & ~has_a).any() and (has_a & ~has_b).any()
    # One space id in slot 0, three in slot 1.
    spaces = CELLS[:, :, :, [2, 6]]
    assert set(np.unique(spaces[0][~np.isnan(spaces[0])])) == {0.0}
    assert set(np.unique(spaces[1][~np.isnan(spaces[1])])) == {0.0, 1.0, 2.0}


@pytest.mark.parametrize("dual", [False, True])
def test_plain_mask_matches_pallas_at_skip_edges(dual):
    want = np.asarray(
        jn._compiled_event_kernel(JP, True, dual=dual)(jnp.asarray(CELLS)))
    got = ek.event_mask(t(CELLS), dual)
    assert np.array_equal(want, got.numpy())
    # An occupied lane of one epoch only has real bits: enters from a lane
    # set only in A, and leaves from a lane set only in B.
    has_a, has_b = lanes(CELLS)
    rows = want.reshape(has_a.shape + (-1,))
    assert rows[has_a & ~has_b][:, :72].any()
    if dual:
        assert rows[has_b & ~has_a][:, 72:].any()


@pytest.mark.parametrize("dual", [False, True])
@pytest.mark.parametrize("drain", [1 << 16, 50])  # 50: both regions overflow
def test_plain_drain_matches_pallas_at_skip_edges(pallas_store, dual, drain):
    kernel = jn._compiled_event_kernel(JP, True, dual=dual,
                                       drain_inline=drain)
    want_words, want_pairs = kernel(jnp.asarray(CELLS), jnp.asarray(PLANE))
    got_words, got_pairs = ek.event_drain(t(CELLS), t(PLANE), dual, drain,
                                          JP.capacity)
    assert np.array_equal(np.asarray(want_words), got_words.numpy())
    cap = drain * (2 if dual else 1)
    assert np.array_equal(np.asarray(want_pairs)[:, :cap],
                          got_pairs[:, :cap].numpy())
    filled = (got_pairs[0, :cap] < JP.capacity).reshape(-1, drain).sum(1)
    assert ((filled == drain) == (drain == 50)).all()


@pytest.mark.parametrize("make", [lattice_cells, skip_edge_cells])
def test_event_ops_counts_pairs_with_both_x_set(make):
    """event_ops against a brute count of the (query, candidate, epoch)
    triples of each cell whose x is set on both sides."""
    cells = make(2, 3, 4, seed=7)
    rows, cols = cells.shape[1] - 2, cells.shape[2] - 2
    pairs = 0
    for s in range(cells.shape[0]):
        for i in range(rows):
            for j in range(cols):
                blk = cells[s, i:i + 3, j:j + 3]  # [3, 3, F, 128]
                for fx in (0, 4):
                    q = ~np.isnan(blk[1, 1, fx])
                    c = ~np.isnan(blk[:, :, fx]).reshape(-1)
                    pairs += int((q[:, None] & c[None, :]).sum())
    assert pairs > 0
    assert event_ops(ek, t(cells)) == pairs * OPS_PER_PAIR_EPOCH
