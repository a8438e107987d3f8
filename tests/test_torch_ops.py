"""The port's neighbor-engine pieces against the JAX package, one by one.

Every input is made with numpy from a seed and fed to the JAX function and
its counterpart in ``goworld_tpu_torch``. Outputs are integers, booleans and
copied f32 features, so every comparison is exact. The JAX event kernel runs
through the Pallas interpreter, as the JAX package's own tests run it.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import lattice_cells
from goworld_tpu.ops import neighbor as jn
from goworld_tpu_torch.ops import event_kernel as ek
from goworld_tpu_torch.ops import neighbor as tn


def t(a):
    return torch.tensor(np.asarray(a))


def same(a, b):
    return np.array_equal(np.asarray(a), np.asarray(b))


def both_params(**fields):
    return jn.NeighborParams(**fields), tn.NeighborParams(**fields)


PARAM_CASES = [
    {},
    dict(capacity=256, cell_size=100.0, grid_x=16, grid_z=16,
         space_slots=4, cell_capacity=64, max_events=16384),
    dict(drain_mode="grouped"),
    dict(drain_mode="scatter"),
    dict(capacity=1864128),  # largest multiple of 8 under the int32 index
    dict(drain_mode="fastest"),
    dict(grid_x=3),
    dict(grid_z=2),
    dict(capacity=100),
    dict(capacity=1864136),
]


@pytest.mark.parametrize("fields", PARAM_CASES)
def test_params_validation_matches_reference(fields):
    try:
        jp, jerr = jn.NeighborParams(**fields), None
    except ValueError as e:
        jp, jerr = None, str(e)
    try:
        tp, terr = tn.NeighborParams(**fields), None
    except ValueError as e:
        tp, terr = None, str(e)
    assert terr == jerr
    if jp is not None:
        assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
        assert tp.num_buckets == jp.num_buckets
        assert tn.params_from_reference(dataclasses.asdict(jp)) == tp


def test_params_from_reference_rejects_unknown_fields():
    fields = dataclasses.asdict(jn.NeighborParams())
    with pytest.raises(ValueError, match="unknown"):
        tn.params_from_reference({**fields, "shards": 4})


def test_bins_match_reference():
    """Negative and exact-multiple coordinates (floor-mod), and space ids
    near ±2^31, whose hash products wrap in int32."""
    jp, tp = both_params(capacity=64, cell_size=100.0, grid_x=16, grid_z=12,
                         space_slots=5)
    rng = np.random.default_rng(0)
    pos = rng.uniform(-5000, 5000, (64, 2)).astype(np.float32)
    pos[:8] = np.array([[-100, 0], [-0.5, 100], [1600, -1200], [0, -1e-3],
                        [-1e4, 1e4], [99.99, -99.99], [-1600, 1200],
                        [300, 300]], np.float32)
    space = rng.integers(-2**31, 2**31, 64, dtype=np.int64).astype(np.int32)
    space[:8] = [0, 1, -1, 2**31 - 1, -2**31, 2**31 - 2, -2**31 + 1, 40503]
    want = jn._bins(jp, jnp.asarray(pos), jnp.asarray(space))
    got = tn._bins(tp, t(pos), t(space))
    oracle = jn.bins_reference(jp, pos, space)
    mirror = tn.bins_reference(tp, pos, space)
    for w, g, o, m in zip(want, got, oracle, mirror):
        assert g.dtype == torch.int32
        assert same(w, g) and same(w, o) and same(w, m)


@pytest.mark.parametrize("fallback,stride", [
    (False, 8), (False, tn.LANES), (True, 4),
])
def test_sorted_ranks_and_build_table_match_reference(fallback, stride):
    """Both sort branches (the fused key*n+iota sort, and the stable argsort
    once (num_buckets+1)*n overflows int32), on a drop window."""
    if fallback:
        fields = dict(capacity=1024, grid_x=512, grid_z=512, space_slots=8,
                      cell_capacity=4)
    else:
        fields = dict(capacity=256, grid_x=8, grid_z=8, space_slots=2,
                      cell_capacity=8)
    jp, tp = both_params(**fields)
    n, nb = jp.capacity, jp.num_buckets
    assert ((nb + 1) * n >= 2**31) == fallback
    rng = np.random.default_rng(1)
    bucket = rng.integers(0, nb, n).astype(np.int32)
    bucket[: n // 4] = rng.integers(0, 3, n // 4)  # overfull cells
    active = rng.random(n) < 0.85
    key = np.where(active, bucket, nb).astype(np.int32)
    for w, g in zip(jn.sorted_ranks(jnp.asarray(key), n, nb),
                    tn.sorted_ranks(t(key), n, nb)):
        assert same(w, g)
    want = jn._build_table(jp, jnp.asarray(bucket), jnp.asarray(active),
                           stride)
    got = tn._build_table(tp, t(bucket), t(active), stride)
    assert int(got[2]) > 0  # the drop window really dropped
    for w, g in zip(want, got):
        assert same(w, g)


def test_scatter_feats_matches_reference():
    jp, tp = both_params(capacity=256, grid_x=4, grid_z=6, space_slots=2,
                         cell_capacity=128)
    rng = np.random.default_rng(2)
    n = jp.capacity
    pos = rng.uniform(0, 600, (n, 2)).astype(np.float32)
    space = rng.integers(0, 3, n).astype(np.int32)
    active = rng.random(n) < 0.9
    cx, cz, sm = tn._bins(tp, t(pos), t(space))
    bucket = (sm * tp.grid_z + cz) * tp.grid_x + cx
    _, slot, _, order, dst = tn._build_table(tp, bucket, t(active), tn.LANES)
    xs = np.where(slot.numpy() >= 0, pos[:, 0], np.nan).astype(np.float32)
    radius = rng.uniform(10, 100, n).astype(np.float32)
    prev = rng.uniform(0, 600, (n, 2)).astype(np.float32)
    prev[::5, 0] = np.nan
    feats_a = (xs, pos[:, 1], space, radius)
    feats_b = (prev[:, 0], prev[:, 1], space[::-1].copy(), radius)
    want = jn._scatter_feats(jp, jnp.asarray(dst.numpy()),
                             jnp.asarray(order.numpy()),
                             tuple(map(jnp.asarray, feats_a)),
                             tuple(map(jnp.asarray, feats_b)))
    got = tn._scatter_feats(tp, dst, order, tuple(map(t, feats_a)),
                            tuple(map(t, feats_b)))
    assert got.shape == (2, 8, 6, 8, tn.LANES) and got.is_contiguous()
    assert np.array_equal(np.asarray(want), got.numpy(), equal_nan=True)
    assert np.isnan(got.numpy()).any()


def boundary_pairs(cells):
    """Count of query/candidate pairs at exactly d2 == r2 in epoch A."""
    s, r2, c2 = cells.shape[:3]
    count = 0
    for i in range(r2 - 2):
        for j in range(c2 - 2):
            blk = cells[:, i:i + 3, j:j + 3]  # [S, 3, 3, F, L]
            cand = blk.transpose(0, 3, 1, 2, 4).reshape(s, 8, -1)
            q = blk[:, 1, 1]
            d2 = ((cand[:, 0, None, :] - q[:, 0, :, None]) ** 2
                  + (cand[:, 1, None, :] - q[:, 1, :, None]) ** 2)
            count += int(np.sum(d2 == (q[:, 3] ** 2)[:, :, None]))
    return count


@pytest.mark.parametrize("dual,rows", [(False, None), (True, None),
                                       (True, 2)])
def test_event_kernel_plain_matches_pallas_interpret(dual, rows):
    """Bit-identical words from the port's plain version (through the
    wrapper, as a CPU tensor gets it) and the Pallas kernel under the
    interpreter; rows=2 is the row-slab geometry of the sharded engine."""
    jp = jn.NeighborParams(capacity=128, grid_x=4, grid_z=4, space_slots=2,
                           cell_capacity=64)
    cells = lattice_cells(2, 4, 4, seed=3)
    if rows is not None:
        cells = np.ascontiguousarray(cells[:, :rows + 2])
    assert boundary_pairs(cells) > 100
    want = np.asarray(
        jn._compiled_event_kernel(jp, True, rows=rows, dual=dual)(
            jnp.asarray(cells))
    )
    before = dict(ek.launches)
    got = ek.event_mask(t(cells), dual)
    assert ek.launches == before  # the plain version launches nothing
    assert got.shape == want.shape and got.dtype == torch.int32
    assert np.array_equal(want, got.numpy())
    assert want.any() and (want < 2**16).all()
    if dual:  # the enter half is the single form on the same cells
        assert np.array_equal(got.numpy()[..., :72],
                              ek.event_mask(t(cells), False).numpy())


def test_event_kernel_skip_flag():
    cells = t(lattice_cells(1, 4, 4, seed=4))
    got = ek.event_mask(cells, False, skip=torch.tensor(False))
    assert torch.equal(got, ek.event_mask_reference(cells, False))
    assert ek.event_mask(cells, True, skip=torch.tensor(True)).shape == (
        1, 4, 4, tn.LANES, 144)


def _fma_boundary_case():
    """(dx, dz) whose d2 = dx*dx + dz*dz, rounded op by op in f32, equals
    r2 = 100*100 exactly, while a fused dx*dx + (dz*dz) rounds above it."""
    r2 = np.float32(10000.0)
    dx = np.linspace(60.0, 80.0, 20001).astype(np.float32)
    dz = np.sqrt(r2 - dx * dx).astype(np.float32)
    for ulps in range(-3, 4):
        z = (dz.view(np.int32) + ulps).view(np.float32)
        d2 = dx * dx + z * z
        fused = (dx.astype(np.float64) ** 2
                 + (z * z).astype(np.float64)).astype(np.float32)
        hit = np.nonzero((d2 == r2) & (fused > r2))[0]
        if len(hit):
            return dx[hit[0]], z[hit[0]]
    raise AssertionError("no boundary case found")


def test_pair_predicate_rounds_each_operation():
    """At d2 == r2 the port follows IEEE rounding op by op, as the numpy
    brute-force oracle does; an FMA (XLA:CPU contracts this expression
    under jit) would put the pair outside the radius."""
    dx, dz = _fma_boundary_case()
    cells = np.full((1, 6, 6, 8, tn.LANES), np.nan, np.float32)
    centre = cells[0, 2, 2]
    centre[:, 0] = [0.0, 0.0, 0.0, 100.0] * 2  # query, both epochs
    centre[:4, 1] = [dx, dz, 0.0, 100.0]  # candidate in epoch A only
    got = ek.event_mask(t(cells), True).numpy()[0, 1, 1, 0]
    c = 4 * tn.LANES + 1  # the candidate's index in the 3x3 block
    assert got[c // 16] == 1 << (c % 16)  # an enter event
    assert not got[72:].any()
    # Both engines see the pair, as the oracle does.
    p = tn.NeighborParams(capacity=8, grid_x=4, grid_z=4, space_slots=1,
                          cell_capacity=8)
    pos = np.zeros((8, 2), np.float32)
    pos[1] = (dx, dz)
    active = np.arange(8) < 2
    space = np.zeros(8, np.int32)
    radius = np.full(8, 100.0, np.float32)
    for backend in ("reference", "kernel"):
        eng = tn.NeighborEngine(p, backend=backend, device="cpu")
        eng.reset()
        enters, _, _ = eng.step(pos, active, space, radius)
        assert sorted(map(tuple, enters.tolist())) == [(0, 1), (1, 0)]


def random_packed(n_rows, seed, density=0.03):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2**16, (n_rows, 72)).astype(np.int32)
    keep = rng.random((n_rows, 72)) < density
    keep[::7] = False  # rows without events
    return np.where(keep, words, 0).astype(np.int32)


@pytest.mark.parametrize("mode", ["bsearch", "grouped", "scatter"])
def test_drain_bits_matches_reference(mode):
    jp, tp = both_params(capacity=64, grid_x=4, grid_z=4, space_slots=2,
                         cell_capacity=64, max_events=48, drain_mode=mode)
    rng = np.random.default_rng(5)
    packed = random_packed(64, seed=6)
    cx = rng.integers(0, 4, 64).astype(np.int32)
    cz = rng.integers(0, 4, 64).astype(np.int32)
    sm = rng.integers(0, 2, 64).astype(np.int32)
    table = rng.integers(0, 65, jp.num_buckets * tn.LANES).astype(np.int32)
    total = int(sum(bin(int(w)).count("1") for w in packed.ravel()))
    assert total > 3 * jp.max_events
    for start in (0, 37, total - 10):
        want = jn._drain_bits(jp, jnp.asarray(packed), jnp.asarray(cx),
                              jnp.asarray(cz), jnp.asarray(sm),
                              jnp.asarray(table), jnp.int32(start))
        got = tn._drain_bits(tp, t(packed), t(cx), t(cz), t(sm), t(table),
                             start)
        assert same(want[0], got[0]), start
        assert int(want[1]) == int(got[1]) == total


def test_popcount16_is_exact():
    x = np.arange(2**16, dtype=np.int32)
    want = np.array([bin(v).count("1") for v in range(2**16)])
    assert same(tn._popcount16(t(x)), want)


def test_drain_ids_matches_reference():
    rng = np.random.default_rng(7)
    n = 50
    ids = np.where(rng.random((40, 36)) < 0.05,
                   rng.integers(0, n, (40, 36)), n).astype(np.int32)
    total = int((ids < n).sum())
    for start in (0, 100, 40 * 36 - 60):
        want = jn._drain_ids(jnp.asarray(ids), n, 32, jnp.int32(start))
        got = tn._drain_ids(t(ids), n, 32, start)
        assert same(want[0], got[0]) and same(want[1], got[1])
    assert total > 32
