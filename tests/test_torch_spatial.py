"""The port's strip+halo tier against the JAX package, on the CPU.

The event kernel's drain form (its plain version here) is held against the
JAX ``_compiled_event_kernel(..., drain_inline=D)`` under the Pallas
interpreter, on slabs built by the JAX strip tier's own scatters; the strip
pieces are held bit for bit against their JAX counterparts; and the port's
``SpatialShardedNeighborEngine`` (8 strips on the CPU) is held tick by tick
against the JAX strip engine (``backend="pallas_interpret"``) and the JAX
single-device engine (``backend="jnp"``) on the traces of
``tests/test_spatial_pallas.py``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas

from goworld_tpu.ops import neighbor as jn
from goworld_tpu.parallel import make_mesh as jax_make_mesh
from goworld_tpu.parallel import spatial as js
from goworld_tpu_torch.ops import event_kernel as ek
from goworld_tpu_torch.ops import neighbor as tn
from goworld_tpu_torch.parallel import make_mesh
from goworld_tpu_torch.parallel import spatial as ts
from test_spatial_pallas import (
    N, PARAMS, STRIP_COLS, WORLD_X, WORLD_Z, _StubDev, make_world, to_sets,
)

T_PARAMS = tn.params_from_reference(dataclasses.asdict(PARAMS))
STORM = dataclasses.replace(PARAMS, max_events=128)


@pytest.fixture
def pallas_store(monkeypatch):
    """The JAX drain form stores its pairs with ``pl.store``, which
    jax 0.9.0 removed from ``jax.experimental.pallas``; without it the
    reference raises AttributeError even under ``interpret=True``. This
    puts back the plain ref store it stood for, for this test only; the
    JAX package is unchanged."""
    monkeypatch.setattr(
        pallas, "store",
        lambda ref, idx, val: ref.__setitem__(idx, val), raising=False)
    yield
    # Programs traced under the shim must not outlive it: the JAX strip
    # tests share these caches and run without it.
    jn._compiled_event_kernel.cache_clear()
    js._jitted_spatial_step_pallas.cache_clear()


def t(a):
    return torch.tensor(np.asarray(a))


def same(a, b):
    return np.array_equal(np.asarray(a), np.asarray(b))


# --- a strip slab, built by the JAX strip tier ------------------------------

SLAB = dict(capacity=512, cell_size=100.0, grid_x=16, grid_z=4,
            space_slots=2, cell_capacity=64, max_events=4096)
SLAB_COLS = 4  # kernel grid columns; the slab is SLAB_COLS + 2 wide


def slab_world(seed, n_rows=384, chunk=300):
    """Combined own+ghost rows of one strip slab: both epochs' features,
    strip-local buckets (some rows outside the slab in one epoch), unique
    slot ids, and a pile past the cell capacity."""
    jp = jn.NeighborParams(**SLAB)
    gxe = SLAB_COLS + 2
    rng = np.random.default_rng(seed)
    pos = np.stack([rng.uniform(-50, gxe * 100 + 50, n_rows),
                    rng.uniform(0, jp.grid_z * 100, n_rows)], 1)
    pos[:80] = (250.0, 150.0)  # 80 rows in one cell: a capacity drop
    ppos = pos + rng.normal(0, 15, pos.shape)
    pos, ppos = pos.astype(np.float32), ppos.astype(np.float32)
    space = rng.integers(0, 2, n_rows).astype(np.int32)
    space[:80] = 0
    pspace = np.where(rng.random(n_rows) < 0.05, 1 - space, space)
    act = rng.random(n_rows) < 0.9
    pact = rng.random(n_rows) < 0.9
    rad = rng.choice(np.float32([40, 70, 100]), n_rows)
    prad = rad.copy()
    slots = rng.permutation(jp.capacity)[:n_rows].astype(np.int32)

    def buckets(xz, spc):
        # z wraps on the torus (floor-mod, as _bins); x is slab-local.
        lx = np.floor(xz[:, 0] / 100).astype(np.int32)
        cz = np.floor(xz[:, 1] / 100).astype(np.int32) % jp.grid_z
        inside = (lx >= 0) & (lx < gxe)
        nb = jp.space_slots * jp.grid_z * gxe
        return np.where(inside, (spc * jp.grid_z + cz) * gxe + lx, nb), inside

    buc_c, in_c = buckets(pos, space)
    buc_p, in_p = buckets(ppos, pspace)
    return dict(jp=jp, gxe=gxe, chunk=chunk, slots=slots,
                cur=(pos, act & in_c, space, rad, buc_c),
                prev=(ppos, pact & in_p, pspace, prad, buc_p))


def jax_slab(w, epoch):
    """JAX strip table, cell slab and slot/own plane of one epoch."""
    jp, gxe, chunk = w["jp"], w["gxe"], w["chunk"]
    nb = jp.space_slots * jp.grid_z * gxe
    pos, act, spc, rad, buc = w[epoch]
    other = w["prev" if epoch == "cur" else "cur"]
    table, tpos, drop, order, dst = js._build_table_strip(
        jp, jnp.asarray(buc), jnp.asarray(act), jnp.asarray(w["slots"]), nb,
        chunk)
    o_table, o_tpos = js._build_table_strip(
        jp, jnp.asarray(other[4]), jnp.asarray(other[1]),
        jnp.asarray(w["slots"]), nb, chunk)[:2]
    xs = jnp.where(tpos >= 0, pos[:, 0], jnp.nan)
    o_xs = jnp.where(o_tpos >= 0, other[0][:, 0], jnp.nan)
    feats = (xs, pos[:, 1], spc, rad)
    o_feats = (o_xs, other[0][:, 1], other[2], other[3])
    cells = jn._scatter_feats(jp, dst, order, feats, o_feats, gx_ext=gxe)
    plane = js._scatter_slotown(jp, dst, order, jnp.asarray(w["slots"]),
                                chunk, gxe)
    return (table, tpos, drop, order, dst), cells, plane


@pytest.mark.parametrize("dual", [False, True])
@pytest.mark.parametrize("drain", [4096, 40])  # 40: both regions overflow
def test_plain_drain_matches_pallas_drain_form(pallas_store, dual, drain):
    w = slab_world(seed=5)
    jp = w["jp"]
    _, cells, plane = jax_slab(w, "cur")
    kernel = jn._compiled_event_kernel(
        jp, True, rows=jp.grid_z, cols=SLAB_COLS, dual=dual,
        drain_inline=drain)
    want_words, want_pairs = kernel(cells, plane)
    got_words, got_pairs = ek.event_drain(t(cells), t(plane), dual, drain,
                                          jp.capacity)
    assert got_words.dtype == torch.int32
    assert same(want_words, got_words)
    cap = drain * (2 if dual else 1)
    assert got_pairs.shape == (2, cap + 1)
    assert same(np.asarray(want_pairs)[:, :cap], got_pairs[:, :cap])
    # The regions' fill tells the overflow case from the other.
    own = np.asarray(plane)[:, 1:-1, 1:-1, 1] > 0
    words = np.asarray(want_words)
    for r in range(2 if dual else 1):
        bits = np.unpackbits(
            words[..., r * 72:(r + 1) * 72].astype("<u2").view(np.uint8),
            axis=-1)
        events = int(bits.reshape(own.shape + (-1,)).sum(-1)[own].sum())
        filled = int((got_pairs[0, r * drain:(r + 1) * drain]
                      < jp.capacity).sum())
        assert filled == min(events, drain)
        assert (events > drain) == (drain == 40)


def test_plain_drain_honours_skip():
    w = slab_world(seed=5)
    _, cells, plane = jax_slab(w, "cur")
    skip = torch.ones((), dtype=torch.bool)
    words, pairs = ek.event_drain(t(cells), t(plane), False, 64, 512,
                                  skip=skip)
    assert words.shape == (2, 4, SLAB_COLS, 128, 72)
    assert pairs.shape == (2, 65)


@pytest.mark.parametrize("epoch", ["cur", "prev"])
def test_strip_tables_and_slabs_match_reference(epoch):
    w = slab_world(seed=9)
    jp, gxe, chunk = w["jp"], w["gxe"], w["chunk"]
    tp = tn.params_from_reference(dataclasses.asdict(jp))
    nb = jp.space_slots * jp.grid_z * gxe
    (want_tab, want_cells, want_plane) = jax_slab(w, epoch)
    pos, act, spc, rad, buc = w[epoch]
    got_tab = ts._build_table_strip(tp, t(buc), t(act), t(w["slots"]), nb,
                                    chunk)
    assert int(got_tab[2]) > 0  # the pile really dropped own rows
    for want, got in zip(want_tab, got_tab):
        assert same(want, got)
    table, tpos, _, order, dst = got_tab
    other = w["prev" if epoch == "cur" else "cur"]
    o_tpos = ts._build_table_strip(tp, t(other[4]), t(other[1]),
                                   t(w["slots"]), nb, chunk)[1]
    nan = float("nan")
    feats = (torch.where(tpos >= 0, t(pos[:, 0]), nan), t(pos[:, 1]),
             t(spc), t(rad))
    o_feats = (torch.where(o_tpos >= 0, t(other[0][:, 0]), nan),
               t(other[0][:, 1]), t(other[2]), t(other[3]))
    cells = tn._scatter_feats(tp, dst, order, feats, o_feats, gx_ext=gxe)
    assert cells.shape == (2, jp.grid_z + 2, gxe, 8, 128)
    np.testing.assert_array_equal(np.asarray(want_cells), cells.numpy())
    plane = ts._scatter_slotown(tp, dst, order, t(w["slots"]), chunk, gxe)
    assert same(want_plane, plane)


def test_sorted_ranks_by_matches_reference():
    rng = np.random.default_rng(2)
    n = 700
    key = rng.integers(0, 40, n).astype(np.int32)
    key[rng.random(n) < 0.2] = 40  # inactive rows
    tie = rng.permutation(4 * n)[:n].astype(np.int32)
    want = jn.sorted_ranks_by(jnp.asarray(key), jnp.asarray(tie), n)
    got = tn.sorted_ranks_by(t(key), t(tie), n)
    for w, g in zip(want, got):
        assert same(w, g)


@pytest.mark.parametrize("mode", ["bsearch", "grouped", "scatter"])
def test_strip_drain_bits_match_reference(mode):
    """The strip-local pager (``gx_ext``, ``wrap_x=False``) from a start
    rank inside the events and past them."""
    jp = jn.NeighborParams(**{**SLAB, "drain_mode": mode})
    tp = tn.params_from_reference(dataclasses.asdict(jp))
    gxe = SLAB_COLS + 2
    rng = np.random.default_rng(4)
    rows = 300
    packed = np.where(rng.random((rows, 72)) < 0.05,
                      rng.integers(1, 1 << 16, (rows, 72)), 0)
    packed = packed.astype(np.int32)
    lx = rng.integers(1, gxe - 1, rows).astype(np.int32)
    cz = rng.integers(0, jp.grid_z, rows).astype(np.int32)
    sm = rng.integers(0, jp.space_slots, rows).astype(np.int32)
    table = rng.integers(0, jp.capacity + 1,
                         jp.space_slots * jp.grid_z * gxe * 128)
    table = table.astype(np.int32)
    total = int(sum(bin(v).count("1") for v in packed.ravel()))
    for start in (0, 500, total - 3, total + 10):
        want = jn._drain_bits(jp, jnp.asarray(packed), jnp.asarray(lx),
                              jnp.asarray(cz), jnp.asarray(sm),
                              jnp.asarray(table), jnp.int32(start),
                              max_events=256, gx_ext=gxe, wrap_x=False)
        got = tn._drain_bits(tp, t(packed), t(lx), t(cz), t(sm), t(table),
                             start, max_events=256, gx_ext=gxe, wrap_x=False)
        assert same(want[0], got[0]) and int(want[1]) == int(got[1]) == total


# --- the host planner ---------------------------------------------------------


def test_plan_strips_matches_reference_and_caps():
    gx = 64
    skew = np.full(gx, 1)
    skew[:8] = 100
    for max_cols in (None, 12, 8):
        assert same(js.plan_strips(skew, 8, max_cols=max_cols),
                    ts.plan_strips(skew, 8, max_cols=max_cols))
    capped = ts.plan_strips(skew, 8, max_cols=12)
    assert capped[0] == 0 and capped[-1] == gx
    assert (np.diff(capped) >= 4).all() and (np.diff(capped) <= 12).all()
    assert np.diff(ts.plan_strips(skew, 8)).max() > 12
    for args in ((skew, 8, 4, 7), (np.ones(20), 8)):
        with pytest.raises(ValueError) as want:
            js.plan_strips(*args)
        with pytest.raises(ValueError) as got:
            ts.plan_strips(*args)
        assert str(got.value) == str(want.value)


def test_plan_placement_matches_reference():
    class Bare:
        pass

    cases = [
        [_StubDev((x, y, 0)) for y in range(2) for x in range(4)],
        [_StubDev((x, 0, 0)) for x in range(4)],
        [_StubDev((x, y, z), core) for z in range(2) for y in range(2)
         for x in range(2) for core in range(2)],
        [Bare(), Bare()],
        [torch.device("cpu")] * 8,
    ]
    for devs in cases:
        order = ts.plan_placement(devs)
        assert same(js.plan_placement(devs), order)
        coords = [getattr(d, "coords", None) for d in devs]
        if all(c is not None for c in coords):
            assert (ts.ring_link_distance(coords, order)
                    == js.ring_link_distance(coords, order))
    snake = ts.plan_placement(cases[0])
    coords = [d.coords for d in cases[0]]
    assert (ts.ring_link_distance(coords, snake)
            < ts.ring_link_distance(coords, np.arange(8)))
    mesh = make_mesh(8, "cpu")
    eng = ts.SpatialShardedNeighborEngine(T_PARAMS, mesh)
    assert eng.mesh == mesh  # coord-less devices keep ring order


def test_make_mesh():
    assert make_mesh(3, "cpu") == [torch.device("cpu")] * 3
    spread = make_mesh(8, ["cpu", "meta"])
    assert spread == [torch.device("cpu")] * 4 + [torch.device("meta")] * 4
    with pytest.raises(ValueError):
        make_mesh(0, "cpu")


# --- the engine, tick by tick ------------------------------------------------


def drift(rng, pos, sigma):
    pos = pos + rng.normal(0, sigma, pos.shape).astype(np.float32)
    np.clip(pos[:, 0], 0, WORLD_X, out=pos[:, 0])
    np.clip(pos[:, 1], 1.0, WORLD_Z - 1.0, out=pos[:, 1])
    return pos.astype(np.float32)


def churn_trace():
    """Random walk with spawn/despawn flips and a 70-row pile in one seam
    cell (capacity 64), re-planned every 3 dispatches."""
    rng, pos, active, space, radius = make_world(400, seed=7)
    pos[:70] = (805.0, 405.0)
    space[:70] = 0
    for _ in range(5):
        yield pos, active, space, radius
        pos = drift(rng, pos, 20)
        active = active.copy()
        active[rng.integers(0, N, 12)] ^= True


def teleport_trace():
    rng, pos, active, space, radius = make_world(400, seed=3)
    for tick in range(4):
        yield pos, active, space, radius
        if tick == 1:
            pos = rng.uniform(0, WORLD_X, (N, 2)).astype(np.float32)
            pos[:, 1] %= WORLD_Z
        else:
            pos = np.clip(pos + rng.normal(0, 5, pos.shape), 0,
                          WORLD_X).astype(np.float32)
            pos[:, 1] %= WORLD_Z


def storm_trace():
    rng, pos, active, space, radius = make_world(400, seed=11)
    for _ in range(3):
        yield pos, active, space, radius
        pos = drift(rng, pos, 30)


def on_off_trace():
    rng, pos, active, space, radius = make_world(400, seed=23)
    for _ in range(4):
        yield pos, active, space, radius
        pos = drift(rng, pos, 20)
        active = active.copy()
        active[rng.integers(0, N, 12)] ^= True


def fast_trace():
    """Seam-free steady ticks: radius 40, ~3-unit drift keeps the guard."""
    rng, pos, active, space, radius = make_world(400, seed=11)
    radius = np.full(N, 40.0, np.float32)
    for _ in range(4):
        yield pos, active, space, radius
        pos = drift(rng, pos, 3)


TRACES = {
    "churn": (churn_trace, PARAMS, dict(replan_interval=3), {}),
    "teleport": (teleport_trace, PARAMS, {}, {}),
    "storm": (storm_trace, STORM, {}, {}),
    "drain_on_off": (on_off_trace, PARAMS, {}, dict(inkernel_drain=False)),
    "fast": (fast_trace, PARAMS, {}, {}),
}


@pytest.mark.parametrize("name", list(TRACES))
def test_strip_engine_matches_reference_engines(pallas_store, name):
    """Each tick: the same enter and leave sets with every pair once, the
    same ``dropped`` and mode, against the JAX strip engine (in-kernel
    drain on) and the single-device engine; the same migration, fallback
    and fast-tick totals as the JAX strip engine. "drain_on_off" adds a
    port engine with the drain off, the same events again."""
    trace, params, kw, extra = TRACES[name]
    single = jn.NeighborEngine(params, backend="jnp")
    ref = js.SpatialShardedNeighborEngine(
        params, jax_make_mesh(8), backend="pallas_interpret",
        strip_cols=STRIP_COLS, prewarm_fallback=False, **kw)
    tp = tn.params_from_reference(dataclasses.asdict(params))
    ports = [ts.SpatialShardedNeighborEngine(
        tp, make_mesh(8, "cpu"), strip_cols=STRIP_COLS, **kw)]
    if extra:
        ports.append(ts.SpatialShardedNeighborEngine(
            tp, make_mesh(8, "cpu"), strip_cols=STRIP_COLS, **kw, **extra))
    assert ports[0].drain_inline == ports[0].events_inline == ref.drain_inline
    for e in [single, ref] + ports:
        e.reset()
    modes, fasts, storms, drops = [], [], 0, 0
    for tick, world in enumerate(trace()):
        want = single.step(*world)
        storms += len(want[0]) > params.max_events
        drops += want[2] > 0
        ref_out = ref.step(*world)
        for eng in ports:
            pend = eng.step_async(*world)
            assert pend.full_repage == (eng.drain_inline > 0
                                        and eng.last_mode == "spatial")
            got = pend.collect()
            for k in (0, 1):
                for other in (want, ref_out):
                    assert to_sets(got[k]) == to_sets(other[k]), (tick, k)
                    assert len(got[k]) == len(other[k]), (tick, k)
            assert got[2] == want[2] == ref_out[2]
            assert eng.last_mode == ref.last_mode
            assert eng.last_fast_tick == ref.last_fast_tick
        modes.append(ref.last_mode)
        fasts.append(ref.last_fast_tick)
    for eng in ports:
        assert eng.total_migrations == ref.total_migrations
        assert eng.total_fallbacks == ref.total_fallbacks
        assert eng.total_fast_ticks == ref.total_fast_ticks
        assert same(eng.shard_population, ref.shard_population)
        assert same(eng.boundaries, ref.boundaries)
    # Each trace exercises what it is named for.
    if name == "churn":
        assert ref.total_migrations > 0 and drops >= 1
    if name == "teleport":
        assert "fallback:teleport" in modes
        assert modes[-1] == "spatial"
    if name == "storm":
        assert storms >= 1
    if name == "fast":
        assert all(fasts)  # the storm from reset deactivates no one
    if name != "teleport":
        assert set(modes) == {"spatial"}


def test_strip_engine_tracks_drops_and_carried_epoch():
    """The seam pile's capacity drops reach ``dropped``; the carried epoch
    is the last dispatched world in slot space."""
    tp = T_PARAMS
    eng = ts.SpatialShardedNeighborEngine(tp, make_mesh(8, "cpu"),
                                          strip_cols=STRIP_COLS)
    eng.reset()
    world = next(churn_trace())
    _, _, dropped = eng.step(*world)
    assert dropped == 6 and eng.last_grid_dropped == 6
    for got, want in zip(eng.carried_epoch(), world):
        assert same(got, want)


def test_constructor_validation():
    mesh = make_mesh(8, "cpu")
    with pytest.raises(ValueError, match="cell_capacity"):
        ts.SpatialShardedNeighborEngine(
            tn.NeighborParams(capacity=512, grid_x=64, grid_z=8,
                              cell_capacity=129), mesh)
    with pytest.raises(ValueError, match="strip_cols"):
        ts.SpatialShardedNeighborEngine(T_PARAMS, mesh, strip_cols=4)
    with pytest.raises(ValueError, match="ghost columns"):
        ts.SpatialShardedNeighborEngine(T_PARAMS, mesh, strip_cols=61)
    with pytest.raises(ValueError, match=">= 2 strips"):
        ts.SpatialShardedNeighborEngine(T_PARAMS, mesh[:1])
    with pytest.raises(ValueError, match="backend"):
        ts.SpatialShardedNeighborEngine(T_PARAMS, mesh, backend="jnp")
    with pytest.raises(ValueError, match="multiple of 8"):
        ts.SpatialShardedNeighborEngine(
            dataclasses.replace(T_PARAMS, capacity=1000), mesh)
    with pytest.raises(ValueError, match="divisible"):
        ts.SpatialShardedNeighborEngine(
            dataclasses.replace(T_PARAMS, max_events=8190), mesh)
    with pytest.raises(ValueError, match="grid_x"):
        ts.SpatialShardedNeighborEngine(
            dataclasses.replace(T_PARAMS, grid_x=16), mesh)
    with pytest.raises(RuntimeError, match="reset"):
        ts.SpatialShardedNeighborEngine(T_PARAMS, mesh).step_async(
            *next(churn_trace()))
