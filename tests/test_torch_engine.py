"""The port's NeighborEngine against the JAX NeighborEngine, tick by tick.

The reference backend is held against ``backend="jnp"`` and the kernel
backend (on the CPU: the event kernel's plain version) against
``backend="pallas_interpret"``. Each tick's enter and leave arrays must be
identical in order, and ``dropped`` identical; the incremental interest sets
are also held against the brute-force oracle of ``test_neighbor``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goworld_tpu.ops import neighbor as jn
from goworld_tpu_torch.ops import event_kernel as ek
from goworld_tpu_torch.ops import neighbor as tn
from test_neighbor import (
    PALLAS_PARAMS, PARAMS, _visible_mask, apply_events, brute_force_sets,
    make_world,
)

RESET = "reset"
PIPELINE = "pipeline"  # dispatch the next tick before collecting this one

PAGING = dataclasses.replace(PARAMS, max_events=64)
DROPS = jn.NeighborParams(capacity=64, cell_size=100.0, grid_x=8, grid_z=8,
                          space_slots=2, cell_capacity=8, max_events=16384)
KERNEL_DROPS = jn.NeighborParams(capacity=64, cell_size=100.0, grid_x=4,
                                 grid_z=4, space_slots=2, cell_capacity=8,
                                 max_events=8192)
KERNEL_PAGING = dataclasses.replace(PALLAS_PARAMS, max_events=64)


def tick(pos, active, space, radius, dirty=True):
    return (pos.copy(), active.copy(), space.copy(), radius.copy(), dirty)


def random_walk():
    rng = np.random.default_rng(1)
    pos, active, space, radius = make_world(256, 180, seed=1)
    for _ in range(5):
        pos = np.clip(pos + rng.normal(0, 15, pos.shape), 0, 1500)
        yield tick(pos.astype(np.float32), active, space, radius)


def teleports():
    rng = np.random.default_rng(7)
    pos, active, space, radius = make_world(256, 200, seed=7, world=1500.0)
    for _ in range(3):
        pos = rng.uniform(0, 1500, pos.shape).astype(np.float32)
        yield tick(pos, active, space, radius)


def isolation_radius_wrap():
    """Space isolation (everyone on one point), asymmetric radius,
    wraparound aliases and negative coordinates, one tick each."""
    n = 256
    pos = np.zeros((n, 2), np.float32)
    yield tick(pos, np.ones(n, bool), (np.arange(n) % 4).astype(np.int32),
               np.full(n, 50.0, np.float32))
    active = np.arange(n) < 2
    pos[1] = (70.0, 0.0)
    radius = np.full(n, 100.0, np.float32)
    radius[1] = 30.0
    yield tick(pos, active, np.zeros(n, np.int32), radius)
    pos[0] = (50.0, 50.0)
    pos[1] = (1650.0, 50.0)  # one grid period away
    yield tick(pos, active, np.zeros(n, np.int32), np.full(n, 100.0,
                                                           np.float32))
    pos, active, space, radius = make_world(256, 150, seed=3)
    yield tick(pos - 800.0, active, space, radius)


def deactivation_and_space_hop():
    pos, active, space, radius = make_world(256, 100, seed=2, world=300.0)
    yield tick(pos, active, space, radius)
    active = active.copy()
    active[0] = False
    yield tick(pos, active, space, radius)
    space = space.copy()
    space[5:9] = (space[5:9] + 1) % 4
    yield tick(pos, active, space, radius)


def paging_storm():
    rng = np.random.default_rng(0)
    pos, active, space, radius = make_world(256, 200, seed=0)
    yield tick(pos, active, space, radius)
    yield tick(rng.uniform(0, 1000, pos.shape).astype(np.float32), active,
               space, radius)


def drop_window():
    rng = np.random.default_rng(11)
    n = 64
    active = np.ones(n, bool)
    space = np.zeros(n, np.int32)
    radius = np.full(n, 100.0, np.float32)
    pos = rng.uniform(0, 800, (n, 2)).astype(np.float32)
    for k in range(6):
        if k % 3 == 1:
            pos[: n // 2] = rng.uniform(10, 90, (n // 2, 2))
        else:
            pos = rng.uniform(0, 800, (n, 2)).astype(np.float32)
        yield tick(pos, active, space, radius)


def reset_and_clean_meta():
    """Pipelined ticks with meta_dirty=False, a mid-run reset, and a dirty
    tick that spawns the dormant half."""
    rng = np.random.default_rng(9)
    pos, active, space, radius = make_world(256, 128, seed=9)
    yield tick(pos, active, space, radius)
    for _ in range(3):
        pos = np.clip(pos + rng.normal(0, 15, pos.shape), 0, 1000)
        yield PIPELINE
        yield tick(pos.astype(np.float32), active, space, radius, dirty=False)
    yield RESET
    yield tick(pos.astype(np.float32), active, space, radius)
    yield tick(pos.astype(np.float32), np.ones(256, bool), space, radius)


def kernel_drift_into_overflow():
    """Drift (fast ticks) until a cell overflows (slow ticks): the dropped
    entity's neighbors must see their leaves."""
    rng = np.random.default_rng(11)
    n = 64
    active = np.arange(n) < 20
    space = np.zeros(n, np.int32)
    radius = np.full(n, 60.0, np.float32)
    pos = np.full((n, 2), 350.0, np.float32)
    pos[:12] = 50.0 + rng.uniform(-45.0, 45.0, (12, 2))
    pos[:12, 0] += 44.0
    pos[12:20] = rng.uniform(200.0, 400.0, (8, 2))  # static bystanders
    for _ in range(6):
        yield tick(pos, active, space, radius)
        pos[:12, 0] -= 8.0


def kernel_mixed():
    """Storm (paged by rank), pipelined drift with meta_dirty=False (fast),
    then a teleport, and a despawn with a space hop (slow)."""
    rng = np.random.default_rng(2)
    n = 128
    pos = rng.uniform(0, 400, (n, 2)).astype(np.float32)
    active = np.arange(n) < 100
    space = rng.integers(0, 2, n).astype(np.int32)
    radius = np.full(n, 60.0, np.float32)
    yield tick(pos, active, space, radius)
    for _ in range(2):
        pos = np.clip(pos + rng.normal(0, 3, pos.shape), 0, 400)
        yield PIPELINE
        yield tick(pos.astype(np.float32), active, space, radius, dirty=False)
    pos = pos.astype(np.float32)
    pos[:5] = rng.uniform(0, 400, (5, 2))
    yield tick(pos, active, space, radius)
    active = active.copy()
    active[10:14] = False
    space = space.copy()
    space[20:30] = 1 - space[20:30]
    yield tick(pos, active, space, radius)


def jax_fast(p, prev, cur, dropped):
    """The JAX engine's fast-path guard on the same epochs."""
    ppos, pact, pspc, prad = map(jnp.asarray, prev)
    pos, act, spc, _ = map(jnp.asarray, cur)
    return bool(jn._fast_guard(p, ppos, pact, pspc, prad, pos, act, spc,
                               jnp.int32(dropped)))


def run_both(p, ticks, jax_backend, port_backend, visible=False):
    """Step both engines through ``ticks``; returns the port's fast flags."""
    n = p.capacity
    je = jn.NeighborEngine(p, backend=jax_backend)
    te = tn.NeighborEngine(tn.params_from_reference(dataclasses.asdict(p)),
                           backend=port_backend, device="cpu")
    je.reset()
    te.reset()
    cur = [set() for _ in range(n)]
    fasts = []
    pipeline = False
    pending = None  # (jax, port, tick) dispatched but not collected

    def finish(pend):
        jpend, tpend, (pos, act, spc, rad, _), prev = pend
        want = jpend.collect()
        got = tpend.collect()
        assert np.array_equal(want[0], got[0]), "enters"
        assert np.array_equal(want[1], got[1]), "leaves"
        assert want[2] == got[2], "dropped"
        assert got[0].dtype == got[1].dtype == np.int32
        fast = bool(tpend.fast)
        assert fast == jax_fast(p, prev, (pos, act, spc, rad), want[2])
        fasts.append(fast)
        apply_events(cur, got[0], got[1])
        vis = _visible_mask(p, pos, act, spc) if visible else act
        assert cur == brute_force_sets(pos, vis, spc, rad)

    for tk in ticks:
        if tk == PIPELINE:
            pipeline = True
            continue
        if tk == RESET:
            if pending is not None:
                finish(pending)
                pending = None
            je.reset()
            te.reset()
            cur = [set() for _ in range(n)]
            continue
        pos, act, spc, rad, dirty = tk
        prev = je.carried_epoch()
        assert all(np.array_equal(a, b)
                   for a, b in zip(prev, te.carried_epoch()))
        nxt = (je.step_async(pos, act, spc, rad, meta_dirty=dirty),
               te.step_async(pos, act, spc, rad, meta_dirty=dirty), tk, prev)
        if pending is not None:
            finish(pending)
            pending = None
        if pipeline:
            pending = nxt
            pipeline = False
        else:
            finish(nxt)
    if pending is not None:
        finish(pending)
    return fasts


@pytest.mark.parametrize("p,scenario,visible", [
    (PARAMS, random_walk, False),
    (PARAMS, teleports, False),
    (PARAMS, isolation_radius_wrap, False),
    (PARAMS, deactivation_and_space_hop, False),
    (PAGING, paging_storm, False),
    (DROPS, drop_window, True),
    (PARAMS, reset_and_clean_meta, False),
], ids=lambda v: getattr(v, "__name__", None))
def test_reference_engine_matches_jnp(p, scenario, visible):
    run_both(p, scenario(), "jnp", "reference", visible)


@pytest.mark.parametrize("p,scenario,visible", [
    (KERNEL_DROPS, kernel_drift_into_overflow, True),
    (KERNEL_PAGING, kernel_mixed, False),
], ids=lambda v: getattr(v, "__name__", None))
def test_kernel_engine_matches_pallas_interpret(p, scenario, visible):
    before = dict(ek.launches)
    fasts = run_both(p, scenario(), "pallas_interpret", "kernel", visible)
    assert True in fasts and False in fasts  # both leave paths ran
    assert ek.launches == before  # CPU tensors: the plain version


@pytest.mark.parametrize("jax_backend,port_backend", [
    ("jnp", "reference"), ("pallas_interpret", "kernel"),
])
def test_state_carries_over_from_jax_engine(jax_backend, port_backend):
    """The JAX engine runs a few ticks; its state moves into a fresh port
    engine, and both then step the same next ticks identically."""
    p = KERNEL_PAGING
    rng = np.random.default_rng(4)
    n = p.capacity
    pos = rng.uniform(0, 400, (n, 2)).astype(np.float32)
    active = np.arange(n) < 110
    space = rng.integers(0, 2, n).astype(np.int32)
    radius = np.full(n, 70.0, np.float32)
    je = jn.NeighborEngine(p, backend=jax_backend)
    je.reset()
    for _ in range(2):
        je.step(pos, active, space, radius)
        pos = np.clip(pos + rng.normal(0, 4, pos.shape), 0, 400)
        pos = pos.astype(np.float32)
    te = tn.NeighborEngine(tn.params_from_reference(dataclasses.asdict(p)),
                           backend=port_backend, device="cpu")
    te.load_state(tuple(np.asarray(a) for a in je._state))
    for k in range(2):
        if k == 1:
            pos[:3] = rng.uniform(0, 400, (3, 2))  # a slow tick
        want = je.step(pos, active, space, radius)
        got = te.step(pos, active, space, radius)
        assert np.array_equal(want[0], got[0])
        assert np.array_equal(want[1], got[1])
        assert want[2] == got[2]
        assert len(want[0]) + len(want[1]) > 0


def test_load_state_checks_shapes():
    eng = tn.NeighborEngine(tn.NeighborParams(capacity=64, grid_x=4,
                                              grid_z=4, space_slots=1),
                            backend="kernel", device="cpu")
    eng.reset()
    state = eng.carried_epoch()
    with pytest.raises(ValueError, match="11 arrays"):
        eng.load_state(state)
    with pytest.raises(ValueError, match="shape"):
        eng.load_state(state + (np.zeros(3, np.int32),) * 7)


def test_step_async_copies_caller_buffers():
    """In-place updates of the caller's arrays after a dispatch must not
    rewrite the engine's previous epoch."""
    p = tn.NeighborParams(capacity=64, grid_x=4, grid_z=4, space_slots=1,
                          cell_capacity=64)
    eng = tn.NeighborEngine(p, backend="reference", device="cpu")
    eng.reset()
    pos, active, space, radius = make_world(64, 40, seed=5, world=400.0)
    eng.step(pos, active, space, radius)
    sent = pos.copy()
    pos += 1000.0
    active[:] = False
    kept = eng.carried_epoch()
    assert np.array_equal(kept[0], sent)
    assert kept[1].sum() == 40


def test_default_device_is_cuda():
    """No device= means CUDA; on a machine without one the engine raises
    instead of running on the CPU."""
    p = tn.NeighborParams(capacity=64, grid_x=4, grid_z=4, space_slots=1)
    if torch.cuda.is_available():
        assert tn.NeighborEngine(p).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            tn.NeighborEngine(p)
    assert tn.NeighborEngine(p, device="cpu").backend == "reference"


def test_kernel_backend_rejects_wide_cells():
    p = tn.NeighborParams(capacity=64, grid_x=4, grid_z=4, space_slots=2,
                          cell_capacity=tn.LANES + 1, max_events=64)
    with pytest.raises(ValueError, match="cell_capacity"):
        tn.NeighborEngine(p, backend="kernel", device="cpu")
