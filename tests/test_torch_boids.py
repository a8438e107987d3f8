"""The port's boids step against the JAX package, piece by piece.

Every input is made with numpy from a seed and fed to the JAX function and
its counterpart in ``goworld_tpu_torch``. The cell packing must be
bit-identical. The steering kernel's plain version is held against the
Pallas kernel run by the interpreter at ``atol=1e-5``: the two sum the same
terms in another order, which moves the f32 results by a few 1e-6. The
float64 oracle is held at ``tests/test_boids.py``'s 2e-3.
"""

import dataclasses
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import seam_world
from goworld_tpu.ops import boids as jb
from goworld_tpu_torch.ops import boids as tb
from goworld_tpu_torch.ops import boids_kernel as bk

BASE = dict(capacity=512, cell_size=100.0, grid_x=8, grid_z=8,
            max_speed=8.0, max_accel=2.0)
SUPERCELLS = dict(BASE, cell_size=250.0, grid_x=4, grid_z=4, radius=100.0)


def both_params(**fields):
    jp = jb.BoidsParams(**{**BASE, **fields})
    return jp, tb.params_from_reference(dataclasses.asdict(jp))


def uniform(p, n_active=400, seed=1, speed=3.0):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, [p.world_x, p.world_z], (p.capacity, 2))
    vel = rng.normal(0, speed, (p.capacity, 2))
    active = np.arange(p.capacity) < n_active
    return pos.astype(np.float32), vel.astype(np.float32), active


def overfilled(p, seed=3):
    """150 active agents in cell (0, 0), past its 128 lanes; inactive agents
    there too; some coordinates on exact cell multiples or just below 0."""
    pos, vel, active = uniform(p, n_active=450, seed=seed)
    rng = np.random.default_rng(seed)
    pos[:170] = rng.uniform(0, p.cell_size, (170, 2))
    active[150:170] = False
    pos[200:204] = [[100.0, 200.0], [0.0, 700.0], [-1e-3, 50.0],
                    [p.world_x - 1e-3, 0.0]]
    return pos, vel, active


WORLDS = {
    "uniform": ({}, uniform),
    "seam_cluster": ({}, seam_world),
    "supercells": (SUPERCELLS, uniform),
}


def jax_cells(jp, pos, vel, active):
    return jb._build_cells(jp, jnp.asarray(pos), jnp.asarray(vel),
                           jnp.asarray(active))


def port_cells(tp, pos, vel, active):
    return tb._build_cells(tp, torch.tensor(pos), torch.tensor(vel),
                           torch.tensor(active))


@pytest.mark.parametrize("fields", [
    {}, SUPERCELLS, dict(radius=150.0), dict(radius=100.0),
    dict(sep_frac=0.5, w_sep=0.1, dt=0.5),
])
def test_params_validation_matches_reference(fields):
    try:
        jp, jerr = jb.BoidsParams(**fields), None
    except ValueError as e:
        jp, jerr = None, str(e)
    try:
        tp, terr = tb.BoidsParams(**fields), None
    except ValueError as e:
        tp, terr = None, str(e)
    assert terr == jerr
    if jp is not None:
        assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
        assert (tp.r_eff, tp.world_x, tp.world_z) == (
            jp.r_eff, jp.world_x, jp.world_z)
        assert tb.params_from_reference(dataclasses.asdict(jp)) == tp


def test_params_from_reference_rejects_unknown_fields():
    fields = dataclasses.asdict(jb.BoidsParams())
    with pytest.raises(ValueError, match="unknown"):
        tb.params_from_reference({**fields, "lanes": 64})
    fields.pop("dt")
    with pytest.raises(ValueError, match="missing"):
        tb.params_from_reference(fields)


@pytest.mark.parametrize("case", [*WORLDS, "overfilled"])
def test_build_cells_bit_identical(case):
    fields, make = WORLDS.get(case, ({}, overfilled))
    jp, tp = both_params(**fields)
    inputs = make(jp)
    j_cells, j_slot = jax_cells(jp, *inputs)
    t_cells, t_slot = port_cells(tp, *inputs)
    assert t_cells.shape == (tp.grid_z + 2, tp.grid_x + 2, 8, 128)
    assert t_cells.dtype == torch.float32 and t_slot.dtype == torch.int32
    assert np.array_equal(np.asarray(j_cells), t_cells.numpy())
    assert np.array_equal(np.asarray(j_slot), t_slot.numpy())
    if case == "overfilled":
        assert (t_slot.numpy()[:150] == -1).sum() == 150 - 128


@pytest.mark.parametrize("case", list(WORLDS))
def test_plain_kernel_matches_pallas_interpreter(case):
    fields, make = WORLDS[case]
    jp, tp = both_params(**fields)
    cells, _ = jax_cells(jp, *make(jp))
    want = np.asarray(jb._compiled_accel(jp, True)(cells))
    before = bk.launches["boids"]
    got = bk.boids_accel(torch.tensor(np.asarray(cells)), tp)
    assert bk.launches["boids"] == before  # the plain version counts nothing
    assert got.shape == want.shape == (tp.grid_z, tp.grid_x, 2, 128)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def torus_gap(a, b, world):
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return np.minimum(d, world - d)


@pytest.mark.parametrize("case", ["uniform", "overfilled"])
def test_step_matches_reference_step(case):
    jp, tp = both_params()
    pos, vel, active = (uniform if case == "uniform" else overfilled)(jp)
    j_pos, j_vel, j_acc, j_drop = jb._step(
        jp, True, jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(active))
    t_pos, t_vel, t_acc, t_drop = tb._step(
        tp, "kernel", torch.tensor(pos), torch.tensor(vel),
        torch.tensor(active))
    np.testing.assert_allclose(t_acc.numpy(), np.asarray(j_acc),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t_vel.numpy(), np.asarray(j_vel),
                               rtol=1e-5, atol=1e-5)
    # An agent within an ulp of the edge may wrap to 0 in one and to just
    # under the world size in the other: the same place on the torus.
    gap = torus_gap(t_pos.numpy(), j_pos, np.array([tp.world_x, tp.world_z]))
    assert gap.max() <= 1e-3
    assert int(t_drop) == int(j_drop)
    assert (int(t_drop) > 0) == (case == "overfilled")
    assert t_drop.dtype == torch.int32


@pytest.mark.parametrize("case", list(WORLDS))
def test_accel_matches_oracle(case):
    fields, make = WORLDS[case]
    _, tp = both_params(**fields)
    pos, vel, active = make(tp)
    _, _, accel = tb.BoidsEngine(tp, device="cpu").step(pos, vel, active)
    got = accel.numpy().astype(np.float64)
    want = tb.reference_accel(tp, pos, vel, active)
    np.testing.assert_allclose(got[active], want[active], rtol=2e-3,
                               atol=2e-3)
    assert np.all(got[~active] == 0.0)
    rows = np.array([3, 0, 450, 17])
    assert np.array_equal(tb.reference_accel(tp, pos, vel, active, rows),
                          want[rows])


def test_engine_device_and_backend():
    tp = tb.BoidsParams(**BASE)
    eng = tb.BoidsEngine(tp, device="cpu")
    assert eng.backend == "reference" and eng.device.type == "cpu"
    assert tb.BoidsEngine(tp, backend="kernel", device="cpu").backend == (
        "kernel")
    with pytest.raises(ValueError, match="backend"):
        tb.BoidsEngine(tp, backend="pallas", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tb.BoidsEngine(tp)


def test_isolated_agent_no_force():
    tp = tb.BoidsParams(**BASE)
    pos = np.zeros((tp.capacity, 2), np.float32)
    pos[0] = (50.0, 50.0)
    pos[1] = (450.0, 450.0)  # > cell_size away from agent 0
    vel = np.zeros((tp.capacity, 2), np.float32)
    active = np.arange(tp.capacity) < 2
    _, _, accel = tb.BoidsEngine(tp, device="cpu").step(pos, vel, active)
    np.testing.assert_allclose(accel.numpy()[:2], 0.0, atol=1e-6)


def test_speed_clamped_and_world_wrapped():
    tp = tb.BoidsParams(**{**BASE, "max_speed": 5.0})
    pos, vel, active = uniform(tp, seed=3, speed=20.0)
    pos2, vel2, _ = tb.BoidsEngine(tp, device="cpu").step(pos, vel, active)
    assert pos2.dtype == vel2.dtype == torch.float32
    speeds = np.linalg.norm(vel2.numpy(), axis=1)
    assert speeds.max() <= tp.max_speed * 1.001
    pos2 = pos2.numpy()
    assert (pos2 >= 0).all() and (pos2[:, 0] <= tp.world_x).all() \
        and (pos2[:, 1] <= tp.world_z).all()


def test_alignment_converges_headings():
    """Flocking sanity: alignment shrinks velocity variance over time, with
    the tensors chained from one step into the next."""
    tp = tb.BoidsParams(**{**BASE, "w_sep": 0.1, "w_coh": 0.2,
                           "w_align": 1.5, "max_speed": 6.0})
    rng = np.random.default_rng(4)
    pos = np.mod(rng.normal(300.0, 80.0, (tp.capacity, 2)), tp.world_x)
    pos = pos.astype(np.float32)
    vel = rng.normal(0, 4.0, (tp.capacity, 2)).astype(np.float32)
    active = np.ones(tp.capacity, bool)
    eng = tb.BoidsEngine(tp, device="cpu")
    var0 = np.var(vel, axis=0).sum()
    for _ in range(25):
        pos, vel, _ = eng.step(pos, vel, active)
    var1 = np.var(vel.numpy(), axis=0).sum()
    assert var1 < var0 * 0.5, (var0, var1)


def test_overflow_warning_reads_the_stale_count(caplog):
    _, tp = both_params()
    pos, vel, active = overfilled(tp)
    eng = tb.BoidsEngine(tp, device="cpu")
    eng.DROP_CHECK_INTERVAL = 2
    dropped = int(tb._step(tp, "kernel", torch.tensor(pos), torch.tensor(vel),
                           torch.tensor(active))[3])
    assert dropped > 0
    # The handler sits on the module's logger itself: a game's log setup
    # (run in-process by other test files) stops the package logger from
    # propagating to the root, where caplog listens.
    logger = logging.getLogger(tb.__name__)
    logger.addHandler(caplog.handler)
    try:
        with caplog.at_level(logging.WARNING, logger=tb.__name__):
            for k in range(1, 5):
                eng.step(pos, vel, active)
                assert int(eng.last_dropped) == dropped
                # The count taken at tick 2 is read at tick 4, not before.
                assert (f"cell overflow: {dropped} " in caplog.text) == \
                    (k == 4)
    finally:
        logger.removeHandler(caplog.handler)
