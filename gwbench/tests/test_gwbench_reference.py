"""The plain reference against the port's plain CPU path, at a small
size; and the control, the reference one precision lower, fails."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from gwbench import control, manifest
from gwbench.reference import check, interest
from gwbench.tests.conftest import REPO

MIX = json.loads((REPO / "gwbench/traffic/walk.json").read_text())


def _config(**engine):
    cfg = json.loads((REPO / "gwbench/configs/aoi_100k.json").read_text())
    cfg["engine"].update(capacity=1024, grid_x=6, grid_z=6, max_events=512,
                         **engine)
    return cfg


def _tick(prev, pos, prev_active, active, space, radius, got, n):
    enters, leaves, dropped = got
    return {"prev": prev, "pos": pos, "prev_active": prev_active,
            "active": active, "space": space, "radius": radius,
            "parts": [(0, n, enters, leaves, dropped)]}


@pytest.mark.parametrize("backend", ["reference", "kernel"])
@pytest.mark.parametrize("crowd", [False, True], ids=["uniform", "crowd"])
def test_reference_agrees_with_port(backend, crowd):
    """Storm (paged), steady ticks, wave ticks (the slow path) and, with a
    crowd, cells over capacity (drops)."""
    from goworld_tpu_torch.ops.neighbor import NeighborEngine, NeighborParams

    cfg = _config(cell_capacity=16 if crowd else 128)
    n = cfg["engine"]["capacity"]
    t = manifest.generator(REPO, "motion").Traffic(dict(MIX, sigma=6.0),
                                                   cfg, n, 11)
    jumps = np.random.default_rng(5)
    if crowd:  # a quarter of the rows start in one cell
        t.u[:, : n // 4] = (np.float32(150.0)
                            + t.u[:, : n // 4] % np.float32(100.0))
        t._fold(t.pos)
    eng = NeighborEngine(NeighborParams(**cfg["engine"]), backend=backend,
                         device="cpu")
    eng.reset()
    zeros = np.zeros(n, bool)
    got = eng.step(t.pos, t.active, t.space, t.radius)
    ticks = [_tick(np.zeros_like(t.pos), t.pos.copy(), zeros, t.active,
                   t.space, t.radius, got, n)]
    assert len(got[0]) > cfg["engine"]["max_events"]  # the storm paged
    for k in range(9):
        pos = t.advance()
        if k % 4 == 3:  # a fifth of the rows jump to random points
            idx = jumps.permutation(n)[: n // 5]
            t.u[:, idx] = (jumps.random((len(idx), 2), dtype=np.float32)
                           * t.world).T
            t._fold(pos)
        got = eng.step_async(pos, t.active, t.space, t.radius,
                             meta_dirty=False).collect()
        ticks.append(_tick(t.prev.copy(), pos.copy(), t.active, t.active,
                           t.space, t.radius, got, n))
    numbers = check.compare(ticks, cfg, torch.device("cpu"))
    assert numbers["pairs_wrong"] == 0 and numbers["dropped_wrong"] == 0
    assert numbers["events_checked"] > 1000
    if crowd:
        assert sum(tk["parts"][0][4] for tk in ticks) > 0  # cells dropped


def test_interest_brute_force():
    """The cell enumeration finds exactly the pairs a brute force finds."""
    g = torch.Generator().manual_seed(4)
    n = 600
    pos = torch.rand((n, 2), generator=g) * 1200.0
    active = torch.rand(n, generator=g) < 0.9
    space = (torch.rand(n, generator=g) < 0.3).to(torch.int64)
    radius = 60.0 + 40.0 * torch.rand(n, generator=g)
    keys, dropped = interest.interest(pos, active, space, radius, 300.0, 4,
                                      4, 128)
    assert dropped == 0
    dx = pos[None, :, 0] - pos[:, None, 0]
    dz = pos[None, :, 1] - pos[:, None, 1]
    ok = ((dx * dx + dz * dz <= (radius * radius)[:, None])
          & active[:, None] & active[None, :]
          & (space[:, None] == space[None, :])
          & ~torch.eye(n, dtype=torch.bool))
    i, j = torch.nonzero(ok, as_tuple=True)
    assert torch.equal(keys, torch.sort(i * n + j).values)


def test_control_fails(bench_root):
    cell = manifest.resolve(manifest.load(bench_root), "tiny_1.walk",
                            bench_root)
    for seed in (1, 2, 3):
        ticks = control.world_ticks(cell, seed, 10)
        numbers = check.compare(ticks, cell["config"], torch.device("cpu"),
                                program_dtype=control.CONTROL_DTYPE)
        assert not check.verdict(numbers)[0]
        assert numbers["pairs_wrong"] > 100
