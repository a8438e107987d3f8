"""The motion generator: the same seed gives the same ticks, and the
world's edges keep every position inside it."""

from __future__ import annotations

import json

import numpy as np
import pytest

from gwbench import manifest
from gwbench.tests.conftest import REPO

MIX = json.loads((REPO / "gwbench/traffic/walk.json").read_text())
CONFIG = json.loads((REPO / "gwbench/configs/aoi_100k.json").read_text())


def traffic(seed, stream=0, rows=4096, mix=MIX):
    gen = manifest.generator(REPO, mix["generator"])
    return gen.Traffic(mix, CONFIG, rows, seed, stream)


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11, 2**40 + 3])
def test_same_seed_same_ticks(seed):
    a, b = traffic(seed), traffic(seed)
    for _ in range(50):
        np.testing.assert_array_equal(a.advance(), b.advance())
    np.testing.assert_array_equal(a.active, b.active)
    other = traffic(seed + 1)
    assert not np.array_equal(other.advance(), a.advance())


def test_streams_differ():
    assert not np.array_equal(traffic(5, 0).pos, traffic(5, 1).pos)


@pytest.mark.parametrize("mix", [MIX, dict(MIX, sigma=40.0)],
                         ids=["walk", "fast"])
def test_reflection_keeps_the_world(mix):
    t = traffic(3, mix=mix, rows=2048)
    world = t.world
    lo = np.full(2, np.inf)
    hi = np.full(2, -np.inf)
    for _ in range(3000):
        pos = t.advance()
        assert pos.dtype == np.float32
        assert (pos >= 0).all() and (pos <= world).all()
        lo = np.minimum(lo, pos.min(0))
        hi = np.maximum(hi, pos.max(0))
        # Reflection never moves a row farther than its velocity does.
        step = np.abs(pos - t.prev).max(0)
        assert (step <= np.abs(t.vel).max(1) * (1 + 1e-5) + 1e-3).all()
    # Rows reach the edges and come back: the density does not pile up.
    assert (lo < 0.02 * world).all() and (hi > 0.98 * world).all()
    counts, _, _ = np.histogram2d(t.pos[:, 0], t.pos[:, 1], bins=4,
                                  range=[[0, world[0]], [0, world[1]]])
    assert counts.max() < 2.0 * counts.mean()


def test_active_share():
    cfg = dict(CONFIG, active_share=0.875)
    gen = manifest.generator(REPO, "motion")
    t = gen.Traffic(MIX, cfg, 8192, 1)
    assert t.active.sum() == 7168
