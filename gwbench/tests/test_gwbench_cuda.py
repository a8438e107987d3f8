"""On the card: the single-card cell runs whole and proves correct, and
the control fails at the cell's own size."""

from __future__ import annotations

import time

import pytest

from gwbench import control, manifest, run
from gwbench.reference import check
from gwbench.tests.conftest import REPO


@pytest.mark.cuda
def test_cell_runs_correct(card):
    line, bad = run.run_cell(REPO, "aoi_100k.walk", 2**31 + 3, 2.0, True,
                             "cuda", time.perf_counter())
    assert bad == []
    assert line["correct"] is True
    assert line["device"]["busy_s"] > 0
    assert 0 < line["metrics"]["event_mask_roofline"]["value"] <= 100


@pytest.mark.cuda
def test_control_fails_at_cell_size(card):
    cell = manifest.resolve(manifest.load(REPO), "aoi_100k.walk", REPO)
    ticks = control.world_ticks(cell, 5, 20)
    numbers = check.compare(ticks, cell["config"], card,
                            program_dtype=control.CONTROL_DTYPE)
    assert not check.verdict(numbers)[0]
