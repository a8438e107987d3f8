"""Fixtures of the benchmark's tests: a copy of the benchmark in a
temporary checkout, with tiny cells that run on the CPU, and a card for
the tests marked ``cuda`` (decided inside the fixture, never at import)."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]

# Tiny cells: the headline's cell size, radius, capacity and motion on an
# 8 x 8 grid of 2,048 slots, with an inline budget the storm pages past.
TINY = {
    "tiny_1": dict(driver="single", processes=1, backend="kernel"),
    "tiny_2p": dict(driver="multiproc", processes=2, backend="reference"),
}


def add_config(root: Path, name: str, **changes) -> None:
    """Write ``configs/<name>.json``: aoi_100k's file with ``changes``
    (``engine`` entries merged), and list it with a ``walk`` cell."""
    cfg = json.loads((REPO / "gwbench/configs/aoi_100k.json").read_text())
    engine = dict(cfg["engine"], **changes.pop("engine", {}))
    cfg.update(changes, name=name, engine=engine)
    (root / f"gwbench/configs/{name}.json").write_text(json.dumps(cfg))
    m = json.loads((root / "BENCHMARK.json").read_text())
    m["configs"].append({"name": name, "source": "test",
                         "file": f"gwbench/configs/{name}.json",
                         "reduced": [], "why": "a test's cell"})
    m["workloads"].append({"name": f"{name}.walk", "config": name,
                           "traffic": "walk", "chips": cfg["chips"],
                           "why": "a test's cell"})
    for metric in m["end_to_end"] + m["per_layer"]:
        if "workloads" in metric:
            metric["workloads"].append(f"{name}.walk")
    (root / "BENCHMARK.json").write_text(json.dumps(m))


@pytest.fixture
def bench_root(tmp_path) -> Path:
    """A checkout holding ``BENCHMARK.json`` and a copy of ``gwbench/``,
    with the tiny cells ``tiny_1.walk`` and ``tiny_2p.walk``."""
    shutil.copytree(REPO / "gwbench", tmp_path / "gwbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    for name, kw in TINY.items():
        add_config(tmp_path, name, chips=1, warm_ticks=2, check_share=0.3,
                   trace_ticks=2,
                   engine=dict(capacity=2048, grid_x=8, grid_z=8,
                               max_events=1024 * kw["processes"]), **kw)
    return tmp_path


@pytest.fixture
def card():
    """The first CUDA card; skips where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)
