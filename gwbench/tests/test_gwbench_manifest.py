"""The manifest's rules, files found by name, and the import check."""

from __future__ import annotations

import ast
import copy
import json
import time
from pathlib import Path

import pytest

from gwbench import manifest, run
from gwbench.tests.conftest import REPO, add_config


def test_repo_manifest_is_sound():
    assert manifest.check(manifest.load(REPO), REPO) == []


def _broken(change):
    m = copy.deepcopy(manifest.load(REPO))
    change(m)
    return manifest.check(m, REPO)


@pytest.mark.parametrize("change", [
    lambda m: m["end_to_end"][0].update(name="bad name"),
    lambda m: m["end_to_end"][0].update(name="x" * 65),
    lambda m: m["end_to_end"][0].update(unit="updates per s"),
    lambda m: m["end_to_end"][0].update(unit="µs"),
    lambda m: m["per_layer"][0].update(name="dispatch/ms"),
    lambda m: m["workloads"][0].update(name="a,b"),
    lambda m: m["configs"][0]["reduced"].append("num layers"),
    lambda m: m["per_layer"][0].update(better="faster"),
    lambda m: m["end_to_end"][0].update(source="program_counter"),
], ids=["space", "long", "unit-space", "unit-greek", "slash", "comma",
        "reduced", "better", "e2e-source"])
def test_names_and_units(change):
    assert _broken(change)


def test_moves_must_be_reported_in_each_cell():
    def change(m):
        # collect_ms moves the p99, which the four-card cell does not report.
        spec = next(x for x in m["per_layer"] if x["name"] == "collect_ms")
        spec["workloads"] = [w["name"] for w in m["workloads"]]
    errs = _broken(change)
    assert any("collect_ms" in e and "does not report" in e for e in errs)


def test_every_file_found_by_name():
    m = manifest.load(REPO)
    for w in m["workloads"]:
        cell = manifest.resolve(m, w["name"], REPO)
        assert Path(cell["driver"]).is_file()
        assert Path(cell["generator"]).is_file()
        assert cell["config"]["chips"] == w["chips"]
    for spec in m["end_to_end"] + m["per_layer"]:
        assert callable(manifest.metric_reader(REPO, spec["name"]).read)
    assert _broken(lambda m: m["per_layer"].append(
        dict(m["per_layer"][0], name="no_such_reader")))


def test_throwaway_files_are_picked_up(bench_root):
    """A configuration, a traffic mix and a metric added as files, with
    their entries, run without an edit to any file the benchmark had."""
    before = {p: p.read_bytes() for p in (bench_root / "gwbench").rglob("*")
              if p.is_file()}
    (bench_root / "gwbench/traffic/drift.json").write_text(json.dumps(
        {"generator": "motion", "sigma": 1.0}))
    (bench_root / "gwbench/metrics/events_per_tick.py").write_text(
        '"""Pairs received a tick."""\n\n\ndef read(run):\n'
        '    return sum(float(p["window"]["events"].mean())'
        ' for p in run.procs)\n')
    add_config(bench_root, "tiny_throwaway", chips=1, warm_ticks=1,
               check_share=0.5, trace_ticks=2,
               driver="single", processes=1, backend="reference",
               engine=dict(capacity=512, grid_x=4, grid_z=4,
                           max_events=256))
    m = json.loads((bench_root / "BENCHMARK.json").read_text())
    m["workloads"].append({"name": "tiny_throwaway.drift",
                           "config": "tiny_throwaway", "traffic": "drift",
                           "chips": 1, "why": "a test's cell"})
    next(x for x in m["end_to_end"] if x["name"] == "entity_updates_per_s")[
        "workloads"].append("tiny_throwaway.drift")
    m["per_layer"].append({"name": "events_per_tick", "unit": "pairs",
                           "better": "higher", "source": "host_clock",
                           "layer": "host API",
                           "moves": "entity_updates_per_s",
                           "workloads": ["tiny_throwaway.drift"]})
    (bench_root / "BENCHMARK.json").write_text(json.dumps(m))
    assert manifest.check(m, bench_root) == []
    line, bad = run.run_cell(bench_root, "tiny_throwaway.drift", 3, 0.3,
                             True, "cpu", time.perf_counter())
    assert bad == []
    assert line["correct"] is True
    assert line["metrics"]["events_per_tick"]["value"] > 0
    assert list(line)[-1] == "checked"
    after = {p: p.read_bytes() for p in before}
    assert after == before


@pytest.mark.parametrize("names, found", [
    (["goworld_tpu_torch", "goworld_tpu_torch.ops.neighbor", "numpy"], []),
    (["goworld_tpu", "goworld_tpu.ops"], ["goworld_tpu"]),
    (["jax.numpy", "jaxlib.xla_client", "flax.linen"],
     ["flax", "jax", "jaxlib"]),
    (["jaxtyping", "flaxen", "goworld_tpu_tools"], []),
])
def test_forbidden_modules_compared_whole(names, found):
    assert run.forbidden(names) == found


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_sources_import_no_jax():
    for path in (REPO / "gwbench").rglob("*.py"):
        assert not run.forbidden(_imports(path)), path
    for path in (REPO / "gwbench/reference").rglob("*.py"):
        assert "goworld_tpu_torch" not in _imports(path), path


def test_run_refuses_without_enough_cards(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "aoi_100k.walk", "--seed", "1",
                     "--seconds", "1"]) != 0
    out = capsys.readouterr()
    assert out.out == "" and "CUDA" in out.err
