"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
Each is a file of its own under the benchmark's folder, and so is each
metric's reader, each driver and each traffic generator:

- ``configs/<config>.json``: the deployment (the manifest's ``file``);
- ``traffic/<mix>.json``: the mix's parameters and its generator's name;
- ``traffic/<generator>.py``: a generator, shared by the mixes naming it;
- ``drivers/<driver>.py``: how an engine is built, stepped and collected;
- ``metrics/<metric>.py``: the reader of one metric.

Every lookup is relative to a root directory (the checkout), so a test can
point the harness at a copy with files of its own.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BENCH_DIR = "gwbench"

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = ("host_clock", "device_trace")


class ManifestError(ValueError):
    """A manifest or a file it names breaks the benchmark's rules."""


def load(root: Path = ROOT) -> dict:
    with open(Path(root) / "BENCHMARK.json", encoding="utf-8") as f:
        return json.load(f)


def bench_file(root: Path, *parts: str) -> Path:
    return Path(root, BENCH_DIR, *parts)


def load_json(path: Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def load_module(path: Path, prefix: str):
    """The module of the Python file ``path``, loaded by its path (and
    cached in ``sys.modules`` under ``<prefix>.<stem>@<path>``)."""
    path = Path(path).resolve()
    if not path.is_file():
        raise ManifestError(f"no file {path}")
    key = f"gwbench_{prefix}.{path.stem}@{path}"
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[key]
        raise
    return mod


def metric_reader(root: Path, name: str):
    return load_module(bench_file(root, "metrics", f"{name}.py"), "metrics")


def driver_path(root: Path, name: str) -> Path:
    return bench_file(root, "drivers", f"{name}.py")


def generator(root: Path, name: str):
    return load_module(bench_file(root, "traffic", f"{name}.py"), "traffic")


def cell_metrics(manifest: dict, workload: str, trace: bool) -> list[dict]:
    """The metrics a run of ``workload`` reports: its end-to-end metrics
    untraced, its per-layer metrics traced."""
    group = manifest["per_layer" if trace else "end_to_end"]
    return [m for m in group
            if workload in m.get("workloads", [workload])]


def resolve(manifest: dict, workload: str, root: Path = ROOT) -> dict:
    """Everything one cell needs: its manifest entry, its configuration's
    file, its mix's file, and the paths of its driver and generator."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise ManifestError(
            f"unknown workload {workload!r}; BENCHMARK.json has "
            f"{sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = load_json(Path(root, configs[cell["config"]]["file"]))
    traffic = load_json(bench_file(root, "traffic", f"{cell['traffic']}.json"))
    return {
        "workload": workload,
        "chips": int(cell["chips"]),
        "config_name": cell["config"],
        "traffic_name": cell["traffic"],
        "config": config,
        "traffic": traffic,
        "driver": str(driver_path(root, config["driver"])),
        "generator": str(bench_file(root, "traffic",
                                    f"{traffic['generator']}.py")),
        "root": str(root),
    }


def check(manifest: dict, root: Path = ROOT) -> list[str]:
    """The breaches of the benchmark's rules this module can see: names,
    units, sources, files found by name, and every per-layer metric's
    ``moves`` reported in each cell that reports the metric. Empty when
    the manifest is sound."""
    errs: list[str] = []
    names_seen: set[str] = set()

    def name_ok(what: str, name) -> None:
        if not isinstance(name, str) or not NAME_RE.match(name):
            errs.append(f"{what}: bad name {name!r}")

    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        if not manifest.get(key):
            errs.append(f"{key}: empty")
    for c in manifest.get("configs", []):
        name_ok("config", c.get("name"))
        for k in c.get("reduced", []):
            name_ok(f"config {c.get('name')} reduced", k)
        if not Path(root, c.get("file", "")).is_file():
            errs.append(f"config {c.get('name')}: no file {c.get('file')}")
        if c.get("name") in names_seen:
            errs.append(f"config {c['name']}: name used twice")
        names_seen.add(c.get("name"))
    configs = {c.get("name"): c for c in manifest.get("configs", [])}
    cells = {}
    for w in manifest.get("workloads", []):
        for k in ("name", "config", "traffic"):
            name_ok(f"workload {k}", w.get(k))
        if w.get("name") in cells:
            errs.append(f"workload {w['name']}: name used twice")
        cells[w.get("name")] = w
        if w.get("config") not in configs:
            errs.append(f"workload {w.get('name')}: unknown config")
            continue
        if w.get("chips") not in (1, 4):
            errs.append(f"workload {w.get('name')}: chips must be 1 or 4")
        try:
            r = resolve(manifest, w["name"], root)
        except (OSError, KeyError, ManifestError) as exc:
            errs.append(f"workload {w.get('name')}: {exc}")
            continue
        for what, path in (("driver", r["driver"]),
                           ("generator", r["generator"])):
            if not Path(path).is_file():
                errs.append(f"workload {w['name']}: no {what} {path}")
        if int(r["config"].get("chips", 0)) != int(w["chips"]):
            errs.append(f"workload {w['name']}: chips differ from its "
                        f"configuration's")
    metric_names: set[str] = set()
    e2e = {m.get("name"): m for m in manifest.get("end_to_end", [])}
    for group in ("end_to_end", "per_layer"):
        for m in manifest.get(group, []):
            name = m.get("name")
            name_ok(f"{group} metric", name)
            if name in metric_names:
                errs.append(f"metric {name}: name used twice")
            metric_names.add(name)
            if not isinstance(m.get("unit"), str) or not UNIT_RE.match(
                    m["unit"]):
                errs.append(f"metric {name}: bad unit {m.get('unit')!r}")
            if m.get("better") not in ("lower", "higher"):
                errs.append(f"metric {name}: better must be lower|higher")
            if m.get("source") not in SOURCES:
                errs.append(f"metric {name}: source {m.get('source')!r}")
            for w in m.get("workloads", []):
                if w not in cells:
                    errs.append(f"metric {name}: unknown workload {w}")
            if not bench_file(root, "metrics", f"{name}.py").is_file():
                errs.append(f"metric {name}: no reader metrics/{name}.py")
            if group == "per_layer":
                moves = m.get("moves")
                if moves not in e2e:
                    errs.append(f"metric {name}: moves {moves!r} is no "
                                f"end-to-end metric")
                    continue
                for w in m.get("workloads", list(cells)):
                    if w not in e2e[moves].get("workloads", [w]):
                        errs.append(f"metric {name}: {w} does not report "
                                    f"{moves}")
    if "setup_s" not in e2e or "workloads" in e2e["setup_s"]:
        errs.append("end_to_end: setup_s must be reported in every cell")
    for w in cells:
        if len(cell_metrics(manifest, w, trace=False)) < 2:
            errs.append(f"workload {w}: no end-to-end metric besides "
                        f"setup_s")
        if not cell_metrics(manifest, w, trace=True):
            errs.append(f"workload {w}: no per-layer metric")
    return errs
