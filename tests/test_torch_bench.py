"""The port's bench (``goworld_tpu_torch/bench.py``) against the repo's root
``bench.py`` on the CPU.

Each test runs a mode of the port with ``--device cpu`` (the engines' plain
versions) and the root's function on the JAX package (its CPU engines) on the
same seeded worlds, and requires the fields that the world decides (entities,
grid, events a tick, paged ticks, drops, parity, fallback and fast ticks,
migrations, structural bytes, traces) to be exactly equal. Throughput is
measured, not compared. Steps and repeats are cut by the bench's env knobs
(``monkeypatch.setenv``, so the root's own writes to the environment cannot
leak) or by copies of the fixed config dicts on both sides.

The root's CPU ``bench_aoi`` bins at its CPU geometry (cell capacity 64); the
port always takes the accelerator branch's (capacity 128). The worlds here
override cell and grid and hold no cell over 64 occupants, so both engines
see the same cells.
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from goworld_tpu.ops import neighbor as jn
from goworld_tpu.parallel import spatial as js
from goworld_tpu_torch import bench as port_bench
from goworld_tpu_torch.ops import event_kernel
from goworld_tpu_torch.telemetry import history

ROOT = Path(__file__).resolve().parent.parent

# Torch threads a test process uses (the suite runs files in parallel
# worker processes; torch's default of one a core oversubscribes the host).
THREADS = 2

# Every knob a test may set; each test starts with none of them set.
KNOBS = ("BENCH_MODE", "BENCH_N", "BENCH_STEPS", "BENCH_SYNC_STEPS",
         "BENCH_SWEEP_STEPS", "BENCH_MAX_EVENTS", "BENCH_DRAIN_MODE",
         "BENCH_BOIDS_N", "BENCH_BOIDS_STEPS", "BENCH_BOIDS_SWEEP_STEPS",
         "BENCH_FUSED_N", "BENCH_FUSED_STEPS", "BENCH_REHEARSAL",
         "BENCH_PLATFORM")

# The root's bench_phase_profile keys (bench.py:1836-1903). The root's
# profile runs the Pallas kernel compiled (interpret=False), so only on a
# TPU: its key set is read from the source.
PHASE_KEYS = {"table_ms", "feats_ms", "kernel_ms", "gather_ms",
              "events_in_mask", "drain_ms", "drain_bsearch_ms",
              "drain_grouped_ms", "drain_scatter_ms", "full_step_ms",
              "est_tick_ms"}


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def root_bench():
    spec = importlib.util.spec_from_file_location("root_bench",
                                                  ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def knobs(monkeypatch):
    """Clears the bench's knobs and returns a setter for this test's."""
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)

    def setknobs(**kw):
        for k, v in kw.items():
            monkeypatch.setenv(k, str(v))
    return setknobs


@pytest.fixture
def pallas_store(monkeypatch):
    """``pl.store``, which jax 0.9.0 removed, put back for the JAX strip
    tier's drain form (as ``tests/test_torch_spatial.py`` does); the
    programs traced under it are dropped after."""
    from jax.experimental import pallas

    monkeypatch.setattr(
        pallas, "store",
        lambda ref, idx, val: ref.__setitem__(idx, val), raising=False)
    yield
    jn._compiled_event_kernel.cache_clear()
    js._jitted_spatial_step_pallas.cache_clear()


def lines_of(fn, *args):
    """(return value, stdout lines) of ``fn(*args)``."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = fn(*args)
    return rc, out.getvalue().strip().splitlines()


def test_fixed_configs_are_the_roots(root_bench):
    for name in ("CELL_SWEEP", "EVENTS_SWEEP", "DRAIN_SWEEP",
                 "BOIDS_CELL_SWEEP", "PINNED_FLOOR_CONFIG",
                 "SHARDED_FLOOR_CONFIG", "PALLAS_SHARDED_CONFIG",
                 "HEADLINE_BASELINE", "P99_TARGET_MS"):
        assert getattr(port_bench, name) == getattr(root_bench, name), name


# --- bench_aoi -------------------------------------------------------------

AOI_FIELDS = ("metric", "entities", "grid", "cell_size", "max_events",
              "drain_mode", "spaces", "events_per_tick", "paged_ticks",
              "inline_budget_clears_steady_state")
AOI_CASES = {
    "one_space": dict(n_spaces=1, drain_mode="bsearch"),
    "four_spaces": dict(n_spaces=4, drain_mode="grouped"),
    "paged": dict(n_spaces=1, drain_mode="scatter", max_events_override=256),
}


@pytest.mark.parametrize("case", sorted(AOI_CASES))
def test_bench_aoi_matches_root(root_bench, knobs, case):
    knobs(BENCH_STEPS=2, BENCH_SYNC_STEPS=2)
    kw = dict(n=1024, cell_override=100.0, grid_override=16,
              **AOI_CASES[case])
    # The world bench_aoi makes: no cell holds more than the root's CPU
    # cell capacity.
    pos = np.random.default_rng(0).uniform(0, 1600.0, (1024, 2))
    cells = np.floor(pos / 100.0).astype(int)
    assert np.unique(cells, axis=0, return_counts=True)[1].max() <= 32
    want = root_bench.bench_aoi(**kw)
    got = port_bench.bench_aoi(device="cpu", **kw)
    assert {k: got[k] for k in AOI_FIELDS} == {k: want[k] for k in AOI_FIELDS}
    assert set(got) == set(want) | {"backend", "device"}
    assert got["backend"] == "reference" and got["device"] == "cpu"
    assert got["value"] > 0
    if case == "paged":
        assert got["paged_ticks"] > 0


def test_bench_aoi_on_cpu_keeps_the_card_geometry(knobs):
    """The port's geometry is the accelerator branch's whatever the device:
    cell 300 and grid 44 at 102,400 entities and <= 4 slots, 400 and 32
    above; here at 1/16 of the entities (the grid follows the density)."""
    knobs(BENCH_STEPS=2, BENCH_SYNC_STEPS=2, BENCH_N=512)
    r = port_bench.bench_aoi(device="cpu")
    assert (r["cell_size"], r["grid"], r["spaces"]) == (300.0, 8, 1)
    assert r["metric"] == "aoi_entity_updates_per_sec"
    r = port_bench.bench_aoi(space_slots=32, n_spaces=32, label="aoi_32space",
                             device="cpu")
    assert (r["cell_size"], r["grid"], r["spaces"]) == (400.0, 8, 32)


# --- boids -----------------------------------------------------------------

BOIDS_FIELDS = ("metric", "agents", "grid", "cell_size",
                "cell_overflow_dropped")


def test_bench_boids_matches_root(root_bench, knobs):
    knobs(BENCH_BOIDS_N=400, BENCH_BOIDS_STEPS=2)
    want = root_bench.bench_boids()
    got = port_bench.bench_boids(device="cpu")
    assert got["grid"] == 6
    assert {k: got[k] for k in BOIDS_FIELDS} == \
        {k: want[k] for k in BOIDS_FIELDS}
    assert set(got) == set(want) | {"backend", "device"}


@pytest.mark.slow
def test_bench_boids_tuned_matches_root(root_bench, knobs):
    """~16 s on one core: the root's four sweep points each trace the
    Pallas interpreter."""
    knobs(BENCH_BOIDS_N=200, BENCH_BOIDS_STEPS=2, BENCH_BOIDS_SWEEP_STEPS=2)
    want = root_bench.bench_boids_tuned()
    got = port_bench.bench_boids_tuned(device="cpu")
    assert got["metric"] == want["metric"] == "boids_agent_updates_per_sec"
    assert set(got["cell_sweep"]) == set(want["cell_sweep"]) == {
        f"cell_{int(c)}" for c in root_bench.BOIDS_CELL_SWEEP}
    for key, entry in want["cell_sweep"].items():
        assert set(got["cell_sweep"][key]) == set(entry)
        assert got["cell_sweep"][key]["dropped"] == entry["dropped"]
    # The winner is the fastest drop-free point: which one is a timing.
    assert got["cell_size"] in root_bench.BOIDS_CELL_SWEEP
    assert got["cell_overflow_dropped"] == 0
    assert set(got) == set(want) | {"backend", "device"}


# --- the strip engine --------------------------------------------------------

SHARDED_FIELDS = ("metric", "config", "mesh", "mesh_devices", "shard_mode",
                  "parity_with_single_device", "fallback_ticks", "fast_ticks",
                  "shard_migrations", "halo_bytes_per_tick",
                  "allgather_equiv_bytes_per_tick",
                  "halo_smaller_than_allgather", "comms_reduction",
                  "steady_state_retraces")
# The other backend's structural fields: the root names them by its backend
# (jnp | pallas), the port by its own (reference | kernel).
OTHER = ("halo_bytes_per_tick", "allgather_equiv_bytes_per_tick",
         "comms_reduction")


def hold_sharded(root_bench, monkeypatch, port_backend, root_backend):
    config = {"reference": "SHARDED_FLOOR_CONFIG",
              "kernel": "PALLAS_SHARDED_CONFIG"}[port_backend]
    cut = dict(getattr(root_bench, config), steps=2, repeats=1,
               parity_ticks=2)
    monkeypatch.setattr(root_bench, config, cut)
    monkeypatch.setattr(port_bench, config, cut)
    monkeypatch.setitem(port_bench.SHARDED_CONFIGS, port_backend, cut)
    want = root_bench.bench_sharded(root_backend)
    got = port_bench.bench_sharded(port_backend, device="cpu")
    assert {k: got[k] for k in SHARDED_FIELDS} == \
        {k: want[k] for k in SHARDED_FIELDS}
    other_root = "pallas" if root_backend == "jnp" else "jnp"
    other_port = "kernel" if port_backend == "reference" else "reference"
    for k in OTHER:
        assert got[f"{other_port}_{k}"] == want[f"{other_root}_{k}"], k
    assert got["parity_with_single_device"] is True
    assert got["fallback_ticks"] == 0 and got["halo_smaller_than_allgather"]
    assert (got["backend"], got["shard_backend"], got["platform"],
            got["device"]) == (port_backend, port_backend, "cpu", "cpu")
    renamed = {k.replace(other_root, other_port, 1) for k in want}
    assert set(got) == renamed | {"device"}
    assert got["floor_file"] is None
    return got


def test_bench_sharded_reference_matches_root_jnp(root_bench, monkeypatch):
    hold_sharded(root_bench, monkeypatch, "reference", "jnp")


@pytest.mark.slow
def test_bench_sharded_kernel_matches_root_pallas(root_bench, monkeypatch,
                                                  pallas_store):
    """~2 min on one core: the root's strip kernel runs through the Pallas
    interpreter."""
    got = hold_sharded(root_bench, monkeypatch, "kernel", "pallas_interpret")
    assert got["fast_ticks"] > 0  # radius 40: the one-launch fast tick


# The kernel backend's config cut to a quarter of the entities and columns
# (the root's interpreted run of it still takes ~35 s).
KERNEL_CUT = dict(n=512, grid=64, grid_z=4,
                  max_events=4096, halo_cap=64, strip_cols=16, active=448,
                  steps=2, parity_ticks=2)


def test_bench_sharded_kernel_counts_as_the_reference(monkeypatch):
    """The kernel backend (the drain form's plain version here) at a cut
    config: parity, no fallback, fast ticks, and the same counters and
    bytes as the reference backend on the same trace."""
    cut = dict(port_bench.PALLAS_SHARDED_CONFIG, **KERNEL_CUT)
    monkeypatch.setitem(port_bench.SHARDED_CONFIGS, "kernel", cut)
    monkeypatch.setitem(port_bench.SHARDED_CONFIGS, "reference", cut)
    got = port_bench.bench_sharded("kernel", device="cpu")
    ref = port_bench.bench_sharded("reference", device="cpu")
    assert got["parity_with_single_device"] is True
    assert got["fallback_ticks"] == 0 and got["fast_ticks"] > 0
    assert got["halo_smaller_than_allgather"]
    for k in ("parity_with_single_device", "fallback_ticks", "fast_ticks",
              "shard_migrations", "halo_bytes_per_tick",
              "allgather_equiv_bytes_per_tick"):
        assert got[k] == ref[k], k
    assert got["backend"] == "kernel" and ref["backend"] == "reference"


# --- --fused and --pinned-floor ---------------------------------------------


def test_bench_fused_on_cpu(knobs):
    from goworld_tpu_torch.entity import entity_manager as tem

    knobs(BENCH_FUSED_N=256, BENCH_FUSED_STEPS=3)
    try:
        got = port_bench.bench_fused(device="cpu")
    finally:
        tem.cleanup_for_tests()
    assert (got["entities"], got["steps"]) == (256, 3)
    assert got["fused_hook_never_traced"] is True
    assert (got["unfused"]["hook_jit_traces"],
            got["fused"]["hook_jit_traces"]) == (1, 0)
    assert (got["backend"], got["device"], got["platform"]) == (
        "reference", "cpu", "cpu")


@pytest.mark.slow
def test_bench_fused_matches_root(root_bench, knobs):
    """~25 s on one core, ~21 of them the JAX runtime's compiles."""
    from goworld_tpu.entity import entity_manager as jem
    from goworld_tpu_torch.entity import entity_manager as tem

    knobs(BENCH_FUSED_N=256, BENCH_FUSED_STEPS=3)
    try:
        want = root_bench.bench_fused()
        got = port_bench.bench_fused(device="cpu")
    finally:
        jem.cleanup_for_tests()
        tem.cleanup_for_tests()
    for k in ("metric", "entities", "steps", "fused_hook_never_traced"):
        assert got[k] == want[k], k
    for run in ("unfused", "fused"):
        assert got[run]["hook_jit_traces"] == want[run]["hook_jit_traces"]
        assert set(got[run]) == set(want[run])
    assert got["fused_hook_never_traced"] is True
    assert (got["unfused"]["hook_jit_traces"], got["backend"],
            got["device"]) == (1, "reference", "cpu")
    assert set(got) == set(want) | {"backend", "device"}


def test_bench_pinned_floor_matches_root(root_bench, monkeypatch):
    cut = dict(root_bench.PINNED_FLOOR_CONFIG, steps=2, repeats=2)
    monkeypatch.setattr(root_bench, "PINNED_FLOOR_CONFIG", cut)
    monkeypatch.setattr(port_bench, "PINNED_FLOOR_CONFIG", cut)
    want = root_bench.bench_pinned_floor()
    got = port_bench.bench_pinned_floor(device="cpu")
    assert got["config"] == want["config"] == cut
    assert got["value"] > 0 and len(got["runs"]) == 2
    assert got["steady_state_retraces"] == 0 and got["floor_file"] is None
    assert set(got) == set(want) | {"backend", "device"}


# --- the phase profile -------------------------------------------------------


def test_phase_profile_counts_the_jax_steps_enters():
    n, cell, grid = 512, 100.0, 8
    got = port_bench.bench_phase_profile(n=n, cell=cell, grid=grid,
                                         device="cpu")
    assert set(got) == PHASE_KEYS
    assert all(got[k] > 0 for k in PHASE_KEYS)
    # The same world: enters of the step from ppos to pos.
    rng = np.random.default_rng(0)
    pos = rng.uniform(0, grid * cell, (n, 2)).astype(np.float32)
    ppos = pos + rng.normal(0, 3, (n, 2)).astype(np.float32)
    eng = jn.NeighborEngine(jn.NeighborParams(
        capacity=n, cell_size=cell, grid_x=grid, grid_z=grid, space_slots=1,
        cell_capacity=128, max_events=131072), backend="jnp")
    eng.reset()
    act = np.ones(n, bool)
    spc = np.zeros(n, np.int32)
    rad = np.full(n, 100.0, np.float32)
    eng.step(ppos, act, spc, rad)
    enters, _, _ = eng.step(pos, act, spc, rad)
    assert got["events_in_mask"] == len(enters) > 0


# --- the default run ----------------------------------------------------------


def test_default_run_on_cpu_is_the_roots_cpu_branch(root_bench, knobs,
                                                    monkeypatch):
    knobs(BENCH_N=512, BENCH_STEPS=2, BENCH_SYNC_STEPS=2,
          BENCH_PLATFORM="cpu")
    monkeypatch.setattr(sys, "argv", ["bench.py"])
    _, root_lines = lines_of(root_bench._run_bench)
    rc, lines = lines_of(port_bench.main, ["--device", "cpu"])
    assert rc == 0
    want, got = json.loads(root_lines[-2]), json.loads(lines[-2])
    # The root's probe diagnostics and its jax backend have no counterpart.
    root_keys = set(want) - {"actual_backend", "platform_forced"}
    assert set(got) == root_keys | {"backend", "device"}
    assert set(got["configs"]) == set(want["configs"])
    assert got["configs"]["boids_50k"]["skipped"]
    assert "error" not in got and "error" not in got["configs"][
        "multispace_32"]
    assert got["metric"] == want["metric"] == "aoi_entity_updates_per_sec_100k"
    assert got["configs"]["multispace_32"]["spaces"] == 32
    assert (got["platform"], got["backend"], got["device"]) == (
        "cpu", "reference", "cpu")
    # The compact headline comes last.
    assert json.loads(lines[-1]) == port_bench.headline_of(got)
    assert set(json.loads(lines[-1])) == (
        set(json.loads(root_lines[-1])) - {"actual_backend"}
    ) | {"backend", "device"}


def card_branch(knobs, n, agents):
    """The card's branch of the ``all`` run on the CPU (``BENCH_REHEARSAL``)
    at ``n`` entities and ``agents`` boids, every step knob at 2."""
    knobs(BENCH_N=n, BENCH_STEPS=2, BENCH_SYNC_STEPS=2,
          BENCH_SWEEP_STEPS=2, BENCH_BOIDS_N=agents, BENCH_BOIDS_STEPS=2,
          BENCH_BOIDS_SWEEP_STEPS=2, BENCH_REHEARSAL=1)
    rc, lines = lines_of(port_bench.main, ["--device", "cpu"])
    assert rc == 0
    return json.loads(lines[-2]), json.loads(lines[-1])


def hold_card_branch(root_bench, result, headline):
    configs = result["configs"]
    assert set(configs) == {"multispace_32", "unity_200", "synthetic_10k",
                            "boids_50k", "cell_sweep", "events_sweep",
                            "drain_sweep", "self_tune", "pod_1m"}
    assert set(configs["cell_sweep"]) == {
        f"cell_{int(c)}" for c, _ in root_bench.CELL_SWEEP}
    assert set(configs["events_sweep"]) == {
        f"max_events_{me}" for me in root_bench.EVENTS_SWEEP}
    assert set(configs["drain_sweep"]) == {
        f"drain_{dm}" for dm in root_bench.DRAIN_SWEEP}
    for name in ("cell_sweep", "events_sweep", "drain_sweep"):
        for point in configs[name].values():
            assert "error" not in point and point["updates_per_sec"] > 0
    assert set(configs["boids_50k"]["cell_sweep"]) == {
        f"cell_{int(c)}" for c in root_bench.BOIDS_CELL_SWEEP}
    for name in ("multispace_32", "synthetic_10k", "boids_50k"):
        assert "error" not in configs[name] and configs[name]["value"] > 0
    assert set(result["phases"]) == PHASE_KEYS
    assert "skipped" in configs["self_tune"]  # off the canonical size
    assert configs["unity_200"]["covered_by"] and configs["pod_1m"][
        "covered_by"]
    assert result["rehearsal"] is True and "error" not in result
    assert headline == port_bench.headline_of(result)


def test_default_run_card_branch_on_cpu(root_bench, knobs, monkeypatch):
    """Every config and sweep point of the card's branch, at 256 entities.
    ``synthetic_10k`` runs at ``BENCH_N`` here too (its 10,240 entities
    cost ~20 s on the CPU's plain versions); the slow test below runs the
    branch at 1,024 entities and ``synthetic_10k`` whole (~40 s)."""
    bench_aoi = port_bench.bench_aoi

    def capped(n=None, **kw):
        return bench_aoi(n=None if n is None else min(n, 256), **kw)

    monkeypatch.setattr(port_bench, "bench_aoi", capped)
    result, headline = card_branch(knobs, 256, 200)
    hold_card_branch(root_bench, result, headline)


@pytest.mark.slow
def test_default_run_card_branch_on_cpu_whole(root_bench, knobs):
    result, headline = card_branch(knobs, 1024, 800)
    hold_card_branch(root_bench, result, headline)
    assert result["configs"]["synthetic_10k"]["entities"] == 10240


def test_modes_without_a_card_fail_in_their_line(knobs, monkeypatch):
    """No ``--device``: the card, and here there is none. Each mode's line
    carries ``error``; nothing runs on the CPU in its place."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    knobs(BENCH_MODE="aoi")
    for argv in ([], ["--sharded"], ["--fused"], ["--pinned-floor"],
                 ["--trace-overhead"]):
        rc, lines = lines_of(port_bench.main, argv)
        assert rc == 0
        assert "no CUDA device" in json.loads(lines[0])["error"], argv
        assert "value" in json.loads(lines[-1])


def test_history_dir_writes_the_bench_ring(tmp_path, knobs):
    rc, lines = lines_of(port_bench.main, [
        "--list-scenarios", "--device", "cpu", "--history-dir",
        str(tmp_path)])
    assert rc == 0 and lines
    frames, torn = history.read_frames(str(tmp_path / "bench"))
    assert torn == 0 and frames
    assert frames[-1]["process"] == "bench" and frames[-1]["final"] is True
    assert history.active_writer() is None
    # The event kernel's launches by form, the wrapper's own counts, ride
    # every frame.
    launched = frames[-1]["gauges"]["event_kernel_launches"]
    assert {labels["form"]: n for labels, n in launched} == {
        form: float(n) for form, n in event_kernel.launches.items()}
