"""The port's scenario matrix against the JAX package's.

The same registry, the same seeded worlds tick for tick, and the same
``invariants`` from ``run_scenario``: the port's batched engine on the CPU
(the reference backend, and the event kernel's plain versions with
``backend="kernel"``) against the JAX runner's batched engine, and the
port's 8-strip engine on ``make_mesh(8, "cpu")`` against the JAX strip
engine on conftest's 8 CPU devices. Every ``invariants`` field is compared
exactly: both engines compute the exact interest set each tick, so event
totals, census and density facts agree field for field. Then the runner's
gates on the port: the one-launch pin on both engines (and a wrapper that
dispatches twice in a tick trips it), the interest oracle, the SLO gate,
and ``python -m goworld_tpu_torch.bench``'s scenario modes.

Runs are cut as ``tests/test_scenarios.py`` cuts them (``_TICKS_SCALE``;
``hotspot`` needs all of its 0.5 for its endgame crowd and its fallback),
and both packages' runners time one measure pass where the registry asks
for best of ``repeats`` (``invariants`` come from the verify pass; the
one-launch pin counts the pass that runs). Each run is made once and
shared. The gates that need a run of their own use a small battle-royale
world (``TINY``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import goworld_tpu.scenarios as jax_scenarios
import goworld_tpu_torch.scenarios as port_scenarios
from goworld_tpu.scenarios import runner as jax_runner
from goworld_tpu_torch import bench as port_bench
from goworld_tpu_torch.ops import neighbor
from goworld_tpu_torch.parallel import spatial
from goworld_tpu_torch.config.read_config import SLOConfig
from goworld_tpu_torch.scenarios import ScenarioInvariantError
from goworld_tpu_torch.scenarios import runner
from goworld_tpu_torch.scenarios.battle_royale import BattleRoyaleWorld
from goworld_tpu_torch.telemetry.slo import SLOViolation

ROOT = Path(__file__).resolve().parent.parent
NAMES = ("battle_royale", "hotspot", "service_heavy")
# tests/test_scenarios.py's cuts: hotspot needs its endgame crowd and
# service_heavy the ticks after its outage, so both stop at 0.5.
_TICKS_SCALE = {"battle_royale": 0.25, "hotspot": 0.5, "service_heavy": 0.5}

# A small battle-royale world for the gates that need a run of their own;
# its geometry fits the 8-strip engine (512 % 64 == 0, 4096 % 8 == 0,
# 32 >= 4 * 8).
TINY = port_scenarios.ScenarioSpec(
    name="tiny_royale", description="a small battle royale",
    config={"n": 256, "capacity": 512, "cell_size": 100.0, "grid": 32,
            "space_slots": 1, "cell_capacity": 64, "max_events": 4096,
            "shards": 8, "ticks": 8, "radius": 100.0, "repeats": 1,
            "seed": 16},
    factory=BattleRoyaleWorld,
)

# Torch threads a test process uses: the suite runs files in parallel
# worker processes, and torch's default of one thread a core in each of
# them oversubscribes the host (runs here took 10-40x longer so).
THREADS = 2

_runs: dict = {}


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(threads)


def _one_repeat(get_scenario):
    def get(name):
        spec = get_scenario(name)
        return dataclasses.replace(spec, config=dict(spec.config, repeats=1))
    return get


@pytest.fixture(autouse=True, scope="module")
def one_measure_pass():
    """Both runners time one measure pass (module-scoped: the runs are
    shared across the file's tests)."""
    saved = runner.get_scenario, jax_runner.get_scenario
    runner.get_scenario = _one_repeat(saved[0])
    jax_runner.get_scenario = _one_repeat(saved[1])
    yield
    runner.get_scenario, jax_runner.get_scenario = saved


def _once(key, fn):
    if key not in _runs:
        _runs[key] = fn()
    return _runs[key]


def jax_run(name, engine):
    return _once(("jax", name, engine), lambda: jax_runner.run_scenario(
        name, engine=engine, ticks_scale=_TICKS_SCALE[name]))


def port_run(name, engine, backend):
    if (name, engine, backend) == ("hotspot", "batched", "reference"):
        return bench_hotspot()  # the bench CLI runs exactly this
    return _once(("port", name, engine, backend), lambda: runner.run_scenario(
        name, engine=engine, ticks_scale=_TICKS_SCALE[name], device="cpu",
        backend=backend))


def bench(*args):
    """``python -m goworld_tpu_torch.bench ARGS``: its stdout lines."""
    r = subprocess.run(
        [sys.executable, "-m", "goworld_tpu_torch.bench", *args],
        capture_output=True, text=True, timeout=600, check=True, cwd=ROOT,
        env=dict(os.environ, OMP_NUM_THREADS=str(THREADS)))
    return r.stdout.strip().splitlines()


def bench_hotspot():
    """``bench --scenario hotspot --device cpu`` in this process, its run
    cut as the file's others are."""
    def run():
        run_scenario = runner.run_scenario
        runner.run_scenario = lambda *a, **kw: run_scenario(
            *a, ticks_scale=_TICKS_SCALE["hotspot"], **kw)
        out = io.StringIO()
        try:
            with contextlib.redirect_stdout(out):
                rc = port_bench.main(["--scenario", "hotspot",
                                      "--device", "cpu"])
        finally:
            runner.run_scenario = run_scenario
        lines = out.getvalue().strip().splitlines()
        assert rc == 0 and len(lines) == 1, lines
        return json.loads(lines[0])

    return _once("bench_hotspot", run)


# --- registry and worlds -------------------------------------------------------


def test_registry_equals_jax():
    assert port_scenarios.scenario_names() == NAMES
    assert jax_scenarios.scenario_names() == NAMES
    for name in NAMES:
        port = port_scenarios.get_scenario(name)
        jax = jax_scenarios.get_scenario(name)
        assert dict(port.config) == dict(jax.config)
        assert port.description == jax.description
    with pytest.raises(KeyError, match="battle_royale"):
        port_scenarios.get_scenario("free_for_all")


@pytest.mark.parametrize("name", NAMES)
def test_world_matches_jax_tick_for_tick(name):
    """One seed, both packages: the epoch arrays the engines step, bit for
    bit, after each of the first 8 ticks (and the same meta_dirty)."""
    scale = _TICKS_SCALE[name]
    port = port_scenarios.get_scenario(name).make(ticks_scale=scale)
    jax = jax_scenarios.get_scenario(name).make(ticks_scale=scale)
    port.setup()
    jax.setup()
    try:
        for t in range(1, 9):
            assert port.tick(t) == jax.tick(t), t
            for field in ("pos", "active", "space", "radius"):
                a, b = getattr(port, field), getattr(jax, field)
                assert a.dtype == b.dtype, (t, field)
                assert np.array_equal(a, b), (t, field)
    finally:
        port.teardown()
        jax.teardown()


# --- invariants against the JAX runner ----------------------------------------


@pytest.mark.parametrize("name,backend", [
    ("battle_royale", "reference"), ("hotspot", "reference"),
    ("service_heavy", "reference"), ("hotspot", "kernel"),
    pytest.param("battle_royale", "kernel", marks=pytest.mark.slow),
    pytest.param("service_heavy", "kernel", marks=pytest.mark.slow),
])
def test_batched_invariants_equal_jax(name, backend):
    """The port's batched engine on the CPU gives the JAX batched runner's
    ``invariants`` exactly, on the reference backend and on the event
    kernel's plain versions."""
    port = port_run(name, "batched", backend)
    jax = jax_run(name, "batched")
    assert port["backend"] == backend and port["device"] == "cpu"
    assert port["errors"] == 0
    assert port["invariants"] == jax["invariants"]
    assert port["invariants"]["dropped"] == 0


@pytest.mark.parametrize("name", [
    "hotspot",
    pytest.param("battle_royale", marks=pytest.mark.slow),
    pytest.param("service_heavy", marks=pytest.mark.slow),
])
def test_sharded_invariants_equal_jax(name):
    """The port's 8-strip engine (8 strips on the CPU) against the JAX strip
    engine on 8 CPU devices: the same invariants and the same count of
    exact all-gather fallback ticks; hotspot's crowd must overflow a strip
    on both sides."""
    port = port_run(name, "sharded", "kernel")
    jax = jax_run(name, "sharded")
    assert port["engine"] == "sharded" and port["backend"] == "kernel"
    assert port["invariants"] == jax["invariants"]
    assert port["fallback_ticks"] == jax["fallback_ticks"]
    if name == "hotspot":
        assert port["fallback_ticks"] > 0
        assert jax["fallback_ticks"] > 0


# --- the runner's gates on the port -------------------------------------------


@pytest.mark.parametrize("engine,backend", [
    ("batched", "reference"), ("batched", "kernel"), ("sharded", "kernel"),
])
def test_one_launch_per_tick(engine, backend):
    r = port_run("hotspot", engine, backend)
    assert r["one_launch_per_tick"] is True
    assert r["step_launches"] == r["ticks_dispatched"] > 0
    assert r["steady_state_retraces"] == 0


class DoubleDispatch:
    """An engine that launches its step twice a tick: the second dispatch
    sees the same epoch (so it has no events and the stream stays right),
    which is exactly the hidden extra launch the one-launch pin catches."""

    def __init__(self, eng):
        self.eng = eng

    def __getattr__(self, name):
        return getattr(self.eng, name)

    def step_async(self, *args, **kwargs):
        pending = self.eng.step_async(*args, **kwargs)
        self.eng.step_async(*args, **kwargs).collect()
        return pending


@pytest.fixture
def tiny(monkeypatch):
    monkeypatch.setattr(runner, "get_scenario", lambda name: TINY)


@pytest.mark.parametrize("engine", ["batched", "sharded"])
def test_one_launch_pin_holds_and_catches_a_second_dispatch(
        tiny, monkeypatch, engine):
    r = runner.run_scenario("tiny_royale", engine=engine, device="cpu")
    assert r["step_launches"] == r["ticks_dispatched"] == 8
    make = runner.make_engine
    monkeypatch.setattr(runner, "make_engine",
                        lambda *a, **kw: DoubleDispatch(make(*a, **kw)))
    with pytest.raises(ScenarioInvariantError,
                       match="one-launch pin violated: 8 measured ticks "
                             "dispatched but 15 step launches"):
        runner.run_scenario("tiny_royale", engine=engine, device="cpu")


@pytest.mark.parametrize("engine,module,program", [
    ("batched", neighbor, "_step_packed_tiered"),
    ("sharded", spatial, "_spatial_step_pallas_impl"),
])
def test_one_launch_pin_catches_a_second_program_in_a_dispatch(
        tiny, monkeypatch, engine, module, program):
    """The engines count launches in their step programs, not in
    ``step_async``: one dispatch that runs its program twice trips the
    pin."""
    run = getattr(module, program)

    def twice(*args):
        run(*args)
        return run(*args)

    monkeypatch.setattr(module, program, twice)
    with pytest.raises(ScenarioInvariantError,
                       match="one-launch pin violated: 8 measured ticks "
                             "dispatched but 1[0-9] step launches"):
        runner.run_scenario("tiny_royale", engine=engine, device="cpu")


def test_slo_gate(tiny):
    with pytest.raises(SLOViolation, match="tick_p99.*VIOLATED"):
        runner.run_scenario("tiny_royale", device="cpu",
                            slo=SLOConfig(tick_p99_budget=1e-12))
    headline = runner.run_scenario(
        "tiny_royale", device="cpu",
        slo=SLOConfig(tick_p99_budget=100.0, steady_state_retraces=0))
    verdict = headline["slo"]
    assert verdict["ok"] is True
    assert verdict["budgets"]["tick_p99"]["observed"] > 0
    assert verdict["budgets"]["steady_state_retraces"]["ok"] is True


def test_oracle_rejects_bad_streams():
    ev = lambda *pairs: np.asarray(pairs, np.int64).reshape(-1, 2)  # noqa
    o = runner.InterestOracle(100)
    o.apply(0, ev((1, 2), (2, 1)), ev())
    with pytest.raises(ScenarioInvariantError, match="already interested"):
        o.apply(1, ev((1, 2)), ev())
    with pytest.raises(ScenarioInvariantError, match="never entered"):
        o.apply(1, ev(), ev((3, 4)))
    with pytest.raises(ScenarioInvariantError, match="duplicate enter"):
        o.apply(1, ev((5, 6), (5, 6)), ev())
    active = np.ones(100, bool)
    active[1] = False
    with pytest.raises(ScenarioInvariantError, match="stale interest"):
        o.check_alive(active)
    o.apply(2, ev(), ev((1, 2), (2, 1)))
    o.check_alive(active)


def test_make_engine_rejects_unknown():
    config = dict(port_scenarios.get_scenario("hotspot").config)
    with pytest.raises(ValueError, match="batched | sharded"):
        runner.make_engine(config, "pallas", device="cpu")


# --- the port's bench -----------------------------------------------------------


def test_bench_lists_scenarios():
    rows = [json.loads(line) for line in bench("--list-scenarios",
                                               "--device", "cpu")]
    assert [row["scenario"] for row in rows] == list(NAMES)
    for row in rows:
        assert row["config"] == dict(
            port_scenarios.get_scenario(row["scenario"]).config)
        assert row["backend"] == "reference" and row["device"] == "cpu"


def test_bench_scenario_hotspot_on_cpu():
    r = bench_hotspot()
    assert r["metric"] == "scenario_hotspot_updates_per_sec"
    assert r["backend"] == "reference" and r["device"] == "cpu"
    assert r["engine"] == "batched"
    assert r["value"] > 0 and r["errors"] == 0
    assert r["step_launches"] == r["ticks_dispatched"]
    assert r["invariants"] == jax_run("hotspot", "batched")["invariants"]
