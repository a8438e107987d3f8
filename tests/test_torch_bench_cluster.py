"""The port bench's cluster modes against the repo's root ``bench.py``.

The fan-outs run as a user runs them, each package's in a fresh process
(the modes read process-global counters and the entity manager, which an
earlier run in the same interpreter would leak into). Their throughput is
measured, not compared: only the fields the fixed config decides are held
equal, and no floor is read. ``--trace-overhead`` and the multigame
wrappers run with their inner calls stubbed in both packages, which
checks the lines' structure and value formulas; the real
``run_multigame_spaces`` runs in ``tests/test_torch_chaos.py``. Every test
has a time limit of its own (``time_limit``), and every subprocess too.
"""

from __future__ import annotations

import contextlib
import functools
import importlib.util
import io
import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import pytest

from goworld_tpu.chaos import multigame as jmultigame
from goworld_tpu.telemetry import tracing as jtracing
from goworld_tpu_torch import bench as port_bench
from goworld_tpu_torch.chaos import multigame as tmultigame
from goworld_tpu_torch.telemetry import tracing as ttracing

ROOT = Path(__file__).resolve().parent.parent

# The keys the port adds to every line of the root bench.
PORT_KEYS = {"backend", "device"}

# flag -> (the root's function name, metric, unit), as the root bench's
# flag table has them.
MODES = {
    "--fanout": ("bench_fanout", "fanout_sync_records_per_sec",
                 "sync-records/sec"),
    "--fanout-multi": ("bench_fanout_multi",
                       "fanout_multi_sync_records_per_sec",
                       "sync-records/sec"),
    "--fanout-massive": ("bench_fanout_massive",
                         "fanout_massive_sync_records_per_sec",
                         "sync-records/sec"),
    "--trace-overhead": ("bench_trace_overhead",
                         "trace_overhead_sync_records_per_sec",
                         "sync-records/sec"),
    "--multigame": ("bench_multigame",
                    "multigame_rebalance_entities_per_sec", "entities/sec"),
    "--multigame-spaces": ("bench_multigame_spaces",
                           "multigame_space_kill_crosses_passed",
                           "scenarios"),
}


class TimeLimit(Exception):
    pass


def time_limit(seconds: int):
    """The test fails with ``TimeLimit`` after ``seconds`` of wall time
    (SIGALRM: pytest and its workers run tests on the main thread)."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            def expire(signum, frame):
                raise TimeLimit(f"{fn.__name__} ran past {seconds} s")

            old = signal.signal(signal.SIGALRM, expire)
            signal.alarm(seconds)
            try:
                return fn(*args, **kwargs)
            finally:
                signal.alarm(0)
                signal.signal(signal.SIGALRM, old)
        return run
    return wrap


@pytest.fixture(scope="module")
def root_bench():
    spec = importlib.util.spec_from_file_location("root_bench_cluster",
                                                  ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def root_mode(flag: str) -> subprocess.Popen:
    """``python bench.py <flag>`` from the repo's root, started."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("BENCH_TRACE_SAMPLE_RATE", None)
    return subprocess.Popen(
        [sys.executable, str(ROOT / "bench.py"), flag], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)


def last_line(proc: subprocess.Popen, timeout: float) -> dict:
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    assert proc.returncode == 0, out[-2000:]
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("name", [
    "FANOUT_CONFIG", "FANOUT_MULTI_CONFIG", "FANOUT_HOPS",
    "FANOUT_MASSIVE_CONFIG", "TRACE_OVERHEAD_RATES", "MULTIGAME_CONFIG",
    "MULTIGAME_SPACES_CONFIG"])
@time_limit(60)
def test_fixed_config_is_the_roots(root_bench, name):
    assert getattr(port_bench, name) == getattr(root_bench, name)


@pytest.mark.parametrize("flag", ["--fanout", "--fanout-multi"])
@time_limit(300)
def test_fanout_matches_root_in_fresh_processes(root_bench, flag):
    """Both packages' fan-out, side by side, each in its own process: the
    same metric, unit, clients, gates, config, sync path, slab slots and
    hops; the root's keys plus ``backend`` and ``device``; a value above 0
    in each."""
    root_proc = root_mode(flag)
    try:
        port = port_bench._fanout_tier1_env(flag=flag, timeout=240)
    finally:
        root = last_line(root_proc, 240)
    for line in (root, port):
        assert line.get("error") is None, line
        assert line["value"] > 0, line
    assert set(port) == set(root) | PORT_KEYS
    for k in ("metric", "unit", "clients", "gates", "config", "sync_path",
              "slab_entities"):
        assert port[k] == root[k], k
    assert port["metric"] == MODES[flag][1]
    assert (list(port["hop_busy_ms"]) == list(root["hop_busy_ms"])
            == list(port["hop_shares"]) == list(port_bench.FANOUT_HOPS))
    assert port["backend"] == "xzlist" and port["device"] == "cpu"
    assert port["steady_state_retraces"] == 0
    assert port["floor_file"] is None


@time_limit(420)
def test_fanout_massive_holds_the_roots_gate():
    """``--fanout-massive`` of the port in a fresh process, against the
    conditions of the root's gate (tests/test_telemetry.py) without its
    floor: 1,008 clients on 2 gates, no bot error, no retrace, tiered bytes
    a client a second at least 3x below the full phase's, and the storm's
    census conserved with no bot error."""
    result = port_bench._fanout_tier1_env(flag="--fanout-massive",
                                          timeout=360)
    assert result.get("error") is None, result
    assert result["metric"] == MODES["--fanout-massive"][1]
    assert result["clients"] >= 1000
    assert result["gates"] >= 2
    assert result["bot_errors"] == 0, result.get("bot_error_samples")
    assert result["steady_state_retraces"] == 0
    assert result["bytes_reduction"] >= 3.0, (
        result["bytes_per_client_s"],
        result["full_equiv_bytes_per_client_s"])
    storm = result["reconnect_storm"]
    assert storm["bot_errors"] == 0, storm
    assert storm["census_clients"] == result["clients"]
    assert result["value"] > 0
    assert (result["backend"], result["device"]) == ("xzlist", "cpu")


def stub_trace_overhead(bench, tracing, monkeypatch, seen, fail_at=None):
    """The inner calls of ``bench_trace_overhead`` replaced: each returns
    numbers made from the sampling rate in force when it is called."""
    def pinned(device=None):
        rate = tracing.sample_rate()
        seen.append(("pinned", rate, device))
        return {"value": 1000.0 + rate, "backend": "reference",
                "device": "cpu"}

    def fanout(trace_sample_rate=None, config=None):
        rate = tracing.sample_rate()
        seen.append(("fanout", rate, trace_sample_rate))
        if rate == fail_at:
            raise RuntimeError("fan-out failed")
        value = {0: 500.0, 1024: 480.0, 1: 300.0}[rate]
        return {"value": value, "runs": [value - 1.0, value]}

    monkeypatch.setattr(bench, "bench_pinned_floor", pinned)
    monkeypatch.setattr(bench, "bench_fanout", fanout)


@time_limit(60)
def test_trace_overhead_structure_and_value_match_root(root_bench,
                                                       monkeypatch):
    """Both packages' ``bench_trace_overhead`` over stubbed inner calls:
    each rate configured in turn before its runs, the same rates, values
    and cost, the root's keys plus ``backend`` and ``device`` at the top
    and in every rate, and the caller's sampling rate restored."""
    out = {}
    for name, bench, tracing in (("root", root_bench, jtracing),
                                 ("port", port_bench, ttracing)):
        seen = []
        stub_trace_overhead(bench, tracing, monkeypatch, seen)
        saved = tracing.sample_rate()
        tracing.configure(sample_rate=7)
        try:
            kw = {"device": "cpu"} if name == "port" else {}
            out[name] = bench.bench_trace_overhead(**kw)
            assert tracing.sample_rate() == 7
        finally:
            tracing.configure(sample_rate=saved)
        assert [s[:2] for s in seen] == [
            (kind, rate) for rate in port_bench.TRACE_OVERHEAD_RATES
            for kind in ("pinned", "fanout")]
        assert [s[2] for s in seen if s[0] == "fanout"] == list(
            port_bench.TRACE_OVERHEAD_RATES)
    root, port = out["root"], out["port"]
    assert set(port) == set(root) | PORT_KEYS
    for k in ("metric", "unit", "value", "full_sampling_cost_pct"):
        assert port[k] == root[k], k
    assert port["value"] == 500.0
    assert port["full_sampling_cost_pct"] == 40.0
    assert list(port["rates"]) == list(root["rates"]) == ["off", "1/1024",
                                                          "1/1"]
    for key, entry in port["rates"].items():
        assert set(entry) == set(root["rates"][key]) | PORT_KEYS
        assert {k: entry[k] for k in root["rates"][key]} == \
            root["rates"][key]
        assert (entry["backend"], entry["device"]) == ("reference", "cpu")
    assert (port["backend"], port["device"], port["platform"]) == (
        "reference", "cpu", "cpu")


@pytest.mark.parametrize("package", ["root", "port"])
@time_limit(60)
def test_trace_overhead_restores_the_rate_when_a_run_fails(
        root_bench, monkeypatch, package):
    bench, tracing = ((root_bench, jtracing) if package == "root"
                      else (port_bench, ttracing))
    seen = []
    stub_trace_overhead(bench, tracing, monkeypatch, seen, fail_at=1024)
    saved = tracing.sample_rate()
    tracing.configure(sample_rate=7)
    try:
        kw = {"device": "cpu"} if package == "port" else {}
        with pytest.raises(RuntimeError, match="fan-out failed"):
            bench.bench_trace_overhead(**kw)
        assert tracing.sample_rate() == 7
    finally:
        tracing.configure(sample_rate=saved)


MULTIGAME = {
    "convergence_s": 1.5, "census": [6, 6], "migrations_done": 7,
    "migrations_rolled_back": 0, "zero_loss": True, "bot_errors": 0,
    "dispatcher_restart_phase": {"scenario": "x", "zero_loss": True},
}
MULTIGAME_SPACES = {"phases": {
    "receiver_mid_prepare": {"zero_loss": True, "bot_errors": 0},
    "donor_mid_commit": {"zero_loss": True, "bot_errors": 2},
    "planner_host": {"zero_loss": False, "bot_errors": 0},
    "extra": {"zero_loss": True},
}}


@pytest.mark.parametrize("mode", ["multigame", "multigame_spaces"])
@time_limit(60)
def test_multigame_wrappers_match_root(root_bench, monkeypatch, mode):
    """Both packages' wrappers over a stubbed harness: the harness called
    with the fixed config, the root's value formula (entities moved a
    second of convergence; crosses with zero loss and no bot error), and
    the root's line plus ``backend`` and ``device``."""
    out = {}
    for name, bench, harness in (("root", root_bench, jmultigame),
                                 ("port", port_bench, tmultigame)):
        calls = []
        if mode == "multigame":
            def fake(run_dir, n_bots=12, transport="tcp",
                     with_restart_phase=True):
                calls.append((n_bots, transport, with_restart_phase))
                return json.loads(json.dumps(MULTIGAME))
            monkeypatch.setattr(harness, "run_multigame", fake)
            out[name] = bench.bench_multigame()
            assert calls == [(12, "tcp", True)]
        else:
            def fake(run_dir, n_bots=12, n_games=3, transport="tcp"):
                calls.append((n_bots, n_games, transport))
                return json.loads(json.dumps(MULTIGAME_SPACES))
            monkeypatch.setattr(harness, "run_multigame_spaces", fake)
            out[name] = bench.bench_multigame_spaces()
            assert calls == [(12, 3, "tcp")]
    root, port = out["root"], out["port"]
    assert set(port) == set(root) | PORT_KEYS
    diff = {k for k in root if port[k] != root[k]}
    assert diff <= {"floor_file"}
    if "floor_file" in root:
        assert port["floor_file"] is None
    assert (port["backend"], port["device"]) == ("xzlist", "cpu")
    if mode == "multigame":
        assert port["value"] == round(7 / 1.5, 2) == port["runs"][0]
    else:
        # receiver_mid_prepare, and extra (no bot_errors key).
        assert port["value"] == 2.0


@pytest.mark.parametrize("flag", list(MODES))
@time_limit(60)
def test_mode_that_raises_prints_the_roots_error_line(root_bench,
                                                      monkeypatch, flag):
    """A mode that raises prints one line, rc 0: the root's metric and unit
    for its flag, value 0.0, and the exception in ``error``."""
    fn_name = MODES[flag][0]

    def boom(*args, **kwargs):
        raise RuntimeError(f"{fn_name} raised")

    lines = {}
    for name, bench in (("root", root_bench), ("port", port_bench)):
        monkeypatch.setattr(bench, fn_name, boom)
        monkeypatch.setattr(sys, "argv", ["bench.py", flag])
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = (bench._run_bench() if name == "root"
                  else bench.main([flag]))
        assert rc == 0
        out = buf.getvalue().strip().splitlines()
        assert len(out) == 1, out
        lines[name] = json.loads(out[0])
    for line in lines.values():
        assert (line["metric"], line["value"], line["unit"]) == (
            MODES[flag][1], 0.0, MODES[flag][2])
        assert f"RuntimeError: {fn_name} raised" in line["error"]
    assert set(lines["port"]) == set(lines["root"])
