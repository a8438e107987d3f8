"""The port's chaos harness and its torch profiler route.

``tests/test_chaos.py``'s scenarios on the port's in-process cluster
(``goworld_tpu_torch.chaos``: the port's dispatchers, game and gate over
localhost, strict bots of the port's client), with the same assertions and
the same ``slow`` marks; the dispatcher kill+restart runs over both cluster
transports, as the JAX tests run it. The cluster's game runs ``[aoi]
backend = xzlist``, as the JAX harness's does, so nothing here needs the
card. Then ``/profile?mode=torch`` of the port's debug server on the CPU:
a Chrome trace that loads, and ``mode=jax`` refused.

Both packages keep their runtimes in module globals; every test starts and
ends with both clean (as ``tests/test_torch_game.py`` does).
"""

from __future__ import annotations

import asyncio
import importlib
import json
import os

import pytest

from goworld_tpu_torch.chaos import (
    ChaosCluster,
    scenario_battle_royale_freeze_restore,
    scenario_battle_royale_keyframe_storm,
    scenario_battle_royale_kill_game,
    scenario_dispatcher_restart,
    scenario_game_kill_recreate,
    scenario_gate_kill_reconnect,
    scenario_paused_dispatcher,
    scenario_service_outage_dispatcher_restart,
    scenario_severed_link,
    scenario_storage_outage,
)

pytestmark = pytest.mark.chaos

FAST_STORAGE = dict(
    retry_base_interval=0.05, retry_max_interval=0.2,
    circuit_failure_threshold=3, circuit_cooldown=0.3,
)


def _clean(root: str) -> None:
    def m(name):
        return importlib.import_module(f"{root}.{name}")

    m("entity.entity_manager").cleanup_for_tests()
    m("kvreg").clear_for_tests()
    m("storage").set_backend(None)
    m("kvdb").set_backend(None)
    m("utils.post").clear()


@pytest.fixture(autouse=True)
def clean_runtimes():
    for root in ("goworld_tpu", "goworld_tpu_torch"):
        _clean(root)
    yield
    for root in ("goworld_tpu", "goworld_tpu_torch"):
        _clean(root)


def _run(scenario_fn, n_dispatchers=2, n_bots=12, **cluster_kw):
    async def run():
        cluster = ChaosCluster(
            cluster_kw.pop("run_dir"), n_dispatchers=n_dispatchers,
            n_bots=n_bots, storage_knobs=FAST_STORAGE, **cluster_kw)
        await cluster.start()
        try:
            return await scenario_fn(cluster)
        finally:
            await cluster.stop()

    return asyncio.run(run())


@pytest.mark.parametrize("transport", ["tcp", "uds"])
def test_dispatcher_kill_restart_smoke(tmp_path, transport):
    """Kill + restart one dispatcher (of 2) under 12 strict bots: zero bot
    errors, zero dropped packets, pings issued during the outage delivered
    after the reconnect replay, on either cluster transport."""
    r = _run(scenario_dispatcher_restart, run_dir=str(tmp_path),
             transport=transport)
    assert r["bot_errors"] == 0
    assert r["dropped"] == 0
    assert r["recovery_s"] < 10.0


def test_severed_link_recovers(tmp_path):
    r = _run(scenario_severed_link, run_dir=str(tmp_path))
    assert r["bot_errors"] == 0
    assert r["dropped"] == 0
    assert r["recovery_s"] < 10.0


def test_paused_dispatcher_liveness_kill(tmp_path):
    r = _run(scenario_paused_dispatcher, run_dir=str(tmp_path),
             peer_heartbeat_timeout=0.6)
    assert r["bot_errors"] == 0
    assert r["detect_s"] < 5.0


def test_game_kill_recreate(tmp_path):
    r = _run(scenario_game_kill_recreate, run_dir=str(tmp_path))
    assert r["bot_errors"] == 0
    assert r["recovery_s"] < 20.0


def test_gate_kill_reconnect(tmp_path):
    r = _run(scenario_gate_kill_reconnect, run_dir=str(tmp_path))
    assert r["bot_errors"] == 0
    assert r["recovery_s"] < 20.0


@pytest.mark.slow
def test_migrate_during_dispatcher_restart_uds(tmp_path):
    from goworld_tpu_torch.chaos.multigame import run_multigame

    r = run_multigame(str(tmp_path), n_bots=12, transport="uds",
                      with_restart_phase=True)
    assert r["bot_errors"] == 0
    assert r["zero_loss"] is True
    phase = r["dispatcher_restart_phase"]
    assert phase["zero_loss"] is True
    assert phase["bot_errors"] == 0
    assert (phase["migrations_done"]
            + phase["migrations_rolled_back"]) >= 0


def test_battle_royale_kill_game(tmp_path):
    r = _run(scenario_battle_royale_kill_game, run_dir=str(tmp_path))
    assert r["bot_errors"] == 0
    assert r["recovery_s"] < 20.0
    assert r["endgame_edges"] == 12 * 11
    assert r["cluster_view_converge_s"] < 20.0


def test_battle_royale_freeze_restore(tmp_path):
    r = _run(scenario_battle_royale_freeze_restore, run_dir=str(tmp_path))
    assert r["bot_errors"] == 0
    assert r["recovery_s"] < 20.0
    assert r["endgame_edges"] == 12 * 11
    assert r["cluster_view_converge_s"] < 20.0


def test_storage_outage_circuit(tmp_path):
    r = _run(scenario_storage_outage, run_dir=str(tmp_path))
    assert r["lost_saves"] == 0
    assert r["recovery_s"] < 10.0


def test_battle_royale_keyframe_storm(tmp_path):
    r = _run(scenario_battle_royale_keyframe_storm, run_dir=str(tmp_path),
             sync_knobs=dict(tier_cadences=(1, 4), quantize_bits=7))
    assert r["bot_errors"] == 0
    assert r["waves"] == 2
    for kf in r["keyframes_per_wave"]:
        assert kf >= r["edges_per_wave"]


def test_service_outage_under_dispatcher_restart(tmp_path):
    r = _run(scenario_service_outage_dispatcher_restart,
             run_dir=str(tmp_path))
    assert r["bot_errors"] == 0
    assert r["lost_saves"] == 0
    assert r["failed_writes"] >= 3
    assert r["recovery_s"] < 15.0


def test_multigame_spaces_kill_crosses(tmp_path):
    """The 3-game whole-space run on the port's game processes
    (``goworld_tpu_torch.chaos.game_proc``): the three kill crosses, census
    conserved, zero strict-bot errors, the planner shard re-claimed."""
    from goworld_tpu_torch.chaos.multigame import run_multigame_spaces

    r = run_multigame_spaces(str(tmp_path), n_bots=12, n_games=3,
                             transport="tcp")
    assert r["bot_errors"] == 0
    assert r["zero_loss"] is True
    phases = r["phases"]
    assert set(phases) == {"kill_receiver_mid_prepare",
                           "kill_donor_mid_commit", "kill_planner_host"}
    for name, p in phases.items():
        assert p["bot_errors"] == 0, name
        assert p["zero_loss"] is True, name
    assert phases["kill_receiver_mid_prepare"]["donor_outcomes_failed"] >= 1
    assert phases["kill_donor_mid_commit"]["moved_members"] > 0
    ph = phases["kill_planner_host"]
    assert ph["new_host"] != ph["old_host"]
    assert ph["new_host_gauge"] == 1.0
    assert sum(r["census_final"]) == 12


@pytest.mark.slow
def test_full_chaos_soak(tmp_path):
    async def run():
        cluster = ChaosCluster(str(tmp_path), n_dispatchers=3, n_bots=16,
                               storage_knobs=FAST_STORAGE)
        await cluster.start()
        try:
            results = [
                await scenario_dispatcher_restart(cluster, victim=1),
                await scenario_severed_link(cluster, victim=2),
                await scenario_paused_dispatcher(cluster, victim=0),
                await scenario_storage_outage(cluster),
                await scenario_dispatcher_restart(cluster, victim=0),
            ]
        finally:
            await cluster.stop()
        return results

    results = asyncio.run(run())
    assert len(results) == 5
    assert all(r.get("bot_errors", 0) == 0 for r in results)


# --- /profile?mode=torch -------------------------------------------------------


async def _get(port: int, path: str) -> tuple[int, bytes]:
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(f"GET {path} HTTP/1.1\r\nHost: x\r\n\r\n".encode())
    await writer.drain()
    raw = await reader.read()
    writer.close()
    head, _, body = raw.partition(b"\r\n\r\n")
    return int(head.split()[1]), body


def _serve_and_get(paths):
    """Start the port's debug server on a free loopback port, keep the loop
    busy with small torch work (a stand-in for a game's ticks), and GET
    each path in turn."""
    import torch

    from goworld_tpu_torch.utils.debug_http import DebugHTTPServer

    async def run():
        server = DebugHTTPServer("127.0.0.1", 0)
        await server.start()
        port = server.port
        stop = asyncio.Event()

        async def ticks():
            a = torch.ones(64, 64)
            while not stop.is_set():
                a = torch.tanh(a @ a / 64.0)
                await asyncio.sleep(0.01)

        work = asyncio.get_running_loop().create_task(ticks())
        try:
            return [await _get(port, p) for p in paths]
        finally:
            stop.set()
            await work
            await server.stop()

    return asyncio.run(run())


def test_profile_torch_route_writes_a_chrome_trace():
    (status, body), = _serve_and_get(["/profile?mode=torch&seconds=0.5"])
    assert status == 200, body
    answer = json.loads(body)
    assert answer["seconds"] == 0.5
    assert answer["cuda"] is False  # this process never used a card
    assert answer["device_kernels"] == 0
    assert os.path.dirname(answer["trace"]) == answer["trace_dir"]
    with open(answer["trace"]) as f:
        trace = json.load(f)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "aten::tanh" in names  # the loop's work inside the window


def test_profile_jax_mode_is_refused_naming_torch():
    (status, body), = _serve_and_get(["/profile?mode=jax&seconds=0.1"])
    assert status == 400
    assert "mode=torch" in json.loads(body)["error"]
