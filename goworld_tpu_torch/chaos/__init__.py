"""Fault-injection (chaos) harness.

Drives a REAL in-process cluster — N dispatchers + one game + one gate over
localhost TCP or unix sockets, with strict protocol bots — while injecting
the faults the resilience layer exists for: dispatcher crash + restart,
mid-tick link severing (socket abort, not clean close), a process stalled
past the heartbeat deadline, a storage backend failing N writes, a GAME
crash + cold recreate, and a GATE crash + client reconnect wave. Scenarios
assert zero bot errors, zero entity loss, and recovery within a deadline.

The seventh scenario — migrate-during-dispatcher-restart — needs two real
game processes (the entity manager is per-process state) and lives in the
subprocess-backed multigame harness (``chaos/multigame.py``), which also
carries the ``bench.py --multigame`` rebalance floor.

Entry points: the scenario coroutines here (used by tests/test_chaos.py)
and ``bench.py --chaos`` (one compact JSON headline like the other bench
modes).
"""

from goworld_tpu_torch.chaos.harness import (  # noqa: F401
    ChaosCluster,
    FlakyBackend,
    dropped_packet_count,
    run_chaos,
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
