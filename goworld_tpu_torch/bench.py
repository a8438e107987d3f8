"""The port's benchmark: the repo's ``bench.py`` headline and its gate modes
on PyTorch, printed as the same one-line JSON with ``backend`` and
``device`` added.

    python -m goworld_tpu_torch.bench                       # bench_aoi
    python -m goworld_tpu_torch.bench --scenario hotspot [--scenario-engine sharded]
    python -m goworld_tpu_torch.bench --list-scenarios
    python -m goworld_tpu_torch.bench --chaos
    ... [--slo-config goworld.ini] [--device cpu]

- no mode: ``bench_aoi``, the production AOI loop at the headline of
  bench.py's accelerator branch (102,400 entities, one space, 44x44 cells
  of 300, radius 100, cell capacity 128, ``max_events`` 131,072): the
  enter storm off the clock, ``BENCH_STEPS`` pipelined ticks (one blocking
  readback each), then ``BENCH_SYNC_STEPS`` synchronous ones for the
  post-step drain latency. ``BENCH_N`` scales the entities (the grid
  follows, at the same density), ``BENCH_MAX_EVENTS`` the inline budget.
- ``--scenario <name>``: one registered scenario (``scenarios/``) in gate
  mode: the fixed registry config, the verify pass (interest-set oracle
  and per-tick invariants) then the timed measure pass, with the one-launch
  pin. ``--scenario-engine sharded`` runs the strip engine, its strips on
  one device.
- ``--list-scenarios``: one JSON line per registered scenario.
- ``--chaos``: the chaos suite over the port's in-process cluster, once a
  transport (tcp, then uds), plus the migration-during-restart phase on the
  two-game cluster. A gate: any failure or bot error exits 1.
- ``--slo-config <ini>``: the ``[slo]`` budgets that ``--scenario`` and
  ``--chaos`` are judged against.

Everything runs on the CUDA card unless ``--device cpu`` is given; without
a card the AOI modes fail in their JSON line's ``error``. The chaos
cluster's games run ``[aoi] backend = xzlist`` and never touch the card.
The root bench's other modes (``--sharded``, ``--fused``, boids, fanout,
multigame, the floors) are not ported yet (ROADMAP).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

import numpy as np

HEADLINE_BASELINE = 100_000 * 30  # 100k entities @ 30 Hz (BASELINE.md)
P99_TARGET_MS = 5.0

CHAOS_CONFIG = {"dispatchers": 2, "bots": 12, "multigame_bots": 12,
                "scenarios_per_transport": 10}


def _device_name(device) -> str:
    import torch

    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return str(device)


def bench_aoi(device=None) -> dict:
    """The production AOI loop (the BatchAOIService path): pipelined
    ``step_async`` and one packed readback a tick, at the headline
    geometry of the root bench's accelerator branch."""
    from goworld_tpu_torch.ops import NeighborEngine, NeighborParams

    n = int(os.environ.get("BENCH_N", "102400"))
    cell, cap = 300.0, 128
    grid = max(8, int(round(44 * (n / 102400.0) ** 0.5 / 4)) * 4)
    max_events = int(os.environ.get("BENCH_MAX_EVENTS", "131072"))
    params = NeighborParams(
        capacity=n, cell_size=cell, grid_x=grid, grid_z=grid, space_slots=1,
        cell_capacity=cap, max_events=max_events, drain_mode="bsearch")
    eng = NeighborEngine(params, device=device)
    eng.reset()

    rng = np.random.default_rng(0)
    world = grid * cell
    pos = rng.uniform(0, world, (n, 2)).astype(np.float32)
    active = np.ones(n, bool)
    space = np.zeros(n, np.int32)
    radius = np.full(n, 100.0, np.float32)
    vel = rng.normal(0, 3.0, (n, 2)).astype(np.float32)

    # Warmup: the first tick's full enter storm, paged, off the clock.
    eng.step(pos, active, space, radius)

    steps = max(2, int(os.environ.get("BENCH_STEPS", "45")))
    events = 0
    paged_ticks = 0  # ticks whose event count overflowed the inline budget
    collect_lat: list[float] = []
    diff_lat: list[float] = []  # dispatch of tick t -> tick t events on host
    pending = None
    pending_dispatch_t = 0.0

    def land(pend, t_dispatch):
        nonlocal events, paged_ticks
        t0 = time.perf_counter()
        enters, leaves, _ = pend.collect()
        t1 = time.perf_counter()
        collect_lat.append(t1 - t0)
        diff_lat.append(t1 - t_dispatch)
        events += len(enters) + len(leaves)
        if len(enters) > max_events or len(leaves) > max_events:
            paged_ticks += 1

    t_all0 = time.perf_counter()
    for _ in range(steps):
        pos += vel
        np.clip(pos, 0.0, world, out=pos)
        t_dispatch = time.perf_counter()
        nxt = eng.step_async(pos, active, space, radius, meta_dirty=False)
        if pending is not None:
            land(pending, pending_dispatch_t)
        pending, pending_dispatch_t = nxt, t_dispatch
    land(pending, pending_dispatch_t)
    t_all = time.perf_counter() - t_all0

    # The post-step drain: wait for the step, then time collect() alone
    # (BASELINE's p99 < 5 ms budget; the pipelined diff latency is at least
    # one tick by design).
    sync_steps = max(2, int(os.environ.get("BENCH_SYNC_STEPS", "15")))
    drain_lat: list[float] = []
    for _ in range(sync_steps):
        pos += vel
        np.clip(pos, 0.0, world, out=pos)
        pend = eng.step_async(pos, active, space, radius, meta_dirty=False)
        pend.wait_device()
        t0 = time.perf_counter()
        pend.collect()
        drain_lat.append(time.perf_counter() - t0)
    s_ms = np.array(drain_lat) * 1000.0
    c_ms = np.array(collect_lat) * 1000.0
    d_ms = np.array(diff_lat) * 1000.0
    ticks_per_sec = steps / t_all
    updates_per_sec = ticks_per_sec * n

    def p(a, q):
        return round(float(np.percentile(a, q)), 3)

    return {
        "metric": "aoi_entity_updates_per_sec",
        "value": round(updates_per_sec, 1),
        "unit": "entity-updates/sec",
        "vs_baseline": round(updates_per_sec / HEADLINE_BASELINE, 3),
        "backend": eng.backend,
        "device": _device_name(eng.device),
        "entities": n,
        "cell_size": cell,
        "grid": grid,
        "max_events": max_events,
        "drain_mode": params.drain_mode,
        "spaces": 1,
        "steps": steps,
        "ticks_per_sec": round(ticks_per_sec, 2),
        "events_per_tick": round(events / steps, 1),
        "paged_ticks": paged_ticks,
        "inline_budget_clears_steady_state": paged_ticks == 0,
        "collect_p50_ms": p(c_ms, 50),
        "collect_p99_ms": p(c_ms, 99),
        "diff_latency_p50_ms": p(d_ms, 50),
        "diff_latency_p99_ms": p(d_ms, 99),
        "post_step_drain_p50_ms": p(s_ms, 50),
        "post_step_drain_p99_ms": p(s_ms, 99),
        "post_step_drain_meets_target": bool(
            np.percentile(s_ms, 99) < P99_TARGET_MS),
        "p99_target_ms": P99_TARGET_MS,
    }


def _slo(path):
    """The ``[slo]`` section of ``path`` when it sets a budget, else None
    (no gate)."""
    if path is None:
        return None
    from goworld_tpu_torch.config.read_config import _load

    slo = _load(path).slo
    return slo if slo.enabled() else None


def bench_scenario(name: str, engine: str, slo=None, device=None) -> dict:
    """One registered scenario in gate mode (``--scenario``)."""
    from goworld_tpu_torch.scenarios import runner

    return runner.run_scenario(name, engine=engine, slo=slo, device=device)


def list_scenarios(device) -> int:
    """The registry, one JSON line per scenario: its fixed config, and the
    backend ``--scenario`` runs it on with this ``--device``. The port has
    no committed floors yet."""
    from goworld_tpu_torch.scenarios import get_scenario, scenario_names

    backend = "reference" if device == "cpu" else "kernel"
    for name in scenario_names():
        spec = get_scenario(name)
        print(json.dumps({
            "scenario": name,
            "description": spec.description,
            "config": dict(spec.config),
            "backend": backend,
            "device": device or "cuda",
            "committed_floor": None,
            "tolerance": None,
        }, separators=(",", ":")))
    return 0


def bench_chaos(slo=None) -> dict:
    """The chaos suite (``--chaos``): every scenario of ``run_chaos`` on the
    port's in-process cluster, then migrate-during-dispatcher-restart on
    the two-game cluster, once a cluster transport (tcp, then uds). Value
    = scenarios passed across both transports; failures are named in
    ``failures`` and make the process exit 1."""
    import tempfile

    from goworld_tpu_torch.chaos import run_chaos
    from goworld_tpu_torch.chaos.multigame import run_multigame

    c = CHAOS_CONFIG
    per_transport: dict = {}
    per_scenario: dict = {}
    failures: list = []
    worst = 0.0
    passed = 0
    for transport in ("tcp", "uds"):
        with tempfile.TemporaryDirectory(prefix="bench_chaos_") as d:
            r = run_chaos(d, n_dispatchers=c["dispatchers"],
                          n_bots=c["bots"], transport=transport, slo=slo)
        scenarios = list(r["scenarios"])
        with tempfile.TemporaryDirectory(prefix="bench_chaos_mg_") as d:
            try:
                mg = run_multigame(d, n_bots=c["multigame_bots"],
                                   transport=transport,
                                   with_restart_phase=True)
                phase = dict(mg["dispatcher_restart_phase"])
                phase["rebalance_convergence_s"] = mg["convergence_s"]
                scenarios.append(phase)
            except Exception as exc:
                failures.append({
                    "scenario": "migrate_during_dispatcher_restart",
                    "transport": transport,
                    "error": f"{type(exc).__name__}: {exc}"})
        for s in scenarios:
            per_scenario[f"{transport}:{s['scenario']}"] = {
                "recovery_s": s.get("recovery_s", s.get("detect_s", 0.0)),
                "bot_errors": s.get("bot_errors", 0),
            }
            worst = max(worst, s.get("recovery_s",
                                     s.get("detect_s", 0.0)))
        failures.extend(
            dict(f, transport=transport) for f in r["failures"])
        passed += len(scenarios)
        per_transport[transport] = {
            "passed": len(scenarios), "scenarios": scenarios}
    out = {
        "metric": "chaos_scenarios_passed",
        "value": float(passed),
        "unit": "scenarios",
        "worst_recovery_s": round(worst, 3),
        "per_scenario": per_scenario,
        "bot_errors": sum(v["bot_errors"] for v in per_scenario.values()),
        "transports": per_transport,
        "config": dict(c),
        "backend": "xzlist",
        "device": "cpu",
    }
    if failures:
        out["failures"] = failures
        out["error"] = "; ".join(
            f"{f.get('transport', '?')}:{f['scenario']}: {f['error']}"
            for f in failures)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m goworld_tpu_torch.bench",
        description="The port's benchmark: one JSON line on stdout.")
    ap.add_argument("--scenario", metavar="NAME")
    ap.add_argument("--scenario-engine", default="batched",
                    choices=("batched", "sharded"))
    ap.add_argument("--list-scenarios", action="store_true")
    ap.add_argument("--chaos", action="store_true")
    ap.add_argument("--slo-config", metavar="INI")
    ap.add_argument("--device", choices=("cuda", "cpu"),
                    help="where the AOI engines run (default: the card)")
    args = ap.parse_args(argv)

    if args.list_scenarios:
        return list_scenarios(args.device)
    if args.chaos:
        metric, unit = "chaos_scenarios_passed", "scenarios"

        def run():
            return bench_chaos(slo=_slo(args.slo_config))
    elif args.scenario:
        metric, unit = "scenario_updates_per_sec", "entity-updates/sec"

        def run():
            return bench_scenario(
                args.scenario, args.scenario_engine,
                slo=_slo(args.slo_config), device=args.device)
    else:
        metric, unit = "aoi_entity_updates_per_sec", "entity-updates/sec"

        def run():
            return bench_aoi(device=args.device)
    try:
        result = run()
    except Exception:
        result = {"metric": metric, "value": 0.0, "unit": unit,
                  "error": traceback.format_exc(limit=4)}
    print(json.dumps(result, separators=(",", ":")), flush=True)
    if args.chaos and (result.get("error") or result.get("failures")
                       or result.get("bot_errors")):
        # --chaos is a gate: any failure or bot error exits non-zero.
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
