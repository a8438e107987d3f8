"""The port's benchmark: the repo's ``bench.py`` on PyTorch, its device modes
and its gate modes, printed as the same JSON lines with ``backend``
(``kernel`` | ``reference``) and ``device`` (the card's name, or ``cpu``)
added.

    python -m goworld_tpu_torch.bench                       # the default run
    python -m goworld_tpu_torch.bench --sharded [--sharded-backend kernel|reference]
    python -m goworld_tpu_torch.bench --fused
    python -m goworld_tpu_torch.bench --pinned-floor
    python -m goworld_tpu_torch.bench --scenario hotspot [--scenario-engine sharded]
    python -m goworld_tpu_torch.bench --list-scenarios
    python -m goworld_tpu_torch.bench --chaos
    python -m goworld_tpu_torch.bench --fanout | --fanout-multi | --fanout-massive
    python -m goworld_tpu_torch.bench --trace-overhead
    python -m goworld_tpu_torch.bench --multigame | --multigame-spaces
    ... [--history-dir DIR] [--slo-config goworld.ini] [--device cpu]

- no mode: the default run, ``BENCH_MODE=aoi|boids|multispace|all``
  (default ``all``). ``aoi`` is ``bench_aoi``: the production AOI loop at
  the headline of bench.py's accelerator branch (102,400 entities, one
  space, 44x44 cells of 300, radius 100, cell capacity 128, ``max_events``
  131,072): the enter storm off the clock, ``BENCH_STEPS`` pipelined ticks
  (one blocking readback each), then ``BENCH_SYNC_STEPS`` synchronous ones
  for the post-step drain latency. ``multispace`` is the 32-space shape
  (32x32 cells of 400), ``boids`` is ``bench_boids_tuned`` (51,200 agents,
  the drop-free winner of ``BOIDS_CELL_SWEEP``). ``all`` on the card runs
  the headline, ``multispace_32``, ``synthetic_10k``, ``boids_50k``, the
  phase profile (``phases``), the cell, events and drain sweeps at
  ``BENCH_SWEEP_STEPS`` and the self-tune promotion (only at the canonical
  102,400 entities); with ``--device cpu`` it runs the headline and
  ``multispace_32`` and marks ``boids_50k`` skipped. It prints the full
  record, then the compact headline as the last line. ``BENCH_N`` scales
  the entities (the grid follows, at the same density; the phase profile
  runs at the headline's geometry), ``BENCH_MAX_EVENTS`` the inline budget,
  ``BENCH_DRAIN_MODE`` the drain's select, ``BENCH_BOIDS_N`` the agents,
  ``BENCH_BOIDS_STEPS`` / ``BENCH_BOIDS_SWEEP_STEPS`` the boids steps;
  ``BENCH_REHEARSAL=1`` takes the card's branch on ``--device cpu``.
- ``--sharded``: the strip engine (``parallel/spatial.py``) on
  ``make_mesh(8)``, eight strips on one device, at a fixed config
  (``SHARDED_FLOOR_CONFIG`` for the ``reference`` backend,
  ``PALLAS_SHARDED_CONFIG`` for ``kernel``, the in-kernel drain): exact
  event parity with the single-device engine on the same trace, then best
  of ``repeats`` pipelined runs, with both backends' structural halo and
  all-gather bytes. ``--sharded-backend`` defaults to ``kernel`` on the
  card and ``reference`` on the CPU.
- ``--fused``: the port's runtime with N columnar avatars on the batched
  AOI service, ``fuse_logic`` off then on: the host entity-logic time a
  tick, and the fused hook never run.
- ``--pinned-floor``: the pipelined AOI loop at ``PINNED_FLOOR_CONFIG``,
  best of ``repeats``. The port has no floors file, so nothing is compared.
- ``--scenario <name>``: one registered scenario (``scenarios/``) in gate
  mode: the fixed registry config, the verify pass (interest-set oracle
  and per-tick invariants) then the timed measure pass, with the one-launch
  pin. ``--scenario-engine sharded`` runs the strip engine, its strips on
  one device.
- ``--list-scenarios``: one JSON line per registered scenario.
- ``--chaos``: the chaos suite over the port's in-process cluster, once a
  transport (tcp, then uds), plus the migration-during-restart phase on the
  two-game cluster. A gate: any failure or bot error exits 1.
- ``--fanout``: delivered sync records/s of an in-process cluster (one
  dispatcher, one game, one gate, 80 bot sockets whose avatars all see each
  other, a sync every 5 ms), best of 3 windows, with each hop's busy time
  and share (``FANOUT_HOPS``). ``--fanout-multi``: 104 bots on 2 gates.
  ``BENCH_TRACE_SAMPLE_RATE`` overrides the cluster's trace sampling.
- ``--fanout-massive``: 1,008 bot sockets in 4 fleet processes
  (``python -m goworld_tpu_torch.chaos.botfleet``) on 2 gates; records/s
  and bytes a client a second at full rate, then with cadence tiers and
  quantized deltas (the value), then a gate kill and reconnect storm judged
  by the collector's census.
- ``--trace-overhead``: at each rate of ``TRACE_OVERHEAD_RATES`` (off,
  1/1024, 1/1), the pinned floor on ``--device`` (the card by default) and
  the fan-out; the value is the fan-out with tracing off.
- ``--multigame``: rebalance convergence (entities moved a second) on two
  game processes, then migration across a dispatcher restart.
  ``--multigame-spaces``: whole-space migration under three kill crosses;
  the value is the crosses passed.
- ``--history-dir <dir>``: the run's own black box: a ``HistoryWriter``
  ring under ``<dir>/bench`` whose final frame carries the run's telemetry,
  the event kernel's launches by form among it.
- ``--slo-config <ini>``: the ``[slo]`` budgets that ``--scenario`` and
  ``--chaos`` are judged against.

Everything runs on the CUDA card unless ``--device cpu`` is given; without
a card a mode fails in its JSON line's ``error`` (it never falls back to the
CPU). The exit code is 0 but for ``--chaos``. The cluster modes' games
(``--chaos``, the fan-outs, ``--multigame*`` and the fan-out half of
``--trace-overhead``) run ``[aoi] backend = xzlist``, as the root bench's
do: they measure the host pipeline, never touch the card and need none;
their lines say ``backend: xzlist``, ``device: cpu``. The port has no
floors file: ``floor_file`` is null and nothing is compared.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback

import numpy as np

HEADLINE_BASELINE = 100_000 * 30  # 100k entities @ 30 Hz (BASELINE.md)
P99_TARGET_MS = 5.0

# Sweep points (single source for both the sweep loops and self-tuning), as
# in bench.py: cell sizes with the grid that keeps the 13,200-unit world of
# the canonical 102,400 entities, the per-side event budgets, the drain's
# word-select strategies.
CELL_SWEEP = ((100.0, 132), (150.0, 88), (300.0, 44), (440.0, 30), (600.0, 22))
EVENTS_SWEEP = (65536, 98304, 131072, 163840, 196608)
DRAIN_SWEEP = ("bsearch", "grouped", "scatter")
CANONICAL_N = 102400

# Boids supercell sweep at a fixed 100-unit interaction radius over the same
# world span: bigger cells pack more agents per 128-lane cell.
BOIDS_CELL_SWEEP = (100.0, 160.0, 200.0, 320.0)
BOIDS_BASELINE = 50_000 * 30  # 50k agents @ 30 Hz

# bench.py's fixed configs, never self-tuned and never env-scaled.
PINNED_FLOOR_CONFIG = {
    "n": 2048, "cell_size": 100.0, "grid": 32, "space_slots": 1,
    "cell_capacity": 64, "max_events": 32768, "drain_mode": "bsearch",
    "steps": 20, "repeats": 3,
}
# The strip engine's reference backend: 8,192 entities over a 128-column
# torus (16 columns a strip), radius == cell_size, halo_cap 768 covering
# the ~384-row uniform bands 2x.
SHARDED_FLOOR_CONFIG = {
    "n": 8192, "cell_size": 100.0, "grid": 128, "space_slots": 1,
    "cell_capacity": 32, "max_events": 32768, "shards": 8,
    "halo_cap": 768, "active": 7168, "steps": 20, "repeats": 3,
    "parity_ticks": 3,
}
# The kernel backend (bench.py's pallas_interpret config): 2,048 entities
# over a 192-column torus, grid_z 8, halo_cap 128, strip_cols 48, radius 40
# so the seam-free guard holds on drift ticks (the one-launch fast tick).
PALLAS_SHARDED_CONFIG = {
    "n": 2048, "cell_size": 100.0, "grid": 192, "grid_z": 8,
    "space_slots": 1, "cell_capacity": 32, "max_events": 16384,
    "shards": 8, "halo_cap": 128, "strip_cols": 48, "radius": 40.0,
    "active": 1792, "steps": 8, "repeats": 1, "parity_ticks": 2,
}
SHARDED_CONFIGS = {"reference": SHARDED_FLOOR_CONFIG,
                   "kernel": PALLAS_SHARDED_CONFIG}

CHAOS_CONFIG = {"dispatchers": 2, "bots": 12, "multigame_bots": 12,
                "scenarios_per_transport": 10}

# Where the port covers the default run's configs that are not bench runs.
UNITY_200_COVERED_BY = (
    "chip_smoke.py unity_demo (16 spaces of 103 entities through the "
    "port's runtime and batched AOI service on the card; "
    "tests/test_torch_examples.py on the CPU)")
POD_1M_COVERED_BY = (
    "chip_smoke.py multihost_1m (BASELINE config 5: 4 processes x 2 shards "
    "on 4 cards) and entity_1m (8 shards on one card)")


def _resolve(device):
    """``device`` as a torch.device: None means the CUDA card, and raises
    when there is none (a mode never falls back to the CPU)."""
    import torch

    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("the bench runs on the CUDA card unless told "
                               "otherwise, and no CUDA device is available; "
                               "pass --device cpu for the plain versions")
        device = "cuda"
    return torch.device(device)


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _device_name(device) -> str:
    import torch

    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return str(device)


def _platform(device) -> str:
    return "gpu" if device.type == "cuda" else device.type


def _exc_line() -> str:
    """One diagnosable line for a caught exception: its type and message."""
    tp, exc, _ = sys.exc_info()
    return f"{tp.__name__}: {str(exc)[:300]}"


def _steady_state_retraces() -> int:
    """The sentinel's retrace count (0 by construction: PyTorch traces
    nothing); floors report the delta across their own run."""
    from goworld_tpu_torch.telemetry import sentinel

    return int(sentinel.steady_state_retraces())


def bench_aoi(n: int | None = None, space_slots: int = 4, n_spaces: int = 1,
              label: str = "aoi", cell_override: float | None = None,
              grid_override: int | None = None,
              max_events_override: int | None = None,
              drain_mode: str | None = None, device=None,
              steps: int | None = None) -> dict:
    """The production AOI loop (the BatchAOIService path): pipelined
    ``step_async`` and one packed readback a tick, at the geometry of the
    root bench's accelerator branch. ``n_spaces`` > 1 is BASELINE config 3
    (batched cross-space AOI in one launch). ``steps`` overrides
    ``BENCH_STEPS`` (the sweeps' short runs)."""
    from goworld_tpu_torch.ops import NeighborEngine, NeighborParams

    dev = _resolve(device)
    card = dev.type == "cuda"
    if n is None:
        n = int(os.environ.get("BENCH_N", str(CANONICAL_N)))
    # Never fold into more slots than there are spaces: empty slabs would
    # run the full per-cell kernel work on NaN rows.
    space_slots = max(1, min(space_slots, n_spaces))
    if space_slots > 4:
        cell, cap = 400.0, 128
        grid = max(8, int(round(32 * (n / 102400.0) ** 0.5 / 4)) * 4)
    else:
        cell, cap = 300.0, 128
        grid = max(8, int(round(44 * (n / 102400.0) ** 0.5 / 4)) * 4)
    if cell_override is not None:
        cell = cell_override
    if grid_override is not None:
        grid = grid_override
    max_events = max_events_override or int(
        os.environ.get("BENCH_MAX_EVENTS", "131072"))
    params = NeighborParams(
        capacity=n, cell_size=cell, grid_x=grid, grid_z=grid,
        space_slots=space_slots, cell_capacity=cap, max_events=max_events,
        drain_mode=drain_mode or os.environ.get("BENCH_DRAIN_MODE", "bsearch"),
    )
    eng = NeighborEngine(params, device=dev)
    eng.reset()

    rng = np.random.default_rng(0)
    # ~6 entities per 100x100 cell over the world, ~19 AOI neighbors each.
    world = grid * cell
    pos = rng.uniform(0, world, (n, 2)).astype(np.float32)
    active = np.ones(n, bool)
    space = (np.arange(n) % n_spaces).astype(np.int32)
    radius = np.full(n, 100.0, np.float32)
    vel = rng.normal(0, 3.0, (n, 2)).astype(np.float32)

    # Warmup: the first tick's full enter storm, paged, off the clock.
    eng.step(pos, active, space, radius)

    if steps is None:  # the CPU run is a diagnostic: fewer steps
        steps = int(os.environ.get("BENCH_STEPS", "45" if card else "10"))
    steps = max(2, steps)
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
        # Steady state moves positions only, as the service's ticks do.
        nxt = eng.step_async(pos, active, space, radius, meta_dirty=False)
        if pending is not None:
            land(pending, pending_dispatch_t)
        pending, pending_dispatch_t = nxt, t_dispatch
    land(pending, pending_dispatch_t)
    t_all = time.perf_counter() - t_all0

    # The post-step drain: wait for the step, then time collect() alone
    # (BASELINE's p99 < 5 ms budget; the pipelined diff latency is at least
    # one tick by design).
    sync_steps = max(2, int(os.environ.get(
        "BENCH_SYNC_STEPS", "15" if card else "3")))
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
        "metric": f"{label}_entity_updates_per_sec",
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
        "spaces": n_spaces,
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
        "p99_axis_note": (
            "BASELINE's p99<5ms applies to post_step_drain_* (events on "
            "host after the device step completes); diff_latency_* spans "
            "dispatch->host across the pipelined loop and is >= 1 tick by "
            "design (diffs land one tick late, batched.py)"
        ),
    }


def bench_pinned_floor(device=None) -> dict:
    """``--pinned-floor``: the pipelined AOI loop (``step_async`` and one
    packed readback a tick) at ``PINNED_FLOOR_CONFIG``, best of
    ``repeats``. The port has no floors file, so no floor is compared."""
    from goworld_tpu_torch.ops import NeighborEngine, NeighborParams

    dev = _resolve(device)
    retraces0 = _steady_state_retraces()
    c = PINNED_FLOOR_CONFIG
    n = c["n"]
    params = NeighborParams(
        capacity=n, cell_size=c["cell_size"], grid_x=c["grid"],
        grid_z=c["grid"], space_slots=c["space_slots"],
        cell_capacity=c["cell_capacity"], max_events=c["max_events"],
        drain_mode=c["drain_mode"],
    )
    world = c["grid"] * c["cell_size"]
    runs = []
    for _rep in range(c["repeats"]):
        eng = NeighborEngine(params, device=dev)
        eng.reset()
        rng = np.random.default_rng(0)  # the same world every repeat
        pos = rng.uniform(0, world, (n, 2)).astype(np.float32)
        active = np.ones(n, bool)
        space = np.zeros(n, np.int32)
        radius = np.full(n, 100.0, np.float32)
        vel = rng.normal(0, 3.0, (n, 2)).astype(np.float32)
        eng.step(pos, active, space, radius)  # the enter storm
        pending = None
        t0 = time.perf_counter()
        for _ in range(c["steps"]):
            pos += vel
            np.clip(pos, 0.0, world, out=pos)
            nxt = eng.step_async(pos, active, space, radius,
                                 meta_dirty=False)
            if pending is not None:
                pending.collect()
            pending = nxt
        pending.collect()
        runs.append(c["steps"] / (time.perf_counter() - t0) * n)
    return {
        "metric": "pinned_floor_updates_per_sec",
        "value": round(max(runs), 1),
        "unit": "entity-updates/sec",
        "runs": [round(r, 1) for r in runs],
        "config": dict(c),
        "platform": _platform(dev),
        "backend": eng.backend,
        "device": _device_name(dev),
        "steady_state_retraces": _steady_state_retraces() - retraces0,
        "floor_file": None,
    }


def _spatial_engine_for(c: dict, backend: str, mesh):
    """The strip engine for a sharded config, constructed and not stepped
    (also the other backend's, for its structural bytes)."""
    from goworld_tpu_torch.ops import NeighborParams
    from goworld_tpu_torch.parallel import SpatialShardedNeighborEngine

    params = NeighborParams(
        capacity=c["n"], cell_size=c["cell_size"], grid_x=c["grid"],
        grid_z=c.get("grid_z", c["grid"]), space_slots=c["space_slots"],
        cell_capacity=c["cell_capacity"], max_events=c["max_events"],
    )
    return SpatialShardedNeighborEngine(
        params, mesh, halo_cap=c["halo_cap"], backend=backend,
        strip_cols=c.get("strip_cols"))


def bench_sharded(backend: str | None = None, device=None) -> dict:
    """``--sharded``: updates/s of the strip engine on eight strips of one
    device at its backend's fixed config, best of ``repeats`` pipelined
    runs, after an exact event-set parity check against the single-device
    engine (reference backend) on the same trace. The line carries both
    backends' structural halo and all-gather bytes a tick."""
    from goworld_tpu_torch.ops import NeighborEngine, NeighborParams
    from goworld_tpu_torch.parallel import make_mesh

    dev = _resolve(device)
    if backend is None:
        backend = "kernel" if dev.type == "cuda" else "reference"
    if backend not in SHARDED_CONFIGS:
        raise ValueError(f"unknown --sharded-backend {backend!r}")
    c = SHARDED_CONFIGS[backend]
    n = c["n"]
    params = NeighborParams(
        capacity=n, cell_size=c["cell_size"], grid_x=c["grid"],
        grid_z=c.get("grid_z", c["grid"]), space_slots=c["space_slots"],
        cell_capacity=c["cell_capacity"], max_events=c["max_events"],
    )
    mesh = make_mesh(c["shards"], dev)
    retraces0 = _steady_state_retraces()
    world = c["grid"] * c["cell_size"]
    world_z = c.get("grid_z", c["grid"]) * c["cell_size"]

    def make_world():
        rng = np.random.default_rng(0)
        pos = rng.uniform(0, world, (n, 2)).astype(np.float32)
        pos[:, 1] %= world_z
        active = np.zeros(n, bool)
        active[:c["active"]] = True
        space = np.zeros(n, np.int32)
        radius = np.full(n, c.get("radius", 100.0), np.float32)
        vel = rng.normal(0, 3.0, (n, 2)).astype(np.float32)
        return pos, active, space, radius, vel

    eng = _spatial_engine_for(c, backend, mesh)
    other_backend = "kernel" if backend == "reference" else "reference"
    other = _spatial_engine_for(SHARDED_CONFIGS[other_backend],
                                other_backend, mesh)

    # Exact event-set parity on the measured trace.
    single = NeighborEngine(params, backend="reference", device=dev)
    single.reset()
    eng.reset()
    pos, active, space, radius, vel = make_world()
    parity = True
    for _ in range(c["parity_ticks"]):
        e1, l1, d1 = single.step(pos, active, space, radius)
        e2, l2, d2 = eng.step(pos, active, space, radius)
        if (d1 != d2
                or sorted(map(tuple, e1)) != sorted(map(tuple, e2))
                or sorted(map(tuple, l1)) != sorted(map(tuple, l2))):
            parity = False
            break
        pos += vel
        np.clip(pos, 0.0, world, out=pos)

    runs = []
    fallback_ticks = 0
    migrations = 0
    fast_ticks = 0
    for _rep in range(c["repeats"]):
        eng.reset()
        fb0, mg0 = eng.total_fallbacks, eng.total_migrations
        ft0 = eng.total_fast_ticks
        pos, active, space, radius, vel = make_world()
        eng.step(pos, active, space, radius)  # the enter storm
        pending = None
        t0 = time.perf_counter()
        for _ in range(c["steps"]):
            pos += vel
            np.clip(pos, 0.0, world, out=pos)
            nxt = eng.step_async(pos, active, space, radius,
                                 meta_dirty=False)
            if pending is not None:
                pending.collect()
            pending = nxt
        pending.collect()
        runs.append(c["steps"] / (time.perf_counter() - t0) * n)
        fallback_ticks += eng.total_fallbacks - fb0
        migrations += eng.total_migrations - mg0
        fast_ticks += eng.total_fast_ticks - ft0
    return {
        "metric": "sharded_updates_per_sec",
        "value": round(max(runs), 1),
        "unit": "entity-updates/sec",
        "runs": [round(r, 1) for r in runs],
        "config": dict(c),
        "mesh": f"1x{c['shards']}",
        "mesh_devices": c["shards"],
        "backend": backend,
        "device": _device_name(dev),
        "shard_backend": backend,
        "shard_mode": "spatial",
        "platform": _platform(dev),
        "parity_with_single_device": parity,
        # What the halo exchange moves a tick against what the all-gather
        # formulation would move, for the measured backend at its config
        # and for the other backend at its own.
        "halo_bytes_per_tick": eng.halo_bytes_per_tick,
        "allgather_equiv_bytes_per_tick": eng.allgather_bytes_per_tick,
        "halo_smaller_than_allgather":
            eng.halo_bytes_per_tick < eng.allgather_bytes_per_tick,
        "comms_reduction": round(
            eng.allgather_bytes_per_tick / max(1, eng.halo_bytes_per_tick),
            2),
        f"{other_backend}_halo_bytes_per_tick": other.halo_bytes_per_tick,
        f"{other_backend}_allgather_equiv_bytes_per_tick":
            other.allgather_bytes_per_tick,
        f"{other_backend}_comms_reduction": round(
            other.allgather_bytes_per_tick
            / max(1, other.halo_bytes_per_tick), 2),
        "fallback_ticks": fallback_ticks,
        "shard_migrations": migrations,
        # Collected steady ticks whose seam-free guard held (the kernel
        # config's radius 40 keeps it true on drift).
        "fast_ticks": fast_ticks,
        "steady_state_retraces": _steady_state_retraces() - retraces0,
        "floor_file": None,
    }


def bench_boids(cell: float = 100.0, label: str = "boids", device=None,
                steps: int | None = None) -> dict:
    """BASELINE config 4: the boids step (51,200 agents, AOI and steering in
    one kernel launch, device-resident). The grid derives from a
    cell-independent world target, so every sweep point simulates the same
    density (within half a cell of rounding). ``steps`` overrides
    ``BENCH_BOIDS_STEPS``."""
    import torch

    from goworld_tpu_torch.ops.boids import BoidsEngine, BoidsParams

    dev = _resolve(device)
    n = int(os.environ.get("BENCH_BOIDS_N", "51200"))
    world_target = 6400.0 * (n / 51200.0) ** 0.5
    grid = max(4, int(round(world_target / cell)))
    p = BoidsParams(capacity=n, cell_size=cell, grid_x=grid, grid_z=grid,
                    radius=100.0)
    eng = BoidsEngine(p, device=dev)
    rng = np.random.default_rng(0)
    pos = rng.uniform(0, [p.world_x, p.world_z], (n, 2)).astype(np.float32)
    vel = rng.normal(0, 3.0, (n, 2)).astype(np.float32)
    active = torch.ones(n, dtype=torch.bool, device=dev)

    pos, vel, _ = eng.step(pos, vel, active)  # first use, off the clock
    _sync(dev)
    if steps is None:
        steps = int(os.environ.get("BENCH_BOIDS_STEPS", "60"))
    steps = max(2, steps)
    drops = []  # device scalars, read only after the timed loop
    t0 = time.perf_counter()
    for _ in range(steps):
        pos, vel, _ = eng.step(pos, vel, active)  # chained on the device
        drops.append(eng.last_dropped)
    _sync(dev)
    t_all = time.perf_counter() - t0
    # Summed over every tick: condensing flocks can overflow mid-run and be
    # clean on the last tick.
    dropped = int(torch.stack(drops).sum())
    ticks_per_sec = steps / t_all
    updates_per_sec = ticks_per_sec * n
    return {
        "metric": f"{label}_agent_updates_per_sec",
        "value": round(updates_per_sec, 1),
        "unit": "agent-updates/sec",
        "vs_baseline": round(updates_per_sec / BOIDS_BASELINE, 3),
        "backend": eng.backend,
        "device": _device_name(dev),
        "agents": n,
        "cell_size": cell,
        "grid": grid,
        "ticks_per_sec": round(ticks_per_sec, 2),
        "cell_overflow_dropped": dropped,
    }


def bench_boids_tuned(device=None) -> dict:
    """Sweep the supercell sizes in short runs (``BENCH_BOIDS_SWEEP_STEPS``)
    and run the fastest drop-free one at full length. Flocking clusters
    agents, so a config that drops agents to cell overflow is disqualified
    (its steering is silently wrong); the full-length run checks again and
    falls to the next candidate if it drops."""
    sweep_steps = int(os.environ.get("BENCH_BOIDS_SWEEP_STEPS", "15"))
    sweep = {}
    candidates = []  # drop-free configs
    for cell in BOIDS_CELL_SWEEP:
        try:
            r = bench_boids(cell=cell, label=f"boids_c{int(cell)}",
                            device=device, steps=sweep_steps)
            sweep[f"cell_{int(cell)}"] = {
                "updates_per_sec": r["value"],
                "dropped": r["cell_overflow_dropped"],
            }
            if r["cell_overflow_dropped"] == 0:
                candidates.append((r["value"], cell))
        except Exception:
            sweep[f"cell_{int(cell)}"] = {"error": _exc_line()}
    candidates.sort(reverse=True)
    order = [c for _, c in candidates] or [BOIDS_CELL_SWEEP[0]]
    result = None
    for cell in order:
        result = bench_boids(cell=cell, device=device)
        if result["cell_overflow_dropped"] == 0:
            break
        # If every config drops, the last one is reported with its nonzero
        # cell_overflow_dropped.
        sweep[f"cell_{int(cell)}"]["disqualified_full_run_dropped"] = (
            result["cell_overflow_dropped"])
    result["metric"] = "boids_agent_updates_per_sec"
    result["cell_sweep"] = sweep
    return result


def bench_phase_profile(n: int = CANONICAL_N, cell: float = 300.0,
                        grid: int = 44, device=None) -> dict:
    """The tick budget by stage: each piece of the kernel step
    (``ops/neighbor.py``) on its own, synchronized, best of 3, on one space
    slot as the headline. ``events_in_mask`` is the enter events of the
    step from ``ppos`` to ``pos``."""
    import torch

    from goworld_tpu_torch.ops import neighbor as nb
    from goworld_tpu_torch.ops.event_kernel import event_mask

    dev = _resolve(device)
    p = nb.NeighborParams(
        capacity=n, cell_size=cell, grid_x=grid, grid_z=grid,
        space_slots=1, cell_capacity=128, max_events=131072,
    )
    rng = np.random.default_rng(0)
    world = grid * cell
    pos_h = rng.uniform(0, world, (n, 2)).astype(np.float32)
    ppos_h = pos_h + rng.normal(0, 3, (n, 2)).astype(np.float32)
    pos = torch.as_tensor(pos_h, device=dev)
    ppos = torch.as_tensor(ppos_h, device=dev)
    act = torch.ones(n, dtype=torch.bool, device=dev)
    spc = torch.zeros(n, dtype=torch.int32, device=dev)
    rad = torch.full((n,), 100.0, dtype=torch.float32, device=dev)

    def t(fn, iters=3):
        fn()  # warm
        _sync(dev)
        best = None
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            _sync(dev)
            dt = time.perf_counter() - t0
            best = dt if best is None else min(best, dt)
        return round(best * 1000.0, 4)

    def phase_table():
        cx, cz, sm = nb._bins(p, pos, spc)
        buc = (sm * p.grid_z + cz) * p.grid_x + cx
        return nb._build_table(p, buc, act, nb.LANES)

    out = {}
    out["table_ms"] = t(phase_table)
    table, slot, _, order, dst = phase_table()

    def phase_feats():
        xs = torch.where(slot >= 0, pos[:, 0], float("nan"))
        xsp = torch.where(slot >= 0, ppos[:, 0], float("nan"))
        return nb._scatter_feats(p, dst, order, (xs, pos[:, 1], spc, rad),
                                 (xsp, ppos[:, 1], spc, rad))

    out["feats_ms"] = t(phase_feats)
    cells = phase_feats()
    out["kernel_ms"] = t(lambda: event_mask(cells, dual=True))
    packed_cells = event_mask(cells, dual=True)[..., :nb._W]

    def phase_gather():
        pe = nb._per_entity(packed_cells, slot)
        return pe, nb._popcount16(pe).sum()

    out["gather_ms"] = t(phase_gather)
    packed_e, cnt = phase_gather()
    out["events_in_mask"] = int(cnt)
    cx, cz, sm = nb._bins(p, pos, spc)
    out["drain_ms"] = t(
        lambda: nb._drain_bits(p, packed_e, cx, cz, sm, table, 0))
    # Per-mode drain attribution: the same inputs, each select strategy.
    for dm in DRAIN_SWEEP:
        if dm == p.drain_mode:
            out[f"drain_{dm}_ms"] = out["drain_ms"]
            continue
        pm = dataclasses.replace(p, drain_mode=dm)
        out[f"drain_{dm}_ms"] = t(
            lambda pm=pm: nb._drain_bits(pm, packed_e, cx, cz, sm, table, 0))
    cxp, czp, smp = nb._bins(p, ppos, spc)
    bucp = (smp * p.grid_z + czp) * p.grid_x + cxp
    table_p, slot_p, _, order_p, dst_p = nb._build_table(
        p, bucp, act, nb.LANES)
    out["full_step_ms"] = t(lambda: nb._step_pallas(
        p, ppos, act, spc, rad, cxp, czp, smp, table_p, slot_p, order_p,
        dst_p, pos, act, spc, rad))
    # A steady tick: one table + feats + kernel chain, one drain a mask,
    # one slot gather.
    out["est_tick_ms"] = round(
        out["table_ms"] + out["feats_ms"] + out["kernel_ms"]
        + 2 * out["drain_ms"] + out["gather_ms"], 4)
    return out


def bench_fused(device=None) -> dict:
    """``--fused``: the port's runtime (no sockets) with N columnar avatars
    on the batched AOI service, driven through the production tick path
    with ``fuse_logic`` off, then on, measuring the host cost of the entity
    logic phase (``run_tick_batches``) a tick. Fused, the class's hook never
    runs and the logic rides the engine's step."""
    from goworld_tpu_torch.entity import entity_manager as em
    from goworld_tpu_torch.entity.columns import columnar_tick
    from goworld_tpu_torch.entity.entity import Entity
    from goworld_tpu_torch.entity.space import Space
    from goworld_tpu_torch.entity.vector import Vector3
    from goworld_tpu_torch.ops import NeighborParams

    dev = _resolve(device)
    n = int(os.environ.get("BENCH_FUSED_N", "1024"))
    steps = int(os.environ.get("BENCH_FUSED_STEPS", "60"))
    backend = None

    def run(fuse: bool) -> dict:
        nonlocal backend
        em.cleanup_for_tests()

        def drift(x, y, z, yaw, dt, vx, vz):
            return x + vx * dt, y, z + vz * dt, yaw + 10.0 * dt, vx, vz

        class FusedSpace(Space):
            def on_space_created(self):
                if self.kind == 1:
                    self.enable_aoi(100.0)

        class FusedAvatar(Entity):
            on_tick_batch = columnar_tick(drift, ("vx", "vz"))

            @classmethod
            def describe_entity_type(cls, desc):
                desc.set_use_aoi(True, 100.0)
                desc.define_attr("vx", "Column")
                desc.define_attr("vz", "Column")

        em.register_space(FusedSpace)
        em.register_entity(FusedAvatar)
        rt = em.runtime
        rt.aoi_backend = "batched"
        rt.aoi_device = str(dev)
        rt.aoi_params = NeighborParams(
            capacity=max(256, ((n + 256 + 255) // 256) * 256),
            cell_size=100.0, grid_x=32, grid_z=32, space_slots=1,
            cell_capacity=64, max_events=32768)
        rt.aoi_fuse_logic = fuse
        try:
            space = em.create_space_locally(1)
            rng = np.random.default_rng(0)
            for _ in range(n):
                e = em.create_entity_locally(
                    "FusedAvatar", space=space,
                    pos=Vector3(float(rng.uniform(0, 3200)), 0.0,
                                float(rng.uniform(0, 3200))))
                e.attrs["vx"] = float(rng.normal(0, 3.0))
                e.attrs["vz"] = float(rng.normal(0, 3.0))
            svc = rt.aoi_service
            backend = svc.engine.backend
            for _ in range(3):  # warm: first use + the enter storm
                rt.slabs.run_tick_batches()
                svc.tick()
            logic_s = 0.0
            aoi_s = 0.0
            for _ in range(steps):
                t0 = time.perf_counter()
                rt.slabs.run_tick_batches()
                t1 = time.perf_counter()
                svc.tick()
                # The step's device time belongs to the AOI phase: without
                # this wait the unfused hook's device work would queue
                # behind the in-flight step and the logic phase would
                # absorb the step's time.
                pend = svc._pending
                if pend is not None:
                    pend[0].wait_device()
                t2 = time.perf_counter()
                logic_s += t1 - t0
                aoi_s += t2 - t1
            hook = FusedAvatar.on_tick_batch.__func__
            return {
                "entity_logic_host_us_per_tick": round(
                    logic_s / steps * 1e6, 1),
                "aoi_phase_us_per_tick": round(aoi_s / steps * 1e6, 1),
                "hook_jit_traces": hook.jit_cache_size(),
            }
        finally:
            em.cleanup_for_tests()

    unfused = run(False)
    fused = run(True)
    collapse = (unfused["entity_logic_host_us_per_tick"]
                / max(fused["entity_logic_host_us_per_tick"], 0.01))
    return {
        "metric": "fused_entity_logic_collapse",
        "value": round(collapse, 1),
        "unit": "x (host entity_logic us, unfused/fused)",
        "entities": n,
        "steps": steps,
        "unfused": unfused,
        "fused": fused,
        # Fused ticks must never run the class's hook.
        "fused_hook_never_traced": fused["hook_jit_traces"] == 0,
        "platform": _platform(dev),
        "backend": backend,
        "device": _device_name(dev),
    }


class _SkipSelfTune(Exception):
    pass


def _sweep_entry(r: dict, *extra: str) -> dict:
    return {"updates_per_sec": r["value"],
            "diff_latency_p99_ms": r["diff_latency_p99_ms"],
            "post_step_drain_p99_ms": r["post_step_drain_p99_ms"],
            **{k: r[k] for k in extra}}


def _self_tune(result: dict, configs: dict, sweep: dict, esweep: dict,
               dsweep: dict, device) -> None:
    """If the short sweeps found a better config, run the headline again at
    full length there and promote it on throughput, or on paging hygiene
    (the default pages in steady state, the tuned one clears, at <= 3%
    throughput cost). Only at the canonical size: ``CELL_SWEEP``'s grids
    pin the world of 102,400 entities."""
    if result.get("entities") != CANONICAL_N:
        raise _SkipSelfTune()
    cells = {cg: f"cell_{int(cg[0])}" for cg in CELL_SWEEP}
    head_cfg = (result.get("cell_size"), result.get("grid"),
                result.get("max_events"), result.get("drain_mode"))
    best_cell = max(
        (cg for cg in cells if "updates_per_sec" in sweep.get(cells[cg], {})),
        key=lambda cg: sweep[cells[cg]]["updates_per_sec"],
        default=(head_cfg[0], head_cfg[1]))
    # Budgets whose steady state clears the inline buffer first (a paged
    # tick pays a second drain round trip), then throughput.
    best_me = max(
        (me for me in EVENTS_SWEEP
         if "updates_per_sec" in esweep.get(f"max_events_{me}", {})),
        key=lambda me: (
            esweep[f"max_events_{me}"].get("paged_ticks", 1) == 0,
            esweep[f"max_events_{me}"]["updates_per_sec"]),
        default=head_cfg[2])
    best_dm = max(
        (dm for dm in DRAIN_SWEEP
         if "updates_per_sec" in dsweep.get(f"drain_{dm}", {})),
        key=lambda dm: dsweep[f"drain_{dm}"]["updates_per_sec"],
        default=head_cfg[3])
    if (best_cell[0], best_cell[1], best_me, best_dm) == head_cfg:
        configs["self_tune"] = {"kept": "the default config is the "
                                        "sweeps' best"}
        return
    tuned = bench_aoi(label="aoi_tuned", cell_override=best_cell[0],
                      grid_override=best_cell[1],
                      max_events_override=best_me, drain_mode=best_dm,
                      device=device)
    tuned["tuned_cell"] = best_cell[0]
    tuned["tuned_grid"] = best_cell[1]
    tuned["tuned_max_events"] = best_me
    tuned["tuned_drain_mode"] = best_dm
    promote = tuned["value"] > result["value"]
    if (not promote
            and not result.get("inline_budget_clears_steady_state", True)
            and tuned.get("inline_budget_clears_steady_state")
            and tuned["value"] >= 0.97 * result["value"]):
        promote = True
        tuned["promoted_for_paging_hygiene"] = True
    if promote:
        configs["default_config_headline"] = {
            k: result[k] for k in (
                "value", "ticks_per_sec", "diff_latency_p99_ms",
                "post_step_drain_p99_ms", "post_step_drain_meets_target",
                "inline_budget_clears_steady_state")}
        # The phase profile was measured at the default config: it stays
        # with those numbers.
        if "phases" in result:
            configs["default_config_headline"]["phases"] = result.pop(
                "phases")
        for k, v in tuned.items():
            if k != "metric":
                result[k] = v
    else:
        configs["tuned_not_better"] = {"value": tuned["value"],
                                       "cell": best_cell[0],
                                       "max_events": best_me}


def _card_configs(result: dict, configs: dict, device) -> None:
    """The card's part of the ``all`` run: ``synthetic_10k``, ``boids_50k``,
    the phase profile, the three sweeps at ``BENCH_SWEEP_STEPS`` and the
    self-tune. Each failure lands in its own entry's ``error``."""
    try:
        # BASELINE config 2: 10k random-walk entities on one device.
        configs["synthetic_10k"] = bench_aoi(n=10240, label="aoi_10k",
                                             device=device)
    except Exception:
        configs["synthetic_10k"] = {"error": _exc_line()}
    try:
        configs["boids_50k"] = bench_boids_tuned(device=device)
    except Exception:
        configs["boids_50k"] = {"error": _exc_line()}
    try:
        result["phases"] = bench_phase_profile(
            n=result["entities"], cell=result["cell_size"],
            grid=result["grid"], device=device)
    except Exception:
        result["phases"] = {"error": _exc_line()}
    sweep_steps = int(os.environ.get("BENCH_SWEEP_STEPS", "12"))
    sweep = {}
    for cell, grid in CELL_SWEEP:
        try:
            r = bench_aoi(label=f"cell{int(cell)}", cell_override=cell,
                          grid_override=grid, device=device,
                          steps=sweep_steps)
            sweep[f"cell_{int(cell)}"] = _sweep_entry(r)
        except Exception:
            sweep[f"cell_{int(cell)}"] = {"error": _exc_line()}
    configs["cell_sweep"] = sweep
    # The drain's cost scales with max_events.
    esweep = {}
    for me in EVENTS_SWEEP:
        try:
            r = bench_aoi(label=f"me{me}", max_events_override=me,
                          device=device, steps=sweep_steps)
            esweep[f"max_events_{me}"] = _sweep_entry(r, "paged_ticks")
        except Exception:
            esweep[f"max_events_{me}"] = {"error": _exc_line()}
    configs["events_sweep"] = esweep
    # The drain's word-select strategies: the same events, other gathers.
    dsweep = {}
    for dm in DRAIN_SWEEP:
        try:
            r = bench_aoi(label=f"drain_{dm}", drain_mode=dm, device=device,
                          steps=sweep_steps)
            dsweep[f"drain_{dm}"] = _sweep_entry(r)
        except Exception:
            dsweep[f"drain_{dm}"] = {"error": _exc_line()}
    configs["drain_sweep"] = dsweep
    try:
        _self_tune(result, configs, sweep, esweep, dsweep, device)
    except _SkipSelfTune:
        configs["self_tune"] = {
            "skipped": f"BENCH_N != {CANONICAL_N} (sweep grids pin the "
                       f"canonical world size)"}
    except Exception:
        configs["self_tune"] = {"error": _exc_line()}


def bench_default(device=None) -> dict:
    """The default run (no mode flag), by ``BENCH_MODE``: ``aoi``,
    ``boids``, ``multispace`` or ``all`` (the default). The card's branch
    runs on the card, or on any device under ``BENCH_REHEARSAL=1``."""
    mode = os.environ.get("BENCH_MODE", "all")
    rehearsal = os.environ.get("BENCH_REHEARSAL") == "1"
    on_card = device is None or _resolve(device).type == "cuda"
    card_branch = on_card or rehearsal
    try:
        if mode == "boids":
            if not card_branch:
                result = {
                    "metric": "boids_agent_updates_per_sec", "value": 0.0,
                    "unit": "agent-updates/sec", "vs_baseline": 0.0,
                    "skipped": "requires the card (the CUDA boids kernel)",
                }
            else:
                result = bench_boids_tuned(device=device)
        elif mode == "aoi":
            result = bench_aoi(device=device)
        elif mode == "multispace":
            result = bench_aoi(space_slots=32, n_spaces=32,
                               label="aoi_32space", device=device)
        else:  # all: the headline, then the other BASELINE configs
            result = bench_aoi(label="aoi", device=device)
            result["metric"] = "aoi_entity_updates_per_sec_100k"
            configs: dict = {}
            try:
                configs["multispace_32"] = bench_aoi(
                    n=int(os.environ.get("BENCH_N", str(CANONICAL_N))),
                    space_slots=32, n_spaces=32, label="aoi_32space",
                    device=device)
            except Exception:
                configs["multispace_32"] = {"error": _exc_line()}
            configs["unity_200"] = {"covered_by": UNITY_200_COVERED_BY}
            if card_branch:
                _card_configs(result, configs, device)
            else:
                configs["boids_50k"] = {
                    "skipped": "requires the card (the CUDA boids kernel)"}
            configs["pod_1m"] = {"covered_by": POD_1M_COVERED_BY}
            result["configs"] = configs
    except Exception:
        result = {
            "metric": "aoi_entity_updates_per_sec_100k", "value": 0.0,
            "unit": "entity-updates/sec", "vs_baseline": 0.0,
            "error": traceback.format_exc(limit=4),
        }
    result["platform"] = "gpu" if on_card else "cpu"
    if rehearsal:
        result["rehearsal"] = True
    return result


def headline_of(result: dict) -> dict:
    """The compact headline the default run prints last."""
    return {k: result[k] for k in ("metric", "value", "unit", "vs_baseline",
                                   "platform", "backend", "device", "error")
            if k in result}


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


# --- the cluster modes: fan-out, trace overhead, multigame -------------------

# The fan-out mode: a real in-process cluster (dispatcher, game, gates over
# localhost TCP) with N bot sockets whose avatars share one AOI space, so
# every position change fans out to every other bot's client. It measures
# the host half of the sync pipeline end to end: the slab flag scan, the
# per-gate record pack, dispatcher routing, the gate's demux, the coalesced
# client writes. The game runs [aoi] backend = xzlist, as bench.py's does:
# no engine, no card. 80 bots at 5 ms offer ~1.26 M records/s, so the loop
# saturates and the number is capacity.
FANOUT_CONFIG = {
    "bots": 80, "gates": 1, "sync_interval": 0.005, "measure_s": 2.0,
    "windows": 3, "aoi_distance": 100.0,
}
# The multi-gate variant: 2 gates x 52 bots, so the game packs one buffer a
# gate and each gate demuxes its own stream.
FANOUT_MULTI_CONFIG = {
    "bots": 104, "gates": 2, "sync_interval": 0.005, "measure_s": 2.0,
    "windows": 2, "aoi_distance": 400.0,
}

# The fan-out pipeline's hops, as the game, dispatcher and gate services
# count them in fanout_hop_seconds_total{hop}.
FANOUT_HOPS = ("game_collect", "game_pack", "game_send",
               "dispatcher_route", "gate_demux", "client_write")

# The repo's root: the bot fleets and the fresh bench processes run from it.
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _hop_seconds() -> dict[str, float]:
    from goworld_tpu_torch import telemetry

    fam = telemetry.counter(
        "fanout_hop_seconds_total", "", ("hop",))
    return {h: fam.labels(h).value for h in FANOUT_HOPS}


def bench_fanout(trace_sample_rate: int | None = None,
                 config: dict | None = None) -> dict:
    """``--fanout``: delivered sync records/s at ``FANOUT_CONFIG``, best of
    ``windows`` measurement windows over one live cluster.
    ``trace_sample_rate`` overrides [telemetry] trace_sample_rate for the
    cluster (None keeps the default 1/1024, or ``BENCH_TRACE_SAMPLE_RATE``);
    ``config`` selects another fixed shape (``FANOUT_MULTI_CONFIG``).

    The line carries ``hop_busy_ms`` and ``hop_shares``: the busy wall time
    of each pipeline stage over the windows and its share, so a regression
    names its hop."""
    import asyncio
    import tempfile

    c = config or FANOUT_CONFIG
    if trace_sample_rate is None and "BENCH_TRACE_SAMPLE_RATE" in os.environ:
        trace_sample_rate = int(os.environ["BENCH_TRACE_SAMPLE_RATE"])

    async def run() -> tuple[list[float], dict]:
        from goworld_tpu_torch.config.read_config import (
            AOIConfig,
            DeploymentConfig,
            DispatcherConfig,
            GameConfig,
            GateConfig,
            GoWorldConfig,
            KVDBConfig,
            StorageConfig,
            TelemetryConfig,
        )
        from goworld_tpu_torch.dispatcher import DispatcherService
        from goworld_tpu_torch.entity import entity_manager as em
        from goworld_tpu_torch.entity.entity import Entity
        from goworld_tpu_torch.entity.space import Space
        from goworld_tpu_torch.entity.vector import Vector3
        from goworld_tpu_torch.game import GameService
        from goworld_tpu_torch.gate import GateService
        from goworld_tpu_torch.netutil.packet_conn import (
            ConnectionClosed,
            PacketConnection,
        )
        from goworld_tpu_torch.proto.conn import (
            SYNC_RECORD_SIZE,
            GoWorldConnection,
        )
        from goworld_tpu_torch.proto.msgtypes import MsgType

        n_bots = c["bots"]
        n_gates = c.get("gates", 1)
        holder: dict = {"arena": None, "joined": 0}

        class FanSpace(Space):
            def on_space_created(self):
                if self.kind == 1:
                    self.enable_aoi(c["aoi_distance"])
                    holder["arena"] = self

        class FanAvatar(Entity):
            # One on_tick_batch call a game tick jitters every avatar's x in
            # one vectorized write; the cadence accumulator and the jitter
            # phase are Column attrs, so the fan-out rides the columnar
            # read/write path.

            @classmethod
            def describe_entity_type(cls, desc):
                desc.set_use_aoi(True, c["aoi_distance"])
                desc.define_attr("accum", "Column")
                desc.define_attr("phase", "Column")

            def on_client_connected(self):
                arena = holder["arena"]
                if arena is not None:
                    # Clustered well inside one AOI radius (full N x N
                    # interest); the spacing shrinks past 30 bots so the
                    # whole line still fits the radius.
                    gap = min(3.0, 90.0 / max(1, n_bots))
                    x = gap * holder["joined"]
                    holder["joined"] += 1
                    self.enter_space(arena.id, Vector3(x, 0.0, 10.0))

            @classmethod
            def on_tick_batch(cls, view):
                # Every avatar shares the tick's dt, so all cross the
                # cadence together.
                accum = view.col("accum") + view.dt
                if accum.max(initial=0.0) < c["sync_interval"]:
                    view.set_col("accum", accum)
                    return
                # Carry the residual (capped), so a late loop iteration
                # does not stretch the average cadence.
                view.set_col(
                    "accum",
                    np.minimum(accum - c["sync_interval"],
                               c["sync_interval"]))
                phase = 1.0 - view.col("phase")
                view.set_col("phase", phase)
                # Half a unit in place on odd phases: never leaving the
                # shared neighborhood.
                view.set_position_yaw(x=np.floor(view.x) + 0.5 * phase)

        class Bot:
            def __init__(self) -> None:
                self.records = 0
                self.task = None
                self.conn = None

            async def pump(self, host: str, port: int) -> None:
                reader, writer = await asyncio.open_connection(host, port)
                self.conn = GoWorldConnection(PacketConnection(reader, writer))
                try:
                    while True:
                        msgtype, packet = await self.conn.recv()
                        if msgtype == MsgType.SYNC_POSITION_YAW_ON_CLIENTS:
                            self.records += (
                                len(packet.payload) // SYNC_RECORD_SIZE
                            )
                except (ConnectionClosed, asyncio.CancelledError):
                    pass

        em.cleanup_for_tests()
        tmp = tempfile.TemporaryDirectory(prefix="bench_fanout_")
        bots = [Bot() for _ in range(n_bots)]
        disp = game = game_task = None
        gates: list = []
        try:
            em.register_space(FanSpace)
            em.register_entity(FanAvatar)
            disp = DispatcherService(1, desired_games=1,
                                     desired_gates=n_gates)
            await disp.start()
            cfg = GoWorldConfig()
            cfg.deployment = DeploymentConfig(
                desired_games=1, desired_gates=n_gates,
                desired_dispatchers=1)
            cfg.dispatchers = {1: DispatcherConfig(port=disp.port)}
            cfg.games = {1: GameConfig(
                boot_entity="FanAvatar", save_interval=0.0,
                position_sync_interval=c["sync_interval"])}
            cfg.gates = {
                g: GateConfig(
                    port=0, position_sync_interval=c["sync_interval"],
                    heartbeat_timeout=0.0)
                for g in range(1, n_gates + 1)
            }
            cfg.aoi = AOIConfig(backend="xzlist")  # the host pipeline only
            cfg.storage = StorageConfig(
                type="filesystem", directory=tmp.name + "/es")
            cfg.kvdb = KVDBConfig(
                type="filesystem", directory=tmp.name + "/kv")
            if trace_sample_rate is not None:
                cfg.telemetry = TelemetryConfig(
                    trace_sample_rate=trace_sample_rate)
            game = GameService(1, cfg, restore=False)
            game_task = asyncio.get_running_loop().create_task(
                game.run_async())
            for g in range(1, n_gates + 1):
                gate = GateService(g, cfg)
                await gate.start()
                gates.append(gate)
            for _ in range(1000):
                if game.deployment_ready:
                    break
                await asyncio.sleep(0.01)
            assert game.deployment_ready, "cluster never became ready"
            em.create_space_locally(1)
            assert holder["arena"] is not None
            for i, b in enumerate(bots):
                b.task = asyncio.get_running_loop().create_task(
                    b.pump("127.0.0.1", gates[i % n_gates].port))

            # Full mutual interest: the steady-state fan-out world.
            def satur():
                avs = [e for e in em.entities().values()
                       if e.typename == "FanAvatar" and e.client is not None]
                return (len(avs) == n_bots and all(
                    len(a.interested_by) == n_bots - 1 for a in avs))
            for _ in range(2000):
                if satur():
                    break
                await asyncio.sleep(0.01)
            assert satur(), "bots never reached full mutual AOI interest"
            slab_entities = em.runtime.slabs.used
            rates = []
            await asyncio.sleep(0.5)  # settle: first packets in flight
            hops0 = _hop_seconds()
            for _ in range(c["windows"]):
                base = sum(b.records for b in bots)
                t0 = time.perf_counter()
                await asyncio.sleep(c["measure_s"])
                dt = time.perf_counter() - t0
                rates.append(
                    (sum(b.records for b in bots) - base) / dt)
            hops1 = _hop_seconds()
            hop_ms = {h: round((hops1[h] - hops0[h]) * 1000.0, 2)
                      for h in FANOUT_HOPS}
            total = sum(hop_ms.values()) or 1.0
            hops = {
                "hop_busy_ms": hop_ms,
                "hop_shares": {h: round(v / total, 3)
                               for h, v in hop_ms.items()},
                # The sync path measured: the columnar collect over this
                # many live slab slots.
                "sync_path": "slab",
                "slab_entities": int(slab_entities),
            }
            return rates, hops
        finally:
            for b in bots:
                if b.task is not None:
                    b.task.cancel()
                if b.conn is not None:
                    b.conn.close()
            for gate in gates:
                await gate.stop()
            if game is not None:
                game.terminate()
                try:
                    await asyncio.wait_for(game_task, timeout=10)
                except Exception:
                    pass
            if disp is not None:
                await disp.stop()
            from goworld_tpu_torch import kvdb, storage

            storage.set_backend(None)
            kvdb.set_backend(None)
            em.cleanup_for_tests()
            tmp.cleanup()

    retraces0 = _steady_state_retraces()
    rates, hops = asyncio.run(run())
    out = {
        "metric": ("fanout_sync_records_per_sec"
                   if c.get("gates", 1) == 1
                   else "fanout_multi_sync_records_per_sec"),
        "value": round(max(rates), 1),
        "unit": "sync-records/sec",
        "runs": [round(r, 1) for r in rates],
        # How many real client sockets, across how many gates, the number
        # serves.
        "clients": c["bots"],
        "gates": c.get("gates", 1),
        "config": dict(c),
        "platform": "cpu",
        "backend": "xzlist",
        "device": "cpu",
        "steady_state_retraces": _steady_state_retraces() - retraces0,
        "floor_file": None,
    }
    out.update(hops)
    return out


def _fanout_tier1_env(flag: str = "--fanout", timeout: float = 600) -> dict:
    """``python -m goworld_tpu_torch.bench <flag>`` in a fresh process: the
    mode reads process-global counters and the entity manager, which a run
    before it in the same interpreter would leak into. The process is
    killed at ``timeout`` seconds. Returns the mode's JSON line."""
    import subprocess

    env = dict(os.environ, PYTHONPATH=_REPO)
    r = subprocess.run(
        [sys.executable, "-m", "goworld_tpu_torch.bench", flag],
        capture_output=True, text=True, env=env, timeout=timeout,
        check=True, cwd=_REPO,
    )
    return json.loads(r.stdout.strip().splitlines()[-1])


def bench_fanout_multi() -> dict:
    """``--fanout-multi``: the 2-gate x 104-bot fan-out
    (``FANOUT_MULTI_CONFIG``)."""
    return bench_fanout(config=FANOUT_MULTI_CONFIG)


# The massive fan-out: 1,008 real client sockets, 4 bot-fleet subprocesses of
# 252 bots (chaos/botfleet.py) across 2 in-process gates, one dispatcher, one
# game, one AOI space. Avatars sit on a 42 x 24 grid at 55-unit spacing with
# a 100-unit radius: an interior avatar watches 8 neighbors (4 at 55 units
# in the middle cadence tier, 4 at 77.8 in the far tier), and every avatar
# jitters in lockstep each sync interval, so tiers never reclassify. Two
# phases over the same cluster and movement: "full" (full rate and
# precision), then "tiered" (cadence tiers and quantized deltas, the value).
# Then a gate kill and reconnect storm: gate 2 stops, its 504 clients re-dial
# gate 1, judged by the collector's census (1,008 conserved, no alert) and
# the fleets' strict decode (no delta before its keyframe).
FANOUT_MASSIVE_CONFIG = {
    "bots": 1008, "gates": 2, "fleets": 4, "cols": 42,
    "spacing": 55.0, "aoi_distance": 100.0, "sync_interval": 0.1,
    "measure_s": 4.0, "windows": 2, "settle_s": 2.0,
    "tier_cadences": (1, 8, 32), "quantize_bits": 7,
    "keyframe_interval": 64, "near_ratio": 0.5, "far_ratio": 0.8,
    "storm": True,
}


def bench_fanout_massive() -> dict:
    """``--fanout-massive``: delivered records/s of the tiered phase at
    ``FANOUT_MASSIVE_CONFIG``, with both phases' records/s and bytes a
    client a second, their ratio, and the reconnect storm's recovery."""
    import asyncio
    import tempfile

    c = FANOUT_MASSIVE_CONFIG

    async def run() -> dict:
        from goworld_tpu_torch.config.read_config import (
            AOIConfig,
            DeploymentConfig,
            DispatcherConfig,
            GameConfig,
            GateConfig,
            GoWorldConfig,
            KVDBConfig,
            StorageConfig,
        )
        from goworld_tpu_torch.dispatcher import DispatcherService
        from goworld_tpu_torch.entity import entity_manager as em
        from goworld_tpu_torch.entity.entity import Entity
        from goworld_tpu_torch.entity.slabs import SyncTuning
        from goworld_tpu_torch.entity.space import Space
        from goworld_tpu_torch.entity.vector import Vector3
        from goworld_tpu_torch.game import GameService
        from goworld_tpu_torch.gate import GateService

        n_bots = c["bots"]
        n_gates = c["gates"]
        holder: dict = {"arena": None, "joined": 0, "move": False}

        class MassSpace(Space):
            def on_space_created(self):
                if self.kind == 1:
                    self.enable_aoi(c["aoi_distance"])
                    holder["arena"] = self

        class MassAvatar(Entity):
            @classmethod
            def describe_entity_type(cls, desc):
                desc.set_use_aoi(True, c["aoi_distance"])
                desc.define_attr("accum", "Column")
                desc.define_attr("phase", "Column")

            def on_client_connected(self):
                arena = holder["arena"]
                if arena is not None:
                    i = holder["joined"]
                    holder["joined"] += 1
                    x = c["spacing"] * (i % c["cols"])
                    z = c["spacing"] * (i // c["cols"])
                    self.enter_space(arena.id, Vector3(x, 0.0, z))

            def on_client_disconnected(self):
                # An orphaned boot avatar dies, so the census re-converges
                # at the bot count after the storm.
                self.destroy()

            @classmethod
            def on_tick_batch(cls, view):
                if not holder["move"]:
                    return
                accum = view.col("accum") + view.dt
                if accum.max(initial=0.0) < c["sync_interval"]:
                    view.set_col("accum", accum)
                    return
                view.set_col(
                    "accum",
                    np.minimum(accum - c["sync_interval"],
                               c["sync_interval"]))
                phase = 1.0 - view.col("phase")
                view.set_col("phase", phase)
                # Lockstep: every x moves by the same half unit each beat,
                # so pairwise distances and tiers stay fixed.
                view.set_position_yaw(x=np.floor(view.x) + 0.5 * phase)

        async def fleet_spawn(ports: list[int], bots: int):
            # One torch thread a fleet: four fleets share the host with the
            # cluster.
            return await asyncio.create_subprocess_exec(
                sys.executable, "-m", "goworld_tpu_torch.chaos.botfleet",
                "--gates", ",".join(str(p) for p in ports),
                "--bots", str(bots), "--stagger-ms", "3",
                stdin=asyncio.subprocess.PIPE,
                stdout=asyncio.subprocess.PIPE,
                stderr=asyncio.subprocess.DEVNULL,
                cwd=_REPO,
                env=dict(os.environ, PYTHONPATH=_REPO, OMP_NUM_THREADS="1"),
            )

        async def fleet_read(proc) -> dict:
            line = await asyncio.wait_for(proc.stdout.readline(), 60)
            if not line:
                raise RuntimeError("bot fleet died (empty stdout)")
            return json.loads(line)

        async def fleet_cmd(proc, cmd: str) -> dict:
            proc.stdin.write(
                (json.dumps({"cmd": cmd}) + "\n").encode())
            await proc.stdin.drain()
            return await fleet_read(proc)

        async def fleets_report(procs) -> dict:
            reports = []
            for p in procs:
                reports.append(await fleet_cmd(p, "report"))
            return {
                k: sum(r[k] for r in reports)
                for k in ("bots", "alive", "players", "entities",
                          "keyframes", "deltas", "records",
                          "sync_bytes", "sync_packets", "errors")
            } | {"error_samples": [s for r in reports
                                   for s in r["error_samples"]][:5]}

        async def measure(procs, seconds: float, windows: int) -> dict:
            best = None
            for _ in range(windows):
                a = await fleets_report(procs)
                t0 = time.perf_counter()
                await asyncio.sleep(seconds)
                dt = time.perf_counter() - t0
                b = await fleets_report(procs)
                w = {
                    "records_per_s": (b["records"] - a["records"]) / dt,
                    "keyframes_per_s":
                        (b["keyframes"] - a["keyframes"]) / dt,
                    "deltas_per_s": (b["deltas"] - a["deltas"]) / dt,
                    "bytes_per_client_s":
                        (b["sync_bytes"] - a["sync_bytes"]) / dt / n_bots,
                }
                if best is None or w["records_per_s"] > best["records_per_s"]:
                    best = w
                best["errors"] = b["errors"]
            return {k: round(v, 1) for k, v in best.items()}

        em.cleanup_for_tests()
        tmp = tempfile.TemporaryDirectory(prefix="bench_massive_")
        disp = game = game_task = None
        gates: list = []
        procs: list = []
        try:
            em.register_space(MassSpace)
            em.register_entity(MassAvatar)
            disp = DispatcherService(1, desired_games=1,
                                     desired_gates=n_gates)
            await disp.start()
            cfg = GoWorldConfig()
            cfg.deployment = DeploymentConfig(
                desired_games=1, desired_gates=n_gates,
                desired_dispatchers=1)
            cfg.dispatchers = {1: DispatcherConfig(port=disp.port)}
            cfg.games = {1: GameConfig(
                boot_entity="MassAvatar", save_interval=0.0,
                position_sync_interval=c["sync_interval"])}
            cfg.gates = {
                g: GateConfig(port=0, heartbeat_timeout=0.0)
                for g in range(1, n_gates + 1)
            }
            cfg.aoi = AOIConfig(backend="xzlist")  # the host pipeline only
            cfg.storage = StorageConfig(
                type="filesystem", directory=tmp.name + "/es")
            cfg.kvdb = KVDBConfig(
                type="filesystem", directory=tmp.name + "/kv")
            game = GameService(1, cfg, restore=False)
            game_task = asyncio.get_running_loop().create_task(
                game.run_async())
            for g in range(1, n_gates + 1):
                gate = GateService(g, cfg)
                await gate.start()
                gates.append(gate)
            for _ in range(1000):
                if game.deployment_ready:
                    break
                await asyncio.sleep(0.01)
            assert game.deployment_ready, "cluster never became ready"
            em.create_space_locally(1)
            assert holder["arena"] is not None

            ports = [g.port for g in gates]
            per_fleet = n_bots // c["fleets"]
            assert per_fleet * c["fleets"] == n_bots
            for _ in range(c["fleets"]):
                procs.append(await fleet_spawn(ports, per_fleet))
            for p in procs:
                ready = await asyncio.wait_for(fleet_read(p), 180)
                assert ready.get("ready") == per_fleet, ready
            # Boot convergence: every bot owns a player and the interest
            # graph's edge count held for a second.
            slabs = em.runtime.slabs
            stable_since = None
            last_edges = -1
            deadline = time.monotonic() + 180
            while time.monotonic() < deadline:
                r = await fleets_report(procs)
                edges = slabs.edge_count()
                if r["players"] == n_bots and edges == last_edges:
                    if stable_since is None:
                        stable_since = time.monotonic()
                    elif time.monotonic() - stable_since > 1.0:
                        break
                else:
                    stable_since = None
                last_edges = edges
                await asyncio.sleep(0.25)
            else:
                raise AssertionError(
                    f"massive boot never converged: {r} edges={last_edges}")
            out: dict = {
                "clients": n_bots,
                "gates": n_gates,
                "fleets": c["fleets"],
                "edges": int(slabs.edge_count()),
                "entities": len(em.entities()) - 1,  # minus the space
            }

            # Phase 1: full rate and full precision.
            slabs.configure_sync(SyncTuning())
            holder["move"] = True
            await asyncio.sleep(c["settle_s"])
            out["full"] = await measure(
                procs, c["measure_s"], c["windows"])
            # Phase 2: cadence tiers and quantized deltas; the baselines
            # re-establish through one keyframe wave.
            slabs.configure_sync(SyncTuning(
                tier_cadences=c["tier_cadences"],
                quantize_bits=c["quantize_bits"],
                keyframe_interval=c["keyframe_interval"],
                near_ratio=c["near_ratio"], far_ratio=c["far_ratio"],
            ))
            await asyncio.sleep(c["settle_s"])
            out["tiered"] = await measure(
                procs, c["measure_s"], c["windows"])
            fb = out["full"]["bytes_per_client_s"]
            tb = out["tiered"]["bytes_per_client_s"]
            out["bytes_per_client_s"] = tb
            out["full_equiv_bytes_per_client_s"] = fb
            out["bytes_reduction"] = round(fb / max(tb, 1e-9), 2)
            out["records_reduction"] = round(
                out["full"]["records_per_s"]
                / max(out["tiered"]["records_per_s"], 1e-9), 2)
            out["tier_edges"] = {
                str(t): int(n) for t, n in enumerate(
                    np.bincount(
                        slabs._e_tier[:slabs.edge_count()],
                        minlength=len(c["tier_cadences"])).tolist())
            }

            if c.get("storm"):
                # Movement stays on through the storm: reconnected clients
                # must decode the live stream, keyframes first.
                out["reconnect_storm"] = await _massive_storm(
                    c, disp, game, gates, procs, fleets_report, fleet_cmd,
                    n_bots)
            holder["move"] = False
            r = await fleets_report(procs)
            out["bot_errors"] = r["errors"]
            out["bot_error_samples"] = r["error_samples"]
            return out
        finally:
            for p in procs:
                try:
                    p.stdin.close()
                except Exception:
                    pass
            for p in procs:
                try:
                    await asyncio.wait_for(p.wait(), 10)
                except Exception:
                    p.kill()
            for gate in gates:
                try:
                    await gate.stop()
                except Exception:
                    pass
            if game is not None:
                game.terminate()
                try:
                    await asyncio.wait_for(game_task, timeout=15)
                except Exception:
                    pass
            if disp is not None:
                await disp.stop()
            from goworld_tpu_torch import kvdb, storage

            storage.set_backend(None)
            kvdb.set_backend(None)
            em.cleanup_for_tests()
            tmp.cleanup()

    retraces0 = _steady_state_retraces()
    result = asyncio.run(run())
    out = {
        "metric": "fanout_massive_sync_records_per_sec",
        "value": result["tiered"]["records_per_s"],
        "unit": "sync-records/sec",
        "runs": [result["tiered"]["records_per_s"]],
        "config": {k: list(v) if isinstance(v, tuple) else v
                   for k, v in c.items()},
        "platform": "cpu",
        "backend": "xzlist",
        "device": "cpu",
        "steady_state_retraces": _steady_state_retraces() - retraces0,
        "floor_file": None,
    }
    out.update(result)
    return out


async def _massive_storm(c, disp, game, gates, procs, fleets_report,
                         fleet_cmd, n_bots: int) -> dict:
    """Gate kill and reconnect storm at the massive client count, judged by
    an in-process ``ClusterCollector`` over the live services: stop gate 2,
    re-dial its clients against gate 1, then poll until every surviving
    process reports, the client census is conserved at the bot count and
    no alert remains. The fleets' strict decode counts a delta before its
    keyframe as a bot error (zero required)."""
    import asyncio

    from goworld_tpu_torch.telemetry.collector import ClusterCollector

    t0 = time.monotonic()
    errors_before = (await fleets_report(procs))["errors"]
    await gates[1].stop()
    del gates[1]
    # Every dead bot walks the gate list and lands on the survivor.
    reconnected = 0
    for p in procs:
        r = await fleet_cmd(p, "reconnect_dead")
        reconnected += r["reconnected"]
        assert r["failed"] == 0, r

    def targets():
        async def disp_fetch() -> dict:
            return {"health": disp._health(), "metrics": {}}

        async def game_fetch() -> dict:
            return {"health": game._health(), "metrics": {}}

        async def gate_fetch() -> dict:
            return {"health": gates[0]._health(), "metrics": {}}

        return [("dispatcher1", disp_fetch), ("game1", game_fetch),
                ("gate1", gate_fetch)]

    coll = ClusterCollector(targets(), interval=0.05)
    deadline = time.monotonic() + 60
    last = None
    converged = None
    while time.monotonic() < deadline:
        await coll.poll_once()
        summary = coll.view()["summary"]
        census = summary["census"]
        r = await fleets_report(procs)
        if (summary["reporting"] == summary["expected"]
                and not summary["alerts"]
                and census["clients_conserved"]
                and census["gate_clients"] == n_bots
                and r["players"] == n_bots):
            converged = time.monotonic() - t0
            break
        last = summary
        await asyncio.sleep(0.2)
    if converged is None:
        raise AssertionError(
            f"massive reconnect storm never converged: {last}")
    # Movement after the storm: reconnected clients must decode cleanly.
    await asyncio.sleep(max(1.0, 10 * c["sync_interval"]))
    r = await fleets_report(procs)
    return {
        "reconnected": reconnected,
        "converge_s": round(converged, 3),
        "bot_errors": r["errors"] - errors_before,
        "census_clients": census["gate_clients"],  # the collector's count
    }


# Sampling denominators swept by --trace-overhead: off, the production
# default and trace-everything.
TRACE_OVERHEAD_RATES = (0, 1024, 1)


def bench_trace_overhead(device=None) -> dict:
    """``--trace-overhead``: the pinned floor and the fan-out at each
    sampling rate. The pinned floor is the AOI engine's loop on ``device``
    (the card by default), where tracing is absent: the control. The
    fan-out runs the packet path where the trace branch, the trailer and
    the span recording live. The value is the fan-out with tracing off.
    The caller's sampling rate is restored after."""
    from goworld_tpu_torch.telemetry import tracing

    dev = _resolve(device)
    out: dict = {
        "metric": "trace_overhead_sync_records_per_sec",
        "unit": "sync-records/sec",
        "rates": {},
        "platform": _platform(dev),
        "floor_file": None,
    }
    saved = tracing.sample_rate()
    try:
        for rate in TRACE_OVERHEAD_RATES:
            key = "off" if rate == 0 else f"1/{rate}"
            tracing.configure(sample_rate=rate)
            pinned = bench_pinned_floor(device=dev)
            fan = bench_fanout(trace_sample_rate=rate)
            out["rates"][key] = {
                "sample_rate": rate,
                "pinned_floor": pinned["value"],
                "fanout": fan["value"],
                "fanout_runs": fan["runs"],
                "backend": pinned["backend"],
                "device": pinned["device"],
            }
            out["backend"] = pinned["backend"]
            out["device"] = pinned["device"]
    finally:
        tracing.configure(sample_rate=saved)
    off = out["rates"].get("off", {}).get("fanout", 0.0)
    out["value"] = off  # the headline: the point that must be free
    full = out["rates"].get("1/1", {}).get("fanout", 0.0)
    if off:
        out["full_sampling_cost_pct"] = round(100.0 * (1.0 - full / off), 1)
    return out


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


# The live-rebalance run: 2 game subprocesses, 2 in-parent dispatchers, 1
# gate, 12 strict bots, xzlist AOI, every avatar booted onto game1 (game2 is
# boot-banned). The value is rebalance throughput: entities moved per second
# of convergence. The same run then migrates across a dispatcher restart
# (zero loss required).
MULTIGAME_CONFIG = {
    "bots": 12, "games": 2, "dispatchers": 2, "transport": "tcp",
}


def bench_multigame() -> dict:
    """``--multigame``: rebalance convergence on the 2-game cluster at
    ``MULTIGAME_CONFIG``, with the dispatcher-restart phase."""
    import tempfile

    from goworld_tpu_torch.chaos.multigame import run_multigame

    c = MULTIGAME_CONFIG
    with tempfile.TemporaryDirectory(prefix="bench_multigame_") as d:
        r = run_multigame(d, n_bots=c["bots"], transport=c["transport"],
                          with_restart_phase=True)
    value = r["migrations_done"] / max(r["convergence_s"], 1e-9)
    out = {
        "metric": "multigame_rebalance_entities_per_sec",
        "value": round(value, 2),
        "unit": "entities/sec",
        "runs": [round(value, 2)],
        "config": dict(c),
        "platform": "cpu",
        "backend": "xzlist",
        "device": "cpu",
        "floor_file": None,
    }
    out.update(r)
    return out


# The whole-space migration chaos run: 3 game subprocesses, the receivers
# booted without an arena (the planner can only move whole spaces), the
# planner in the sharded RebalancePlannerService, and three kill crosses:
# the receiver mid-PREPARE, the donor mid-COMMIT, the planner's host. The
# value is the crosses passed.
MULTIGAME_SPACES_CONFIG = {
    "bots": 12, "games": 3, "dispatchers": 2, "transport": "tcp",
}


def bench_multigame_spaces() -> dict:
    """``--multigame-spaces``: the whole-space migration chaos run at
    ``MULTIGAME_SPACES_CONFIG``; a cross passes with zero loss and no bot
    error."""
    import tempfile

    from goworld_tpu_torch.chaos.multigame import run_multigame_spaces

    c = MULTIGAME_SPACES_CONFIG
    with tempfile.TemporaryDirectory(prefix="bench_multigame_sp_") as d:
        r = run_multigame_spaces(d, n_bots=c["bots"], n_games=c["games"],
                                 transport=c["transport"])
    phases = r.get("phases", {})
    passed = sum(1 for p in phases.values()
                 if p.get("zero_loss") and not p.get("bot_errors"))
    out = {
        "metric": "multigame_space_kill_crosses_passed",
        "value": float(passed),
        "unit": "scenarios",
        "config": dict(c),
        "platform": "cpu",
        "backend": "xzlist",
        "device": "cpu",
    }
    out.update(r)
    return out


# The gate modes with a flag of their own: (flag's dest, function, metric,
# unit), in the root bench's order.
GATE_MODES = (
    ("fused", lambda a: bench_fused(device=a.device),
     "fused_entity_logic_collapse", "x"),
    ("pinned_floor", lambda a: bench_pinned_floor(device=a.device),
     "pinned_floor_updates_per_sec", "entity-updates/sec"),
    ("sharded", lambda a: bench_sharded(a.sharded_backend, device=a.device),
     "sharded_updates_per_sec", "entity-updates/sec"),
    ("fanout_multi", lambda a: bench_fanout_multi(),
     "fanout_multi_sync_records_per_sec", "sync-records/sec"),
    ("fanout_massive", lambda a: bench_fanout_massive(),
     "fanout_massive_sync_records_per_sec", "sync-records/sec"),
    ("fanout", lambda a: bench_fanout(),
     "fanout_sync_records_per_sec", "sync-records/sec"),
    ("multigame_spaces", lambda a: bench_multigame_spaces(),
     "multigame_space_kill_crosses_passed", "scenarios"),
    ("multigame", lambda a: bench_multigame(),
     "multigame_rebalance_entities_per_sec", "entities/sec"),
    ("chaos", lambda a: bench_chaos(slo=_slo(a.slo_config)),
     "chaos_scenarios_passed", "scenarios"),
    ("trace_overhead", lambda a: bench_trace_overhead(device=a.device),
     "trace_overhead_sync_records_per_sec", "sync-records/sec"),
)


def _run_bench(args) -> int:
    if args.list_scenarios:
        return list_scenarios(args.device)
    if args.scenario:
        metric, unit = "scenario_updates_per_sec", "entity-updates/sec"

        def run():
            return bench_scenario(
                args.scenario, args.scenario_engine,
                slo=_slo(args.slo_config), device=args.device)
    else:
        mode = next((m for m in GATE_MODES if getattr(args, m[0])), None)
        if mode is None:
            # The default run: the full record, then the compact headline
            # as the last line (a tail of the output keeps it whole).
            result = bench_default(device=args.device)
            print(json.dumps(result), flush=True)
            print(json.dumps(headline_of(result), separators=(",", ":")),
                  flush=True)
            return 0
        _, fn, metric, unit = mode

        def run():
            return fn(args)
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m goworld_tpu_torch.bench",
        description="The port's benchmark: JSON lines on stdout.")
    ap.add_argument("--sharded", action="store_true")
    ap.add_argument("--sharded-backend", choices=tuple(SHARDED_CONFIGS),
                    help="the strip engine's backend (default: kernel on "
                         "the card, reference on the CPU)")
    ap.add_argument("--fused", action="store_true")
    ap.add_argument("--pinned-floor", action="store_true")
    ap.add_argument("--scenario", metavar="NAME")
    ap.add_argument("--scenario-engine", default="batched",
                    choices=("batched", "sharded"))
    ap.add_argument("--list-scenarios", action="store_true")
    ap.add_argument("--chaos", action="store_true")
    ap.add_argument("--fanout", action="store_true")
    ap.add_argument("--fanout-multi", action="store_true")
    ap.add_argument("--fanout-massive", action="store_true")
    ap.add_argument("--trace-overhead", action="store_true")
    ap.add_argument("--multigame", action="store_true")
    ap.add_argument("--multigame-spaces", action="store_true")
    ap.add_argument("--history-dir", metavar="DIR",
                    help="write the run's telemetry ring under DIR/bench")
    ap.add_argument("--slo-config", metavar="INI")
    ap.add_argument("--device", choices=("cuda", "cpu"),
                    help="where the engines run (default: the card)")
    args = ap.parse_args(argv)

    hist = None
    if args.history_dir:
        from goworld_tpu_torch.ops import event_kernel
        from goworld_tpu_torch.telemetry import history as history_mod

        # The event kernel's launches by form, as its wrapper counts them
        # (a game exports the same gauge): the ring's frames carry them.
        event_kernel.register_launch_gauge()
        hist = history_mod.HistoryWriter(
            os.path.join(args.history_dir, "bench"), "bench")
        history_mod.set_active_writer(hist)
    try:
        return _run_bench(args)
    finally:
        if hist is not None:
            hist.close()  # the final frame: the whole run's deltas
            history_mod.clear_active_writer(hist)


if __name__ == "__main__":
    sys.exit(main())
