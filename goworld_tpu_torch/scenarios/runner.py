"""Scenario runner: one drive loop for every scenario on every engine.

``run_scenario(name, engine=...)`` makes two passes over the SAME seeded
world definition:

1. **verify pass** (untimed): the production pipelined ``step_async``
   loop with an interest-set oracle on the host — every enter must be
   fresh (not already interested, no duplicate within the tick), every
   leave must dissolve an existing pair, and the scenario's own
   ``observe()`` assertions run per tick.  A violation raises
   :class:`ScenarioInvariantError`; the headline never ships a number a
   wrong event stream produced.
2. **measure pass**: fresh world, same seed, best-of-``repeats`` timed
   pipelined runs (first step synchronous — compile + the enter storm —
   exactly like the pinned floor), yielding entity-updates/sec.

Engines: ``batched`` is the single-device ``NeighborEngine``;
``sharded`` is the grid-strip ``SpatialShardedNeighborEngine`` with its
``shards`` strips on one device (``parallel.make_mesh`` puts repeated
strips on one card). Both run on CUDA unless the caller passes
``device="cpu"``; on the card ``backend="auto"`` is the hand-written event
kernel, on the CPU the reference backend (or the kernel's plain versions
with ``backend="kernel"``). The scenario definition is identical either
way; only ``make_engine`` differs.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Set

import numpy as np

from goworld_tpu_torch.scenarios import (
    ScenarioInvariantError,
    ScenarioSpec,
    ScenarioWorld,
    get_scenario,
)


class InterestOracle:
    """Host-side mirror of the engine's interest set, keyed by directed
    pair id ``watcher * n + subject``.  O(events) per tick — NOT O(n^2);
    the oracle scales with the stream it checks."""

    def __init__(self, n: int) -> None:
        self.n = n
        self.pairs: Set[int] = set()

    def _keys(self, events: np.ndarray) -> List[int]:
        if len(events) == 0:
            return []
        ev = np.asarray(events, np.int64)
        return (ev[:, 0] * self.n + ev[:, 1]).tolist()

    def apply(self, t: int, enters: np.ndarray, leaves: np.ndarray) -> None:
        ek, lk = self._keys(enters), self._keys(leaves)
        if len(set(ek)) != len(ek):
            raise ScenarioInvariantError(
                f"tick {t}: duplicate enter events within one tick")
        if len(set(lk)) != len(lk):
            raise ScenarioInvariantError(
                f"tick {t}: duplicate leave events within one tick")
        for k in lk:
            if k not in self.pairs:
                raise ScenarioInvariantError(
                    f"tick {t}: leave for pair ({k // self.n}, "
                    f"{k % self.n}) that was never entered")
            self.pairs.discard(k)
        for k in ek:
            if k in self.pairs:
                raise ScenarioInvariantError(
                    f"tick {t}: enter for pair ({k // self.n}, "
                    f"{k % self.n}) already interested")
            self.pairs.add(k)

    def check_alive(self, active: np.ndarray) -> None:
        """End-of-run: no surviving pair may reference a dead entity —
        deactivation must have drained its edges through leave events."""
        for k in self.pairs:
            a, b = k // self.n, k % self.n
            if not (active[a] and active[b]):
                raise ScenarioInvariantError(
                    f"stale interest pair ({a}, {b}) survives a dead "
                    f"entity — deactivation did not emit its leaves")


def make_engine(config: Dict[str, Any], engine: str, device: Any = None,
                backend: str = "auto") -> Any:
    """Build the AOI engine a scenario runs on. ``batched`` | ``sharded``.

    ``device`` None means the card (and raises without one); ``backend``
    is ``auto`` | ``reference`` | ``kernel``; the strip engine has the
    kernel backend only (``auto`` is it), which runs the kernel's plain
    versions on CPU tensors. Nothing compiles lazily in PyTorch, so
    there is no platform pin and no fallback prewarm to turn off."""
    from goworld_tpu_torch.ops import NeighborEngine, NeighborParams

    params = NeighborParams(
        capacity=config.get("capacity", config["n"]),
        cell_size=config["cell_size"],
        grid_x=config["grid"], grid_z=config.get("grid_z", config["grid"]),
        space_slots=config["space_slots"],
        cell_capacity=config["cell_capacity"],
        max_events=config["max_events"],
    )
    if engine == "batched":
        return NeighborEngine(params, backend=backend, device=device)
    if engine == "sharded":
        from goworld_tpu_torch.parallel import make_mesh
        from goworld_tpu_torch.parallel.spatial import (
            SpatialShardedNeighborEngine,
        )

        return SpatialShardedNeighborEngine(
            params, make_mesh(int(config["shards"]), device),
            halo_cap=config.get("halo_cap"), backend=backend)
    raise ValueError(f"unknown scenario engine {engine!r} "
                     "(batched | sharded)")


def _drive(world: ScenarioWorld, eng: Any,
           oracle: Optional[InterestOracle]) -> None:
    """The production pipelined loop: dispatch tick t while collecting
    tick t-1's events (diffs land one dispatch late by design,
    ops/neighbor.py). ``observe``/oracle attribution follows the pending
    step's tick, so assertions see the right world state."""
    eng.reset()
    ticks = int(world.config["ticks"])
    pending, prev_t = None, -1
    for t in range(ticks):
        dirty = True if t == 0 else world.tick(t)
        nxt = eng.step_async(world.pos, world.active, world.space,
                             world.radius, meta_dirty=bool(dirty))
        if pending is not None:
            e, l, d = pending.collect()
            if oracle is not None:
                oracle.apply(prev_t, e, l)
            world.observe(prev_t, e, l, int(d))
        pending, prev_t = nxt, t
    e, l, d = pending.collect()
    if oracle is not None:
        oracle.apply(prev_t, e, l)
    world.observe(prev_t, e, l, int(d))


def _retrace_count() -> int:
    from goworld_tpu_torch.telemetry import sentinel

    return int(sentinel.steady_state_retraces())


# Every label a tick dispatch can launch its STEP under, across engines
# and backends (telemetry/sentinel.py).  The fallback decision on the
# spatial engine is made on the host BEFORE any launch (parallel/spatial.py
# step_async), so one dispatch fires exactly one of these — never two.
# Each step program counts its own calls, so a dispatch that ran two
# programs counts two.  Storm pages are deliberately absent: a storm tick pages through extra
# drain launches by design, and the one-launch pin is about the step, not
# the overflow path.
_STEP_LABELS = tuple(
    f"aoi_step_{kind}{bk}"
    for kind in ("", "fused_")
    for bk in ("reference", "kernel")
) + (
    "sharded_step", "sharded_step_fused", "sharded_step_kernel",
    "spatial_step_reference", "spatial_step_reference_fused",
    "spatial_step_kernel", "spatial_step_kernel_fused",
)


def _step_launches() -> int:
    from goworld_tpu_torch.telemetry import sentinel

    return int(sum(sentinel.launches_total(lb) for lb in _STEP_LABELS))


def _device_name(eng: Any) -> str:
    """The device an engine ran on: the card's name, or ``cpu``."""
    import torch

    dev = eng.mesh[0] if hasattr(eng, "mesh") else eng.device
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return str(dev)


def run_scenario(name: str, engine: Optional[str] = "batched",
                 seed: Optional[int] = -1,
                 ticks_scale: Optional[float] = 1.0,
                 slo: Any = None, device: Any = None,
                 backend: str = "auto") -> Dict[str, Any]:
    """Run a registered scenario end-to-end; returns the headline dict
    (bench.py prints it as the one JSON line).

    Passing ``None`` for engine/seed/ticks_scale consults the
    ``[scenario]`` ini section (ad-hoc/dev runs); the defaults (and
    bench.py's gate mode, which relies on them) never touch the ini, so
    committed floors cannot drift with an operator's config.  A negative
    seed — the default — means the registry's fixed per-scenario seed.

    ``slo`` is an optional :class:`SLOConfig`: when it has budgets set,
    the measure pass also records per-tick wall times and the run is
    judged against ``tick_p99_budget`` / ``steady_state_retraces`` —
    a violated budget raises :class:`SLOViolation` (the headline would
    have shipped a number the operator declared unacceptable). The
    per-tick clock reads happen ONLY under an active SLO gate, so the
    pinned floors' measure loop is untouched.

    The ``invariants`` sub-dict holds ONLY seed-deterministic fields —
    the determinism gate asserts two back-to-back runs produce it
    bit-identically.  Wall-clock numbers (value/runs/latencies) and
    engine-internal counters that may depend on timing live beside it.

    ``device`` and ``backend`` go to :func:`make_engine`: None is the
    card. The headline names the backend and the device that ran.
    """
    if engine is None or ticks_scale is None or seed is None:
        from goworld_tpu_torch.config import read_config

        sc = read_config.get().scenario
        if engine is None:
            engine = sc.default_engine
        if ticks_scale is None:
            ticks_scale = sc.ticks_scale
        if seed is None:
            seed = sc.seed
    if seed is not None and seed < 0:
        seed = None  # the registry's fixed per-scenario seed
    assert engine is not None and ticks_scale is not None
    spec: ScenarioSpec = get_scenario(name)
    retraces0 = _retrace_count()

    # Pass 1: verify — oracle + per-tick scenario assertions, untimed.
    world = spec.make(seed=seed, ticks_scale=ticks_scale)
    eng = make_engine(world.config, engine, device=device, backend=backend)
    world.setup()
    try:
        oracle = InterestOracle(world.cap)
        _drive(world, eng, oracle)
        oracle.check_alive(world.active)
        world.check_engine(eng, engine)
        invariants = world.invariants()
        extra = world.extra_headline()
    finally:
        world.teardown()

    # Pass 2: measure — fresh world, same seed, best-of-repeats timed.
    repeats = int(world.config.get("repeats", 1))
    ticks = int(world.config["ticks"])
    launches0 = _step_launches()
    slo_active = slo is not None and slo.enabled()
    tick_wall: List[float] = []
    runs: List[float] = []
    for _rep in range(repeats):
        w = spec.make(seed=seed, ticks_scale=ticks_scale)
        w.setup()
        try:
            eng.reset()
            # Sync first step: compile + the enter storm, off the clock
            # (the pinned-floor convention).
            eng.step(w.pos, w.active, w.space, w.radius)
            pending = None
            t0 = time.perf_counter()
            if slo_active:
                t_prev = t0
                for t in range(1, ticks):
                    dirty = w.tick(t)
                    nxt = eng.step_async(w.pos, w.active, w.space, w.radius,
                                         meta_dirty=bool(dirty))
                    if pending is not None:
                        pending.collect()
                    pending = nxt
                    now = time.perf_counter()
                    tick_wall.append(now - t_prev)
                    t_prev = now
            else:
                for t in range(1, ticks):
                    dirty = w.tick(t)
                    nxt = eng.step_async(w.pos, w.active, w.space, w.radius,
                                         meta_dirty=bool(dirty))
                    if pending is not None:
                        pending.collect()
                    pending = nxt
            if pending is not None:
                pending.collect()
            runs.append((ticks - 1) / (time.perf_counter() - t0) * w.n)
        finally:
            w.teardown()

    # One-launch pin: every measured tick must have cost
    # exactly one step launch — enter/leave storms, hotspot fallbacks
    # and strip re-plans included.  An extra launch means a hidden host
    # round-trip crept onto the steady path; a missing one means a tick
    # silently skipped the engine.  Hard gate, not a telemetry note.
    step_launches = _step_launches() - launches0
    ticks_dispatched = repeats * ticks
    if step_launches != ticks_dispatched:
        raise ScenarioInvariantError(
            f"one-launch pin violated: {ticks_dispatched} measured ticks "
            f"dispatched but {step_launches} step launches recorded")

    retraces = _retrace_count() - retraces0
    slo_verdict = None
    if slo_active:
        from goworld_tpu_torch.telemetry.slo import (
            SLOViolation,
            judge_values,
            render_verdict,
        )

        s = sorted(tick_wall)
        tick_p99 = s[max(0, -(-len(s) * 99 // 100) - 1)] if s else 0.0
        slo_verdict = judge_values(
            slo, tick_p99=tick_p99, steady_state_retraces=retraces)
        if not slo_verdict["ok"]:
            raise SLOViolation(
                f"scenario {name!r} violated its SLO: "
                f"{render_verdict(slo_verdict)}")

    headline: Dict[str, Any] = {
        "metric": f"scenario_{name}_updates_per_sec",
        "value": round(max(runs), 1),
        "unit": "entity-updates/sec",
        "runs": [round(r, 1) for r in runs],
        "scenario": name,
        "engine": engine,
        "backend": eng.backend,
        "device": _device_name(eng),
        "config": dict(spec.config),
        "seed": world.seed,
        "invariants": invariants,
        "steady_state_retraces": retraces,
        "step_launches": step_launches,
        "ticks_dispatched": ticks_dispatched,
        "one_launch_per_tick": True,
        "errors": 0,
    }
    if slo_verdict is not None:
        headline["slo"] = slo_verdict
    headline.update(extra)
    # Engine-internal counters: structural, but timing-adjacent on the
    # sharded tier (replan cadence), so they ride OUTSIDE invariants —
    # except the hotspot fallback count, which each scenario may choose
    # to pull INTO its invariants via engine_invariants().
    if engine == "sharded":
        headline["fallback_ticks"] = int(eng.total_fallbacks)
        headline["shard_migrations"] = int(eng.total_migrations)
        headline["fast_ticks"] = int(eng.total_fast_ticks)
    return headline
