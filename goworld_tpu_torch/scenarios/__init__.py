"""Scenario matrix: reproducible, seed-deterministic workloads.

Every committed floor before this package measured ONE workload shape —
mutually-interested bots on a uniform grid.  A scenario is a first-class
workload object instead: a movement model + entity lifecycle + interest
profile + per-tick assertions, built from a fixed config and a seed, so
bench.py (``--scenario <name>``), the chaos harness, and tests all drive
the SAME definition through one interface.

Contract:

- **Deterministic**: all world randomness flows through ONE
  ``np.random.default_rng(seed)`` stream drawn in tick order, so the same
  seed reproduces the identical trajectory — and therefore the identical
  invariant fields (census trajectory, event counts) — run over run.
  Wall-clock fields (updates/sec, latencies) are reported OUTSIDE the
  ``invariants`` dict for exactly this reason.
- **Engine-agnostic**: a scenario only exposes the epoch arrays the
  NeighborEngine family steps (``pos/active/space/radius``); the runner
  (``scenarios/runner.py``) drives it on the batched single-device engine
  or the spatially sharded one, unchanged.
- **Self-checking**: ``observe()`` runs per-tick assertions against the
  engine's event stream (the runner adds an interest-set oracle on top:
  no duplicate enter, no orphan leave); a violation raises
  :class:`ScenarioInvariantError` — the scenario is a correctness gate
  first and a throughput number second.

The three shipped scenarios (each registered at import):

- ``battle_royale`` — a shrinking zone forces mass enter waves toward the
  center while storm + combat eliminations churn entities out of the
  world (death = deactivation, the slab-quarantine analog).  Invariants:
  census conservation (alive + eliminated == n every tick), the alive
  trajectory, event totals, zero grid drops.
- ``service_heavy`` — chat/mail/ranking traffic routed by the service
  layer's ``shard_by_key`` over sharded service counters, every op
  persisted through the REAL storage worker while an injected outage
  opens the circuit breaker (storage/circuit.py) mid-run.  Invariants:
  exactly-once per-shard receipts, circuit observed OPEN then recovered,
  zero lost saves after the heal.
- ``hotspot`` — everyone converges on one small crowd disc: worst-case
  AOI density (max cell population near cell_capacity), the spatial
  engine's hotter-than-a-strip fallback (a whole population in one strip
  exceeds the per-shard row budget — exact all-gather ticks, counted),
  and tier-0-everything sync load.

Adding a scenario: subclass :class:`ScenarioWorld`, give it a module-level
``SPEC = ScenarioSpec(...)`` with a FIXED config (floors must be
comparable round over round, so configs are never self-tuned), call
``register(SPEC)``, and import the module here.  Keep ``tick()``
vectorized — the per-tick bodies are gwlint R2 hot paths.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Tuple

import numpy as np


class ScenarioInvariantError(AssertionError):
    """A per-tick or end-of-run scenario invariant did not hold."""


class ScenarioWorld:
    """Base workload: seeded epoch arrays + the hooks the runner drives.

    Subclasses fill ``pos/active/space/radius`` in ``__init__`` from
    ``self.rng`` and advance them in ``tick()``.  ``space`` stays 0 and
    ``radius`` stays the config's uniform AOI radius unless a scenario
    overrides them.
    """

    def __init__(self, config: Mapping[str, Any], seed: int) -> None:
        self.config = dict(config)
        self.seed = int(seed)
        self.rng = np.random.default_rng(self.seed)
        n = int(config["n"])
        self.n = n
        # Engine capacity may exceed the population: the extra rows stay
        # permanently inactive (slot slack), which is what gives the
        # sharded tier per-strip row headroom over the all-active
        # average — without it every uniform all-active world sits
        # exactly at the per-shard budget and falls back on any
        # imbalance.  hotspot deliberately keeps the slack small enough
        # that the endgame crowd still overflows a strip.
        self.cap = int(config.get("capacity", n))
        self.world = float(config["grid"]) * float(config["cell_size"])
        self.world_z = (float(config.get("grid_z", config["grid"]))
                        * float(config["cell_size"]))
        self.pos = np.zeros((self.cap, 2), np.float32)
        self.active = np.zeros(self.cap, bool)
        self.active[:n] = True
        self.space = np.zeros(self.cap, np.int32)
        self.radius = np.full(
            self.cap, float(config.get("radius", config["cell_size"])),
            np.float32)
        # Event accounting every scenario shares (filled by observe()).
        self.enter_events = 0
        self.leave_events = 0
        self.dropped_total = 0

    # --- runner hooks -------------------------------------------------------

    def setup(self) -> None:
        """Acquire out-of-world resources (service_heavy: the storage
        worker + backend).  Paired with :meth:`teardown`."""

    def teardown(self) -> None:
        """Release whatever :meth:`setup` acquired."""

    def tick(self, t: int) -> bool:
        """Advance the world one tick; returns True when active/space/
        radius changed (the engine's ``meta_dirty`` flag — lifecycle
        churn), False when only positions moved."""
        raise NotImplementedError

    def check_engine(self, eng: Any, engine: str) -> None:
        """End-of-verify-pass assertions against the ENGINE's own
        counters (hotspot: the sharded tier must have taken the
        hotter-than-a-strip exact fallback).  Default: none."""

    def extra_headline(self) -> Dict[str, Any]:
        """Scenario-specific headline fields that are NOT deterministic
        (wall-clock latencies etc.) — merged beside, never inside, the
        ``invariants`` dict."""
        return {}

    def observe(self, t: int, enters: np.ndarray, leaves: np.ndarray,
                dropped: int) -> None:
        """Per-tick assertions over the engine's event stream for tick
        ``t`` (the runner's pipelined loop delivers them one dispatch
        late, correctly attributed).  Base: event totals + the shared
        zero-grid-drop clause."""
        self.enter_events += int(len(enters))
        self.leave_events += int(len(leaves))
        self.dropped_total += int(dropped)
        if dropped > int(self.config.get("max_dropped", 0)):
            raise ScenarioInvariantError(
                f"{type(self).__name__}: tick {t} dropped {dropped} "
                f"entities from the AOI grid (cell_capacity overflow) — "
                f"the scenario config must keep density under capacity")

    def invariants(self) -> Dict[str, Any]:
        """Deterministic end-of-run invariant fields (identical run over
        run for one seed — the determinism gate compares this dict)."""
        return {
            "enter_events": self.enter_events,
            "leave_events": self.leave_events,
            "dropped": self.dropped_total,
        }


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """A registered scenario: FIXED config + factory.

    ``config`` must carry at least ``n / cell_size / grid / space_slots /
    cell_capacity / max_events / ticks / repeats / seed / shards`` — the
    engine geometry the runner builds, never self-tuned (scenario floors
    follow the same comparable-by-construction rule as the pinned floor).
    """

    name: str
    description: str
    config: Mapping[str, Any]
    factory: Callable[[Mapping[str, Any], int], ScenarioWorld]

    def make(self, seed: int | None = None,
             ticks_scale: float = 1.0) -> ScenarioWorld:
        cfg = dict(self.config)
        if ticks_scale != 1.0:
            cfg["ticks"] = max(8, int(round(cfg["ticks"] * ticks_scale)))
        return self.factory(
            cfg, self.config["seed"] if seed is None else seed)


_REGISTRY: Dict[str, ScenarioSpec] = {}


def register(spec: ScenarioSpec) -> ScenarioSpec:
    if spec.name in _REGISTRY:
        raise ValueError(f"scenario {spec.name!r} already registered")
    _REGISTRY[spec.name] = spec
    return spec


def get_scenario(name: str) -> ScenarioSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown scenario {name!r} (available: "
            f"{', '.join(scenario_names())})") from None


def scenario_names() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


# Scenario modules self-register on import; keep these last.
from goworld_tpu_torch.scenarios import battle_royale as battle_royale  # noqa: E402
from goworld_tpu_torch.scenarios import hotspot as hotspot  # noqa: E402
from goworld_tpu_torch.scenarios import service_heavy as service_heavy  # noqa: E402
