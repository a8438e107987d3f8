"""battle_royale: a shrinking zone forces mass enter waves while storm +
combat eliminations churn entities out of the world.

The zone is a disc centered on the world that shrinks linearly from
``zone_r0`` to ``zone_rf`` over the run.  Entities random-walk inside it;
anyone caught outside is pulled toward the center faster than the zone
shrinks AND takes storm damage (hp), so the far-corner population dies
early (the first churn wave) while everyone else is compressed into an
ever-denser endgame disc (the mass enter waves).  Combat eliminates a
fixed fraction of the living every tick down to an endgame floor — death
is deactivation, which must drain every interest edge through leave
events (the runner's oracle ``check_alive`` proves it, the engine-side
analog of slab quarantine).

Invariants: census conservation (alive + eliminated == n EVERY tick),
the alive trajectory sampled every 8 ticks, storm/combat kill split,
event totals, zero grid drops.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Tuple

import numpy as np

from goworld_tpu_torch.scenarios import (
    ScenarioInvariantError,
    ScenarioSpec,
    ScenarioWorld,
    register,
)


def zone_radius(r0: float, rf: float, ticks: int, t: int) -> float:
    """The zone radius at tick ``t`` — linear shrink, clamped.  Pure so
    the chaos harness drives live avatars with the SAME zone math."""
    f = min(max(t / max(ticks - 1, 1), 0.0), 1.0)
    return r0 + (rf - r0) * f


def royale_ring_positions(n: int, t: int, ticks: int,
                          center: Tuple[float, float], r0: float,
                          rf: float) -> List[Tuple[float, float]]:
    """Deterministic per-entity positions on the shrinking zone's
    boundary ring (entity i at angle 2*pi*i/n, radius 0.8 * zone).  The
    chaos harness places its live ChaosAvatars with this: as the zone
    collapses everyone converges, producing the mass enter waves on real
    game-process AOI, with zero avatar destroys so the cluster census
    must stay exactly n_bots."""
    r = 0.8 * zone_radius(r0, rf, ticks, t)
    out = []
    for i in range(n):
        a = 2.0 * np.pi * i / max(n, 1)
        out.append((center[0] + r * float(np.cos(a)),
                    center[1] + r * float(np.sin(a))))
    return out


class BattleRoyaleWorld(ScenarioWorld):
    def __init__(self, config: Mapping[str, Any], seed: int) -> None:
        super().__init__(config, seed)
        self.pos = self.rng.uniform(
            0.0, self.world, (self.cap, 2)).astype(np.float32)
        self.center = np.array(
            [self.world / 2.0, self.world / 2.0], np.float32)
        self.r0 = float(config.get("zone_r0", self.world / 2.0))
        self.rf = float(config.get("zone_rf", self.world / 32.0))
        self.storm_speed = float(config.get("storm_speed", 60.0))
        # Pull starts at margin*zone so survivors ride WELL inside the
        # rim; damage only applies strictly outside the zone.  With the
        # zone shrinking ~31/tick and the pull at 60, only the far-corner
        # spawn population and unlucky rim-riders die to the storm.
        self.zone_margin = float(config.get("zone_margin", 0.7))
        self.walk_sigma = float(config.get("walk_sigma", 3.0))
        self.endgame_floor = int(config.get("endgame_floor", self.n // 16))
        self.hp = np.full(self.cap, int(config.get("hp", 12)), np.int32)
        self.alive_count = self.n
        self.storm_kills = 0
        self.combat_kills = 0
        self.alive_trajectory: List[int] = []

    def tick(self, t: int) -> bool:
        zone = np.float32(
            zone_radius(self.r0, self.rf, int(self.config["ticks"]), t))
        alive = self.active
        # Random walk + storm pull, vectorized (gwlint R2 hot path).
        step = self.rng.normal(
            0.0, self.walk_sigma, (self.cap, 2)).astype(np.float32)
        d = self.pos - self.center
        dist = np.maximum(np.hypot(d[:, 0], d[:, 1]), 1e-6).astype(np.float32)
        margin = zone * np.float32(self.zone_margin)
        pulled = alive & (dist > margin)
        outside = alive & (dist > zone)
        pull = np.minimum(np.float32(self.storm_speed),
                          dist - margin * np.float32(0.9))
        step -= np.where(pulled, pull / dist, np.float32(0.0))[:, None] * d
        # pos/active are REBOUND, never mutated in place: the previous
        # buffers may still back an in-flight step_async dispatch (the
        # runner pipelines), and racing it makes event streams
        # nondeterministic.
        self.pos = np.clip(
            self.pos + np.where(alive, np.float32(1.0),
                                np.float32(0.0))[:, None] * step,
            0.0, self.world)
        # Storm damage: hp drains outside the zone; 0 hp eliminates.
        self.hp -= outside.astype(np.int32)
        died_storm = alive & (self.hp <= 0)
        self.storm_kills += int(died_storm.sum())
        self.active = self.active & ~died_storm
        # Combat: a fixed fraction of the living falls every tick, down
        # to the endgame floor (keeps final density under cell_capacity).
        survivors = np.flatnonzero(self.active)
        kills = min(max(1, len(survivors) // 32),
                    max(0, len(survivors) - self.endgame_floor))
        died = died_storm.any() or kills > 0
        if kills > 0:
            fallen = self.rng.choice(survivors, kills, replace=False)
            self.active[fallen] = False
            self.combat_kills += kills
        self.alive_count = int(self.active.sum())
        # Census conservation — THE battle-royale invariant, every tick.
        if self.alive_count + self.storm_kills + self.combat_kills != self.n:
            raise ScenarioInvariantError(
                f"tick {t}: census broken — alive {self.alive_count} + "
                f"storm {self.storm_kills} + combat {self.combat_kills} "
                f"!= {self.n}")
        if t % 8 == 0:
            self.alive_trajectory.append(self.alive_count)
        return bool(died)

    def invariants(self) -> Dict[str, Any]:
        inv = super().invariants()
        inv.update({
            "alive_final": self.alive_count,
            "alive_trajectory": list(self.alive_trajectory),
            "storm_kills": self.storm_kills,
            "combat_kills": self.combat_kills,
            "eliminated": self.storm_kills + self.combat_kills,
        })
        return inv


# FIXED config (floor-grade: never self-tuned). Geometry satisfies the
# sharded engine's constraints on the standard forced 8-device mesh:
# capacity % 64 == 0, max_events % 8 == 0, grid >= 4 * shards.
SPEC = register(ScenarioSpec(
    name="battle_royale",
    description=("shrinking zone: mass enter waves + death churn; census "
                 "conservation every tick, dead entities must drain all "
                 "interest edges"),
    config={
        "n": 2048, "capacity": 2560, "cell_size": 100.0, "grid": 64,
        "space_slots": 1, "cell_capacity": 64, "max_events": 32768,
        "shards": 8, "ticks": 96, "radius": 100.0, "repeats": 2,
        "seed": 16,
    },
    factory=BattleRoyaleWorld,
))
