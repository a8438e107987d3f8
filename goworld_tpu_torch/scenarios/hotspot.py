"""hotspot: everyone converges on one small crowd disc — worst-case AOI
density by construction.

Each entity owns a personal target drawn uniformly (area-uniform, sqrt
radial sampling) inside a disc of radius ``crowd_r`` around the world
center and marches straight at it, then jitters in place.  The endgame is
the regime that breaks AOI engines: max cell population pushed toward
``cell_capacity`` (but provably under it — ``dropped == 0`` stays a hard
per-tick clause), nearly every surviving interest pair inside the tier-0
band (tier-0-everything sync load), and on the spatially sharded engine
the entire population lands in a handful of grid columns — hotter than
any strip's per-shard row budget, which MUST trip the engine's
``strip_overflow`` exact-fallback path (``check_engine`` asserts the
fallback count is non-zero; it is THE hotspot invariant on that tier).

No lifecycle churn: after the first dispatch every tick is
``meta_dirty=False``, so the batched tier stays on its packed fast path
while density does all the damage.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np

from goworld_tpu_torch.scenarios import (
    ScenarioInvariantError,
    ScenarioSpec,
    ScenarioWorld,
    register,
)


class HotspotWorld(ScenarioWorld):
    def __init__(self, config: Mapping[str, Any], seed: int) -> None:
        super().__init__(config, seed)
        self.pos = self.rng.uniform(
            0.0, self.world, (self.cap, 2)).astype(np.float32)
        center = np.array([self.world / 2.0, self.world / 2.0], np.float32)
        crowd_r = float(config.get("crowd_r", 200.0))
        # Area-uniform targets in the crowd disc.
        rr = crowd_r * np.sqrt(self.rng.uniform(0.0, 1.0, self.cap))
        th = self.rng.uniform(0.0, 2.0 * np.pi, self.cap)
        self.target = (center + np.stack(
            [rr * np.cos(th), rr * np.sin(th)], 1)).astype(np.float32)
        self.speed = float(config.get("speed", 80.0))
        self.jitter = float(config.get("jitter", 2.0))

    def tick(self, t: int) -> bool:
        # March at the personal target, overshoot-safe; jitter on arrival.
        d = self.target - self.pos
        dist = np.maximum(np.hypot(d[:, 0], d[:, 1]), 1e-6).astype(np.float32)
        step = np.minimum(np.float32(self.speed), dist) / dist
        # Rebind, don't mutate: the previous buffer may back an in-flight
        # pipelined dispatch.
        self.pos = np.clip(
            self.pos + step[:, None] * d + self.rng.normal(
                0.0, self.jitter, (self.cap, 2)).astype(np.float32),
            0.0, self.world)
        return False  # pure movement: no lifecycle churn after tick 0

    def check_engine(self, eng: Any, engine: str) -> None:
        if engine == "sharded" and int(eng.total_fallbacks) == 0:
            raise ScenarioInvariantError(
                "hotspot on the sharded engine took ZERO exact-fallback "
                "ticks — the whole population in one strip must exceed "
                "the per-shard row budget (strip_overflow); the crowd "
                "never formed or the fallback path regressed")

    def invariants(self) -> Dict[str, Any]:
        inv = super().invariants()
        # Final-density facts, computed from positions (deterministic).
        cell = float(self.config["cell_size"])
        gx = int(self.config["grid"])
        pop = self.pos[:self.n]  # the live population, not slack rows
        cx = np.clip((pop[:, 0] // cell).astype(np.int64), 0, gx - 1)
        cz = np.clip((pop[:, 1] // cell).astype(np.int64), 0, gx - 1)
        counts = np.bincount(cx * gx + cz, minlength=gx * gx)
        d = pop[:, None, :] - pop[None, :, :]
        d2 = (d * d).sum(-1)
        np.fill_diagonal(d2, np.inf)
        r = float(self.config["radius"])
        in_aoi = int((d2 < r * r).sum())
        in_tier0 = int((d2 < (0.5 * r) ** 2).sum())
        tier0_share = round(in_tier0 / max(in_aoi, 1), 4)
        avg_neighbors = round(in_aoi / self.n, 1)
        # 0.25 is the scale-free uniform-field limit for the 0.5*radius
        # tier-0 band; beating it means the crowd genuinely saturates the
        # band, and >= 100 average AOI neighbors is the density clause.
        if tier0_share < 0.25:
            raise ScenarioInvariantError(
                f"hotspot endgame tier0_share {tier0_share} < 0.25 — the "
                "crowd is not dense enough to be a hotspot")
        if avg_neighbors < 100.0:
            raise ScenarioInvariantError(
                f"hotspot endgame avg AOI neighbors {avg_neighbors} < 100 "
                "— not worst-case density")
        inv.update({
            "max_cell_density": int(counts.max()),
            "final_aoi_pairs": in_aoi,
            "avg_aoi_neighbors": avg_neighbors,
            "tier0_share": tier0_share,
        })
        return inv


# FIXED config. n=1024 over a 48x48 grid: the final 200-radius crowd
# peaks ~90/cell (under cell_capacity 128, dropped stays 0) at ~200
# average AOI neighbors each, and lands in ~6 grid columns — far beyond
# one strip's 128-row budget on the 8-shard mesh, guaranteeing
# strip_overflow fallbacks — the 1280-row capacity leaves only 25% slot
# slack (160-row strips), so the pre-crowd uniform world shards natively
# while the crowd provably cannot. Geometry satisfies the sharded
# constraints: 1280 % 64 == 0, 32768 % 8 == 0, 48 >= 4 * 8.
SPEC = register(ScenarioSpec(
    name="hotspot",
    description=("everyone converges on one crowd disc: worst-case AOI "
                 "density, tier-0-everything sync, sharded "
                 "strip_overflow fallback required"),
    config={
        "n": 1024, "capacity": 1280, "cell_size": 100.0, "grid": 48,
        "space_slots": 1, "cell_capacity": 128, "max_events": 32768,
        "shards": 8, "ticks": 56, "radius": 100.0, "repeats": 3,
        "seed": 16,
    },
    factory=HotspotWorld,
))
