"""Telemetry-driven live rebalancer (ROADMAP item 1; no reference analog).

GoWorld's load balancing stops at PLACEMENT: the dispatcher's CPU min-heap
(dispatcher/lbc.py) picks the least-loaded game for NEW entities, and a hot
game stays hot until its population churns away. This package takes the
same telemetry the engine already produces — tick-phase p95, queue depth,
entity counts, per-space populations — and moves LIVE entities between
games through the hardened cross-game migration path:

- ``report``: the per-game load-report schema (built game-side, consumed
  dispatcher-side) and the scalar load score.
- ``planner``: dispatcher-side planning — pick donor/receiver games and
  donor/receiver spaces, with hysteresis and hard pause conditions (stale
  telemetry, a game link mid-restart) so the rebalancer degrades to DOING
  NOTHING rather than guessing.
- ``migrator``: game-side execution — drive each commanded entity through
  ``enter_space``'s cross-game machinery with a per-migration deadline,
  CANCEL_MIGRATE rollback, bounce-back detection (an entity the dispatcher
  returned home because the target game died), and per-entity cooldown
  with rollback backoff so a flapping target cannot thrash.

Zero-loss contract (pinned by tests/test_rebalance.py and the multigame
chaos scenarios): client RPCs and position-sync records addressed at a
migrating entity buffer at the dispatcher for the migrate window and flush
to wherever the entity LANDS; a REAL_MIGRATE whose target game is gone
bounces home instead of dropping; a migration that cannot complete rolls
back to the source game. An entity is never in zero places.

CheetahGIS (PAPERS.md) is the exemplar for streaming spatial workload
partitioning — its density-aware streaming partitioner maps here to the
planner's per-space population view; the manycore range-query work informs
the batched interest re-registration the AOI plane already performs after
a move (the restored entity re-enters the target space in one hop).
"""

from __future__ import annotations

from goworld_tpu_torch import telemetry

# Families register at module scope only (gwlint R5); children resolve at
# use sites. Outcomes: done = REAL_MIGRATE left for the target game and
# the entity did not bounce home; rolled_back = the pending request was
# cancelled/superseded or the entity bounced home; timeout = the migrator
# hit its per-migration deadline and cancelled (a rollback whose CAUSE is
# the deadline — counted separately so a flapping peer is visible).
MIGRATIONS = telemetry.counter(
    "rebalance_migrations_total",
    "Rebalancer-driven cross-game migrations by outcome "
    "(done|rolled_back|timeout).",
    ("outcome",))
# Dispatcher-side view of each game's scalar load score (rebalance/report
# load_score over the game's last report); NaN-free — removed when the
# game is declared down.
LOAD_SCORE = telemetry.gauge(
    "game_load_score",
    "Scalar load score per game from its last load report "
    "(entities + weighted cpu/tick-p95/queue-depth).",
    ("gameid",))
# Planner activity: rounds that produced moves, and rounds paused by each
# guard condition (visibility into "why is it not rebalancing").
PLANS = telemetry.counter(
    "rebalance_plans_total",
    "Planner rounds by result (moved|balanced|paused_stale|paused_links|"
    "paused_few).",
    ("result",))
# Whole-space handoffs (donor-side outcomes): done = the
# SPACE_MIGRATE_DATA left and did not bounce back within the confirm
# window; aborted = a dispatcher refused the PREPARE (dead target) or the
# space died pre-pack; timeout = the per-space deadline fired mid-PREPARE
# (unfrozen in place); rolled_back = the data bounced home and the space
# restored where it was.
SPACE_MIGRATIONS = telemetry.counter(
    "rebalance_space_migrations_total",
    "Whole-space handoffs by outcome "
    "(done|aborted|timeout|rolled_back).",
    ("outcome",))
# Spaces currently mid-handoff on this game (preparing or in the bounce
# window) — the gwtop REBAL column's "in flight" figure.
SPACES_IN_FLIGHT = telemetry.gauge(
    "rebalance_spaces_in_flight",
    "Whole-space handoffs currently tracked by this game's migrator.")
# Which game hosts the sharded planner service shard (0 on games not
# hosting it; every game publishes its own view — the collector surfaces
# the nonzero one). Dispatcher-local planning leaves this 0 everywhere.
PLANNER_HOST = telemetry.gauge(
    "rebalance_planner_host",
    "1 when this game hosts the RebalancePlannerService shard, else 0.")

from goworld_tpu_torch.rebalance.migrator import RebalanceMigrator  # noqa: E402
from goworld_tpu_torch.rebalance.planner import (  # noqa: E402
    Move,
    RebalancePlanner,
    SpaceMove,
)
from goworld_tpu_torch.rebalance.report import build_load_report, load_score  # noqa: E402

__all__ = [
    "MIGRATIONS",
    "LOAD_SCORE",
    "PLANS",
    "SPACE_MIGRATIONS",
    "SPACES_IN_FLIGHT",
    "PLANNER_HOST",
    "Move",
    "SpaceMove",
    "RebalancePlanner",
    "RebalanceMigrator",
    "build_load_report",
    "load_score",
]
