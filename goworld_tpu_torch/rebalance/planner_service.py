"""The rebalance planner as a sharded service entity.

With ``[rebalance] planner_service`` on, planning moves off the driver
dispatcher into a single-shard :class:`RebalancePlannerService` hosted on
whichever game wins the ``Service/RebalancePlannerService#0`` kvreg race.
Crash-survivability falls out of the service plane's existing machinery:

- the host game dies → the dispatcher's game-down purge releases the
  shard's kvreg claim (empty-value deletions, replicated), every surviving
  game's reconcile sees it unclaimed and races to re-claim, and the new
  host's planner resumes from the next GAME_LOAD_REPORT round — the report
  table is soft state that refills within one ``report_interval``;
- games push their load reports here via ``call_service_shard_key`` (the
  same deferred-call path every service call rides), so reports queued
  during the failover window deliver to the NEW shard;
- the computed plan goes to a dispatcher as one REBALANCE_PLAN push; the
  dispatcher stays the authority on dispatch (config gate + per-game
  liveness), so a stale or split-brain service cannot move entities.

The planner logic itself (rebalance/planner.py) is identical in both
homes — bin-packing, hysteresis, fencing, pause guards — only the driving
loop differs: an entity timer here, the dispatcher tick loop there.
"""

from __future__ import annotations

import time

from goworld_tpu_torch.entity.entity import Entity
from goworld_tpu_torch.utils import gwlog

SERVICE_NAME = "RebalancePlannerService"
SHARD_COUNT = 1  # one planner; shard_by_key("planner", 1) == 0
REPORT_SHARD_KEY = "planner"


class RebalancePlannerService(Entity):
    """Single-shard planning service. State is deliberately soft: the
    report table rebuilds from live GAME_LOAD_REPORT pushes, and the
    pair fences it loses on failover only cost one conservative round."""

    @classmethod
    def describe_entity_type(cls, desc):
        pass  # no persisted attrs: every field rebuilds from live reports

    def on_init(self) -> None:
        from goworld_tpu_torch import rebalance
        from goworld_tpu_torch.config.read_config import RebalanceConfig
        from goworld_tpu_torch.entity import entity_manager
        from goworld_tpu_torch.rebalance.planner import RebalancePlanner

        gs = entity_manager.runtime.game_service
        self._rb_cfg = (gs.cfg.rebalance if gs is not None
                        else RebalanceConfig())
        self.planner = RebalancePlanner(self._rb_cfg)
        # on_init (not on_created) so a freeze→restore of the hosting game
        # re-raises the gauge: restore replays timers but never on_created.
        rebalance.PLANNER_HOST.set(1)

    def on_created(self) -> None:
        from goworld_tpu_torch.entity import entity_manager

        self.add_timer(max(0.05, self._rb_cfg.interval), "PlanTick")
        gwlog.infof(
            "rebalance: planner service %s hosting on game %d "
            "(interval %.2fs)", self.id, entity_manager.runtime.gameid,
            self._rb_cfg.interval)

    def on_destroy(self) -> None:
        # Lost the registration race or host shutdown: stop claiming the
        # gauge so /cluster's planner-host view follows the live shard.
        from goworld_tpu_torch import rebalance

        rebalance.PLANNER_HOST.set(0)

    # --- RPC: every game's _lbc_loop pushes here ---------------------------

    def ReportLoad(self, gameid, report) -> None:
        from goworld_tpu_torch.rebalance.report import coerce_report

        self.planner.on_report(
            int(gameid), coerce_report(report), time.monotonic())

    # --- timer: one planning round per [rebalance] interval ----------------

    def PlanTick(self) -> None:
        from goworld_tpu_torch import dispatchercluster
        from goworld_tpu_torch.entity import entity_manager
        from goworld_tpu_torch.rebalance.planner import plan_to_wire

        gs = entity_manager.runtime.game_service
        # Liveness view: the hosting game's NOTIFY_GAME_CONNECTED set plus
        # itself (the broadcast excludes the subject). Same contract as
        # the dispatcher's connected set: a reporting game missing from it
        # pauses the round (paused_links).
        connected = set(gs.online_games) | {gs.gameid} if gs else set()
        plans = self.planner.plan(connected, time.monotonic())
        if not plans:
            return
        dispatchercluster.select_by_entity_id(self.id).send_rebalance_plan(
            plan_to_wire(plans))
        gwlog.infof("rebalance: planner service pushed %d commands (%s)",
                    len(plans), self.planner.last_result)


def register() -> None:
    """Register the service type + shard (idempotent per process); called
    from the game boot path when [rebalance] planner_service is on."""
    from goworld_tpu_torch import service as service_mod

    service_mod.register_service(RebalancePlannerService, SHARD_COUNT)
