"""GameService: packet handling + tick loop + terminate/freeze paths.

Reference parity: ``components/game/GameService.go`` — the main loop
(:76-187) selects {packet queue | 5 ms ticker}; ~20 message handlers
(:92-157); terminate saves + destroys all entities (:194-213); freeze packs
every entity to ``game<N>_freezed.dat`` (:217-266, restore.go:12-34).
``components/game/game.go`` — boot sequence (:66-136) and signal handling
(:138-194). ``lbc/gamelbc.go:17-39`` — CPU% reports to every dispatcher.
"""

from __future__ import annotations

import asyncio
import json
import os
import signal
import time
from typing import Optional

# Importing torch creates no CUDA context, so `-d`'s fork stays safe; the
# first device use is the AOI service's warmup in run_async.
import torch

from goworld_tpu_torch import consts, dispatchercluster, kvdb, kvreg, storage, telemetry
from goworld_tpu_torch.dispatchercluster.cluster import ClusterClient
from goworld_tpu_torch.entity import entity_manager
from goworld_tpu_torch.entity.game_client import GameClient
from goworld_tpu_torch.netutil.packet import Packet
from goworld_tpu_torch.proto.conn import unpack_sync_records
from goworld_tpu_torch.proto.msgtypes import MsgType
from goworld_tpu_torch.telemetry import tracing
from goworld_tpu_torch.utils import async_jobs, crontab, gwlog, gwutils, post

# Sync fan-out per-hop attribution (shared family with the dispatcher's
# dispatcher_route and the gate's gate_demux/client_write hops; bench.py
# --fanout reads the deltas into per-hop shares). The game side is split
# into game_collect + game_pack (entity_manager.collect_entity_sync_infos
# owns both compute sub-hops) and game_send — the per-gate dispatcher-link
# writes below, kept separate so pack COMPUTE is attributable apart from
# wire work (mirroring the gate's gate_demux vs client_write split).
_HOP_GAME_SEND = telemetry.counter(
    "fanout_hop_seconds_total",
    "Busy wall seconds per sync fan-out hop (game_collect|game_pack|"
    "game_send|dispatcher_route|gate_demux|client_write).",
    ("hop",)).labels("game_send")

# run states (GameService.go rsRunning/rsTerminating/rsFreezing...)
RS_RUNNING = 0
RS_TERMINATING = 1
RS_FREEZING = 2
RS_TERMINATED = 3
RS_FREEZED = 4


def freeze_filename(gameid: int) -> str:
    return f"game{gameid}_freezed.dat"


class GameService:
    """One game process. Construct, then ``await service.run_async()``."""

    def __init__(self, gameid: int, cfg=None, restore: bool = False) -> None:
        from goworld_tpu_torch.config import get as get_config

        self.gameid = gameid
        self.cfg = cfg or get_config()
        self.restore = restore
        self.run_state = RS_RUNNING
        self.online_games: set[int] = set()
        self.deployment_ready = False
        self._queue: asyncio.Queue = asyncio.Queue()
        self.cluster: Optional[ClusterClient] = None
        self._freeze_acks = 0
        self._stop_event = asyncio.Event()
        self.exit_code: Optional[int] = None
        self._last_sync_collect = 0.0
        self._last_aoi_tick = 0.0
        self._aoi_wedge_warned = False
        self._last_packet_at = 0.0
        self._freeze_acked_at = 0.0
        self._freeze_started_at = 0.0
        # Migrate-in volume counters (gwvar MigrateIn*): a soak whose game
        # RSS climbs names its per-payload cost here.
        self._migrate_in_count = 0
        self._migrate_in_bytes = 0
        self._migrate_in_max = 0
        # Rebalance execution (rebalance/migrator.py): drives dispatcher-
        # commanded migrations with deadline + rollback; ticked from the
        # main loop's entity_logic phase (zero cost while idle).
        rbcfg = getattr(self.cfg, "rebalance", None)
        from goworld_tpu_torch.rebalance import RebalanceMigrator

        self.migrator = RebalanceMigrator(
            migrate_timeout=rbcfg.migrate_timeout if rbcfg else 5.0,
            cooldown=rbcfg.cooldown if rbcfg else 5.0)
        self._report_interval = rbcfg.report_interval if rbcfg else 1.0
        # CPU% over the last report interval (rebalance/report.py reads it).
        self.last_cpu_pct = 0.0
        game_cfg = self.cfg.games.get(gameid)
        self.boot_entity = game_cfg.boot_entity if game_cfg else ""
        self.position_sync_interval = (
            game_cfg.position_sync_interval if game_cfg else consts.POSITION_SYNC_INTERVAL
        )
        self._started_at = 0.0
        # Slow-tick flight recorder ([telemetry] knobs; tracing.py): every
        # tick records its phase budget; /flight serves the ring.
        tcfg = getattr(self.cfg, "telemetry", None)
        self.flight = tracing.FlightRecorder(
            capacity=tcfg.flight_ring_size if tcfg else 240,
            slow_budget=tcfg.slow_tick_budget if tcfg else
            consts.SLOW_TICK_BUDGET,
        )
        # trace_id of the first sampled packet handled in the current tick
        # (0 = untraced tick): gates phase-span emission at commit.
        self._tick_trace_id = 0

    # --- boot (game.go:66-136) ---------------------------------------------

    async def run_async(self) -> int:
        """Full process lifecycle; returns the exit code (0 normal, 2 freeze —
        the CLI restarts freezed games with -restore)."""
        rt = entity_manager.runtime
        rt.gameid = self.gameid
        rt.game_service = self
        self._started_at = time.monotonic()
        tcfg = getattr(self.cfg, "telemetry", None)
        if tcfg is not None:
            tracing.configure_from_config(tcfg)
        tracing.set_flight_recorder(self.flight)
        game_cfg = self.cfg.games.get(self.gameid)
        if game_cfg is not None:
            rt.save_interval = game_cfg.save_interval
            rt.position_sync_interval = game_cfg.position_sync_interval
        if self.cfg.aoi.backend != "auto":
            rt.aoi_backend = "xzlist" if self.cfg.aoi.backend == "xzlist" else "batched"
        # [aoi] capacity/cell/mesh knobs → engine params (ini is the single
        # source of truth; tests may pre-seed rt.aoi_params to override).
        rt.aoi_mesh_shards = max(1, self.cfg.aoi.mesh_shards)
        rt.aoi_shard_mode = self.cfg.aoi.shard_mode
        rt.aoi_strip_placement = self.cfg.aoi.strip_placement
        rt.aoi_pallas_strip_cols = self.cfg.aoi.pallas_strip_cols
        rt.aoi_pallas_inkernel_drain = self.cfg.aoi.pallas_inkernel_drain
        rt.aoi_delivery = self.cfg.aoi.delivery
        rt.aoi_sync_wait_budget = self.cfg.aoi.sync_wait_budget
        rt.aoi_fuse_logic = self.cfg.aoi.fuse_logic
        ecfg = getattr(self.cfg, "entity", None)
        if ecfg is not None:
            # Pre-size the slab store ([entity] slab_initial) so steady-
            # state populations don't pay growth reallocation mid-login.
            rt.slabs.ensure_capacity(ecfg.slab_initial)
        sycfg = getattr(self.cfg, "sync", None)
        if sycfg is not None:
            # [sync] adaptive per-client sync: cadence tiers + delta/
            # quantized records (entity/slabs.py; defaults = legacy path).
            rt.slabs.configure_sync(sycfg)
        if rt.aoi_backend != "xzlist" and rt.aoi_params is None:
            from goworld_tpu_torch.entity.aoi.batched import params_from_config

            rt.aoi_params = params_from_config(self.cfg.aoi)
        if rt.aoi_backend != "xzlist":
            # Per-game aoi_platform overrides the global [aoi] platform
            # (read_config.py GameConfig.aoi_platform). "cpu" runs the
            # batched service on the kernels' plain versions; "auto" and
            # "cuda" leave rt.aoi_device None, which means the CUDA card
            # and raises where there is none: such a game exits non-zero
            # with the runtime's error, it never carries on on the CPU.
            # [aoi] compilation_cache has no counterpart (nothing compiles
            # lazily in PyTorch; the CLI built the CUDA libraries).
            platform = (
                (game_cfg.aoi_platform if game_cfg else "")
                or self.cfg.aoi.platform
            )
            rt.aoi_device = "cpu" if platform == "cpu" else None
            if self.cfg.aoi.multihost_coordinator:
                # Multi-process tier: every game joins ONE torch.distributed
                # group; process_id is this game's rank among the
                # configured games (read_config validates processes ==
                # len(games)). Must run before the AOI service is built;
                # blocks until every game is up (the CLI spawns the game
                # batch before waiting on tags).
                from goworld_tpu_torch.parallel.multihost import (
                    gather_route,
                    init_multihost,
                    process_count,
                )

                games_sorted = sorted(self.cfg.games)
                pid = games_sorted.index(self.gameid)
                nprocs = len(games_sorted)
                gwlog.infof(
                    "game %d joining AOI multihost mesh as process %d/%d "
                    "via %s", self.gameid, pid, nprocs,
                    self.cfg.aoi.multihost_coordinator,
                )
                # A game whose AOI runs on the CPU takes no card.
                init_multihost(
                    self.cfg.aoi.multihost_coordinator, nprocs, pid,
                    cuda=rt.aoi_device != "cpu",
                )
                rt.aoi_multihost = True
                # One shard a game process: the global shard count is the
                # process count. The cards decided the gather route.
                gwlog.infof(
                    "game %d AOI multihost mesh joined: %d processes, "
                    "%d global devices, gather route %s", self.gameid,
                    process_count(), process_count(), gather_route(),
                )
            # Run the engine BEFORE the ready barrier admits clients: the
            # first dispatch otherwise pays the CUDA context, the kernel
            # libraries' loading and the allocator's first blocks right as
            # the first clients log in.
            aoi = rt.get_aoi_service()
            aoi.warmup()
            dev = aoi.device
            gwlog.infof(
                "game %d AOI device: %s (%s)", self.gameid, dev,
                torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else "plain versions on the host CPU")
        if not storage.initialized():
            storage.initialize(self.cfg.storage)
        rt.storage = storage.SyncStorageAdapter()
        if not kvdb.initialized():
            kvdb.initialize(self.cfg.kvdb)

        rbcfg = getattr(self.cfg, "rebalance", None)
        if rbcfg is not None and rbcfg.enabled and rbcfg.planner_service:
            # Planner failover: host planning in a sharded
            # service entity — every game registers the type, exactly one
            # wins the kvreg shard race and plans; survivors re-claim the
            # shard when the host dies. Must happen before restore: a
            # frozen planner entity needs its type in the registry.
            from goworld_tpu_torch.rebalance import planner_service

            planner_service.register()

        if self.restore:
            self._restore_freezed_entities()
            # Run the per-class batched tick programs once at the restored
            # populations BEFORE the cluster re-handshake admits traffic,
            # on the AOI service's device (the warmup above already made
            # its CUDA context and loaded the kernel libraries): the first
            # live tick after respawn pays no first-use cost while
            # buffered client RPCs are already draining. With
            # [aoi] fuse_logic this also runs the FUSED step for the
            # restored program set (service.prewarm_fused).
            rt.slabs.prewarm_tick_hooks()
        elif entity_manager.get_nil_space() is None:
            entity_manager.create_nil_space(self.gameid)

        from goworld_tpu_torch.dispatchercluster.cluster import (
            cluster_knobs,
            dispatcher_addrs,
        )

        self.cluster = ClusterClient(
            dispatcher_addrs(self.cfg), self._handshake, self._on_packet,
            self._on_dispatcher_disconnect, **cluster_knobs(self.cfg)
        )
        dispatchercluster.set_cluster(self.cluster)
        self.cluster.start()

        from goworld_tpu_torch import service as service_mod

        service_mod.setup(self.gameid)  # service.go:78-81
        self._install_signal_handlers()
        from goworld_tpu_torch.utils import gwvar
        from goworld_tpu_torch.utils.debug_http import setup_http_server

        lbc_task = None
        debug_srv = None
        hist_writer = None
        hist_task = None
        try:
            # Debug HTTP server (binutil.SetupHTTPServer; game.go:107) + gwvar.
            gwvar.set_var("IsDeploymentReady", lambda: self.deployment_ready)
            gwvar.set_var("NumEntities", lambda: len(entity_manager.entities()))
            gwvar.set_var("MigrateIn", lambda: {
                "count": self._migrate_in_count,
                "bytes": self._migrate_in_bytes,
                "max_bytes": self._migrate_in_max,
            })

            def _fattest():
                # Largest entity by serialized attr size, broken down by
                # top-level key — names the payload that bloats migrations.
                # One serialize per entity (per-key sizes summed), not two:
                # /vars runs this synchronously on the game loop.
                best = None
                for e in entity_manager.entities().values():
                    keys = {k: len(json.dumps(v, default=str))
                            for k, v in e.attrs.to_dict().items()}
                    sz = sum(keys.values())
                    if best is None or sz > best["bytes"]:
                        best = {"type": e.typename, "bytes": sz,
                                "keys": keys}
                return best

            gwvar.set_var("FattestEntity", _fattest)
            # Per-type counts: the leak-hunting view (a soak that grows
            # NumEntities names its culprit here).
            def _counts():
                out: dict[str, int] = {}
                for e in entity_manager.entities().values():
                    out[e.typename] = out.get(e.typename, 0) + 1
                return out
            gwvar.set_var("EntityCounts", _counts)
            from goworld_tpu_torch.utils import debug_http

            debug_http.set_health_provider(self._health)
            # Pull-sampled telemetry gauge beside the gwvar probe: /metrics
            # scrapers get entity counts without touching /vars.
            telemetry.gauge(
                "game_entities", "Live entities on this game process.",
                ("gameid",),
            ).labels(str(self.gameid)).set_function(
                lambda: len(entity_manager.entities()))
            if rt.aoi_service is not None:
                # The event kernel's launches by form, as its wrapper counts
                # them where it launches (ops/event_kernel.py): a scraper
                # reads the mask forms' launches inside the game. The plain
                # versions on the CPU count none.
                from goworld_tpu_torch.ops import event_kernel

                event_kernel.register_launch_gauge()
            debug_srv = await setup_http_server(game_cfg.http_addr if game_cfg else "")
            if tcfg is not None and tcfg.history_dir:
                # Black-box history ring (telemetry/history.py): its own
                # cadence task off the logic loop; the finally below
                # writes the final frame — after a kill this ring is the
                # only record of the process's last ticks.
                from goworld_tpu_torch.telemetry import history as history_mod
                import os as _os

                hist_writer = history_mod.HistoryWriter(
                    _os.path.join(tcfg.history_dir, f"game{self.gameid}"),
                    f"game{self.gameid}",
                    interval=tcfg.history_interval,
                    segment_bytes=tcfg.history_segment_bytes,
                    segments=tcfg.history_segments,
                    health=self._health, flight=self.flight)
                history_mod.set_active_writer(hist_writer)
                hist_task = asyncio.get_running_loop().create_task(
                    hist_writer.run())
            lbc_task = asyncio.get_running_loop().create_task(self._lbc_loop())
            gwlog.infof("game %d starting (restore=%s)", self.gameid, self.restore)
            gwlog.infof(consts.GAME_STARTED_TAG)
            await self._main_loop()
        finally:
            if lbc_task is not None:
                lbc_task.cancel()
            if hist_task is not None:
                hist_task.cancel()
            if hist_writer is not None:
                # Final frame: the ring's newest entry carries the last
                # flight-recorder ticks + census this incarnation saw.
                hist_writer.close()
                from goworld_tpu_torch.telemetry import history as history_mod

                history_mod.clear_active_writer(hist_writer)
            if debug_srv is not None:
                await debug_srv.stop()
            # IsDeploymentReady is guaranteed always-published (gwvar.go:27-29
            # sets it at init); flip it back to False rather than unsetting so
            # a co-hosted /vars endpoint keeps serving it after shutdown.
            gwvar.set_var("IsDeploymentReady", False)
            gwvar.unset("NumEntities")
            # These closures capture self + the entity graph: a stopped
            # service must neither serve stale probes nor keep hundreds
            # of MB of entity state alive through the gwvar registry.
            gwvar.unset("MigrateIn")
            gwvar.unset("FattestEntity")
            # Same closure-capture reasoning as the gwvar.unset calls.
            telemetry.gauge("game_entities", labelnames=("gameid",)).remove(
                str(self.gameid))
            from goworld_tpu_torch.utils import debug_http

            debug_http.clear_health_provider(self._health)
            if tracing.flight_recorder() is self.flight:
                tracing.set_flight_recorder(None)
            await self.cluster.stop()
            dispatchercluster.set_cluster(None)
            if rt.aoi_multihost:
                # Leave the AOI process group: over NCCL it is aborted, so
                # a game that goes never waits on a gather its peer left.
                from goworld_tpu_torch.parallel import multihost

                multihost.leave()
        return self.exit_code or 0

    def _handshake(self, index: int, proxy) -> None:
        # Per-dispatcher entity list: each dispatcher gets ONLY the ids it
        # owns by hash (GetEntityIDsForDispatcher, DispatcherConnMgr.go:79).
        # Sending the full list seeds stale entries on non-owner
        # dispatchers; after a migration (which updates only the owner),
        # the next restore's reconciliation on a non-owner then REJECTS
        # the entity and its game destroys it (seen as vanished avatars +
        # wedged clients in the double-reload soak).
        from goworld_tpu_torch.common import hash_entity_id

        n = len(self.cfg.dispatchers)
        proxy.send_set_game_id(
            self.gameid,
            is_reconnect=self.deployment_ready,
            is_restore=self.restore,
            is_ban_boot_entity=not self.boot_entity,
            entity_ids=[
                eid for eid in entity_manager.entities()
                if hash_entity_id(eid) % n == index
            ],
        )

    def _on_packet(self, index: int, msgtype: int, packet: Packet) -> None:
        self._queue.put_nowait((msgtype, packet))

    def _on_dispatcher_disconnect(self, index: int) -> None:
        # Sends to the lost dispatcher buffer in its replay ring (byte-
        # capped) and flush after the reconnect handshake — see
        # dispatchercluster/cluster.py.
        gwlog.warnf("game %d: dispatcher %d disconnected; buffering sends "
                    "until reconnect", self.gameid, index)

    def _health(self) -> dict:
        """One JSON object for GET /healthz (and the /snapshot row the
        cluster collector aggregates)."""
        # Client-binding census by gate + the generations those bindings
        # carry: the collector's conservation law (clients bound on games
        # == clients connected on gates) and stale-generation check read
        # exactly these (telemetry/collector.py summarize).
        clients = 0
        gate_gens: dict[str, set] = {}
        for e in entity_manager.entities().values():
            c = e.client
            if c is None:
                continue
            clients += 1
            gate_gens.setdefault(str(c.gateid), set()).add(c.gate_gen)
        # A locally-hosted RebalancePlannerService shard surfaces its
        # planning state here: /cluster's REBAL view and the pause/
        # failover alerts read exactly this row (the dispatcher's healthz
        # only carries last_result in driver mode).
        planner = None
        for e in entity_manager.entities().values():
            if (e.typename == "RebalancePlannerService"
                    and not e.is_destroyed()):
                planner = {
                    "last_result": e.planner.last_result,
                    "reporting_games": e.planner.reports.games(),
                }
                break
        return {
            "kind": "game",
            "id": self.gameid,
            "uptime_s": round(time.monotonic() - self._started_at, 3),
            "deployment_ready": self.deployment_ready,
            "run_state": self.run_state,
            "entities": len(entity_manager.entities()),
            "clients": clients,
            "queue_depth": self.queue_depth(),
            "client_gate_gens": {g: sorted(s) for g, s in gate_gens.items()},
            "rebalance_planner": planner,
            "online_games": sorted(self.online_games),
            "dispatcher_links": (
                self.cluster.link_states() if self.cluster is not None
                else []),
        }

    def _install_signal_handlers(self) -> None:
        loop = asyncio.get_running_loop()
        try:
            loop.add_signal_handler(signal.SIGTERM, self.terminate)
            loop.add_signal_handler(signal.SIGHUP, self.start_freeze)
        except (NotImplementedError, RuntimeError):
            pass  # non-main thread (tests) or unsupported platform

    # --- main loop (GameService.go:76-187) -----------------------------------

    async def _main_loop(self) -> None:
        tick = consts.GAME_SERVICE_TICK_INTERVAL
        rt = entity_manager.runtime
        # Per-tick phase attribution (telemetry/phases.py): dispatch =
        # packet handling, entity_logic = timers+crontab+post, aoi =
        # poll/dispatch/deliver of the batched engine, sync_send = the
        # batched position-sync push. begin() runs AFTER the queue wait so
        # idle time never pollutes the dispatch phase; "total" is the
        # busy span of each iteration. Served on /metrics as
        # game_tick_phase_seconds{phase=...}.
        tracer = telemetry.PhaseTracer(
            "game_tick_phase_seconds",
            ("dispatch", "entity_logic", "aoi", "sync_send"),
            help="Busy wall seconds per game-loop tick, by phase "
                 "(dispatch|entity_logic|aoi|sync_send|total).",
        )
        # Events delivered by the last AOI tick (set by the batched
        # engine; stays 0 on xzlist) — sampled into each flight record.
        aoi_backlog = telemetry.gauge("aoi_event_backlog")
        while True:
            try:
                # Wake at the next position-sync deadline when it lands
                # inside the tick window: a fixed 5 ms wait ADDS to the
                # iteration's work time, so the configured sync rate ran
                # ~25% slow on a quiet queue (6.3 ms achieved periods at a
                # 5 ms interval — bench.py --fanout is cadence-bound on
                # exactly this).
                timeout = tick
                if self.position_sync_interval > 0:
                    due = (self._last_sync_collect
                           + self.position_sync_interval - time.monotonic())
                    if due < timeout:
                        timeout = max(0.0, due)
                msgtype, packet = await asyncio.wait_for(
                    self._queue.get(), timeout=timeout)
                tracer.begin()
                self._last_packet_at = time.monotonic()
                self._handle_packet(msgtype, packet)
                # Drain whatever else arrived without waiting.
                while True:
                    try:
                        msgtype, packet = self._queue.get_nowait()
                    except asyncio.QueueEmpty:
                        break
                    self._handle_packet(msgtype, packet)
            except asyncio.TimeoutError:
                tracer.begin()
            tracer.mark("dispatch")
            # Ingress seam 2 (beside the gate's client-RPC receive): game-
            # originated work — timers firing RPCs, crontab jobs — head-
            # samples a fresh root so server-side request chains are
            # traceable too. One coin flip per 5 ms tick; sends inside the
            # scope carry the context across the cluster.
            timer_scope = tracing.root_scope("game.timer_tick")
            if timer_scope is None:
                rt.timer_service.tick()
            else:
                timer_scope.args["gameid"] = self.gameid
                if not self._tick_trace_id:
                    self._tick_trace_id = timer_scope.ctx.trace_id
                with timer_scope:
                    rt.timer_service.tick()
            # Per-class batched behaviors: ONE on_tick_batch call per
            # adopted class over its entities' slab view — the vectorized
            # replacement for per-entity timers (entity/slabs.py).
            rt.slabs.run_tick_batches()
            # Rebalance state machine: deadlines, rollbacks, bounce
            # confirmation for in-flight commanded migrations.
            self.migrator.tick(time.monotonic())
            tracer.mark("entity_logic")
            # NOTE on the multi-HOST (DCN) tier: the wait=False machinery
            # below is lockstep-SAFE as is. Frame-skip only DEFERS a
            # dispatch index (tick dispatches 0,1,2,... on every process,
            # never skipping one), and delivery happens only when the
            # in-flight step is observed ready — so a fast game is paced by
            # readiness gating instead of blocking in a collective, a dead
            # peer degrades to the wedge-watchdog warning (RPCs keep
            # flowing) instead of freezing the loop, and per-process
            # adaptive cadences cannot diverge the global op sequence.
            if rt.aoi_service is not None:
                # AOI rides the position-sync cadence (reference §3.3: AOI
                # updates feed client create/destroy alongside position
                # syncs), NOT the 5 ms loop tick — dispatching every loop
                # iteration ran the device at 100% duty cycle and starved
                # single-core hosts. wait=False: never stall the loop on
                # device compute — frame-skip and let RPCs keep flowing.
                now_aoi = time.monotonic()
                # Ungated readiness probe FIRST (every loop iteration): the
                # turnaround sample must be independent of the cadence gate
                # or the gate re-measures itself and doubles unbounded
                # (poll_ready docstring).
                rt.aoi_service.poll_ready()
                # Cadence stretches to 2x the measured step turnaround when
                # compute exceeds the configured interval — caps engine
                # duty at ~50% under overload instead of dispatching
                # back-to-back (graceful degradation; batched.py).
                cadence = max(
                    self.position_sync_interval,
                    2.0 * rt.aoi_service.last_step_duration,
                )
                if now_aoi - self._last_aoi_tick >= cadence:
                    # Advance the cadence timer only on an actual dispatch:
                    # a frame-skip (None) keeps probing every 5 ms loop
                    # iteration so a step finishing just past the boundary
                    # isn't penalized a whole extra interval.
                    if rt.aoi_service.tick(wait=False) is not None:
                        self._last_aoi_tick = now_aoi
                        self._aoi_wedge_warned = False
                # Watchdog: a step that never becomes ready (wedged device)
                # would frame-skip forever with AOI silently dead while RPCs
                # keep flowing. Warn once per incident at 10x
                # the cadence (generous: covers jit recompiles on growth).
                age = rt.aoi_service.in_flight_age()
                if age > max(10.0 * cadence, 30.0):
                    if not self._aoi_wedge_warned:
                        self._aoi_wedge_warned = True
                        gwlog.errorf(
                            "game %d: in-flight AOI step not ready after "
                            "%.1f s (cadence %.3f s) — device wedged? AOI "
                            "delivery is stalled; RPCs keep running",
                            self.gameid, age, cadence,
                        )
            tracer.mark("aoi")
            crontab.check()
            post.tick()
            tracer.mark("entity_logic")
            now = time.monotonic()
            if now - self._last_sync_collect >= self.position_sync_interval:
                # Scheduled-rate cadence: advance the deadline by the
                # INTERVAL (not to `now`) so a loop iteration landing late
                # doesn't stretch the average sync period — the configured
                # position_sync_interval is a rate, and under load the old
                # fixed-delay reset ran it ~25% slow (5 ms config, ~6.2 ms
                # achieved — measured by bench.py --fanout, where delivered
                # records are cadence-bound). Clamped to one interval of
                # backlog: a long stall must not trigger a catch-up burst.
                self._last_sync_collect = max(
                    self._last_sync_collect + self.position_sync_interval,
                    now - self.position_sync_interval,
                )
                self._send_entity_sync_infos()
                tracer.mark("sync_send")
            committed = tracer.commit()
            if committed is not None:
                t0, total, phases = committed
                # Flight recorder: one compact record per tick; a tick
                # over the slow budget dumps the ring as ONE WARN and
                # keeps it on GET /flight.
                self.flight.record(
                    t0, total, phases,
                    queue_depth=self._queue.qsize(),
                    entities=len(entity_manager.entities()),
                    aoi_backlog=int(aoi_backlog.value),
                )
                if self._tick_trace_id:
                    # PhaseTracer boundaries as span events: the tick that
                    # handled a sampled packet lays its phase budget on
                    # the same timeline as that packet's spans.
                    tracing.record_phase_spans(
                        self._tick_trace_id, t0, phases)
                    self._tick_trace_id = 0
            if self.run_state == RS_TERMINATING:
                self._do_terminate()
                return
            if self.run_state == RS_FREEZING:
                if self._freeze_acks >= len(self.cfg.dispatchers):
                    # Deterministic fence: each dispatcher
                    # emits its ack on the SAME TCP stream strictly after
                    # installing the block, and acks are counted here at
                    # PROCESSING time — so per-connection FIFO (socket →
                    # reader task → logic queue) guarantees that every
                    # packet a dispatcher forwarded pre-block (e.g. a
                    # REAL_MIGRATE carrying an avatar's entire state) has
                    # already been processed by the time the count reaches
                    # N. Packets a dispatcher received post-block go to
                    # its pending buffer and are delivered after restore.
                    # Nothing can still be in flight: freeze NOW — no
                    # probabilistic quiet-window wait (a migrate delayed
                    # past the old 0.3 s window by kernel buffering was
                    # still lost; the fence cannot miss it).
                    self._do_freeze()
                    return
                if (
                    self._freeze_started_at
                    and now - self._freeze_started_at
                    > consts.FREEZE_ACK_TIMEOUT
                ):
                    # Safety net: a dead/hung dispatcher would otherwise
                    # wedge the freeze forever. Fall back to the
                    # quiescence heuristic — freeze after a quiet window,
                    # bounded by the drain cap.
                    if not self._freeze_acked_at:
                        gwlog.errorf(
                            "game %d: only %d/%d freeze acks after %.0f s "
                            "— falling back to quiescent-window freeze",
                            self.gameid, self._freeze_acks,
                            len(self.cfg.dispatchers),
                            consts.FREEZE_ACK_TIMEOUT,
                        )
                        self._freeze_acked_at = now
                    quiet = now - self._last_packet_at
                    if (
                        quiet >= consts.FREEZE_QUIESCENT_WINDOW
                        or now - self._freeze_acked_at > consts.FREEZE_DRAIN_CAP
                    ):
                        self._do_freeze()
                        return

    def _send_entity_sync_infos(self) -> None:
        """Push batched position syncs, one coalesced packet per gate
        (§3.3; rows are selected and packed as pure column ops over the
        entity slabs — entity_manager.collect_entity_sync_infos). Wall
        time lands on fanout_hop_seconds_total{hop="game_collect"|
        "game_pack"}; the dispatcher-link writes below land on game_send —
        the game-side hops of the per-hop breakdown bench.py --fanout
        reports."""
        per_gate = entity_manager.collect_entity_sync_infos()
        if not per_gate:
            return
        t0 = time.perf_counter()
        qb = entity_manager.runtime.slabs.sync.quantize_bits
        for gateid, (full, delta) in per_gate.items():
            conn = dispatchercluster.select_by_gate_id(gateid)
            if full:
                conn.send_sync_position_yaw_on_clients(gateid, full)
            if delta:
                conn.send_sync_position_yaw_delta_on_clients(
                    gateid, qb, delta)
        _HOP_GAME_SEND.inc(time.perf_counter() - t0)

    # --- packet handlers (GameService.go:92-157) ------------------------------

    def _handle_packet(self, msgtype: int, packet: Packet) -> None:
        scope = None
        if packet.trace is not None:
            # Sampled request: the handling span (incl. local queue dwell
            # as a child) parents onto the dispatcher's routing span; any
            # reply RPC sent inside re-attaches the trailer toward the
            # client's gate.
            scope = tracing.continue_from_packet(
                packet, "game.handle", dwell_name="game.queue_dwell")
            scope.args["msgtype"] = int(msgtype)
            scope.args["gameid"] = self.gameid
            if not self._tick_trace_id:
                self._tick_trace_id = packet.trace.trace_id
        try:
            if scope is None:
                self._dispatch_packet(msgtype, packet)
            else:
                with scope:
                    self._dispatch_packet(msgtype, packet)
        except Exception:
            gwlog.trace_error("game %d: error handling msgtype %s", self.gameid, msgtype)

    def _dispatch_packet(self, msgtype: int, packet: Packet) -> None:
        if msgtype == MsgType.CALL_ENTITY_METHOD:
            eid = packet.read_entity_id()
            method = packet.read_varstr()
            args = tuple(packet.read_args())
            entity_manager.handle_call(eid, method, args, None)
        elif msgtype == MsgType.CALL_ENTITY_METHOD_FROM_CLIENT:
            eid = packet.read_entity_id()
            method = packet.read_varstr()
            args = tuple(packet.read_args())
            clientid = packet.read_client_id()
            entity_manager.handle_call(eid, method, args, clientid)
        elif msgtype == MsgType.SYNC_POSITION_YAW_FROM_CLIENT:
            for eid, x, y, z, yaw in unpack_sync_records(packet.payload):
                e = entity_manager.get_entity(eid)
                if e is not None:
                    e.on_sync_position_yaw_from_client(x, y, z, yaw)
        elif msgtype == MsgType.NOTIFY_CLIENT_CONNECTED:
            clientid = packet.read_client_id()
            gateid = packet.read_uint16()
            boot_eid = packet.read_entity_id()
            gate_gen = (packet.read_uint32()
                        if packet.unread_len() >= 4 else 0)
            self._handle_client_connected(clientid, gateid, boot_eid,
                                          gate_gen)
        elif msgtype == MsgType.NOTIFY_CLIENT_DISCONNECTED:
            clientid = packet.read_client_id()
            packet.read_entity_id()
            owner = entity_manager.get_client_owner(clientid)
            if owner is not None:
                owner.notify_client_disconnected()
        elif msgtype == MsgType.CREATE_ENTITY_SOMEWHERE:
            packet.read_uint16()
            typename = packet.read_varstr()
            eid = packet.read_entity_id()
            attrs = packet.read_data()
            self._handle_create_entity_somewhere(typename, eid, attrs)
        elif msgtype == MsgType.LOAD_ENTITY_SOMEWHERE:
            packet.read_uint16()
            typename = packet.read_varstr()
            eid = packet.read_entity_id()
            entity_manager.load_entity_locally(typename, eid)
        elif msgtype == MsgType.QUERY_SPACE_GAMEID_FOR_MIGRATE_ACK:
            spaceid = packet.read_entity_id()
            eid = packet.read_entity_id()
            gameid = packet.read_uint16()
            nonce = packet.read_uint32()
            e = entity_manager.get_entity(eid)
            if e is not None:
                e.on_query_space_gameid_ack(spaceid, gameid, nonce)
        elif msgtype == MsgType.MIGRATE_REQUEST_ACK:
            eid = packet.read_entity_id()
            spaceid = packet.read_entity_id()
            space_gameid = packet.read_uint16()
            nonce = packet.read_uint32()
            e = entity_manager.get_entity(eid)
            if e is not None:
                e.on_migrate_request_ack(spaceid, space_gameid, nonce)
        elif msgtype == MsgType.REAL_MIGRATE:
            eid = packet.read_entity_id()
            packet.read_uint16()
            raw_len = packet.unread_len()
            data = packet.read_data()
            if not isinstance(data, dict):
                raise ValueError(
                    f"REAL_MIGRATE body for {eid} is "
                    f"{type(data).__name__}, expected dict")
            self._migrate_in_count += 1
            self._migrate_in_bytes += raw_len
            if raw_len > self._migrate_in_max:
                self._migrate_in_max = raw_len
            entity_manager.restore_entity(eid, data, is_migrate=True)
            # Normal arrival → start the newcomer's re-move cooldown;
            # BOUNCE of our own pending departure (dispatcher returned it
            # because the target game died) → roll the migration back.
            self.migrator.on_arrived(eid, time.monotonic())
        elif msgtype == MsgType.REBALANCE_MIGRATE:
            from_space = packet.read_entity_id()
            to_space = packet.read_entity_id()
            to_game = packet.read_uint16()
            count = packet.read_uint16()
            self._handle_rebalance_migrate(from_space, to_space, to_game, count)
        elif msgtype == MsgType.REBALANCE_MIGRATE_SPACE:
            spaceid = packet.read_entity_id()
            to_game = packet.read_uint16()
            self._handle_rebalance_migrate_space(spaceid, to_game)
        elif msgtype == MsgType.SPACE_MIGRATE_PREPARE_ACK:
            spaceid = packet.read_entity_id()
            dispatcherid = packet.read_uint16()
            self.migrator.on_space_prepare_ack(
                spaceid, dispatcherid, time.monotonic())
        elif msgtype == MsgType.SPACE_MIGRATE_DATA:
            spaceid = packet.read_entity_id()
            packet.read_uint16()
            raw_len = packet.unread_len()
            bundle = packet.read_data()
            if not isinstance(bundle, dict):
                raise ValueError(
                    f"SPACE_MIGRATE_DATA body for {spaceid} is "
                    f"{type(bundle).__name__}, expected dict")
            # Trailing source_game (same convention as REAL_MIGRATE's):
            # present so a dispatcher sweep can bounce the payload home.
            source_game = (packet.read_uint16()
                           if packet.unread_len() >= 2 else 0)
            self._migrate_in_count += 1
            self._migrate_in_bytes += raw_len
            if raw_len > self._migrate_in_max:
                self._migrate_in_max = raw_len
            self.migrator.on_space_data(
                spaceid, bundle, source_game, time.monotonic())
        elif msgtype == MsgType.SPACE_MIGRATE_ABORT:
            spaceid = packet.read_entity_id()
            reason = packet.read_varstr()
            self.migrator.on_space_abort(spaceid, reason, time.monotonic())
        elif msgtype == MsgType.CALL_NIL_SPACES:
            packet.read_uint16()
            method = packet.read_varstr()
            args = tuple(packet.read_args())
            ns = entity_manager.get_nil_space()
            if ns is not None:
                ns.on_call_from_remote(method, args, None)
        elif msgtype == MsgType.SET_GAME_ID_ACK:
            ack = packet.read_data()
            if not isinstance(ack, dict):
                raise ValueError(
                    f"SET_GAME_ID_ACK body is {type(ack).__name__}, "
                    f"expected dict")
            self._handle_set_game_id_ack(ack)
        elif msgtype == MsgType.NOTIFY_GAME_CONNECTED:
            self.online_games.add(packet.read_uint16())
        elif msgtype == MsgType.NOTIFY_GAME_DISCONNECTED:
            self.online_games.discard(packet.read_uint16())
        elif msgtype == MsgType.NOTIFY_GATE_DISCONNECTED:
            gateid = packet.read_uint16()
            valid_gen = (packet.read_uint32()
                         if packet.unread_len() >= 4 else 0)
            entity_manager.on_gate_disconnected(gateid, valid_gen)
        elif msgtype == MsgType.NOTIFY_DEPLOYMENT_READY:
            self._on_deployment_ready()
        elif msgtype == MsgType.KVREG_REGISTER:
            key = packet.read_varstr()
            value = packet.read_varstr()
            kvreg.on_registered(key, value)
        elif msgtype == MsgType.START_FREEZE_GAME_ACK:
            self._freeze_acks += 1
        else:
            gwlog.warnf("game %d: unhandled msgtype %s", self.gameid, msgtype)

    def _handle_rebalance_migrate(self, from_space: str, to_space: str,
                                  to_game: int, count: int) -> None:
        """Dispatcher rebalance command: move up to ``count`` eligible
        entities of ``from_space`` into ``to_space`` (a same-kind space on
        ``to_game``) through the hardened migrate path. A stale command —
        the space moved, emptied, or died since the planner's report —
        degrades to moving fewer (or zero) entities, never to guessing."""
        space = entity_manager.get_space(from_space)
        if space is None or space.is_destroyed():
            gwlog.warnf("game %d: rebalance command for unknown space %s",
                        self.gameid, from_space)
            return
        moved = self.migrator.handle_command(
            space, to_space, count, time.monotonic())
        gwlog.infof(
            "game %d: rebalance command — migrating %d/%d entities of "
            "space %s to %s on game %d", self.gameid, moved, count,
            from_space, to_space, to_game)

    def _handle_rebalance_migrate_space(self, spaceid: str,
                                        to_game: int) -> None:
        """Dispatcher rebalance command: hand the WHOLE space to
        ``to_game`` through the two-phase SPACE_MIGRATE protocol. Same
        staleness contract as the entity command: an unknown / already
        in-flight / cooling-down space degrades to doing nothing."""
        space = entity_manager.get_space(spaceid)
        if space is None or space.is_destroyed():
            gwlog.warnf(
                "game %d: space-rebalance command for unknown space %s",
                self.gameid, spaceid)
            return
        started = self.migrator.handle_space_command(
            space, to_game, time.monotonic())
        gwlog.infof(
            "game %d: space-rebalance command — handoff of %s (%d members)"
            " to game %d %s", self.gameid, spaceid,
            space.get_entity_count(), to_game,
            "started" if started else "refused")

    def _handle_client_connected(self, clientid: str, gateid: int,
                                 boot_eid: str, gate_gen: int = 0) -> None:
        """Create the boot entity and bind the fresh client
        (GameService.go:413-422)."""
        if not self.boot_entity:
            gwlog.errorf("game %d: client connected but no boot entity configured", self.gameid)
            return
        e = entity_manager.create_entity_locally(self.boot_entity, eid=boot_eid)
        e.set_client(GameClient(clientid, gateid, e.id, gate_gen=gate_gen))

    def _handle_create_entity_somewhere(self, typename: str, eid: str, attrs: dict) -> None:
        kind = attrs.pop("_kind", None)
        desc = entity_manager.get_entity_type_desc(typename)
        if desc.is_space and kind is not None:
            entity_manager.create_space_locally(int(kind), eid=eid, attrs=attrs or None)
        else:
            entity_manager.create_entity_locally(typename, eid=eid, attrs=attrs or None)

    def _handle_set_game_id_ack(self, ack: dict) -> None:
        """Reconnect reconciliation + kvreg replay (GameService.go:341-377)."""
        self.online_games = set(ack.get("online_games", []))
        for eid in ack.get("rejected", []):
            e = entity_manager.get_entity(eid)
            if e is not None:
                gwlog.warnf("game %d: destroying rejected entity %s", self.gameid, e)
                e.destroy()
        kvreg.replay(ack.get("kvreg", {}))
        if ack.get("ready"):
            self._on_deployment_ready()

    def _on_deployment_ready(self) -> None:
        if self.deployment_ready:
            return
        self.deployment_ready = True
        gwlog.infof("game %d: deployment ready", self.gameid)
        entity_manager.on_game_ready()
        from goworld_tpu_torch import service as service_mod

        service_mod.on_deployment_ready()

    # --- terminate (GameService.go:194-213) -----------------------------------

    def terminate(self) -> None:
        if self.run_state == RS_RUNNING:
            self.run_state = RS_TERMINATING

    def _do_terminate(self) -> None:
        gwlog.infof("game %d terminating: saving and destroying all entities", self.gameid)
        entity_manager.save_entities_batch()
        for e in list(entity_manager.entities().values()):
            if not e.is_space_entity():
                gwutils.run_panicless(e.destroy)
        for s in list(entity_manager.entities().values()):
            gwutils.run_panicless(s.destroy)
        storage.drain_for_shutdown()
        post.tick()
        self._log_device_memory()
        self.run_state = RS_TERMINATED
        self.exit_code = 0

    # --- freeze (GameService.go:217-310, game.go:163-188) ---------------------

    def start_freeze(self) -> None:
        """SIGHUP entry: ask every dispatcher to buffer our packets."""
        if self.run_state != RS_RUNNING:
            return
        gwlog.infof("game %d freezing: notifying %d dispatchers", self.gameid, len(self.cfg.dispatchers))
        self._freeze_acks = 0
        self._freeze_started_at = time.monotonic()
        self.run_state = RS_FREEZING
        for sender in dispatchercluster.select_all():
            sender.send_start_freeze_game()

    def _do_freeze(self) -> None:
        # AOI flush first: its delivered callbacks may post work or queue
        # storage saves, which the barriers below must then drain.
        aoi = entity_manager.runtime.aoi_service
        if aoi is not None:
            aoi.flush()  # no in-flight AOI diffs may survive the freeze
        post.tick()
        async_jobs.wait_clear()
        data = entity_manager.freeze_entities(self.gameid)
        path = freeze_filename(self.gameid)
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(data, f)
        os.replace(tmp, path)
        gwlog.infof("game %d freezed to %s (%d spaces, %d entities)",
                    self.gameid, path, len(data["spaces"]), len(data["entities"]))
        self._log_device_memory()
        gwlog.infof(consts.FREEZED_TAG)
        self.run_state = RS_FREEZED
        self.exit_code = 2  # CLI restarts with -restore

    def _log_device_memory(self) -> None:
        """One log line with this process's peak device memory (each game
        holds its own CUDA context and caching allocator on the card)."""
        aoi = entity_manager.runtime.aoi_service
        if aoi is None or aoi.device.type != "cuda":
            return
        gwlog.infof(
            "game %d peak device memory: %d bytes allocated, %d reserved",
            self.gameid, torch.cuda.max_memory_allocated(aoi.device),
            torch.cuda.max_memory_reserved(aoi.device))

    def _restore_freezed_entities(self) -> None:
        """restore.go:12-34: read the freeze file and rebuild in 3 passes."""
        path = freeze_filename(self.gameid)
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
        entity_manager.restore_freezed_entities(data)
        os.remove(path)
        gwlog.infof("game %d restored %d spaces + %d entities from %s",
                    self.gameid, len(data["spaces"]), len(data["entities"]), path)

    # --- load reporting (lbc/gamelbc.go:17-39, extended per ROADMAP 1) --------

    def queue_depth(self) -> int:
        return self._queue.qsize()

    async def _lbc_loop(self) -> None:
        """Every [rebalance] report_interval: send the RICH load report
        (cpu%, entities, tick p95, queue depth, per-space populations —
        rebalance/report.py) to every dispatcher. Supersedes the
        reference's cpu-only GAME_LBC_INFO: the dispatcher feeds the same
        cpu number into its LBC choose-game heap AND the rebalancer's
        planner from this one packet."""
        from goworld_tpu_torch.rebalance import build_load_report

        rbcfg = getattr(self.cfg, "rebalance", None)
        to_service = (rbcfg is not None and rbcfg.enabled
                      and rbcfg.planner_service)
        last_cpu = time.process_time()
        last_wall = time.monotonic()
        while True:
            await asyncio.sleep(self._report_interval)
            cpu, wall = time.process_time(), time.monotonic()
            pct = 100.0 * (cpu - last_cpu) / max(1e-9, wall - last_wall)
            last_cpu, last_wall = cpu, wall
            self.last_cpu_pct = pct
            report = build_load_report(self)
            for sender in dispatchercluster.select_all():
                sender.send_game_load_report(report)
            if to_service:
                # Planner-service mode ALSO pushes the report to the
                # sharded planner (deferred-call path: a report racing the
                # failover window delivers to the NEW shard). Dispatchers
                # keep receiving theirs — the LBC heap and /cluster load
                # scores live there regardless of who plans.
                from goworld_tpu_torch import service as service_mod
                from goworld_tpu_torch.rebalance import planner_service as ps

                service_mod.call_service_shard_key(
                    ps.SERVICE_NAME, ps.REPORT_SHARD_KEY, "ReportLoad",
                    self.gameid, report)


def run(gameid: int | None = None, restore: bool | None = None) -> int:
    """Process entry point: parse args (game.go:52-61), run the service."""
    import argparse

    from goworld_tpu_torch.config import get as get_config, set_config_file

    parser = argparse.ArgumentParser(description="goworld_tpu_torch game process")
    parser.add_argument("-gid", type=int, default=gameid or 1)
    parser.add_argument("-configfile", type=str, default="")
    parser.add_argument("-log", type=str, default="")
    parser.add_argument("-restore", action="store_true", default=bool(restore))
    parser.add_argument("-d", action="store_true",
                        help="daemonize (binutil.Daemonize, game.go:70-77)")
    args, _ = parser.parse_known_args()
    if args.configfile:
        set_config_file(args.configfile)
    cfg = get_config()
    game_cfg = cfg.games.get(args.gid)
    if args.d:
        from goworld_tpu_torch.utils.binutil import daemonize

        daemonize((game_cfg.log_file if game_cfg else None)
                  or f"game{args.gid}.daemon.log")
    gwlog.setup(
        level=(args.log or (game_cfg.log_level if game_cfg else "info")),
        logfile=(game_cfg.log_file if game_cfg else None) or None,
        fmt=cfg.log.format,
    )
    gwlog.set_source(f"game{args.gid}")
    svc = GameService(args.gid, cfg, restore=args.restore)
    return asyncio.run(svc.run_async())
