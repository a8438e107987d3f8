"""Multigame harness: N REAL game processes + in-parent dispatchers/gate.

The entity manager is per-process state, so a genuine multi-game world
needs real game processes: this harness spawns ``n_games``
``chaos/game_proc.py`` children against dispatchers, a gate, and strict
bots living in the PARENT process — which is exactly what makes it
measurable: the parent holds the dispatcher objects, so the rebalancer's
report table, the migration counters, the space-handoff park table, and
the kvreg store are directly observable with no scraping.

Entry points, all used by bench.py:

- ``run_multigame`` (the ``--multigame`` floor): the pinned 2-game shape —
  boot with a deliberately fully skewed placement (boot is game1-only,
  every avatar lands in game1's arena), resume the planner at t0, and
  measure rebalance convergence — then run the
  migrate-during-dispatcher-restart chaos phase on the same cluster.
- ``run_multigame_spaces``: 3+ games where the receivers start
  with ZERO arenas, so balancing is only reachable through WHOLE-SPACE
  handoffs, planned by the sharded RebalancePlannerService. The same
  cluster then survives three kill crosses: receiver killed mid-PREPARE
  (the handoff aborts/bounces, the space never leaves the donor),
  donor killed mid-COMMIT (the in-flight SPACE_MIGRATE_DATA still lands
  — a space is never in zero places), and the planner-HOST game killed
  (the service shard fails over and rebalancing resumes).
- ``scenario_migrate_during_dispatcher_restart`` (the chaos-catalog
  cross): kill a dispatcher while commanded migrations are mid-window.
"""

from __future__ import annotations

import asyncio
import os
import subprocess
import sys
import time
from typing import Optional

from goworld_tpu_torch.client import ClientBot
from goworld_tpu_torch.common import hash_entity_id
from goworld_tpu_torch.config.read_config import (
    ClusterConfig,
    DeploymentConfig,
    DispatcherConfig,
    GateConfig,
    GoWorldConfig,
    RebalanceConfig,
)
from goworld_tpu_torch.dispatcher import DispatcherService
from goworld_tpu_torch.gate import GateService
from goworld_tpu_torch.netutil.packet import Packet
from goworld_tpu_torch.proto.msgtypes import MsgType
from goworld_tpu_torch.utils import gwlog

ARENA_KIND = 1
PLANNER_SHARD_KEY = "Service/RebalancePlannerService#0"
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

_INI = """\
[deployment]
dispatchers = {n_disp}
games = {n_games}
gates = 1

{dispatcher_sections}
[game_common]
save_interval = 0
position_sync_interval = 0.05
log_level = info

{game_sections}
[gate1]
port = {gate_port}

[storage]
type = filesystem
directory = {dir}/es

[kvdb]
type = filesystem
directory = {dir}/kv

[aoi]
backend = xzlist

[cluster]
peer_heartbeat_timeout = {hb}
reconnect_max_interval = 1.0
transport = {transport}
uds_dir = {uds_dir}

[rebalance]
enabled = true
driver_dispatcher = 1
interval = {interval}
report_interval = {report_interval}
stale_after = {stale_after}
min_entity_delta = {min_delta}
max_moves_per_round = {max_moves}
max_space_moves_per_round = {max_space_moves}
planner_service = {planner_service}
migrate_timeout = {migrate_timeout}
cooldown = {cooldown}
"""




class MultigameCluster:
    """N game subprocesses × M spaces, dispatchers + gate + bots in-parent.

    ``arenas`` is the per-game MG_ARENAS list (how many kind-1 arenas each
    child creates at deployment-ready); the default — one everywhere —
    is the pinned 2-game floor shape. The whole-space scenarios give
    game1 several and every receiver ZERO: a receiver without a same-kind
    space is exactly what makes the planner reach for whole-space moves.
    """

    def __init__(self, run_dir: str, n_bots: int = 12,
                 n_dispatchers: int = 2, transport: str = "tcp",
                 n_games: int = 2, arenas: Optional[list] = None,
                 planner_service: bool = False,
                 max_space_moves: int = 0) -> None:
        self.run_dir = run_dir
        self.n_bots = n_bots
        self.n_dispatchers = n_dispatchers
        self.n_games = n_games
        self.transport = transport
        self.arenas = (list(arenas) if arenas is not None
                       else [1] * n_games)
        assert len(self.arenas) == n_games
        self.rebalance_cfg = RebalanceConfig(
            enabled=True, driver_dispatcher=1, interval=0.5,
            report_interval=0.25, stale_after=3.0, min_entity_delta=4,
            max_moves_per_round=4, migrate_timeout=4.0, cooldown=2.0,
            max_space_moves_per_round=max_space_moves,
            planner_service=planner_service)
        # 3 s, not the chaos harness's 1 s: the children are real
        # processes competing for the same (often 1-core) host — a busy
        # box legitimately deschedules a child past 1 s, and a flapping
        # link mid-boot turns a timing artifact into a spurious restart.
        self.peer_heartbeat_timeout = 3.0
        self.dispatchers: list[Optional[DispatcherService]] = []
        # Every dispatcher object ever started (dead ones included): the
        # migration counters are summed over OBJECTS, because a stopped
        # service unregisters its telemetry children and family sums would
        # go backwards across a restart.
        self._all_dispatchers: list[DispatcherService] = []
        self.ports: list[int] = []
        self.gate: Optional[GateService] = None
        self.games: list[Optional[subprocess.Popen]] = []
        self.bots: list[ClientBot] = []
        self._sync_tasks: list[asyncio.Task] = []
        self._ping_seq = 0
        self._pongs: dict[str, list] = {}

    def game_ids(self) -> list[int]:
        return list(range(1, self.n_games + 1))

    def live_game_ids(self) -> list[int]:
        return [g for g in self.game_ids()
                if self.games and self.games[g - 1] is not None
                and self.games[g - 1].poll() is None]

    # --- lifecycle ----------------------------------------------------------

    async def start(self, boot_deadline: float = 60.0) -> None:
        uds_dir = self.run_dir if self.transport == "uds" else None
        for i in range(self.n_dispatchers):
            d = DispatcherService(
                i + 1, desired_games=self.n_games, desired_gates=1,
                peer_heartbeat_timeout=self.peer_heartbeat_timeout,
                rebalance=self.rebalance_cfg)
            d.rebalance_pause()  # resumed at the measured t0
            await d.start(uds_dir=uds_dir)
            self.dispatchers.append(d)
            self._all_dispatchers.append(d)
            self.ports.append(d.port)

        cfg = GoWorldConfig()
        cfg.deployment = DeploymentConfig(
            desired_games=self.n_games, desired_gates=1,
            desired_dispatchers=self.n_dispatchers)
        cfg.dispatchers = {
            i + 1: DispatcherConfig(port=p)
            for i, p in enumerate(self.ports)}
        cfg.gates = {1: GateConfig(
            port=0, position_sync_interval=0.05, heartbeat_timeout=30.0)}
        cfg.cluster = ClusterConfig(
            peer_heartbeat_timeout=self.peer_heartbeat_timeout,
            reconnect_max_interval=1.0,
            transport=self.transport,
            uds_dir=self.run_dir if self.transport == "uds" else "")
        cfg.rebalance = self.rebalance_cfg
        self.cfg = cfg
        self.gate = GateService(1, cfg)
        await self.gate.start()

        # Debug ports for the REAL game children: the cluster-view
        # convergence check scrapes their /snapshot over HTTP — the same
        # production path the driver dispatcher's collector uses.
        self.game_http = [self._free_port() for _ in self.game_ids()]
        rb = self.rebalance_cfg
        game_sections = ""
        for gid in self.game_ids():
            boot = "boot_entity = MGAvatar\n" if gid == 1 else ""
            game_sections += (
                f"[game{gid}]\n{boot}log_file = game{gid}.log\n"
                f"http_addr = 127.0.0.1:{self.game_http[gid - 1]}\n\n")
        ini = _INI.format(
            n_games=self.n_games, game_sections=game_sections,
            n_disp=self.n_dispatchers,
            dispatcher_sections="".join(
                f"[dispatcher{i + 1}]\nport = {p}\n\n"
                for i, p in enumerate(self.ports)),
            gate_port=self.gate.port, dir=self.run_dir,
            transport=self.transport,
            uds_dir=self.run_dir if self.transport == "uds" else "",
            hb=self.peer_heartbeat_timeout,
            interval=rb.interval, report_interval=rb.report_interval,
            stale_after=rb.stale_after, min_delta=rb.min_entity_delta,
            max_moves=rb.max_moves_per_round,
            max_space_moves=rb.max_space_moves_per_round,
            planner_service="true" if rb.planner_service else "false",
            migrate_timeout=rb.migrate_timeout, cooldown=rb.cooldown)
        self.ini_path = os.path.join(self.run_dir, "goworld.ini")
        with open(self.ini_path, "w", encoding="utf-8") as f:
            f.write(ini)

        self.games = [None] * self.n_games
        for gid in self.game_ids():
            self._spawn_game(gid)

        await self._wait(
            lambda: all(
                sum(1 for gi in d.games.values() if gi.connected)
                == self.n_games
                for d in self.dispatchers if d is not None)
            and self.dispatchers[0].deployment_ready,
            boot_deadline, "game processes never all connected",
            on_fail=self._game_log_tails)
        # Every game must have reported (arena ids come from the reports);
        # arena-less games (MG_ARENAS=0) legitimately report no spaces.
        await self._wait(
            lambda: len(self._planner().reports.games()) == self.n_games
            and all(self._arena(g) is not None
                    for g in self.game_ids() if self.arenas[g - 1] > 0),
            boot_deadline, "games never reported their arenas")

        for i in range(self.n_bots):
            bot = ClientBot(name=f"mgbot{i}", strict=True,
                            heartbeat_interval=1.0)
            self._pongs[bot.name] = []
            bot.rpc_handlers[(None, "Pong")] = (
                lambda entity, n, name=bot.name: self._pongs[name].append(n))
            await bot.connect("127.0.0.1", self.gate.port)
            await bot.wait_player(timeout=15)
            self.bots.append(bot)
            self._sync_tasks.append(
                asyncio.get_running_loop().create_task(self._sync_loop(bot)))
        # Skew barrier: every avatar sits in a game1 arena (boot is
        # game1-only), visible through the load reports.
        await self._wait(
            lambda: self._game_pop(1) == self.n_bots,
            30.0, "avatars never all collected in game1's arenas")

    def _spawn_game(self, gid: int) -> None:
        # One torch thread a game: the games share the host with the
        # dispatchers, the gate and the bots, and torch's intra-op threads
        # would contend across them.
        env = dict(os.environ, PYTHONPATH=_REPO, OMP_NUM_THREADS="1",
                   MG_ARENAS=str(self.arenas[gid - 1]))
        logf = open(os.path.join(self.run_dir, f"game{gid}.out.log"), "ab")
        proc = subprocess.Popen(
            [sys.executable, "-m", "goworld_tpu_torch.chaos.game_proc",
             "-gid", str(gid), "-configfile", self.ini_path],
            cwd=self.run_dir, env=env, stdout=logf,
            stderr=subprocess.STDOUT)
        logf.close()
        self.games[gid - 1] = proc

    async def _kill_game(self, gid: int) -> None:
        """SIGKILL a game child — the crash model of the kill crosses
        (no atexit, no socket shutdown beyond the kernel's RST)."""
        proc = self.games[gid - 1]
        assert proc is not None and proc.poll() is None, f"game{gid} dead"
        proc.kill()
        deadline = time.monotonic() + 10.0
        while proc.poll() is None and time.monotonic() < deadline:
            await asyncio.sleep(0.02)
        gwlog.infof("multigame: game%d killed", gid)

    async def _respawn_game(self, gid: int, deadline: float = 30.0) -> None:
        """Restart a killed child and wait until every dispatcher sees it
        connected AND it reports again (census helpers read the reports)."""
        self._spawn_game(gid)
        await self._wait(
            lambda: all(d._game(gid).connected
                        for d in self.dispatchers if d is not None)
            and self._report(gid) is not None,
            deadline, f"game{gid} never rejoined after respawn",
            on_fail=self._game_log_tails)

    async def stop(self) -> None:
        for t in self._sync_tasks:
            t.cancel()
        self._sync_tasks.clear()
        for b in self.bots:
            await b.close()
        self.bots.clear()
        if self.gate is not None:
            await self.gate.stop()
            self.gate = None
        for proc in self.games:
            if proc is not None and proc.poll() is None:
                proc.terminate()
        deadline = time.monotonic() + 10.0
        for proc in self.games:
            if proc is None:
                continue
            while proc.poll() is None and time.monotonic() < deadline:
                await asyncio.sleep(0.05)
            if proc.poll() is None:
                proc.kill()
        self.games.clear()
        for d in self.dispatchers:
            if d is not None:
                await d.stop()
        self.dispatchers.clear()

    def _game_log_tails(self) -> str:
        tails = []
        for gid in self.game_ids():
            try:
                with open(os.path.join(self.run_dir,
                                       f"game{gid}.out.log"), "rb") as f:
                    data = f.read()[-800:]
                tails.append(f"game{gid}: ...{data.decode(errors='replace')}")
            except OSError:
                pass
        return "\n".join(tails)

    async def _wait(self, cond, timeout: float, what: str,
                    on_fail=None) -> None:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if cond():
                return
            await asyncio.sleep(0.02)
        extra = f"\n{on_fail()}" if on_fail is not None else ""
        raise AssertionError(f"multigame: {what} (after {timeout:.1f}s)"
                             f"{extra}")

    async def _sync_loop(self, bot: ClientBot) -> None:
        """Light client-driven position jitter (the sync plane the migrate
        window must buffer — records sent mid-migrate must land on the
        entity's NEW game, never a stale one)."""
        import random

        while True:
            await asyncio.sleep(0.1)
            p = bot.player
            if p is not None:
                p.sync_position(p.x + random.uniform(-0.5, 0.5), p.y,
                                p.z + random.uniform(-0.5, 0.5), p.yaw)

    # --- observability -------------------------------------------------------

    @staticmethod
    def _free_port() -> int:
        import socket

        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return int(s.getsockname()[1])

    def collector_targets(self):
        """Cluster-collector targets: the REAL game children are scraped
        over their debug HTTP ports (the exact production path), the
        in-parent dispatchers/gate feed the collector directly — the
        process-global health-provider slot can't tell them apart."""
        from goworld_tpu_torch.telemetry.collector import http_target

        def disp_fetch(i: int):
            async def fetch() -> dict:
                d = self.dispatchers[i]
                if d is None:
                    raise RuntimeError("dispatcher killed")
                return {"health": d._health(), "metrics": {}}

            return fetch

        async def gate_fetch() -> dict:
            if self.gate is None:
                raise RuntimeError("gate down")
            return {"health": self.gate._health(), "metrics": {}}

        targets = [(f"dispatcher{i + 1}", disp_fetch(i))
                   for i in range(self.n_dispatchers)]
        for gid in self.game_ids():
            targets.append(http_target(
                f"game{gid}", f"127.0.0.1:{self.game_http[gid - 1]}"))
        targets.append(("gate1", gate_fetch))
        return targets

    async def game_metric(self, gid: int, family: str,
                          label: Optional[str] = None,
                          value: Optional[str] = None) -> float:
        """One metric family's series sum scraped from a child's
        /snapshot — how the parent asserts child-side rebalance counters
        (space-handoff outcomes, the planner-host gauge)."""
        from goworld_tpu_torch.telemetry.collector import (
            _series_sum,
            http_fetch_json,
        )

        snap = await http_fetch_json(
            f"127.0.0.1:{self.game_http[gid - 1]}", "/snapshot")
        return _series_sum(snap.get("metrics", {}), family, label, value)

    async def assert_cluster_view_converged(
            self, deadline: float = 25.0) -> float:
        """The aggregated view over every real game process +
        dispatchers + gate must re-converge — every process reporting,
        client census conserved at the bot count across the games, no
        stale generation rows. Returns seconds until convergence."""
        import json as _json

        from goworld_tpu_torch.telemetry.collector import ClusterCollector

        coll = ClusterCollector(self.collector_targets(), interval=0.1)
        t0 = time.monotonic()
        last = None
        while time.monotonic() - t0 < deadline:
            await coll.poll_once()
            summary = coll.view()["summary"]
            census = summary["census"]
            if (summary["reporting"] == summary["expected"]
                    and not summary["alerts"]
                    and census["clients_conserved"]
                    and census["gate_clients"] == len(self.bots)):
                return time.monotonic() - t0
            last = summary
            await asyncio.sleep(0.1)
        raise AssertionError(
            "multigame: /cluster view never re-converged: "
            f"{_json.dumps(last, default=str)}")

    def _planner(self):
        for d in self.dispatchers:
            if d is not None:
                return d.planner
        raise AssertionError("no live dispatcher")

    def _live_dispatcher(self) -> DispatcherService:
        for d in self.dispatchers:
            if d is not None:
                return d
        raise AssertionError("no live dispatcher")

    def _report(self, gameid: int) -> dict | None:
        return self._planner().reports.get(gameid)

    def _arenas_of(self, gameid: int) -> list[tuple[str, int]]:
        r = self._report(gameid) or {}
        return [(sid, int(count)) for sid, kind, count in
                r.get("spaces", []) if kind == ARENA_KIND]

    def _arena(self, gameid: int):
        arenas = self._arenas_of(gameid)
        return arenas[0][0] if arenas else None

    def _game_pop(self, gameid: int) -> int:
        return sum(count for _sid, count in self._arenas_of(gameid))

    def census(self) -> tuple:
        return tuple(self._game_pop(g) for g in self.game_ids())

    def space_handoffs(self) -> int:
        """Spaces currently parked at any live dispatcher (the handoff
        table every PREPARE fills and every abort/ack/deadline drains)."""
        return sum(len(d._space_handoffs)
                   for d in self.dispatchers if d is not None)

    def kvreg_lookup(self, key: str) -> Optional[str]:
        for d in self.dispatchers:
            if d is not None and key in d.kvreg:
                return d.kvreg[key]
        return None

    def planner_host_game(self) -> Optional[int]:
        """Which game owns the RebalancePlannerService shard, per the
        dispatchers' replicated kvreg store ("game<N>")."""
        val = self.kvreg_lookup(PLANNER_SHARD_KEY)
        if val is None or not val.startswith("game"):
            return None
        try:
            return int(val[4:])
        except ValueError:
            return None

    def command_space_move(self, spaceid: str, donor: int,
                           to_game: int) -> None:
        """Inject one whole-space handoff command through a live
        dispatcher's plan-dispatch path (the same packet a planning round
        or a REBALANCE_PLAN push would produce)."""
        from goworld_tpu_torch.rebalance.planner import SpaceMove

        self._live_dispatcher()._dispatch_plan(
            [SpaceMove(donor, to_game, spaceid, 0)], time.monotonic())

    async def _command_until(self, sid: str, donor: int, to_game: int,
                             cond, deadline: float, what: str) -> None:
        """Re-issue a space-move command until its observable effect
        lands: ``handle_space_command`` refuses SILENTLY while the space
        is on its post-arrival / post-rollback cooldown (by design — a
        stale command degrades to nothing), so a chaos phase that needs
        the handoff to actually START must keep asking."""
        end = time.monotonic() + deadline
        while time.monotonic() < end:
            self.command_space_move(sid, donor, to_game)
            retry_at = min(end, time.monotonic() + 1.0)
            while time.monotonic() < retry_at:
                if cond():
                    return
                await asyncio.sleep(0.02)
        raise AssertionError(
            f"multigame: {what} (after {deadline:.1f}s)\n"
            + self._game_log_tails())

    def _mig_counters(self) -> dict[str, int]:
        return {
            "routed": sum(d.migrates_routed for d in self._all_dispatchers),
            "bounced": sum(d.migrates_bounced
                           for d in self._all_dispatchers),
            "cancel": sum(d.migrates_cancelled
                          for d in self._all_dispatchers),
        }

    def bot_errors(self) -> list[str]:
        return [err for b in self.bots for err in b.errors]

    async def assert_rpc_roundtrip(self, deadline: float = 15.0) -> float:
        """Every bot pings its avatar (wherever it now lives) and must get
        its pong — the client-visible zero-loss probe."""
        self._ping_seq += 1
        n = self._ping_seq
        t0 = time.monotonic()
        for b in self.bots:
            assert b.player is not None, f"{b.name}: player mirror lost"
            b.player.call_server("Ping_Client", n)
        await self._wait(
            lambda: all(n in self._pongs[b.name] for b in self.bots),
            deadline, f"ping {n}: not every bot got its pong")
        return time.monotonic() - t0

    def _pause_planners(self) -> None:
        for d in self.dispatchers:
            if d is not None:
                d.rebalance_pause()

    def _resume_planners(self) -> None:
        for d in self.dispatchers:
            if d is not None:
                d.rebalance_resume()

    # --- phases --------------------------------------------------------------

    async def wait_balanced(self, deadline: float = 30.0,
                            what: str = "never balanced") -> float:
        """Wait until per-game populations are balanced AND stable.
        Stability must SPAN report cycles (the census is read from the
        cached reports): balanced and unchanged for 3 report intervals,
        with the sum conserved (an in-flight migration makes it dip).
        Does NOT touch planner pause state. Returns the wait's length."""
        tol = self.rebalance_cfg.min_entity_delta
        span = 3.0 * self.rebalance_cfg.report_interval
        t0 = time.monotonic()
        state = {"census": None, "since": 0.0}

        def balanced() -> bool:
            c = self.census()
            now = time.monotonic()
            if c != state["census"]:
                state["census"], state["since"] = c, now
            return (sum(c) == self.n_bots
                    and max(c) - min(c) <= tol
                    and now - state["since"] >= span)

        await self._wait(
            balanced, deadline, what,
            on_fail=lambda: (
                f"census {self.census()}, reports "
                f"{ {g: self._report(g) for g in self.game_ids()} }\n"
                + self._game_log_tails()))
        return time.monotonic() - t0

    async def converge(self, deadline: float = 30.0) -> dict:
        """Resume the planner at t0; wait until the per-game populations
        are balanced AND stable (two consecutive report snapshots agree
        and the full census is conserved — in-flight migrations make the
        sum dip, so a conserved sum means nothing is mid-air)."""
        mig0 = self._mig_counters()
        t0 = time.monotonic()
        self._resume_planners()
        await self.wait_balanced(deadline, "never converged")
        convergence_s = time.monotonic() - t0
        rt = await self.assert_rpc_roundtrip()
        mig1 = self._mig_counters()
        return {
            "convergence_s": round(convergence_s, 3),
            "census": list(self.census()),
            "migrations_done": int(mig1["routed"] - mig0["routed"]),
            "migrations_rolled_back": int(
                (mig1["cancel"] - mig0["cancel"])
                + (mig1["bounced"] - mig0["bounced"])),
            "post_roundtrip_s": round(rt, 3),
            "zero_loss": sum(self.census()) == self.n_bots,
            "bot_errors": len(self.bot_errors()),
        }

    async def _wait_census_settled(self, games: list[int], deadline: float,
                                   what: str) -> None:
        """Sum over ``games`` back at n_bots and unchanged for 3 report
        intervals, with no space parked at any dispatcher."""
        span = 3.0 * self.rebalance_cfg.report_interval
        state = {"census": None, "since": 0.0}

        def settled() -> bool:
            c = tuple(self._game_pop(g) for g in games)
            t = time.monotonic()
            if c != state["census"]:
                state["census"], state["since"] = c, t
            return (sum(c) == self.n_bots
                    and self.space_handoffs() == 0
                    and t - state["since"] >= span)

        await self._wait(
            settled, deadline, what,
            on_fail=lambda: (
                f"census {tuple(self._game_pop(g) for g in games)}, "
                f"handoffs {self.space_handoffs()}, reports "
                f"{ {g: self._report(g) for g in games} }\n"
                + self._game_log_tails()))

    async def kill_receiver_mid_prepare(
            self, deadline: float = 30.0) -> dict:
        """Kill cross 1: command a whole-space handoff and kill
        the RECEIVER game in the same instant — its death races the
        PREPARE fan-out. Whichever window the kill lands in (dispatcher
        already knows → the PREPARE is refused with an ABORT; dispatchers
        parked first → the packed SPACE_MIGRATE_DATA bounces home off the
        dead link), the space must end up back on the donor, unfrozen,
        with every member and every bot answering — never in zero places,
        never lost."""
        self._pause_planners()
        donor = 1
        receivers = [g for g in self.live_game_ids()
                     if g != donor and self._game_pop(g) == 0]
        assert receivers, "no empty receiver to kill mid-PREPARE"
        receiver = receivers[0]
        census0 = self.census()
        arenas = self._arenas_of(donor)
        assert arenas, "donor has no arena"
        sid = max(arenas, key=lambda a: a[1])[0]
        t0 = time.monotonic()
        # Command + SIGKILL in the same event-loop turn: the command is
        # still in the parent→donor socket buffer when the receiver dies,
        # so the donor's PREPARE broadcast races the dispatchers' dead-
        # link detection — the exact window the two-phase protocol exists
        # for.
        self.command_space_move(sid, donor, receiver)
        await self._kill_game(receiver)
        survivors = [g for g in self.game_ids() if g != receiver]
        await self._wait(
            lambda: (self.space_handoffs() == 0
                     and self._game_pop(donor) == census0[donor - 1]),
            deadline, "space never returned home after receiver kill",
            on_fail=lambda: (
                f"census {self.census()}, handoffs "
                f"{self.space_handoffs()}\n" + self._game_log_tails()))
        await self._wait_census_settled(
            survivors, deadline, "census never settled after receiver kill")
        # The donor's own counters must classify the outcome: exactly one
        # handoff ended aborted / rolled_back / timeout, zero done.
        failed = sum([
            await self.game_metric(
                donor, "rebalance_space_migrations_total",
                "outcome", outcome)
            for outcome in ("aborted", "rolled_back", "timeout")])
        done = await self.game_metric(
            donor, "rebalance_space_migrations_total", "outcome", "done")
        assert failed >= 1.0 and done == 0.0, (failed, done)
        await self._respawn_game(receiver)
        rt = await self.assert_rpc_roundtrip(deadline)
        errors = self.bot_errors()
        assert not errors, f"bot errors in mid-PREPARE kill: {errors[:5]}"
        return {
            "scenario": "space_kill_receiver_mid_prepare",
            "recovery_s": round(time.monotonic() - t0, 3),
            "census_before": list(census0),
            "census_after": list(self.census()),
            "donor_outcomes_failed": int(failed),
            "post_roundtrip_s": round(rt, 3),
            "zero_loss": sum(self.census()) == self.n_bots,
            "bot_errors": len(errors),
        }

    async def kill_donor_mid_commit(self, deadline: float = 30.0) -> dict:
        """Kill cross 2: kill the DONOR game the instant its
        SPACE_MIGRATE_DATA has passed the space-owner dispatcher (the
        parent watches the routed counter, so the kill provably lands
        inside the commit window — data sent, ACK not yet seen). The
        space and every member must survive on the receiver: the payload
        in flight IS the space's one live copy, and the dispatcher is
        obligated to deliver it."""
        self._pause_planners()
        # The donor must hold its WHOLE population inside one arena —
        # killing it then loses nothing but the space already in flight.
        candidates = [
            g for g in self.live_game_ids()
            if len(self._arenas_of(g)) == 1 and self._game_pop(g) > 0
            and g != 1]
        if not candidates:
            candidates = [g for g in self.live_game_ids()
                          if len(self._arenas_of(g)) == 1
                          and self._game_pop(g) > 0]
        assert candidates, f"no single-arena donor in {self.census()}"
        donor = candidates[0]
        sid, count0 = self._arenas_of(donor)[0]
        receiver = min(
            (g for g in self.live_game_ids() if g != donor),
            key=self._game_pop)
        census0 = self.census()
        mig0 = self._mig_counters()["routed"]
        t0 = time.monotonic()
        # Tight poll: the routed counter increments in the dispatcher's
        # own handler (same process), so routed > mig0 means the payload
        # is PAST the dispatcher and queued toward the live receiver.
        # Re-issued because the arena may still sit on its post-arrival
        # cooldown from the convergence phase.
        await self._command_until(
            sid, donor, receiver,
            lambda: self._mig_counters()["routed"] > mig0,
            deadline, "SPACE_MIGRATE_DATA never crossed a dispatcher")
        await self._kill_game(donor)
        survivors = [g for g in self.game_ids() if g != donor]
        await self._wait(
            lambda: any(s == sid and c == count0
                        for s, c in self._arenas_of(receiver)),
            deadline,
            f"space {sid} never restored on game{receiver} with "
            f"{count0} members",
            on_fail=lambda: (
                f"census {self.census()}, receiver arenas "
                f"{self._arenas_of(receiver)}\n" + self._game_log_tails()))
        await self._wait_census_settled(
            survivors, deadline, "census never settled after donor kill")
        await self._respawn_game(donor)
        # The respawned donor's slot holds the DEAD incarnation's report
        # until the fresh (empty) game reports in — wait it out so the
        # census below counts live entities, not ghosts.
        await self._wait(
            lambda: sum(self.census()) == self.n_bots, deadline,
            "census never matched the fleet after donor respawn",
            on_fail=lambda: f"census {self.census()}")
        rt = await self.assert_rpc_roundtrip(deadline)
        errors = self.bot_errors()
        assert not errors, f"bot errors in mid-COMMIT kill: {errors[:5]}"
        return {
            "scenario": "space_kill_donor_mid_commit",
            "recovery_s": round(time.monotonic() - t0, 3),
            "census_before": list(census0),
            "census_after": list(self.census()),
            "moved_space": sid,
            "moved_members": count0,
            "post_roundtrip_s": round(rt, 3),
            "zero_loss": sum(self.census()) == self.n_bots,
            "bot_errors": len(errors),
        }

    async def kill_planner_host(self, deadline: float = 45.0) -> dict:
        """Kill cross 3 (planner failover): evacuate the planner-
        host game through whole-space handoffs (zero loss), SIGKILL it,
        and require the sharded RebalancePlannerService to fail over — the
        dispatcher purges the dead game's kvreg claims, a survivor
        re-claims the shard, and its planner RESUMES rebalancing the skew
        the earlier kills left behind. Needs [rebalance]
        planner_service."""
        assert self.rebalance_cfg.planner_service
        self._pause_planners()
        await self._wait(
            lambda: self.planner_host_game() in self.live_game_ids(),
            deadline, "planner shard never claimed by a live game")
        host = self.planner_host_game()
        # Evacuate: every arena on the host moves whole to the emptiest
        # other game, through the same two-phase handoff under test.
        for sid, _count in self._arenas_of(host):
            target = min(
                (g for g in self.live_game_ids() if g != host),
                key=self._game_pop)
            await self._command_until(
                sid, host, target,
                lambda s=sid, t=target: any(
                    row[0] == s for row in self._arenas_of(t)),
                deadline, f"evacuation of {sid} off game{host} never landed")
        await self._wait(
            lambda: self._game_pop(host) == 0
            and self.space_handoffs() == 0,
            deadline, f"game{host} never drained before the kill")
        census0 = self.census()
        t0 = time.monotonic()
        await self._kill_game(host)
        survivors = [g for g in self.game_ids() if g != host]
        # Failover: the purge must release the shard claim and a SURVIVOR
        # must win the re-registration race.
        await self._wait(
            lambda: self.planner_host_game() in survivors,
            deadline, "planner shard never failed over to a survivor")
        new_host = self.planner_host_game()
        failover_s = time.monotonic() - t0
        # The new host's own gauge must agree with the kvreg claim (the
        # claim lands first; the entity — and its gauge — follows on the
        # winner's next reconcile pass).
        host_gauge = 0.0
        gauge_deadline = time.monotonic() + deadline
        while time.monotonic() < gauge_deadline:
            try:
                host_gauge = await self.game_metric(
                    new_host, "rebalance_planner_host")
            except (OSError, ValueError):
                host_gauge = 0.0
            if host_gauge >= 1.0:
                break
            await asyncio.sleep(0.1)
        assert host_gauge >= 1.0, (
            f"game{new_host} claims the planner shard but its "
            f"rebalance_planner_host gauge is {host_gauge}")
        # ...and resumed planning must fix the skew the kills left: the
        # evacuated arenas sit wherever we pushed them, so the failed-over
        # planner has real work to do.
        self._resume_planners()
        tol = self.rebalance_cfg.min_entity_delta
        span = 3.0 * self.rebalance_cfg.report_interval
        state = {"census": None, "since": 0.0}

        def balanced() -> bool:
            c = tuple(self._game_pop(g) for g in survivors)
            now = time.monotonic()
            if c != state["census"]:
                state["census"], state["since"] = c, now
            return (sum(c) == self.n_bots
                    and max(c) - min(c) <= tol
                    and now - state["since"] >= span)

        await self._wait(
            balanced, deadline,
            "failed-over planner never rebalanced the survivors",
            on_fail=lambda: (
                f"census {self.census()}, planner host "
                f"{self.planner_host_game()}\n" + self._game_log_tails()))
        rebalanced_s = time.monotonic() - t0
        await self._respawn_game(host)
        await self._wait_census_settled(
            self.game_ids(), deadline,
            "census never settled after planner-host respawn")
        rt = await self.assert_rpc_roundtrip(deadline)
        errors = self.bot_errors()
        assert not errors, f"bot errors in planner-host kill: {errors[:5]}"
        return {
            "scenario": "space_kill_planner_host",
            "old_host": host,
            "new_host": new_host,
            "new_host_gauge": host_gauge,
            "failover_s": round(failover_s, 3),
            "recovery_s": round(rebalanced_s, 3),
            "census_before": list(census0),
            "census_after": list(self.census()),
            "post_roundtrip_s": round(rt, 3),
            "zero_loss": sum(self.census()) == self.n_bots,
            "bot_errors": len(errors),
        }

    async def migrate_during_dispatcher_restart(
        self, moves: int = 4, downtime: float = 1.0,
        deadline: float = 25.0,
    ) -> dict:
        """THE ROADMAP-named scenario: command a batch of migrations, kill
        a dispatcher inside the migrate window (before yielding to the
        event loop, so nothing has completed yet), restart it, and require
        every migration to complete (possibly via the replay-ring flush)
        or roll back — census conserved, every bot answering."""
        self._pause_planners()
        donor = max(self.live_game_ids(), key=self._game_pop)
        recv = min((g for g in self.live_game_ids() if g != donor),
                   key=self._game_pop)
        from_space, to_space = self._arena(donor), self._arena(recv)
        assert from_space and to_space, "arenas unknown"
        mig0 = self._mig_counters()
        census0 = self.census()
        # The migrate chain fans over dispatchers by id hash: the space
        # query rides hash(to_space)'s dispatcher, the per-entity blocks
        # ride hash(eid)'s. Kill the one NOT owning the space query so
        # queries still flow and ~half the entities' MIGRATE_REQUESTs are
        # mid-air when the link dies (they park in the games' replay
        # rings and must resolve after the restart).
        owner_idx = hash_entity_id(to_space) % self.n_dispatchers
        victim = (owner_idx + 1) % self.n_dispatchers
        # The command itself must ride a SURVIVING dispatcher's game link
        # (sending it through the victim would abort it in the socket
        # buffer and nothing would ever be mid-air).
        commander = self.dispatchers[owner_idx]
        p = Packet()
        p.append_entity_id(from_space)
        p.append_entity_id(to_space)
        p.append_uint16(recv)
        p.append_uint16(moves)
        now = time.monotonic()
        commander._game(donor).dispatch(MsgType.REBALANCE_MIGRATE, p, now)
        # Same event-loop turn: the command is in the socket buffer but no
        # ack has come back — the kill lands inside the migrate window.
        d = self.dispatchers[victim]
        for proxy in list(d._conns):
            proxy.conn.abort()
        await d.stop()
        self.dispatchers[victim] = None
        gwlog.infof("multigame: dispatcher %d killed mid-migrate",
                    victim + 1)
        await asyncio.sleep(downtime)
        t0 = time.monotonic()
        nd = DispatcherService(
            victim + 1, desired_games=self.n_games, desired_gates=1,
            peer_heartbeat_timeout=self.peer_heartbeat_timeout,
            rebalance=self.rebalance_cfg)
        nd.rebalance_pause()
        self._all_dispatchers.append(nd)
        for _ in range(100):
            try:
                await nd.start(
                    port=self.ports[victim],
                    uds_dir=(self.run_dir if self.transport == "uds"
                             else None))
                break
            except OSError:
                await asyncio.sleep(0.05)
        else:
            raise AssertionError("could not rebind dispatcher port")
        self.dispatchers[victim] = nd

        # Settled = census conserved and unchanged for 3 report intervals
        # (an in-flight migration makes the sum dip; a just-landing one
        # changes the split).
        span = 3.0 * self.rebalance_cfg.report_interval
        state = {"census": None, "since": 0.0}

        def settled() -> bool:
            c = self.census()
            t = time.monotonic()
            if c != state["census"]:
                state["census"], state["since"] = c, t
            return sum(c) == self.n_bots and t - state["since"] >= span

        def diag() -> str:
            lines = [
                f"reports: "
                f"{ {g: self._report(g) for g in self.game_ids()} }"]
            for i, d in enumerate(self.dispatchers):
                if d is None:
                    lines.append(f"dispatcher[{i}]: None")
                    continue
                lines.append(
                    f"dispatcher[{i}] id={d.dispid} games="
                    f"{ {g: gi.connected for g, gi in d.games.items()} } "
                    f"planner_games={d.planner.reports.games()}")
            lines.append(self._game_log_tails())
            return "\n".join(lines)
        await self._wait(settled, deadline,
                         f"census never settled (is {self.census()})",
                         on_fail=diag)
        rt = await self.assert_rpc_roundtrip(deadline)
        recovery = time.monotonic() - t0
        mig1 = self._mig_counters()
        errors = self.bot_errors()
        assert not errors, f"bot errors during migrate+restart: {errors[:5]}"
        done = int(mig1["routed"] - mig0["routed"])
        rolled = int((mig1["cancel"] - mig0["cancel"])
                     + (mig1["bounced"] - mig0["bounced"]))
        view_converge = await self.assert_cluster_view_converged()
        return {
            "scenario": "migrate_during_dispatcher_restart",
            "recovery_s": round(recovery, 3),
            "cluster_view_converge_s": round(view_converge, 3),
            "post_roundtrip_s": round(rt, 3),
            "census_before": list(census0),
            "census_after": list(self.census()),
            "migrations_done": done,
            "migrations_rolled_back": rolled,
            "commanded": moves,
            "zero_loss": sum(self.census()) == self.n_bots,
            "bot_errors": len(errors),
        }


async def _run_multigame(run_dir: str, n_bots: int, transport: str,
                         with_restart_phase: bool) -> dict:
    cluster = MultigameCluster(run_dir, n_bots=n_bots, transport=transport)
    # start() INSIDE the try: a boot failure must still tear the cluster
    # down — its game children are real OS processes, and two leaked
    # games silently eating a 1-core host skew every measurement that
    # follows (found the hard way: a failed boot leaked children that
    # depressed the pinned floor a full tier-1 run later).
    try:
        await cluster.start()
        out = await cluster.converge()
        out["skew_initial"] = [n_bots, 0]
        if with_restart_phase:
            out["dispatcher_restart_phase"] = (
                await cluster.migrate_during_dispatcher_restart())
        out["bot_errors"] = len(cluster.bot_errors())
        assert not cluster.bot_errors(), cluster.bot_errors()[:5]
    finally:
        await cluster.stop()
    return out


def run_multigame(run_dir: str, n_bots: int = 12, transport: str = "tcp",
                  with_restart_phase: bool = True) -> dict:
    """Blocking driver (bench.py --multigame / the dispatcher-restart
    chaos scenario): the pinned 2-game floor shape."""
    return asyncio.run(
        _run_multigame(run_dir, n_bots, transport, with_restart_phase))


async def _run_multigame_spaces(run_dir: str, n_bots: int, n_games: int,
                                transport: str) -> dict:
    # Receivers start with ZERO arenas: the only way the planner can
    # balance is moving WHOLE spaces (no same-kind receiver space exists
    # for plain entity moves until a handoff plants one).
    arenas = [n_games] + [0] * (n_games - 1)
    cluster = MultigameCluster(
        run_dir, n_bots=n_bots, transport=transport, n_games=n_games,
        arenas=arenas, planner_service=True, max_space_moves=1)
    try:
        await cluster.start()
        phases: dict = {}
        phases["kill_receiver_mid_prepare"] = (
            await cluster.kill_receiver_mid_prepare())
        out = await cluster.converge()
        out["skew_initial"] = [n_bots] + [0] * (n_games - 1)
        phases["kill_donor_mid_commit"] = (
            await cluster.kill_donor_mid_commit())
        phases["kill_planner_host"] = await cluster.kill_planner_host()
        out["phases"] = phases
        # The planner is live again after the failover phase: require the
        # whole fleet (respawned ex-host included) to settle balanced
        # before the final snapshots — a racing handoff would otherwise
        # photograph a transient skew as the "final" census.
        out["final_rebalance_s"] = round(await cluster.wait_balanced(
            30.0, "fleet never re-balanced after the kill crosses"), 3)
        out["cluster_view_converge_s"] = round(
            await cluster.assert_cluster_view_converged(), 3)
        out["census_final"] = list(cluster.census())
        out["bot_errors"] = len(cluster.bot_errors())
        assert not cluster.bot_errors(), cluster.bot_errors()[:5]
    finally:
        await cluster.stop()
    return out


def run_multigame_spaces(run_dir: str, n_bots: int = 12, n_games: int = 3,
                         transport: str = "tcp") -> dict:
    """Blocking driver of the whole-space chaos run: N games,
    arena-less receivers, sharded planner service, and the three kill
    crosses (receiver mid-PREPARE, donor mid-COMMIT, planner host)."""
    return asyncio.run(
        _run_multigame_spaces(run_dir, n_bots, n_games, transport))
