"""In-process chaos cluster: real sockets, real services, injected faults.

The cluster plumbing mirrors ``bench.py --fanout`` (dispatcher + game +
gate over localhost TCP, protocol bots on the gate) extended to N
dispatchers and fault injectors. Everything runs in ONE asyncio loop and
ONE process — "killing a dispatcher" stops its service after aborting its
sockets (RST, not FIN: peers see a crash, not a shutdown), "pausing" one
stalls its logic/tick loops with sockets open (the half-open-link case the
liveness heartbeats exist for), the storage fault wraps the live backend
in a write-failing decorator, "killing the game" cancels its loop and
wipes the per-process entity world (registry kept — a fresh interpreter
re-importing the same server module), and "killing the gate" aborts every
client socket so a NEW gate process (fresh generation) takes the port.

Invariants every scenario asserts:
- zero bot errors (bots run strict — any protocol inconsistency records);
- zero entity loss (every avatar still live on the game afterward);
- recovery within the scenario deadline, proven by a full RPC round trip
  (each bot Ping→Pong through gate → dispatcher → game and back).
"""

from __future__ import annotations

import asyncio
import os
import time
from typing import Optional

from goworld_tpu_torch import telemetry
from goworld_tpu_torch.client import ClientBot
from goworld_tpu_torch.config.read_config import (
    AOIConfig,
    ClusterConfig,
    DeploymentConfig,
    DispatcherConfig,
    GameConfig,
    GateConfig,
    GoWorldConfig,
    KVDBConfig,
    StorageConfig,
    SyncConfig,
    TelemetryConfig,
)
from goworld_tpu_torch.dispatcher import DispatcherService
from goworld_tpu_torch.entity.entity import Entity
from goworld_tpu_torch.entity.space import Space
from goworld_tpu_torch.entity.vector import Vector3
from goworld_tpu_torch.game import GameService
from goworld_tpu_torch.game.service import RS_RUNNING
from goworld_tpu_torch.gate import GateService
from goworld_tpu_torch.utils import gwlog

AOI_DISTANCE = 100.0

# Per-scenario recovery time, scraped from /metrics and summed into the
# bench --chaos headline (the harness once surfaced only
# the worst recovery). Gauge, not histogram: each scenario runs
# once per suite and the CURRENT value is the interesting one.
_RECOVERY = telemetry.gauge(
    "chaos_recovery_seconds",
    "Recovery (or detection) seconds of the last run of each chaos "
    "scenario.", ("scenario", "transport"))


class _Holder:
    arena = None
    joined = 0


class ChaosSpace(Space):
    def on_space_created(self):
        if self.kind == 1:
            self.enable_aoi(AOI_DISTANCE)
            _Holder.arena = self


class ChaosAvatar(Entity):
    """Boot avatar: joins the shared arena and echoes Ping→Pong.

    ``pings`` is a Column attr (entity/columns.py): every scenario's RPC
    traffic reads/writes a slab column through the attrs surface, so the
    chaos catalog exercises columnar attrs across crashes, restarts and
    reconnect waves for free."""

    @classmethod
    def describe_entity_type(cls, desc):
        desc.set_use_aoi(True, AOI_DISTANCE)
        desc.define_attr("pings", "Column", dtype="int32")

    def on_client_connected(self):
        arena = _Holder.arena
        if arena is not None:
            # Clustered inside one AOI radius: full mutual interest, so
            # position syncs and creates fan out bot-to-bot (real traffic
            # shapes, like the fanout bench).
            x = 3.0 * _Holder.joined
            _Holder.joined += 1
            self.enter_space(arena.id, Vector3(x, 0.0, 10.0))
        self.set_client_syncing(True)

    def Ping_Client(self, n):
        self.attrs["pings"] = self.attrs.get_int("pings") + 1
        self.call_client("Pong", n)

    def on_client_disconnected(self):
        # A detached chaos avatar has no re-attach path (its client either
        # closed or died with a gate): despawn cleanly — AOI leaves fire
        # to the survivors, the slab slot quarantines per contract, and
        # the avatar census stays exact across gate kills.
        if not self.is_destroyed():
            self.destroy()


class FlakyBackend:
    """Storage-backend decorator failing the next ``fail_writes`` writes
    (reads stay healthy — the fault under test is a sick write path)."""

    def __init__(self, inner) -> None:
        self.inner = inner
        self.fail_writes = 0
        self.writes = 0
        self.failed = 0

    def write(self, typename: str, eid: str, data: dict) -> None:
        if self.fail_writes > 0:
            self.fail_writes -= 1
            self.failed += 1
            raise IOError("chaos: injected storage write failure")
        self.inner.write(typename, eid, data)
        self.writes += 1

    def read(self, typename: str, eid: str):
        return self.inner.read(typename, eid)

    def exists(self, typename: str, eid: str) -> bool:
        return self.inner.exists(typename, eid)

    def list_entity_ids(self, typename: str):
        return self.inner.list_entity_ids(typename)


def dropped_packet_count() -> float:
    """Sum of cluster_dropped_packets_total across all reasons."""
    fam = telemetry.family("cluster_dropped_packets_total")
    if fam is None:
        return 0.0
    return sum(child.value for _, child in fam.children())


class ChaosCluster:
    """N dispatchers + 1 game + 1 gate + strict bots, with fault hooks."""

    def __init__(
        self,
        run_dir: str,
        n_dispatchers: int = 2,
        n_bots: int = 12,
        *,
        peer_heartbeat_timeout: float = 1.0,
        down_buffer_bytes: int = 2 * 1024 * 1024,
        reconnect_max_interval: float = 1.0,
        sync_interval: float = 0.05,
        storage_knobs: Optional[dict] = None,
        sync_knobs: Optional[dict] = None,
        transport: str = "tcp",
    ) -> None:
        self.run_dir = run_dir
        self.n_dispatchers = n_dispatchers
        self.n_bots = n_bots
        self.peer_heartbeat_timeout = peer_heartbeat_timeout
        # "uds": the game/gate↔dispatcher links ride Unix-domain sockets
        # (socket files under run_dir) — crash/replay/liveness semantics
        # must be transport-identical, and every scenario asserts exactly
        # that when run on both transports (bench.py --chaos).
        self.transport = transport
        self.uds_dir = run_dir if transport == "uds" else None
        self.cluster_cfg = ClusterConfig(
            down_buffer_bytes=down_buffer_bytes,
            peer_heartbeat_timeout=peer_heartbeat_timeout,
            reconnect_max_interval=reconnect_max_interval,
            transport=transport,
            uds_dir=run_dir if transport == "uds" else "",
        )
        self.sync_interval = sync_interval
        self.storage_knobs = storage_knobs or {}
        # [sync] overrides (tier cadences / quantize bits) — the
        # keyframe-storm scenario needs the delta plane live so enter
        # waves force attributable new_pair keyframes.
        self.sync_knobs = sync_knobs or {}
        self.dispatchers: list[Optional[DispatcherService]] = []
        self.ports: list[int] = []
        self.game: Optional[GameService] = None
        self.gate: Optional[GateService] = None
        self.bots: list[ClientBot] = []
        self._game_task: Optional[asyncio.Task] = None
        self._ping_seq = 0
        self._pongs: dict[str, list] = {}
        self._bot_gen = 0

    # --- lifecycle ----------------------------------------------------------

    async def start(self) -> None:
        from goworld_tpu_torch.entity import entity_manager as em

        em.cleanup_for_tests()
        _Holder.arena = None
        _Holder.joined = 0
        em.register_space(ChaosSpace)
        em.register_entity(ChaosAvatar)
        for i in range(self.n_dispatchers):
            d = DispatcherService(
                i + 1, desired_games=1, desired_gates=1,
                peer_heartbeat_timeout=self.peer_heartbeat_timeout)
            await d.start(uds_dir=self.uds_dir)
            self.dispatchers.append(d)
            self.ports.append(d.port)

        cfg = GoWorldConfig()
        cfg.deployment = DeploymentConfig(
            desired_games=1, desired_gates=1,
            desired_dispatchers=self.n_dispatchers)
        cfg.dispatchers = {
            i + 1: DispatcherConfig(port=p) for i, p in enumerate(self.ports)
        }
        cfg.games = {1: GameConfig(
            boot_entity="ChaosAvatar", save_interval=0.0,
            position_sync_interval=self.sync_interval)}
        cfg.gates = {1: GateConfig(
            port=0, position_sync_interval=self.sync_interval,
            heartbeat_timeout=30.0)}
        cfg.aoi = AOIConfig(backend="xzlist")  # host pipeline only, no card
        cfg.storage = StorageConfig(
            type="filesystem", directory=self.run_dir + "/es",
            **self.storage_knobs)
        cfg.kvdb = KVDBConfig(
            type="filesystem", directory=self.run_dir + "/kv")
        if self.sync_knobs:
            cfg.sync = SyncConfig(**self.sync_knobs)
        cfg.cluster = self.cluster_cfg
        # Black boxes: every chaos service appends telemetry
        # frames to a crash-survivable history ring under run_dir — after
        # a kill the ring is the only record of the victim's final ticks,
        # and emit_postmortem() bundles it.
        self.history_dir = os.path.join(self.run_dir, "history")
        cfg.telemetry = TelemetryConfig(
            history_dir=self.history_dir, history_interval=0.2)
        self.cfg = cfg

        self.game = GameService(1, cfg, restore=False)
        self._game_task = asyncio.get_running_loop().create_task(
            self.game.run_async())
        self.gate = GateService(1, cfg)
        await self.gate.start()
        await self._wait(lambda: self.game.deployment_ready, 15.0,
                         "cluster never became deployment-ready")
        em.create_space_locally(1)
        assert _Holder.arena is not None
        # The gate's bound port survives restarts: a recreated GateService
        # must come back on the SAME address or clients could never
        # reconnect to a crashed gate in production either.
        self.cfg.gates[1].port = self.gate.port
        await self._spawn_bots()

    async def _spawn_bots(self) -> None:
        """Connect a fresh strict-bot fleet (initial boot, and the client
        reconnect wave after a game or gate crash)."""
        from goworld_tpu_torch.entity import entity_manager as em

        self._bot_gen += 1
        gen = self._bot_gen
        for i in range(self.n_bots):
            bot = ClientBot(name=f"chaosbot{gen}.{i}", strict=True,
                            heartbeat_interval=1.0)
            self._pongs[bot.name] = []
            bot.rpc_handlers[(None, "Pong")] = (
                lambda entity, n, name=bot.name: self._pongs[name].append(n))
            await bot.connect("127.0.0.1", self.gate.port)
            await bot.wait_player(timeout=10)
            self.bots.append(bot)
        await self._wait(
            lambda: sum(1 for e in em.entities().values()
                        if e.typename == "ChaosAvatar"
                        and e.client is not None) == self.n_bots,
            15.0, "bots never all attached to avatars")

    async def close_bots(self) -> None:
        for b in self.bots:
            await b.close()
        self.bots.clear()

    async def stop(self) -> None:
        from goworld_tpu_torch import kvdb, storage
        from goworld_tpu_torch.entity import entity_manager as em
        from goworld_tpu_torch.utils import post

        for b in self.bots:
            await b.close()
        if self.gate is not None:
            await self.gate.stop()
        if self.game is not None:
            self.game.terminate()
            try:
                await asyncio.wait_for(self._game_task, timeout=10)
            except Exception:
                pass
        for d in self.dispatchers:
            if d is not None:
                await d.stop()
        storage.set_backend(None)
        kvdb.set_backend(None)
        em.cleanup_for_tests()
        post.clear()

    async def _wait(self, cond, timeout: float, what: str) -> None:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if cond():
                return
            await asyncio.sleep(0.01)
        raise AssertionError(f"chaos: {what} (after {timeout:.1f}s)")

    # --- invariants ---------------------------------------------------------

    def bot_errors(self) -> list[str]:
        return [err for b in self.bots for err in b.errors]

    def live_avatars(self) -> int:
        from goworld_tpu_torch.entity import entity_manager as em

        return sum(1 for e in em.entities().values()
                   if e.typename == "ChaosAvatar")

    def links_up(self) -> bool:
        return all(
            m.proxy is not None
            for svc in (self.game, self.gate)
            for m in svc.cluster._mgrs
        )

    def collector_targets(self):
        """Cluster-collector targets over the LIVE service objects (the
        in-process analog of the production loopback scrape — the health
        provider slot is process-global, so an in-process cluster feeds
        the collector directly; the summary code path is identical).
        Closures read ``self.<service>`` at fetch time, so a killed and
        recreated service is picked up without rebuilding targets."""

        def disp_fetch(i: int):
            async def fetch() -> dict:
                d = self.dispatchers[i]
                if d is None:
                    raise RuntimeError("dispatcher killed")
                return {"health": d._health(), "metrics": {}}

            return fetch

        async def game_fetch() -> dict:
            if self.game is None or self.game.run_state != RS_RUNNING:
                raise RuntimeError("game down")
            return {"health": self.game._health(), "metrics": {}}

        async def gate_fetch() -> dict:
            if self.gate is None:
                raise RuntimeError("gate down")
            return {"health": self.gate._health(), "metrics": {}}

        targets = [(f"dispatcher{i + 1}", disp_fetch(i))
                   for i in range(self.n_dispatchers)]
        targets.append(("game1", game_fetch))
        targets.append(("gate1", gate_fetch))
        return targets

    async def assert_cluster_view_converged(
            self, deadline: float = 20.0) -> float:
        """After a scenario, recovery is judged from the
        AGGREGATED view too — poll a ClusterCollector over the live
        services until every process reports, the client census is
        conserved at the bot count, and no stale generation row (or any
        other alert) remains. Returns seconds until convergence."""
        import json as _json

        from goworld_tpu_torch.telemetry.collector import ClusterCollector

        coll = ClusterCollector(self.collector_targets(), interval=0.05)
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
            await asyncio.sleep(0.05)
        raise AssertionError(
            "chaos: /cluster view never re-converged: "
            f"{_json.dumps(last, default=str)}")

    async def assert_rpc_roundtrip(self, deadline: float = 10.0) -> float:
        """Every bot pings its avatar; returns seconds until every pong
        landed. Packets buffered in replay rings count — the deadline spans
        reconnect + replay, which is exactly the recovery being measured."""
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

    async def emit_postmortem(self, reason: str) -> str:
        """Bundle the cluster's black box — every history ring
        under run_dir (dead incarnations included: their rings outlive
        them), the live span ring and flight dump, plus one final
        aggregated cluster view. Returns the bundle directory path."""
        from goworld_tpu_torch.telemetry import tracing
        from goworld_tpu_torch.telemetry.collector import ClusterCollector
        from goworld_tpu_torch.telemetry.postmortem import collect_bundle

        view = None
        try:
            coll = ClusterCollector(self.collector_targets(), interval=0.05)
            await coll.poll_once()
            view = coll.view()
        except Exception:
            pass  # a half-dead cluster still gets its rings bundled
        # One asyncio loop, one process-global span ring: the scrape is
        # shared, like a whole cluster co-hosted on one box.
        spans = {"chaos": tracing.snapshot()}
        flights = {}
        if self.game is not None and self.game.flight is not None:
            flights["game1"] = self.game.flight.snapshot()
        out = os.path.join(
            self.run_dir, f"postmortem-{reason.replace('/', '_')}")
        collect_bundle(out, reason=reason, history_dir=self.history_dir,
                       cluster_view=view, process_spans=spans,
                       flights=flights)
        gwlog.infof("chaos: post-mortem bundle at %s (reason=%s)",
                    out, reason)
        return out

    # --- fault injectors ----------------------------------------------------

    async def kill_dispatcher(self, i: int) -> None:
        """Crash semantics: RST every peer socket, then stop the service
        (a clean stop would FIN-close, which a crash never does)."""
        d = self.dispatchers[i]
        assert d is not None
        for proxy in list(d._conns):
            proxy.conn.abort()
        await d.stop()
        self.dispatchers[i] = None
        gwlog.infof("chaos: dispatcher %d killed (port %d)",
                    i + 1, self.ports[i])

    async def restart_dispatcher(self, i: int) -> None:
        d = DispatcherService(
            i + 1, desired_games=1, desired_gates=1,
            peer_heartbeat_timeout=self.peer_heartbeat_timeout)
        for _ in range(100):  # the old socket may linger briefly
            try:
                await d.start(port=self.ports[i], uds_dir=self.uds_dir)
                break
            except OSError:
                await asyncio.sleep(0.05)
        else:
            raise AssertionError(
                f"chaos: could not rebind dispatcher port {self.ports[i]}")
        self.dispatchers[i] = d
        gwlog.infof("chaos: dispatcher %d restarted", i + 1)

    def sever_game_link(self, i: int) -> None:
        """Abort the game↔dispatcher-i socket mid-tick (RST, not close)."""
        m = self.game.cluster._mgrs[i]
        assert m.proxy is not None, "link already down"
        m.proxy.conn.abort()

    def pause_dispatcher(self, i: int) -> None:
        self.dispatchers[i].pause()

    def resume_dispatcher(self, i: int) -> None:
        self.dispatchers[i].resume()

    async def kill_game(self) -> None:
        """Crash the game process-equivalent: RST its dispatcher links,
        cancel its loop, and wipe the per-process entity world (the type
        registry survives, exactly like a fresh interpreter re-importing
        the same server module). Peers see a died game, not a shutdown."""
        from goworld_tpu_torch.entity import entity_manager as em

        assert self.game is not None
        for m in self.game.cluster._mgrs:
            if m.proxy is not None:
                m.proxy.conn.abort()
        self._game_task.cancel()
        try:
            await self._game_task
        except (asyncio.CancelledError, Exception):
            pass
        self.game = None
        self._game_task = None
        em.reset_world()
        _Holder.arena = None
        _Holder.joined = 0
        gwlog.infof("chaos: game killed (world wiped, registry kept)")

    async def restart_game(self) -> None:
        """Cold-boot a replacement game with the same gameid (restore=False
        — a crash left no freeze file; entities are gone, not frozen)."""
        from goworld_tpu_torch.entity import entity_manager as em

        self.game = GameService(1, self.cfg, restore=False)
        self._game_task = asyncio.get_running_loop().create_task(
            self.game.run_async())
        await self._wait(lambda: self.game.deployment_ready, 15.0,
                         "recreated game never became ready")
        em.create_space_locally(1)
        assert _Holder.arena is not None
        gwlog.infof("chaos: game recreated")

    async def kill_gate(self) -> None:
        """Crash the gate: RST every client socket and dispatcher link,
        then drop the listeners. Clients see a dead server; the
        dispatcher sees a vanished gate (reconnect-grace window starts)."""
        assert self.gate is not None
        for cp in list(self.gate.clients.values()):
            cp.conn.conn.abort()
        for m in self.gate.cluster._mgrs:
            if m.proxy is not None:
                m.proxy.conn.abort()
        await self.gate.stop()
        self.gate = None
        gwlog.infof("chaos: gate killed")

    async def restart_gate(self) -> None:
        """A NEW gate process on the same port: its fresh handshake makes
        the dispatchers detach the dead predecessor's client bindings on
        every game before traffic flows."""
        gate = GateService(1, self.cfg)
        for _ in range(100):  # the old socket may linger briefly
            try:
                await gate.start()
                break
            except OSError:
                await asyncio.sleep(0.05)
        else:
            raise AssertionError(
                f"chaos: could not rebind gate port "
                f"{self.cfg.gates[1].port}")
        self.gate = gate
        gwlog.infof("chaos: gate restarted on port %d", gate.port)


# --- scenarios ---------------------------------------------------------------


async def scenario_dispatcher_restart(
    cluster: ChaosCluster, downtime: float = 0.3, victim: int = 0,
    recovery_deadline: float = 10.0,
) -> dict:
    """Kill one dispatcher (of >= 2) under live bots, ping THROUGH the
    outage (sends buffer in replay rings), restart it, and require every
    pong + zero drops + zero bot errors + zero entity loss."""
    await cluster.assert_rpc_roundtrip()
    drops0 = dropped_packet_count()
    await cluster.kill_dispatcher(victim)
    # Pings issued while the dispatcher is DOWN: gate/game sends to it park
    # in the replay rings and must be delivered after the reconnect.
    cluster._ping_seq += 1
    mid = cluster._ping_seq
    for b in cluster.bots:
        b.player.call_server("Ping_Client", mid)
    await asyncio.sleep(downtime)
    t0 = time.monotonic()
    await cluster.restart_dispatcher(victim)
    await cluster._wait(cluster.links_up, recovery_deadline,
                        "links never reconnected after dispatcher restart")
    await cluster._wait(
        lambda: all(mid in cluster._pongs[b.name] for b in cluster.bots),
        recovery_deadline, "mid-outage pings were lost")
    rt = await cluster.assert_rpc_roundtrip(recovery_deadline)
    recovery = time.monotonic() - t0
    drops = dropped_packet_count() - drops0
    errors = cluster.bot_errors()
    assert not errors, f"bot errors during dispatcher restart: {errors[:5]}"
    assert drops == 0, f"{drops} packets dropped (ring overflow?)"
    assert cluster.live_avatars() == cluster.n_bots, "entity loss"
    # Column attrs rode the outage: every avatar's ping counter (a slab
    # column behind the attrs surface) recorded the mid-outage ping too.
    from goworld_tpu_torch.entity import entity_manager as em

    for e in em.entities().values():
        if e.typename == "ChaosAvatar":
            assert e.attrs.get_int("pings") >= 2, "column attr lost pings"
    _RECOVERY.labels("dispatcher_restart", cluster.transport).set(recovery)
    return {"scenario": "dispatcher_restart", "recovery_s": round(recovery, 3),
            "post_roundtrip_s": round(rt, 3), "dropped": drops,
            "bot_errors": len(errors)}


async def scenario_severed_link(
    cluster: ChaosCluster, victim: int = 0, recovery_deadline: float = 10.0,
) -> dict:
    """RST the game↔dispatcher link mid-tick; the reconnect loop must
    restore it and buffered sends must replay."""
    await cluster.assert_rpc_roundtrip()
    drops0 = dropped_packet_count()
    t0 = time.monotonic()
    cluster.sever_game_link(victim)
    await cluster._wait(cluster.links_up, recovery_deadline,
                        "severed link never reconnected")
    rt = await cluster.assert_rpc_roundtrip(recovery_deadline)
    recovery = time.monotonic() - t0
    drops = dropped_packet_count() - drops0
    errors = cluster.bot_errors()
    assert not errors, f"bot errors after severed link: {errors[:5]}"
    assert drops == 0, f"{drops} packets dropped after severed link"
    assert cluster.live_avatars() == cluster.n_bots, "entity loss"
    _RECOVERY.labels("severed_link", cluster.transport).set(recovery)
    return {"scenario": "severed_link", "recovery_s": round(recovery, 3),
            "post_roundtrip_s": round(rt, 3), "dropped": drops,
            "bot_errors": len(errors)}


async def scenario_paused_dispatcher(
    cluster: ChaosCluster, victim: int = 0, recovery_deadline: float = 15.0,
) -> dict:
    """Stall a dispatcher past the heartbeat deadline (sockets open, loops
    frozen — the half-open case). Peers' liveness watchdogs must abort the
    silent links (converting the stall into reconnects) instead of waiting
    on the OS; after resume, traffic must flow again."""
    await cluster.assert_rpc_roundtrip()
    hb_kills0 = telemetry.counter(
        "cluster_link_heartbeat_kills_total").value
    cluster.pause_dispatcher(victim)
    # Past the deadline the game/gate watchdogs must have aborted the
    # victim's silent links at least once.
    pause_span = cluster.peer_heartbeat_timeout * 2.0 + 1.0
    t0 = time.monotonic()
    await cluster._wait(
        lambda: telemetry.counter(
            "cluster_link_heartbeat_kills_total").value > hb_kills0,
        pause_span + 5.0, "no liveness kill while dispatcher was stalled")
    detected = time.monotonic() - t0
    cluster.resume_dispatcher(victim)
    await cluster._wait(cluster.links_up, recovery_deadline,
                        "links never recovered after resume")
    rt = await cluster.assert_rpc_roundtrip(recovery_deadline)
    errors = cluster.bot_errors()
    assert not errors, f"bot errors across paused dispatcher: {errors[:5]}"
    assert cluster.live_avatars() == cluster.n_bots, "entity loss"
    _RECOVERY.labels("paused_dispatcher", cluster.transport).set(detected)
    return {"scenario": "paused_dispatcher",
            "detect_s": round(detected, 3),
            "post_roundtrip_s": round(rt, 3), "bot_errors": len(errors)}


async def scenario_storage_outage(
    cluster: ChaosCluster, failures: int = 25, n_saves: int = 10,
    recovery_deadline: float = 10.0,
) -> dict:
    """Fail the next N storage writes: the circuit must OPEN (worker not
    wedged — reads still served), saves defer, and once the backend heals
    every deferred save must land within the deadline."""
    from goworld_tpu_torch import storage
    from goworld_tpu_torch.storage.circuit import CircuitBreaker

    flaky = FlakyBackend(storage.get_backend())
    storage.set_backend(flaky)
    flaky.fail_writes = failures
    t0 = time.monotonic()
    for k in range(n_saves):
        storage.save("ChaosDoc", f"doc{k:03d}", {"k": k})
    await cluster._wait(
        lambda: storage.circuit_state() == CircuitBreaker.OPEN,
        recovery_deadline, "circuit never opened under write failures")
    opened = time.monotonic() - t0
    # Worker must still serve reads while the circuit is open.
    got: list = []
    storage.load("ChaosDoc", "doc000", lambda r, e: got.append((r, e)))
    from goworld_tpu_torch.utils import post as _post

    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline and not got:
        _post.tick()  # completion callbacks ride the post queue
        await asyncio.sleep(0.02)
    assert got and got[0][1] is None, "worker wedged: load never completed"
    # Backend heals; periodic saves (the save_interval crontab in prod)
    # probe the half-open circuit and flush the deferred queue.
    flaky.fail_writes = 0
    t1 = time.monotonic()
    k = n_saves
    while (storage.deferred_count()
           or storage.circuit_state() != CircuitBreaker.CLOSED):
        if time.monotonic() - t1 > recovery_deadline:
            raise AssertionError(
                f"storage never recovered: state={storage.circuit_state()} "
                f"deferred={storage.deferred_count()}")
        storage.save("ChaosDoc", f"doc{k:03d}", {"k": k})
        k += 1
        await asyncio.sleep(0.1)
    storage.wait_clear(10.0)
    recovery = time.monotonic() - t1
    missing = [i for i in range(n_saves)
               if flaky.inner.read("ChaosDoc", f"doc{i:03d}") is None]
    assert not missing, f"saves lost across the outage: {missing}"
    _RECOVERY.labels("storage_outage", cluster.transport).set(recovery)
    return {"scenario": "storage_outage", "open_after_s": round(opened, 3),
            "recovery_s": round(recovery, 3),
            "failed_writes": flaky.failed, "lost_saves": len(missing),
            "bot_errors": len(cluster.bot_errors())}


async def scenario_service_outage_dispatcher_restart(
    cluster: ChaosCluster, failures: int = 25, ops: int = 96,
    recovery_deadline: float = 15.0,
) -> dict:
    """Catalog cross: the service_heavy workload's storage
    outage UNDER a dispatcher restart — both control planes sick at
    once. Shard-routed service receipts + storage saves flow while (a)
    the backend fails writes past the breaker threshold AND (b) a
    dispatcher dies and restarts mid-outage. The circuit must open (not
    wedge), pings issued through the dispatcher outage must all land
    after the reconnect (replay rings), the routing trajectory must stay
    exactly-once per shard, and once the backend heals every deferred
    save must land: zero lost documents, zero bot errors, zero entity
    loss."""
    from goworld_tpu_torch import service, storage
    from goworld_tpu_torch.storage.circuit import CircuitBreaker

    flaky = FlakyBackend(storage.get_backend())
    storage.set_backend(flaky)
    kind_shards = {"chat": 4, "mail": 2, "ranking": 2}
    kinds = tuple(kind_shards)
    receipts: dict[str, list[int]] = {
        k: [0] * s for k, s in kind_shards.items()}
    expected: dict[str, dict] = {}
    seq = 0

    def issue(n: int) -> None:
        nonlocal seq
        for _ in range(n):
            kind = kinds[seq % len(kinds)]
            shard = service.shard_by_key(
                f"user{seq}", kind_shards[kind])
            receipts[kind][shard] += 1
            doc = f"svc-{kind}-{shard}-{seq % 8}"
            payload = {"seq": seq, "kind": kind}
            expected[doc] = payload
            storage.save("ChaosSvcDoc", doc, payload)
            seq += 1

    await cluster.assert_rpc_roundtrip()
    issue(ops // 3)  # healthy baseline traffic
    # The cross: storage outage and dispatcher kill land TOGETHER.
    flaky.fail_writes = failures
    await cluster.kill_dispatcher(0)
    cluster._ping_seq += 1
    mid = cluster._ping_seq
    for b in cluster.bots:
        b.player.call_server("Ping_Client", mid)  # parks in replay rings
    issue(ops // 3)  # service traffic INTO the double fault
    await cluster._wait(
        lambda: storage.circuit_state() == CircuitBreaker.OPEN,
        recovery_deadline,
        "circuit never opened under the dispatcher-restart cross")
    t0 = time.monotonic()
    await cluster.restart_dispatcher(0)
    await cluster._wait(
        cluster.links_up, recovery_deadline,
        "links never reconnected (storage outage + dispatcher restart)")
    await cluster._wait(
        lambda: all(mid in cluster._pongs[b.name] for b in cluster.bots),
        recovery_deadline, "mid-cross pings were lost")
    # Backend heals AFTER the cluster plane: saves keep probing the
    # half-open circuit until it closes and the deferred queue drains.
    flaky.fail_writes = 0
    issue(ops - 2 * (ops // 3))
    t1 = time.monotonic()
    while (storage.deferred_count()
           or storage.circuit_state() != CircuitBreaker.CLOSED):
        if time.monotonic() - t1 > recovery_deadline:
            raise AssertionError(
                f"storage never recovered under the cross: "
                f"state={storage.circuit_state()} "
                f"deferred={storage.deferred_count()}")
        issue(1)
        await asyncio.sleep(0.1)
    storage.wait_clear(10.0)
    recovery = time.monotonic() - t0
    # Exactly-once receipts: the shard routing trajectory is
    # deterministic in seq, so a replayed/duplicated op would break the
    # recomputed totals.
    want: dict[str, list[int]] = {
        k: [0] * s for k, s in kind_shards.items()}
    for i in range(seq):
        kind = kinds[i % len(kinds)]
        want[kind][service.shard_by_key(f"user{i}", kind_shards[kind])] += 1
    assert receipts == want, (
        f"shard receipts not exactly-once: {receipts} != {want}")
    missing = [d for d, payload in expected.items()
               if flaky.inner.read("ChaosSvcDoc", d) != payload]
    assert not missing, (
        f"saves lost/stale across the cross: {missing[:5]}")
    rt = await cluster.assert_rpc_roundtrip(recovery_deadline)
    errors = cluster.bot_errors()
    assert not errors, f"bot errors across the cross: {errors[:5]}"
    assert cluster.live_avatars() == cluster.n_bots, "entity loss"
    _RECOVERY.labels(
        "service_outage_dispatcher_restart", cluster.transport).set(recovery)
    return {"scenario": "service_outage_dispatcher_restart",
            "recovery_s": round(recovery, 3),
            "post_roundtrip_s": round(rt, 3),
            "ops": seq, "failed_writes": flaky.failed,
            "lost_saves": len(missing), "bot_errors": len(errors)}


async def scenario_game_kill_recreate(
    cluster: ChaosCluster, downtime: float = 0.3,
    recovery_deadline: float = 20.0,
) -> dict:
    """Crash THE GAME under live bots, recreate it cold, and require a
    consistent world afterwards: the dispatcher purges the dead
    incarnation's entity routes at the cold-boot handshake (no RPC ever
    routes at a ghost), clients reconnect and get fresh avatars, the
    avatar census returns to exactly n_bots with full AOI interest, and
    no bot sees a protocol inconsistency (strict mode)."""
    await cluster.assert_rpc_roundtrip()
    await cluster.kill_game()
    await asyncio.sleep(downtime)
    t0 = time.monotonic()
    await cluster.restart_game()
    # The dead incarnation's clients can't be re-attached (no boot flow
    # re-runs for an existing connection) — clients reconnect, exactly as
    # they would after a real server crash.
    await cluster.close_bots()
    await cluster._spawn_bots()
    await cluster._wait(cluster.links_up, recovery_deadline,
                        "links never recovered after game recreate")
    rt = await cluster.assert_rpc_roundtrip(recovery_deadline)
    recovery = time.monotonic() - t0
    errors = cluster.bot_errors()
    assert not errors, f"bot errors across game kill: {errors[:5]}"
    assert cluster.live_avatars() == cluster.n_bots, (
        f"avatar census wrong after recreate: {cluster.live_avatars()} "
        f"!= {cluster.n_bots}")
    # AOI consistency: the recreated arena re-derived full mutual
    # interest (every avatar sees every other).
    from goworld_tpu_torch.entity import entity_manager as em

    avs = [e for e in em.entities().values()
           if e.typename == "ChaosAvatar"]
    assert all(len(a.interested_by) == cluster.n_bots - 1 for a in avs), (
        "AOI interest not re-derived after game recreate")
    _RECOVERY.labels("game_kill_recreate", cluster.transport).set(recovery)
    return {"scenario": "game_kill_recreate",
            "recovery_s": round(recovery, 3),
            "post_roundtrip_s": round(rt, 3), "bot_errors": len(errors)}


async def scenario_gate_kill_reconnect(
    cluster: ChaosCluster, downtime: float = 0.3,
    recovery_deadline: float = 20.0,
) -> dict:
    """Crash THE GATE under strict bots: every client socket dies. A NEW
    gate process takes the port; its fresh handshake makes the
    dispatchers detach the dead incarnation's client bindings on the game
    (orphaned avatars despawn cleanly, with AOI leaves), clients
    reconnect and get fresh avatars, and no record ever misroutes across
    clients (strict bots would flag a sync/RPC for an entity they never
    saw)."""
    await cluster.assert_rpc_roundtrip()
    await cluster.kill_gate()
    # Client sockets are dead: drop the bot objects (their recv loops
    # already exited) before anything reconnects.
    await cluster.close_bots()
    await asyncio.sleep(downtime)
    t0 = time.monotonic()
    await cluster.restart_gate()
    await cluster._spawn_bots()
    await cluster._wait(cluster.links_up, recovery_deadline,
                        "links never recovered after gate restart")
    rt = await cluster.assert_rpc_roundtrip(recovery_deadline)
    # The dead incarnation's avatars must despawn (detach → destroy), the
    # new fleet's census must be exact.
    await cluster._wait(
        lambda: cluster.live_avatars() == cluster.n_bots,
        recovery_deadline,
        f"orphaned avatars never despawned "
        f"(census {cluster.live_avatars()} != {cluster.n_bots})")
    recovery = time.monotonic() - t0
    errors = cluster.bot_errors()
    assert not errors, f"bot errors across gate kill: {errors[:5]}"
    _RECOVERY.labels("gate_kill_reconnect", cluster.transport).set(recovery)
    return {"scenario": "gate_kill_reconnect",
            "recovery_s": round(recovery, 3),
            "post_roundtrip_s": round(rt, 3), "bot_errors": len(errors)}


async def _royale_collapse(cluster: ChaosCluster, t_from: int, t_to: int,
                           ticks: int, r0: float = 400.0,
                           rf: float = 10.0) -> None:
    """Drive every live ChaosAvatar along the battle-royale shrinking
    ring (scenarios/battle_royale.py zone math — the SAME scenario
    definition the bench engines run, here moving real entities through
    real AOI).  Avatars are indexed by sorted eid so a respawned fleet
    resumes the collapse deterministically."""
    from goworld_tpu_torch.entity import entity_manager as em
    from goworld_tpu_torch.scenarios.battle_royale import royale_ring_positions

    for t in range(t_from, t_to):
        avs = sorted(
            (e for e in em.entities().values()
             if e.typename == "ChaosAvatar"), key=lambda e: e.id)
        ring = royale_ring_positions(
            len(avs), t, ticks, (0.0, 0.0), r0, rf)
        for a, (x, z) in zip(avs, ring):
            a.set_position(Vector3(x, 0.0, z))
        # One sync interval per zone tick: AOI diffs + position syncs
        # flow to the strict bots between moves.
        await asyncio.sleep(cluster.sync_interval)


def _royale_edges(cluster: ChaosCluster) -> int:
    """Directed interest-edge count across the live avatar fleet."""
    from goworld_tpu_torch.entity import entity_manager as em

    return sum(len(e.interested_by) for e in em.entities().values()
               if e.typename == "ChaosAvatar")


def _edge_table_eids() -> list:
    """The slabs' device edge columns (the subj/wat slot pairs a batched
    AOI dispatch ships for the tier/verdict passes) canonicalized to eid
    space and sorted: slots are reassigned on restore, eids are the
    identity, so equality of two snapshots is bit-identity of the edge
    TABLE contents independent of slot numbering and row order."""
    from goworld_tpu_torch.entity import entity_manager as em

    by_slot = {e._slot: e.id for e in em.entities().values()
               if e._slot >= 0}
    _ver, n, subj, wat = em.runtime.slabs.snapshot_edges_for_tiering()
    return sorted((by_slot[int(s)], by_slot[int(w)])
                  for s, w in zip(subj[:n], wat[:n]))


async def scenario_battle_royale_kill_game(
    cluster: ChaosCluster, ticks: int = 16, recovery_deadline: float = 20.0,
) -> dict:
    """The battle-royale workload on LIVE avatars crossed with a game
    crash: the boot cluster (full mutual interest) scatters onto the wide
    zone ring — a mass LEAVE wave, every edge dissolved — then the zone
    collapse begins; mid-collapse the game is killed and recreated cold,
    the clients reconnect onto fresh avatars, and the collapse resumes to
    the endgame disc — the mass ENTER wave back to full mutual interest.
    Census conserved at exactly n_bots, zero strict-bot errors, and the
    aggregated /cluster view re-converges with zero alerts."""
    n = cluster.n_bots
    await cluster.assert_rpc_roundtrip()
    assert _royale_edges(cluster) == n * (n - 1), (
        "boot fleet not fully mutually interested")
    # Scatter: ring spacing at the full zone exceeds AOI_DISTANCE.
    await _royale_collapse(cluster, 0, 2, ticks)
    scattered = _royale_edges(cluster)
    assert scattered == 0, (
        f"mass leave wave incomplete: {scattered} interest edges survive "
        f"the scatter onto the wide ring")
    await _royale_collapse(cluster, 2, ticks // 2, ticks)
    # Survivor-side census at the kill point: the aggregated view the
    # rest of the cluster agrees on, held against the victim's black box
    # after the crash.
    from goworld_tpu_torch.telemetry.collector import ClusterCollector

    coll = ClusterCollector(cluster.collector_targets(), interval=0.05)
    await coll.poll_once()
    pre_census = int(
        coll.view()["processes"]["game1"]["health"]["entities"])
    await cluster.kill_game()
    # The dead game can no longer serve /flight — its history ring is the
    # only record of its final ticks. Bundle it and hold the black box to
    # the survivor-side census: the newest flight rows must carry exactly
    # the entity count the aggregated view reported before the crash.
    bundle_dir = await cluster.emit_postmortem("battle_royale_kill_game")
    from goworld_tpu_torch.telemetry.postmortem import load_bundle

    box = load_bundle(bundle_dir)["processes"].get("game1")
    assert box is not None and box["frames"], (
        "killed game left no history frames in the bundle")
    assert box["frames"][-1].get("final"), (
        "game ring missing its final (shutdown-path) frame")
    flight_rows = [t for f in box["frames"]
                   for t in (f.get("flight") or [])]
    assert len(flight_rows) >= 3, (
        f"bundle holds only {len(flight_rows)} of the victim's ticks")
    tail = flight_rows[-3:]
    assert all(int(t["entities"]) == pre_census for t in tail), (
        f"black-box census {[t['entities'] for t in tail]} != "
        f"survivor-side /cluster census {pre_census}")
    t0 = time.monotonic()
    await cluster.restart_game()
    # The dead incarnation's clients reconnect, exactly like a real crash.
    await cluster.close_bots()
    await cluster._spawn_bots()
    await cluster._wait(cluster.links_up, recovery_deadline,
                        "links never recovered after game kill mid-royale")
    # Resume the collapse on the fresh fleet, down to the endgame disc.
    await _royale_collapse(cluster, ticks // 2, ticks, ticks)
    rt = await cluster.assert_rpc_roundtrip(recovery_deadline)
    recovery = time.monotonic() - t0
    errors = cluster.bot_errors()
    assert not errors, f"bot errors across royale game kill: {errors[:5]}"
    assert cluster.live_avatars() == n, (
        f"royale census broken: {cluster.live_avatars()} != {n}")
    endgame = _royale_edges(cluster)
    assert endgame == n * (n - 1), (
        f"mass enter wave incomplete: {endgame} edges at the endgame disc, "
        f"expected full mutual interest {n * (n - 1)}")
    converge = await cluster.assert_cluster_view_converged()
    _RECOVERY.labels("battle_royale_kill_game", cluster.transport).set(
        recovery)
    return {"scenario": "battle_royale_kill_game",
            "recovery_s": round(recovery, 3),
            "post_roundtrip_s": round(rt, 3),
            "cluster_view_converge_s": round(converge, 3),
            "endgame_edges": endgame, "bot_errors": len(errors),
            "bundle": bundle_dir,
            "black_box_ticks": len(flight_rows)}


async def scenario_battle_royale_freeze_restore(
    cluster: ChaosCluster, ticks: int = 16, recovery_deadline: float = 20.0,
) -> dict:
    """The battle-royale collapse crossed with a freeze→restore reload
    (the SIGHUP hot-reload path): mid-collapse the game freezes to
    ``game<N>_freezed.dat`` and exits rc 2, the world is wiped (process
    death analog, registry kept), and a ``restore=True`` GameService
    resurrects every avatar — same eids, same positions, same column
    attrs, client bindings reattached quietly while the bots stay
    connected to the gate.  The collapse then resumes on the RESTORED
    fleet to full endgame interest; census conserved, zero strict-bot
    errors, /cluster re-converges alert-free."""
    import os

    from goworld_tpu_torch.entity import entity_manager as em

    n = cluster.n_bots
    await cluster.assert_rpc_roundtrip()
    await _royale_collapse(cluster, 0, ticks // 2, ticks)
    frozen = {
        e.id: (e.position.x, e.position.z, e.attrs.get_int("pings"))
        for e in em.entities().values() if e.typename == "ChaosAvatar"}
    assert len(frozen) == n
    # Pre-freeze device edge columns in eid space: restore
    # rebuilds interest from scratch (freeze data carries no edges), and
    # identical positions must reconverge to a bit-identical edge table.
    pre_edges = _edge_table_eids()
    # The freeze file lands in cwd (game/service.py freeze_filename) —
    # point cwd at the run dir for the freeze->restore window.
    prev_cwd = os.getcwd()
    os.chdir(cluster.run_dir)
    try:
        cluster.game.start_freeze()
        rc = await asyncio.wait_for(cluster._game_task, timeout=15)
        assert rc == 2, f"freeze exit code {rc} != 2"
        t0 = time.monotonic()
        # Process-death analog: wipe the world, keep the type registry.
        em.reset_world()
        _Holder.arena = None
        _Holder.joined = 0
        cluster.game = GameService(1, cluster.cfg, restore=True)
        cluster._game_task = asyncio.get_running_loop().create_task(
            cluster.game.run_async())
        await cluster._wait(lambda: cluster.game.deployment_ready, 15.0,
                            "restored game never became ready")
    finally:
        os.chdir(prev_cwd)
    # Restore re-creates spaces without on_space_created: re-point the
    # holder at the resurrected arena (and keep spawn offsets moving).
    for e in em.entities().values():
        if isinstance(e, ChaosSpace) and e.kind == 1:
            _Holder.arena = e
    assert _Holder.arena is not None, "arena space did not survive restore"
    _Holder.joined = n
    await cluster._wait(cluster.links_up, recovery_deadline,
                        "links never recovered after freeze restore")
    # Same avatars, not replacements: eids, positions and the pings
    # column attr all survived the reload.
    restored = {
        e.id: (e.position.x, e.position.z, e.attrs.get_int("pings"))
        for e in em.entities().values() if e.typename == "ChaosAvatar"}
    assert restored.keys() == frozen.keys(), (
        "avatar identity not conserved across freeze restore")
    for eid, (x, z, pings) in frozen.items():
        rx, rz, rpings = restored[eid]
        assert abs(rx - x) < 1e-6 and abs(rz - z) < 1e-6, (
            f"{eid}: position drifted across restore")
        assert rpings == pings, f"{eid}: pings column lost across restore"
    # Interest rebuilt from scratch must land on the SAME edge table the
    # frozen world had: positions are bit-identical, so the rebuilt
    # device edge columns must be too (eid space — slots renumber).
    await cluster._wait(
        lambda: _edge_table_eids() == pre_edges, recovery_deadline,
        "post-restore edge table never reconverged bit-identical to the "
        "pre-freeze device edge columns")
    # Resume the collapse on the restored fleet.
    await _royale_collapse(cluster, ticks // 2, ticks, ticks)
    rt = await cluster.assert_rpc_roundtrip(recovery_deadline)
    recovery = time.monotonic() - t0
    errors = cluster.bot_errors()
    assert not errors, f"bot errors across freeze restore: {errors[:5]}"
    assert cluster.live_avatars() == n, (
        f"royale census broken: {cluster.live_avatars()} != {n}")
    endgame = _royale_edges(cluster)
    assert endgame == n * (n - 1), (
        f"endgame interest incomplete after restore: {endgame} != "
        f"{n * (n - 1)}")
    converge = await cluster.assert_cluster_view_converged()
    _RECOVERY.labels("battle_royale_freeze_restore", cluster.transport).set(
        recovery)
    return {"scenario": "battle_royale_freeze_restore",
            "recovery_s": round(recovery, 3),
            "post_roundtrip_s": round(rt, 3),
            "cluster_view_converge_s": round(converge, 3),
            "restored_edge_table_rows": len(pre_edges),
            "endgame_edges": endgame, "bot_errors": len(errors)}


def _kf_forced(reason: str) -> float:
    """Current sync_keyframes_forced_total{reason=...} value."""
    fam = telemetry.family("sync_keyframes_forced_total")
    if fam is None:
        return 0.0
    return sum(child.value for labels, child in fam.children()
               if reason in labels)


async def scenario_battle_royale_keyframe_storm(
    cluster: ChaosCluster, ticks: int = 16, waves: int = 2,
    recovery_deadline: float = 30.0,
) -> dict:
    # recovery_deadline spans a possible heartbeat-dropped link reconnect
    # (5s buffering window) on a loaded CI host, not just the sync lag.
    """Keyframe-storm assertion: battle-royale ENTER waves on a
    cluster running the delta sync plane ([sync] quantize_bits > 0 — the
    cluster must be built with sync_knobs). Each wave scatters the fleet
    (every interest edge dissolves) then collapses it back to the endgame
    disc (a mass enter wave re-forming full mutual interest); every
    re-formed (subject, watcher) pair's FIRST record must be a forced
    full-precision keyframe, so sync_keyframes_forced_total{reason=
    new_pair} must grow in lockstep with the wave's edge census — at
    least one keyframe per re-formed pair, every wave. The strict bots
    independently prove the same contract from the wire: a delta record
    before a keyframe is a protocol error."""
    n = cluster.n_bots
    await cluster.assert_rpc_roundtrip()
    per_wave: list[int] = []
    for _ in range(waves):
        # Scatter: ring spacing at the full zone exceeds AOI_DISTANCE, so
        # the NEXT collapse is a pure enter wave over invalid baselines.
        await _royale_collapse(cluster, 0, 2, ticks)
        await cluster._wait(
            lambda: _royale_edges(cluster) == 0, recovery_deadline,
            "scatter never dissolved the fleet's interest edges")
        kf0 = _kf_forced("new_pair")
        await _royale_collapse(cluster, 2, ticks, ticks)
        await cluster._wait(
            lambda: _royale_edges(cluster) == n * (n - 1),
            recovery_deadline, "enter wave never re-formed full interest")
        # Lockstep: one forced keyframe per re-formed directed pair (the
        # emission may trail the edge census by a sync interval or two).
        await cluster._wait(
            lambda: _kf_forced("new_pair") - kf0 >= n * (n - 1),
            recovery_deadline,
            "enter wave did not force a keyframe per new pair")
        per_wave.append(int(_kf_forced("new_pair") - kf0))
    rt = await cluster.assert_rpc_roundtrip(recovery_deadline)
    errors = cluster.bot_errors()
    assert not errors, (
        f"strict bots saw sync errors in the keyframe storm: {errors[:5]}")
    assert cluster.live_avatars() == n, "entity loss across the storm"
    return {"scenario": "battle_royale_keyframe_storm",
            "waves": waves, "edges_per_wave": n * (n - 1),
            "keyframes_per_wave": per_wave,
            "post_roundtrip_s": round(rt, 3), "bot_errors": len(errors)}


def run_chaos(run_dir: str, n_dispatchers: int = 2, n_bots: int = 12,
              transport: str = "tcp", slo=None) -> dict:
    """Run the single-cluster scenario suite (``bench.py --chaos``;
    ``transport`` = "tcp" or "uds" — the fault semantics must be
    transport-identical and every scenario asserts its own invariants
    either way). Returns a JSON-able summary with per-scenario recovery
    times and bot-error counts; a scenario failure is CAPTURED (named in
    ``failures``) and aborts the remaining scenarios on this cluster —
    the caller decides the exit code, so one red scenario can never hide
    the others' numbers. A failed scenario also leaves a post-mortem
    bundle (named in its failure entry) holding every history ring.

    ``slo`` is an optional :class:`SLOConfig`: with a
    ``bot_error_rate`` budget set, the suite's aggregate bot-error rate
    (errors per bot per scenario) is judged at the end and a violation
    lands in ``failures`` like any red scenario."""

    async def _run() -> dict:
        cluster = ChaosCluster(
            run_dir, n_dispatchers=n_dispatchers, n_bots=n_bots,
            transport=transport,
            storage_knobs=dict(
                retry_base_interval=0.05, retry_max_interval=0.2,
                circuit_failure_threshold=3, circuit_cooldown=0.3,
            ))
        await cluster.start()
        results: list[dict] = []
        failures: list[dict] = []
        scenario_fns = (
            scenario_dispatcher_restart,
            scenario_severed_link,
            scenario_paused_dispatcher,
            scenario_storage_outage,
            # Catalog cross: the service-heavy storage outage
            # UNDER a dispatcher restart (both planes sick at once).
            scenario_service_outage_dispatcher_restart,
            scenario_game_kill_recreate,
            scenario_gate_kill_reconnect,
            # Scenario-matrix workloads crossed with faults:
            # the battle-royale collapse on live avatars under a game
            # kill and under a freeze->restore reload.
            scenario_battle_royale_kill_game,
            scenario_battle_royale_freeze_restore,
        )
        try:
            for fn in scenario_fns:
                name = fn.__name__.removeprefix("scenario_")
                try:
                    r = await fn(cluster)
                    # Recovery is also judged from the
                    # AGGREGATED cluster view — every process reporting,
                    # census conserved, no stale generation rows.
                    r["cluster_view_converge_s"] = round(
                        await cluster.assert_cluster_view_converged(), 3)
                    results.append(r)
                except Exception as exc:  # captured, not swallowed
                    gwlog.trace_error("chaos: scenario %s failed", name)
                    failure = {
                        "scenario": name,
                        "error": f"{type(exc).__name__}: {exc}",
                        "bot_errors": len(cluster.bot_errors()),
                    }
                    # The black box outlives the failure: bundle every
                    # history ring before tearing the cluster down.
                    try:
                        failure["bundle"] = await cluster.emit_postmortem(
                            f"{name}-failed")
                    except Exception:
                        gwlog.trace_error(
                            "chaos: post-mortem bundle failed for %s", name)
                    failures.append(failure)
                    break  # cluster state is suspect; stop this transport
        finally:
            await cluster.stop()
        bot_errors = sum(r.get("bot_errors", 0) for r in results)
        summary = {
            "scenarios": results,
            "failures": failures,
            "passed": len(results),
            "bot_errors": bot_errors,
            "dispatchers": n_dispatchers,
            "bots": n_bots,
            "transport": transport,
        }
        if slo is not None and slo.enabled():
            from goworld_tpu_torch.telemetry.slo import judge_values, render_verdict

            rate = (bot_errors / (n_bots * len(results))
                    if results else 0.0)
            verdict = judge_values(slo, bot_error_rate=rate)
            summary["slo"] = verdict
            if not verdict["ok"]:
                failures.append({
                    "scenario": "slo_gate",
                    "error": f"SLOViolation: {render_verdict(verdict)}",
                    "bot_errors": bot_errors,
                })
        return summary

    return asyncio.run(_run())
