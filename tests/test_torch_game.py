"""The port's game stack against the JAX package's, packet for packet.

The flows of ``tests/test_game_service.py`` (boot entity and a client RPC,
disconnect, terminate saves, freeze -> restore, the freeze fence) and an
AOI flow on the batched service (``[aoi] backend = tpu``, ``platform =
cpu``) run over localhost sockets: a dispatcher, one ``GameService`` and a
fake gate (``tests.test_dispatcher.FakePeer`` behind a cluster client).
Each flow runs once on the JAX stack and once on the port's; every packet
the fake gate receives must be equal in both runs. Entity ids are made
deterministic in both packages (the id generator's clock, machine, pid and
counter are pinned), so ids match by creation order. Packets are compared
in order within each phase of a flow. The AOI flow runs the game on a
fixed clock, so its loop neither ticks the AOI service nor pushes position
syncs by itself: the flow drives each server tick (the AOI service's
tick, then the position-sync push, then a marker RPC to the client that
closes the tick's phase, since one dispatcher keeps the game's packets to
the gate in order) and compares each tick's packets, position syncs
included, as multisets (both engines deliver one tick's events in their
own drain order). The other flows leave position syncs out: they ride the
sync cadence's timing.

Also: a port game given ``[aoi] platform = auto`` on a machine without a
CUDA card exits non-zero with the runtime's error.
"""

from __future__ import annotations

import asyncio
import importlib
import os
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

from tests.test_dispatcher import FakePeer

ROOT = Path(__file__).resolve().parent.parent
CLOCK = 1_700_000_000.0


def package(root: str) -> types.SimpleNamespace:
    def m(name):
        return importlib.import_module(f"{root}.{name}")

    return types.SimpleNamespace(
        root=root, rc=m("config.read_config"), em=m("entity.entity_manager"),
        Entity=m("entity.entity").Entity, Space=m("entity.space").Space,
        Vector3=m("entity.vector").Vector3,
        Dispatcher=m("dispatcher").DispatcherService,
        ClusterClient=m("dispatchercluster.cluster").ClusterClient,
        GameService=m("game").GameService, game=m("game.service"),
        GameClient=m("entity.game_client").GameClient,
        MsgType=m("proto.msgtypes").MsgType,
        post=m("utils.post"), kvreg=m("kvreg"), storage=m("storage"),
        kvdb=m("kvdb"), consts=m("consts"), ids=m("common.entity_id"))


JAX, PORT = package("goworld_tpu"), package("goworld_tpu_torch")


def clean(P) -> None:
    P.em.cleanup_for_tests()
    P.kvreg.clear_for_tests()
    P.storage.set_backend(None)
    P.kvdb.set_backend(None)
    P.post.clear()


@pytest.fixture
def both(tmp_path, monkeypatch):
    """Both packages' module globals clean before and after; entity ids
    pinned to a deterministic sequence in both. Torch runs one intra-op
    thread meanwhile, as a game process on the CPU should (README: with
    every core's thread on each small op, a loaded host stretched the
    port's CPU AOI dispatch to seconds and the game lost its links)."""
    monkeypatch.chdir(tmp_path)
    for P in (JAX, PORT):
        clean(P)
        monkeypatch.setattr(P.ids, "time",
                            types.SimpleNamespace(time=lambda: CLOCK))
        monkeypatch.setattr(P.ids, "_machine", b"\x01\x02\x03")
        monkeypatch.setattr(P.ids, "_pid", 77)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    for P in (JAX, PORT):
        clean(P)


def reset_ids(P) -> None:
    P.ids._counter = 1000


def classes(P):
    """The flows' entity classes on one package's Entity and Space."""

    class BootAccount(P.Entity):
        logins: list = []

        @classmethod
        def describe_entity_type(cls, desc):
            desc.define_attr("name", "Client")

        def on_client_connected(self):
            self.attrs.set("name", "fresh")

        def Login_Client(self, username):
            BootAccount.logins.append((self.id, username))
            self.attrs.set("name", username)

    class TSpace(P.Space):
        @classmethod
        def describe_entity_type(cls, desc):
            desc.define_attr("_EnableAOI", "Persistent")

    class Persist(P.Entity):
        @classmethod
        def describe_entity_type(cls, desc):
            desc.define_attr("gold", "Persistent")

    class Frozen(P.Entity):
        @classmethod
        def describe_entity_type(cls, desc):
            desc.define_attr("hp", "Client")

    class Mob(P.Entity):
        @classmethod
        def describe_entity_type(cls, desc):
            desc.set_use_aoi(True, 100.0)
            desc.define_attr("hp", "AllClients")

    class Hero(P.Entity):
        space = None

        @classmethod
        def describe_entity_type(cls, desc):
            desc.set_use_aoi(True, 100.0)
            desc.define_attr("name", "AllClients")

        def on_client_connected(self):
            Hero.space._enter(self, P.Vector3(0.0, 0.0, 0.0))

    return types.SimpleNamespace(
        BootAccount=BootAccount, TSpace=TSpace, Persist=Persist,
        Frozen=Frozen, Mob=Mob, Hero=Hero)


def make_cfg(P, disp_port, tmp_path, boot, aoi):
    rc = P.rc
    cfg = rc.GoWorldConfig()
    cfg.deployment = rc.DeploymentConfig(
        desired_games=1, desired_gates=1, desired_dispatchers=1)
    cfg.dispatchers = {1: rc.DispatcherConfig(port=disp_port)}
    cfg.games = {1: rc.GameConfig(boot_entity=boot, save_interval=0.0,
                                  position_sync_interval=0.02)}
    tag = P.root
    cfg.storage = rc.StorageConfig(type="filesystem",
                                   directory=str(tmp_path / tag / "es"))
    cfg.kvdb = rc.KVDBConfig(type="filesystem",
                             directory=str(tmp_path / tag / "kv"))
    if aoi:
        # The batched service on the CPU; the JAX package's persistent XLA
        # cache stays off so that this process's jax config is untouched.
        cfg.aoi = rc.AOIConfig(backend="tpu", platform="cpu",
                               max_entities=64, compilation_cache="off")
    return cfg


class Stack:
    """Dispatcher + GameService + fake gate of one package."""

    def __init__(self, P, tmp_path, boot="BootAccount", aoi=False):
        self.P, self.tmp_path, self.boot, self.aoi = P, tmp_path, boot, aoi
        self.cls = classes(P)
        self.phases: list[list] = []
        self._mark = 0

    def register(self):
        em = self.P.em
        em.register_space(self.cls.TSpace)
        for c in (self.cls.BootAccount, self.cls.Persist, self.cls.Frozen,
                  self.cls.Mob, self.cls.Hero):
            em.register_entity(c)

    async def start(self):
        P = self.P
        self.disp = P.Dispatcher(1, desired_games=1, desired_gates=1)
        await self.disp.start()
        self.cfg = make_cfg(P, self.disp.port, self.tmp_path, self.boot,
                            self.aoi)
        self.register()
        await self.boot_game(restore=False)
        self.peer = FakePeer()

        def handshake(index, proxy):
            proxy.send_set_gate_id(1)

        self.cg = P.ClusterClient([("127.0.0.1", self.disp.port)], handshake,
                                  self.peer.on_packet)
        self.cg.start()
        await self.cg.wait_connected()
        await self.ready()

    async def boot_game(self, restore):
        self.svc = self.P.GameService(1, self.cfg, restore=restore)
        self.task = asyncio.get_running_loop().create_task(
            self.svc.run_async())

    async def ready(self):
        for _ in range(1000):
            if self.svc.deployment_ready:
                break
            await asyncio.sleep(0.01)
        assert self.svc.deployment_ready

    def gate(self):
        return self.cg.select(0)

    def _pending(self) -> list:
        skip = {int(self.P.MsgType.HEARTBEAT)}
        if not self.aoi:  # the AOI flow drives the syncs itself
            skip |= {int(self.P.MsgType.SYNC_POSITION_YAW_ON_CLIENTS),
                     int(self.P.MsgType.SYNC_POSITION_YAW_DELTA_ON_CLIENTS)}
        got = [(int(mt), bytes(pkt.payload))
               for mt, pkt in self.peer.received[self._mark:]]
        return [g for g in got if g[0] not in skip]

    async def settle(self, seconds=0.3, expect=0):
        """Let the game run until the phase holds at least ``expect``
        packets (15 s at most), then ``seconds`` more, and close it."""
        for _ in range(1500):
            if len(self._pending()) >= expect:
                break
            await asyncio.sleep(0.01)
        await asyncio.sleep(seconds)
        self.phases.append(self._pending())
        self._mark = len(self.peer.received)

    async def server_tick(self, k: int):
        """One server tick, driven (the game's loop does none on the fixed
        clock): the AOI service's tick, the position-sync push, then a
        marker RPC to the client; the phase closes at the marker."""
        self.P.em.runtime.aoi_service.tick(wait=True)
        self.svc._send_entity_sync_infos()
        self.P.GameClient(CID, 1, BOOT).call(BOOT, "ServerTick", (k,))
        call = int(self.P.MsgType.CALL_ENTITY_METHOD_ON_CLIENT)
        for _ in range(1500):
            got = [(int(mt), bytes(pkt.payload))
                   for mt, pkt in self.peer.received[self._mark:]]
            end = [i for i, (mt, pl) in enumerate(got)
                   if mt == call and b"ServerTick" in pl]
            if end:
                break
            await asyncio.sleep(0.01)
        assert end, f"tick {k}: the marker never reached the gate"
        self._mark += end[0] + 1
        self.phases.append([g for g in got[:end[0] + 1]
                            if g[0] != int(self.P.MsgType.HEARTBEAT)])

    async def stop(self):
        self.svc.terminate()
        rc = await asyncio.wait_for(self.task, timeout=20)
        await self.cg.stop()
        await self.disp.stop()
        return rc


# The AOI flow's game clock: at this value the sync deadline, 0.02 s an
# interval, catches up to the clock exactly in two loop iterations.
FIXED_CLOCK = 1_000_000.0

CID = "cidAAAAAAAAAAAAA"
BOOT = "bootAAAAAAAAAAAA"


async def flow_boot_rpc(st: Stack):
    st.gate().send_notify_client_connected(CID, 1, BOOT)
    await st.peer.expect(st.P.MsgType.CREATE_ENTITY_ON_CLIENT)
    st._mark = 0
    await st.settle()
    st.gate().send_call_entity_method_from_client(
        BOOT, "Login_Client", ("alice",), CID)
    await st.settle()
    assert st.cls.BootAccount.logins == [(BOOT, "alice")]
    await st.stop()


async def flow_disconnect(st: Stack):
    st.gate().send_notify_client_connected(CID, 1, BOOT)
    await st.settle()
    st.gate().send_notify_client_disconnected(CID, BOOT)
    await st.settle()
    assert st.P.em.get_entity(BOOT).client is None
    await st.stop()


async def flow_terminate_saves(st: Stack):
    e = st.P.em.create_entity_locally("Persist")
    e.attrs.set("gold", 99)
    await st.settle()
    await st.stop()
    st.phases.append([("saved", st.P.storage.get_backend().read(
        "Persist", e.id))])


async def flow_freeze_restore(st: Stack):
    P = st.P
    st.gate().send_notify_client_connected(CID, 1, BOOT)
    e = P.em.create_entity_locally("Frozen")
    e.attrs.set("hp", 42)
    await st.settle()
    st.svc.start_freeze()
    assert await asyncio.wait_for(st.task, timeout=20) == 2
    assert os.path.exists("game1_freezed.dat")
    P.em.cleanup_for_tests()
    st.register()
    await st.boot_game(restore=True)
    await st.ready()
    e2 = P.em.get_entity(e.id)
    assert e2 is not None and e2.attrs.get("hp") == 42
    st.gate().send_call_entity_method_from_client(
        BOOT, "Login_Client", ("bob",), CID)
    await st.settle()
    await st.stop()


async def flow_freeze_fence(st: Stack):
    import time

    st.gate().send_notify_client_connected(CID, 1, BOOT)
    await st.settle()
    t0 = time.monotonic()
    st.svc.start_freeze()
    assert await asyncio.wait_for(st.task, timeout=20) == 2
    assert time.monotonic() - t0 < 1.0
    await st.settle(0.05)
    await st.cg.stop()
    await st.disp.stop()


async def flow_aoi(st: Stack):
    """Pipelined delivery: a tick delivers the previous tick's events."""
    P, em, V = st.P, st.P.em, st.P.Vector3
    for _ in range(1500):  # the loop's own AOI tick and sync catch-up
        if st.svc._last_aoi_tick == st.svc._last_sync_collect == FIXED_CLOCK:
            break
        await asyncio.sleep(0.01)
    assert st.svc._last_aoi_tick == st.svc._last_sync_collect == FIXED_CLOCK
    space = em.create_space_locally(kind=1)
    space.enable_aoi(100.0)
    st.cls.Hero.space = space
    mobs = []
    for i, (x, z) in enumerate([(10, 0), (0, 30), (-40, -40), (60, 10),
                                (0, -90), (500, 0), (0, 700), (900, 900)]):
        m = em.create_entity_locally("Mob")
        m.attrs.set("hp", i)
        space._enter(m, V(float(x), 0.0, float(z)))
        mobs.append(m)
    await st.server_tick(0)
    # The player's own create, then one per neighbor within 100.
    st.gate().send_notify_client_connected(CID, 1, BOOT)
    for _ in range(1500):
        if em.get_entity(BOOT) is not None:
            break
        await asyncio.sleep(0.01)
    await st.server_tick(1)
    await st.server_tick(2)
    mobs[0].set_position(V(400.0, 0.0, 400.0))  # leaves
    mobs[5].set_position(V(20.0, 0.0, 20.0))  # enters
    mobs[3].set_position(V(55.0, 0.0, 15.0))  # syncs
    await st.server_tick(3)
    await st.server_tick(4)
    mobs[1].destroy()
    mobs[6].set_position(V(-30.0, 0.0, 5.0))
    mobs[3].set_position(V(50.0, 0.0, 20.0))
    mobs[2].set_position(V(-35.0, 0.0, -45.0))
    await st.server_tick(5)
    await st.server_tick(6)
    await st.stop()


FLOWS = {
    "boot_rpc": (flow_boot_rpc, "BootAccount", False),
    "disconnect": (flow_disconnect, "BootAccount", False),
    "terminate_saves": (flow_terminate_saves, "BootAccount", False),
    "freeze_restore": (flow_freeze_restore, "BootAccount", False),
    "freeze_fence": (flow_freeze_fence, "BootAccount", False),
    "aoi": (flow_aoi, "Hero", True),
}


def play(P, tmp_path, name, monkeypatch):
    flow, boot, aoi = FLOWS[name]
    clean(P)
    reset_ids(P)
    st = Stack(P, tmp_path, boot=boot, aoi=aoi)
    if aoi:
        # The game module's monotonic clock stands still: the loop's first
        # iterations tick the (empty) AOI service and catch the sync
        # deadline up to the clock, and then neither is due again.
        import time

        monkeypatch.setattr(P.game, "time", types.SimpleNamespace(
            monotonic=lambda: FIXED_CLOCK, perf_counter=time.perf_counter,
            process_time=time.process_time))

    async def run():
        await st.start()
        await flow(st)

    asyncio.run(asyncio.wait_for(run(), timeout=60))
    if aoi:
        svc = P.em.runtime.aoi_service
        st.phases.append([("aoi_service", type(svc).__name__)])
    clean(P)
    return st.phases


@pytest.mark.parametrize("name", list(FLOWS))
def test_flow_gives_the_gate_equal_packets(both, tmp_path, monkeypatch,
                                           name):
    want = play(JAX, tmp_path, name, monkeypatch)
    got = play(PORT, tmp_path, name, monkeypatch)
    assert len(got) == len(want)
    assert sum(len(p) for p in want) > 0
    for k, (a, b) in enumerate(zip(want, got)):
        if name == "aoi":
            a, b = sorted(a, key=repr), sorted(b, key=repr)
        assert a == b, f"{name}: phase {k} differs"
    if name == "aoi":
        def count(kind):
            return [sum(p[0] == int(kind) for p in ph) for ph in want]

        mt = JAX.MsgType
        creates = count(mt.CREATE_ENTITY_ON_CLIENT)
        destroys = count(mt.DESTROY_ENTITY_ON_CLIENT)
        syncs = count(mt.SYNC_POSITION_YAW_ON_CLIENTS)
        # Tick 2 delivers the five neighbors within 100 (the player's own
        # create came with its connect, in tick 1's phase); tick 4 the
        # leave and the enter of tick 3's moves; the destroy and tick 6's
        # enter follow. Position syncs reach the player in later ticks.
        assert creates[1] >= 1 and creates[2] == 5, creates
        assert destroys[4] >= 1 and creates[4] >= 1, (creates, destroys)
        assert sum(destroys) >= 2 and sum(syncs) >= 2, (destroys, syncs)


def test_auto_platform_without_a_card_exits_nonzero(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: auto runs there")
    ini = tmp_path / "goworld.ini"
    ini.write_text(
        "[deployment]\ndispatchers = 1\ngames = 1\ngates = 1\n"
        "[dispatcher1]\nport = 1\n[game1]\n[gate1]\nport = 2\n"
        f"[storage]\ntype = filesystem\ndirectory = {tmp_path}/es\n"
        f"[kvdb]\ntype = filesystem\ndirectory = {tmp_path}/kv\n"
        "[aoi]\nbackend = tpu\nplatform = auto\nmax_entities = 64\n")
    r = subprocess.run(
        [sys.executable, "-m", "goworld_tpu_torch.examples.test_game",
         "-gid", "1", "-configfile", str(ini)],
        cwd=tmp_path, env=dict(os.environ, PYTHONPATH=str(ROOT)),
        capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "no CUDA device is available" in r.stdout + r.stderr
