"""The port's example servers on the port's in-process runtime.

The flows of tests/test_examples.py for unity_demo, chatroom_demo and
nil_game, played on ``goworld_tpu_torch.examples`` and the port's runtime
(a loopback kvreg, a sqlite kvdb); unity_demo's monster chase on the port's
batched AOI engine on the CPU; and a small unity crowd (2 spaces of 100
players and 3 monsters, the players on a seeded numpy walk) whose interest
sets after every AOI tick equal the JAX batched runtime's on the same
positions.
"""

from __future__ import annotations

import random
import time

import numpy as np
import pytest

from goworld_tpu_torch import dispatchercluster
from goworld_tpu_torch.entity import entity_manager as em
from goworld_tpu_torch.entity.game_client import GameClient
from goworld_tpu_torch.entity.vector import Vector3


class RecordingSender:
    """Captures every send_* call issued to the dispatcher fabric."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if name.startswith("send_"):
            def record(*args, **kwargs):
                self.calls.append((name, args, kwargs))

            return record
        raise AttributeError(name)


class RecordingCluster(dispatchercluster.DispatcherClusterBase):
    def __init__(self):
        self.sender = RecordingSender()

    def select(self, idx):
        return self.sender

    def count(self):
        return 1

    def of_type(self, msg):
        return [c for c in self.sender.calls if c[0] == msg]


class Stack:
    """One package's in-process runtime and its modules (the port's, or
    the JAX package's for the crowd's reference run)."""

    def __init__(self, pkg):
        import importlib

        def mod(name):
            return importlib.import_module(f"{pkg}.{name}")

        self.pkg = pkg
        self.em = mod("entity.entity_manager")
        self.service = mod("service")
        self.kvreg = mod("kvreg")
        self.kvdb = mod("kvdb")
        self.storage = mod("storage")
        self.post = mod("utils.post")
        self.cluster = mod("dispatchercluster")
        self.GameClient = mod("entity.game_client").GameClient
        self.Vector3 = mod("entity.vector").Vector3
        self.SQLiteKVDB = mod("kvdb.sqlite").SQLiteKVDB
        self.NeighborParams = mod("ops.neighbor").NeighborParams

    def clean(self):
        self.kvdb.set_backend(None)
        self.storage.set_backend(None)
        self.cluster.set_cluster(None)
        self.em.cleanup_for_tests()
        self.service.clear_for_tests()
        self.kvreg.clear_for_tests()
        self.post.clear()

    def start(self, path, monkeypatch):
        self.clean()
        self.kvdb.set_backend(self.SQLiteKVDB(str(path)))
        # Loopback: a registration applies at once, as if the dispatcher
        # had echoed it back (a single-game cluster).
        monkeypatch.setattr(
            self.kvreg, "register",
            lambda k, v, force=False: self.kvreg.on_registered(k, v))
        return self.em.runtime

    def pump(self, cond=None, timeout=8.0):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            self.em.runtime.tick()
            if cond is not None and cond():
                return True
            time.sleep(0.01)
        if cond is not None:
            raise AssertionError("pump timed out")
        return False

    def start_services(self, names, gameid=1):
        self.service.setup(gameid)
        self.service.on_deployment_ready()
        self.pump(lambda: all(self.service.check_service_entities_ready(n)
                              for n in names))


PORT = Stack("goworld_tpu_torch")


@pytest.fixture
def runtime(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    rt = PORT.start(tmp_path, monkeypatch)
    yield rt
    PORT.clean()


def pump(cond=None, timeout=8.0):
    return PORT.pump(cond, timeout)


def attach_client(entity, clientid="C" * 16, gateid=1):
    client = GameClient(clientid, gateid, entity.id)
    entity.set_client(client)
    return client


# --- unity_demo --------------------------------------------------------------


@pytest.fixture
def unity(runtime):
    from goworld_tpu_torch.examples import unity_demo as ud

    ud.register()
    em.create_nil_space(1)
    PORT.start_services(["OnlineService", "SpaceService"])
    return ud.server


def _enter(player):
    attach_client(player)
    pump(lambda: player.space is not None and not player.space.is_nil())


def test_unity_player_enters_space_with_monsters(unity):
    player = em.create_entity_locally("Player")
    _enter(player)
    assert player.space.count_entities("Monster") == \
        unity.MySpace.MONSTERS_PER_SPACE


def _chase_and_hit(player, monster, wait):
    """The monster's AI chases a player inside its AOI but outside attack
    range, then attacks one in range: a Tick lands DAMAGE. ``wait(cond)``
    returns once the monster's interest in the player has landed."""
    player.set_position(monster.position + Vector3(20.0, 0.0, 0.0))
    wait(lambda: monster.is_interested_in(player))
    monster.call_local("AI", ())
    assert monster.moving_to is player
    d0 = monster.distance_to(player)
    monster.call_local("Tick", ())
    assert monster.distance_to(player) < d0  # moved toward the player
    player.set_position(monster.position + Vector3(1.0, 0.0, 0.0))
    monster.call_local("AI", ())
    assert monster.attacking is player
    hp0 = player.attrs.get_int("hp")
    monster.call_local("Tick", ())
    assert player.attrs.get_int("hp") == hp0 - monster.DAMAGE


def test_unity_monster_chases_and_attacks(unity):
    player = em.create_entity_locally("Player")
    _enter(player)
    monster = next(e for e in player.space.entities
                   if e.typename == "Monster")
    player.call_local("DoEnterSpace", (player.space.kind, player.space.id))
    _chase_and_hit(player, monster, _landed_now)


def _landed_now(cond):
    """The xzlist manager delivers interest within the position update."""
    assert cond()


def test_unity_player_kills_monster(unity):
    player = em.create_entity_locally("Player")
    _enter(player)
    monster = next(e for e in player.space.entities
                   if e.typename == "Monster")
    for _ in range(10):
        player.call_local("Attack_Client", (monster.id,))
    assert monster.is_destroyed()
    assert monster.attrs.get_int("hp") == 0


def test_unity_player_death_and_respawn(unity):
    player = em.create_entity_locally("Player")
    _enter(player)
    for _ in range(10):
        player.call_local("TakeDamage", (10,))
    assert player.attrs.get_int("hp") == 0
    assert player.attrs.get_str("action") == "death"
    player.call_local("Respawn", ())
    assert player.attrs.get_int("hp") == player.attrs.get_int("hpmax")


@pytest.fixture
def unity_batched(runtime):
    """unity_demo on the port's batched AOI engine on the CPU: the AI reads
    interest sets that arrive one delivery tick late."""
    from goworld_tpu_torch.examples import unity_demo as ud

    runtime.aoi_backend = "batched"
    runtime.aoi_device = "cpu"
    runtime.aoi_params = PORT.NeighborParams(
        capacity=256, cell_size=600.0, grid_x=8, grid_z=8,
        space_slots=4, cell_capacity=64, max_events=16384)
    ud.register()
    em.create_nil_space(1)
    PORT.start_services(["SpaceService"])
    return ud.server


def test_unity_monster_chase_batched(unity_batched):
    player = em.create_entity_locally("Player")
    _enter(player)
    monster = next(e for e in player.space.entities
                   if e.typename == "Monster")
    svc = em.runtime.aoi_service
    assert svc.device.type == "cpu"
    _chase_and_hit(player, monster, pump)


# --- chatroom_demo / nil_game ------------------------------------------------


@pytest.fixture
def chatroom(runtime):
    from goworld_tpu_torch.examples import chatroom_demo as cd

    cd.register()
    em.create_nil_space(1)
    return cd.server


def test_chatroom_login_and_chat(chatroom):
    cluster = RecordingCluster()
    dispatchercluster.set_cluster(cluster)
    account = em.create_entity_locally("Account")
    attach_client(account)
    account.call_local("Login_Client", ("alice", "pw"))
    pump(lambda: len(em.get_entities_by_type("Avatar")) == 1)
    avatar = em.get_entities_by_type("Avatar")[0]
    assert avatar.attrs.get_str("chatroom") == "1"
    avatar.call_local("SendChat_Client", ("hello room",))
    assert len(cluster.of_type("send_call_filtered_client_proxies")) == 1
    avatar.call_local("SendChat_Client", ("/join lobby",))
    assert avatar.attrs.get_str("chatroom") == "lobby"
    avatar.call_local("SendChat_Client", ("hi lobby",))
    sends = cluster.of_type("send_call_filtered_client_proxies")
    assert len(sends) == 2 and "lobby" in str(sends[-1][1])


def test_chatroom_unknown_command(chatroom):
    cluster = RecordingCluster()
    dispatchercluster.set_cluster(cluster)
    avatar = em.create_entity_locally("Avatar", attrs={"name": "x"})
    attach_client(avatar)
    avatar.call_local("SendChat_Client", ("/frobnicate",))
    rpcs = cluster.of_type("send_call_entity_method_on_client")
    assert any("ShowError" in str(c[1]) for c in rpcs)


def test_nil_game_registers_and_boots(runtime):
    from goworld_tpu_torch.examples import nil_game as ng

    ng.register()
    assert em.create_nil_space(1).is_nil()
    assert em.create_entity_locally("Account").typename == "Account"


# --- a small unity crowd against the JAX batched runtime ---------------------

CROWD_SPACES = 2
CROWD_PLAYERS = 100
CROWD_TICKS = 12
CROWD_PARAMS = dict(capacity=256, cell_size=100.0, grid_x=16, grid_z=16,
                    space_slots=4, cell_capacity=128, max_events=16384)


def _crowd_interest(stack, path, monkeypatch):
    """unity_demo's crowd on ``stack``'s batched runtime: CROWD_SPACES
    spaces of CROWD_PLAYERS players (logged in a space at a time) and their
    monsters, the monsters' AI off (their timers would move them on the
    wall clock), then CROWD_TICKS AOI ticks of a seeded N(0, 1) walk of the
    players. Returns each tick's interest sets by entity label (type and
    creation order)."""
    import importlib

    ud = importlib.import_module(f"{stack.pkg}.examples.unity_demo.server") \
        if stack.pkg == "goworld_tpu_torch" else \
        importlib.import_module("examples.unity_demo.server")
    path.mkdir()
    rt = stack.start(path, monkeypatch)
    monkeypatch.setattr(ud.Monster, "AI", lambda self: None)
    monkeypatch.setattr(ud.Monster, "Tick", lambda self: None)
    rt.aoi_backend = "batched"
    if stack is PORT:
        rt.aoi_device = "cpu"
    rt.aoi_params = stack.NeighborParams(**CROWD_PARAMS)
    random.seed(3)  # the monsters' spawn offsets
    try:
        ud.register()
        stack.em.create_nil_space(1)
        stack.start_services(["OnlineService", "SpaceService"])
        players = []
        for k in range(CROWD_SPACES):
            batch = [stack.em.create_entity_locally("Player")
                     for _ in range(CROWD_PLAYERS)]
            for i, p in enumerate(batch):
                p.set_client(stack.GameClient(f"{k:04d}{i:012d}", 1, p.id))
            stack.pump(lambda: all(p.space is not None
                                   and not p.space.is_nil() for p in batch),
                       timeout=60)
            players += batch
        label, count = {}, {}
        for e in stack.em._entities.values():
            if e.typename in ("Player", "Monster"):
                count[e.typename] = count.get(e.typename, 0) + 1
                label[e.id] = f"{e.typename}{count[e.typename]}"
        svc = rt.aoi_service
        svc.flush()
        rng = np.random.default_rng(7)
        out = []
        for _ in range(CROWD_TICKS):
            step = rng.normal(0, 1.0, (len(players), 2)).astype(np.float32)
            for p, (dx, dz) in zip(players, step):
                q = p.position
                p.set_position(stack.Vector3(q.x + float(dx), q.y,
                                             q.z + float(dz)))
            svc.tick()
            svc.flush()
            out.append({label[e.id]: sorted(label[o.id]
                                            for o in e.interested_in)
                        for e in stack.em._entities.values()
                        if e.id in label})
        return out
    finally:
        stack.clean()


def test_unity_crowd_interest_equals_the_jax_batched_runtime(
        tmp_path, monkeypatch):
    jax = Stack("goworld_tpu")
    want = _crowd_interest(jax, tmp_path / "jax", monkeypatch)
    got = _crowd_interest(PORT, tmp_path / "port", monkeypatch)
    assert len(got) == CROWD_TICKS
    sizes = [len(s) for s in got[0].values()]
    # each space one crowd: 103 mutually interested entities
    assert len(got[0]) == CROWD_SPACES * (CROWD_PLAYERS + 3)
    assert max(sizes) == CROWD_PLAYERS + 2
    for t, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"tick {t}: interest sets differ"
