"""Unity-facing combat demo.

Behavioral parity with the reference's examples/unity_demo: Account login
(Account.go), Player with client-driven movement and combat stats
(Player.go:14-192), Monster AI chasing/attacking the nearest player through
its AOI interest set (Monster.go:11-171), MySpace spawning monsters, and
SpaceService capping spaces at 100 avatars (SpaceService.go:13-43).
"""

from __future__ import annotations

import random

import goworld_tpu_torch as goworld
from goworld_tpu_torch.entity.entity import Entity
from goworld_tpu_torch.entity.space import Space
from goworld_tpu_torch.entity.vector import Vector3
from goworld_tpu_torch.utils import gwlog

MAX_AVATAR_COUNT_PER_SPACE = 100

MONSTER_TICK_INTERVAL = 0.030  # Monster.go:34 (30 ms movement tick)
MONSTER_AI_INTERVAL = 0.100  # Monster.go:31 (100 ms target selection)


class Account(Entity):
    """Login flow: password check → create/load Player → hand the client
    over (unity_demo/Account.go)."""

    @classmethod
    def describe_entity_type(cls, desc):
        pass

    def on_init(self):
        self.logining = False

    def Login_Client(self, username: str, password: str):
        if self.logining:
            return
        if password != "123456":
            self.call_client("OnLogin", False)
            return
        self.logining = True
        self.call_client("OnLogin", True)

        def got(player_id, err=None):
            if self.is_destroyed():
                return
            if not player_id:
                player = goworld.create_entity_locally("Player")
                goworld.kvdb_put(username, player.id)
                self.give_client_to(player)
            else:
                goworld.load_entity_somewhere("Player", player_id)
                self.call(player_id, "GetSpaceID", self.id)

        goworld.kvdb_get(username, got)

    def OnGetPlayerSpaceID(self, player_id: str, space_id: str):
        player = goworld.get_entity(player_id)
        if player is not None:
            self.give_client_to(player)
            return
        self.attrs.set("loginPlayerID", player_id)
        self.enter_space(space_id, Vector3())

    def on_migrate_in(self):
        # Arrived on the player's game: finish the handover (same retry shape
        # as test_game's Account.OnMigrateIn).
        player_id = self.attrs.get_str("loginPlayerID")
        player = goworld.get_entity(player_id)
        if player is not None:
            self.give_client_to(player)
        else:
            self.add_callback(random.random() * 3.0, "RetryLoginToPlayer", player_id)

    def RetryLoginToPlayer(self, player_id: str):
        goworld.load_entity_somewhere("Player", player_id)
        self.call(player_id, "GetSpaceID", self.id)

    def on_client_disconnected(self):
        self.destroy()


class Player(Entity):
    """The player: client-synced movement, HP, respawn (Player.go:14-192)."""

    @classmethod
    def describe_entity_type(cls, desc):
        desc.set_use_aoi(True, 100.0)
        desc.define_attr("name", "AllClients", "Persistent")
        desc.define_attr("lv", "AllClients", "Persistent")
        desc.define_attr("hp", "AllClients")
        desc.define_attr("hpmax", "AllClients")
        desc.define_attr("action", "AllClients")
        desc.define_attr("spaceKind", "Persistent")

    def on_attrs_ready(self):
        a = self.attrs
        a.set_default("spaceKind", 1)
        a.set_default("name", "noname")
        a.set_default("lv", 1)
        a.set_default("hp", 100)
        a.set_default("hpmax", 100)
        a.set_default("action", "idle")
        a.set_default("attack", 30)
        self.set_client_syncing(True)

    def GetSpaceID(self, caller_id: str):
        space_id = self.space.id if self.space is not None else ""
        self.call(caller_id, "OnGetPlayerSpaceID", self.id, space_id)

    def _enter_space_kind(self, kind: int):
        if self.space is not None and self.space.kind == kind:
            return
        goworld.call_service_shard_key("SpaceService", str(kind), "EnterSpace", self.id, kind)

    def on_client_connected(self):
        self._enter_space_kind(self.attrs.get_int("spaceKind"))

    def on_client_disconnected(self):
        self.destroy()

    def EnterSpace_Client(self, kind: int):
        self._enter_space_kind(int(kind))

    def DoEnterSpace(self, kind: int, space_id: str):
        self.attrs.set("spaceKind", kind)
        self.enter_space(space_id, Vector3())

    # --- combat (Player.go:100-192) ----------------------------------------

    def TakeDamage(self, damage: int):
        hp = max(0, self.attrs.get_int("hp") - int(damage))
        self.attrs.set("hp", hp)
        if hp <= 0:
            self.attrs.set("action", "death")
            self.set_client_syncing(False)
            self.add_callback(10.0, "Respawn")

    def Respawn(self):
        self.attrs.set("hp", self.attrs.get_int("hpmax"))
        self.attrs.set("action", "idle")
        self.set_position(Vector3())
        self.set_client_syncing(True)

    def Attack_Client(self, target_id: str):
        target = goworld.get_entity(target_id)
        if target is None or target.typename != "Monster":
            return
        self.call_all_clients("DisplayAttack", target_id)
        target.TakeDamage(self.attrs.get_int("attack", 30))


class Monster(Entity):
    """AI: pick the nearest live player in AOI every 100 ms; chase until in
    attack range, then attack on a cooldown (Monster.go:11-171)."""

    @classmethod
    def describe_entity_type(cls, desc):
        desc.set_use_aoi(True, 100.0)
        desc.define_attr("name", "AllClients")
        desc.define_attr("lv", "AllClients")
        desc.define_attr("hp", "AllClients")
        desc.define_attr("hpmax", "AllClients")
        desc.define_attr("action", "AllClients")

    SPEED = 2.0
    ATTACK_RANGE = 3.0
    ATTACK_CD = 1.0
    DAMAGE = 10

    def on_init(self):
        self.moving_to = None
        self.attacking = None
        self.last_attack_time = 0.0

    def on_enter_space(self):
        a = self.attrs
        a.set_default("name", "minion")
        a.set_default("lv", 1)
        a.set_default("hpmax", 100)
        a.set_default("hp", 100)
        a.set_default("action", "idle")
        self.add_timer(MONSTER_AI_INTERVAL, "AI")
        self.add_timer(MONSTER_TICK_INTERVAL, "Tick")

    def AI(self):
        nearest = None
        for e in self.interested_in:
            if e.typename != "Player" or e.attrs.get_int("hp") <= 0:
                continue
            if nearest is None or self.distance_to(nearest) > self.distance_to(e):
                nearest = e
        if nearest is None:
            self._idle()
        elif self.distance_to(nearest) > self.ATTACK_RANGE:
            self._move_to(nearest)
        else:
            self._attack_target(nearest)

    def Tick(self):
        if self.attacking is not None and self.is_interested_in(self.attacking):
            now = goworld.now()
            if now >= self.last_attack_time + self.ATTACK_CD:
                self.face_to(self.attacking)
                self._attack(self.attacking)
                self.last_attack_time = now
            return
        if self.moving_to is not None and self.is_interested_in(self.moving_to):
            direction = self.moving_to.position - self.position
            direction = Vector3(direction.x, 0.0, direction.z)
            step = direction.normalized() * (self.SPEED * MONSTER_TICK_INTERVAL)
            self.set_position(self.position + step)
            self.face_to(self.moving_to)

    def _idle(self):
        if self.moving_to is None and self.attacking is None:
            return
        self.moving_to = None
        self.attacking = None
        self.attrs.set("action", "idle")

    def _move_to(self, player: Entity):
        if self.moving_to is player:
            return
        self.moving_to = player
        self.attacking = None
        self.attrs.set("action", "move")

    def _attack_target(self, player: Entity):
        if self.attacking is player:
            return
        self.moving_to = None
        self.attacking = player
        self.attrs.set("action", "attack")

    def _attack(self, player: Entity):
        self.call_all_clients("DisplayAttack", player.id)
        if player.attrs.get_int("hp") <= 0:
            return
        player.TakeDamage(self.DAMAGE)

    def TakeDamage(self, damage: int):
        hp = max(0, self.attrs.get_int("hp") - int(damage))
        self.attrs.set("hp", hp)
        gwlog.infof("%s TakeDamage %s => hp=%s", self, damage, hp)
        if hp <= 0:
            self.attrs.set("action", "death")
            self.destroy()


class MySpace(Space):
    """Spawns monsters when created (unity_demo/MySpace.go)."""

    MONSTERS_PER_SPACE = 3

    def on_space_created(self):
        if self.kind <= 0:
            return
        self.enable_aoi(100.0)
        goworld.call_service_shard_key(
            "SpaceService", str(self.kind), "NotifySpaceLoaded", self.kind, self.id
        )
        for i in range(self.MONSTERS_PER_SPACE):
            self.create_entity(
                "Monster", Vector3(float(random.randint(-10, 10)), 0.0, float(random.randint(-10, 10)))
            )

    def on_entity_enter_space(self, entity):
        # Authoritative symmetric counting on the space hooks — see
        # test_game MySpace for the drift analysis (routing-time counting
        # leaks +1 per same-space re-enter and churns spaces).
        if self.kind <= 0:
            return  # nil space: never registered with SpaceService
        if entity.typename == "Player":
            goworld.call_service_shard_key(
                "SpaceService", str(self.kind), "AvatarEntered",
                self.kind, self.id,
            )

    def on_entity_leave_space(self, entity):
        if self.kind <= 0:
            return
        if entity.typename == "Player":
            goworld.call_service_shard_key(
                "SpaceService", str(self.kind), "AvatarLeft",
                self.kind, self.id,
            )


class OnlineService(Entity):
    """Same bookkeeping as test_game's (unity_demo/OnlineService.go)."""

    @classmethod
    def describe_entity_type(cls, desc):
        pass

    def on_init(self):
        self.avatars: dict[str, tuple[str, int]] = {}

    def CheckIn(self, avatar_id: str, name: str, level: int):
        self.avatars[avatar_id] = (name, level)

    def CheckOut(self, avatar_id: str):
        self.avatars.pop(avatar_id, None)


class SpaceService(Entity):
    """Space chooser with the 100-avatar cap (unity_demo/SpaceService.go)."""

    @classmethod
    def describe_entity_type(cls, desc):
        pass

    INFLIGHT_HORIZON = 10.0  # see test_game SpaceService

    def on_init(self):
        self.space_kinds: dict[int, dict[str, dict]] = {}
        self.pending_requests: list[tuple[str, int]] = []
        self._creating_since: dict[int, float] = {}

    def _kind_info(self, kind: int) -> dict[str, dict]:
        return self.space_kinds.setdefault(kind, {})

    def _occupancy(self, info: dict) -> int:
        horizon = goworld.now() - self.INFLIGHT_HORIZON
        info["inflight"] = [t for t in info.get("inflight", []) if t > horizon]
        return info["avatar_num"] + len(info["inflight"])

    def EnterSpace(self, avatar_id: str, kind: int):
        chosen, best = None, None
        for sid, info in self._kind_info(kind).items():
            occ = self._occupancy(info)
            if occ >= MAX_AVATAR_COUNT_PER_SPACE:
                continue
            if chosen is None or occ > best:
                chosen, best = sid, occ
        if chosen is not None:
            info = self._kind_info(kind)[chosen]
            info.setdefault("inflight", []).append(goworld.now())
            self.call(avatar_id, "DoEnterSpace", kind, chosen)
        else:
            # Deduplicate creation per kind with a retry horizon (see
            # test_game SpaceService).
            now = goworld.now()
            since = self._creating_since.get(kind)
            self.pending_requests.append((avatar_id, kind))
            if since is None or now - since > self.INFLIGHT_HORIZON:
                self._creating_since[kind] = now
                goworld.create_space_somewhere(kind)

    def NotifySpaceLoaded(self, kind: int, space_id: str):
        self._creating_since.pop(kind, None)
        info = self._kind_info(kind)[space_id] = {
            "avatar_num": 0, "inflight": [],
        }
        satisfied = [r for r in self.pending_requests if r[1] == kind]
        self.pending_requests = [r for r in self.pending_requests if r[1] != kind]
        for avatar_id, _ in satisfied:
            info["inflight"].append(goworld.now())
            self.call(avatar_id, "DoEnterSpace", kind, space_id)

    def AvatarEntered(self, kind: int, space_id: str):
        info = self._kind_info(kind).get(space_id)
        if info is not None:
            info["avatar_num"] += 1
            if info.get("inflight"):
                info["inflight"].pop(0)

    def AvatarLeft(self, kind: int, space_id: str):
        info = self._kind_info(kind).get(space_id)
        if info is not None and info["avatar_num"] > 0:
            info["avatar_num"] -= 1


def register() -> None:
    goworld.register_space(MySpace)
    goworld.register_entity(Account)
    goworld.register_entity(Player)
    goworld.register_entity(Monster)
    goworld.register_service(OnlineService, 1)
    goworld.register_service(SpaceService, 1)


def main() -> None:
    register()
    goworld.run()


if __name__ == "__main__":
    main()
