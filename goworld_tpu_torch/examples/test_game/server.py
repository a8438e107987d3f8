"""Full-feature test server.

Behavioral parity with the reference's examples/test_game: Account login via
KVDB (Account.go:37-111), Avatar with AOI, filtered chat, mail, pubsub,
complex attrs and cross-game nil-space hopping (Avatar.go:24-322), Monster and
AOITester AOI probes (Monster.go, AOITester.go), MySpace with 10 monsters and
auto-destroy (MySpace.go:26-129), and the three sharded services
(OnlineService.go, SpaceService.go, MailService.go).
"""

from __future__ import annotations

import random

import goworld_tpu_torch as goworld
from goworld_tpu_torch.entity.entity import Entity
from goworld_tpu_torch.entity.space import Space
from goworld_tpu_torch.entity.vector import Vector3
from goworld_tpu_torch.ext import pubsub
from goworld_tpu_torch.utils import gwlog

SERVICE_NAMES = ["OnlineService", "SpaceService", "MailService", pubsub.SERVICE_NAME]

PUBSUB_TEST_SUBJECTS = ["monster", "npc", "item", "avatar", "boss_*"]

MAX_AVATAR_COUNT_PER_SPACE = 100

SPACE_DESTROY_CHECK_INTERVAL = 300.0  # MySpace.go:15 (5 min)
SPACE_IDLE_DESTROY_SECONDS = 60.0  # SpaceService.go:159

END_MAIL_ID = 9999999999


class Account(Entity):
    """Login entity owning the client until an Avatar takes over
    (Account.go:14-111)."""

    @classmethod
    def describe_entity_type(cls, desc):
        desc.define_attr("loginAvatarID")

    def on_init(self):
        self.logining = False

    def Login_Client(self, username: str, password: str):
        if self.logining:
            gwlog.errorf("%s is already logining", self)
            return
        if password != "123456":
            self.call_client("OnLogin", False)
            return
        self.logining = True
        self.call_client("OnLogin", True)

        def got_avatar_id(avatar_id, err=None):
            if self.is_destroyed():
                return
            if not avatar_id:
                avatar = goworld.create_entity_locally("Avatar")
                goworld.kvdb_put(username, avatar.id)
                self._on_avatar_found(avatar)
            else:
                goworld.load_entity_somewhere("Avatar", avatar_id)
                self.call(avatar_id, "GetSpaceID", self.id)

        goworld.kvdb_get(username, got_avatar_id)

    def OnGetAvatarSpaceID(self, avatar_id: str, space_id: str):
        # The avatar may be local after all (Account.go:72-82).
        avatar = goworld.get_entity(avatar_id)
        if avatar is not None:
            self._on_avatar_found(avatar)
            return
        self.attrs.set("loginAvatarID", avatar_id)
        self.enter_space(space_id, Vector3())

    def _on_avatar_found(self, avatar: Entity):
        self.give_client_to(avatar)

    def on_client_disconnected(self):
        self.destroy()

    def on_migrate_in(self):
        avatar_id = self.attrs.get_str("loginAvatarID")
        avatar = goworld.get_entity(avatar_id)
        if avatar is not None:
            self._on_avatar_found(avatar)
        else:
            self.add_callback(random.random() * 3.0, "RetryLoginToAvatar", avatar_id)

    def RetryLoginToAvatar(self, avatar_id: str):
        goworld.load_entity_somewhere("Avatar", avatar_id)
        self.call(avatar_id, "GetSpaceID", self.id)


class Avatar(Entity):
    """The player entity (Avatar.go:20-322)."""

    # DELIBERATE DEVIATION from the reference: Avatar.go:217-231 keeps
    # every mail forever; under a mail-enabled soak that rides EVERY
    # migration (measured 400+ KB/avatar, BENCH_NOTES), so this
    # server keeps only the newest MAILBOX_CAP mails (see OnGetMails).
    # Class constant so a deploy (or parity audit) can subclass/override
    # it — set very large to approximate keep-everything.
    MAILBOX_CAP = 100

    @classmethod
    def describe_entity_type(cls, desc):
        desc.set_use_aoi(True, 100.0)
        desc.define_attr("name", "AllClients", "Persistent")
        desc.define_attr("level", "AllClients", "Persistent")
        desc.define_attr("prof", "AllClients", "Persistent")
        desc.define_attr("exp", "Client", "Persistent")
        desc.define_attr("mails", "Client", "Persistent")
        desc.define_attr("spaceKind", "Persistent")
        desc.define_attr("lastMailID", "Persistent")
        desc.define_attr("testListField", "AllClients")
        desc.define_attr("enteringNilSpace")
        desc.define_attr("testCallAllN")
        desc.define_attr("complexAttr", "Client")
        # Columnar attr (entity/columns.py): stored in a slab column,
        # read/written through the same attrs surface — the cross-game
        # migration e2e (tests/test_migration.py) pins that it continues
        # across the hop, and the CLI reload pins freeze→restore.
        desc.define_attr("pingCount", "Column", dtype="int32")

    def on_attrs_ready(self):
        a = self.attrs
        a.set_default("name", "noname")
        a.set_default("level", 1)
        a.set_default("exp", 0)
        a.set_default("prof", 1 + random.randrange(4))
        a.set_default("spaceKind", 1 + random.randrange(100))
        a.set_default("lastMailID", 0)
        a.set_default("mails", {})
        a.set_default("testListField", [])
        a.set_default("enteringNilSpace", False)

    def on_created(self):
        goworld.call_service_shard_key(
            "OnlineService", self.id, "CheckIn",
            self.id, self.attrs.get_str("name"), self.attrs.get_int("level"),
        )
        for subject in PUBSUB_TEST_SUBJECTS:
            # pubsub.subscribe routes wildcards to every shard so sharded
            # publishes can't miss them.
            pubsub.subscribe(self.id, subject)

    def on_destroy(self):
        goworld.call_service_shard_key("OnlineService", self.id, "CheckOut", self.id)
        goworld.call_service_all(pubsub.SERVICE_NAME, "UnsubscribeAll", self.id)

    # --- space hopping (Avatar.go:94-175) ----------------------------------

    def _enter_space_kind(self, kind: int):
        if self.space is not None and self.space.kind == kind:
            return
        # Remember the LATEST intent: with queued-until-ready service calls
        # (service._defer) a cold-start enter can be delivered late, and its
        # DoEnterSpace routing must not stomp a newer enter the client has
        # since requested.
        self._pending_enter_kind = kind
        goworld.call_service_shard_key("SpaceService", str(kind), "EnterSpace", self.id, kind)

    def on_client_connected(self):
        self.set_filter_prop("spaceKind", str(self.attrs.get_int("spaceKind")))
        self.set_filter_prop("level", str(self.attrs.get_int("level")))
        self.set_filter_prop("prof", str(self.attrs.get_int("prof")))
        self.set_filter_prop("online", "0")
        self.set_filter_prop("online", "1")
        self._enter_space_kind(self.attrs.get_int("spaceKind"))

    def on_client_disconnected(self):
        self.destroy()

    def EnterSpace_Client(self, kind: int):
        self._enter_space_kind(int(kind))

    def DoEnterSpace(self, kind: int, space_id: str):
        if getattr(self, "_pending_enter_kind", None) != kind:
            return  # stale routing from a superseded enter intent
        self.enter_space(space_id, _random_position())

    def GetSpaceID(self, caller_id: str):
        space_id = self.space.id if self.space is not None else ""
        self.call(caller_id, "OnGetAvatarSpaceID", self.id, space_id)

    def EnterRandomNilSpace_Client(self):
        games = goworld.get_online_games()
        gameid = random.choice(sorted(games)) if games else goworld.get_game_id()
        nil_space_id = goworld.get_nil_space_id(gameid)
        self.attrs.set("enteringNilSpace", True)
        if goworld.get_space(nil_space_id) is not None:
            self.attrs.set("enteringNilSpace", False)
            self.enter_space(nil_space_id, Vector3())
            self.call_client("OnEnterRandomNilSpace")
        else:
            self.enter_space(nil_space_id, Vector3())

    def on_migrate_in(self):
        if self.attrs.get_bool("enteringNilSpace"):
            self.attrs.delete("enteringNilSpace")
            self.call_client("OnEnterRandomNilSpace")

    def on_enter_space(self):
        # The reference protocol pushes a client-side space object on every
        # space switch (ClientBot.go:485-496 createSpace → OnEnterSpace);
        # this framework's wire protocol is entity-only, so the test server
        # acks space entry explicitly — the bot harness keys its
        # DoEnterRandomSpace completion off this (bot_runner.py).
        super().on_enter_space()
        self._pending_enter_kind = None
        kind = self.space.kind if self.space is not None else 0
        self.call_client("OnEnterSpace", kind)

    # --- chat (Avatar.go:233-245) ------------------------------------------

    def Say_Client(self, channel: str, content: str):
        if channel == "world":
            self.call_filtered_clients("", "=", "", "OnSay",
                                       self.id, self.attrs.get_str("name"), channel, content)
        elif channel == "prof":
            prof = str(self.attrs.get_int("prof"))
            self.call_filtered_clients("prof", "=", prof, "OnSay",
                                       self.id, self.attrs.get_str("name"), channel, content)
        else:
            raise ValueError(f"invalid channel: {channel}")

    def Move_Client(self, x: float, y: float, z: float):
        self.set_position(Vector3(x, y, z))

    # --- migration test probes (no reference analog; used by
    # tests/test_migration.py to observe cross-game hops from the client) ---

    def ReportGame_Client(self):
        self.call_client(
            "OnReportGame",
            goworld.get_game_id(),
            self.space.id if self.space is not None else "",
            self.space.kind if self.space is not None else -1,
        )

    def EnterSpaceByID_Client(self, space_id: str):
        self.enter_space(space_id, _random_position())

    def ReportAOI_Client(self):
        self.call_client(
            "OnReportAOI",
            sorted(e.id for e in self.interested_in),
            float(self.position.x), float(self.position.z),
        )

    def StartPing_Client(self, period: float):
        self.add_timer(float(period), "PingTimer")

    def PingTimer(self):
        # Counter lives in attrs so a cross-game hop must carry it: the
        # post-migration ping sequence continuing from the pre-migration
        # value proves BOTH the repeat timer and the attrs migrated.
        n = self.attrs.get_int("pingCount") + 1
        self.attrs.set("pingCount", n)
        self.call_client("OnPing", n)

    # --- mail (Avatar.go:185-231) ------------------------------------------

    def SendMail_Client(self, target_id: str, mail):
        goworld.call_service_any(
            "MailService", "SendMail", self.id, self.attrs.get_str("name"), target_id, mail
        )

    def OnSendMail(self, ok: bool):
        self.call_client("OnSendMail", ok)

    def NotifyReceiveMail(self):
        pass

    def GetMails_Client(self):
        goworld.call_service_any("MailService", "GetMails", self.id, self.attrs.get_int("lastMailID"))

    def OnGetMails(self, last_mail_id: int, mails: list):
        if last_mail_id != self.attrs.get_int("lastMailID"):
            gwlog.warnf("%s.OnGetMails: lastMailID mismatch: local=%s return=%s",
                        self, self.attrs.get_int("lastMailID"), last_mail_id)
            self.call_client("OnGetMails", False)
            return
        mails_attr = self.attrs.get_map("mails")
        for mail_id, mail in mails:
            if mail_id <= self.attrs.get_int("lastMailID"):
                raise RuntimeError("mail ID should be increasing")
            if mails_attr.has(str(mail_id)):
                gwlog.errorf("mail %d received multiple times", mail_id)
                continue
            mails_attr.set(str(mail_id), mail)
            self.attrs.set("lastMailID", mail_id)
        # Bound the mailbox: keep the newest MAILBOX_CAP (documented
        # deviation — see the class constant). The reference never prunes
        # and never notices, because its CI runs with DoSendMail disabled.
        overflow = len(mails_attr) - self.MAILBOX_CAP
        if overflow > 0:
            for old_id in sorted(mails_attr.keys(), key=int)[:overflow]:
                mails_attr.delete(old_id)
        self.call_client("OnGetMails", True)

    # --- pubsub (Avatar.go:247-262) ----------------------------------------

    def TestPublish_Client(self):
        subject = random.choice(PUBSUB_TEST_SUBJECTS)
        if subject.endswith("*"):
            subject = subject[:-1] + str(random.randrange(100))
        goworld.call_service_shard_key(
            pubsub.SERVICE_NAME, subject, "Publish",
            subject, f"{self.id}: hello {subject}, this is a test publish message",
        )

    def OnPublish(self, subject: str, content: str):
        publisher = content[:16]  # EntityID prefix (common.ENTITYID_LENGTH)
        self.call_client("OnTestPublish", publisher, subject, content)

    # --- AOI probe (Avatar.go:264-275) --------------------------------------

    def TestAOI_Client(self):
        e = goworld.create_entity_locally("AOITester")
        if e.space is not None and not e.space.is_nil():
            raise RuntimeError("AOITester space is not nil")
        if self.space is not None:
            e.enter_space(self.space.id, self.position)

        # The batched AOI plane delivers enter diffs one tick late (pipelined
        # by design, aoi/batched.py); destroying on the next post drain would
        # reconcile the enter away before the client ever saw the tester.
        # A short timer keeps the reference probe semantics (create reaches
        # the client, then the tester disappears) on both AOI backends.
        self.add_callback(0.2, "FinishTestAOI", e.id)

    def FinishTestAOI(self, tester_id: str):
        self.call_client("OnTestAOI", tester_id)
        tester = goworld.get_entity(tester_id)
        if tester is not None and not tester.is_destroyed():
            tester.destroy()

    # --- AllClients echo (Avatar.go:277-303) ---------------------------------

    def TestCallAll_Client(self):
        avatar_count = 1 + sum(1 for e in self.interested_in if e.typename == "Avatar")
        self.attrs.set("testCallAllN", avatar_count)
        self.call_all_clients("TestCallAllPlzEcho", self.id)

    def TestCallAllEcho_AllClients(self, eid: str):
        o = goworld.get_entity(eid)
        if o is None:
            gwlog.warnf("%s.TestCallAllEcho: can not find avatar %s", self, eid)
            return
        v = o.attrs.get_int("testCallAllN") - 1
        o.attrs.set("testCallAllN", v)
        if v == 0:
            o.call_client("OnTestCallAll")

    # --- nested attrs (Avatar.go:305-322) -----------------------------------

    def TestComplexAttr_Client(self):
        complex_attr = self.attrs.get_map("complexAttr")
        key1 = complex_attr.get_map("key1")
        key2 = key1.get_list("key2")
        key2.append(True)
        key2.append([])
        idx1 = key2[1]
        idx1.append({})
        idx1[0].set("finalkey", "iamhere")
        self.call_client("OnTestComplexAttrStep1")
        complex_attr.clear()
        self.call_client("OnTestComplexAttrClear")

    def TestListField_Client(self):
        lst = self.attrs.get_list("testListField")
        r = random.random()
        if len(lst) > 0 and r < 1 / 3:
            lst.pop()
        elif len(lst) > 0 and r < 0.5:
            lst.set(random.randrange(len(lst)), random.randrange(100))
        else:
            lst.append(random.randrange(100))
        self.call_client("OnTestListField", lst.to_list())


class Monster(Entity):
    """AOI-visible dummy (Monster.go:9-13)."""

    @classmethod
    def describe_entity_type(cls, desc):
        desc.set_use_aoi(True, 100.0)


class AOITester(Entity):
    """Probe spawned into the caller's space to exercise AOI create-on-client
    (AOITester.go:9-16)."""

    @classmethod
    def describe_entity_type(cls, desc):
        desc.set_use_aoi(True, 100.0)


class MySpace(Space):
    """Custom space: AOI 100, 10 monsters, auto-destroy when idle
    (MySpace.go:18-129)."""

    MONSTERS_PER_SPACE = 10

    def on_init(self):
        self._destroy_check_timer = 0

    def on_space_created(self):
        self.enable_aoi(100.0)
        goworld.call_service_shard_key(
            "SpaceService", str(self.kind), "NotifySpaceLoaded", self.kind, self.id
        )
        for _ in range(self.MONSTERS_PER_SPACE):
            self.create_entity("Monster", Vector3())

    def on_entity_enter_space(self, entity: Entity):
        if self.kind <= 0:
            return  # nil space: never registered with SpaceService
        if entity.typename == "Avatar":
            # Authoritative counting: the service's avatar_num moves ONLY
            # on these symmetric space hooks. Counting at routing time
            # drifted +1 whenever an avatar re-requested the space it was
            # already in (no leave ever matched the increment), inflating
            # spaces to "full" and churning fresh ones (measured: 52
            # spaces for 60 bots and 2 kinds).
            goworld.call_service_shard_key(
                "SpaceService", str(self.kind), "AvatarEntered",
                self.kind, self.id,
            )
            self._clear_destroy_check_timer()

    def on_entity_leave_space(self, entity: Entity):
        if self.kind <= 0:
            return
        if entity.typename == "Avatar":
            # Keep the SpaceService's per-space avatar count honest: the
            # reference declares AvatarNum but never updates it (dead
            # field — its spaces can never report full), while the earlier
            # port incremented at ROUTING time without decrementing, so
            # every ~100 aggregate enters marked a space full and churned
            # a fresh MySpace + 10 Monsters, unbounded. (The ~1-space-per
            # -bot world population itself is faithful: the reference
            # randomizes spaceKind over 100 kinds, Avatar.go:70.)
            goworld.call_service_shard_key(
                "SpaceService", str(self.kind), "AvatarLeft",
                self.kind, self.id,
            )
            if self.count_entities("Avatar") == 0:
                self._set_destroy_check_timer()

    def _set_destroy_check_timer(self):
        if self._destroy_check_timer:
            return
        self._destroy_check_timer = self.add_timer(
            SPACE_DESTROY_CHECK_INTERVAL, "CheckForDestroy"
        )

    def _clear_destroy_check_timer(self):
        if self._destroy_check_timer:
            self.cancel_timer(self._destroy_check_timer)
            self._destroy_check_timer = 0

    def CheckForDestroy(self):
        if self.count_entities("Avatar") != 0:
            raise RuntimeError("Avatar count should be 0")
        goworld.call_service_shard_key(
            "SpaceService", str(self.kind), "RequestDestroy", self.kind, self.id
        )

    def ConfirmRequestDestroy(self, ok: bool):
        if ok:
            if self.count_entities("Avatar") != 0:
                raise RuntimeError("ConfirmRequestDestroy: avatars present")
            self.destroy()

    def on_game_ready(self):
        gwlog.infof("%s on game ready", self)

    def TestCallNilSpaces(self, a, b, c, d):
        gwlog.infof("TestCallNilSpaces %s %s %s %s works", a, b, c, d)


class OnlineService(Entity):
    """Tracks online avatars (OnlineService.go:15-51)."""

    @classmethod
    def describe_entity_type(cls, desc):
        pass

    def on_init(self):
        self.avatars: dict[str, tuple[str, int]] = {}
        self.maxlevel = 0

    def CheckIn(self, avatar_id: str, name: str, level: int):
        self.avatars[avatar_id] = (name, level)
        self.maxlevel = max(self.maxlevel, level)

    def CheckOut(self, avatar_id: str):
        self.avatars.pop(avatar_id, None)


class SpaceService(Entity):
    """Space management: choose/create spaces per kind and route avatars
    (SpaceService.go:53-164)."""

    @classmethod
    def describe_entity_type(cls, desc):
        pass

    # Routed-but-not-yet-entered reservations expire after this horizon —
    # they bound overfill during the enter round-trip without reintroducing
    # the permanent count drift of routing-time increments.
    INFLIGHT_HORIZON = 10.0

    def on_init(self):
        # kind → {space_id → info dict(avatar_num, inflight, last_enter_time)}
        self.space_kinds: dict[int, dict[str, dict]] = {}
        self.pending_requests: list[tuple[str, int]] = []
        self._creating_since: dict[int, float] = {}  # kind → first create t

    def _kind_info(self, kind: int) -> dict[str, dict]:
        return self.space_kinds.setdefault(kind, {})

    def _occupancy(self, info: dict) -> int:
        horizon = goworld.now() - self.INFLIGHT_HORIZON
        info["inflight"] = [t for t in info.get("inflight", []) if t > horizon]
        return info["avatar_num"] + len(info["inflight"])

    def _choose(self, kind: int) -> str | None:
        """The space with the most avatars that is not full
        (SpaceService.go:26-39); counts include un-expired in-flight
        routings so a burst can't overfill one space past the cap."""
        best_id, best = None, None
        for sid, info in self._kind_info(kind).items():
            occ = self._occupancy(info)
            if occ >= MAX_AVATAR_COUNT_PER_SPACE:
                continue
            if best is None or occ > best:
                best_id, best = sid, occ
        return best_id

    def EnterSpace(self, avatar_id: str, kind: int):
        sid = self._choose(kind)
        if sid is not None:
            info = self._kind_info(kind)[sid]
            info["last_enter_time"] = goworld.now()
            info.setdefault("inflight", []).append(goworld.now())
            self.call(avatar_id, "DoEnterSpace", kind, sid)
        else:
            # One creation per kind per storm: NotifySpaceLoaded satisfies
            # EVERY pending request of the kind, so concurrent requesters
            # only need the first to trigger the create. (The reference
            # creates one space PER REQUEST here — a 60-bot cold start
            # spawned ~80 spaces + 800 monsters that only 5-minute idle
            # destroy reaps.) A lost create (target game froze before
            # NotifySpaceLoaded) re-fires after the horizon instead of
            # wedging the kind forever.
            now = goworld.now()
            since = self._creating_since.get(kind)
            self.pending_requests.append((avatar_id, kind))
            if since is None or now - since > self.INFLIGHT_HORIZON:
                self._creating_since[kind] = now
                goworld.create_space_somewhere(kind)

    def NotifySpaceLoaded(self, kind: int, space_id: str):
        self._creating_since.pop(kind, None)
        self._kind_info(kind)[space_id] = {
            "avatar_num": 0,
            "inflight": [],
            "last_enter_time": goworld.now(),
        }
        satisfied = [r for r in self.pending_requests if r[1] == kind]
        self.pending_requests = [r for r in self.pending_requests if r[1] != kind]
        info = self._kind_info(kind)[space_id]
        for avatar_id, _ in satisfied:
            info["inflight"].append(goworld.now())
            self.call(avatar_id, "DoEnterSpace", kind, space_id)

    def AvatarEntered(self, kind: int, space_id: str):
        info = self._kind_info(kind).get(space_id)
        if info is not None:
            info["avatar_num"] += 1
            if info.get("inflight"):
                info["inflight"].pop(0)  # reservation completed
            info["last_enter_time"] = goworld.now()

    def AvatarLeft(self, kind: int, space_id: str):
        info = self._kind_info(kind).get(space_id)
        if info is not None and info["avatar_num"] > 0:
            info["avatar_num"] -= 1

    def RequestDestroy(self, kind: int, space_id: str):
        info = self._kind_info(kind).get(space_id)
        if info is None:
            self.call(space_id, "ConfirmRequestDestroy", True)
            return
        if goworld.now() > info["last_enter_time"] + SPACE_IDLE_DESTROY_SECONDS:
            del self._kind_info(kind)[space_id]
            self.call(space_id, "ConfirmRequestDestroy", True)


class MailService(Entity):
    """Mail over KVDB with monotonically increasing ids
    (MailService.go:22-131)."""

    @classmethod
    def describe_entity_type(cls, desc):
        pass

    def on_init(self):
        self.last_mail_id = -1

    def on_created(self):
        self._load_last_mail_id()

    def on_restored(self):
        # Freeze/restore skips on_created; without this reload the restored
        # shard would reject every SendMail forever (the reference shares
        # this hole — its CI runs with DoSendMail disabled).
        self._load_last_mail_id()

    def _load_last_mail_id(self):
        def loaded(old_val, err=None):
            self.last_mail_id = int(old_val) if old_val else 0

        goworld.kvdb_get_or_put("MailService:lastMailID", "0", loaded)

    @staticmethod
    def _mail_key(mail_id: int, target_id: str) -> str:
        return f"MailService:mail${target_id}${mail_id:010d}"

    @staticmethod
    def _parse_mail_key(key: str) -> tuple[str, int]:
        eid = key[len("MailService:mail$"):len("MailService:mail$") + 16]
        return eid, int(key.rsplit("$", 1)[1])

    def _gen_mail_id(self) -> int:
        if self.last_mail_id < 0:
            raise RuntimeError("MailService: lastMailID not loaded yet")
        self.last_mail_id += 1
        goworld.kvdb_put("MailService:lastMailID", str(self.last_mail_id))
        return self.last_mail_id

    def SendMail(self, sender_id: str, sender_name: str, target_id: str, data):
        if self.last_mail_id < 0:
            # id counter still loading (fresh create or just restored):
            # retry shortly instead of failing the client's send.
            self.add_callback(0.2, "SendMail", sender_id, sender_name,
                              target_id, data)
            return
        mail_id = self._gen_mail_id()
        mail_key = self._mail_key(mail_id, target_id)
        mail = {
            "senderID": sender_id,
            "senderName": sender_name,
            "targetID": target_id,
            "data": data,
        }
        from goworld_tpu_torch.netutil.msgpacker import pack_msg

        def saved(result, err=None):
            self.call(sender_id, "OnSendMail", True)
            self.call(target_id, "NotifyReceiveMail")

        goworld.kvdb_put(mail_key, pack_msg(mail).hex(), saved)

    def GetMails(self, avatar_id: str, last_mail_id: int):
        begin = self._mail_key(last_mail_id + 1, avatar_id)
        end = self._mail_key(END_MAIL_ID, avatar_id)

        def got(items, err=None):
            mails = [[self._parse_mail_key(k)[1], v] for k, v in items]
            self.call(avatar_id, "OnGetMails", last_mail_id, mails)

        goworld.kvdb_get_range(begin, end, got)


def _random_position() -> Vector3:
    return Vector3(float(random.randint(-400, 400)), 0.0, float(random.randint(-400, 400)))


def register() -> None:
    """Register all test_game entity types (test_game.go:26-42)."""
    goworld.register_space(MySpace)
    goworld.register_entity(Account)
    goworld.register_entity(AOITester)
    goworld.register_service(OnlineService, 3)
    goworld.register_service(SpaceService, 3)
    goworld.register_service(MailService, 1)
    pubsub.register_service(3)
    goworld.register_entity(Monster)
    goworld.register_entity(Avatar)


def main() -> None:
    register()
    goworld.run()


if __name__ == "__main__":
    main()
