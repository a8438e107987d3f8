"""The port's dispatcher keeps a routed space bundle until its target acks.

A whole-space handoff's SPACE_MIGRATE_DATA is the space's last copy. When
the target game is killed just as the bundle is routed to it, the bundle
can be written into a socket that outlives the process by the few
milliseconds the kernel takes to tear it down (~20 ms for a process with
torch loaded), and is never read. The port's dispatcher keeps every
bundle it wrote to a live target until the target's SPACE_MIGRATE_ACK,
and bounces it home when the target is declared dead or cold-boots under
the same gameid (``DispatcherService._bounce_inflight_spaces``). The JAX package's
dispatcher drops it: the same steps are played on both packages, and the
space comes home only in the port.
"""

from __future__ import annotations

import asyncio

import pytest

from goworld_tpu import consts as jconsts
from goworld_tpu.dispatcher import DispatcherService as JDispatcher
from goworld_tpu.dispatchercluster.cluster import ClusterClient as JClient
from goworld_tpu.proto.msgtypes import MsgType as JMsgType
from goworld_tpu_torch import consts as tconsts
from goworld_tpu_torch.dispatcher import DispatcherService as TDispatcher
from goworld_tpu_torch.dispatchercluster.cluster import ClusterClient as TClient
from goworld_tpu_torch.proto.msgtypes import MsgType as TMsgType

PACKAGES = {
    "jax": (jconsts, JDispatcher, JClient, JMsgType),
    "port": (tconsts, TDispatcher, TClient, TMsgType),
}
SPACE = "S".ljust(16, "0")
BUNDLE = {"space": {"type": "Arena"}, "members": [["M".ljust(16, "0"), {}]]}


class Peer:
    """A fake game endpoint: the packets it receives, by msgtype."""

    def __init__(self):
        self.received = []
        self.event = asyncio.Event()

    def on_packet(self, index, msgtype, packet):
        self.received.append((msgtype, packet))
        self.event.set()

    async def expect(self, msgtype, timeout):
        loop = asyncio.get_running_loop()
        deadline = loop.time() + timeout
        while True:
            for i, (mt, pkt) in enumerate(self.received):
                if mt == msgtype:
                    del self.received[i]
                    return pkt
            remaining = deadline - loop.time()
            if remaining <= 0:
                return None
            self.event.clear()
            try:
                await asyncio.wait_for(self.event.wait(), remaining)
            except asyncio.TimeoutError:
                pass


async def boot(Client, addr, gid, peers, clients):
    """A game that boots cold (neither reconnect nor restore)."""
    peer = Peer()

    def handshake(index, proxy):
        proxy.send_set_game_id(gid, False, False, False, [])

    c = Client([addr], handshake, peer.on_packet)
    c.start()
    await c.wait_connected()
    peers.append(peer)
    clients.append(c)


async def routed_then_target_dies(package: str, ack: bool,
                                  reboot: bool = False):
    """Game 1 hands SPACE to game 2 through one dispatcher; game 2 receives
    the bundle and (``ack``) acknowledges it or not, then its link dies
    and stays dead past the grace window, or (``reboot``) a new game 2
    cold-boots inside the window. Returns what game 1 got back and the
    dispatcher's bounce count."""
    consts, Dispatcher, Client, MsgType = PACKAGES[package]
    disp = Dispatcher(1, desired_games=2, desired_gates=0)
    await disp.start()
    addr = ("127.0.0.1", disp.port)
    peers, clients = [], []
    try:
        for gid in (1, 2):
            await boot(Client, addr, gid, peers, clients)
        while len(disp.games) < 2 or not all(
                gi.connected for gi in disp.games.values()):
            await asyncio.sleep(0.01)
        donor, target = clients
        donor.select(0).send_notify_create_entity(SPACE)
        await asyncio.sleep(0.05)
        donor.select(0).send_space_migrate_data(SPACE, 2, BUNDLE,
                                                source_game=1)
        got = await peers[1].expect(MsgType.SPACE_MIGRATE_DATA, 5.0)
        assert got is not None, "the bundle was not routed to game 2"
        if ack:
            target.select(0).send_space_migrate_ack(SPACE, 2)
            await asyncio.sleep(0.05)
        await target.stop()  # game 2 is gone, its bundle never restored
        if reboot:
            await boot(Client, addr, 2, peers, clients)
            home = await peers[0].expect(MsgType.SPACE_MIGRATE_DATA, 3.0)
            return home, disp.migrates_bounced
        home = await peers[0].expect(
            MsgType.SPACE_MIGRATE_DATA,
            consts.DISPATCHER_RECONNECT_BUFFER_WINDOW + 3.0)
        down = await peers[0].expect(MsgType.NOTIFY_GAME_DISCONNECTED, 3.0)
        assert down is not None, "game 2 was never declared dead"
        return home, disp.migrates_bounced
    finally:
        for c in clients:
            await c.stop()
        await disp.stop()


async def buffered_then_flushed_then_dies(package: str):
    """Game 2's link drops; the bundle arrives inside the grace window and
    is buffered; a new game 2 cold-boots and the flush writes the bundle
    to it; that game dies unacknowledged and stays dead. Returns what
    game 1 got back and the dispatcher's bounce count."""
    consts, Dispatcher, Client, MsgType = PACKAGES[package]
    disp = Dispatcher(1, desired_games=2, desired_gates=0)
    await disp.start()
    addr = ("127.0.0.1", disp.port)
    peers, clients = [], []
    try:
        for gid in (1, 2):
            await boot(Client, addr, gid, peers, clients)
        while len(disp.games) < 2 or not all(
                gi.connected for gi in disp.games.values()):
            await asyncio.sleep(0.01)
        donor = clients[0]
        donor.select(0).send_notify_create_entity(SPACE)
        await clients[1].stop()
        while disp.games[2].connected:
            await asyncio.sleep(0.01)
        donor.select(0).send_space_migrate_data(SPACE, 2, BUNDLE,
                                                source_game=1)
        await asyncio.sleep(0.05)
        await boot(Client, addr, 2, peers, clients)
        got = await peers[2].expect(MsgType.SPACE_MIGRATE_DATA, 5.0)
        assert got is not None, "the flush did not write the bundle"
        await clients[2].stop()
        home = await peers[0].expect(
            MsgType.SPACE_MIGRATE_DATA,
            consts.DISPATCHER_RECONNECT_BUFFER_WINDOW + 3.0)
        return home, disp.migrates_bounced
    finally:
        for c in clients:
            await c.stop()
        await disp.stop()


# Each way an unacknowledged bundle can be left with a dead target, with
# the grace window that scenario needs: the cold boot comes inside it.
SCENARIOS = {
    "dies": (0.3, lambda pkg: routed_then_target_dies(pkg, ack=False)),
    "cold_boots": (30.0, lambda pkg: routed_then_target_dies(
        pkg, ack=False, reboot=True)),
    "buffered_then_dies": (1.0, buffered_then_flushed_then_dies),
}


@pytest.mark.parametrize("scenario", list(SCENARIOS))
@pytest.mark.parametrize("package", ["jax", "port"])
def test_bundle_routed_to_a_target_that_dies_comes_home(package, scenario,
                                                        monkeypatch):
    """The bundle goes home when its target is declared dead, when a new
    target cold-boots under its gameid (no sweep sees that one), and when
    it was buffered for an absent target and written by the flush at the
    target's handshake."""
    consts = PACKAGES[package][0]
    window, play = SCENARIOS[scenario]
    monkeypatch.setattr(consts, "DISPATCHER_RECONNECT_BUFFER_WINDOW", window)
    home, bounced = asyncio.run(asyncio.wait_for(play(package), 30))
    if package == "port":
        assert bounced == 1
        assert home is not None
        assert home.read_entity_id() == SPACE
        assert home.read_uint16() == 2
        assert home.read_data() == BUNDLE
    else:  # the reference loses the space's last copy
        assert bounced == 0 and home is None


@pytest.mark.parametrize("package", ["jax", "port"])
def test_acknowledged_bundle_stays_with_its_target(package, monkeypatch):
    """Once the target acks the restore, the space is the target's: its
    death afterwards bounces nothing home (no second copy)."""
    consts = PACKAGES[package][0]
    monkeypatch.setattr(consts, "DISPATCHER_RECONNECT_BUFFER_WINDOW", 0.3)
    home, bounced = asyncio.run(asyncio.wait_for(
        routed_then_target_dies(package, ack=True), 30))
    assert bounced == 0 and home is None
