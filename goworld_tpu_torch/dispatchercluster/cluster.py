"""Real TCP cluster client: one managed connection per dispatcher.

Reference parity: ``engine/dispatchercluster/dispatcherclient/DispatcherConnMgr.go``
— each game/gate process keeps one auto-reconnecting connection per
dispatcher; on (re)connect it re-sends the handshake (SET_GAME_ID carrying
the live entity list, or SET_GATE_ID), then pumps received packets into the
process's logic queue via the delegate (:66-88,123-147).

Resilience deviations from the reference (the reference drops
packets to dead dispatchers and reconnects on a fixed 1 s interval):

- While a link is down, sends land in a **byte-capped replay ring**
  (``[cluster] down_buffer_bytes``; drop-OLDEST on overflow, counted on
  ``cluster_dropped_packets_total{reason}``) and are replayed on the wire
  right after the reconnect handshake — per-link FIFO order is preserved,
  so a dispatcher restart is lossless up to the byte cap.
- Reconnects back off exponentially with **full jitter** (base
  ``RECONNECT_INTERVAL``, capped at ``[cluster] reconnect_max_interval``)
  instead of hammering a dead address at 1 Hz from every process at once.
- A **liveness watchdog** sends a HEARTBEAT msgtype on idle links (every
  ``peer_heartbeat_timeout / 3``) and hard-aborts a link silent past
  ``[cluster] peer_heartbeat_timeout`` — a half-open TCP connection (peer
  paused, NAT dropped, cable pulled) converts into the reconnect path
  instead of stalling until the OS gives up.
"""

from __future__ import annotations

import asyncio
import collections
import os
import random
import tempfile
import time
from typing import Callable, Deque, Optional, Sequence, Union

from goworld_tpu_torch import consts, telemetry
from goworld_tpu_torch.dispatchercluster import DispatcherClusterBase
from goworld_tpu_torch.netutil.packet import Packet
from goworld_tpu_torch.netutil.packet_conn import ConnectionClosed, PacketConnection
from goworld_tpu_torch.proto.conn import GoWorldConnection
from goworld_tpu_torch.proto.msgtypes import MsgType
from goworld_tpu_torch.utils import gwlog

# A dispatcher endpoint: (host, port) for TCP, or a Unix-domain socket
# path for the co-located uds transport ([cluster] transport = uds) —
# same framing, handshakes, heartbeats, and replay rings either way.
DispatcherAddr = Union[tuple, str]


def uds_path_for(port: int, uds_dir: str = "") -> str:
    """The Unix-socket path a dispatcher with TCP port ``port`` serves
    beside its TCP listener when the uds transport is on. Derived from the
    port (unique per dispatcher by config validation) so games/gates need
    no extra per-dispatcher path configuration; ``uds_dir`` defaults to
    the system temp dir (keep it SHORT — sun_path caps at ~108 bytes)."""
    return os.path.join(
        uds_dir or tempfile.gettempdir(), f"gwt-disp-{port}.sock")


def dispatcher_addrs(cfg) -> list[DispatcherAddr]:
    """The dispatcher endpoints a game/gate should dial, honoring
    [cluster] transport: (host, port) tuples for tcp, socket paths for
    uds (single-host deploys where every process is co-located — the
    topology every bench and the chaos harness actually run)."""
    addrs = [cfg.dispatchers[i].addr for i in sorted(cfg.dispatchers)]
    c = getattr(cfg, "cluster", None)
    if c is not None and getattr(c, "transport", "tcp") == "uds":
        return [uds_path_for(port, c.uds_dir) for _, port in addrs]
    return addrs


# Delegate signature: (dispatcher_index, msgtype, packet) — must be fast/non-blocking.
PacketHandler = Callable[[int, int, Packet], None]
# Handshake factory: given the fresh GoWorldConnection, performs the hello.
# Receives (dispatcher_index, proxy): the game handshake must send each
# dispatcher ONLY the entity ids it owns by hash (the reference's
# GetEntityIDsForDispatcher, DispatcherConnMgr.go:79) — a full list creates
# stale entries on non-owner dispatchers that later REJECT the entity at a
# restore after it migrated (its REAL_MIGRATE only updated the owner).
Handshaker = Callable[[int, GoWorldConnection], None]

# Process-wide counters (one series per reason, not per link — links are
# few but long-lived metrics hygiene matches net_packets_total): "overflow"
# = ring evicted its oldest packet at the byte cap, "oversize" = a single
# packet larger than the whole cap, "disabled" = down_buffer_bytes is 0
# (legacy drop-on-down), "stopped" = packets still buffered when the
# process shut the link down for good.
_DROPPED = telemetry.counter(
    "cluster_dropped_packets_total",
    "Packets to a down dispatcher dropped instead of buffered/replayed.",
    ("reason",))
_REPLAYED = telemetry.counter(
    "cluster_replayed_packets_total",
    "Buffered packets replayed onto a reconnected dispatcher link.")
_RECONNECTS = telemetry.counter(
    "cluster_reconnects_total",
    "Completed dispatcher-link reconnect handshakes (beyond the first).")
_HB_KILLS = telemetry.counter(
    "cluster_link_heartbeat_kills_total",
    "Dispatcher links aborted for silence past peer_heartbeat_timeout.")


class _ReplayRing:
    """Byte-capped FIFO of (msgtype, payload) awaiting a reconnect.

    Drop-OLDEST on overflow: the freshest state (position syncs, latest
    attr changes) survives, and the ring can never stall a reconnect — a
    flush is at most ``cap`` bytes."""

    __slots__ = ("cap", "nbytes", "_buf")

    def __init__(self, cap: int) -> None:
        self.cap = cap
        self.nbytes = 0
        self._buf: Deque[tuple[int, bytes]] = collections.deque()

    def __len__(self) -> int:
        return len(self._buf)

    def push(self, msgtype: int, payload: bytes) -> None:
        if self.cap <= 0:
            _DROPPED.labels("disabled").inc()
            return
        if len(payload) > self.cap:
            _DROPPED.labels("oversize").inc()
            return
        self._buf.append((msgtype, payload))
        self.nbytes += len(payload)
        while self.nbytes > self.cap:
            _, old = self._buf.popleft()
            self.nbytes -= len(old)
            _DROPPED.labels("overflow").inc()

    def drain(self) -> Deque[tuple[int, bytes]]:
        buf = self._buf
        self._buf = collections.deque()
        self.nbytes = 0
        return buf


class _RingConn:
    """PacketConnection stand-in that captures typed sends into the ring.

    Wrapping it in a GoWorldConnection gives the full send_* surface for
    free, so the buffering sender stays layout-identical to a live link
    (the wire counters in proto/conn.py count a packet exactly once, at
    buffer time — the replay writes at the PacketConnection layer)."""

    closed = False

    def __init__(self, ring: _ReplayRing) -> None:
        self._ring = ring

    def send_packet(self, msgtype: int, packet: Packet) -> None:
        self._ring.push(msgtype, packet.payload)

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


class DispatcherConnMgr:
    """Managed connection to one dispatcher with auto-reconnect."""

    def __init__(
        self,
        index: int,
        addr: DispatcherAddr,
        handshake: Handshaker,
        on_packet: PacketHandler,
        on_disconnect: Optional[Callable[[int], None]] = None,
        *,
        down_buffer_bytes: Optional[int] = None,
        peer_heartbeat_timeout: Optional[float] = None,
        wait_connected_timeout: Optional[float] = None,
        reconnect_max_interval: Optional[float] = None,
    ) -> None:
        self.index = index
        self.addr = addr
        self._handshake = handshake
        self._on_packet = on_packet
        self._on_disconnect = on_disconnect
        self.down_buffer_bytes = (
            consts.CLUSTER_DOWN_BUFFER_BYTES
            if down_buffer_bytes is None else down_buffer_bytes)
        self.peer_heartbeat_timeout = (
            consts.CLUSTER_PEER_HEARTBEAT_TIMEOUT
            if peer_heartbeat_timeout is None else peer_heartbeat_timeout)
        self.wait_connected_timeout = (
            consts.CLUSTER_WAIT_CONNECTED_TIMEOUT
            if wait_connected_timeout is None else wait_connected_timeout)
        self.reconnect_max_interval = (
            consts.RECONNECT_INTERVAL_MAX
            if reconnect_max_interval is None else reconnect_max_interval)
        self.proxy: Optional[GoWorldConnection] = None
        self.ring = _ReplayRing(self.down_buffer_bytes)
        # trace_wire also on the buffering sender: a sampled packet parked
        # in the ring keeps its trailer and replays with the SAME trace id
        # after the reconnect — the outage shows as dispatcher queue-dwell
        # in the merged timeline, not as a lost trace.
        self._buffer_sender = GoWorldConnection(
            _RingConn(self.ring), trace_wire=True)
        self._task: Optional[asyncio.Task] = None
        self._stopped = False
        self._connected_event = asyncio.Event()
        self._connect_count = 0
        self._last_recv = 0.0

    @property
    def sender(self) -> GoWorldConnection:
        """The live link, or the ring-backed buffering sender while down."""
        proxy = self.proxy
        return proxy if proxy is not None else self._buffer_sender

    def _addr_str(self) -> str:
        addr = self.addr
        return addr if isinstance(addr, str) else f"{addr[0]}:{addr[1]}"

    async def _open(self):
        """Dial the dispatcher over whichever transport the address names
        (uds paths and tcp tuples yield the same stream pair — everything
        above this call is transport-blind)."""
        if isinstance(self.addr, str):
            return await asyncio.open_unix_connection(self.addr)
        return await asyncio.open_connection(*self.addr)

    def link_state(self) -> dict:
        """One JSON-able row for /healthz: link up?, last-seen age,
        packets parked in the replay ring."""
        up = self.proxy is not None
        return {
            "index": self.index,
            "addr": self._addr_str(),
            "connected": up,
            "last_seen_age_s": (
                round(time.monotonic() - self._last_recv, 3)
                if self._last_recv else None),
            "buffered_packets": len(self.ring),
            "connects": self._connect_count,
        }

    def start(self) -> None:
        self._task = asyncio.get_running_loop().create_task(self._run())

    async def wait_connected(self, timeout: Optional[float] = None) -> None:
        t = self.wait_connected_timeout if timeout is None else timeout
        try:
            await asyncio.wait_for(self._connected_event.wait(), t)
        except asyncio.TimeoutError:
            raise TimeoutError(
                f"dispatcher {self.index} at {self._addr_str()} "
                f"not connected after {t:.1f}s (reconnect keeps retrying in "
                f"the background)"
            ) from None

    def _backoff_delay(self, attempt: int) -> float:
        """Exponential backoff with FULL jitter: uniform(0, min(cap,
        base * 2^attempt)) — spreads the post-restart thundering herd of
        every game/gate reconnecting at once."""
        ceiling = min(
            self.reconnect_max_interval,
            consts.RECONNECT_INTERVAL * (2.0 ** min(attempt, 16)),
        )
        return random.uniform(0, ceiling)

    def _flush_ring(self, proxy: GoWorldConnection) -> None:
        """Replay buffered sends right after the reconnect handshake, in
        FIFO order, at the PacketConnection layer (already counted on the
        wire totals when they entered the ring)."""
        buf = self.ring.drain()
        if not buf:
            return
        n, nbytes = len(buf), 0
        for msgtype, payload in buf:
            nbytes += len(payload)
            proxy.conn.send_packet(msgtype, Packet(payload))
        _REPLAYED.inc(n)
        gwlog.infof(
            "dispatcher conn %d: replayed %d buffered packets (%d bytes) "
            "after reconnect", self.index, n, nbytes)

    async def _heartbeat_loop(self, proxy: GoWorldConnection) -> None:
        """Send HEARTBEAT on an idle link; abort a link silent past the
        deadline so the recv pump converts it into the reconnect path."""
        timeout = self.peer_heartbeat_timeout
        interval = max(0.05, timeout / 3.0)
        mark = proxy.conn.sent_packets
        while True:
            await asyncio.sleep(interval)
            now = time.monotonic()
            if now - self._last_recv > timeout:
                gwlog.warnf(
                    "dispatcher conn %d: peer silent for %.1fs "
                    "(> %.1fs heartbeat deadline); aborting half-open link",
                    self.index, now - self._last_recv, timeout)
                _HB_KILLS.inc()
                proxy.conn.abort()
                return
            if proxy.conn.sent_packets == mark:
                proxy.send_cluster_heartbeat()
            mark = proxy.conn.sent_packets

    async def _run(self) -> None:
        """Connect → handshake → ring replay → recv pump; repeat forever
        with jittered backoff (DispatcherConnMgr.go:66-147)."""
        attempt = 0
        while not self._stopped:
            try:
                reader, writer = await self._open()
            except OSError:
                await asyncio.sleep(self._backoff_delay(attempt))
                attempt += 1
                continue
            proxy = GoWorldConnection(
                PacketConnection(reader, writer), trace_wire=True)
            hb_task: Optional[asyncio.Task] = None
            try:
                self._handshake(self.index, proxy)
                # Publish the live proxy only after the handshake is queued
                # and the ring is replayed behind it, so no concurrent send
                # can overtake either.
                self._flush_ring(proxy)
                self.proxy = proxy
                self._connected_event.set()
                attempt = 0
                self._connect_count += 1
                if self._connect_count > 1:
                    _RECONNECTS.inc()
                self._last_recv = time.monotonic()
                if self.peer_heartbeat_timeout > 0:
                    hb_task = asyncio.get_running_loop().create_task(
                        self._heartbeat_loop(proxy))
                while True:
                    msgtype, packet = await proxy.recv()
                    self._last_recv = time.monotonic()
                    if msgtype == MsgType.HEARTBEAT:
                        continue  # liveness only; never routed to logic
                    self._on_packet(self.index, msgtype, packet)
            except ConnectionClosed:
                pass
            except Exception:
                gwlog.trace_error("dispatcher conn %d: recv pump error", self.index)
            finally:
                self.proxy = None
                self._connected_event.clear()
                if hb_task is not None:
                    hb_task.cancel()
                    try:
                        await hb_task
                    except (asyncio.CancelledError, Exception):
                        pass
                proxy.close()
                if self._on_disconnect is not None and not self._stopped:
                    self._on_disconnect(self.index)
            if not self._stopped:
                gwlog.warnf(
                    "dispatcher conn %d lost; reconnecting (sends buffer up "
                    "to %d bytes)", self.index, self.down_buffer_bytes)
                await asyncio.sleep(self._backoff_delay(attempt))
                attempt += 1

    async def stop(self) -> None:
        self._stopped = True
        if self.proxy is not None:
            # Drain before close: the process exits right after stop() during
            # freeze/terminate, and packets still in the asyncio transport
            # buffer would be silently dropped — including REAL_MIGRATE of an
            # avatar that just migrated out, which then exists on NO game.
            try:
                await asyncio.wait_for(
                    self.proxy.conn.drain(hard=True), timeout=5.0
                )
            except Exception:
                pass  # peer already gone; nothing to preserve
            self.proxy.close()
        if len(self.ring):
            # Buffered sends die with the process — visible, not silent.
            _DROPPED.labels("stopped").inc(len(self.ring))
            self.ring.drain()
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, Exception):
                pass


def cluster_knobs(cfg) -> dict:
    """ClusterClient kwargs from a GoWorldConfig's [cluster] section."""
    c = getattr(cfg, "cluster", None)
    if c is None:
        return {}
    return dict(
        down_buffer_bytes=c.down_buffer_bytes,
        peer_heartbeat_timeout=c.peer_heartbeat_timeout,
        wait_connected_timeout=c.wait_connected_timeout,
        reconnect_max_interval=c.reconnect_max_interval,
    )


class ClusterClient(DispatcherClusterBase):
    """The process-wide dispatcher fabric client (dispatchercluster.go:18-37)."""

    def __init__(
        self,
        addrs: Sequence[DispatcherAddr],
        handshake: Handshaker,
        on_packet: PacketHandler,
        on_disconnect: Optional[Callable[[int], None]] = None,
        **knobs,
    ) -> None:
        self._mgrs = [
            DispatcherConnMgr(i, addr, handshake, on_packet, on_disconnect,
                              **knobs)
            for i, addr in enumerate(addrs)
        ]

    def start(self) -> None:
        for m in self._mgrs:
            m.start()

    async def wait_connected(self, timeout: Optional[float] = None) -> None:
        await asyncio.gather(*(m.wait_connected(timeout) for m in self._mgrs))

    async def stop(self) -> None:
        await asyncio.gather(*(m.stop() for m in self._mgrs))

    # --- DispatcherClusterBase ----------------------------------------------

    def select(self, idx: int):
        """The live link for dispatcher ``idx``, or its ring-buffering
        sender while the link is down (drop-on-down is gone: sends survive
        a dispatcher restart up to the ring's byte cap)."""
        return self._mgrs[idx].sender

    def count(self) -> int:
        return len(self._mgrs)

    def link_states(self) -> list[dict]:
        """Per-dispatcher link health rows (GET /healthz)."""
        return [m.link_state() for m in self._mgrs]

    def flush_all(self) -> None:
        for m in self._mgrs:
            if m.proxy is not None:
                m.proxy.flush()
