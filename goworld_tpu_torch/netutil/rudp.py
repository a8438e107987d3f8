"""Reliable-UDP client transport, from scratch (the reference's KCP slot).

Reference parity: the gate serves KCP (reliable UDP) on the same address as
TCP with turbo-mode tuning (``components/gate/GateService.go:134-165``,
``engine/consts/consts.go:122-131`` via xtaci/kcp-go). No ARQ library
exists in this image, so this is an in-repo equivalent (SURVEY.md §2.4
rule): a conversation-id + seq/ack + retransmit-timer protocol carrying
the same framed packet stream as TCP.

Wire format (one datagram per segment, 13-byte header):

    [u32 conv][u8 cmd][u32 seq][u32 ack]  + payload (DATA only)

- ``conv``: connection id, chosen by the client (kcp conversation id).
- DATA(1): ``seq`` = segment number; payload = next MSS-sized slice of the
  byte stream. The receiver reassembles in segment order and parses the
  TCP framing ([u32 len][u16 msgtype][payload]) from the ordered stream.
- ACK(2): ``ack`` = cumulative next-expected segment; ``seq`` = the
  segment that triggered this ack (a 1-slot SACK so the sender can drop
  out-of-order-received segments immediately).
- FIN(3): graceful close.

Loss recovery (KCP turbo parity, ``engine/consts/consts.go:122-131``):

- **Adaptive RTO** (Jacobson/Karels with Karn's rule): RTT is sampled from
  acks of segments transmitted exactly once; ``rto = srtt +
  max(tick, 4*rttvar)``, clamped to [30 ms, 1 s] (the 30 ms floor is KCP's
  nodelay minimum). Timeout backoff is the nodelay ×1.5, not the vanilla
  ×2 (KCP_NO_DELAY=1).
- **Fast resend** (KCP_ENABLE_FAST_RESEND=2): every ack counts, for each
  older in-flight segment, how many times it was "skipped"; at 2 skips the
  segment retransmits immediately without waiting its RTO.
- **Congestion control is OFF by default** (KCP_DISABLE_CONGESTION_CONTROL
  = 1, turbo nc mode): the window is the fixed SEND_WINDOW. Passing
  ``congestion=True`` enables slow-start/AIMD for adverse networks.

A 10 ms tick (turbo interval) drives timeouts. In-flight is windowed;
senders buffer beyond the window and evict the connection if the backlog
exceeds MAX_BACKLOG (the WS transport's stalled-client policy).
``loss_simulation`` drops outgoing datagrams randomly — the e2e tests'
induced-loss knob.
"""

from __future__ import annotations

import asyncio
import random
import struct
from typing import Callable, Optional

from goworld_tpu_torch import consts, native
from goworld_tpu_torch.netutil.packet import Packet
from goworld_tpu_torch.netutil.packet_conn import (
    _COMPRESS_THRESHOLD, ConnectionClosed,
)

_HDR = struct.Struct("<IBII")
CMD_DATA = 1
CMD_ACK = 2
CMD_FIN = 3

MSS = 1200  # payload bytes per segment (under common 1500 MTU)
TICK_INTERVAL = 0.01  # 10 ms retransmit cadence (KCP turbo interval)
RTO_INIT = 0.05  # before the first RTT sample lands
RTO_MIN = 0.03  # KCP nodelay floor
RTO_MAX = 1.0
RTO_BACKOFF = 1.5  # nodelay-mode timeout growth (vanilla KCP doubles)
FAST_RESEND = 2  # KCP_ENABLE_FAST_RESEND: skipped-by-2-acks → retransmit
SEND_WINDOW = 256  # in-flight segments (flow-control cap)
MAX_BACKLOG = 65536  # queued segments beyond the window → evict
NO_SACK = 0xFFFFFFFF


class RUDPEndpoint:
    """One reliable conversation over a datagram ``transmit`` callable."""

    def __init__(
        self,
        conv: int,
        transmit: Callable[[bytes], None],
        on_close: Optional[Callable[["RUDPEndpoint"], None]] = None,
        congestion: bool = False,  # default = KCP turbo nc=1 (off)
    ) -> None:
        self.conv = conv
        self._transmit = transmit
        self._on_close = on_close
        self.closed = False
        self.loss_simulation = 0.0  # outgoing drop probability (tests)
        self._rng = random.Random(conv)
        # send side: seq → [bytes, deadline, rto, sent_time, xmits, fastack]
        self._snd_nxt = 0
        self._unacked: dict[int, list] = {}
        self._backlog: list[tuple[int, bytes]] = []  # beyond the window
        # RTT estimator (Jacobson/Karels; Karn's rule via xmits == 1)
        self.srtt = 0.0
        self.rttvar = 0.0
        self.rto = RTO_INIT
        # congestion (disabled by default, KCP_DISABLE_CONGESTION_CONTROL=1)
        self._congestion = congestion
        self._cwnd = 2.0
        self._ssthresh = float(SEND_WINDOW)
        self.fast_resends = 0  # diagnostics
        self.timeout_resends = 0
        # recv side
        self._rcv_nxt = 0
        self._ooo: dict[int, bytes] = {}  # out-of-order segments
        self._instream = bytearray()  # ordered byte stream, unparsed
        self._packets: asyncio.Queue = asyncio.Queue()  # parsed (msgtype, Packet)
        self._ticker = asyncio.get_running_loop().create_task(self._tick_loop())
        self.dropped = 0

    # --- datagram out -------------------------------------------------------

    def _raw_send(self, data: bytes) -> None:
        if self.loss_simulation and self._rng.random() < self.loss_simulation:
            return  # simulated network loss
        try:
            self._transmit(data)
        except OSError:
            pass  # datagram sends are best-effort; ARQ recovers

    def _send_segment(self, seq: int, payload: bytes) -> None:
        self._raw_send(
            _HDR.pack(self.conv, CMD_DATA, seq, self._rcv_nxt) + payload
        )

    def _send_ack(self, sacked: int) -> None:
        self._raw_send(_HDR.pack(self.conv, CMD_ACK, sacked, self._rcv_nxt))

    # --- public send --------------------------------------------------------

    def _window(self) -> int:
        """Effective in-flight cap: flow window, AND the congestion window
        when congestion control is on (off by default, turbo nc mode)."""
        if not self._congestion:
            return SEND_WINDOW
        return max(1, min(SEND_WINDOW, int(self._cwnd)))

    def send_bytes(self, data: bytes) -> None:
        """Queue bytes onto the reliable stream (split into MSS segments)."""
        if self.closed:
            self.dropped += 1
            return
        now = asyncio.get_running_loop().time()
        for off in range(0, len(data), MSS):
            seg = bytes(data[off:off + MSS])
            seq = self._snd_nxt
            self._snd_nxt += 1
            if len(self._unacked) < self._window():
                self._unacked[seq] = [seg, now + self.rto, self.rto, now, 1, 0]
                self._send_segment(seq, seg)
            else:
                self._backlog.append((seq, seg))
                if len(self._backlog) > MAX_BACKLOG:
                    self.close()  # stalled peer: evict
                    return

    # --- datagram in --------------------------------------------------------

    def on_datagram(self, cmd: int, seq: int, ack: int, payload: bytes) -> None:
        if self.closed:
            return
        # Every packet carries the peer's cumulative ack.
        self._apply_ack(ack)
        if cmd == CMD_DATA:
            if seq >= self._rcv_nxt and seq not in self._ooo:
                self._ooo[seq] = payload
                while self._rcv_nxt in self._ooo:
                    self._instream += self._ooo.pop(self._rcv_nxt)
                    self._rcv_nxt += 1
                self._parse_stream()
            self._send_ack(seq)
        elif cmd == CMD_ACK:
            if seq != NO_SACK:
                self._ack_one(seq)
                self._fast_ack(seq)
                self._refill_window()
        elif cmd == CMD_FIN:
            self.close(send_fin=False)

    def _ack_one(self, seq: int) -> None:
        """Retire one acked segment, sampling RTT per Karn's rule (only
        segments transmitted exactly once give unambiguous samples)."""
        ent = self._unacked.pop(seq, None)
        if ent is None:
            return
        if ent[4] == 1:
            rtt = asyncio.get_running_loop().time() - ent[3]
            if self.srtt == 0.0:
                self.srtt = rtt
                self.rttvar = rtt / 2.0
            else:
                self.rttvar = 0.75 * self.rttvar + 0.25 * abs(self.srtt - rtt)
                self.srtt = 0.875 * self.srtt + 0.125 * rtt
            self.rto = min(
                max(self.srtt + max(TICK_INTERVAL, 4.0 * self.rttvar),
                    RTO_MIN),
                RTO_MAX,
            )
        if self._congestion:  # slow start, then AIMD growth
            self._cwnd += 1.0 if self._cwnd < self._ssthresh else 1.0 / self._cwnd

    def _apply_ack(self, ack: int) -> None:
        if not self._unacked:
            return
        for seq in [s for s in self._unacked if s < ack]:
            self._ack_one(seq)
        # No _fast_ack here: a cumulative ack retires EVERY older segment,
        # so nothing in flight can have been skipped by it; skips are only
        # observable via the SACK seq on CMD_ACK.
        self._refill_window()

    def _fast_ack(self, acked: int) -> None:
        """KCP fast resend: segments older than an acked seq were 'skipped'
        by that ack; at FAST_RESEND skips, retransmit immediately instead of
        waiting for the RTO."""
        ripe = []
        for seq, ent in self._unacked.items():
            if seq < acked:
                ent[5] += 1
                if ent[5] >= FAST_RESEND:
                    ripe.append(seq)
        if not ripe:
            return
        now = asyncio.get_running_loop().time()
        for seq in sorted(ripe):
            ent = self._unacked[seq]
            ent[5] = 0
            ent[4] += 1
            ent[1] = now + ent[2]  # deadline pushed; rto unchanged
            self.fast_resends += 1
            self._send_segment(seq, ent[0])
        if self._congestion:
            inflight = len(self._unacked)
            self._ssthresh = max(inflight / 2.0, 2.0)
            self._cwnd = self._ssthresh + FAST_RESEND

    def _refill_window(self) -> None:
        now = asyncio.get_running_loop().time()
        while self._backlog and len(self._unacked) < self._window():
            seq, seg = self._backlog.pop(0)
            self._unacked[seq] = [seg, now + self.rto, self.rto, now, 1, 0]
            self._send_segment(seq, seg)

    def _parse_stream(self) -> None:
        """Parse [u32 len][u16 msgtype][payload] frames (TCP framing) out of
        the ordered stream — the shared batched deframe seam
        (packet_conn.deframe), with the same bounded-inflate guard as the
        TCP path."""
        from goworld_tpu_torch.netutil.packet_conn import deframe

        frames, err = deframe(self._instream)
        for msgtype, payload in frames:
            self._packets.put_nowait((msgtype, Packet(payload)))
        if err is not None:
            self.close()  # malformed stream (frames before it delivered)

    # --- retransmit ---------------------------------------------------------

    async def _tick_loop(self) -> None:
        try:
            while not self.closed:
                await asyncio.sleep(TICK_INTERVAL)
                now = asyncio.get_running_loop().time()
                timed_out = False
                for seq, ent in self._unacked.items():
                    if now >= ent[1]:
                        ent[2] = min(ent[2] * RTO_BACKOFF, RTO_MAX)
                        ent[1] = now + ent[2]
                        ent[4] += 1
                        ent[5] = 0
                        timed_out = True
                        self.timeout_resends += 1
                        self._send_segment(seq, ent[0])
                if timed_out and self._congestion:
                    self._ssthresh = max(len(self._unacked) / 2.0, 2.0)
                    self._cwnd = 1.0
        except asyncio.CancelledError:
            pass

    # --- recv / close -------------------------------------------------------

    async def recv_packet(self) -> tuple[int, Packet]:
        item = await self._packets.get()
        if item is None:
            raise ConnectionClosed("rudp closed")
        return item

    def close(self, send_fin: bool = True) -> None:
        if self.closed:
            return
        self.closed = True
        if send_fin:
            self._raw_send(_HDR.pack(self.conv, CMD_FIN, 0, self._rcv_nxt))
        self._ticker.cancel()
        self._packets.put_nowait(None)  # wake pending recv
        if self._on_close is not None:
            self._on_close(self)


class RUDPPacketConnection:
    """PacketConnection-shaped adapter over an RUDPEndpoint (the surface
    GoWorldConnection needs; see netutil/ws_conn.py for the pattern)."""

    def __init__(self, endpoint: RUDPEndpoint, peername=None) -> None:
        self._ep = endpoint
        self._peername = peername
        self._compress = 0  # 0 off | 1 zlib | 2 snappy (native.pack modes)

    @property
    def peername(self):
        return self._peername

    @property
    def dropped(self) -> int:
        return self._ep.dropped

    def enable_compression(self, fmt: str = "snappy") -> None:
        """Same contract as PacketConnection.enable_compression (recv
        auto-detects per packet via the length-prefix flag bits)."""
        if fmt not in ("snappy", "zlib"):
            raise ValueError(f"unknown compression format {fmt!r}")
        self._compress = 2 if fmt == "snappy" else 1

    def send_packet(self, msgtype: int, packet: Packet) -> None:
        self._ep.send_bytes(
            native.pack(
                msgtype, packet.payload, self._compress,
                _COMPRESS_THRESHOLD,
                consts.MAX_PACKET_SIZE,
            )
        )

    def flush(self) -> None:
        pass  # segments transmit immediately; ARQ handles the rest

    async def drain(self, hard: bool = False) -> None:
        if hard:
            # Best-effort: wait briefly for the peer to ack everything.
            for _ in range(50):
                if not self._ep._unacked and not self._ep._backlog:
                    return
                await asyncio.sleep(TICK_INTERVAL)

    async def recv_packet(self) -> tuple[int, Packet]:
        return await self._ep.recv_packet()

    def close(self) -> None:
        self._ep.close()

    @property
    def closed(self) -> bool:
        return self._ep.closed


class RUDPListener(asyncio.DatagramProtocol):
    """Server side: one UDP socket on the gate's port; conversations keyed
    by conv id (GateService.go:134-165 serves KCP beside TCP the same way).
    ``on_accept(pconn)`` fires for each new conversation."""

    def __init__(
        self,
        on_accept: Callable[[RUDPPacketConnection], None],
        congestion: bool = False,
    ) -> None:
        self._on_accept = on_accept
        self._congestion = congestion
        self._transport: Optional[asyncio.DatagramTransport] = None
        self._convs: dict[int, RUDPEndpoint] = {}
        self._addrs: dict[int, tuple] = {}
        self.loss_simulation = 0.0  # applied to newly accepted conversations

    def connection_made(self, transport) -> None:
        self._transport = transport

    def datagram_received(self, data: bytes, addr) -> None:
        if len(data) < _HDR.size:
            return
        conv, cmd, seq, ack = _HDR.unpack_from(data, 0)
        ep = self._convs.get(conv)
        if ep is None:
            if cmd != CMD_DATA:
                return  # stray ack/fin for a dead conversation
            ep = RUDPEndpoint(
                conv,
                lambda d, c=conv: self._send_to(c, d),
                on_close=lambda e: self._forget(e.conv),
                congestion=self._congestion,
            )
            ep.loss_simulation = self.loss_simulation
            self._convs[conv] = ep
            self._addrs[conv] = addr
            self._on_accept(RUDPPacketConnection(ep, peername=addr))
        # Peer address may roam (kcp allows it): track the latest source.
        self._addrs[conv] = addr
        ep.on_datagram(cmd, seq, ack, data[_HDR.size:])

    def _send_to(self, conv: int, data: bytes) -> None:
        addr = self._addrs.get(conv)
        if self._transport is not None and addr is not None:
            self._transport.sendto(data, addr)

    def _forget(self, conv: int) -> None:
        self._convs.pop(conv, None)
        self._addrs.pop(conv, None)

    def close(self) -> None:
        for ep in list(self._convs.values()):
            ep.close()
        if self._transport is not None:
            self._transport.close()


class _RUDPClientProtocol(asyncio.DatagramProtocol):
    def __init__(self, endpoint_ref: list) -> None:
        self._ref = endpoint_ref

    def datagram_received(self, data: bytes, addr) -> None:
        ep = self._ref[0]
        if ep is None or len(data) < _HDR.size:
            return
        conv, cmd, seq, ack = _HDR.unpack_from(data, 0)
        if conv == ep.conv:
            ep.on_datagram(cmd, seq, ack, data[_HDR.size:])


async def connect_rudp(
    host: str, port: int, loss_simulation: float = 0.0,
    congestion: bool = False,
) -> RUDPPacketConnection:
    """Client side: open a UDP flow and return a PacketConnection-shaped
    transport (conversation id chosen randomly, kcp style). ``congestion``
    enables slow-start/AIMD for adverse networks (default matches the
    reference's turbo nc=1: off)."""
    loop = asyncio.get_running_loop()
    ref: list = [None]
    transport, _ = await loop.create_datagram_endpoint(
        lambda: _RUDPClientProtocol(ref), remote_addr=(host, port)
    )
    conv = random.getrandbits(32) or 1
    ep = RUDPEndpoint(
        conv,
        transport.sendto,
        on_close=lambda e: transport.close(),
        congestion=congestion,
    )
    ep.loss_simulation = loss_simulation
    ref[0] = ep
    return RUDPPacketConnection(ep, peername=(host, port))
