"""KCP — the actual public ARQ protocol the reference's gate speaks.

Reference parity: the gate serves KCP beside TCP with turbo tuning
(``components/gate/GateService.go:134-165`` via xtaci/kcp-go;
``engine/consts/consts.go:122-131``: nodelay=1, interval=10 ms,
fastresend=2, nc=1, stream mode, ack-no-delay). ``netutil/rudp.py`` is the
in-repo ARQ with KCP-*parity recovery behavior* but its own 13-byte wire
format; THIS module implements the real KCP wire protocol from the public
specification (skywind3000/kcp), so a stock KCP peer can interoperate at
the segment level.

Wire format (all little-endian; one UDP datagram carries >= 1 segments):

    [u32 conv][u8 cmd][u8 frg][u16 wnd][u32 ts][u32 sn][u32 una][u32 len]
    + len payload bytes                                   (24-byte header)

  cmd: 81 PUSH (data) | 82 ACK | 83 WASK (window probe) | 84 WINS (tell)
  frg: fragment countdown (stream mode always 0)
  wnd: sender's free receive-window slots;  una: next sn not yet received
  ts/sn: timestamp (ms) and sequence number — acks echo both

Protocol mechanics implemented exactly per the spec: cumulative una +
per-sn acks, fast retransmit on skip-count (fastresend), Jacobson/Karels
RTO with the 30 ms nodelay floor and nodelay x1.5 backoff, remote-window
tracking with zero-window probes (WASK/WINS with 7 s..120 s probe
backoff), slow-start/congestion-avoidance gated by nc, fragment
reassembly, dead-link detection at 20 transmissions of one segment.

No in-image KCP library or Go toolchain exists to cross-test against, so
the format is pinned the same way the snappy codec is: hand-computed
segment vectors in tests/test_kcp.py plus loss-matrix behavioral gates.
"""

from __future__ import annotations

import asyncio
import collections
import random
import struct
import time
from typing import Callable, Optional

from goworld_tpu_torch import consts as gwconsts
from goworld_tpu_torch import native
from goworld_tpu_torch.netutil.packet import Packet
from goworld_tpu_torch.netutil.packet_conn import ConnectionClosed

# Protocol constants (public KCP spec values).
RTO_NDL = 30  # nodelay min rto
RTO_MIN = 100
RTO_DEF = 200
RTO_MAX = 60000
CMD_PUSH = 81
CMD_ACK = 82
CMD_WASK = 83
CMD_WINS = 84
ASK_SEND = 1  # need to send WASK
ASK_TELL = 2  # need to send WINS
WND_SND = 32
WND_RCV = 128
MTU_DEF = 1400
INTERVAL_DEF = 100
OVERHEAD = 24
DEADLINK = 20
THRESH_INIT = 2
THRESH_MIN = 2
PROBE_INIT = 7000  # 7 s initial window-probe wait
PROBE_LIMIT = 120000  # 120 s max probe wait

_SEG_HDR = struct.Struct("<IBBHIII")  # conv cmd frg wnd ts sn una (+len u32)


def _itimediff(later: int, earlier: int) -> int:
    """Signed difference of two u32 millisecond clocks (wraps at 2^32)."""
    return ((later - earlier + 0x80000000) & 0xFFFFFFFF) - 0x80000000


class _Segment:
    __slots__ = ("conv", "cmd", "frg", "wnd", "ts", "sn", "una",
                 "resendts", "rto", "fastack", "xmit", "data")

    def __init__(self, data: bytes = b"") -> None:
        self.conv = 0
        self.cmd = 0
        self.frg = 0
        self.wnd = 0
        self.ts = 0
        self.sn = 0
        self.una = 0
        self.resendts = 0
        self.rto = 0
        self.fastack = 0
        self.xmit = 0
        self.data = data

    def encode(self) -> bytes:
        return _SEG_HDR.pack(self.conv, self.cmd, self.frg, self.wnd,
                             self.ts, self.sn, self.una) + struct.pack(
                                 "<I", len(self.data))


class KCP:
    """The KCP control block (protocol core; transport-agnostic).

    ``output(data)`` is called with ready-to-send datagrams (<= mtu).
    Drive with ``update(ms)`` at the configured interval and feed received
    datagrams to ``input(data)``. ``send``/``recv`` move user bytes.
    """

    def __init__(self, conv: int, output: Callable[[bytes], None]) -> None:
        self.conv = conv & 0xFFFFFFFF
        self.output = output
        self.snd_una = 0
        self.snd_nxt = 0
        self.rcv_nxt = 0
        self.ts_recent = 0
        self.ts_lastack = 0
        self.ssthresh = THRESH_INIT
        self.rx_rttval = 0
        self.rx_srtt = 0
        self.rx_rto = RTO_DEF
        self.rx_minrto = RTO_MIN
        self.snd_wnd = WND_SND
        self.rcv_wnd = WND_RCV
        self.rmt_wnd = WND_RCV
        self.cwnd = 0
        self.probe = 0
        self.mtu = MTU_DEF
        self.mss = self.mtu - OVERHEAD
        self.stream = False
        self.interval = INTERVAL_DEF
        self.ts_flush = INTERVAL_DEF
        self.nodelay = 0
        self.updated = False
        self.ts_probe = 0
        self.probe_wait = 0
        self.dead_link = DEADLINK
        self.incr = 0
        self.state = 0  # -1 once a segment hit dead_link transmissions
        self.current = 0
        self.nocwnd = 0
        self.fastresend = 0
        self.snd_queue: collections.deque[_Segment] = collections.deque()
        self.rcv_queue: collections.deque[_Segment] = collections.deque()
        self.snd_buf: collections.deque[_Segment] = collections.deque()
        self.rcv_buf: list[_Segment] = []  # kept sn-sorted
        self.acklist: list[tuple[int, int]] = []  # (sn, ts)
        self.xmit = 0

    # --- configuration ------------------------------------------------------

    def set_nodelay(self, nodelay: int, interval: int, resend: int,
                    nc: int) -> None:
        """The turbo knob quartet (reference: SetNoDelay(1, 10, 2, 1))."""
        if nodelay >= 0:
            self.nodelay = nodelay
            self.rx_minrto = RTO_NDL if nodelay else RTO_MIN
        if interval >= 0:
            self.interval = max(10, min(5000, interval))
        if resend >= 0:
            self.fastresend = resend
        if nc >= 0:
            self.nocwnd = nc

    def set_wndsize(self, sndwnd: int, rcvwnd: int) -> None:
        if sndwnd > 0:
            self.snd_wnd = sndwnd
        if rcvwnd > 0:
            self.rcv_wnd = max(rcvwnd, WND_RCV)

    def set_mtu(self, mtu: int) -> None:
        if mtu < 50 or mtu < OVERHEAD:
            raise ValueError("mtu too small")
        self.mtu = mtu
        self.mss = mtu - OVERHEAD

    # --- user data ----------------------------------------------------------

    def send(self, buffer: bytes) -> int:
        """Queue user bytes (stream mode coalesces into the tail segment;
        message mode fragments with frg countdown)."""
        if not buffer and not self.stream:
            return -1
        if self.stream and self.snd_queue:
            tail = self.snd_queue[-1]
            if len(tail.data) < self.mss:
                room = self.mss - len(tail.data)
                take = min(room, len(buffer))
                tail.data += buffer[:take]
                tail.frg = 0
                buffer = buffer[take:]
        if not buffer:
            return 0
        count = (len(buffer) + self.mss - 1) // self.mss
        if count == 0:
            count = 1
        if count >= WND_RCV:
            return -2  # unfragmentable against the protocol's frg field
        for i in range(count):
            seg = _Segment(buffer[i * self.mss:(i + 1) * self.mss])
            seg.frg = 0 if self.stream else (count - i - 1)
            self.snd_queue.append(seg)
        return 0

    def peeksize(self) -> int:
        if not self.rcv_queue:
            return -1
        seg = self.rcv_queue[0]
        if seg.frg == 0:
            return len(seg.data)
        if len(self.rcv_queue) < seg.frg + 1:
            return -1
        length = 0
        for s in self.rcv_queue:
            length += len(s.data)
            if s.frg == 0:
                break
        return length

    def recv(self) -> bytes | None:
        """One reassembled message (or stream chunk), or None."""
        if self.peeksize() < 0:
            return None
        recover = len(self.rcv_queue) >= self.rcv_wnd
        out = []
        while self.rcv_queue:
            seg = self.rcv_queue.popleft()
            out.append(seg.data)
            if seg.frg == 0:
                break
        self._move_rcv_buf()
        if (len(self.rcv_queue) < self.rcv_wnd) and recover:
            self.probe |= ASK_TELL  # window reopened: tell the peer
        return b"".join(out)

    # --- input path ---------------------------------------------------------

    def _update_ack(self, rtt: int) -> None:
        if self.rx_srtt == 0:
            self.rx_srtt = rtt
            self.rx_rttval = rtt // 2
        else:
            delta = abs(rtt - self.rx_srtt)
            self.rx_rttval = (3 * self.rx_rttval + delta) // 4
            self.rx_srtt = max(1, (7 * self.rx_srtt + rtt) // 8)
        rto = self.rx_srtt + max(self.interval, 4 * self.rx_rttval)
        self.rx_rto = max(self.rx_minrto, min(rto, RTO_MAX))

    def _shrink_buf(self) -> None:
        self.snd_una = self.snd_buf[0].sn if self.snd_buf else self.snd_nxt

    def _parse_ack(self, sn: int) -> None:
        if _itimediff(sn, self.snd_una) < 0 or \
                _itimediff(sn, self.snd_nxt) >= 0:
            return
        for i, seg in enumerate(self.snd_buf):
            if seg.sn == sn:
                del self.snd_buf[i]
                break
            if _itimediff(sn, seg.sn) < 0:
                break

    def _parse_una(self, una: int) -> None:
        while self.snd_buf and _itimediff(self.snd_buf[0].sn, una) < 0:
            self.snd_buf.popleft()

    def _parse_fastack(self, sn: int, ts: int) -> None:
        if _itimediff(sn, self.snd_una) < 0 or \
                _itimediff(sn, self.snd_nxt) >= 0:
            return
        for seg in self.snd_buf:
            if _itimediff(sn, seg.sn) < 0:
                break
            if sn != seg.sn:
                seg.fastack += 1

    def _parse_data(self, newseg: _Segment) -> None:
        sn = newseg.sn
        if _itimediff(sn, self.rcv_nxt + self.rcv_wnd) >= 0 or \
                _itimediff(sn, self.rcv_nxt) < 0:
            return
        # Ordered insert (dedup) from the back — bursts arrive in order.
        idx = len(self.rcv_buf)
        for i in range(len(self.rcv_buf) - 1, -1, -1):
            seg = self.rcv_buf[i]
            if seg.sn == sn:
                return  # duplicate
            if _itimediff(sn, seg.sn) > 0:
                idx = i + 1
                break
        else:
            idx = 0
        self.rcv_buf.insert(idx, newseg)
        self._move_rcv_buf()

    def _move_rcv_buf(self) -> None:
        while self.rcv_buf and self.rcv_buf[0].sn == self.rcv_nxt and \
                len(self.rcv_queue) < self.rcv_wnd:
            self.rcv_queue.append(self.rcv_buf.pop(0))
            self.rcv_nxt = (self.rcv_nxt + 1) & 0xFFFFFFFF

    def input(self, data: bytes) -> int:
        """Feed one received datagram (>= 1 segments). Returns 0, or < 0 on
        malformed/foreign input (caller drops the datagram)."""
        if len(data) < OVERHEAD:
            return -1
        prev_una = self.snd_una
        flag = False
        maxack = 0
        latest_ts = 0
        off = 0
        n = len(data)
        while n - off >= OVERHEAD:
            conv, cmd, frg, wnd, ts, sn, una = _SEG_HDR.unpack_from(
                data, off)
            (length,) = struct.unpack_from("<I", data, off + 20)
            off += OVERHEAD
            if conv != self.conv:
                return -1
            if n - off < length:
                return -2
            if cmd not in (CMD_PUSH, CMD_ACK, CMD_WASK, CMD_WINS):
                # Validated BEFORE applying wnd/una (ikcp_input order): a
                # malformed segment must not mutate the window or ack
                # state on its way to being rejected.
                return -3
            self.rmt_wnd = wnd
            self._parse_una(una)
            self._shrink_buf()
            if cmd == CMD_ACK:
                rtt = _itimediff(self.current, ts)
                if rtt >= 0:
                    self._update_ack(rtt)
                self._parse_ack(sn)
                self._shrink_buf()
                if not flag:
                    flag = True
                    maxack = sn
                    latest_ts = ts
                elif _itimediff(sn, maxack) > 0:
                    maxack = sn
                    latest_ts = ts
            elif cmd == CMD_PUSH:
                if _itimediff(sn, self.rcv_nxt + self.rcv_wnd) < 0:
                    self.acklist.append((sn, ts))
                    if _itimediff(sn, self.rcv_nxt) >= 0:
                        seg = _Segment(data[off:off + length])
                        seg.conv, seg.cmd, seg.frg = conv, cmd, frg
                        seg.wnd, seg.ts, seg.sn, seg.una = wnd, ts, sn, una
                        self._parse_data(seg)
            elif cmd == CMD_WASK:
                self.probe |= ASK_TELL
            # CMD_WINS: window update already absorbed via rmt_wnd
            off += length
        if flag:
            self._parse_fastack(maxack, latest_ts)
        # Congestion window growth on forward-progress acks (used only
        # when nc=0, but tracked regardless, per the spec).
        if _itimediff(self.snd_una, prev_una) > 0 and \
                self.cwnd < self.rmt_wnd:
            if self.cwnd < self.ssthresh:
                self.cwnd += 1
                self.incr += self.mss
            else:
                self.incr = max(self.incr, self.mss)
                self.incr += (self.mss * self.mss) // self.incr + \
                    (self.mss // 16)
                if (self.cwnd + 1) * self.mss <= self.incr:
                    self.cwnd = (self.incr + self.mss - 1) // max(
                        1, self.mss)
            if self.cwnd > self.rmt_wnd:
                self.cwnd = self.rmt_wnd
                self.incr = self.rmt_wnd * self.mss
        return 0

    # --- output path --------------------------------------------------------

    def _wnd_unused(self) -> int:
        return max(0, self.rcv_wnd - len(self.rcv_queue))

    def flush(self) -> None:
        if not self.updated:
            return
        current = self.current
        buf = bytearray()
        wnd_unused = self._wnd_unused()

        def emit(chunk: bytes) -> None:
            if len(buf) + len(chunk) > self.mtu and buf:
                self.output(bytes(buf))
                buf.clear()
            buf.extend(chunk)

        seg = _Segment()
        seg.conv = self.conv
        seg.cmd = CMD_ACK
        seg.wnd = wnd_unused
        seg.una = self.rcv_nxt
        # 1) pending acks
        for sn, ts in self.acklist:
            seg.sn, seg.ts = sn, ts
            emit(seg.encode())
        self.acklist.clear()
        # 2) zero-remote-window probing
        if self.rmt_wnd == 0:
            if self.probe_wait == 0:
                self.probe_wait = PROBE_INIT
                self.ts_probe = (current + self.probe_wait) & 0xFFFFFFFF
            elif _itimediff(current, self.ts_probe) >= 0:
                self.probe_wait = max(self.probe_wait, PROBE_INIT)
                self.probe_wait += self.probe_wait // 2
                self.probe_wait = min(self.probe_wait, PROBE_LIMIT)
                self.ts_probe = (current + self.probe_wait) & 0xFFFFFFFF
                self.probe |= ASK_SEND
        else:
            self.ts_probe = 0
            self.probe_wait = 0
        if self.probe & ASK_SEND:
            seg.cmd = CMD_WASK
            seg.sn, seg.ts = 0, 0
            emit(seg.encode())
        if self.probe & ASK_TELL:
            seg.cmd = CMD_WINS
            seg.sn, seg.ts = 0, 0
            emit(seg.encode())
        self.probe = 0
        # 3) move send-queue into the in-flight buffer within the window
        cwnd = min(self.snd_wnd, self.rmt_wnd)
        if not self.nocwnd:
            cwnd = min(self.cwnd, cwnd)
        while _itimediff(self.snd_nxt, self.snd_una + cwnd) < 0 and \
                self.snd_queue:
            newseg = self.snd_queue.popleft()
            newseg.conv = self.conv
            newseg.cmd = CMD_PUSH
            newseg.wnd = wnd_unused
            newseg.ts = current
            newseg.sn = self.snd_nxt
            self.snd_nxt = (self.snd_nxt + 1) & 0xFFFFFFFF
            newseg.una = self.rcv_nxt
            newseg.resendts = current
            newseg.rto = self.rx_rto
            newseg.fastack = 0
            newseg.xmit = 0
            self.snd_buf.append(newseg)
        # 4) (re)transmit in-flight segments
        resent = self.fastresend if self.fastresend > 0 else 0x7FFFFFFF
        rtomin = (self.rx_rto >> 3) if not self.nodelay else 0
        lost = False
        change = False
        for sseg in self.snd_buf:
            needsend = False
            if sseg.xmit == 0:
                needsend = True
                sseg.xmit += 1
                sseg.rto = self.rx_rto
                sseg.resendts = (current + sseg.rto + rtomin) & 0xFFFFFFFF
            elif _itimediff(current, sseg.resendts) >= 0:
                needsend = True
                sseg.xmit += 1
                self.xmit += 1
                if not self.nodelay:
                    sseg.rto += max(sseg.rto, self.rx_rto)
                else:
                    sseg.rto += self.rx_rto // 2  # nodelay x1.5 backoff
                sseg.resendts = (current + sseg.rto) & 0xFFFFFFFF
                lost = True
            elif sseg.fastack >= resent:
                needsend = True
                sseg.xmit += 1
                sseg.fastack = 0
                sseg.resendts = (current + sseg.rto) & 0xFFFFFFFF
                change = True
            if needsend:
                sseg.ts = current
                sseg.wnd = wnd_unused
                sseg.una = self.rcv_nxt
                emit(sseg.encode() + sseg.data)
                if sseg.xmit >= self.dead_link:
                    self.state = -1
        if buf:
            self.output(bytes(buf))
        # 5) congestion state updates
        if change:
            inflight = (self.snd_nxt - self.snd_una) & 0xFFFFFFFF
            self.ssthresh = max(THRESH_MIN, inflight // 2)
            self.cwnd = self.ssthresh + resent
            self.incr = self.cwnd * self.mss
        if lost:
            self.ssthresh = max(THRESH_MIN, cwnd // 2)
            self.cwnd = 1
            self.incr = self.mss
        if self.cwnd < 1:
            self.cwnd = 1
            self.incr = self.mss

    def update(self, current: int) -> None:
        """Clock the protocol (``current`` in ms, any epoch, wraps u32)."""
        self.current = current & 0xFFFFFFFF
        if not self.updated:
            self.updated = True
            self.ts_flush = self.current
        slap = _itimediff(self.current, self.ts_flush)
        if slap >= 10000 or slap < -10000:
            self.ts_flush = self.current
            slap = 0
        if slap >= 0:
            self.ts_flush = (self.ts_flush + self.interval) & 0xFFFFFFFF
            if _itimediff(self.current, self.ts_flush) >= 0:
                self.ts_flush = (self.current + self.interval) & 0xFFFFFFFF
            self.flush()

    def check(self, current: int) -> int:
        """Earliest ms at which update() has work (spec ikcp_check): the
        next flush tick or the earliest retransmit deadline."""
        current &= 0xFFFFFFFF
        if not self.updated:
            return current
        ts_flush = self.ts_flush
        slap = _itimediff(current, ts_flush)
        if slap >= 10000 or slap < -10000:
            ts_flush = current
        if _itimediff(current, ts_flush) >= 0:
            return current
        tm_packet = 0x7FFFFFFF
        for seg in self.snd_buf:
            diff = _itimediff(seg.resendts, current)
            if diff <= 0:
                return current
            tm_packet = min(tm_packet, diff)
        minimal = min(tm_packet, _itimediff(ts_flush, current),
                      self.interval)
        return (current + minimal) & 0xFFFFFFFF

    def idle(self) -> bool:
        """No in-flight data, nothing queued, no acks or probes owed —
        update() is a no-op until new input/send (session-layer parking)."""
        return (not self.snd_buf and not self.snd_queue
                and not self.acklist and self.probe == 0
                and self.rmt_wnd > 0)

    @property
    def has_acks(self) -> bool:
        """Pending acks owed to the peer (shared seam with the C core —
        native/kcpcore.c exposes the same attribute)."""
        return bool(self.acklist)

    def waiting_send(self) -> int:
        return len(self.snd_buf) + len(self.snd_queue)


# --- asyncio session layer ---------------------------------------------------

# Segments kcp.input rejected, by its return code (session layer counts —
# the protocol core stays dependency-free for the C-parity suite).
from goworld_tpu_torch import telemetry as _telemetry

_KCP_MALFORMED = _telemetry.counter(
    "kcp_malformed_dropped_total",
    "Datagrams rejected by kcp.input: runt_or_foreign_conv (short header "
    "or wrong conversation id), bad_length (declared segment length "
    "exceeds the datagram), bad_cmd (unknown command byte).",
    ("reason",))
_KCP_INPUT_REASON = {
    -1: "runt_or_foreign_conv", -2: "bad_length", -3: "bad_cmd",
}

_MS_EPOCH = time.monotonic()


def _now_ms() -> int:
    return int((time.monotonic() - _MS_EPOCH) * 1000) & 0xFFFFFFFF


def make_core(conv: int, output: Callable[[bytes], None]):
    """The KCP control block — the C hot path (native/kcpcore.c) when
    built, else the pinned pure-Python reference above. Identical
    semantics; the parity suite pumps random lossy transfers through
    MIXED C/Python pairs and asserts identical delivered streams."""
    import os

    from goworld_tpu_torch import native

    if native.KCPCore is not None and \
            os.environ.get("GWT_NO_NATIVE", "") != "1":
        return native.KCPCore(conv, output)
    return KCP(conv, output)


class KCPPacketConnection:
    """PacketConnection-shaped adapter over one KCP conversation, carrying
    the same framed packet stream as TCP (stream mode + native.split, the
    way the reference layers its framing over a kcp-go UDPSession)."""

    def __init__(
        self,
        conv: int,
        transmit: Callable[[bytes], None],
        on_close: Optional[Callable[["KCPPacketConnection"], None]] = None,
        fec: tuple[int, int] | None = (10, 3),
    ) -> None:
        self.conv = conv
        self._transmit = transmit
        self._on_close = on_close
        self.loss_simulation = 0.0
        # FEC(10,3) is the reference's exact dial shape
        # (ListenWithOptions(addr, nil, 10, 3)); None disables the FEC
        # framing entirely (plain KCP segments on the wire). Both ends
        # must agree — the 6-byte header is not self-identifying.
        if fec is not None:
            from goworld_tpu_torch.netutil.fec import FECDecoder, FECEncoder

            self._fec_enc = FECEncoder(*fec)
            self._fec_dec = FECDecoder(*fec)
        else:
            self._fec_enc = self._fec_dec = None
        self.kcp = make_core(conv, self._output)
        if fec is not None:
            # Keep FEC-wrapped datagrams inside the 1400-byte budget: the
            # wrap adds 8 bytes (6 header + 2 size), so shrink the kcp
            # mtu by exactly that (kcp-go: SetMtu(mtuDefault-headerSize)).
            self.kcp.set_mtu(MTU_DEF - 8)
        # Reference turbo tuning (consts.go:122-131) + stream mode.
        self.kcp.set_nodelay(1, 10, 2, 1)
        self.kcp.stream = True
        self.kcp.set_wndsize(256, 256)
        self._compress = 0  # 0 off | 1 zlib | 2 snappy (native.pack modes)
        self._rbytes = bytearray()
        self._packets: asyncio.Queue = asyncio.Queue()
        self.closed = False
        self.dropped = 0
        self._peername = None
        self._wake = asyncio.Event()
        self._ticker = asyncio.get_running_loop().create_task(
            self._tick_loop())

    @property
    def peername(self):
        return self._peername

    def _output(self, data: bytes) -> None:
        datagrams = (self._fec_enc.encode(data)
                     if self._fec_enc is not None else (data,))
        for d in datagrams:
            if self.loss_simulation and \
                    random.random() < self.loss_simulation:
                continue
            self._transmit(d)

    async def _tick_loop(self) -> None:
        # Event-driven clocking (code-review r5): while the conversation
        # has work, wake at kcp.check()'s deadline (<= the 10 ms turbo
        # interval); while fully IDLE, park on the wake event so thousands
        # of quiet connections cost zero scheduler load. send_packet and
        # on_datagram kick the event.
        while not self.closed:
            self.kcp.update(_now_ms())
            if self.kcp.state < 0:
                self.close()  # dead link: 20 xmits of one segment
                return
            if self.kcp.idle():
                self._wake.clear()
                await self._wake.wait()
                continue
            nxt = self.kcp.check(_now_ms())
            delay = max(1, _itimediff(nxt, _now_ms())) / 1000.0
            self._wake.clear()
            try:
                await asyncio.wait_for(self._wake.wait(), timeout=delay)
            except asyncio.TimeoutError:
                pass

    def on_datagram(self, data: bytes) -> None:
        """Feed one received UDP datagram (FEC-unwrapped when enabled —
        reconstructed lost datagrams feed kcp right behind the real one).
        Datagrams kcp rejects (foreign conv, truncated declared length,
        unknown cmd) are dropped and counted per reason, so hostile input
        is visible."""
        if self._fec_dec is not None:
            payloads = self._fec_dec.decode(data)
        else:
            payloads = (data,)
        ok = False
        for p in payloads:
            rc = self.kcp.input(p)
            if rc >= 0:
                ok = True
            else:
                _KCP_MALFORMED.labels(
                    _KCP_INPUT_REASON.get(rc, "malformed")).inc()
        if not ok:
            return
        self._wake.set()  # un-park the ticker (acks/probes/window opened)
        # ACK_NO_DELAY: flush pending acks now, not at the next tick.
        if self.kcp.has_acks and self.kcp.updated:
            self.kcp.current = _now_ms()
            self.kcp.flush()
        # Drain every ready message FIRST, then deframe the lot in ONE C
        # split call — a restore burst delivers thousands of stream chunks
        # per client, and a Python→C crossing per chunk is measurable at
        # fleet scale (the TCP path batch-parses whole socket reads the
        # same way).
        got = False
        while True:
            msg = self.kcp.recv()
            if msg is None:
                break
            self._rbytes += msg
            got = True
        if not got:
            return
        from goworld_tpu_torch.netutil.packet_conn import deframe

        frames, err = deframe(self._rbytes)
        for mt, payload in frames:
            self._packets.put_nowait((mt, Packet(payload)))
        if err is not None:
            self.close()  # malformed framed stream is fatal
            return

    # --- PacketConnection surface ------------------------------------------

    def enable_compression(self, fmt: str = "snappy") -> None:
        if fmt not in ("snappy", "zlib"):
            raise ValueError(f"unknown compression format {fmt!r}")
        self._compress = 2 if fmt == "snappy" else 1

    MAX_BACKLOG = 65536  # queued segments beyond the window → evict (the
    # WS/rudp transports' stalled-client policy; KCP itself is unbounded)

    def send_packet(self, msgtype: int, packet: Packet) -> None:
        from goworld_tpu_torch.netutil.packet_conn import _COMPRESS_THRESHOLD

        if self.closed:
            self.dropped += 1
            return
        if self.kcp.waiting_send() > self.MAX_BACKLOG:
            self.dropped += 1
            self.close()  # stalled client: evict
            return
        buf = native.pack(msgtype, packet.payload, self._compress,
                          _COMPRESS_THRESHOLD, gwconsts.MAX_PACKET_SIZE)
        # kcp.send rejects buffers that fragment into >= WND_RCV segments
        # (the u8 frg field); chunk like kcp-go's UDPSession.Write does —
        # stream mode re-coalesces, so chunking is invisible on the wire.
        chunk = self.kcp.mss * 120
        for off in range(0, len(buf), chunk):
            if self.kcp.send(buf[off:off + chunk]) < 0:
                # Chunking guarantees this cannot happen; if it ever does,
                # a HALF-QUEUED frame would desync the framed byte stream
                # for the rest of the conversation — kill it instead.
                self.dropped += 1
                self.close()
                return
        self._wake.set()

    def flush(self) -> None:
        if not self.closed:
            self.kcp.update(_now_ms())

    async def drain(self, hard: bool = False) -> None:
        self.flush()
        if hard:
            # Freeze/terminate path: push retransmits until the peer acked
            # everything or a bounded budget elapses.
            deadline = time.monotonic() + 2.0
            while self.kcp.waiting_send() and time.monotonic() < deadline:
                self.kcp.update(_now_ms())
                await asyncio.sleep(self.kcp.interval / 1000.0)

    async def recv_packet(self) -> tuple[int, Packet]:
        item = await self._packets.get()
        if item is None:
            raise ConnectionClosed("kcp closed")
        return item

    def close(self) -> None:
        """KCP has no FIN on the wire (matching the protocol): the peer
        learns of the close via dead-link / the app-level heartbeat kill.
        The listener tombstones the (addr, conv) key so a still-
        retransmitting peer cannot resurrect a ghost session."""
        if self.closed:
            return
        self.closed = True
        self._ticker.cancel()
        self._packets.put_nowait(None)
        if self._on_close is not None:
            self._on_close(self)


class KCPListener(asyncio.DatagramProtocol):
    """Server side: sessions keyed by remote address on one UDP socket
    (kcp-go's Listener shape, GateService.go:134-144 — FEC parity shards
    carry no conv, so address is the only universal demux key; the conv
    is pinned from the opening PUSH and enforced by kcp.input)."""

    _TOMBSTONES = 1024  # recently closed (addr, conv) keys remembered
    # Session caps: a session costs a ticker task + FEC
    # state + a full gate accept/boot pipeline, keyed by SPOOFABLE source
    # address — so a forged-source flood of 24-byte sn-0 PUSHes would
    # otherwise allocate without bound. Excess opens are dropped BEFORE
    # constructing KCPPacketConnection and counted on
    # kcp_sessions_dropped_total{reason}. A legitimate client behind the
    # caps retries its sn-0 PUSH (it retransmits until acked) and gets in
    # once load subsides. The per-IP cap bounds one unspoofed abuser (or
    # one NAT'd venue — size accordingly) well below the listener cap.
    MAX_SESSIONS = 4096
    MAX_SESSIONS_PER_IP = 64

    def __init__(
        self,
        on_accept: Callable[[KCPPacketConnection], None],
        fec: tuple[int, int] | None = (10, 3),
        max_sessions: int | None = None,
        max_sessions_per_ip: int | None = None,
    ) -> None:
        self._on_accept = on_accept
        self._fec = fec
        self._transport: Optional[asyncio.DatagramTransport] = None
        self._sessions: dict = {}
        self.max_sessions = max_sessions or self.MAX_SESSIONS
        self.max_sessions_per_ip = (
            max_sessions_per_ip or self.MAX_SESSIONS_PER_IP)
        self._per_ip: collections.Counter = collections.Counter()
        from goworld_tpu_torch import telemetry

        self._m_dropped = telemetry.counter(
            "kcp_sessions_dropped_total",
            "sn-0 opens dropped by KCPListener session caps.",
            ("reason",))
        # Closed conversations must not resurrect (code-review r5): an
        # evicted client still retransmitting would otherwise re-create a
        # ghost session + boot flow on its next PUSH. FIFO-bounded so an
        # address churning conv ids can't grow it unboundedly.
        self._tombstones: collections.OrderedDict = collections.OrderedDict()
        self.loss_simulation = 0.0

    def connection_made(self, transport) -> None:
        self._transport = transport

    def _first_segment(self, data: bytes) -> bytes | None:
        """The raw KCP bytes of a datagram for session-opening decisions:
        None when it can't open one (parity shard, runt)."""
        if self._fec is not None:
            from goworld_tpu_torch.netutil import fec as fecmod

            if len(data) < fecmod.DATA_OFF:
                return None
            (flag,) = struct.unpack_from("<H", data, 4)
            if flag != fecmod.TYPE_DATA:
                return None
            return data[fecmod.DATA_OFF:]
        return data

    def datagram_received(self, data: bytes, addr) -> None:
        sess = self._sessions.get(addr)
        if sess is None:
            seg = self._first_segment(data)
            if seg is None or len(seg) < OVERHEAD:
                return
            (conv,) = struct.unpack_from("<I", seg, 0)
            if (addr, conv) in self._tombstones:
                return  # closed conversation: never resurrect
            cmd = seg[4]
            if cmd != CMD_PUSH:
                return  # stray control segment for a dead conversation
            (sn,) = struct.unpack_from("<I", seg, 12)
            if sn != 0:
                # A NEW conversation's first-arriving push is sn 0 (sn 0
                # retransmits until acked, so loss can't starve this);
                # mid-stream sns are a dead/unknown conversation's
                # retransmits — don't boot a ghost proxy for them.
                return
            if len(self._sessions) >= self.max_sessions:
                self._m_dropped.labels("listener_cap").inc()
                return
            if self._per_ip[addr[0]] >= self.max_sessions_per_ip:
                self._m_dropped.labels("ip_cap").inc()
                return
            sess = KCPPacketConnection(
                conv,
                lambda d, a=addr: self._send_to(a, d),
                on_close=self._session_closed,
                fec=self._fec,
            )
            sess.loss_simulation = self.loss_simulation
            sess._peername = addr
            sess._listener_key = addr
            self._sessions[addr] = sess
            self._per_ip[addr[0]] += 1
            self._on_accept(sess)
        sess.on_datagram(data)

    def _session_closed(self, sess: KCPPacketConnection) -> None:
        key = getattr(sess, "_listener_key", None)
        if key is None:
            return
        if self._sessions.pop(key, None) is not None:
            # Decrement only on a real removal: close() can race a
            # tombstoned re-close and must not drive the count negative.
            self._per_ip[key[0]] -= 1
            if self._per_ip[key[0]] <= 0:
                del self._per_ip[key[0]]
        self._tombstones[(key, sess.conv)] = True
        while len(self._tombstones) > self._TOMBSTONES:
            self._tombstones.popitem(last=False)

    def _send_to(self, addr, data: bytes) -> None:
        if self._transport is not None:
            self._transport.sendto(data, addr)

    def close(self) -> None:
        for sess in list(self._sessions.values()):
            sess.close()
        if self._transport is not None:
            self._transport.close()


class _KCPClientProtocol(asyncio.DatagramProtocol):
    def __init__(self, ref: list) -> None:
        self._ref = ref

    def datagram_received(self, data: bytes, addr) -> None:
        sess = self._ref[0]
        if sess is None:
            return
        # The socket is connected to one server; conv/format checks happen
        # inside the session (FEC unwrap + kcp.input conv enforcement).
        sess.on_datagram(data)


async def connect_kcp(
    host: str, port: int, loss_simulation: float = 0.0,
    conv: int | None = None, fec: tuple[int, int] | None = (10, 3),
) -> KCPPacketConnection:
    """Client side: open a KCP conversation (random conv + FEC(10,3), the
    reference's exact dial shape, ClientBot.go:153) and return a
    PacketConnection-shaped transport. ``fec`` must match the server."""
    loop = asyncio.get_running_loop()
    ref: list = [None]
    transport, _ = await loop.create_datagram_endpoint(
        lambda: _KCPClientProtocol(ref), remote_addr=(host, port))
    if conv is None:
        conv = random.getrandbits(32) or 1
    sess = KCPPacketConnection(
        conv, transport.sendto,
        on_close=lambda s: transport.close(), fec=fec)
    sess.loss_simulation = loss_simulation
    sess._peername = (host, port)
    ref[0] = sess
    return sess
