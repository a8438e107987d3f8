"""Length-prefixed packet framing over an asyncio stream.

Reference parity: ``engine/netutil/PacketConnection.go:50-186`` — every wire
message is [u32 LE payload length][payload]; payloads are capped at 25 MiB
(PacketConnection.go:23). The reference queues sends and flushes on a 5 ms
timer to batch small writes (GoWorldConnection.go:437-452); asyncio's
transport write buffering plus an explicit ``flush_interval`` drain task
provides the same batching.

Optional per-packet compression (the reference wraps gate↔client conns in
snappy, ClientProxy.go:42-45): payloads over a small threshold are
compressed with snappy (from-scratch codec in native/ — the library isn't
in the image; zlib remains selectable) and a length-prefix flag bit marks
the codec per packet (the bit role the reference reserves via
PAYLOAD_LEN_MASK), so recv auto-detects and enabling is one-sided safe.
"""

from __future__ import annotations

import asyncio
import collections
import struct

from goworld_tpu_torch import consts, native
from goworld_tpu_torch.netutil.packet import Packet

_COMPRESS_THRESHOLD = 256  # don't deflate tiny packets (heartbeats, syncs)
_RECV_CHUNK = 65536
# Frame header for the uncompressed scatter path: [u32 body_len][u16
# msgtype]. Must stay byte-identical to native.pack's framing (body_len
# counts the msgtype's 2 bytes; no compression flag bits set).
_FRAME_HDR = struct.Struct("<IH")

# Packets that rode an existing corked batch instead of paying their own
# transport write (gate tick-scoped coalescing; one series process-wide —
# connections churn too fast for per-conn labels, same reasoning as
# net_packets_total in proto/conn.py).
from goworld_tpu_torch import telemetry as _telemetry

_COALESCED = _telemetry.counter(
    "net_coalesced_packets_total",
    "Packets flushed as part of a multi-packet corked batch (all but the "
    "first of each batch): writes saved by tick-scoped write coalescing.",
)
_WRITEV = _telemetry.counter(
    "net_writev_batches_total",
    "Multi-buffer flushes handed to the transport as a scatter list "
    "(writelines) instead of being joined into one copy first.",
)


def deframe(rbytes: bytearray, max_packet: int = 0):
    """One batched native.split over ``rbytes``, consuming the parsed
    prefix in place. Returns (frames, error): frames parsed BEFORE a
    malformed one are still returned, and error != None is connection-
    fatal for the caller. The single seam for the framing contract shared
    by the TCP, rudp, and kcp transports (code-review r5)."""
    frames, consumed, err = native.split(
        rbytes, max_packet or consts.MAX_PACKET_SIZE
    )
    if consumed:
        del rbytes[:consumed]
    return frames, err


class ConnectionClosed(Exception):
    pass


class PacketConnection:
    """Framed packet transport over an asyncio (reader, writer) pair."""

    def __init__(
        self,
        reader: asyncio.StreamReader,
        writer: asyncio.StreamWriter,
        flush_interval: float = consts.FLUSH_INTERVAL,
    ) -> None:
        self._reader = reader
        self._writer = writer
        self._flush_interval = flush_interval
        # Scatter list of wire buffers awaiting flush. The uncompressed
        # send path appends TWO entries per packet — a 6-byte frame header
        # and the payload object itself (zero-copy) — so _pending_count
        # tracks packets separately from buffers.
        self._pending: list[bytes] = []
        self._pending_count = 0
        self._flush_task: asyncio.Task | None = None
        self._corked = False  # tick-scoped write coalescing (cork/uncork)
        self._closed = False
        self._compress = 0  # 0 off | 1 zlib | 2 snappy (native.pack modes)
        self.dropped = 0  # packets discarded because the conn was closed
        # Monotonic count of packets queued for send: the cluster-link
        # heartbeat layer compares it across intervals to detect idle
        # links (an int increment — no clock read on the send hot path).
        self.sent_packets = 0
        # Batched recv: raw bytes accumulate here and whole chunks are
        # deframed in one native.split call (C when available) — one await
        # + one parse per burst instead of two awaits per packet.
        # bytearray: `del [:consumed]` keeps multi-chunk reassembly of a
        # large packet linear (immutable += would be quadratic in copies
        # across the ~400 chunks of a near-cap 25 MB packet).
        self._rbytes = bytearray()
        self._rframes: collections.deque = collections.deque()
        self._recv_error: str | None = None

    def enable_compression(self, fmt: str = "snappy") -> None:
        """Turn on per-packet compression for SENDS (recv always
        auto-detects via the length-prefix flag bits, so enabling is
        one-sided safe). ``fmt``: "snappy" (reference parity,
        ClientProxy.go:42-45) or "zlib"."""
        if fmt not in ("snappy", "zlib"):
            raise ValueError(f"unknown compression format {fmt!r}")
        self._compress = 2 if fmt == "snappy" else 1

    @property
    def peername(self):
        try:
            return self._writer.get_extra_info("peername")
        except Exception:
            return None

    # --- send --------------------------------------------------------------

    def send_packet(self, msgtype: int, packet: Packet) -> None:
        """Queue one packet; wire format = [len][u16 msgtype][payload].

        Sends on a closed connection are counted and dropped (the reference
        likewise drops packets to dead peers; reconnect logic re-syncs state,
        DispatcherConnMgr.go:66-88)."""
        if self._closed:
            self.dropped += 1
            return
        payload = packet.payload
        body_len = len(payload) + 2
        if self._compress and body_len >= _COMPRESS_THRESHOLD:
            # Compression candidates take the codec path (one packed buf).
            self._pending.append(native.pack(
                msgtype, payload, self._compress,
                _COMPRESS_THRESHOLD, consts.MAX_PACKET_SIZE,
            ))
        else:
            # Scatter framing: header + payload as separate buffers — the
            # payload (already an immutable bytes on the forward path) is
            # never copied into a framed buffer; flush() hands the whole
            # scatter list to the transport.
            if body_len > consts.MAX_PACKET_SIZE:
                raise ValueError(f"packet too large: {body_len}")
            if not 0 <= msgtype <= 0xFFFF:
                raise ValueError(f"msgtype {msgtype} out of u16 range")
            self._pending.append(_FRAME_HDR.pack(body_len, msgtype))
            if payload:
                self._pending.append(payload)
        self._pending_count += 1
        self.sent_packets += 1
        if self._corked:
            return  # uncork() flushes the whole tick's scatter list at once
        if self._flush_task is None or self._flush_task.done():
            self._flush_task = asyncio.get_running_loop().create_task(
                self._flush_later()
            )

    def cork(self) -> None:
        """Suspend flushing: sends accumulate in the pending scatter list
        with no per-send flush-task bookkeeping until :meth:`uncork`. The
        gate's logic loop corks a connection for the span of one event
        batch (tick) so N per-client packets leave in ONE transport write.
        Idempotent; a connection left corked by an error path is still
        flushed by the next uncork() or close()."""
        self._corked = True

    def uncork(self) -> None:
        """Re-enable flushing and write the coalesced batch out now."""
        self._corked = False
        n = self._pending_count
        if n > 1:
            _COALESCED.inc(n - 1)
        self.flush()

    async def _flush_later(self) -> None:
        if self._flush_interval > 0:
            await asyncio.sleep(self._flush_interval)
        self.flush()

    def flush(self) -> None:
        if self._closed or not self._pending:
            return
        pending = self._pending
        self._pending = []
        self._pending_count = 0
        try:
            if len(pending) == 1:
                self._writer.write(pending[0])
            else:
                # Scatter-gather: the transport takes the buffer list as is
                # (writev-style; on interpreters whose transport implements
                # writelines via sendmsg this is zero-copy end to end, and
                # even the fallback join happens ONCE at the lowest layer
                # instead of once here and once there).
                _WRITEV.inc()
                self._writer.writelines(pending)
        except Exception:
            self._closed = True

    async def drain(self, hard: bool = False) -> None:
        """Flush queued packets into the transport and wait for it to drain.

        ``hard=True`` waits until the transport buffer is completely empty
        (write-buffer limits dropped to zero) — required before process exit
        (freeze/terminate), where normal drain() can return with bytes still
        in the user-space buffer that die with the process.
        """
        self.flush()
        try:
            if hard:
                self._writer.transport.set_write_buffer_limits(0, 0)
            await self._writer.drain()
        except Exception:
            self._closed = True
            raise ConnectionClosed("drain failed")

    # --- recv --------------------------------------------------------------

    async def recv_packet(self) -> tuple[int, Packet]:
        """Read one framed packet; returns (msgtype, packet).

        Bytes are read in chunks and deframed in batch (native.split —
        C when available): the per-packet inflate is bounded at
        MAX_PACKET_SIZE inside split (decompression-bomb guard)."""
        while not self._rframes:
            if self._recv_error is not None:
                # Parsed frames before the malformed one were delivered;
                # now the connection dies.
                raise ConnectionClosed(self._recv_error)
            try:
                chunk = await self._reader.read(_RECV_CHUNK)
            except (ConnectionResetError, OSError):
                raise ConnectionClosed("connection closed while reading")
            if not chunk:
                raise ConnectionClosed("connection closed while reading")
            self._rbytes += chunk
            frames, err = deframe(self._rbytes)
            self._rframes.extend(frames)
            if err is not None:
                self._recv_error = err
                if not self._rframes:
                    raise ConnectionClosed(err)
        msgtype, payload = self._rframes.popleft()
        return msgtype, Packet(payload)

    # --- close -------------------------------------------------------------

    def close(self) -> None:
        self._closed = True
        try:
            self._writer.close()
        except Exception:
            pass

    def abort(self) -> None:
        """Hard-kill the transport: discard buffered bytes and reset the
        connection (no FIN handshake). Used by the liveness watchdog to
        convert a half-open link into an immediate reconnect, and by the
        chaos harness to model a crashed peer (clean close would let the
        remote distinguish an orderly shutdown)."""
        self._closed = True
        try:
            self._writer.transport.abort()
        except Exception:
            try:
                self._writer.close()
            except Exception:
                pass

    @property
    def closed(self) -> bool:
        return self._closed
