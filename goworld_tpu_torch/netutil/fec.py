"""Forward error correction for the KCP transport (kcp-go FEC layout).

The reference's gate and client both construct KCP sessions with FEC
enabled — ``kcp.ListenWithOptions(addr, nil, 10, 3)`` /
``DialWithOptions`` (components/gate/GateService.go:134-135,
examples/test_client/ClientBot.go:153): every UDP datagram is wrapped in
a 6-byte FEC header and every 10 data datagrams are followed by 3 parity
datagrams, letting the receiver RECONSTRUCT lost datagrams without
waiting a retransmit round trip.

Wire layout (kcp-go's fec.go):

    [u32 LE seqid][u16 LE flag] + shard bytes
      flag: 0xf1 = data, 0xf2 = parity
      data shard bytes: [u16 LE size][payload]  (size counts itself +
      payload, so recovered shards know their true length; receivers
      feed payload = pkt[8:] straight to kcp.input on arrival)

seqids are consecutive across data AND parity: a group of (10+3) shards
occupies 13 consecutive seqids — 10 data then 3 parity. Parity shards
are a systematic Reed-Solomon code over GF(2^8) (poly 0x11d) of the data
shards zero-padded to the group's max length: any 10 of the 13 shards
reconstruct the group.

The RS matrix here is the classic systematic Vandermonde construction
(top square inverted so data rows are identity). No Go toolchain exists
in-image to bit-compare parity against kcp-go's matrix, so parity-shard
byte equality with kcp-go is unverified (documented); the header layout,
group geometry, and data-shard pass-through are pinned by vectors in
tests/test_kcp.py, and recovery is proven against induced datagram loss.
"""

from __future__ import annotations

import struct

TYPE_DATA = 0xF1
TYPE_PARITY = 0xF2
HEADER = struct.Struct("<IH")  # seqid, flag
HEADER_SIZE = 6
SIZE_OFF = HEADER_SIZE  # u16 LE size follows the header in data shards
DATA_OFF = HEADER_SIZE + 2

# Hostile-input ceiling on a single shard's bytes (header/size fields
# from a hostile sender). Honest shards are
# bounded by the KCP mtu (~1400); RS reconstruction pads every shard of a
# group to the LONGEST member, so without a cap one forged jumbo datagram
# per group multiplies the GF(256) matmul work 40x. 16 KiB keeps any
# legitimate future mtu while bounding amplification.
MAX_SHARD = 16384

# Malformed datagrams dropped by the FEC layer, by reason (process-wide;
# per-connection labels would churn — same policy as net_packets_total).
from goworld_tpu_torch import telemetry as _telemetry

_MALFORMED = _telemetry.counter(
    "fec_malformed_dropped_total",
    "Datagrams dropped by FEC decode: runt (shorter than the header), "
    "bad_flag (neither data nor parity), size_field (data shard whose "
    "declared u16 size exceeds its bytes), oversize (shard beyond "
    "MAX_SHARD).",
    ("reason",))


# --- GF(256) arithmetic (poly 0x11d, the RS standard kcp-go uses) ------------

_EXP = [0] * 512
_LOG = [0] * 256
_x = 1
for _i in range(255):
    _EXP[_i] = _x
    _LOG[_x] = _i
    _x <<= 1
    if _x & 0x100:
        _x ^= 0x11D
for _i in range(255, 512):
    _EXP[_i] = _EXP[_i - 255]


def _gmul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    return _EXP[_LOG[a] + _LOG[b]]


def _ginv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("gf256 inverse of 0")
    return _EXP[255 - _LOG[a]]


# Byte-wise multiply-by-constant as a 256-entry translate table: Python's
# bytes.translate runs the hot loop in C.
_MUL_TABLE: dict[int, bytes] = {}


def _mul_table(c: int) -> bytes:
    t = _MUL_TABLE.get(c)
    if t is None:
        t = bytes(_gmul(c, x) for x in range(256))
        _MUL_TABLE[c] = t
    return t


def _mul_shard(c: int, shard: bytes) -> int:
    """c * shard as a big-int bitstring (XOR-accumulation friendly)."""
    if c == 0:
        return 0
    if c == 1:
        return int.from_bytes(shard, "big")
    return int.from_bytes(shard.translate(_mul_table(c)), "big")


def _matmul_rows(matrix_rows, shards: list[bytes], length: int):
    import os

    from goworld_tpu_torch import native

    # Both implementations require equal-length shards; enforce here so
    # the C path (tail-pads/truncates) and the Python big-int path
    # (front-pads/overflows) can never silently diverge on malformed
    # input (code-review r5). Internal callers always ljust-pad.
    for s in shards:
        if len(s) != length:
            raise ValueError("rs shards must all equal the given length")
    if native.rs_matmul is not None and \
            os.environ.get("GWT_NO_NATIVE", "") != "1":
        # C hot loop (native/kcpcore.c rs_matmul): identical GF(256)
        # XOR-dot; the Python path below is the pinned reference the
        # parity test compares against.
        return native.rs_matmul(matrix_rows, shards, length)
    out = []
    for row in matrix_rows:
        acc = 0
        for c, shard in zip(row, shards):
            acc ^= _mul_shard(c, shard)
        out.append(acc.to_bytes(length, "big"))
    return out


def _invert(m: list[list[int]]) -> list[list[int]]:
    """Gauss-Jordan inverse over GF(256)."""
    n = len(m)
    a = [row[:] + [1 if i == j else 0 for j in range(n)]
         for i, row in enumerate(m)]
    for col in range(n):
        piv = next((r for r in range(col, n) if a[r][col]), None)
        if piv is None:
            raise ValueError("singular matrix")
        a[col], a[piv] = a[piv], a[col]
        inv = _ginv(a[col][col])
        a[col] = [_gmul(inv, v) for v in a[col]]
        for r in range(n):
            if r != col and a[r][col]:
                f = a[r][col]
                a[r] = [v ^ _gmul(f, a[col][c2])
                        for c2, v in enumerate(a[r])]
    return [row[n:] for row in a]


class ReedSolomon:
    """Systematic RS(data, parity) over GF(256): encode matrix rows are
    identity for data + parity rows from the inverted-top Vandermonde."""

    def __init__(self, data_shards: int, parity_shards: int) -> None:
        self.d = data_shards
        self.p = parity_shards
        n = data_shards + parity_shards
        vand = [[_EXP[(i * j) % 255] if i or j else 1
                 for j in range(data_shards)] for i in range(n)]
        # exp table power: element (i, j) = alpha^(i*j)
        top_inv = _invert([row[:] for row in vand[:data_shards]])
        self.matrix = [
            [self._dot(vand[r], top_inv, c) for c in range(data_shards)]
            for r in range(n)
        ]
        self.parity_rows = self.matrix[data_shards:]

    @staticmethod
    def _dot(row, m, col) -> int:
        acc = 0
        for k, v in enumerate(row):
            acc ^= _gmul(v, m[k][col])
        return acc

    def encode(self, data: list[bytes]) -> list[bytes]:
        """Parity shards for equal-length data shards."""
        assert len(data) == self.d
        length = len(data[0])
        return _matmul_rows(self.parity_rows, data, length)

    def reconstruct(self, shards: list[bytes | None]) -> list[bytes]:
        """Recover the DATA shards given any >= d of the d+p shards
        (None = missing). Returns the d data shards."""
        have = [(i, s) for i, s in enumerate(shards) if s is not None]
        if len(have) < self.d:
            raise ValueError("not enough shards")
        have = have[:self.d]
        length = len(have[0][1])
        sub = [self.matrix[i] for i, _ in have]
        inv = _invert(sub)
        return _matmul_rows(inv, [s for _, s in have], length)


_RS_CACHE: dict[tuple[int, int], ReedSolomon] = {}


def get_rs(data_shards: int, parity_shards: int) -> ReedSolomon:
    """The RS code is immutable per (d, p): build the matrix once per
    process, not once per encoder/decoder per connection (code-review
    r5 — the gate accepts thousands of clients)."""
    key = (data_shards, parity_shards)
    rs = _RS_CACHE.get(key)
    if rs is None:
        rs = _RS_CACHE[key] = ReedSolomon(data_shards, parity_shards)
    return rs


class FECEncoder:
    """Wrap outgoing datagrams as data shards; after every ``d`` of them
    emit ``p`` parity shards (consecutive seqids, kcp-go group layout)."""

    def __init__(self, data_shards: int = 10, parity_shards: int = 3) -> None:
        self.rs = get_rs(data_shards, parity_shards)
        # Wrap at a MULTIPLE of the group size (kcp-go's paws), never at
        # raw 2^32: 2^32 mod 13 != 0, so a raw wrap would permanently
        # misalign decoder groups (code-review r5).
        n = data_shards + parity_shards
        self._paws = (0xFFFFFFFF // n) * n
        self.next_seqid = 0
        self._group: list[bytes] = []  # shard bytes ([size][payload])

    def encode(self, payload: bytes) -> list[bytes]:
        """Returns the datagrams to transmit for this payload: the data
        shard, plus the group's parity shards when it completes."""
        shard = struct.pack("<H", len(payload) + 2) + payload
        out = [HEADER.pack(self.next_seqid, TYPE_DATA) + shard]
        self.next_seqid = (self.next_seqid + 1) % self._paws
        self._group.append(shard)
        if len(self._group) == self.rs.d:
            maxlen = max(len(s) for s in self._group)
            padded = [s.ljust(maxlen, b"\x00") for s in self._group]
            for par in self.rs.encode(padded):
                out.append(HEADER.pack(self.next_seqid, TYPE_PARITY) + par)
                self.next_seqid = (self.next_seqid + 1) % self._paws
            self._group.clear()
        return out


class FECDecoder:
    """Unwrap incoming datagrams; reconstruct lost data shards when a
    group reaches ``d`` received shards with data missing."""

    def __init__(self, data_shards: int = 10, parity_shards: int = 3,
                 window: int = 256) -> None:
        self.rs = get_rs(data_shards, parity_shards)
        self.n = data_shards + parity_shards
        import collections

        self.window = window  # remembered groups (anti-memory-growth)
        self._groups: dict[int, list[bytes | None]] = {}
        # FIFO-bounded: done-markers must not outlive the window (a late
        # duplicate for a forgotten group merely re-feeds kcp, which
        # dedups by sn).
        self._done: collections.OrderedDict = collections.OrderedDict()

    def decode(self, pkt: bytes) -> list[bytes]:
        """Feed one received datagram; returns kcp-ready payloads (the
        packet's own payload if it is a data shard, plus any payloads
        recovered by FEC reconstruction).

        Hostile header/size fields are bounds-checked BEFORE any slicing
        or group bookkeeping and dropped with a per-reason count on
        ``fec_malformed_dropped_total`` — a forged size/length must never
        reach the RS padding math or kcp."""
        if len(pkt) < DATA_OFF:
            _MALFORMED.labels("runt").inc()
            return []
        seqid, flag = HEADER.unpack_from(pkt)
        if flag not in (TYPE_DATA, TYPE_PARITY):
            _MALFORMED.labels("bad_flag").inc()
            return []
        if len(pkt) - HEADER_SIZE > MAX_SHARD:
            _MALFORMED.labels("oversize").inc()
            return []
        out = []
        if flag == TYPE_DATA:
            # The declared size counts itself + payload; an honest sender
            # always writes exactly len(shard). Larger means a forged
            # field (would mis-trim peers' reconstructions), smaller than
            # the 2-byte prefix is nonsense — drop both.
            (size,) = struct.unpack_from("<H", pkt, SIZE_OFF)
            if size < 2 or size > len(pkt) - HEADER_SIZE:
                _MALFORMED.labels("size_field").inc()
                return []
            out.append(pkt[DATA_OFF:])
        group = seqid - (seqid % self.n)
        idx = seqid % self.n
        if self._done.get(group):
            return out
        entry = self._groups.get(group)
        if entry is None:
            # [shards, have, data_have]: counters tracked on insert, not
            # recounted per datagram (per-datagram hot path).
            entry = self._groups.setdefault(
                group, [[None] * self.n, 0, 0])
            # Bound memory: evict the oldest-INSERTED group beyond the
            # window (dict insertion order) — NOT min(): after the
            # encoder's seqid wrap, new groups have small ids and min()
            # would evict every new group on arrival, silently killing
            # recovery for the rest of the connection (code-review r5).
            while len(self._groups) > self.window:
                old = next(iter(self._groups))
                self._groups.pop(old, None)
                self._done.pop(old, None)
        shards = entry[0]
        if shards[idx] is None:
            shards[idx] = pkt[HEADER_SIZE:]
            entry[1] += 1
            if idx < self.rs.d:
                entry[2] += 1
        have, data_have = entry[1], entry[2]
        if have >= self.rs.d and data_have < self.rs.d:
            maxlen = max(len(s) for s in shards if s is not None)
            padded = [s.ljust(maxlen, b"\x00") if s is not None else None
                      for s in shards]
            try:
                data = self.rs.reconstruct(padded)
            except ValueError:
                return out
            for i in range(self.rs.d):
                if shards[i] is None:
                    (size,) = struct.unpack_from("<H", data[i])
                    if 2 <= size <= len(data[i]):
                        out.append(data[i][2:size])
            self._mark_done(group)
        elif data_have == self.rs.d:
            self._mark_done(group)
        return out

    def _mark_done(self, group: int) -> None:
        self._groups.pop(group, None)
        self._done[group] = True
        while len(self._done) > self.window:
            self._done.popitem(last=False)
