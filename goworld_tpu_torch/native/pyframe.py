"""Pure-Python reference implementation of the _fastframe surface.

Semantics must match fastframe.c exactly — the parity fuzz suite in
tests/test_native.py drives both over the same corpus. This is also the
fallback when the C module can't build (GWT_NO_NATIVE=1, no compiler).

Compression formats (``compress`` arg of :func:`pack`): 0/False = off,
1 = zlib (deflate level 1), 2 = snappy — the reference's actual gate↔client
codec (ClientProxy.go:42-45 wraps conns in snappy streams). The snappy
block-format codec here is from scratch (the library isn't in the image):
format per the public Snappy format description — varint uncompressed-length
preamble, then literal/copy elements (tag low 2 bits: 00 literal, 01 copy
with 11-bit offset, 10 copy with 2-byte offset, 11 copy with 4-byte
offset). The receive side auto-detects per packet via two length-prefix
flag bits, so enabling either format stays one-sided safe.
"""

from __future__ import annotations

import struct
import zlib

_LEN = struct.Struct("<I")
_ZLIB_BIT = 0x80000000
_SNAPPY_BIT = 0x40000000
_LEN_MASK = 0x3FFFFFFF

COMPRESS_OFF = 0
COMPRESS_ZLIB = 1
COMPRESS_SNAPPY = 2

_SNAPPY_BLOCK = 32768  # fragment size: every offset fits a 2-byte copy


# --- snappy block codec ------------------------------------------------------


def _snappy_emit_literal(out: bytearray, data: bytes, s: int, e: int) -> None:
    length = e - s
    if length <= 0:
        return
    n1 = length - 1
    if n1 < 60:
        out.append(n1 << 2)
    elif n1 < 0x100:
        out.append(60 << 2)
        out.append(n1)
    else:  # length <= 32768+preamble slack: two bytes always suffice
        out.append(61 << 2)
        out.append(n1 & 0xFF)
        out.append((n1 >> 8) & 0xFF)
    out += data[s:e]


def _snappy_emit_copy(out: bytearray, offset: int, length: int) -> None:
    # Long matches: 64-byte chunks, leaving a >=4 remainder (emitting 60
    # instead of 64 when the tail would drop under 4 — copies can't encode
    # lengths 1..3).
    while length >= 68:
        out.append((63 << 2) | 2)
        out.append(offset & 0xFF)
        out.append((offset >> 8) & 0xFF)
        length -= 64
    if length > 64:
        out.append((59 << 2) | 2)
        out.append(offset & 0xFF)
        out.append((offset >> 8) & 0xFF)
        length -= 60
    if length <= 11 and offset < 2048:
        out.append(1 | ((length - 4) << 2) | ((offset >> 8) << 5))
        out.append(offset & 0xFF)
    else:
        out.append(((length - 1) << 2) | 2)
        out.append(offset & 0xFF)
        out.append((offset >> 8) & 0xFF)


def snappy_compress(data: bytes) -> bytes:
    """Snappy block-format compress (greedy 4-byte-hash matcher, 32 KiB
    fragments like the standard encoder so offsets fit 2 bytes)."""
    out = bytearray()
    n = len(data)
    v = n
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)
    i = 0
    while i < n:
        base = i
        block_end = min(i + _SNAPPY_BLOCK, n)
        table: dict[bytes, int] = {}
        lit_start = i
        while i < block_end:
            if block_end - i < 4:
                i = block_end
                break
            key = data[i:i + 4]
            cand = table.get(key, -1)
            table[key] = i
            if cand >= base:
                _snappy_emit_literal(out, data, lit_start, i)
                m, c = i + 4, cand + 4
                while m < block_end and data[m] == data[c]:
                    m += 1
                    c += 1
                _snappy_emit_copy(out, i - cand, m - i)
                i = m
                lit_start = i
            else:
                i += 1
        _snappy_emit_literal(out, data, lit_start, block_end)
    return bytes(out)


def snappy_decompress(data: bytes, cap: int) -> bytes:
    """Decode a snappy block; raises ValueError on malformed input or when
    the declared/produced size exceeds ``cap`` (decompression-bomb guard,
    same contract as the bounded zlib inflate)."""
    n = len(data)
    ulen = 0
    shift = 0
    i = 0
    while True:
        if i >= n or shift > 31:
            raise ValueError("bad snappy preamble")
        b = data[i]
        i += 1
        ulen |= (b & 0x7F) << shift
        if not b & 0x80:
            break
        shift += 7
    if ulen > cap:
        raise ValueError("compressed packet exceeds size cap")
    out = bytearray()
    while i < n:
        t = data[i]
        i += 1
        typ = t & 3
        if typ == 0:  # literal
            ln = t >> 2
            if ln >= 60:
                nb = ln - 59
                if i + nb > n:
                    raise ValueError("bad snappy stream")
                ln = int.from_bytes(data[i:i + nb], "little")
                i += nb
            ln += 1
            if i + ln > n or len(out) + ln > ulen:
                raise ValueError("bad snappy stream")
            out += data[i:i + ln]
            i += ln
            continue
        if typ == 1:
            if i >= n:
                raise ValueError("bad snappy stream")
            ln = ((t >> 2) & 7) + 4
            off = ((t >> 5) << 8) | data[i]
            i += 1
        elif typ == 2:
            if i + 2 > n:
                raise ValueError("bad snappy stream")
            ln = (t >> 2) + 1
            off = data[i] | (data[i + 1] << 8)
            i += 2
        else:
            if i + 4 > n:
                raise ValueError("bad snappy stream")
            ln = (t >> 2) + 1
            off = int.from_bytes(data[i:i + 4], "little")
            i += 4
        pos = len(out)
        if off == 0 or off > pos or pos + ln > ulen:
            raise ValueError("bad snappy stream")
        if off >= ln:
            start = pos - off
            out += out[start:start + ln]
        else:  # overlapping copy replicates the tail pattern bytewise
            for _ in range(ln):
                out.append(out[-off])
    if len(out) != ulen:
        raise ValueError("bad snappy stream")
    return bytes(out)


# --- framing -----------------------------------------------------------------


def split(data, max_packet: int):
    """Parse complete frames out of ``data``.

    Returns (frames, consumed, error) where frames =
    [(msgtype, payload_bytes)] and error is None or a str describing the
    malformed frame parsing STOPPED at (bad length, bad compressed stream,
    bounded-decompress overflow). Frames parsed before the malformed one
    are still returned — callers deliver them, then treat error as a
    connection-fatal condition.
    """
    buf = bytes(data)
    frames = []
    off = 0
    n = len(buf)
    while n - off >= 4:
        (raw,) = _LEN.unpack_from(buf, off)
        is_zlib = bool(raw & _ZLIB_BIT)
        is_snappy = bool(raw & _SNAPPY_BIT)
        body_len = raw & _LEN_MASK
        if is_zlib and is_snappy:
            return frames, off, "bad packet flags"
        if body_len < 2 or body_len > max_packet:
            return frames, off, f"bad packet length {body_len}"
        if n - off - 4 < body_len:
            break  # incomplete frame
        body = buf[off + 4 : off + 4 + body_len]
        if is_zlib:
            try:
                d = zlib.decompressobj()
                body = d.decompress(body, max_packet)
                if d.unconsumed_tail or not d.eof:
                    return frames, off, "compressed packet exceeds size cap"
            except zlib.error as exc:
                return frames, off, f"bad compressed packet: {exc}"
            if len(body) < 2:
                return frames, off, "bad decompressed length"
        elif is_snappy:
            try:
                body = snappy_decompress(body, max_packet)
            except ValueError as exc:
                return frames, off, str(exc)
            if len(body) < 2:
                return frames, off, "bad decompressed length"
        msgtype = body[0] | (body[1] << 8)
        frames.append((msgtype, body[2:]))
        off += 4 + body_len
    return frames, off, None


def pack(msgtype: int, payload, compress, threshold: int,
         max_packet: int) -> bytes:
    """Build one framed buffer.

    ``compress``: 0/False off, 1/True zlib (level 1), 2 snappy — the body
    is compressed when it reaches ``threshold`` AND the codec actually
    shrinks it (the flag bit tells the receiver which codec, per packet).
    """
    if not 0 <= msgtype <= 0xFFFF:
        raise ValueError(f"msgtype {msgtype} out of u16 range")
    payload = bytes(payload)
    body = struct.pack("<H", msgtype) + payload
    if len(body) > max_packet:
        raise ValueError(f"packet too large: {len(body)}")
    flag = 0
    mode = int(compress)
    if mode and len(body) >= threshold:
        if mode == COMPRESS_SNAPPY:
            packed = snappy_compress(body)
            if len(packed) < len(body):
                body = packed
                flag = _SNAPPY_BIT
        else:
            deflated = zlib.compress(body, 1)
            if len(deflated) < len(body):
                body = deflated
                flag = _ZLIB_BIT
    return _LEN.pack(len(body) | flag) + body
