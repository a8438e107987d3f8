"""Minimal BSON codec (the subset entity/kv documents need).

Support layer for the from-scratch MongoDB client (netutil/mongo.py) — the
reference ships mgo-driver-backed mongodb backends; this image has no
driver, so the wire format is implemented directly (SURVEY.md §2.4 in-repo
equivalents rule).

Types: double, string, embedded document, array, bool, null, int32, int64.
Documents decode to dict, arrays to list; ints decode to int, doubles to
float. Encoding chooses int32/int64 by range and rejects unsupported types
loudly (entities serialize to exactly this subset — attrs.py uniformizes
values to int/float/bool/str/dict/list).
"""

from __future__ import annotations

import struct

_DOUBLE = 0x01
_STRING = 0x02
_DOC = 0x03
_ARRAY = 0x04
_BOOL = 0x08
_NULL = 0x0A
_INT32 = 0x10
_INT64 = 0x12

_I32 = struct.Struct("<i")
_I64 = struct.Struct("<q")
_F64 = struct.Struct("<d")


def _encode_value(out: bytearray, key: str, val) -> None:
    kb = key.encode("utf-8") + b"\x00"
    if isinstance(val, bool):  # before int: bool is an int subclass
        out += bytes([_BOOL]) + kb + (b"\x01" if val else b"\x00")
    elif isinstance(val, int):
        if -(2**31) <= val < 2**31:
            out += bytes([_INT32]) + kb + _I32.pack(val)
        else:
            out += bytes([_INT64]) + kb + _I64.pack(val)
    elif isinstance(val, float):
        out += bytes([_DOUBLE]) + kb + _F64.pack(val)
    elif isinstance(val, str):
        vb = val.encode("utf-8") + b"\x00"
        out += bytes([_STRING]) + kb + _I32.pack(len(vb)) + vb
    elif val is None:
        out += bytes([_NULL]) + kb
    elif isinstance(val, dict):
        out += bytes([_DOC]) + kb + encode(val)
    elif isinstance(val, (list, tuple)):
        out += bytes([_ARRAY]) + kb + encode(
            {str(i): v for i, v in enumerate(val)}
        )
    else:
        raise TypeError(f"bson: unsupported type {type(val).__name__} for {key!r}")


def encode(doc: dict) -> bytes:
    body = bytearray()
    for key, val in doc.items():
        _encode_value(body, str(key), val)
    return _I32.pack(len(body) + 5) + bytes(body) + b"\x00"


def _need(data: bytes, off: int, n: int) -> None:
    """Bounds guard: every wire-derived offset/length passes through here
    before a read, so a truncated or hostile document raises ValueError
    (like the unsupported-type path) instead of struct.error/IndexError
    out of the storage worker's decode."""
    if off < 0 or n < 0 or off + n > len(data):
        raise ValueError(
            f"bson: truncated document (need {n} bytes at {off}, "
            f"have {len(data)})")


def _read_cstring(data: bytes, off: int) -> tuple[str, int]:
    end = data.index(b"\x00", off)  # raises ValueError when unterminated
    return data[off:end].decode("utf-8"), end + 1


def _decode_value(kind: int, data: bytes, off: int):
    if kind == _DOUBLE:
        _need(data, off, 8)
        return _F64.unpack_from(data, off)[0], off + 8
    if kind == _STRING:
        _need(data, off, 4)
        (n,) = _I32.unpack_from(data, off)
        if n < 1:
            raise ValueError(f"bson: invalid string length {n}")
        _need(data, off + 4, n)
        s = data[off + 4:off + 4 + n - 1].decode("utf-8")
        return s, off + 4 + n
    if kind == _DOC:
        doc, n = _decode_doc(data, off)
        return doc, n
    if kind == _ARRAY:
        doc, n = _decode_doc(data, off)
        return [doc[k] for k in sorted(doc, key=int)], n
    if kind == _BOOL:
        _need(data, off, 1)
        return data[off] != 0, off + 1
    if kind == _NULL:
        return None, off
    if kind == _INT32:
        _need(data, off, 4)
        return _I32.unpack_from(data, off)[0], off + 4
    if kind == _INT64:
        _need(data, off, 8)
        return _I64.unpack_from(data, off)[0], off + 8
    raise ValueError(f"bson: unsupported element type 0x{kind:02x}")


def _decode_doc(data: bytes, off: int) -> tuple[dict, int]:
    _need(data, off, 4)
    (total,) = _I32.unpack_from(data, off)
    if total < 5:
        raise ValueError(f"bson: invalid document length {total}")
    _need(data, off, total)
    end = off + total - 1  # position of the trailing NUL
    off += 4
    doc: dict = {}
    while off < end:
        _need(data, off, 1)
        kind = data[off]
        key, off = _read_cstring(data, off + 1)
        doc[key], off = _decode_value(kind, data, off)
    return doc, end + 1


def decode(data: bytes) -> dict:
    doc, _ = _decode_doc(data, 0)
    return doc
