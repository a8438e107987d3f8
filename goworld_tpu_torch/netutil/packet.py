"""Binary packet buffer with typed append/read codecs.

Reference parity: ``engine/netutil/Packet.go:83-89,210-503`` — a growable
payload buffer written with AppendUint16/AppendFloat32/AppendEntityID/
AppendVarStr/AppendData(msgpack)/AppendArgs and read back with the matching
Read* calls. The reference pools packets for GC pressure; in Python we rely
on bytearray and keep the same API shape (the hot path — position syncs —
batches many records into one packet exactly like the reference,
proto.go:135-139).

All integers little-endian, matching the reference's PACKET_ENDIAN.
"""

from __future__ import annotations

import struct

import msgpack

from goworld_tpu_torch import consts
from goworld_tpu_torch.common import ENTITYID_LENGTH

_U16 = struct.Struct("<H")
_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")
_F32 = struct.Struct("<f")
_F64 = struct.Struct("<d")


class PacketReadError(ValueError, IndexError):
    """A read past the end of a packet payload (truncated/hostile frame).

    Subclasses BOTH ValueError (the parser contract every wire module
    follows — gwlint R3, and the schema fuzz in tests/test_modelcheck.py:
    short or mutated buffers raise ValueError, never a bare struct.error
    or IndexError) and IndexError (what this seam raised historically, so
    existing catchers keep working)."""


class Packet:
    """Append-only write + cursor read packet payload.

    A packet constructed from ``bytes`` keeps that object as its buffer
    without copying: the dominant packet population — received frames that
    are only read and/or forwarded verbatim (the dispatcher's entire
    routing plane) — then pays ZERO payload copies end to end, because
    :attr:`payload` hands the same immutable object back out. The first
    append (or trailer strip) transparently converts to a private
    bytearray, so writers keep the exact legacy semantics."""

    __slots__ = ("_buf", "_rpos", "trace")

    def __init__(self, payload: bytes | bytearray | None = None) -> None:
        if payload is None or not len(payload):
            self._buf: bytes | bytearray = bytearray()
        elif type(payload) is bytes:
            self._buf = payload  # zero-copy read/forward fast path
        else:
            self._buf = bytearray(payload)
        self._rpos = 0
        # TraceContext attached by the recv seam when the wire msgtype
        # carried the tracing-trailer flag (telemetry/tracing.py); None
        # for the overwhelming majority of packets.
        self.trace = None

    def _wbuf(self) -> bytearray:
        """The mutable buffer, converting a shared read-only one on the
        first write (copy-on-write seam for the zero-copy constructor)."""
        if type(self._buf) is not bytearray:
            self._buf = bytearray(self._buf)
        return self._buf

    def pop_tail(self, n: int) -> bytes:
        """Remove and return the last ``n`` payload bytes (trailer strip)."""
        buf = self._wbuf()
        tail = bytes(buf[-n:])
        del buf[-n:]
        return tail

    # --- lifecycle ---------------------------------------------------------

    @property
    def payload(self) -> bytes:
        buf = self._buf
        return buf if type(buf) is bytes else bytes(buf)

    def payload_len(self) -> int:
        return len(self._buf)

    def unread_len(self) -> int:
        return len(self._buf) - self._rpos

    def set_read_pos(self, pos: int) -> None:
        self._rpos = pos

    # --- append ------------------------------------------------------------

    def append_byte(self, v: int) -> "Packet":
        self._wbuf().append(v & 0xFF)
        return self

    def append_bool(self, v: bool) -> "Packet":
        return self.append_byte(1 if v else 0)

    def append_uint16(self, v: int) -> "Packet":
        self._wbuf().extend(_U16.pack(v))
        return self

    def append_uint32(self, v: int) -> "Packet":
        self._wbuf().extend(_U32.pack(v))
        return self

    def append_uint64(self, v: int) -> "Packet":
        self._wbuf().extend(_U64.pack(v))
        return self

    def append_float32(self, v: float) -> "Packet":
        self._wbuf().extend(_F32.pack(v))
        return self

    def append_float64(self, v: float) -> "Packet":
        self._wbuf().extend(_F64.pack(v))
        return self

    def append_bytes(self, v: bytes) -> "Packet":
        self._wbuf().extend(v)
        return self

    def append_varbytes(self, v: bytes) -> "Packet":
        self.append_uint32(len(v))
        self._wbuf().extend(v)
        return self

    def append_varstr(self, v: str) -> "Packet":
        return self.append_varbytes(v.encode("utf-8"))

    def append_entity_id(self, eid: str) -> "Packet":
        b = eid.encode("ascii")
        if len(b) != ENTITYID_LENGTH:
            raise ValueError(f"bad entity id {eid!r}")
        self._wbuf().extend(b)
        return self

    def append_client_id(self, cid: str) -> "Packet":
        return self.append_entity_id(cid)

    def append_data(self, obj) -> "Packet":
        """Append a msgpack-encoded object (reference AppendData,
        Packet.go:419-437)."""
        return self.append_varbytes(
            msgpack.packb(obj, use_bin_type=True)
        )

    def append_args(self, args: tuple | list) -> "Packet":
        """Append RPC args: u16 count + one msgpack blob each
        (reference AppendArgs)."""
        self.append_uint16(len(args))
        for a in args:
            self.append_data(a)
        return self

    # --- read --------------------------------------------------------------

    def _take(self, n: int) -> memoryview:
        if self._rpos + n > len(self._buf):
            raise PacketReadError("packet read overflow")
        mv = memoryview(self._buf)[self._rpos : self._rpos + n]
        self._rpos += n
        return mv

    def read_byte(self) -> int:
        return self._take(1)[0]

    def read_bool(self) -> bool:
        return self.read_byte() != 0

    def read_uint16(self) -> int:
        return _U16.unpack(self._take(2))[0]

    def read_uint32(self) -> int:
        return _U32.unpack(self._take(4))[0]

    def read_uint64(self) -> int:
        return _U64.unpack(self._take(8))[0]

    def read_float32(self) -> float:
        return _F32.unpack(self._take(4))[0]

    def read_float64(self) -> float:
        return _F64.unpack(self._take(8))[0]

    def read_bytes(self, n: int) -> bytes:
        return bytes(self._take(n))

    def read_varbytes(self) -> bytes:
        n = self.read_uint32()
        if n > consts.MAX_PACKET_SIZE:
            raise ValueError(f"varbytes length {n} exceeds max packet size")
        return self.read_bytes(n)

    def read_varstr(self) -> str:
        return self.read_varbytes().decode("utf-8")

    def read_entity_id(self) -> str:
        return bytes(self._take(ENTITYID_LENGTH)).decode("ascii")

    def read_client_id(self) -> str:
        return self.read_entity_id()

    def read_data(self):
        blob = self.read_varbytes()
        try:
            return msgpack.unpackb(blob, raw=False)
        except ValueError:
            raise
        except Exception as exc:
            # msgpack's truncation/garbage errors are mostly ValueError
            # subclasses already; normalize the stragglers (OutOfData,
            # BufferFull derive from bare UnpackException) so every wire
            # parser keeps the raise-ValueError contract.
            raise PacketReadError(f"malformed msgpack payload: {exc}") from exc

    def read_args(self) -> list:
        n = self.read_uint16()
        return [self.read_data() for _ in range(n)]

    def read_rest(self) -> bytes:
        return self.read_bytes(self.unread_len())
