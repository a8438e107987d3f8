"""The port's wire against the JAX package's, byte for byte.

For messages made from a seed: the framing (the native C module and the
pure-Python ``pyframe``), ``Packet`` payloads, the msgpack codec and the
typed senders of ``proto.conn`` give the same bytes in both packages, and
each package decodes the other's frames and payloads. The recv seam of
``proto.conn`` strips a trace trailer the same way in both packages.
"""

from __future__ import annotations

import asyncio
import random

import pytest

import goworld_tpu.native as jnative
import goworld_tpu.native.pyframe as jpyframe
import goworld_tpu.netutil.msgpacker as jmsgpacker
import goworld_tpu.netutil.packet as jpacket
import goworld_tpu.netutil.packet_conn as jpacket_conn
import goworld_tpu.proto.conn as jconn
import goworld_tpu.proto.msgtypes as jmsgtypes
import goworld_tpu.telemetry.tracing as jtracing
import goworld_tpu_torch.native as tnative
import goworld_tpu_torch.native.pyframe as tpyframe
import goworld_tpu_torch.netutil.msgpacker as tmsgpacker
import goworld_tpu_torch.netutil.packet as tpacket
import goworld_tpu_torch.netutil.packet_conn as tpacket_conn
import goworld_tpu_torch.proto.conn as tconn
import goworld_tpu_torch.proto.msgtypes as tmsgtypes
import goworld_tpu_torch.telemetry.tracing as ttracing

MAXP = 25 * 1024 * 1024
ALPHA = "0123456789abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ-_"


def frames_of(seed: int) -> list[tuple[int, bytes, int]]:
    rng = random.Random(seed)
    out = []
    for _ in range(200):
        n = rng.choice([0, 1, 2, 63, 64, 256, 1000, 5000, 70000])
        chunk = bytes(rng.getrandbits(8) for _ in range(min(n, 200)))
        out.append((rng.randrange(0, 65536),
                    (chunk * max(1, n // 200))[:n], rng.choice([0, 1, 2])))
    return out


def impls():
    return {
        "jax-native": (jnative.pack, jnative.split),
        "jax-pyframe": (jpyframe.pack, jpyframe.split),
        "port-native": (tnative.pack, tnative.split),
        "port-pyframe": (tpyframe.pack, tpyframe.split),
    }


def test_native_framing_is_built_in_both_packages():
    assert jnative.IMPL == tnative.IMPL == "c"


@pytest.mark.parametrize("seed", [0, 1])
def test_framing_bytes_equal_and_cross_decode(seed):
    msgs = frames_of(seed)
    streams = {
        name: b"".join(pack(mt, pl, c, 64, MAXP) for mt, pl, c in msgs)
        for name, (pack, _) in impls().items()
    }
    # The same implementation gives the same bytes in both packages (the C
    # and Python snappy codecs need not agree with each other).
    assert streams["jax-native"] == streams["port-native"]
    assert streams["jax-pyframe"] == streams["port-pyframe"]
    for sname, (_, split) in impls().items():
        for pname, stream in streams.items():
            frames, consumed, err = split(stream, MAXP)
            assert err is None and consumed == len(stream), (pname, sname)
            assert [(mt, bytes(p)) for mt, p in frames] == [
                (mt, pl) for mt, pl, _ in msgs], (pname, sname)


def random_obj(rng: random.Random, depth: int = 0, int_keys: bool = True):
    """A msgpack-able object. RPC args (``Packet.read_data``) take string
    map keys only, so ``int_keys=False`` for them."""
    kinds = ["nil", "bool", "int", "float", "str", "bin"]
    if depth < 3:
        kinds += ["array", "map"]
    k = rng.choice(kinds)
    if k == "nil":
        return None
    if k == "bool":
        return rng.random() < 0.5
    if k == "int":
        return rng.choice([rng.randrange(-40, 200),
                           rng.randrange(-2 ** 63, 2 ** 64)])
    if k == "float":
        return rng.uniform(-1e9, 1e9)
    if k == "str":
        return "".join(rng.choice(ALPHA + "é漢 ") for _ in
                       range(rng.choice([0, 5, 40, 300])))
    if k == "bin":
        return bytes(rng.getrandbits(8) for _ in range(rng.choice([0, 7, 300])))
    if k == "array":
        return [random_obj(rng, depth + 1, int_keys)
                for _ in range(rng.randrange(0, 20))]
    keys = [str(rng.random())]
    if int_keys:
        keys.append(rng.randrange(100))
    return {rng.choice(keys): random_obj(rng, depth + 1, int_keys)
            for _ in range(rng.randrange(0, 20))}


def test_msgpack_bytes_equal_and_cross_decode():
    rng = random.Random(5)
    for _ in range(300):
        obj = random_obj(rng)
        a, b = jmsgpacker.pack_msg(obj), tmsgpacker.pack_msg(obj)
        assert a == b
        assert tmsgpacker.unpack_msg(a) == jmsgpacker.unpack_msg(b) == obj


def eid(rng: random.Random) -> str:
    return "".join(rng.choice(ALPHA) for _ in range(16))


def fill_packet(mod, seed: int):
    """The same seeded sequence of appends on one package's Packet."""
    rng = random.Random(seed)
    p = mod.Packet()
    for _ in range(120):
        op = rng.randrange(10)
        if op == 0:
            p.append_byte(rng.randrange(256))
        elif op == 1:
            p.append_bool(rng.random() < 0.5)
        elif op == 2:
            p.append_uint16(rng.randrange(2 ** 16))
        elif op == 3:
            p.append_uint32(rng.randrange(2 ** 32))
        elif op == 4:
            p.append_uint64(rng.randrange(2 ** 64))
        elif op == 5:
            p.append_float32(rng.uniform(-1e6, 1e6))
        elif op == 6:
            p.append_float64(rng.uniform(-1e6, 1e6))
        elif op == 7:
            p.append_varstr("".join(rng.choice(ALPHA) for _ in range(9)))
        elif op == 8:
            p.append_entity_id(eid(rng))
        else:
            p.append_args(tuple(random_obj(rng, 2, False) for _ in range(3)))
    return p


def read_back(mod, payload: bytes, seed: int) -> list:
    rng = random.Random(seed)
    p = mod.Packet(payload)
    out = []
    for _ in range(120):
        op = rng.randrange(10)
        if op == 0:
            rng.randrange(256)
            out.append(p.read_byte())
        elif op == 1:
            rng.random()
            out.append(p.read_bool())
        elif op == 2:
            rng.randrange(2 ** 16)
            out.append(p.read_uint16())
        elif op == 3:
            rng.randrange(2 ** 32)
            out.append(p.read_uint32())
        elif op == 4:
            rng.randrange(2 ** 64)
            out.append(p.read_uint64())
        elif op == 5:
            rng.uniform(-1e6, 1e6)
            out.append(p.read_float32())
        elif op == 6:
            rng.uniform(-1e6, 1e6)
            out.append(p.read_float64())
        elif op == 7:
            [rng.choice(ALPHA) for _ in range(9)]
            out.append(p.read_varstr())
        elif op == 8:
            eid(rng)
            out.append(p.read_entity_id())
        else:
            [random_obj(rng, 2, False) for _ in range(3)]
            out.append(p.read_args())
    assert p.unread_len() == 0
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_packet_bytes_equal_and_cross_decode(seed):
    a = fill_packet(jpacket, seed).payload
    b = fill_packet(tpacket, seed).payload
    assert a == b
    assert read_back(tpacket, a, seed) == read_back(jpacket, b, seed)


class Recorder:
    """A PacketConnection stand-in: records what the typed senders send."""

    def __init__(self):
        self.sent = []

    def send_packet(self, msgtype, packet):
        self.sent.append((msgtype, bytes(packet.payload)))


def drive_senders(mod, seed: int) -> list:
    rng = random.Random(seed)
    rec = Recorder()
    gc = mod.GoWorldConnection(rec)
    a, b, c = eid(rng), eid(rng), eid(rng)
    args = tuple(random_obj(rng, 2, False) for _ in range(4))
    attrs = {"name": "x", "hp": 7, "pos": [1.5, 2.5]}
    gc.send_set_game_id(3, False, True, False, [a, b])
    gc.send_set_gate_id(2)
    gc.send_notify_create_entity(a)
    gc.send_notify_destroy_entity(b)
    gc.send_notify_client_connected(c, 2, a)
    gc.send_notify_client_disconnected(c, a)
    gc.send_call_entity_method(a, "Hello", args)
    gc.send_call_entity_method_from_client(a, "Login_Client", args, c)
    gc.send_call_nil_spaces(1, "Broadcast", args)
    gc.send_create_entity_somewhere(2, "Avatar", b, attrs)
    gc.send_load_entity_somewhere("Account", c, 1)
    rec.sent.append(("sync", mod.pack_sync_record(a, 1.0, 2.0, 3.0, 0.5)))
    return rec.sent


@pytest.mark.parametrize("seed", [0, 1])
def test_typed_senders_give_equal_packets(seed):
    assert drive_senders(jconn, seed) == drive_senders(tconn, seed)


PACKAGES = {
    "jax": (jpacket, jpacket_conn, jconn, jmsgtypes, jtracing),
    "port": (tpacket, tpacket_conn, tconn, tmsgtypes, ttracing),
}


async def recv_through_seam(receiver, sender, frames):
    """``frames`` ([(msgtype, payload)]) sent by a server-side
    ``PacketConnection`` of the ``sender`` package to a client
    ``GoWorldConnection`` of the ``receiver`` package over localhost TCP:
    what the client's recv seam returns, one (msgtype, payload, trace ids)
    a frame. The server-side connection is closed before ``wait_closed``,
    which otherwise waits for it forever (Python 3.12.1 on)."""
    packet, packet_conn = PACKAGES[sender][:2]
    conn_mod = PACKAGES[receiver][2]
    accepted = asyncio.Queue()

    async def on_conn(reader, writer):
        await accepted.put(packet_conn.PacketConnection(reader, writer))

    server = await asyncio.start_server(on_conn, "127.0.0.1", 0)
    port = server.sockets[0].getsockname()[1]
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    client = conn_mod.GoWorldConnection(
        PACKAGES[receiver][1].PacketConnection(reader, writer))
    server_side = await asyncio.wait_for(accepted.get(), 5)
    try:
        for msgtype, payload in frames:
            server_side.send_packet(msgtype, packet.Packet(payload))
        server_side.flush()
        out = []
        for _ in frames:
            msgtype, p = await asyncio.wait_for(client.recv(), 5)
            trace = None if p.trace is None else (
                p.trace.trace_id, p.trace.span_id, p.trace.flags,
                p.trace.born is not None)
            out.append((int(msgtype), bytes(p.payload), trace))
        return out
    finally:
        server_side.close()
        writer.close()
        server.close()
        await server.wait_closed()


@pytest.mark.parametrize("sender", ["jax", "port"])
def test_recv_seam_strips_the_trace_trailer_in_both_packages(sender):
    """A flagged (v4) frame, the payload then the trailer, decodes to the
    unflagged msgtype and the payload with its trace ids attached; the
    plain frame passes untouched. The same frames, sent by either
    package's connection, give the same results through each package's
    seam."""
    assert jmsgtypes.MSGTYPE_TRACE_FLAG == tmsgtypes.MSGTYPE_TRACE_FLAG
    call = int(jmsgtypes.MsgType.CALL_ENTITY_METHOD)
    assert call == int(tmsgtypes.MsgType.CALL_ENTITY_METHOD)
    body = b"hello-payload"
    trailer = jtracing.encode_trailer(jtracing.TraceContext(0xABCD, 0x1234))
    assert trailer == ttracing.encode_trailer(
        ttracing.TraceContext(0xABCD, 0x1234))
    frames = [(call | jmsgtypes.MSGTYPE_TRACE_FLAG, body + trailer),
              (call, body)]

    async def both():
        return {receiver: await recv_through_seam(receiver, sender, frames)
                for receiver in PACKAGES}

    got = asyncio.run(asyncio.wait_for(both(), 20))
    want = [(call, body, (0xABCD, 0x1234, jtracing.FLAG_SAMPLED, True)),
            (call, body, None)]
    assert got["jax"] == got["port"] == want
