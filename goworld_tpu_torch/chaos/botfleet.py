"""Subprocess bot fleets: thousands of REAL client sockets for the
massive fan-out floor (``bench.py --fanout-massive``).

The ``--multigame`` move applied to the CLIENT side: one parent process
cannot pump 1000+ asyncio sockets beside an in-process cluster on a small
host, so the bots live in K fleet subprocesses of N bots each, each a full
:class:`goworld_tpu_torch.client.ClientBot` (entity mirrors, keyframe/delta
decode, strict protocol checks) — not a byte-counting stub. The parent
drives fleets over a line-oriented JSON stdio protocol:

    parent -> child   {"cmd": "report"}
                      {"cmd": "reconnect_dead"}
                      {"cmd": "quit"}
    child -> parent   one JSON object per command (see _report)

plus a spontaneous ``{"ready": N}`` line once every bot's socket is
connected. Counters of interest per fleet: delivered sync records split
keyframe/delta, client-wire sync payload bytes (the bytes/client/s
numerator), players assigned, live sockets, and protocol errors — a delta
record arriving before any keyframe (stale baseline) is counted as an
error by the ClientBot decode, which is exactly the reconnect-storm
assertion.

Run directly:  python -m goworld_tpu_torch.chaos.botfleet --gates 7001,7002 \
                      --bots 252 [--host 127.0.0.1] [--stagger-ms 3]
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
import threading
from typing import Optional

from goworld_tpu_torch.client.client import ClientBot
from goworld_tpu_torch.netutil.packet import Packet
from goworld_tpu_torch.proto.msgtypes import MsgType


class CountingBot(ClientBot):
    """ClientBot plus fleet counters (records + client-wire sync bytes)."""

    def __init__(self, name: str, gate_index: int) -> None:
        # Long heartbeat: 1000 bots heartbeating every 5 s is pure noise
        # next to the sync streams being measured; the gates in the
        # massive harness run with heartbeat kills disabled.
        super().__init__(name=name, strict=False, heartbeat_interval=30.0)
        self.gate_index = gate_index
        self.sync_bytes = 0
        self.sync_packets = 0
        # A remote close surfaces only as the recv pump exiting (the
        # conn object's closed flag is set by local close/send errors),
        # so liveness is tracked at the pump.
        self.dead = False

    async def connect(self, host: str, port: int) -> None:
        self.dead = False
        await super().connect(host, port)

    async def _recv_loop(self) -> None:
        try:
            await super()._recv_loop()
        finally:
            self.dead = True

    def _handle(self, msgtype: int, packet: Packet) -> None:
        if msgtype in (MsgType.SYNC_POSITION_YAW_ON_CLIENTS,
                       MsgType.SYNC_POSITION_YAW_DELTA_ON_CLIENTS):
            self.sync_bytes += packet.payload_len()
            self.sync_packets += 1
        super()._handle(msgtype, packet)

    @property
    def alive(self) -> bool:
        return (not self.dead and self.conn is not None
                and not self.conn.closed)


class Fleet:
    """The child-process side: N bots across the given gate ports."""

    def __init__(self, host: str, ports: list[int], n_bots: int,
                 stagger_ms: float) -> None:
        self.host = host
        self.ports = ports
        self.n_bots = n_bots
        self.stagger = stagger_ms / 1000.0
        self.bots: list[CountingBot] = []

    async def connect_all(self) -> None:
        for i in range(self.n_bots):
            bot = CountingBot(f"fleet-bot{i}", i % len(self.ports))
            self.bots.append(bot)
            await bot.connect(self.host, self.ports[bot.gate_index])
            if self.stagger:
                # Pace the dial storm: 1000 simultaneous SYNs against a
                # 1-core host's accept loop time out before boot.
                await asyncio.sleep(self.stagger)

    async def reconnect_dead(self) -> dict:
        """Re-dial every bot whose socket died (the gate-kill reconnect
        storm): each tries the gates round-robin starting after its old
        one, so a killed gate's clients land on the survivor. The old
        mirror state is dropped — a reconnected client is a NEW client
        and must be served creation + keyframes from scratch."""
        moved = 0
        failed = 0
        for bot in self.bots:
            if bot.alive:
                continue
            await bot.close()
            bot.entities.clear()
            bot.player = None
            ok = False
            for k in range(1, len(self.ports) + 1):
                idx = (bot.gate_index + k) % len(self.ports)
                try:
                    await bot.connect(self.host, self.ports[idx])
                    bot.gate_index = idx
                    ok = True
                    break
                except OSError:
                    continue
            if ok:
                moved += 1
                if self.stagger:
                    await asyncio.sleep(self.stagger)
            else:
                failed += 1
        return {"reconnected": moved, "failed": failed}

    def report(self) -> dict:
        keyframes = sum(e.keyframes for b in self.bots
                        for e in b.entities.values())
        deltas = sum(e.deltas for b in self.bots
                     for e in b.entities.values())
        return {
            "bots": len(self.bots),
            "alive": sum(1 for b in self.bots if b.alive),
            "players": sum(1 for b in self.bots if b.player is not None),
            "entities": sum(len(b.entities) for b in self.bots),
            "keyframes": keyframes,
            "deltas": deltas,
            "records": keyframes + deltas,
            "sync_bytes": sum(b.sync_bytes for b in self.bots),
            "sync_packets": sum(b.sync_packets for b in self.bots),
            "errors": sum(len(b.errors) for b in self.bots),
            "error_samples": [err for b in self.bots
                              for err in b.errors][:5],
        }

    async def close_all(self) -> None:
        for bot in self.bots:
            await bot.close()


async def _amain(args: argparse.Namespace) -> int:
    fleet = Fleet(args.host, [int(p) for p in args.gates.split(",")],
                  args.bots, args.stagger_ms)
    loop = asyncio.get_running_loop()
    cmd_q: asyncio.Queue = asyncio.Queue()

    def stdin_pump() -> None:
        for line in sys.stdin:
            loop.call_soon_threadsafe(cmd_q.put_nowait, line)
        loop.call_soon_threadsafe(cmd_q.put_nowait, "")

    threading.Thread(target=stdin_pump, daemon=True).start()

    def emit(obj: dict) -> None:
        sys.stdout.write(json.dumps(obj, separators=(",", ":")) + "\n")
        sys.stdout.flush()

    await fleet.connect_all()
    emit({"ready": len(fleet.bots)})
    try:
        while True:
            line = await cmd_q.get()
            if not line.strip():
                return 0  # parent closed stdin
            cmd = json.loads(line).get("cmd")
            if cmd == "report":
                emit(fleet.report())
            elif cmd == "reconnect_dead":
                emit(await fleet.reconnect_dead())
            elif cmd == "quit":
                emit({"ok": True})
                return 0
            else:
                emit({"error": f"unknown cmd {cmd!r}"})
    finally:
        await fleet.close_all()


def main(argv: Optional[list] = None) -> int:
    parser = argparse.ArgumentParser(description="goworld_tpu_torch bot fleet")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--gates", required=True,
                        help="comma-separated gate ports")
    parser.add_argument("--bots", type=int, required=True)
    parser.add_argument("--stagger-ms", type=float, default=3.0)
    args = parser.parse_args(argv)
    return asyncio.run(_amain(args))


if __name__ == "__main__":
    sys.exit(main())
