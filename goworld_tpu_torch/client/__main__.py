"""Standalone bot-army entry point.

Reference parity: ``examples/test_client/test_client.go:35-84`` — flags
``-N`` (bot count), ``-strict``, ``-duration`` seconds, gates resolved from
the deployment ini (bots pick gates round-robin, ClientBot.go:82-85).

    python -m goworld_tpu_torch.client -N 200 -strict -duration 300

Exit code 0 = clean run; 1 = strict failure or any bot error.
"""

from __future__ import annotations

import argparse
import asyncio
import sys

from goworld_tpu_torch.client.bot_runner import format_report, run_fleet


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m goworld_tpu_torch.client")
    ap.add_argument("-N", type=int, default=10, help="number of bots")
    ap.add_argument("-strict", action="store_true",
                    help="promote any protocol error/timeout to fatal")
    ap.add_argument("-duration", type=float, default=30.0,
                    help="seconds to run scenarios")
    ap.add_argument("-configfile", default="goworld.ini",
                    help="deployment ini to resolve gate addresses from")
    ap.add_argument("-gate", action="append", default=[],
                    help="explicit gate host:port (repeatable; overrides ini)")
    ap.add_argument("-ws", action="store_true", help="connect over WebSocket")
    ap.add_argument("-rudp", action="store_true",
                    help="connect over reliable UDP (the reference's kcp mode)")
    ap.add_argument("-rudp-protocol", dest="rudp_protocol", default="kcp",
                    choices=("kcp", "native"),
                    help="reliable-UDP wire protocol; must match the "
                         "gate's [gate] rudp_protocol")
    ap.add_argument("-rudp-fec", dest="rudp_fec", default="10,3",
                    help="kcp FEC shards 'data,parity' or 'off'; must "
                         "match the gate's [gate] rudp_fec")
    ap.add_argument("-tls", action="store_true", help="TLS client link")
    ap.add_argument("-compress", action="store_true",
                    help="compressed client link")
    ap.add_argument("-seed", type=int, default=None)
    ap.add_argument("-index-base", dest="index_base", type=int, default=0,
                    help="offset bot indices (stress_<i> identities) so "
                         "CONCURRENT fleets against one cluster don't "
                         "fight over the same avatars")
    ap.add_argument("-timeout", type=float, default=None,
                    help="per-scenario completion budget in seconds "
                         "(retries happen within it); large fleets on "
                         "loaded hosts need more than the reference's 5. "
                         "Default: [client] rpc_timeout from the ini "
                         "(5.0 when unset) — widen the config instead of "
                         "eating a strict-mode flake on slow rigs")
    args = ap.parse_args(argv)
    # Normalize + fail fast (same rules as the gate-side config): a bad
    # spec must die here as a usage error, not as N per-bot ValueErrors
    # mid-fleet.
    args.rudp_fec = args.rudp_fec.strip().lower()
    from goworld_tpu_torch.config.read_config import parse_fec

    try:
        parse_fec(args.rudp_fec)
    except ValueError as exc:
        ap.error(str(exc))

    if args.timeout is None:
        # [client] rpc_timeout: the strict-bot budget is deployment
        # config, not a constant — a rig whose reload window exceeds 5 s
        # widens it HERE honestly instead of eating a strict flake.
        args.timeout = 5.0
        import os

        if os.path.exists(args.configfile):
            from goworld_tpu_torch.config import read_config

            read_config.set_config_file(args.configfile)
            args.timeout = read_config.get().client.rpc_timeout

    gates: list[tuple[str, int]] = []
    for spec in args.gate:
        host, _, port = spec.rpartition(":")
        gates.append((host or "127.0.0.1", int(port)))
    if not gates:
        from goworld_tpu_torch.config import read_config

        read_config.set_config_file(args.configfile)
        cfg = read_config.get()
        if args.ws:
            for g in cfg.gates.values():
                if g.ws_addr:
                    host, _, port = g.ws_addr.rpartition(":")
                    gates.append((host or "127.0.0.1", int(port)))
        else:
            gates = [(g.host, g.port) for g in cfg.gates.values()]
    if not gates:
        print("no gates found (use -gate host:port or -configfile)",
              file=sys.stderr)
        return 2

    report = asyncio.run(
        run_fleet(
            args.N, gates, args.duration,
            strict=args.strict, ws=args.ws, rudp=args.rudp,
            rudp_protocol=args.rudp_protocol, rudp_fec=args.rudp_fec,
            tls=args.tls, index_base=args.index_base,
            compress=args.compress, seed=args.seed,
            thing_timeout=args.timeout,
        )
    )
    print(format_report(report))
    return 1 if report["errors"] else 0


if __name__ == "__main__":
    sys.exit(main())
