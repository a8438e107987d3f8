"""tracecat: merge every process's span ring into ONE Perfetto trace.

Each goworld_tpu_torch process keeps a ring of finished distributed-tracing
spans (telemetry/tracing.py) served as ``GET /trace?raw=1`` on its debug
HTTP port. This tool reads ``goworld.ini``, scrapes every dispatcher /
game / gate that has an ``http_addr``, and merges the rings into one
chrome://tracing / Perfetto-loadable JSON file with consistent pid/tid
naming — so one page shows a sampled RPC's full cross-process timeline:

    gate.client_rpc ─▶ dispatcher.route (dispatcher.queue_dwell)
        ─▶ game.handle (game.queue_dwell, tick.* phases, storage.save)
        ─▶ dispatcher.route ─▶ gate.client_fanout

Usage:

    python -m goworld_tpu_torch.tools.tracecat [-configfile goworld.ini]
                             [-o trace.json]
                             [--trace-id HEX]   # keep one trace only
    python -m goworld_tpu_torch.tools.tracecat --bundle DIR [-o trace.json]
                             # offline: a gwpost post-mortem bundle as
                             # the span source — no process need be alive

Load the output at https://ui.perfetto.dev (or chrome://tracing). Spans
share a host clock (same-machine deployment), so cross-process ordering
is honest to ~µs; the stdout summary names each complete trace seen.
In ``--bundle`` mode the spans come from the bundle's scraped rings plus
spans synthesized from each process's history-ring flight rows — the
killed process's final ticks included.
"""

from __future__ import annotations

import argparse
import json
import sys
import urllib.request


def scrape(http_addr: str, timeout: float = 5.0) -> dict:
    """One process's raw span ring: {"process", "pid", "spans"}."""
    with urllib.request.urlopen(
        f"http://{http_addr}/trace?raw=1", timeout=timeout
    ) as r:
        return json.loads(r.read())


def collect_endpoints(cfg) -> list[tuple[str, str]]:
    """(name, http_addr) for every configured process that has one."""
    out: list[tuple[str, str]] = []
    for i, d in sorted(cfg.dispatchers.items()):
        if d.http_addr:
            out.append((f"dispatcher{i}", d.http_addr))
    for i, g in sorted(cfg.games.items()):
        if g.http_addr:
            out.append((f"game{i}", g.http_addr))
    for i, g in sorted(cfg.gates.items()):
        if g.http_addr:
            out.append((f"gate{i}", g.http_addr))
    return out


def merge(process_spans: list[tuple[str, list[dict]]],
          trace_id: int | None = None) -> dict:
    """Merge per-process span lists into one chrome trace-event object.

    ``process_spans`` = [(process_name, spans)] — pid is the list index
    (stable, so re-running yields comparable files). Optionally filters
    to a single trace id. (Shared with the post-mortem renderer —
    telemetry/postmortem.py owns the implementation.)
    """
    from goworld_tpu_torch.telemetry.postmortem import merge_spans

    return merge_spans(process_spans, trace_id=trace_id)


def trace_summary(process_spans: list[tuple[str, list[dict]]]) -> dict:
    """trace_id (hex) → {span count, processes seen, root span names}."""
    traces: dict[str, dict] = {}
    for name, spans in process_spans:
        for s in spans:
            t = traces.setdefault(f"{s['trace']:016x}", {
                "spans": 0, "processes": set(), "roots": set()})
            t["spans"] += 1
            t["processes"].add(name)
            if not s["parent"]:
                t["roots"].add(s["name"])
    return {
        tid: {"spans": t["spans"],
              "processes": sorted(t["processes"]),
              "roots": sorted(t["roots"])}
        for tid, t in traces.items()
    }


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        description="merge per-process /trace rings into one Perfetto file")
    parser.add_argument("-configfile", default="",
                        help="goworld.ini (default: ./goworld.ini)")
    parser.add_argument("-o", "--out", default="trace.json")
    parser.add_argument("--trace-id", default="",
                        help="keep only this trace id (hex)")
    parser.add_argument("--bundle", default="",
                        help="offline source: a gwpost post-mortem "
                             "bundle directory instead of live HTTP")
    args = parser.parse_args(argv)

    process_spans: list[tuple[str, list[dict]]] = []
    if args.bundle:
        from goworld_tpu_torch.telemetry.postmortem import (
            bundle_process_spans,
        )

        process_spans = bundle_process_spans(args.bundle)
        if not process_spans:
            print(f"tracecat: bundle {args.bundle} holds no spans",
                  file=sys.stderr)
            return 1
    else:
        from goworld_tpu_torch.config import get as get_config, set_config_file

        if args.configfile:
            set_config_file(args.configfile)
        cfg = get_config()
        endpoints = collect_endpoints(cfg)
        if not endpoints:
            print("tracecat: no process in the config has an http_addr",
                  file=sys.stderr)
            return 1

        for name, addr in endpoints:
            try:
                ring = scrape(addr)
            except Exception as exc:
                print(f"tracecat: {name} @ {addr} unreachable: {exc}",
                      file=sys.stderr)
                continue
            process_spans.append(
                (ring.get("process") or name, ring["spans"]))
        if not process_spans:
            print("tracecat: no process reachable", file=sys.stderr)
            return 1

    tid = int(args.trace_id, 16) if args.trace_id else None
    out = merge(process_spans, trace_id=tid)
    with open(args.out, "w", encoding="utf-8") as f:
        json.dump(out, f)
    summary = trace_summary(process_spans)
    cross = {k: v for k, v in summary.items() if len(v["processes"]) >= 2}
    print(json.dumps({
        "out": args.out,
        "processes": [n for n, _ in process_spans],
        "spans": sum(len(s) for _, s in process_spans),
        "traces": len(summary),
        "cross_process_traces": len(cross),
        "example": next(iter(sorted(
            cross.items(), key=lambda kv: -kv[1]["spans"])), None),
    }, separators=(",", ":")))
    return 0


if __name__ == "__main__":
    sys.exit(main())
