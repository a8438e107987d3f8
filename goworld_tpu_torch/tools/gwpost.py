"""gwpost: one-command post-mortem bundles + merged timeline rendering.

Collect mode (default) reads ``goworld.ini``, scrapes every live
process's span ring and flight dump, grabs the driver dispatcher's final
``/cluster`` view, copies every process's on-disk history ring
(``[telemetry] history_dir`` — the black box that survives a crash), and
writes one bundle directory. Dead processes are expected, not errors:
their history rings speak for them. Render mode (``--bundle``) takes an
existing bundle — e.g. one the chaos harness emitted on failure — and
produces the merged Perfetto timeline (tracecat's merge) including the
killed process's final flight-recorder ticks, plus a stdout summary.

Usage:

    python -m goworld_tpu_torch.tools.gwpost [-configfile goworld.ini]
        [--history-dir DIR] [-o BUNDLE_DIR] [--reason TEXT]
    python -m goworld_tpu_torch.tools.gwpost --bundle BUNDLE_DIR

Both modes leave ``trace.json`` inside the bundle — load it at
https://ui.perfetto.dev. ``tools/gwpost.py`` is the repo-root shim.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import urllib.request

from goworld_tpu_torch.telemetry import postmortem


def _fetch_json(http_addr: str, path: str, timeout: float = 3.0):
    with urllib.request.urlopen(
        f"http://{http_addr}{path}", timeout=timeout
    ) as r:
        return json.loads(r.read())


def _endpoints(cfg) -> list[tuple[str, str]]:
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


def collect(cfg, out_dir: str, history_dir: str = "",
            reason: str = "gwpost") -> dict:
    """Scrape what's alive, copy what's on disk, write the bundle."""
    process_spans: dict[str, list[dict]] = {}
    flights: dict[str, dict] = {}
    cluster_view = None
    for name, addr in _endpoints(cfg):
        try:
            ring = _fetch_json(addr, "/trace?raw=1")
            process_spans[name] = ring.get("spans") or []
        except Exception as exc:
            print(f"gwpost: {name} @ {addr} spans unreachable: {exc}",
                  file=sys.stderr)
        try:
            flight = _fetch_json(addr, "/flight")
            if flight:
                flights[name] = flight
        except Exception:
            pass
        if cluster_view is None and name.startswith("dispatcher"):
            try:
                cluster_view = _fetch_json(addr, "/cluster")
            except Exception:
                pass
    hdir = history_dir or cfg.telemetry.history_dir
    return postmortem.collect_bundle(
        out_dir, reason=reason, history_dir=hdir,
        cluster_view=cluster_view, process_spans=process_spans,
        flights=flights)


def render(bundle_dir: str, trace_out: str = "") -> dict:
    """Merged Perfetto timeline + summary for an existing bundle."""
    import os

    process_spans = postmortem.bundle_process_spans(bundle_dir)
    trace_path = trace_out or os.path.join(bundle_dir, "trace.json")
    merged = postmortem.merge_spans(process_spans)
    with open(trace_path, "w", encoding="utf-8") as f:
        json.dump(merged, f)
    summary = postmortem.bundle_summary(bundle_dir)
    summary["trace"] = {
        "out": trace_path,
        "events": len(merged["traceEvents"]),
        "processes": [n for n, _ in process_spans],
    }
    return summary


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        description="post-mortem bundle collector / renderer")
    parser.add_argument("-configfile", default="",
                        help="goworld.ini (default: ./goworld.ini)")
    parser.add_argument("--bundle", default="",
                        help="render an EXISTING bundle directory "
                             "instead of collecting a new one")
    parser.add_argument("--history-dir", default="",
                        help="override [telemetry] history_dir as the "
                             "ring source")
    parser.add_argument("-o", "--out", default="",
                        help="bundle output directory "
                             "(default postmortem-<unix-ts>)")
    parser.add_argument("--reason", default="gwpost",
                        help="reason recorded in the bundle manifest")
    args = parser.parse_args(argv)

    if args.bundle:
        bundle_dir = args.bundle
    else:
        from goworld_tpu_torch.config import get as get_config, set_config_file

        if args.configfile:
            set_config_file(args.configfile)
        cfg = get_config()
        bundle_dir = args.out or f"postmortem-{int(time.time())}"
        manifest = collect(cfg, bundle_dir,
                           history_dir=args.history_dir,
                           reason=args.reason)
        if not manifest["processes"]:
            print("gwpost: nothing collected (no live process, no "
                  "history ring) — is [telemetry] history_dir set?",
                  file=sys.stderr)
            return 1
    summary = render(bundle_dir)
    summary["bundle"] = bundle_dir
    print(json.dumps(summary, separators=(",", ":")))
    return 0


if __name__ == "__main__":
    sys.exit(main())
