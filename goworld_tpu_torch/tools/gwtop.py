"""gwtop: the whole deployment on one terminal page.

Reads the driver dispatcher's ``GET /cluster`` aggregate (the
ClusterCollector's loopback scrape of every process's ``/snapshot`` —
telemetry/collector.py) and renders it as a live console: one row per
process (health, census, queue depth, tick-phase p50/p95 with a phase
heat strip, AOI backlog, fused gauges, jit launches/retraces, net
counters) plus the cluster summary line (census conservation, generation
consistency, migration/bounce/retrace counters, alerts). The moral
composition of the reference's per-process pprof+expvar ports into a
single pane of glass.

Usage::

    python -m goworld_tpu_torch.tools.gwtop [-configfile goworld.ini]
                                      [--addr HOST:PORT]  # /cluster source
                                      [--interval 2.0]
                                      [--once]            # one JSON snapshot

``--once`` prints the raw ``/cluster`` JSON (machine-readable — CI logs
and the chaos harness parse this shape); without it the console
redraws every ``--interval`` seconds until interrupted. The default
``--addr`` is the configured driver dispatcher's ``http_addr``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import urllib.request
from typing import Any, Optional

#: Phase heat scale: fraction of the tick budget → block glyph.
_BLOCKS = " ▁▂▃▄▅▆▇█"

#: Tick-phase columns rendered in the heat strip, in loop order.
_PHASES = ("dispatch", "entity_logic", "aoi", "sync_send")


def fetch_view(addr: str, timeout: float = 5.0) -> dict[str, Any]:
    with urllib.request.urlopen(
            f"http://{addr}/cluster", timeout=timeout) as r:
        return dict(json.loads(r.read()))


def collector_addr_from_config(cfg: Any) -> str:
    """The driver dispatcher's http_addr (where /cluster is served)."""
    driver = cfg.rebalance.driver_dispatcher
    d = cfg.dispatchers.get(driver)
    if d is not None and d.http_addr:
        return str(d.http_addr)
    for _i, dc in sorted(cfg.dispatchers.items()):
        if dc.http_addr:
            return str(dc.http_addr)
    return ""


def _series(metrics: dict[str, Any], family: str) -> list[dict[str, Any]]:
    fam = metrics.get(family)
    return list(fam["series"]) if fam else []


def _gauge(metrics: dict[str, Any], family: str) -> Optional[float]:
    s = _series(metrics, family)
    return float(s[0]["value"]) if s else None


def _sum(metrics: dict[str, Any], family: str) -> float:
    return sum(float(s.get("value", 0.0)) for s in _series(metrics, family))


def _phase_stats(metrics: dict[str, Any]) -> dict[str, dict[str, float]]:
    out: dict[str, dict[str, float]] = {}
    for s in _series(metrics, "game_tick_phase_seconds"):
        phase = s["labels"].get("phase", "")
        out[phase] = {"p50": float(s.get("p50", 0.0)),
                      "p95": float(s.get("p95", 0.0)),
                      "p999": float(s.get("p999", 0.0))}
    return out


def _heat(phases: dict[str, dict[str, float]], budget: float) -> str:
    """One block glyph per phase, p95 scaled against the tick budget —
    the hot phase reads as the tall bar."""
    glyphs = []
    for p in _PHASES:
        v = phases.get(p, {}).get("p95", 0.0)
        frac = min(1.0, v / budget) if budget > 0 else 0.0
        idx = round(frac * (len(_BLOCKS) - 1))
        if v > 0 and idx == 0:
            idx = 1  # nonzero time always visible, however far under budget
        glyphs.append(_BLOCKS[idx])
    return "".join(glyphs)


def _fmt_ms(v: Optional[float]) -> str:
    return f"{v * 1000:.1f}" if v is not None else "-"


def _row(name: str, proc: dict[str, Any], tick_budget: float) -> list[str]:
    h = proc.get("health") or {}
    m = proc.get("metrics") or {}
    kind = h.get("kind", "?")
    status = "ok" if proc.get("ok") else ("DOWN" if proc.get("error")
                                          else "STALE")
    age = proc.get("age_s")
    uptime = h.get("uptime_s")
    if kind == "game":
        census = f"{h.get('entities', '-')}e/{h.get('clients', '-')}c"
        queue_s = str(int(h.get("queue_depth", 0)))
    elif kind == "gate":
        census = f"{h.get('clients', '-')}c g{h.get('generation', 0) & 0xffff:04x}"
        queue_s = str(int(h.get("queue_depth", 0)))
    elif kind == "dispatcher":
        census = f"{h.get('entities_routed', '-')}rt"
        queue_s = str(int(h.get("queue_depth", 0)))
    else:
        census, queue_s = "-", "-"
    phases = _phase_stats(m)
    total = phases.get("total", {})
    heat = _heat(phases, tick_budget) if phases else "-"
    backlog = _gauge(m, "aoi_event_backlog")
    fused_c = _gauge(m, "aoi_fused_classes")
    fused_s = _gauge(m, "aoi_fused_slots")
    fused = (f"{int(fused_c)}/{int(fused_s)}"
             if fused_c is not None and fused_s is not None else "-")
    launches = _sum(m, "jit_launches_total")
    retraces = _sum(m, "jit_retrace_events_total")
    return [
        name,
        status,
        f"{age:.1f}" if age is not None else "-",
        f"{uptime:.0f}" if isinstance(uptime, (int, float)) else "-",
        census,
        queue_s,
        (f"{_fmt_ms(total.get('p50'))}/{_fmt_ms(total.get('p95'))}"
         f"/{_fmt_ms(total.get('p999'))}"),
        heat,
        f"{int(backlog)}" if backlog is not None else "-",
        fused,
        _dlvr_col(m),
        _sync_col(m),
        _rebal_col(h, m),
        f"{int(launches)}" if launches else "-",
        f"{int(retraces)}" if retraces else "0" if launches else "-",
    ]


def _sync_col(metrics: dict[str, Any]) -> str:
    """Adaptive-sync column ([sync]): interest-pair population
    per cadence tier (t0/t1/... slashes) plus the game's rolling sync
    bytes/client/s — '-' for processes without tiering active."""
    tiers = _series(metrics, "sync_tier_edges")
    if not tiers:
        return "-"
    counts = "/".join(
        str(int(s.get("value", 0))) for s in sorted(
            tiers, key=lambda s: int(s["labels"].get("tier", "0"))))
    bpc = _gauge(metrics, "sync_bytes_per_client_per_s")
    return f"{counts}·{bpc:.0f}B/c" if bpc else counts


def _dlvr_col(metrics: dict[str, Any]) -> str:
    """Device-resident delivery column: fused-delivery vs
    host-fallback class census (``2f/1h``) plus the cumulative host wall
    seconds still spent in the delivery+persist phases — the number the
    fused edge decode and columnar persistence exist to shrink.  '-' for
    processes without the batched AOI service."""
    fused = _gauge(metrics, "aoi_fused_delivery_classes")
    fb = _gauge(metrics, "aoi_host_fallback_classes")
    if fused is None and fb is None:
        return "-"
    secs = sum(
        float(s.get("value", 0.0))
        for s in _series(metrics, "aoi_host_phase_seconds_total")
        if s["labels"].get("phase") in ("delivery", "persist"))
    return f"{int(fused or 0)}f/{int(fb or 0)}h·{secs:.1f}s"


def _rebal_col(h: dict[str, Any], metrics: dict[str, Any]) -> str:
    """Rebalance column: ``P:<state>`` marks the process
    hosting the planner (sharded service entity on a game, or the driver
    dispatcher in non-service mode) with its last round's result; games
    show their spaces mid-handoff (``Nsp→``), dispatchers their parked
    member-stream count (``Npark``). '-' when the plane is quiet."""
    kind = h.get("kind")
    parts: list[str] = []
    if kind == "game":
        ps = h.get("rebalance_planner")
        if ps:
            parts.append(f"P:{ps.get('last_result', '?')}")
        inflight = _gauge(metrics, "rebalance_spaces_in_flight")
        if inflight:
            parts.append(f"{int(inflight)}sp→")
    elif kind == "dispatcher":
        rb = h.get("rebalance") or {}
        if rb.get("driver") and not rb.get("planner_service"):
            parts.append(f"P:{rb.get('last_result', '?')}")
        parked = int(rb.get("space_handoffs", 0))
        if parked:
            parts.append(f"{parked}park")
    return " ".join(parts) if parts else "-"


_HEADERS = ["PROCESS", "ST", "AGE", "UP", "CENSUS", "Q",
            "TICK p50/p95/p999ms", "HEAT", "AOIBL", "FUSED", "DLVR",
            "SYNC", "REBAL", "LAUNCH", "RETR"]


def render(view: dict[str, Any], tick_budget: float = 0.1) -> str:
    """The whole /cluster view as one fixed-width page (also what the
    README's screenshot-as-text shows)."""
    coll = view.get("collector") or {}
    summary = view.get("summary") or {}
    census = summary.get("census") or {}
    migrations = summary.get("migrations") or {}
    rebal = summary.get("rebalance") or {}
    rebal_line = ""
    if rebal.get("enabled"):
        sp = rebal.get("space_migrations") or {}
        paused = sum((rebal.get("rounds_paused") or {}).values())
        rebal_line = (
            f" · rebal host={rebal.get('planner_host') or '-'}"
            f" paused={paused}"
            f" infl={rebal.get('spaces_in_flight', 0)}"
            f" sp d{sp.get('done', 0)}/a{sp.get('aborted', 0)}"
            f"/t{sp.get('timeout', 0)}/r{sp.get('rolled_back', 0)}")
    lines = [
        (f"goworld_tpu_torch cluster · {summary.get('reporting', 0)}/"
         f"{summary.get('expected', 0)} reporting · "
         f"clients {census.get('game_clients', 0)}g={census.get('gate_clients', 0)}gw"
         f"{' OK' if census.get('clients_conserved') else ' MISMATCH'} · "
         f"entities {census.get('game_entities', 0)} · "
         f"retraces {summary.get('steady_state_retraces', 0)} · "
         f"migr r{migrations.get('routed', 0)}/b{migrations.get('bounced', 0)}"
         f"/c{migrations.get('cancel', 0)}" + rebal_line),
        (f"collector: {coll.get('targets', 0)} targets · poll "
         f"{coll.get('polls', 0)} @ {coll.get('interval_s', 0)}s · "
         f"stale>{coll.get('stale_after_s', 0)}s · heat="
         f"{'·'.join(_PHASES)} vs {tick_budget * 1000:.0f}ms budget"),
    ]
    slo = summary.get("slo") or {}
    if slo.get("enabled"):
        # The SLO column: per-budget observed/budget,
        # compliance over the long window, and the burn-rate multiple
        # (1.0 = consuming the error budget exactly at the sustainable
        # rate; sustained > 1.0 raises an alert below).
        parts = []
        for bname, b in (slo.get("budgets") or {}).items():
            obs = b.get("observed")
            obs_s = "-" if obs is None else f"{obs:.4g}"
            parts.append(
                f"{bname} {obs_s}/{b.get('budget'):.4g}"
                f" c={b.get('compliance', 0.0):.2f}"
                f" burn={b.get('burn_long', 0.0):.2f}"
                + ("" if b.get("ok") else " VIOLATED"))
        lines.append("slo: " + ("OK" if slo.get("ok") else "VIOLATED")
                     + " · " + " | ".join(parts))
    alerts = summary.get("alerts") or []
    lines.append("alerts: " + ("; ".join(alerts) if alerts else "(none)"))
    stale = (summary.get("generations") or {}).get("stale") or []
    if stale:
        lines.append("stale generations: " + json.dumps(stale))
    rows = [_row(name, proc, tick_budget)
            for name, proc in (view.get("processes") or {}).items()]
    widths = [max(len(h), *(len(r[i]) for r in rows)) if rows else len(h)
              for i, h in enumerate(_HEADERS)]
    lines.append("")
    lines.append("  ".join(h.ljust(w) for h, w in zip(_HEADERS, widths)))
    for r in rows:
        lines.append("  ".join(c.ljust(w) for c, w in zip(r, widths)))
    return "\n".join(lines)


def main(argv: Optional[list[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        description="live console over the cluster observability plane")
    parser.add_argument("-configfile", default="",
                        help="goworld.ini (default: ./goworld.ini)")
    parser.add_argument("--addr", default="",
                        help="collector debug addr (default: the driver "
                             "dispatcher's http_addr from the config)")
    parser.add_argument("--interval", type=float, default=2.0)
    parser.add_argument("--once", action="store_true",
                        help="print one machine-readable /cluster JSON "
                             "snapshot and exit")
    args = parser.parse_args(argv)

    addr = args.addr
    tick_budget = 0.1
    if not addr:
        from goworld_tpu_torch.config import get as get_config, set_config_file

        if args.configfile:
            set_config_file(args.configfile)
        cfg = get_config()
        addr = collector_addr_from_config(cfg)
        tick_budget = cfg.telemetry.slow_tick_budget or 0.1
        if not addr:
            print("gwtop: no dispatcher in the config has an http_addr "
                  "(set one, or pass --addr)", file=sys.stderr)
            return 1

    if args.once:
        try:
            view = fetch_view(addr)
        except Exception as exc:
            print(f"gwtop: /cluster @ {addr} unreachable: {exc}",
                  file=sys.stderr)
            return 1
        print(json.dumps(view, separators=(",", ":"), default=str))
        return 0

    try:
        while True:
            try:
                view = fetch_view(addr)
                page = render(view, tick_budget)
            except Exception as exc:
                page = f"gwtop: /cluster @ {addr} unreachable: {exc}"
            # Clear + home, then the page (plain ANSI; any terminal).
            sys.stdout.write("\x1b[2J\x1b[H" + page + "\n")
            sys.stdout.flush()
            time.sleep(max(0.2, args.interval))
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    sys.exit(main())
