"""Cluster telemetry collector: every process's snapshot behind ONE URL.

Each goworld_tpu_torch process already serves rich *local* telemetry on its
debug port (``/healthz``, ``/metrics``, ``/trace``, ``/flight``) — but an
operator of a 2-dispatcher / 2-game / 2-gate deployment had to poll six
ports and merge by hand. This module is the single pane of glass: a
:class:`ClusterCollector` (hosted by the **driver dispatcher**, the same
process that plans rebalancing) periodically fetches one compact snapshot
per process and serves the aggregate as ``GET /cluster`` on its own debug
port, which ``python -m goworld_tpu_torch.tools.gwtop`` renders live.

Design choice — **loopback scrape**, not a pushed MsgType (README
"Cluster observability" states the full argument): dispatchers do not
interconnect, so a pushed snapshot from dispatcher 2 has no wire path to
the driver's collector, while a scrape covers all three process kinds
with one code path; the per-process endpoints stay authoritative (the
``/cluster`` row is literally the process's own ``/snapshot``, seconds
old); zero bytes ride the cluster links and no PROTO_VERSION bump is
needed; and the deployment is already enumerable from the shared ini —
tools/tracecat.py scrapes ``/trace`` from the same addresses. The
trade-off is that the collector must reach each ``http_addr`` (loopback
on the single-host deployments this repo targets; front multi-host runs
with a tunnel, noted in the README).

Transport is pluggable: production targets fetch
``http://<http_addr>/snapshot``; the in-process chaos harness hands the
collector direct callables over its service objects, so scenario
recovery is judged from the *aggregated* view with the same summary code
paths production uses.
"""

from __future__ import annotations

import asyncio
import json
import time
from typing import Any, Awaitable, Callable, Optional

from goworld_tpu_torch.telemetry.metrics import REGISTRY

#: Snapshot fetcher for one process: returns the /snapshot-shaped dict
#: ({"health": ..., "metrics": ...}) or raises.
Fetch = Callable[[], Awaitable[dict[str, Any]]]

#: Metric families worth shipping in the per-process snapshot row — the
#: cluster plane's working set, not the full exposition (that stays on
#: the per-process /metrics).
SNAPSHOT_FAMILY_PREFIXES: tuple[str, ...] = (
    "game_tick_phase_seconds",
    "game_entities",
    "aoi_",
    "jit_",
    "dispatcher_",
    "gate_",
    "cluster_",
    "rebalance_",
    "sync_",
    "chaos_recovery_seconds",
    "net_packets_total",
    "net_bytes_total",
    "history_",
)


def selected_metrics(snapshot: dict[str, Any]) -> dict[str, Any]:
    """The cluster-plane subset of a registry snapshot (series only)."""
    out: dict[str, Any] = {}
    for name, fam in snapshot.items():
        if name.startswith(SNAPSHOT_FAMILY_PREFIXES):
            out[name] = {"type": fam["type"], "series": fam["series"]}
    return out


def build_local_snapshot() -> dict[str, Any]:
    """THIS process's observability row (the ``GET /snapshot`` payload):
    its /healthz object plus the cluster-plane metric families."""
    from goworld_tpu_torch.utils import debug_http

    return {
        "health": debug_http.health_snapshot(),
        "metrics": selected_metrics(REGISTRY.snapshot()),
    }


async def http_fetch_json(addr: str, path: str,
                          timeout: float = 2.0) -> dict[str, Any]:
    """Minimal asyncio HTTP/1.1 GET of a JSON body from ``host:port``
    (the debug servers speak exactly this; no external HTTP client in
    the image's async stack)."""
    host, _, port_s = addr.rpartition(":")
    reader, writer = await asyncio.wait_for(
        asyncio.open_connection(host or "127.0.0.1", int(port_s)),
        timeout=timeout)
    try:
        writer.write(
            f"GET {path} HTTP/1.1\r\nHost: {addr}\r\n"
            f"Connection: close\r\n\r\n".encode())
        await writer.drain()
        raw = await asyncio.wait_for(reader.read(), timeout=timeout)
    finally:
        writer.close()
        try:
            await writer.wait_closed()
        except Exception:
            pass
    head, _, body = raw.partition(b"\r\n\r\n")
    status_line = head.split(b"\r\n", 1)[0].decode(errors="replace")
    parts = status_line.split()
    if len(parts) < 2 or parts[1] != "200":
        raise ValueError(f"{addr}{path}: {status_line}")
    return dict(json.loads(body))


def http_target(name: str, http_addr: str,
                timeout: float = 2.0) -> tuple[str, Fetch]:
    async def fetch() -> dict[str, Any]:
        return await http_fetch_json(http_addr, "/snapshot", timeout)

    return (name, fetch)


def http_targets_from_config(cfg: Any) -> list[tuple[str, Fetch]]:
    """(name, fetch) for every configured process with an ``http_addr``
    — the same deployment enumeration tools/tracecat.py scrapes."""
    out: list[tuple[str, Fetch]] = []
    for i, d in sorted(cfg.dispatchers.items()):
        if d.http_addr:
            out.append(http_target(f"dispatcher{i}", d.http_addr))
    for i, g in sorted(cfg.games.items()):
        if g.http_addr:
            out.append(http_target(f"game{i}", g.http_addr))
    for i, g in sorted(cfg.gates.items()):
        if g.http_addr:
            out.append(http_target(f"gate{i}", g.http_addr))
    return out


def _series_sum(metrics: dict[str, Any], family: str,
                label: Optional[str] = None,
                value: Optional[str] = None) -> float:
    fam = metrics.get(family)
    if not fam:
        return 0.0
    total = 0.0
    for s in fam["series"]:
        if label is not None and s["labels"].get(label) != value:
            continue
        total += float(s.get("value", 0.0))
    return total


class ClusterCollector:
    """Periodic scrape of every target + the aggregate ``view()``.

    A target that errors or goes silent keeps its LAST snapshot with
    ``ok: false`` and the error string — a crashed game must show up as
    a red row holding its final state, not vanish from the pane.
    """

    def __init__(self, targets: list[tuple[str, Fetch]],
                 interval: float = 1.0,
                 stale_after: Optional[float] = None,
                 slo: Any = None) -> None:
        self.interval = max(0.05, float(interval))
        # A row older than this is stale even if the fetch "worked"
        # (default: three scrape cycles, mirroring [rebalance]
        # stale_after's relationship to report_interval).
        self.stale_after = (3.0 * self.interval if stale_after is None
                            else float(stale_after))
        self._targets = list(targets)
        self._rows: dict[str, dict[str, Any]] = {}
        self._task: Optional[asyncio.Task[None]] = None
        self._polls = 0
        # SLO plane (telemetry/slo.py): judged once per poll so the burn
        # windows advance at scrape cadence, not reader cadence.
        self._judge = None
        if slo is not None and slo.enabled():
            from goworld_tpu_torch.telemetry.slo import SLOJudge
            self._judge = SLOJudge(slo)

    # --- lifecycle ----------------------------------------------------------

    async def start(self) -> None:
        self._task = asyncio.get_running_loop().create_task(self._loop())

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, Exception):
                pass
            self._task = None

    async def _loop(self) -> None:
        while True:
            try:
                await self.poll_once()
            except Exception:  # a scrape round must never kill the loop
                pass
            await asyncio.sleep(self.interval)

    async def poll_once(self) -> None:
        """One scrape round: all targets concurrently, per-target errors
        captured into the row (never raised)."""
        self._polls += 1
        results = await asyncio.gather(
            *(self._fetch_one(name, fetch) for name, fetch in self._targets)
        )
        for name, row in results:
            if row.get("snapshot") is None and name in self._rows:
                # keep the last good snapshot under the error marker
                prev = self._rows[name]
                row["snapshot"] = prev.get("snapshot")
                row["fetched_at"] = prev.get("fetched_at", 0.0)
            self._rows[name] = row
        if self._judge is not None:
            self._judge.judge_poll(self._process_rows())

    async def _fetch_one(self, name: str,
                         fetch: Fetch) -> tuple[str, dict[str, Any]]:
        try:
            snap = await fetch()
            return (name, {"snapshot": snap, "error": None,
                           "fetched_at": time.monotonic()})
        except Exception as exc:
            return (name, {"snapshot": None,
                           "error": f"{type(exc).__name__}: {exc}",
                           "fetched_at": 0.0})

    # --- the aggregate view -------------------------------------------------

    def _process_rows(self) -> dict[str, dict[str, Any]]:
        now = time.monotonic()
        processes: dict[str, dict[str, Any]] = {}
        for name, raw in sorted(self._rows.items()):
            snap = raw.get("snapshot") or {}
            fetched = float(raw.get("fetched_at") or 0.0)
            age = round(now - fetched, 3) if fetched else None
            ok = (raw.get("error") is None and age is not None
                  and age <= self.stale_after)
            processes[name] = {
                "ok": ok,
                "age_s": age,
                "error": raw.get("error"),
                "health": snap.get("health") or {},
                "metrics": snap.get("metrics") or {},
            }
        return processes

    def view(self) -> dict[str, Any]:
        """The ``GET /cluster`` object: one row per process + a cluster
        summary (census conservation, generation consistency, migration
        and retrace counters, alerts). Built on demand — the reader pays,
        the scrape loop just stores."""
        processes = self._process_rows()
        summary = summarize(processes)
        if self._judge is not None:
            summary["slo"] = self._judge.summary()
            summary["alerts"].extend(self._judge.alerts())
        return {
            "collector": {
                "interval_s": self.interval,
                "stale_after_s": self.stale_after,
                "polls": self._polls,
                "targets": len(self._targets),
                "ts": time.time(),
            },
            "processes": processes,
            "summary": summary,
        }


def summarize(processes: dict[str, dict[str, Any]]) -> dict[str, Any]:
    """Cluster-level invariants from the per-process rows.

    - **census**: clients bound on games vs clients connected on gates —
      a real cross-process conservation law (every connected client has
      exactly one avatar binding), judged from the aggregated view.
    - **generations**: every gate names its boot generation; any game
      client-binding or dispatcher gate-registration carrying a DIFFERENT
      generation for that gate is a stale row (a dead incarnation's
      binding that should have been detached).
    - **counters**: migrations routed/bounced/cancelled, steady-state
      retraces, chaos recoveries — summed across rows.
    """
    reporting = [n for n, r in processes.items() if r["ok"]]
    down = [n for n, r in processes.items() if not r["ok"]]
    game_entities = 0
    game_clients = 0
    gate_clients = 0
    gate_gens: dict[str, int] = {}
    stale_gens: list[dict[str, Any]] = []
    migrates = {"routed": 0.0, "bounced": 0.0, "cancel": 0.0}
    retraces = 0.0
    fused_classes = 0.0
    fused_slots = 0.0
    # Device-resident tick: the delivery-class split and the
    # host wall-clock the fused decode / columnar persist shrink.
    fused_delivery_classes = 0.0
    host_fallback_classes = 0.0
    host_phase = {"delivery": 0.0, "persist": 0.0}
    # Rebalance plane: planner host + pause/failover state for
    # the /cluster REBAL view and its alerts.
    space_outcomes = {"done": 0.0, "aborted": 0.0, "timeout": 0.0,
                      "rolled_back": 0.0}
    paused_reasons = {"paused_stale": 0.0, "paused_links": 0.0,
                      "paused_few": 0.0}
    spaces_in_flight = 0.0
    space_handoffs_parked = 0
    # Device comms (ROADMAP item 5): per-link halo / allgather bytes
    # rolled up by tier for the /cluster summary (the per-link series
    # stay on each row's metrics and in its history frames).
    comms_tiers: dict[str, float] = {}
    comms_links: set = set()
    planner_host = None
    planner_last = None
    planner_service = False
    rebalance_enabled = False
    for name, row in processes.items():
        h = row["health"]
        kind = h.get("kind")
        if kind == "game":
            game_entities += int(h.get("entities", 0))
            game_clients += int(h.get("clients", 0))
            ps = h.get("rebalance_planner")
            if ps:
                # This game hosts the sharded planner service right now.
                planner_host = name
                planner_last = ps.get("last_result")
        elif kind == "dispatcher":
            rb = h.get("rebalance") or {}
            rebalance_enabled = rebalance_enabled or bool(rb.get("enabled"))
            planner_service = planner_service or bool(
                rb.get("planner_service"))
            space_handoffs_parked += int(rb.get("space_handoffs", 0))
            if rb.get("driver") and not rb.get("planner_service"):
                planner_host = name
                planner_last = rb.get("last_result")
        elif kind == "gate":
            gate_clients += int(h.get("clients", 0))
            gen = h.get("generation")
            if gen is not None:
                gate_gens[str(h.get("id"))] = int(gen)
        m = row["metrics"]
        for outcome in migrates:
            migrates[outcome] += _series_sum(
                m, "dispatcher_migrates_total", "kind", outcome)
        retraces += _series_sum(m, "jit_retrace_events_total")
        fused_classes = max(fused_classes,
                            _series_sum(m, "aoi_fused_classes"))
        fused_slots = max(fused_slots, _series_sum(m, "aoi_fused_slots"))
        fused_delivery_classes = max(
            fused_delivery_classes,
            _series_sum(m, "aoi_fused_delivery_classes"))
        host_fallback_classes = max(
            host_fallback_classes,
            _series_sum(m, "aoi_host_fallback_classes"))
        for ph in host_phase:
            host_phase[ph] += _series_sum(
                m, "aoi_host_phase_seconds_total", "phase", ph)
        for outcome in space_outcomes:
            space_outcomes[outcome] += _series_sum(
                m, "rebalance_space_migrations_total", "outcome", outcome)
        link_fam = m.get("aoi_link_bytes_total")
        if link_fam:
            for s in link_fam.get("series", []):
                tier = s.get("labels", {}).get("tier", "")
                comms_tiers[tier] = (comms_tiers.get(tier, 0.0)
                                     + float(s.get("value", 0.0)))
                comms_links.add((tier, s.get("labels", {}).get("link", "")))
        for reason in paused_reasons:
            paused_reasons[reason] += _series_sum(
                m, "rebalance_plans_total", "result", reason)
        spaces_in_flight += _series_sum(m, "rebalance_spaces_in_flight")
        if (planner_host is None
                and _series_sum(m, "rebalance_planner_host") >= 1.0):
            # Gauge fallback for hosts whose healthz row predates the
            # rebalance_planner field (or non-game scrapes).
            planner_host = name
    # Generation consistency: compare every binding against the gate's
    # own announced generation (only for gates that are reporting).
    for name, row in processes.items():
        h = row["health"]
        if h.get("kind") == "game":
            for gid, gens in (h.get("client_gate_gens") or {}).items():
                want = gate_gens.get(str(gid))
                for g in gens:
                    # gen 0 = pre-generation binding (legacy path): unknown,
                    # not stale — only a DIFFERENT nonzero generation is.
                    if want is not None and int(g) != 0 and int(g) != want:
                        stale_gens.append({
                            "where": name, "gate": gid,
                            "bound_gen": int(g), "gate_gen": want})
        elif h.get("kind") == "dispatcher":
            for gid, info in (h.get("gates") or {}).items():
                want = gate_gens.get(str(gid))
                got = info.get("gen")
                if (want is not None and got is not None and int(got) != 0
                        and int(got) != want and info.get("connected")):
                    stale_gens.append({
                        "where": name, "gate": gid,
                        "bound_gen": int(got), "gate_gen": want})
    clients_conserved = game_clients == gate_clients
    alerts: list[str] = []
    if down:
        alerts.append(f"processes not reporting: {', '.join(down)}")
    if not clients_conserved:
        alerts.append(
            f"census mismatch: {game_clients} clients bound on games vs "
            f"{gate_clients} connected on gates")
    if stale_gens:
        alerts.append(f"{len(stale_gens)} stale generation row(s)")
    if retraces:
        alerts.append(
            f"{int(retraces)} steady-state jit retrace(s) — see the "
            f"retrace WARN and /flight on the offending game")
    # Rebalance-plane alerts: a paused planner names its guard
    # reason, and an enabled planner service with NO live host is a
    # failover in flight (or a wedged one — either way worth eyes).
    if planner_last in paused_reasons:
        alerts.append(
            f"rebalance paused: {planner_last} (planner on "
            f"{planner_host})")
    if rebalance_enabled and planner_service and planner_host is None:
        alerts.append(
            "rebalance planner service has no live host "
            "(failover in flight?)")
    return {
        "reporting": len(reporting),
        "expected": len(processes),
        "down": down,
        "census": {
            "game_entities": game_entities,
            "game_clients": game_clients,
            "gate_clients": gate_clients,
            "clients_conserved": clients_conserved,
        },
        "generations": {
            "gates": gate_gens,
            "stale": stale_gens,
        },
        "migrations": {k: int(v) for k, v in migrates.items()},
        "rebalance": {
            "enabled": rebalance_enabled,
            "planner_service": planner_service,
            "planner_host": planner_host,
            "last_result": planner_last,
            "rounds_paused": {k: int(v) for k, v in paused_reasons.items()},
            "spaces_in_flight": int(spaces_in_flight),
            "space_handoffs_parked": space_handoffs_parked,
            "space_migrations": {
                k: int(v) for k, v in space_outcomes.items()},
        },
        "steady_state_retraces": int(retraces),
        "comms": {
            "links": len(comms_links),
            "bytes": {k: int(v) for k, v in sorted(comms_tiers.items())},
        },
        "fused": {"classes": int(fused_classes), "slots": int(fused_slots)},
        "delivery": {
            "fused_classes": int(fused_delivery_classes),
            "host_fallback_classes": int(host_fallback_classes),
            "host_phase_seconds": {
                k: round(v, 3) for k, v in host_phase.items()},
        },
        "alerts": alerts,
    }
