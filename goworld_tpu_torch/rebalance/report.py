"""Per-game load-report schema + scalar load score.

Built on the game (one bson dict per ``[rebalance] report_interval``, sent
to EVERY dispatcher beside the legacy cpu-only GAME_LBC_INFO), consumed on
the dispatcher by both the LBC choose-game heap and the rebalance planner.

Schema (all keys always present; see ``build_load_report``):

- ``cpu``: process CPU percent over the last report interval.
- ``entities``: live entity count (spaces + nil space included — the
  planner compares games against each other, so the constant offset of
  per-game spaces cancels).
- ``tick_p95_ms``: p95 busy tick over the flight-recorder ring (the
  tick-phase histogram's tail, as one number).
- ``queue_depth``: packets waiting in the game logic queue at report time
  (the sync-queue dwell proxy: depth × tick time = dwell).
- ``spaces``: ``[[spaceid, kind, population], ...]`` for every non-nil
  space — the planner's donor/receiver-space view (CheetahGIS-style
  density partitioning needs per-region populations, not just totals).
"""

from __future__ import annotations

import time


def build_load_report(game_service) -> dict:
    """Build this game's load report (runs on the game logic loop — cheap:
    one pass over the spaces dict + a sorted copy of the flight ring)."""
    from goworld_tpu_torch.entity import entity_manager as em

    spaces = []
    for sid, space in em._spaces.items():
        if space.is_nil():
            continue
        spaces.append([sid, int(space.kind), int(space.get_entity_count())])
    flight = game_service.flight
    totals = sorted(t["total_ms"] for t in flight.ticks())
    p95 = totals[int(0.95 * (len(totals) - 1))] if totals else 0.0
    return {
        "cpu": round(game_service.last_cpu_pct, 2),
        "entities": len(em.entities()),
        "tick_p95_ms": round(p95, 3),
        "queue_depth": game_service.queue_depth(),
        "spaces": spaces,
    }


def coerce_report(report: object) -> dict:
    """Validate a wire-received load report (dispatcher seam).  Raises
    ValueError — never TypeError — on any malformed shape, so a corrupt
    or hostile GAME_LOAD_REPORT keeps the raise-ValueError parser
    contract (gwlint R3 / the schema fuzz in tests/test_modelcheck.py).
    Returns the report with the numeric keys coerced to float/int."""
    if not isinstance(report, dict):
        raise ValueError(
            f"load report is {type(report).__name__}, expected dict")
    out = dict(report)
    try:
        for key in ("cpu", "tick_p95_ms"):
            out[key] = float(report.get(key, 0.0))
        for key in ("entities", "queue_depth"):
            out[key] = int(report.get(key, 0))
    except (TypeError, ValueError) as exc:
        raise ValueError(f"malformed load report field: {exc}") from exc
    spaces = out.get("spaces", [])
    if not isinstance(spaces, list):
        raise ValueError("load report 'spaces' is not a list")
    rows = []
    for row in spaces:
        # a malformed row would otherwise TypeError inside the planner's
        # unpack (`for sid, kind, count in ...`) — in the dispatcher TICK
        # loop, where an escape kills the task, not just one packet
        if not isinstance(row, (list, tuple)) or len(row) != 3:
            raise ValueError(f"load report space row malformed: {row!r}")
        sid, kind, count = row
        try:
            rows.append([str(sid), int(kind), int(count)])
        except (TypeError, ValueError) as exc:
            raise ValueError(
                f"load report space row malformed: {exc}") from exc
    out["spaces"] = rows
    return out


def load_score(report: dict) -> float:
    """Scalar load score. Entity count is the backbone (it is exact and
    moves exactly when the rebalancer acts); cpu, tick-p95 and queue depth
    weight in so two games with equal populations but unequal compute
    still rank (a game wedged on a slow tick reads hotter than its entity
    count alone says)."""
    return (
        float(report.get("entities", 0))
        + 0.5 * float(report.get("cpu", 0.0))
        + 0.05 * float(report.get("tick_p95_ms", 0.0))
        + 0.1 * float(report.get("queue_depth", 0))
    )


class ReportTable:
    """Dispatcher-side store of the latest report per game, with
    staleness bookkeeping (monotonic receive times)."""

    def __init__(self) -> None:
        self._reports: dict[int, tuple[dict, float]] = {}

    def update(self, gameid: int, report: dict,
               now: float | None = None) -> None:
        self._reports[gameid] = (
            report, time.monotonic() if now is None else now)

    def remove(self, gameid: int) -> None:
        self._reports.pop(gameid, None)

    def get(self, gameid: int) -> dict | None:
        entry = self._reports.get(gameid)
        return entry[0] if entry is not None else None

    def age(self, gameid: int, now: float | None = None) -> float:
        entry = self._reports.get(gameid)
        if entry is None:
            return float("inf")
        return (time.monotonic() if now is None else now) - entry[1]

    def games(self) -> list[int]:
        return sorted(self._reports)

    def entities(self, gameid: int) -> int:
        r = self.get(gameid)
        return int(r["entities"]) if r is not None else 0
