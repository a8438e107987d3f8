"""Dispatcher-side rebalance planning.

One planner instance lives on the driver dispatcher ([rebalance]
driver_dispatcher) — or, with [rebalance] planner_service, inside the
sharded RebalancePlannerService entity so a dead planner host fails over
with the service plane (rebalance/planner_service.py). Each planning round
it looks at the latest per-game load reports and greedily bin-packs load
across ALL reporting games:

- donors are visited hottest-first (by load score); each donor drains
  toward the coldest receiver (by projected entity count, updated as the
  round plans — two donors aiming at one receiver see each other's moves);
- per donor/receiver pair, up to ``max_moves_per_round`` entities move
  from the donor's fattest spaces into SAME-KIND spaces on the receiver
  (moving between unlike kinds would be a gameplay decision, not an ops
  decision);
- when the receiver has NO same-kind space to absorb into, the pair may
  instead move a WHOLE SPACE (largest-first-fit among donor spaces whose
  population fits inside the pair's delta), bounded by
  ``max_space_moves_per_round`` (0 disables — the default) and executed
  by the crash-safe two-phase handoff in rebalance/migrator.py;
- or the round pauses, loudly classified: telemetry stale, a game link
  mid-restart, fewer than two reporting games, or simply balanced.

Anti-thrash design (the "converges, never oscillates" contract):

- hysteresis: no pair is planned unless donor minus receiver entity count
  is at least ``min_entity_delta``, and only ``delta // 2`` entities move
  per pair — the plan aims AT the midpoint, never past it (a whole-space
  move requires the space's population to fit inside the delta for the
  same reason);
- report fencing: after issuing moves the planner refuses to plan the
  same pair again until BOTH games' reports were received after the
  issue time — a plan may never act on counts that predate its own
  previous moves (the classic double-move oscillation);
- the migrator's per-entity/per-space cooldown (game-side) is the third
  layer: even a confused plan cannot bounce one entity or space back and
  forth inside the cooldown window.
"""

from __future__ import annotations

import dataclasses

from goworld_tpu_torch.rebalance.report import ReportTable, load_score
from goworld_tpu_torch.utils import gwlog


@dataclasses.dataclass
class Move:
    """One planned transfer: ``count`` entities out of ``from_space`` on
    ``from_game`` into ``to_space`` on ``to_game`` (the donor game picks
    WHICH entities — the planner only sees populations)."""

    from_game: int
    to_game: int
    from_space: str
    to_space: str
    count: int


@dataclasses.dataclass
class SpaceMove:
    """One planned whole-space handoff: ``spaceid`` (with every member)
    leaves ``from_game`` for ``to_game`` through the two-phase
    SPACE_MIGRATE protocol (rebalance/migrator.py). ``count`` is the
    population at planning time (projection bookkeeping only)."""

    from_game: int
    to_game: int
    spaceid: str
    count: int


def plan_to_wire(plans: list) -> dict:
    """Serialize a round's plans for the REBALANCE_PLAN push (the sharded
    planner service sends this to a dispatcher for validation/dispatch)."""
    return {
        "moves": [[m.from_game, m.to_game, m.from_space, m.to_space,
                   m.count] for m in plans if isinstance(m, Move)],
        "space_moves": [[m.from_game, m.to_game, m.spaceid, m.count]
                        for m in plans if isinstance(m, SpaceMove)],
    }


def plan_from_wire(payload: dict) -> list:
    """Inverse of :func:`plan_to_wire`; ValueError on malformed input
    (the wire-parser contract — a bad plan must not half-execute)."""
    if not isinstance(payload, dict):
        raise ValueError(f"plan payload is {type(payload).__name__}")
    out: list = []
    try:
        for row in payload.get("moves", []):
            fg, tg, fs, ts, n = row
            out.append(Move(int(fg), int(tg), str(fs), str(ts), int(n)))
        for row in payload.get("space_moves", []):
            fg, tg, sid, n = row
            out.append(SpaceMove(int(fg), int(tg), str(sid), int(n)))
    except (TypeError, ValueError) as exc:
        raise ValueError(f"malformed plan payload: {exc}") from exc
    return out


class RebalancePlanner:
    def __init__(self, cfg) -> None:
        self.cfg = cfg  # RebalanceConfig
        self.reports = ReportTable()
        # (donor, receiver) → monotonic time moves were last issued; both
        # games must report AFTER this before the pair is planned again.
        self._fenced: dict[tuple[int, int], float] = {}
        self.last_result = "idle"  # /healthz visibility

    # --- input ---------------------------------------------------------------

    def on_report(self, gameid: int, report: dict,
                  now: float | None = None) -> None:
        self.reports.update(gameid, report, now)

    def on_game_down(self, gameid: int) -> None:
        self.reports.remove(gameid)

    # --- planning ------------------------------------------------------------

    def plan(self, connected: set[int], now: float) -> list:
        """One planning round. ``connected`` = games with a live dispatcher
        link RIGHT NOW; a reporting game without a link is mid-restart and
        pauses the planner entirely (moving entities toward or away from a
        game whose state is unknown is exactly the thrash this guard
        exists to prevent). Returns a list of Move / SpaceMove."""
        from goworld_tpu_torch import rebalance

        games = self.reports.games()
        fresh = [g for g in games if g in connected]
        if any(g not in connected for g in games):
            # A reporting game without a live link is mid-restart: its
            # state is unknown, so the whole planner pauses (classified
            # before the count check — this is the restart case, not the
            # small-cluster case).
            return self._pause("paused_links", rebalance.PLANS)
        if len(fresh) < 2:
            return self._pause("paused_few", rebalance.PLANS)
        if any(self.reports.age(g, now) > self.cfg.stale_after
               for g in fresh):
            return self._pause("paused_stale", rebalance.PLANS)

        # Working copies the round mutates as it plans: projected entity
        # counts per game, and per-game space rows ([sid, kind, count]) so
        # a moved space's kind becomes absorbable at its receiver within
        # the same round's later pairs.
        proj = {g: self.reports.entities(g) for g in fresh}
        spaces = {
            g: [list(s)
                for s in (self.reports.get(g) or {}).get("spaces", [])]
            for g in fresh
        }
        entity_budget = self.cfg.max_moves_per_round
        space_budget = self.cfg.max_space_moves_per_round
        donors = sorted(
            fresh, key=lambda g: -load_score(self.reports.get(g)))
        plans: list = []
        for donor in donors:
            if entity_budget <= 0 and space_budget <= 0:
                break
            receiver = min(
                (g for g in fresh if g != donor), key=lambda g: proj[g])
            delta = proj[donor] - proj[receiver]
            if delta < self.cfg.min_entity_delta:
                continue
            fence = self._fenced.get((donor, receiver))
            if fence is not None and (
                self.reports.age(donor, now) > now - fence
                or self.reports.age(receiver, now) > now - fence
            ):
                # One (or both) reports predate our previous moves for
                # this pair: acting again would double-count the same
                # imbalance.
                continue
            pair: list = self._pick_spaces(
                spaces[donor], spaces[receiver], donor, receiver,
                min(entity_budget, delta // 2))
            if not pair and space_budget > 0:
                # No same-kind receiver space absorbs entities: move a
                # whole space instead (the bin-packer's placement step).
                pair = self._pick_whole_spaces(
                    spaces[donor], spaces[receiver], donor, receiver,
                    delta, space_budget)
                space_budget -= len(pair)
            else:
                entity_budget -= sum(m.count for m in pair)
            if not pair:
                continue
            moved = sum(m.count for m in pair)
            proj[donor] -= moved
            proj[receiver] += moved
            self._fenced[(donor, receiver)] = now
            plans.extend(pair)

        if not plans:
            self.last_result = (
                "fenced" if self._fenced else "balanced")
            rebalance.PLANS.labels("balanced").inc()
            return []
        n_ent = sum(m.count for m in plans if isinstance(m, Move))
        n_sp = sum(1 for m in plans if isinstance(m, SpaceMove))
        self.last_result = f"moved {n_ent} entities + {n_sp} spaces"
        rebalance.PLANS.labels("moved").inc()
        gwlog.infof(
            "rebalance: plan %s across %d games (scores %s)",
            self.last_result, len(fresh),
            {g: round(load_score(self.reports.get(g)), 1) for g in fresh})
        return plans

    def _pause(self, reason: str, plans) -> list:
        self.last_result = reason
        plans.labels(reason).inc()
        return []

    @staticmethod
    def _pick_spaces(donor_spaces: list, recv_spaces: list, donor: int,
                     receiver: int, budget: int) -> list:
        """Donor spaces largest-first; for each, the emptiest SAME-KIND
        receiver space. Splits the budget across donor spaces as needed
        (a donor whose population is spread over many spaces still
        drains). Mutates the working rows so later pairs in the same
        round see this pair's moves."""
        by_kind: dict[int, list] = {}
        for row in recv_spaces:
            by_kind.setdefault(int(row[1]), []).append(row)
        moves: list = []
        for row in sorted(donor_spaces, key=lambda s: -s[2]):
            if budget <= 0:
                break
            sid, kind, count = row[0], row[1], row[2]
            targets = by_kind.get(int(kind))
            if not targets or count <= 0:
                continue
            target = min(targets, key=lambda s: s[2])
            n = min(budget, int(count))
            moves.append(Move(donor, receiver, sid, target[0], n))
            budget -= n
            row[2] -= n
            target[2] += n  # keep later picks spreading, not stacking
        return moves

    @staticmethod
    def _pick_whole_spaces(donor_spaces: list, recv_spaces: list,
                           donor: int, receiver: int, delta: int,
                           budget: int) -> list:
        """Largest-first-fit whole-space placement: move donor spaces
        (population descending) whose population fits inside HALF the
        pair's remaining delta — a move of ``c`` changes the imbalance
        from ``delta`` to ``delta - 2c``, so ``2c <= delta`` is exactly
        "never past the midpoint": the receiver never ends up hotter than
        the donor, every move strictly improves, no ping-pong (a space of
        4 with delta 4 would flip 8/4 into 4/8 forever). The moved row
        transfers to the receiver's working list, so its kind absorbs
        entity moves in later pairs of the same round."""
        moves: list = []
        for row in sorted(donor_spaces, key=lambda s: -s[2]):
            if budget <= 0 or delta < 1:
                break
            sid, count = row[0], int(row[2])
            if count < 1 or 2 * count > delta:
                continue
            moves.append(SpaceMove(donor, receiver, sid, count))
            donor_spaces.remove(row)
            recv_spaces.append(row)
            delta -= 2 * count
            budget -= 1
        return moves
