"""Explicit-state model checker for the cluster protocol.

A compact Python model of the dispatcher<->game<->gate state machines —
client-binding generations, migrate target states (connected / blocked /
UNKNOWN / declared-DEAD), reconnect-grace windows, pending-sync parking,
buffered boots — explored EXHAUSTIVELY over bounded interleavings of
message delivery, process crash / cold restart, and grace expiry.  The
transition rules mirror the shipped code path by path (each cites its
``file:line``), so the model is the SPEC: the next protocol PR extends
the model first and lands against these invariants instead of against
production.

Invariants (the zero-loss contract, asserted in every reached state
and at every quiescent terminal state):

- **I1 no lost / duplicate entity** — an entity has exactly one live
  copy across games, in-flight ``REAL_MIGRATE`` payloads, and dispatcher
  grace buffers; a copy count of zero is legal only after the process
  HOSTING the copy (or holding it on a dying socket) crashed.
- **I2 no stale sync delivery** — a position-sync record is never
  delivered to a game that does not host its entity (parking + FIFO
  flush-behind-``REAL_MIGRATE`` is what guarantees it).
- **I3 no stuck terminal** — when no action remains, the entity lives on
  a live game (unless crash-lost), nothing sits in a buffer forever, and
  every boot request was served unless its only game stayed dead.
- **I4 generation-scoped detach** — a gate-restart detach broadcast
  never removes a binding of the valid (new) generation, under any
  cross-dispatcher delivery order.

Scope honesty: the exploration is BOUNDED (budgets below) and the model
abstracts time into nondeterministic grace-expiry events — it proves the
protocol LOGIC under every interleaving within the bounds, not liveness
under real clocks, and not payload encoding (gwlint R7 owns layout).

``python -m goworld_tpu_torch.analysis.modelcheck`` runs the tier-1 configs
and reports deterministic state counts (tools/lint.sh wires it in).

Seeded mutants (``mutants=`` on a config) flip one protocol rule each;
tests/test_modelcheck.py proves every one is caught — the checker has
teeth, not just green lights.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Iterable, NamedTuple, Optional

Msg = tuple[str, ...]
Chan = tuple[Msg, ...]

#: Known mutant switches (test_modelcheck pins each one caught).
MUTANTS = (
    "no_bounce",          # dead-target REAL_MIGRATE dropped, not bounced home
    "no_purge_cold_boot",  # cold handshake keeps the dead incarnation's routes
    "infinite_grace",     # reconnect-grace windows never expire
    "no_sync_parking",    # syncs for a blocked (migrating) entity route anyway
    "skip_gen_check",     # gate-restart detach ignores the valid generation
    "drop_boot_no_game",  # boot with no connected game dropped, not buffered
    # -- space-migration rules (SpaceMigrateModel) --
    "no_space_bounce",    # dead-target SPACE_MIGRATE_DATA dropped, not bounced
    "no_space_park",      # PREPARE skips parking the members' streams
    "no_freeze_cancel_member",  # freeze keeps members' pending entity migrates
    "no_unfreeze_on_abort",     # abort leaves the space FROZEN forever
    "no_frozen_join_guard",     # a join lands in a FROZEN space instead of queueing
)


# --- framework ---------------------------------------------------------------


class Step(NamedTuple):
    label: str
    state: "State"
    violations: tuple[str, ...] = ()


State = tuple  # models return hashable NamedTuples (subtypes of tuple)


class Model:
    """Interface an explorable protocol model implements."""

    name = "model"

    def initial(self) -> State:
        raise NotImplementedError

    def actions(self, s: State) -> list[Step]:
        raise NotImplementedError

    def state_invariants(self, s: State) -> tuple[str, ...]:
        return ()

    def terminal_violations(self, s: State) -> tuple[str, ...]:
        return ()


@dataclasses.dataclass
class Counterexample:
    message: str
    trace: tuple[str, ...]

    def render(self) -> str:
        lines = [f"violation: {self.message}", "  trace:"]
        lines += [f"    {i + 1:2d}. {step}"
                  for i, step in enumerate(self.trace)]
        return "\n".join(lines)


@dataclasses.dataclass
class CheckResult:
    model: str
    states: int
    transitions: int
    terminals: int
    violations: list[Counterexample]

    @property
    def ok(self) -> bool:
        return not self.violations

    def render(self) -> str:
        head = (f"{self.model}: {self.states} states, "
                f"{self.transitions} transitions, {self.terminals} "
                f"terminal state(s), {len(self.violations)} violation(s)")
        return "\n".join([head] + [v.render() for v in self.violations])


def explore(model: Model, max_states: int = 1_000_000,
            max_counterexamples: int = 8) -> CheckResult:
    """Exhaustive BFS over the model's reachable states.  Deterministic:
    identical models explore identical state counts in identical order
    (actions are returned in rule order; the frontier is FIFO)."""
    init = model.initial()
    parents: dict[State, Optional[tuple[State, str]]] = {init: None}
    frontier: deque[State] = deque([init])
    violations: list[Counterexample] = []
    transitions = 0
    terminals = 0

    def trace_to(s: State, last: Optional[str] = None) -> tuple[str, ...]:
        labels: list[str] = [] if last is None else [last]
        cur: Optional[tuple[State, str]] = parents[s]
        while cur is not None:
            labels.append(cur[1])
            cur = parents[cur[0]]
        return tuple(reversed(labels))

    def report(msg: str, s: State, last: Optional[str] = None) -> None:
        if len(violations) < max_counterexamples:
            violations.append(Counterexample(msg, trace_to(s, last)))

    for msg in model.state_invariants(init):
        report(msg, init)
    while frontier:
        if len(parents) > max_states:
            raise RuntimeError(
                f"{model.name}: state space exceeded {max_states} — "
                f"tighten the config bounds")
        s = frontier.popleft()
        steps = model.actions(s)
        if not steps:
            terminals += 1
            for msg in model.terminal_violations(s):
                report(msg, s)
            continue
        for label, nxt, viols in steps:
            transitions += 1
            for msg in viols:
                report(msg, s, label)
            if nxt not in parents:
                parents[nxt] = (s, label)
                frontier.append(nxt)
                for msg in model.state_invariants(nxt):
                    report(msg, nxt)
    return CheckResult(model.name, len(parents), transitions, terminals,
                       violations)


# --- the migrate + crash model ----------------------------------------------
#
# One entity "E" on game 1, one dispatcher, one migration toward game 2.
# Game indices are 0-based internally, 1-based in labels.  Each rule
# cites the code it mirrors.

LINK_CONN = "conn"
LINK_GRACE = "grace"
LINK_UNREG = "unreg"
LINK_DEAD = "dead"

M_MREQ = ("MIGRATE_REQUEST",)
M_MACK = ("MIGRATE_REQUEST_ACK",)
M_RMIG = ("REAL_MIGRATE",)
M_SYNC = ("SYNC_POSITION",)
M_CANCEL = ("CANCEL_MIGRATE",)
M_CREATE = ("NOTIFY_CREATE_ENTITY",)
M_HSHAKE_COLD = ("SET_GAME_ID", "cold")


class MigState(NamedTuple):
    g_alive: tuple[bool, bool]
    g_has_e: tuple[bool, bool]
    g1_migrate: str       # idle | requested | sent | cancelled | closed
    links: tuple[str, str]
    route: int            # 0 unrouted, 1, 2
    blocked: bool         # dispatcher migrate window for E
    parked: Chan          # per-entity pending queue (parked syncs)
    gpending: tuple[Chan, Chan]   # per-game grace buffers
    to_g: tuple[Chan, Chan]       # dispatcher -> game FIFOs
    from_g: tuple[Chan, Chan]     # game -> dispatcher FIFOs
    crashes_left: int
    restarts_left: int
    syncs_left: int
    cancels_left: int
    migrates_left: int
    crash_lost: bool


def _put(chans: tuple[Chan, Chan], i: int, *msgs: Msg
         ) -> tuple[Chan, Chan]:
    out = list(chans)
    out[i] = out[i] + tuple(msgs)
    return (out[0], out[1])


def _pop(chans: tuple[Chan, Chan], i: int) -> tuple[Msg, tuple[Chan, Chan]]:
    out = list(chans)
    head, out[i] = out[i][0], out[i][1:]
    return head, (out[0], out[1])


@dataclasses.dataclass(frozen=True)
class MigConfig:
    name: str = "migrate_crash"
    crashes: int = 1          # crash budget for game 2 (the target)
    restarts: int = 1         # cold-restart budget for game 2
    syncs: int = 1            # position-sync records injected at D
    cancels: int = 1          # migrator deadline-cancel budget
    migrates: int = 1
    target_unregistered: bool = False  # UNKNOWN-target start (replayed
    #                                    RMIG racing a re-handshake)
    mutants: frozenset[str] = frozenset()


class MigrateCrashModel(Model):
    """dispatcher/service.py + rebalance/migrator.py + entity manager
    notify flow, reduced to E's fate under every interleaving."""

    def __init__(self, cfg: MigConfig) -> None:
        bad = cfg.mutants - set(MUTANTS)
        if bad:
            raise ValueError(f"unknown mutants {sorted(bad)}")
        self.cfg = cfg
        self.name = cfg.name

    def initial(self) -> MigState:
        cfg = self.cfg
        return MigState(
            g_alive=(True, True),
            g_has_e=(True, False),
            g1_migrate="idle",
            links=(LINK_CONN,
                   LINK_UNREG if cfg.target_unregistered else LINK_CONN),
            route=1,
            blocked=False,
            parked=(),
            gpending=((), ()),
            to_g=((), ()),
            from_g=((), ()),
            crashes_left=cfg.crashes,
            restarts_left=cfg.restarts,
            syncs_left=cfg.syncs,
            cancels_left=cfg.cancels,
            migrates_left=cfg.migrates,
            crash_lost=False,
        )

    # -- shared sub-rules ---------------------------------------------------

    def _deliver_to_game(self, s: MigState, gi: int, msg: Msg
                         ) -> MigState:
        """_GameInfo.dispatch (dispatcher/service.py:116-122): connected
        sends, a grace/unreg window buffers, a dead game drops."""
        link = s.links[gi]
        if link == LINK_CONN:
            return s._replace(to_g=_put(s.to_g, gi, msg))
        if link in (LINK_GRACE, LINK_UNREG):
            return s._replace(gpending=_put(s.gpending, gi, msg))
        return s  # dead: drop (syncs/acks only ever reach here)

    def _flush_parked(self, s: MigState, gi: int) -> MigState:
        """_flush_entity_pending (dispatcher/service.py:774-779): parked
        packets follow E to wherever it routed, AFTER the REAL_MIGRATE on
        the same FIFO."""
        out = s
        for msg in s.parked:
            out = self._deliver_to_game(out, gi, msg)
        return out._replace(parked=(), blocked=False)

    # -- actions ------------------------------------------------------------

    def actions(self, st: State) -> list[Step]:
        assert isinstance(st, MigState)
        s = st
        cfg = self.cfg
        steps: list[Step] = []

        # migrator issues the move (rebalance/migrator.py:81-99 ->
        # entity.enter_space -> MIGRATE_REQUEST, entity.py:750-765)
        if (s.migrates_left and s.g1_migrate == "idle" and s.g_alive[0]
                and s.g_has_e[0]):
            steps.append(Step(
                "game1: send MIGRATE_REQUEST(E)",
                s._replace(g1_migrate="requested",
                           migrates_left=s.migrates_left - 1,
                           from_g=_put(s.from_g, 0, M_MREQ))))

        # migrator deadline fires (rebalance/migrator.py:143-150 ->
        # cancel_enter_space -> CANCEL_MIGRATE; the entity stays)
        if s.cancels_left and s.g1_migrate == "requested":
            steps.append(Step(
                "game1: migrate deadline -> CANCEL_MIGRATE(E)",
                s._replace(g1_migrate="cancelled",
                           cancels_left=s.cancels_left - 1,
                           from_g=_put(s.from_g, 0, M_CANCEL))))

        # a gate-side sync record reaches the dispatcher
        # (dispatcher/service.py:1222-1290)
        if s.syncs_left:
            nxt = s._replace(syncs_left=s.syncs_left - 1)
            if s.blocked and "no_sync_parking" not in cfg.mutants:
                # park with the entity's pending queue (:1246-1254)
                nxt = nxt._replace(parked=nxt.parked + (M_SYNC,))
            elif s.route == 0:
                # unrouted grace buffer (:757-767)
                nxt = nxt._replace(parked=nxt.parked + (M_SYNC,))
            else:
                nxt = self._deliver_to_game(nxt, s.route - 1, M_SYNC)
            steps.append(Step("gate: SYNC(E) reaches dispatcher", nxt))

        # deliver game -> dispatcher
        for gi in (0, 1):
            if not s.from_g[gi]:
                continue
            msg, from_g = _pop(s.from_g, gi)
            base = s._replace(from_g=from_g)
            steps.append(self._dispatcher_handle(base, gi, msg))

        # deliver dispatcher -> game
        for gi in (0, 1):
            if not s.to_g[gi]:
                continue
            msg, to_g = _pop(s.to_g, gi)
            base = s._replace(to_g=to_g)
            steps.append(self._game_handle(base, gi, msg))

        # crash game 2 (the migrate target)
        if s.crashes_left and s.g_alive[1]:
            lost = s.g_has_e[1] or any(
                m == M_RMIG for m in s.to_g[1])  # on a dying socket
            nxt = s._replace(
                g_alive=(s.g_alive[0], False),
                g_has_e=(s.g_has_e[0], False),
                crashes_left=s.crashes_left - 1,
                to_g=(s.to_g[0], ()),
                from_g=(s.from_g[0], ()),
                links=(s.links[0],
                       LINK_GRACE if s.links[1] == LINK_CONN
                       else s.links[1]),
                crash_lost=s.crash_lost or lost)
            steps.append(Step("game2: CRASH", nxt))

        # cold restart of game 2 (fresh process, empty entity set)
        if s.restarts_left and not s.g_alive[1]:
            steps.append(Step(
                "game2: cold restart -> SET_GAME_ID(cold)",
                s._replace(g_alive=(s.g_alive[0], True),
                           restarts_left=s.restarts_left - 1,
                           from_g=_put(s.from_g, 1, M_HSHAKE_COLD))))

        # an unregistered-but-alive target finally handshakes
        # (the replayed-RMIG-races-rehandshake scenario)
        if (s.g_alive[1] and s.links[1] == LINK_UNREG
                and M_HSHAKE_COLD not in s.from_g[1]):
            steps.append(Step(
                "game2: handshake SET_GAME_ID(cold)",
                s._replace(from_g=_put(s.from_g, 1, M_HSHAKE_COLD))))

        # reconnect-grace expiry on game 2 — the sweep fires on wall
        # clock whether or not the process is back up, including the
        # alive-but-slow-to-handshake UNKNOWN-target window
        # (_sweep_dead_frozen_games:649-676 + _handle_game_down:1410-1424)
        if s.links[1] == LINK_GRACE and \
                "infinite_grace" not in cfg.mutants:
            steps.append(self._expire_game2(s))

        # unrouted-entity sweep drops parked packets for an entity no
        # game claimed (_sweep_unrouted_entities:698-715).  The window is
        # long (seconds) against an in-flight NOTIFY_CREATE (one RTT), so
        # the time-free model does not race the sweep against a CREATE
        # already on the wire.
        if (s.route == 0 and s.parked and not s.blocked
                and not any(M_CREATE in c for c in s.from_g)):
            steps.append(Step(
                "dispatcher: unrouted sweep drops parked packets",
                s._replace(parked=())))

        return steps

    def _dispatcher_handle(self, s: MigState, gi: int, msg: Msg) -> Step:
        g = f"game{gi + 1}"
        cfg = self.cfg
        viols: tuple[str, ...] = ()
        if msg == M_MREQ:
            # block E's stream, ack through the buffered path
            # (_handle_migrate_request:1122-1134)
            nxt = self._deliver_to_game(
                s._replace(blocked=True), 0, M_MACK)
            return Step(f"dispatcher: {g} MIGRATE_REQUEST -> block E, "
                        f"ack", nxt)
        if msg == M_CANCEL:
            # unblock + flush parked to E's current route
            # (_handle_cancel_migrate:1212-1218)
            nxt = s
            if s.route:
                nxt = self._flush_parked(s, s.route - 1)
            nxt = nxt._replace(blocked=False)
            return Step(f"dispatcher: {g} CANCEL_MIGRATE -> unblock E",
                        nxt)
        if msg == M_CREATE:
            # route E here, flush parked (_handle_notify_create_entity)
            nxt = self._flush_parked(s._replace(route=gi + 1), gi)
            return Step(f"dispatcher: {g} NOTIFY_CREATE -> route E", nxt)
        if msg == M_RMIG:
            return self._route_real_migrate(s)
        if msg == M_HSHAKE_COLD:
            # cold boot: purge the dead incarnation's routes, then flush
            # the grace buffer to the fresh process
            # (_handle_set_game_id:857-874 purge, 910 unblock_and_flush)
            nxt = s
            if nxt.route == gi + 1 and \
                    "no_purge_cold_boot" not in cfg.mutants:
                nxt = nxt._replace(route=0)
            links = list(nxt.links)
            links[gi] = LINK_CONN
            gp = list(nxt.gpending)
            flushed = gp[gi]
            gp[gi] = ()
            nxt = nxt._replace(
                links=(links[0], links[1]),
                gpending=(gp[0], gp[1]),
                to_g=_put(nxt.to_g, gi, *flushed))
            return Step(f"dispatcher: {g} cold handshake -> purge stale "
                        f"routes, flush {len(flushed)} buffered", nxt,
                        viols)
        raise AssertionError(f"unmodeled dispatcher message {msg}")

    def _route_real_migrate(self, s: MigState) -> Step:
        """_handle_real_migrate (dispatcher/service.py:1146-1192): route,
        buffer behind a grace window, or bounce the payload HOME — never
        drop the entity's last copy."""
        cfg = self.cfg
        tlink = s.links[1]
        if tlink == LINK_UNREG:
            # unknown target: grant the standard reconnect-grace window
            # and buffer (:1169-1176)
            nxt = s._replace(
                links=(s.links[0], LINK_GRACE), route=2,
                gpending=_put(s.gpending, 1, M_RMIG))
            nxt = self._flush_parked(nxt, 1)
            return Step("dispatcher: REAL_MIGRATE(E) -> unknown game2, "
                        "buffer behind grace window", nxt)
        if tlink in (LINK_CONN, LINK_GRACE):
            nxt = self._deliver_to_game(s._replace(route=2), 1, M_RMIG)
            nxt = self._flush_parked(nxt, 1)
            return Step("dispatcher: REAL_MIGRATE(E) -> route to game2",
                        nxt)
        # declared dead: bounce home (:1177-1192)
        if "no_bounce" in cfg.mutants:
            nxt = s._replace(route=0, blocked=False, parked=())
            return Step("dispatcher: REAL_MIGRATE(E) -> target dead, "
                        "payload DROPPED [mutant]", nxt,
                        ("entity E's last copy dropped at the "
                         "dispatcher (dead target, no bounce)",))
        if s.links[0] in (LINK_CONN, LINK_GRACE):
            nxt = self._deliver_to_game(s._replace(route=1), 0, M_RMIG)
            nxt = self._flush_parked(nxt, 0)
            return Step("dispatcher: REAL_MIGRATE(E) -> target dead, "
                        "bounce HOME to game1", nxt)
        # both ends gone: only reachable with a game-1 crash in budget
        nxt = s._replace(route=0, blocked=False, parked=(),
                         crash_lost=True)
        return Step("dispatcher: REAL_MIGRATE(E) -> both ends crashed; "
                    "state dropped", nxt)

    def _expire_game2(self, s: MigState) -> Step:
        """Grace lapse: bounce buffered REAL_MIGRATEs home, drop the
        rest, declare the game down (purging its routes)."""
        nxt = s
        viols: list[str] = []
        for msg in s.gpending[1]:
            if msg != M_RMIG:
                continue  # parked syncs etc. drop with the window
            if "no_bounce" in self.cfg.mutants:
                viols.append("entity E's last copy dropped at grace "
                             "expiry (no bounce)")
                nxt = nxt._replace(route=0, blocked=False, parked=())
            elif nxt.links[0] in (LINK_CONN, LINK_GRACE):
                nxt = self._deliver_to_game(
                    nxt._replace(route=1), 0, M_RMIG)
                nxt = self._flush_parked(nxt, 0)
            else:
                nxt = nxt._replace(route=0, crash_lost=True)
        nxt = nxt._replace(gpending=(nxt.gpending[0], ()),
                           links=(nxt.links[0], LINK_DEAD))
        if nxt.route == 2:  # _handle_game_down purges dead routes
            nxt = nxt._replace(route=0)
        return Step("dispatcher: game2 grace window expires -> declared "
                    "dead", nxt, tuple(viols))

    def _game_handle(self, s: MigState, gi: int, msg: Msg) -> Step:
        g = f"game{gi + 1}"
        if msg == M_MACK:
            # entity.py:803-847: pack state, send REAL_MIGRATE, destroy
            # the local copy.  A cancelled request ignores the stale ack.
            if gi == 0 and s.g1_migrate == "requested":
                nxt = s._replace(
                    g_has_e=(False, s.g_has_e[1]), g1_migrate="sent",
                    from_g=_put(s.from_g, 0, M_RMIG))
                return Step(f"{g}: MIGRATE_REQUEST_ACK -> send "
                            f"REAL_MIGRATE(E), drop local copy", nxt)
            return Step(f"{g}: stale MIGRATE_REQUEST_ACK ignored", s)
        if msg == M_RMIG:
            # game/service.py:712-725 restore_entity + the entity
            # manager's NOTIFY_CREATE_ENTITY (entity_manager.py:503)
            has = list(s.g_has_e)
            has[gi] = True
            mig = "closed" if gi == 0 else s.g1_migrate
            nxt = s._replace(g_has_e=(has[0], has[1]), g1_migrate=mig,
                             from_g=_put(s.from_g, gi, M_CREATE))
            kind = "bounced home" if gi == 0 else "arrives"
            return Step(f"{g}: REAL_MIGRATE(E) {kind} -> restore, "
                        f"NOTIFY_CREATE", nxt)
        if msg == M_SYNC:
            # The parking clause: a record must never reach a game
            # OTHER than the one holding E's live copy.  A record for an
            # entity with no live copy anywhere (crash-lost) is dropped
            # by ``get_entity -> None`` (game/service.py:667-670) — a
            # legal drop, not a mis-route.
            viols2: tuple[str, ...] = ()
            if not s.g_has_e[gi] and self._copies(s) >= 1:
                viols2 = (f"sync record for E delivered to {g} while E's "
                          f"live copy is elsewhere (stale-game delivery)",)
            return Step(f"{g}: SYNC(E) delivered", s, viols2)
        raise AssertionError(f"unmodeled game message {msg}")

    # -- invariants ---------------------------------------------------------

    def _copies(self, s: MigState) -> int:
        chans: Iterable[Chan] = (*s.to_g, *s.from_g, *s.gpending)
        in_flight = sum(1 for c in chans for m in c if m == M_RMIG)
        return int(s.g_has_e[0]) + int(s.g_has_e[1]) + in_flight

    def state_invariants(self, st: State) -> tuple[str, ...]:
        assert isinstance(st, MigState)
        s = st
        out: list[str] = []
        copies = self._copies(s)
        if copies > 1:
            out.append(f"entity E duplicated: {copies} live copies")
        if copies == 0 and not s.crash_lost:
            out.append("entity E vanished with no crash to blame")
        return tuple(out)

    def terminal_violations(self, st: State) -> tuple[str, ...]:
        assert isinstance(st, MigState)
        s = st
        out: list[str] = []
        hosted_alive = any(s.g_has_e[i] and s.g_alive[i] for i in (0, 1))
        if not hosted_alive and not s.crash_lost:
            out.append("terminal state: E is not hosted by any live game")
        if s.route and not s.g_has_e[s.route - 1]:
            # Route hygiene: the entity table must never keep an entry
            # pointing at a game that does not host the entity — the
            # cold-boot purge (_handle_set_game_id:857-874) and the
            # game-down sweep (_handle_game_down:1410-1424) exist
            # precisely to keep this true.
            out.append(f"terminal state: stale routing-table entry — E "
                       f"routed to game{s.route} which does not host it")
        if any(M_RMIG in gp for gp in s.gpending):
            out.append("terminal state: REAL_MIGRATE(E) stuck in a "
                       "dispatcher buffer forever")
        if s.blocked and all(s.g_alive):
            out.append("terminal state: E's stream blocked forever with "
                       "both games alive")
        return tuple(out)


# --- the gate-generation model ----------------------------------------------


class GateGenState(NamedTuple):
    bindings: frozenset[tuple[str, int]]  # (clientid, gate generation)
    detach_chan: Chan   # dispatcher A -> game (the restart broadcast)
    connect_chan: Chan  # dispatcher B -> game (the new client's boot)
    c2_bound: bool


@dataclasses.dataclass(frozen=True)
class GateGenConfig:
    name: str = "gate_generation"
    valid_gen: int = 2
    mutants: frozenset[str] = frozenset()


class GateGenerationModel(Model):
    """A gate process restarts: its detach broadcast (naming the new
    generation as valid) races the new generation's first client boot on
    a DIFFERENT dispatcher link — the cross-dispatcher ordering.
    Mirrors entity/game_client.py gate_gen + entity_manager
    .on_gate_disconnected(gateid, valid_gen)."""

    def __init__(self, cfg: GateGenConfig) -> None:
        self.cfg = cfg
        self.name = cfg.name

    def initial(self) -> GateGenState:
        return GateGenState(
            bindings=frozenset({("c1", 1)}),
            detach_chan=(("NOTIFY_GATE_DISCONNECTED",
                          str(self.cfg.valid_gen)),),
            connect_chan=(("NOTIFY_CLIENT_CONNECTED", "c2",
                           str(self.cfg.valid_gen)),),
            c2_bound=False,
        )

    def actions(self, st: State) -> list[Step]:
        assert isinstance(st, GateGenState)
        s = st
        steps: list[Step] = []
        if s.detach_chan:
            msg, rest = s.detach_chan[0], s.detach_chan[1:]
            valid = int(msg[1])
            viols: list[str] = []
            if "skip_gen_check" in self.cfg.mutants:
                dropped = s.bindings
            else:
                dropped = frozenset(b for b in s.bindings
                                    if b[1] != valid)
            for cid, gen in dropped:
                if gen == valid:
                    viols.append(
                        f"detach broadcast removed live binding "
                        f"({cid}, gen {gen}) of the VALID generation")
            steps.append(Step(
                f"game: detach gate bindings (valid gen {valid})",
                s._replace(bindings=s.bindings - dropped,
                           detach_chan=rest),
                tuple(viols)))
        if s.connect_chan:
            msg, rest = s.connect_chan[0], s.connect_chan[1:]
            cid, gen = msg[1], int(msg[2])
            steps.append(Step(
                f"game: bind client {cid} (gen {gen})",
                s._replace(bindings=s.bindings | {(cid, gen)},
                           connect_chan=rest, c2_bound=True)))
        return steps

    def terminal_violations(self, st: State) -> tuple[str, ...]:
        assert isinstance(st, GateGenState)
        s = st
        out: list[str] = []
        if ("c1", 1) in s.bindings:
            out.append("dead-generation binding (c1, gen 1) survived "
                       "the restart detach")
        if s.c2_bound and ("c2", self.cfg.valid_gen) not in s.bindings:
            out.append("valid-generation binding (c2) was detached")
        return tuple(out)


# --- the boot-during-link-flap model -----------------------------------------


class BootState(NamedTuple):
    link: str   # conn | grace | dead
    boot: str   # pending | buffered | served | dropped
    reconnects_left: int


@dataclasses.dataclass(frozen=True)
class BootConfig:
    name: str = "boot_flap"
    reconnects: int = 1
    mutants: frozenset[str] = frozenset()


class BootFlapModel(Model):
    """A client boot request arrives while every boot-capable game is
    mid-reconnect (dispatcher/service.py:985-1026): the request buffers
    for the grace window and retries each tick; only a window that
    lapses with no game drops it."""

    def __init__(self, cfg: BootConfig) -> None:
        self.cfg = cfg
        self.name = cfg.name

    def initial(self) -> BootState:
        return BootState(link=LINK_GRACE, boot="pending",
                         reconnects_left=self.cfg.reconnects)

    def actions(self, st: State) -> list[Step]:
        assert isinstance(st, BootState)
        s = st
        steps: list[Step] = []
        if s.boot == "pending":
            if s.link == LINK_CONN:
                steps.append(Step("dispatcher: boot served immediately",
                                  s._replace(boot="served")))
            elif "drop_boot_no_game" in self.cfg.mutants:
                steps.append(Step(
                    "dispatcher: no game -> boot DROPPED [mutant]",
                    s._replace(boot="dropped")))
            else:
                steps.append(Step(
                    "dispatcher: no game -> buffer boot for the grace "
                    "window (:995-1003)",
                    s._replace(boot="buffered")))
        if s.link == LINK_GRACE and s.reconnects_left:
            steps.append(Step(
                "game: reconnects within the grace window",
                s._replace(link=LINK_CONN,
                           reconnects_left=s.reconnects_left - 1)))
        if s.link == LINK_GRACE:
            steps.append(Step("dispatcher: grace window expires",
                              s._replace(link=LINK_DEAD)))
        if s.boot == "buffered" and s.link == LINK_CONN:
            steps.append(Step(
                "dispatcher: tick retry serves the buffered boot "
                "(:1012-1026)", s._replace(boot="served")))
        if s.boot == "buffered" and s.link == LINK_DEAD:
            steps.append(Step(
                "dispatcher: boot window lapsed with no game; dropped",
                s._replace(boot="dropped")))
        return steps

    def terminal_violations(self, st: State) -> tuple[str, ...]:
        assert isinstance(st, BootState)
        s = st
        if s.boot == "dropped" and s.link == LINK_CONN:
            return ("boot request dropped even though a game "
                    "reconnected — every boot must eventually be served",)
        if s.boot not in ("served", "dropped"):
            return (f"terminal state with boot still {s.boot!r}",)
        return ()


# --- the whole-space migration model -----------------------------------------
#
# One space "S" with one member "M" on game 1, one dispatcher, one
# handoff toward game 2, one joiner "J" trying to enter mid-flight.  The
# protocol is freeze-fence + fat transfer with bounce-home: the donor
# freezes membership, broadcasts SPACE_MIGRATE_PREPARE so every owning
# dispatcher parks the members' streams and acks on the SAME FIFO the
# parked traffic rode (the freeze-ack fence of game/service.py), packs
# the snapshot only after every ack (so nothing sent pre-park can be
# lost), and ships one SPACE_MIGRATE_DATA that is routed exactly like
# REAL_MIGRATE — buffer behind a grace window, bounce HOME to the donor
# on a dead target.  COMMIT is successful restore + NOTIFY_CREATE
# rerouting; ABORT is the donor deadline (or a dead-target reply)
# unfreezing in place.  I1/I2/I3 extend verbatim to the space copy and
# the member; I4 (gate generations) is untouched by this protocol.
#
# Scope honesty: one dispatcher stands in for the all-dispatcher
# broadcast (per-dispatcher behavior is symmetric and the fence is
# per-FIFO); the donor game never crashes (after DATA leaves, the donor
# holds nothing — chaos covers donor kills); space-targeted RPC parking
# is not modeled (members' sync traffic is the load-bearing case).

S_PREP_M = ("SPACE_MIGRATE_PREPARE", "members=M")
S_PREP_0 = ("SPACE_MIGRATE_PREPARE", "members=")
S_PACKACK = ("SPACE_MIGRATE_PREPARE_ACK",)
S_DATA = ("SPACE_MIGRATE_DATA",)
S_ABORT_G = ("SPACE_MIGRATE_ABORT", "from_game")
S_ABORT_D = ("SPACE_MIGRATE_ABORT", "from_dispatcher")
S_CREATE = ("NOTIFY_CREATE_SPACE",)
SM_CREATE = ("NOTIFY_CREATE_MEMBER",)
SM_JOIN = ("JOIN_SPACE",)


class SpaceMigState(NamedTuple):
    g_alive: tuple[bool, bool]
    g_space: tuple[str, str]   # none | live | frozen
    sm: str        # donor handoff: idle|preparing|sent|aborted|rolled
    mm: str        # member entity-migrate: idle|requested|cancelled|sent
    m_members: bool            # M is in S's (frozen) membership/snapshot
    m_solo: int                # 0, or the game hosting M standalone
    links: tuple[str, str]
    s_route: int
    m_route: int
    m_blocked: bool
    m_parked: Chan
    j: str   # out|pending|queued|in_frozen|in|dropped|destroyed
    gpending: tuple[Chan, Chan]
    to_g: tuple[Chan, Chan]
    from_g: tuple[Chan, Chan]
    crashes_left: int
    restarts_left: int
    syncs_left: int
    joins_left: int
    cancels_left: int
    migrates_left: int
    member_migrates_left: int
    crash_lost: bool


@dataclasses.dataclass(frozen=True)
class SpaceMigConfig:
    name: str = "space_handoff"
    crashes: int = 1           # crash budget for game 2 (the receiver)
    restarts: int = 1
    syncs: int = 1             # member-position syncs injected at D
    joins: int = 1             # joiner enter-space attempts
    cancels: int = 1           # donor deadline-abort budget
    migrates: int = 1          # whole-space handoff attempts
    member_migrates: int = 0   # member's own entity-migrate attempts
    mutants: frozenset[str] = frozenset()


class SpaceMigrateModel(Model):
    """rebalance/migrator.py space states + dispatcher parking +
    entity_manager pack/restore, reduced to the fate of S, M and J
    under every interleaving."""

    def __init__(self, cfg: SpaceMigConfig) -> None:
        bad = cfg.mutants - set(MUTANTS)
        if bad:
            raise ValueError(f"unknown mutants {sorted(bad)}")
        self.cfg = cfg
        self.name = cfg.name

    def initial(self) -> SpaceMigState:
        cfg = self.cfg
        return SpaceMigState(
            g_alive=(True, True), g_space=("live", "none"),
            sm="idle", mm="idle", m_members=True, m_solo=0,
            links=(LINK_CONN, LINK_CONN), s_route=1, m_route=1,
            m_blocked=False, m_parked=(), j="out",
            gpending=((), ()), to_g=((), ()), from_g=((), ()),
            crashes_left=cfg.crashes, restarts_left=cfg.restarts,
            syncs_left=cfg.syncs, joins_left=cfg.joins,
            cancels_left=cfg.cancels, migrates_left=cfg.migrates,
            member_migrates_left=cfg.member_migrates, crash_lost=False)

    # -- shared sub-rules ---------------------------------------------------

    def _deliver(self, s: SpaceMigState, gi: int, msg: Msg
                 ) -> SpaceMigState:
        link = s.links[gi]
        if link == LINK_CONN:
            return s._replace(to_g=_put(s.to_g, gi, msg))
        if link in (LINK_GRACE, LINK_UNREG):
            return s._replace(gpending=_put(s.gpending, gi, msg))
        return s

    def _flush_m(self, s: SpaceMigState, gi: int) -> SpaceMigState:
        out = s
        for msg in s.m_parked:
            out = self._deliver(out, gi, msg)
        return out._replace(m_parked=(), m_blocked=False)

    def _s_copies(self, s: SpaceMigState) -> int:
        chans: Iterable[Chan] = (*s.to_g, *s.from_g, *s.gpending)
        in_flight = sum(1 for c in chans for m in c if m == S_DATA)
        return sum(1 for g in s.g_space if g in ("live", "frozen")) \
            + in_flight

    def _m_copies(self, s: SpaceMigState) -> int:
        chans: Iterable[Chan] = (*s.to_g, *s.from_g, *s.gpending)
        rmig = sum(1 for c in chans for m in c if m == M_RMIG)
        inside = self._s_copies(s) if s.m_members else 0
        return inside + (1 if s.m_solo else 0) + rmig

    def _m_hosted(self, s: SpaceMigState, gi: int) -> bool:
        return (s.m_members and s.g_space[gi] in ("live", "frozen")) \
            or s.m_solo == gi + 1

    def _unfreeze(self, s: SpaceMigState) -> SpaceMigState:
        """Abort-in-place: space back to live, queued joins replay
        (Space._pending_enters replay on unfreeze)."""
        if "no_unfreeze_on_abort" in self.cfg.mutants:
            return s
        nxt = s._replace(g_space=("live", s.g_space[1]))
        if nxt.j in ("queued", "in_frozen"):
            nxt = nxt._replace(j="in")
        return nxt

    # -- actions ------------------------------------------------------------

    def actions(self, st: State) -> list[Step]:
        assert isinstance(st, SpaceMigState)
        s = st
        cfg = self.cfg
        steps: list[Step] = []

        # planner command lands: freeze S, cancel members' pending
        # entity migrates (frozen membership IS the pack list), send
        # PREPARE to the dispatcher
        if (s.migrates_left and s.sm == "idle" and s.g_alive[0]
                and s.g_space[0] == "live"):
            # PREPARE carries the freeze-time member list: a member
            # that already migrated out is not parked
            prep = S_PREP_M if s.m_members else S_PREP_0
            nxt = s._replace(
                sm="preparing", g_space=("frozen", s.g_space[1]),
                migrates_left=s.migrates_left - 1,
                from_g=_put(s.from_g, 0, prep))
            if (s.mm == "requested"
                    and "no_freeze_cancel_member" not in cfg.mutants):
                nxt = nxt._replace(mm="cancelled")
            steps.append(Step(
                "game1: freeze S (cancel member migrates) -> "
                "SPACE_MIGRATE_PREPARE", nxt))

        # member M starts its own entity migrate (only while the space
        # is live — migrator eligibility skips frozen-space members)
        if (s.member_migrates_left and s.mm == "idle" and s.m_members
                and s.g_space[0] == "live" and s.sm == "idle"
                and s.g_alive[0]):
            steps.append(Step(
                "game1: member M sends MIGRATE_REQUEST",
                s._replace(mm="requested",
                           member_migrates_left=s.member_migrates_left - 1,
                           from_g=_put(s.from_g, 0, M_MREQ))))

        # donor deadline while awaiting acks -> ABORT: unfreeze in
        # place + broadcast the abort so dispatchers unpark
        if s.cancels_left and s.sm == "preparing":
            nxt = self._unfreeze(s)._replace(
                sm="aborted", cancels_left=s.cancels_left - 1,
                from_g=_put(s.from_g, 0, S_ABORT_G))
            steps.append(Step(
                "game1: PREPARE deadline -> abort, unfreeze S in place",
                nxt))

        # a member-position sync record reaches the dispatcher
        if s.syncs_left:
            nxt = s._replace(syncs_left=s.syncs_left - 1)
            if s.m_blocked:
                nxt = nxt._replace(m_parked=nxt.m_parked + (M_SYNC,))
            elif s.m_route == 0:
                nxt = nxt._replace(m_parked=nxt.m_parked + (M_SYNC,))
            else:
                nxt = self._deliver(nxt, s.m_route - 1, M_SYNC)
            steps.append(Step("gate: SYNC(M) reaches dispatcher", nxt))

        # a joiner's enter-space request reaches the dispatcher and is
        # routed by S's routing entry
        if s.joins_left and s.j == "out":
            nxt = s._replace(joins_left=s.joins_left - 1)
            if s.s_route == 0 or s.links[s.s_route - 1] == LINK_DEAD:
                nxt = nxt._replace(j="dropped")  # client retries (legal)
            else:
                nxt = self._deliver(
                    nxt._replace(j="pending"), s.s_route - 1, SM_JOIN)
            steps.append(Step("client: J requests to join S", nxt))

        # deliver game -> dispatcher
        for gi in (0, 1):
            if s.from_g[gi]:
                msg, from_g = _pop(s.from_g, gi)
                steps.append(self._dispatcher_handle(
                    s._replace(from_g=from_g), gi, msg))

        # deliver dispatcher -> game
        for gi in (0, 1):
            if s.to_g[gi]:
                msg, to_g = _pop(s.to_g, gi)
                steps.append(self._game_handle(
                    s._replace(to_g=to_g), gi, msg))

        # crash game 2 (the receiver)
        if s.crashes_left and s.g_alive[1]:
            lost = (s.g_space[1] in ("live", "frozen")
                    or s.m_solo == 2
                    or any(m in (S_DATA, M_RMIG) for m in s.to_g[1]))
            nxt = s._replace(
                g_alive=(s.g_alive[0], False),
                g_space=(s.g_space[0], "none"),
                m_solo=0 if s.m_solo == 2 else s.m_solo,
                crashes_left=s.crashes_left - 1,
                to_g=(s.to_g[0], ()), from_g=(s.from_g[0], ()),
                links=(s.links[0],
                       LINK_GRACE if s.links[1] == LINK_CONN
                       else s.links[1]),
                crash_lost=s.crash_lost or lost)
            if s.j == "pending" and SM_JOIN in s.to_g[1]:
                nxt = nxt._replace(j="dropped")
            steps.append(Step("game2: CRASH", nxt))

        # cold restart of game 2
        if s.restarts_left and not s.g_alive[1]:
            steps.append(Step(
                "game2: cold restart -> SET_GAME_ID(cold)",
                s._replace(g_alive=(s.g_alive[0], True),
                           restarts_left=s.restarts_left - 1,
                           from_g=_put(s.from_g, 1, M_HSHAKE_COLD))))

        # reconnect-grace expiry on game 2
        if s.links[1] == LINK_GRACE:
            steps.append(self._expire_game2(s))

        # park-deadline sweep: parked traffic for a crash-lost member
        # is dropped (the real block() window has a wall-clock deadline;
        # a sync for an entity with no live copy is a legal drop)
        if (s.m_blocked and s.crash_lost and self._m_copies(s) == 0
                and not s.from_g[0] and not s.from_g[1]):
            steps.append(Step(
                "dispatcher: park deadline sweep (member crash-lost)",
                s._replace(m_blocked=False, m_parked=())))

        # unrouted sweep for M's parked packets (same rule as the
        # entity model)
        if (s.m_route == 0 and s.m_parked and not s.m_blocked
                and not any(SM_CREATE in c for c in s.from_g)):
            steps.append(Step(
                "dispatcher: unrouted sweep drops M's parked packets",
                s._replace(m_parked=())))

        return steps

    # -- dispatcher ---------------------------------------------------------

    def _dispatcher_handle(self, s: SpaceMigState, gi: int, msg: Msg
                           ) -> Step:
        g = f"game{gi + 1}"
        cfg = self.cfg
        if msg in (S_PREP_M, S_PREP_0):
            # park every LISTED member stream this dispatcher owns,
            # then ack on the donor's FIFO — the ack fences all
            # pre-park traffic
            if s.links[1] == LINK_DEAD:
                nxt = self._deliver(s, 0, S_ABORT_D)
                return Step("dispatcher: PREPARE -> target dead, reply "
                            "ABORT", nxt)
            nxt = s
            if msg == S_PREP_M and "no_space_park" not in cfg.mutants:
                nxt = nxt._replace(m_blocked=True)
            nxt = self._deliver(nxt, 0, S_PACKACK)
            return Step("dispatcher: PREPARE -> park listed members, "
                        "ack", nxt)
        if msg == S_ABORT_G:
            # donor aborted: unpark members, flush to their route
            nxt = s
            if s.m_route:
                nxt = self._flush_m(s, s.m_route - 1)
            nxt = nxt._replace(m_blocked=False)
            return Step("dispatcher: space ABORT -> unpark M", nxt)
        if msg == S_DATA:
            return self._route_space_data(s)
        if msg == S_CREATE:
            return Step(f"dispatcher: {g} NOTIFY_CREATE(S) -> route S",
                        s._replace(s_route=gi + 1))
        if msg == SM_CREATE:
            nxt = self._flush_m(s._replace(m_route=gi + 1), gi)
            return Step(f"dispatcher: {g} NOTIFY_CREATE(M) -> route M, "
                        f"flush parked", nxt)
        if msg == SM_JOIN:
            # a join bounced off a copy-less game: re-route by S's
            # current entry (enter_space re-resolution)
            if s.s_route == 0 or s.links[s.s_route - 1] == LINK_DEAD:
                return Step("dispatcher: J's join has no routable S -> "
                            "dropped (client retries)",
                            s._replace(j="dropped"))
            nxt = self._deliver(s, s.s_route - 1, SM_JOIN)
            return Step("dispatcher: re-route J's join", nxt)
        if msg == M_MREQ:
            nxt = self._deliver(s._replace(m_blocked=True), 0, M_MACK)
            return Step("dispatcher: M MIGRATE_REQUEST -> block M, ack",
                        nxt)
        if msg == M_RMIG:
            if s.links[1] in (LINK_CONN, LINK_GRACE, LINK_UNREG):
                nxt = self._deliver(s._replace(m_route=2), 1, M_RMIG)
                return Step("dispatcher: REAL_MIGRATE(M) -> game2", nxt)
            nxt = self._deliver(s._replace(m_route=1), 0, M_RMIG)
            return Step("dispatcher: REAL_MIGRATE(M) -> target dead, "
                        "bounce HOME", nxt)
        if msg == M_HSHAKE_COLD:
            nxt = s
            if nxt.s_route == 2:
                nxt = nxt._replace(s_route=0)
            if nxt.m_route == 2:
                nxt = nxt._replace(m_route=0)
            links = (nxt.links[0], LINK_CONN)
            flushed = nxt.gpending[1]
            nxt = nxt._replace(
                links=links, gpending=(nxt.gpending[0], ()),
                to_g=_put(nxt.to_g, 1, *flushed))
            return Step(f"dispatcher: {g} cold handshake -> purge "
                        f"routes, flush {len(flushed)} buffered", nxt)
        raise AssertionError(f"unmodeled dispatcher message {msg}")

    def _route_space_data(self, s: SpaceMigState) -> Step:
        """SPACE_MIGRATE_DATA routes exactly like REAL_MIGRATE: forward,
        buffer behind grace, or bounce the whole space HOME."""
        tlink = s.links[1]
        if tlink in (LINK_CONN, LINK_GRACE, LINK_UNREG):
            nxt = self._deliver(s._replace(s_route=2), 1, S_DATA)
            return Step("dispatcher: SPACE_DATA(S) -> route to game2",
                        nxt)
        if "no_space_bounce" in self.cfg.mutants:
            nxt = s._replace(s_route=0)
            return Step("dispatcher: SPACE_DATA(S) -> target dead, "
                        "payload DROPPED [mutant]", nxt,
                        ("space S's last copy dropped at the dispatcher "
                         "(dead target, no bounce)",))
        nxt = self._deliver(s._replace(s_route=1), 0, S_DATA)
        return Step("dispatcher: SPACE_DATA(S) -> target dead, bounce "
                    "HOME to game1", nxt)

    # -- games --------------------------------------------------------------

    def _game_handle(self, s: SpaceMigState, gi: int, msg: Msg) -> Step:
        g = f"game{gi + 1}"
        if msg == S_PACKACK:
            if gi == 0 and s.sm == "preparing":
                return self._pack(s)
            return Step(f"{g}: stale PREPARE_ACK ignored", s)
        if msg == S_ABORT_D:
            if gi == 0 and s.sm == "preparing":
                nxt = self._unfreeze(s)._replace(
                    sm="aborted", from_g=_put(s.from_g, 0, S_ABORT_G))
                return Step(f"{g}: dispatcher ABORT -> unfreeze S in "
                            f"place", nxt)
            return Step(f"{g}: stale space ABORT ignored", s)
        if msg == S_DATA:
            spaces = list(s.g_space)
            spaces[gi] = "live"
            sm = "rolled" if gi == 0 else s.sm
            creates = (S_CREATE,) + ((SM_CREATE,) if s.m_members else ())
            nxt = s._replace(
                g_space=(spaces[0], spaces[1]), sm=sm,
                from_g=_put(s.from_g, gi, *creates))
            kind = "bounced home (rollback + cooldown)" if gi == 0 \
                else "arrives"
            return Step(f"{g}: SPACE_DATA(S) {kind} -> restore live, "
                        f"NOTIFY_CREATEs", nxt)
        if msg == M_MACK:
            if gi == 0 and s.mm == "requested":
                # membership was fixed at freeze time: a frozen space
                # still counts M in its snapshot (only reachable under
                # the no_freeze_cancel_member mutant)
                members = s.g_space[0] != "live"
                nxt = s._replace(
                    mm="sent", m_members=members,
                    from_g=_put(s.from_g, 0, M_RMIG))
                return Step(f"{g}: M MIGRATE_REQUEST_ACK -> send "
                            f"REAL_MIGRATE(M), drop local copy", nxt)
            return Step(f"{g}: stale MIGRATE_REQUEST_ACK ignored", s)
        if msg == M_RMIG:
            nxt = s._replace(m_solo=gi + 1,
                             from_g=_put(s.from_g, gi, SM_CREATE))
            return Step(f"{g}: REAL_MIGRATE(M) arrives -> restore, "
                        f"NOTIFY_CREATE", nxt)
        if msg == M_SYNC:
            viols: tuple[str, ...] = ()
            if not self._m_hosted(s, gi) and self._m_copies(s) >= 1:
                viols = (f"sync record for M delivered to {g} while M's "
                         f"live copy is elsewhere (stale-game delivery)",)
            return Step(f"{g}: SYNC(M) delivered", s, viols)
        if msg == SM_JOIN:
            state = s.g_space[gi]
            if state == "live":
                return Step(f"{g}: J enters live S", s._replace(j="in"))
            if state == "frozen":
                if "no_frozen_join_guard" in self.cfg.mutants:
                    return Step(f"{g}: J enters FROZEN S [mutant]",
                                s._replace(j="in_frozen"))
                return Step(f"{g}: S frozen -> queue J's enter",
                            s._replace(j="queued"))
            # no copy here (stale delivery window): bounce to re-route
            nxt = s._replace(from_g=_put(s.from_g, gi, SM_JOIN))
            return Step(f"{g}: no S here -> bounce J's join", nxt)
        raise AssertionError(f"unmodeled game message {msg}")

    def _pack(self, s: SpaceMigState) -> Step:
        """All dispatcher acks in: pack the frozen membership, destroy
        the local copies, ship SPACE_MIGRATE_DATA.  Queued joiners are
        re-dispatched AFTER the data on the same FIFO."""
        viols: list[str] = []
        nxt = s._replace(
            g_space=("none", s.g_space[1]), sm="sent",
            from_g=_put(s.from_g, 0, S_DATA))
        if s.j == "queued":
            nxt = nxt._replace(j="pending",
                               from_g=_put(nxt.from_g, 0, SM_JOIN))
        elif s.j == "in_frozen":
            viols.append(
                "joiner J entered the FROZEN space and was destroyed by "
                "the pack (absent from the freeze-time snapshot)")
            nxt = nxt._replace(j="destroyed")
        return Step("game1: all PREPARE acks in -> pack S(+M), destroy "
                    "local, send SPACE_DATA", nxt, tuple(viols))

    def _expire_game2(self, s: SpaceMigState) -> Step:
        """Grace lapse on the receiver: bounce buffered space payloads
        (and member migrates) home, drop the rest, purge routes."""
        nxt = s
        viols: list[str] = []
        for msg in s.gpending[1]:
            if msg == S_DATA:
                if "no_space_bounce" in self.cfg.mutants:
                    viols.append("space S's last copy dropped at grace "
                                 "expiry (no bounce)")
                    nxt = nxt._replace(s_route=0)
                else:
                    nxt = self._deliver(
                        nxt._replace(s_route=1), 0, S_DATA)
            elif msg == M_RMIG:
                nxt = self._deliver(nxt._replace(m_route=1), 0, M_RMIG)
            elif msg == SM_JOIN:
                nxt = nxt._replace(j="dropped")
            # parked syncs etc. drop with the window
        nxt = nxt._replace(gpending=(nxt.gpending[0], ()),
                           links=(nxt.links[0], LINK_DEAD))
        if nxt.s_route == 2:
            nxt = nxt._replace(s_route=0)
        if nxt.m_route == 2:
            nxt = nxt._replace(m_route=0)
        return Step("dispatcher: game2 grace window expires -> declared "
                    "dead", nxt, tuple(viols))

    # -- invariants ---------------------------------------------------------

    def state_invariants(self, st: State) -> tuple[str, ...]:
        assert isinstance(st, SpaceMigState)
        s = st
        out: list[str] = []
        sc = self._s_copies(s)
        if sc > 1:
            out.append(f"space S duplicated: {sc} live copies")
        if sc == 0 and not s.crash_lost:
            out.append("space S vanished with no crash to blame")
        mc = self._m_copies(s)
        if mc > 1:
            out.append(f"member M duplicated: {mc} live copies")
        if mc == 0 and not s.crash_lost:
            out.append("member M vanished with no crash to blame")
        return tuple(out)

    def terminal_violations(self, st: State) -> tuple[str, ...]:
        assert isinstance(st, SpaceMigState)
        s = st
        out: list[str] = []
        if "frozen" in s.g_space:
            out.append("terminal state: space S FROZEN forever — "
                       "abort/commit never unfroze it")
        hosted_live = any(s.g_space[i] == "live" and s.g_alive[i]
                          for i in (0, 1))
        if not hosted_live and not s.crash_lost:
            out.append("terminal state: S is not live on any live game")
        if s.sm == "preparing":
            out.append("terminal state: handoff wedged in PREPARE")
        if s.s_route and s.g_space[s.s_route - 1] == "none":
            out.append(f"terminal state: stale routing-table entry — S "
                       f"routed to game{s.s_route} which does not host "
                       f"it")
        if (s.m_route and not self._m_hosted(s, s.m_route - 1)
                and not s.crash_lost):
            out.append(f"terminal state: stale routing-table entry — M "
                       f"routed to game{s.m_route} which does not host "
                       f"it")
        if any(S_DATA in gp or M_RMIG in gp for gp in s.gpending):
            out.append("terminal state: migrate payload stuck in a "
                       "dispatcher buffer forever")
        if s.m_blocked and not s.crash_lost:
            out.append("terminal state: M's stream parked forever")
        if s.m_parked and not s.crash_lost:
            out.append("terminal state: M's parked packets never "
                       "flushed")
        if s.j in ("pending", "queued", "in_frozen"):
            out.append(f"terminal state: joiner J stuck ({s.j})")
        return tuple(out)


# --- entry points ------------------------------------------------------------


def tier1_configs() -> list[Model]:
    """The bounded configurations tier-1 explores exhaustively."""
    return [
        MigrateCrashModel(MigConfig()),
        MigrateCrashModel(MigConfig(name="migrate_unknown_target",
                                    target_unregistered=True)),
        # the crashed target never comes back: grace expiry MUST bounce
        # the payload home (this is the config that exposes a widened
        # grace window — see the infinite_grace mutant)
        MigrateCrashModel(MigConfig(name="migrate_no_return",
                                    restarts=0)),
        GateGenerationModel(GateGenConfig()),
        BootFlapModel(BootConfig()),
        # whole-space handoff: crash/restart/expiry x abort-deadline x
        # member sync parking x joiner queueing
        SpaceMigrateModel(SpaceMigConfig()),
        # the member-migrates-while-the-space-moves race (freeze must
        # cancel the member's in-flight entity migrate)
        SpaceMigrateModel(SpaceMigConfig(
            name="space_member_race", crashes=0, restarts=0, joins=0,
            member_migrates=1)),
    ]


def deep_configs() -> list[Model]:
    """Wider bounds for the slow suite: more crash/restart/sync budget
    around the same machine."""
    return [
        MigrateCrashModel(MigConfig(
            name="migrate_crash_deep", crashes=2, restarts=2, syncs=2,
            cancels=1)),
        MigrateCrashModel(MigConfig(
            name="migrate_unknown_deep", target_unregistered=True,
            crashes=1, restarts=2, syncs=2)),
        SpaceMigrateModel(SpaceMigConfig(
            name="space_handoff_deep", syncs=2, member_migrates=1)),
    ]


def check_all(models: Iterable[Model],
              max_states: int = 1_000_000) -> list[CheckResult]:
    return [explore(m, max_states=max_states) for m in models]


def main(argv: Optional[list[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="exhaustive cluster-protocol model checker")
    ap.add_argument("--deep", action="store_true",
                    help="also run the slow-suite configurations")
    args = ap.parse_args(argv)
    models = tier1_configs() + (deep_configs() if args.deep else [])
    rc = 0
    for result in check_all(models):
        print(result.render())
        if not result.ok:
            rc = 1
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
