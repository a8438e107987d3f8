"""Game-side execution of rebalance moves: hardened cross-game migration.

The dispatcher's REBALANCE_MIGRATE names (from_space, to_space, to_game,
count); this module picks the entities and drives each through the
existing ``enter_space`` cross-game machinery (QUERY_SPACE_GAMEID →
MIGRATE_REQUEST → REAL_MIGRATE), adding the guarantees the organic path
leaves to its 60 s dispatcher window:

- **per-migration deadline**: a migration not done by ``migrate_timeout``
  is cancelled (CANCEL_MIGRATE releases the dispatcher's RPC block) and
  counted ``timeout`` — the entity stays live on this game;
- **bounce-back detection**: if the dispatcher returned the entity home
  because the target game died mid-REAL_MIGRATE, the reappearance inside
  the confirmation window converts the outcome to ``rolled_back`` instead
  of a false ``done``;
- **cooldown with backoff**: a moved (or rolled-back) entity is exempt
  from re-selection for ``cooldown`` seconds, doubling per consecutive
  rollback — a flapping target game cannot make one entity ping-pong.

States per tracked entity id::

    pending     enter_space issued; watching for completion or deadline
    confirming  entity gone locally (REAL_MIGRATE sent); waiting out the
                bounce window before counting ``done``

Whole-SPACE migration extends the same guarantees from entities
to spaces as a crash-safe two-phase handoff, proved model-first in
analysis/modelcheck.py (space_handoff / space_member_race):

- **PREPARE**: freeze the space (joins queue; members' pending entity
  migrates are cancelled LOCALLY — no CANCEL_MIGRATE, the stream must stay
  parked), then broadcast SPACE_MIGRATE_PREPARE carrying the freeze-time
  member list to every dispatcher; each parks exactly the LISTED members
  it routes to this game and acks on its own FIFO (the freeze-ack fence —
  every packet it forwarded pre-park has already arrived here).
- **COMMIT** ≡ all acks in: pack the space + members into ONE
  SPACE_MIGRATE_DATA (destroying the local copies) and send it via the
  space-owner dispatcher, which routes it exactly like REAL_MIGRATE —
  buffer behind a grace window, bounce HOME on a dead target. The
  receiver's restore re-announces every id (NOTIFY_CREATE re-routes and
  unparks). Queued joins re-dispatch behind the data on the same FIFO.
- **ABORT** ≡ the per-space deadline fires while preparing, or a
  dispatcher reports the target dead: unfreeze in place (queued joins
  replay) and broadcast SPACE_MIGRATE_ABORT so every dispatcher unparks.
  A bounced-home data payload restores in place (``rolled_back``).

A space is never in zero places: its last copy is always live on the
donor, live on the receiver, or the in-flight payload a dispatcher is
obligated to deliver or bounce (modelcheck invariant I1 for spaces).

States per tracked space id::

    preparing   PREPARE broadcast; counting acks, watching the deadline
    sent        SPACE_MIGRATE_DATA left; waiting out the bounce window
"""

from __future__ import annotations

import dataclasses

from goworld_tpu_torch import consts
from goworld_tpu_torch.utils import gwlog

# Seconds an entity must stay gone before a departure counts as done: long
# enough for a dispatcher bounce (dead target) to restore it, short enough
# that the counter is live. Bounces ride the same link the REAL_MIGRATE
# left on, so they arrive within an RTT of the dispatcher noticing.
CONFIRM_GRACE = 2.0

# The SPACE grace must additionally outlast the dispatcher's reconnect
# buffer: a SPACE_MIGRATE_DATA whose target is mid-restart parks behind
# the 5 s reconnect window and bounces home only when the game is declared
# DEAD — up to DISPATCHER_RECONNECT_BUFFER_WINDOW later. If the donor has
# already counted the handoff done by then, the bounce looks like a fresh
# receive and the rollback is misclassified (found live by the
# kill-receiver-mid-PREPARE chaos cross).
SPACE_CONFIRM_GRACE = (
    consts.DISPATCHER_RECONNECT_BUFFER_WINDOW + CONFIRM_GRACE)


@dataclasses.dataclass
class _Pending:
    deadline: float
    to_space: str
    nonce_spaceid: str  # the spaceid the enter targets (validity key)


@dataclasses.dataclass
class _PendingSpace:
    deadline: float
    to_game: int
    member_eids: list  # freeze-time membership (the PREPARE park list)
    need_acks: int     # number of dispatchers that must ack
    acks: set          # dispatcher ids acked so far
    state: str         # "preparing" | "sent"


class RebalanceMigrator:
    def __init__(self, migrate_timeout: float = 5.0,
                 cooldown: float = 5.0) -> None:
        self.migrate_timeout = migrate_timeout
        self.cooldown = cooldown
        self._pending: dict[str, _Pending] = {}
        self._confirming: dict[str, float] = {}
        # eid → (exempt-until, consecutive rollbacks)
        self._cooldowns: dict[str, tuple[float, int]] = {}
        self.done = 0
        self.rolled_back = 0
        self.timeouts = 0
        # --- whole-space handoffs ---
        self._pending_spaces: dict[str, _PendingSpace] = {}
        # spaceid → (exempt-until, consecutive failures)
        self._space_cooldowns: dict[str, tuple[float, int]] = {}
        self.spaces_done = 0
        self.spaces_aborted = 0
        self.spaces_rolled_back = 0
        self.spaces_timeout = 0

    # --- selection -----------------------------------------------------------

    def eligible(self, space, now: float) -> list:
        """Movable entities of ``space``: live, client-facing or not, not
        already migrating, not on cooldown. Deterministic order (by id) so
        repeated commands act on a stable prefix."""
        if getattr(space, "frozen", False):
            # Mid-handoff: the freeze-time member list is already the
            # PREPARE park list; donating an entity now would mutate the
            # snapshot (modelcheck no_freeze_cancel_member duplicates it).
            return []
        out = []
        for e in space.entities:
            if e.is_destroyed() or e.is_space_entity():
                continue
            if e.id in self._pending or e.id in self._confirming:
                continue
            cd = self._cooldowns.get(e.id)
            if cd is not None and now < cd[0]:
                continue
            out.append(e)
        out.sort(key=lambda e: e.id)
        return out

    # --- execution -----------------------------------------------------------

    def migrate(self, entity, to_space: str, now: float) -> None:
        """Issue one hardened migration. Reuses the entity's current
        position — a rebalance move is an ops action, not a teleport."""
        self._pending[entity.id] = _Pending(
            now + self.migrate_timeout, to_space, to_space)
        entity.enter_space(to_space, entity.position)

    def handle_command(self, space, to_space: str, count: int,
                       now: float) -> int:
        """REBALANCE_MIGRATE entry: migrate up to ``count`` eligible
        entities of ``space`` into ``to_space``. Returns how many were
        issued."""
        moved = 0
        for e in self.eligible(space, now):
            if moved >= count:
                break
            self.migrate(e, to_space, now)
            moved += 1
        return moved

    # --- whole-space handoff --------------------------------------

    def handle_space_command(self, space, to_game: int, now: float) -> bool:
        """REBALANCE_MIGRATE_SPACE entry: start the two-phase handoff of
        ``space`` to ``to_game``. Returns False when the command is
        refused (already in flight, on cooldown, nil, or self-targeted) —
        a stale command degrades to doing nothing, never to guessing."""
        from goworld_tpu_torch import dispatchercluster
        from goworld_tpu_torch.entity import entity_manager as em

        if (space.is_nil() or space.frozen
                or space.id in self._pending_spaces
                or to_game == em.runtime.gameid):
            return False
        cd = self._space_cooldowns.get(space.id)
        if cd is not None and now < cd[0]:
            return False
        space.freeze_space()
        # Cancel members' pending entity migrates LOCALLY (drop the
        # request; late acks fail the nonce check). Deliberately NOT
        # cancel_enter_space(): CANCEL_MIGRATE would flush the member's
        # dispatcher stream mid-handoff, and the stream must stay parked
        # until the member's NOTIFY_CREATE lands on the receiver (the
        # modelcheck no_freeze_cancel_member mutant duplicates the member
        # without this cancel; space_member_race pins the parking rule).
        member_eids = []
        for e in sorted(space.entities, key=lambda e: e.id):
            if e._enter_space_request is not None:
                gwlog.infof(
                    "rebalance: space %s freezing; locally cancelling "
                    "%s's pending enter", space.id, e.id)
                e._enter_space_request = None
            self._pending.pop(e.id, None)
            member_eids.append(e.id)
        senders = list(dispatchercluster.select_all())
        self._pending_spaces[space.id] = _PendingSpace(
            deadline=now + self.migrate_timeout, to_game=to_game,
            member_eids=member_eids, need_acks=len(senders), acks=set(),
            state="preparing")
        self._spaces_gauge()
        for sender in senders:
            sender.send_space_migrate_prepare(space.id, to_game, member_eids)
        gwlog.infof(
            "rebalance: space %s (%d members) PREPARE broadcast to %d "
            "dispatchers, target game %d", space.id, len(member_eids),
            len(senders), to_game)
        return True

    def on_space_prepare_ack(self, spaceid: str, dispatcherid: int,
                             now: float) -> None:
        """A dispatcher parked the listed members it owns and acked on its
        own FIFO — when every dispatcher has, all pre-park packets have
        been processed here (the freeze-ack fence) and the pack is safe."""
        p = self._pending_spaces.get(spaceid)
        if p is None or p.state != "preparing":
            return  # late ack of an aborted/completed handoff: stale
        p.acks.add(dispatcherid)
        if len(p.acks) >= p.need_acks:
            self._pack_and_send(spaceid, p, now)

    def _pack_and_send(self, spaceid: str, p: _PendingSpace,
                       now: float) -> None:
        from goworld_tpu_torch import dispatchercluster
        from goworld_tpu_torch.entity import entity_manager as em

        space = em.get_space(spaceid)
        if space is None or space.is_destroyed():
            # The space died between freeze and the last ack (game logic
            # destroyed it): nothing to move — unpark and forget.
            del self._pending_spaces[spaceid]
            self._spaces_gauge()
            self._abort_broadcast(spaceid, "space_destroyed")
            self._space_fail(spaceid, "aborted", now)
            return
        bundle, queued = em.pack_space(space)
        dispatchercluster.select_by_entity_id(spaceid).send_space_migrate_data(
            spaceid, p.to_game, bundle, source_game=em.runtime.gameid)
        p.state = "sent"
        p.deadline = now + SPACE_CONFIRM_GRACE
        # Queued joiners re-dispatch AFTER the data: their
        # QUERY_SPACE_GAMEID rides the same space-owner-dispatcher FIFO
        # behind SPACE_MIGRATE_DATA, so the answer names the receiver.
        for entity, pos in queued:
            if not entity.is_destroyed():
                entity.enter_space(spaceid, pos)
        gwlog.infof(
            "rebalance: space %s packed (%d members, %d queued joins "
            "re-dispatched); SPACE_MIGRATE_DATA sent toward game %d",
            spaceid, len(bundle["members"]), len(queued), p.to_game)

    def on_space_abort(self, spaceid: str, reason: str, now: float) -> None:
        """A dispatcher refused the PREPARE (target game dead) — unfreeze
        in place and tell every OTHER dispatcher to unpark (they may have
        parked already; the refusing one did not)."""
        p = self._pending_spaces.get(spaceid)
        if p is None or p.state != "preparing":
            return  # duplicate/late abort: the handoff already resolved
        del self._pending_spaces[spaceid]
        self._spaces_gauge()
        self._unfreeze_local(spaceid)
        self._abort_broadcast(spaceid, reason)
        self._space_fail(spaceid, "aborted", now)
        gwlog.warnf("rebalance: space %s handoff aborted (%s); unfrozen "
                    "in place", spaceid, reason)

    def on_space_data(self, spaceid: str, bundle: dict, source_game: int,
                      now: float) -> None:
        """Inbound SPACE_MIGRATE_DATA. Two meanings, exactly like
        on_arrived: a normal receive (restore the space + members live —
        every NOTIFY_CREATE re-routes and unparks), or the BOUNCE of our
        own handoff (the dispatcher returned it because the target died)
        — then the space restores where it was and the move rolls back."""
        from goworld_tpu_torch import dispatchercluster
        from goworld_tpu_torch.entity import entity_manager as em

        p = self._pending_spaces.pop(spaceid, None)
        self._spaces_gauge()
        em.restore_space_bundle(spaceid, bundle)
        if p is not None:
            # Release the parked streams NOW rather than letting each
            # dispatcher's deadline sweep do it: the members are live here
            # again and their routes never changed (idempotent with the
            # sweep — release is a pop).
            self._abort_broadcast(spaceid, "bounced_home")
            self._space_fail(spaceid, "rolled_back", now)
            gwlog.warnf(
                "rebalance: space %s bounced home (target game down); "
                "restored in place with %d members", spaceid,
                len(bundle.get("members", {})))
            return
        # Receiver side: announce completion so every dispatcher clears
        # its handoff entry, and start the newcomer's cooldown so this
        # game doesn't instantly re-donate it.
        self._space_cooldowns[spaceid] = (now + self.cooldown, 0)
        for sender in dispatchercluster.select_all():
            sender.send_space_migrate_ack(spaceid, em.runtime.gameid)
        gwlog.infof("rebalance: space %s restored here with %d members",
                    spaceid, len(bundle.get("members", {})))

    def _unfreeze_local(self, spaceid: str) -> None:
        from goworld_tpu_torch.entity import entity_manager as em

        space = em.get_space(spaceid)
        if space is not None and space.frozen:
            space.unfreeze_space()

    @staticmethod
    def _abort_broadcast(spaceid: str, reason: str) -> None:
        from goworld_tpu_torch import dispatchercluster

        for sender in dispatchercluster.select_all():
            sender.send_space_migrate_abort(spaceid, reason)

    def _space_fail(self, spaceid: str, outcome: str, now: float) -> None:
        self._space_count(outcome)
        if outcome == "timeout":
            self.spaces_timeout += 1
        elif outcome == "aborted":
            self.spaces_aborted += 1
        else:
            self.spaces_rolled_back += 1
        prev = self._space_cooldowns.get(spaceid)
        fails = (prev[1] if prev else 0) + 1
        self._space_cooldowns[spaceid] = (
            now + self.cooldown * (2 ** min(fails - 1, 6)), fails)

    @staticmethod
    def _space_count(outcome: str) -> None:
        from goworld_tpu_torch import rebalance

        rebalance.SPACE_MIGRATIONS.labels(outcome).inc()

    def _spaces_gauge(self) -> None:
        from goworld_tpu_torch import rebalance

        rebalance.SPACES_IN_FLIGHT.set(len(self._pending_spaces))

    # --- lifecycle notifications --------------------------------------------

    def on_arrived(self, eid: str, now: float) -> None:
        """An entity landed here via REAL_MIGRATE. Two meanings: a normal
        arrival (receiver side — start its cooldown so this game doesn't
        instantly re-donate the newcomer), or a BOUNCE of our own pending
        departure (the dispatcher sent it home because the target game
        died) — then the migration rolls back."""
        if eid in self._confirming or eid in self._pending:
            self._pending.pop(eid, None)
            self._confirming.pop(eid, None)
            self._fail(eid, "rolled_back", now)
            gwlog.warnf("rebalance: %s bounced home (target game down); "
                        "rolled back", eid)
            return
        self._cooldowns[eid] = (now + self.cooldown, 0)

    # --- the state machine ---------------------------------------------------

    def tick(self, now: float) -> None:
        """Advance every tracked migration (called from the game loop's
        entity_logic phase; O(tracked), zero when idle)."""
        if self._pending_spaces:
            self._tick_spaces(now)
        if not self._pending and not self._confirming:
            return
        from goworld_tpu_torch.entity import entity_manager as em

        for eid, p in list(self._pending.items()):
            e = em.get_entity(eid)
            if e is None or e.is_destroyed():
                # REAL_MIGRATE left; hold the outcome until the bounce
                # window passes.
                del self._pending[eid]
                self._confirming[eid] = now + CONFIRM_GRACE
                continue
            req = e._enter_space_request
            if req is None or req[0] != p.nonce_spaceid:
                # Cancelled (dispatcher timeout path) or superseded by an
                # organic enter_space — either way OUR migration is over
                # and the entity stayed.
                del self._pending[eid]
                self._fail(eid, "rolled_back", now)
                continue
            if now >= p.deadline:
                del self._pending[eid]
                e.cancel_enter_space()
                self._fail(eid, "timeout", now)
                gwlog.warnf(
                    "rebalance: migration of %s to %s timed out after "
                    "%.1fs; cancelled (entity stays)", eid, p.to_space,
                    self.migrate_timeout)
        for eid, deadline in list(self._confirming.items()):
            if em.get_entity(eid) is not None:
                # Reappeared outside on_arrived (e.g. restored locally):
                # treat as a rollback all the same.
                del self._confirming[eid]
                self._fail(eid, "rolled_back", now)
            elif now >= deadline:
                del self._confirming[eid]
                self._count("done")
                self.done += 1
                self._cooldowns.pop(eid, None)

    def _tick_spaces(self, now: float) -> None:
        """Space-handoff deadlines. ``preparing`` past the deadline →
        ABORT: unfreeze in place, broadcast the abort so every dispatcher
        unparks, cooldown (modelcheck terminal I3: a space may never stay
        FROZEN forever — the no_unfreeze_on_abort mutant is exactly this
        rule deleted). ``sent`` past the bounce window → done: the data
        was delivered (or is the dispatcher's obligation now)."""
        for spaceid, p in list(self._pending_spaces.items()):
            if now < p.deadline:
                continue
            del self._pending_spaces[spaceid]
            self._spaces_gauge()
            if p.state == "preparing":
                self._unfreeze_local(spaceid)
                self._abort_broadcast(spaceid, "deadline")
                self._space_fail(spaceid, "timeout", now)
                gwlog.warnf(
                    "rebalance: space %s handoff timed out after %.1fs "
                    "with %d/%d acks; unfrozen in place", spaceid,
                    self.migrate_timeout, len(p.acks), p.need_acks)
            else:
                self._space_count("done")
                self.spaces_done += 1
                self._space_cooldowns.pop(spaceid, None)

    def _fail(self, eid: str, outcome: str, now: float) -> None:
        self._count(outcome)
        if outcome == "timeout":
            self.timeouts += 1
        else:
            self.rolled_back += 1
        prev = self._cooldowns.get(eid)
        fails = (prev[1] if prev else 0) + 1
        # Backoff: each consecutive rollback doubles the exemption.
        self._cooldowns[eid] = (
            now + self.cooldown * (2 ** min(fails - 1, 6)), fails)

    @staticmethod
    def _count(outcome: str) -> None:
        from goworld_tpu_torch import rebalance

        rebalance.MIGRATIONS.labels(outcome).inc()

    @property
    def in_flight(self) -> int:
        return len(self._pending) + len(self._confirming)

    @property
    def spaces_in_flight(self) -> int:
        return len(self._pending_spaces)
