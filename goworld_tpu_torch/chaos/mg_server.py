"""Server module of the multigame harness's CHILD game processes.

Registered by ``chaos/game_proc.py`` (the ``python -m`` entry each child
runs) and imported by the parent only for the class names. The world is
deliberately minimal but real: each game creates ``MG_ARENAS`` kind-1 AOI
arenas at deployment-ready (default 1; the whole-space scenarios give the
donor several and the receivers ZERO — a receiver with no same-kind space
is exactly what makes the planner reach for whole-space moves), boot
avatars spread round-robin across their LOCAL arenas (boot is game1-only,
so the initial placement is fully skewed onto game1 — the shape the
rebalancer must fix), and avatars answer Ping→Pong for the harness's
zero-loss roundtrip probes.
"""

from __future__ import annotations

import os

from goworld_tpu_torch.entity import entity_manager as em
from goworld_tpu_torch.entity.entity import Entity
from goworld_tpu_torch.entity.space import Space
from goworld_tpu_torch.entity.vector import Vector3

ARENA_KIND = 1
AOI_DISTANCE = 100.0


def _n_arenas() -> int:
    """How many arenas THIS game process creates at deployment-ready.
    Set per-child by the harness (MG_ARENAS); bad values mean 1."""
    try:
        return max(0, int(os.environ.get("MG_ARENAS", "1")))
    except ValueError:
        return 1


def local_arenas() -> list:
    out = [s for s in em._spaces.values()
           if s.kind == ARENA_KIND and not s.is_destroyed()]
    out.sort(key=lambda s: s.id)  # deterministic round-robin order
    return out


class MGSpace(Space):
    def on_space_created(self):
        if self.kind == ARENA_KIND:
            self.enable_aoi(AOI_DISTANCE)

    def on_game_ready(self):
        # Runs on the nil space at deployment-ready: create this game's
        # configured arena count (a game with MG_ARENAS=0 hosts none — the
        # whole-space receivers start arena-less on purpose).
        if self.is_nil():
            for _ in range(_n_arenas() - len(local_arenas())):
                em.create_space_locally(ARENA_KIND)


class MGAvatar(Entity):
    """Boot avatar: joins a local arena (round-robin across them when the
    game hosts several), echoes Ping→Pong, lets its client drive position
    (the sync plane the migrate window buffers)."""

    _joined = 0

    @classmethod
    def describe_entity_type(cls, desc):
        desc.set_use_aoi(True, AOI_DISTANCE)

    def on_client_connected(self):
        self.set_client_syncing(True)
        self._join_arena()

    def _join_arena(self):
        if self.is_destroyed() or self.client is None:
            return
        arenas = local_arenas()
        if not arenas:
            # Boot raced deployment-ready; the arenas appear momentarily.
            self.add_callback(0.1, "_join_arena")
            return
        if self.space is not None and self.space in arenas:
            return
        arena = arenas[MGAvatar._joined % len(arenas)]
        x = 2.0 * (MGAvatar._joined % 40)
        MGAvatar._joined += 1
        self.enter_space(arena.id, Vector3(x, 0.0, 10.0))

    def Ping_Client(self, n):
        self.call_client("Pong", n)


def register() -> None:
    em.register_space(MGSpace)
    em.register_entity(MGAvatar)
