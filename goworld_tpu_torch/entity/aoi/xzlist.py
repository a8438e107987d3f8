"""CPU sweep-list AOI manager.

Reference parity: the go-aoi ``XZListAOIManager`` (SURVEY.md §2.4 — sweep
lists sorted by coordinate, O(candidates) neighborhood diffing, one uniform
AOI distance per manager, callbacks fired synchronously inside Enter/Leave/
Moved). This in-repo implementation keeps a list sorted by x; neighbor
queries bisect the x-range then filter by z and euclidean distance —
O(log n + candidates) per update, which matches the reference's per-move
cost profile at demo scales (~hundreds of entities per space).
"""

from __future__ import annotations

import bisect

from goworld_tpu_torch.entity.aoi.base import AOIManagerBase


class _Tracker:
    __slots__ = ("entity", "x", "z", "neighbors")

    def __init__(self, entity, x: float, z: float) -> None:
        self.entity = entity
        self.x = x
        self.z = z
        self.neighbors: set[_Tracker] = set()


class XZListAOIManager(AOIManagerBase):
    def __init__(self, distance: float) -> None:
        self.distance = float(distance)
        self._trackers: dict[object, _Tracker] = {}
        # Sweep list of (x, id(tracker), tracker) kept sorted by x.
        self._xlist: list[tuple[float, int, _Tracker]] = []

    # --- membership --------------------------------------------------------

    def enter(self, entity, x: float, z: float) -> None:
        if entity in self._trackers:
            return
        t = _Tracker(entity, x, z)
        self._trackers[entity] = t
        # Mirror the AOI distance into the slab radius column: the
        # adaptive-sync tier classification (entity/slabs.py) reads it
        # for every backend, and only the batched service fills it
        # otherwise.
        slot = getattr(entity, "_slot", -1)
        slabs = getattr(entity, "_slabs", None)
        if slot >= 0 and slabs is not None:
            slabs.radius[slot] = self.distance
        bisect.insort(self._xlist, (x, id(t), t))
        self._update_neighbors(t)

    def leave(self, entity) -> None:
        t = self._trackers.pop(entity, None)
        if t is None:
            return
        self._xlist.remove((t.x, id(t), t))
        for other in list(t.neighbors):
            self._unlink(t, other)

    def moved(self, entity, x: float, z: float) -> None:
        t = self._trackers.get(entity)
        if t is None:
            return
        self._xlist.remove((t.x, id(t), t))
        t.x = x
        t.z = z
        bisect.insort(self._xlist, (x, id(t), t))
        self._update_neighbors(t)

    # --- internals ---------------------------------------------------------

    def _candidates(self, t: _Tracker):
        d = self.distance
        lo = bisect.bisect_left(self._xlist, (t.x - d, -1, None))
        hi = bisect.bisect_right(self._xlist, (t.x + d, 1 << 62, None))
        for i in range(lo, hi):
            other = self._xlist[i][2]
            if other is not t:
                yield other

    def _in_range(self, a: _Tracker, b: _Tracker) -> bool:
        dx = a.x - b.x
        dz = a.z - b.z
        return dx * dx + dz * dz <= self.distance * self.distance

    def _update_neighbors(self, t: _Tracker) -> None:
        current: set[_Tracker] = set()
        for other in self._candidates(t):
            if self._in_range(t, other):
                current.add(other)
        for other in list(t.neighbors - current):
            self._unlink(t, other)
        for other in current - t.neighbors:
            self._link(t, other)

    @staticmethod
    def _link(a: _Tracker, b: _Tracker) -> None:
        a.neighbors.add(b)
        b.neighbors.add(a)
        a.entity.on_enter_aoi(b.entity)
        b.entity.on_enter_aoi(a.entity)

    @staticmethod
    def _unlink(a: _Tracker, b: _Tracker) -> None:
        a.neighbors.discard(b)
        b.neighbors.discard(a)
        a.entity.on_leave_aoi(b.entity)
        b.entity.on_leave_aoi(a.entity)
