"""Load-balancing heap over game CPU reports.

Reference parity: ``components/dispatcher/lbcheap.go:11-78`` — a min-heap of
per-game CPU%; ``chooseGame`` pops the least-loaded game and nudges its load
by +0.1 so repeated picks within one report interval spread out
(DispatcherService.go:529-542,947-957).
"""

from __future__ import annotations

import heapq


class LBCHeap:
    """Min-heap of (cpu_percent, gameid) with lazy invalidation."""

    def __init__(self) -> None:
        self._heap: list[list] = []  # [cpu, gameid, valid]
        self._entries: dict[int, list] = {}

    def update(self, gameid: int, cpu_percent: float) -> None:
        old = self._entries.get(gameid)
        if old is not None:
            old[2] = False
        entry = [cpu_percent, gameid, True]
        self._entries[gameid] = entry
        heapq.heappush(self._heap, entry)
        # Lazy-deletion compaction: periodic reports would otherwise grow the
        # heap without bound when choose() is rarely called.
        if len(self._heap) > 2 * len(self._entries) + 16:
            self._heap = [e for e in self._heap if e[2]]
            heapq.heapify(self._heap)

    def remove(self, gameid: int) -> None:
        old = self._entries.pop(gameid, None)
        if old is not None:
            old[2] = False

    def choose(self) -> int | None:
        """Pop the least-loaded game and re-push with +0.1 nudge
        (lbcheap.go:72-78)."""
        while self._heap:
            cpu, gameid, valid = self._heap[0]
            if not valid or self._entries.get(gameid) is not self._heap[0]:
                heapq.heappop(self._heap)
                continue
            self.update(gameid, cpu + 0.1)
            return gameid
        return None

    def __len__(self) -> int:
        return len(self._entries)

    def validate(self) -> None:
        """Debug-mode invariant check (lbcheap.go:53-71)."""
        for gameid, entry in self._entries.items():
            assert entry[2], f"entry for game {gameid} marked invalid"
            assert entry[1] == gameid
