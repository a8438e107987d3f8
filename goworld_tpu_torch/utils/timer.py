"""Timer service driving entity timers and periodic ticks.

Reference parity: the ``xiaonanln/goTimer`` timer wheel the reference embeds
(Entity.go:392-406 for per-entity timers; GameService.go:171 ``timer.Tick()``
drives them once per 5 ms loop iteration). Python-native design: a heapq-based
priority queue with O(log n) add/cancel and a monotonic-clock ``tick()``.

Timers are *cooperative*: they only fire inside ``tick()``, which the owning
single-threaded loop calls — callbacks therefore never race entity logic,
exactly like the reference.
"""

from __future__ import annotations

import heapq
import itertools
import time
from typing import Callable

from goworld_tpu_torch.utils import gwutils


class TimerHandle:
    __slots__ = ("timer_id", "cancelled")

    def __init__(self, timer_id: int) -> None:
        self.timer_id = timer_id
        self.cancelled = False

    def cancel(self) -> None:
        self.cancelled = True


class TimerService:
    def __init__(self, now: Callable[[], float] = time.monotonic) -> None:
        self._now = now
        self._heap: list[tuple[float, int, TimerHandle, float, Callable]] = []
        self._seq = itertools.count()

    def add_callback(self, delay: float, cb: Callable[[], None]) -> TimerHandle:
        """One-shot timer."""
        return self._schedule(delay, 0.0, cb)

    def add_timer(self, interval: float, cb: Callable[[], None]) -> TimerHandle:
        """Repeating timer with fixed interval."""
        if interval <= 0:
            raise ValueError("repeat interval must be > 0")
        return self._schedule(interval, interval, cb)

    def _schedule(self, delay: float, repeat: float, cb: Callable) -> TimerHandle:
        h = TimerHandle(next(self._seq))
        heapq.heappush(self._heap, (self._now() + delay, h.timer_id, h, repeat, cb))
        return h

    def tick(self) -> int:
        """Fire all due timers; returns number fired."""
        now = self._now()
        fired = 0
        while self._heap and self._heap[0][0] <= now:
            deadline, tid, handle, repeat, cb = heapq.heappop(self._heap)
            if handle.cancelled:
                continue
            if repeat > 0:
                # Re-arm before running so a slow callback can't skew cadence
                # (and so the callback may cancel its own handle).
                next_deadline = deadline + repeat
                if next_deadline <= now:  # missed ticks: don't burst-fire
                    next_deadline = now + repeat
                heapq.heappush(self._heap, (next_deadline, tid, handle, repeat, cb))
            gwutils.run_panicless(cb)
            fired += 1
        return fired

    def next_deadline(self) -> float | None:
        while self._heap and self._heap[0][2].cancelled:
            heapq.heappop(self._heap)
        return self._heap[0][0] if self._heap else None

    def __len__(self) -> int:
        return sum(1 for item in self._heap if not item[2].cancelled)
