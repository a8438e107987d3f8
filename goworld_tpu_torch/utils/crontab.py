"""Cron-style scheduled callbacks with minute resolution.

Reference parity: ``engine/crontab/crontab.go:11-185`` — register callbacks by
(minute, hour, day, month, dayofweek); a **negative value -N means "every N"**
(e.g. minute=-5 → every 5 minutes); checked once per minute off the main timer.
"""

from __future__ import annotations

import itertools
import time
from typing import Callable

from goworld_tpu_torch.utils import gwutils


class CronHandle:
    __slots__ = ("cron_id", "cancelled")

    def __init__(self, cron_id: int) -> None:
        self.cron_id = cron_id
        self.cancelled = False

    def cancel(self) -> None:
        self.cancelled = True


class Crontab:
    def __init__(self, now: Callable[[], float] = time.time) -> None:
        self._now = now
        self._entries: dict[int, tuple[int, int, int, int, int, Callable]] = {}
        self._handles: dict[int, CronHandle] = {}
        self._seq = itertools.count()
        self._last_minute = int(self._now() // 60)

    def register(
        self,
        minute: int,
        hour: int,
        day: int,
        month: int,
        dayofweek: int,
        cb: Callable[[], None],
    ) -> CronHandle:
        self._validate(minute, 0, 59)
        self._validate(hour, 0, 23)
        self._validate(day, 1, 31)
        self._validate(month, 1, 12)
        # dayofweek: 0=Sunday like the reference (Go time.Weekday); 7 also
        # accepted as Sunday.
        if dayofweek == 7:
            dayofweek = 0
        self._validate(dayofweek, 0, 6)
        h = CronHandle(next(self._seq))
        self._entries[h.cron_id] = (minute, hour, day, month, dayofweek, cb)
        self._handles[h.cron_id] = h
        return h

    @staticmethod
    def _validate(v: int, lo: int, hi: int) -> None:
        if v >= 0 and not (lo <= v <= hi):
            raise ValueError(f"cron field {v} out of range [{lo},{hi}]")

    @staticmethod
    def _match(spec: int, value: int) -> bool:
        if spec < 0:  # every N
            return value % (-spec) == 0
        return spec == value

    def check(self) -> int:
        """Fire entries whose spec matches any minute since the last check.
        Call from the main loop at >= 1/minute cadence. Returns fires."""
        cur_minute = int(self._now() // 60)
        fired = 0
        while self._last_minute < cur_minute:
            self._last_minute += 1
            t = time.localtime(self._last_minute * 60)
            for cron_id, (mi, h, d, mo, dow, cb) in list(self._entries.items()):
                handle = self._handles.get(cron_id)
                if handle is not None and handle.cancelled:
                    del self._entries[cron_id]
                    del self._handles[cron_id]
                    continue
                # tm_wday is Monday=0; convert to Sunday=0 (Go time.Weekday).
                if (
                    self._match(mi, t.tm_min)
                    and self._match(h, t.tm_hour)
                    and self._match(d, t.tm_mday)
                    and self._match(mo, t.tm_mon)
                    and self._match(dow, (t.tm_wday + 1) % 7)
                ):
                    gwutils.run_panicless(cb)
                    fired += 1
        return fired


_default = Crontab()


def register(minute: int, hour: int, day: int, month: int, dayofweek: int, cb) -> CronHandle:
    return _default.register(minute, hour, day, month, dayofweek, cb)


def check() -> int:
    return _default.check()
