"""What one run leaves for the metric readers.

A driver returns one record a process (``procs``), each holding the
window's host-clock samples (``loop.window``), the process's rows and
device, its peak memory and, in a traced run, its stretch's summary
(``trace.summarize``). A reader (``metrics/<name>.py``) takes a :class:`Run`
and returns its metric's value, or None where the run holds nothing for it.
"""

from __future__ import annotations

import numpy as np


class Run:
    def __init__(self, cell: dict, procs: list[dict], setup_s: float):
        self.cell = cell
        self.config = cell["config"]
        self.procs = procs
        self.setup_s = setup_s

    def ticks(self) -> int:
        """Ticks every process completed in the window (the same count in
        each: they step one world)."""
        return min(len(p["window"]["collect1"]) for p in self.procs)

    def window_s(self) -> float:
        """From the first process's first dispatch to the last process's
        last collect."""
        return (max(p["window"]["t1"] for p in self.procs)
                - min(p["window"]["t0"] for p in self.procs))

    def active(self) -> int:
        return sum(int(p["active"]) for p in self.procs)

    def host_s(self, start: str, end: str) -> np.ndarray:
        """Host seconds between two of a tick's stamps, over every
        process's ticks that the profiler did not slow."""
        out = []
        for p in self.procs:
            w = p["window"]
            k = len(w[end])
            out.append((w[end] - w[start][:k])[w["host_kept"][:k]])
        return np.concatenate(out)

    def host_mean_ms(self, start: str, end: str) -> float | None:
        """The mean of :meth:`host_s`, in ms (None where no tick counts)."""
        ms = self.host_s(start, end) * 1e3
        return float(ms.mean()) if len(ms) else None

    def profiles(self) -> list[dict]:
        return [p["window"]["profile"] for p in self.procs
                if p["window"]["profile"] is not None]

    def device_profiles(self) -> list[dict]:
        """The profiles that saw the device work (none in a rehearsal on
        the CPU)."""
        return [p for p in self.profiles() if p["busy_s"] > 0]

    def device_ms_per_tick(self) -> float | None:
        """The device's seconds of activity in each traced stretch over its
        ticks, in ms, a mean over the cards."""
        profs = self.device_profiles()
        if not profs:
            return None
        return sum(sum(p["ops"].values()) / p["ticks"]
                   for p in profs) / len(profs) * 1e3

    def device_idle_share(self) -> float | None:
        """One minus the union of the device's activity over each traced
        stretch's wall time, in %, a mean over the cards."""
        profs = self.device_profiles()
        if not profs:
            return None
        return sum(100.0 * (1.0 - p["busy_s"] / p["window_s"])
                   for p in profs) / len(profs)
