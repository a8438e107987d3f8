"""The traced stretch: ``torch.profiler`` over a run of steady ticks, kept
in memory and reduced to a summary on the spot (no trace file).

The profiler records the device's activity alone: recording the host's
operations too costs microseconds an operation, and the loop's host is
what paces the tick. The benchmark stamps its own host spans instead
(``gwbench.traffic``, ``gwbench.dispatch``, ``gwbench.collect``), on the
clock the profiler reports in (the Unix epoch, in ns). The summary's
window runs from the stretch's first dispatch to its last collect, and
everything else is read inside it:

- ``busy_s``: the union of the device's activity (kernels, copies, fills);
- ``ops``: device seconds by operation name, clipped to the window;
- ``launches``: by operation name, the count and the whole seconds of
  those that start inside the window;
- ``gaps``: the longest idle gaps of the device, each named after the
  benchmark's host span that holds its middle ("host" where none does).
"""

from __future__ import annotations

import contextlib
import time

DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset", "device_op")
TOP = 10


class Stretch:
    """Profiles the first ``ticks`` ticks of a window, from the first one's
    dispatch to the last one's collect. The profiler starts before the
    window opens (:meth:`begin`), since starting it takes seconds; stopping
    it and reading its events falls in the window, after the stretch."""

    def __init__(self, ticks: int, cuda: bool):
        if ticks < 1:
            raise ValueError("a traced stretch holds at least one tick")
        self.ticks = ticks
        self.cuda = cuda
        self.prof = None
        self.summary = None
        self.spans: list[tuple[str, int, int]] = []
        # The first traced tick's inputs, for the occupancy a kernel's
        # bound needs.
        self.first = None

    def note(self, traffic) -> None:
        if self.first is None:
            self.first = {"prev": traffic.prev.copy(),
                          "pos": traffic.pos.copy(),
                          "prev_active": traffic.active,
                          "active": traffic.active, "space": traffic.space,
                          "radius": traffic.radius}

    def active(self) -> bool:
        return self.prof is not None

    @contextlib.contextmanager
    def _stamp(self, name: str):
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((name, t0, time.time_ns()))

    def span(self, name: str):
        if self.prof is None:
            return contextlib.nullcontext()
        return self._stamp(name)

    def begin(self) -> "Stretch":
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CUDA] if self.cuda else [ProfilerActivity.CPU]
        self.prof = profile(activities=acts)
        self.prof.start()
        return self

    def end(self, collected: int) -> None:
        """Stops the profiler once ``collected`` ticks have been collected
        since it began."""
        self.prof.stop()
        events = self.prof.profiler.kineto_results.events()
        self.prof = None
        self.summary = summarize(events, self.spans, collected)
        self.summary["first"] = self.first


def _kind(e) -> str | None:
    """A device event's activity: kineto's name for it where this torch
    says, "gpu_user_annotation" for the device copy of a host span, None
    where neither is known."""
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return kind()
    ann = getattr(e, "is_user_annotation", None)
    if ann is not None and ann():
        return "gpu_user_annotation"
    return None


def _union(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1][1] = b
        else:
            merged.append([a, b])
    return merged


def summarize(events, spans, ticks: int) -> dict:
    """The stretch's summary from kineto's events and the host spans
    ``(name, start_ns, end_ns)``."""
    device = []
    for e in events:
        if not str(e.device_type()).endswith("CUDA"):
            continue
        if (_kind(e) or "device_op") in DEVICE_ACTIVITIES:
            s = e.start_ns()
            device.append((s, s + e.duration_ns(), e.name()))
    dispatches = [s for s in spans if s[0] == "gwbench.dispatch"]
    collects = [s for s in spans if s[0] == "gwbench.collect"]
    if not dispatches or not collects:
        raise RuntimeError("the traced stretch holds no benchmark spans")
    w0 = min(s[1] for s in dispatches)
    w1 = max(s[2] for s in collects)
    ops: dict[str, float] = {}
    launches: dict[str, list] = {}
    clipped = []
    for a, b, name in device:
        if w0 <= a < w1:
            n_t = launches.setdefault(name, [0, 0.0])
            n_t[0] += 1
            n_t[1] += (b - a) * 1e-9
        a, b = max(a, w0), min(b, w1)
        if b > a:
            clipped.append((a, b))
            ops[name] = ops.get(name, 0.0) + (b - a) * 1e-9
    busy = _union(clipped)
    gaps = []
    edge = w0
    for a, b in busy + [[w1, w1]]:
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    named = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]:
        mid = (a + b) // 2
        label = next((name for name, s0, s1 in spans if s0 <= mid < s1),
                     "host")
        named.append([label, (b - a) * 1e-9])
    return {
        "window_s": (w1 - w0) * 1e-9,
        "busy_s": sum(b - a for a, b in busy) * 1e-9,
        "ticks": ticks,
        "ops": ops,
        "launches": launches,
        "gaps": named,
    }
