"""Tick-phase tracer: per-iteration wall-time attribution for hot loops.

The instrument CheetahGIS-style streaming engines live on: every stage of
the update pipeline gets its own duration histogram, continuously, in
production — so a regression names its phase instead of hiding in an
aggregate tick time (the failure mode that let a 16% CPU-bench
regression pass unnoticed).

Usage, inside a loop that must stay cheap (the 5 ms game tick):

    tracer = PhaseTracer("game_tick_phase_seconds",
                         ("dispatch", "entity_logic", "aoi", "sync_send"))
    while True:
        ...wait for work...
        tracer.begin()            # tick starts AFTER the idle wait
        handle_packets()
        tracer.mark("dispatch")
        tick_timers()
        tracer.mark("entity_logic")
        aoi_tick()
        tracer.mark("aoi")
        post_tick()
        tracer.mark("entity_logic")   # same phase twice: segments accumulate
        tracer.commit()               # observe phases + "total"

Cost per tick: one monotonic() call per mark, a small-dict accumulate, and
one histogram observe per touched phase at commit — microseconds against a
5 ms tick budget.

Phase semantics under the fused tick ([aoi] fuse_logic, entity/columns.py):
per-class columnar tick programs compile INTO the AOI device launch, so
``run_tick_batches`` skips them and ``entity_logic`` collapses to the
residual host work (timers, crontab, post queue, non-fusable hooks) while
the logic cost moves inside the ``aoi`` phase's device step — the collapse
is the observable signature that fusion is live (``bench.py --fused``
reports it; aoi_fused_classes/aoi_fused_slots on /metrics name the cause).
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

from goworld_tpu_torch.telemetry.metrics import REGISTRY, Registry

#: Label value reserved for the whole begin()→commit() span.
TOTAL_PHASE = "total"


class PhaseTracer:
    """Histogram family labeled by ``phase``, fed by begin/mark/commit."""

    __slots__ = ("_family", "_children", "_t0", "_last", "_acc")

    def __init__(self, name: str, phases: Sequence[str], help: str = "",
                 registry: Optional[Registry] = None) -> None:
        reg = registry or REGISTRY
        self._family = reg.histogram(
            name,
            help or "Wall seconds per loop-tick phase (telemetry PhaseTracer).",
            labelnames=("phase",),
        )
        # Pre-resolve children: no labels() dict lookup on the hot path.
        self._children = {p: self._family.labels(p) for p in phases}
        self._children[TOTAL_PHASE] = self._family.labels(TOTAL_PHASE)
        self._t0 = 0.0
        self._last = 0.0
        self._acc: dict[str, float] = {}

    def begin(self) -> None:
        """Start a tick. Call AFTER any idle wait so queue-blocked time
        doesn't pollute the first phase."""
        self._t0 = self._last = time.monotonic()
        self._acc.clear()

    def mark(self, phase: str) -> None:
        """Attribute the segment since the previous mark (or begin) to
        ``phase``. Re-marking a phase within one tick accumulates."""
        now = time.monotonic()
        self._acc[phase] = self._acc.get(phase, 0.0) + (now - self._last)
        self._last = now

    def commit(self):
        """Observe every accumulated phase plus the whole-tick total.

        Returns ``(t0_monotonic, total_seconds, phases_dict)`` so the
        caller can feed the same attribution to the flight recorder /
        trace ring without re-timing anything (None when no begin()
        preceded). The returned dict is a copy — safe to keep."""
        if not self._t0:
            return None  # commit without begin: nothing to attribute
        phases = dict(self._acc)
        for phase, took in phases.items():
            child = self._children.get(phase)
            if child is None:  # late-declared phase: resolve once, keep
                child = self._children[phase] = self._family.labels(phase)
            child.observe(took)
        total = self._last - self._t0
        self._children[TOTAL_PHASE].observe(total)
        t0 = self._t0
        self._t0 = 0.0
        self._acc.clear()
        return t0, total, phases
