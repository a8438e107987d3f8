"""The loop a game process runs: a closed loop with one tick in flight.

Each tick the process moves its rows (the traffic), dispatches tick t+1
(``step_async``) and then collects tick t (``collect``, every page
included), as ``BatchAOIService`` runs its tick: one caller that waits for
its previous tick. The window opens at the first timed dispatch and closes
when the last collect returns. It dispatches ticks until ``seconds`` have
passed, or a count fixed before it opens (processes that step one world
must dispatch the same ticks, and agree on the count once, not every
tick); the one in flight at the end is collected.

What the loop keeps, a tick: the host clock before and after the dispatch
and the collect, and the count of pairs received. What it keeps for the
check: the storm (set-up's first tick, which pages), a sample of the
window's ticks drawn from the seed, and the window's last tick: their
positions, flags and pairs.
"""

from __future__ import annotations

import contextlib
import gc
import os
import time

import numpy as np

from gwbench.trace import Stretch


def settle(slot: int) -> None:
    """Steadies a game process's host: every thread of the process on two
    cores of its own (the ``slot``-th pair counted down from the last core,
    so that processes with different slots share none), and one intra-op
    thread for torch's host operations. Acts on this process alone."""
    import torch

    cores = sorted(os.sched_getaffinity(0))
    k = len(cores)
    mine = {cores[(-1 - 2 * slot) % k], cores[(-2 - 2 * slot) % k]}
    for tid in os.listdir("/proc/self/task"):
        try:
            os.sched_setaffinity(int(tid), mine)
        except ProcessLookupError:  # a thread that has ended since
            pass
    torch.set_num_threads(1)


def _meta(traffic):
    return traffic.active, traffic.space, traffic.radius


def _keep(traffic, tick):
    """A checked tick's inputs (the mixes keep flags, spaces and radii
    fixed, so the tick before had the same)."""
    return {
        "tick": tick,
        "prev": traffic.prev.copy(),
        "pos": traffic.pos.copy(),
        "prev_active": traffic.active,
        "active": traffic.active,
        "space": traffic.space,
        "radius": traffic.radius,
    }


def storm(engine, traffic) -> dict:
    """Set-up's first tick: every active entity enters its neighbours'
    interest (the enter storm, paged past the inline budget). Returns its
    check record."""
    pos = traffic.pos
    enters, leaves, dropped = engine.step_async(
        pos, *_meta(traffic), meta_dirty=True).collect()
    rec = {"tick": "storm", "prev": np.zeros_like(pos), "pos": pos.copy(),
           "prev_active": np.zeros_like(traffic.active),
           "active": traffic.active, "space": traffic.space,
           "radius": traffic.radius}
    rec.update(enters=enters, leaves=leaves, dropped=dropped)
    return rec


def warm(engine, traffic, ticks: int) -> float | None:
    """``ticks`` steady ticks through the window's own calls, off the
    clock. Returns the host seconds a tick after the first (None for fewer
    than two ticks)."""
    pending = None
    t1 = None
    for i in range(ticks):
        if i == 1:
            t1 = time.perf_counter()
        nxt = engine.step_async(traffic.advance(), *_meta(traffic),
                                meta_dirty=False)
        if pending is not None:
            pending.collect()
        pending = nxt
    if pending is not None:
        pending.collect()
    if t1 is None:
        return None
    return (time.perf_counter() - t1) / (ticks - 1)


def window(engine, traffic, seconds: float, check_rng, check_share: float,
           stretch: Stretch | None = None, ticks: int | None = None) -> dict:
    """Run the window; returns its samples and its checked ticks.

    ``stretch``: a begun :class:`Stretch` that profiles the window's first
    ticks (None: no profiler). ``ticks``: the count of ticks to dispatch
    (None: as many as ``seconds`` hold)."""
    d0: list[float] = []
    d1: list[float] = []
    c0: list[float] = []
    c1: list[float] = []
    events: list[int] = []
    checks: list[dict] = []
    span = stretch.span if stretch is not None else (
        lambda name: contextlib.nullcontext())
    pending = None
    pending_keep = None
    # Set-up's objects leave the collector's reach: a collection in the
    # window walks the loop's own garbage, not the libraries' heap.
    gc.freeze()
    t0 = time.perf_counter()
    deadline = t0 + seconds

    def land(pend, keep):
        a = time.perf_counter()
        with span("gwbench.collect"):
            enters, leaves, dropped = pend.collect()
        c0.append(a)
        c1.append(time.perf_counter())
        events.append(len(enters) + len(leaves))
        if keep is not None:
            keep.update(enters=enters, leaves=leaves, dropped=dropped)
            checks.append(keep)

    i = 0
    while True:
        with span("gwbench.traffic"):
            pos = traffic.advance()
        keep = None
        if check_rng.random() < check_share:
            keep = _keep(traffic, i)
        if stretch is not None and stretch.active():
            stretch.note(traffic)
        a = time.perf_counter()
        with span("gwbench.dispatch"):
            nxt = engine.step_async(pos, *_meta(traffic), meta_dirty=False)
        d0.append(a)
        d1.append(time.perf_counter())
        if pending is not None:
            land(pending, pending_keep)
        pending, pending_keep = nxt, keep
        i += 1
        if (stretch is not None and stretch.active()
                and len(c1) == stretch.ticks):
            stretch.end(len(c1))
        if (i == ticks if ticks is not None
                else time.perf_counter() >= deadline):
            break
    last = pending_keep or _keep(traffic, i - 1)
    land(pending, last)
    if stretch is not None and stretch.active():
        stretch.end(len(c1))
    # The host clock's samples leave out the ticks the profiler slowed:
    # the stretch's, and the one dispatched before it stopped.
    kept = np.ones(len(d0), bool)
    if stretch is not None:
        kept[:stretch.ticks + 1] = False
    return {
        "t0": t0,
        "t1": c1[-1],
        "dispatch0": np.array(d0),
        "dispatch1": np.array(d1),
        "collect0": np.array(c0),
        "collect1": np.array(c1),
        "events": np.array(events),
        "host_kept": kept,
        "checks": checks,
        "profile": stretch.summary if stretch is not None else None,
    }
