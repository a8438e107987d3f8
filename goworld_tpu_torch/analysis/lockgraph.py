"""Runtime lock-order detector: the dynamic complement to gwlint R4.

``LockGraphMonitor`` wraps ``threading.Lock``/``RLock`` construction so
every lock created while installed is tracked: each acquisition records
directed edges from every lock the acquiring thread already holds to the
new one, keyed by the lock's *creation site* (file:line) so all
instances born at one callsite collapse into a single graph node — that
is what turns "thread A took slab-lock then ring-lock, thread B the
reverse" into a visible AB/BA cycle even when the instances differ.  It
also patches ``time.sleep`` and ``queue.Queue.get/put`` to record any
blocking call made while a tracked lock is held — the game-loop /
storage-worker / network-thread interleavings that were once debugged by hand.

Scope and honesty notes:

- Only locks constructed while installed are tracked; module-level locks
  created at import time are invisible.  Tier-1 therefore installs the
  monitor BEFORE building the cluster under test.
- Edges between two *different* instances from the same creation site
  ("peer" edges, e.g. two Counter ring locks) are recorded but excluded
  from the cycle assertion: same-site nesting is usually a benign
  container-of-children pattern, while a true same-INSTANCE re-acquire
  of a non-reentrant lock is reported immediately as a deadlock.
- The monitor never blocks the program: bookkeeping is a thread-local
  list plus one small mutex around the shared edge set.

Usage (see tests/test_torch_analysis.py)::

    mon = LockGraphMonitor()
    with mon.installed():
        ... build + run the cluster ...
    report = mon.report()
    assert not report["cycles"] and not report["blocking"]
"""

from __future__ import annotations

import queue
import threading
import time
import traceback
from contextlib import contextmanager
from typing import Any, Iterator, Optional

_real_lock_ctor = threading.Lock
_real_rlock_ctor = threading.RLock
_real_sleep = time.sleep
_real_queue_get = queue.Queue.get
_real_queue_put = queue.Queue.put


def _site_name(filename: str, lineno: int) -> str:
    """Short stable site id: last 3 path components + line (bare
    basenames collide — gate/service.py vs dispatcher/service.py)."""
    return f"{'/'.join(filename.split('/')[-3:])}:{lineno}"


def _owned(filename: str) -> bool:
    return "goworld_tpu_torch" in filename.replace("\\", "/").split("/")


def _creation_site() -> tuple[str, bool]:
    """(site, engine_owned) of the frame that constructed the lock —
    first frame outside this module and the threading machinery.
    engine_owned marks locks born in the port's own code: a frame whose
    path has a ``goworld_tpu_torch`` directory, matched on the path
    component (a substring would also own the JAX package's frames), so
    the assertions can scope to locks we own rather than torch/stdlib
    internals created while the monitor happened to be installed."""
    for frame in reversed(traceback.extract_stack()):
        fn = frame.filename
        if fn.endswith("lockgraph.py") or fn.endswith("threading.py"):
            continue
        return _site_name(fn, frame.lineno), _owned(fn)
    return "<unknown>", False


class _TrackedLock:
    """Duck-type of threading.Lock/RLock good enough for `with`,
    Condition wrapping, and bare acquire/release."""

    def __init__(self, monitor: "LockGraphMonitor", inner: Any,
                 site: str, reentrant: bool) -> None:
        self._monitor = monitor
        self._inner = inner
        self.site = site
        self.reentrant = reentrant

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        self._monitor._before_acquire(self, blocking)
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._monitor._after_acquire(self)
        return got

    def release(self) -> None:
        self._monitor._on_release(self)
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc: Any) -> None:
        self.release()

    # RLock internals used by threading.Condition
    def _is_owned(self) -> bool:
        if hasattr(self._inner, "_is_owned"):
            return self._inner._is_owned()
        return self._inner.locked()

    def __repr__(self) -> str:
        return f"<TrackedLock {self.site} reentrant={self.reentrant}>"


class LockGraphMonitor:
    """Records the cross-thread lock acquisition-order graph plus
    blocking-calls-under-lock while installed."""

    def __init__(self) -> None:
        self._mu = _real_lock_ctor()
        self._tls = threading.local()
        # (site_a, site_b) -> count, for a held when b acquired
        self.edges: dict[tuple[str, str], int] = {}
        # same-site different-instance nestings (excluded from cycles)
        self.peer_edges: dict[str, int] = {}
        self.sites: dict[str, int] = {}  # site -> locks created there
        self.goworld_sites: set[str] = set()  # sites in goworld_tpu_torch code
        self.blocking: list[dict] = []  # blocking call under held lock
        self.deadlocks: list[dict] = []  # same-instance re-acquire
        self._installed = False

    # -- bookkeeping ---------------------------------------------------------

    def _held(self) -> list[_TrackedLock]:
        held = getattr(self._tls, "held", None)
        if held is None:
            held = self._tls.held = []
        return held

    def _before_acquire(self, lock: _TrackedLock, blocking: bool) -> None:
        # Tracked locks outlive uninstall() inside long-lived components;
        # only RECORD while installed (held bookkeeping stays on so the
        # per-thread stacks remain balanced either way).
        held = self._held()
        if not held or not self._installed:
            return
        if blocking and not lock.reentrant and any(
                h._inner is lock._inner for h in held):
            with self._mu:
                self.deadlocks.append({
                    "site": lock.site,
                    "thread": threading.current_thread().name,
                    "held": [h.site for h in held],
                    "stack": traceback.format_stack(limit=8),
                })
        with self._mu:
            for h in held:
                if h._inner is lock._inner:
                    continue
                if h.site == lock.site:
                    self.peer_edges[h.site] = \
                        self.peer_edges.get(h.site, 0) + 1
                else:
                    key = (h.site, lock.site)
                    self.edges[key] = self.edges.get(key, 0) + 1

    def _after_acquire(self, lock: _TrackedLock) -> None:
        self._held().append(lock)

    def _on_release(self, lock: _TrackedLock) -> None:
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i] is lock:
                del held[i]
                return

    def _on_blocking(self, what: str) -> None:
        held = self._held()
        if not held or not self._installed:
            return
        site = "<unknown>"
        for frame in reversed(traceback.extract_stack()):
            fn = frame.filename
            if fn.endswith(("lockgraph.py", "threading.py", "queue.py")):
                continue
            site = _site_name(fn, frame.lineno)
            break
        with self._mu:
            self.blocking.append({
                "call": what,
                "site": site,
                "thread": threading.current_thread().name,
                "held": [h.site for h in held],
            })

    # -- installation --------------------------------------------------------

    def _make_lock(self) -> _TrackedLock:
        site, gw = _creation_site()
        with self._mu:
            self.sites[site] = self.sites.get(site, 0) + 1
            if gw:
                self.goworld_sites.add(site)
        return _TrackedLock(self, _real_lock_ctor(), site, reentrant=False)

    def _make_rlock(self) -> _TrackedLock:
        site, gw = _creation_site()
        with self._mu:
            self.sites[site] = self.sites.get(site, 0) + 1
            if gw:
                self.goworld_sites.add(site)
        return _TrackedLock(self, _real_rlock_ctor(), site, reentrant=True)

    def install(self) -> None:
        if self._installed:
            return
        self._installed = True
        monitor = self

        threading.Lock = monitor._make_lock  # type: ignore[assignment]
        threading.RLock = monitor._make_rlock  # type: ignore[assignment]

        def traced_sleep(secs: float) -> None:
            if secs > 0:
                monitor._on_blocking(f"time.sleep({secs!r})")
            _real_sleep(secs)

        def traced_get(self: queue.Queue, block: bool = True,
                       timeout: Optional[float] = None):
            if block and timeout != 0:
                monitor._on_blocking("queue.Queue.get(block=True)")
            return _real_queue_get(self, block, timeout)

        def traced_put(self: queue.Queue, item: Any, block: bool = True,
                       timeout: Optional[float] = None):
            if block and timeout != 0 and self.maxsize > 0:
                monitor._on_blocking("queue.Queue.put(block=True)")
            return _real_queue_put(self, item, block, timeout)

        time.sleep = traced_sleep  # type: ignore[assignment]
        queue.Queue.get = traced_get  # type: ignore[method-assign]
        queue.Queue.put = traced_put  # type: ignore[method-assign]

    def uninstall(self) -> None:
        if not self._installed:
            return
        self._installed = False
        threading.Lock = _real_lock_ctor  # type: ignore[assignment]
        threading.RLock = _real_rlock_ctor  # type: ignore[assignment]
        time.sleep = _real_sleep  # type: ignore[assignment]
        queue.Queue.get = _real_queue_get  # type: ignore[method-assign]
        queue.Queue.put = _real_queue_put  # type: ignore[method-assign]

    @contextmanager
    def installed(self) -> Iterator["LockGraphMonitor"]:
        self.install()
        try:
            yield self
        finally:
            self.uninstall()

    # -- analysis ------------------------------------------------------------

    def find_cycles(self, goworld_only: bool = False) -> list[list[str]]:
        """Cycles in the site-level acquisition-order graph (iterative
        DFS with an explicit stack; peer edges excluded by construction).
        ``goworld_only`` restricts the graph to edges between locks the
        engine itself created — the tier-1 assertion surface."""
        with self._mu:
            adj: dict[str, set[str]] = {}
            for (a, b) in self.edges:
                if goworld_only and not (a in self.goworld_sites
                                         and b in self.goworld_sites):
                    continue
                adj.setdefault(a, set()).add(b)
        WHITE, GRAY, BLACK = 0, 1, 2
        color = {n: WHITE for n in adj}
        cycles: list[list[str]] = []

        def dfs(start: str) -> None:
            stack: list[tuple[str, Iterator[str]]] = [
                (start, iter(adj.get(start, ())))]
            color[start] = GRAY
            path = [start]
            while stack:
                node, it = stack[-1]
                advanced = False
                for nxt in it:
                    c = color.get(nxt, WHITE)
                    if c == GRAY:
                        i = path.index(nxt)
                        cycles.append(path[i:] + [nxt])
                    elif c == WHITE:
                        color[nxt] = GRAY
                        stack.append((nxt, iter(adj.get(nxt, ()))))
                        path.append(nxt)
                        advanced = True
                        break
                if not advanced:
                    color[node] = BLACK
                    stack.pop()
                    path.pop()

        for n in list(adj):
            if color.get(n, WHITE) == WHITE:
                dfs(n)
        return cycles

    def report(self) -> dict:
        with self._mu:
            edges = dict(self.edges)
            peers = dict(self.peer_edges)
            blocking = list(self.blocking)
            deadlocks = list(self.deadlocks)
            sites = dict(self.sites)
        return {
            "locks_created": sum(sites.values()),
            "sites": sites,
            "goworld_sites": sorted(self.goworld_sites),
            "edges": {f"{a} -> {b}": n for (a, b), n in sorted(edges.items())},
            "peer_edges": peers,
            "cycles": self.find_cycles(),
            "goworld_cycles": self.find_cycles(goworld_only=True),
            "goworld_blocking": [
                b for b in blocking
                if any(h in self.goworld_sites for h in b["held"])],
            "blocking": blocking,
            "deadlocks": deadlocks,
        }
