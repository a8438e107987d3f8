"""Named serial async job groups.

Reference parity: ``engine/async/async.go:32-112`` — each *group* is a named
serial queue (one worker goroutine + channel in the reference; one worker
thread + Queue here). Jobs in a group run strictly in order; their callbacks
are marshalled back to the owning main loop via the post queue, so game logic
never sees concurrency. ``wait_clear`` drains all groups (used at terminate /
freeze, reference async.WaitClear).
"""

from __future__ import annotations

import queue
import threading
import time
import traceback
from typing import Any, Callable

from goworld_tpu_torch.utils import gwlog, post


class _Group:
    def __init__(self, name: str) -> None:
        self.name = name
        self.q: queue.Queue = queue.Queue()
        # pending counts queued + currently-executing jobs; guarded by cond so
        # wait_clear can't observe "drained" between dequeue and execution.
        self.pending = 0
        self.cond = threading.Condition()
        self.thread = threading.Thread(target=self._run, name=f"async-{name}", daemon=True)
        self.thread.start()

    def _run(self) -> None:
        while True:
            item = self.q.get()
            if item is None:
                return
            routine, callback = item
            result, err = None, None
            try:
                result = routine()
            except BaseException as e:  # noqa: BLE001
                err = e
                gwlog.errorf("async %s: job failed: %s\n%s", self.name, e, traceback.format_exc())
            if callback is not None:
                # Bind callback as a default too: the loop rebinds the local
                # on the next iteration before posted lambdas run.
                post.post(lambda r=result, e=err, cb=callback: cb(r, e))
            with self.cond:
                self.pending -= 1
                if self.pending == 0:
                    self.cond.notify_all()

    def submit(self, routine: Callable, callback) -> None:
        with self.cond:
            self.pending += 1
        self.q.put((routine, callback))

    def wait_idle(self, deadline: float) -> bool:
        with self.cond:
            while self.pending > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self.cond.wait(remaining)
        return True


_lock = threading.Lock()
_groups: dict[str, _Group] = {}


def append_job(
    group: str,
    routine: Callable[[], Any],
    callback: Callable[[Any, BaseException | None], None] | None = None,
) -> None:
    """Queue ``routine`` on the named serial group; ``callback(result, error)``
    is posted back to the main loop when it completes."""
    with _lock:
        g = _groups.get(group)
        if g is None:
            g = _groups[group] = _Group(group)
    g.submit(routine, callback)


def wait_clear(timeout: float = 30.0) -> bool:
    """Block until every group has finished all queued jobs (including the
    job currently executing). Callbacks already posted back to the main loop
    are not waited on — the caller must keep ticking post."""
    deadline = time.monotonic() + timeout
    with _lock:
        groups = list(_groups.values())
    return all(g.wait_idle(deadline) for g in groups)
