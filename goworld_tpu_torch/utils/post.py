"""Main-loop deferred callback queue.

Reference parity: ``engine/post/post.go:11-44`` — callbacks registered from
anywhere are drained by ``tick()`` at the end of every main-loop iteration.
Single-threaded logic loops + ``post`` is how the reference designs races away
(SURVEY.md §5.2); we keep the same idiom, with a lock so worker threads
(storage/kvdb backends) may post back into the loop.
"""

from __future__ import annotations

import threading
from typing import Callable

from goworld_tpu_torch.utils import gwutils


class PostQueue:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._callbacks: list[Callable[[], None]] = []

    def post(self, cb: Callable[[], None]) -> None:
        with self._lock:
            self._callbacks.append(cb)

    def tick(self) -> int:
        """Drain all callbacks posted so far (including ones posted while
        draining, matching post.Tick's loop-until-empty). Returns count run."""
        n = 0
        while True:
            with self._lock:
                if not self._callbacks:
                    return n
                batch, self._callbacks = self._callbacks, []
            for cb in batch:
                gwutils.run_panicless(cb)
                n += 1

    def __len__(self) -> int:
        with self._lock:
            return len(self._callbacks)


# Module-level default queue, mirroring the reference's package-global.
_default = PostQueue()


def post(cb: Callable[[], None]) -> None:
    _default.post(cb)


def tick() -> int:
    return _default.tick()


def clear() -> None:
    """Test helper: drop pending callbacks."""
    global _default
    _default = PostQueue()
