"""Panic-resilience idioms.

Reference parity: ``engine/gwutils/gwutils.go:6-42`` — ``RunPanicless`` /
``CatchPanic`` / ``RepeatUntilPanicless`` are the core resilience primitives:
every service loop and user callback in the reference runs inside one so a
panicking entity method cannot take the process down (e.g. GameService.go:73).
"""

from __future__ import annotations

import traceback
from typing import Callable, TypeVar

from goworld_tpu_torch.utils import gwlog

T = TypeVar("T")


def run_panicless(fn: Callable[[], T]) -> bool:
    """Run ``fn``; log-and-swallow any exception. Returns True iff no raise."""
    try:
        fn()
        return True
    except BaseException as e:  # noqa: BLE001 - mirror of recover()
        if isinstance(e, (KeyboardInterrupt, SystemExit)):
            raise
        gwlog.errorf("panic in %s: %s\n%s", fn, e, traceback.format_exc())
        return False


def catch_panic(fn: Callable[[], T]) -> BaseException | None:  # gwlint: keep — reference gwutils API (CatchPanic)
    """Run ``fn``; return the exception it raised, if any."""
    try:
        fn()
        return None
    except BaseException as e:  # noqa: BLE001
        if isinstance(e, (KeyboardInterrupt, SystemExit)):
            raise
        gwlog.errorf("panic in %s: %s\n%s", fn, e, traceback.format_exc())
        return e


def repeat_until_panicless(fn: Callable[[], None]) -> None:
    """Re-run ``fn`` until it completes without raising."""
    while not run_panicless(fn):
        pass
