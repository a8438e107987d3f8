"""Process bootstrap helpers.

Reference parity: ``engine/binutil`` — the ``-d`` daemon mode (go-daemon on
unix) plus log/stdio plumbing. The debug HTTP server half of binutil lives
in utils/debug_http.py.
"""

from __future__ import annotations

import os
import sys


def daemonize(logfile: str | None = None) -> None:
    """Detach from the controlling terminal (classic unix double fork).

    stdout/stderr are redirected to ``logfile`` (append) or /dev/null, stdin
    to /dev/null. Call before any event loop or thread is created.
    """
    if not hasattr(os, "fork"):  # non-unix: run in foreground
        return
    if os.fork() > 0:
        os._exit(0)  # first parent: let the shell return
    os.setsid()
    if os.fork() > 0:
        os._exit(0)  # session leader exits: can never reacquire a tty
    sys.stdout.flush()
    sys.stderr.flush()
    devnull_r = os.open(os.devnull, os.O_RDONLY)
    os.dup2(devnull_r, 0)
    if logfile:
        out = os.open(logfile, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
    else:
        out = os.open(os.devnull, os.O_WRONLY)
    os.dup2(out, 1)
    os.dup2(out, 2)
