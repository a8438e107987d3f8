"""Event latency: for each tick, the host's milliseconds from the start of
its ``step_async`` to the return of the ``collect`` that brings its last
enter and leave pair to the host (every page included); the 99th
percentile over every tick of the window, every process's; host clock."""

import numpy as np


def read(run):
    ms = run.host_s("dispatch0", "collect1") * 1e3
    return float(np.percentile(ms, 99)) if len(ms) else None
