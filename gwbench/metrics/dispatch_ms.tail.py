"""Layer: host API (``NeighborEngine.step_async``,
``MultiHostNeighborEngine.step_async``). The host's milliseconds inside
the call, a mean per tick over the window's ticks outside the profiled
stretch, over every process; host clock. Moves ``event_latency_p99_ms``."""


def read(run):
    return run.host_mean_ms("dispatch0", "dispatch1")
