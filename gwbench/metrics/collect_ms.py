"""Layer: readback and paging (``PendingStep.collect``). The host's
milliseconds inside the call, the wait for the device and every page
included, a mean per tick over the window's ticks outside the profiled
stretch; host clock. Moves ``event_latency_p99_ms``."""


def read(run):
    return run.host_mean_ms("collect0", "collect1")
