"""Layer: the tick program (``neighbor._step_pallas`` with its drains;
``mesh._sharded_step`` on each rank). The device's seconds of activity
(kernels, copies, fills) in the traced stretch over its ticks, in ms, a
mean over the cards; ``torch.profiler``. Moves ``event_latency_p99_ms``."""


def read(run):
    return run.device_ms_per_tick()
