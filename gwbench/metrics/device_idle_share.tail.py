"""Layer: the device. The share of the traced stretch's wall time in which
no operation ran on the card, one minus the union of the device's
activity intervals over the stretch, in %, a mean over the cards;
``torch.profiler``. The profiler slows every launch on the host, so
where the host paces the tick this reads higher than an untraced tick's
share. Moves ``event_latency_p99_ms``."""


def read(run):
    return run.device_idle_share()
