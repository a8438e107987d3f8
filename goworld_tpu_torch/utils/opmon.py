"""Operation monitor: named op duration stats + slow-op warnings.

Reference parity: ``engine/opmon/opmon.go:37-118`` — operations are wrapped
with a monitor that records count/total/max duration and warns when an op
exceeds its threshold; a periodic dump prints the table.

Since the telemetry subsystem landed this module is a thin SHIM: every
``Operation`` records into the ``op_duration_seconds{op=...}`` histogram
family of :data:`goworld_tpu_torch.telemetry.REGISTRY`, so existing call sites
(gate packet handling, storage saves, aoi.dispatch/deliver/drain) feed the
same registry ``/metrics`` renders — one instrumentation plane, two views.
``dump()`` keeps its legacy shape ({name: {count, avg, max, p50, p99}}) for
``/opmon`` and tests; ``telemetry.snapshot()`` is the superset.
"""

from __future__ import annotations

import time

from goworld_tpu_torch import telemetry
from goworld_tpu_torch.utils import gwlog

_OP_METRIC = "op_duration_seconds"


def _family():
    return telemetry.histogram(
        _OP_METRIC,
        "Named operation durations (opmon shim; op = operation name).",
        labelnames=("op",),
    )


class Operation:
    """Usage: ``op = opmon.Operation("dispatch"); ...; op.finish(0.01)``."""

    __slots__ = ("name", "start")

    def __init__(self, name: str) -> None:
        self.name = name
        self.start = time.monotonic()

    def finish(self, warn_threshold: float = 0.0) -> float:
        took = time.monotonic() - self.start
        _family().labels(self.name).observe(took)
        if warn_threshold and took > warn_threshold:
            gwlog.warnf("opmon: operation %s took %.3fs > %.3fs", self.name, took, warn_threshold)
        return took


def dump() -> dict[str, dict[str, float]]:
    """Legacy opmon table: {op: {count, avg, max, p50, p99}} — percentiles
    from the histogram's bounded sample ring (nearest-rank)."""
    out = {}
    for values, hist in _family().children():
        cnt = hist.count
        out[values[0]] = {
            "count": cnt,
            "avg": hist.sum / cnt if cnt else 0.0,
            "max": hist.max,
            "p50": hist.percentile(0.50),
            "p99": hist.percentile(0.99),
        }
    return out


def dump_log() -> None:  # gwlint: keep — operator-facing opmon shim (reference Dump parity)
    for name, st in sorted(dump().items()):
        gwlog.infof(
            "opmon: %-32s count=%-8d avg=%.3fms p50=%.3fms p99=%.3fms "
            "max=%.3fms",
            name, st["count"], st["avg"] * 1000,
            st.get("p50", 0.0) * 1000, st.get("p99", 0.0) * 1000,
            st["max"] * 1000,
        )


def reset() -> None:
    _family().clear()
