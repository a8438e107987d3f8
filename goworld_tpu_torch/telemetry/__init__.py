"""goworld_tpu_torch.telemetry — typed metrics, Prometheus exposition, phase tracing.

The engine-wide observability subsystem (README "Telemetry"):

- :mod:`metrics` — Counter / Gauge / Histogram families in a process-wide
  registry (zero-dep, allocation-light hot path).
- :mod:`phases` — :class:`PhaseTracer`, per-tick wall-time attribution for
  the game/gate/dispatcher hot loops.
- Exposition: ``render()`` (Prometheus text 0.0.4, served as ``/metrics``
  by utils/debug_http.py) and ``snapshot()``/``dump()`` (JSON), which
  absorb and supersede the old ``opmon.dump()`` —
  ``utils/opmon.Operation`` is now a thin shim recording into the
  ``op_duration_seconds`` histogram family here.

Module-level helpers record into the default :data:`REGISTRY`; pass an
explicit :class:`Registry` for isolated use (tests, embedded drivers).
"""

from __future__ import annotations

from typing import Optional, Sequence

from goworld_tpu_torch.telemetry.metrics import (  # noqa: F401
    DEFAULT_BUCKETS,
    REGISTRY,
    Counter,
    Gauge,
    Histogram,
    MetricFamily,
    Registry,
    exponential_buckets,
)
from goworld_tpu_torch.telemetry.phases import PhaseTracer, TOTAL_PHASE  # noqa: F401
from goworld_tpu_torch.telemetry import tracing  # noqa: F401


def counter(name: str, help: str = "", labelnames: Sequence[str] = ()):
    """Get-or-create a counter in the default registry (child when
    unlabeled, family when labeled)."""
    return REGISTRY.counter(name, help, labelnames)


def gauge(name: str, help: str = "", labelnames: Sequence[str] = ()):
    return REGISTRY.gauge(name, help, labelnames)


def histogram(name: str, help: str = "", labelnames: Sequence[str] = (),
              buckets: Optional[Sequence[float]] = None):
    return REGISTRY.histogram(name, help, labelnames, buckets)


def family(name: str):
    """The registered MetricFamily for ``name`` (None when absent)."""
    return REGISTRY.family(name)


def render() -> str:
    """Prometheus text exposition of the default registry (``/metrics``)."""
    return REGISTRY.render()


def snapshot() -> dict:
    """JSON-able structured dump of every family and series."""
    return REGISTRY.snapshot()


# dump() is the name opmon historically exported for "give me the JSON
# view"; keep the alias so the supersession reads naturally at call sites.
dump = snapshot


def reset_for_tests() -> None:
    REGISTRY.clear()
