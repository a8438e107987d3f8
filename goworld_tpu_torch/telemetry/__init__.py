"""Typed metrics of the port: Counter / Gauge / Histogram families in a
process-wide registry of its own (a copy of ``goworld_tpu.telemetry``'s
metrics core; the families the entity model and the AOI service register).

The registry is the port's own, so a process that imports both packages
holds two registries and the same family name never clashes.
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
    """Prometheus text exposition of the default registry."""
    return REGISTRY.render()


def snapshot() -> dict:
    """JSON-able structured dump of every family and series."""
    return REGISTRY.snapshot()


def reset_for_tests() -> None:
    REGISTRY.clear()
