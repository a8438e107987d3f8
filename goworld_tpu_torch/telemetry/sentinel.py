"""Device-runtime sentinel: launch accounting for the engine steps.

The port's copy of ``goworld_tpu.telemetry.sentinel``: the counter
families, their configuration and their readers. Each step program of
the port's engines calls :func:`note_launch` once a call, where the JAX
package's ``SentinelJit`` wraps its counterpart, so each game's
``/metrics`` shows its device steps and the scenario runner's one-launch
gate (``scenarios/runner.py``) sees a dispatch that ran two programs:

- ``ops.neighbor._step_packed_tiered`` (``NeighborEngine``):
  ``aoi_step_{backend}``, or ``aoi_step_fused_{backend}`` when entity
  logic rides the step;
- ``parallel.spatial._spatial_step_pallas_impl`` (a strip tick):
  ``spatial_step_kernel``; ``parallel.mesh._sharded_step`` (an exact
  all-gather fallback tick): ``sharded_step``; their fused variants append
  ``_fused``.

Storm pages (the drains that page an overflowing tick) are not steps and
are not counted.

The JAX package's ``SentinelJit`` wraps ``jax.jit`` to see a retrace (a
new trace of an already compiled step, read from the jit's trace cache),
and a listener forwards jax's persistent compile-cache events. PyTorch
runs eagerly and traces and compiles nothing, so neither has a
counterpart: ``jit_traces_total``, ``jit_retrace_events_total`` and
``jit_cached_traces`` stay 0, :func:`steady_state_retraces` is 0, and the
``[slo] steady_state_retraces`` budget holds trivially.
"""

from __future__ import annotations

from typing import Any, Optional

from goworld_tpu_torch.telemetry.metrics import REGISTRY

_LAUNCHES = REGISTRY.counter(
    "jit_launches_total",
    "Dispatches of each instrumented engine step jit.", ("fn",))
_TRACES = REGISTRY.counter(
    "jit_traces_total",
    "XLA traces (compiles) of each instrumented engine step jit.", ("fn",))
_RETRACES = REGISTRY.counter(
    "jit_retrace_events_total",
    "Steady-state retraces: traces that happened after the warm-tick "
    "threshold on an already-compiled jit (each one is a regression).",
    ("fn",))
_CACHED = REGISTRY.gauge(
    "jit_cached_traces",
    "Live trace-cache entries held by each instrumented jit.", ("fn",))

#: Launches after which a fresh trace on an instance is a steady-state
#: retrace ([telemetry] retrace_warm_ticks).
_warm_launches: int = 32


def configure(warm_launches: Optional[int] = None) -> None:
    global _warm_launches
    if warm_launches is not None:
        _warm_launches = max(1, int(warm_launches))


def configure_from_config(tcfg: Any) -> None:
    """Apply a read_config.TelemetryConfig (each process at boot)."""
    configure(warm_launches=getattr(tcfg, "retrace_warm_ticks", None))


def warm_launches() -> int:
    return _warm_launches


def steady_state_retraces() -> float:
    """Sum of ``jit_retrace_events_total`` across every instrumented jit
    (the bench floor headlines assert this stays 0)."""
    fam = REGISTRY.family("jit_retrace_events_total")
    if fam is None:
        return 0.0
    return sum(child.value for _, child in fam.children())


def note_launch(fn: str) -> None:
    """Count one dispatch of the engine step ``fn`` (the port's engines
    call this where the JAX package's ``SentinelJit`` counts a call)."""
    _LAUNCHES.labels(fn).inc()


def launches_total(fn: str) -> float:
    return float(_LAUNCHES.labels(fn).value)


def traces_total(fn: str) -> float:
    return float(_TRACES.labels(fn).value)


def retrace_events_total(fn: str) -> float:
    return float(_RETRACES.labels(fn).value)
