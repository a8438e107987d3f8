"""The strip tier's telemetry in the port against the JAX strip engine's.

Each case steps a port ``SpatialShardedNeighborEngine`` and a JAX one on
the same trace, tick by tick, and holds the port's registry against the JAX
package's: every strip family (``aoi_spatial_fast_ticks_total``,
``aoi_strip_ring_distance``, ``aoi_shard_count``, ``aoi_shard_entities``,
``aoi_halo_bytes_total``, ``aoi_allgather_bytes_total``,
``aoi_halo_bytes_per_tick``, ``aoi_allgather_equiv_bytes_per_tick``,
``aoi_shard_migrations_total``, ``aoi_shard_fallback_total``,
``aoi_shard_replans_total`` and the halo children of
``aoi_link_bytes_total``) with the same kind, help text and labels, each
counter's growth over the trace and each gauge's value equal. Two pairs:
the port's reference backend against JAX ``jnp``, and the port's kernel
backend (its plain drain form) against JAX ``pallas_interpret`` with the
drain form off (the reference's drain form needs ``pl.store``, which this
jax lacks; the families do not depend on the drain). The traces are those
of ``tests/test_torch_spatial.py``'s engine test, plus one for each
fallback reason the teleport trace does not reach (``halo_overflow``,
``strip_overflow``) and a skewed crowd whose re-plan is adopted. The
counters must also equal the port engine's plain attributes.
"""

import dataclasses

import numpy as np
import pytest

from goworld_tpu import telemetry as jax_telemetry
from goworld_tpu.parallel import make_mesh as jax_make_mesh
from goworld_tpu.parallel import spatial as js
from goworld_tpu_torch import telemetry
from goworld_tpu_torch.ops import neighbor as tn
from goworld_tpu_torch.parallel import make_mesh
from goworld_tpu_torch.parallel import spatial as ts
from goworld_tpu_torch.telemetry import tracing
from test_spatial_pallas import (
    PARAMS, STRIP_COLS, WORLD_X, WORLD_Z, make_world,
)
from test_torch_spatial import TRACES, drift

FAMILIES = (
    "aoi_spatial_fast_ticks_total", "aoi_strip_ring_distance",
    "aoi_shard_count", "aoi_shard_entities", "aoi_halo_bytes_total",
    "aoi_allgather_bytes_total", "aoi_halo_bytes_per_tick",
    "aoi_allgather_equiv_bytes_per_tick", "aoi_shard_migrations_total",
    "aoi_shard_fallback_total", "aoi_shard_replans_total",
    "aoi_link_bytes_total",
)
N = PARAMS.capacity
SEAM_X = 801.0  # a crowd on the seam between the first two strips


def halo_trace():
    """A 30-entity crowd on a seam past halo_cap 24 (halo_overflow), then
    dispersed (a teleport tick), then steady again."""
    rng, pos, active, space, radius = make_world(260, seed=13)
    pos[:30, 0] = SEAM_X
    space[:30] = 0
    yield pos, active, space, radius
    pos = rng.uniform(0, WORLD_X, (N, 2)).astype(np.float32)
    pos[:, 1] %= WORLD_Z
    for _ in range(2):
        yield pos, active, space, radius
        pos = drift(rng, pos, 3)


def hot_trace():
    """Every entity in one column: no strip holds them (strip_overflow)."""
    rng = np.random.default_rng(9)
    pos = np.zeros((N, 2), np.float32)
    pos[:, 0] = 850.0
    pos[:, 1] = rng.uniform(0, WORLD_Z, N).astype(np.float32)
    active = np.ones(N, bool)
    space = np.zeros(N, np.int32)
    radius = np.full(N, 100.0, np.float32)
    for _ in range(2):
        yield pos, active, space, radius
        pos = pos.copy()
        pos[:, 1] = (pos[:, 1] + rng.normal(0, 10, N)) % WORLD_Z


def skew_trace():
    """352 entities, half of them in the left quarter of the torus,
    re-planned every 2 dispatches: an equal-population split is
    adopted."""
    rng = np.random.default_rng(21)
    n_active = 352
    pos = rng.uniform(0, WORLD_X, (N, 2)).astype(np.float32)
    pos[:n_active // 2, 0] = rng.uniform(0, WORLD_X / 4, n_active // 2)
    pos[:, 1] %= WORLD_Z
    active = np.arange(N) < n_active
    space = np.zeros(N, np.int32)
    radius = np.full(N, 100.0, np.float32)
    for _ in range(4):
        yield pos, active, space, radius
        pos = drift(rng, pos, 8)


CASES = {name: (trace, params, kw)
         for name, (trace, params, kw, _) in TRACES.items()}
CASES.update({
    "halo_overflow": (halo_trace, PARAMS, dict(halo_cap=24)),
    "strip_overflow": (hot_trace, PARAMS, {}),
    "replan": (skew_trace, PARAMS, dict(replan_interval=2)),
})
PAIRS = {"reference": "jnp", "kernel": "pallas_interpret"}


def reading(tel) -> dict:
    """Each strip family's (kind, help, labels, {label values: value}); of
    aoi_link_bytes_total only the halo children."""
    out = {}
    for name in FAMILIES:
        fam = tel.family(name)
        assert fam is not None, name
        values = {key: child.value for key, child in fam.children()
                  if name != "aoi_link_bytes_total" or key[0] == "halo"}
        out[name] = (fam.kind, fam.help, fam.labelnames, values)
    return out


def grown(before: dict, after: dict) -> dict:
    """``after`` with each counter's growth since ``before`` in place of
    its value (children that did not grow left out)."""
    out = {}
    for name, (kind, help_, labels, values) in after.items():
        if kind == "counter":
            old = before[name][3]
            values = {k: v - old.get(k, 0.0) for k, v in values.items()
                      if v != old.get(k, 0.0)}
        out[name] = (kind, help_, labels, values)
    return out


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("backend", list(PAIRS))
def test_strip_families_match_jax(case, backend):
    trace, params, kw = CASES[case]
    tp = tn.params_from_reference(dataclasses.asdict(params))
    ref = js.SpatialShardedNeighborEngine(
        params, jax_make_mesh(8), backend=PAIRS[backend],
        strip_cols=STRIP_COLS, prewarm_fallback=False, inkernel_drain=False,
        **kw)
    port = ts.SpatialShardedNeighborEngine(
        tp, make_mesh(8, "cpu"), backend=backend, strip_cols=STRIP_COLS,
        **kw)
    ref.reset()
    port.reset()
    base = (reading(telemetry), reading(jax_telemetry))
    modes, strip_ticks = [], 0
    for tick, world in enumerate(trace()):
        want = ref.step(*world)
        got = port.step(*world)
        assert [len(x) for x in got[:2]] == [len(x) for x in want[:2]]
        assert port.last_mode == ref.last_mode, tick
        modes.append(port.last_mode)
        strip_ticks += port.last_mode == "spatial"
        ours = grown(base[0], reading(telemetry))
        theirs = grown(base[1], reading(jax_telemetry))
        assert ours == theirs, tick

    values = {name: v[3] for name, v in ours.items()}
    n_dev = port.n_devices

    def total(name):
        return sum(values[name].values())

    # The counters equal the port engine's plain attributes.
    assert total("aoi_spatial_fast_ticks_total") == port.total_fast_ticks
    assert total("aoi_shard_migrations_total") == port.total_migrations
    assert total("aoi_shard_fallback_total") == port.total_fallbacks
    assert total("aoi_shard_replans_total") == port.total_replans
    assert total("aoi_halo_bytes_total") == (
        strip_ticks * port.halo_bytes_per_tick)
    assert total("aoi_allgather_bytes_total") == (
        port.total_fallbacks * port.allgather_bytes_per_tick)
    assert values["aoi_shard_count"] == {(): n_dev}
    assert values["aoi_halo_bytes_per_tick"] == {
        (): port.halo_bytes_per_tick}
    assert values["aoi_allgather_equiv_bytes_per_tick"] == {
        (): port.allgather_bytes_per_tick}
    assert values["aoi_shard_entities"] == {
        (str(d),): port.shard_population[d] for d in range(n_dev)}
    # No torch.device has coords, as no CPU device of the JAX mesh has.
    assert values["aoi_strip_ring_distance"] == {}
    if strip_ticks:
        links = values["aoi_link_bytes_total"]
        assert links and all(v % ts.HALO_ROW_BYTES == 0
                             for v in links.values())
    # Each case reaches what it is there for.
    reasons = values["aoi_shard_fallback_total"]
    if case in ("teleport", "halo_overflow", "strip_overflow"):
        reason = "teleport" if case == "teleport" else case
        assert reasons.get((reason,), 0) >= 1, reasons
    if case == "halo_overflow":
        assert modes[-1] == "spatial"
    if case == "churn":
        assert port.total_migrations > 0
    if case == "replan":
        assert port.total_replans >= 1
    if case == "fast":
        assert port.total_fast_ticks == len(modes)


def test_halo_span_on_traced_ticks():
    """A traced dispatch leaves a ``tick.halo`` span with the migration
    count and mode (the JAX package's ``tests/test_spatial.py`` test of the
    same name); an untraced one adds none."""
    tp = tn.params_from_reference(dataclasses.asdict(PARAMS))
    eng = ts.SpatialShardedNeighborEngine(
        tp, make_mesh(8, "cpu"), backend="reference")
    eng.reset()
    _, pos, active, space, radius = make_world(300, seed=23)

    def halo_spans():
        return [sp for sp in tracing.snapshot() if sp["name"] == "tick.halo"]

    eng.step(pos, active, space, radius)  # untraced
    base = len(halo_spans())
    saved = tracing.sample_rate()
    tracing.configure(sample_rate=1)
    try:
        scope = tracing.root_scope("test.tick")
        assert scope is not None
        with scope:
            eng.step(pos, active, space, radius)
    finally:
        tracing.configure(sample_rate=saved)
    spans = halo_spans()
    assert len(spans) == base + 1
    assert spans[-1]["args"] == {"migrations": 0, "mode": "spatial"}
    assert spans[-1]["parent"] == scope.ctx.span_id
