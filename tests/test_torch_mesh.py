"""The port's entity-sharded tier and the strip tier's reference backend
against the JAX package, on the CPU.

``goworld_tpu_torch.parallel.mesh.ShardedNeighborEngine`` on 8 CPU shards
is held against the JAX ``ShardedNeighborEngine`` on its 8-device CPU mesh
(``tests/conftest.py``), backend by backend: the port's ``"reference"``
(the all-gather program) against JAX's ``"jnp"``, the port's ``"kernel"``
(the slab program, the event kernel's plain version on the CPU) against
JAX's ``"pallas_interpret"``. Each pair must give identical enter and leave
arrays in identical order and the same ``dropped``, through the traces of
``tests/test_parallel.py``. The port's
``SpatialShardedNeighborEngine(backend="reference")`` is held the same way
against the JAX strip engine's ``"jnp"`` backend on the traces of
``tests/test_torch_spatial.py``, with and without fused entity logic.
"""

import dataclasses

import numpy as np
import pytest
import torch

from goworld_tpu.ops import neighbor as jn
from goworld_tpu.parallel import make_mesh as jax_make_mesh
from goworld_tpu.parallel import mesh as jm
from goworld_tpu.parallel import spatial as js
from goworld_tpu_torch import graft_entry
from goworld_tpu_torch.ops import neighbor as tn
from goworld_tpu_torch.parallel import make_mesh
from goworld_tpu_torch.parallel import mesh as tm
from goworld_tpu_torch.parallel import spatial as ts
from goworld_tpu_torch.telemetry import sentinel
from test_parallel import PARAMS, make_world
from test_torch_passes import FUSED_RTOL, JAX_PROGRAMS, PROGRAMS
from test_torch_spatial import TRACES

# (port backend, JAX backend) pairs that run the same algorithm, so the
# same pair order.
PAIRS = [("reference", "jnp"), ("kernel", "pallas_interpret")]

# Torch threads of this file's process: the suite runs files in parallel
# worker processes, and torch's default of one thread a core in each of
# them oversubscribes the host (tests/test_torch_scenarios.py).
THREADS = 2


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(threads)


def port_params(p):
    return tn.params_from_reference(dataclasses.asdict(p))


def engines(params, backend, jax_backend):
    port = tm.ShardedNeighborEngine(port_params(params), make_mesh(8, "cpu"),
                                    backend=backend)
    ref = jm.ShardedNeighborEngine(params, jax_make_mesh(8),
                                   backend=jax_backend)
    port.reset()
    ref.reset()
    return port, ref


def same_stream(got, want):
    for k in (0, 1):
        assert np.array_equal(np.asarray(got[k]), np.asarray(want[k])), k
    assert got[2] == want[2]


@pytest.mark.parametrize("backend,jax_backend", PAIRS)
def test_sharded_matches_jax(backend, jax_backend):
    """test_parallel.py's five drifting ticks: identical arrays in order."""
    port, ref = engines(PARAMS, backend, jax_backend)
    rng = np.random.default_rng(7)
    pos, active, space, radius = make_world(512, 400, seed=7)
    for _ in range(5):
        pos = np.clip(pos + rng.normal(0, 20, pos.shape), 0,
                      1500).astype(np.float32)
        same_stream(port.step(pos, active, space, radius),
                    ref.step(pos, active, space, radius))


@pytest.mark.parametrize("backend,jax_backend", PAIRS)
def test_sharded_chunked_drain_small_buffer(backend, jax_backend):
    """max_events 128: every shard pages its storm (test_parallel.py:100)."""
    small = dataclasses.replace(PARAMS, max_events=128)
    port, ref = engines(small, backend, jax_backend)
    world = make_world(512, 400, seed=11)
    got = port.step(*world)
    same_stream(got, ref.step(*world))
    assert len(got[0]) > small.max_events


@pytest.mark.parametrize("backend,jax_backend", PAIRS)
def test_sharded_fast_path_parity(backend, jax_backend):
    """Radius 40 with ~3-unit drift keeps the guard true while churn makes
    enters and leaves every tick (test_parallel.py:126)."""
    port, ref = engines(PARAMS, backend, jax_backend)
    rng = np.random.default_rng(11)
    pos, active, space, radius = make_world(512, 400, seed=11, world=600.0)
    radius = np.full(512, 40.0, np.float32)
    leaves = 0
    for _ in range(5):
        pos = np.clip(pos + rng.normal(0, 3, pos.shape), 0,
                      600).astype(np.float32)
        got = port.step(pos, active, space, radius)
        same_stream(got, ref.step(pos, active, space, radius))
        leaves += len(got[1])
    assert leaves > 0


@pytest.mark.parametrize("backend", ["reference", "kernel"])
def test_sharded_pipeline_matches_sync(backend):
    """Depth-2 dispatch/collect gives the synchronous stream
    (test_parallel.py:70); one step program a dispatch."""
    p = port_params(PARAMS)
    sync = tm.ShardedNeighborEngine(p, make_mesh(8, "cpu"), backend=backend)
    pipe = tm.ShardedNeighborEngine(p, make_mesh(8, "cpu"), backend=backend)
    sync.reset()
    pipe.reset()
    rng = np.random.default_rng(13)
    pos, active, space, radius = make_world(512, 450, seed=13)
    vel = rng.normal(0, 25.0, pos.shape).astype(np.float32)
    label = "sharded_step_kernel" if backend == "kernel" else "sharded_step"
    want, got = [], []
    pending = None
    for _ in range(6):
        want.append(sync.step(pos, active, space, radius))
        before = sentinel.launches_total(label)
        nxt = pipe.step_async(pos, active, space, radius)
        assert sentinel.launches_total(label) == before + 1
        if pending is not None:
            got.append(pending.collect())
        pending = nxt
        pos = np.clip(pos + vel, 0, 1500).astype(np.float32)
    got.append(pending.collect())
    for g, w in zip(got, want):
        same_stream(g, w)


def test_constructor_checks():
    """test_parallel.py:117, and the port's other checks."""
    mesh = make_mesh(8, "cpu")
    with pytest.raises(ValueError, match="multiple of 8"):
        tm.ShardedNeighborEngine(
            tn.NeighborParams(capacity=520, grid_x=8, grid_z=8), mesh)
    p = port_params(PARAMS)
    with pytest.raises(ValueError, match="divisible"):
        tm.ShardedNeighborEngine(dataclasses.replace(p, max_events=8190),
                                 mesh)
    with pytest.raises(ValueError, match="grid_z"):
        tm.ShardedNeighborEngine(dataclasses.replace(p, grid_z=12), mesh)
    # The all-gather program has no slab, so no grid_z condition.
    tm.ShardedNeighborEngine(dataclasses.replace(p, grid_z=12), mesh,
                             backend="reference")
    with pytest.raises(ValueError, match="cell_capacity"):
        tm.ShardedNeighborEngine(
            dataclasses.replace(p, cell_capacity=129), mesh)
    with pytest.raises(ValueError, match="backend"):
        tm.ShardedNeighborEngine(p, mesh, backend="jnp")
    with pytest.raises(RuntimeError, match="reset"):
        tm.ShardedNeighborEngine(p, mesh).step_async(
            *make_world(512, 400, seed=1))
    assert tm.ShardedNeighborEngine(p, mesh).backend == "kernel"


def test_dryrun_multichip_matches_jax():
    """``graft_entry.dryrun_multichip(8)``'s streams, backend by backend,
    against the JAX sharded engines on the same ticks."""
    streams = graft_entry.dryrun_multichip(8, device="cpu")
    params = graft_entry.dryrun_params(8)
    jp = jn.NeighborParams(**dataclasses.asdict(params))
    refs = {b: jm.ShardedNeighborEngine(jp, jax_make_mesh(8), backend=jb)
            for b, jb in PAIRS}
    for eng in refs.values():
        eng.reset()
    for tick, (pos, active, space, radius, _) in enumerate(
            graft_entry.dryrun_ticks(params)):
        for backend, eng in refs.items():
            same_stream(streams[backend][tick],
                        eng.step(pos, active, space, radius))
    assert streams["kernel"][2][2] >= 8  # the engineered drop


# --- the strip tier's reference backend ----------------------------------------


@pytest.mark.parametrize("name", list(TRACES))
def test_strip_reference_backend_matches_jax_jnp(name):
    """Each tick: identical arrays in order, ``dropped``, mode and fast
    tick against the JAX strip engine's jnp backend; the same migration,
    fallback and fast-tick totals."""
    trace, params, kw, _ = TRACES[name]
    ref = js.SpatialShardedNeighborEngine(
        params, jax_make_mesh(8), backend="jnp", prewarm_fallback=False,
        **kw)
    port = ts.SpatialShardedNeighborEngine(
        port_params(params), make_mesh(8, "cpu"), backend="reference", **kw)
    assert port.drain_inline == 0 and port.strip_cols is None
    ref.reset()
    port.reset()
    for world in trace():
        before = sentinel.launches_total("spatial_step_reference")
        pend = port.step_async(*world)
        if port.last_mode == "spatial":
            assert (sentinel.launches_total("spatial_step_reference")
                    == before + 1)
        same_stream(pend.collect(), ref.step(*world))
        assert port.last_mode == ref.last_mode
        assert port.last_fast_tick == ref.last_fast_tick
    assert port.total_migrations == ref.total_migrations
    assert port.total_fallbacks == ref.total_fallbacks
    assert port.total_fast_ticks == ref.total_fast_ticks
    assert np.array_equal(port.boundaries, ref.boundaries)


def test_strip_reference_backend_fused_logic_matches_jax_jnp():
    """The fused variant: the programs' outputs within FUSED_RTOL of JAX's
    (ROADMAP queue 3 item 5), the events identical, across a teleport's
    fallback tick; then the fused warmup."""
    from test_torch_passes import STRIPS, world

    p = STRIPS
    n = p.capacity
    port = ts.SpatialShardedNeighborEngine(p, make_mesh(2, "cpu"),
                                           backend="reference")
    ref = js.SpatialShardedNeighborEngine(
        jn.NeighborParams(**dataclasses.asdict(p)), jax_make_mesh(2),
        backend="jnp", prewarm_fallback=False)
    port.reset()
    ref.reset()
    rng, s = world(21, n)
    s["pos"] = rng.uniform(0, 1600, (n, 2)).astype(np.float32)
    modes = []
    for t in range(4):
        if t == 2:
            s["pos"][:8] = rng.uniform(0, 1600, (8, 2)).astype(np.float32)
        logic = (PROGRAMS, s["sel"], s["y"], s["yaw"], 0.1,
                 (s["vx"], s["hp"], s["cool"]))
        a = port.step_async(s["pos"], s["act"], s["spc"], s["rad"],
                            logic=logic)
        c = ref.step_async(s["pos"], s["act"], s["spc"], s["rad"],
                           logic=(JAX_PROGRAMS,) + logic[1:])
        _, _, perm, outs = a.fused
        slots = []
        for o in outs:
            r = np.asarray(o)
            sl = np.empty_like(r)
            sl[perm] = r
            slots.append(sl)
        for got, o in zip(slots, c.fused[3]):
            want = np.empty_like(got)
            want[c.fused[2]] = np.asarray(o)
            np.testing.assert_allclose(got, want, rtol=FUSED_RTOL, atol=0)
        same_stream(a.collect(), c.collect())
        assert port.last_mode == ref.last_mode
        modes.append(port.last_mode)
        s["pos"] = slots[0]
        s["y"], s["yaw"], s["vx"], s["hp"], s["cool"] = slots[1:]
    assert "spatial" in modes and any(m.startswith("fallback") for m in modes)
    assert port.fused_trace_count(PROGRAMS) == 1
    port.warmup_fused(PROGRAMS, ("float32",) * 3)
