"""The port's counterpart of the repo's ``__graft_entry__.entry()``.

``entry()`` returns one forward step of the flagship compute program, the
event-native batched AOI step at the headline scale (102,400 entity slots,
44x44 cells of 300, BASELINE.json), as a callable and its input tensors:
the kernel backend (``ops.neighbor._step_pallas``, the hand-written CUDA
event kernel) on a previous epoch of an all-inactive tick, the current
epoch drawn from seed 0 as the JAX entry draws it. The inputs live on the
CUDA card unless the caller passes ``device="cpu"``, where the wrappers run
the kernels' plain versions. ``reference()`` gives the reference backend's
step (``_step_packed_jnp``) over the same previous and current epochs.

``dryrun_multichip(n)`` is the JAX entry's multi-device dry run: three ticks
of a tiny world on ``n`` shards of one device through the entity-sharded
engine on both backends (the slab kernel and the all-gather program), held
against the single-device engine, with an engineered cell overflow on the
last tick.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from goworld_tpu_torch.ops.neighbor import (
    LANES,
    NeighborEngine,
    NeighborParams,
    _step_packed_jnp,
    _step_pallas,
    bins_reference,
)

PARAMS = NeighborParams(
    capacity=102400,
    cell_size=300.0,
    grid_x=44,
    grid_z=44,
    space_slots=4,
    cell_capacity=128,
    max_events=262144,
)


def _device(device) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "entry() runs on CUDA unless told otherwise, and no CUDA "
                "device is available; pass device='cpu'")
        return torch.device("cuda")
    return torch.device(device)


def _epochs(params: NeighborParams, dev: torch.device):
    """(previous epoch, current epoch): an all-inactive tick, then seed 0's
    uniform positions over the world, every slot active, radius 100."""
    n = params.capacity
    rng = np.random.default_rng(0)
    world = params.grid_x * params.cell_size
    prev = (
        torch.zeros((n, 2), dtype=torch.float32, device=dev),
        torch.zeros(n, dtype=torch.bool, device=dev),
        torch.zeros(n, dtype=torch.int32, device=dev),
        torch.zeros(n, dtype=torch.float32, device=dev),
    )
    cur = (
        torch.as_tensor(rng.uniform(0, world, (n, 2)).astype(np.float32),
                        device=dev),
        torch.ones(n, dtype=torch.bool, device=dev),
        torch.zeros(n, dtype=torch.int32, device=dev),
        torch.full((n,), 100.0, dtype=torch.float32, device=dev),
    )
    return prev, cur


def entry(device=None):
    """``(fn, args)``: ``fn(*args)`` runs one headline step through the
    event kernel and returns ``(enter_ctx, leave_ctx, out, next_grid,
    fast)``; ``out`` is the packed readback (header rows, then the enter
    and leave pairs)."""
    params = PARAMS
    dev = _device(device)
    n = params.capacity
    prev, cur = _epochs(params, dev)
    # Carried previous-grid artifacts of an all-inactive tick
    # (NeighborEngine.reset's kernel state).
    table_size = params.num_buckets * LANES
    i32 = dict(dtype=torch.int32, device=dev)
    carried = (
        torch.zeros(n, **i32),
        torch.zeros(n, **i32),
        torch.zeros(n, **i32),
        torch.full((table_size,), n, **i32),
        torch.full((n,), -1, **i32),
        torch.arange(n, **i32),
        torch.full((n,), table_size, **i32),
    )
    return functools.partial(_step_pallas, params), prev + carried + cur


def reference(device=None):
    """``(fn, args)`` of the reference backend's step over the same epochs:
    ``fn(*args)`` returns ``(enter_ids, leave_ids, out, fast)``, where
    ``enter_ids`` holds every enter event (row = entity, sentinel n)."""
    params = PARAMS
    prev, cur = _epochs(params, _device(device))
    return functools.partial(_step_packed_jnp, params), prev + cur


def dryrun_params(n_devices: int) -> NeighborParams:
    """The dry run's world: 64 slots a shard, 8 columns, ``grid_z`` a
    multiple of the shard count (one slab of rows a shard), 2 space slots,
    cell capacity 32."""
    gz = 8 if 8 % n_devices == 0 else max(8, n_devices)
    return NeighborParams(
        capacity=8 * n_devices * 8,
        cell_size=100.0,
        grid_x=8,
        grid_z=gz,
        space_slots=2,
        cell_capacity=32,
        max_events=1024 * n_devices,
    )


def dryrun_ticks(params: NeighborParams):
    """The dry run's three ticks, drawn from seed 1 in the JAX entry's
    order: yields (pos, active, space, radius, expected_dropped), where
    ``expected_dropped`` is None but on the last tick, which crams 40
    same-space entities into one cell of capacity 32."""
    n = params.capacity
    gz = params.grid_z
    rng = np.random.default_rng(1)
    pos = rng.uniform(0, 700, (n, 2)).astype(np.float32)
    active = np.ones((n,), bool)
    space = (np.arange(n) % 2).astype(np.int32)
    radius = np.full((n,), 100.0, np.float32)
    for tick in range(3):
        expected = None
        if tick == 2:
            pos[:40] = rng.uniform(10, 90, (40, 2)).astype(np.float32)
            space[:40] = 0
            cx, cz, sm = bins_reference(params, pos, space)
            bucket = (sm * gz + cz) * params.grid_x + cx
            counts = np.bincount(bucket[active],
                                 minlength=params.num_buckets)
            expected = int(np.maximum(counts - params.cell_capacity, 0).sum())
            assert expected >= 8
        yield pos, active, space, radius, expected
        pos = np.clip(
            pos + rng.normal(0, 10, pos.shape).astype(np.float32), 0, 700
        ).astype(np.float32)


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """Three ticks of :func:`dryrun_ticks` on ``n_devices`` shards of one
    device (the CUDA card unless ``device`` says otherwise), through
    ``ShardedNeighborEngine`` on both backends, each tick's events equal to
    the single-device engine's and the engineered drop counted. Returns
    each backend's stream, ``{backend: [(enters, leaves, dropped), ...]}``."""
    from goworld_tpu_torch.parallel.mesh import (
        ShardedNeighborEngine,
        make_mesh,
    )

    dev = _device(device)
    params = dryrun_params(n_devices)
    mesh = make_mesh(n_devices, dev)
    engines = {b: ShardedNeighborEngine(params, mesh, backend=b)
               for b in ("reference", "kernel")}
    single = NeighborEngine(params, backend="reference", device=dev)
    single.reset()
    for eng in engines.values():
        eng.reset()

    def canon(pairs):
        return sorted(map(tuple, np.asarray(pairs).tolist()))

    streams: dict = {b: [] for b in engines}
    total_enters = 0
    expected_dropped = None
    for tick, (pos, active, space, radius, expected) in enumerate(
            dryrun_ticks(params)):
        if expected is not None:
            expected_dropped = expected
        e_1, l_1, d_1 = single.step(pos, active, space, radius)
        for backend, eng in engines.items():
            e_s, l_s, d_s = eng.step(pos, active, space, radius)
            streams[backend].append((e_s, l_s, d_s))
            assert canon(e_s) == canon(e_1), (
                f"tick {tick}: {backend} sharded enters diverge")
            assert canon(l_s) == canon(l_1), (
                f"tick {tick}: {backend} sharded leaves diverge")
            assert d_s == d_1, f"tick {tick}: dropped {d_s} != {d_1}"
        if tick == 0:
            assert len(e_1) > 0, "dense world produced no enter events"
            assert len(l_1) == 0
        if expected is not None:
            assert d_1 == expected, f"expected {expected} dropped, got {d_1}"
        total_enters += len(e_1)
    print(
        f"dryrun_multichip ok: {n_devices} shards on {dev}, "
        f"{params.capacity} slots, 3 ticks, {total_enters} enters, "
        f"sharded==single event streams (reference AND slab kernel), "
        f"engineered dropped={expected_dropped} matched, "
        f"1 packed readback per tick"
    )
    return streams
