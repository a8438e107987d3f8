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

The JAX entry's ``dryrun_multichip`` waits for the entity-sharded tier
(ROADMAP queue 1 item 8).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from goworld_tpu_torch.ops.neighbor import (
    LANES,
    NeighborParams,
    _step_packed_jnp,
    _step_pallas,
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
