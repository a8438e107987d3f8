"""Where a steady AOI tick of goworld_tpu_torch spends its time on one card.

    python3 tools/profile_torch_tick.py

Runs the headline configuration of chip_smoke.py (102,400 entities, 44x44
cells of 300) through the CUDA kernel path: the enter storm, a warm-up, then
``TICKS`` pipelined steady ticks (dispatch t+1, then collect t) through
tools/torch_profile.py's ``profile_loop``: the device span of single
synchronous ticks by CUDA events, the host clock's ``step_async`` (the
dispatch), ``collect`` and whole tick over three untraced loops, and one
loop under ``torch.profiler`` for the top operations, the kernel time per
tick and the device busy share (that kernel time over the untraced tick's
wall time).

Prints one JSON line last; the trace goes to profile_out/tick_trace.json.
Needs a CUDA device.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
TICKS = 20


def run_ticks(eng, pos, vel, world, args, ticks):
    """Pipelined steady ticks, moving ``pos`` in place; returns per-tick
    host seconds of the dispatch and the collect."""
    active, space, radius = args
    dispatch, collect = [], []
    pending = None
    for _ in range(ticks):
        pos += vel
        np.clip(pos, 0.0, world, out=pos)
        t0 = time.perf_counter()
        nxt = eng.step_async(pos, active, space, radius, meta_dirty=False)
        dispatch.append(time.perf_counter() - t0)
        if pending is not None:
            t0 = time.perf_counter()
            pending.collect()
            collect.append(time.perf_counter() - t0)
        pending = nxt
    pending.collect()
    return {"dispatch": dispatch, "collect": collect}


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_tick: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from chip_smoke import HEADLINE, card_line
    from goworld_tpu_torch.ops import neighbor as tn
    from torch_profile import profile_loop  # beside this script

    print(f"card: {card_line()}", flush=True)
    p = tn.NeighborParams(**HEADLINE)
    n = p.capacity
    world = p.grid_x * p.cell_size
    rng = np.random.default_rng(0)
    pos = rng.uniform(0, world, (n, 2)).astype(np.float32)
    args = (np.ones(n, bool), np.zeros(n, np.int32),
            np.full(n, 100.0, np.float32))
    vel = rng.normal(0, 3.0, (n, 2)).astype(np.float32)
    eng = tn.NeighborEngine(p)
    eng.reset()
    eng.step(pos, *args)  # storm + build
    run_ticks(eng, pos, vel, world, args, 5)  # warm-up
    torch.cuda.synchronize()
    print(json.dumps(profile_loop(
        lambda k: run_ticks(eng, pos, vel, world, args, k), TICKS,
        "tick_trace")))
    return 0


if __name__ == "__main__":
    sys.exit(main())
