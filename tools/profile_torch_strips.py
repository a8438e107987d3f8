"""Where a steady strip-tier tick of goworld_tpu_torch spends its time on one
card.

    python3 tools/profile_torch_strips.py

Runs chip_smoke.py's ``strips_1m`` configuration (BASELINE.json's config 5:
1,048,576 entity slots, 917,504 active, 8 grid-column strips on the one
card, 128x128 cells of 300, radius 100, the in-kernel drain on) through the
strip engine: the enter storm, a warm-up, then ``TICKS`` pipelined steady
ticks (dispatch t+1, then collect t) through tools/torch_profile.py's
``profile_loop``: the device span of single synchronous ticks by CUDA
events, the host clock's ``step_async`` (the dispatch), ``collect`` and
whole tick over three untraced loops, and one loop under
``torch.profiler`` for the top operations, the drain form's time per tick
(its three passes) and the device busy share. Last, ``HOST_TICKS`` more
ticks under ``cProfile``: where the host's dispatch goes, by Python
function (``host_top``: the functions with the most own time, ms a tick).

Prints one JSON line last; the trace goes to profile_out/strips_trace.json.
Needs a CUDA device.
"""

from __future__ import annotations

import cProfile
import json
import pstats
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
TICKS = 10
HOST_TICKS = 5
# The drain form's three passes (csrc/event_kernel.cu).
DRAIN_KERNELS = ("event_mask_kernel", "drain_scan_kernel",
                 "drain_write_kernel")


def run_ticks(eng, pos, vel, world, args, ticks, walk):
    """Pipelined steady ticks, moving ``pos`` in place; returns per-tick
    host seconds of the dispatch and the collect."""
    dispatch, collect = [], []
    pending = None
    for _ in range(ticks):
        walk(pos, vel, world)
        t0 = time.perf_counter()
        nxt = eng.step_async(pos, *args, meta_dirty=False)
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
        print("profile_torch_strips: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from chip_smoke import (STRIPS, STRIPS_ACTIVE, STRIPS_N, card_line,
                            walk)
    from goworld_tpu_torch.ops import neighbor as tn
    from goworld_tpu_torch.parallel import SpatialShardedNeighborEngine
    from goworld_tpu_torch.parallel import make_mesh
    from torch_profile import profile_loop  # beside this script

    print(f"card: {card_line()}", flush=True)
    p = tn.NeighborParams(**STRIPS)
    n = p.capacity
    world = p.grid_x * p.cell_size
    rng = np.random.default_rng(0)
    pos = rng.uniform(0, world, (n, 2)).astype(np.float32)
    args = (np.arange(n) < STRIPS_ACTIVE, np.zeros(n, np.int32),
            np.full(n, 100.0, np.float32))
    vel = rng.normal(0, 3.0, (n, 2)).astype(np.float32)
    eng = SpatialShardedNeighborEngine(p, make_mesh(STRIPS_N))
    eng.reset()
    eng.step(pos, *args)  # storm
    run_ticks(eng, pos, vel, world, args, 3, walk)  # warm-up
    torch.cuda.synchronize()
    result = profile_loop(
        lambda k: run_ticks(eng, pos, vel, world, args, k, walk), TICKS,
        "strips_trace", kernel=DRAIN_KERNELS)
    result["last_mode"] = eng.last_mode
    result["fast_ticks"] = eng.total_fast_ticks
    prof = cProfile.Profile()
    prof.runcall(run_ticks, eng, pos, vel, world, args, HOST_TICKS, walk)
    stats = pstats.Stats(prof).stats
    top = sorted(stats.items(), key=lambda kv: -kv[1][2])[:12]
    result["host_top"] = {
        f"{Path(f).name}:{line}({name})": tt / HOST_TICKS * 1e3
        for (f, line, name), (_, _, tt, _, _) in top
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
