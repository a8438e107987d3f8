"""Where a boids step of goworld_tpu_torch spends its time on one card.

    python3 tools/profile_torch_boids.py [cell_size]

Runs chip_smoke.py's boids_50k configuration (51,200 agents, radius 100, a
6,400-wide world; cell 100 unless given) through the default engine, the
CUDA kernel path: a warm-up, then ``STEPS`` chained steps through
tools/torch_profile.py's ``profile_loop``: the device span of single steps
by CUDA events, the host clock's dispatch (``BoidsEngine.step`` returns
before the device is done) and whole step over three untraced loops, and one
loop under ``torch.profiler`` for the top operations, the device time per
step, the kernel's share of it and the device busy share (that device time
over the untraced step's wall time). It also prints what the kernel's time
follows, for the start cells and for the last profiled step's: the occupied
cells, their mean agents, the query warps holding an agent and the pairs of
an occupied query lane and an occupied candidate lane (the query itself
included) over each cell's 3x3 block.

Prints one JSON line last; the trace goes to profile_out/boids_trace.json.
Needs a CUDA device.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
STEPS = 20


def cell_stats(tb, p, pos, vel, active) -> dict:
    """The cells' occupancy that the boids kernel's time follows."""
    occ = tb._build_cells(p, pos, vel, active)[0][..., 4, :] > 0
    per_cell = occ.sum(-1)
    n = per_cell[1:-1, 1:-1]
    block = sum(per_cell[di:di + p.grid_z, dj:dj + p.grid_x]
                for di in range(3) for dj in range(3))
    warps = occ[1:-1, 1:-1].reshape(p.grid_z, p.grid_x, -1, 32).any(-1)
    return {
        "occupied_cells": int((n > 0).sum()),
        "agents_per_occupied_cell": float(n[n > 0].float().mean()),
        "query_warps": int(warps.sum()),
        "pairs": int((n * block).sum()),
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_boids: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from chip_smoke import boids_params, boids_world, card_line
    from goworld_tpu_torch.ops import boids as tb
    from torch_profile import profile_loop  # beside this script

    print(f"card: {card_line()}", flush=True)
    cell = float(sys.argv[1]) if len(sys.argv) > 1 else 100.0
    p = boids_params(tb, cell)
    eng = tb.BoidsEngine(p)
    pos, vel, active = boids_world(p)
    state = [torch.as_tensor(pos, device=eng.device),
             torch.as_tensor(vel, device=eng.device),
             torch.as_tensor(active, device=eng.device)]
    at_start = cell_stats(tb, p, *state)

    def run_steps(k):
        """k chained steps; the per-step host seconds of the dispatch."""
        dispatch = []
        for _ in range(k):
            t0 = time.perf_counter()
            state[0], state[1], _ = eng.step(*state)
            dispatch.append(time.perf_counter() - t0)
        return {"dispatch": dispatch}

    run_steps(5)  # warm-up
    torch.cuda.synchronize()
    result = profile_loop(run_steps, STEPS, "boids_trace",
                          kernel="boids_accel_kernel")
    print(json.dumps({"cell_size": cell, "grid": p.grid_x, **result,
                      "dropped_last_step": int(eng.last_dropped),
                      "cells_at_start": at_start,
                      "cells_at_end": cell_stats(tb, p, *state)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
