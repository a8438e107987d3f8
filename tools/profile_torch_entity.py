"""Where a steady tick of goworld_tpu_torch's entity-sharded tier spends its
time on one card.

    python3 tools/profile_torch_entity.py

Runs chip_smoke.py's ``entity_1m`` configuration (BASELINE.json's config 5:
1,048,576 entity slots, 917,504 active, 128x128 cells of 300, radius 100)
through ``ShardedNeighborEngine`` with 8 shards on the one card (the slab
kernel: each shard launches the event kernel's mask forms on its 16 grid
rows): the enter storm, a warm-up, then ``TICKS`` pipelined steady ticks
(dispatch t+1, then collect t) through tools/torch_profile.py's
``profile_loop``: the device span of single synchronous ticks by CUDA
events, the host clock's ``step_async`` (the dispatch), ``collect`` and
whole tick over three untraced loops, and one loop under
``torch.profiler`` for the top operations, the mask forms' time a tick and
the device busy share.

Prints one JSON line last; the trace goes to profile_out/entity_trace.json.
Needs a CUDA device.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
TICKS = 10


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_entity: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from chip_smoke import ENTITY_N, STRIPS, STRIPS_ACTIVE, card_line, walk
    from goworld_tpu_torch.ops import neighbor as tn
    from goworld_tpu_torch.parallel import ShardedNeighborEngine, make_mesh
    from profile_torch_strips import run_ticks  # beside this script
    from torch_profile import profile_loop

    print(f"card: {card_line()}", flush=True)
    p = tn.NeighborParams(**STRIPS)
    n = p.capacity
    world = p.grid_x * p.cell_size
    rng = np.random.default_rng(0)
    pos = rng.uniform(0, world, (n, 2)).astype(np.float32)
    args = (np.arange(n) < STRIPS_ACTIVE, np.zeros(n, np.int32),
            np.full(n, 100.0, np.float32))
    vel = rng.normal(0, 3.0, (n, 2)).astype(np.float32)
    eng = ShardedNeighborEngine(p, make_mesh(ENTITY_N))
    eng.reset()
    eng.step(pos, *args)  # storm
    run_ticks(eng, pos, vel, world, args, 3, walk)  # warm-up
    torch.cuda.synchronize()
    result = profile_loop(
        lambda k: run_ticks(eng, pos, vel, world, args, k, walk), TICKS,
        "entity_trace", kernel="event_mask_kernel")
    result["shards"] = ENTITY_N
    result["backend"] = eng.backend
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
