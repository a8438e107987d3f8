"""The control of the correctness check: the plain reference put in the
program's place and computed one precision lower than the configuration
states (bfloat16 for its float32 distance test), on the cell's own world
and ticks. The comparison has to find it wrong.

    python3 -m gwbench.control --workload aoi_100k.walk --seeds 1 2 3 --ticks 40

For each seed it makes the cell's world as a run does (every process's
rows from the seed and the process's rank), the storm and ``--ticks``
steady ticks, checks the storm, the ticks the run's check would sample and
the last, and prints the compared numbers as one JSON line. The benchmark's
runs do not run it; it needs no card (``--device cpu``), and takes one where
given (``--device cuda``).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from gwbench import manifest
from gwbench.drivers.single import check_rng
from gwbench.reference import check

CONTROL_DTYPE = torch.bfloat16


def world_ticks(cell: dict, seed: int, ticks: int) -> list[dict]:
    """The checked ticks of the cell's world over ``ticks`` steady ticks,
    with no program: each process's part is its row range alone."""
    cfg = cell["config"]
    gen = manifest.load_module(cell["generator"], "traffic")
    nprocs = int(cfg.get("processes", 1))
    rows = int(cfg["engine"]["capacity"]) // nprocs
    streams = [gen.Traffic(cell["traffic"], cfg, rows, seed, stream=r)
               for r in range(nprocs)]
    parts = [(r * rows, (r + 1) * rows, None, None, None)
             for r in range(nprocs)]

    def world(prev_active):
        return {
            "prev": np.concatenate([t.prev for t in streams]),
            "pos": np.concatenate([t.pos for t in streams]),
            "prev_active": (np.zeros(rows * nprocs, bool) if prev_active
                            is None else prev_active),
            "active": np.concatenate([t.active for t in streams]),
            "space": np.concatenate([t.space for t in streams]),
            "radius": np.concatenate([t.radius for t in streams]),
            "parts": parts,
        }

    out = [dict(world(np.zeros(rows * nprocs, bool)), tick="storm")]
    out[0]["prev"] = np.zeros_like(out[0]["pos"])
    for _ in range(int(cfg["warm_ticks"])):
        for t in streams:
            t.advance()
    rng = check_rng(seed)
    active = out[0]["active"]
    for i in range(ticks):
        for t in streams:
            t.advance()
        if rng.random() < float(cfg["check_share"]) or i == ticks - 1:
            out.append(dict(world(active), tick=i))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--ticks", type=int, default=40)
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args(argv)
    root = manifest.ROOT
    cell = manifest.resolve(manifest.load(root), args.workload, root)
    dev = torch.device(args.device)
    for seed in args.seeds:
        ticks = world_ticks(cell, seed, args.ticks)
        numbers = check.compare(ticks, cell["config"], dev,
                                program_dtype=CONTROL_DTYPE)
        correct, shown = check.verdict(numbers)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": str(CONTROL_DTYPE), "correct": correct,
                          **numbers}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
