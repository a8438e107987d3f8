"""Layer: the event kernel (``ops.event_kernel``, ``gw_event_mask``, both
forms). Its least time over the profiler's time of its launches, in %.

The least time counts what the traced ticks need of the kernel: the dual
form once a tick. The cell's mixes move positions alone, within the
engine's fast guard, so the single form returns at once on every tick: its
launches count in the time and nothing in the bound. Each dual launch's
bound is the larger of its bytes (the cell layout read once, the masks
written once: a function of the grid's shape) over the HBM rate and its
FP32 operations (from the occupancy of the cells at the stretch's first
tick, from the benchmark's own positions) over the FP32 rate
(``gwbench/roofline.py``, H100 SXM peaks at 700 W). The time is every
launch of the kernels named below that starts in the stretch. Moves
``event_latency_p99_ms``."""

import torch

from gwbench import roofline
from gwbench.reference import interest

KERNELS = ("event_mask_kernel<true", "event_mask_kernel<false")
DUAL = KERNELS[0]


def _occupancy(first, cfg):
    e = cfg["engine"]
    g = dict(cell_size=float(e["cell_size"]), grid_x=int(e["grid_x"]),
             grid_z=int(e["grid_z"]))
    space = torch.as_tensor(first["space"]).to(torch.int64)
    pos = torch.as_tensor(first["pos"])
    prev = torch.as_tensor(first["prev"])
    vis, _, _ = interest.visibility(
        pos, torch.as_tensor(first["active"]), space,
        cell_capacity=int(e["cell_capacity"]), **g)
    vis_p, _, _ = interest.visibility(
        prev, torch.as_tensor(first["prev_active"]), space,
        cell_capacity=int(e["cell_capacity"]), **g)
    # The dual form bins by the current grid: epoch A's lanes are the
    # entities visible now, epoch B's those of them visible before.
    occ_a = interest.cell_occupancy(pos, vis, space, **g)
    occ_b = interest.cell_occupancy(pos, vis & vis_p, space, **g)
    return occ_a, occ_b


def read(run):
    cfg = run.config
    e = cfg["engine"]
    total = 0.0
    for p in run.profiles():
        dual_n = 0
        time_s = 0.0
        for name, (count, t) in p["launches"].items():
            if any(k in name for k in KERNELS):
                time_s += t
                if DUAL in name:
                    dual_n += count
        if time_s == 0.0 or p.get("first") is None:
            continue
        occ_a, occ_b = _occupancy(p["first"], cfg)
        ops = roofline.event_ops(occ_a, occ_b)
        spaces = int(e["space_slots"])
        gz, gx = int(e["grid_z"]), int(e["grid_x"])
        dual = roofline.bound_s(roofline.event_bytes(spaces, gz, gx, True), ops)
        total += 100.0 * dual_n * dual / time_s
    n = len(run.profiles())
    return total / n if total else None
