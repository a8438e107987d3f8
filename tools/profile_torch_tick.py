"""Where a steady AOI tick of goworld_tpu_torch spends its time on one card.

    python3 tools/profile_torch_tick.py

Runs the headline configuration of chip_smoke.py (102,400 entities, 44x44
cells of 300) through the CUDA kernel path: the enter storm, a warm-up, then
``TICKS`` pipelined steady ticks (dispatch t+1, then collect t), twice:

1. untraced, timing each phase on the host clock: ``step_async`` (the
   dispatch), ``collect``, and the whole tick; the device time of each tick
   comes from CUDA events around it;
2. under ``torch.profiler``, printing the top operations by device time and
   by host time, the kernel time per tick, and the device busy share: that
   kernel time over the untraced tick's wall time.

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
    """Pipelined steady ticks; returns per-tick host seconds of the
    dispatch and the collect, and the loop's wall seconds."""
    active, space, radius = args
    dispatch, collect = [], []
    pending = None
    t_all = time.perf_counter()
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
    torch.cuda.synchronize()
    return dispatch, collect, time.perf_counter() - t_all


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_tick: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from chip_smoke import HEADLINE, card_line
    from goworld_tpu_torch.ops import neighbor as tn

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

    # Device time per tick, by events around each synchronous tick.
    device_ms = []
    for _ in range(TICKS):
        pos += vel
        np.clip(pos, 0.0, world, out=pos)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        pend = eng.step_async(pos, *args, meta_dirty=False)
        end.record()
        pend.collect()
        device_ms.append(start.elapsed_time(end))

    dispatch, collect, wall = run_ticks(eng, pos, vel, world, args,
                                        TICKS)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, _, traced_wall = run_ticks(eng, pos, vel, world, args,
                                      TICKS)
    from torch.autograd import DeviceType

    avg = prof.key_averages()
    device_us = sum(e.self_device_time_total for e in avg
                    if e.device_type == DeviceType.CUDA)
    print(avg.table(sort_by="self_device_time_total", row_limit=15))
    print(avg.table(sort_by="self_cpu_time_total", row_limit=15))
    out = ROOT / "profile_out"
    out.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(out / "tick_trace.json"))
    ms = lambda xs: float(np.median(xs) * 1e3)  # noqa: E731
    print(json.dumps({
        "ticks": TICKS,
        "tick_ms": wall / TICKS * 1e3,
        "dispatch_p50_ms": ms(dispatch),
        "collect_p50_ms": ms(collect),
        "device_span_p50_ms": float(np.median(device_ms)),
        "traced_tick_ms": traced_wall / TICKS * 1e3,
        "device_ms_per_tick": device_us / 1e3 / TICKS,
        # Kernel time per tick (traced) over the untraced tick's wall time.
        "device_busy_share": device_us / 1e3 / TICKS
        / (wall / TICKS * 1e3),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
