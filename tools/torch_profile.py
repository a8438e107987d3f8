"""The measure-profile-export loop that the port's profile tools share
(tools/profile_torch_tick.py, tools/profile_torch_boids.py,
tools/profile_torch_strips.py).

A tool hands :func:`profile_loop` a ``loop(k)`` that runs k steps of its
workload on one card, keeping its own state, and returns the host seconds of
each step by phase name (``{"dispatch": [...], "collect": [...]}``).
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent


def _timed(loop, k):
    """loop(k) on the host clock, the device drained at the end: (the
    loop's per-step phase seconds, its wall seconds)."""
    t0 = time.perf_counter()
    phases = loop(k)
    torch.cuda.synchronize()
    return phases, time.perf_counter() - t0


def profile_loop(loop, steps: int, trace_name: str,
                 kernel: str | tuple[str, ...] | None = None,
                 loops: int = 3) -> dict:
    """Where ``steps`` steps of ``loop`` spend their time:

    1. the device span of each of ``steps`` single steps, by CUDA events
       around ``loop(1)``;
    2. ``loops`` untraced loops of ``steps`` steps on the host clock: the
       median wall time a step, and the median of each phase;
    3. one loop under ``torch.profiler``: prints the top operations by
       device time and by host time and writes the trace to
       profile_out/<trace_name>.json.

    Returns step_ms (median loop), step_ms_of_each_loop, <phase>_p50_ms,
    device_span_p50_ms, traced_step_ms, device_ms_per_step (traced),
    kernel_ms_per_step (the device time of operations whose name holds
    ``kernel``, or one of the names in a tuple, when given) and
    device_busy_share: the traced device time a
    step over the untraced step's wall time."""
    device_ms = []
    for _ in range(steps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loop(1)
        end.record()
        end.synchronize()
        device_ms.append(start.elapsed_time(end))

    walls, phases = [], {}
    for _ in range(loops):
        got, wall = _timed(loop, steps)
        walls.append(wall)
        for name, secs in got.items():
            phases.setdefault(name, []).extend(secs)
    step_ms = float(np.median(walls)) / steps * 1e3

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, traced_wall = _timed(loop, steps)
    avg = prof.key_averages()
    device = [e for e in avg if e.device_type == DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in device)
    print(avg.table(sort_by="self_device_time_total", row_limit=15))
    print(avg.table(sort_by="self_cpu_time_total", row_limit=15))
    out = ROOT / "profile_out"
    out.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(out / f"{trace_name}.json"))

    result = {
        "steps": steps,
        "step_ms": step_ms,
        "step_ms_of_each_loop": [w / steps * 1e3 for w in walls],
        **{f"{name}_p50_ms": float(np.median(secs) * 1e3)
           for name, secs in phases.items() if secs},
        "device_span_p50_ms": float(np.median(device_ms)),
        "traced_step_ms": traced_wall / steps * 1e3,
        "device_ms_per_step": device_us / 1e3 / steps,
    }
    if kernel is not None:
        names = (kernel,) if isinstance(kernel, str) else kernel
        result["kernel_ms_per_step"] = sum(
            e.self_device_time_total for e in device
            if any(k in e.key for k in names)
        ) / 1e3 / steps
    result["device_busy_share"] = result["device_ms_per_step"] / step_ms
    return result
