"""One game process on one card: ``goworld_tpu_torch.ops.NeighborEngine``,
built from the configuration's ``engine`` settings and ``backend``, stepped
by ``step_async`` and collected by ``PendingStep.collect``.

``run`` makes the world from the seed, runs the storm and the warm ticks,
the window, and hands back the process's record and the checked ticks
(``gwbench/loop.py``). The engine is freed before it returns, so the
reference that follows finds the card empty.
"""

from __future__ import annotations

import numpy as np

from gwbench import loop, manifest
from gwbench.trace import Stretch

CHECK_STREAM = 1 << 20  # the check's draws, apart from every rank's rows


def world_tick(rec: dict, parts: list) -> dict:
    """A checked tick of the whole world, with each process's pairs."""
    out = {k: rec[k] for k in ("tick", "prev", "pos", "prev_active",
                               "active", "space", "radius")}
    out["parts"] = parts
    return out


def check_rng(seed: int):
    return np.random.default_rng([int(seed) % 2**63, CHECK_STREAM])


def run(cell: dict, seed: int, seconds: float, trace: bool, device: str,
        t_start: float) -> dict:
    import torch

    from goworld_tpu_torch.ops.neighbor import NeighborEngine, NeighborParams

    cfg = cell["config"]
    gen = manifest.load_module(cell["generator"], "traffic")
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        loop.settle(0)
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    n = int(cfg["engine"]["capacity"])
    traffic = gen.Traffic(cell["traffic"], cfg, n, seed)
    engine = NeighborEngine(NeighborParams(**cfg["engine"]),
                            backend=cfg["backend"], device=dev)
    engine.reset()
    storm = loop.storm(engine, traffic)
    loop.warm(engine, traffic, int(cfg["warm_ticks"]))
    stretch = (Stretch(int(cfg["trace_ticks"]), cuda).begin() if trace
               else None)
    win = loop.window(engine, traffic, seconds, check_rng(seed),
                      float(cfg["check_share"]), stretch)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    name = torch.cuda.get_device_name(dev) if cuda else "cpu"
    del engine
    if cuda:
        torch.cuda.empty_cache()
    ticks = [world_tick(r, [(0, n, r["enters"], r["leaves"], r["dropped"])])
             for r in [storm] + win.pop("checks")]
    proc = {"rank": 0, "active": int(traffic.active.sum()), "window": win,
            "peak_bytes": peak, "device_name": name}
    return {"procs": [proc], "ticks": ticks, "setup_s": win["t0"] - t_start,
            "cards": 1 if cuda else 0}
