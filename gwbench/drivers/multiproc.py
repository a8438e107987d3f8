"""Game processes stepping one world: the multi-process tier of
``goworld_tpu_torch.parallel.multihost``, a process a card.

Each worker process joins the group (``init_multihost`` over a TCP store
on a free localhost port), takes card ``rank``, and builds its engine as
``BatchAOIService(multihost=True)`` builds it:
``MultiHostNeighborEngine(params, make_mesh(1, card), backend=...)``. It
feeds its own rows ``[rank * rows, (rank + 1) * rows)``, drawn from the
seed and its rank, and receives its own rows' events; the processes'
rows are all-gathered every tick (over NCCL on cards, Gloo on the CPU).

The processes must dispatch the same ticks, so they fix the window's count
once, before it opens: each times its warm ticks, and the slowest
process's tick over ``seconds`` is the count, agreed by one all-reduce over
the group's CPU backend (Gloo) that also opens the window together. No
host barrier falls inside the window. Their clocks are comparable: Linux's
``perf_counter`` is the machine's monotonic clock.

The parent process never touches a card while the workers run: it starts
them, gathers their records and checked ticks, and leaves the reference
to run after they have ended.
"""

from __future__ import annotations

import multiprocessing
import queue as queue_mod
import socket
import sys
import time

import numpy as np

from gwbench import loop, manifest
from gwbench.drivers.single import check_rng, world_tick
from gwbench.trace import Stretch

JOIN_TIMEOUT_S = 300.0


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run(cell: dict, seed: int, seconds: float, trace: bool, device: str,
        t_start: float) -> dict:
    cfg = cell["config"]
    nprocs = int(cfg["processes"])
    addr = f"127.0.0.1:{free_port()}"
    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    from gwbench import worker

    procs = [ctx.Process(target=worker.main, args=(cell["driver"], dict(
        cell=cell, seed=seed, seconds=seconds, trace=trace, rank=r,
        nprocs=nprocs, addr=addr, cuda=device == "cuda"), q))
        for r in range(nprocs)]
    for p in procs:
        p.start()
    results: dict[int, dict] = {}
    errors = []
    deadline = time.monotonic() + JOIN_TIMEOUT_S + seconds
    try:
        while len(results) + len(errors) < nprocs:
            try:
                rank, status, payload = q.get(timeout=1.0)
            except queue_mod.Empty:
                if time.monotonic() > deadline or any(
                        p.exitcode not in (None, 0) for p in procs):
                    errors.append("a worker ended without a result")
                    break
                continue
            if status == "ok":
                results[rank] = payload
            else:
                errors.append(f"rank {rank}:\n{payload}")
    finally:
        for p in procs:
            p.join(timeout=30 if not errors else 5)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        raise RuntimeError("multi-process cell failed:\n" + "\n".join(errors))
    recs = [results[r] for r in range(nprocs)]
    ticks = []
    by_rank = [{c["tick"]: c for c in r["checks"]} for r in recs]
    for label in by_rank[0]:
        parts_recs = [b[label] for b in by_rank]
        world = {k: np.concatenate([c[k] for c in parts_recs])
                 for k in ("prev", "pos", "prev_active", "active", "space",
                           "radius")}
        world["tick"] = label
        ticks.append(world_tick(world, [
            (r["lo"], r["lo"] + r["rows"], c["enters"], c["leaves"],
             c["dropped"]) for r, c in zip(recs, parts_recs)]))
    for r in recs:
        del r["checks"]
    return {"procs": recs, "ticks": ticks,
            "setup_s": min(r["window"]["t0"] for r in recs) - t_start,
            "cards": len({r["card"] for r in recs}) if device == "cuda" else 0}


def worker(cell: dict, seed: int, seconds: float, trace: bool, rank: int,
           nprocs: int, addr: str, cuda: bool) -> dict:
    import torch
    import torch.distributed as dist

    from goworld_tpu_torch.ops.neighbor import NeighborParams
    from goworld_tpu_torch.parallel import multihost as mh
    from goworld_tpu_torch.parallel.mesh import make_mesh

    cfg = cell["config"]
    if cuda:
        loop.settle(rank)
    mh.init_multihost(addr, nprocs, rank, timeout_s=JOIN_TIMEOUT_S, cuda=cuda)
    try:
        dev = (torch.device("cuda", torch.cuda.current_device()) if cuda
               else torch.device("cpu"))
        engine = mh.MultiHostNeighborEngine(
            NeighborParams(**cfg["engine"]), make_mesh(1, dev),
            backend=cfg["backend"])
        engine.reset()
        gen = manifest.load_module(cell["generator"], "traffic")
        traffic = gen.Traffic(cell["traffic"], cfg, engine.local_capacity,
                              seed, stream=rank)
        storm = loop.storm(engine, traffic)
        tick_s = loop.warm(engine, traffic, int(cfg["warm_ticks"]))
        if tick_s is None:
            raise ValueError("a multi-process cell needs warm_ticks >= 2")
        stretch = (Stretch(int(cfg["trace_ticks"]), cuda).begin() if trace
                   else None)
        slowest = torch.tensor([tick_s], dtype=torch.float64)
        dist.all_reduce(slowest, op=dist.ReduceOp.MAX)
        ticks = max(1, round(seconds / float(slowest.item())))
        win = loop.window(engine, traffic, seconds, check_rng(seed),
                          float(cfg["check_share"]), stretch, ticks=ticks)
        peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
        name = torch.cuda.get_device_name(dev) if cuda else "cpu"
        lo, rows = engine.local_lo, engine.local_capacity
        del engine
        checks = [storm] + win.pop("checks")
    finally:
        mh.leave()
    return {"rank": rank, "lo": lo, "rows": rows,
            "active": int(traffic.active.sum()), "window": win,
            "peak_bytes": peak, "device_name": name,
            "card": dev.index if cuda else -1, "checks": checks,
            "modules": sorted({m.split(".")[0] for m in sys.modules})}
