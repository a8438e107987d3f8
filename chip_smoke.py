"""Smoke run of goworld_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

From the root of a checkout, on a machine with a CUDA card and the CUDA
toolkit. It

1. builds every CUDA kernel of the port from ``goworld_tpu_torch/ops/csrc``;
2. holds each kernel form against its plain PyTorch version on the card, at
   the headline cell grid and at a small lattice grid (bit-identical words),
   and times both;
3. drives the AOI neighbor engine's main path at the headline size of
   bench.py's accelerator branch (102,400 entities, 44x44 cells of 300,
   radius 100): the enter storm, 40 pipelined steady ticks, 200 synchronous
   ones and a slow tick (1% despawned, 1% teleported), with the kernel
   launch counts zeroed just before and read just after;
4. holds the storm, two steady ticks and the slow tick against the port's
   reference engine on the card, and a 1,024-entity sample's incremental
   interest sets against brute force;
5. repeats the kernel checks, the drive and the engine checks for a few
   ticks of the 32-space shape (bench.py ``multispace_32``: 32 space slots,
   32x32 cells of 400).

It prints bench.py's metrics, a ``{"kernels": [...]}`` line, the card's name
and power limit, and last ``{"ok": true, "device": {...}}``. Any failed check
raises, so the exit code is not 0. Without a CUDA device it exits with 1 and
prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# Published peaks of one H100 SXM (NVIDIA's data sheet): HBM3 bandwidth, and
# FP32 outside the tensor cores, 67 TFLOP/s with an FMA counted as two
# operations. The kernel is built with --fmad=false and issues separate
# FP32 instructions of one operation each, so its peak is half that rate.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12 / 2
# FP32 operations per pair and epoch in the event kernel: 2 subtractions,
# 2 multiplications, 1 addition, 2 comparisons.
OPS_PER_PAIR_EPOCH = 7

# The two configurations of bench.py's accelerator branch, and the ticks.
HEADLINE = dict(capacity=102400, cell_size=300.0, grid_x=44, grid_z=44,
                space_slots=1, cell_capacity=128, max_events=131072)
MULTISPACE = dict(capacity=102400, cell_size=400.0, grid_x=32, grid_z=32,
                  space_slots=32, cell_capacity=128, max_events=131072)
PIPELINED_TICKS = 40
SYNC_TICKS = 200

SOURCE = "goworld_tpu_torch/ops/csrc/event_kernel.cu"
REPLACES = "goworld_tpu/ops/neighbor.py:496"
SAMPLE = 1024


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def cuda_ms(fn, reps: int = 30) -> float:
    """Median device time of one call of ``fn()`` over ``reps`` calls, by
    CUDA events. Each call queues behind a ~1 ms device sleep, so the host
    has issued it before the device reaches it and the host's launch
    overhead stays out of the time."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def pct(values_s, q) -> float:
    return float(np.percentile(np.asarray(values_s) * 1000.0, q))


def pair_keys(pairs: np.ndarray, n: int) -> np.ndarray:
    return np.sort(pairs[:, 0].astype(np.int64) * n + pairs[:, 1])


def check_pairs(pairs: np.ndarray, n: int, what: str) -> None:
    if pairs.ndim != 2 or pairs.shape[1] != 2 or pairs.dtype != np.int32:
        raise AssertionError(f"{what}: malformed pairs {pairs.shape}")
    if len(pairs) and (pairs.min() < 0 or pairs.max() >= n):
        raise AssertionError(f"{what}: slot out of range")
    if len(pairs) and (pairs[:, 0] == pairs[:, 1]).any():
        raise AssertionError(f"{what}: self pair")


def lattice_cells(slots, rows, cols, seed):
    """Event-kernel input f32[slots, rows+2, cols+2, 8, 128] on an integer
    lattice, so pairs at exactly d == r (3-4-5 and 5-12-13 triples) are
    common and `<=` is told from `<`. It holds empty lanes, an empty and a
    full cell, lanes present in one epoch only, moves and radius changes
    between the epochs, three space ids, and a wrapped halo ring."""
    rng = np.random.default_rng(seed)
    shape = (slots, rows, cols, 128)
    occupied = rng.random(shape) < rng.uniform(0.2, 1.0, shape[:3])[..., None]
    occupied[0, 0, 0] = False
    occupied[-1, -1, -1] = True
    xz = rng.integers(0, 30, shape + (2,)).astype(np.float32)
    move = rng.integers(-4, 5, shape + (2,)).astype(np.float32)
    spc = rng.integers(0, 3, shape).astype(np.float32)
    rad = rng.choice(np.array([5, 10, 13, 25], np.float32), shape)
    feats = [xz[..., 0], xz[..., 1], spc, rad,
             xz[..., 0] + move[..., 0], xz[..., 1] + move[..., 1],
             np.where(rng.random(shape) < 0.1, (spc + 1) % 3, spc),
             np.where(rng.random(shape) < 0.2, rad + 5, rad)]
    cells = np.full(shape[:3] + (8, 128), np.nan, np.float32)
    for f, v in enumerate(feats):
        cells[..., f, :] = np.where(occupied, v, np.nan)
    absent_b = rng.random(shape) < 0.1  # no epoch-B position
    cells[..., 4, :] = np.where(absent_b, np.nan, cells[..., 4, :])
    zi = np.arange(-1, rows + 1) % rows
    xi = np.arange(-1, cols + 1) % cols
    return np.ascontiguousarray(cells[:, zi][:, :, xi])


def steady_cells(tn, p, pos, ppos, space, device):
    """The current grid's cells of a steady tick, built by the engine's own
    binning, table and scatter (as _step_pallas builds them)."""
    n = p.capacity
    pos_t = torch.tensor(pos, device=device)
    ppos_t = torch.tensor(ppos, device=device)
    space = torch.tensor(space, device=device)
    radius = torch.full((n,), 100.0, device=device)
    active = torch.ones(n, dtype=torch.bool, device=device)
    cx, cz, sm = tn._bins(p, pos_t, space)
    bucket = (sm * p.grid_z + cz) * p.grid_x + cx
    _, slot, _, order, dst = tn._build_table(p, bucket, active, tn.LANES)
    feats_a = (pos_t[:, 0], pos_t[:, 1], space, radius)
    feats_b = (ppos_t[:, 0], ppos_t[:, 1], space, radius)
    return tn._scatter_feats(p, dst, order, feats_a, feats_b)


def hold_kernel(ek, cells, dual) -> int:
    """One form's words against its plain version on the same cells; the
    largest difference of a word, which must be 0."""
    got = ek.event_mask(cells, dual)
    want = ek.event_mask_reference(cells, dual)
    err = int((got - want).abs().max())  # words are 0..65535
    if err:
        raise AssertionError(f"{ek.FORMS[int(dual)]}: kernel words differ "
                             f"from the plain version at "
                             f"{tuple(cells.shape)}")
    return err


def kernel_checks(tn, ek, p, pos, ppos, space, device):
    """Each form against its plain version, at the headline cells and at a
    small lattice grid; times at the headline cells."""
    head = steady_cells(tn, p, pos, ppos, space, device)
    small = torch.tensor(lattice_cells(2, 6, 5, seed=1), device=device)
    n_cells = head.shape[0] * (head.shape[1] - 2) * (head.shape[2] - 2)
    skip = torch.ones((), dtype=torch.bool, device=device)
    rows = []
    for dual in (False, True):
        name = ek.FORMS[int(dual)]
        err = max(hold_kernel(ek, cells, dual) for cells in (small, head))
        out = ek.event_mask(head, dual)
        ms = cuda_ms(lambda: ek.event_mask(head, dual))
        plain_ms = cuda_ms(lambda: ek.event_mask_reference(head, dual), 3)
        bytes_moved = head.numel() * 4 + out.numel() * 4
        ops = n_cells * 128 * 1152 * 2 * OPS_PER_PAIR_EPOCH
        bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / FP32_OPS_PER_S * 1e3
        row = {
            "name": name, "form": "dual" if dual else "single",
            "route": "cuda", "source": SOURCE, "replaces": REPLACES,
            "launches": None, "bit_identical": True, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms > ops_ms else "operations",
            "library_ms": None,
            "bytes": bytes_moved, "fp32_ops": ops,
        }
        if not dual:  # what a fast tick pays for the skipped launch
            row["skipped_ms"] = cuda_ms(
                lambda: ek.event_mask(head, False, skip=skip))
        rows.append(row)
        print(f"kernel {name}: bit-identical at {tuple(small.shape)} and "
              f"{tuple(head.shape)}; {ms:.4f} ms, plain {plain_ms:.3f} ms, "
              f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})",
              flush=True)
    del head, small
    torch.cuda.empty_cache()
    return rows


class SampleSets:
    """Incremental interest sets of a sample of query slots, from the event
    stream, held against brute force on the card."""

    def __init__(self, n, seed):
        self.n = n
        self.slots = np.sort(
            np.random.default_rng(seed).choice(n, SAMPLE, replace=False))
        self.row = np.full(n, -1, np.int64)
        self.row[self.slots] = np.arange(SAMPLE)
        self.sets = np.zeros((SAMPLE, n), bool)

    def apply(self, enters, leaves):
        for pairs, value in ((leaves, False), (enters, True)):
            r = self.row[pairs[:, 0]]
            hit = r >= 0
            self.sets[r[hit], pairs[hit, 1]] = value

    def check(self, pos, active, space, radius, device, what):
        p = torch.tensor(pos, device=device)
        a = torch.tensor(active, device=device)
        s = torch.tensor(space, device=device)
        r = torch.tensor(radius, device=device)
        q = torch.tensor(self.slots, device=device)
        dx = p[None, :, 0] - p[q, 0][:, None]
        dz = p[None, :, 1] - p[q, 1][:, None]
        d2 = dx * dx + dz * dz
        want = (a[q][:, None] & a[None, :] & (s[q][:, None] == s[None, :])
                & (d2 <= (r[q] * r[q])[:, None]))
        want[torch.arange(SAMPLE, device=device), q] = False
        if not np.array_equal(self.sets, want.cpu().numpy()):
            raise AssertionError(f"{what}: sample interest sets differ "
                                 f"from brute force")


def hold_against_reference(tn, p, device, compared, what):
    """Each compared tick again through the reference engine on the card,
    from the same previous epoch: the same pair sets and drop count."""
    ref = tn.NeighborEngine(p, backend="reference", device=device)
    for label, prev, cur, got in compared:
        if prev is None:
            ref.reset()
        else:
            ref.load_state(prev)
        want = ref.step(*cur)
        for k, side in ((0, "enters"), (1, "leaves")):
            if not np.array_equal(pair_keys(want[k], p.capacity),
                                  pair_keys(got[k], p.capacity)):
                raise AssertionError(f"{what} {label}: {side} differ from "
                                     f"the reference engine")
        if want[2] != got[2]:
            raise AssertionError(f"{what} {label}: dropped differs")
        print(f"{what} {label}: {len(got[0])} enters, {len(got[1])} leaves,"
              f" dropped {got[2]}: equal to the reference engine",
              flush=True)


def walk(pos, vel, world):
    """One tick of the walk, in place. Entities reflect off the world's
    edges: bench.py clips them there, which over a few hundred ticks piles
    them up on the edge cells past a cell's capacity."""
    pos += vel
    under = pos < 0
    over = pos > world
    pos[under] = -pos[under]
    pos[over] = 2 * world - pos[over]
    vel[under | over] *= -1


def slow_tick_inputs(rng, pos, active, world):
    """1% despawned, 1% teleported across the map."""
    n = len(pos)
    pos = pos.copy()
    active = active.copy()
    active[rng.choice(n, n // 100, replace=False)] = False
    hop = rng.choice(n, n // 100, replace=False)
    pos[hop] = rng.uniform(0, world, (len(hop), 2)).astype(np.float32)
    return pos, active


def drive_headline(tn, ek, device):
    """bench.py's accelerator headline loop through the port's engine."""
    p = tn.NeighborParams(**HEADLINE)
    n = p.capacity
    world = p.grid_x * p.cell_size
    rng = np.random.default_rng(0)
    pos = rng.uniform(0, world, (n, 2)).astype(np.float32)
    active = np.ones(n, bool)
    space = np.zeros(n, np.int32)
    radius = np.full(n, 100.0, np.float32)
    vel = rng.normal(0, 3.0, (n, 2)).astype(np.float32)
    kernels = kernel_checks(tn, ek, p, pos + vel, pos, space, device)

    eng = tn.NeighborEngine(p)
    if eng.backend != "kernel" or eng.device != device:
        raise AssertionError("the default engine is not the CUDA kernel path")
    eng.reset()
    sample = SampleSets(n, seed=1)
    compared = []
    fasts = []
    torch.cuda.synchronize()
    ek.reset_launch_counts()

    # The enter storm (paged).
    t0 = time.perf_counter()
    pend = eng.step_async(pos, active, space, radius)
    storm = pend.collect()
    storm_ms = (time.perf_counter() - t0) * 1e3
    fasts.append(pend.fast)
    compared.append(("storm", None, (pos.copy(), active, space, radius),
                     storm))

    def consume(out, label):
        check_pairs(out[0], n, f"{label} enters")
        check_pairs(out[1], n, f"{label} leaves")
        if out[2]:
            raise AssertionError(f"{label}: {out[2]} entities dropped")
        sample.apply(out[0], out[1])

    consume(storm, "storm")

    # Pipelined steady ticks: dispatch t+1, then collect t. The timed
    # window holds only what a game does (move, step_async, collect); the
    # checks run over the kept outputs after it.
    steps = PIPELINED_TICKS
    k_cmp = steps // 2  # a steady tick compared with the reference engine
    outs = []
    dispatch_s, collect_s = [], []
    pending = None
    t_all0 = time.perf_counter()
    for k in range(1, steps + 2):
        nxt = None
        if k <= steps:
            prev = pos.copy() if k == k_cmp else None
            walk(pos, vel, world)
            t0 = time.perf_counter()
            nxt = eng.step_async(pos, active, space, radius, meta_dirty=False)
            dispatch_s.append(time.perf_counter() - t0)
            fasts.append(nxt.fast)
            if k == k_cmp:
                cmp_epochs = ((prev, active, space, radius),
                              (pos.copy(), active, space, radius))
        if pending is not None:
            t0 = time.perf_counter()
            outs.append(pending.collect())
            collect_s.append(time.perf_counter() - t0)
        pending = nxt
    t_all = time.perf_counter() - t_all0
    events = paged = 0
    for k, out in enumerate(outs, 1):
        events += len(out[0]) + len(out[1])
        paged += len(out[0]) > p.max_events or len(out[1]) > p.max_events
        consume(out, f"tick {k}")
    compared.append((f"steady tick {k_cmp}", *cmp_epochs, outs[k_cmp - 1]))
    del outs

    # Synchronous steady ticks: post-step drain latency.
    drain_s = []
    for j in range(SYNC_TICKS):
        prev = pos.copy()
        walk(pos, vel, world)
        pend = eng.step_async(pos, active, space, radius, meta_dirty=False)
        fasts.append(pend.fast)
        pend.wait_device()
        t0 = time.perf_counter()
        out = pend.collect()
        drain_s.append(time.perf_counter() - t0)
        consume(out, f"sync tick {j}")
        if j == SYNC_TICKS // 2:
            compared.append(("sync steady tick",
                             (prev, active, space, radius),
                             (pos.copy(), active, space, radius), out))

    # The slow tick.
    prev = (pos.copy(), active, space, radius)
    pos, active = slow_tick_inputs(rng, pos, active, world)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pend = eng.step_async(pos, active, space, radius)
    out = pend.collect()
    slow_ms = (time.perf_counter() - t0) * 1e3
    fasts.append(pend.fast)
    consume(out, "slow tick")
    compared.append(("slow tick", prev, (pos, active, space, radius), out))
    torch.cuda.synchronize()
    launches = dict(ek.launches)

    fast = [bool(f) for f in fasts]
    if fast[-1] or not all(fast[:-1]):
        raise AssertionError(f"unexpected fast/slow ticks: {fast}")
    if launches[ek.FORMS[1]] != len(fast) or launches[ek.FORMS[0]] != len(fast):
        raise AssertionError(f"launch counts {launches} for {len(fast)} ticks")
    sample.check(pos, active, space, radius, device, "headline")
    hold_against_reference(tn, p, device, compared, "headline")

    for row in kernels:
        row["launches"] = launches[row["name"]]
    metrics = {
        "config": HEADLINE,
        "aoi_entity_updates_per_sec": steps / t_all * n,
        "ticks_per_sec": steps / t_all,
        "events_per_tick": events / steps,
        "paged_ticks": int(paged),
        "storm_events": len(storm[0]),
        "storm_ms": storm_ms,
        "dispatch_p50_ms": pct(dispatch_s, 50),
        "dispatch_p99_ms": pct(dispatch_s, 99),
        "collect_p50_ms": pct(collect_s, 50),
        "collect_p99_ms": pct(collect_s, 99),
        "post_step_drain_p50_ms": pct(drain_s, 50),
        "post_step_drain_p99_ms": pct(drain_s, 99),
        "post_step_drain_samples": len(drain_s),
        "slow_tick_ms": slow_ms,
        "ticks": len(fast),
        "slow_ticks": fast.count(False),
        "launches": launches,
        "single_form_ticks_with_work": fast.count(False),
    }
    return metrics, kernels


def drive_multispace(tn, ek, device):
    """bench.py's multispace_32 accelerator shape, a few ticks."""
    p = tn.NeighborParams(**MULTISPACE)
    n = p.capacity
    world = p.grid_x * p.cell_size
    rng = np.random.default_rng(0)
    pos = rng.uniform(0, world, (n, 2)).astype(np.float32)
    active = np.ones(n, bool)
    space = (np.arange(n) % p.space_slots).astype(np.int32)
    radius = np.full(n, 100.0, np.float32)
    vel = rng.normal(0, 3.0, (n, 2)).astype(np.float32)

    # Both forms against their plain version at this path's cells.
    cells = steady_cells(tn, p, pos + vel, pos, space, device)
    kernel_err, kernel_ms = {}, {}
    for dual in (False, True):
        name = ek.FORMS[int(dual)]
        kernel_err[name] = hold_kernel(ek, cells, dual)
        kernel_ms[name] = cuda_ms(lambda: ek.event_mask(cells, dual), 5)
        print(f"kernel {name}: bit-identical at {tuple(cells.shape)}; "
              f"{kernel_ms[name]:.4f} ms", flush=True)
    del cells
    torch.cuda.empty_cache()

    eng = tn.NeighborEngine(p)
    eng.reset()
    sample = SampleSets(n, seed=2)
    compared, fasts = [], []
    torch.cuda.synchronize()
    ek.reset_launch_counts()
    prev = None
    tick_s = []
    for k in range(5):
        if k == 4:
            pos, active = slow_tick_inputs(rng, pos, active, world)
        elif k:
            pos = np.clip(pos + vel, 0.0, world).astype(np.float32)
        t0 = time.perf_counter()
        pend = eng.step_async(pos, active, space, radius,
                              meta_dirty=k in (0, 4))
        out = pend.collect()
        tick_s.append(time.perf_counter() - t0)
        fasts.append(pend.fast)
        for which, pairs in (("enters", out[0]), ("leaves", out[1])):
            check_pairs(pairs, n, f"multispace tick {k} {which}")
        if out[2]:
            raise AssertionError(f"multispace tick {k}: dropped {out[2]}")
        sample.apply(out[0], out[1])
        cur = (pos.copy(), active.copy(), space, radius)
        compared.append((f"tick {k}", prev, cur, out))
        prev = cur
    torch.cuda.synchronize()
    launches = dict(ek.launches)
    fast = [bool(f) for f in fasts]
    if fast[-1] or min(launches.values()) != len(fast):
        raise AssertionError(f"multispace: fast {fast}, launches {launches}")
    sample.check(pos, active, space, radius, device, "multispace")
    hold_against_reference(tn, p, device, compared, "multispace")
    return {
        "config": MULTISPACE,
        "tick_ms": [s * 1e3 for s in tick_s],
        "events": [len(c[3][0]) + len(c[3][1]) for c in compared],
        "fast": fast,
        "launches": launches,
        "kernel_max_abs_err": kernel_err,
        "kernel_ms": kernel_ms,
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from goworld_tpu_torch.ops import _build
    from goworld_tpu_torch.ops import event_kernel as ek
    from goworld_tpu_torch.ops import neighbor as tn

    device = torch.device("cuda")
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    log = _build.build("event_kernel")
    print(f"build: {time.perf_counter() - t0:.1f} s for {SOURCE}", flush=True)
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  {line.strip()}")

    headline, kernels = drive_headline(tn, ek, device)
    print(json.dumps({"headline": headline}), flush=True)
    multispace = drive_multispace(tn, ek, device)
    print(json.dumps({"multispace_32": multispace}), flush=True)
    for row in kernels:  # the kernel checks of both paths
        row["max_abs_err"] = max(row["max_abs_err"],
                                 multispace["kernel_max_abs_err"][row["name"]])
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
