"""Times variants of the boids kernel's design against it, in turns, on one
card.

    python3 tools/time_boids_variants.py [--rounds N] [variant ...]

Each variant is goworld_tpu_torch/ops/csrc/boids_kernel.cu with a few text
replacements (``VARIANTS``): another CTA shape, register bound or unroll
depth, or another way of taking the image. The source keeps its choice as
plain constants; this script is how that choice is checked again. Every
variant, ``kept`` (the source as it is) included, is built by nvcc with the
port's flags (``_build.NVCC_FLAGS``), all builds started together, into
goworld_tpu_torch/_build/variants/, and its ptxas line printed.

Inputs: chip_smoke.py's start cells of the four sweep grids (51,200 agents,
radius 100, a 6,400-wide world), its seam grid and its
``boids_skip_edge_cells``. Each variant is held against the plain PyTorch
version there (``BOIDS_ATOL``); then, for ``--rounds`` rounds, each grid
times every variant once (chip_smoke.cuda_ms: median of 30 launches by CUDA
events), the order rotating from round to round. Printed per variant and
grid: the median over the rounds, the lowest and the highest; and launches
x median on the main path's mix (the launches chip_smoke.py's boids drive
makes at each grid: 1 + BOIDS_SWEEP_STEPS at each sweep grid, and
1 + BOIDS_STEPS more at grid 64, the size the drive has run in full).
The launches here are not counted in ``boids_kernel.launches``.

Prints one JSON line last. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent

# name -> [(text in boids_kernel.cu, its replacement), ...]
VARIANTS = {
    "kept": [],
    "t256_mb4": [
        ("constexpr int kThreads = 128;", "constexpr int kThreads = 256;"),
        ("constexpr int kMinBlocks = 8;", "constexpr int kMinBlocks = 4;"),
    ],
    "mb6": [
        ("constexpr int kMinBlocks = 8;", "constexpr int kMinBlocks = 6;"),
    ],
    "mb10": [
        ("constexpr int kMinBlocks = 8;", "constexpr int kMinBlocks = 10;"),
    ],
    "u1": [("constexpr int kUnroll = 4;", "constexpr int kUnroll = 1;")],
    "u2": [("constexpr int kUnroll = 4;", "constexpr int kUnroll = 2;")],
    # Every CTA takes the per-halo-cell shifts (kShifted with zero shifts is
    # kNone's arithmetic); no block-wide extent, no atomicMax.
    "shifted_everywhere": [
        ("""      key[0] = max(key[0], order_key(-kin[n].x));
      key[1] = max(key[1], order_key(kin[n].x));
      key[2] = max(key[2], order_key(-kin[n].y));
      key[3] = max(key[3], order_key(kin[n].y));
""", ""),
        ("""#pragma unroll
  for (int f = 0; f < 4; ++f) {
    const int top = __reduce_max_sync(0xffffffffu, key[f]);
    if (lane == 0) atomicMax(&extent[9][f], top);
  }
""", ""),
        ("""  if (!(__fadd_rn(from_key(extent[9][1]), from_key(extent[9][0])) <= k.hwx &&
        __fadd_rn(from_key(extent[9][3]), from_key(extent[9][2])) <= k.hwz)) {
""", "  {\n"),
        ("""    if (__any_sync(0xffffffffu, shifted)) {
      steer_queries<kShifted>(list, runs, shifts[warp], qlane, dst, k);
      return;
    }
  }
  steer_queries<kNone>(list, runs, shifts[warp], qlane, dst, k);
""", """    steer_queries<kShifted>(list, runs, shifts[warp], qlane, dst, k);
  }
"""),
    ],
}


def variant_source(text: str, name: str) -> str:
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            raise ValueError(f"variant {name}: {old[:50]!r} is not in the "
                             "source exactly once")
        text = text.replace(old, new)
    return text


def build_all(names, _build) -> dict:
    """Builds every variant at once; returns name -> (library path, nvcc
    output)."""
    src = (_build.CSRC / "boids_kernel.cu").read_text()
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        cu = out_dir / f"boids_{name}.cu"
        cu.write_text(variant_source(src, name))
        so = out_dir / f"boids_{name}.so"
        procs[name] = (so, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        built[name] = (so, log)
    return built


def load(so: Path):
    fn = ctypes.CDLL(str(so)).gw_boids_accel
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, *[ctypes.c_float] * 8, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def launcher(fn, bk, cells, p):
    gz, gx = cells.shape[0] - 2, cells.shape[1] - 2
    out = torch.empty((gz, gx, 2, 128), dtype=torch.float32,
                      device=cells.device)
    consts = bk.step_constants(p)
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        err = fn(cells.data_ptr(), out.data_ptr(), gz, gx, *consts, stream)
        if err != 0:
            raise RuntimeError(f"boids variant launch failed: cudaError {err}")
        return out
    return run


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=7)
    ap.add_argument("variants", nargs="*", default=list(VARIANTS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_boids_variants: no CUDA device", file=sys.stderr)
        return 1
    names = ["kept"] + [v for v in args.variants if v != "kept"]
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from goworld_tpu_torch.ops import _build
    from goworld_tpu_torch.ops import boids as tb
    from goworld_tpu_torch.ops import boids_kernel as bk

    card = cs.card_line()
    print(card, flush=True)
    built = build_all(names, _build)
    ptxas = {}
    for name, (_, log) in built.items():
        ptxas[name] = " | ".join(cs.ptxas_resources(log).values())
        print(f"{name}: ptxas {ptxas[name]}"
              + ("  SPILLS" if cs.spills(ptxas[name]) else ""), flush=True)
    fns = {name: load(so) for name, (so, _) in built.items()}

    device = torch.device("cuda")
    inputs = {}
    small = tb.BoidsParams(capacity=512, cell_size=100.0, grid_x=8, grid_z=8)
    inputs["seam"] = (small, cs.boids_cells(tb, small, cs.seam_world(small),
                                            device))
    edge = tb.BoidsParams(**cs.BOIDS_SKIP_EDGE)
    inputs["skip_edge"] = (edge, torch.tensor(cs.boids_skip_edge_cells(),
                                              device=device))
    grids = []
    for cell in cs.BOIDS_CELL_SWEEP:
        p = cs.boids_params(tb, cell)
        inputs[p.grid_x] = (p, cs.boids_cells(tb, p, cs.boids_world(p),
                                              device))
        grids.append(p.grid_x)

    errs = {name: 0.0 for name in names}
    same = {name: True for name in names}
    for key, (p, cells) in inputs.items():
        want = bk.boids_accel_reference(cells, p)
        kept = launcher(fns["kept"], bk, cells, p)().clone()
        for name in names:
            got = launcher(fns[name], bk, cells, p)()
            err = float((got - want).abs().max())
            if not bool(torch.isfinite(got).all()) or err > cs.BOIDS_ATOL:
                raise AssertionError(f"variant {name} at {key}: differs from "
                                     f"the plain version by {err}")
            errs[name] = max(errs[name], err)
            same[name] &= bool(torch.equal(got, kept))
    for name in names:
        print(f"{name}: max abs err {errs[name]:.3g} from the plain version, "
              f"{'bit-identical to' if same[name] else 'differs from'} kept",
              flush=True)

    times = {name: {g: [] for g in grids + ["skip_edge"]} for name in names}
    for r in range(args.rounds):
        order = names[r % len(names):] + names[:r % len(names)]
        for g in grids + ["skip_edge"]:
            p, cells = inputs[g]
            for name in order:
                times[name][g].append(cs.cuda_ms(launcher(fns[name], bk,
                                                          cells, p)))
    mix = {g: 1 + cs.BOIDS_SWEEP_STEPS for g in grids}
    mix[grids[0]] += 1 + cs.BOIDS_STEPS
    result = {}
    for name in names:
        row = {str(g): {"ms": float(np.median(t)), "min": float(min(t)),
                        "max": float(max(t))} for g, t in times[name].items()}
        mix_ms = sum(n * row[str(g)]["ms"] for g, n in mix.items())
        result[name] = {"ptxas": ptxas[name], "max_abs_err": errs[name],
                        "bit_identical": same[name], "by_grid": row,
                        "mix_ms": mix_ms}
        cells_txt = ", ".join(f"{g}: {v['ms']:.4f} ({v['min']:.4f}-"
                              f"{v['max']:.4f})" for g, v in row.items())
        print(f"{name}: {cells_txt}; mix {mix_ms:.3f} ms", flush=True)
    print(json.dumps({"card": card, "rounds": args.rounds,
                      "mix": {str(g): n for g, n in mix.items()},
                      "variants": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
