"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m gwbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

It loads the cell's configuration, traffic mix and driver by name, makes
the world from the seed, sets up (the storm and the warm ticks), measures
for ``--seconds``, checks every checked tick against the plain reference
and prints, as the last line of standard output, one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics untraced, its per-layer metrics traced), ``device``, with
``--trace 1`` a ``breakdown``, and last ``checked``: each number compared
beside its limit, which also end standard error.

It fails, and prints no result, where CUDA is missing or holds fewer cards
than the cell asks for (there is no CPU fallback), and where ``jax``,
``jaxlib``, ``flax`` or the JAX package ``goworld_tpu`` is loaded once the
window has closed.
"""

import time

T_START = time.perf_counter()  # the process's start, for setup_s

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

if not __package__:  # run as a file: make the checkout importable
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from gwbench import manifest, record  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "goworld_tpu")
TOP = 10


def forbidden(names) -> list[str]:
    """The forbidden top-level modules among ``names``, compared whole:
    ``goworld_tpu_torch`` is not ``goworld_tpu``."""
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def _breakdown(run: record.Run) -> dict:
    profs = run.profiles()
    ops: dict[str, float] = {}
    for p in profs:
        for name, s in p["ops"].items():
            ops[name] = ops.get(name, 0.0) + s / len(profs)
    gaps = []
    for rank, p in enumerate(profs):
        prefix = f"rank{rank} " if len(profs) > 1 else ""
        gaps += [[prefix + label, s] for label, s in p["gaps"]]
    return {
        "device_ops": [[n[:200], s] for n, s in sorted(
            ops.items(), key=lambda kv: -kv[1])[:TOP]],
        "idle_gaps": sorted(gaps, key=lambda g: -g[1])[:TOP],
    }


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, device: str, t_start: float) -> tuple[dict, list]:
    """(the result line, the forbidden modules found). ``device`` is
    ``"cuda"`` for the benchmark; the tests rehearse on ``"cpu"``."""
    import torch

    from gwbench.reference import check

    m = manifest.load(root)
    cell = manifest.resolve(m, workload, root)
    specs = manifest.cell_metrics(m, workload, trace)
    readers = {s["name"]: manifest.metric_reader(root, s["name"])
               for s in specs}
    driver = manifest.load_module(cell["driver"], "drivers")
    out = driver.run(cell, seed, seconds, trace, device, t_start)
    run = record.Run(cell, out["procs"], out["setup_s"])
    modules = set(sys.modules)
    for p in out["procs"]:
        modules.update(p.get("modules", ()))
    numbers = check.compare(out["ticks"], cell["config"], torch.device(device))
    correct, shown = check.verdict(numbers)
    metrics = {}
    for spec in specs:
        value = readers[spec["name"]].read(run)
        if value is not None:
            metrics[spec["name"]] = {"value": float(value),
                                     "unit": spec["unit"]}
    dev = {
        "platform": "gpu" if device == "cuda" else device,
        "kind": out["procs"][0]["device_name"],
        "count": out["cards"],
        "memory_peak_bytes": max(int(p["peak_bytes"]) for p in out["procs"]),
    }
    line = {"correct": correct,
            "attempted": run.ticks() * len(out["procs"]),
            "failed": 0, "metrics": metrics, "device": dev}
    if trace:
        profs = run.profiles()
        dev["busy_s"] = sum(p["busy_s"] for p in profs) / len(profs)
        dev["window_s"] = sum(p["window_s"] for p in profs) / len(profs)
        line["breakdown"] = _breakdown(run)
    line["checked"] = shown
    return line, forbidden(modules)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = manifest.ROOT
    m = manifest.load(root)
    chips = int(manifest.resolve(m, args.workload, root)["chips"])
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"gwbench: {args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    line, bad = run_cell(root, args.workload, args.seed, args.seconds,
                         bool(args.trace), "cuda", T_START)
    if bad:
        print(f"gwbench: loaded after the window: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    for name, c in line["checked"].items():
        bound = (f"limit {c['limit']}" if "limit" in c
                 else f"at least {c['at_least']}")
        print(f"checked {name} {c['value']} {bound}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
