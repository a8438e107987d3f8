"""Where a scenario's tick spends its time on one card.

    python3 tools/profile_torch_scenario.py [name ...] [--engine batched|sharded]

For each named scenario (default: all three) at its registered config, on
each engine (default: both): the world's seeded ticks driven through the
port's engine on the card as ``scenarios.runner`` drives them (the world's
numpy tick, ``step_async``, then the previous tick's ``collect``), first
through half of the scenario's ticks (``hotspot``'s crowd is dense by
then), then ``TICKS`` more through tools/torch_profile.py's
``profile_loop``: the device span of single ticks by CUDA events, the host
clock's world tick, dispatch and collect over three untraced loops, and one
loop under ``torch.profiler`` for the top operations, the event kernel's
device time a tick and the device busy share.

Prints one JSON line a run; the traces go to profile_out/. Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
TICKS = 20
# The event kernel's device functions (ops/csrc/event_kernel.cu).
KERNELS = ("event_mask_kernel", "drain_scan_kernel", "drain_write_kernel")


class Drive:
    """A scenario world and its engine, ticked as the runner ticks them."""

    def __init__(self, world, eng):
        self.world, self.eng = world, eng
        self.t = 0
        self.pending = None

    def run(self, k):
        w, phases = self.world, {"world": [], "dispatch": [], "collect": []}
        for _ in range(k):
            self.t += 1
            t0 = time.perf_counter()
            dirty = w.tick(self.t)
            t1 = time.perf_counter()
            nxt = self.eng.step_async(w.pos, w.active, w.space, w.radius,
                                      meta_dirty=bool(dirty))
            t2 = time.perf_counter()
            if self.pending is not None:
                self.pending.collect()
            t3 = time.perf_counter()
            self.pending = nxt
            phases["world"].append(t1 - t0)
            phases["dispatch"].append(t2 - t1)
            phases["collect"].append(t3 - t2)
        return phases


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("names", nargs="*",
                    default=["hotspot", "battle_royale", "service_heavy"])
    ap.add_argument("--engine", choices=("batched", "sharded"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_scenario: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from chip_smoke import card_line
    from goworld_tpu_torch.scenarios import get_scenario
    from goworld_tpu_torch.scenarios.runner import make_engine
    from torch_profile import profile_loop  # beside this script

    print(f"card: {card_line()}", flush=True)
    engines = [args.engine] if args.engine else ["batched", "sharded"]
    for name in args.names:
        for engine in engines:
            world = get_scenario(name).make()
            world.setup()
            try:
                eng = make_engine(world.config, engine, backend="kernel")
                eng.reset()
                eng.step(world.pos, world.active, world.space, world.radius)
                drive = Drive(world, eng)
                drive.run(int(world.config["ticks"]) // 2)
                torch.cuda.synchronize()
                result = profile_loop(drive.run, TICKS,
                                      f"scenario_{name}_{engine}",
                                      kernel=KERNELS)
                drive.pending.collect()
            finally:
                world.teardown()
            fallbacks = getattr(eng, "total_fallbacks", None)
            print(json.dumps({"scenario": name, "engine": engine,
                              "from_tick": int(world.config["ticks"]) // 2,
                              "fallback_ticks_so_far": fallbacks,
                              **result}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
