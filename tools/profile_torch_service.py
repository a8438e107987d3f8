"""Where a steady service_10k tick of goworld_tpu_torch spends its time on
one card.

    python3 tools/profile_torch_service.py [--fuse]

Builds chip_smoke.py's ``service_10k`` world (10,240 columnar avatars in one
space, ``[sync]`` tiers, fused delivery; ``--fuse`` turns on [aoi]
fuse_logic) through the port's runtime, runs the enter storm and a warm-up,
then ``TICKS`` runtime ticks through tools/torch_profile.py's
``profile_loop``: the host clock splits each tick into entity logic (the
host tick programs), dispatch (``BatchAOIService._dispatch``: the fused and
tier writebacks, the edge snapshot, ``step_async``), collect (the wait and
the one readback) and delivery (the fused edge decode and the
``on_aoi_batch`` callbacks); ``torch.profiler`` gives the top operations,
the event kernel's time a tick and the device busy share. A cProfile of
one loop names the host functions that take the tick.

Prints one JSON line last; the trace goes to profile_out/service_trace.json.
Needs a CUDA device.
"""

from __future__ import annotations

import cProfile
import io
import json
import pstats
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
TICKS = 20


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_service: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from chip_smoke import card_line, service_tick, service_world
    from goworld_tpu_torch.entity import entity_manager as em
    from goworld_tpu_torch.entity.aoi import batched
    from goworld_tpu_torch.ops import neighbor as tn
    from torch_profile import profile_loop  # beside this script

    fuse = "--fuse" in sys.argv[1:]
    print(f"card: {card_line()}", flush=True)
    rt, svc, _, _, clock, _ = service_world(
        em, tn, torch.device("cuda"), fuse)
    phase = {"dispatch": 0.0, "deliver": 0.0}

    def timed(name, fn):
        def run(*args):
            t = time.perf_counter()
            try:
                return fn(*args)
            finally:
                phase[name] += time.perf_counter() - t
        return run

    svc._dispatch = timed("dispatch", svc._dispatch)
    svc._deliver = timed("deliver", svc._deliver)
    delivery = batched._M_HOST_PHASE.labels("delivery")

    def loop(k):
        out = {"logic": [], "dispatch": [], "collect": [], "delivery": []}
        for _ in range(k):
            d0, v0 = dict(phase), delivery.value
            _, t_logic = service_tick(rt, svc, clock)
            host_delivery = delivery.value - v0
            out["logic"].append(t_logic)
            out["dispatch"].append(phase["dispatch"] - d0["dispatch"])
            out["collect"].append(phase["deliver"] - d0["deliver"]
                                  - host_delivery)
            out["delivery"].append(host_delivery)
        return out

    loop(8)  # the storm and a warm-up
    torch.cuda.synchronize()
    result = profile_loop(loop, TICKS, "service_trace",
                          kernel="event_mask_kernel")
    prof = cProfile.Profile()
    prof.enable()
    loop(TICKS)
    prof.disable()
    text = io.StringIO()
    pstats.Stats(prof, stream=text).sort_stats("tottime").print_stats(15)
    print(text.getvalue())
    result["fuse_logic"] = fuse
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
