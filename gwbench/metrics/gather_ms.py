"""Layer: the process gather (``parallel.multihost``, the all-gather of
every process's rows over NCCL). The device's milliseconds in NCCL's
all-gather kernels a tick in the traced stretch, the largest of the
ranks; ``torch.profiler``. The kernel runs from the first rank's arrival
to the last one's data, so a rank that waits for a peer counts the wait.
Moves ``entity_updates_per_s``."""

KERNELS = ("AllGather",)


def read(run):
    per_rank = []
    for p in run.profiles():
        s = sum(t for name, t in p["ops"].items()
                if "nccl" in name.lower() and any(k in name for k in KERNELS))
        if s > 0:
            per_rank.append(s / p["ticks"] * 1e3)
    return max(per_rank) if per_rank else None
