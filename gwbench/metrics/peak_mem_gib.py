"""The largest ``torch.cuda.max_memory_allocated()`` of the run, set-up
included, over the cell's cards, in GiB."""


def read(run):
    peak = max(int(p["peak_bytes"]) for p in run.procs)
    return peak / 2**30 if peak else None
