"""The comparison that decides ``correct``.

Each checked tick's enter and leave pairs, as each process received them,
are held against :mod:`interest` recomputed from the tick's generated
positions and the tick's before. A process owns a range of rows, and its
pairs must be exactly the reference's pairs whose querying entity lies in
that range (row ownership); the single-process engine owns every row.

The numbers compared, each with its limit (an exact comparison, so 0):

- ``pairs_wrong``: pairs missing, extra or repeated, over every checked
  tick and process;
- ``dropped_wrong``: the sum of the differences between each process's
  reported grid-capacity drops and the reference's;
- ``ticks_checked``: at least 2 (the set-up's paged storm and the window's
  last tick are always checked).
"""

from __future__ import annotations

import numpy as np
import torch

from gwbench.reference import interest as ref

LIMITS = {"pairs_wrong": 0, "dropped_wrong": 0}
MIN_TICKS = 2


def _grid(config: dict) -> dict:
    e = config["engine"]
    return dict(cell_size=float(e["cell_size"]), grid_x=int(e["grid_x"]),
                grid_z=int(e["grid_z"]),
                cell_capacity=int(e["cell_capacity"]))


def _tensor(a, dtype, device):
    return torch.as_tensor(np.ascontiguousarray(a), device=device).to(dtype)


def reference_events(tick: dict, config: dict, device,
                     dtype=torch.float32):
    """(enter keys, leave keys, dropped) of one tick of the whole world,
    the distance test run in ``dtype``."""
    g = _grid(config)
    space = _tensor(tick["space"], torch.int64, device)
    radius = _tensor(tick["radius"], torch.float32, device)
    before, _ = ref.interest(
        _tensor(tick["prev"], torch.float32, device),
        _tensor(tick["prev_active"], torch.bool, device), space, radius,
        dtype=dtype, **g)
    now, dropped = ref.interest(
        _tensor(tick["pos"], torch.float32, device),
        _tensor(tick["active"], torch.bool, device), space, radius,
        dtype=dtype, **g)
    enters, leaves = ref.diff(before, now)
    return enters, leaves, dropped


def mismatch(got, want) -> int:
    """Pairs of ``got`` (keys) missing from ``want``, extra in it, or
    repeated."""
    uniq = torch.unique(got)
    repeated = len(got) - len(uniq)
    extra = int((~torch.isin(uniq, want, assume_unique=True)).sum())
    missing = int((~torch.isin(want, uniq, assume_unique=True)).sum())
    return repeated + extra + missing


def compare(ticks: list[dict], config: dict, device,
            program_dtype=None) -> dict:
    """The compared numbers over ``ticks``. Each tick holds the world's
    ``prev``/``pos``/``prev_active``/``active``/``space``/``radius`` and
    ``parts``: one ``(lo, hi, enters, leaves, dropped)`` per process, its
    rows ``[lo, hi)`` and what it received.

    ``program_dtype`` set: the control. The reference computed in that
    precision stands in the program's place, for every part."""
    wrong = dropped_wrong = events = 0
    for tick in ticks:
        n = len(tick["pos"])
        enters, leaves, dropped = reference_events(tick, config, device)
        if program_dtype is not None:
            c_ent, c_lv, c_drop = reference_events(tick, config, device,
                                                   program_dtype)
        for lo, hi, p_ent, p_lv, p_drop in tick["parts"]:
            def own(keys):
                q = keys // n
                return keys[(q >= lo) & (q < hi)]

            if program_dtype is not None:
                got_e, got_l, p_drop = own(c_ent), own(c_lv), c_drop
            else:
                got_e = ref.pair_keys(p_ent, n, device)
                got_l = ref.pair_keys(p_lv, n, device)
            want_e, want_l = own(enters), own(leaves)
            wrong += mismatch(got_e, want_e) + mismatch(got_l, want_l)
            dropped_wrong += abs(int(p_drop) - dropped)
            events += len(want_e) + len(want_l)
    return {"pairs_wrong": wrong, "dropped_wrong": dropped_wrong,
            "ticks_checked": len(ticks), "events_checked": events}


def verdict(numbers: dict) -> tuple[bool, dict]:
    """(correct, each compared number beside its limit)."""
    shown = {k: {"value": numbers[k], "limit": v} for k, v in LIMITS.items()}
    shown["ticks_checked"] = {"value": numbers["ticks_checked"],
                              "at_least": MIN_TICKS}
    ok = all(numbers[k] <= v for k, v in LIMITS.items()) and (
        numbers["ticks_checked"] >= MIN_TICKS)
    return ok, shown
