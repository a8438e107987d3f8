"""Peaks of the card and the event kernel's least time, from shapes.

Copied from ``chip_smoke.py`` (``HBM_BYTES_PER_S``, ``FP32_OPS_PER_S``,
``OPS_PER_PAIR_EPOCH``, ``event_ops``, ``event_bound``) so that the yardstick
stays with the benchmark; the shapes are the configuration's, and the
occupancy comes from the benchmark's own positions.

Published peaks of one H100 SXM (NVIDIA's data sheet, at its 700 W power
limit): HBM3 at 3.35 TB/s, and 67 TFLOP/s in FP32 outside the tensor cores
with an FMA counted as two operations. The event kernel is built with
``--fmad=false`` and issues one FP32 instruction an operation, so its peak
is half that rate.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12 / 2
# FP32 operations a pair and epoch: 2 subtractions, 2 multiplications,
# 1 addition, 2 comparisons.
OPS_PER_PAIR_EPOCH = 7
LANES = 128  # query lanes a cell
FEATURES = 8  # feature rows a cell: (x, z, space, radius) of two epochs
WORDS = 9 * LANES // 16  # packed mask words a query row, one region


def event_bytes(spaces: int, grid_z: int, grid_x: int, dual: bool) -> int:
    """Bytes one launch moves at least: the cell layout
    f32[S, gz+2, gx+2, 8, 128] read once, the masks
    i32[S, gz, gx, 128, 72 (single) or 144 (dual)] written once."""
    cells = spaces * (grid_z + 2) * (grid_x + 2) * FEATURES * LANES * 4
    words = spaces * grid_z * grid_x * LANES * WORDS * (2 if dual else 1) * 4
    return cells + words


def event_ops(occ_a, occ_b) -> int:
    """FP32 operations a launch needs: in each epoch E, every query lane
    present in E against every candidate present in E in its 3x3 block of
    cells (torus-wrapped), 7 operations a pair. ``occ_a`` / ``occ_b``:
    int tensors [S, gz, gx] of the lanes present in each epoch."""
    import torch

    pairs = 0
    for occ in (occ_a, occ_b):
        block = sum(torch.roll(occ, (dz, dx), dims=(1, 2))
                    for dz in (-1, 0, 1) for dx in (-1, 0, 1))
        pairs += int((occ.to(torch.int64) * block.to(torch.int64)).sum())
    return pairs * OPS_PER_PAIR_EPOCH


def bound_s(n_bytes: int, ops: int) -> float:
    """The least time in seconds: the larger of the two rates' times."""
    return max(n_bytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S)
