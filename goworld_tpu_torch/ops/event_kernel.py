"""The AOI event kernel: its CUDA wrapper, its plain PyTorch version, and
its launch counts.

Counterpart of ``goworld_tpu/ops/neighbor.py::_event_kernel`` in its single
and dual forms (``_compiled_event_kernel(p, ..., dual=False|True)``). The
kernel itself is ``csrc/event_kernel.cu``, built by ``_build`` at first use.

Input: the dense cell layout f32[S, rows+2, cols+2, 8, 128] with a halo
ring (``neighbor._scatter_feats``). Output: i32[S, rows, cols, 128, 72] in
the single form, i32[S, rows, cols, 128, 144] in the dual form, 16 candidate
bits per word: see the source's header for the predicate.

:func:`event_mask` takes the plain version only for a tensor on the CPU; on
a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from goworld_tpu_torch.ops import _build

LANES = 128  # query lanes per cell
_PACK = 16  # candidate bits per i32 word
_F = 8  # feature rows per cell
_W = 9 * LANES // _PACK  # words per mask row (72)

# Feature rows: epoch A = the epoch the grid is binned by, epoch B = the
# other one. Empty lanes hold NaN in every row.
_FX_A, _FZ_A, _FS_A, _FR_A = 0, 1, 2, 3
_FX_B, _FZ_B, _FS_B, _FR_B = 4, 5, 6, 7

# Cells per chunk of the plain version: ~250 MB of temporaries per chunk.
_CHUNK_CELLS = 64

FORMS = ("event_mask_single", "event_mask_dual")

# Launches of the CUDA kernel by form, counted where the kernel is launched
# and nowhere else (the plain version counts nothing).
launches = dict.fromkeys(FORMS, 0)


def reset_launch_counts() -> None:
    for form in FORMS:
        launches[form] = 0


def words(dual: bool) -> int:
    return _W * (2 if dual else 1)


def event_mask(cells: torch.Tensor, dual: bool,
               skip: torch.Tensor | None = None) -> torch.Tensor:
    """Packed event masks of every cell of ``cells``.

    ``skip`` is an optional one-element bool tensor on the same device: when
    it holds True the call does no work and the output is left unwritten
    (the engine's slow-tick launch on a tick that turned out fast), which
    lets the caller decide on the device without a host round trip."""
    if cells.device.type == "cpu":
        return event_mask_reference(cells, dual, skip)
    if cells.device.type != "cuda":
        raise ValueError(f"event_mask runs on cpu or cuda, got {cells.device}")
    _check_cells(cells)
    if skip is not None and (
        skip.dtype != torch.bool or skip.numel() != 1
        or skip.device != cells.device
    ):
        raise ValueError("skip must be one bool on the cells' device")
    s, rows, cols = cells.shape[0], cells.shape[1] - 2, cells.shape[2] - 2
    out = torch.empty(
        (s, rows, cols, LANES, words(dual)), dtype=torch.int32,
        device=cells.device,
    )
    with torch.cuda.device(cells.device):
        stream = torch.cuda.current_stream(cells.device).cuda_stream
        err = _library().gw_event_mask(
            cells.data_ptr(), out.data_ptr(),
            None if skip is None else skip.data_ptr(),
            s, rows, cols, int(dual), stream,
        )
    if err != 0:
        raise RuntimeError(f"event kernel launch failed: cudaError {err}")
    launches[FORMS[int(dual)]] += 1
    return out


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load_library("event_kernel")
    fn = lib.gw_event_mask
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return lib


def _check_cells(cells: torch.Tensor) -> None:
    if cells.dtype != torch.float32:
        raise ValueError(f"cells must be float32, got {cells.dtype}")
    if (cells.dim() != 5 or cells.shape[3] != _F or cells.shape[4] != LANES
            or cells.shape[1] < 3 or cells.shape[2] < 3):
        raise ValueError(
            f"cells must be [S, rows+2, cols+2, {_F}, {LANES}], "
            f"got {tuple(cells.shape)}"
        )
    if not cells.is_contiguous():
        raise ValueError("cells must be contiguous")


def event_mask_reference(cells: torch.Tensor, dual: bool,
                         skip: torch.Tensor | None = None) -> torch.Tensor:
    """The plain PyTorch version of the kernel: the same words, from tensor
    ops over chunks of cells, on whatever device ``cells`` lies on."""
    _check_cells(cells)
    dev = cells.device
    s, rows, cols = cells.shape[0], cells.shape[1] - 2, cells.shape[2] - 2
    out = torch.empty(
        (s, rows, cols, LANES, words(dual)), dtype=torch.int32, device=dev
    )
    if skip is not None and bool(skip):
        return out
    flat_out = out.view(s * rows * cols, LANES, words(dual))
    lane = torch.arange(LANES, device=dev)
    cidx = torch.arange(9 * LANES, device=dev)
    not_self = cidx[None, :] != (4 * LANES + lane)[:, None]  # [LANES, 9L]
    shifts = torch.arange(_PACK, dtype=torch.int32, device=dev)
    three = torch.arange(3, device=dev)

    def pack(mask):  # bool[C, LANES, 9L] -> i32[C, LANES, W]
        bits = mask.view(mask.shape[0], LANES, _W, _PACK).to(torch.int32)
        return (bits << shifts).sum(-1, dtype=torch.int32)

    for start in range(0, s * rows * cols, _CHUNK_CELLS):
        idx = torch.arange(
            start, min(start + _CHUNK_CELLS, s * rows * cols), device=dev
        )
        si = idx // (rows * cols)
        ii = (idx // cols) % rows
        jj = idx % cols
        blk = cells[
            si[:, None, None],
            (ii[:, None] + three)[:, :, None],
            (jj[:, None] + three)[:, None, :],
        ]  # [C, 3, 3, F, LANES]
        cand = blk.permute(0, 3, 1, 2, 4).reshape(-1, _F, 9 * LANES)
        q = blk[:, 1, 1]  # [C, F, LANES]

        def valid(fx, fz, fs, fr):
            # Empty lanes hold NaN x: d2 is NaN and NaN <= r2 is false.
            dx = cand[:, fx][:, None, :] - q[:, fx][:, :, None]
            dz = cand[:, fz][:, None, :] - q[:, fz][:, :, None]
            d2 = dx * dx + dz * dz
            r2 = (q[:, fr] * q[:, fr])[:, :, None]
            same = q[:, fs][:, :, None] == cand[:, fs][:, None, :]
            return same & (d2 <= r2) & not_self

        v_a = valid(_FX_A, _FZ_A, _FS_A, _FR_A)
        v_b = valid(_FX_B, _FZ_B, _FS_B, _FR_B)
        packed = [pack(v_a & ~v_b)]
        if dual:
            packed.append(pack(v_b & ~v_a))
        flat_out[idx] = torch.cat(packed, dim=-1)
    return out
