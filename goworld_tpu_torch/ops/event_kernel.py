"""The AOI event kernel: its CUDA wrapper, its plain PyTorch version, and
its launch counts.

Counterpart of ``goworld_tpu/ops/neighbor.py::_event_kernel`` in all its
forms: single and dual (``_compiled_event_kernel(p, ..., dual=False|True)``),
and each of them with the in-kernel drain (``drain_inline=D``). The kernel
itself is ``csrc/event_kernel.cu``, built by ``_build`` at first use.

Input: the dense cell layout f32[S, rows+2, cols+2, 8, 128] with a halo
ring (``neighbor._scatter_feats``). Output: i32[S, rows, cols, 128, 72] in
the single form, i32[S, rows, cols, 128, 144] in the dual form, 16 candidate
bits per word: see the source's header for the predicate. The drain forms
(:func:`event_drain`) take a second input, the slot/own plane
i32[S, rows+2, cols+2, 2, 128], and also return the compacted pairs block
i32[2, D+1] (single) or i32[2, 2D+1] (dual).

:func:`event_mask` and :func:`event_drain` take the plain version only for
a tensor on the CPU; on a CUDA tensor they launch the kernel or raise.
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

# Query lanes per chunk of the plain versions: ~250 MB of temporaries.
_CHUNK_QUERIES = 4096

FORMS = ("event_mask_single", "event_mask_dual")
DRAIN_FORMS = ("event_drain_single", "event_drain_dual")

# Launches of the CUDA kernel by form, counted where the kernel is launched
# and nowhere else (the plain version counts nothing).
launches = dict.fromkeys(FORMS + DRAIN_FORMS, 0)


def reset_launch_counts() -> None:  # gwlint: keep (chip_smoke.py zeroes it)
    for form in launches:
        launches[form] = 0


def register_launch_gauge() -> None:
    """Export ``launches`` as the gauge ``event_kernel_launches{form}``,
    read where a scraper or a history frame samples it."""
    from goworld_tpu_torch import telemetry

    gauge = telemetry.gauge(
        "event_kernel_launches",
        "Launches of each event-kernel form in this process.", ("form",))
    for form in launches:
        gauge.labels(form).set_function(lambda f=form: launches[f])


def words_per_row(dual: bool) -> int:
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
    _check_skip(skip, cells.device)
    s, rows, cols = cells.shape[0], cells.shape[1] - 2, cells.shape[2] - 2
    out = torch.empty(
        (s, rows, cols, LANES, words_per_row(dual)), dtype=torch.int32,
        device=cells.device,
    )
    # The record names the launch after the C entry point in a
    # torch.profiler trace (its device kernel is event_mask_kernel).
    with torch.cuda.device(cells.device), \
            torch.profiler.record_function("gw_event_mask"):
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


def event_drain(cells: torch.Tensor, plane: torch.Tensor, dual: bool,
                drain: int, capacity: int,
                skip: torch.Tensor | None = None):
    """The drain form: the packed masks of :func:`event_mask`, plus the
    (query slot, other slot) pair of every event whose query lane is OWN
    (``plane[..., 1, lane] > 0`` at the centre cell), compacted in the
    TPU kernel's emission order: cell-major over (s, i, j), then query
    lane, then candidate ``c = (3*di + dj)*128 + lane`` ascending.

    Returns (words, pairs): ``pairs`` is i32[2, cap+1] with cap = ``drain``
    (single) or ``2*drain`` (dual), row 0 the query slot and row 1 the
    other slot (both read from plane 0), prefilled with ``capacity``.
    Enters fill columns [0, drain); in the dual form leaves fill
    [drain, 2*drain). Events past a region's end are not written. The last
    column is the TPU kernel's trash column: the port never writes it, and
    callers read only the regions. ``skip`` as in :func:`event_mask`: both
    outputs are left unwritten."""
    if cells.device.type == "cpu":
        return event_drain_reference(cells, plane, dual, drain, capacity,
                                     skip)
    if cells.device.type != "cuda":
        raise ValueError(f"event_drain runs on cpu or cuda, got {cells.device}")
    _check_cells(cells)
    _check_plane(plane, cells)
    _check_skip(skip, cells.device)
    if drain <= 0:
        raise ValueError(f"drain must be positive, got {drain}")
    s, rows, cols = cells.shape[0], cells.shape[1] - 2, cells.shape[2] - 2
    n_cells = s * rows * cols
    dev = cells.device
    words = torch.empty((s, rows, cols, LANES, words_per_row(dual)),
                        dtype=torch.int32, device=dev)
    pairs = torch.empty((2, drain * (2 if dual else 1) + 1),
                        dtype=torch.int32, device=dev)
    # Scratch: per-cell own-lane event counts, then their exclusive scan.
    counts = torch.empty((n_cells, 2), dtype=torch.int32, device=dev)
    offsets = torch.empty((n_cells, 2), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev), \
            torch.profiler.record_function("gw_event_drain"):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _library().gw_event_drain(
            cells.data_ptr(), plane.data_ptr(), words.data_ptr(),
            pairs.data_ptr(), counts.data_ptr(), offsets.data_ptr(),
            None if skip is None else skip.data_ptr(),
            s, rows, cols, int(dual), drain, capacity, stream,
        )
    if err != 0:
        raise RuntimeError(f"event drain kernel launch failed: cudaError {err}")
    launches[DRAIN_FORMS[int(dual)]] += 1
    return words, pairs


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
    fn = lib.gw_event_drain
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _check_skip(skip: torch.Tensor | None, device: torch.device) -> None:
    if skip is not None and (
        skip.dtype != torch.bool or skip.numel() != 1
        or skip.device != device
    ):
        raise ValueError("skip must be one bool on the cells' device")


def _check_plane(plane: torch.Tensor, cells: torch.Tensor) -> None:
    want = cells.shape[:3] + (2, LANES)
    if plane.dtype != torch.int32 or tuple(plane.shape) != tuple(want):
        raise ValueError(
            f"plane must be int32 {tuple(want)}, got {plane.dtype} "
            f"{tuple(plane.shape)}"
        )
    if plane.device != cells.device or not plane.is_contiguous():
        raise ValueError("plane must be contiguous, on the cells' device")


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
    ops over chunks of query lanes, on whatever device ``cells`` lies on.

    Only occupied query lanes are evaluated: a lane whose x is NaN in both
    epochs is valid with no candidate, so its words stay zero."""
    _check_cells(cells)
    dev = cells.device
    s, rows, cols = cells.shape[0], cells.shape[1] - 2, cells.shape[2] - 2
    n_words = words_per_row(dual)
    if skip is not None and bool(skip):
        return torch.empty((s, rows, cols, LANES, n_words),
                           dtype=torch.int32, device=dev)
    out = torch.zeros((s, rows, cols, LANES, n_words), dtype=torch.int32,
                      device=dev)
    flat_out = out.view(-1, n_words)  # [cell * LANES + lane, words]
    centre = cells[:, 1:-1, 1:-1]
    occupied = ~(torch.isnan(centre[..., _FX_A, :])
                 & torch.isnan(centre[..., _FX_B, :]))
    queries = torch.nonzero(occupied.reshape(-1)).reshape(-1)
    cidx = torch.arange(9 * LANES, device=dev)
    shifts = torch.arange(_PACK, dtype=torch.int32, device=dev)
    three = torch.arange(3, device=dev)

    def pack(mask):  # bool[K, 9L] -> i32[K, W]
        bits = mask.view(mask.shape[0], _W, _PACK).to(torch.int32)
        return (bits << shifts).sum(-1, dtype=torch.int32)

    for start in range(0, len(queries), _CHUNK_QUERIES):
        qi = queries[start:start + _CHUNK_QUERIES]
        lane = qi % LANES
        cell, inv = torch.unique(qi // LANES, return_inverse=True)
        si = cell // (rows * cols)
        ii = (cell // cols) % rows
        jj = cell % cols
        blk = cells[
            si[:, None, None],
            (ii[:, None] + three)[:, :, None],
            (jj[:, None] + three)[:, None, :],
        ]  # [U, 3, 3, F, LANES]
        cand = blk.permute(0, 3, 1, 2, 4).reshape(-1, _F, 9 * LANES)
        q = blk[inv, 1, 1, :, lane]  # [K, F]
        not_self = cidx[None, :] != (4 * LANES + lane)[:, None]

        def valid(fx, fz, fs, fr):
            # Empty lanes hold NaN x: d2 is NaN and NaN <= r2 is false.
            dx = cand[inv, fx] - q[:, fx, None]
            dz = cand[inv, fz] - q[:, fz, None]
            d2 = dx * dx + dz * dz
            r2 = (q[:, fr] * q[:, fr])[:, None]
            same = q[:, fs, None] == cand[inv, fs]
            return same & (d2 <= r2) & not_self

        v_a = valid(_FX_A, _FZ_A, _FS_A, _FR_A)
        v_b = valid(_FX_B, _FZ_B, _FS_B, _FR_B)
        packed = [pack(v_a & ~v_b)]
        if dual:
            packed.append(pack(v_b & ~v_a))
        flat_out[qi] = torch.cat(packed, dim=-1)
    return out


def event_drain_reference(cells: torch.Tensor, plane: torch.Tensor,
                          dual: bool, drain: int, capacity: int,
                          skip: torch.Tensor | None = None):
    """The plain PyTorch version of the drain form: the words of
    :func:`event_mask_reference`; then, per region, the own query rows
    with events in (cell, lane) order, unpacked to candidate bits a chunk
    at a time. ``torch.nonzero``'s row-major order over (row, candidate)
    is the emission order, so the first ``drain`` hits are the region's
    pairs."""
    _check_cells(cells)
    _check_plane(plane, cells)
    dev = cells.device
    n_regions = 2 if dual else 1
    words = event_mask_reference(cells, dual, skip)
    if skip is not None and bool(skip):
        return words, torch.empty((2, drain * n_regions + 1),
                                  dtype=torch.int32, device=dev)
    pairs = torch.full((2, drain * n_regions + 1), capacity,
                       dtype=torch.int32, device=dev)
    s, rows, cols = words.shape[:3]
    flat = words.view(-1, words_per_row(dual))  # [cell * LANES + lane, W]
    slots = plane[:, :, :, 0]  # [S, rows+2, cols+2, LANES]
    own = (plane[:, 1:-1, 1:-1, 1] > 0).reshape(-1)
    shifts = torch.arange(_PACK, dtype=torch.int32, device=dev)
    for r in range(n_regions):
        region = flat[:, r * _W:(r + 1) * _W]
        emitting = torch.nonzero(own & (region != 0).any(1)).reshape(-1)
        filled = 0
        for start in range(0, len(emitting), _CHUNK_QUERIES):
            if filled >= drain:
                break
            qi = emitting[start:start + _CHUNK_QUERIES]
            bits = ((region[qi][..., None] >> shifts) & 1).bool()
            hit = torch.nonzero(bits.view(len(qi), 9 * LANES))
            hit = hit[:drain - filled]  # (row in chunk, candidate)
            row = qi[hit[:, 0]]
            cell = row // LANES
            si = cell // (rows * cols)
            ii = (cell // cols) % rows
            jj = cell % cols
            hc = hit[:, 1] // LANES
            col = slice(r * drain + filled, r * drain + filled + len(hit))
            pairs[0, col] = slots[si, ii + 1, jj + 1, row % LANES]
            pairs[1, col] = slots[si, ii + hc // 3, jj + hc % 3,
                                  hit[:, 1] % LANES]
            filled += len(hit)
    return words, pairs
