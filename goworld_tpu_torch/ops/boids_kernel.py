"""The boids steering kernel: its CUDA wrapper, its plain PyTorch version,
and its launch count.

Counterpart of ``goworld_tpu/ops/boids.py::_boids_kernel``
(``_compiled_accel``). The kernel itself is ``csrc/boids_kernel.cu``, built
by ``_build`` at first use.

Input: the dense cell layout f32[gz+2, gx+2, 8, 128] with a wrapped halo ring
(``boids._build_cells``): x, z, vx, vz, valid, 3 spare rows. Output: the
clamped acceleration f32[gz, gx, 2, 128] of every lane; see the source's
header for the forces.

:func:`boids_accel` takes the plain version only for a tensor on the CPU; on
a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from goworld_tpu_torch.ops import _build

LANES = 128  # agents per cell
_F = 8  # feature rows per cell: x, z, vx, vz, valid, 3 spare

# Cells per chunk of the plain version, by device type: 4.7 MB per
# [C, 128, 1152] temporary on the CPU, where larger ones run slower; 38 MB on
# CUDA, where fewer chunks mean fewer launches.
_CHUNK_CELLS = {"cpu": 8, "cuda": 64}

# Launches of the CUDA kernel, counted where the kernel is launched and
# nowhere else (the plain version counts nothing).
launches = {"boids": 0}


def reset_launch_counts() -> None:  # gwlint: keep (chip_smoke.py zeroes it)
    launches["boids"] = 0


def step_constants(p) -> tuple[float, ...]:
    """The kernel's constants, rounded to f32 as the Pallas body rounds them:
    (world_x, world_z, r2, sep_r2, w_sep, w_align, w_coh, max_accel)."""
    return tuple(float(np.float32(v)) for v in (
        p.world_x, p.world_z, p.r_eff * p.r_eff, (p.r_eff * p.sep_frac) ** 2,
        p.w_sep, p.w_align, p.w_coh, p.max_accel,
    ))


def boids_accel(cells: torch.Tensor, p) -> torch.Tensor:
    """Clamped steering acceleration f32[gz, gx, 2, 128] of every lane of
    ``cells`` under the ``BoidsParams`` ``p``."""
    if cells.device.type == "cpu":
        return boids_accel_reference(cells, p)
    if cells.device.type != "cuda":
        raise ValueError(f"boids_accel runs on cpu or cuda, got {cells.device}")
    _check_cells(cells)
    gz, gx = cells.shape[0] - 2, cells.shape[1] - 2
    out = torch.empty((gz, gx, 2, LANES), dtype=torch.float32,
                      device=cells.device)
    with torch.cuda.device(cells.device):
        stream = torch.cuda.current_stream(cells.device).cuda_stream
        err = _library().gw_boids_accel(
            cells.data_ptr(), out.data_ptr(), gz, gx, *step_constants(p),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"boids kernel launch failed: cudaError {err}")
    launches["boids"] += 1
    return out


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load_library("boids_kernel")
    fn = lib.gw_boids_accel
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        *[ctypes.c_float] * 8,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return lib


def _check_cells(cells: torch.Tensor) -> None:
    if cells.dtype != torch.float32:
        raise ValueError(f"cells must be float32, got {cells.dtype}")
    if (cells.dim() != 4 or cells.shape[2] != _F or cells.shape[3] != LANES
            or cells.shape[0] < 3 or cells.shape[1] < 3):
        raise ValueError(
            f"cells must be [gz+2, gx+2, {_F}, {LANES}], "
            f"got {tuple(cells.shape)}"
        )
    if not cells.is_contiguous():
        raise ValueError("cells must be contiguous")


def halo_pairs(cells: torch.Tensor, idx: torch.Tensor, p):
    """The 3x3 halo pairs of the cells ``idx`` (flat over [gz, gx]):
    (q f32[C, F, 128], cand f32[C, F, 1152], dx, dz, d2, neighbor), the last
    four [C, 128, 1152], ``neighbor`` the kernel's predicate."""
    dev = cells.device
    gx = cells.shape[1] - 2
    wx, wz, r2 = step_constants(p)[:3]
    # Tensor divisors: CUDA divides by a Python scalar through its
    # reciprocal, which moves the image at |dx| = w/2.
    wx_t = torch.full((), wx, dtype=torch.float32, device=dev)
    wz_t = torch.full((), wz, dtype=torch.float32, device=dev)
    three = torch.arange(3, device=dev)
    ii = idx // gx
    jj = idx % gx
    blk = cells[
        (ii[:, None] + three)[:, :, None],
        (jj[:, None] + three)[:, None, :],
    ]  # [C, 3, 3, F, LANES]
    cand = blk.permute(0, 3, 1, 2, 4).reshape(-1, _F, 9 * LANES)
    q = blk[:, 1, 1]
    dx = cand[:, 0][:, None, :] - q[:, 0][:, :, None]
    dz = cand[:, 1][:, None, :] - q[:, 1][:, :, None]
    dx = dx - wx * torch.round(dx / wx_t)  # round: half to even, as jnp's
    dz = dz - wz * torch.round(dz / wz_t)
    d2 = dx * dx + dz * dz
    lane = torch.arange(LANES, device=dev)
    not_self = torch.arange(9 * LANES, device=dev)[None, :] != (
        4 * LANES + lane)[:, None]
    neighbor = ((q[:, 4][:, :, None] > 0.0) & (cand[:, 4][:, None, :] > 0.0)
                & (d2 <= r2) & not_self)
    return q, cand, dx, dz, d2, neighbor


def boids_accel_reference(cells: torch.Tensor, p) -> torch.Tensor:
    """The plain PyTorch version of the kernel: the Pallas body's tensor
    ops over chunks of cells, on whatever device ``cells`` lies on."""
    _check_cells(cells)
    dev = cells.device
    gz, gx = cells.shape[0] - 2, cells.shape[1] - 2
    _, _, _, sep_r2, w_sep, w_align, w_coh, max_accel = step_constants(p)
    out = torch.empty((gz, gx, 2, LANES), dtype=torch.float32, device=dev)
    flat_out = out.view(gz * gx, 2, LANES)
    chunk = _CHUNK_CELLS[dev.type]
    for start in range(0, gz * gx, chunk):
        idx = torch.arange(start, min(start + chunk, gz * gx), device=dev)
        q, cand, dx, dz, d2, neighbor = halo_pairs(cells, idx, p)
        vf = neighbor.to(torch.float32)
        count = vf.sum(2)
        has_n = count > 0.0
        inv_count = torch.where(has_n, 1.0 / torch.clamp(count, min=1.0), 0.0)
        close = vf * (d2 < sep_r2).to(torch.float32)
        inv_d2 = close / (d2 + 1e-6)
        sep_x = -(dx * inv_d2).sum(2)
        sep_z = -(dz * inv_d2).sum(2)
        align_x = ((cand[:, 2][:, None, :] * vf).sum(2) * inv_count
                   - q[:, 2]) * has_n
        align_z = ((cand[:, 3][:, None, :] * vf).sum(2) * inv_count
                   - q[:, 3]) * has_n
        coh_x = (dx * vf).sum(2) * inv_count
        coh_z = (dz * vf).sum(2) * inv_count
        ax = w_sep * sep_x + w_align * align_x + w_coh * coh_x
        az = w_sep * sep_z + w_align * align_z + w_coh * coh_z
        a2 = ax * ax + az * az
        scale = torch.clamp(max_accel * torch.rsqrt(a2 + 1e-12), max=1.0)
        flat_out[idx] = torch.stack([ax * scale, az * scale], dim=1)
    return out
