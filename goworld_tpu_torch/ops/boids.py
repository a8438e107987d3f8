"""Fused boids flocking step in PyTorch, the port of
``goworld_tpu.ops.boids``.

Agents are binned into grid cells of side ``cell_size`` and packed into the
dense per-cell layout f32[gz+2, gx+2, 8, 128] (x, z, vx, vz, valid, 3 spare
rows; 128 lanes a cell) with a wrapped halo ring, so every cell's 3x3
neighborhood is one block. The steering kernel (``ops/boids_kernel.py``)
reduces each agent's neighbors in that block to separation, alignment and
cohesion forces; the step then integrates with a speed clamp and wraps the
world to the grid torus. The JAX module's docstring has the design.

Backends:

- ``"kernel"``: the steering kernel through :func:`boids_accel`: the
  hand-written CUDA kernel on a CUDA device, its plain version on the CPU.
- ``"reference"``: the kernel's plain PyTorch version on any device.

The private functions keep the JAX module's names. Every tensor is made on
the engine's device, and a step never waits on the device.
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch

from goworld_tpu_torch.ops.boids_kernel import (
    LANES, _F, boids_accel, boids_accel_reference,
)
from goworld_tpu_torch.ops.neighbor import _f32, _slot_table

log = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class BoidsParams:
    """Static configuration of a boids engine (the same fields, defaults
    and validation as the JAX module's ``BoidsParams``)."""

    capacity: int = 65536  # max agents (N)
    cell_size: float = 100.0  # grid cell side; must be >= radius
    grid_x: int = 64
    grid_z: int = 64
    # Interaction radius; 0.0 = cell_size. Larger cells at a fixed radius
    # pack more agents into a cell's 128 lanes.
    radius: float = 0.0
    sep_frac: float = 0.3  # separation acts inside sep_frac * radius
    w_sep: float = 1.5
    w_align: float = 1.0
    w_coh: float = 1.0
    max_speed: float = 8.0
    max_accel: float = 2.0
    dt: float = 1.0

    def __post_init__(self) -> None:
        if self.radius > self.cell_size:
            # The 3x3 halo only covers one cell ring: a larger radius
            # would silently miss true neighbors.
            raise ValueError(
                f"radius {self.radius} exceeds cell_size {self.cell_size}"
            )

    @property
    def r_eff(self) -> float:
        return self.radius or self.cell_size

    @property
    def world_x(self) -> float:
        return self.grid_x * self.cell_size

    @property
    def world_z(self) -> float:
        return self.grid_z * self.cell_size


def params_from_reference(fields: dict) -> BoidsParams:
    """A port ``BoidsParams`` from ``dataclasses.asdict`` of a JAX one."""
    names = {f.name for f in dataclasses.fields(BoidsParams)}
    if set(fields) != names:
        raise ValueError(
            f"fields differ from BoidsParams: missing "
            f"{sorted(names - set(fields))}, unknown "
            f"{sorted(set(fields) - names)}"
        )
    return BoidsParams(**fields)


def _build_cells(p: BoidsParams, pos: torch.Tensor, vel: torch.Tensor,
                 active: torch.Tensor):
    """Pack agents into the dense per-cell layout.

    Returns (cells f32[gz+2, gx+2, F, LANES] wrap-padded, slot i32[N]) where
    ``slot`` is each agent's flat (cell, lane) address in the unpadded grid,
    -1 when it was dropped because its cell already held LANES agents. An
    empty lane carries agent N-1's x, z, vx and vz and a valid row of 0."""
    n = p.capacity
    dev = pos.device
    cell = _f32(p.cell_size, dev)
    cx = torch.remainder(torch.floor(pos[:, 0] / cell).to(torch.int32),
                         p.grid_x)
    cz = torch.remainder(torch.floor(pos[:, 1] / cell).to(torch.int32),
                         p.grid_z)
    num_buckets = p.grid_x * p.grid_z
    table, slot, _, _ = _slot_table(cz * p.grid_x + cx, active, n,
                                    num_buckets, LANES, LANES)
    flat_size = num_buckets * LANES
    safe = torch.clamp(table, max=n - 1).long()
    present = table < n

    valid = torch.where(present, active.to(torch.float32)[safe], 0.0)
    feats = torch.stack([pos[safe, 0], pos[safe, 1], vel[safe, 0],
                         vel[safe, 1], valid])  # [5, num_buckets*LANES]
    feats = torch.cat([feats, feats.new_zeros((_F - 5, flat_size))])
    cells = feats.view(_F, p.grid_z, p.grid_x, LANES).permute(1, 2, 0, 3)
    # Torus halo: one wrapped ring around the spatial dims.
    zi = torch.remainder(torch.arange(-1, p.grid_z + 1, device=dev), p.grid_z)
    xi = torch.remainder(torch.arange(-1, p.grid_x + 1, device=dev), p.grid_x)
    cells = cells[zi][:, xi].contiguous()
    return cells, slot


def _step(p: BoidsParams, backend: str, pos: torch.Tensor, vel: torch.Tensor,
          active: torch.Tensor):
    """One tick: (pos2, vel2, accel, dropped), all on ``pos``'s device."""
    dev = pos.device
    cells, slot = _build_cells(p, pos, vel, active)
    accel_fn = boids_accel if backend == "kernel" else boids_accel_reference
    accel_cells = accel_fn(cells, p)  # [gz, gx, 2, LANES]
    flat = accel_cells.permute(0, 1, 3, 2).reshape(-1, 2)
    ok = slot >= 0
    accel = torch.where(ok[:, None], flat[torch.clamp(slot, min=0).long()],
                        0.0)
    dropped = (active & ~ok).sum(dtype=torch.int32)

    vel2 = vel + accel * p.dt
    speed2 = (vel2 * vel2).sum(1, keepdim=True)
    clamp = torch.clamp(p.max_speed * torch.rsqrt(speed2 + 1e-12), max=1.0)
    vel2 = vel2 * clamp
    pos2 = pos + vel2 * p.dt
    world = torch.stack([_f32(p.world_x, dev), _f32(p.world_z, dev)])
    pos2 = torch.remainder(pos2, world)  # floor-mod, as jnp.mod
    return pos2, vel2, accel, dropped


class BoidsEngine:
    """Stateless-per-tick flocking stepper (positions in, positions out).

        eng = BoidsEngine(BoidsParams(capacity=51200))
        pos, vel, accel = eng.step(pos, vel, active)

    ``step`` takes numpy arrays or tensors [N, 2], [N, 2], [N] and returns
    tensors on the engine's device; feeding them back in keeps the loop on
    the device.

    ``device``: None means ``"cuda"``, and raises when no CUDA device is
    available; pass ``"cpu"`` to run the plain version on the CPU.
    ``backend``: ``"auto"`` picks ``"kernel"`` on CUDA and ``"reference"``
    elsewhere.
    """

    # Check the overflow counter once per this many ticks. The checked scalar
    # is a full interval old, so reading it never stalls the pipeline.
    DROP_CHECK_INTERVAL = 64

    def __init__(self, params: BoidsParams, backend: str = "auto",
                 device: str | torch.device | None = None):
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "BoidsEngine runs on CUDA unless told otherwise, and no "
                    "CUDA device is available; pass device='cpu' for the "
                    "plain version"
                )
            device = "cuda"
        self.device = torch.device(device)
        if backend == "auto":
            backend = "kernel" if self.device.type == "cuda" else "reference"
        if backend not in ("reference", "kernel"):
            raise ValueError(f"unknown backend {backend!r}")
        self.params = params
        self.backend = backend
        # Device scalar: active agents whose cell overflowed LANES this tick
        # (they get zero steering and are invisible to their neighbors).
        self.last_dropped: torch.Tensor | None = None
        self._tick = 0
        self._stale_dropped: torch.Tensor | None = None

    def step(self, pos, vel, active):
        """One tick; returns (pos, vel, accel) as tensors [N,2], [N,2], [N,2]
        on the engine's device."""
        dev = self.device
        pos2, vel2, accel, dropped = _step(
            self.params, self.backend,
            torch.as_tensor(pos, dtype=torch.float32, device=dev),
            torch.as_tensor(vel, dtype=torch.float32, device=dev),
            torch.as_tensor(active, dtype=torch.bool, device=dev),
        )
        self.last_dropped = dropped  # device scalar; int() it to inspect
        self._tick += 1
        if self._tick % self.DROP_CHECK_INTERVAL == 0:
            if self._stale_dropped is not None:
                n_dropped = int(self._stale_dropped)
                if n_dropped:
                    log.warning(
                        "boids cell overflow: %d active agents exceeded "
                        "LANES=%d occupants in their grid cell (zero "
                        "steering, invisible to neighbors); enlarge grid or "
                        "cell_size", n_dropped, LANES,
                    )
            self._stale_dropped = dropped
        return pos2, vel2, accel


def reference_accel(p: BoidsParams, pos, vel, active, rows=None) -> np.ndarray:
    """O(N^2) numpy oracle with the kernel's force semantics, in float64.

    Returns the acceleration of every agent [N, 2], or with ``rows`` (agent
    indices) of those agents only [len(rows), 2], so a sample of a large
    world stays cheap."""
    pos = np.asarray(pos, np.float64)
    vel = np.asarray(vel, np.float64)
    active = np.asarray(active, bool)
    rows = np.arange(len(pos)) if rows is None else np.asarray(rows)
    accel = np.zeros((len(rows), 2))
    wx, wz = p.world_x, p.world_z
    for k, i in enumerate(rows):
        if not active[i]:
            continue
        d = pos - pos[i]
        d[:, 0] -= wx * np.round(d[:, 0] / wx)
        d[:, 1] -= wz * np.round(d[:, 1] / wz)
        d2 = np.sum(d * d, axis=1)
        mask = active & (d2 <= p.r_eff**2)
        mask[i] = False
        if not mask.any():
            continue
        close = mask & (d2 < (p.r_eff * p.sep_frac) ** 2)
        inv = np.where(close, 1.0 / (d2 + 1e-6), 0.0)
        sep = -np.sum(d * inv[:, None], axis=0)
        align = vel[mask].mean(axis=0) - vel[i]
        coh = d[mask].mean(axis=0)
        a = p.w_sep * sep + p.w_align * align + p.w_coh * coh
        accel[k] = a * min(1.0, p.max_accel / np.sqrt(np.sum(a * a) + 1e-12))
    return accel
