"""The motion generator: the positions a game process hands its AOI engine
each tick.

A mix's file (``traffic/<mix>.json``) names this generator and sets:

- ``sigma``: each entity's velocity, drawn once from N(0, sigma) world
  units a tick on each axis (the root bench's law).

Motion reflects at the world's edges, so the density stays uniform however
long a run lasts.

The configuration gives the rows (``rows``), which of them are active
(``active_share``), the world's extent (the grid's cells times their
size), the AOI radius and the spaces. Rows start uniform over the world.

Everything comes from ``(seed, stream)``: the same pair gives the same
ticks. A stream is one process's rows (its rank), so the four processes of
a multi-process cell draw distinct rows from one seed.

Reflection is computed on an unfolded coordinate ``u`` kept in
``[0, 2W)``: the position is ``W - |W - u|``, which is ``u`` on the way
out and ``2W - u`` on the way back, and always inside ``[0, W]``.
"""

from __future__ import annotations

import numpy as np


class Traffic:
    """One process's rows and their motion. ``pos`` holds the positions of
    the last :meth:`advance`, ``prev`` those of the one before (the two
    buffers swap, so neither is copied a tick)."""

    def __init__(self, mix: dict, config: dict, rows: int, seed: int,
                 stream: int = 0):
        eng = config["engine"]
        self.world = np.array(
            [eng["grid_x"] * eng["cell_size"], eng["grid_z"] * eng["cell_size"]],
            np.float32)
        rng = np.random.default_rng([int(seed) % 2**63, int(stream)])
        n = int(rows)
        # Axis-major [2, n] state, so each pass runs over whole rows (a
        # [n, 2] array against a per-axis [2] one runs two at a time).
        self._w = self.world[:, None]
        self.u = np.ascontiguousarray(
            (rng.random((n, 2), dtype=np.float32) * self.world).T)
        vel = rng.normal(0.0, float(mix["sigma"]), (n, 2)).astype(np.float32)
        self.vel = np.ascontiguousarray(vel.T)
        n_active = int(round(float(config.get("active_share", 1.0)) * n))
        self.active = np.zeros(n, bool)
        self.active[rng.permutation(n)[:n_active]] = True
        n_spaces = int(config.get("spaces", 1))
        self.space = (np.arange(n) % n_spaces).astype(np.int32)
        self.radius = np.full(n, float(config["radius"]), np.float32)
        self.pos = np.empty((n, 2), np.float32)
        self.prev = np.empty((n, 2), np.float32)
        self._tmp = np.empty((2, n), np.float32)
        self._mask = np.empty((2, n), bool)
        self.period = 2.0 * self._w
        self._fold(self.pos)

    def _fold(self, out: np.ndarray) -> None:
        np.subtract(self._w, self.u, out=self._tmp)
        np.abs(self._tmp, out=self._tmp)
        np.subtract(self._w, self._tmp, out=out.T)

    def advance(self) -> np.ndarray:
        """The next tick's positions (``pos``); ``prev`` becomes the
        last tick's."""
        self.prev, self.pos = self.pos, self.prev
        np.add(self.u, self.vel, out=self.u)
        # Back into [0, 2W): a tick moves far less than 2W (np.remainder
        # is ten times slower than these four passes).
        np.greater_equal(self.u, self.period, out=self._mask)
        np.subtract(self.u, self.period, out=self.u, where=self._mask)
        np.less(self.u, 0.0, out=self._mask)
        np.add(self.u, self.period, out=self.u, where=self._mask)
        self._fold(self.pos)
        return self.pos
