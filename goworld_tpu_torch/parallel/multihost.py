"""Multi-process sharded AOI, the port of ``goworld_tpu.parallel.multihost``.

Several processes (a deployment's game processes, or hosts) step ONE
entity-sharded world together. Each process owns a contiguous slab of
entity rows, ``[local_lo, local_lo + local_capacity)``, and a list of local
shards (its mesh, ``parallel.mesh.make_mesh``); the global shard count is
world size x local shards and the same on every process.

The JAX module runs one SPMD program across the processes
(multi-controller ``shard_map``), so every process must dispatch every
global computation, including each storm page. PyTorch has no such program.
Here the only cross-process traffic is one gather, over
``torch.distributed``, of every process's host rows before upload; after
it each process holds the whole world, uploads it to its own devices, and
runs the entity-sharded programs of ``parallel.mesh`` for its OWN shards
only: the all-gather program (backend ``"reference"``) or the slab-kernel
program (backend ``"kernel"``). Paging needs no peer: a process pages its
own shards from its own counts.

What a process receives: under ``"reference"`` exactly the events of its
own entity rows (row ownership, what a game process delivers); under
``"kernel"`` the events of the entities binned in its shards' slabs of
grid rows (cell ownership, as the JAX module says of its Pallas path).
The union over the processes is the single-device engine's stream either
way.

The gather runs on the Gloo backend over CPU tensors: it works when every
process shares one card (NCCL refuses two ranks on one GPU). It is started
asynchronously in ``step_async``, so a process that dispatched ahead of a
peer does not block: ``MultiHostPendingStep.is_ready`` stays False until
every peer has dispatched the same tick (as the JAX step's collective is
not ready until every process joins it), and the device step launches when
the gather is seen complete. ``collect`` waits for it.

Bootstrap: :func:`init_multihost` on every process, then the same engine
construction on every process with identical params.
"""

from __future__ import annotations

import datetime
import time

import numpy as np
import torch
import torch.distributed as dist

from goworld_tpu_torch.ops.neighbor import (
    NeighborParams,
    check_radius,
    check_space_ids,
    upload,
)
from goworld_tpu_torch.parallel.mesh import (
    _WORLDS,
    ALLGATHER_ROW_BYTES,
    _M_ALLGATHER_EQUIV,
    _M_ALLGATHER_TOTAL,
    _M_LINK_BYTES,
    ShardedPendingStep,
    _pack_blocks,
    _page_shards,
    _shard_steps,
    check_mesh_params,
    make_mesh,
)
from goworld_tpu_torch.telemetry import sentinel

# Seconds a join, or a collective, may wait on a peer before it raises.
DEFAULT_TIMEOUT_S = 120.0

# The process group's key-value store (the flush alignment's channel,
# entity/aoi/batched.py), set by init_multihost.
_STORE: dist.Store | None = None

# Columns of one host row in the gather, as int32 words: x, z (float32
# bits), active, space, radius (float32 bits).
_ROW_WORDS = 5


def init_multihost(coordinator_address: str, num_processes: int,
                   process_id: int,
                   timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join the process group of ``num_processes`` processes as rank
    ``process_id``, over Gloo, with ``coordinator_address`` ("host:port")
    as the rendezvous: process 0 serves the key-value store there, as the
    ``tcp://`` init method does. Blocks until every process joined, at most
    ``timeout_s``, which also bounds every later collective. The store is
    kept for the service's flush alignment (:func:`store`)."""
    global _STORE
    host, port = coordinator_address.rsplit(":", 1)
    timeout = datetime.timedelta(seconds=timeout_s)
    kv = dist.TCPStore(host, int(port), num_processes,
                       is_master=process_id == 0, timeout=timeout)
    dist.init_process_group("gloo", store=kv, rank=process_id,
                            world_size=num_processes, timeout=timeout)
    _STORE = kv


def store() -> dist.Store | None:
    """The store of :func:`init_multihost`, or None outside a group."""
    return _STORE


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _pack_rows(pos, active, space, radius) -> torch.Tensor:
    """This process's rows as int32 [rows, 5] (float bits kept)."""
    rows = np.empty((len(pos), _ROW_WORDS), np.int32)
    rows[:, 0:2] = np.ascontiguousarray(pos, np.float32).view(np.int32)
    rows[:, 2] = np.asarray(active, bool)
    rows[:, 3] = np.asarray(space, np.int32)
    rows[:, 4] = np.ascontiguousarray(radius, np.float32).view(np.int32)
    return torch.from_numpy(rows)


def _unpack_rows(rows: np.ndarray) -> tuple:
    """(pos f32 [N, 2], active bool, space i32, radius f32) of the gathered
    int32 rows."""
    return (
        np.ascontiguousarray(rows[:, 0:2]).view(np.float32),
        rows[:, 2] != 0,
        np.ascontiguousarray(rows[:, 3]),
        np.ascontiguousarray(rows[:, 4]).view(np.float32),
    )


class MultiHostPendingStep:
    """In-flight multi-process tick: the gather of every process's rows,
    then this process's shards' step, a ``parallel.mesh.ShardedPendingStep``
    over the local shards' blocks to which ``collect`` and the device part
    of ``is_ready`` and ``wait_device`` go. ``collect()`` reads only LOCAL
    shards.

    After the step launched, ``gather_ms`` holds the milliseconds from the
    gather's start (in ``step_async``) to its completion as this process
    saw it: with a peer behind, mostly the wait for that peer's dispatch.

    A gather that failed (a peer left the group) is never ready: the game
    loop frame-skips and its wedge watchdog warns, as with a JAX collective
    a dead peer never joins, and the flush abandons the step at its
    deadline; ``collect`` raises the failure. A step that failed to launch
    after the gather (a device error, a bug) raises from ``is_ready`` as
    well as from ``collect``, and from the engine's next ``step_async``."""

    __slots__ = ("_engine", "_work", "_parts", "_t0", "_step", "_error",
                 "_gather_failed", "gather_ms")

    def __init__(self, engine, work, parts: list) -> None:
        self._engine = engine
        self._work = work
        self._parts = parts
        self._t0 = time.perf_counter()
        self._step: ShardedPendingStep | None = None
        self._error: BaseException | None = None
        self._gather_failed = False
        self.gather_ms = None

    def _launch(self) -> None:
        """Finish the gather (waiting for it) and dispatch the step."""
        if self._step is not None:
            return
        if self._error is not None:
            raise self._error
        try:
            self._work.wait()
        except RuntimeError as exc:  # the gather failed: a peer left
            self._error = exc
            self._gather_failed = True
            raise
        self.gather_ms = (time.perf_counter() - self._t0) * 1000.0
        try:
            self._step = self._engine._launch(
                _unpack_rows(torch.cat(self._parts).numpy()))
        except BaseException as exc:
            self._error = exc
            raise
        self._parts = None

    def is_ready(self) -> bool:
        """True when collect() will not block: every peer has dispatched
        this tick and the local step has computed."""
        if self._step is None:
            if self._gather_failed or (
                    self._error is None and not self._work.is_completed()):
                return False
            try:
                self._launch()
            except RuntimeError:
                if self._gather_failed:
                    return False
                raise
        return self._step.is_ready()

    def wait_device(self) -> None:
        """Block until the gather and the local step are done."""
        self._launch()
        self._step.wait_device()

    def collect(self) -> tuple[np.ndarray, np.ndarray, int]:
        """(local_enters, local_leaves, dropped), pairs with global ids: the
        events of this process's own shards. One blocking read, then the
        local shards' storm paging."""
        self._launch()
        return self._step.collect()


class MultiHostNeighborEngine:
    """Per-process handle on the multi-process engine.

    Every process constructs it with identical params and the same number
    of local shards, and steps it with its LOCAL entity rows
    ``[local_lo, local_lo + local_capacity)``. ``mesh``: this process's
    local shards (None: one shard on the current CUDA device).
    ``backend``: ``"reference"`` (row ownership) or ``"kernel"`` (cell
    ownership; grid_z a multiple of the global shard count), see the
    module docstring.

    The packed block of a local shard keeps the JAX layout, [3 + D + 2E,
    2]: the header rows, D counts rows, the inline pairs. Its counts rows
    hold THIS process's shards' (enters, leaves) at their global shard
    index and zeros for every other process's shards: no peer's counts are
    needed, since a process pages only its own shards.
    """

    def __init__(self, params: NeighborParams, mesh=None,
                 backend: str = "reference"):
        if not dist.is_initialized():
            raise RuntimeError(
                "MultiHostNeighborEngine needs a process group: call "
                "init_multihost first")
        if backend not in ("reference", "kernel"):
            raise ValueError(f"unknown backend {backend!r}")
        if mesh is None:
            mesh = make_mesh(1)
        mesh = [torch.device(d) for d in mesh]
        world = dist.get_world_size()
        rank = dist.get_rank()
        # Every process must bring the same number of shards: one gather at
        # construction, where every process builds its engine.
        counts = [torch.zeros(1, dtype=torch.int64) for _ in range(world)]
        dist.all_gather(counts, torch.tensor([len(mesh)], dtype=torch.int64))
        if {int(c) for c in counts} != {len(mesh)}:
            raise ValueError(
                f"processes bring {[int(c) for c in counts]} local shards; "
                f"every process must bring the same number")
        n_local = len(mesh)
        n_dev = world * n_local
        check_mesh_params(params, n_dev, backend)
        self.params = params
        self.mesh = mesh
        self.backend = backend
        self.n_devices = n_dev
        self.n_processes = world
        self.process_index = rank
        self.chunk = params.capacity // n_dev
        self.events_inline = params.max_events // n_dev
        self.shards = [rank * n_local + k for k in range(n_local)]
        self.local_lo = self.shards[0] * self.chunk
        self.local_capacity = n_local * self.chunk
        self.allgather_bytes_per_tick = (
            n_dev * (params.capacity - self.chunk) * ALLGATHER_ROW_BYTES)
        _M_ALLGATHER_EQUIV.set(self.allgather_bytes_per_tick)
        # This process's slice of the structural all-gather: its shards
        # pull each other's rows locally and every remote shard's rows
        # through the process gather.
        host = f"host{rank}"
        self._ici_bytes = (n_local * (n_local - 1) * self.chunk
                           * ALLGATHER_ROW_BYTES)
        self._dcn_bytes = (n_local * (n_dev - n_local) * self.chunk
                           * ALLGATHER_ROW_BYTES)
        self._m_link_ici = _M_LINK_BYTES.labels("ici-allgather", host)
        self._m_link_dcn = _M_LINK_BYTES.labels("dcn-allgather", host)
        self._state: dict | None = None
        self._unlaunched: MultiHostPendingStep | None = None
        self.last_grid_dropped = 0

    def _upload_world(self, arrays: tuple) -> dict:
        """(pos, active, space, radius) host arrays on each local device."""
        dtypes = (np.float32, np.bool_, np.int32, np.float32)
        return {dev: tuple(upload(a, dt, dev) for a, dt in zip(arrays,
                                                              dtypes))
                for dev in dict.fromkeys(self.mesh)}

    def reset(self) -> None:
        """An all-inactive previous tick on every process."""
        n = self.params.capacity
        self._state = self._upload_world((
            np.zeros((n, 2), np.float32), np.zeros(n, bool),
            np.zeros(n, np.int32), np.zeros(n, np.float32)))

    def carried_epoch(self) -> tuple:
        """The last launched world (every process's rows) as numpy."""
        if self._state is None:
            raise RuntimeError("call reset() first")
        if self._unlaunched is not None:
            self._unlaunched._launch()
        return tuple(a.cpu().numpy()
                     for a in next(iter(self._state.values())))

    def step_async(
        self,
        pos: np.ndarray,
        active: np.ndarray,
        space: np.ndarray,
        radius: np.ndarray,
        meta_dirty: bool = True,
    ) -> MultiHostPendingStep:
        """Start one tick with this process's LOCAL rows
        ([local_capacity, ...] arrays): the gather of every process's rows
        starts at once and the step launches when it completes (see the
        module docstring). ``meta_dirty`` is accepted for the engines'
        common interface; every tick gathers all four columns, since a
        peer's may have changed."""
        if self._state is None:
            raise RuntimeError("call reset() first")
        if len(pos) != self.local_capacity:
            raise ValueError(
                f"pass LOCAL rows ({self.local_capacity}), got {len(pos)}")
        check_radius(self.params, radius, active)
        if self.backend == "kernel":
            check_space_ids(space, active)
        # Launches run in dispatch order: each takes the world its
        # predecessor launched as its previous epoch.
        if self._unlaunched is not None:
            self._unlaunched._launch()
        local = _pack_rows(pos, active, space, radius)
        parts = [torch.empty_like(local) for _ in range(self.n_processes)]
        work = dist.all_gather(parts, local, async_op=True)
        pending = MultiHostPendingStep(self, work, parts)
        self._unlaunched = pending
        return pending

    def _page(self, ctx: list, deficit: np.ndarray,
              starts: np.ndarray) -> list[np.ndarray]:
        return _page_shards(self, ctx, self.shards, deficit, starts)

    def _note_step_flags(self, flags: int) -> None:
        """Header flags: both programs write 0 here."""

    def _launch(self, arrays: tuple) -> ShardedPendingStep:
        """Dispatch this process's shards' step on the gathered world; the
        pending step over their blocks."""
        cur = self._upload_world(arrays)
        p = self.params
        sentinel.note_launch("sharded_step_kernel" if self.backend == "kernel"
                             else "sharded_step")
        worlds = {dev: _WORLDS[self.backend](p, *self._state[dev], *cur[dev])
                  for dev in cur}
        enter_ctx, leave_ctx, headers, pairs = _shard_steps(
            p, self.events_inline, self.backend, self.n_devices, worlds,
            self.shards, self.mesh)
        # Each block's counts rows: the local shards' at their global index.
        dev0 = self.mesh[0]
        counts = torch.zeros((self.n_devices, 2), dtype=torch.int32,
                             device=dev0)
        for d, header in zip(self.shards, headers):
            counts[d] = header[0].to(dev0)  # gwlint: ok R1 a device-to-device copy between shards; the host does not wait
        outs = _pack_blocks(headers, pairs,
                            [counts.to(dev) for dev in self.mesh])  # gwlint: ok R1 a device-to-device copy between shards; the host does not wait
        pending = ShardedPendingStep(self, enter_ctx, leave_ctx, outs)
        pending.rank_paging = self.backend == "kernel"
        self._state = cur
        self._unlaunched = None
        _M_ALLGATHER_TOTAL.inc(self.allgather_bytes_per_tick)
        if self._ici_bytes:
            self._m_link_ici.inc(self._ici_bytes)
        if self._dcn_bytes:
            self._m_link_dcn.inc(self._dcn_bytes)
        return pending

    def step(self, pos, active, space, radius):
        """Run one tick; returns (local enter pairs, local leave pairs,
        dropped)."""
        return self.step_async(pos, active, space, radius).collect()
