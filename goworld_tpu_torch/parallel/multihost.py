"""Multi-process sharded AOI, the port of ``goworld_tpu.parallel.multihost``.

Several processes (a deployment's game processes, or hosts) step ONE
entity-sharded world together. Each process owns a contiguous slab of
entity rows, ``[local_lo, local_lo + local_capacity)``, and a list of local
shards (its mesh, ``parallel.mesh.make_mesh``); the global shard count is
world size x local shards and the same on every process.

The JAX module runs one SPMD program across the processes
(multi-controller ``shard_map``): each process puts only its own row slab
on its devices and the step all-gathers the rows on the devices, over ICI
within a host and DCN between hosts. PyTorch has no such program. Here the
only cross-process traffic is one all-gather of every process's rows a
tick, over ``torch.distributed``; after it each process holds the whole
world on its own devices and runs the entity-sharded programs of
``parallel.mesh`` for its OWN shards only: the all-gather program (backend
``"reference"``) or the slab-kernel program (backend ``"kernel"``). Paging
needs no peer: a process pages its own shards from its own counts.

What a process receives: under ``"reference"`` exactly the events of its
own entity rows (row ownership, what a game process delivers); under
``"kernel"`` the events of the entities binned in its shards' slabs of
grid rows (cell ownership, as the JAX module says of its Pallas path).
The union over the processes is the single-device engine's stream either
way.

The gather: each process packs only its own rows, uploads them to its
first shard's device (pinned, ``non_blocking``; with ``meta_dirty=False``
only the positions, the metadata staying there from the previous tick)
and starts ``all_gather_into_tensor`` on that device; the step reads the
gathered world where it landed, with no whole-world upload. Its route is
chosen once at :func:`init_multihost` from the cards the processes hold
(rank r takes ``cuda:(r % device_count)``, as a JAX process takes its
local devices):

- ``"device"``, where no two processes share a card: the gather runs over
  NCCL, card to card, with no host round trip. Rows on the CPU (tests,
  ``[aoi] platform = cpu``) take it over Gloo.
- ``"host"``, where two processes share one card (NCCL cannot run two
  ranks on one GPU): the group is Gloo alone, which stages the card's
  rows through host memory.

Both routes run the same code; they differ in the group's backend. There
is no fallback between them: a NCCL error raises. The group's NCCL
communicator runs under ``TORCH_NCCL_ASYNC_ERROR_HANDLING=2`` unless the
environment says otherwise: a collective a peer never joins is aborted at
the group's timeout and fails, and the process lives on. :func:`leave`
aborts the group, so a process that goes (a game freezing for a reload)
never waits on a collective its peer left.

The gather starts asynchronously in ``step_async``, so a process that
dispatched ahead of a peer does not block: ``MultiHostPendingStep.is_ready``
stays False until every peer has dispatched the same tick (as the JAX
step's collective is not ready until every process joins it), and the
device step launches when the gather is seen complete. ``collect`` waits
for it, at most the group's timeout over NCCL.

Bootstrap: :func:`init_multihost` on every process, then the same engine
construction on every process with identical params.
"""

from __future__ import annotations

import datetime
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from goworld_tpu_torch.ops.neighbor import (
    NeighborParams,
    check_radius,
    check_space_ids,
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
# entity/aoi/batched.py), the gather route, the group's backend and its
# timeout, set by init_multihost.
_STORE: dist.Store | None = None
_ROUTE: str | None = None
_BACKEND: str | None = None
_TIMEOUT_S = DEFAULT_TIMEOUT_S

# The timeout of the wait that reads a completed NCCL gather's outcome.
_SETTLED = datetime.timedelta(seconds=1)

# The store's keys through which the processes swap their cards' identities.
_CARD_KEY = "gwt/multihost/card"

# Columns of one row in the gather, as int32 words: x, z (float32 bits),
# active, space, radius (float32 bits).
_ROW_WORDS = 5

# The tensor all-gather: torch 2.13 renamed all_gather_into_tensor, which
# older releases have alone.
_all_gather_tensor = (getattr(dist, "all_gather_single", None)
                      or dist.all_gather_into_tensor)


def choose_route(cards: list[str]) -> str:
    """The gather route for the processes' card identities (rank order; ""
    for a process without a card): ``"host"`` where two processes share a
    card, else ``"device"``."""
    held = [c for c in cards if c]
    return "host" if len(set(held)) < len(held) else "device"


def _take_card(process_id: int) -> str:
    """Make ``cuda:(process_id % device_count)`` this process's current
    device and return its UUID; "" without CUDA."""
    if not torch.cuda.is_available():
        return ""
    card = process_id % torch.cuda.device_count()
    torch.cuda.set_device(card)
    return str(torch.cuda.get_device_properties(card).uuid)


def init_multihost(coordinator_address: str, num_processes: int,
                   process_id: int, timeout_s: float = DEFAULT_TIMEOUT_S,
                   cuda: bool = True) -> None:
    """Join the process group of ``num_processes`` processes as rank
    ``process_id``, with ``coordinator_address`` ("host:port") as the
    rendezvous: process 0 serves the key-value store there, as the
    ``tcp://`` init method does. Each process first takes its card (see the
    module docstring; none with ``cuda`` False, where its rows stay on the
    CPU) and the processes swap the cards' identities through the store,
    which decides the gather route; the group is then Gloo plus, where
    every process holds a card of its own, NCCL for CUDA tensors (its
    communicator made at the first CUDA collective). Blocks until
    every process joined, at most ``timeout_s``, which also bounds every
    later collective. The store is kept for the service's flush alignment
    (:func:`store`)."""
    global _STORE, _ROUTE, _BACKEND, _TIMEOUT_S
    host, port = coordinator_address.rsplit(":", 1)
    timeout = datetime.timedelta(seconds=timeout_s)
    kv = dist.TCPStore(host, int(port), num_processes,
                       is_master=process_id == 0, timeout=timeout)
    kv.set(f"{_CARD_KEY}/{process_id}",
           _take_card(process_id) if cuda else "")
    cards = [kv.get(f"{_CARD_KEY}/{r}").decode()
             for r in range(num_processes)]
    route = choose_route(cards)
    backend = "gloo"
    if route == "device" and all(cards) and torch.cuda.is_available():
        os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING", "2")
        backend = "cpu:gloo,cuda:nccl"
    dist.init_process_group(backend, store=kv, rank=process_id,
                            world_size=num_processes, timeout=timeout)
    _STORE, _ROUTE, _BACKEND, _TIMEOUT_S = kv, route, backend, timeout_s


def leave() -> None:
    """Leave the group: abort it where it holds NCCL (a collective a peer
    left is not waited on), else destroy it. No-op outside a group."""
    global _STORE, _ROUTE, _BACKEND
    if dist.is_initialized():
        if _BACKEND is not None and "nccl" in _BACKEND:
            dist.distributed_c10d._abort_process_group()
        else:
            dist.destroy_process_group()
    _STORE = _ROUTE = _BACKEND = None


def store() -> dist.Store | None:
    """The store of :func:`init_multihost`, or None outside a group."""
    return _STORE


def gather_route() -> str | None:
    """The route :func:`init_multihost` chose, or None outside a group."""
    return _ROUTE


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _pack_rows(rows: np.ndarray, pos, active, space, radius) -> None:
    """Write host rows into int32 ``rows`` [n, 5] (float bits kept)."""
    rows[:, 0:2] = np.ascontiguousarray(pos, np.float32).view(np.int32)
    rows[:, 2] = np.asarray(active, bool)
    rows[:, 3] = np.asarray(space, np.int32)
    rows[:, 4] = np.ascontiguousarray(radius, np.float32).view(np.int32)


def _unpack_device(rows: torch.Tensor) -> tuple:
    """The gathered int32 rows' columns as tensors on their device."""
    return (
        rows[:, 0:2].contiguous().view(torch.float32),
        rows[:, 2] != 0,
        rows[:, 3].contiguous(),
        rows[:, 4].contiguous().view(torch.float32),
    )


class MultiHostPendingStep:
    """In-flight multi-process tick: the gather of every process's rows,
    then this process's shards' step, a ``parallel.mesh.ShardedPendingStep``
    over the local shards' blocks to which ``collect`` and the device part
    of ``is_ready`` and ``wait_device`` go. ``collect()`` reads only LOCAL
    shards. ``parts`` is the gathered rows' tensor; ``nccl`` says the
    gather runs over NCCL.

    ``gather_ms`` holds the milliseconds from the gather's start (in
    ``step_async``) to its completion as this process saw it: with a peer
    behind, mostly the wait for that peer's dispatch.

    A gather that failed (a peer left the group) is never ready: the game
    loop frame-skips and its wedge watchdog warns, as with a JAX collective
    a dead peer never joins, and the flush abandons the step at its
    deadline; ``collect`` raises the failure. Over NCCL the gather a peer
    never joins fails at the group's timeout, and ``collect`` raises then
    at the latest. A step that failed to launch after the gather (a device
    error, a bug) raises from ``is_ready`` as well as from ``collect``, and
    from the engine's next ``step_async``."""

    __slots__ = ("_engine", "_work", "_parts", "_nccl", "_t0", "_step",
                 "_error", "_gather_failed", "gather_ms")

    def __init__(self, engine, work, parts, nccl: bool = False) -> None:
        self._engine = engine
        self._work = work
        self._parts = parts
        self._nccl = nccl
        self._t0 = time.perf_counter()
        self._step: ShardedPendingStep | None = None
        self._error: BaseException | None = None
        self._gather_failed = False
        self.gather_ms = None

    def _gather_done(self) -> bool:
        """Whether the gather completed well, without blocking; a failure
        NCCL reports is recorded as the step's error."""
        if self.gather_ms is not None:
            return True
        if self._gather_failed or not self._work.is_completed():
            return False
        if self._nccl:
            try:
                # The work completed: a wait with a timeout returns at once,
                # and raises the work's error where NCCL's watchdog aborted
                # it (a wait without one only orders the stream).
                self._work.wait(_SETTLED)
            except RuntimeError as exc:
                self._error = RuntimeError(f"the process gather failed: {exc}")
                self._gather_failed = True
                return False
            self._note_gathered()
        return True

    def _note_gathered(self) -> None:
        if self.gather_ms is None:
            self.gather_ms = (time.perf_counter() - self._t0) * 1000.0

    def _await_gather(self) -> None:
        """Over NCCL: poll the gather until it completes, at most the
        group's timeout; raises its failure."""
        deadline = self._t0 + _TIMEOUT_S
        while not self._gather_done():
            if self._gather_failed:
                raise self._error
            if time.perf_counter() > deadline:
                raise RuntimeError(
                    f"the process gather did not complete within "
                    f"{_TIMEOUT_S} s: a peer left the group")
            time.sleep(0.0001)

    def _launch(self) -> None:
        """Finish the gather and dispatch the step. Over Gloo the host
        waits for the gathered rows; over NCCL the step's stream waits on
        the gather and the host does not."""
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
        if not self._nccl:
            self._note_gathered()
        try:
            self._step = self._engine._launch(_unpack_device(self._parts))
        except BaseException as exc:
            self._error = exc
            raise
        self._parts = None

    def is_ready(self) -> bool:
        """True when collect() will not block: every peer has dispatched
        this tick and the local step has computed."""
        if self._step is None:
            if self._gather_failed or (
                    self._error is None and not self._gather_done()):
                return False
            try:
                self._launch()
            except RuntimeError:
                if self._gather_failed:
                    return False
                raise
        elif self._nccl and not self._gather_done():
            return False  # launched behind a gather still in flight
        return self._step.is_ready()

    def wait_device(self) -> None:
        """Block until the gather and the local step are done."""
        if self._nccl:
            self._await_gather()
        self._launch()
        self._step.wait_device()

    def collect(self) -> tuple[np.ndarray, np.ndarray, int]:
        """(local_enters, local_leaves, dropped), pairs with global ids: the
        events of this process's own shards. One blocking read, then the
        local shards' storm paging."""
        if self._nccl:
            self._await_gather()
        self._launch()
        return self._step.collect()


class MultiHostNeighborEngine:
    """Per-process handle on the multi-process engine.

    Every process constructs it with identical params and the same number
    of local shards, and steps it with its LOCAL entity rows
    ``[local_lo, local_lo + local_capacity)``. ``mesh``: this process's
    local shards (None: one shard on the current CUDA device; over NCCL
    the first shard's device must be this process's card). ``backend``: ``"reference"`` (row ownership) or
    ``"kernel"`` (cell ownership; grid_z a multiple of the global shard
    count), see the module docstring. ``gather_route`` is the route
    :func:`init_multihost` chose.

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
        self.gather_route = _ROUTE or "host"
        # Whether the gather runs over NCCL: a group with NCCL, rows on a
        # card.
        self._nccl = "nccl" in (_BACKEND or "") and mesh[0].type == "cuda"
        if self._nccl and mesh[0].index != torch.cuda.current_device():
            raise ValueError(
                f"the NCCL gather runs on this process's card, "
                f"cuda:{torch.cuda.current_device()}; the mesh starts on "
                f"{mesh[0]}")
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
        # The last uploaded local rows [local_capacity, 5], on the first
        # shard's device: its metadata columns are reused when
        # a tick's meta_dirty is False.
        self._local: torch.Tensor | None = None
        self._unlaunched: MultiHostPendingStep | None = None
        self.last_grid_dropped = 0

    def reset(self) -> None:
        """An all-inactive previous tick on every process."""
        n = self.params.capacity
        self._state = {dev: (
            torch.zeros((n, 2), dtype=torch.float32, device=dev),
            torch.zeros(n, dtype=torch.bool, device=dev),
            torch.zeros(n, dtype=torch.int32, device=dev),
            torch.zeros(n, dtype=torch.float32, device=dev),
        ) for dev in dict.fromkeys(self.mesh)}
        self._local = torch.zeros((self.local_capacity, _ROW_WORDS),
                                  dtype=torch.int32, device=self.mesh[0])

    def carried_epoch(self) -> tuple:
        """The last launched world (every process's rows) as numpy."""
        if self._state is None:
            raise RuntimeError("call reset() first")
        if self._unlaunched is not None:
            self._unlaunched._launch()
        return tuple(a.cpu().numpy()
                     for a in next(iter(self._state.values())))

    def _upload_local(self, pos, active, space, radius,
                      meta_dirty: bool) -> torch.Tensor:
        """This process's rows packed [local_capacity, 5] on the first
        shard's device: a pinned, non-blocking upload of every column, or
        with ``meta_dirty`` False of the positions alone beside the last
        tick's metadata columns."""
        dev = self.mesh[0]
        pin = dev.type == "cuda"
        lc = self.local_capacity
        if meta_dirty:
            host = torch.empty((lc, _ROW_WORDS), dtype=torch.int32,
                               pin_memory=pin)
            _pack_rows(host.numpy(), pos, active, space, radius)  # gwlint: ok R1 host is a host buffer (pinned for a card)
            local = host.to(dev, non_blocking=True)
        else:
            host = torch.empty((lc, 2), dtype=torch.int32, pin_memory=pin)
            host.numpy()[...] = np.ascontiguousarray(  # gwlint: ok R1 host is a host buffer (pinned for a card)
                pos, np.float32).view(np.int32)
            local = torch.empty((lc, _ROW_WORDS), dtype=torch.int32,
                                device=dev)
            local[:, 0:2].copy_(host, non_blocking=True)
            local[:, 2:].copy_(self._local[:, 2:], non_blocking=True)
        self._local = local
        return local

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
        starts at once and the step launches behind it (see the module
        docstring). ``meta_dirty`` False asserts this process's active,
        space and radius are unchanged since its previous step: only the
        positions are then uploaded; the gather still carries every
        column, since a peer's may have changed."""
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
        local = self._upload_local(pos, active, space, radius, meta_dirty)
        parts = torch.empty((self.n_processes * len(local), _ROW_WORDS),
                            dtype=torch.int32, device=local.device)
        work = _all_gather_tensor(parts, local, async_op=True)
        pending = MultiHostPendingStep(self, work, parts, self._nccl)
        self._unlaunched = pending
        return pending

    def _page(self, ctx: list, deficit: np.ndarray,
              starts: np.ndarray) -> list[np.ndarray]:
        return _page_shards(self, ctx, self.shards, deficit, starts)

    def _note_step_flags(self, flags: int) -> None:
        """Header flags: both programs write 0 here."""

    def _launch(self, arrays: tuple) -> ShardedPendingStep:
        """Dispatch this process's shards' step on the gathered world's
        columns (tensors on the first shard's device); the pending step
        over their blocks."""
        dev0 = arrays[0].device
        cur = {dev: arrays if dev == dev0 else tuple(
                   a.to(dev, non_blocking=True) for a in arrays)
               for dev in dict.fromkeys(self.mesh)}
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
