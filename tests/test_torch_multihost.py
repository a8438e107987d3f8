"""The port's multi-process AOI tier on the CPU: two real OS processes.

Each process joins one group (``parallel.multihost.init_multihost``) with
4 CPU shards, so the global engine has 8 shards, and steps
``MultiHostNeighborEngine`` with only ITS entity rows over the trace of
``tests/test_multihost.py`` (512 slots, ``max_events`` 256, so the first
tick's storm pages on every shard), on both backends and on both gather
routes: the host route (the card identities stubbed to one shared card)
and the device route (stubbed to two distinct cards; the rows on the CPU,
so its group is Gloo too), with ``meta_dirty`` False after the storm.
The union of the two processes' events must equal the JAX single-device
engine's stream on every tick and route; under
``"reference"`` each process must get exactly its own rows' events, and
the two routes give each process the same events. The same pair of
processes then plays the batched service's flush alignment on each route
(one process a dispatch ahead; both collect the same final step) and a
dead peer (the alignment gives up within its deadline).

This file is also the worker: ``python tests/test_torch_multihost.py rank
nprocs coordinators outfile`` (under ``if __name__ == "__main__"``; one
coordinator per route, comma-separated).
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SERVER = "goworld_tpu_torch.examples.test_game"
BACKENDS = ("reference", "kernel")
# Each route's stubbed card identity of a rank.
ROUTES = {"host": lambda rank: "GPU-shared",
          "device": lambda rank: f"GPU-{rank}"}
TICKS = 3
# The dead-peer case's flush deadline, seconds.
DEAD_PEER_DEADLINE = 1.0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _trace(n):
    """test_multihost.py's seeded world: (rng, pos, active, space,
    radius); every tick then drifts pos by N(0, 25)."""
    rng = np.random.default_rng(17)
    pos = rng.uniform(0, 1500, (n, 2)).astype(np.float32)
    active = np.ones(n, bool)
    active[400:] = False
    space = rng.integers(0, 3, n).astype(np.int32)
    radius = np.full(n, 100.0, np.float32)
    return rng, pos, active, space, radius


def _drift(rng, pos):
    return np.clip(pos + rng.normal(0, 25, pos.shape), 0,
                   1500).astype(np.float32)


def _to_sets(pairs, n=512):
    sets = [set() for _ in range(n)]
    for a, b in pairs:
        sets[int(a)].add(int(b))
    return sets


def _worker(rank: int, nprocs: int, coords: str, outfile: str) -> int:
    import torch
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    from goworld_tpu_torch.entity.aoi.batched import BatchAOIService
    from goworld_tpu_torch.ops.neighbor import NeighborParams
    from goworld_tpu_torch.parallel import multihost as mh
    from goworld_tpu_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    p = NeighborParams(capacity=512, cell_size=100.0, grid_x=16, grid_z=16,
                       space_slots=4, cell_capacity=64, max_events=256)
    dump = {}
    for route, coord in zip(ROUTES, coords.split(",")):
        if route != "host":
            dist.barrier()
            mh.leave()
        mh._take_card = ROUTES[route]
        mh.init_multihost(coord, nprocs, rank, timeout_s=60.0)
        dump[f"{route}_route"] = np.array(mh.gather_route())
        for backend in BACKENDS:
            eng = mh.MultiHostNeighborEngine(p, make_mesh(4, "cpu"),
                                             backend=backend)
            assert eng.gather_route == route
            eng.reset()
            rng, pos, active, space, radius = _trace(p.capacity)
            lo, lc = eng.local_lo, eng.local_capacity
            for tick in range(TICKS):
                pend = eng.step_async(
                    pos[lo:lo + lc], active[lo:lo + lc], space[lo:lo + lc],
                    radius[lo:lo + lc], meta_dirty=tick == 0)
                e, l, dropped = pend.collect()
                key = f"{route}_{backend}"
                dump[f"{key}_enter_{tick}"] = e
                dump[f"{key}_leave_{tick}"] = l
                dump[f"{key}_dropped_{tick}"] = np.array([dropped])
                assert pend.gather_ms is not None
                pos = _drift(rng, pos)
            dump["local_lo"] = np.array([lo])
            dump["local_capacity"] = np.array([lc])
        _align_flush(mh, BatchAOIService, p, rank, route, dump)
    dist.barrier()
    mh.leave()
    np.savez(outfile, **dump)
    print(f"worker {rank} ok", flush=True)
    return 0


def _align_flush(mh, service_cls, p, rank, route, dump):
    """The flush alignment on ``route``: rank 0 dispatches once more than
    rank 1 (its gather waits for rank 1), then both flush; then a dead
    peer, rank 1 never publishing its count for the next round."""
    svc = service_cls(p, multihost=True, device="cpu")
    assert svc.engine.gather_route == route
    svc.warmup()
    svc.tick()
    svc.tick()
    if rank == 0:
        svc._pending[0].wait_device()  # rank 1 dispatched #2 as well
        assert svc.tick(wait=False) is not None
    dump[f"{route}_count_before_flush"] = np.array([svc._dispatch_count])
    svc.flush()
    dump[f"{route}_count_after_flush"] = np.array([svc._dispatch_count])
    dump[f"{route}_pending_after_flush"] = np.array(
        [svc._pending is not None])
    if rank == 0:
        svc.MULTIHOST_FLUSH_DEADLINE = DEAD_PEER_DEADLINE
        t0 = time.monotonic()
        dump[f"{route}_dead_peer_aligned"] = np.array(
            [svc._align_multihost_for_flush()])
        dump[f"{route}_dead_peer_seconds"] = np.array(
            [time.monotonic() - t0])


def test_two_processes_match_single_device_and_align_flush(tmp_path):
    from goworld_tpu.ops.neighbor import NeighborEngine, NeighborParams

    coords = ",".join(f"127.0.0.1:{_free_port()}" for _ in ROUTES)
    outs = [str(tmp_path / f"mh_out_{i}.npz") for i in range(2)]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(i), "2", coords,
             outs[i]],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        for i in range(2)
    ]
    logs = []
    try:
        for proc in procs:
            logs.append(proc.communicate(timeout=120)[0])
    finally:
        for proc in procs:
            proc.kill()
    for proc, log in zip(procs, logs):
        assert proc.returncode == 0, log[-3000:]

    p = NeighborParams(capacity=512, cell_size=100.0, grid_x=16, grid_z=16,
                       space_slots=4, cell_capacity=64, max_events=256)
    ref = NeighborEngine(p, backend="jnp")
    ref.reset()
    rng, pos, active, space, radius = _trace(p.capacity)
    want = []
    for _ in range(TICKS):
        want.append(ref.step(pos, active, space, radius))
        pos = _drift(rng, pos)

    data = [np.load(f) for f in outs]
    spans = sorted((int(d["local_lo"][0]), int(d["local_capacity"][0]))
                   for d in data)
    assert spans == [(0, 256), (256, 256)]
    for d in data:
        for route in ROUTES:
            assert str(d[f"{route}_route"]) == route
    for route, backend in itertools.product(ROUTES, BACKENDS):
        for tick, (want_e, want_l, want_d) in enumerate(want):
            key = f"{route}_{backend}"
            union_e = np.concatenate([d[f"{key}_enter_{tick}"]
                                      for d in data])
            union_l = np.concatenate([d[f"{key}_leave_{tick}"]
                                      for d in data])
            # Exact counts first: sets alone would hide a duplicate from a
            # broken paging resume.
            assert len(union_e) == len(want_e), (key, tick)
            assert len(union_l) == len(want_l), (key, tick)
            assert _to_sets(union_e) == _to_sets(want_e), (key, tick)
            assert _to_sets(union_l) == _to_sets(want_l), (key, tick)
            for d in data:
                assert int(d[f"{key}_dropped_{tick}"][0]) == want_d
                for side in ("enter", "leave"):
                    # Both routes give each process the same events.
                    got = d[f"{key}_{side}_{tick}"]
                    host = d[f"host_{backend}_{side}_{tick}"]
                    assert _to_sets(got) == _to_sets(host), (key, tick)
                    if backend == "reference":
                        lo = int(d["local_lo"][0])
                        lc = int(d["local_capacity"][0])
                        ent = got[:, 0]
                        assert ((ent >= lo) & (ent < lo + lc)).all()
            if tick == 0:
                assert len(union_e) > 8 * 32  # every shard's budget paged
    # The flush on each route: rank 0 a dispatch ahead, both end on the
    # same step with nothing in flight; then the dead peer.
    for route in ROUTES:
        assert [int(d[f"{route}_count_before_flush"][0])
                for d in data] == [3, 2], route
        assert [int(d[f"{route}_count_after_flush"][0])
                for d in data] == [3, 3], route
        assert not any(bool(d[f"{route}_pending_after_flush"][0])
                       for d in data), route
        dead = data[0]
        assert not bool(dead[f"{route}_dead_peer_aligned"][0]), route
        assert (float(dead[f"{route}_dead_peer_seconds"][0])
                < DEAD_PEER_DEADLINE + 2.0), route


def test_failed_gather_is_never_ready():
    """A gather that failed (a peer left the group) leaves the step never
    ready, so the service frame-skips instead of raising in the game loop;
    collecting it raises the failure."""
    from goworld_tpu_torch.parallel.multihost import MultiHostPendingStep

    class FailedWork:
        def is_completed(self):
            return True

        def wait(self):
            raise RuntimeError("connection closed by peer")

    pending = MultiHostPendingStep(None, FailedWork(), [])
    assert not pending.is_ready()
    assert not pending.is_ready()
    with pytest.raises(RuntimeError, match="closed by peer"):
        pending.collect()


def test_failed_step_launch_raises_its_own_error(monkeypatch):
    """A step that fails after a good gather (a device error, a bug) is
    not taken for a dead peer: ``wait_device``, ``is_ready`` and
    ``collect`` raise that error, the step is not dispatched twice, and
    the engine's next ``step_async`` raises it too instead of stepping
    from a world that never advanced. A one-process group, in this
    process."""
    import torch.distributed as dist

    from goworld_tpu_torch.ops.neighbor import NeighborParams
    from goworld_tpu_torch.parallel import multihost
    from goworld_tpu_torch.parallel.mesh import make_mesh

    p = NeighborParams(capacity=512, cell_size=100.0, grid_x=16, grid_z=16,
                       space_slots=4, cell_capacity=64, max_events=256)
    calls = []

    def failing_steps(*args):
        calls.append(args)
        raise RuntimeError("CUDA out of memory")

    multihost.init_multihost(f"127.0.0.1:{_free_port()}", 1, 0,
                             timeout_s=30.0)
    try:
        eng = multihost.MultiHostNeighborEngine(p, make_mesh(2, "cpu"))
        eng.reset()
        _, pos, active, space, radius = _trace(p.capacity)
        monkeypatch.setattr(multihost, "_shard_steps", failing_steps)
        pending = eng.step_async(pos, active, space, radius)
        with pytest.raises(RuntimeError, match="out of memory"):
            pending.wait_device()
        with pytest.raises(RuntimeError, match="out of memory"):
            pending.is_ready()
        with pytest.raises(RuntimeError, match="out of memory"):
            pending.collect()
        with pytest.raises(RuntimeError, match="out of memory"):
            eng.step_async(pos, active, space, radius)
        assert len(calls) == 1
        assert pending.gather_ms is not None
    finally:
        dist.destroy_process_group()
        multihost._STORE = None


def test_route_selection():
    """The cards decide the gather route: processes on distinct cards (or
    on none) take the device route, two on one card the host route, one
    process the device route; ``init_multihost`` takes it from the cards
    its processes report through the store."""
    from goworld_tpu_torch.parallel import multihost

    assert multihost.choose_route(["GPU-a", "GPU-b"]) == "device"
    assert multihost.choose_route(["GPU-a", "GPU-a"]) == "host"
    assert multihost.choose_route(["GPU-a", "GPU-b", "GPU-a"]) == "host"
    assert multihost.choose_route(["GPU-a"]) == "device"
    assert multihost.choose_route(["", ""]) == "device"


def test_one_process_takes_the_device_route(monkeypatch):
    import torch.distributed as dist

    from goworld_tpu_torch.ops.neighbor import NeighborParams
    from goworld_tpu_torch.parallel import multihost
    from goworld_tpu_torch.parallel.mesh import make_mesh

    monkeypatch.setattr(multihost, "_take_card", lambda rank: "GPU-0")
    multihost.init_multihost(f"127.0.0.1:{_free_port()}", 1, 0,
                             timeout_s=30.0)
    try:
        assert multihost.gather_route() == "device"
        assert dist.get_backend() == "gloo"  # no CUDA here: no NCCL
        p = NeighborParams(capacity=512, cell_size=100.0, grid_x=16,
                           grid_z=16, space_slots=4, cell_capacity=64,
                           max_events=256)
        eng = multihost.MultiHostNeighborEngine(p, make_mesh(2, "cpu"))
        assert eng.gather_route == "device"
    finally:
        multihost.leave()
    assert multihost.store() is None and not dist.is_initialized()


def test_meta_dirty_false_uploads_positions_only():
    """On the device route, ``meta_dirty=False`` uploads this process's
    positions only and gathers the metadata it kept from its previous
    tick: the same events as the JAX single-device engine given the same
    flags, also on a tick whose active column changed but was not marked
    dirty (both engines then step the previous active)."""
    import torch

    from goworld_tpu.ops.neighbor import NeighborEngine, NeighborParams
    from goworld_tpu_torch.ops import neighbor as tn
    from goworld_tpu_torch.parallel import multihost
    from goworld_tpu_torch.parallel.mesh import make_mesh

    p = NeighborParams(capacity=512, cell_size=100.0, grid_x=16, grid_z=16,
                       space_slots=4, cell_capacity=64, max_events=4096)
    ref = NeighborEngine(p, backend="jnp")
    ref.reset()
    multihost.init_multihost(f"127.0.0.1:{_free_port()}", 1, 0,
                             timeout_s=30.0)
    try:
        eng = multihost.MultiHostNeighborEngine(
            tn.NeighborParams(**dataclasses.asdict(p)), make_mesh(2, "cpu"),
            backend="kernel")
        assert eng.gather_route == "device"
        eng.reset()
        rng, pos, active, space, radius = _trace(p.capacity)
        first_meta = None
        for tick in range(4):
            meta_dirty = tick == 0
            if tick == 3:
                active = active.copy()
                active[:50] = False  # not marked dirty: not uploaded
            want = ref.step_async(pos, active, space, radius,
                                  meta_dirty=meta_dirty).collect()
            got = eng.step_async(pos, active, space, radius,
                                 meta_dirty=meta_dirty).collect()
            for k in (0, 1):
                assert len(got[k]) == len(want[k]), (tick, k)
                assert _to_sets(got[k]) == _to_sets(want[k]), (tick, k)
            assert got[2] == want[2]
            local = eng._local
            assert torch.equal(local[:, 0:2].view(torch.float32),
                               torch.from_numpy(pos))
            if tick == 0:
                first_meta = local[:, 2:].clone()
            assert torch.equal(local[:, 2:], first_meta), tick
            pos = _drift(rng, pos)
    finally:
        multihost.leave()


def _device_pending(work):
    """A device-route pending step over ``work``, its rows on the CPU."""
    import torch

    from goworld_tpu_torch.parallel.multihost import MultiHostPendingStep

    return MultiHostPendingStep(None, work, torch.empty((0, 5)))


def test_failed_device_gather_is_never_ready(monkeypatch):
    """The device route's failed gather is never ready and ``collect``
    raises it: over Gloo (the rows on the CPU) the gather's wait raises;
    over NCCL the gather reports its failure (the watchdog aborted it at
    the group's timeout), or never completes and ``collect`` gives up at
    that timeout."""
    from goworld_tpu_torch.parallel import multihost

    class FailedWork:
        def is_completed(self):
            return True

        def wait(self):
            raise RuntimeError("connection closed by peer")

    pending = _device_pending(FailedWork())
    assert not pending.is_ready()
    assert not pending.is_ready()
    with pytest.raises(RuntimeError, match="closed by peer"):
        pending.collect()

    class AbortedWork(FailedWork):
        def wait(self, timeout=None):
            # Over NCCL a wait only orders the stream; with a timeout it
            # also raises the error of a completed work.
            if timeout is not None:
                raise RuntimeError("Watchdog caught collective operation "
                                   "timeout")

    pending = _device_pending(AbortedWork())
    pending._nccl = True
    assert not pending.is_ready()
    assert not pending.is_ready()
    with pytest.raises(RuntimeError, match="gather failed.*Watchdog"):
        pending.collect()
    with pytest.raises(RuntimeError, match="gather failed"):
        pending.wait_device()

    class PendingWork(AbortedWork):
        def is_completed(self):
            return False

    monkeypatch.setattr(multihost, "_TIMEOUT_S", 0.2)
    pending = _device_pending(PendingWork())
    pending._nccl = True
    assert not pending.is_ready()
    with pytest.raises(RuntimeError, match="did not complete within"):
        pending.collect()


MH_CLUSTER_INI = """\
[deployment]
dispatchers = 1
games = 2
gates = 1

[dispatcher1]
port = {disp}

[game_common]
boot_entity = Account
save_interval = 600

[game1]
[game2]

[gate1]
port = {gate}
heartbeat_timeout = 60

[storage]
type = filesystem
directory = {dir}/es

[kvdb]
type = sqlite
directory = {dir}/kv

[aoi]
backend = tpu
platform = {platform}
max_entities = 512
multihost_coordinator = 127.0.0.1:{coord}
"""


@pytest.mark.slow
def test_multihost_cluster_two_games(tmp_path):
    """The port's copy of tests/test_multihost.py's cluster test: a CLI
    deployment whose two games join one group through
    ``[aoi] multihost_coordinator`` and step AOI in lockstep, 10 strict
    bots across a reload (the flush alignment, then the re-join)."""
    import asyncio

    from goworld_tpu_torch.client.bot_runner import format_report, run_fleet

    d = str(tmp_path)
    ports = {"disp": _free_port(), "gate": _free_port(),
             "coord": _free_port()}
    with open(os.path.join(d, "goworld.ini"), "w") as f:
        f.write(MH_CLUSTER_INI.format(dir=d, platform="cpu", **ports))

    def cli(*args, timeout=180):
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
        return subprocess.run(
            [sys.executable, "-m", "goworld_tpu_torch.cli", *args],
            cwd=d, env=env, capture_output=True, text=True, timeout=timeout,
        )

    def joins(game):
        with open(os.path.join(d, f"{game}.out.log")) as f:
            return f.read().count("AOI multihost mesh joined: 2 processes")

    r = cli("start", SERVER)
    try:
        assert r.returncode == 0, r.stdout + r.stderr
        assert joins("game1") >= 1 and joins("game2") >= 1

        async def scenario():
            fleet = asyncio.create_task(run_fleet(
                10, [("127.0.0.1", ports["gate"])], 45.0, strict=True,
                seed=11, thing_timeout=40.0))
            await asyncio.sleep(20.0)
            rr = await asyncio.to_thread(cli, "reload", SERVER)
            assert rr.returncode == 0, rr.stdout + rr.stderr
            assert "reload complete" in rr.stdout
            return await fleet

        report = asyncio.run(scenario())
        assert report["errors"] == [], format_report(report)
        assert joins("game1") >= 2 and joins("game2") >= 2
    finally:
        cli("kill", SERVER)


if __name__ == "__main__":
    sys.exit(_worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                     sys.argv[4]))
