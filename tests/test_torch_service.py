"""The port's batched AOI service and entity runtime against the JAX ones,
on the CPU (``device="cpu"``: the engines' plain versions).

Counterparts of the JAX package's service oracles, played on the port's
``entity_manager.runtime`` and, with the same seed, held against the JAX
runtime's checkpoints: the random-trace oracle of
``tests/test_entity.py`` (xzlist vs batched), the fused-delivery parity
oracle (single device and 2 strips), the ``on_aoi_batch`` ordering
harness, the [sync] tier writeback of ``tests/test_synctier.py`` and the
fused-service tests of ``tests/test_columns.py``. Fused trajectories are
held bit for bit against the port's own unfused hook and within
``FUSED_RTOL`` of the JAX runtime's (XLA may contract ``a*b+c`` into an
FMA under jit; eager torch rounds each operation). Both packages' global
runtimes are cleaned in the fixture's teardown.
"""

import random
import socket
import time
import types

import numpy as np
import pytest
import torch

import goworld_tpu.entity.aoi.batched as jbatched
import goworld_tpu.entity.columns as jcolumns
import goworld_tpu.entity.entity as jentity
import goworld_tpu.entity.entity_manager as jem
import goworld_tpu.entity.slabs as jslabs
import goworld_tpu.entity.space as jspace
import goworld_tpu.entity.vector as jvector
import goworld_tpu.ops.neighbor as jneighbor
import goworld_tpu_torch.entity.aoi.batched as tbatched
import goworld_tpu_torch.entity.columns as tcolumns
import goworld_tpu_torch.entity.entity as tentity
import goworld_tpu_torch.entity.entity_manager as tem
import goworld_tpu_torch.entity.space as tspace
import goworld_tpu_torch.entity.vector as tvector
import goworld_tpu_torch.ops.neighbor as tneighbor
from goworld_tpu_torch.entity.slabs import (
    SIF_SYNC_NEIGHBOR_CLIENTS,
    SIF_SYNC_OWN_CLIENT,
    EntitySlabs,
    SyncTuning,
    classify_tiers,
)

FUSED_RTOL = 1e-6

PORT = types.SimpleNamespace(
    name="port", em=tem, Entity=tentity.Entity, Space=tspace.Space,
    Vector3=tvector.Vector3, Params=tneighbor.NeighborParams,
    batched=tbatched, columnar_tick=tcolumns.columnar_tick,
    SyncTuning=SyncTuning)
JAX = types.SimpleNamespace(
    name="jax", em=jem, Entity=jentity.Entity, Space=jspace.Space,
    Vector3=jvector.Vector3, Params=jneighbor.NeighborParams,
    batched=jbatched, columnar_tick=jcolumns.columnar_tick,
    SyncTuning=jslabs.SyncTuning)

TRACE_PARAMS = dict(capacity=128, cell_size=100.0, grid_x=8, grid_z=8,
                    space_slots=4, cell_capacity=32, max_events=8192)
FUSED_PARAMS = dict(capacity=256, cell_size=100.0, grid_x=16, grid_z=16,
                    space_slots=2, cell_capacity=32, max_events=4096)


@pytest.fixture(autouse=True)
def fresh_runtimes():
    for pk in (PORT, JAX):
        pk.em.cleanup_for_tests()
    yield
    for pk in (PORT, JAX):
        pk.em.cleanup_for_tests()


def runtime(pk, backend="batched", params=TRACE_PARAMS, **kw):
    """A fresh runtime of package ``pk`` on the CPU."""
    pk.em.cleanup_for_tests()
    rt = pk.em.runtime
    rt.aoi_backend = backend
    rt.aoi_params = pk.Params(**params)
    if pk is PORT:
        rt.aoi_device = "cpu"
    for k, v in kw.items():
        setattr(rt, k, v)
    return rt


def classes(pk):
    class MySpace(pk.Space):
        @classmethod
        def describe_entity_type(cls, desc):
            desc.define_attr("_EnableAOI", "Persistent")

    class Avatar(pk.Entity):
        @classmethod
        def describe_entity_type(cls, desc):
            desc.set_use_aoi(True)

        def on_enter_aoi(self, other):  # per-pair hooks: host delivery
            super().on_enter_aoi(other)

    class Monster(pk.Entity):
        @classmethod
        def describe_entity_type(cls, desc):
            desc.set_use_aoi(True)

    return MySpace, Avatar, Monster


def two_spaces(pk):
    a = pk.em.create_space_locally(kind=1)
    a.enable_aoi(100.0)
    b = pk.em.create_space_locally(kind=2)
    b.enable_aoi(100.0)
    return [a, b]


def checkpoint(ents, seq):
    return {seq[e.id]: sorted(seq[o.id] for o in e.interested_in)
            for e in ents}


# --- random-trace oracles ------------------------------------------------------


def play_random_trace(pk, backend):
    """tests/test_entity.py::test_aoi_backends_agree_on_random_trace's
    world: spawns, despawns and moves over two spaces, two ticks a step."""
    rt = runtime(pk, backend)
    space_cls, avatar, _ = classes(pk)
    pk.em.register_space(space_cls)
    pk.em.register_entity(avatar)
    rng = random.Random(4242)
    spaces = two_spaces(pk)
    ents, seq, checkpoints = [], {}, []
    for step in range(60):
        roll = rng.random()
        if roll < 0.35 and len(ents) < 40:
            e = pk.em.create_entity_locally("Avatar")
            seq[e.id] = len(seq)
            sp = spaces[rng.randrange(2)]
            sp._enter(e, pk.Vector3(rng.uniform(0, 700), 0,
                                    rng.uniform(0, 700)))
            ents.append(e)
        elif roll < 0.5 and ents:
            ents.pop(rng.randrange(len(ents))).destroy()
        elif ents:
            e = ents[rng.randrange(len(ents))]
            e.set_position(pk.Vector3(rng.uniform(0, 700), 0,
                                      rng.uniform(0, 700)))
        rt.tick()
        rt.tick()
        if step % 10 == 9:
            checkpoints.append(checkpoint(ents, seq))
    return checkpoints


def test_runtime_random_trace_matches_xzlist_and_jax():
    port = play_random_trace(PORT, "batched")
    port_xz = play_random_trace(PORT, "xzlist")
    ref = play_random_trace(JAX, "batched")
    assert len(port) == 6
    assert any(any(v for v in cp.values()) for cp in port)
    assert port == port_xz == ref


def play_fused_delivery(pk, shards, fused):
    """tests/test_entity.py::test_fused_delivery_parity_random_trace's
    world: spawns, despawns, space hops and moves."""
    real = pk.batched._class_fused_delivery
    pk.batched._class_fused_delivery = real if fused else (lambda c: False)
    try:
        rt = runtime(pk, aoi_mesh_shards=shards)
        space_cls, _, monster = classes(pk)
        pk.em.register_space(space_cls)
        pk.em.register_entity(monster)
        rng = random.Random(1907)
        spaces = two_spaces(pk)
        ents, seq, checkpoints = [], {}, []
        for step in range(50):
            roll = rng.random()
            if roll < 0.30 and len(ents) < 40:
                e = pk.em.create_entity_locally("Monster")
                seq[e.id] = len(seq)
                spaces[rng.randrange(2)]._enter(
                    e, pk.Vector3(rng.uniform(0, 700), 0,
                                  rng.uniform(0, 700)))
                ents.append(e)
            elif roll < 0.42 and ents:
                ents.pop(rng.randrange(len(ents))).destroy()
            elif roll < 0.55 and ents:
                e = ents[rng.randrange(len(ents))]
                src = e.space
                dst = spaces[0] if src is spaces[1] else spaces[1]
                src._leave(e)
                dst._enter(e, pk.Vector3(rng.uniform(0, 700), 0,
                                         rng.uniform(0, 700)))
            elif ents:
                e = ents[rng.randrange(len(ents))]
                e.set_position(pk.Vector3(rng.uniform(0, 700), 0,
                                          rng.uniform(0, 700)))
            rt.tick()
            rt.tick()
            if step % 10 == 9:
                checkpoints.append(checkpoint(ents, seq))
        svc = rt.aoi_service
        return checkpoints, {c.__name__ for c in svc._fused_classes}, svc
    finally:
        pk.batched._class_fused_delivery = real


@pytest.mark.parametrize("shards", [1, 2])
def test_fused_delivery_parity_random_trace(shards):
    applied = tbatched._M_FUSED_DELIVERY_EVENTS.labels("applied")
    applied0 = applied.value
    fused, census, svc = play_fused_delivery(PORT, shards, True)
    engine = type(svc.engine).__name__
    assert engine == ("NeighborEngine" if shards == 1
                      else "SpatialShardedNeighborEngine")
    assert "Monster" in census
    assert applied.value > applied0
    host, host_census, _ = play_fused_delivery(PORT, shards, False)
    assert not host_census
    ref, _, _ = play_fused_delivery(JAX, shards, True)
    assert len(fused) == 5
    assert any(any(v for v in cp.values()) for cp in fused)
    assert fused == host == ref


# --- on_aoi_batch delivery ordering ----------------------------------------------


def delivery_service():
    return tbatched.BatchAOIService(tneighbor.NeighborParams(
        capacity=64, cell_size=100.0, grid_x=8, grid_z=8, space_slots=1,
        cell_capacity=16, max_events=256), device="cpu")


class Recorder:
    """Duck-typed legacy entity (no on_aoi_batch): per-pair fallback."""

    def __init__(self, name):
        self.name = name
        self.calls = []

    def is_destroyed(self):
        return False

    def on_enter_aoi(self, other):
        self.calls.append(("enter", other.name))

    def on_leave_aoi(self, other):
        self.calls.append(("leave", other.name))


def legacy_delivery(ents, enters, leaves):
    """The pre-batch per-pair loop: ALL leaves, then ALL enters."""
    for a, b in leaves:
        ea, eb = ents[a], ents[b]
        if ea is not None and eb is not None and not ea.is_destroyed():
            ea.on_leave_aoi(eb)
    for a, b in enters:
        ea, eb = ents[a], ents[b]
        if (ea is not None and eb is not None and not ea.is_destroyed()
                and not eb.is_destroyed()):
            ea.on_enter_aoi(eb)


def test_on_aoi_batch_ordering_parity_with_legacy_and_jax():
    rng = np.random.default_rng(11)
    n = 10
    for trial in range(10):
        k_e, k_l = int(rng.integers(0, 30)), int(rng.integers(0, 30))

        def pairs(k):
            if k == 0:
                return np.empty((0, 2), np.int64)
            a = rng.integers(0, n, size=k)
            b = (a + 1 + rng.integers(0, n - 1, size=k)) % n
            return np.stack([a, b], axis=1).astype(np.int64)

        enters, leaves = pairs(k_e), pairs(k_l)
        legacy = [Recorder(i) for i in range(n)]
        legacy_delivery(legacy, enters, leaves)
        port = [Recorder(i) for i in range(n)]
        svc = delivery_service()
        for i, r in enumerate(port):
            svc._entities[i] = r
        svc._dispatch_events(enters, leaves)
        ref = [Recorder(i) for i in range(n)]
        jsvc = jbatched.BatchAOIService(jneighbor.NeighborParams(
            capacity=64, cell_size=100.0, grid_x=8, grid_z=8,
            space_slots=1, cell_capacity=16, max_events=256))
        for i, r in enumerate(ref):
            jsvc._entities[i] = r
        jsvc._dispatch_events(enters, leaves)
        for i in range(n):
            assert port[i].calls == legacy[i].calls == ref[i].calls, (
                trial, i)
            kinds = [k for k, _ in port[i].calls]
            assert kinds == sorted(kinds, key=lambda k: k == "enter")


def test_on_aoi_batch_single_callback_and_interest_parity():
    class BatchAvatar(tentity.Entity):
        def __init__(self):
            super().__init__()
            self.batches = []

        def on_aoi_batch(self, enters, leaves):
            self.batches.append((list(enters), list(leaves)))
            super().on_aoi_batch(enters, leaves)

    tem.register_space(classes(PORT)[0])
    svc = delivery_service()
    tem.register_entity(BatchAvatar).set_use_aoi(True)
    a, b, c = (tem.create_entity_locally("BatchAvatar") for _ in range(3))
    for i, e in enumerate((a, b, c)):
        svc._entities[i] = e
    enters = np.asarray([[0, 1], [0, 2], [1, 0], [2, 0]], np.int64)
    svc._dispatch_events(enters, np.empty((0, 2), np.int64))
    assert a.batches == [([b, c], [])]
    assert a.is_interested_in(b) and a.is_interested_in(c)
    assert b.is_interested_in(a) and c.is_interested_in(a)
    svc._dispatch_events(np.empty((0, 2), np.int64),
                         np.asarray([[0, 2], [2, 0]], np.int64))
    assert a.batches[1] == ([], [c])
    assert not a.is_interested_in(c) and a.is_interested_in(b)


def test_on_aoi_batch_skips_destroyed_mid_batch():
    class Mortal(Recorder):
        destroyed = False

        def is_destroyed(self):
            return self.destroyed

    class Killer(Recorder):
        def on_enter_aoi(self, other):
            super().on_enter_aoi(other)
            mortal.destroyed = True

    svc = delivery_service()
    mortal, killer, other = Mortal(2), Killer(0), Recorder(1)
    for i, e in enumerate((killer, other, mortal)):
        svc._entities[i] = e
    svc._dispatch_events(np.asarray([[0, 1], [1, 2], [2, 1]], np.int64),
                         np.empty((0, 2), np.int64))
    assert killer.calls == [("enter", 1)]
    assert other.calls == [] and mortal.calls == []


# --- [sync] tier writeback --------------------------------------------------------


class Duck:
    def is_destroyed(self):
        return False

    def on_enter_aoi(self, other):
        pass

    def on_leave_aoi(self, other):
        pass


def test_tier_writeback_lands_and_stale_version_is_discarded():
    slabs = EntitySlabs(32)
    slabs.configure_sync(SyncTuning(tier_cadences=(1, 4, 16),
                                    quantize_bits=7))
    params = tneighbor.NeighborParams(
        capacity=256, cell_size=100.0, grid_x=32, grid_z=32, space_slots=1,
        cell_capacity=16, max_events=1024)
    svc = tbatched.BatchAOIService(params, slabs=slabs, device="cpu")
    svc.warmup()
    ducks = [Duck() for _ in range(8)]
    slots = []
    for i, d in enumerate(ducks):
        sl = slabs.alloc(d)
        d._slot, d._slabs = sl, slabs
        svc.alloc_slot(d, 1, 6.0 * i * i, 0.0, 100.0)
        slots.append(sl)
    for i in range(len(slots) - 1):
        slabs.edge_add(slots[i], slots[i + 1])
    assert svc._tier_pass_active() and svc._verdicts_enabled
    captured = []
    step_async = svc.engine.step_async

    def spy(pos, active, space, radius, **kw):
        pending = step_async(pos, active, space, radius, **kw)
        captured.append((np.array(pos), kw.get("tiers"), pending.tiers))
        return pending

    svc.engine.step_async = spy
    # PyTorch compiles nothing: the device pass ships from the first tick.
    svc.tick()
    assert slabs.device_tiers
    for k in range(6):
        for d in ducks:  # move apart: the far tiers come into use
            slabs.xz[d._slot, 0] *= 1.15
            slabs.fused_dirty[d._slot] = True
        svc.tick()
    svc.flush()
    assert all(c[2] is not None for c in captured)
    ver, n, subj, wat = slabs.snapshot_edges_for_tiering()
    (prev, _, _), (cur, payload, tiers) = captured[-2], captured[-1]
    assert payload[0] == ver and payload[1] == n == len(slots) - 1
    d = cur[subj] - cur[wat]
    pd = prev[subj] - prev[wat]
    want = classify_tiers((d * d).sum(axis=1), slabs.radius[wat], 3,
                          slabs.sync.near_ratio, slabs.sync.far_ratio,
                          (pd * pd).sum(axis=1).astype(np.float32))
    got = np.asarray(tiers[2])[:n]
    np.testing.assert_array_equal(got, want)
    assert len(set(got.tolist())) > 1
    # The previous dispatch's vector landed on the edge table (each is
    # written back at the next dispatch; flush writes none)...
    np.testing.assert_array_equal(slabs._e_tier[:n],
                                  np.asarray(captured[-2][2][2])[:n])
    # ...and a vector computed against another edge layout is discarded.
    assert slabs.apply_device_tiers(ver - 1, n, np.zeros(64, np.uint8)) \
        is False


# --- the fused service (tests/test_columns.py's fused-service tests) -------------


def drift(x, y, z, yaw, dt, vx, hp):
    return x + vx * dt, y, z, yaw + dt, vx, hp - dt


def fused_world(pk, n=12, fuse=True, hook=drift):
    """An embedded runtime with one batched AOI space and ``n`` columnar
    avatars (``_fused_world`` of tests/test_columns.py)."""
    class FusedSpace(pk.Space):
        def on_space_created(self):
            if self.kind == 1:
                self.enable_aoi(100.0)

    class ColAvatar(pk.Entity):
        on_tick_batch = pk.columnar_tick(hook, ("vx", "hp"))

        @classmethod
        def describe_entity_type(cls, desc):
            desc.set_use_aoi(True, 100.0)
            desc.define_attr("vx", "Column")
            desc.define_attr("hp", "Column", default=100.0)

    rt = runtime(pk, params=FUSED_PARAMS, aoi_fuse_logic=fuse)
    pk.em.register_space(FusedSpace)
    pk.em.register_entity(ColAvatar)
    space = pk.em.create_space_locally(1)
    ents = []
    for i in range(n):
        e = pk.em.create_entity_locally(
            "ColAvatar", space=space, pos=pk.Vector3(10.0 * i, 0.0, 10.0))
        e.attrs["vx"] = 2.0
        ents.append(e)
    return ColAvatar, rt.aoi_service, ents


def test_fused_service_one_launch_trace_counts():
    cls, svc, ents = fused_world(PORT)
    hook = cls.on_tick_batch.__func__
    rt = tem.runtime
    x0 = [e.position.x for e in ents]
    tem.collect_entity_sync_infos()
    for _ in range(4):
        rt.tick()
    assert hook.jit_cache_size() == 0, "the fused class's host hook ran"
    progs, _ = svc._live_programs()
    assert progs and svc.engine.fused_trace_count(progs) == 1
    assert all(e.position.x > x for e, x in zip(ents, x0))
    assert all(e.attrs["hp"] < 100.0 for e in ents)
    flags = rt.slabs.flags[[e._slot for e in ents]]
    assert ((flags & (SIF_SYNC_OWN_CLIENT | SIF_SYNC_NEIGHBOR_CLIENTS))
            > 0).all()


def test_fused_service_host_writes_win():
    cls, svc, ents = fused_world(PORT, n=4)
    rt = tem.runtime
    # A fixed 0.1 s a tick: the drift after the teleport is 2 * 0.1 however
    # slow the host is.
    clock = FakeClock(time.monotonic())
    rt.now = svc.clock = clock

    def tick():
        rt.tick()
        clock.t += 0.1

    for _ in range(3):
        tick()
    e = ents[0]
    e.set_position(tvector.Vector3(555.0, 0.0, 7.0))
    tick()
    assert e.position.x == pytest.approx(555.0)
    tick()
    assert e.position.x == pytest.approx(555.2)


def test_fused_service_release_fences_writeback():
    cls, svc, ents = fused_world(PORT, n=4)
    rt = tem.runtime
    for _ in range(3):
        rt.tick()
    e = ents[0]
    slot = e._slot
    e.attrs["hp"] = 3.0
    e.destroy()
    slabs = rt.slabs
    assert slabs.columns["hp"][slot] == np.float32(100.0)
    rt.tick()
    assert slabs.columns["hp"][slot] == np.float32(100.0)
    assert slabs.flags[slot] == 0


def test_fused_fallback_for_hand_written_hooks():
    calls = []

    class Manual(tentity.Entity):
        @classmethod
        def on_tick_batch(cls, view):
            calls.append(len(view))

    cls, svc, ents = fused_world(PORT, n=3)
    tem.register_entity(Manual)
    tem.create_entity_locally("Manual")
    for _ in range(2):
        tem.runtime.tick()
    assert calls and calls[-1] == 1
    assert svc.takes_over_tick(cls) is True
    assert svc.takes_over_tick(Manual) is False


def test_unfused_service_ignores_fuse_machinery():
    cls, svc, ents = fused_world(PORT, n=3, fuse=False)
    hook = cls.on_tick_batch.__func__
    x0 = [e.position.x for e in ents]
    for _ in range(3):
        tem.runtime.tick()
    assert hook.jit_cache_size() == 1  # the host hook did the work
    assert all(e.position.x > x for e, x in zip(ents, x0))
    assert svc._pending is None or svc._pending[0].fused is None


def test_fused_freeze_restore_preserves_columns():
    cls, svc, ents = fused_world(PORT, n=6)
    rt = tem.runtime
    tem.create_nil_space(rt.gameid)
    for _ in range(3):
        rt.tick()
    svc.flush()
    hp_before = {e.id: e.attrs["hp"] for e in ents}
    x_before = {e.id: e.position.x for e in ents}
    data = tem.freeze_entities(rt.gameid)
    tem.reset_world()
    rt = tem.runtime
    rt.aoi_backend = "batched"
    rt.aoi_device = "cpu"
    rt.aoi_params = tneighbor.NeighborParams(**FUSED_PARAMS)
    rt.aoi_fuse_logic = True
    rt.get_aoi_service()
    tem.restore_freezed_entities(data)
    for e in [tem.get_entity(i) for i in hp_before]:
        assert e.attrs["hp"] == pytest.approx(hp_before[e.id])
        assert e.position.x == pytest.approx(x_before[e.id])
    rt.slabs.prewarm_tick_hooks()
    svc2 = rt.aoi_service
    progs, _ = svc2._live_programs()
    assert progs and svc2.engine.fused_trace_count(progs) == 1
    rt.tick()
    rt.tick()
    assert svc2.engine.fused_trace_count(progs) == 1
    assert cls.on_tick_batch.__func__.jit_cache_size() == 0


def test_fused_migrate_races_inflight_tick():
    cls, svc, ents = fused_world(PORT, n=4)
    rt = tem.runtime
    for _ in range(3):
        rt.tick()
    e = ents[0]
    eid = e.id
    hp_at_pack = e.attrs["hp"]
    data = e.get_migrate_data()
    assert data["attrs"]["hp"] == pytest.approx(hp_at_pack)
    e._destroy(is_migrate=True)
    rt.tick()
    restored = tem.restore_entity(eid, data, is_migrate=True)
    assert restored.attrs["hp"] == pytest.approx(hp_at_pack)
    rt.tick()
    rt.tick()
    assert restored.attrs["hp"] < hp_at_pack


class FakeClock:
    """A clock both runs read: one step a tick, from a given start."""

    def __init__(self, t):
        self.t = t

    def __call__(self):
        return self.t


def play_trajectory(pk, fuse, monkeypatch, ticks=8):
    """Columnar avatars with seeded velocities, ``ticks`` runtime ticks at
    a fixed 0.25 s step, then a flush: positions, yaw and columns."""
    cls, svc, ents = fused_world(pk, n=24, fuse=fuse)
    rng = np.random.default_rng(9)
    for e in ents:
        e.set_position(pk.Vector3(float(rng.uniform(0, 1200)), 0.0,
                                  float(rng.uniform(0, 1200))))
        e.attrs["vx"] = float(rng.normal(0, 30))
    rt = pk.em.runtime
    # The unfused hook's first dt is now - its class's registration time;
    # the fused step's first dt is 0: start the clock at that registration.
    clock = FakeClock(rt.slabs._tick_buckets[cls].last_tick)
    rt.now = clock
    if pk is PORT:
        svc.clock = clock
    else:
        monkeypatch.setattr(pk.batched, "time", types.SimpleNamespace(
            monotonic=clock, perf_counter=time.perf_counter,
            sleep=time.sleep))
    for _ in range(ticks):
        rt.tick()
        clock.t += 0.25
    svc.flush()
    slabs = rt.slabs
    sl = [e._slot for e in ents]
    return (slabs.xz[sl].copy(), slabs.yaw[sl].copy(),
            slabs.columns["hp"][sl].copy(), cls)


def test_fused_trajectory_matches_unfused_and_jax(monkeypatch):
    fused = play_trajectory(PORT, True, monkeypatch)
    assert fused[3].on_tick_batch.__func__.jit_cache_size() == 0
    unfused = play_trajectory(PORT, False, monkeypatch)
    assert unfused[3].on_tick_batch.__func__.jit_cache_size() == 1
    ref = play_trajectory(JAX, True, monkeypatch)
    for a, b, c in zip(fused[:3], unfused[:3], ref[:3]):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(a, c, rtol=FUSED_RTOL, atol=0)
    assert not np.array_equal(fused[2], np.full(24, 100.0, np.float32))


# --- device choice and the sharded tiers -------------------------------------------


def test_service_runs_on_cuda_unless_told_and_refuses_unported_tiers(
        monkeypatch):
    """The service's device defaults to CUDA and raises without it; each
    tier setting builds its engine: ``shard_mode="entity"`` the
    entity-sharded engine, ``"spatial"`` the strip engine, an unknown mode
    raises, and ``multihost=True`` needs a process group, then builds the
    multi-process engine at full capacity (the name is kept from the
    slices where the last two tiers were not ported and raised)."""
    import torch.distributed as dist

    from goworld_tpu_torch.parallel import multihost as mh
    from goworld_tpu_torch.parallel.mesh import ShardedNeighborEngine
    from goworld_tpu_torch.parallel.spatial import (
        SpatialShardedNeighborEngine,
    )

    p = tneighbor.NeighborParams(capacity=64, cell_size=100.0, grid_x=8,
                                 grid_z=8, space_slots=1, cell_capacity=16,
                                 max_events=256)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tbatched.BatchAOIService(p)
        rt = tem.runtime
        rt.aoi_backend = "batched"
        with pytest.raises(RuntimeError, match="CUDA"):
            rt.get_aoi_service()
        with pytest.raises(RuntimeError, match="CUDA"):
            rt.logic_device()
    else:
        assert tbatched.BatchAOIService(p).device.type == "cuda"
    svc = tbatched.BatchAOIService(p, device="cpu")
    assert svc.device == torch.device("cpu")
    assert svc.engine.device == torch.device("cpu")
    grid16 = tneighbor.NeighborParams(capacity=64, cell_size=100.0,
                                      grid_x=16, grid_z=16, space_slots=1,
                                      cell_capacity=16, max_events=256)
    svc = tbatched.BatchAOIService(grid16, mesh_shards=2,
                                   shard_mode="entity", device="cpu")
    assert isinstance(svc.engine, ShardedNeighborEngine)
    assert svc.engine.backend == "kernel" and svc.engine.n_devices == 2
    svc = tbatched.BatchAOIService(grid16, mesh_shards=2, device="cpu")
    assert isinstance(svc.engine, SpatialShardedNeighborEngine)
    with pytest.raises(ValueError, match="shard_mode"):
        tbatched.BatchAOIService(p, mesh_shards=2, shard_mode="allgather",
                                 device="cpu")
    with pytest.raises(RuntimeError, match="init_multihost"):
        tbatched.BatchAOIService(p, multihost=True, device="cpu")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    mh.init_multihost(f"127.0.0.1:{port}", 1, 0, timeout_s=30.0)
    try:
        svc = tbatched.BatchAOIService(p, multihost=True, device="cpu")
        assert isinstance(svc.engine, mh.MultiHostNeighborEngine)
        assert svc.engine.backend == "reference"
        assert svc.params == p  # one process: the alignment is 8 already
        assert (svc.engine.local_lo, svc.engine.local_capacity) == (0, 64)
        assert svc._next_tier() is None  # full capacity at once
        assert svc.alloc_space_id() == 2  # seq * nprocs + pid + 1
    finally:
        dist.destroy_process_group()
        monkeypatch.setattr(mh, "_STORE", None)


@pytest.mark.parametrize("pk", [JAX, PORT], ids=lambda pk: pk.name)
def test_batched_aoi_entity_shard_mode_wired(pk):
    """``[aoi] shard_mode = entity`` reaches the entity-sharded engine
    through the runtime (tests/test_entity.py:450), in both packages:
    two avatars 50 apart see each other after two ticks."""
    rt = runtime(pk, aoi_mesh_shards=2, aoi_shard_mode="entity")
    space_cls, avatar, _ = classes(pk)
    pk.em.register_space(space_cls)
    pk.em.register_entity(avatar)
    sp = two_spaces(pk)[0]
    svc = rt.get_aoi_service()
    if pk is PORT:
        from goworld_tpu_torch.parallel.mesh import ShardedNeighborEngine
    else:
        from goworld_tpu.parallel.mesh import ShardedNeighborEngine
    assert isinstance(svc.engine, ShardedNeighborEngine)
    a = pk.em.create_entity_locally("Avatar")
    b = pk.em.create_entity_locally("Avatar")
    sp._enter(a, pk.Vector3(0, 0, 0))
    sp._enter(b, pk.Vector3(50, 0, 0))
    rt.tick()
    rt.tick()
    assert a.is_interested_in(b) and b.is_interested_in(a)


def churn_tier_writebacks(pk):
    """A moving world with [sync] tiers on: how many device tier vectors
    were written back over 12 steady ticks, each tick with AOI events."""
    rt = runtime(pk)
    rt.slabs.configure_sync(pk.SyncTuning(tier_cadences=(1, 4, 16)))
    space_cls, _, monster = classes(pk)
    pk.em.register_space(space_cls)
    pk.em.register_entity(monster)
    sp = two_spaces(pk)[0]
    rng = np.random.default_rng(4)
    ents = []
    for _ in range(60):
        e = pk.em.create_entity_locally("Monster")
        sp._enter(e, pk.Vector3(*rng.uniform(0, 400, 3)))
        ents.append(e)
    landed, events = [], []
    apply_tiers = rt.slabs.apply_device_tiers
    rt.slabs.apply_device_tiers = lambda *a: landed.append(apply_tiers(*a))
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:  # JAX: until the pass engages
        rt.tick()
        if rt.slabs.device_tiers:
            break
    for _ in range(3):
        rt.tick()
    landed.clear()
    for _ in range(12):
        for e in ents:
            p = e.position
            e.set_position(pk.Vector3(p.x + rng.normal(0, 20), 0,
                                      p.z + rng.normal(0, 20)))
        events.append(rt.aoi_service.tick())
    return landed, events


def test_tier_vectors_are_discarded_under_edge_churn_in_both_packages():
    """The JAX service's tier writeback is discarded whenever the edge
    table changed between the snapshot (dispatch t) and the writeback
    (dispatch t+1), and pipelined delivery of tick t-1's events changes it
    in between on every tick with events: under steady churn no device
    tier vector lands (ROADMAP queue 3). The port keeps that behaviour."""
    port, port_events = churn_tier_writebacks(PORT)
    ref, ref_events = churn_tier_writebacks(JAX)
    # Tick 1 delivers the settled world's step; every later one has events.
    assert port_events[0] == (0, 0)
    assert all(e + l > 0 for e, l in port_events[1:])
    # The JAX service ships no tier pass while a grown edge capacity's
    # variant compiles, so it attempts fewer writebacks.
    assert len(port) == 12 and len(ref) > 2
    assert port[:2] == [True, True] and not any(port[2:])
    assert not any(ref[2:])
