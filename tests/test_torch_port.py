"""The port as a package: what it imports, and what it does on a CUDA card.

The ``cuda`` tests need an NVIDIA GPU and skip without one; on the card
they build the kernels from ``goworld_tpu_torch/ops/csrc`` and hold each
against its plain version. This file imports no jax, so it also runs on a
machine with the card and no jax.
"""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from chip_smoke import (
    BOIDS_SKIP_EDGE, boids_skip_edge_cells, lattice_cells, lattice_plane,
    seam_world, skip_edge_cells,
)
from goworld_tpu_torch.ops import boids as tb
from goworld_tpu_torch.ops import boids_kernel as bk
from goworld_tpu_torch.ops import event_kernel as ek
from goworld_tpu_torch.ops import neighbor as tn
from goworld_tpu_torch.parallel import make_mesh
from goworld_tpu_torch.parallel import mesh as tm
from goworld_tpu_torch.parallel import spatial as ts

ROOT = Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "goworld_tpu_torch"


def port_modules():
    """Every importable module of the port; the ``__main__`` modules are
    process entry points (importing one runs a dispatcher, a gate, a bot
    fleet or a game) and are held by the source scan below instead."""
    return sorted(
        ".".join(f.relative_to(ROOT).with_suffix("").parts).removesuffix(
            ".__init__")
        for f in PACKAGE.rglob("*.py") if f.name != "__main__.py"
    )


def test_port_imports_neither_jax_nor_the_jax_package():
    mods = port_modules()
    for m in ("ops.neighbor", "ops.event_kernel", "ops.boids",
              "ops.boids_kernel", "parallel", "parallel.mesh",
              "parallel.spatial", "entity", "entity.attrs",
              "entity.columns", "entity.slabs", "entity.entity",
              "entity.entity_manager", "entity.space", "entity.aoi",
              "entity.aoi.batched", "entity.aoi.xzlist", "utils.gwlog",
              "utils.opmon", "utils.timer", "telemetry",
              "telemetry.metrics", "proto", "proto.conn",
              "dispatchercluster", "common", "consts", "game",
              "game.service", "cli", "dispatcher", "dispatcher.service",
              "gate", "gate.service", "client", "client.bot_runner",
              "config", "config.read_config", "facade",
              "examples.test_game", "examples.test_game.server",
              "graft_entry", "native", "netutil", "telemetry.sentinel",
              "utils.debug_http", "dispatchercluster.cluster",
              "scenarios", "scenarios.runner", "scenarios.hotspot",
              "scenarios.battle_royale", "scenarios.service_heavy",
              "telemetry.postmortem", "chaos", "chaos.harness",
              "chaos.multigame", "chaos.botfleet", "chaos.mg_server",
              "chaos.game_proc", "tools", "tools.gwtop", "tools.gwpost",
              "tools.tracecat", "bench"):
        assert f"goworld_tpu_torch.{m}" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith(('jax.', 'jaxlib', 'goworld_tpu.')) "
        "or m == 'goworld_tpu')\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


def test_port_sources_name_no_jax_package_import():
    files = sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for rel in ("parallel/spatial.py", "entity/aoi/batched.py",
                "entity/entity_manager.py", "entity/columns.py",
                "utils/gwlog.py", "telemetry/metrics.py", "proto/conn.py",
                "dispatchercluster/__init__.py", "common/__init__.py",
                "game/service.py", "cli.py", "dispatcher/__main__.py",
                "gate/__main__.py", "client/__main__.py",
                "config/read_config.py", "facade.py",
                "examples/test_game/__main__.py",
                "examples/test_game/server.py", "graft_entry.py",
                "scenarios/runner.py", "scenarios/service_heavy.py",
                "chaos/harness.py", "chaos/multigame.py", "bench.py",
                "tools/tracecat.py"):
        assert PACKAGE / rel in files
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "goworld_tpu"), (f, name)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels run only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dual", [False, True])
def test_cuda_kernel_matches_plain_version(cuda, dual):
    cells = torch.tensor(lattice_cells(2, 6, 5, seed=1), device=cuda)
    before = ek.launches[ek.FORMS[int(dual)]]
    got = ek.event_mask(cells, dual)
    assert ek.launches[ek.FORMS[int(dual)]] == before + 1
    want = ek.event_mask_reference(cells, dual)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    skipped = ek.event_mask(cells, dual, skip=torch.ones(
        (), dtype=torch.bool, device=cuda))
    assert skipped.shape == want.shape


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["reference", "kernel"])
def test_cuda_engine_matches_cpu_engine(cuda, backend):
    p = tn.NeighborParams(capacity=256, cell_size=100.0, grid_x=8, grid_z=8,
                          space_slots=2, cell_capacity=64, max_events=64)
    engines = [tn.NeighborEngine(p, backend=backend, device=d)
               for d in ("cpu", cuda)]
    for e in engines:
        e.reset()
    rng = np.random.default_rng(3)
    pos = rng.uniform(0, 800, (256, 2)).astype(np.float32)
    active = rng.random(256) < 0.9
    space = rng.integers(0, 3, 256).astype(np.int32)
    radius = np.full(256, 60.0, np.float32)
    for k in range(4):
        if k == 2:
            pos[:9] = rng.uniform(0, 800, (9, 2))
        outs = [e.step(pos, active, space, radius) for e in engines]
        assert np.array_equal(outs[0][0], outs[1][0])
        assert np.array_equal(outs[0][1], outs[1][1])
        assert outs[0][2] == outs[1][2]
        pos = np.clip(pos + rng.normal(0, 3, pos.shape), 0, 800)
        pos = pos.astype(np.float32)


BOIDS_CASES = {
    "seam_cluster": dict(capacity=512, cell_size=100.0, grid_x=8, grid_z=8),
    "supercells": dict(capacity=512, cell_size=250.0, grid_x=4, grid_z=4,
                       radius=100.0),
    "skip_edge": BOIDS_SKIP_EDGE,  # the kernel at boids_skip_edge_cells
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(BOIDS_CASES))
def test_cuda_boids_kernel_matches_plain_version(cuda, case):
    p = tb.BoidsParams(**BOIDS_CASES[case])
    world = [torch.tensor(a, device=cuda) for a in seam_world(p)]
    if case == "skip_edge":
        cells = torch.tensor(boids_skip_edge_cells(), device=cuda)
    else:
        cells, _ = tb._build_cells(p, *world)
    before = bk.launches["boids"]
    got = bk.boids_accel(cells, p)
    assert bk.launches["boids"] == before + 1
    want = bk.boids_accel_reference(cells, p)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 1e-4
    # The whole step: the default engine on the card against the CPU one.
    pos, vel, accel = tb.BoidsEngine(p).step(*world)
    cpu = tb.BoidsEngine(p, device="cpu").step(*(a.cpu() for a in world))
    assert float((accel.cpu() - cpu[2]).abs().max()) <= 1e-4
    assert float((vel.cpu() - cpu[1]).abs().max()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("dual", [False, True])
@pytest.mark.parametrize("drain", [100, 1 << 20])  # overflowing, not
def test_cuda_drain_kernel_matches_plain_version(cuda, dual, drain):
    cells_np = lattice_cells(2, 6, 5, seed=1)
    cells = torch.tensor(cells_np, device=cuda)
    plane = torch.tensor(lattice_plane(cells_np, seed=2), device=cuda)
    form = ek.DRAIN_FORMS[int(dual)]
    before = ek.launches[form]
    words, pairs = ek.event_drain(cells, plane, dual, drain, 8192)
    assert ek.launches[form] == before + 1
    want_w, want_p = ek.event_drain_reference(cells, plane, dual, drain,
                                              8192)
    torch.cuda.synchronize()
    cols = drain * (2 if dual else 1)
    assert torch.equal(words, want_w)
    assert torch.equal(pairs[:, :cols], want_p[:, :cols])
    skip = torch.ones((), dtype=torch.bool, device=cuda)
    skipped = ek.event_drain(cells, plane, dual, drain, 8192, skip=skip)
    assert skipped[1].shape == want_p.shape


@pytest.mark.cuda
@pytest.mark.parametrize("dual", [False, True])
def test_cuda_kernels_match_plain_version_at_skip_edges(cuda, dual):
    """The mask and drain forms at cells whose empty query lanes and empty
    candidate chunks the kernel skips (chip_smoke.skip_edge_cells)."""
    cells_np = skip_edge_cells(2, 6, 5, seed=5)
    cells = torch.tensor(cells_np, device=cuda)
    plane = torch.tensor(lattice_plane(cells_np, seed=2, either_epoch=True),
                         device=cuda)
    got = ek.event_mask(cells, dual)
    assert torch.equal(got, ek.event_mask_reference(cells, dual))
    for drain in (100, 1 << 20):  # overflowing, not
        words, pairs = ek.event_drain(cells, plane, dual, drain, 8192)
        want_w, want_p = ek.event_drain_reference(cells, plane, dual, drain,
                                                  8192)
        cols = drain * (2 if dual else 1)
        assert torch.equal(words, want_w)
        assert torch.equal(pairs[:, :cols], want_p[:, :cols])


def strip_engine_matches_single_device_engine(mesh, inkernel_drain,
                                              backend="kernel"):
    """8 strips on ``mesh`` against the single-device kernel engine on the
    first card: a storm past the inline budget, steady drift, despawns and
    a teleport (the all-gather fallback)."""
    p = tn.NeighborParams(capacity=2048, cell_size=100.0, grid_x=64,
                          grid_z=8, space_slots=2, cell_capacity=64,
                          max_events=1024)
    strips = ts.SpatialShardedNeighborEngine(p, mesh, strip_cols=10,
                                             inkernel_drain=inkernel_drain,
                                             backend=backend)
    single = tn.NeighborEngine(p)
    assert strips.mesh == mesh
    strips.reset()
    single.reset()
    rng = np.random.default_rng(5)
    pos = rng.uniform(0, [6400, 800], (2048, 2)).astype(np.float32)
    active = rng.random(2048) < 0.8
    space = rng.integers(0, 2, 2048).astype(np.int32)
    radius = np.full(2048, 100.0, np.float32)
    modes = []
    for k in range(5):
        if k == 3:
            active = active & (rng.random(2048) < 0.95)
        if k == 4:
            pos[:20] = rng.uniform(0, [6400, 800], (20, 2))
        got = strips.step(pos, active, space, radius)
        want = single.step(pos, active, space, radius)
        modes.append(strips.last_mode)
        for i in (0, 1):
            assert len(got[i]) == len(want[i])
            assert (sorted(map(tuple, got[i].tolist()))
                    == sorted(map(tuple, want[i].tolist())))
        assert got[2] == want[2]
        pos = np.clip(pos + rng.normal(0, 3, pos.shape), 0,
                      [6400, 799]).astype(np.float32)
    assert modes[:4] == ["spatial"] * 4 and modes[4] == "fallback:teleport"


@pytest.mark.cuda
@pytest.mark.parametrize("inkernel_drain", [True, False])
def test_cuda_strip_engine_matches_single_device_engine(cuda,
                                                        inkernel_drain):
    mesh = make_mesh(8)
    assert mesh == [torch.device("cuda", torch.cuda.current_device())] * 8
    strip_engine_matches_single_device_engine(mesh, inkernel_drain)


@pytest.mark.cuda
def test_cuda_strip_reference_backend_matches_single_device_engine(cuda):
    strip_engine_matches_single_device_engine(make_mesh(8), False,
                                              backend="reference")


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["reference", "kernel"])
def test_cuda_sharded_engine_matches_single_device_engine(cuda, backend):
    """8 entity shards on the card against the single-device kernel engine:
    a storm past every shard's inline budget, drift, despawns, a teleport.
    Four space slots, so the slab program copies each shard's slab."""
    p = tn.NeighborParams(capacity=4096, cell_size=100.0, grid_x=16,
                          grid_z=16, space_slots=4, cell_capacity=64,
                          max_events=1024)
    sharded = tm.ShardedNeighborEngine(p, make_mesh(8), backend=backend)
    single = tn.NeighborEngine(p)
    sharded.reset()
    single.reset()
    rng = np.random.default_rng(9)
    pos = rng.uniform(0, 1600, (4096, 2)).astype(np.float32)
    active = rng.random(4096) < 0.8
    space = rng.integers(0, 6, 4096).astype(np.int32)
    radius = np.full(4096, 100.0, np.float32)
    before = dict(ek.launches)
    for k in range(5):
        if k == 3:
            active = active & (rng.random(4096) < 0.95)
        if k == 4:
            pos[:20] = rng.uniform(0, 1600, (20, 2))
        got = sharded.step(pos, active, space, radius)
        want = single.step(pos, active, space, radius)
        for i in (0, 1):
            assert len(got[i]) == len(want[i])
            assert (sorted(map(tuple, got[i].tolist()))
                    == sorted(map(tuple, want[i].tolist())))
        assert got[2] == want[2]
        if k == 0:
            assert len(got[0]) > p.max_events
        pos = np.clip(pos + rng.normal(0, 3, pos.shape), 0,
                      1600).astype(np.float32)
    if backend == "kernel":  # 8 shards' launches of each form, 5 ticks;
        # the single-device engine adds one of each a tick
        for form in ek.FORMS:
            assert ek.launches[form] - before[form] == 5 * 8 + 5


@pytest.mark.cuda
def test_cuda_strip_engine_spread_over_cards(cuda):
    """The strips spread over every card of the machine: the bands, the
    guard's reductions, the counts and the fallback's all-gather cross
    cards."""
    cards = torch.cuda.device_count()
    if cards < 2:
        pytest.skip("needs two or more CUDA devices")
    mesh = make_mesh(8, [f"cuda:{k}" for k in range(cards)])
    assert len(set(mesh)) == cards
    strip_engine_matches_single_device_engine(mesh, True)


def play_service(device, fuse):
    """A columnar world through the port's runtime on ``device``: the
    same seeded spawns, moves, space hops and despawns, with ``[sync]``
    tiers and fused delivery on, at a fixed dt. Returns each tick's
    delivered (enters, leaves), settled interest sets, and the final
    positions and columns."""
    from goworld_tpu_torch.entity import entity_manager as em
    from goworld_tpu_torch.entity.columns import columnar_tick
    from goworld_tpu_torch.entity.entity import Entity
    from goworld_tpu_torch.entity.slabs import SyncTuning
    from goworld_tpu_torch.entity.space import Space
    from goworld_tpu_torch.entity.vector import Vector3

    def drift(x, y, z, yaw, dt, vx, vz):
        return x + vx * dt, y, z + vz * dt, yaw + 10.0 * dt, vx, vz

    class CardSpace(Space):
        @classmethod
        def describe_entity_type(cls, desc):
            desc.define_attr("_EnableAOI", "Persistent")

    class Walker(Entity):
        on_tick_batch = columnar_tick(drift, ("vx", "vz"))

        @classmethod
        def describe_entity_type(cls, desc):
            desc.set_use_aoi(True, 100.0)
            desc.define_attr("vx", "Column")
            desc.define_attr("vz", "Column")

    em.cleanup_for_tests()
    rt = em.runtime
    rt.aoi_backend = "batched"
    rt.aoi_device = device
    rt.aoi_fuse_logic = fuse
    rt.aoi_params = tn.NeighborParams(
        capacity=1024, cell_size=100.0, grid_x=16, grid_z=16,
        space_slots=2, cell_capacity=64, max_events=4096)
    rt.slabs.configure_sync(SyncTuning(tier_cadences=(1, 4, 16)))
    em.register_space(CardSpace)
    em.register_entity(Walker)
    spaces = [em.create_space_locally(kind=k) for k in (1, 2)]
    for sp in spaces:
        sp.enable_aoi(100.0)
    rng = np.random.default_rng(17)
    ents = []
    for i in range(600):
        e = em.create_entity_locally("Walker")
        spaces[i % 2]._enter(e, Vector3(*rng.uniform(0, 1600, 3)))
        e.attrs["vx"] = float(rng.normal(0, 20))
        e.attrs["vz"] = float(rng.normal(0, 20))
        ents.append(e)
    svc = rt.aoi_service
    assert svc.device.type == torch.device(device).type
    t = [rt.slabs._tick_buckets[Walker].last_tick]
    rt.now = lambda: t[0]
    svc.clock = rt.now
    delivered, sets = [], []
    for k in range(12):
        if k == 6:  # churn: despawns and a space hop
            for e in ents[:20]:
                e.destroy()
            e = ents[30]
            e.space._leave(e)
            spaces[0]._enter(e, Vector3(5.0, 0.0, 5.0))
        rt.timer_service.tick()
        rt.slabs.run_tick_batches(rt.now())
        delivered.append(svc.tick())
        t[0] += 0.5
    svc.flush()
    live = [e for e in ents if not e.is_destroyed()]
    index = {e.id: i for i, e in enumerate(ents)}  # ids differ per run
    sets = {index[e.id]: sorted(index[o.id] for o in e.interested_in)
            for e in live}
    slots = [e._slot for e in live]
    out = (rt.slabs.xz[slots].copy(), rt.slabs.columns["vx"][slots].copy())
    em.cleanup_for_tests()
    return delivered, sets, out


@pytest.mark.cuda
@pytest.mark.parametrize("fuse", [False, True])
def test_cuda_service_matches_cpu_service(cuda, fuse):
    """The batched AOI service on the card against the same service on
    the CPU, tick by tick: the delivered event counts of every tick, the
    settled interest sets, and the positions and columns bit for bit."""
    a = play_service("cuda", fuse)
    b = play_service("cpu", fuse)
    assert a[0] == b[0]
    assert sum(e for e, _ in a[0][1:]) > 0
    assert a[1] == b[1]
    for x, y in zip(a[2], b[2]):
        np.testing.assert_array_equal(x, y)


def boot_game_and_tick(tmp_path, platform):
    """The port's dispatcher and a ``GameService`` in-process with
    ``[aoi] backend = tpu`` and ``platform``: a space of 200 AOI walkers
    ticks for a second. Returns the AOI service's device type and the
    sentinel's AOI step count after the boot's warmup and at the end."""
    import asyncio

    from goworld_tpu_torch.config import read_config as rc
    from goworld_tpu_torch.dispatcher import DispatcherService
    from goworld_tpu_torch.entity import entity_manager as em
    from goworld_tpu_torch.entity.entity import Entity
    from goworld_tpu_torch.entity.space import Space
    from goworld_tpu_torch.entity.vector import Vector3
    from goworld_tpu_torch.game import GameService
    from goworld_tpu_torch.telemetry import sentinel

    class CardSpace(Space):
        @classmethod
        def describe_entity_type(cls, desc):
            desc.define_attr("_EnableAOI", "Persistent")

    class Walker(Entity):
        @classmethod
        def describe_entity_type(cls, desc):
            desc.set_use_aoi(True, 100.0)

    label = "aoi_step_kernel" if platform != "cpu" else "aoi_step_reference"

    async def run():
        disp = DispatcherService(1, desired_games=1, desired_gates=0)
        await disp.start()
        cfg = rc.GoWorldConfig()
        cfg.dispatchers = {1: rc.DispatcherConfig(port=disp.port)}
        cfg.games = {1: rc.GameConfig(save_interval=0.0,
                                      position_sync_interval=0.02)}
        cfg.storage = rc.StorageConfig(type="filesystem",
                                       directory=str(tmp_path / "es"))
        cfg.kvdb = rc.KVDBConfig(type="filesystem",
                                 directory=str(tmp_path / "kv"))
        cfg.aoi = rc.AOIConfig(backend="tpu", platform=platform,
                               max_entities=1024)
        em.register_space(CardSpace)
        em.register_entity(Walker)
        svc = GameService(1, cfg)
        task = asyncio.get_running_loop().create_task(svc.run_async())
        while em.runtime.aoi_service is None or not svc._started_at:
            await asyncio.sleep(0.01)
        await asyncio.sleep(0.2)
        booted = sentinel.launches_total(label)
        space = em.create_space_locally(kind=1)
        space.enable_aoi(100.0)
        rng = np.random.default_rng(3)
        walkers = []
        for _ in range(200):
            w = em.create_entity_locally("Walker")
            space._enter(w, Vector3(*rng.uniform(0, 800, 3)))
            walkers.append(w)
        for _ in range(50):
            for w in walkers[:50]:
                p = w.position
                w.set_position(Vector3(p.x + 1.0, p.y, p.z))
            await asyncio.sleep(0.02)
        dev = em.runtime.aoi_service.device.type
        svc.terminate()
        assert await asyncio.wait_for(task, timeout=30) == 0
        await disp.stop()
        return dev, booted, sentinel.launches_total(label)

    em.cleanup_for_tests()
    try:
        return asyncio.run(run())
    finally:
        em.cleanup_for_tests()


@pytest.mark.cuda
def test_cuda_game_boots_on_the_card(cuda, tmp_path, monkeypatch):
    """A game with ``platform = auto`` puts its batched AOI service on the
    card, warms it up there before the ready barrier, and counts its AOI
    steps (``jit_launches_total{fn="aoi_step_kernel"}``) as it ticks."""
    monkeypatch.chdir(tmp_path)
    dev, booted, final = boot_game_and_tick(tmp_path, "auto")
    assert dev == "cuda"
    assert booted >= 1  # the boot's warmup step
    assert final > booted


def freeze_after_fused_ticks(device):
    """A fused columnar world on ``device`` ticks with a step in flight,
    then freezes as ``GameService._do_freeze`` does (flush, then
    ``freeze_entities``). Returns the freeze data."""
    from goworld_tpu_torch.entity import entity_manager as em
    from goworld_tpu_torch.entity.columns import columnar_tick
    from goworld_tpu_torch.entity.entity import Entity
    from goworld_tpu_torch.entity.space import Space
    from goworld_tpu_torch.entity.vector import Vector3

    def drift(x, y, z, yaw, dt, vx, vz):
        return x + vx * dt, y, z + vz * dt, yaw, vx, vz

    class FreezeSpace(Space):
        @classmethod
        def describe_entity_type(cls, desc):
            desc.define_attr("_EnableAOI", "Persistent")

    class Drifter(Entity):
        on_tick_batch = columnar_tick(drift, ("vx", "vz"))

        @classmethod
        def describe_entity_type(cls, desc):
            desc.set_use_aoi(True, 100.0)
            desc.define_attr("vx", "Column")
            desc.define_attr("vz", "Column")

    em.cleanup_for_tests()
    try:
        rt = em.runtime
        rt.gameid = 1
        rt.aoi_backend = "batched"
        rt.aoi_device = device
        rt.aoi_fuse_logic = True
        rt.aoi_params = tn.NeighborParams(
            capacity=512, cell_size=100.0, grid_x=8, grid_z=8,
            space_slots=2, cell_capacity=64, max_events=2048)
        em.register_space(FreezeSpace)
        em.register_entity(Drifter)
        em.create_nil_space(1)
        sp = em.create_space_locally(kind=1)
        sp.enable_aoi(100.0)
        rng = np.random.default_rng(5)
        for _ in range(200):
            e = em.create_entity_locally("Drifter")
            sp._enter(e, Vector3(*rng.uniform(0, 700, 3)))
            e.attrs["vx"] = float(rng.normal(0, 5))
            e.attrs["vz"] = float(rng.normal(0, 5))
        svc = rt.aoi_service
        for _ in range(4):
            rt.slabs.run_tick_batches()
            svc.tick()  # the last step stays in flight
        svc.flush()
        return em.freeze_entities(1)
    finally:
        em.cleanup_for_tests()


def no_tensor_in(obj) -> bool:
    if isinstance(obj, torch.Tensor):
        return False
    if isinstance(obj, dict):
        return all(no_tensor_in(k) and no_tensor_in(v)
                   for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return all(no_tensor_in(v) for v in obj)
    return True


@pytest.mark.cuda
def test_cuda_freeze_data_holds_no_tensor(cuda):
    """A freeze on the card under ``[aoi] fuse_logic`` (fused programs
    writing Column attrs back from the device): the freeze data holds
    plain values only and dumps to JSON, as the game writes it."""
    import json

    data = freeze_after_fused_ticks("cuda")
    assert no_tensor_in(data)
    assert len(data["entities"]) == 200
    json.dumps(data)


def test_game_boots_and_counts_steps_on_cpu(tmp_path, monkeypatch):
    """``platform = cpu``: the game's batched service runs the plain
    versions, and the sentinel counts its AOI steps as on the card."""
    monkeypatch.chdir(tmp_path)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        dev, booted, final = boot_game_and_tick(tmp_path, "cpu")
    finally:
        torch.set_num_threads(threads)
    assert dev == "cpu"
    assert booted >= 1 and final > booted


def test_freeze_data_holds_no_tensor_on_cpu():
    import json

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        data = freeze_after_fused_ticks("cpu")
    finally:
        torch.set_num_threads(threads)
    assert no_tensor_in(data)
    assert len(data["entities"]) == 200
    json.dumps(data)


# --- the multi-process tier's device route over NCCL -------------------------


def cards_or_skip(k: int) -> list[str]:
    from chip_smoke import visible_cards

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cards = visible_cards()
    if len(cards) < k:
        pytest.skip(f"needs {k} CUDA devices, this machine has {len(cards)}")
    return cards


@pytest.mark.cuda
def test_cuda_multihost_device_route_matches_single_device_engine(tmp_path):
    """Two processes on two cards take the device route: each uploads its
    own rows and the gather runs on the cards over NCCL; on both backends
    the union of their events equals the single-device engine's on every
    tick (chip_smoke's multihost world, the storm paged)."""
    import chip_smoke as cs

    cards = cards_or_skip(2)
    data = cs.run_multihost_workers(ROOT, tmp_path, "multihost", 2,
                                    cards[:2])
    assert [str(d["route"]) for d in data] == ["device", "device"]
    p = tn.NeighborParams(**cs.MULTIHOST)
    single = tn.NeighborEngine(p, backend="kernel", device="cuda")
    single.reset()
    want = [single.step(*w) for _, w, _ in cs.multihost_trace(p.capacity)]
    for backend in ("reference", "kernel"):
        cs.hold_multihost_run(data, want, p.capacity, backend, "two cards")


def run_nccl_workers(tmp_path, mode, cards, extra_env=None, timeout=180):
    """Two processes of this file's worker (``mode``), seeing ``cards``;
    their (return code, output), rank order."""
    import os

    from chip_smoke import free_port

    coord = f"127.0.0.1:{free_port()}"
    env = dict(os.environ, PYTHONPATH=str(ROOT),
               CUDA_VISIBLE_DEVICES=",".join(cards),
               TORCH_NCCL_DUMP_ON_TIMEOUT="0", **(extra_env or {}))
    procs = [subprocess.Popen(
        [sys.executable, __file__, mode, str(rank), coord],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in range(2)]
    try:
        return [(proc.wait(timeout=timeout), proc.stdout.read())
                for proc in procs]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


@pytest.mark.cuda
def test_cuda_nccl_error_raises_and_does_not_drop_to_gloo(tmp_path):
    """Two processes on ONE card that report distinct cards take the
    device route; NCCL refuses two ranks on one GPU, and that error is
    raised from the first step: nothing carries on over Gloo."""
    cards = cards_or_skip(1)
    for rc, log in run_nccl_workers(tmp_path, "nccl_duplicate", cards[:1]):
        print(f"rc {rc}:\n{log[-1500:]}")
        assert rc == 0, log[-3000:]
        assert "route device: raised" in log, log[-3000:]
        assert "NCCL" in log or "nccl" in log, log[-3000:]


# Seconds of the peer-left case's group timeout.
PEER_LEFT_TIMEOUT_S = 10.0


@pytest.mark.cuda
@pytest.mark.parametrize("handling", ["2", "3"])
def test_cuda_gather_a_peer_left(tmp_path, handling):
    """Rank 0 dispatches a gather rank 1 never joins: rank 1 leaves (an
    abort) and exits at once. Rank 0's step is never ready, and its
    ``collect`` raises at the group's timeout. Under
    TORCH_NCCL_ASYNC_ERROR_HANDLING=2, what ``init_multihost`` sets unless
    the environment says otherwise, rank 0 then leaves the group (an
    abort) and exits 0. Under 3, torch's default, NCCL's watchdog thread
    ends the process by a signal after the timeout (SIGABRT or SIGSEGV),
    whatever it does meanwhile."""
    cards = cards_or_skip(2)
    (rc0, log0), (rc1, log1) = run_nccl_workers(
        tmp_path, "peer_left", cards[:2],
        {"TORCH_NCCL_ASYNC_ERROR_HANDLING": handling})
    print(f"handling {handling}: rank 0 rc {rc0}:\n{log0[-2000:]}")
    assert rc1 == 0 and "rank 1 left" in log1, log1[-3000:]
    assert "never ready" in log0, log0[-3000:]
    assert "collect raised" in log0, log0[-3000:]
    if handling == "2":
        assert rc0 == 0 and "left the group" in log0, log0[-3000:]
    else:
        assert rc0 < 0, log0[-3000:]


def nccl_worker(mode: str, rank: int, coord: str) -> int:
    """The two-process cases above: ``nccl_duplicate`` (both ranks on one
    card, reported as distinct cards) and ``peer_left`` (rank 1 leaves
    after one tick, rank 0 dispatches another)."""
    import time

    from goworld_tpu_torch.parallel import multihost as mh

    if mode == "nccl_duplicate":
        def take_card(r):
            torch.cuda.set_device(0)
            return f"GPU-reported-{r}"
        mh._take_card = take_card
    timeout = PEER_LEFT_TIMEOUT_S if mode == "peer_left" else 60.0
    mh.init_multihost(coord, 2, rank, timeout_s=timeout)
    p = tn.NeighborParams(capacity=4096, cell_size=100.0, grid_x=16,
                          grid_z=16, space_slots=1, cell_capacity=64,
                          max_events=4096)
    eng = mh.MultiHostNeighborEngine(p, make_mesh(1, "cuda"))
    eng.reset()
    rng = np.random.default_rng(rank)
    lc = eng.local_capacity
    world = (rng.uniform(0, 1600, (lc, 2)).astype(np.float32),
             np.ones(lc, bool), np.zeros(lc, np.int32),
             np.full(lc, 100.0, np.float32))
    if mode == "nccl_duplicate":
        try:
            eng.step(*world)
        except Exception as exc:  # the NCCL error, reported
            print(f"rank {rank} route {mh.gather_route()}: raised "
                  f"{type(exc).__name__}: {exc}", flush=True)
            mh.leave()
            return 0
        print(f"rank {rank}: the step ran", flush=True)
        return 1
    eng.step(*world)
    if rank == 1:
        mh.leave()
        print("rank 1 left", flush=True)
        return 0
    pend = eng.step_async(*world)
    t0 = time.monotonic()
    while time.monotonic() - t0 < PEER_LEFT_TIMEOUT_S + 10.0:
        if pend.is_ready():
            print("rank 0: the step became ready", flush=True)
            return 1
        time.sleep(0.05)
    print(f"rank 0: never ready in {time.monotonic() - t0:.1f} s",
          flush=True)
    try:
        pend.collect()
        print("rank 0: collect returned without raising", flush=True)
    except RuntimeError as exc:
        print(f"rank 0: collect raised after {time.monotonic() - t0:.1f} "
              f"s: {exc}", flush=True)
    t1 = time.monotonic()
    mh.leave()
    print(f"rank 0: left the group in {time.monotonic() - t1:.3f} s",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(nccl_worker(sys.argv[1], int(sys.argv[2]), sys.argv[3]))
