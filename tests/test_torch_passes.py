"""The port's step-riding passes against the JAX engine's, on the CPU.

The [sync] cadence tier pass (``_tier_pass``), the fused-delivery edge
verdicts (``_edge_verdicts``) and ``tier_edge_capacity`` are held bit for
bit against the JAX functions on the same seeded inputs, and the tier pass
against the port's copy of ``entity.slabs.classify_tiers`` too.
``NeighborEngine.step_async(logic=, tiers=)`` on the port's reference and
kernel backends (the kernel's plain version on the CPU) is held against
the JAX engine's ``jnp`` and ``pallas_interpret`` backends: the packed
readback, the tier vector and the verdict vector identical; the fused
outputs bit-identical to the port's unfused program
(``_fused_program_apply`` on the dispatched epoch) and within
``FUSED_RTOL`` of JAX's, whose jit may contract ``a*b+c`` into an FMA where
eager torch rounds each operation (ROADMAP queue 3, item 1). The strip
engine's fused logic is held against the single-device engine's, bit for
bit, and against the JAX strip engine's events.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goworld_tpu.entity.columns import FusedProgram as JaxFusedProgram
from goworld_tpu.ops import neighbor as jn
from goworld_tpu.parallel import mesh as jmesh
from goworld_tpu.parallel import spatial as jsp
from goworld_tpu_torch.entity.columns import FusedProgram
from goworld_tpu_torch.entity.slabs import classify_tiers
from goworld_tpu_torch.ops import neighbor as tn
from goworld_tpu_torch.parallel import make_mesh
from goworld_tpu_torch.parallel import spatial as ts

# Relative tolerance of the port's fused outputs against JAX's: one f32
# rounding of a contracted multiply-add, at the magnitudes of the inputs.
FUSED_RTOL = 1e-6

TIER_CFGS = [(3, 0.5, 0.8), (4, 0.3, 0.9), (2, 0.5, 0.5), (5, 0.0, 1.0)]


def prog_a(x, y, z, yaw, dt, vx, hp):
    return x + vx * dt, y, z + 0.25 * dt, yaw + 3.0 * dt, vx, hp - dt


def prog_b(x, y, z, yaw, dt, cool):
    return x, y + dt, z, yaw, cool * 0.5


PROGRAMS = (FusedProgram(prog_a, ("vx", "hp")),
            FusedProgram(prog_b, ("cool",)))
JAX_PROGRAMS = (JaxFusedProgram(prog_a, ("vx", "hp")),
                JaxFusedProgram(prog_b, ("cool",)))


def pass_inputs(seed, n=128, n_edges=200, ecap=256):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, 800, (n, 2)).astype(np.float32)
    ppos = (pos + rng.normal(0, 20, (n, 2))).astype(np.float32)
    radius = rng.choice([50.0, 100.0, 150.0], n).astype(np.float32)
    subj = np.full(ecap, n, np.int32)
    wat = np.full(ecap, n, np.int32)
    subj[:n_edges] = rng.integers(0, n, n_edges)
    wat[:n_edges] = rng.integers(0, n, n_edges)
    return pos, ppos, radius, subj, wat


@pytest.mark.parametrize("cfg", TIER_CFGS)
@pytest.mark.parametrize("n_edges", [0, 1, 200, 256])
def test_tier_pass_matches_jax_bit_for_bit(cfg, n_edges):
    pos, ppos, radius, subj, wat = pass_inputs(n_edges + 7, n_edges=n_edges)
    want = np.asarray(jn._tier_pass(
        jnp.asarray(pos), jnp.asarray(ppos), jnp.asarray(radius),
        jnp.asarray(subj), jnp.asarray(wat), *cfg))
    got = tn._tier_pass(
        torch.tensor(pos), torch.tensor(ppos), torch.tensor(radius),
        torch.tensor(subj), torch.tensor(wat), *cfg).numpy()
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    # Pad rows (sentinel capacity on both sides) are tier 0.
    assert not got[n_edges:].any()
    if n_edges > 100:  # the inputs reach several tiers
        assert len(np.unique(got[:n_edges])) > 1


def test_tier_pass_matches_host_classify():
    pos, ppos, radius, subj, wat = pass_inputs(3, n_edges=256)
    for cfg in TIER_CFGS[:2]:
        got = tn._tier_pass(
            torch.tensor(pos), torch.tensor(ppos), torch.tensor(radius),
            torch.tensor(subj), torch.tensor(wat), *cfg).numpy()
        d = pos[subj] - pos[wat]
        pd = ppos[subj] - ppos[wat]
        want = classify_tiers((d * d).sum(axis=1), radius[wat], *cfg,
                              (pd * pd).sum(axis=1).astype(np.float32))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_edges", [0, 5, 300])
def test_edge_verdicts_match_jax(n_edges):
    p = tn.NeighborParams(capacity=64, cell_size=100.0, grid_x=8, grid_z=8,
                          space_slots=1, cell_capacity=16, max_events=256)
    jp = jn.NeighborParams(**dataclasses.asdict(p))
    rng = np.random.default_rng(n_edges)
    n, e = p.capacity, p.max_events
    ecap = jn.tier_edge_capacity(n_edges)
    subj = np.full(ecap, n, np.int32)
    wat = np.full(ecap, n, np.int32)
    subj[:n_edges] = rng.integers(0, n, n_edges)
    wat[:n_edges] = rng.integers(0, n, n_edges)
    out = np.full((3 + 2 * e, 2), n, np.int32)
    for lo, k in ((3, 100), (3 + e, 80)):
        pairs = rng.integers(0, n, (k, 2)).astype(np.int32)
        # Half the events name a snapshot edge (subject=other, watcher).
        hit = rng.random(k) < 0.5
        if n_edges:
            pick = rng.integers(0, n_edges, k)
            pairs[hit, 0] = wat[pick[hit]]
            pairs[hit, 1] = subj[pick[hit]]
        out[lo:lo + k] = pairs
    want = np.asarray(jn._edge_verdicts(jp, jnp.asarray(out),
                                        jnp.asarray(subj), jnp.asarray(wat)))
    got = tn._edge_verdicts(p, torch.tensor(out), torch.tensor(subj),
                            torch.tensor(wat)).numpy()
    assert got.dtype == np.uint8 and got.shape == (2 * e,)
    np.testing.assert_array_equal(got, want)


def test_tier_edge_capacity_matches_jax():
    for k in [0, 1, 255, 256, 257, 1000, 4096, 4097, 180_000]:
        assert tn.tier_edge_capacity(k) == jn.tier_edge_capacity(k)


# --- the step with its riding passes ------------------------------------------

ENGINE = tn.NeighborParams(capacity=128, cell_size=100.0, grid_x=8, grid_z=8,
                           space_slots=2, cell_capacity=32, max_events=2048)
JAX_BACKEND = {"reference": "jnp", "kernel": "pallas_interpret"}


def world(seed, n):
    rng = np.random.default_rng(seed)
    s = dict(
        pos=rng.uniform(0, 700, (n, 2)).astype(np.float32),
        act=rng.random(n) < 0.9,
        spc=rng.integers(0, 2, n).astype(np.int32),
        rad=np.full(n, 100.0, np.float32),
        y=np.zeros(n, np.float32),
        yaw=rng.uniform(0, 360, n).astype(np.float32),
        vx=rng.normal(0, 30, n).astype(np.float32),
        hp=np.full(n, 100.0, np.float32),
        cool=rng.uniform(0, 8, n).astype(np.float32),
        sel=rng.integers(0, 3, n).astype(np.int32),
    )
    return rng, s


def tier_payload(rng, n, n_edges, kind):
    """(ver, n, subj_pad, wat_pad, tcfg[, verdicts]) of one ``kind``:
    "5" the tiers-only 5-tuple, "6" tiers and verdicts, "verdicts" the
    6-tuple with no tier config, "empty" verdicts over an empty snapshot."""
    if kind == "empty":
        n_edges = 0
    ecap = tn.tier_edge_capacity(n_edges)
    subj = np.full(ecap, n, np.int32)
    wat = np.full(ecap, n, np.int32)
    subj[:n_edges] = rng.integers(0, n, n_edges)
    wat[:n_edges] = rng.integers(0, n, n_edges)
    cfg = (3, 0.5, 0.8)
    if kind == "5":
        return (kind, n_edges, subj, wat, cfg)
    return (kind, n_edges, subj, wat, None if kind in ("verdicts", "empty")
            else cfg, True)


def unfused_outputs(s, dt):
    """The port's unfused programs over the dispatched epoch, selected by
    ``sel`` (what the service's host hook would write)."""
    t = {k: torch.tensor(v) for k, v in s.items()}
    dtt = tn._f32(dt, "cpu")
    x, z = t["pos"][:, 0], t["pos"][:, 1]
    new = {k: s[k].copy() for k in ("y", "yaw", "vx", "hp", "cool")}
    new["x"], new["z"] = s["pos"][:, 0].copy(), s["pos"][:, 1].copy()
    for k, prog in enumerate(PROGRAMS, 1):
        cols = tuple(t[c] for c in prog.columns)
        outs = [o.numpy() for o in tn._fused_program_apply(
            prog, x, t["y"], z, t["yaw"], dtt, cols)]
        m = s["sel"] == k
        for name, o in zip(("x", "y", "z", "yaw") + prog.columns, outs):
            new[name][m] = o[m]
    return new


@pytest.mark.parametrize("backend", ["reference", "kernel"])
def test_step_riding_passes_match_jax(backend):
    p = ENGINE
    n = p.capacity
    jp = jn.NeighborParams(**dataclasses.asdict(p))
    port = tn.NeighborEngine(p, backend=backend, device="cpu")
    ref = jn.NeighborEngine(jp, backend=JAX_BACKEND[backend])
    port.reset()
    ref.reset()
    rng, s = world(11, n)
    kinds = ["6", "6", "5", "verdicts", "empty"]
    if backend == "kernel":
        kinds = ["6", "5", "verdicts"]
    for t, kind in enumerate(kinds):
        dt = 0.05 + 0.01 * t
        tiers = tier_payload(rng, n, 150, kind)
        n_edges = tiers[1]
        logic = (PROGRAMS, s["sel"], s["y"], s["yaw"], dt,
                 (s["vx"], s["hp"], s["cool"]))
        jlogic = (JAX_PROGRAMS,) + logic[1:]
        a = port.step_async(s["pos"], s["act"], s["spc"], s["rad"],
                            logic=logic, tiers=tiers)
        b = ref.step_async(s["pos"], s["act"], s["spc"], s["rad"],
                           logic=jlogic, tiers=tiers)
        # The packed readback (header, cursors, inline pairs).
        np.testing.assert_array_equal(a._host.numpy(), np.asarray(b._out))
        if kind in ("5", "6"):
            assert a.tiers[:2] == b.tiers[:2] == (kind, n_edges)
            np.testing.assert_array_equal(np.asarray(a.tiers[2]),
                                          np.asarray(b.tiers[2]))
        else:
            assert a.tiers is None and b.tiers is None
        if kind == "5":
            assert a.verdicts is None and b.verdicts is None
        else:
            np.testing.assert_array_equal(np.asarray(a.verdicts),
                                          np.asarray(b.verdicts))
        programs, sel, perm, outs = a.fused
        assert programs == PROGRAMS and perm is None
        np.testing.assert_array_equal(sel, s["sel"])
        got = [np.asarray(o) for o in outs]
        want = [np.asarray(o) for o in b.fused[3]]
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_allclose(g, w, rtol=FUSED_RTOL, atol=0)
        host = unfused_outputs(s, dt)
        np.testing.assert_array_equal(got[0][:, 0], host["x"])
        np.testing.assert_array_equal(got[0][:, 1], host["z"])
        for name, g in zip(("y", "yaw", "vx", "hp", "cool"), got[1:]):
            np.testing.assert_array_equal(g, host[name])
        ea, la, da = a.collect()
        eb, lb, db = b.collect()
        np.testing.assert_array_equal(ea, eb)
        np.testing.assert_array_equal(la, lb)
        assert da == db
        # Write back as the service does, then churn a few rows.
        s["pos"] = np.stack([host["x"], host["z"]], axis=1)
        for name in ("y", "yaw", "vx", "hp", "cool"):
            s[name] = host[name]
        s["act"] = s["act"].copy()
        s["act"][rng.integers(0, n, 3)] ^= True
    assert port.fused_trace_count(PROGRAMS) == 1


@pytest.mark.parametrize("backend", ["reference", "kernel"])
def test_warmups_leave_engine_state_untouched(backend):
    p = dataclasses.replace(ENGINE, capacity=64)
    n = p.capacity
    eng = tn.NeighborEngine(p, backend=backend, device="cpu")
    twin = tn.NeighborEngine(p, backend=backend, device="cpu")
    rng, s = world(5, n)
    progs = (PROGRAMS[1],)
    for e in (eng, twin):
        e.reset()
        e.step(s["pos"], s["act"], s["spc"], s["rad"])
    before = [t.clone() for t in eng._state]
    assert eng.fused_trace_count(progs) == 0
    eng.warmup_fused(progs, ("float32",))
    assert eng.fused_trace_count(progs) == 1
    eng.warmup_tiered(None, (), (3, 0.5, 0.8), 256, True)
    eng.warmup_tiered(progs, ("float32",), None, 512, True)
    for a, b in zip(before, eng._state):
        assert torch.equal(a, b)
    pos2 = (s["pos"] + 40).astype(np.float32)
    for got, want in zip(eng.step(pos2, s["act"], s["spc"], s["rad"]),
                         twin.step(pos2, s["act"], s["spc"], s["rad"])):
        np.testing.assert_array_equal(got, want)


# --- fused logic on the strip engine -------------------------------------------

STRIPS = tn.NeighborParams(capacity=256, cell_size=100.0, grid_x=16,
                           grid_z=16, space_slots=2, cell_capacity=32,
                           max_events=2048)


def test_strip_engine_fused_logic_matches_single_device_and_jax():
    p = STRIPS
    n = p.capacity
    jp = jn.NeighborParams(**dataclasses.asdict(p))
    strips = ts.SpatialShardedNeighborEngine(p, make_mesh(2, "cpu"))
    single = tn.NeighborEngine(p, backend="kernel", device="cpu")
    ref = jsp.SpatialShardedNeighborEngine(jp, jmesh.make_mesh(2),
                                           backend="jnp")
    assert strips.supports_fused_logic
    for e in (strips, single, ref):
        e.reset()
    rng, s = world(21, n)
    s["pos"] = rng.uniform(0, 1600, (n, 2)).astype(np.float32)
    modes = []
    for t in range(4):
        dt = 0.1
        if t == 2:  # a teleport: the exact all-gather fallback tick
            s["pos"][:8] = rng.uniform(0, 1600, (8, 2)).astype(np.float32)
        logic = (PROGRAMS, s["sel"], s["y"], s["yaw"], dt,
                 (s["vx"], s["hp"], s["cool"]))
        a = strips.step_async(s["pos"], s["act"], s["spc"], s["rad"],
                              logic=logic)
        b = single.step_async(s["pos"], s["act"], s["spc"], s["rad"],
                              logic=logic)
        c = ref.step_async(s["pos"], s["act"], s["spc"], s["rad"],
                           logic=(JAX_PROGRAMS,) + logic[1:])
        programs, sel, perm, outs = a.fused
        assert programs == PROGRAMS and sorted(perm) == list(range(n))
        rows = [np.asarray(o) for o in outs]
        slots = [np.empty_like(r) for r in rows]
        for r, sl in zip(rows, slots):
            sl[perm] = r
        single_out = [np.asarray(o) for o in b.fused[3]]
        for got, want in zip(slots, single_out):
            np.testing.assert_array_equal(got, want)
        jperm = c.fused[2]
        for got, o in zip(slots, c.fused[3]):
            want = np.empty_like(got)
            want[jperm] = np.asarray(o)
            np.testing.assert_allclose(got, want, rtol=FUSED_RTOL, atol=0)
        ea, la, da = a.collect()
        eb, lb, db = b.collect()
        ec, lc, dc = c.collect()
        key = lambda x: sorted(map(tuple, np.asarray(x).tolist()))  # noqa: E731
        assert key(ea) == key(eb) == key(ec)
        assert key(la) == key(lb) == key(lc)
        assert da == db == dc
        modes.append(strips.last_mode)
        s["pos"] = slots[0]
        s["y"], s["yaw"], s["vx"], s["hp"], s["cool"] = slots[1:]
    assert "spatial" in modes and any(m.startswith("fallback") for m in modes)
    assert strips.fused_trace_count(PROGRAMS) == 1
    strips.warmup_fused(PROGRAMS, ("float32",) * 3)


def test_fused_difference_from_jax_is_the_contracted_multiply_add():
    """Where the port's fused outputs differ from JAX's, JAX took
    ``x + vx*dt`` as one fused multiply-add (XLA:CPU contracts it under
    jit) and the port rounded the product and the sum each, as numpy does
    (ROADMAP queue 3 item 5)."""
    import jax

    rng = np.random.default_rng(2)
    n = 4096
    x = rng.uniform(0, 1600, n).astype(np.float32)
    vx = rng.normal(0, 30, n).astype(np.float32)
    zeros = np.zeros(n, np.float32)
    sel = np.ones(n, np.int32)
    dt = np.float32(0.063)
    pos = np.stack([x, zeros], axis=1)
    want = jax.jit(lambda *a: jn._apply_fused_logic(JAX_PROGRAMS[:1], *a))(
        pos, zeros, zeros, sel, dt, (vx, zeros))[0][:, 0]
    got = tn._apply_fused_logic(
        PROGRAMS[:1], torch.tensor(pos), torch.tensor(zeros),
        torch.tensor(zeros), torch.tensor(sel), tn._f32(float(dt), "cpu"),
        (torch.tensor(vx), torch.tensor(zeros)))[0][:, 0].numpy()
    want = np.asarray(want)
    rounded = x + vx * dt  # numpy: each operation rounded to f32
    fused = (x.astype(np.float64) + vx.astype(np.float64) * np.float64(dt)
             ).astype(np.float32)
    np.testing.assert_array_equal(got, rounded)
    differ = want != got
    assert differ.any(), "no contracted multiply-add seen"
    np.testing.assert_array_equal(want[differ], fused[differ])
    np.testing.assert_allclose(got, want, rtol=FUSED_RTOL, atol=0)
