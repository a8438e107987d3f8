"""gwlint, the lock-order detector and their gates over the port's package.

The port's rules (``goworld_tpu_torch/analysis``) on fixture trees: R1 as
sync hygiene (PyTorch's host syncs in a function a dispatch reaches), R2 to
R7 as in the JAX package; the suppression mechanics; the package gate under
the port's own baseline, the CLI and the empty dead-code report; and the
lock-order detector (inversion, blocking under a lock, the port's frames
as the owned ones, a stress smoke over the port's chaos harness). The
package is linted once, by the CLI; R7's mutants share one parse.
"""

from __future__ import annotations

import ast
import asyncio
import os
import queue
import subprocess
import sys
import threading
import time

import pytest

from goworld_tpu_torch.analysis import core, hot_path, reach
from goworld_tpu_torch.analysis import lockgraph
from goworld_tpu_torch.analysis.lockgraph import LockGraphMonitor
from goworld_tpu_torch.analysis.rules import _sample_keys, check_r7

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "goworld_tpu_torch"

assert hot_path  # the decorator is rule input (R2)


def _lint_snippet(tmp_path, relpath: str, source: str,
                  rules: tuple[str, ...],
                  extra: dict[str, str] | None = None) -> core.LintResult:
    """Write ``source`` at ``relpath`` under a throwaway repo root and run
    the given rules over it."""
    for p, s in {relpath: source, **(extra or {})}.items():
        dst = tmp_path / p
        dst.parent.mkdir(parents=True, exist_ok=True)
        dst.write_text(s)
    return core.run_lint(str(tmp_path), rules=rules)


def _messages(result: core.LintResult) -> list[str]:
    return [v.render() for v in result.violations]


# --- R1: sync hygiene --------------------------------------------------------

# Every line ending in "# S" holds one host sync; nothing else may be
# flagged. The step program is a root because it counts a launch.
R1_BAD = """\
import numpy as np
import torch
from goworld_tpu_torch.telemetry import sentinel
from goworld_tpu_torch.b import helper

_CACHE = {}


def step(x, dev, out):
    sentinel.note_launch("step")
    _CACHE["last"] = 1  # S
    a = x.item()  # S
    b = x.tolist()  # S
    c = x.cpu()  # S
    d = x.numpy()  # S
    torch.cuda.synchronize()  # S
    torch.cuda.current_stream().synchronize()  # S
    e = torch.nonzero(x)  # S
    f = x.nonzero()  # S
    g = torch.unique(x)  # S
    h = torch.masked_select(x, x > 0)  # S
    i = torch.repeat_interleave(x, x)  # S
    j = float(x.sum())  # S
    k = int(x[0])  # S
    m = bool(x.any())  # S
    n = x.to("cpu")  # S
    o = x.to(dev)  # S
    out.copy_(x)  # S
    q = torch.tensor([1, 2], device=dev)  # S
    r = np.asarray(out)  # S
    pinned = torch.empty(4, pin_memory=True)
    s = pinned.to(dev)  # S
    t = pinned.cuda()  # S
    pinned.copy_(x)  # S
    return (helper(x), a, b, c, d, e, f, g, h, i, j, k, m, n, o, q,
            r, s, t)
"""

R1_HELPER = """\
def helper(x):
    return x.item()
"""

R1_CLEAN = """\
import numpy as np
import torch
from goworld_tpu_torch.telemetry import sentinel


def step(x: torch.Tensor, dev, n: int, flag: bool, host_arr: np.ndarray):
    sentinel.note_launch("step")
    pinned = torch.empty(4, pin_memory=True)
    view = pinned.numpy()
    a = np.asarray([1, 2])
    k = int(a.max()) + int(n) + int(flag) + int(host_arr.sum())
    y = x.to(torch.int32)
    z = x.to(y.dtype)
    w = pinned.to(dev, non_blocking=True)
    spare = torch.empty(4, pin_memory=True)
    spare.copy_(pinned)
    pinned.copy_(x, non_blocking=True)
    u = pinned.to("cpu")
    i = torch.repeat_interleave(x, x, output_size=8)
    t = torch.full((), 1.0, device=dev)
    return y, z, w, u, i, t, view, k


def host_side(x):
    # Reached from no dispatch: a host read here is what collect does.
    return x.item(), x.cpu(), float(x)
"""

R1_ENGINE = """\
class Pending:
    def __init__(self, out):
        self.n = out.tolist()


class Engine:
    def step_async(self, x):
        self._prepare(x)
        return Pending(x)

    def _prepare(self, x):
        return x.item()

    def collect(self, x):
        return x.item()
"""


def _marked_lines(source: str) -> set[int]:
    return {i for i, line in enumerate(source.splitlines(), 1)
            if line.endswith("# S")}


def test_r1_flags_each_pytorch_sync_in_a_step_program(tmp_path):
    r = _lint_snippet(tmp_path, f"{PKG}/a.py", R1_BAD, ("R1",),
                      extra={f"{PKG}/b.py": R1_HELPER})
    got = {v.line for v in r.violations if v.path == f"{PKG}/a.py"}
    assert got == _marked_lines(R1_BAD), _messages(r)
    assert len([v for v in r.violations if v.path == f"{PKG}/a.py"]) == \
        len(got), _messages(r)
    # the helper in another module is reached through the import
    assert [v.symbol for v in r.violations
            if v.path == f"{PKG}/b.py"] == ["helper"], _messages(r)
    msgs = "\n".join(_messages(r))
    for word in (".item()", ".tolist()", ".cpu()", ".numpy()",
                 "synchronize", "torch.nonzero", "torch.unique",
                 "masked_select", "repeat_interleave", "float(x)",
                 "int(x)", "bool(x)", ".to('cpu')", ".to(device)",
                 ".copy_()", "torch.tensor", "np.asarray",
                 "module-level container '_CACHE'"):
        assert word in msgs, word


def test_r1_host_data_and_unreached_code_are_clean(tmp_path):
    r = _lint_snippet(tmp_path, f"{PKG}/a.py", R1_CLEAN, ("R1",))
    assert r.ok, _messages(r)


def test_r1_roots_step_async_methods_and_constructors(tmp_path):
    r = _lint_snippet(tmp_path, f"{PKG}/eng.py", R1_ENGINE, ("R1",))
    assert sorted(v.symbol for v in r.violations) == [
        "Engine._prepare", "Pending.__init__"], _messages(r)


def test_r1_finding_spans_its_call(tmp_path):
    src = ("from goworld_tpu_torch.telemetry import sentinel\n"
           "def step(x):\n"
           "    sentinel.note_launch('s')\n"
           "    return (x\n"
           "            .item())\n")
    r = _lint_snippet(tmp_path, f"{PKG}/a.py", src, ("R1",))
    assert [(v.line, v.end_line) for v in r.violations] == [(4, 5)]


# --- R2: hot-path shape ------------------------------------------------------


R2_BAD = """\
import struct

@hot_path
def collect(entities):
    out = bytearray()
    for e in entities:
        out += struct.pack("<16s", e)
    return bytes(out)
"""

R2_CLEAN = """\
@hot_path
def collect(columns):
    for kind in ("a", "b", "c"):
        columns.flush(kind)
    return columns.tobytes()
"""


@pytest.mark.parametrize("case", ["bad", "clean", "undecorated"])
def test_r2_hot_path_shape(tmp_path, case):
    src = {"bad": R2_BAD, "clean": R2_CLEAN,
           "undecorated": R2_BAD.replace("@hot_path\n", "")}[case]
    r = _lint_snippet(tmp_path, f"{PKG}/hp.py", src, ("R2",))
    if case == "bad":
        msgs = "\n".join(_messages(r))
        assert "per-item Python loop" in msgs and "struct.pack" in msgs
    else:
        assert r.ok, _messages(r)


def test_r2_lists_the_ports_program_bodies():
    from goworld_tpu_torch.analysis.rules import HOT_PATHS

    assert {"_step_packed_tiered", "_tier_pass", "_edge_verdicts"} <= \
        HOT_PATHS[f"{PKG}/ops/neighbor.py"]
    assert "_spatial_step_strips" in HOT_PATHS[f"{PKG}/parallel/spatial.py"]
    assert "_sharded_step_kernel" in HOT_PATHS[f"{PKG}/parallel/mesh.py"]
    assert "_deliver_fused" in HOT_PATHS[f"{PKG}/entity/aoi/batched.py"]
    for path, names in HOT_PATHS.items():
        assert path.startswith(f"{PKG}/"), path
        assert not names & {"_step_packed_fused_jnp", "_event_kernel",
                            "_step_packed_fused_pallas"}, path
        assert os.path.exists(os.path.join(REPO_ROOT, path)), path


# --- R3: parse bounds --------------------------------------------------------


R3_BAD = """\
import struct

def parse(data: bytes):
    kind = data[0]
    return kind, struct.unpack("<H", data[1:3])[0]
"""

R3_CLEAN = """\
import struct

def parse(data: bytes):
    if len(data) < 3:
        raise ValueError("short frame")
    kind = data[0]
    return kind, struct.unpack("<H", data[1:3])[0]

def parse_try(data: bytes):
    try:
        return struct.unpack("<H", data[0:2])[0]
    except struct.error:
        return None

def parse_helper(data: bytes, off: int):
    _need(data, off, 2)
    return struct.unpack_from("<H", data, off)[0]
"""


@pytest.mark.parametrize("path,src,n", [
    (f"{PKG}/netutil/p.py", R3_BAD, 2),  # index + unpack
    (f"{PKG}/netutil/p.py", R3_CLEAN, 0),
    (f"{PKG}/entity/p.py", R3_BAD, 0),  # only wire modules
], ids=["bad", "clean", "not_wire"])
def test_r3_parse_bounds(tmp_path, path, src, n):
    r = _lint_snippet(tmp_path, path, src, ("R3",))
    assert len(r.violations) == n, _messages(r)


# --- R4: lock discipline -----------------------------------------------------


R4_BAD = """\
import threading
import time

class Svc:
    def __init__(self):
        self._lock = threading.Lock()

    def bad_sleep(self):
        with self._lock:
            time.sleep(0.5)

    def bad_bare(self):
        self._lock.acquire()
        try:
            pass
        finally:
            self._lock.release()

    def bad_queue(self, q):
        with self._lock:
            self.queue.get()
"""

R4_CLEAN = """\
import threading
import time

class Svc:
    def __init__(self):
        self._lock = threading.Lock()

    def good(self):
        with self._lock:
            self.counter += 1
        time.sleep(0.5)

    def good_nonblocking(self, q):
        with self._lock:
            self.queue.get(block=False)
"""


def test_r4_lock_discipline(tmp_path):
    r = _lint_snippet(tmp_path, f"{PKG}/svc.py", R4_BAD, ("R4",))
    msgs = "\n".join(_messages(r))
    for word in ("time.sleep under a held lock", "bare .acquire()",
                 "bare .release()", "blocking queue .get()"):
        assert word in msgs, word
    r = _lint_snippet(tmp_path / "c", f"{PKG}/svc.py", R4_CLEAN, ("R4",))
    assert r.ok, _messages(r)


# --- R5: telemetry hygiene ---------------------------------------------------


R5_BAD = """\
from goworld_tpu_torch.telemetry.metrics import REGISTRY

REQS = REGISTRY.counter("reqs_total")

def handle():
    REQS.dec()

def lazy_register():
    c = REGISTRY.counter("oops_total")
    return c

def leaky_span():
    scope = root_scope("x")
    scope.args["k"] = 1
"""

R5_CLEAN = """\
from goworld_tpu_torch.telemetry.metrics import REGISTRY

REQS = REGISTRY.counter("reqs_total")
DEPTH = REGISTRY.gauge("depth")

def handle():
    REQS.inc()
    DEPTH.dec()

def spanned():
    scope = root_scope("x")
    if scope is not None:
        with scope:
            pass

def factory():
    scope = root_scope("x")
    return scope
"""


def test_r5_telemetry_hygiene(tmp_path):
    r = _lint_snippet(tmp_path, f"{PKG}/t.py", R5_BAD, ("R5",))
    msgs = "\n".join(_messages(r))
    assert ".dec()'d" in msgs and "registered inside" in msgs
    assert "never" in msgs and "entered" in msgs
    r = _lint_snippet(tmp_path / "c", f"{PKG}/t.py", R5_CLEAN, ("R5",))
    assert r.ok, _messages(r)


# --- R6: config drift --------------------------------------------------------


R6_CONFIG = """\
import configparser

def load(cp):
    if cp.has_section("storage"):
        s = cp["storage"]
        t = s.get("type", "filesystem")
        secret = s.get("undocumented_knob", "")
    return t, secret
"""


def test_r6_config_drift(tmp_path):
    r = _lint_snippet(
        tmp_path, f"{PKG}/config/read_config.py", R6_CONFIG, ("R6",),
        extra={"goworld.ini.sample":
               "[storage]\ntype = filesystem\norphaned_key = 1\n"})
    msgs = "\n".join(_messages(r))
    assert "undocumented_knob" in msgs and "orphaned_key" in msgs
    r = _lint_snippet(
        tmp_path / "c", f"{PKG}/config/read_config.py", R6_CONFIG, ("R6",),
        extra={"goworld.ini.sample": "[storage]\ntype = filesystem\n"
               "; undocumented_knob =       ; now documented\n"})
    assert r.ok, _messages(r)


def test_r6_holds_the_ports_reader_against_the_root_sample():
    """The port reads the root goworld.ini.sample unchanged (only [aoi]
    platform's values differ): every section family the reader consumes,
    [aoi] with fuse_logic, [sync] and [scenario] included, is in R6's
    scan, and R6 finds no drift."""
    fams, _lines = _sample_keys(REPO_ROOT)
    assert {"platform", "fuse_logic"} <= fams["aoi"]
    assert {"tier_cadences", "near_ratio", "far_ratio"} <= fams["sync"]
    assert {"seed", "default_engine", "ticks_scale"} <= fams["scenario"]
    mods = [core.ParsedModule(REPO_ROOT, os.path.join(
        REPO_ROOT, PKG, "config", "read_config.py"))]
    r = core.run_lint(REPO_ROOT, rules=("R6",), modules=mods)
    assert r.ok, _messages(r)


# --- R7: proto conformance ---------------------------------------------------


def _r7_fixture(tmp_path, *, sender: str | None = None,
                handler: str | None = None,
                schema_body: str | None = None,
                history_digest: str | None = None) -> core.LintResult:
    """A minimal tree R7 can lint: msgtypes + schema + one sender + one
    handler module, with the digest computed the same way the engine
    does unless overridden."""
    from goworld_tpu_torch.proto.schema import digest_of

    msgtypes = ("PROTO_VERSION = 9\nREDIRECT_MIN = 1001\n"
                "REDIRECT_MAX = 1499\nclass MsgType:\n"
                "    PING = 1\n    PONG = 2\n")
    if schema_body is None:
        schema_body = (
            'SCHEMAS = (\n'
            '    schema(MsgType.PING, ("eid", "eid"), ("nonce", "u32")),\n'
            '    schema(MsgType.PONG, ("nonce", "u32")),\n'
            ')\n')
        entries = [("PING", 1, ("eid", "u32"), None),
                   ("PONG", 2, ("u32",), None)]
    else:
        entries = None
    if history_digest is None:
        history_digest = digest_of(9, entries) if entries else "feedface"
    schema_src = (
        "TRACE_TRAILER_BYTES = 17\n"
        'REDIRECT_PREFIX = (("gateid", "u16"), ("clientid", "cid"))\n'
        + schema_body + f'SCHEMA_HISTORY = {{9: "{history_digest}"}}\n')
    if sender is None:
        sender = SENDER.replace("    p.append_entity_id(eid)\n",
                                "    p.append_entity_id(eid)\n"
                                "    p.append_uint32(nonce)\n", 1)
    if handler is None:
        handler = (
            f"from {PKG}.proto.msgtypes import MsgType\n"
            "class Svc:\n"
            "    def _handle_ping(self, proxy, packet):\n"
            "        eid = packet.read_entity_id()\n"
            "        nonce = packet.read_uint32()\n"
            "    _HANDLERS = {MsgType.PING: _handle_ping}\n")
    return _lint_snippet(
        tmp_path, f"{PKG}/proto/schema.py", schema_src, ("R7",),
        extra={f"{PKG}/proto/msgtypes.py": msgtypes,
               f"{PKG}/net.py": sender,
               f"{PKG}/dispatcher/svc.py": handler})


# send_ping without its nonce (the drifted sender).
SENDER = (
    f"from {PKG}.netutil.packet import Packet\n"
    f"from {PKG}.proto.msgtypes import MsgType\n"
    "def send_ping(conn, eid, nonce):\n"
    "    p = Packet()\n"
    "    p.append_entity_id(eid)\n"
    "    conn.send(MsgType.PING, p)\n"
    "def send_pong(conn, nonce):\n"
    "    p = Packet()\n"
    "    p.append_uint32(nonce)\n"
    "    conn.send(MsgType.PONG, p)\n")


def test_r7_clean_fixture_tree(tmp_path):
    r = _r7_fixture(tmp_path)
    assert r.ok, _messages(r)


def test_r7_flags_drift(tmp_path):
    r = _r7_fixture(tmp_path / "a", sender=SENDER)
    assert "MsgType.PING packed as ['eid']" in "\n".join(_messages(r))
    handler = (
        f"from {PKG}.proto.msgtypes import MsgType\n"
        "class Svc:\n"
        "    def _handle_ping(self, proxy, packet):\n"
        "        nonce = packet.read_uint32()\n"
        "        eid = packet.read_entity_id()\n"
        "    _HANDLERS = {MsgType.PING: _handle_ping}\n")
    r = _r7_fixture(tmp_path / "b", handler=handler)
    assert "position 0 expects 'eid'" in "\n".join(_messages(r))
    r = _r7_fixture(tmp_path / "c", history_digest="0123456789abcdef")
    msgs = "\n".join(_messages(r))
    assert "does not match the pinned" in msgs and "bump PROTO_VERSION" in msgs
    r = _r7_fixture(tmp_path / "d", schema_body=(
        'SCHEMAS = (\n'
        '    schema(MsgType.PING, ("eid", "eid"), ("nonce", "u32")),\n'
        ')\n'))
    msgs = "\n".join(_messages(r))
    assert "MsgType.PONG" in msgs and "no wire schema" in msgs


@pytest.fixture(scope="module")
def package_modules():
    """The port's package, parsed once."""
    return core.parse_package(REPO_ROOT)


@pytest.fixture(scope="module")
def wire_modules(package_modules):
    """The modules R7 reads: every one that names a MsgType (the schema,
    the message types, each pack and handler site)."""
    return [m for m in package_modules if "MsgType" in m.source]


# Seeded protocol mutants over the committed sources: each must be caught by
# R7 (the model checker's mutants are in tests/test_torch_modelcheck.py).
R7_MUTANTS = {
    "dropped_pack_field": (
        "proto/conn.py",
        "        p.append_uint16(space_gameid)\n"
        "        p.append_uint32(nonce)\n"
        "        self.send(MsgType.MIGRATE_REQUEST, p)",
        "        p.append_uint16(space_gameid)\n"
        "        self.send(MsgType.MIGRATE_REQUEST, p)",
        "MIGRATE_REQUEST packed as"),
    "reordered_handshake_fields": (
        "proto/conn.py",
        "        p.append_uint16(gateid)\n"
        "        p.append_bool(fresh)\n"
        "        p.append_uint32(gen)",
        "        p.append_uint16(gateid)\n"
        "        p.append_uint32(gen)\n"
        "        p.append_bool(fresh)",
        "SET_GATE_ID packed as"),
    "layout_edit_without_bump": (
        "proto/schema.py",
        'schema(MsgType.CANCEL_MIGRATE, ("eid", "eid")),',
        'schema(MsgType.CANCEL_MIGRATE, ("eid", "eid"), ("why", "u8")),',
        "does not match the pinned"),
    "handler_skips_field": (
        "game/service.py",
        "            eid = packet.read_entity_id()\n"
        "            packet.read_uint16()\n"
        "            raw_len = packet.unread_len()",
        "            packet.read_uint16()\n"
        "            eid = packet.read_entity_id()\n"
        "            raw_len = packet.unread_len()",
        "REAL_MIGRATE"),
    "delta_sync_schema_field_drop": (
        "proto/schema.py",
        'schema(MsgType.SYNC_POSITION_YAW_DELTA_ON_CLIENTS,\n'
        '           ("gateid", "u16"), ("quantize_bits", "u8"),\n'
        '           raw="client_delta_sync_blocks"),',
        'schema(MsgType.SYNC_POSITION_YAW_DELTA_ON_CLIENTS,\n'
        '           ("gateid", "u16"),\n'
        '           raw="client_delta_sync_blocks"),',
        "does not match the pinned"),
    "delta_sync_handler_read_order": (
        "gate/service.py",
        "        packet.read_uint16()  # gateid\n"
        "        qb = packet.read_byte()",
        "        qb = packet.read_byte()\n"
        "        packet.read_uint16()  # gateid",
        "SYNC_POSITION_YAW_DELTA_ON_CLIENTS"),
    "delta_sync_layout_edit_without_bump": (
        "proto/schema.py",
        'schema(MsgType.SYNC_POSITION_YAW_DELTA_ON_CLIENTS,\n'
        '           ("gateid", "u16"), ("quantize_bits", "u8"),',
        'schema(MsgType.SYNC_POSITION_YAW_DELTA_ON_CLIENTS,\n'
        '           ("gateid", "u16"), ("quantize_bits", "u16"),',
        "does not match the pinned"),
}


def test_r7_wire_modules_are_clean(wire_modules):
    assert not check_r7(wire_modules, REPO_ROOT)


@pytest.mark.parametrize("mutant", list(R7_MUTANTS))
def test_r7_mutant_caught(tmp_path, wire_modules, mutant):
    rel, old, new, want = R7_MUTANTS[mutant]
    path = f"{PKG}/{rel}"
    mods = list(wire_modules)
    i = next(i for i, m in enumerate(mods) if m.path == path)
    src = mods[i].source.replace(old, new)
    assert src != mods[i].source, f"mutation did not apply to {path}"
    dst = tmp_path / path
    dst.parent.mkdir(parents=True, exist_ok=True)
    dst.write_text(src)
    mods[i] = core.ParsedModule(str(tmp_path), str(dst))
    assert mods[i].path == path
    assert any(want in v.message for v in check_r7(mods, REPO_ROOT))


# --- suppression mechanics ---------------------------------------------------


def test_inline_pragma_suppresses_only_with_a_reason(tmp_path):
    src = R3_BAD.replace(
        "kind = data[0]",
        "kind = data[0]  # gwlint: ok R3 fixture — caller pre-validates")
    r = _lint_snippet(tmp_path, f"{PKG}/netutil/p.py", src, ("R3",))
    assert len(r.violations) == 1 and len(r.suppressed) == 1, _messages(r)
    src = R3_BAD.replace("kind = data[0]", "kind = data[0]  # gwlint: ok R3")
    r = _lint_snippet(tmp_path / "b", f"{PKG}/netutil/p.py", src, ("R3",))
    assert len(r.violations) == 2, _messages(r)


def test_baseline_suppresses_by_symbol_and_reports_stale(tmp_path):
    (tmp_path / PKG / "netutil").mkdir(parents=True)
    (tmp_path / PKG / "netutil" / "p.py").write_text(R3_BAD)
    bl = tmp_path / "baseline.toml"
    bl.write_text(
        f'[[suppress]]\nrule = "R3"\npath = "{PKG}/netutil/p.py"\n'
        'symbol = "parse"\nreason = "fixture: both reads pre-validated"\n'
        f'[[suppress]]\nrule = "R3"\npath = "{PKG}/gone.py"\n'
        'reason = "matches nothing anymore"\n')
    r = core.run_lint(str(tmp_path), baseline_path=str(bl), rules=("R3",))
    assert r.ok and len(r.suppressed) == 2
    assert [s.path for s in r.stale_baseline] == [f"{PKG}/gone.py"]
    bl.write_text('[[suppress]]\nrule = "R3"\npath = "x.py"\n')
    with pytest.raises(ValueError, match="justification"):
        core.load_baseline(str(bl))


# --- the package gates -------------------------------------------------------


# The dispatch roots: each is held by line pragmas, not by a symbol-wide
# baseline entry, so a sync added anywhere in it fails the gate.
DISPATCH_ROOTS = [
    (f"{PKG}/ops/neighbor.py", "NeighborEngine.step_async"),
    (f"{PKG}/entity/aoi/batched.py", "BatchAOIService._dispatch"),
    (f"{PKG}/parallel/spatial.py", "SpatialShardedNeighborEngine.step_async"),
    (f"{PKG}/parallel/mesh.py", "ShardedPendingStep.__init__"),
]


@pytest.mark.parametrize("path,symbol", DISPATCH_ROOTS,
                         ids=[s for _, s in DISPATCH_ROOTS])
def test_gate_fails_on_a_sync_added_to_a_dispatch_root(
        tmp_path, package_modules, path, symbol):
    """A copy of the module with ``.item()`` as the root's first
    statement: the package gate under the port's baseline reports that one
    line and nothing else."""
    mod = next(m for m in package_modules if m.path == path)
    cls, name = symbol.split(".")
    fn = next(f for c in mod.tree.body
              if isinstance(c, ast.ClassDef) and c.name == cls
              for f in c.body
              if isinstance(f, ast.FunctionDef) and f.name == name)
    docstring = isinstance(fn.body[0], ast.Expr) and isinstance(
        fn.body[0].value, ast.Constant)
    first = fn.body[1 if docstring else 0]
    lines = mod.source.split("\n")
    lines.insert(first.lineno - 1,
                 " " * first.col_offset + "_probe = self._probe.item()")
    dst = tmp_path / path
    dst.parent.mkdir(parents=True)
    dst.write_text("\n".join(lines))
    mods = [core.ParsedModule(str(tmp_path), str(dst)) if m.path == path
            else m for m in package_modules]
    r = core.run_lint(REPO_ROOT, baseline_path=core.DEFAULT_BASELINE,
                      rules=("R1",), modules=mods)
    assert [(v.path, v.line, v.symbol) for v in r.violations] == [
        (path, first.lineno, symbol)], _messages(r)
    assert ".item()" in r.violations[0].message
    assert not [e for e in r.stale_baseline if e.rule == "R1"]


def test_gwlint_cli_gates_the_package():
    """The port's gwlint (what developers run) exits 0 on the committed
    tree under the package's baseline with --strict-baseline (no stale
    entry), and every baseline entry carries a triaged reason."""
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO_ROOT, PKG, "tools", "gwlint.py"),
         "--strict-baseline"],
        capture_output=True, text=True, cwd=REPO_ROOT, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert " 0 violation(s)" in proc.stdout and " 0 stale" in proc.stdout
    entries = core.load_baseline(core.DEFAULT_BASELINE)
    assert entries
    for s in entries:
        assert s.reason.strip(), f"baseline entry without reason: {s}"
        assert not s.reason.startswith("TRIAGE"), f"untriaged: {s}"
        assert s.path.startswith(f"{PKG}/"), s


def test_dead_code_report_is_empty(package_modules):
    dead = reach.find_dead_code(REPO_ROOT, package_modules)
    assert not dead, "\n".join(d.render() for d in dead)


def test_package_walk_is_the_ports_only(package_modules):
    paths = {m.path for m in package_modules}
    assert all(p.startswith(f"{PKG}/") for p in paths)
    assert f"{PKG}/analysis/rules.py" in paths


# --- lockgraph ---------------------------------------------------------------


def _run(fn):
    th = threading.Thread(target=fn)
    th.start()
    th.join(timeout=5)
    assert not th.is_alive()


def test_lockgraph_ab_ba_inversion_and_consistent_order():
    mon = LockGraphMonitor()
    with mon.installed():
        lock_a = threading.Lock()
        lock_b = threading.Lock()

        def ab():
            with lock_a:
                with lock_b:
                    pass

        def ba():
            with lock_b:
                with lock_a:
                    pass

        _run(ab)
        assert mon.report()["edges"] and not mon.report()["cycles"]
        _run(ba)
    assert mon.report()["cycles"], mon.report()["edges"]


@pytest.mark.parametrize("call", ["sleep", "queue_get", "outside"])
def test_lockgraph_blocking_under_a_lock(call):
    mon = LockGraphMonitor()
    with mon.installed():
        lk = threading.Lock()
        q = queue.Queue()
        q.put(1)
        with lk:
            if call == "sleep":
                time.sleep(0.001)
            elif call == "queue_get":
                q.get(timeout=1)
        if call == "outside":
            time.sleep(0.001)
    blocking = mon.report()["blocking"]
    want = {"sleep": "time.sleep", "queue_get": "queue.Queue.get"}
    if call == "outside":
        assert not blocking
    else:
        assert [b["call"].split("(")[0] for b in blocking] == [want[call]]


def test_lockgraph_self_deadlock_and_condition():
    mon = LockGraphMonitor()
    with mon.installed():
        lk = threading.Lock()
        lk.acquire()
        # A blocking re-acquire would hang: drive the check that
        # acquire(blocking=True) runs first.
        mon._before_acquire(lk, True)
        lk.release()
        cond = threading.Condition()
        done = []

        def waiter():
            with cond:
                while not done:
                    cond.wait(timeout=2)

        th = threading.Thread(target=waiter)
        th.start()
        time.sleep(0.05)
        with cond:
            done.append(1)
            cond.notify()
        th.join(timeout=2)
        assert not th.is_alive()
    r = mon.report()
    assert len(r["deadlocks"]) == 1 and not r["blocking"]
    mon.uninstall()
    assert type(threading.Lock()).__name__ != "_TrackedLock"


def test_lockgraph_owns_the_ports_frames_only():
    """A lock is engine-owned when a path component of its creation frame
    is goworld_tpu_torch: the port's frames, not the JAX package's (whose
    directory name is a prefix of the port's)."""
    assert lockgraph._owned(f"/x/{PKG}/entity/slabs.py")
    assert not lockgraph._owned("/x/goworld_tpu/entity/slabs.py")
    assert not lockgraph._owned(f"/x/{PKG}_old/slabs.py")
    assert not lockgraph._owned("/x/tests/test_torch_analysis.py")
    from goworld_tpu.telemetry.metrics import Registry as JaxRegistry
    from goworld_tpu_torch.telemetry.metrics import Registry

    mon = LockGraphMonitor()
    with mon.installed():
        JaxRegistry().counter("jax_total").inc()
        threading.Lock()  # born in this test file
        assert not mon.report()["goworld_sites"]
        Registry().counter("port_total").inc()
    sites = mon.report()["goworld_sites"]
    assert sites and all("metrics.py" in s for s in sites), sites


def _assert_lock_clean(report: dict) -> None:
    """Acquisition order among the port's locks is acyclic, no blocking
    call runs under one of them, no lock is re-acquired by its holder."""
    assert report["locks_created"] > 0, "monitor saw no locks"
    assert report["goworld_sites"], "no engine locks tracked"
    assert not report["goworld_cycles"], report["edges"]
    assert not report["goworld_blocking"], report["goworld_blocking"]
    assert not report["deadlocks"], report["deadlocks"]


def test_lockgraph_stress_smoke_over_the_ports_chaos_cluster(tmp_path):
    """The port's in-process chaos cluster (2 dispatchers, 8 bots, its
    game, gate and storage worker) serving bots under the monitor,
    installed before the cluster is built."""
    from goworld_tpu_torch.chaos import ChaosCluster

    mon = LockGraphMonitor()
    with mon.installed():
        async def run():
            cluster = ChaosCluster(
                str(tmp_path), n_dispatchers=2, n_bots=8,
                storage_knobs=dict(
                    retry_base_interval=0.05, retry_max_interval=0.2,
                    circuit_failure_threshold=3, circuit_cooldown=0.3))
            await cluster.start()
            try:
                await asyncio.sleep(1.5)
            finally:
                await cluster.stop()

        asyncio.run(run())
    _assert_lock_clean(mon.report())
