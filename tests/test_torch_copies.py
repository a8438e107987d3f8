"""The port's copies of the JAX package's host modules are the same code.

Every module that the port copied (the wire, config, telemetry,
utilities, storage and kvdb, the dispatcher cluster, services, rebalancing,
the game, the facade, the dispatcher, the gate, the CLI, the bot client,
the example servers, the scenarios, the chaos harness, the post-mortem
bundles, the operator tools, the wire schema, gwlint, the lock-order
detector, the model checker and the Chinese doc entry) must equal its
JAX original after the package rename ``goworld_tpu`` ->
``goworld_tpu_torch``: the same ``ast.dump`` with
docstrings dropped (comments are not in the AST). The hand-edited modules
are allowed to differ only in the top-level definitions named below, or
in the methods named ``Class.method``, each with its reason; everything
else in them is held equal too, a class's other members one by one.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
JAX = ROOT / "goworld_tpu"
PORT = ROOT / "goworld_tpu_torch"

COPIED = [
    "native/__init__.py", "native/pyframe.py",
    *(f"netutil/{n}.py" for n in (
        "__init__", "packet", "packet_conn", "tcp", "msgpacker", "bson",
        "mongo", "mysql", "resp", "resp_cluster", "kcp", "rudp", "fec",
        "ws_conn")),
    "proto/__init__.py", "proto/conn.py", "proto/msgtypes.py",
    "config/__init__.py", "config/read_config.py",
    *(f"telemetry/{n}.py" for n in (
        "__init__", "tracing", "phases", "slo", "collector", "history",
        "sentinel")),
    *(f"utils/{n}.py" for n in (
        "__init__", "gwlog", "async_jobs", "crontab", "gwvar", "binutil",
        "debug_http")),
    *(f"kvdb/{n}.py" for n in (
        "__init__", "filesystem", "mongodb", "mysql", "redis",
        "redis_cluster", "sqlite")),
    "kvreg/__init__.py",
    *(f"storage/{n}.py" for n in (
        "__init__", "circuit", "filesystem", "mongodb", "mysql", "redis",
        "redis_cluster", "sqlite")),
    "dispatchercluster/__init__.py", "dispatchercluster/cluster.py",
    "service/__init__.py",
    *(f"rebalance/{n}.py" for n in (
        "__init__", "migrator", "planner", "planner_service", "report")),
    "game/__init__.py", "game/service.py",
    "facade.py", "__init__.py",
    "ext/__init__.py", "ext/pubsub.py", "ext/db.py",
    *(f"dispatcher/{n}.py" for n in ("__init__", "__main__", "lbc",
                                     "service")),
    *(f"gate/{n}.py" for n in ("__init__", "__main__", "filter_tree",
                               "service")),
    "cli.py",
    *(f"client/{n}.py" for n in ("__init__", "__main__", "bot_runner",
                                 "client")),
    *(f"scenarios/{n}.py" for n in ("__init__", "battle_royale", "hotspot",
                                    "service_heavy", "runner")),
    "telemetry/postmortem.py",
    *(f"chaos/{n}.py" for n in ("__init__", "harness", "multigame",
                                "botfleet", "mg_server", "game_proc")),
    *(f"tools/{n}.py" for n in ("__init__", "gwtop", "gwpost")),
    "proto/schema.py", "cn.py",
    *(f"analysis/{n}.py" for n in ("__init__", "core", "rules", "reach",
                                   "lockgraph", "modelcheck")),
]
EXAMPLES = ("test_game", "nil_game", "chatroom_demo", "unity_demo")
EXAMPLE = [f"{ex}/{n}" for ex in EXAMPLES
           for n in ("__init__.py", "__main__.py", "server.py")]
C_SOURCES = ["native/fastframe.c", "native/kcpcore.c"]

# Hand-edited modules: the top-level definitions that may differ, with why.
# "imports" stands for the module's top-level import statements.
EDITED = {
    # Edit 1, the game boot: the platform pin becomes rt.aoi_device, the
    # XLA cache (apply_compilation_cache) has no counterpart, multihost
    # joins a torch.distributed group (the port's init_multihost, before
    # the AOI service is built), the boot logs the torch device,
    # /metrics shows the event kernel's launches by form, and each
    # freeze/terminate logs the game's peak device memory.
    "game/service.py": {"imports", "apply_compilation_cache",
                        "GameService"},
    # Edit 2: [aoi] platform takes auto|cpu|cuda; tpu is refused.
    "config/read_config.py": {"_validate"},
    # Edit 3: start/reload build the CUDA libraries before games spawn
    # (_build_kernels); the help text names the port's game.
    "cli.py": {"_build_kernels", "cmd_start", "cmd_reload", "main"},
    # Edit 4: the counters, configuration and readers. SentinelJit (a
    # jax.jit wrapper that reads retraces from the jit's trace cache), its
    # signature helpers, the compile-cache listener and its two counters
    # have no counterpart: PyTorch traces and compiles nothing.
    # note_launch is the port engines' launch count, called by each step
    # program where SentinelJit wraps its JAX counterpart
    # (ops/neighbor.py, parallel/spatial.py and parallel/mesh.py, which
    # are ports, not copies, so they are not listed here).
    "telemetry/sentinel.py": {"imports", "_CACHE_HITS", "_CACHE_MISSES",
                              "_sig_of", "_sig_delta", "SentinelJit",
                              "_cache_listener_installed",
                              "install_compile_cache_listener",
                              "note_launch"},
    # Edit 5: /profile?mode=torch wraps the window in torch.profiler
    # (_profile_torch, in place of _profile_jax); mode=jax answers 400
    # naming mode=torch.
    "utils/debug_http.py": {"DebugHTTPServer"},
    # The scenario runner: make_engine builds the port's engines on a
    # torch device (no jax platform pin, no device-count check, no
    # fallback prewarm: nothing compiles lazily), _STEP_LABELS lists the
    # port's step labels, and run_scenario takes device= and backend= and
    # names both in the headline (_device_name).
    "scenarios/runner.py": {"make_engine", "_STEP_LABELS", "_device_name",
                            "run_scenario"},
    # The multigame harness spawns the port's game_proc with one torch
    # thread (OMP_NUM_THREADS=1, ROADMAP queue 3 item 6) where the JAX
    # harness pins JAX_PLATFORMS=cpu.
    "chaos/multigame.py": {"MultigameCluster"},
    # A fault fix (ROADMAP queue 3 item 7): games booting together raced
    # the switch of the shared sqlite file to WAL ("database is locked"
    # at once); enable_wal retries it. The JAX package has the same race.
    "kvdb/sqlite.py": {"imports", "enable_wal", "SQLiteKVDB"},
    "storage/sqlite.py": {"imports", "SQLiteEntityStorage"},
    # gwlint over the port: the baseline lives in the package
    # (DEFAULT_BASELINE; the root gwlint_baseline.toml is the JAX
    # package's), and a finding keeps its node's last line (Violation,
    # ParsedModule.violation) so chip_smoke.py's sync_check can place a
    # sync inside a multi-line call.
    "analysis/core.py": {"DEFAULT_BASELINE", "Violation", "ParsedModule"},
    # R1 recast as sync hygiene: eager PyTorch traces nothing, so the roots
    # are the step programs (note_launch), every step_async and the
    # service's dispatch, constructors resolve to __init__, and the
    # flagged calls are PyTorch's host syncs (the jit wrappers, the host
    # callbacks and their helpers go); R2's HOT_PATHS name the port's own
    # program bodies.
    "analysis/rules.py": {
        "HOT_PATHS", "_JIT_WRAPPERS", "_HOST_CALLBACK_FUNCS", "_ROOTS",
        "_ROOT_METHODS", "_HOST_READS", "_SIZED_BY_DATA", "_SCALAR_CASTS",
        "_DTYPE_NAMES",
        "_ProgramIndex", "_unwrap_partial", "_resolve_traced_arg",
        "_jit_roots", "_sync_roots", "_reachable", "_kw", "_is_true",
        "_is_cpu", "_is_dtype", "_host_names", "_is_host", "_sync_call",
        "_blocking_copy", "check_r1"},
    # The lock-order detector owns a lock born in a frame whose path has a
    # goworld_tpu_torch directory (a path component: the JAX copy's
    # substring test would own either package's frames).
    "analysis/lockgraph.py": {"_owned", "_creation_site"},
    # A fault fix: a space bundle routed to a target killed in the same
    # instant could sit unread in a socket that outlived the process (a
    # process with torch loaded takes ~20 ms to tear down) and was lost.
    # The dispatcher keeps each routed bundle in its handoff entry
    # (_SpaceHandoff) until the target acks it, bounces it home when the
    # target is declared dead or cold-boots (_bounce_inflight_spaces), and
    # logs an error when the deadline drops an unacknowledged one. The JAX
    # package has the same race.
    "dispatcher/service.py": {
        "_SpaceHandoff",
        "DispatcherService.__init__",
        "DispatcherService._sweep_dead_frozen_games",
        "DispatcherService._bounce_inflight_spaces",
        "DispatcherService._handle_set_game_id",
        "DispatcherService._handle_space_migrate_prepare",
        "DispatcherService._handle_space_migrate_data",
        "DispatcherService._keep_inflight_space",
        "DispatcherService._keep_buffered_spaces",
        "DispatcherService._release_space_handoff",
        "DispatcherService._sweep_space_handoffs"},
}
# cn.py differs from its original only in its docstring (the AOI paragraph
# names PyTorch and the CUDA kernels), which the comparison drops.


def rename(text: str) -> str:
    return re.sub(r"\bgoworld_tpu\b", "goworld_tpu_torch", text)


def _strip_docstrings(tree: ast.AST) -> ast.AST:
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            body = node.body
            if (body and isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant)
                    and isinstance(body[0].value.value, str)):
                node.body = body[1:] or [ast.Pass()]
    return tree


def _tree(text: str) -> ast.Module:
    return _strip_docstrings(ast.parse(text))


def _name(stmt: ast.stmt) -> str:
    if isinstance(stmt, (ast.Import, ast.ImportFrom)):
        return "imports"
    if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                         ast.ClassDef)):
        return stmt.name
    if isinstance(stmt, (ast.Assign, ast.AnnAssign)):
        target = stmt.targets[0] if isinstance(stmt, ast.Assign) \
            else stmt.target
        if isinstance(target, ast.Name):
            return target.id
    return ast.dump(stmt)


def _by_name(tree: ast.Module) -> dict[str, list[str]]:
    """Each top-level definition's dump by name; a class also by member
    (``Class.member``) and by its header without the body
    (``Class.<header>``)."""
    out: dict[str, list[str]] = {}
    for stmt in tree.body:
        name = _name(stmt)
        out.setdefault(name, []).append(ast.dump(stmt))
        if isinstance(stmt, ast.ClassDef):
            for member in stmt.body:
                out.setdefault(f"{name}.{_name(member)}", []).append(
                    ast.dump(member))
            header = ast.ClassDef(
                name=stmt.name, bases=stmt.bases, keywords=stmt.keywords,
                body=[], decorator_list=stmt.decorator_list,
                type_params=getattr(stmt, "type_params", []))
            out[f"{name}.<header>"] = [ast.dump(header)]
    return out


def _allowed(name: str, allowed: set) -> bool:
    """A name is let differ when it is listed, when its class is listed
    whole, or when it is a class one of whose members is listed (its
    members and header are then compared one by one)."""
    return (name in allowed or name.split(".")[0] in allowed
            or any(a.startswith(name + ".") for a in allowed))


@pytest.mark.parametrize("rel", COPIED)
def test_copy_equals_jax_original(rel):
    want = _tree(rename((JAX / rel).read_text()))
    got = _tree((PORT / rel).read_text())
    if rel not in EDITED:
        assert ast.dump(got) == ast.dump(want), rel
        return
    allowed = EDITED[rel]
    a, b = _by_name(want), _by_name(got)
    for name in set(a) | set(b):
        if _allowed(name, allowed):
            continue
        assert a.get(name) == b.get(name), f"{rel}: {name} differs"
    # Every allowed difference is real: an entry that no longer differs
    # is stale and must leave the list.
    for name in allowed:
        assert a.get(name) != b.get(name), f"{rel}: {name} is equal now"


@pytest.mark.parametrize("rel", EXAMPLE,
                         ids=lambda rel: rel.removeprefix("test_game/"))
def test_example_copy_equals_repo_example(rel):
    ex = rel.split("/")[0]
    text = rename((ROOT / "examples" / rel).read_text())
    text = text.replace(f"examples.{ex}", f"goworld_tpu_torch.examples.{ex}")
    got = (PORT / "examples" / rel).read_text()
    assert ast.dump(_tree(got)) == ast.dump(_tree(text))


@pytest.mark.parametrize("rel", C_SOURCES)
def test_native_sources_equal(rel):
    assert (PORT / rel).read_bytes() == (JAX / rel).read_bytes()
