"""Ops CLI: build | start | stop | kill | reload | status for a server dir.

Reference parity: ``cmd/goworld`` (SURVEY.md §2.3) — ``build`` compiles the
server (build.go:9-56; here: byte-compile), ``start`` spawns dispatchers →
games → gates waiting for each group's supervisor tag in its log
(start.go:17-126), ``stop`` SIGTERMs gates → games → dispatchers
(stop.go:11-60), ``reload`` SIGHUP-freezes the games then restarts them with
``-restore`` under the (possibly rebuilt) code (reload.go:10-33), ``status``
reports which configured processes are alive (status.go:14-115).

Process bookkeeping is pidfile-based (``<name>.pid`` = "pid starttime" in the
run directory), verified against the kernel start time in /proc/<pid>/stat so
a recycled PID belonging to an unrelated process is never signalled.

When some game runs the batched AOI engine on the CUDA card (``[aoi]
backend = tpu`` and a platform other than ``cpu``), ``start`` and
``reload`` build the CUDA kernel libraries once, in the CLI process,
before they spawn games; a failed build aborts with ``nvcc``'s output.

Usage:
    python -m goworld_tpu_torch.cli start goworld_tpu_torch.examples.test_game [-configfile goworld.ini]
    python -m goworld_tpu_torch.cli stop
    python -m goworld_tpu_torch.cli reload goworld_tpu_torch.examples.test_game
    python -m goworld_tpu_torch.cli status
"""

from __future__ import annotations

import argparse
import compileall
import importlib.util
import os
import signal
import subprocess
import sys
import time

from goworld_tpu_torch import consts
from goworld_tpu_torch.config import get as get_config, set_config_file

START_TIMEOUT = 60.0  # per-process tag wait (start.go waits per process)
STOP_TIMEOUT = 30.0
FREEZE_TIMEOUT = 30.0  # consts.go FREEZE_TIMEOUT is 10s; allow slack


# --- pidfile bookkeeping -----------------------------------------------------


def _pidfile(run_dir: str, name: str) -> str:
    return os.path.join(run_dir, f"{name}.pid")


def _logfile(run_dir: str, name: str) -> str:
    return os.path.join(run_dir, f"{name}.out.log")


def _read_pid(run_dir: str, name: str) -> tuple[int, int | None] | None:
    """Returns (pid, starttime) from the pidfile; starttime is None for
    legacy single-field pidfiles."""
    try:
        with open(_pidfile(run_dir, name)) as f:
            fields = f.read().split()
            pid = int(fields[0])
            start = int(fields[1]) if len(fields) > 1 else None
            return pid, start
    except (OSError, ValueError, IndexError):
        return None


def _proc_cmdline(pid: int) -> str:
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            return f.read().replace(b"\0", b" ").decode(errors="replace")
    except OSError:
        return ""


def _proc_starttime(pid: int) -> int | None:
    """Kernel start time (clock ticks since boot, /proc/<pid>/stat field 22).
    Stable for the process's lifetime and never reused together with the same
    PID, so (pid, starttime) uniquely identifies the process we spawned."""
    try:
        with open(f"/proc/{pid}/stat", "rb") as f:
            stat = f.read().decode(errors="replace")
        # Field 2 (comm) may contain spaces/parens; fields after the closing
        # paren are well-formed.
        rest = stat.rsplit(")", 1)[1].split()
        return int(rest[19])  # field 22 overall = index 19 after comm
    except (OSError, ValueError, IndexError):
        return None


def _alive(pidinfo: tuple[int, int | None] | None, expect: str) -> bool:
    """Alive AND still the process we started (guards stale pidfile reuse)."""
    if pidinfo is None:
        return False
    pid, start = pidinfo
    cmdline = _proc_cmdline(pid)
    if not cmdline:
        return False  # dead (or unreadable) — never "matches"
    if start is not None:
        # Strong identity: a recycled PID has a different kernel start time.
        return _proc_starttime(pid) == start
    # Legacy pidfile without a start time: fall back to the cmdline marker.
    return (expect or "python") in cmdline


def _process_names(cfg) -> dict[str, list[str]]:
    return {
        "dispatcher": [f"dispatcher{i}" for i in sorted(cfg.dispatchers)],
        "game": [f"game{i}" for i in sorted(cfg.games)],
        "gate": [f"gate{i}" for i in sorted(cfg.gates)],
    }


def _expect_marker(kind: str, name: str, server_module: str | None) -> str:
    """Substring of the child cmdline that identifies this process kind."""
    if kind == "dispatcher":
        return "goworld_tpu_torch.dispatcher"
    if kind == "gate":
        return "goworld_tpu_torch.gate"
    return server_module or ""


# --- spawn + tag wait --------------------------------------------------------


def _spawn_nowait(run_dir: str, name: str, argv: list[str]):
    """Launch the process and return (proc, log offset) without waiting for
    its supervisor tag — callers spawn a batch, then wait for every tag
    (parallel restart halves a reload's client-visible freeze window: each
    game is a fresh interpreter with seconds of import/warmup cost)."""
    log_path = _logfile(run_dir, name)
    logf = open(log_path, "ab")
    logf.write(f"\n--- spawn {time.strftime('%F %T')}: {' '.join(argv)}\n".encode())
    logf.flush()
    offset = logf.tell()  # only log content from THIS spawn satisfies the tag
    proc = subprocess.Popen(
        argv, stdout=logf, stderr=subprocess.STDOUT, cwd=run_dir,
        start_new_session=True,  # survives the CLI exiting (daemon-ish)
    )
    logf.close()
    start = _proc_starttime(proc.pid)
    with open(_pidfile(run_dir, name), "w") as f:
        f.write(str(proc.pid) if start is None else f"{proc.pid} {start}")
    return proc, offset


def _spawn(run_dir: str, name: str, argv: list[str], tag: str) -> None:
    proc, offset = _spawn_nowait(run_dir, name, argv)
    _wait_tag(run_dir, name, tag, proc, offset)


def _wait_tag(run_dir: str, name: str, tag: str, proc=None, offset: int = 0) -> None:
    """Scan the child's log (from this spawn's offset — logs append across
    restarts so reload forensics keep the pre-freeze half) for its
    supervisor tag (start.go:98-126)."""
    log_path = _logfile(run_dir, name)
    deadline = time.monotonic() + START_TIMEOUT
    while time.monotonic() < deadline:
        try:
            with open(log_path, "rb") as f:
                f.seek(offset)
                if tag.encode() in f.read():
                    print(f"  {name}: started ok")
                    return
        except OSError:
            pass
        if proc is not None and proc.poll() is not None:
            sys.exit(f"{name} exited with code {proc.returncode}; see {log_path}")
        time.sleep(0.05)
    sys.exit(f"timeout waiting for {name} start tag; see {log_path}")


def _truncate_log(run_dir: str, name: str) -> None:
    # Tags are matched by scanning the whole log; stale tags from a previous
    # run must not satisfy the wait.
    try:
        os.truncate(_logfile(run_dir, name), 0)
    except OSError:
        pass


# --- commands ----------------------------------------------------------------


def _build_kernels(cfg) -> None:
    """Build every CUDA kernel library once, here, when some game's batched
    AOI service runs on the card: otherwise each game would build on its
    first use, N games racing ``nvcc`` and the first tick paying for it.
    The builds run side by side; a failure exits with nvcc's output."""
    if cfg.aoi.backend != "tpu" or all(
            (g.aoi_platform or cfg.aoi.platform) == "cpu"
            for g in cfg.games.values()):
        return
    from concurrent.futures import ThreadPoolExecutor

    from goworld_tpu_torch.ops import _build

    with ThreadPoolExecutor(len(_build.SOURCES)) as pool:
        futures = [pool.submit(_build.build, n) for n in _build.SOURCES]
        errors = []
        for f in futures:
            try:
                f.result()
            except RuntimeError as exc:
                errors.append(str(exc))
    if errors:
        sys.exit("CUDA kernel build failed; no game started:\n"
                 + "\n".join(errors))
    print(f"CUDA kernels: {', '.join(_build.SOURCES)} built in {_build.BUILD_DIR}")


def cmd_build(args) -> int:
    """Byte-compile the server module tree (parity with `goworld build`)."""
    spec = importlib.util.find_spec(args.server_module)
    if spec is None:
        sys.exit(f"server module {args.server_module!r} not found")
    targets = spec.submodule_search_locations or [os.path.dirname(spec.origin or "")]
    ok = all(compileall.compile_dir(t, quiet=1) for t in targets)
    from goworld_tpu_torch import native

    print(f"native wire framing: {native.prebuild()}")
    print(f"build {'ok' if ok else 'FAILED'}: {list(targets)}")
    return 0 if ok else 1


def cmd_start(args) -> int:
    from goworld_tpu_torch import native

    impl = native.prebuild()  # one compile here, not N racing in children
    print(f"native wire framing: {impl}")
    cfg = get_config()
    _build_kernels(cfg)
    run_dir = os.path.abspath(args.dir)
    names = _process_names(cfg)
    configfile = os.path.abspath(args.configfile) if args.configfile else ""
    cfg_argv = ["-configfile", configfile] if configfile else []

    for name in [n for group in names.values() for n in group]:
        _truncate_log(run_dir, name)

    print(f"starting {len(names['dispatcher'])} dispatcher(s) ...")
    for i, name in zip(sorted(cfg.dispatchers), names["dispatcher"]):
        _spawn(run_dir, name,
               [sys.executable, "-m", "goworld_tpu_torch.dispatcher", "-dispid", str(i)] + cfg_argv,
               consts.DISPATCHER_STARTED_TAG)
    print(f"starting {len(names['game'])} game(s) [{args.server_module}] ...")
    # Spawn the whole game batch BEFORE waiting on any tag: an AOI
    # multihost game blocks at the jax.distributed barrier until every
    # peer game is up, so sequential spawn-then-wait would deadlock (and
    # batching is faster for plain deploys too).
    spawned = []
    for i, name in zip(sorted(cfg.games), names["game"]):
        argv = [sys.executable, "-m", args.server_module, "-gid", str(i)] + cfg_argv
        if args.restore:
            argv.append("-restore")
        spawned.append((name,) + _spawn_nowait(run_dir, name, argv))
    try:
        for name, proc, offset in spawned:
            _wait_tag(run_dir, name, consts.GAME_STARTED_TAG, proc, offset)
    except SystemExit:
        # One game failed to boot: reap its batch-mates — otherwise they
        # linger daemonized (a multihost peer sits wedged at the mesh
        # barrier holding its ports) and the next `start` fails on
        # port conflicts until a manual `kill`.
        for name, proc, _ in spawned:
            if proc.poll() is None:
                proc.terminate()
        raise
    print(f"starting {len(names['gate'])} gate(s) ...")
    for i, name in zip(sorted(cfg.gates), names["gate"]):
        _spawn(run_dir, name,
               [sys.executable, "-m", "goworld_tpu_torch.gate", "-gid", str(i)] + cfg_argv,
               consts.GATE_STARTED_TAG)
    print("cluster started")
    return 0


def _stop_group(run_dir: str, kind: str, names: list[str], sig: int,
                server_module: str | None) -> None:
    expect = _expect_marker(kind, "", server_module)
    pids = []
    for name in names:
        pid = _read_pid(run_dir, name)
        if not _alive(pid, expect):
            print(f"  {name}: not running")
            continue
        try:
            os.kill(pid[0], sig)
        except ProcessLookupError:
            print(f"  {name}: already gone")
            continue
        pids.append((name, pid))
    deadline = time.monotonic() + STOP_TIMEOUT
    for name, pid in pids:
        while _alive(pid, expect) and time.monotonic() < deadline:
            time.sleep(0.05)
        if _alive(pid, expect):
            print(f"  {name}: did not exit; killing")
            try:
                os.kill(pid[0], signal.SIGKILL)
            except ProcessLookupError:
                pass
        else:
            print(f"  {name}: stopped")
        try:
            os.unlink(_pidfile(run_dir, name))
        except OSError:
            pass


def cmd_stop(args, sig: int = signal.SIGTERM) -> int:
    cfg = get_config()
    run_dir = os.path.abspath(args.dir)
    names = _process_names(cfg)
    # Reference order: gates first (detach clients), then games (save all
    # entities), then dispatchers (stop.go:11-60).
    print("stopping gates ...")
    _stop_group(run_dir, "gate", names["gate"], sig, None)
    print("stopping games ...")
    _stop_group(run_dir, "game", names["game"], sig, getattr(args, "server_module", None))
    print("stopping dispatchers ...")
    _stop_group(run_dir, "dispatcher", names["dispatcher"], sig, None)
    return 0


def cmd_kill(args) -> int:
    return cmd_stop(args, sig=signal.SIGKILL)


def cmd_reload(args) -> int:
    """Freeze games (SIGHUP) → wait for exit → restart with -restore.

    Dispatchers buffer the frozen games' packets and gates keep their client
    sockets, so clients ride through the swap (SURVEY.md §3.5).
    """
    cfg = get_config()
    _build_kernels(cfg)
    run_dir = os.path.abspath(args.dir)
    names = _process_names(cfg)["game"]
    expect = args.server_module
    frozen = []
    for i, name in zip(sorted(cfg.games), names):
        pid = _read_pid(run_dir, name)
        if not _alive(pid, expect):
            print(f"  {name}: not running; skipping")
            continue
        try:
            os.kill(pid[0], signal.SIGHUP)
        except ProcessLookupError:
            print(f"  {name}: already gone; skipping")
            continue
        frozen.append((name, pid, i))
    for name, pid, _ in frozen:
        deadline = time.monotonic() + FREEZE_TIMEOUT
        while _alive(pid, expect) and time.monotonic() < deadline:
            time.sleep(0.05)
        if _alive(pid, expect):
            sys.exit(f"{name} did not freeze within {FREEZE_TIMEOUT}s")
        print(f"  {name}: freezed")
    configfile = os.path.abspath(args.configfile) if args.configfile else ""
    cfg_argv = ["-configfile", configfile] if configfile else []
    # Spawn ALL restores first, then wait for every tag: the restart cost
    # (interpreter + imports + engine warmup, seconds per game) overlaps
    # instead of serializing, shrinking the window clients must ride out.
    # No truncation on reload: the pre-freeze log half is the forensic
    # record of what led into the swap (_wait_tag scans from the new
    # spawn marker, so stale tags can't satisfy the wait).
    started = []
    for name, _, i in frozen:
        proc, offset = _spawn_nowait(
            run_dir, name,
            [sys.executable, "-m", args.server_module, "-gid", str(i),
             "-restore"] + cfg_argv,
        )
        started.append((name, proc, offset))
    try:
        for name, proc, offset in started:
            _wait_tag(run_dir, name, consts.GAME_STARTED_TAG, proc, offset)
    except SystemExit:
        # Same reap as cmd_start's batch spawn: one failed restore must
        # not leave its batch-mates daemonized (a multihost peer sits
        # wedged at the mesh barrier holding its ports, and the next
        # start/reload fails on port conflicts until a manual `kill`).
        for name, proc, _ in started:
            if proc.poll() is None:
                proc.terminate()
        raise
    print("reload complete")
    return 0


def cmd_status(args) -> int:
    cfg = get_config()
    run_dir = os.path.abspath(args.dir)
    names = _process_names(cfg)
    total = alive = 0
    for kind, group in names.items():
        for name in group:
            total += 1
            pid = _read_pid(run_dir, name)
            up = _alive(pid, _expect_marker(kind, name, getattr(args, "server_module", None) or ""))
            alive += bool(up)
            print(f"  {name}: {'RUNNING pid=' + str(pid[0]) if up else 'not running'}")
    print(f"{alive}/{total} processes running")
    return 0 if alive == total else 1


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="goworld_tpu_torch.cli",
                                     description="goworld_tpu_torch ops CLI (cmd/goworld parity)")
    parser.add_argument("command",
                        choices=["build", "start", "stop", "kill", "reload", "status"])
    parser.add_argument("server_module", nargs="?", default=None,
                        help="python module of the game server (e.g. goworld_tpu_torch.examples.test_game)")
    parser.add_argument("-configfile", default="goworld.ini" if os.path.exists("goworld.ini") else "")
    parser.add_argument("-dir", default=".", help="run directory (pidfiles + logs)")
    parser.add_argument("-restore", action="store_true", help="start games with -restore")
    args = parser.parse_args(argv)

    if args.configfile:
        set_config_file(os.path.abspath(args.configfile))
    if args.command in ("build", "start", "reload") and not args.server_module:
        parser.error(f"{args.command} requires a server module")
    return {
        "build": cmd_build,
        "start": cmd_start,
        "stop": cmd_stop,
        "kill": cmd_kill,
        "reload": cmd_reload,
        "status": cmd_status,
    }[args.command](args)


if __name__ == "__main__":
    sys.exit(main())
