"""Native (C) runtime hot paths, with transparent pure-Python fallback.

The reference ships its runtime as a compiled Go binary; the brief's
native-equivalents rule maps that to C where the Python runtime has a
measured hot loop. First citizen: ``_fastframe``, the wire framing every
process runs per packet (see fastframe.c's header for the profile
motivation).

Build strategy: compile on first import into the package directory
(atomic rename, so concurrent process startups race benignly) using the
toolchain baked into the image (``cc -O2 -shared -fPIC ... -lz``). The
built artifact carries a sidecar ``.srchash`` recording the sha256 of the
``fastframe.c`` it was compiled from; an .so whose sidecar does not match
the current source is rebuilt, never trusted — so a stale or foreign
binary can't silently shadow the reviewed C source. The CLI
calls :func:`prebuild` before spawning a fleet so the whole cluster pays
for ONE compile in the CLI process instead of N racing compiles in the
children (each child then just hash-checks and dlopens). Any failure —
missing compiler, sandboxed FS, exotic platform — degrades to the
pure-Python implementations in ``pyframe.py`` with identical semantics;
``GWT_NO_NATIVE=1`` forces the fallback (tests exercise BOTH).

Public surface (same signatures either way):

    split(data, max_packet)
        -> (list[(msgtype, payload_bytes)], consumed, error_or_None)
       Frames parsed before a malformed one are still returned (no valid
       packet is lost to a chunk boundary); error != None is
       connection-fatal for the caller.
    pack(msgtype, payload, compress, threshold, max_packet) -> bytes
    IMPL — "c" or "python", for diagnostics/tests.
"""

from __future__ import annotations

import hashlib
import importlib.util
import os
import subprocess
import sysconfig

from goworld_tpu_torch.native import pyframe as _py


def _paths(mod: str = "_fastframe",
           source: str = "fastframe.c") -> tuple[str, str, str]:
    pkg_dir = os.path.dirname(os.path.abspath(__file__))
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    so_path = os.path.join(pkg_dir, mod + suffix)
    return so_path, so_path + ".srchash", os.path.join(pkg_dir, source)


def _source_hash(src: str) -> str:
    with open(src, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _build_and_import(mod: str = "_fastframe", source: str = "fastframe.c",
                      libs: tuple[str, ...] = ("-lz",)):
    so_path, hash_path, src = _paths(mod, source)
    want = _source_hash(src)
    have = None
    if os.path.exists(so_path):
        try:
            with open(hash_path) as f:
                have = f.read().strip()
        except OSError:
            pass  # no sidecar → unverifiable artifact → rebuild
    if have != want:
        include = sysconfig.get_path("include")
        cc = os.environ.get("CC", "cc")
        tmp = so_path + f".tmp{os.getpid()}"
        cmd = [
            cc, "-O2", "-shared", "-fPIC", f"-I{include}",
            src, *libs, "-o", tmp,
        ]
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, so_path)  # atomic: concurrent builders race benignly
        htmp = hash_path + f".tmp{os.getpid()}"
        with open(htmp, "w") as f:
            f.write(want)
        os.replace(htmp, hash_path)
        # (A crash between the two replaces leaves hash != source, which
        # just forces a rebuild next import — never a stale .so in use.)
    # Load by explicit path — no sys.path mutation (a package-dir entry
    # would let native/ files shadow top-level module names process-wide).
    spec = importlib.util.spec_from_file_location(mod, so_path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def prebuild() -> str:
    """Ensure the native modules are built and verified against the
    current source hashes; returns the active IMPL ("c" or "python").
    Called by the CLI before spawning a fleet so children skip the
    compiles entirely."""
    global IMPL, split, pack, KCPCore, rs_matmul
    if os.environ.get("GWT_NO_NATIVE", "") == "1":
        return IMPL
    try:
        _c = _build_and_import()
        split, pack, IMPL = _c.split, _c.pack, "c"
    except Exception:  # pragma: no cover - environment-dependent
        pass
    try:
        _k = _build_and_import("_kcpcore", "kcpcore.c", libs=())
        KCPCore = _k.KCPCore
        rs_matmul = _k.rs_matmul
    except Exception:  # pragma: no cover - environment-dependent
        pass
    return IMPL


IMPL = "python"
split = _py.split
pack = _py.pack
KCPCore = None  # C KCP control block (netutil/kcp.py falls back to Python)
rs_matmul = None  # C GF(256) row mat-mul (netutil/fec.py falls back)
prebuild()  # also makes later explicit prebuild() calls cheap no-ops
