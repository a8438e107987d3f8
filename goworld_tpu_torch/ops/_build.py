"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into
a shared library of its own with a plain C interface, at first use, into
``goworld_tpu_torch/_build/`` (listed in ``.gitignore``). The library's file
name carries a hash of its source, of the shared headers (``csrc/*.cuh``) and
of the flags, so an edited source builds anew, alone, and an unchanged one is
reused. The sources in the checkout are the only input; nothing is
downloaded.

There is no fallback: a missing ``nvcc`` or a failed build raises, with the
compiler's output.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
#: Every kernel source, by name (``csrc/<name>.cu``): one library each.
SOURCES = tuple(sorted(f.stem for f in CSRC.glob("*.cu")))

# --fmad=false: d2 = dx*dx + dz*dz must round each product and the sum, as
# the plain PyTorch versions do (an FMA changes the result at d2 == r2).
# -Xptxas -v prints each kernel's registers and shared memory.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)


def nvcc_path() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    path = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    if path is None or not os.path.exists(path):
        path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError(
            "nvcc not found: the CUDA toolkit is needed to build "
            f"the kernels in {CSRC}"
        )
    return path


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless it is built already. Returns the
    compiler's output ("" when the library was built before); raises with
    that output if ``nvcc`` fails."""
    target = library_path(name)
    if target.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}")
    os.replace(tmp, target)
    return proc.stdout


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """The built library ``csrc/<name>.cu``, building it first if needed."""
    build(name)
    return ctypes.CDLL(str(library_path(name)))
