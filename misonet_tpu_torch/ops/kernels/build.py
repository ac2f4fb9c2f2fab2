"""Build and bind the port's CUDA kernels.

At first use, ``nvcc`` compiles every ``misonet_tpu_torch/csrc/*.cu`` into
one shared library with a plain C interface, written under
``build/torch_kernels/`` of the checkout and named by a hash of the sources
and flags, so an edited source rebuilds and an unchanged one is reused.
The compiler's ``-Xptxas -v`` report (registers, shared memory and spills
per kernel) is kept beside it as ``<library>.log``.  The library is loaded
with ``ctypes``; each kernel module declares the argument types of its own
entry point.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

PACKAGE = Path(__file__).resolve().parents[2]
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE.parent / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)


def find_nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                     "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the "
        "misonet_tpu_torch CUDA kernels are built from source at first use"
    )


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels unless a library for the current sources exists;
    returns its path."""
    lib = BUILD_DIR / f"libmisonet_kernels_{source_hash()}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-Xptxas", "-v",
           "-o", tmp, *map(str, sources())]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    lib.with_suffix(".log").write_text(
        f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        f"nvcc took {time.perf_counter() - t0:.1f} s\n"
    )
    os.replace(tmp, lib)
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    return ctypes.CDLL(str(build()))
