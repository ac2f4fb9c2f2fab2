"""Build and bind the port's CUDA kernels.

At first use, ``nvcc`` compiles every ``misonet_tpu_torch/csrc/*.cu``, one
process per source, all started together, and links the objects into one
shared library with a plain C interface, written under
``build/torch_kernels/`` of the checkout and named by a hash of the sources
and flags, so an edited source rebuilds and an unchanged one is reused.
The compiler's ``-Xptxas -v`` report (registers, shared memory and spills
per kernel) is kept beside it as ``<library>.log``.  The library is loaded
with ``ctypes``; each kernel module declares the argument types of its own
entry point.  Nothing here runs at import time.

Each wrapper counts its launches in a plain int on itself through
:func:`count_launch`, which also adds them to the calling thread's open
:func:`tally`: a CUDA graph's capture learns from it which launches it
recorded (another thread's launches meanwhile are not among them), and
adds them again on each replay (:func:`add_launches`).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

PACKAGE = Path(__file__).resolve().parents[2]
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE.parent / "build" / "torch_kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC")
LINK_FLAGS = (*ARCH_FLAGS, "-shared")


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
    h = hashlib.sha256(" ".join((*COMPILE_FLAGS, *LINK_FLAGS)).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _run(cmds: list[list[str]]) -> list[str]:
    """Run the commands side by side; wait for all of them; return their
    output, raising if any failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({p.returncode}):\n{' '.join(cmd)}\n{out}")
    return outs


def build() -> Path:
    """Compile the kernels unless a library for the current sources exists;
    returns its path."""
    lib = BUILD_DIR / f"libmisonet_kernels_{source_hash()}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in sources()]
        compile_cmds = [
            [nvcc, *COMPILE_FLAGS, "-I", str(CSRC), "-Xptxas", "-v", "-c",
             "-o", str(obj), str(src)]
            for src, obj in zip(sources(), objs)
        ]
        outs = _run(compile_cmds)
        so = Path(tmp) / lib.name
        link_cmd = [nvcc, *LINK_FLAGS, "-o", str(so), *map(str, objs)]
        outs += _run([link_cmd])
        lib.with_suffix(".log").write_text(
            "".join(f"{' '.join(c)}\n{o}"
                    for c, o in zip([*compile_cmds, link_cmd], outs))
            + f"nvcc took {time.perf_counter() - t0:.1f} s\n"
        )
        os.replace(so, lib)
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    return ctypes.CDLL(str(build()))


_tallies = threading.local()


def count_launch(wrapper, attr: str) -> None:
    """One more launch in the counter ``wrapper.<attr>`` (and in the
    calling thread's open :func:`tally`, if any)."""
    setattr(wrapper, attr, getattr(wrapper, attr) + 1)
    tally_ = getattr(_tallies, "open", None)
    if tally_ is not None:
        tally_[wrapper, attr] = tally_.get((wrapper, attr), 0) + 1


@contextlib.contextmanager
def tally():
    """Yields {(wrapper, counter attribute): launches} counted on this
    thread inside the block."""
    outer = getattr(_tallies, "open", None)
    _tallies.open = counts = {}
    try:
        yield counts
    finally:
        _tallies.open = outer


def add_launches(counts: dict, sign: int = 1) -> None:
    """Add ``sign`` times a :func:`tally`'s launches to the counters."""
    for (wrapper, attr), n in counts.items():
        setattr(wrapper, attr, getattr(wrapper, attr) + sign * n)
