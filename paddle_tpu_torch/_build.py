"""Build the port's CUDA C++ kernels at first use and load them with
ctypes.

Each ``csrc/*.cu`` compiles with nvcc into its own shared library with
a plain C interface (declared in ``csrc/kernels.h``) under the
git-ignored ``build/`` directory beside this file.  A library's file
name carries a hash of its source, every header under ``csrc/``
(``*.h`` and ``*.cuh``) and the flags, so an edited source or header is
rebuilt and a stale library is never loaded.  All the
sources that need building compile at once, one nvcc process each.
Nothing here falls back: a missing nvcc or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_LIBS = {}


def _nvcc():
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): "
                           "the port's CUDA kernels cannot be built")
    return path


def _library_path(src):
    h = hashlib.sha256()
    for p in sorted([*CSRC.glob("*.h"), *CSRC.glob("*.cuh")]) + [src]:
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}.{h.hexdigest()[:16]}.so"


def build_all(verbose=False):
    """Compile every ``csrc/*.cu`` whose library is missing, one nvcc
    process per source, all started together.  ``verbose`` adds
    ``-Xptxas -v`` (registers, shared memory and spills per kernel).
    Returns ``{name: {"seconds": wall seconds, "log": nvcc stderr}}``
    for the sources built by this call."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    extra = ["-Xptxas", "-v"] if verbose else []
    jobs = {}
    try:
        for src in sorted(CSRC.glob("*.cu")):
            out = _library_path(src)
            if out.exists():
                continue
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, *extra, "-I", str(CSRC),
                   "-o", str(tmp), str(src)]
            jobs[src.stem] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True), tmp, out, time.perf_counter())
        built = {}
        for name, (proc, tmp, out, t0) in jobs.items():
            _, err = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed to build {name}.cu "
                                   f"(exit {proc.returncode}):\n{err}")
            os.replace(tmp, out)
            built[name] = {"seconds": time.perf_counter() - t0, "log": err}
        return built
    finally:
        for proc, tmp, _, _ in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if tmp.exists():
                tmp.unlink()


def load(name):
    """The loaded ctypes library of ``csrc/<name>.cu``, built first if
    needed."""
    lib = _LIBS.get(name)
    if lib is None:
        src = CSRC / f"{name}.cu"
        if not src.exists():
            raise FileNotFoundError(src)
        path = _library_path(src)
        if not path.exists():
            build_all()
        lib = _LIBS[name] = ctypes.CDLL(str(path))
    return lib
