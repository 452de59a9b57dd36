"""Build and load the port's CUDA kernels (``kernels/csrc/*.cu``).

Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared
library with a plain C interface and loaded with ``ctypes``: no PyTorch
headers, so a build takes seconds.  Libraries go to ``build/repro_torch/``
at the repository root, named by a hash of the source, the local headers
it includes (``#include "x.cuh"``, followed through headers) and the
flags, so an edited source or header is rebuilt and an unchanged one is
loaded as it is.  Builds
happen at first use; ``build()`` compiles several sources at once, one
``nvcc`` process each.  A missing ``nvcc`` or a failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["BUILD_DIR", "CSRC", "NVCC_FLAGS", "build", "build_log",
           "build_seconds", "load_library"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
# Seconds each library's nvcc run took in this process (absent when it was
# already built) and the compiler's messages (ptxas register/smem report).
build_seconds: dict[str, float] = {}
build_log: dict[str, str] = {}


def _nvcc() -> str:
    cands = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                          "bin", "nvcc"), shutil.which("nvcc")]
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from source at first use")


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def _sources(src: Path) -> list[Path]:
    """``src`` and the local headers it includes, each once, in the order
    first met (an include is looked up beside the file that names it)."""
    seen, todo = [], [src.resolve()]
    while todo:
        f = todo.pop(0)
        if f in seen:
            continue
        seen.append(f)
        for m in _LOCAL_INCLUDE.finditer(f.read_bytes()):
            inc = (f.parent / m.group(1).decode()).resolve()
            if inc.is_file():
                todo.append(inc)
    return seen


def _library_path(name: str, csrc: Path = CSRC) -> Path:
    h = hashlib.sha256()
    for f in _sources(csrc / f"{name}.cu"):
        h.update(f.name.encode() + b"\0" + f.read_bytes())
    h.update(repr(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(names: list[str]) -> None:
    """Compile every listed source that is not built yet, all at once."""
    todo = [(n, _library_path(n)) for n in names
            if not _library_path(n).exists()]
    if not todo:
        return
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, so in todo:
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, so, tmp, time.perf_counter(),
                      subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, so, tmp, t0, proc in procs:
        log, _ = proc.communicate()
        build_log[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, so)       # atomic publish for concurrent builders
        build_seconds[name] = time.perf_counter() - t0
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = _LIBS[name] = ctypes.CDLL(str(_library_path(name)))
    return lib
