"""Build the port's CUDA kernels from ``topsy_tpu_torch/csrc`` at first use.

Each ``.cu`` source is compiled by ``nvcc`` into its own shared library with
a plain C interface and loaded with ``ctypes`` (no PyTorch headers, so a
build takes seconds); a library newer than its source is loaded as it
is.  Libraries land in ``build/torch_kernels/`` at the
repository root.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"

NVCC_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              # no FMA contraction: the kernels' f32 arithmetic rounds
              # exactly as the plain PyTorch versions' separate ops do
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              # registers, shared memory and spills of every kernel
              "-Xptxas=-v"]

_libs: dict[str, ctypes.CDLL] = {}
#: nvcc's output per built source (ptxas' resource lines)
build_logs: dict[str, str] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the port's CUDA kernels need the "
                       "CUDA toolkit (set CUDA_HOME)")


def _stem(name: str, defines) -> str:
    """The library's name: the source's, plus its ``-D`` flags if any."""
    return "-".join([name, *(d.removeprefix("-D").replace("=", "")
                             for d in defines)])


def build(names) -> None:
    """Compile ``csrc/<name>.cu`` for every name not yet loaded, one
    ``nvcc`` process per source, all started together, and load them.  An
    entry of ``names`` may also be a ``(name, defines)`` pair: a variant of
    the source built with extra ``-D`` flags into its own library (a
    breakdown build; the port's own libraries take none)."""
    jobs = {}
    for entry in names:
        n, d = (entry, ()) if isinstance(entry, str) else \
            (entry[0], tuple(entry[1]))
        s = _stem(n, d)
        if s in _libs:
            continue
        if _current(s, n):
            # built by an earlier process of this checkout (the workers of
            # a multi-process render load the parent's build)
            _libs[s] = ctypes.CDLL(str(BUILD_DIR / f"lib{s}.so"))
            continue
        jobs[s] = (n, d)
    if not jobs:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {s: subprocess.Popen(
        [nvcc_path(), *NVCC_FLAGS, *d, "-o", str(BUILD_DIR / f"lib{s}.so"),
         str(CSRC / f"{n}.cu")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for s, (n, d) in jobs.items()}
    failed = []
    for s, proc in procs.items():
        out, _ = proc.communicate()
        build_logs[s] = out
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {s}:\n{out}")
    if failed:
        raise RuntimeError("\n".join(failed))
    for s in jobs:
        _libs[s] = ctypes.CDLL(str(BUILD_DIR / f"lib{s}.so"))


def _current(stem: str, name: str) -> bool:
    """Whether ``lib<stem>.so`` exists and is newer than its source and
    than this file (which holds the flags)."""
    lib = BUILD_DIR / f"lib{stem}.so"
    if not lib.exists():
        return False
    newest = max((CSRC / f"{name}.cu").stat().st_mtime,
                 Path(__file__).stat().st_mtime)
    return lib.stat().st_mtime > newest


def library(name: str, defines=()) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (built with ``defines``),
    building it if needed."""
    build([(name, defines)])
    return _libs[_stem(name, defines)]
