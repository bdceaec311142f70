"""Build the port's CUDA kernels from ``topsy_tpu_torch/csrc`` at first use.

Each ``.cu`` source is compiled by ``nvcc`` into its own shared library with
a plain C interface and loaded with ``ctypes`` (no PyTorch headers, so a
build takes seconds).  Libraries land in ``build/torch_kernels/`` at the
repository root, next to Triton's cache for the port's Triton kernels.
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
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC"]

_libs: dict[str, ctypes.CDLL] = {}


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


def build(names) -> None:
    """Compile ``csrc/<name>.cu`` for every name not yet loaded, one
    ``nvcc`` process per source, all started together, and load them."""
    todo = [n for n in dict.fromkeys(names) if n not in _libs]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {n: subprocess.Popen(
        [nvcc_path(), *NVCC_FLAGS, "-o", str(BUILD_DIR / f"lib{n}.so"),
         str(CSRC / f"{n}.cu")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for n in todo}
    failed = []
    for n, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for csrc/{n}.cu:\n{out}")
    if failed:
        raise RuntimeError("\n".join(failed))
    for n in todo:
        _libs[n] = ctypes.CDLL(str(BUILD_DIR / f"lib{n}.so"))


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    build([name])
    return _libs[name]


def triton_cache_dir() -> str:
    """Keep Triton's compile cache inside the build directory."""
    path = BUILD_DIR / "triton"
    path.mkdir(parents=True, exist_ok=True)
    os.environ.setdefault("TRITON_CACHE_DIR", str(path))
    return os.environ["TRITON_CACHE_DIR"]
