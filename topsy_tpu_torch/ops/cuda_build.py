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


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    lib = _libs.get(name)
    if lib is None:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        out = BUILD_DIR / f"lib{name}.so"
        proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(out),
                               str(CSRC / f"{name}.cu")],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n"
                               f"{proc.stdout}{proc.stderr}")
        lib = _libs[name] = ctypes.CDLL(str(out))
    return lib


def triton_cache_dir() -> str:
    """Keep Triton's compile cache inside the build directory."""
    path = BUILD_DIR / "triton"
    path.mkdir(parents=True, exist_ok=True)
    os.environ.setdefault("TRITON_CACHE_DIR", str(path))
    return os.environ["TRITON_CACHE_DIR"]
