"""Native (C++/OpenMP) host runtime: cell binning, the interleaved LOD
order, the exact kNN smoothing lengths and the (smoothing-bucket, Morton)
presort.

A pinned copy of ``topsy_tpu/native/__init__.py``.  ``_native.cpp`` is
compiled with ``g++`` at first use into ``build/torch_native/`` at the
repository root and loaded with ctypes.  Every entry point returns None
when the library cannot be built, and its caller then takes the numpy path
(for the kNN, the ArrayDataLoader's multigrid estimate): these are
host-side computations, not device kernels.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

logger = logging.getLogger(__name__)

_lock = threading.Lock()
_lib = None
_build_failed = False

_SRC = Path(__file__).resolve().parent / "_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"


def _load() -> ctypes.CDLL | None:
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        so = BUILD_DIR / "_native.so"
        try:
            if (not so.exists()
                    or so.stat().st_mtime < _SRC.stat().st_mtime):
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = str(so) + f".{os.getpid()}.tmp"
                cmd = ["g++", "-O3", "-fopenmp", "-shared", "-fPIC",
                       "-std=c++17", str(_SRC), "-o", tmp]
                subprocess.run(cmd, check=True, capture_output=True)
                os.replace(tmp, so)
            lib = ctypes.CDLL(str(so))
        except (OSError, subprocess.CalledProcessError) as e:
            logger.warning("Native runtime unavailable (%s); using numpy "
                           "fallbacks", e)
            _build_failed = True
            return None
        lib.cell_sort.restype = ctypes.c_int
        lib.cell_sort.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_double,
            ctypes.c_double, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.interleave_order.restype = None
        lib.interleave_order.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
        lib.knn_smooth.restype = None
        lib.knn_smooth.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                   ctypes.c_int, ctypes.c_void_p]
        lib.presort_order.restype = None
        lib.presort_order.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_double,
            ctypes.c_void_p, ctypes.c_void_p]
        _lib = lib
        logger.info("Loaded native runtime (%s)", so)
        return _lib


def cell_sort(positions: np.ndarray, box_min: float, box_max: float,
              nside: int):
    """(ordering, offsets, lengths) for cell-contiguous layout, or None to
    signal the caller to use the numpy path."""
    lib = _load()
    if lib is None:
        return None
    pos = np.ascontiguousarray(positions, dtype=np.float32)
    n = len(pos)
    ordering = np.empty(n, dtype=np.int64)
    ncell = nside ** 3
    offsets = np.empty(ncell, dtype=np.int64)
    lengths = np.empty(ncell, dtype=np.int64)
    rc = lib.cell_sort(pos.ctypes.data, n, float(box_min), float(box_max),
                       int(nside), ordering.ctypes.data, offsets.ctypes.data,
                       lengths.ctypes.data)
    if rc != 0:
        raise ValueError("Particle positions are outside the box")
    return ordering, offsets, lengths


def interleave_order(offsets: np.ndarray, lengths: np.ndarray,
                     phi: np.ndarray):
    lib = _load()
    if lib is None:
        return None
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    lengths = np.ascontiguousarray(lengths, dtype=np.int64)
    phi = np.ascontiguousarray(phi, dtype=np.float64)
    n = int(lengths.sum())
    order = np.empty(n, dtype=np.int64)
    lib.interleave_order(offsets.ctypes.data, lengths.ctypes.data,
                         phi.ctypes.data, len(lengths), n, order.ctypes.data)
    return order


def presort_order(pos_smooth: np.ndarray, delta_octave: float):
    """(buckets, order) for the (smoothing-bucket, Morton) presort
    (ops/morton.py) via a native LSD radix sort — same key, same result
    ordering as the numpy path.  None if the native library is
    unavailable."""
    lib = _load()
    if lib is None:
        return None
    ps = np.ascontiguousarray(pos_smooth, dtype=np.float32)
    n = len(ps)
    buckets = np.empty(n, dtype=np.int32)
    order = np.empty(n, dtype=np.int64)
    lib.presort_order(ps.ctypes.data, n, float(delta_octave),
                      buckets.ctypes.data, order.ctypes.data)
    return buckets, order


def knn_smooth(positions: np.ndarray,
               n_neighbors: int = 64) -> np.ndarray | None:
    """Exact kNN smoothing lengths, h = 0.5 * d_nn (pynbody convention);
    None if the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    pos = np.ascontiguousarray(positions, dtype=np.float32)
    h = np.empty(len(pos), dtype=np.float32)
    lib.knn_smooth(pos.ctypes.data, len(pos), int(n_neighbors), h.ctypes.data)
    return h
