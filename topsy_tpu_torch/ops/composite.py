"""2x pyramid upsampling for the atlas collapse.

Counterpart of ``_upsample2x_matrix`` and ``upsample2x_kind_cm`` in
``topsy_tpu/ops/composite.py``.  The interpolation matrices are the
reference's own (host numpy, cached); the two per-axis products run as
float32 matmuls with TF32 off (``torch.backends.cuda.matmul.allow_tf32`` is
set False in ``topsy_tpu_torch/__init__.py``), as the reference runs them
at float32 precision.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _bspline3(t: np.ndarray) -> np.ndarray:
    """Cubic B-spline basis (support |t| < 2, partition of unity)."""
    t = np.abs(t)
    return np.where(
        t < 1.0, 2.0 / 3.0 - t**2 + 0.5 * t**3,
        np.where(t < 2.0, (2.0 - t) ** 3 / 6.0, 0.0))


@functools.lru_cache(maxsize=32)
def _upsample2x_matrix(n: int, kind: str = "spline") -> np.ndarray:
    """(n, 2n) interpolation matrix: y = x @ M upsamples the last axis with
    half-pixel-centre sampling and edge clamp — the interpolating cubic
    spline (B-spline prefilter folded in), built as the reference builds it.
    The port implements the configured filter, 'spline', only."""
    if kind != "spline":
        raise ValueError(f"pyramid collapse filter {kind!r}: the port "
                         "implements 'spline' only")
    m = np.zeros((n, 2 * n), dtype=np.float32)
    if n < 2:
        m[:, :] = 1.0
        return m
    # collocation: f[r] = sum_k c[k] B3(r - k), basis clamped at the edges
    r = np.arange(n)
    a = np.zeros((n, n))
    for k in range(-1, n + 1):
        a[:, min(max(k, 0), n - 1)] += _bspline3(r - k)
    # evaluation of the spline at fine half-pixel centres j/2 - 0.25
    xc = np.arange(2 * n) / 2.0 - 0.25
    e = np.zeros((n, 2 * n))
    for k in range(-1, n + 1):
        e[min(max(k, 0), n - 1), :] += _bspline3(xc - k)
    m[:, :] = np.linalg.solve(a.T, e)
    return m


@functools.lru_cache(maxsize=64)
def _matrix_on(n: int, kind: str, device: str) -> torch.Tensor:
    return torch.as_tensor(_upsample2x_matrix(n, kind), device=device)


def upsample2x_kind_cm(x: torch.Tensor, kind: str) -> torch.Tensor:
    """2x upsample over the two trailing axes of (C, H, W)."""
    C, H, W = x.shape
    dev = str(x.device)
    t = torch.einsum("chw,hH->cHw", x, _matrix_on(H, kind, dev))
    return torch.einsum("cHw,wW->cHW", t, _matrix_on(W, kind, dev))
