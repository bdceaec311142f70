"""2x pyramid upsampling for the atlas collapses, and the periodic
lattice composite.

Counterpart of every function of ``topsy_tpu/ops/composite.py``.  The
interpolation matrices ('linear', 'catmull', 'spline') are the reference's
own (host numpy, cached); the two per-axis products run as float32 matmuls
with TF32 off (``torch.backends.cuda.matmul.allow_tf32`` is set False in
``topsy_tpu_torch/__init__.py``), as the reference runs them at float32
precision.  ``upsample2x_*`` take channel-last (H, W, C) images and
``upsample2x_*_cm`` channel-major (C, H, W) ones; the pyramid collapses
call ``upsample2x_kind_cm`` with ``config.PYRAMID_COLLAPSE_FILTER``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def upsample2x_linear(x: torch.Tensor) -> torch.Tensor:
    """Exact 2x bilinear upsample over the two leading axes of (H, W, ...):
    out[2k] = 0.75 in[k] + 0.25 in[k-1], out[2k+1] = 0.75 in[k] + 0.25
    in[k+1], clamped at the edges, by shifts and weighted adds as the
    reference computes it."""

    def axis0(a):
        lo = torch.cat([a[:1], a[:-1]], dim=0)
        hi = torch.cat([a[1:], a[-1:]], dim=0)
        even = 0.75 * a + 0.25 * lo
        odd = 0.75 * a + 0.25 * hi
        return torch.stack([even, odd], dim=1).reshape((-1,) + a.shape[1:])

    x = axis0(x)
    return axis0(x.transpose(0, 1)).transpose(0, 1)


def _catmull_weight(t: float) -> float:
    t = abs(t)
    if t < 1.0:
        return 1.5 * t**3 - 2.5 * t**2 + 1.0
    if t < 2.0:
        return -0.5 * t**3 + 2.5 * t**2 - 4.0 * t + 2.0
    return 0.0


def _bspline3(t: np.ndarray) -> np.ndarray:
    """Cubic B-spline basis (support |t| < 2, partition of unity)."""
    t = np.abs(t)
    return np.where(
        t < 1.0, 2.0 / 3.0 - t**2 + 0.5 * t**3,
        np.where(t < 2.0, (2.0 - t) ** 3 / 6.0, 0.0))


@functools.lru_cache(maxsize=32)
def _upsample2x_matrix(n: int, kind: str = "linear") -> np.ndarray:
    """(n, 2n) interpolation matrix: y = x @ M upsamples the last axis with
    half-pixel-centre sampling and edge clamp, built as the reference builds
    it.  ``kind``: 'linear' (out[2k] = 0.75 in[k] + 0.25 in[k-1], out[2k+1]
    = 0.75 in[k] + 0.25 in[k+1]; the surface collapse), 'catmull' (4-tap
    Catmull-Rom, third-order accurate) or 'spline' (the interpolating cubic
    spline, B-spline prefilter folded in, fourth-order; the default density
    collapse).  Any other name is the 'catmull' filter, as in the
    reference.  Every kind preserves constants (interior rows sum to 2)."""
    m = np.zeros((n, 2 * n), dtype=np.float32)
    if kind == "linear":
        k = np.arange(n)
        m[k, 2 * k] += 0.75
        m[np.maximum(k - 1, 0), 2 * k] += 0.25
        m[k, 2 * k + 1] += 0.75
        m[np.minimum(k + 1, n - 1), 2 * k + 1] += 0.25
        return m
    if kind != "spline":
        for j in range(2 * n):
            xc = j / 2.0 - 0.25  # coarse-grid coordinate of fine centre j
            k0 = int(np.floor(xc))
            for k in range(k0 - 1, k0 + 3):
                m[min(max(k, 0), n - 1), j] += _catmull_weight(xc - k)
        return m
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


def upsample2x_linear_cm(x: torch.Tensor) -> torch.Tensor:
    """Exact 2x bilinear upsample over the two trailing axes of (C, H, W),
    by the 'linear' matrix's products."""
    return upsample2x_kind_cm(x, "linear")


def upsample2x_kind(x: torch.Tensor, kind: str) -> torch.Tensor:
    """2x upsample over the two leading axes of (H, W, ...) with the given
    reconstruction filter (``_upsample2x_matrix``)."""
    H, W = x.shape[0], x.shape[1]
    dev = str(x.device)
    t = torch.einsum("hw...,hH->Hw...", x, _matrix_on(H, kind, dev))
    return torch.einsum("Hw...,wW->HW...", t, _matrix_on(W, kind, dev))


def upsample2x_catmull(x: torch.Tensor) -> torch.Tensor:
    """2x Catmull-Rom upsample over the two leading axes of (H, W, C)."""
    return upsample2x_kind(x, "catmull")


def upsample2x_kind_cm(x: torch.Tensor, kind: str) -> torch.Tensor:
    """2x upsample over the two trailing axes of (C, H, W)."""
    C, H, W = x.shape
    dev = str(x.device)
    t = torch.einsum("chw,hH->cHw", x, _matrix_on(H, kind, dev))
    return torch.einsum("cHw,wW->cHW", t, _matrix_on(W, kind, dev))


def upsample2x_catmull_cm(x: torch.Tensor) -> torch.Tensor:
    """2x Catmull-Rom upsample over the two trailing axes of (C, H, W)."""
    return upsample2x_kind_cm(x, "catmull")


def upsample2x_zmax_cm(dv: torch.Tensor) -> torch.Tensor:
    """Coverage-normalized 2x bilinear upsample of a (2=[depth, payload], H,
    W) z-buffer level (depth > 0 means covered), as the reference's
    ``upsample2x_zmax_cm``: (depth*cov, payload*cov, cov) are interpolated
    and normalized by the interpolated coverage; a fine pixel is covered iff
    that coverage exceeds 0.5.  The payload is the nearest coarse pixel's
    (the winner's quantity, never a blend), falling back to the
    coverage-weighted average where the nearest coarse pixel is empty."""
    depth, val = dv[0], dv[1]
    cov = (depth > 0.0).to(depth.dtype)
    up = upsample2x_kind_cm(torch.stack([depth * cov, val * cov, cov]),
                            "linear")
    covf = up[2]
    valid = covf > 0.5
    inv = 1.0 / torch.clamp(covf, min=1e-20)
    near_v = val.repeat_interleave(2, dim=0).repeat_interleave(2, dim=1)
    near_cov = cov.repeat_interleave(2, dim=0).repeat_interleave(2,
                                                                 dim=1) > 0.0
    payload = torch.where(near_cov, near_v, up[1] * inv)
    return torch.stack([torch.where(valid, up[0] * inv, 0.0),
                        torch.where(valid, payload, 0.0)])


def _integer_shift(im: torch.Tensor, iy: int, ix: int) -> torch.Tensor:
    """Shift (H, W, C) by whole pixels (rows down by ``iy``, columns right
    by ``ix``), zero-filling the vacated region."""
    H, W = im.shape[0], im.shape[1]
    out = torch.zeros_like(im)
    if abs(iy) >= H or abs(ix) >= W:
        return out
    out[max(iy, 0):H + min(iy, 0), max(ix, 0):W + min(ix, 0)] = \
        im[max(-iy, 0):H - max(iy, 0), max(-ix, 0):W - max(ix, 0)]
    return out


def shift_bilinear(im: torch.Tensor, dy, dx) -> torch.Tensor:
    """Shift (H, W, C) by fractional (dy, dx) pixels (host float32
    scalars) with bilinear filtering and zero fill."""
    dy, dx = np.float32(dy), np.float32(dx)
    iy, ix = int(np.floor(dy)), int(np.floor(dx))
    fy = float(dy - np.float32(iy))
    fx = float(dx - np.float32(ix))
    gy, gx = float(np.float32(1.0) - np.float32(fy)), \
        float(np.float32(1.0) - np.float32(fx))
    return (_integer_shift(im, iy, ix) * gy * gx
            + _integer_shift(im, iy, ix + 1) * gy * fx
            + _integer_shift(im, iy + 1, ix) * fy * gx
            + _integer_shift(im, iy + 1, ix + 1) * fy * fx)


def lattice_composite(image: torch.Tensor, offsets_px, weights
                      ) -> torch.Tensor:
    """Sum of weighted bilinear-shifted copies of the (H, W, C) ``image``.

    offsets_px: (K, 2) host (dy, dx) pixel shifts; weights: (K,) host
    weights.  One instance at a time, as the reference's scan; a
    zero-weight instance still costs its shift."""
    offsets_px = np.asarray(offsets_px, dtype=np.float32).reshape(-1, 2)
    weights = np.asarray(weights, dtype=np.float32).reshape(-1)
    out = torch.zeros_like(image)
    for (dy, dx), w in zip(offsets_px, weights):
        out = out + shift_bilinear(image, dy, dx) * float(w)
    return out
