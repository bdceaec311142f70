"""SPH kernel mathematics for the TPU splatter.

A pinned copy of ``topsy_tpu/ops/kernels.py``.

The projected (2D) cubic-spline kernel is the line-of-sight integral of the
standard M4 cubic spline with support 2h (the same kernel the reference
obtains from pynbody; reference: src/topsy/sph.py:364-394).  Because TPUs
have no texture samplers, we do not build a mip-mapped texture.  Instead we

* tabulate the radial profile once (host, numpy),
* build a low-rank *separable* eigen-decomposition
  ``K(x, y) ~= sum_k s_k p_k(x^2) p_k(y^2)`` whose factors are fitted by
  polynomials, so kernel evaluation on device is pure FMA (no gathers), and
* tabulate a discrete mass-normalization ``c(h)`` that makes every splat
  deposit exactly its mass regardless of its pixel size (the reference
  achieves the same with per-mip-level normalization of its kernel texture,
  reference: src/topsy/sph.py:386-394).

Everything in this module is host-side numpy, computed once and cached.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np

from .. import config

KERNEL_SUPPORT = 2.0  # kernel support radius in units of h


def spline_m4(q: np.ndarray) -> np.ndarray:
    """Standard 3D M4 cubic-spline kernel (support 2h), h=1, normalized so
    that the 3D integral is 1."""
    q = np.asarray(q, dtype=np.float64)
    inner = (1.0 - 1.5 * q**2 + 0.75 * q**3) / np.pi
    outer = 0.25 * (2.0 - q) ** 3 / np.pi
    return np.where(q < 1.0, inner, np.where(q < 2.0, outer, 0.0))


@functools.lru_cache(maxsize=None)
def radial_table(n_samples: int = 2048) -> tuple[np.ndarray, np.ndarray]:
    """Tabulated projected kernel k2(q) = integral of M4 along z, q in [0,2].

    Normalized such that the 2D integral over the plane is exactly 1 (in
    units of h).
    """
    q = np.linspace(0.0, KERNEL_SUPPORT, n_samples)
    # integrate over z on [0, sqrt(4-q^2)] by fixed fine grid + trapezoid
    nz = 4096
    t = np.linspace(0.0, 1.0, nz)[None, :]
    zmax = np.sqrt(np.maximum(KERNEL_SUPPORT**2 - q[:, None] ** 2, 0.0))
    z = zmax * t
    vals = spline_m4(np.sqrt(q[:, None] ** 2 + z**2))
    k2 = 2.0 * np.trapezoid(vals, z, axis=1)
    # renormalize the 2D integral to exactly 1
    integral = 2.0 * np.pi * np.trapezoid(k2 * q, q)
    k2 /= integral
    return q, k2


def kernel_value(q: np.ndarray) -> np.ndarray:
    """Projected kernel value(s) at radius q (units of h), by interpolation."""
    qs, ks = radial_table()
    return np.interp(np.asarray(q, dtype=np.float64), qs, ks, right=0.0)


@dataclass(frozen=True)
class LowRankKernel:
    """Separable eigen-approximation of the projected kernel.

    K(x, y) ~= sum_k signs[k] * P_k(x^2) * P_k(y^2)   for |x|,|y| <= 2,

    where P_k is a polynomial with coefficients ``coeffs[k]`` (highest power
    first, evaluatable by Horner) in the variable s = t^2, valid on
    s in [0, 4]; values must be masked to zero for s > 4.
    """

    signs: np.ndarray       # (rank,)
    coeffs: np.ndarray      # (rank, degree+1), float32, highest power first
    rank: int
    degree: int

    def eval_profiles(self, t: np.ndarray) -> np.ndarray:
        """Evaluate all rank profiles at offsets t (units of h).

        Returns array of shape (rank,) + t.shape. numpy reference used by
        tests and table building; the device path re-implements this in jnp.
        """
        s = np.asarray(t, dtype=np.float64) ** 2
        out = np.empty((self.rank,) + s.shape)
        for k in range(self.rank):
            out[k] = np.polyval(self.coeffs[k].astype(np.float64), s)
        out *= (s <= KERNEL_SUPPORT**2)
        return out

    def eval_xy(self, x: np.ndarray, y: np.ndarray) -> np.ndarray:
        px = self.eval_profiles(x)
        py = self.eval_profiles(y)
        return np.einsum("k,k...,k...->...", self.signs, py, px)


@functools.lru_cache(maxsize=None)
def lowrank_kernel(rank: int = config.SPLAT_KERNEL_RANK,
                   degree: int = config.SPLAT_POLY_DEGREE,
                   grid: int = 257) -> LowRankKernel:
    """Build the low-rank separable kernel approximation.

    Rank 3 with degree-6 polynomial profiles constrained to vanish exactly at
    the support edge (``p(KERNEL_SUPPORT^2) = 0``) reproduces the projected
    kernel to ~1e-3 of its peak, inside the tolerance of the reference's own
    64x64 mip texture discretization.  The edge constraint means device
    evaluators can clamp ``t^2`` to the support instead of masking: values
    outside the support are exactly zero by construction.
    """
    xs = np.linspace(-KERNEL_SUPPORT, KERNEL_SUPPORT, grid)
    r = np.sqrt(xs[:, None] ** 2 + xs[None, :] ** 2)
    K = kernel_value(r)
    w, V = np.linalg.eigh(K)
    order = np.argsort(-np.abs(w))
    w, V = w[order], V[:, order]

    signs = np.sign(w[:rank])
    # continuous profile: v_k(x) = sqrt(|lambda_k|) * u_k(x)
    profiles = V[:, :rank] * np.sqrt(np.abs(w[:rank]))[None, :]

    s = xs**2
    edge = KERNEL_SUPPORT**2
    # constrained least squares: basis (s^j - edge^j), j = degree..1, spans
    # exactly the degree-``degree`` polynomials with p(edge) = 0
    A = np.stack([s**j - edge**j for j in range(degree, 0, -1)], axis=1)
    coeffs = np.empty((rank, degree + 1), dtype=np.float64)
    for k in range(rank):
        c, *_ = np.linalg.lstsq(A, profiles[:, k], rcond=None)
        const = -(c * (edge ** np.arange(degree, 0, -1))).sum()
        coeffs[k] = np.concatenate([c, [const]])
    return LowRankKernel(signs=signs.astype(np.float32),
                         coeffs=coeffs.astype(np.float32),
                         rank=rank, degree=degree)


@functools.lru_cache(maxsize=None)
def lowrank_integral(rank: int = config.SPLAT_KERNEL_RANK,
                     degree: int = config.SPLAT_POLY_DEGREE,
                     n: int = 8192) -> float:
    """2D integral of the low-rank separable kernel over its support.

    Separability makes it a sum of squared 1-D integrals:
    ``I = sum_k s_k (int p_k(t^2) dt)^2``.  Giant splats (support wider
    than any level window, ops/splat_giant.py) are normalized by ``1/I``
    instead of the discrete norm_table: for the h >= 8 px sizes the giant
    pass handles, the discrete pixel sum differs from the continuous
    integral by < 1e-4 (Euler-Maclaurin, the projected kernel is C^2), so
    mass conservation matches the truncated paths' table to well inside
    the reference's own pixel tolerances."""
    lrk = lowrank_kernel(rank, degree)
    t = np.linspace(-KERNEL_SUPPORT, KERNEL_SUPPORT, n)
    profiles = lrk.eval_profiles(t)          # (rank, n)
    line = np.trapezoid(profiles, t, axis=1)  # (rank,)
    return float(np.sum(lrk.signs * line**2))


@functools.lru_cache(maxsize=None)
def radial_edge_poly(degree: int = 10) -> np.ndarray:
    """Edge-factored polynomial fit of the projected kernel radial profile.

    ``k2(q) ~= g(u) * (4 - q^2)^3.5`` with ``u = q^2/2 - 1``: the
    line-of-sight integral of the M4 spline behaves as (2-q)^3.5 at the
    support edge, so factoring (4-q^2)^3.5 leaves a smooth positive g that
    a degree-10 fit reproduces to 4e-4 relative error *everywhere* —
    including the deep wings where any direct polynomial (or separable
    product) fit has unbounded relative error.  Used by the exact
    big-giant subpass (ops/splat_giant.py), whose wings singly dominate
    image corners.  Returns power-basis coefficients of g (highest first).
    """
    qs, ks = radial_table(8192)
    s = qs**2
    t = 4.0 - s
    sel = t > 1e-6
    g = ks[sel] / t[sel] ** 3.5
    u = s[sel] / 2.0 - 1.0
    cheb = np.polynomial.chebyshev.Chebyshev.fit(u, g, degree, domain=[-1, 1])
    coeffs = np.polynomial.chebyshev.cheb2poly(cheb.coef)[::-1]
    fit = np.polyval(coeffs, s / 2.0 - 1.0) * t**3.5
    band = ks > ks.max() * 1e-7
    err = np.abs(fit[band] / ks[band] - 1.0).max()
    assert err < 2e-3, f"radial edge fit error too large: {err}"
    return coeffs.astype(np.float64)


def _window_offsets(c: float, window: int) -> np.ndarray:
    """Pixel-centre offsets (relative to splat centre c) of the length-
    ``window`` window anchored at floor(c) - window//2 + 1."""
    start = np.floor(c) - window // 2 + 1
    return start + np.arange(window) - c


@functools.lru_cache(maxsize=None)
def norm_table(mode: str = "exact",
               window: int = config.SPLAT_WINDOW,
               h_min: float = 0.4, h_max: float = 16.0,
               n_h: int = 96, n_phase: int = 8) -> tuple[np.ndarray, np.ndarray]:
    """Discrete mass-normalization table c(h).

    ``c(h) = h^2 / E_phase[ sum over the window of K(dx/h, dy/h) ]`` so that a
    splat of smoothing length h (in pixels) deposits exactly its mass when its
    kernel values are multiplied by c(h)/h^2 and summed over its discrete
    footprint window.  ``mode`` selects the evaluator the table is exact for:
    'exact' (radial interpolation; scatter path) or 'lowrank' (polynomial
    separable evaluation; matmul path).
    """
    hs = np.geomspace(h_min, h_max, n_h)
    lrk = lowrank_kernel()
    phases = (np.arange(n_phase) + 0.5) / n_phase
    sums = np.zeros(n_h)
    for fy in phases:
        for fx in phases:
            # splat centre at fractional position (fy, fx)
            dy = _window_offsets(fy, window)
            dx = _window_offsets(fx, window)
            for i, h in enumerate(hs):
                ty = dy / h
                tx = dx / h
                if mode == "exact":
                    q = np.sqrt(ty[:, None] ** 2 + tx[None, :] ** 2)
                    vals = kernel_value(q)
                else:
                    vals = lrk.eval_xy(tx[None, :].repeat(window, 0),
                                       ty[:, None].repeat(window, 1))
                sums[i] += vals.sum()
    sums /= n_phase**2
    c = hs**2 / np.maximum(sums, 1e-30)
    return hs.astype(np.float32), c.astype(np.float32)
