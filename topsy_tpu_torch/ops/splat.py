"""Particle splatting front end and the scatter ground truth.

Counterpart of ``topsy_tpu/ops/splat.py``: projection, pyramid levels,
the bit-trick powers of two, the mass-normalisation polynomial, the deposit
coefficients, the low-rank profiles (``profiles_select``, CIC hats for
tiny splats), ``splat_scatter``, the windowed scatter-add splatter the
tests hold every other path against, and ``splat_bruteforce``, the float64
continuous ideal.  Host-side kernel tables come from the pinned copy
``ops/kernels``.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from .. import config
from . import kernels

WINDOW = config.SPLAT_WINDOW
H_MAX = config.SPLAT_MAX_HALF_SIZE_PX
H_MIN = config.SPLAT_MIN_HALF_SIZE_PX
H_TRUNC = 16.0  # coarsest-level smoothing clamp for the norm table domain


@dataclass(frozen=True)
class PyramidSpec:
    resolution: int
    num_levels: int
    pad: int  # padding pixels on each side of each level buffer

    @property
    def level_resolutions(self) -> tuple[int, ...]:
        return tuple(max(1, -(-self.resolution // (1 << l)))
                     for l in range(self.num_levels))

    @property
    def padded_sizes(self) -> tuple[int, ...]:
        return tuple(r + 2 * self.pad for r in self.level_resolutions)

    @property
    def flat_offsets(self) -> tuple[int, ...]:
        offs = [0]
        for s in self.padded_sizes:
            offs.append(offs[-1] + s * s)
        return tuple(offs)

    @property
    def flat_size(self) -> int:
        return self.flat_offsets[-1]


def default_pyramid(resolution: int) -> PyramidSpec:
    n = min(config.SPLAT_PYRAMID_LEVELS,
            max(1, int(np.log2(max(resolution, 16) / 16)) + 1))
    return PyramidSpec(resolution=resolution, num_levels=n, pad=WINDOW)


def _scalar(v, device):
    """A float32 0-dim tensor from a python/numpy scalar or a tensor.  A
    scalar is filled on the device: an upload from pageable host memory
    would wait for the device's queue."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.float32)
    return torch.full((), float(v), dtype=torch.float32, device=device)


def project(pos_smooth: torch.Tensor, matrix, resolution: int, scale):
    """Project particles to screen space.

    pos_smooth: (N, 4) [x, y, z, h]; matrix: (4, 4) world->clip.
    Returns (cx, cy, z01, h_px, visible) as in the reference."""
    m = torch.as_tensor(matrix, dtype=torch.float32, device=pos_smooth.device)
    x, y, z = pos_smooth[:, 0], pos_smooth[:, 1], pos_smooth[:, 2]
    clip_x = x * m[0, 0] + y * m[0, 1] + z * m[0, 2] + m[0, 3]
    clip_y = x * m[1, 0] + y * m[1, 1] + z * m[1, 2] + m[1, 3]
    z01 = x * m[2, 0] + y * m[2, 1] + z * m[2, 2] + m[2, 3]
    cx = (clip_x + 1.0) * (resolution / 2.0) - 0.5
    cy = (1.0 - clip_y) * (resolution / 2.0) - 0.5
    h_px = pos_smooth[:, 3] * _scalar(resolution / (2.0 * scale),
                                      pos_smooth.device)
    visible = ((z01 >= 0.0) & (z01 <= 1.0) & (h_px > 0.0)
               & torch.isfinite(h_px))
    return cx, cy, z01, h_px, visible


def exp2_int(e: torch.Tensor) -> torch.Tensor:
    """Exact 2^e for small integer tensors via the f32 exponent field."""
    return ((e.to(torch.int32) + 127) << 23).to(torch.int32).view(torch.float32)


def ceil_log2_pos(x: torch.Tensor) -> torch.Tensor:
    """ceil(log2(x)) for positive normal f32, via exponent/mantissa bits."""
    bits = x.to(torch.float32).view(torch.int32)
    e = ((bits >> 23) & 0xFF) - 127
    return e + ((bits & 0x7FFFFF) != 0).to(torch.int32)


def assign_levels(h_px: torch.Tensor, num_levels: int, lev=None):
    """Pyramid level per splat and the effective smoothing in level pixels
    (``tiny`` splats deposit a cloud-in-cell hat with h_eff = 1)."""
    if lev is None:
        lev = ceil_log2_pos(torch.clamp(h_px, min=1e-30) / H_MAX)
        lev = torch.clamp(lev, 0, num_levels - 1)
    h_l = h_px * exp2_int(-lev)
    tiny = h_l < H_MIN
    h_eff = torch.where(tiny, 1.0, torch.clamp(h_l, H_MIN, H_TRUNC))
    return lev, h_eff, tiny


def levels_from_buckets(buckets: torch.Tensor, px_per_world, num_levels: int):
    """Pyramid levels derived from static 1/8-octave smoothing buckets
    (the bucket's upper edge is the representative smoothing)."""
    from .morton import DELTA_OCTAVE
    s = torch.log2(_scalar(px_per_world / H_MAX, buckets.device))
    lev = torch.ceil((buckets.to(torch.float32) + 1.0) * DELTA_OCTAVE + s)
    return torch.clamp(lev, 0, num_levels - 1).to(torch.int32)


@functools.lru_cache(maxsize=None)
def _norm_poly(mode: str, degree: int = 12) -> tuple[np.ndarray, float, float]:
    """Chebyshev fit of c(h) against normalised h (power-basis coefficients,
    highest first; centre; halfwidth) — the reference's construction."""
    hs, cs = kernels.norm_table(mode)
    lo, hi = hs[0], hs[-1]
    centre, halfwidth = (hi + lo) / 2.0, (hi - lo) / 2.0
    t = (hs - centre) / halfwidth
    cheb = np.polynomial.chebyshev.Chebyshev.fit(t, cs, degree, domain=[-1, 1])
    coeffs = np.polynomial.chebyshev.cheb2poly(cheb.coef)[::-1]
    fit = np.polyval(coeffs, t)
    err = np.abs(fit / cs - 1.0).max()
    assert err < 5e-3, f"norm poly fit error too large: {err}"
    return coeffs.astype(np.float64), float(centre), float(halfwidth)


def norm_factor(h_eff: torch.Tensor, mode: str) -> torch.Tensor:
    """Discrete mass-normalisation c(h_eff), a Horner polynomial."""
    coeffs, centre, halfwidth = _norm_poly(mode)
    x = (torch.clamp(h_eff, 0.4, H_TRUNC) - centre) / halfwidth
    acc = torch.full_like(x, float(coeffs[0]))
    for c in coeffs[1:]:
        acc = acc * x + float(c)
    return acc


def splat_coefficients(pos_smooth, values, matrix, resolution, scale,
                       pyramid: PyramidSpec, extra_mask=None, mode="exact",
                       depth_channel=False, level_override=None):
    """Shared front end: projection, level assignment, deposit coefficients.

    Returns a dict of per-particle tensors with the reference's keys."""
    from . import splat_giant
    cx, cy, z01, h_px, visible = project(pos_smooth, matrix, resolution, scale)
    if depth_channel:
        values = torch.cat([values, values[:, :1] * z01[:, None]], dim=1)
    lev, h_eff, tiny = assign_levels(h_px, pyramid.num_levels,
                                     lev=level_override)
    lev_scale = exp2_int(lev)
    inv_lev_scale = exp2_int(-lev)

    cx_l = (cx + 0.5) * inv_lev_scale - 0.5
    cy_l = (cy + 0.5) * inv_lev_scale - 0.5

    px_per_world = _scalar(resolution / (2.0 * scale), pos_smooth.device)
    h_eff_world = h_eff * lev_scale / px_per_world

    c_norm = torch.where(tiny, 1.0, norm_factor(h_eff, mode))
    w = c_norm / (h_eff_world * h_eff_world)
    w = torch.where(visible, w, 0.0)
    if extra_mask is not None:
        w = torch.where(extra_mask, w, 0.0)
    coef = values * w[:, None]

    h_l = h_px * inv_lev_scale
    giant = (~tiny) & (h_l > splat_giant.GIANT_H) & (torch.abs(w) > 0.0)
    coef_giant = values * torch.where(
        giant, splat_giant.giant_norm(h_px, px_per_world), 0.0)[:, None]
    return dict(level=lev, cx=cx_l, cy=cy_l, h_eff=h_eff, tiny=tiny,
                coef=coef, giant=giant, coef_giant=coef_giant,
                cx_fine=cx, cy_fine=cy, h_px=h_px)


# ---------------------------------------------------------------------------
# scatter ground truth
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _radial_table_f32(n: int = 2048) -> np.ndarray:
    _, k = kernels.radial_table(n)
    return k.astype(np.float32)


def kernel_radial(q: torch.Tensor) -> torch.Tensor:
    """Exact radial kernel via table interpolation."""
    table = torch.as_tensor(_radial_table_f32(), device=q.device)
    n = table.shape[0]
    x = torch.clamp(q, 0.0, kernels.KERNEL_SUPPORT) * (
        (n - 1) / kernels.KERNEL_SUPPORT)
    i0 = torch.clamp(x.to(torch.int32), 0, n - 2).long()
    frac = x - i0.to(torch.float32)
    v = table[i0] * (1.0 - frac) + table[i0 + 1] * frac
    return torch.where(q < kernels.KERNEL_SUPPORT, v, 0.0)


def hat_profile(t2: torch.Tensor) -> torch.Tensor:
    """Cloud-in-cell triangle profile max(0, 1 - |t|) from squared offsets."""
    return torch.clamp(1.0 - torch.sqrt(torch.clamp(t2, min=0.0)), min=0.0)


def lowrank_profiles(t2: torch.Tensor, lrk: kernels.LowRankKernel
                     ) -> torch.Tensor:
    """The low-rank kernel profiles at squared offsets t2 (units of h^2) by
    Horner polynomials, zero beyond the support.  Returns (rank,) +
    t2.shape."""
    outs = []
    for k in range(lrk.rank):
        acc = torch.full_like(t2, float(lrk.coeffs[k][0]))
        for c in lrk.coeffs[k][1:]:
            acc = acc * t2 + float(c)
        outs.append(torch.where(t2 <= kernels.KERNEL_SUPPORT ** 2, acc, 0.0))
    return torch.stack(outs)


def profiles_select(t2: torch.Tensor, tiny: torch.Tensor,
                    lrk: kernels.LowRankKernel, signed: bool) -> torch.Tensor:
    """Kernel profiles with the CIC hat substituted for tiny splats (rank 1:
    the higher profiles are zero there); ``tiny`` broadcasts against t2."""
    p = lowrank_profiles(t2, lrk)
    if signed:
        sign = torch.as_tensor(np.asarray(lrk.signs, np.float32),
                               device=t2.device)
        p = p * sign.reshape((-1,) + (1,) * t2.dim())
    hat = hat_profile(t2)
    zero = torch.zeros_like(t2)
    return torch.stack([torch.where(tiny, hat if k == 0 else zero, p[k])
                        for k in range(lrk.rank)])


def splat_scatter(pos_smooth, values, matrix, resolution, scale,
                  extra_mask=None, pyramid: PyramidSpec | None = None,
                  depth_channel=False, chunk: int = 1 << 18):
    """Windowed scatter-add splatter, (N,4) x (N,C) -> (res, res, C), written
    with ``index_add_``.  ``chunk`` bounds the (chunk, WINDOW, WINDOW)
    temporaries; it changes only the order of the f32 sums."""
    from . import splat_giant
    if pyramid is None:
        pyramid = default_pyramid(resolution)
    dev = pos_smooth.device
    parts = splat_coefficients(pos_smooth, values, matrix, resolution, scale,
                               pyramid, extra_mask, mode="exact",
                               depth_channel=depth_channel)
    C = values.shape[1] + (1 if depth_channel else 0)
    lev, cx, cy, h_eff, coef = (parts["level"], parts["cx"], parts["cy"],
                                parts["h_eff"], parts["coef"])

    gidx, gvalid, excluded = splat_giant.select_giants_topk(
        parts["giant"], parts["h_px"], splat_giant.CAP)
    coef = torch.where(excluded[:, None], 0.0, coef)
    giant_im = splat_giant.giant_image(
        parts["cy_fine"][gidx], parts["cx_fine"][gidx], parts["h_px"][gidx],
        parts["coef_giant"][gidx] * gvalid[:, None], resolution)

    pad = pyramid.pad
    lev_l = lev.long()
    res_l = torch.as_tensor(pyramid.level_resolutions, device=dev)[lev_l]
    sizes = torch.as_tensor(pyramid.padded_sizes, device=dev)[lev_l]
    flat_offs = torch.as_tensor(pyramid.flat_offsets, device=dev)[lev_l]

    sx = torch.minimum(torch.clamp(
        torch.floor(cx).to(torch.int32) - (WINDOW // 2 - 1) + pad, min=0),
        sizes - WINDOW)
    sy = torch.minimum(torch.clamp(
        torch.floor(cy).to(torch.int32) - (WINDOW // 2 - 1) + pad, min=0),
        sizes - WINDOW)
    res_f = res_l.to(torch.float32)
    inside = ((cx > -pad - 8.0) & (cx < res_f + pad + 8.0)
              & (cy > -pad - 8.0) & (cy < res_f + pad + 8.0))
    coef = coef * inside[:, None].to(coef.dtype)

    buf = torch.zeros((pyramid.flat_size, C), dtype=torch.float32, device=dev)
    d = torch.arange(WINDOW, dtype=torch.float32, device=dev)
    di = torch.arange(WINDOW, dtype=torch.int64, device=dev)
    tiny_all = parts["tiny"]
    for s in range(0, cx.shape[0], chunk):
        e = s + chunk
        dx = (sx[s:e] - pad)[:, None] + d[None, :] - cx[s:e, None]
        dy = (sy[s:e] - pad)[:, None] + d[None, :] - cy[s:e, None]
        inv_h = 1.0 / h_eff[s:e]
        q = (torch.sqrt(dy[:, :, None] ** 2 + dx[:, None, :] ** 2)
             * inv_h[:, None, None])
        w_kernel = kernel_radial(q)
        hat2d = (hat_profile(dy ** 2)[:, :, None]
                 * hat_profile(dx ** 2)[:, None, :])
        w = torch.where(tiny_all[s:e, None, None], hat2d, w_kernel)
        rows = sy[s:e, None].long() + di[None, :]
        cols = sx[s:e, None].long() + di[None, :]
        flat_idx = (flat_offs[s:e, None, None]
                    + rows[:, :, None] * sizes[s:e, None, None]
                    + cols[:, None, :])
        updates = w[..., None] * coef[s:e, None, None, :]
        buf.index_add_(0, flat_idx.reshape(-1), updates.reshape(-1, C))
    return collapse_pyramid(buf, pyramid) + giant_im


def collapse_pyramid(flat_buffer: torch.Tensor,
                     pyramid: PyramidSpec) -> torch.Tensor:
    """Crop each level out of the flat buffer, upsample and sum coarse->fine."""
    from .composite import upsample2x_kind_cm
    C = flat_buffer.shape[-1]
    pad = pyramid.pad
    levels = []
    for l in range(pyramid.num_levels):
        size = pyramid.padded_sizes[l]
        off = pyramid.flat_offsets[l]
        im = flat_buffer[off:off + size * size].reshape(size, size, C)
        levels.append(im[pad:size - pad, pad:size - pad].permute(2, 0, 1))
    out = levels[-1]
    for l in range(pyramid.num_levels - 2, -1, -1):
        target = pyramid.level_resolutions[l]
        up = upsample2x_kind_cm(out, config.PYRAMID_COLLAPSE_FILTER)
        out = levels[l] + up[:, :target, :target]
    return out.permute(1, 2, 0)


# ---------------------------------------------------------------------------
# brute-force float64 ground truth (tests only; small N)
# ---------------------------------------------------------------------------

def splat_bruteforce(pos_smooth: np.ndarray, values: np.ndarray,
                     matrix: np.ndarray, resolution: int,
                     scale: float) -> np.ndarray:
    """Continuous-ideal splatter in float64 numpy: full resolution, no
    window, the exact radial kernel, the exact per-footprint normalisation.
    O(N * footprint); tests only."""
    pos_smooth = np.asarray(pos_smooth, dtype=np.float64)
    values = np.asarray(values, dtype=np.float64)
    xyz1 = np.concatenate([pos_smooth[:, :3], np.ones((len(pos_smooth), 1))],
                          axis=1)
    clip = xyz1 @ np.asarray(matrix, dtype=np.float64).T
    cx = (clip[:, 0] + 1.0) * (resolution / 2.0) - 0.5
    cy = (1.0 - clip[:, 1]) * (resolution / 2.0) - 0.5
    z01 = clip[:, 2]
    h_px = pos_smooth[:, 3] * (resolution / (2.0 * scale))

    out = np.zeros((resolution, resolution, values.shape[1]))
    for i in range(len(pos_smooth)):
        if not (0.0 <= z01[i] <= 1.0) or h_px[i] <= 0:
            continue
        h = max(h_px[i], H_MIN)
        r = 2.0 * h
        x0 = max(int(np.floor(cx[i] - r)), 0)
        x1 = min(int(np.ceil(cx[i] + r)) + 1, resolution)
        y0 = max(int(np.floor(cy[i] - r)), 0)
        y1 = min(int(np.ceil(cy[i] + r)) + 1, resolution)
        if x0 >= x1 or y0 >= y1:
            continue
        xs = np.arange(x0, x1) - cx[i]
        ys = np.arange(y0, y1) - cy[i]
        q = np.sqrt(ys[:, None] ** 2 + xs[None, :] ** 2) / h
        kv = kernels.kernel_value(q)
        full_xs = np.arange(int(np.floor(cx[i] - r)),
                            int(np.ceil(cx[i] + r)) + 1) - cx[i]
        full_ys = np.arange(int(np.floor(cy[i] - r)),
                            int(np.ceil(cy[i] + r)) + 1) - cy[i]
        qf = np.sqrt(full_ys[:, None] ** 2 + full_xs[None, :] ** 2) / h
        denom = kernels.kernel_value(qf).sum()
        if denom <= 0:
            continue
        h_world = h / (resolution / (2.0 * scale))
        w = kv * (h * h / denom) / h_world ** 2
        out[y0:y1, x0:x1] += w[:, :, None] * values[i][None, None, :]
    return out
