"""Occlusion (z-buffered) splatting: the scatter-max ground truth.

Counterpart of ``topsy_tpu/ops/zsplat.py``: particles above a density cut
rasterize hemispheres and a greater-compare depth test keeps the front-most
fragment, giving (quantity value, surface depth) per pixel with depth =
clip_z + hemisphere_kernel * h_clip / 2.  The winner is found with a
two-pass windowed scatter-max (``scatter_reduce_(..., 'amax')``: the max
depth, then the matching fragment's value), over particle chunks so that
the (chunk, WINDOW, WINDOW) fragments fit in memory.  Pyramid levels are
combined by max-compositing (``_collapse_max``).
"""

from __future__ import annotations

import numpy as np
import torch

from .splat import (H_MIN, H_TRUNC, WINDOW, PyramidSpec, assign_levels,
                    default_pyramid, project)

HEMI_SUPPORT = 2.0


def hemisphere_kernel(q: torch.Tensor) -> torch.Tensor:
    """sqrt(4 - q^2) inside the support, negative outside (discarded)."""
    return torch.where(q < HEMI_SUPPORT,
                       torch.sqrt(torch.clamp(4.0 - q * q, min=0.0)), -0.01)


def zsplat_scatter(pos_smooth, values, matrix, resolution, scale,
                   density_cut=0.0, extra_mask=None,
                   pyramid: PyramidSpec | None = None, level_override=None,
                   chunk: int = 1 << 17):
    """(N,4) x (N,2 [mass, quantity]) -> (res, res, 2) [value, depth];
    depth 0 = empty.  ``level_override`` substitutes per-splat pyramid
    levels (the bucket-derived levels of the atlas path); ``chunk`` bounds
    the particles per scatter step and does not change the result."""
    if pyramid is None:
        pyramid = default_pyramid(resolution)
    dev = pos_smooth.device
    cx, cy, z01, h_px, visible = project(pos_smooth, matrix, resolution, scale)
    lev, h_eff, _tiny = assign_levels(h_px, pyramid.num_levels,
                                      lev=level_override)
    lev_scale = torch.exp2(lev.to(torch.float32))
    cx_l = (cx + 0.5) / lev_scale - 0.5
    cy_l = (cy + 0.5) / lev_scale - 0.5

    mass = values[:, 0]
    qty = values[:, 1]
    h_world = pos_smooth[:, 3]
    rho = mass / torch.clamp(h_world, min=1e-30) ** 3
    ok = visible & (rho > density_cut)
    if extra_mask is not None:
        ok = ok & extra_mask
    h_clip_half = h_world / scale * 0.5

    pad = pyramid.pad
    lev_l = lev.long()
    res_l = torch.as_tensor(pyramid.level_resolutions, device=dev)[lev_l]
    sizes = torch.as_tensor(pyramid.padded_sizes, device=dev)[lev_l]
    flat_offs = torch.as_tensor(pyramid.flat_offsets, device=dev)[lev_l]

    sx = torch.minimum(torch.clamp(
        torch.floor(cx_l).to(torch.int32) - (WINDOW // 2 - 1) + pad, min=0),
        sizes - WINDOW)
    sy = torch.minimum(torch.clamp(
        torch.floor(cy_l).to(torch.int32) - (WINDOW // 2 - 1) + pad, min=0),
        sizes - WINDOW)
    res_f = res_l.to(torch.float32)
    inside = ((cx_l > -pad - 8.0) & (cx_l < res_f + pad + 8.0)
              & (cy_l > -pad - 8.0) & (cy_l < res_f + pad + 8.0))
    ok = ok & inside
    inv_h = 1.0 / torch.clamp(h_eff, H_MIN, H_TRUNC)
    d = torch.arange(WINDOW, dtype=torch.float32, device=dev)
    di = torch.arange(WINDOW, dtype=torch.int64, device=dev)

    def fragments(s, e):
        dxs = (sx[s:e] - pad)[:, None] + d[None, :] - cx_l[s:e, None]
        dys = (sy[s:e] - pad)[:, None] + d[None, :] - cy_l[s:e, None]
        q = (torch.sqrt(dys[:, :, None] ** 2 + dxs[:, None, :] ** 2)
             * inv_h[s:e, None, None])
        k = hemisphere_kernel(q)
        frag_ok = (k >= 0.0) & ok[s:e, None, None]
        depth = z01[s:e, None, None] + k * h_clip_half[s:e, None, None]
        depth = torch.where(frag_ok, depth, -torch.inf)
        rows = sy[s:e, None].long() + di[None, :]
        cols = sx[s:e, None].long() + di[None, :]
        idx = (flat_offs[s:e, None, None] + rows[:, :, None]
               * sizes[s:e, None, None] + cols[:, None, :])
        return depth.reshape(-1), idx.reshape(-1)

    n = pos_smooth.shape[0]
    dbuf = torch.zeros((pyramid.flat_size,), dtype=torch.float32, device=dev)
    for s in range(0, n, chunk):
        dflat, idx = fragments(s, s + chunk)
        dbuf.scatter_reduce_(0, idx, dflat, "amax")
    # second pass: the winning fragment's quantity value
    vbuf = torch.full((pyramid.flat_size,), -torch.inf, dtype=torch.float32,
                      device=dev)
    for s in range(0, n, chunk):
        dflat, idx = fragments(s, s + chunk)
        win = (dflat == dbuf[idx]) & torch.isfinite(dflat)
        vfrag = qty[s:s + chunk, None, None].expand(
            -1, WINDOW, WINDOW).reshape(-1)
        vbuf.scatter_reduce_(0, idx, torch.where(win, vfrag, -torch.inf),
                             "amax")
    vbuf = torch.where(torch.isfinite(vbuf), vbuf, 0.0)
    dbuf = torch.clamp(dbuf, min=0.0)  # background depth 0 (cleared z-buffer)
    return _collapse_max(dbuf, vbuf, pyramid)


def _collapse_max(dbuf, vbuf, pyramid: PyramidSpec):
    from .composite import upsample2x_zmax_cm
    pad = pyramid.pad
    levels = []
    for l in range(pyramid.num_levels):
        size = pyramid.padded_sizes[l]
        off = pyramid.flat_offsets[l]
        dim = dbuf[off:off + size * size].reshape(size, size)
        vim = vbuf[off:off + size * size].reshape(size, size)
        levels.append((dim[pad:size - pad, pad:size - pad],
                       vim[pad:size - pad, pad:size - pad]))

    dout, vout = levels[-1]
    for l in range(pyramid.num_levels - 2, -1, -1):
        target = pyramid.level_resolutions[l]
        dv = upsample2x_zmax_cm(torch.stack([dout, vout]))
        dup = dv[0, :target, :target]
        vup = dv[1, :target, :target]
        dfine, vfine = levels[l]
        front = dfine >= dup
        dout = torch.where(front, dfine, dup)
        vout = torch.where(front, vfine, vup)
    return torch.stack([vout, dout], dim=-1)


def density_cut_percentiles(mass: np.ndarray, smooth: np.ndarray,
                            num_samples: int = 101) -> np.ndarray:
    """Density-percentile table for the surface density-cut slider."""
    rho = (np.asarray(mass, dtype=np.float64)
           / np.asarray(smooth, np.float64) ** 3)
    return np.quantile(rho, np.linspace(0, 1, num_samples))
