"""The plain reference the benchmark holds the program's frames against.

Plain PyTorch and NumPy.  It imports nothing of the program: what the
program derives from the snapshot (levels, the giant plan, the density
cut, the colormap's range) is worked out again here from the snapshot
itself.  Each routine is a frozen copy of a plain routine of the port,
named beside it, with the port's presort, tiles and kernels left out:

* ``snapshot``: ``loaders.test_data_device`` (the seeded Gaussian-mixture
  snapshot on the device);
* ``clip_matrix``: ``camera.world_to_clip_matrix``;
* ``additive``: ``ops/splat.splat_scatter`` (projection, pyramid levels,
  the exact radial kernel in a 16-pixel window, the discrete mass
  normalisation, the spline pyramid collapse), with the giant splats of
  ``ops/splat_giant.giant_plan``'s bucket rule deposited over the whole
  framebuffer with the exact radial kernel;
* ``surface``: ``ops/zsplat.zsplat_scatter`` (front-most hemisphere
  fragments, the coverage-normalised collapse) with the giants of the same
  rule as full-support hemispheres (``splat_giant.zsplat_giant_image``);
* ``autorange`` / ``univariate_rgba``: ``color/maps.Colormap`` with
  ``ops/stats.percentiles``; ``surface_rgba``: ``color/surface`` with
  ``ops/smooth``; ``present``: ``Visualizer._compose_presentation`` with no
  overlay.

Every float routine takes ``dtype``: the benchmark's control runs the same
code in bfloat16.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch
import torch.nn.functional as F

# -- constants (frozen from topsy_tpu_torch/config.py and ops/) --------------
WINDOW = 16
H_MAX = 3.5
H_MIN = 0.71
H_TRUNC = 16.0
PYRAMID_LEVELS = 7
KERNEL_SUPPORT = 2.0
HEMI_SUPPORT = 2.0
DELTA_OCTAVE = 0.125
FOOT = 8.0
GIANT_H = FOOT / KERNEL_SUPPORT
GIANT_CAP = 8192
AUTORANGE_PERCENTILES = (1.0, 99.9)
HIST_BINS = 4096
MAX_SURFACE_SMOOTH_PIXELS = 100
DENSITY_CUT_SAMPLES = 101

GMM_WEIGHTS = (0.5, 0.4, 0.1)
GMM_MEANS = ((0.0, 0.0, 0.0), (0.0, 0.0, 0.0), (6.0, 10.0, 0.0))
GMM_STD = ((20.0, 20.0, 20.0), (4.0, 0.2, 4.0), (2.0, 2.0, 3.0))

LUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "luts")


# -- the snapshot -------------------------------------------------------------

def snapshot(n: int, seed: int, device, mass: float = 1e-8):
    """(pos_smooth (n, 4), mass (n,), quantity (n,)) float32 on ``device``:
    the three-component Gaussian mixture in contiguous component blocks,
    the analytic-density smoothing ``2 / den^0.333333`` and the
    test-quantity, drawn from a torch generator seeded with ``seed``."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    z = torch.randn((n, 3), generator=gen, device=dev)
    means = torch.tensor(GMM_MEANS, dtype=torch.float32, device=dev)
    stds = torch.tensor(GMM_STD, dtype=torch.float32, device=dev)
    n0, n1 = int(n * GMM_WEIGHTS[0]), int(n * GMM_WEIGHTS[1])
    comp = torch.full((n,), 2, dtype=torch.int64, device=dev)
    comp[:n0] = 0
    comp[n0:n0 + n1] = 1
    pos = z * stds[comp] + means[comp]
    den = torch.zeros(n, dtype=torch.float32, device=dev)
    for w, mean, std in zip(GMM_WEIGHTS, GMM_MEANS, GMM_STD):
        norm = float((2 * np.pi) ** 1.5
                     * np.prod(np.float32(std).astype(np.float64)))
        m = torch.tensor(mean, dtype=torch.float32, device=dev)
        s2 = torch.tensor(std, dtype=torch.float32, device=dev) ** 2
        den = den + w * torch.exp(-torch.sum((pos - m) ** 2 / s2, dim=1)) / norm
    smooth = 2.0 / (den * n) ** 0.333333
    masses = torch.full((n,), mass, dtype=torch.float32, device=dev)
    qty = (torch.sin(pos[:, 0]) * torch.cos(pos[:, 1]) * torch.cos(pos[:, 2])
           * 1e-4)
    return torch.cat([pos, smooth[:, None]], dim=1), masses, qty


# -- the camera ---------------------------------------------------------------

def clip_matrix(rotation, offset, scale) -> np.ndarray:
    """World to clip space: clip = C @ (R / s) @ T @ [x, y, z, 1]."""
    model = np.eye(4)
    model[:3, 3] = np.asarray(offset, dtype=np.float64)
    squash = np.array([[1.0, 0, 0, 0], [0, 1.0, 0, 0], [0, 0, 0.5, 0.5],
                       [0, 0, 0, 1.0]])
    rs = np.zeros((4, 4))
    rs[:3, :3] = np.asarray(rotation, dtype=np.float64) / scale
    rs[3, 3] = 1.0
    return (squash @ rs @ model).astype(np.float32)


# -- kernel tables (host numpy) -----------------------------------------------

def _spline_m4(q):
    q = np.asarray(q, dtype=np.float64)
    inner = (1.0 - 1.5 * q ** 2 + 0.75 * q ** 3) / np.pi
    outer = 0.25 * (2.0 - q) ** 3 / np.pi
    return np.where(q < 1.0, inner, np.where(q < 2.0, outer, 0.0))


@functools.lru_cache(maxsize=None)
def radial_table(n_samples: int = 2048):
    """The projected M4 kernel k2(q) on q in [0, 2], its 2-D integral 1."""
    q = np.linspace(0.0, KERNEL_SUPPORT, n_samples)
    t = np.linspace(0.0, 1.0, 4096)[None, :]
    zmax = np.sqrt(np.maximum(KERNEL_SUPPORT ** 2 - q[:, None] ** 2, 0.0))
    z = zmax * t
    k2 = 2.0 * np.trapezoid(_spline_m4(np.sqrt(q[:, None] ** 2 + z ** 2)), z,
                            axis=1)
    k2 /= 2.0 * np.pi * np.trapezoid(k2 * q, q)
    return q, k2


def _kernel_value_np(q):
    qs, ks = radial_table()
    return np.interp(np.asarray(q, dtype=np.float64), qs, ks, right=0.0)


@functools.lru_cache(maxsize=None)
def _norm_poly(degree: int = 12):
    """c(h) = h^2 / (mean over sub-pixel phases of the window's kernel sum),
    fitted by a Chebyshev polynomial in normalised h (power basis, highest
    first; centre; half-width)."""
    hs = np.geomspace(0.4, 16.0, 96)
    phases = (np.arange(8) + 0.5) / 8
    sums = np.zeros(hs.size)
    for fy in phases:
        for fx in phases:
            dy = np.floor(fy) - WINDOW // 2 + 1 + np.arange(WINDOW) - fy
            dx = np.floor(fx) - WINDOW // 2 + 1 + np.arange(WINDOW) - fx
            for i, h in enumerate(hs):
                q = np.sqrt((dy / h)[:, None] ** 2 + (dx / h)[None, :] ** 2)
                sums[i] += _kernel_value_np(q).sum()
    sums /= 64.0
    cs = (hs ** 2 / np.maximum(sums, 1e-30)).astype(np.float32)
    hs = hs.astype(np.float32)
    lo, hi = float(hs[0]), float(hs[-1])
    centre, half = (hi + lo) / 2.0, (hi - lo) / 2.0
    t = (hs - centre) / half
    cheb = np.polynomial.chebyshev.Chebyshev.fit(t, cs, degree, domain=[-1, 1])
    coeffs = np.polynomial.chebyshev.cheb2poly(cheb.coef)[::-1]
    return coeffs.astype(np.float64), centre, half


def _norm_factor(h_eff):
    coeffs, centre, half = _norm_poly()
    x = (torch.clamp(h_eff, 0.4, H_TRUNC) - centre) / half
    acc = torch.full_like(x, float(coeffs[0]))
    for c in coeffs[1:]:
        acc = acc * x + float(c)
    return acc


def _kernel_radial(q, dtype):
    _, k = radial_table()
    table = torch.as_tensor(k.astype(np.float32), device=q.device).to(dtype)
    n = table.shape[0]
    x = torch.clamp(q, 0.0, KERNEL_SUPPORT) * ((n - 1) / KERNEL_SUPPORT)
    i0 = torch.clamp(x.to(torch.int32), 0, n - 2).long()
    frac = x - i0.to(dtype)
    v = table[i0] * (1.0 - frac) + table[i0 + 1] * frac
    return torch.where(q < KERNEL_SUPPORT, v, torch.zeros_like(v))


# -- pyramid ------------------------------------------------------------------

def pyramid(resolution: int):
    """(level resolutions, padded sizes, flat offsets) of the deposit
    pyramid: levels of halving resolution down to 16 pixels, padded by the
    window on each side."""
    n = min(PYRAMID_LEVELS, max(1, int(np.log2(max(resolution, 16) / 16)) + 1))
    res = [max(1, -(-resolution // (1 << l))) for l in range(n)]
    sizes = [r + 2 * WINDOW for r in res]
    offs = [0]
    for s in sizes:
        offs.append(offs[-1] + s * s)
    return res, sizes, offs


@functools.lru_cache(maxsize=None)
def _upsample_matrix_np(n: int, kind: str):
    """(n, 2n) 2x upsampling matrix, half-pixel centres, edges clamped:
    'linear' or 'spline' (the interpolating cubic spline)."""
    m = np.zeros((n, 2 * n), dtype=np.float32)
    if kind == "linear":
        k = np.arange(n)
        np.add.at(m, (k, 2 * k), 0.75)
        np.add.at(m, (np.maximum(k - 1, 0), 2 * k), 0.25)
        np.add.at(m, (k, 2 * k + 1), 0.75)
        np.add.at(m, (np.minimum(k + 1, n - 1), 2 * k + 1), 0.25)
        return m
    if n < 2:
        m[:, :] = 1.0
        return m

    def b3(t):
        t = np.abs(t)
        return np.where(t < 1.0, 2.0 / 3.0 - t ** 2 + 0.5 * t ** 3,
                        np.where(t < 2.0, (2.0 - t) ** 3 / 6.0, 0.0))

    r = np.arange(n)
    a = np.zeros((n, n))
    xc = np.arange(2 * n) / 2.0 - 0.25
    e = np.zeros((n, 2 * n))
    for k in range(-1, n + 1):
        a[:, min(max(k, 0), n - 1)] += b3(r - k)
        e[min(max(k, 0), n - 1), :] += b3(xc - k)
    m[:, :] = np.linalg.solve(a.T, e)
    return m


def _upsample_cm(x, kind: str):
    """2x upsample of (C, H, W) over its two trailing axes."""
    mh = torch.as_tensor(_upsample_matrix_np(x.shape[1], kind),
                         device=x.device).to(x.dtype)
    mw = torch.as_tensor(_upsample_matrix_np(x.shape[2], kind),
                         device=x.device).to(x.dtype)
    t = torch.einsum("chw,hH->cHw", x, mh)
    return torch.einsum("cHw,wW->cHW", t, mw)


# -- shared front end ----------------------------------------------------------

def smoothing_buckets(h):
    """The 1/8-octave bucket of each smoothing length."""
    h = torch.clamp(h.to(torch.float32), min=1e-30)
    return torch.floor(torch.log2(h) * (1.0 / DELTA_OCTAVE)).to(torch.int32)


def _levels(buckets, px_per_world: float, num_levels: int):
    """Pyramid level of each particle from its bucket's upper edge."""
    s = float(np.log2(np.float32(px_per_world / H_MAX)))
    lev = torch.ceil((buckets.to(torch.float32) + 1.0) * DELTA_OCTAVE + s)
    return torch.clamp(lev, 0, num_levels - 1).to(torch.int32)


def giant_threshold(buckets, resolution: int, scale: float, num_levels: int):
    """The smallest bucket whose particles can be giants at this zoom, or
    None when no particle is rendered as a giant (none can be, or more than
    the giant layer's cap lie at or above that bucket)."""
    hist_b, hist_n = torch.unique(buckets.to(torch.int64), return_counts=True)
    hist_b, hist_n = hist_b.cpu().numpy(), hist_n.cpu().numpy()
    ppw = resolution / (2.0 * float(scale))
    b = hist_b.astype(np.float64)
    lev = np.clip(np.ceil((b + 1.0) * DELTA_OCTAVE + np.log2(ppw / H_MAX)),
                  0, num_levels - 1)
    capable = np.exp2((b + 1.0) * DELTA_OCTAVE) * ppw * np.exp2(-lev) > GIANT_H
    if not capable.any():
        return None
    thresh = int(hist_b[capable].min())
    if int(hist_n[hist_b >= thresh].sum()) > min(GIANT_CAP, int(buckets.numel())):
        return None
    return thresh


def _project(ps, matrix, resolution: int, scale: float, dtype):
    m = torch.as_tensor(matrix, device=ps.device).to(dtype)
    p = ps.to(dtype)
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    clip_x = x * m[0, 0] + y * m[0, 1] + z * m[0, 2] + m[0, 3]
    clip_y = x * m[1, 0] + y * m[1, 1] + z * m[1, 2] + m[1, 3]
    z01 = x * m[2, 0] + y * m[2, 1] + z * m[2, 2] + m[2, 3]
    cx = (clip_x + 1.0) * (resolution / 2.0) - 0.5
    cy = (1.0 - clip_y) * (resolution / 2.0) - 0.5
    h_px = p[:, 3] * (resolution / (2.0 * scale))
    visible = (z01 >= 0.0) & (z01 <= 1.0) & (h_px > 0.0) & torch.isfinite(h_px)
    return cx, cy, z01, h_px, visible


def _front_end(ps, matrix, resolution, scale, dtype):
    """Projection, levels, the level-pixel smoothing and the giant mask."""
    res_l, sizes, offs = pyramid(resolution)
    nl = len(res_l)
    cx, cy, z01, h_px, visible = _project(ps, matrix, resolution, scale, dtype)
    buckets = smoothing_buckets(ps[:, 3])
    lev = _levels(buckets, resolution / (2.0 * float(scale)), nl)
    lev_scale = torch.exp2(lev.to(torch.float32)).to(dtype)
    h_l = h_px / lev_scale
    tiny = h_l < H_MIN
    thresh = giant_threshold(buckets, resolution, scale, nl)
    giant = torch.zeros_like(visible) if thresh is None else \
        (~tiny) & (h_l > GIANT_H) & (buckets >= thresh)
    return dict(cx=cx, cy=cy, z01=z01, h_px=h_px, visible=visible, lev=lev,
                lev_scale=lev_scale, h_l=h_l, tiny=tiny, giant=giant,
                res_l=res_l, sizes=sizes, offs=offs)


def _windows(fe, cx_l, cy_l):
    """Per particle: the window's origin (sx, sy) in its padded level and
    whether its centre lies near enough to the level to deposit."""
    dev = cx_l.device
    lev = fe["lev"].long()
    sizes = torch.as_tensor(fe["sizes"], device=dev)[lev]
    res_f = torch.as_tensor(fe["res_l"], device=dev)[lev].to(cx_l.dtype)
    sx = torch.minimum(torch.clamp(torch.floor(cx_l).to(torch.int32)
                                   - (WINDOW // 2 - 1) + WINDOW, min=0),
                       sizes - WINDOW)
    sy = torch.minimum(torch.clamp(torch.floor(cy_l).to(torch.int32)
                                   - (WINDOW // 2 - 1) + WINDOW, min=0),
                       sizes - WINDOW)
    inside = ((cx_l > -WINDOW - 8.0) & (cx_l < res_f + WINDOW + 8.0)
              & (cy_l > -WINDOW - 8.0) & (cy_l < res_f + WINDOW + 8.0))
    flat = torch.as_tensor(fe["offs"][:-1], device=dev)[lev]
    return sx, sy, inside, sizes, flat


# -- the additive image --------------------------------------------------------

def additive(ps, values, matrix, resolution: int, scale: float,
             dtype=torch.float32, chunk: int = 1 << 18):
    """(res, res, C) additive image of particles ``ps`` (n, 4) with channel
    values ``values`` (n, C): each particle's mass-normalised kernel in a
    16-pixel window of its pyramid level, the levels collapsed by the
    spline filter, giants exact over the whole framebuffer."""
    dev = ps.device
    fe = _front_end(ps, matrix, resolution, scale, dtype)
    C = values.shape[1]
    vals = values.to(dtype)
    lev_scale, tiny = fe["lev_scale"], fe["tiny"]
    cx_l = (fe["cx"] + 0.5) / lev_scale - 0.5
    cy_l = (fe["cy"] + 0.5) / lev_scale - 0.5
    ppw = resolution / (2.0 * float(scale))
    h_eff = torch.where(tiny, torch.ones_like(fe["h_l"]),
                        torch.clamp(fe["h_l"], H_MIN, H_TRUNC))
    h_eff_world = h_eff * lev_scale / ppw
    c_norm = torch.where(tiny, torch.ones_like(h_eff),
                         _norm_factor(h_eff.float()).to(dtype))
    w = c_norm / (h_eff_world * h_eff_world)
    w = torch.where(fe["visible"] & ~fe["giant"], w, torch.zeros_like(w))
    sx, sy, inside, sizes, flat = _windows(fe, cx_l, cy_l)
    coef = vals * (w * inside.to(dtype))[:, None]

    res_l, psizes, offs = fe["res_l"], fe["sizes"], fe["offs"]
    buf = torch.zeros((offs[-1], C), dtype=dtype, device=dev)
    d = torch.arange(WINDOW, dtype=dtype, device=dev)
    di = torch.arange(WINDOW, dtype=torch.int64, device=dev)
    for s in range(0, ps.shape[0], chunk):
        e = s + chunk
        dx = (sx[s:e] - WINDOW).to(dtype)[:, None] + d[None, :] - cx_l[s:e, None]
        dy = (sy[s:e] - WINDOW).to(dtype)[:, None] + d[None, :] - cy_l[s:e, None]
        q = torch.sqrt(dy[:, :, None] ** 2 + dx[:, None, :] ** 2) \
            / h_eff[s:e, None, None]
        hat_y = torch.clamp(1.0 - torch.abs(dy), min=0.0)
        hat_x = torch.clamp(1.0 - torch.abs(dx), min=0.0)
        wk = torch.where(tiny[s:e, None, None],
                         hat_y[:, :, None] * hat_x[:, None, :],
                         _kernel_radial(q, dtype))
        idx = (flat[s:e, None, None]
               + (sy[s:e, None].long() + di[None, :])[:, :, None]
               * sizes[s:e, None, None]
               + (sx[s:e, None].long() + di[None, :])[:, None, :])
        buf.index_add_(0, idx.reshape(-1),
                       (wk[..., None] * coef[s:e, None, None, :]).reshape(-1, C))
    levels = []
    for l in range(len(res_l)):
        size = psizes[l]
        im = buf[offs[l]:offs[l] + size * size].reshape(size, size, C)
        levels.append(im[WINDOW:size - WINDOW, WINDOW:size - WINDOW]
                      .permute(2, 0, 1))
    out = levels[-1]
    for l in range(len(res_l) - 2, -1, -1):
        up = _upsample_cm(out, "spline")
        out = levels[l] + up[:, :res_l[l], :res_l[l]]
    image = out.permute(1, 2, 0)
    gidx = torch.nonzero(fe["giant"] & fe["visible"]).flatten()
    if gidx.numel():
        image = image + _giant_additive(fe, vals, gidx, ppw, resolution, dtype)
    return image


def _giant_additive(fe, vals, gidx, ppw, resolution, dtype, chunk: int = 16):
    """The giants' exact radial kernels over the whole framebuffer."""
    grid = torch.arange(resolution, dtype=dtype, device=vals.device)
    out = torch.zeros((resolution, resolution, vals.shape[1]), dtype=dtype,
                      device=vals.device)
    for s in range(0, gidx.numel(), chunk):
        g = gidx[s:s + chunk]
        inv = 1.0 / fe["h_px"][g]
        ty = (grid[None, :] - fe["cy"][g, None]) * inv[:, None]
        tx = (grid[None, :] - fe["cx"][g, None]) * inv[:, None]
        q = torch.sqrt(ty[:, :, None] ** 2 + tx[:, None, :] ** 2)
        wgt = vals[g] * (ppw * inv)[:, None] ** 2
        out += torch.einsum("gyx,gc->yxc", _kernel_radial(q, dtype), wgt)
    return out


# -- the z-buffered surface -----------------------------------------------------

def density_cut(mass, smooth, percentile: float) -> float:
    """The density (mass / h^3) at ``percentile`` of the snapshot's, as the
    surface renderer's 101-entry table picks it."""
    rho = (mass.double() / smooth.double() ** 3).cpu().numpy()
    table = np.quantile(rho, np.linspace(0, 1, DENSITY_CUT_SAMPLES))
    return float(table[int(percentile / 100.0 * (DENSITY_CUT_SAMPLES - 1))])


def surface(ps, mass, qty, matrix, resolution: int, scale: float, cut: float,
            dtype=torch.float32, chunk: int = 1 << 17):
    """(res, res, 2) [quantity, depth] of the front-most hemisphere
    fragment of the particles denser than ``cut``; depth 0 is empty."""
    dev = ps.device
    fe = _front_end(ps, matrix, resolution, scale, dtype)
    lev_scale = fe["lev_scale"]
    cx_l = (fe["cx"] + 0.5) / lev_scale - 0.5
    cy_l = (fe["cy"] + 0.5) / lev_scale - 0.5
    hw = torch.clamp(ps[:, 3], min=1e-30)
    rho = mass / (hw * hw * hw)
    dense = fe["visible"] & (rho > np.float32(cut))
    h_clip_half = (ps[:, 3] / float(scale) * 0.5).to(dtype)
    sx, sy, inside, sizes, flat = _windows(fe, cx_l, cy_l)
    ok = dense & inside & ~fe["giant"]
    h_eff = torch.where(fe["tiny"], torch.ones_like(fe["h_l"]),
                        torch.clamp(fe["h_l"], H_MIN, H_TRUNC))
    inv_h = 1.0 / torch.clamp(h_eff, H_MIN, H_TRUNC)
    z01 = fe["z01"]
    q_val = qty.to(dtype)
    d = torch.arange(WINDOW, dtype=dtype, device=dev)
    di = torch.arange(WINDOW, dtype=torch.int64, device=dev)
    neg_inf = torch.tensor(-torch.inf, dtype=dtype, device=dev)

    def fragments(s, e):
        dx = (sx[s:e] - WINDOW).to(dtype)[:, None] + d[None, :] - cx_l[s:e, None]
        dy = (sy[s:e] - WINDOW).to(dtype)[:, None] + d[None, :] - cy_l[s:e, None]
        q = torch.sqrt(dy[:, :, None] ** 2 + dx[:, None, :] ** 2) \
            * inv_h[s:e, None, None]
        k = torch.where(q < HEMI_SUPPORT,
                        torch.sqrt(torch.clamp(4.0 - q * q, min=0.0)),
                        torch.full_like(q, -0.01))
        depth = z01[s:e, None, None] + k * h_clip_half[s:e, None, None]
        depth = torch.where((k >= 0.0) & ok[s:e, None, None], depth, neg_inf)
        idx = (flat[s:e, None, None]
               + (sy[s:e, None].long() + di[None, :])[:, :, None]
               * sizes[s:e, None, None]
               + (sx[s:e, None].long() + di[None, :])[:, None, :])
        return depth.reshape(-1), idx.reshape(-1)

    offs = fe["offs"]
    n = ps.shape[0]
    dbuf = torch.zeros((offs[-1],), dtype=dtype, device=dev)
    for s in range(0, n, chunk):
        dflat, idx = fragments(s, s + chunk)
        dbuf.scatter_reduce_(0, idx, dflat, "amax")
    vbuf = torch.full((offs[-1],), -torch.inf, dtype=dtype, device=dev)
    for s in range(0, n, chunk):
        dflat, idx = fragments(s, s + chunk)
        win = (dflat == dbuf[idx]) & torch.isfinite(dflat)
        vfrag = q_val[s:s + chunk, None, None].expand(-1, WINDOW,
                                                      WINDOW).reshape(-1)
        vbuf.scatter_reduce_(0, idx, torch.where(win, vfrag, neg_inf), "amax")
    vbuf = torch.where(torch.isfinite(vbuf), vbuf, torch.zeros_like(vbuf))
    dbuf = torch.clamp(dbuf, min=0.0)

    res_l, psizes = fe["res_l"], fe["sizes"]
    levels = []
    for l in range(len(res_l)):
        size = psizes[l]
        dim = dbuf[offs[l]:offs[l] + size * size].reshape(size, size)
        vim = vbuf[offs[l]:offs[l] + size * size].reshape(size, size)
        levels.append((dim[WINDOW:size - WINDOW, WINDOW:size - WINDOW],
                       vim[WINDOW:size - WINDOW, WINDOW:size - WINDOW]))
    dout, vout = levels[-1]
    for l in range(len(res_l) - 2, -1, -1):
        dv = _upsample_zmax(torch.stack([dout, vout]))
        dup, vup = dv[0, :res_l[l], :res_l[l]], dv[1, :res_l[l], :res_l[l]]
        dfine, vfine = levels[l]
        front = dfine >= dup
        dout = torch.where(front, dfine, dup)
        vout = torch.where(front, vfine, vup)
    image = torch.stack([vout, dout], dim=-1)
    gidx = torch.nonzero(fe["giant"] & dense).flatten()
    if gidx.numel():
        layer = _giant_surface(fe, q_val, h_clip_half, gidx, resolution, dtype)
        front = layer[..., 1] > image[..., 1]
        image = torch.where(front[..., None], layer, image)
    return image


def _upsample_zmax(dv):
    """Coverage-normalised 2x bilinear upsample of a (2 = [depth, value],
    H, W) z-buffer level; the value is the nearest coarse pixel's where it
    is covered."""
    depth, val = dv[0], dv[1]
    cov = (depth > 0.0).to(depth.dtype)
    up = _upsample_cm(torch.stack([depth * cov, val * cov, cov]), "linear")
    covf = up[2]
    valid = covf > 0.5
    inv = 1.0 / torch.clamp(covf, min=1e-20)
    near_v = val.repeat_interleave(2, dim=0).repeat_interleave(2, dim=1)
    near_cov = cov.repeat_interleave(2, dim=0).repeat_interleave(2, dim=1) > 0
    payload = torch.where(near_cov, near_v, up[1] * inv)
    zero = torch.zeros_like(covf)
    return torch.stack([torch.where(valid, up[0] * inv, zero),
                        torch.where(valid, payload, zero)])


def _giant_surface(fe, qty, h_clip_half, gidx, resolution, dtype,
                   chunk: int = 16):
    """The giants' full hemispheres over the framebuffer, front-most kept
    (the first giant on a depth tie)."""
    dev = qty.device
    grid = torch.arange(resolution, dtype=dtype, device=dev)
    vbuf = torch.zeros((resolution, resolution), dtype=dtype, device=dev)
    dbuf = torch.full((resolution, resolution), -torch.inf, dtype=dtype,
                      device=dev)
    for s in range(0, gidx.numel(), chunk):
        g = gidx[s:s + chunk]
        inv = 1.0 / fe["h_px"][g]
        dy2 = ((grid[None, :] - fe["cy"][g, None]) * inv[:, None]) ** 2
        dx2 = ((grid[None, :] - fe["cx"][g, None]) * inv[:, None]) ** 2
        q2 = dy2[:, :, None] + dx2[:, None, :]
        k = torch.sqrt(torch.clamp(HEMI_SUPPORT ** 2 - q2, min=0.0))
        depth = torch.where(q2 < HEMI_SUPPORT ** 2,
                            fe["z01"][g, None, None]
                            + k * h_clip_half[g, None, None],
                            torch.full_like(q2, -torch.inf))
        di, win = torch.max(depth, dim=0)
        take = di > dbuf
        vbuf = torch.where(take, qty[g][win], vbuf)
        dbuf = torch.where(take, di, dbuf)
    dbuf = torch.clamp(dbuf, min=0.0)
    vbuf = torch.where(dbuf > 0.0, vbuf, torch.zeros_like(vbuf))
    return torch.stack([vbuf, dbuf], dim=-1)


# -- colormaps and the presentation ----------------------------------------------

@functools.lru_cache(maxsize=None)
def _lut_np(name: str) -> np.ndarray:
    return np.load(os.path.join(LUT_DIR, f"{name}.npy"))


def lut(name: str, device, dtype=torch.float32):
    """(1000, 4) RGBA samples of a matplotlib colormap at
    linspace(0.001, 0.999)."""
    return torch.as_tensor(_lut_np(name), device=device).to(dtype)


def _sample_lut(values, table):
    n = table.shape[0]
    x = torch.clamp(values, 0.0, 1.0) * (n - 1)
    i0 = torch.clamp(x.to(torch.int32), 0, n - 2).long()
    frac = (x - i0.to(values.dtype))[..., None]
    return table[i0] * (1 - frac) + table[i0 + 1] * frac


def _percentiles(values, qs):
    """Percentiles of the finite entries by a 4096-bin histogram between
    their least and greatest: (percentiles, count, least, greatest)."""
    values = values.reshape(-1).to(torch.float32)
    finite = torch.isfinite(values)
    n_finite = int(finite.sum())
    safe = torch.where(finite, values, torch.zeros_like(values))
    lo = torch.where(finite, values, torch.full_like(values, torch.inf)).min()
    hi = torch.where(finite, values, torch.full_like(values, -torch.inf)).max()
    span = torch.clamp(hi - lo, min=1e-30)
    scaled = torch.nan_to_num((safe - lo) / span * HIST_BINS, nan=0.0,
                              posinf=0.0, neginf=0.0)
    idx = torch.clamp(scaled.to(torch.int32), 0, HIST_BINS - 1).long()
    hist = torch.zeros((HIST_BINS,), dtype=torch.float32, device=values.device)
    hist.index_add_(0, idx, finite.to(torch.float32))
    cdf = torch.cumsum(hist, 0) / max(n_finite, 1)
    targets = torch.tensor([q / 100.0 for q in qs], dtype=torch.float32,
                           device=values.device)
    b = torch.clamp(torch.searchsorted(cdf, targets), 0, HIST_BINS - 1)
    cdf_lo = torch.where(b > 0, cdf[torch.clamp(b - 1, min=0)],
                         torch.zeros_like(targets))
    cdf_hi = cdf[b]
    frac = torch.where(cdf_hi > cdf_lo, (targets - cdf_lo) / (cdf_hi - cdf_lo),
                       torch.full_like(targets, 0.5))
    edges = lo + (b.to(torch.float32) + frac) * (span / HIST_BINS)
    return edges.cpu().numpy(), n_finite, float(lo), float(hi)


def autorange(values) -> dict:
    """The colormap's range from the values it maps: the 1st and 99.9th
    percentiles, of log10 of them unless a value is negative."""
    values = values.reshape(-1).float()
    lin, n_lin, _, _ = _percentiles(values, AUTORANGE_PERCENTILES)
    logp, n_log, _, _ = _percentiles(torch.log10(values),
                                     AUTORANGE_PERCENTILES)
    use_log = not bool((values < 0).any())
    p, n = (logp, n_log) if use_log else (lin, n_lin)
    if n > 2:
        return {"vmin": float(p[0]), "vmax": float(p[-1]), "log": use_log}
    return {"vmin": 0.0, "vmax": 1.0, "log": use_log}


def weighted_content(raw):
    """The mass-weighted quantity of an additive (mass, mass * q) image."""
    return raw[..., 1] / raw[..., 0]


def univariate_rgba(raw, cmap: dict, table):
    """RGBA of the weighted quantity of an additive image under ``cmap``."""
    value = weighted_content(raw)
    if cmap["log"]:
        value = torch.log(value) / 2.30258509
    norm = torch.clamp((value - cmap["vmin"]) / (cmap["vmax"] - cmap["vmin"]),
                       0.0, 1.0)
    norm = torch.where(torch.isfinite(norm), norm, torch.zeros_like(norm))
    return _sample_lut(norm, table)


def bilateral(image, smoothing_scale: float, channel: int = 1):
    """Bilateral filter of one channel of (H, W, C), clamped edges: spatial
    sigma ``smoothing_scale * width`` pixels, range sigma twice the scale,
    over a square of 4 sigma + 1 pixels (at most 100)."""
    H, W = image.shape[0], image.shape[1]
    sig = max(smoothing_scale, 1e-5)
    sig_s, sig_r = sig * W, sig * 2.0
    ks = min(int(sig_s * 4) + 1, MAX_SURFACE_SMOOTH_PIXELS)
    half = ks // 2
    depth = image[..., channel]
    padded = F.pad(depth[None, None].float(), (half,) * 4,
                   mode="replicate")[0, 0].to(depth.dtype)
    inv_2ss = float(1.0 / (2.0 * np.float32(sig_s) ** 2))
    inv_2rs = float(1.0 / (2.0 * np.float32(sig_r) ** 2))
    dxs = torch.arange(-half, half + 1, device=image.device)
    wsum = torch.zeros_like(depth)
    vsum = torch.zeros_like(depth)
    for dy in range(-half, half + 1):
        band = padded[half + dy:half + dy + H]
        shifted = band.unfold(1, W, 1).permute(1, 0, 2)
        w_s = torch.exp(-(dy * dy + dxs * dxs).to(depth.dtype) * inv_2ss)
        diff = shifted - depth
        w = w_s[:, None, None] * torch.exp(-(diff * diff) * inv_2rs)
        wsum = wsum + w.sum(dim=0)
        vsum = vsum + (shifted * w).sum(dim=0)
    out = image.clone()
    out[..., channel] = vsum / wsum
    return out


SURFACE_LIGHT = (0.0, 1.0 / np.sqrt(2.0), 1.0 / np.sqrt(2.0))
SURFACE_AMBIENT = (0.0, 0.0, 0.2)


def surface_rgba(raw, cmap: dict, table, smoothing_scale: float = 0.01):
    """The lit surface: the bilateral-smoothed depth, normals from central
    differences, diffuse and ambient light on the quantity's colour."""
    sm = bilateral(raw, smoothing_scale)
    value, depth = sm[..., 0], sm[..., 1]
    H, W = depth.shape
    texel = 1.0 / W
    pad = F.pad(depth[None, None].float(), (1, 1, 1, 1),
                mode="replicate")[0, 0].to(depth.dtype)
    dX = (pad[1:-1, 2:] - pad[1:-1, :-2]) * 0.5
    dY = (pad[2:, 1:-1] - pad[:-2, 1:-1]) * 0.5
    norm = torch.sqrt(dX * dX + dY * dY + texel * texel)
    light = SURFACE_LIGHT
    n_dot_l = torch.clamp(-dX / norm * light[0] - dY / norm * light[1]
                          + texel / norm * light[2], min=0.0)
    v = torch.log(value) / 2.30258509 if cmap["log"] else value
    v = torch.clamp((v - cmap["vmin"]) / (cmap["vmax"] - cmap["vmin"]),
                    0.0, 1.0)
    v = torch.where(torch.isfinite(v), v, torch.zeros_like(v))
    material = _sample_lut(v, table)[..., :3]
    ambient = torch.tensor(SURFACE_AMBIENT, device=raw.device).to(raw.dtype)
    shade = n_dot_l[..., None] * material + ambient * material
    shade = shade * (torch.clamp(depth, 0.0, 0.5) * 2.0)[..., None]
    return torch.cat([shade, torch.ones_like(shade[..., :1])], dim=-1)


def surface_autorange(raw) -> dict:
    """The surface's material range: over the covered pixels' values."""
    return autorange(raw[..., 0].reshape(-1)[raw[..., 1].reshape(-1) > 0.0])


def present(rgba, width: int, height: int) -> np.ndarray:
    """The presented uint8 frame: the square image cropped to the window's
    aspect and resized bilinearly, alpha 1, rounded to 8 bits."""
    s = rgba.shape[0]
    aspect = width / height
    if aspect >= 1.0:
        vis = max(2, int(round(s / aspect)))
        r0 = (s - vis) // 2
        cropped = rgba[r0:r0 + vis]
    else:
        vis = max(2, int(round(s * aspect)))
        c0 = (s - vis) // 2
        cropped = rgba[:, c0:c0 + vis]
    out = F.interpolate(cropped.float().permute(2, 0, 1)[None],
                        size=(height, width), mode="bilinear",
                        align_corners=False, antialias=False)[0]
    img = out.permute(1, 2, 0).cpu().numpy().astype(np.float32)
    img[..., 3] = 1.0
    return (np.clip(img, 0.0, 1.0) * 255 + 0.5).astype(np.uint8)
