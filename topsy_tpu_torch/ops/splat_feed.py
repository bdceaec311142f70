"""The fused presorted front end ("feed"): kernel K1 and its plain version.

Counterpart of ``topsy_tpu/ops/splat_feed.py``.  One pass over the
transposed presorted layout (per-field (n_groups, GROUP) matrices) computes
projection, level math, deposit coefficients, the per-group window anchors
(row reductions over the group), fit masks, size classes and dispatch
flags, emitting exactly the operands ``splat_accum.accumulate_groups``
takes.  ``splat_feed`` launches the Triton kernel for CUDA tensors and runs
``splat_feed_plain`` (a statement-by-statement mirror of the reference's
``_feed_kernel_body``) for CPU tensors.

Wrapper note (``splat_feed`` on a CUDA tensor): replaces
``topsy_tpu/ops/splat_feed.py::splat_feed_pallas``; on the H100 it is bound
by device-memory bandwidth (4 + C_in (+ mask) f32 reads and 3 + 2C f32
writes per particle); the Triton kernel reads each group's 512-lane rows
once into registers, does the row reductions there, and writes every output
once.  Division is IEEE (``div_rn``) and FMA contraction is off, so the fit
tests and floors round exactly as the plain version does.  A group may hold
any number G of lanes, as the reference's blocks ``(b_g, group)`` do: the
program pads its lane axis to the next power of two (``tl.arange`` needs
one), masks the padded lanes out of every load and store, and gives them
neutral values in every lane reduction, so they never move an anchor or
make a group active, spilled or big.

``params_f`` (16,) float32 and ``sp_i`` (4,) int32 are host (numpy) arrays:
``[m00..m23, px_per_world, 1/px_per_world, 0, 0]`` and ``[g0, start, count,
bucket_threshold]``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import kernels
from .splat import H_MAX, H_MIN, H_TRUNC, _norm_poly
from .splat_accum import (COL_ALIGN, FLAG_ALL_TINY, FLAG_INACTIVE,
                          FLAG_MASKED, FLAG_MIXED, FLAG_POLY, FULL_CLASS,
                          PROFILE_COLS, SIZE_CLASSES, WINDOW_COLS)

F32_MAX = float(np.finfo(np.float32).max)

#: launches of the Triton kernel (incremented only where it is launched)
launches = 0

#: groups (512-lane rows) per Triton program
BLOCK_GROUPS = 2


def _f32(v) -> float:
    """The float32 value of a python/numpy scalar, as a python float."""
    return float(np.float32(v))


def splat_feed_plain(fields, values, pergroup, params_f, sp_i, mask=None, *,
                     C_in: int, depth_channel: bool, resolution: int,
                     atlas_rows: int, atlas_cols: int, window_rows: int,
                     band: int, col_pad: float, foot: float,
                     piece_groups: int, ranged: bool, has_mask: bool,
                     sentinel_ay: float, norm_mode: str = "lowrank"):
    """Plain PyTorch front end over groups [g0, g0 + piece_groups).

    Returns (ay, ax, ih, cfit (C, pg, G), cspill (C, pg, G), w0, c0, ce,
    flags, nspill) like the reference's ``splat_feed_pallas``."""
    x, y, z, h = fields
    n_groups, group = x.shape
    C = C_in + (1 if depth_channel else 0)
    g0 = int(sp_i[0])
    sl = slice(g0, g0 + piece_groups)
    x, y, z, h = x[sl], y[sl], z[sl], h[sl]
    vals = [values[c][sl] for c in range(C_in)]
    pg = pergroup[sl]
    dev = x.device
    coeffs, norm_centre, norm_halfwidth = _norm_poly(norm_mode)

    m = [_f32(params_f[k]) for k in range(12)]
    ppw = _f32(params_f[12])
    inv_ppw = _f32(params_f[13])

    res_half = resolution * 0.5
    cxw = x * m[0] + y * m[1] + z * m[2] + m[3]
    cyw = x * m[4] + y * m[5] + z * m[6] + m[7]
    z01 = x * m[8] + y * m[9] + z * m[10] + m[11]
    cx = (cxw + 1.0) * res_half - 0.5
    cy = (1.0 - cyw) * res_half - 0.5
    h_px = h * ppw
    visible = ((z01 >= 0.0) & (z01 <= 1.0) & (h_px > 0.0)
               & (h_px <= F32_MAX))
    if ranged:
        start, count = int(sp_i[1]), int(sp_i[2])
        row = torch.arange(piece_groups, device=dev,
                           dtype=torch.int32)[:, None]
        lane = torch.arange(group, device=dev, dtype=torch.int32)[None, :]
        p = (g0 + row) * group + lane
        visible = visible & (p >= start) & (p < start + count)
    if has_mask:
        visible = visible & (mask[sl] > 0.0)

    inv_lev = pg[:, 1:2]
    lev_scale = pg[:, 2:3]
    row_off = pg[:, 3:4]
    res_l = pg[:, 4:5]

    h_l = h_px * inv_lev
    tiny = h_l < H_MIN
    h_eff = torch.where(tiny, 1.0, torch.clamp(h_l, H_MIN, H_TRUNC))
    cx_l = (cx + 0.5) * inv_lev - 0.5
    cy_l = (cy + 0.5) * inv_lev - 0.5
    h_eff_world = h_eff * lev_scale * inv_ppw

    t = ((torch.clamp(h_eff, 0.4, H_TRUNC) - norm_centre)
         * (1.0 / norm_halfwidth))
    acc = torch.full_like(t, float(coeffs[0]))
    for c in coeffs[1:]:
        acc = acc * t + float(c)
    c_norm = torch.where(tiny, 1.0, acc)
    w = c_norm / (h_eff_world * h_eff_world)
    w = torch.where(visible, w, 0.0)

    bucket = pg[:, 0:1]
    giant = ((~tiny) & (h_l > foot / kernels.KERNEL_SUPPORT)
             & (bucket >= float(np.float32(sp_i[3]))))
    w = torch.where(giant, 0.0, w)

    margin = col_pad - foot + 4.0
    cyc = torch.minimum(torch.maximum(cy_l, torch.full_like(cy_l, -margin)),
                        res_l + margin)
    cxc = torch.minimum(torch.maximum(cx_l, torch.full_like(cx_l, -margin)),
                        res_l + margin)
    ay = row_off + cyc
    ax = col_pad + cxc
    ih = torch.where(tiny, -1.0, 1.0 / h_eff)
    ay = torch.where(ay == ay, ay, sentinel_ay)
    ax = torch.where(ax == ax, ax, col_pad)

    sup = torch.where(tiny, 1.0, torch.clamp(kernels.KERNEL_SUPPORT * h_eff,
                                             max=foot))
    ay_lo = ay - sup
    ay_hi = ay + sup
    ax_lo = ax - sup
    ax_hi = ax + sup
    lo_r = ay_lo.amin(dim=1, keepdim=True)
    hi_r = ay_hi.amax(dim=1, keepdim=True)
    lo_c = ax_lo.amin(dim=1, keepdim=True)
    hi_c = ax_hi.amax(dim=1, keepdim=True)

    w0_top = float(((atlas_rows - window_rows) // band) * band)
    w0f = torch.clamp(torch.floor(lo_r * (1.0 / band)) * band, 0.0, w0_top)
    ce_raw = torch.floor(lo_c)
    c0f = torch.clamp(torch.floor(ce_raw * (1.0 / COL_ALIGN)) * COL_ALIGN,
                      0.0, float(atlas_cols - WINDOW_COLS))
    cef = torch.minimum(torch.maximum(ce_raw, c0f),
                        c0f + float(WINDOW_COLS - PROFILE_COLS))

    fits = ((ay_hi < w0f + window_rows) & (ax_hi < cef + PROFILE_COLS)
            & (ax_lo >= cef))

    coefs = [vals[c] * w for c in range(C_in)]
    if depth_channel:
        coefs.append(vals[0] * z01 * w)
    cfit = [torch.where(fits, cc, 0.0) for cc in coefs]
    abssum = torch.abs(cfit[0])
    for cc in cfit[1:]:
        abssum = abssum + torch.abs(cc)
    spill_any = torch.abs(coefs[0])
    for cc in coefs[1:]:
        spill_any = spill_any + torch.abs(cc)
    spilled = (~fits) & (spill_any > 0.0)
    cspill = [torch.where(spilled, cc, 0.0) for cc in coefs]
    nspill = spilled.to(torch.int32).sum(dim=1, keepdim=True,
                                         dtype=torch.int32)

    sizes = torch.full((piece_groups, 1), FULL_CLASS, dtype=torch.int32,
                       device=dev)
    for sz in range(len(SIZE_CLASSES) - 2, -1, -1):
        r_e, c_e = SIZE_CLASSES[sz]
        r_e = window_rows if r_e is None else min(r_e, window_rows)
        c_e = PROFILE_COLS if c_e is None else c_e
        fit_sz = (hi_r < w0f + r_e) & (hi_c < cef + c_e)
        sizes = torch.where(fit_sz, sz, sizes)

    active = abssum.sum(dim=1, keepdim=True) > 0.0
    ih_max = ih.amax(dim=1, keepdim=True)
    ih_min = ih.amin(dim=1, keepdim=True)
    big_th = (1.0 / H_MAX) * (1.0 - 1e-6)
    any_big = torch.where((ih > 0.0) & (ih < big_th), 1.0, 0.0).amax(
        dim=1, keepdim=True) > 0.0
    kind = torch.where(
        ~active, FLAG_INACTIVE,
        torch.where(ih_max < 0.0, FLAG_ALL_TINY,
                    torch.where(any_big, FLAG_MASKED,
                                torch.where(ih_min < 0.0, FLAG_MIXED,
                                            FLAG_POLY)))).to(torch.int32)
    szc = torch.where((kind == FLAG_ALL_TINY) | (kind == FLAG_POLY), sizes,
                      FULL_CLASS)
    flags = (kind * 4 + szc).to(torch.int32)

    return (ay, ax, ih, torch.stack(cfit), torch.stack(cspill),
            w0f.to(torch.int32).reshape(-1), c0f.to(torch.int32).reshape(-1),
            cef.to(torch.int32).reshape(-1), flags.reshape(-1),
            nspill.reshape(-1))


# ---------------------------------------------------------------------------
# the Triton kernel
# ---------------------------------------------------------------------------

_kernel = None


def _triton_kernel():
    """Define the Triton kernel (on first use: this module imports without
    Triton)."""
    global _kernel
    if _kernel is not None:
        return _kernel
    from . import cuda_build
    cuda_build.triton_cache_dir()
    import triton
    import triton.language as tl

    @triton.jit
    def _clip(v, lo, hi):
        # NaN-propagating, as jnp.clip and torch.clamp are
        return tl.minimum(tl.maximum(v, lo, propagate_nan=tl.PropagateNan.ALL),
                          hi, propagate_nan=tl.PropagateNan.ALL)

    @triton.jit
    def feed_kernel(
            x_ptr, y_ptr, z_ptr, h_ptr, v_ptr, v_cstride, mask_ptr, pg_ptr,
            ay_ptr, ax_ptr, ih_ptr, fit_ptr, sp_ptr, out_cstride,
            w0_ptr, c0_ptr, ce_ptr, fl_ptr, ns_ptr, nc_ptr,
            m0, m1, m2, m3, m4, m5, m6, m7, m8, m9, m10, m11, ppw, inv_ppw,
            g0, start, count, bucket_thresh, piece_groups,
            res_half, norm_centre, inv_halfwidth, sentinel_ay, col_pad,
            foot, margin, w0_top, c0_top, big_th, h_min, h_trunc,
            C_IN: tl.constexpr, DEPTH: tl.constexpr, RANGED: tl.constexpr,
            HAS_MASK: tl.constexpr, G: tl.constexpr, GP2: tl.constexpr,
            BG: tl.constexpr, N_NORM: tl.constexpr, BAND: tl.constexpr,
            WINDOW_ROWS: tl.constexpr, SZ_R0: tl.constexpr,
            SZ_R1: tl.constexpr, SZ_R2: tl.constexpr):
        pid = tl.program_id(0)
        rows = pid * BG + tl.arange(0, BG)[:, None]          # piece-local
        lanes = tl.arange(0, GP2)[None, :]                   # padded to 2^k
        lane_ok = lanes < G
        rmask = rows < piece_groups
        lmask = rmask & lane_ok
        grp = g0 + rows                                      # global group
        src = grp.to(tl.int64) * G + lanes
        dst = rows.to(tl.int64) * G + lanes

        x = tl.load(x_ptr + src, mask=lmask, other=0.0)
        y = tl.load(y_ptr + src, mask=lmask, other=0.0)
        z = tl.load(z_ptr + src, mask=lmask, other=0.0)
        h = tl.load(h_ptr + src, mask=lmask, other=0.0)

        cxw = x * m0 + y * m1 + z * m2 + m3
        cyw = x * m4 + y * m5 + z * m6 + m7
        z01 = x * m8 + y * m9 + z * m10 + m11
        cx = (cxw + 1.0) * res_half - 0.5
        cy = (1.0 - cyw) * res_half - 0.5
        h_px = h * ppw
        visible = ((z01 >= 0.0) & (z01 <= 1.0) & (h_px > 0.0)
                   & (h_px <= 3.4028234663852886e38))
        if RANGED:
            p = grp * G + lanes
            visible = visible & (p >= start) & (p < start + count)
        if HAS_MASK:
            mk = tl.load(mask_ptr + src, mask=lmask, other=0.0)
            visible = visible & (mk > 0.0)

        pgb = pg_ptr + grp.to(tl.int64) * 8
        bucket = tl.load(pgb + 0, mask=rmask, other=0.0)
        inv_lev = tl.load(pgb + 1, mask=rmask, other=1.0)
        lev_scale = tl.load(pgb + 2, mask=rmask, other=1.0)
        row_off = tl.load(pgb + 3, mask=rmask, other=0.0)
        res_l = tl.load(pgb + 4, mask=rmask, other=0.0)

        h_l = h_px * inv_lev
        tiny = h_l < h_min
        h_eff = tl.where(tiny, 1.0, _clip(h_l, h_min, h_trunc))
        cx_l = (cx + 0.5) * inv_lev - 0.5
        cy_l = (cy + 0.5) * inv_lev - 0.5
        h_eff_world = h_eff * lev_scale * inv_ppw

        t = (_clip(h_eff, 0.4, h_trunc) - norm_centre) * inv_halfwidth
        acc = tl.zeros_like(t) + tl.load(nc_ptr)
        for k in tl.static_range(1, N_NORM):
            acc = acc * t + tl.load(nc_ptr + k)
        c_norm = tl.where(tiny, 1.0, acc)
        w = tl.math.div_rn(c_norm, h_eff_world * h_eff_world)
        w = tl.where(visible, w, 0.0)

        giant = (~tiny) & (h_l > foot * 0.5) & (bucket >= bucket_thresh)
        w = tl.where(giant, 0.0, w)

        cyc = _clip(cy_l, -margin, res_l + margin)
        cxc = _clip(cx_l, -margin, res_l + margin)
        ay = row_off + cyc
        ax = col_pad + cxc
        ih = tl.where(tiny, -1.0, tl.math.div_rn(tl.zeros_like(h_eff) + 1.0,
                                                 h_eff))
        ay = tl.where(ay == ay, ay, sentinel_ay)
        ax = tl.where(ax == ax, ax, col_pad)

        sup = tl.where(tiny, 1.0, tl.minimum(
            2.0 * h_eff, foot, propagate_nan=tl.PropagateNan.ALL))
        ay_lo = ay - sup
        ay_hi = ay + sup
        ax_lo = ax - sup
        ax_hi = ax + sup
        # padded lanes take the neutral value of each lane reduction
        lo_r = tl.min(tl.where(lane_ok, ay_lo, float("inf")), axis=1,
                      keep_dims=True)
        hi_r = tl.max(tl.where(lane_ok, ay_hi, -float("inf")), axis=1,
                      keep_dims=True)
        lo_c = tl.min(tl.where(lane_ok, ax_lo, float("inf")), axis=1,
                      keep_dims=True)
        hi_c = tl.max(tl.where(lane_ok, ax_hi, -float("inf")), axis=1,
                      keep_dims=True)

        w0f = _clip(tl.floor(lo_r * (1.0 / BAND)) * BAND, 0.0, w0_top)
        ce_raw = tl.floor(lo_c)
        c0f = _clip(tl.floor(ce_raw * (1.0 / 128.0)) * 128.0, 0.0, c0_top)
        cef = _clip(ce_raw, c0f, c0f + 128.0)

        fits = ((ay_hi < w0f + WINDOW_ROWS) & (ax_hi < cef + 128.0)
                & (ax_lo >= cef))

        abssum = tl.zeros_like(w)
        spill_any = tl.zeros_like(w)
        v0 = tl.load(v_ptr + src, mask=lmask, other=0.0)
        for c in tl.static_range(C_IN + DEPTH):
            if c < C_IN:
                cc = tl.load(v_ptr + c * v_cstride + src, mask=lmask,
                             other=0.0) * w
            else:
                cc = v0 * z01 * w
            cf = tl.where(fits & lane_ok, cc, 0.0)
            if c == 0:
                abssum = tl.abs(cf)
                spill_any = tl.abs(cc)
            else:
                abssum = abssum + tl.abs(cf)
                spill_any = spill_any + tl.abs(cc)
            tl.store(fit_ptr + c * out_cstride + dst, cf, mask=lmask)
        spilled = (~fits) & (spill_any > 0.0) & lane_ok
        for c in tl.static_range(C_IN + DEPTH):
            if c < C_IN:
                cc = tl.load(v_ptr + c * v_cstride + src, mask=lmask,
                             other=0.0) * w
            else:
                cc = v0 * z01 * w
            tl.store(sp_ptr + c * out_cstride + dst,
                     tl.where(spilled, cc, 0.0), mask=lmask)
        nspill = tl.sum(tl.where(spilled & rmask, 1, 0), axis=1,
                        keep_dims=True)

        sizes = tl.zeros_like(nspill) + 3
        fit2 = (hi_r < w0f + SZ_R2) & (hi_c < cef + 128.0)
        sizes = tl.where(fit2, 2, sizes)
        fit1 = (hi_r < w0f + SZ_R1) & (hi_c < cef + 64.0)
        sizes = tl.where(fit1, 1, sizes)
        fit0 = (hi_r < w0f + SZ_R0) & (hi_c < cef + 32.0)
        sizes = tl.where(fit0, 0, sizes)

        active = tl.sum(abssum, axis=1, keep_dims=True) > 0.0
        ih_max = tl.max(tl.where(lane_ok, ih, -float("inf")), axis=1,
                        keep_dims=True)
        ih_min = tl.min(tl.where(lane_ok, ih, float("inf")), axis=1,
                        keep_dims=True)
        any_big = tl.max(tl.where((ih > 0.0) & (ih < big_th) & lane_ok, 1.0,
                                  0.0), axis=1, keep_dims=True) > 0.0
        kind = tl.where(~active, 0,
                        tl.where(ih_max < 0.0, 1,
                                 tl.where(any_big, 4,
                                          tl.where(ih_min < 0.0, 3, 2))))
        szc = tl.where((kind == 1) | (kind == 2), sizes, 3)
        flags = kind * 4 + szc

        tl.store(ay_ptr + dst, ay, mask=lmask)
        tl.store(ax_ptr + dst, ax, mask=lmask)
        tl.store(ih_ptr + dst, ih, mask=lmask)
        tl.store(w0_ptr + rows, w0f.to(tl.int32), mask=rmask)
        tl.store(c0_ptr + rows, c0f.to(tl.int32), mask=rmask)
        tl.store(ce_ptr + rows, cef.to(tl.int32), mask=rmask)
        tl.store(fl_ptr + rows, flags.to(tl.int32), mask=rmask)
        tl.store(ns_ptr + rows, nspill.to(tl.int32), mask=rmask)

    _kernel = feed_kernel
    return _kernel


_norm_cache: dict = {}


def _norm_coeffs_on(norm_mode: str, device) -> torch.Tensor:
    key = (norm_mode, str(device))
    t = _norm_cache.get(key)
    if t is None:
        coeffs = _norm_poly(norm_mode)[0]
        t = torch.as_tensor(np.asarray(coeffs, np.float32), device=device)
        _norm_cache[key] = t
    return t


def _check(t: torch.Tensor, name: str, shape, device):
    if t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, got {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def splat_feed_triton(fields, values, pergroup, params_f, sp_i, mask=None, *,
                      C_in: int, depth_channel: bool, resolution: int,
                      atlas_rows: int, atlas_cols: int, window_rows: int,
                      band: int, col_pad: float, foot: float,
                      piece_groups: int, ranged: bool, has_mask: bool,
                      sentinel_ay: float, norm_mode: str = "lowrank"):
    """Launch kernel K1 on the current stream (same contract as
    ``splat_feed_plain``)."""
    global launches
    x, y, z, h = fields
    n_groups, G = x.shape
    dev = x.device
    if not x.is_cuda:
        raise ValueError("splat_feed_triton needs CUDA tensors")
    C = C_in + (1 if depth_channel else 0)
    for name, t in zip("xyzh", fields):
        _check(t, name, (n_groups, G), dev)
    if isinstance(values, (list, tuple)):
        values = torch.stack(list(values))
    _check(values, "values", (C_in, n_groups, G), dev)
    _check(pergroup, "pergroup", (n_groups, 8), dev)
    if has_mask:
        _check(mask, "mask", (n_groups, G), dev)
    g0 = int(sp_i[0])
    if not 0 <= g0 <= n_groups - piece_groups:
        raise ValueError(f"piece [{g0}, {g0 + piece_groups}) outside "
                         f"{n_groups} groups")
    if window_rows > 96 or any(r > window_rows
                               for r, _ in SIZE_CLASSES[:FULL_CLASS]):
        raise ValueError("the feed kernel takes 48 <= window_rows <= 96, "
                         f"got {window_rows}")

    pg = piece_groups
    f32, i32 = torch.float32, torch.int32
    ay = torch.empty((pg, G), dtype=f32, device=dev)
    ax = torch.empty((pg, G), dtype=f32, device=dev)
    ih = torch.empty((pg, G), dtype=f32, device=dev)
    cfit = torch.empty((C, pg, G), dtype=f32, device=dev)
    cspill = torch.empty((C, pg, G), dtype=f32, device=dev)
    w0 = torch.empty((pg,), dtype=i32, device=dev)
    c0 = torch.empty((pg,), dtype=i32, device=dev)
    ce = torch.empty((pg,), dtype=i32, device=dev)
    flags = torch.empty((pg,), dtype=i32, device=dev)
    nspill = torch.empty((pg,), dtype=i32, device=dev)
    if pg == 0:
        return ay, ax, ih, cfit, cspill, w0, c0, ce, flags, nspill

    _, norm_centre, norm_halfwidth = _norm_poly(norm_mode)
    ncoef = _norm_coeffs_on(norm_mode, dev)
    m = [_f32(params_f[k]) for k in range(12)]
    kernel = _triton_kernel()
    grid = ((pg + BLOCK_GROUPS - 1) // BLOCK_GROUPS,)
    margin = col_pad - foot + 4.0
    kernel[grid](
        x, y, z, h, values, n_groups * G, mask if has_mask else x, pergroup,
        ay, ax, ih, cfit, cspill, pg * G, w0, c0, ce, flags, nspill, ncoef,
        *m, _f32(params_f[12]), _f32(params_f[13]),
        g0, int(sp_i[1]), int(sp_i[2]), _f32(sp_i[3]), pg,
        _f32(resolution * 0.5), _f32(norm_centre),
        _f32(1.0 / norm_halfwidth), _f32(sentinel_ay), _f32(col_pad),
        _f32(foot), _f32(margin),
        _f32(((atlas_rows - window_rows) // band) * band),
        _f32(atlas_cols - WINDOW_COLS), _f32((1.0 / H_MAX) * (1.0 - 1e-6)),
        _f32(H_MIN), _f32(H_TRUNC),
        C_IN=C_in, DEPTH=int(depth_channel), RANGED=bool(ranged),
        HAS_MASK=bool(has_mask), G=G, GP2=1 << (G - 1).bit_length(),
        BG=BLOCK_GROUPS,
        N_NORM=len(ncoef), BAND=band, WINDOW_ROWS=window_rows,
        SZ_R0=min(SIZE_CLASSES[0][0], window_rows),
        SZ_R1=min(SIZE_CLASSES[1][0], window_rows),
        SZ_R2=min(SIZE_CLASSES[2][0], window_rows),
        num_warps=4, enable_fp_fusion=False)
    launches += 1
    return ay, ax, ih, cfit, cspill, w0, c0, ce, flags, nspill


def splat_feed(fields, values, pergroup, params_f, sp_i, mask=None, **kw):
    """The front end: kernel K1 for CUDA tensors, the plain version for CPU
    tensors."""
    if fields[0].is_cuda:
        return splat_feed_triton(fields, values, pergroup, params_f, sp_i,
                                 mask, **kw)
    if fields[0].device.type != "cpu":
        raise ValueError(f"splat_feed: unsupported device {fields[0].device}")
    return splat_feed_plain(fields, values, pergroup, params_f, sp_i, mask,
                            **kw)
