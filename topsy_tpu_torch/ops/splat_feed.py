"""The fused presorted front end ("feed"): kernel K1 and its plain version.

Counterpart of ``topsy_tpu/ops/splat_feed.py``.  One pass over the
transposed presorted layout (per-field (n_groups, GROUP) matrices) computes
projection, level math, deposit coefficients, the per-group window anchors
(row reductions over the group), fit masks, size classes and dispatch
flags, emitting exactly the operands ``splat_accum.accumulate_groups``
takes.  ``splat_feed`` launches the CUDA kernel (``csrc/splat_feed.cu``)
for CUDA tensors and runs ``splat_feed_plain`` (a statement-by-statement
mirror of the reference's ``_feed_kernel_body``) for CPU tensors.

Wrapper note (``splat_feed_cuda``): replaces
``topsy_tpu/ops/splat_feed.py::splat_feed_pallas``; on the H100 the kernel
is bound by device-memory bytes (4 + C_in (+ mask) f32 reads and 3 + 2C
f32 writes per slot), and its design (in the source) is about bytes in
flight.  The wrapper keeps its host time small: the call's scalars are
rounded to float32 once per (layout, view, piece) into one ``ctypes``
structure, which the C entry point passes to the kernel by value; the
outputs are views of two ``torch.empty`` buffers; one ``ctypes`` call
launches.  A group may hold any number G <= ``KERNEL_MAX_G`` of lanes, as
the reference's blocks ``(b_g, group)`` do.

``params_f`` (16,) float32 and ``sp_i`` (4,) int32 are host (numpy) arrays:
``[m00..m23, px_per_world, 1/px_per_world, 0, 0]`` and ``[g0, start, count,
bucket_threshold]``.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..performance import counters, traced
from . import kernels
from .splat import H_MAX, H_MIN, H_TRUNC, _norm_poly
from .splat_accum import (COL_ALIGN, FLAG_ALL_TINY, FLAG_INACTIVE,
                          FLAG_MASKED, FLAG_MIXED, FLAG_POLY, FULL_CLASS,
                          PROFILE_COLS, SIZE_CLASSES, WINDOW_COLS)

F32_MAX = float(np.finfo(np.float32).max)


def _f32(v) -> float:
    """The float32 value of a python/numpy scalar, as a python float."""
    return float(np.float32(v))


def _to_i32(v: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 as XLA and the card convert: toward zero,
    saturating, NaN to 0 (a CPU ``.to(torch.int32)`` gives INT_MIN for
    NaN).  A group whose smoothing lengths hold a NaN has NaN extents."""
    i32 = torch.iinfo(torch.int32)
    # 2147483520 is the largest float32 below 2^31
    out = torch.where(v == v, v, 0.0).clamp(float(i32.min), 2147483520.0)
    return torch.where(v >= 2.0**31, i32.max, out.to(torch.int32))


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
            _to_i32(w0f).reshape(-1), _to_i32(c0f).reshape(-1),
            _to_i32(cef).reshape(-1), flags.reshape(-1), nspill.reshape(-1))


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------

#: the widest group (lanes) the kernel takes (MAX_G in csrc/splat_feed.cu)
KERNEL_MAX_G = 1024


class _Scalars(ctypes.Structure):
    """The kernel's by-value parameters (``FeedScalars`` in
    ``csrc/splat_feed.cu``, field for field)."""
    _fields_ = [("start", ctypes.c_longlong), ("count", ctypes.c_longlong),
                ("v_cstride", ctypes.c_longlong),
                ("m", ctypes.c_float * 12),
                *[(n, ctypes.c_float) for n in (
                    "ppw", "inv_ppw", "res_half", "norm_centre",
                    "inv_halfwidth", "sentinel_ay", "col_pad", "foot",
                    "giant_h", "margin", "inv_band", "band", "w0_top",
                    "c0_top", "big_th", "h_min", "h_trunc", "bucket_thresh",
                    "support", "window_rows", "profile_cols",
                    "inv_col_align", "col_align", "ce_span")],
                ("sz_r", ctypes.c_float * 3), ("sz_c", ctypes.c_float * 3),
                ("norm", ctypes.c_float * 13),
                *[(n, ctypes.c_int) for n in (
                    "g0", "piece_groups", "G", "c_in", "depth", "ranged",
                    "has_mask")]]


@functools.lru_cache(maxsize=None)
def _bind():
    """The kernel's C entry point, bound once."""
    from . import cuda_build
    lib = cuda_build.library("splat_feed")
    size = lib.topsy_splat_feed_scalars_size()
    if size != ctypes.sizeof(_Scalars):
        raise RuntimeError(f"csrc/splat_feed.cu's FeedScalars has {size} "
                           f"bytes, its ctypes mirror {ctypes.sizeof(_Scalars)}")
    fn = lib.topsy_splat_feed
    P = ctypes.c_void_p
    fn.argtypes = [P] * 11
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=256)
def _scalars(params_b: bytes, sp_b: bytes, n_groups: int, G: int, C_in: int,
             depth_channel: bool, resolution: int, atlas_rows: int,
             atlas_cols: int, window_rows: int, band: int, col_pad: float,
             foot: float, piece_groups: int, ranged: bool, has_mask: bool,
             sentinel_ay: float, norm_mode: str):
    """The call's parameter struct, every scalar in float32 as
    ``splat_feed_plain`` rounds it; made once per (layout, view, piece)."""
    params_f = np.frombuffer(params_b, np.float32)
    g0, start, count, bucket = (int(v) for v in np.frombuffer(sp_b, np.int32))
    if not 0 <= g0 <= n_groups - piece_groups:
        raise ValueError(f"piece [{g0}, {g0 + piece_groups}) outside "
                         f"{n_groups} groups")
    if not 1 <= G <= KERNEL_MAX_G:
        raise ValueError(f"group width {G} outside [1, {KERNEL_MAX_G}]")
    if not 1 <= C_in <= 3:
        raise ValueError(f"the feed kernel takes 1 to 3 value rows, got "
                         f"{C_in}")
    coeffs, norm_centre, norm_halfwidth = _norm_poly(norm_mode)
    if len(coeffs) != 13:
        raise ValueError(f"norm polynomial of {len(coeffs)} terms, the "
                         "kernel takes 13")
    s = _Scalars()
    s.start, s.count, s.v_cstride = start, count, n_groups * G
    s.m[:] = [_f32(params_f[k]) for k in range(12)]
    s.ppw, s.inv_ppw = _f32(params_f[12]), _f32(params_f[13])
    s.res_half = _f32(resolution * 0.5)
    s.norm_centre = _f32(norm_centre)
    s.inv_halfwidth = _f32(1.0 / norm_halfwidth)
    s.sentinel_ay, s.col_pad, s.foot = (_f32(sentinel_ay), _f32(col_pad),
                                        _f32(foot))
    s.giant_h = _f32(foot / kernels.KERNEL_SUPPORT)
    s.margin = _f32(col_pad - foot + 4.0)
    s.inv_band, s.band = _f32(1.0 / band), _f32(band)
    s.w0_top = _f32(((atlas_rows - window_rows) // band) * band)
    s.c0_top = _f32(atlas_cols - WINDOW_COLS)
    s.big_th = _f32((1.0 / H_MAX) * (1.0 - 1e-6))
    s.h_min, s.h_trunc = _f32(H_MIN), _f32(H_TRUNC)
    s.bucket_thresh = _f32(np.float32(bucket))
    s.support = _f32(kernels.KERNEL_SUPPORT)
    s.window_rows, s.profile_cols = _f32(window_rows), _f32(PROFILE_COLS)
    s.inv_col_align, s.col_align = _f32(1.0 / COL_ALIGN), _f32(COL_ALIGN)
    s.ce_span = _f32(WINDOW_COLS - PROFILE_COLS)
    for sz in range(3):
        r_e, c_e = SIZE_CLASSES[sz]
        s.sz_r[sz] = _f32(min(r_e, window_rows))
        s.sz_c[sz] = _f32(c_e)
    s.norm[:] = [_f32(c) for c in coeffs]
    s.g0, s.piece_groups, s.G = g0, piece_groups, G
    s.c_in, s.depth = C_in, int(depth_channel)
    s.ranged, s.has_mask = int(ranged), int(has_mask)
    return s


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


def splat_feed_cuda(fields, values, pergroup, params_f, sp_i, mask=None, *,
                    C_in: int, depth_channel: bool, resolution: int,
                    atlas_rows: int, atlas_cols: int, window_rows: int,
                    band: int, col_pad: float, foot: float,
                    piece_groups: int, ranged: bool, has_mask: bool,
                    sentinel_ay: float, norm_mode: str = "lowrank"):
    """Launch kernel K1 (``csrc/splat_feed.cu``) on the current stream (same
    contract as ``splat_feed_plain``).  The outputs are views of two
    buffers: the f32 planes of one (3 + 2C, pg, G), the int32 vectors of
    one (5, pg)."""
    x, y, z, h = fields
    if not x.is_cuda:
        raise ValueError("splat_feed_cuda needs CUDA tensors")
    n_groups, G = shape = x.shape
    dev, index = x.device, x.get_device()
    if isinstance(values, (list, tuple)):
        values = torch.stack(list(values))
    checked = [(x, "x", shape), (y, "y", shape), (z, "z", shape),
               (h, "h", shape), (values, "values", (C_in, n_groups, G)),
               (pergroup, "pergroup", (n_groups, 8))]
    if has_mask:
        checked.append((mask, "mask", shape))
    for t, name, want in checked:
        if (t.dtype is not torch.float32 or t.shape != want
                or not t.is_contiguous() or t.get_device() != index):
            _check(t, name, want, dev)
    scal = _scalars(np.asarray(params_f, np.float32).tobytes(),
                    np.asarray(sp_i, np.int32).tobytes(), n_groups, G, C_in,
                    bool(depth_channel), resolution, atlas_rows, atlas_cols,
                    window_rows, band, col_pad, foot, piece_groups,
                    bool(ranged), bool(has_mask), sentinel_ay, norm_mode)
    C = C_in + (1 if depth_channel else 0)
    pg = piece_groups
    out = torch.empty((3 + 2 * C, pg, G), dtype=torch.float32, device=dev)
    out_i = torch.empty((5, pg), dtype=torch.int32, device=dev)
    if pg:
        err = _bind()(
            ctypes.byref(scal), x.data_ptr(), y.data_ptr(), z.data_ptr(),
            h.data_ptr(), values.data_ptr(),
            mask.data_ptr() if has_mask else None, pergroup.data_ptr(),
            out.data_ptr(), out_i.data_ptr(),
            torch._C._cuda_getCurrentRawStream(index))
        if err != 0:
            raise RuntimeError(f"splat_feed kernel launch failed: cudaError "
                               f"{err}")
        counters["k1_launches"] += 1
    ay, ax, ih = out[:3].unbind(0)
    w0, c0, ce, flags, nspill = out_i.unbind(0)
    return ay, ax, ih, out[3:3 + C], out[3 + C:], w0, c0, ce, flags, nspill


@traced("topsy.k1")
def splat_feed(fields, values, pergroup, params_f, sp_i, mask=None, **kw):
    """The front end: kernel K1 for CUDA tensors, the plain version for CPU
    tensors."""
    if fields[0].is_cuda:
        return splat_feed_cuda(fields, values, pergroup, params_f, sp_i,
                               mask, **kw)
    if fields[0].device.type != "cpu":
        raise ValueError(f"splat_feed: unsupported device {fields[0].device}")
    return splat_feed_plain(fields, values, pergroup, params_f, sp_i, mask,
                            **kw)
