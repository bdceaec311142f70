"""Atlas-windowed z-buffered splatting: the surface mode's fast path.

Counterpart of ``zsplat_atlas`` and ``collapse_max_atlas`` in
``topsy_tpu/ops/zsplat_atlas.py``.  The plain front end projects the
presorted particles, places them in their bucket-derived pyramid level and
computes per-group support-tight window anchors, size classes and flags;
kernel K3 (``zsplat_accum``) keeps the front-most hemisphere fragment per
pixel; particles that do not fit their group's window go through the spill
tiers (tier 2: groups of G/8 over full-width windows; tier 3: one-particle
groups, or the sequential per-straggler merge when no ``t3_cap`` is given);
``collapse_max_atlas`` max-composites the pyramid into the image.

The atlas stays packed (``zsplat_accum.pack_atlas``) across the main pass
and the spill tiers; the function's edges keep the reference's contract.
The tiers always run with the ``t3_cap`` route (the reference skips them
when nothing spilled; then every gathered group here is inactive and
``dropped`` is 0, so the result is the same), which keeps the frame free of
host synchronisation.
"""

from __future__ import annotations

import torch

from .. import config
from .splat import (H_MIN, H_TRUNC, PyramidSpec, assign_levels,
                    default_pyramid, exp2_int, levels_from_buckets, project)
from .splat_accum import COL_ALIGN, SUBGROUPS
from .splat_atlas import BAND, COL_PAD, FOOT, ROW_PAD, _topk_desc_stable, \
    atlas_layout
from .zsplat import HEMI_SUPPORT
from .zsplat_accum import (FLAG_ACTIVE, FULL_CLASS, PROFILE_COLS,
                           SIZE_CLASSES, WINDOW_COLS, accumulate_max_packed,
                           pack_atlas, unpack_atlas)

GROUP = 512
#: window rows of the surface path
WINDOW_ROWS = 96
#: straggler budget of spill tier 3 without ``t3_cap``
T3_DEFAULT = 1024


def _floor_i32(x: torch.Tensor) -> torch.Tensor:
    return torch.floor(x).to(torch.int32)


def zsplat_atlas(pos_smooth, values, matrix, resolution, scale,
                 presorted_buckets, density_cut=0.0, extra_mask=None,
                 pyramid: PyramidSpec | None = None, giants="none",
                 group: int | None = None, subgroups: int | None = None,
                 spill_group_cap: int | None = None,
                 t3_cap: int | None = None):
    """(N,4) x (N,>=2 [mass, qty]) -> ((res, res, 2) [value, depth], dropped
    as a 0-dim int tensor).

    Arrays are in the presort's order with ``presorted_buckets`` (N,)
    int32; ``matrix`` is the (4, 4) host world->clip matrix; ``giants`` is
    'none' or a smoothing-bucket threshold whose over-window splats are left
    to the exact dense layer; ``group`` / ``subgroups`` / ``spill_group_cap``
    / ``t3_cap`` as the reference (``subgroups`` only pads the group count;
    ``t3_cap`` selects the one-particle-group tier 3)."""
    if pyramid is None:
        pyramid = default_pyramid(resolution)
    main, tier2, tier3, dropped, shape = deposit_calls(
        pos_smooth, values, matrix, resolution, scale, presorted_buckets,
        density_cut=density_cut, extra_mask=extra_mask, pyramid=pyramid,
        giants=giants, group=group, subgroups=subgroups,
        spill_group_cap=spill_group_cap, t3_cap=t3_cap)
    keys = pack_atlas(torch.zeros(shape, dtype=torch.float32,
                                  device=pos_smooth.device))
    accumulate_max_packed(keys, **main)
    if tier2 is not None:
        accumulate_max_packed(keys, **tier2)
    if t3_cap is not None:
        accumulate_max_packed(keys, **tier3)
    atlas = unpack_atlas(keys)
    if t3_cap is None and tier3 is not None:
        _sequential_stragglers(atlas, **tier3)
    return collapse_max_atlas(atlas, pyramid), dropped


def deposit_calls(pos_smooth, values, matrix, resolution, scale,
                  presorted_buckets, density_cut=0.0, extra_mask=None,
                  pyramid: PyramidSpec | None = None, giants="none",
                  group: int | None = None, subgroups: int | None = None,
                  spill_group_cap: int | None = None,
                  t3_cap: int | None = None, window_rows: int = WINDOW_ROWS):
    """The operands of ``zsplat_atlas``'s deposits: (main, tier2, tier3,
    dropped, atlas shape).  ``main`` and ``tier2`` are the keyword arguments
    of ``zsplat_accum.accumulate_max_packed`` for the main pass and spill
    tier 2; ``tier3`` those of tier 3's one-particle-group pass with
    ``t3_cap``, else the arguments of the sequential straggler merge;
    ``dropped`` is a 0-dim int tensor.  Without ``t3_cap``, tiers 2 and 3
    are None when nothing spilled (the reference's skip).  ``window_rows``
    sets the window height of the fit tests (the deposits keep it)."""
    if pyramid is None:
        pyramid = default_pyramid(resolution)
    dev = pos_smooth.device
    n = pos_smooth.shape[0]
    G = group if group is not None else (
        GROUP if n >= 1 << 18 else (128 if n >= 1 << 14 else 64))
    sg = SUBGROUPS if subgroups is None else subgroups
    pad_quantum = G * sg
    n_pad = max(pad_quantum,
                ((n + pad_quantum - 1) // pad_quantum) * pad_quantum)

    row_offs, atlas_rows, atlas_cols = atlas_layout(pyramid)
    res_per_level = torch.as_tensor(pyramid.level_resolutions,
                                    dtype=torch.float32, device=dev)
    row_offs_arr = torch.as_tensor(row_offs, dtype=torch.float32, device=dev)

    # ---- front end: projection, level placement, payload -------------------
    cx, cy, z01, h_px, visible = project(pos_smooth, matrix, resolution, scale)
    px_per_world = resolution / (2.0 * scale)
    lev = levels_from_buckets(presorted_buckets, px_per_world,
                              pyramid.num_levels)
    lev, h_eff, _tiny = assign_levels(h_px, pyramid.num_levels, lev=lev)
    h_eff = torch.clamp(h_eff, H_MIN, H_TRUNC)
    inv_lev_scale = exp2_int(-lev)
    cx_l = (cx + 0.5) * inv_lev_scale - 0.5
    cy_l = (cy + 0.5) * inv_lev_scale - 0.5

    mass = values[:, 0]
    qty = values[:, 1]
    h_world = pos_smooth[:, 3]
    hw = torch.clamp(h_world, min=1e-30)
    rho = mass / (hw * hw * hw)
    ok = visible & (rho > density_cut)
    if extra_mask is not None:
        ok = ok & extra_mask
    if giants != "none":
        from .splat_giant import GIANT_H
        h_l = h_px * inv_lev_scale
        ok = ok & ~((h_l > GIANT_H) & (presorted_buckets >= int(giants)))
    h_clip_half = h_world / scale * 0.5

    lev_l = lev.long()
    res_l = res_per_level[lev_l]
    margin = float(COL_PAD) - FOOT + 4.0
    cyc = torch.minimum(torch.maximum(cy_l, torch.full_like(cy_l, -margin)),
                        res_l + margin)
    cxc = torch.minimum(torch.maximum(cx_l, torch.full_like(cx_l, -margin)),
                        res_l + margin)
    ay = row_offs_arr[lev_l] + cyc
    ax = COL_PAD + cxc
    sentinel_ay = float(atlas_rows - ROW_PAD + FOOT + 2.0)
    ay = torch.where(torch.isnan(ay), sentinel_ay, ay)
    ax = torch.where(torch.isnan(ax), float(COL_PAD), ax)
    ok = ok & torch.isfinite(z01) & torch.isfinite(h_clip_half)
    inv_h = torch.where(ok, 1.0 / h_eff, -1.0)
    z01c = torch.nan_to_num(z01)
    hchc = torch.nan_to_num(h_clip_half)

    def pad_to(x, fill):
        return torch.cat([x, torch.full((n_pad - n,), fill, dtype=x.dtype,
                                        device=dev)])

    ay_s = pad_to(ay, sentinel_ay)
    ax_s = pad_to(ax, float(COL_PAD))
    ih_s = pad_to(inv_h, -1.0)
    z_s = pad_to(z01c, 0.0)
    hch_s = pad_to(hchc, 0.0)
    val_s = pad_to(qty, 0.0)

    # ---- anchors, classes, fits (support-tight) ------------------------------
    n_groups = n_pad // G
    sup_s = torch.where(ih_s > 0.0,
                        torch.clamp(HEMI_SUPPORT / torch.abs(ih_s), max=FOOT),
                        1.0)
    ay_lo = ay_s - sup_s
    ay_hi = ay_s + sup_s
    ax_lo = ax_s - sup_s
    ax_hi = ax_s + sup_s
    lo_r = ay_lo.reshape(n_groups, G).amin(dim=1)
    hi_r = ay_hi.reshape(n_groups, G).amax(dim=1)
    lo_c = ax_lo.reshape(n_groups, G).amin(dim=1)
    hi_c = ax_hi.reshape(n_groups, G).amax(dim=1)
    w0_top = ((atlas_rows - window_rows) // BAND) * BAND
    w0 = torch.clamp(_floor_i32(lo_r / BAND) * BAND, 0, w0_top).to(
        torch.int32)
    c0e = _floor_i32(lo_c)
    c0 = torch.clamp((c0e // COL_ALIGN) * COL_ALIGN, 0,
                     atlas_cols - WINDOW_COLS).to(torch.int32)
    c0e = torch.minimum(torch.maximum(c0e, c0),
                        c0 + (WINDOW_COLS - PROFILE_COLS)).to(torch.int32)

    w0_rep = w0.repeat_interleave(G).to(torch.float32)
    c0_rep = c0e.repeat_interleave(G).to(torch.float32)
    fits = ((ay_hi < w0_rep + window_rows) & (ax_hi < c0_rep + PROFILE_COLS)
            & (ax_lo >= c0_rep))
    ih_fit = torch.where(fits, ih_s, -torch.abs(ih_s))

    w0f = w0.to(torch.float32)
    c0ef = c0e.to(torch.float32)
    sizes = torch.full_like(w0, FULL_CLASS)
    for sz in range(len(SIZE_CLASSES) - 2, -1, -1):
        r_e, c_e = SIZE_CLASSES[sz]
        r_e = window_rows if r_e is None else min(r_e, window_rows)
        c_e = PROFILE_COLS if c_e is None else c_e
        fit_sz = (hi_r < w0f + r_e) & (hi_c < c0ef + c_e)
        sizes = torch.where(fit_sz, sz, sizes)
    active = (ih_fit > 0.0).reshape(n_groups, G).any(dim=1)
    flags = torch.where(active, FLAG_ACTIVE * 4 + sizes, 0).to(torch.int32)

    pay_g = torch.stack([z_s, hch_s, val_s]).reshape(3, n_groups, G) \
        .permute(1, 0, 2).contiguous()
    main = dict(ay_g=ay_s.reshape(n_groups, 1, G),
                ax_g=ax_s.reshape(n_groups, 1, G),
                ih_g=ih_fit.reshape(n_groups, 1, G), pay_g=pay_g, w0=w0,
                c0=c0, ce=c0e, flags=flags, group=G, window_rows=WINDOW_ROWS)
    shape = (2, atlas_rows, atlas_cols)

    # ---- spill tiers (max semantics) ---------------------------------------
    spilled = ~fits & (ih_s > 0.0)
    per_group_spill = spilled.reshape(n_groups, G).sum(dim=1)
    n_spill = per_group_spill.sum()
    G_SPILL = max(16, G // 8)
    k_groups = min(n_groups, (config.SPLAT_SPILL_GROUP_CAP
                              if spill_group_cap is None
                              else spill_group_cap))
    # the reference keeps its tier-2 group count a SUBGROUPS multiple; the
    # rounding decides which groups are gathered, hence ``dropped``
    k_groups = max(1, (k_groups * (G // G_SPILL)) // SUBGROUPS) \
        * SUBGROUPS * G_SPILL // G
    spill_cap = k_groups * G
    if t3_cap is None and int(n_spill) == 0:
        return main, None, None, n_spill * 0, shape

    top_idx = torch.sort(_topk_desc_stable(per_group_spill, k_groups)).values

    def gather(arr):
        return arr.reshape(n_groups, G)[top_idx].reshape(spill_cap)

    valid = gather(spilled)
    s_ay = gather(ay_s)
    s_ax = gather(ax_s)
    s_ih = torch.where(valid, torch.abs(gather(ih_s)), -1.0)
    s_z = gather(z_s)
    s_hch = gather(hch_s)
    s_val = gather(val_s)

    n_sg = spill_cap // G_SPILL
    valid2 = valid.reshape(n_sg, G_SPILL)
    ay2 = s_ay.reshape(n_sg, G_SPILL)
    ay2m = torch.where(valid2, ay2, torch.inf).amin(dim=1)
    ay2m = torch.where(torch.isfinite(ay2m), ay2m, float(ROW_PAD))
    sw0 = torch.clamp(_floor_i32((ay2m - FOOT) / BAND) * BAND, 0,
                      w0_top).to(torch.int32)
    sc0 = torch.zeros_like(sw0)

    sw0_rep = sw0.repeat_interleave(G_SPILL).to(torch.float32)
    fits2 = (s_ay + FOOT < sw0_rep + window_rows) & valid
    s_ih2 = torch.where(fits2, s_ih, -torch.abs(s_ih))
    straggler = ~fits2 & valid
    n3 = straggler.sum()

    active2 = (s_ih2 > 0.0).reshape(n_sg, G_SPILL).any(dim=1)
    sflags = torch.where(active2, FLAG_ACTIVE * 4 + FULL_CLASS, 0).to(
        torch.int32)
    spay_g = torch.stack([s_z, s_hch, s_val]).reshape(3, n_sg, G_SPILL) \
        .permute(1, 0, 2).contiguous()
    tier2 = dict(ay_g=s_ay.reshape(n_sg, 1, G_SPILL),
                 ax_g=s_ax.reshape(n_sg, 1, G_SPILL),
                 ih_g=s_ih2.reshape(n_sg, 1, G_SPILL), pay_g=spay_g, w0=sw0,
                 c0=sc0, ce=sc0, flags=sflags, group=G_SPILL,
                 window_cols=atlas_cols, window_rows=WINDOW_ROWS)

    not_gathered = n_spill - valid.sum()
    T3 = min(T3_DEFAULT if t3_cap is None else t3_cap, spill_cap)
    dropped = not_gathered + torch.clamp(n3 - T3, min=0)
    if t3_cap is None:
        idx3 = torch.nonzero(straggler).flatten()[:T3]
        tier3 = dict(t_ay=s_ay[idx3], t_ax=s_ax[idx3], t_ih=s_ih[idx3],
                     t_z=s_z[idx3], t_hch=s_hch[idx3], t_val=s_val[idx3],
                     w0_top=w0_top, window_rows=WINDOW_ROWS)
        return main, tier2, tier3, dropped, shape
    # tier 3 as one unconditional group=1 pass over the first T3 stragglers
    # in gathered order (then non-stragglers, inactive)
    ar = torch.arange(spill_cap, device=dev)
    idx3 = torch.sort(torch.where(straggler, ar, ar + spill_cap)).indices[:T3]
    valid3 = straggler[idx3]
    t_ay = s_ay[idx3]
    t_ax = s_ax[idx3]
    t_ih = torch.where(valid3, torch.abs(s_ih[idx3]), -1.0)
    tw0 = torch.clamp(_floor_i32((t_ay - FOOT) / BAND) * BAND, 0,
                      w0_top).to(torch.int32)
    ce_raw = _floor_i32(t_ax - FOOT)
    tc0 = torch.clamp((ce_raw // COL_ALIGN) * COL_ALIGN, 0,
                      atlas_cols - WINDOW_COLS).to(torch.int32)
    tce = torch.minimum(torch.maximum(ce_raw, tc0),
                        tc0 + (WINDOW_COLS - PROFILE_COLS)).to(torch.int32)
    tflags = torch.where(valid3, FLAG_ACTIVE * 4 + FULL_CLASS, 0).to(
        torch.int32)
    tpay = torch.stack([s_z[idx3], s_hch[idx3], s_val[idx3]]).t() \
        .reshape(T3, 3, 1).contiguous()
    tier3 = dict(ay_g=t_ay.reshape(T3, 1, 1), ax_g=t_ax.reshape(T3, 1, 1),
                 ih_g=t_ih.reshape(T3, 1, 1), pay_g=tpay, w0=tw0, c0=tc0,
                 ce=tce, flags=tflags, group=1, window_rows=WINDOW_ROWS)
    return main, tier2, tier3, dropped, shape


def _sequential_stragglers(atlas, *, t_ay, t_ax, t_ih, t_z, t_hch, t_val,
                           w0_top: int, window_rows: int):
    """The reference's tier 3 without ``t3_cap``: one straggler at a time,
    in order, over a (window_rows, WINDOW_COLS) window at its own anchor,
    replacing depth and value where its depth is strictly in front (no value
    tie rule).  Runs on the (2, R, C) atlas in place."""
    dev = atlas.device
    atlas_cols = atlas.shape[2]
    tw0 = torch.clamp(_floor_i32((t_ay - FOOT) / BAND) * BAND, 0, w0_top)
    tc0 = torch.clamp(_floor_i32(t_ax - FOOT), 0, atlas_cols - WINDOW_COLS)
    rows_w = torch.arange(window_rows, dtype=torch.float32, device=dev)
    cols_w = torch.arange(WINDOW_COLS, dtype=torch.float32, device=dev)
    for i in range(t_ay.shape[0]):
        w0p, c0p = int(tw0[i]), int(tc0[i])
        dy = (w0p + rows_w) - t_ay[i]
        dx = (c0p + cols_w) - t_ax[i]
        t = 4.0 - (dy[:, None] ** 2 + dx[None, :] ** 2) * t_ih[i] ** 2
        k = torch.sqrt(torch.clamp(t, min=0.0))
        inside = (((dy > -FOOT) & (dy <= FOOT))[:, None]
                  & ((dx > -FOOT) & (dx <= FOOT))[None, :])
        dep = torch.where((t > 0.0) & inside, t_z[i] + k * t_hch[i],
                          -torch.inf)
        cur = atlas[:, w0p:w0p + window_rows, c0p:c0p + WINDOW_COLS]
        front = dep > cur[0]
        cur[0] = torch.where(front, dep, cur[0])
        cur[1] = torch.where(front, t_val[i], cur[1])


def collapse_max_atlas(atlas: torch.Tensor, pyramid: PyramidSpec):
    """Max-composite the (2=[depth, value], rows, cols) atlas pyramid into a
    (res, res, 2) [value, depth] image: coarse levels are upsampled with
    coverage-normalized bilinear filtering (``upsample2x_zmax_cm``) and lose
    against finer content only where the finer fragment is in front."""
    from .composite import upsample2x_zmax_cm
    row_offs, _, _ = atlas_layout(pyramid)
    levels = []
    for l, res_l in enumerate(pyramid.level_resolutions):
        r0 = row_offs[l]
        levels.append(atlas[:, r0:r0 + res_l, COL_PAD:COL_PAD + res_l])
    out = levels[-1]
    for l in range(pyramid.num_levels - 2, -1, -1):
        target = pyramid.level_resolutions[l]
        up = upsample2x_zmax_cm(out)[:, :target, :target]
        fine = levels[l]
        front = fine[0] >= up[0]
        out = torch.where(front[None], fine, up)
    depth = torch.clamp(out[0], min=0.0)
    value = torch.where(out[0] > 0.0, out[1], 0.0)
    return torch.stack([value, depth], dim=-1)

