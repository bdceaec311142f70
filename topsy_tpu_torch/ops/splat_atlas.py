"""The splat paths over the atlas: the per-frame-sorted flat path, the
presorted feed path, the spill tiers, the pyramid collapse.

Counterpart of ``atlas_layout``, ``splat_atlas``, ``spill_pass`` (here
``spill_tiers``, which returns the two tiers' deposit operands),
``splat_atlas_fields``, ``slice_column_fields`` and ``collapse_atlas`` in
``topsy_tpu/ops/splat_atlas.py``.  Every pyramid level lives in one padded
channel-major atlas (C, atlas_rows, atlas_cols).  ``splat_atlas`` builds
each group's operands with the plain front end (``splat_coefficients``,
then a stable per-frame sort on a (row band, tiny, column) key);
``splat_atlas_fields`` builds them with the feed
kernel (``splat_feed``).  The deposit (``splat_accum``) accumulates each
group into its window, and the spill tiers re-run the deposit for particles
that did not fit: tier 2 over full-width windows in groups of G/8 (at
least 16), tier 3 as one-particle groups.  ``spill_tiers`` builds their
operands with a hand-written CUDA kernel (``csrc/spill_tiers.cu``) on CUDA
tensors and with ``spill_tiers_plain`` otherwise.  Both paths
implement the reference's ``engine="pallas"`` semantics (column anchors
aligned to ``COL_ALIGN``, a ``PROFILE_COLS`` span from the exact base,
size classes, ``group_flags``), which K2 and its plain version implement.
The
reference's ``"scan"`` engine is its CPU stand-in; here K2's plain version
plays that part, so it is not ported, and tier 3 always runs as K2's
one-particle call (the reference's small launches run it in that engine).
The reference's ``presorted_buckets`` option of ``splat_atlas`` (the
presort's flat arrays at 96-row windows, its renderer's path with the feed
kernel off, which exists there because the feed kernel runs interpreted off
the TPU) is not ported: the port's feed kernel runs on every device it
supports (CUDA C++ on the card, its plain version on the CPU).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import config
from ..performance import counters, traced
from . import splat_accum, splat_feed, splat_giant
from . import kernels
from .splat import (H_MAX, PyramidSpec, default_pyramid, exp2_int,
                    levels_from_buckets, splat_coefficients)
from .splat_accum import (COL_ALIGN, FULL_CLASS, PROFILE_COLS, SUBGROUPS,
                          group_flags)

GROUP = 512
TIER3_PALLAS_MIN_GROUPS = 16384
#: window rows of the per-frame-sorted path
WINDOW_ROWS = 64
WINDOW_COLS = 256
BAND = config.SPLAT_BAND_ROWS
COL_PAD = config.SPLAT_ATLAS_COL_PAD
ROW_PAD = config.SPLAT_ATLAS_PAD
FOOT = 8.0
#: straggler budget of spill tier 3 per launch
T3_CAP = 1024
#: window rows of the presorted feed path
PRESORTED_WINDOW_ROWS = 96
#: spill budgets of an interactive column launch (tier-2 groups, tier-3
#: stragglers), raised over a frame's: the reference's column launch
COLUMN_SPILL_GROUP_CAP = 4 * config.SPLAT_SPILL_GROUP_CAP
COLUMN_T3_CAP = 4096


def column_pad_multiple(pad_group: int, width: int) -> int:
    """The multiple a column launch over ``width`` of the layout's
    ``pad_group`` columns pads its group count to (the reference's
    ``subgroups``); the padding changes the spill budget, hence
    ``dropped``."""
    return min(64, SUBGROUPS * (pad_group // width))


def column_pieces(n_groups: int) -> list[tuple[int, int]]:
    """(first group, groups) of the group-axis pieces of a column launch,
    each at most ``config.SPLAT_COLUMNS_GROUP_CAP`` groups with its own
    spill budget."""
    cap = config.SPLAT_COLUMNS_GROUP_CAP
    return [(g0, min(cap, n_groups - g0)) for g0 in range(0, n_groups, cap)]


def atlas_layout(pyramid: PyramidSpec):
    """Row offset of each level region in the atlas, and the atlas shape.
    The width is rounded up to 128 columns as in the reference: it bounds
    the column anchors ``c0``, so it is part of the semantics."""
    row_offs = []
    r = ROW_PAD
    for res_l in pyramid.level_resolutions:
        row_offs.append(r)
        r += res_l + ROW_PAD
    width = max(pyramid.resolution + 2 * COL_PAD, 384)
    width = ((width + 127) // 128) * 128
    return tuple(row_offs), r, width


def _topk_desc_stable(values: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest values, ties to the lower index."""
    _, order = torch.sort(values, descending=True, stable=True)
    return order[:k]


def _spill_budgets(n_groups: int, G: int, group_cap, t3_cap):
    """(G_SPILL, k_groups, T3) of the spill tiers over n_groups groups of
    G: tier 2's group width and gathered groups, tier 3's budget."""
    G_SPILL = max(16, G // 8)
    cap = config.SPLAT_SPILL_GROUP_CAP if group_cap is None else group_cap
    k_groups = min(n_groups, cap)
    # the reference keeps its tier-2 group count a SUBGROUPS multiple; the
    # rounding decides which groups are gathered, hence ``dropped``
    k_groups = max(1, (k_groups * (G // G_SPILL)) // SUBGROUPS) \
        * SUBGROUPS * G_SPILL // G
    T3 = min(T3_CAP if t3_cap is None else t3_cap, k_groups * G)
    return G_SPILL, k_groups, T3


def spill_tiers_plain(ay_s, ax_s, inv_h_s, coef_s, per_group_spill, *, C,
                      G, atlas_rows, atlas_cols, window_rows, group_cap=None,
                      t3_cap=None):
    """``spill_tiers`` in plain PyTorch (the CPU's, and the oracle of the
    kernel's tests)."""
    dev = ay_s.device
    n_groups = per_group_spill.shape[0]
    G_SPILL, k_groups, T3 = _spill_budgets(n_groups, G, group_cap, t3_cap)
    spill_cap = k_groups * G
    spilled = torch.abs(coef_s).sum(dim=0) > 0.0

    top_idx = torch.sort(_topk_desc_stable(per_group_spill, k_groups)).values

    def gather(arr):
        return arr.reshape(n_groups, G)[top_idx].reshape(spill_cap)

    valid = gather(spilled)
    s_ay = gather(ay_s)
    s_ax = gather(ax_s)
    s_ih = gather(inv_h_s)
    s_coef = torch.stack([torch.where(valid, gather(cc), 0.0)
                          for cc in coef_s])                    # (C, cap)

    n_sg = spill_cap // G_SPILL
    ay2 = s_ay.reshape(n_sg, G_SPILL)
    valid2 = valid.reshape(n_sg, G_SPILL)
    ay2m = torch.where(valid2, ay2, torch.inf).amin(dim=1)
    ay2m = torch.where(torch.isfinite(ay2m), ay2m, float(ROW_PAD))
    w0_top = ((atlas_rows - window_rows) // BAND) * BAND
    sw0 = torch.clamp(torch.floor((ay2m - FOOT) / BAND).to(torch.int32)
                      * BAND, 0, w0_top).to(torch.int32)
    sc0 = torch.zeros_like(sw0)

    sw0_rep = sw0.repeat_interleave(G_SPILL).to(torch.float32)
    fits2 = (s_ay + FOOT < sw0_rep + window_rows) & valid
    s_coef_fit = torch.where(fits2, s_coef, 0.0)
    straggler = (~fits2) & valid
    n3 = straggler.sum()

    sflags = group_flags(s_ih.reshape(n_sg, G_SPILL),
                         s_coef_fit.reshape(C, n_sg, G_SPILL).permute(1, 2, 0),
                         H_MAX)
    common = dict(atlas_rows=atlas_rows, atlas_cols=atlas_cols, C=C,
                  window_rows=window_rows)
    tier2 = dict(ay_g=s_ay.reshape(n_sg, G_SPILL),
                 ax_g=s_ax.reshape(n_sg, G_SPILL),
                 ih_g=s_ih.reshape(n_sg, G_SPILL),
                 coef_g=s_coef_fit.reshape(C, n_sg, G_SPILL).contiguous(),
                 w0=sw0, c0=sc0, ce=sc0, flags=sflags, group=G_SPILL,
                 window_cols=atlas_cols, **common)

    # ---- tier 3: one-particle groups (fit by construction) ---------------
    ar = torch.arange(spill_cap, device=dev)
    # the first T3 stragglers in gathered order, then non-stragglers
    idx3 = torch.sort(torch.where(straggler, ar, ar + spill_cap)).indices[:T3]
    valid3 = straggler[idx3]
    t_ay = s_ay[idx3]
    t_ax = s_ax[idx3]
    t_ih = s_ih[idx3]
    t_coef = torch.where(valid3, s_coef[:, idx3], 0.0)          # (C, T3)
    tw0_raw = torch.floor((t_ay - FOOT) / BAND).to(torch.int32) * BAND
    tw0 = torch.clamp(tw0_raw, 0, w0_top).to(torch.int32)
    ce_raw = torch.floor(t_ax - FOOT).to(torch.int32)
    tc0 = torch.clamp((ce_raw // COL_ALIGN) * COL_ALIGN, 0,
                      atlas_cols - WINDOW_COLS).to(torch.int32)
    tce = torch.minimum(torch.maximum(ce_raw, tc0),
                        tc0 + (WINDOW_COLS - PROFILE_COLS)).to(torch.int32)
    # an anchor clipped at the atlas bottom leaves the splat centre below
    # the window start: such stragglers take the full class (class 1 would
    # truncate their deposit rows >= 32)
    t_sizes = torch.where(tw0_raw != tw0, FULL_CLASS, 1).to(torch.int32)
    tflags = group_flags(t_ih.reshape(T3, 1), t_coef.t().reshape(T3, 1, C),
                         H_MAX, sizes=t_sizes)
    tier3 = dict(ay_g=t_ay.reshape(T3, 1), ax_g=t_ax.reshape(T3, 1),
                 ih_g=t_ih.reshape(T3, 1),
                 coef_g=t_coef.reshape(C, T3, 1).contiguous(), w0=tw0,
                 c0=tc0, ce=tce, flags=tflags, group=1,
                 window_cols=WINDOW_COLS, **common)
    not_gathered = per_group_spill.sum() - valid.sum()
    return tier2, tier3, not_gathered + torch.clamp(n3 - T3, min=0)


#: the widest group ``spill_tiers_cuda`` takes (MAX_G in
#: csrc/spill_tiers.cu: its histogram of counts lives in shared memory)
SPILL_KERNEL_MAX_G = 8192
#: channels ``spill_tiers_cuda`` takes (MAX_C in csrc/spill_tiers.cu)
SPILL_KERNEL_MAX_C = 4


class _SpillScalars(ctypes.Structure):
    """The kernel's by-value parameters (``SpillScalars`` in
    ``csrc/spill_tiers.cu``, field for field)."""
    _fields_ = [*[(n, ctypes.c_longlong) for n in (
                    "n_groups", "f_t3", "i_t3", "i_gidx", "i_slots",
                    "i_order")],
                *[(n, ctypes.c_int) for n in (
                    "G", "C", "g_spill", "k_groups", "n_sg", "t3",
                    "window_rows", "w0_top", "c0_top", "band", "col_align",
                    "ce_span")],
                *[(n, ctypes.c_float) for n in ("foot", "big_th",
                                                "row_pad")]]


@functools.lru_cache(maxsize=None)
def _bind_spill():
    """The kernel's C entry point, bound once."""
    from . import cuda_build
    fn = cuda_build.library("spill_tiers").topsy_spill_tiers
    fn.argtypes = [ctypes.c_void_p] * 10
    fn.restype = ctypes.c_int
    return fn


def _quad(n: int) -> int:
    """n rounded up to 4 elements: each output block starts 16-byte
    aligned, as K2's vector loads want."""
    return -(-n // 4) * 4


@functools.lru_cache(maxsize=256)
def _spill_plan(n_groups: int, G: int, C: int, atlas_rows: int,
                atlas_cols: int, window_rows: int, G_SPILL: int,
                k_groups: int, T3: int):
    """(scalars, float outputs, int32 outputs) of a ``spill_tiers_cuda``
    call; made once per (piece shape, budgets as ``_spill_budgets``
    resolves them)."""
    spill_cap = k_groups * G
    if not 1 <= G <= SPILL_KERNEL_MAX_G:
        raise ValueError(f"group width {G} outside [1, "
                         f"{SPILL_KERNEL_MAX_G}]")
    if not 1 <= C <= SPILL_KERNEL_MAX_C:
        raise ValueError(f"the spill kernel takes 1 to "
                         f"{SPILL_KERNEL_MAX_C} channels, got {C}")
    if k_groups > n_groups or spill_cap % G_SPILL:
        raise ValueError(f"{n_groups} groups of {G}: the spill budget of "
                         f"{k_groups} groups does not fit them or tier 2's "
                         f"groups of {G_SPILL}")
    n_sg = spill_cap // G_SPILL
    s = _SpillScalars()
    s.n_groups = n_groups
    s.f_t3 = _quad((3 + C) * spill_cap)
    s.i_t3 = _quad(3 * n_sg)
    s.i_gidx = s.i_t3 + _quad(4 * T3)
    s.i_slots = s.i_gidx + _quad(k_groups)
    s.i_order = s.i_slots + _quad(-(-spill_cap // 4))
    s.G, s.C, s.g_spill, s.k_groups, s.n_sg, s.t3 = (G, C, G_SPILL, k_groups,
                                                     n_sg, T3)
    s.window_rows = window_rows
    s.w0_top = ((atlas_rows - window_rows) // BAND) * BAND
    s.c0_top = atlas_cols - WINDOW_COLS
    s.band, s.col_align = BAND, COL_ALIGN
    s.ce_span = WINDOW_COLS - PROFILE_COLS
    s.foot = FOOT
    s.big_th = float(np.float32((1.0 / H_MAX) * (1.0 - 1e-6)))
    s.row_pad = float(ROW_PAD)
    return s, s.f_t3 + (3 + C) * T3, s.i_order + T3


def spill_tiers_cuda(ay_s, ax_s, inv_h_s, coef_s, per_group_spill, *, C, G,
                     atlas_rows, atlas_cols, window_rows, group_cap=None,
                     t3_cap=None):
    """``spill_tiers`` by the kernel (``csrc/spill_tiers.cu``), launched on
    the current stream: ay_s / ax_s / inv_h_s (n_groups * G,) and coef_s
    (C, n_groups * G) contiguous float32, per_group_spill contiguous
    (n_groups,) int32 counts in [0, G].  Every output is a view of three
    new buffers (float32, int32 and the int64 dropped count)."""
    n_groups = per_group_spill.shape[0]
    n = n_groups * G
    dev = ay_s.device
    for t, name in ((ay_s, "ay_s"), (ax_s, "ax_s"), (inv_h_s, "inv_h_s")):
        splat_accum._check(t, name, torch.float32, (n,), dev)
    splat_accum._check(coef_s, "coef_s", torch.float32, (C, n), dev)
    splat_accum._check(per_group_spill, "per_group_spill", torch.int32,
                       (n_groups,), dev)
    s, n_f, n_i = _spill_plan(n_groups, G, C, atlas_rows, atlas_cols,
                              window_rows, *_spill_budgets(
                                  n_groups, G, group_cap, t3_cap))
    out_f = torch.empty(n_f, dtype=torch.float32, device=dev)
    out_i = torch.empty(n_i, dtype=torch.int32, device=dev)
    out_l = torch.empty(2, dtype=torch.int64, device=dev)
    err = _bind_spill()(
        ctypes.byref(s), ay_s.data_ptr(), ax_s.data_ptr(),
        inv_h_s.data_ptr(), coef_s.data_ptr(), per_group_spill.data_ptr(),
        out_f.data_ptr(), out_i.data_ptr(), out_l.data_ptr(),
        torch._C._cuda_getCurrentRawStream(dev.index))
    if err != 0:
        raise RuntimeError(f"spill_tiers kernel launch failed: cudaError "
                           f"{err}")
    counters["spill_launches"] += 1
    n_sg, G_SPILL, T3 = s.n_sg, s.g_spill, s.t3
    t2 = out_f[:(3 + C) * n_sg * G_SPILL].view(3 + C, n_sg, G_SPILL)
    t3 = out_f[s.f_t3:].view(3 + C, T3, 1)
    w0, zeros, flags = out_i[:3 * n_sg].view(3, n_sg).unbind(0)
    tw0, tc0, tce, tflags = out_i[s.i_t3:s.i_t3 + 4 * T3].view(
        4, T3).unbind(0)
    common = dict(atlas_rows=atlas_rows, atlas_cols=atlas_cols, C=C,
                  window_rows=window_rows)
    ay2, ax2, ih2 = t2[:3].unbind(0)
    ay3, ax3, ih3 = t3[:3].unbind(0)
    tier2 = dict(ay_g=ay2, ax_g=ax2, ih_g=ih2, coef_g=t2[3:], w0=w0,
                 c0=zeros, ce=zeros, flags=flags, group=G_SPILL,
                 window_cols=atlas_cols, **common)
    tier3 = dict(ay_g=ay3, ax_g=ax3, ih_g=ih3, coef_g=t3[3:], w0=tw0,
                 c0=tc0, ce=tce, flags=tflags, group=1,
                 window_cols=WINDOW_COLS, **common)
    return tier2, tier3, out_l[0]


@traced("topsy.spill")
def spill_tiers(ay_s, ax_s, inv_h_s, coef_s, per_group_spill, *, C, G,
                atlas_rows, atlas_cols, window_rows, group_cap=None,
                t3_cap=None):
    """The spill tiers' deposit operands (particles too sparse for their
    group's window): the kernel (``csrc/spill_tiers.cu``) for CUDA
    tensors, ``spill_tiers_plain`` otherwise.

    ay_s/ax_s/inv_h_s: (n_pad,); coef_s: (C, n_pad) channel-major, zero
    where a particle did not spill (a particle spilled where the sum of its
    coefficients' absolute values is positive); per_group_spill:
    (n_groups,) int32 spill counts.  Returns (tier2, tier3, dropped): the keyword arguments
    of the two ``accumulate_groups`` calls (tier 2: groups of G/8 over
    full-width windows; tier 3: one-particle groups) and the dropped count
    as a 0-dim int64 tensor.  Compaction is group-granular: the
    ``k_groups`` groups with the most spills are gathered in layout order.
    ``group_cap`` and ``t3_cap`` override the budgets of tier 2
    (``SPLAT_SPILL_GROUP_CAP`` groups) and tier 3 (``T3_CAP`` stragglers);
    the interactive column launch raises both.  The tiers always run (the
    reference skips them when nothing spilled; then every gathered group
    here is inactive and ``dropped`` is 0, so the result is the same),
    which keeps the frame free of host synchronisation."""
    kw = dict(C=C, G=G, atlas_rows=atlas_rows, atlas_cols=atlas_cols,
              window_rows=window_rows, group_cap=group_cap, t3_cap=t3_cap)
    run = spill_tiers_cuda if ay_s.is_cuda else spill_tiers_plain
    return run(ay_s, ax_s, inv_h_s, coef_s, per_group_spill, **kw)


def sorted_group_size(n: int) -> int:
    """The group width of ``splat_atlas`` over n particles: sparse scenes
    take smaller groups so that a group's (band, column) span still fits
    its window."""
    if n >= 1 << 18:
        return GROUP
    return 128 if n >= 1 << 14 else 64


def splat_atlas(pos_smooth, values, matrix, resolution, scale,
                extra_mask=None, pyramid: PyramidSpec | None = None,
                depth_channel=False, giants="auto",
                _stop_after: str | None = None):
    """The flat splat path: (n, 4) positions and smoothing and (n, C_in)
    values to (image (res, res, C), dropped as a 0-dim int tensor), the
    contract of ``splat.splat_scatter``.

    The particles are sorted per frame on a (row band, tiny, column) key
    (stable: ties keep the input order) and grouped in G =
    ``sorted_group_size(n)`` after padding n to a ``G * SUBGROUPS``
    multiple (the padding decides which particles share a group, hence the
    anchors, spills and drops); windows have ``WINDOW_ROWS`` rows.
    extra_mask: optional (n,) bool; matrix: (4, 4) world->clip (host);
    giants: 'auto' (the largest splats selected here and rendered by the
    exact dense layer) or 'none'.  ``_stop_after`` truncates the
    pipeline after 'frontend' (sorted ay, ax, inv_h, coef (n_pad, C)),
    'anchors' (w0, c0, ce, coef_fit, flags), 'kernel' (the atlas after the
    main pass) or 'spill' (atlas, dropped) for the tests."""
    dev = pos_smooth.device
    if pyramid is None:
        pyramid = default_pyramid(resolution)
    matrix = _as_host_matrix(matrix)
    parts = splat_coefficients(pos_smooth, values, matrix, resolution, scale,
                               pyramid, extra_mask, mode="lowrank",
                               depth_channel=depth_channel)
    C = values.shape[1] + (1 if depth_channel else 0)
    n = pos_smooth.shape[0]
    G = sorted_group_size(n)
    pad_quantum = G * SUBGROUPS
    n_pad = max(pad_quantum, -(-n // pad_quantum) * pad_quantum)
    row_offs, atlas_rows, atlas_cols = atlas_layout(pyramid)
    row_offs_arr, res_per_level = _level_tables(
        row_offs, tuple(pyramid.level_resolutions), dev)

    giant_args = None
    coef = parts["coef"]
    if giants == "auto":
        gidx, gvalid, excluded = splat_giant.select_giants_topk(
            parts["giant"], parts["h_px"], splat_giant.CAP)
        giant_args = (parts["cy_fine"][gidx], parts["cx_fine"][gidx],
                      parts["h_px"][gidx],
                      parts["coef_giant"][gidx] * gvalid[:, None])
        coef = torch.where(excluded[:, None], 0.0, coef)
    elif giants != "none":
        raise ValueError(f"unknown giants option {giants!r}")

    lev = parts["level"].long()
    res_l = res_per_level[lev]
    # centres clipped into the guard margin: off-image splats deposit only
    # into the padding, which the collapse crops
    margin = float(COL_PAD) - FOOT + 4.0
    cy = torch.minimum(torch.clamp(parts["cy"], min=-margin), res_l + margin)
    cx = torch.minimum(torch.clamp(parts["cx"], min=-margin), res_l + margin)
    ay = row_offs_arr[lev] + cy
    ax = COL_PAD + cx
    # a negative inv_h flags a tiny (CIC) splat; the profiles see inv_h^2
    inv_h = torch.where(parts["tiny"], -1.0, 1.0 / parts["h_eff"])
    sentinel_ay = float(atlas_rows - ROW_PAD + FOOT + 2.0)

    def pad_to(x, fill):
        return torch.cat([x, torch.full((n_pad - n,) + tuple(x.shape[1:]),
                                        fill, dtype=x.dtype, device=dev)])

    # (row band, tiny, column): tiny splats lead each band so that all-tiny
    # groups form; inactive particles take the sentinel key
    band = torch.floor(ay / BAND).to(torch.int32)
    xkey = torch.clamp(torch.floor(ax).to(torch.int32), 0, 2047)
    key = band * 4096 + torch.where(parts["tiny"], 0, 2048).to(
        torch.int32) + xkey
    sentinel_key = (int(sentinel_ay // BAND) + 2) * 4096
    active = torch.abs(coef).sum(dim=1) > 0.0
    key = torch.where(active, key, sentinel_key)
    ay = torch.where(active, ay, sentinel_ay)
    ax = torch.where(active, ax, float(COL_PAD))
    key = pad_to(key, sentinel_key)
    _, perm = torch.sort(key, stable=True)
    ay_s = pad_to(ay, sentinel_ay)[perm]
    ax_s = pad_to(ax, float(COL_PAD))[perm]
    inv_h_s = pad_to(inv_h, 1.0)[perm]
    coef_s = pad_to(coef, 0.0)[perm]

    if _stop_after == "frontend":
        return ay_s, ax_s, inv_h_s, coef_s

    n_groups = n_pad // G
    # each particle's true support radius in level pixels: 1 for CIC hats,
    # KERNEL_SUPPORT * h_eff for polynomials, FOOT for truncated splats
    sup_s = torch.where(inv_h_s < 0.0, 1.0,
                        torch.clamp(kernels.KERNEL_SUPPORT / inv_h_s,
                                    max=FOOT))
    ay_lo, ay_hi = ay_s - sup_s, ay_s + sup_s
    ax_lo, ax_hi = ax_s - sup_s, ax_s + sup_s
    lo_r = ay_lo.reshape(n_groups, G).amin(dim=1)
    hi_r = ay_hi.reshape(n_groups, G).amax(dim=1)
    lo_c = ax_lo.reshape(n_groups, G).amin(dim=1)
    hi_c = ax_hi.reshape(n_groups, G).amax(dim=1)
    window_rows = WINDOW_ROWS
    w0 = torch.clamp(torch.floor(lo_r / BAND).to(torch.int32) * BAND, 0,
                     ((atlas_rows - window_rows) // BAND) * BAND)
    c0e = torch.floor(lo_c).to(torch.int32)
    # the window is aligned to COL_ALIGN; profiles span PROFILE_COLS from
    # the exact base c0e, so the fit is measured from c0e
    c0 = torch.clamp((c0e // COL_ALIGN) * COL_ALIGN, 0,
                     atlas_cols - WINDOW_COLS).to(torch.int32)
    c0e = torch.minimum(torch.maximum(c0e, c0),
                        c0 + (WINDOW_COLS - PROFILE_COLS)).to(torch.int32)
    w0 = w0.to(torch.int32)

    w0_rep = w0.repeat_interleave(G).to(torch.float32)
    c0_rep = c0e.repeat_interleave(G).to(torch.float32)
    fits = ((ay_hi < w0_rep + window_rows)
            & (ax_hi < c0_rep + PROFILE_COLS)
            & (ax_lo >= c0_rep))
    coef_fit = torch.where(fits[:, None], coef_s, 0.0)

    # size class per group: the smallest (rows, cols) extent bounding every
    # member's supported footprint (spilled members included)
    w0f = w0.to(torch.float32)
    c0ef = c0e.to(torch.float32)
    sizes = torch.full_like(w0, FULL_CLASS)
    for sz in range(len(splat_accum.SIZE_CLASSES) - 2, -1, -1):
        r_e, c_e = splat_accum.SIZE_CLASSES[sz]
        r_e = window_rows if r_e is None else min(r_e, window_rows)
        c_e = PROFILE_COLS if c_e is None else c_e
        fit_sz = (hi_r < w0f + r_e) & (hi_c < c0ef + c_e)
        sizes = torch.where(fit_sz, sz, sizes)
    flags = group_flags(inv_h_s.reshape(n_groups, G),
                        coef_fit.reshape(n_groups, G, C), H_MAX, sizes=sizes)
    if _stop_after == "anchors":
        return w0, c0, c0e, coef_fit, flags
    atlas = splat_accum.accumulate_groups(
        ay_s.reshape(n_groups, G), ax_s.reshape(n_groups, G),
        inv_h_s.reshape(n_groups, G),
        coef_fit.t().reshape(C, n_groups, G).contiguous(), w0, c0, c0e,
        flags, atlas_rows=atlas_rows, atlas_cols=atlas_cols, C=C, group=G,
        window_rows=window_rows)
    if _stop_after == "kernel":
        return atlas

    spilled = (~fits) & (torch.abs(coef_s).sum(dim=1) > 0.0)
    per_group_spill = spilled.reshape(n_groups, G).sum(dim=1,
                                                       dtype=torch.int32)
    tier2, tier3, dropped = spill_tiers(
        ay_s, ax_s, inv_h_s,
        torch.where(spilled[:, None], coef_s, 0.0).t().contiguous(),
        per_group_spill, C=C, G=G, atlas_rows=atlas_rows,
        atlas_cols=atlas_cols, window_rows=window_rows)
    splat_accum.accumulate_groups(**tier2, atlas0=atlas)
    splat_accum.accumulate_groups(**tier3, atlas0=atlas)
    if _stop_after == "spill":
        return atlas, dropped
    image = collapse_atlas(atlas, pyramid)
    if giant_args is not None:
        image = image + splat_giant.giant_image(*giant_args, resolution)
    return image, dropped


@functools.lru_cache(maxsize=None)
def _level_tables(row_offs: tuple, level_resolutions: tuple,
                  device: torch.device):
    """(row offsets, resolutions) of the pyramid's levels as float32
    tensors on ``device``, uploaded once: an upload from pageable host
    memory waits for the device's queue, which would hold the host in every
    launch."""
    return (torch.tensor(row_offs, dtype=torch.float32, device=device),
            torch.tensor(level_resolutions, dtype=torch.float32,
                         device=device))


def _pergroup_table(group_buckets, px_per_world, pyramid: PyramidSpec,
                    row_offs):
    """(n_groups, 8) f32: [bucket, 2^-lev, 2^lev, row_off, res_l, 0, 0, 0]."""
    dev = group_buckets.device
    n_groups = group_buckets.shape[0]
    lev = levels_from_buckets(group_buckets, px_per_world, pyramid.num_levels)
    lev_l = lev.long()
    zeros = torch.zeros((n_groups,), dtype=torch.float32, device=dev)
    row_offs_arr, res_per_level = _level_tables(
        tuple(row_offs), tuple(pyramid.level_resolutions), dev)
    return torch.stack(
        [group_buckets.to(torch.float32), exp2_int(-lev), exp2_int(lev),
         row_offs_arr[lev_l], res_per_level[lev_l],
         zeros, zeros, zeros], dim=1), lev


def feed_params(matrix, px_per_world, g0, start, count, bucket_thresh):
    """Host (params_f (16,) f32, sp_i (4,) i32) for ``splat_feed``."""
    m = np.asarray(matrix, dtype=np.float32)
    ppw = np.float32(px_per_world)
    params_f = np.concatenate(
        [m[0, :4], m[1, :4], m[2, :4],
         np.array([ppw, np.float32(1.0) / ppw, 0.0, 0.0], np.float32)])
    sp_i = np.array([g0, start, count, bucket_thresh], dtype=np.int32)
    return params_f.astype(np.float32), sp_i


def _as_host_matrix(matrix) -> np.ndarray:
    if isinstance(matrix, torch.Tensor):
        matrix = matrix.detach().cpu().numpy()
    return np.asarray(matrix, dtype=np.float32)


def feed_call(fields, values_cm, matrix, resolution, scale, group_buckets,
              *, mask=None, pyramid: PyramidSpec | None = None,
              depth_channel=False, piece=None, prange=None,
              bucket_thresh=splat_giant.BUCKET_DISABLED):
    """(args, kwargs) of the ``splat_feed`` call that renders one piece.
    values_cm: (C_in, n_groups, GROUP) tensor; the rest as
    ``splat_atlas_fields``."""
    n_groups = fields[0].shape[0]
    C_in = values_cm.shape[0]
    if pyramid is None:
        pyramid = default_pyramid(resolution)
    row_offs, atlas_rows, atlas_cols = atlas_layout(pyramid)
    px_per_world = resolution / (2.0 * scale)
    pergroup, _ = _pergroup_table(group_buckets, px_per_world, pyramid,
                                  row_offs)
    g0, piece_groups = (0, n_groups) if piece is None else map(int, piece)
    start, count = (0, 0) if prange is None else map(int, prange)
    params_f, sp_i = feed_params(_as_host_matrix(matrix),
                                 np.float32(px_per_world), g0, start, count,
                                 int(bucket_thresh))
    kwargs = dict(C_in=C_in, depth_channel=depth_channel,
                  resolution=resolution, atlas_rows=atlas_rows,
                  atlas_cols=atlas_cols, window_rows=PRESORTED_WINDOW_ROWS,
                  band=BAND, col_pad=float(COL_PAD), foot=FOOT,
                  piece_groups=piece_groups, ranged=prange is not None,
                  has_mask=mask is not None,
                  sentinel_ay=float(atlas_rows - ROW_PAD + FOOT + 2.0))
    args = (fields, values_cm, pergroup, params_f, sp_i,
            None if mask is None else mask.contiguous())
    return args, kwargs


def deposit_calls(feed_out, *, C, G, atlas_rows, atlas_cols,
                  window_rows=PRESORTED_WINDOW_ROWS, spill_group_cap=None,
                  spill_t3_cap=None):
    """The keyword arguments of the three ``accumulate_groups`` calls that
    follow a feed — the main pass, spill tier 2 and spill tier 3 — and the
    piece's dropped count (0-dim int tensor)."""
    ay, ax, ih, cfit, cspill, w0, c0, ce, flags, nspill = feed_out
    main = dict(ay_g=ay, ax_g=ax, ih_g=ih, coef_g=cfit, w0=w0, c0=c0, ce=ce,
                flags=flags, atlas_rows=atlas_rows, atlas_cols=atlas_cols,
                C=C, group=G, window_rows=window_rows)
    tier2, tier3, dropped = spill_tiers(
        ay.reshape(-1), ax.reshape(-1), ih.reshape(-1), cspill.reshape(C, -1),
        nspill, C=C, G=G, atlas_rows=atlas_rows, atlas_cols=atlas_cols,
        window_rows=window_rows, group_cap=spill_group_cap,
        t3_cap=spill_t3_cap)
    return main, tier2, tier3, dropped


def splat_atlas_fields(fields, values_cm, matrix, resolution, scale,
                       group_buckets, mask=None,
                       pyramid: PyramidSpec | None = None,
                       depth_channel=False, piece=None, prange=None,
                       giants="auto", spill_group_cap=None,
                       spill_t3_cap=None):
    """The presorted splat path over the transposed field layout.

    fields: (x, y, z, h) each (n_groups, GROUP) f32; values_cm: (C_in,
    n_groups, GROUP) f32 (or a C_in-sequence of (n_groups, GROUP));
    group_buckets: (n_groups,) int32; mask: optional (n_groups, GROUP) f32
    cull mask (>0 keeps); matrix: (4, 4) world->clip (host); scale: the
    viewport half-width (a numpy float32 keeps the reference's float32
    arithmetic for px_per_world); piece: optional (g0, piece_groups);
    prange: optional (start, count) of global slots; giants: 'auto', 'none'
    or a smoothing-bucket threshold; spill_group_cap / spill_t3_cap: the
    spill tiers' budgets (``spill_tiers``).

    Returns (image (res, res, C), dropped as a 0-dim int tensor)."""
    n_groups, G = fields[0].shape
    dev = fields[0].device
    if isinstance(values_cm, (list, tuple)):
        values_cm = torch.stack(list(values_cm))
    C_in = values_cm.shape[0]
    C = C_in + (1 if depth_channel else 0)
    if pyramid is None:
        pyramid = default_pyramid(resolution)
    _, atlas_rows, atlas_cols = atlas_layout(pyramid)
    matrix = _as_host_matrix(matrix)

    giant_args = None
    if giants == "auto":
        # the flat per-particle view, gated like the kernel (piece and
        # range) so a piece loop deposits each giant exactly once
        px_per_world = resolution / (2.0 * scale)
        lev = levels_from_buckets(group_buckets, px_per_world,
                                  pyramid.num_levels)
        ps_flat = torch.stack([f.reshape(-1) for f in fields], dim=1)
        vals_flat = values_cm.reshape(C_in, -1).t()
        lev_flat = lev[:, None].expand(n_groups, G).reshape(-1)
        emask = (mask > 0.0).reshape(-1) if mask is not None else None
        slot_ids = torch.arange(n_groups * G, device=dev)
        gate = None
        if piece is not None:
            gids = slot_ids // G
            gate = (gids >= int(piece[0])) & (gids < int(piece[0])
                                               + int(piece[1]))
        if prange is not None:
            pr = ((slot_ids >= int(prange[0]))
                  & (slot_ids < int(prange[0]) + int(prange[1])))
            gate = pr if gate is None else gate & pr
        if gate is not None:
            emask = gate if emask is None else emask & gate
        parts = splat_coefficients(ps_flat, vals_flat, matrix, resolution,
                                   scale, pyramid, emask, mode="lowrank",
                                   depth_channel=depth_channel,
                                   level_override=lev_flat)
        gidx, gvalid, excluded = splat_giant.select_giants_topk(
            parts["giant"], parts["h_px"], splat_giant.CAP)
        giant_args = (parts["cy_fine"][gidx], parts["cx_fine"][gidx],
                      parts["h_px"][gidx],
                      parts["coef_giant"][gidx] * gvalid[:, None])
        keep = torch.where(excluded, 0.0, 1.0).reshape(n_groups, G)
        mask = keep if mask is None else mask * keep
        bucket_thresh = splat_giant.BUCKET_DISABLED
    elif giants == "none":
        bucket_thresh = splat_giant.BUCKET_DISABLED
    else:
        bucket_thresh = int(giants)

    args, kwargs = feed_call(fields, values_cm, matrix, resolution, scale,
                             group_buckets, mask=mask, pyramid=pyramid,
                             depth_channel=depth_channel, piece=piece,
                             prange=prange, bucket_thresh=bucket_thresh)
    feed_out = splat_feed.splat_feed(*args, **kwargs)
    main, tier2, tier3, dropped = deposit_calls(
        feed_out, C=C, G=G, atlas_rows=atlas_rows, atlas_cols=atlas_cols,
        spill_group_cap=spill_group_cap, spill_t3_cap=spill_t3_cap)
    atlas = splat_accum.accumulate_groups(**main)
    splat_accum.accumulate_groups(**tier2, atlas0=atlas)
    splat_accum.accumulate_groups(**tier3, atlas0=atlas)
    image = collapse_atlas(atlas, pyramid)
    if giant_args is not None:
        image = image + splat_giant.giant_image(*giant_args, resolution)
    return image, dropped


def slice_column_fields(fields, values_cm, group_buckets, mask, col0: int,
                        width: int, merge: bool = True,
                        pad_multiple: int = 8):
    """Columns [col0, col0 + width) of the transposed field layout, for
    ``splat_atlas_fields``.

    ``merge=True``: the (n_groups, width) slice reshapes row-major into
    merged groups of pad_group / width adjacent original groups (width
    must divide pad_group; the layout's run padding keeps merged groups
    single-level, ``morton.min_slice_width``).  ``merge=False`` (the
    renderer's route): one group per original group, (n_groups, width)
    matrices at any width.  The group axis is then padded to a
    ``pad_multiple`` multiple with inactive groups (positions ``PAD_POS``,
    values and mask 0, the last group's bucket): the padding changes
    ``n_groups`` and so the spill tiers' budget, as in the reference.

    values_cm: (C_in, n_groups, pad_group) tensor or a C_in-sequence of
    (n_groups, pad_group); mask: (n_groups, pad_group) or None.  Returns
    (fields, values_cm (C_in, groups, cols), group_buckets, mask), each
    contiguous; the inputs themselves when nothing is sliced or padded."""
    from .morton import PAD_POS
    ng, pad_group = fields[0].shape
    if isinstance(values_cm, (list, tuple)):
        values_cm = torch.stack(list(values_cm))
    if not 0 < width <= pad_group or (merge and pad_group % width):
        raise ValueError(f"column width {width} for groups of {pad_group}"
                         + (" (merged slices need a divisor)" if merge
                            else ""))
    c0 = min(max(int(col0), 0), pad_group - width)
    if width != pad_group:
        cols = slice(c0, c0 + width)
        rows = (-1, pad_group) if merge else (ng, width)
        fields = tuple(f[:, cols].reshape(rows).contiguous() for f in fields)
        values_cm = values_cm[:, :, cols].reshape(
            (values_cm.shape[0],) + rows).contiguous()
        if merge:
            group_buckets = group_buckets.reshape(-1, pad_group // width)[:, 0]
        if mask is not None:
            mask = mask[:, cols].reshape(rows).contiguous()
    mg, g_cols = fields[0].shape
    pad_rows = (-mg) % pad_multiple
    if pad_rows:
        def pad(arr, fill):
            return torch.cat([arr, torch.full(arr.shape[:-2] + (pad_rows,
                                                                g_cols),
                                              fill, dtype=arr.dtype,
                                              device=arr.device)], dim=-2)

        fields = tuple(pad(f, PAD_POS) for f in fields)
        values_cm = pad(values_cm, 0.0)
        group_buckets = torch.cat(
            [group_buckets, group_buckets[-1:].expand(pad_rows)])
        if mask is not None:
            mask = pad(mask, 0.0)
    return fields, values_cm, group_buckets, mask


def collapse_atlas(atlas: torch.Tensor, pyramid: PyramidSpec) -> torch.Tensor:
    """Crop levels from the channel-major atlas, upsample coarse->fine, sum,
    and return the image as (res, res, C)."""
    from .composite import upsample2x_kind_cm
    row_offs, _, _ = atlas_layout(pyramid)
    levels = []
    for l, res_l in enumerate(pyramid.level_resolutions):
        r0 = row_offs[l]
        levels.append(atlas[:, r0:r0 + res_l, COL_PAD:COL_PAD + res_l])
    out = levels[-1]
    for l in range(pyramid.num_levels - 2, -1, -1):
        target = pyramid.level_resolutions[l]
        up = upsample2x_kind_cm(out, config.PYRAMID_COLLAPSE_FILTER)
        out = levels[l] + up[:, :target, :target]
    return out.permute(1, 2, 0)
