"""Occlusion (surface) renderer: front-most-fragment semantics.

Counterpart of ``SurfaceSPHRenderer`` in ``topsy_tpu/render/surface.py``
over the column path of the store's presort and its decimation-mip tiers:
particles above a density-percentile cut render as hemispheres with a
greater-compare depth test; the output channels are (quantity value,
surface depth).  Every frame activates the columns progression (as the
reference does even for EXPORT), plans the exact dense giant layer once per
view, and renders each column range of the tier its block names in one
launch through ``zsplat_atlas`` in group-axis chunks of at most
``config.SPLAT_COLUMNS_GROUP_CAP`` groups, combined by max-compositing.
EXPORT renders every particle once (each tier's own columns).  CHANGE and REFINE frames (the interactive
surface) render the progression's ranges barrier-free with deferred timing
(the frame clock, as ``render/sph.py``); a REFINE frame continues the image
and keeps the view's giant plan, and the giant layer is composited again
after every frame (max is idempotent).  The photometric mass scale is
unity.  Without the column progression (``config.INTERACTIVE_USE_PRESORTED``
off, a layout without column slicing, or ``backend="scatter"``) every frame
renders the snapshot's flat arrays in ``bucket_size`` pieces through
``zsplat.zsplat_scatter`` (``_render_block_surface``, the reference's
scatter fallback, which keeps the truncated giants), combined by
max-compositing, with a device barrier after every piece of an
interactive frame (``sync_blocks``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..drawreason import DrawReason
from ..ops import splat, splat_atlas, splat_giant, zsplat, zsplat_atlas
from ..performance import counters, signposter, traced
from .sph import SPHRenderer, _block_rows
from .store import ParticleStore, bucket_size


def _render_block_surface(pos_smooth, values, cell_ids, cell_table, matrix,
                          scale, density_cut, start: int, count: int, *,
                          resolution: int, bucket: int):
    """Rows [start, start + count) of the flat (n_pad, .) arrays, realised
    as a ``bucket``-row slice plus a mask, through ``zsplat_scatter``:
    a (res, res, 2) (value, depth) image."""
    rows, mask = _block_rows(cell_ids, cell_table, start, count, bucket)
    return zsplat.zsplat_scatter(pos_smooth[rows], values[rows], matrix,
                                 resolution, scale, density_cut=density_cut,
                                 extra_mask=mask)


def surface_column_launches(pos_smooth, values, buckets, cell_ids,
                            cell_table, col0: int, width: int,
                            pad_group: int):
    """The ``zsplat_atlas`` calls of the surface column launch over columns
    [col0, col0 + width) of the (groups x pad_group) presorted matrix:
    (sliced pos_smooth, values, buckets, cull mask or None, the row slices
    of its group-axis chunks, keyword arguments).  A narrow slice keeps
    each original group as its own group (``group=width``), padded to
    ``splat_atlas.column_pad_multiple``; every call has the column launch's
    raised spill budgets.  ``cell_table`` (None = no culling) masks
    unselected cells."""
    n_pad = pos_smooth.shape[0]
    ngr = n_pad // pad_group
    c0 = min(max(int(col0), 0), pad_group - width)

    def slice_cols(arr):
        if width == pad_group:
            return arr
        tail = arr.shape[1:]
        a = arr.reshape((ngr, pad_group) + tail)[:, c0:c0 + width]
        return a.reshape((ngr * width,) + tail)

    mask = None if cell_table is None else cell_table[slice_cols(cell_ids)
                                                      .long()]
    if width == pad_group:
        group = subgroups = None  # the standard full-width grouping
        g_eff = 512
    else:
        group = width
        subgroups = splat_atlas.column_pad_multiple(pad_group, width)
        g_eff = width
    ps_s = slice_cols(pos_smooth)
    kw = dict(group=group, subgroups=subgroups,
              spill_group_cap=splat_atlas.COLUMN_SPILL_GROUP_CAP,
              t3_cap=splat_atlas.COLUMN_T3_CAP)
    return (ps_s, slice_cols(values), slice_cols(buckets), mask,
            column_chunks(ps_s.shape[0], g_eff), kw)


def _render_block_columns_surface(pos_smooth, values, buckets, cell_ids,
                                  cell_table, matrix, scale, density_cut,
                                  col0: int, giant_bucket: int, *,
                                  resolution: int, width: int,
                                  pad_group: int):
    """Column-slice z-buffered render through ``zsplat_atlas``
    (``surface_column_launches``): the chunks' images max-composited, their
    dropped counts summed."""
    ps, vals, bks, mask, chunks, kw = surface_column_launches(
        pos_smooth, values, buckets, cell_ids, cell_table, col0, width,
        pad_group)
    im, dropped = None, 0
    for sl in chunks:
        im_p, d_p = zsplat_atlas.zsplat_atlas(
            ps[sl], vals[sl], matrix, resolution, scale, bks[sl],
            density_cut=density_cut,
            extra_mask=None if mask is None else mask[sl],
            giants=giant_bucket, **kw)
        im = im_p if im is None else _max_composite(im, im_p)
        dropped = dropped + d_p
    return im, dropped


def column_chunks(n_rows: int, g_eff: int) -> list[slice]:
    """The row slices of the group-axis chunks of a column launch
    (``splat_atlas.column_pieces`` over groups of ``g_eff`` rows)."""
    return [slice(g0 * g_eff, min((g0 + n) * g_eff, n_rows))
            for g0, n in splat_atlas.column_pieces(-(-n_rows // g_eff))]


def _render_giant_layer_surface(pos_smooth, values, buckets, cell_ids,
                                cell_table, matrix, scale, density_cut, *,
                                resolution: int):
    """Exact dense hemisphere layer for the giant splats
    (``splat_giant.zsplat_giant_image``): full support, true-h profile."""
    pyramid = splat_atlas.default_pyramid(resolution)
    cx, cy, z01, h_px, visible = splat.project(pos_smooth, matrix,
                                               resolution, scale)
    px_per_world = resolution / (2.0 * scale)
    lev = splat.levels_from_buckets(buckets, px_per_world,
                                    pyramid.num_levels)
    h_l = h_px * splat.exp2_int(-lev)
    mass, qty = values[:, 0], values[:, 1]
    h_world = pos_smooth[:, 3]
    hw = torch.clamp(h_world, min=1e-30)
    rho = mass / (hw * hw * hw)
    active = (visible & (rho > density_cut) & cell_table[cell_ids.long()]
              & (h_l > splat_giant.GIANT_H))
    h_clip_half = h_world / scale * 0.5
    return splat_giant.zsplat_giant_image(cy, cx, h_px, z01, h_clip_half,
                                          qty, active, resolution)


def _max_composite(a, b):
    """Combine two (value, depth) maps keeping the front-most fragment."""
    front = b[..., 1] > a[..., 1]
    return torch.where(front[..., None], b, a)


class SurfaceSPHRenderer(SPHRenderer):
    """Front-most surface renderer with a density cut."""

    _buffer_name = "surface_values"  # (mass, raw quantity)
    _rho_percentiles_num_samples = 101

    def __init__(self, store: ParticleStore, render_progression,
                 resolution: int, wrapping: bool = False,
                 backend: str | None = None, share_render_progression=None):
        super().__init__(store, render_progression, resolution,
                         wrapping=wrapping, backend=backend,
                         share_render_progression=share_render_progression)
        loader = store._loader
        with signposter.use_interval("topsy.density_table"):
            self._percentile_to_den_cut = zsplat.density_cut_percentiles(
                loader.get_mass(), loader.get_smooth(),
                self._rho_percentiles_num_samples)
        lo, hi = self.get_density_cut_percentile_range()
        self._cut_val = 0.5 * (lo + hi)
        self._surface_giant_layer = None

    # -- density cut API -----------------------------------------------------------

    def get_density_cut_percentile(self):
        return self._cut_val

    def set_density_cut_percentile(self, value):
        self._cut_val = value

    def get_density_cut_percentile_range(self):
        return 0.0, 100.0

    def _density_cut_value(self) -> float:
        i = int(self._cut_val / 100.0
                * (self._rho_percentiles_num_samples - 1))
        return float(self._percentile_to_den_cut[i])

    # -- render ----------------------------------------------------------------------

    @traced("topsy.render")
    def render(self, draw_reason=DrawReason.CHANGE):
        if draw_reason == DrawReason.PRESENTATION_CHANGE:
            return
        # the columns progression serves EXPORT too: the scatter fallback is
        # far slower than the column path, so a one-shot EXPORT builds it
        columns = self._maybe_activate_columns(
            DrawReason.CHANGE if draw_reason == DrawReason.EXPORT
            else draw_reason)
        prog = self._render_progression
        if draw_reason != DrawReason.REFINE:
            prog.select_sphere(-np.asarray(self.position_offset),
                               self.scale * 1.2)
            self._refresh_cell_table()

        matrix = self._matrix().astype(np.float32)
        scale = np.float32(self.scale)
        cut = np.float32(self._density_cut_value())
        self._discard_pending_timing()
        self._frame_clock.start()
        first_block = draw_reason != DrawReason.REFINE or self._image is None
        if columns:
            self._prepare_surface_giants(matrix, scale, cut,
                                         keep=not first_block)
        else:
            # the scatter fallback keeps the truncated hemispheres
            self._giant_bucket = None
            self._surface_giant_layer = None
        prog.start_frame(draw_reason)
        defer_timing = columns and draw_reason != DrawReason.EXPORT
        sync_blocks = draw_reason != DrawReason.EXPORT and not defer_timing
        self._dropped_splats = None
        self.last_column_ranges = []
        store = self._store
        while (block := prog.get_block(
                self._render_timer.total_time_in_frame())) is not None:
            starts, lens = block
            for s, l in zip(starts, lens):
                if l <= 0:
                    continue
                if columns:
                    counters["particles_deposited"] += \
                        self._block_particles(s, l)
                    first_block = self._render_columns_surface(
                        matrix, scale, cut, s, l, first_block)
                    continue
                counters["particles_deposited"] += l
                bucket = bucket_size(l, store.n_pad)
                for piece in range(0, l, bucket):
                    with self._render_timer:
                        im = _render_block_surface(
                            store.flat_pos_smooth,
                            store.flat_values_for(self._buffer_name),
                            store.flat_cell_ids, self._cell_table, matrix,
                            scale, cut, s + piece, min(bucket, l - piece),
                            resolution=self._resolution, bucket=bucket)
                        if first_block:
                            self._image = im
                            first_block = False
                        else:
                            self._image = _max_composite(self._image, im)
                    if sync_blocks:
                        self._render_timer.sync(self._image)
            prog.end_block(self._render_timer.total_time_in_frame())
        layer = self._surface_giant_layer
        if layer is not None:
            # max is idempotent: compositing the layer again after every
            # REFINE continuation keeps the giants exact
            with self._render_timer:
                self._image = (layer if self._image is None
                               else _max_composite(self._image, layer))
        self._finish_frame(prog, record_timing=sync_blocks,
                           defer_timing=defer_timing)
        self.last_render_mass_scale = 1.0  # max semantics need no rescale

    def _prepare_surface_giants(self, matrix, scale, cut, keep: bool = False):
        """Per-view giant planning: the bucket exclusion threshold of the
        windowed column slices and the exact dense hemisphere layer;
        ``keep`` (a REFINE continuation, same view) reuses both."""
        if keep and self._giant_bucket is not None:
            return
        with signposter.use_interval("topsy.giants"):
            store = self._store
            num_levels = splat_atlas.default_pyramid(
                self._resolution).num_levels
            size, b_thresh = splat_giant.giant_plan(
                store.giant_meta(), self._resolution, float(self.scale),
                num_levels)
            self._giant_bucket = b_thresh
            if size == 0:
                self._surface_giant_layer = None
                return
            with self._render_timer:
                cand = store.giant_candidates(size)
                self._surface_giant_layer = _render_giant_layer_surface(
                    cand["pos"],
                    store.giant_values_for(self._buffer_name, size),
                    cand["buckets"], cand["cell_ids"], self._cell_table,
                    matrix, scale, cut, resolution=self._resolution)

    def _render_columns_surface(self, matrix, scale, cut, col0: int,
                                ncols: int, first_block: bool) -> bool:
        """One column launch over columns [col0, col0 + ncols) of the flat
        presorted arrays of the tier the progression's ``last_block_tier``
        names (a decimation mip, or the main layout), added to the frame's
        image by max-compositing and to its dropped count (on the device).
        Returns the updated ``first_block``."""
        tier = self._block_tier()
        culling = self._render_progression.get_selected_cell_mask() is not None
        with self._render_timer:
            im, dropped = _render_block_columns_surface(
                tier.pos_smooth, tier.values_for(self._buffer_name),
                tier.buckets, tier.cell_ids if culling else None,
                self._cell_table if culling else None,
                matrix, scale, cut, col0, int(self._giant_bucket),
                resolution=self._resolution, width=ncols,
                pad_group=tier.layout.pad_group)
            self.last_column_ranges.append((col0, ncols))
            self._dropped_splats = (dropped if self._dropped_splats is None
                                    else self._dropped_splats + dropped)
            if first_block:
                self._image = im
                first_block = False
            else:
                self._image = _max_composite(self._image, im)
        return first_block

    @property
    def last_dropped_splats(self) -> int:
        """Splats dropped by the bounded spill tiers, summed over the last
        frame's column launches and their group-axis chunks (the
        univariate interactive convention; with one launch per frame, the
        reference's last-launch count)."""
        d = self._dropped_splats
        return 0 if d is None else int(d)

    def get_image(self) -> np.ndarray:
        """No photometric rescaling."""
        return self._get_image_unscaled()
