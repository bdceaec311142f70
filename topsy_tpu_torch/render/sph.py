"""The SPH renderers: the EXPORT and interactive render loops.

Counterpart of ``SPHRenderer``, ``RGBSPHRenderer`` (the three band masses,
C = 3) and ``DepthSPHRenderer`` (a mass-weighted clip-depth channel, the
double-click pick's ``get_depth_image``) in ``topsy_tpu/render/sph.py``.
``render(DrawReason.EXPORT)`` follows the reference's lazy policy
(``_use_presorted``): a one-shot EXPORT with no cached layout renders the
snapshot's flat arrays through the per-frame-sorted block path
(``_render_block`` -> ``splat_atlas``, pieces of ``bucket_size`` rows,
giants selected inside each piece); once a layout is cached or exports
repeat, it plans the exact giant layer (``_prepare_giants``) and renders
the presort through ``splat_atlas_fields`` in pieces of at most
``config.SPLAT_FEED_LAUNCH_CAP`` particles.  CHANGE and REFINE frames switch the
progression to ``RenderProgressionColumns`` over the main layout and its
decimation-mip tiers, and render whole-column ranges of the (n_groups,
pad_group) matrices of the tier each block names, one un-merged column
slice per range (``_render_block_columns_fields``), with no per-frame
sort and no host synchronisation: their device time is read later from the
frame clock (``notify_presentation_barrier``).  Without the column
progression (``config.INTERACTIVE_USE_PRESORTED`` off, or
``backend="scatter"``, which renders every block through
``splat.splat_scatter``) interactive frames run the block path with a
device barrier after every block (``sync_blocks``), whose CUDA-event times
feed the LOD scheduler.  A REFINE frame continues the image.
``get_image()`` returns the raw (mass, mass * quantity) framebuffer scaled
by the photometric mass factor, which makes a partial frame look whole.
"""

from __future__ import annotations

import copy
import logging

import numpy as np
import torch

from .. import config
from ..camera import world_to_clip_matrix
from ..drawreason import DrawReason
from ..ops import splat, splat_atlas, splat_giant
from ..performance import counters, signposter, traced
from ..util import FrameClock, TimeDeviceOperation
from .store import ParticleStore, bucket_size

logger = logging.getLogger(__name__)


def _block_rows(cell_ids, cell_table, start: int, count: int, bucket: int):
    """(rows, (bucket,) bool mask) of the ``bucket``-row slice ``rows`` of
    the flat arrays that holds rows [start, start + count): the slice is
    clamped into the arrays, the mask keeps the block's rows in selected
    cells (``cell_table`` over ``cell_ids``)."""
    sl = min(max(int(start), 0), cell_ids.shape[0] - bucket)
    rows = slice(sl, sl + bucket)
    idx = sl + torch.arange(bucket, device=cell_ids.device)
    return rows, ((idx >= start) & (idx < start + count)
                  & cell_table[cell_ids[rows].long()])


def _render_block(pos_smooth, values, cell_ids, cell_table, matrix, scale,
                  start: int, count: int, *, resolution: int, bucket: int,
                  depth_channel: bool, backend: str):
    """Render rows [start, start + count) of the flat (n_pad, .) arrays,
    realised as a ``bucket``-row slice plus a mask, into a fresh image
    through the per-frame-sorted ``splat_atlas`` (``backend="atlas"``) or
    ``splat_scatter``.  Returns (image, dropped as a 0-dim int tensor)."""
    rows, mask = _block_rows(cell_ids, cell_table, start, count, bucket)
    if backend == "atlas":
        return splat_atlas.splat_atlas(pos_smooth[rows], values[rows],
                                       matrix, resolution, scale,
                                       extra_mask=mask,
                                       depth_channel=depth_channel)
    im = splat.splat_scatter(pos_smooth[rows], values[rows], matrix,
                             resolution, scale, extra_mask=mask,
                             depth_channel=depth_channel)
    return im, torch.zeros((), dtype=torch.int64, device=im.device)


def _render_giant_layer(pos_smooth, values, buckets, cell_ids, cell_table,
                        matrix, scale, *, resolution, depth_channel):
    """The per-frame exact dense layer over the store's candidate pool."""
    pyramid = splat_atlas.default_pyramid(resolution)
    px_per_world = resolution / (2.0 * scale)
    lev = splat.levels_from_buckets(buckets, px_per_world, pyramid.num_levels)
    mask = cell_table[cell_ids.long()]
    parts = splat.splat_coefficients(pos_smooth, values, matrix, resolution,
                                     scale, pyramid, mask, mode="lowrank",
                                     depth_channel=depth_channel,
                                     level_override=lev)
    return splat_giant.giant_image(parts["cy_fine"], parts["cx_fine"],
                                   parts["h_px"], parts["coef_giant"],
                                   resolution)


def column_launches(fields, values_cm, group_buckets, mask, col0: int,
                    width: int):
    """The ``splat_atlas_fields`` calls of the interactive column launch
    over columns [col0, col0 + width) of the presorted field matrices:
    (sliced fields, values_cm, group_buckets, mask, pieces, keyword
    arguments).

    The slice is not merged (``slice_column_fields(merge=False)``): each
    original group keeps its own tight window, at any width.  Its rows are
    padded to ``splat_atlas.column_pad_multiple``, the group axis is split
    into ``splat_atlas.column_pieces`` and each call has the column
    launch's raised spill budgets, so the images and the summed dropped
    count are the reference's."""
    sliced, vals, gb, msk = splat_atlas.slice_column_fields(
        fields, values_cm, group_buckets, mask, col0, width, merge=False,
        pad_multiple=splat_atlas.column_pad_multiple(fields[0].shape[1],
                                                     width))
    kw = dict(spill_group_cap=splat_atlas.COLUMN_SPILL_GROUP_CAP,
              spill_t3_cap=splat_atlas.COLUMN_T3_CAP)
    return (sliced, vals, gb, msk,
            splat_atlas.column_pieces(sliced[0].shape[0]), kw)


def _render_block_columns_fields(fields, values_cm, group_buckets, mask,
                                 matrix, scale, col0: int, giant_bucket: int,
                                 *, resolution: int, width: int,
                                 depth_channel: bool):
    """Columns [col0, col0 + width) through ``splat_atlas_fields``
    (``column_launches``), the pieces' images and dropped counts summed on
    the device.  Returns (image, dropped as a 0-dim int tensor)."""
    sliced, vals, gb, msk, pieces, kw = column_launches(
        fields, values_cm, group_buckets, mask, col0, width)
    image = dropped = None
    for piece in pieces:
        im, d = splat_atlas.splat_atlas_fields(
            sliced, vals, matrix, resolution, scale, gb, mask=msk,
            depth_channel=depth_channel, giants=giant_bucket, piece=piece,
            **kw)
        image = im if image is None else image + im
        dropped = d if dropped is None else dropped + d
    return image, dropped


class SPHRenderer:
    """Density / mass-weighted-quantity renderer (2 channels)."""

    _buffer_name = "mass_and_quantity"
    _depth_channel = False

    def __init__(self, store: ParticleStore, render_progression,
                 resolution: int, wrapping: bool = False,
                 backend: str | None = None,
                 share_render_progression=None):
        """``wrapping`` is kept and handed to the depth renderer, as in the
        reference; ``share_render_progression``, where given, is the
        progression this renderer uses instead of ``render_progression``
        (the depth renderer runs on a copy of its owner's)."""
        self._store = store
        self._resolution = resolution
        self._wrapping = wrapping
        if backend not in (None, "atlas", "scatter"):
            raise ValueError(f"unknown splat backend {backend!r}")
        self._backend = backend or "atlas"
        self._render_progression = (share_render_progression
                                    if share_render_progression is not None
                                    else render_progression)
        self._export_renders = 0
        self._render_timer = TimeDeviceOperation(
            config.GPU_TIMING_SMOOTH_WINDOW, device=store.device)
        self._frame_clock = FrameClock(store.device)
        self._pending_timing_prog = None

        self.scale = config.DEFAULT_SCALE
        self.rotation_matrix = np.eye(3)
        self.position_offset = np.zeros(3)
        self.has_rendered = False
        self.last_render_mass_scale = 1.0
        self.last_render_fps = 0.0

        self._image = None
        self._giant_image = None
        self._giant_bucket = None
        self._dropped_splats = None
        self._cell_table = store.cell_mask_table(None)
        self._cell_table_generation = None
        self._fields_masks = {}
        #: (col0, ncols) of each column launch of the last interactive frame
        self.last_column_ranges: list = []

    @property
    def resolution(self) -> int:
        return self._resolution

    @property
    def render_progression(self):
        return self._render_progression

    @property
    def frame_clock(self) -> FrameClock:
        """The clock of the last frame; the presentation stops it."""
        return self._frame_clock

    def needs_refine(self) -> bool:
        return self._render_progression.needs_refine()

    def invalidate(self, draw_reason=DrawReason.CHANGE):
        if draw_reason not in (DrawReason.REFINE,
                               DrawReason.PRESENTATION_CHANGE):
            self.has_rendered = False

    def get_output_image(self) -> torch.Tensor:
        """The raw framebuffer (device tensor), the exact giant layer folded
        in divided by the mass scale factor."""
        if self._giant_image is None:
            return self._image
        ms = self.last_render_mass_scale
        return self._image + self._giant_image * (1.0 / ms if ms > 0 else 1.0)

    def get_image(self) -> np.ndarray:
        """Raw SPH map as numpy, photometrically rescaled."""
        return self._get_image_unscaled() * self.last_render_mass_scale

    def _get_image_unscaled(self) -> np.ndarray:
        if not self.has_rendered:
            logger.info("Triggering export-quality render (no render yet)")
            self.render(DrawReason.EXPORT)
        return self.get_output_image().cpu().numpy()

    def get_image_device(self) -> torch.Tensor:
        """Raw SPH map as a device tensor, photometrically rescaled."""
        if not self.has_rendered:
            self.render(DrawReason.EXPORT)
        return self.get_output_image() * self.last_render_mass_scale

    def get_depth_image(self, depth_renderer_reason=DrawReason.CHANGE
                        ) -> np.ndarray:
        """Mass-weighted mean depth in world units, for the double-click
        pick; empty pixels are NaN (the pick ignores them)."""
        depth_renderer = self._get_depth_renderer()
        depth_renderer.render(depth_renderer_reason)
        image = depth_renderer.get_image()
        with np.errstate(invalid="ignore", divide="ignore"):
            depth_viewport = image[..., -1] / image[..., 0]
        return (depth_viewport - 0.5) * self.scale * 2.0

    def _get_depth_renderer(self) -> "DepthSPHRenderer":
        """The cached depth renderer over the same store and resolution,
        given a copy of this renderer's progression and its view."""
        r = getattr(self, "_depth_renderer", None)
        if r is None:
            r = DepthSPHRenderer(self._store, None, self._resolution,
                                 wrapping=self._wrapping,
                                 backend=self._backend,
                                 share_render_progression=copy.copy(
                                     self._render_progression))
            self._depth_renderer = r
        r._render_progression = copy.copy(self._render_progression)
        r.rotation_matrix = self.rotation_matrix
        r.position_offset = self.position_offset
        r.scale = self.scale
        return r

    # -- render loop -------------------------------------------------------------

    @traced("topsy.render")
    def render(self, draw_reason=DrawReason.CHANGE):
        if draw_reason == DrawReason.PRESENTATION_CHANGE:
            return
        columns = self._maybe_activate_columns(draw_reason)
        prog = self._render_progression
        if draw_reason != DrawReason.REFINE:
            prog.select_sphere(-np.asarray(self.position_offset),
                               self.scale * 1.2)
            self._refresh_cell_table()

        matrix = self._matrix().astype(np.float32)
        scale = np.float32(self.scale)
        # a measurement the previous frame left pending is stale now
        self._discard_pending_timing()
        self._frame_clock.start()
        prog.start_frame(draw_reason)
        # the first block starts the image unless a REFINE frame continues it
        first_block = draw_reason != DrawReason.REFINE or self._image is None
        # column frames run barrier-free with deferred timing; frames of the
        # block path wait for the device after every block, so that the
        # scheduler's feedback is device time; EXPORT frames never wait
        defer_timing = columns and draw_reason != DrawReason.EXPORT
        sync_blocks = draw_reason != DrawReason.EXPORT and not defer_timing

        if draw_reason == DrawReason.EXPORT:
            use_presorted = self._use_presorted()
            self._export_renders += 1
            if use_presorted:
                self._render_presorted(matrix, scale, first_block=True)
                counters["particles_deposited"] += self._store.n
                prog.mark_all_rendered(
                    self._render_timer.total_time_in_frame())
                self._finish_frame(prog)
                return

        if columns:
            # the view's giant layer is planned once and kept across REFINE
            self._prepare_giants(matrix, scale, keep=not first_block)
        elif draw_reason != DrawReason.REFINE:
            # the block path selects giants inside each block
            self._giant_image = None
            self._giant_bucket = None
        self._dropped_splats = None
        self.last_column_ranges = []
        while (block := prog.get_block(
                self._render_timer.total_time_in_frame())) is not None:
            for s, l in zip(*block):
                if l <= 0:
                    continue
                if columns:
                    counters["particles_deposited"] += \
                        self._block_particles(s, l)
                    first_block = self._render_columns_range(
                        matrix, scale, s, l, first_block)
                    continue
                counters["particles_deposited"] += l
                bucket = bucket_size(l, self._store.n_pad)
                # a block larger than a bucket renders in bucket pieces
                for piece in range(0, l, bucket):
                    with self._render_timer:
                        im = self._launch_block(matrix, scale, s + piece,
                                                min(bucket, l - piece),
                                                bucket)
                        if first_block:
                            self._image = im
                            first_block = False
                        else:
                            self._image = self._image + im
                    if sync_blocks:
                        self._render_timer.sync(self._image)
            prog.end_block(self._render_timer.total_time_in_frame())
        self._finish_frame(prog, record_timing=sync_blocks,
                           defer_timing=defer_timing)

    def _finish_frame(self, prog, record_timing: bool = False,
                      defer_timing: bool = False):
        """Close a frame.  ``record_timing`` (frames of the block path that
        waited for the device after every block): the frame's CUDA-event
        time feeds the fps running mean and the LOD scheduler; otherwise
        (EXPORT and column frames, barrier-free) the enqueue-only timing is
        discarded.  ``defer_timing`` (column frames): the device time is
        reported later by whoever observes the frame's one barrier, the
        presentation readback (``notify_presentation_barrier``) or the
        caller's own sync (``notify_frame_time``); the LOD recommendation
        waits for it, the photometric scale factor does not."""
        self._render_timer.end_frame(record=record_timing)
        if defer_timing:
            self._pending_timing_prog = prog
            self.last_render_mass_scale = prog.end_frame_get_scalefactor(
                defer_adapt=True)
        else:
            self.last_render_mass_scale = prog.end_frame_get_scalefactor()
        mean = self._render_timer.running_mean_duration
        self.last_render_fps = 1.0 / mean if mean > 0 else 0.0
        self.has_rendered = True
        self._postprocess_frame()

    def _postprocess_frame(self):
        """Hook for subclasses, called as a frame closes (periodic
        tiling)."""

    # -- deferred frame timing (one host round trip per interactive frame) ----

    def notify_frame_time(self, seconds: float):
        """Report the device time of the last interactive frame, measured by
        a caller that observed its barrier.  Feeds the fps running mean and
        the LOD scheduler's deferred adaptation; a no-op when no
        measurement is pending."""
        prog = self._pending_timing_prog
        if prog is None:
            return
        self._pending_timing_prog = None
        self._render_timer.record_external(seconds)
        prog.report_deferred_timing(max(0.0, seconds))
        mean = self._render_timer.running_mean_duration
        self.last_render_fps = 1.0 / mean if mean > 0 else 0.0

    def notify_presentation_barrier(self):
        """Presentation hook, called once the presentation's readback has
        landed and the frame clock is stopped: the clock's span, from the
        frame's first launch to the end of the readback, is the time the
        frame budget must cover (render, colormap and fit)."""
        if self._pending_timing_prog is None:
            return
        seconds = self._frame_clock.seconds()
        if seconds is not None:
            self.notify_frame_time(seconds)

    def _discard_pending_timing(self):
        prog = self._pending_timing_prog
        if prog is not None:
            self._pending_timing_prog = None
            prog.discard_deferred_timing()

    def _maybe_activate_columns(self, draw_reason) -> bool:
        """Switch the progression to sort-free column LOD
        (``RenderProgressionColumns``) over the presorted layout and its
        decimation-mip tiers (``store.ensure_column_mips``; none for small
        snapshots or the host fallback), once per renderer; a REFINE or
        EXPORT frame never switches.  Returns whether the columns
        progression is active."""
        from ..ops.morton import min_slice_width
        from ..progression import RenderProgressionColumns
        if isinstance(self._render_progression, RenderProgressionColumns):
            return True
        if draw_reason in (DrawReason.REFINE, DrawReason.EXPORT):
            return False
        if self._backend != "atlas" or not config.INTERACTIVE_USE_PRESORTED:
            return False
        store = self._store
        store.ensure_presorted()
        layout = store.presorted_layout
        if layout.real_per_column is None:
            return False  # layout without safe column slicing
        mips = store.ensure_column_mips()
        self._render_progression = RenderProgressionColumns(
            layout.real_per_column,
            cell_layout=getattr(self._render_progression, "cell_layout", None),
            col_quantum=min_slice_width(layout),
            mip_tiers=[(m.layout.real_per_column, min_slice_width(m.layout))
                       for m in mips])
        return True

    def _block_tier(self):
        """The tier (``store.PresortedMipTier``) the progression's last
        block indexes: a decimation mip, or the main layout (the last)."""
        mips = self._store.ensure_column_mips()
        i = self._render_progression.last_block_tier
        return mips[i] if i < len(mips) else self._store.main_tier

    def _prepare_giants(self, matrix, scale, keep: bool = False):
        """Per-view giant planning: sets the exclusion bucket threshold of
        every windowed launch and the exact dense giant layer (or None), a
        framebuffer of its own that ``get_output_image`` folds in divided by
        the mass scale.  ``keep`` (a REFINE continuation, same view) reuses
        the plan and the layer."""
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
                self._giant_image = None
                return
            with self._render_timer:
                cand = store.giant_candidates(size)
                self._giant_image = _render_giant_layer(
                    cand["pos"],
                    store.giant_values_for(self._buffer_name, size),
                    cand["buckets"], cand["cell_ids"], self._cell_table,
                    matrix, scale, resolution=self._resolution,
                    depth_channel=self._depth_channel)

    def _use_presorted(self) -> bool:
        """Whether an EXPORT frame renders the presort: once a layout is
        cached on the store (later renderers reuse it at once) or once
        exports repeat (movies, repeated saves); a one-shot EXPORT renders
        the flat arrays through the sorted block path and never builds
        the presort."""
        if self._backend != "atlas":
            return False
        if self._store.presorted_layout is not None:
            return True
        return self._export_renders >= 1

    def _render_presorted(self, matrix, scale, first_block: bool):
        self._store.ensure_presorted()
        self._prepare_giants(matrix, scale)
        self._render_presorted_fields(matrix, scale, first_block)

    def _launch_block(self, matrix, scale, start: int, count: int,
                      bucket: int) -> torch.Tensor:
        """Rows [start, start + count) of the store's flat arrays into a
        fresh image (``_render_block``); the block's dropped count becomes
        the frame's, as in the reference."""
        store = self._store
        im, dropped = _render_block(
            store.flat_pos_smooth, store.flat_values_for(self._buffer_name),
            store.flat_cell_ids, self._cell_table, matrix, scale, start,
            count, resolution=self._resolution, bucket=bucket,
            depth_channel=self._depth_channel, backend=self._backend)
        self._dropped_splats = dropped
        return im

    def _block_particles(self, col0: int, ncols: int) -> int:
        """The real particles in columns [col0, col0 + ncols) of the tier
        the progression's last block names."""
        rpc = self._block_tier().layout.real_per_column
        return int(rpc[col0:col0 + ncols].sum())

    def _render_columns_range(self, matrix, scale, col0: int, ncols: int,
                              first_block: bool) -> bool:
        """Columns [col0, col0 + ncols) of the presorted matrices of the
        tier the progression's ``last_block_tier`` names (a decimation mip,
        or the main layout) in one launch (``_render_block_columns_fields``),
        added to the frame's image and its dropped count (summed on the
        device).  Returns the updated ``first_block``."""
        tier = self._block_tier()
        with self._render_timer:
            im, dropped = _render_block_columns_fields(
                tier.fields(), tier.values_cm_for(self._buffer_name),
                tier.group_buckets, self._feed_cull_mask(tier), matrix,
                scale, col0, int(self._giant_bucket),
                resolution=self._resolution, width=ncols,
                depth_channel=self._depth_channel)
            self.last_column_ranges.append((col0, ncols))
            self._dropped_splats = (dropped if self._dropped_splats is None
                                    else self._dropped_splats + dropped)
            if first_block:
                self._image = im
                first_block = False
            else:
                self._image = self._image + im
        return first_block

    def _feed_cull_mask(self, tier):
        """(n_groups, pad_group) f32 cull mask of ``tier``
        (``store.PresortedMipTier``), rebuilt only when the cell selection
        changes; None without culling."""
        prog = self._render_progression
        if prog.get_selected_cell_mask() is None:
            self._fields_masks = {}
            return None
        gen = getattr(prog, "selection_generation", None)
        got = self._fields_masks.get(tier)
        if got is None or got[0] != gen:
            with signposter.use_interval("topsy.cull_mask"):
                G = tier.layout.pad_group
                mask = self._cell_table[tier.cell_ids.long()].to(
                    torch.float32).reshape(tier.n_out // G, G)
            got = self._fields_masks[tier] = (gen, mask)
        return got[1]

    def pieces(self) -> list:
        """The ``piece`` argument of each ``splat_atlas_fields`` launch of an
        EXPORT frame: ``[None]`` when one launch covers every group, else
        ``(g0, piece_groups)`` per launch of at most
        ``config.SPLAT_FEED_LAUNCH_CAP`` particles."""
        store = self._store
        store.ensure_presorted()
        G = store.presorted_layout.pad_group
        ng = store.n_presorted // G
        piece_g = max(8, min(ng, config.SPLAT_FEED_LAUNCH_CAP // G))
        if piece_g >= ng:
            return [None]
        return [(g0, min(piece_g, ng - g0)) for g0 in range(0, ng, piece_g)]

    def _render_presorted_fields(self, matrix, scale, first_block: bool):
        """Sort-free EXPORT: the piece loop over group offsets.  Each piece
        launch has its own spill budget, so the piecing decides ``dropped``
        as in the reference."""
        tier = self._store.main_tier
        fields = tier.fields()
        values_cm = tier.values_cm_for(self._buffer_name)
        mask = self._feed_cull_mask(tier)
        for piece in self.pieces():
            with self._render_timer:
                im, dropped = splat_atlas.splat_atlas_fields(
                    fields, values_cm, matrix, self._resolution, scale,
                    tier.group_buckets, mask=mask, depth_channel=self._depth_channel,
                    piece=piece, giants=self._giant_bucket)
                self._dropped_splats = dropped
                if first_block:
                    self._image = im
                    first_block = False
                else:
                    self._image = self._image + im

    @property
    def last_dropped_splats(self) -> int:
        """Splats dropped by the bounded spill tiers: in the last piece or
        block of an EXPORT or block-path frame (as in the reference), summed
        over the launches of a column frame."""
        d = self._dropped_splats
        return 0 if d is None else int(d.item())

    def _matrix(self) -> np.ndarray:
        return world_to_clip_matrix(self.rotation_matrix, self.position_offset,
                                    self.scale)

    def _refresh_cell_table(self):
        prog = self._render_progression
        gen = getattr(prog, "selection_generation", None)
        if gen != self._cell_table_generation or self._cell_table is None:
            mask = prog.get_selected_cell_mask()
            self._cell_table = self._store.cell_mask_table(mask)
            self._cell_table_generation = gen


class RGBSPHRenderer(SPHRenderer):
    """Three-band (I, V, U) stellar-light renderer."""

    _buffer_name = "rgb"


class DepthSPHRenderer(SPHRenderer):
    """Adds a mass-weighted clip-depth channel: (mass, mass * quantity,
    mass * clip z)."""

    _depth_channel = True
