"""Time-budgeted progressive-rendering scheduler.

A pinned copy of ``topsy_tpu/progression.py``.

Host-side logic deciding how many particles to splat each frame, matching the
reference scheduler's behaviour (reference: src/topsy/progressive_render.py):

* each interactive frame renders one block sized from an adaptive
  recommendation targeting 1/TARGET_FPS seconds;
* the recommendation is updated from measured render time with log2-damped
  feedback (reference: progressive_render.py:88-103);
* EXPORT frames render everything in bounded chunks;
* REFINE frames continue from where the previous frame stopped;
* a mass scale-factor N_total / N_rendered keeps partial renders
  photometrically correct (reference: progressive_render.py:42-46).

The cell-aware variant converts logical particle fractions into *contiguous
device ranges* thanks to the interleaved LOD ordering (see
cells.CellLayout.interleave_order), rather than into per-cell range lists as
the reference does — the selected particle sets are identical.
"""

from __future__ import annotations

import math

import numpy as np

from . import config
from .cells import CellLayout
from .drawreason import DrawReason


class RenderProgression:
    """Recommends particle blocks to render, adapting to measured timings."""

    def __init__(self, total_particles: int, initial_particles: int | None = None):
        if initial_particles is None:
            initial_particles = int(config.INITIAL_PARTICLES_TO_RENDER)
        self._recommended = min(initial_particles, total_particles)
        self._start_index = 0
        self._total = total_particles
        self._reason: DrawReason | None = None
        self._last_block_len = 1

    # -- frame lifecycle ------------------------------------------------------

    def start_frame(self, draw_reason: DrawReason) -> bool:
        """Begin a frame; returns True if particle ranges must be refreshed."""
        self._reason = draw_reason
        self._first_block = True
        self._rendered_in_frame = 0
        self._time_in_frame = 0.0
        if draw_reason in (DrawReason.PRESENTATION_CHANGE, DrawReason.REFINE):
            return False
        self._start_index = 0
        return True

    def get_block(self, time_elapsed_in_frame: float):
        """Next (starts, lens) to render, or None when the frame is done."""
        if self._reason is None:
            raise RuntimeError("get_block called without a current frame")
        if self._reason == DrawReason.PRESENTATION_CHANGE:
            return None
        if self._start_index >= self._total:
            return None

        if self._reason == DrawReason.EXPORT:
            remaining = self._total - self._start_index
            cap = int(config.MAX_PARTICLES_PER_EXPORT_RENDERCALL
                      / self.get_fraction_volume_selected())
            n = min(remaining, cap)
        else:
            if self._first_block:
                time_available = 1.0 / config.TARGET_FPS
                self._first_block = False
            else:
                time_available = 1.0 / config.TARGET_FPS - time_elapsed_in_frame
            if time_available <= config.FRAME_BUDGET_CUTOFF_FRACTION / config.TARGET_FPS:
                # not enough budget left; a REFINE frame will continue later
                return None
            n = int(self._recommended * time_available * config.TARGET_FPS)
            n = min(n, self._total - self._start_index)

        self._last_block_len = n
        return self._block_for_logical_range(self._start_index, n)

    def end_block(self, time_elapsed_in_frame: float):
        self._start_index += self._last_block_len
        self._rendered_in_frame += self._last_block_len
        self._time_in_frame = time_elapsed_in_frame

    def end_frame_get_scalefactor(self, defer_adapt: bool = False) -> float:
        """Finish the frame; returns N_total / N_rendered for photometry.

        ``defer_adapt=True`` (barrier-free interactive frames): the frame's
        device time is not known yet — the caller reports it later via
        ``report_deferred_timing`` when the frame's single end-of-frame
        barrier (presentation readback) lands, and the LOD recommendation
        adapts then.  The photometric scale factor never waits."""
        if defer_adapt:
            self._deferred_frame = (self._reason, self._rendered_in_frame)
        else:
            self._deferred_frame = None
            self._adapt_recommendation()
        self._reason = None
        return self._total / self._start_index

    def report_deferred_timing(self, seconds: float):
        """Late LOD feedback for a frame closed with ``defer_adapt=True``:
        ``seconds`` is the frame's measured device time (from its single
        natural barrier).  No-op if no deferred frame is pending."""
        pending = getattr(self, "_deferred_frame", None)
        if pending is None:
            return
        self._deferred_frame = None
        reason, rendered = pending
        saved = (self._reason, self._rendered_in_frame, self._time_in_frame)
        self._reason, self._rendered_in_frame = reason, rendered
        self._time_in_frame = seconds
        try:
            self._adapt_recommendation()
        finally:
            (self._reason, self._rendered_in_frame,
             self._time_in_frame) = saved

    def discard_deferred_timing(self):
        """Drop a pending deferred measurement (a new frame started before
        the previous frame's barrier was observed): the recommendation
        simply keeps its last value."""
        self._deferred_frame = None

    def needs_refine(self) -> bool:
        return self._start_index < self._total

    def mark_all_rendered(self, time_elapsed_in_frame: float):
        """Record that a renderer covered everything with its own
        full-coverage pass (the presorted EXPORT path) so the scale factor is
        1, no refinement is requested, and the LOD feedback sees the real
        throughput."""
        self._rendered_in_frame += self._total - self._start_index
        self._start_index = self._total
        self._time_in_frame = time_elapsed_in_frame

    # -- internals -------------------------------------------------------------

    def _block_for_logical_range(self, start: int, length: int):
        return ([start], [length])

    def _adapt_recommendation(self):
        if self._reason in (DrawReason.REFINE, DrawReason.EXPORT):
            # REFINE continues an already-budgeted frame; EXPORT launches
            # oversized full-coverage blocks whose per-particle throughput
            # does not predict interactive blocks — and EXPORT frames run
            # barrier-free (throughput mode, render/sph.py), so their
            # elapsed time is enqueue time, not device time.  Neither may
            # steer the interactive LOD budget.
            return
        achievable = int(self._rendered_in_frame
                         / max(self._time_in_frame * config.TARGET_FPS, 1e-9))
        achievable = max(1, min(achievable, self._total))
        log2_change = abs(math.log2(achievable) - math.log2(self._recommended))
        if log2_change > 1.5:
            # way off: jump straight to the achievable number
            self._recommended = achievable
        elif log2_change > 0.3:
            # modest mismatch: damped geometric update
            self._recommended = int(achievable ** 0.3 * self._recommended ** 0.7)

    # -- geometry selection (no-op without cells) -------------------------------

    def get_max_particle_regions_per_block(self) -> int:
        return 1

    def select_sphere(self, cen, radius):
        pass

    def select_all(self):
        pass

    def get_fraction_volume_selected(self) -> float:
        return 1.0

    def get_selected_cell_mask(self):
        """Boolean mask over cells for geometric culling (None = no culling)."""
        return None


class CellSelectionMixin:
    """Spherical cell selection for geometric culling (reference:
    progressive_render.py:207-220).  Progressions mix this in so the
    renderer's cell-mask table, the ``/Ngf`` status geometry factor and the
    EXPORT chunk sizing all see the current selection."""

    def _init_cell_selection(self, cell_layout: CellLayout | None):
        self._cell_layout = cell_layout
        n = cell_layout.get_num_cells() if cell_layout is not None else 1
        self._selected_cells = np.arange(n)
        self._selection_mask = np.ones(n, dtype=bool)
        self._selection_generation = 0

    @property
    def cell_layout(self) -> CellLayout | None:
        return self._cell_layout

    def select_all(self):
        if self._cell_layout is None:
            return
        self._selected_cells = np.arange(self._cell_layout.get_num_cells())
        self._refresh_selection_mask()

    def select_sphere(self, cen, radius):
        if self._cell_layout is None:
            return
        self._selected_cells = self._cell_layout.cells_in_sphere(cen, radius)
        self._refresh_selection_mask()

    def _refresh_selection_mask(self):
        mask = np.zeros(self._cell_layout.get_num_cells(), dtype=bool)
        mask[self._selected_cells] = True
        if not np.array_equal(mask, self._selection_mask):
            self._selection_mask = mask
            self._selection_generation += 1

    def get_fraction_volume_selected(self) -> float:
        if self._cell_layout is None:
            return 1.0
        return max(1, len(self._selected_cells)) / self._cell_layout.get_num_cells()

    def get_selected_cell_mask(self):
        if self._cell_layout is None or self._selection_mask.all():
            return None
        return self._selection_mask

    @property
    def selection_generation(self) -> int:
        """Increments whenever the cell selection changes (for cache reuse)."""
        return self._selection_generation


class RenderProgressionColumns(CellSelectionMixin, RenderProgression):
    """Progression over the presorted column space (sort-free interactive LOD).

    The particle store holds the snapshot in the static (smoothing-bucket,
    Morton) order with particles shuffled within each group
    (ops/morton.py), so column c of the (n_groups, pad_group) matrix is a
    spatially fair 1/pad_group subsample.  Blocks are whole-column ranges
    ([col0], [ncols]); lengths are accounted in *real* particles via the
    layout's ``real_per_column`` so the photometric scale factor stays
    exact despite run padding.  Column counts snap up to ``col_quantum``
    multiples (the renderer's slice-width buckets).

    With a ``cell_layout``, spherical cell culling applies exactly as in the
    cell-prefix progression: the renderer masks unselected cells inside the
    splat, while logical lengths still count every particle in the rendered
    columns — the same accounting as the prefix path, so the photometric
    scale factor is unchanged by culling.

    **Decimation-mip tiers.**  Column slices cannot go below 1/8 coverage
    (min_slice_width), so at 10^8-particle scale the smallest CHANGE block
    would blow any frame budget.  ``mip_tiers`` (deepest first, each a
    ``(real_per_column, col_quantum)`` pair from
    ops/morton_device.build_mip_layout) prepend progressively decimated
    presorted layouts: the progression renders the deepest tier's columns
    first, then each parent's columns [quantum, pad_group) — exactly-once
    overall, because a mip contains exactly the particles of its parent's
    first ``quantum`` columns.  Blocks never straddle tiers; the renderer
    reads ``last_block_tier`` to pick the tier's arrays.
    """

    def __init__(self, real_per_column: np.ndarray,
                 cell_layout: CellLayout | None = None,
                 initial_particles: int | None = None, col_quantum: int = 128,
                 mip_tiers: list[tuple[np.ndarray, int]] | None = None):
        # tiers deepest-first; the main layout is always the last tier.
        # col_lo: the first column a tier renders itself (deeper tiers cover
        # its columns [0, col_lo) exactly).
        specs = list(mip_tiers or []) + [(real_per_column, col_quantum)]
        self._tiers = []
        tier_start = 0  # cumulative reals covered by deeper tiers
        for i, (rpc, q) in enumerate(specs):
            rpc = np.asarray(rpc, dtype=np.int64)
            lo = 0 if i == 0 else q
            covered = int(rpc[:lo].sum())
            assert covered == tier_start, (
                f"tier {i}: columns [0, {lo}) hold {covered} reals but "
                f"deeper tiers cover {tier_start} — not a mip chain")
            cum = np.concatenate([[0], np.cumsum(rpc[lo:])])
            self._tiers.append(dict(col_lo=lo, ncols=len(rpc), quantum=q,
                                    cum=cum, start=tier_start))
            tier_start += int(cum[-1])
        self._last_block_tier = len(self._tiers) - 1
        self._init_cell_selection(cell_layout)
        super().__init__(tier_start, initial_particles)

    @property
    def last_block_tier(self) -> int:
        """Tier index (deepest mip first, main layout last) of the block
        most recently returned by get_block."""
        return self._last_block_tier

    def start_frame(self, draw_reason: DrawReason) -> bool:
        self._frame_blocks = 0
        return super().start_frame(draw_reason)

    def get_block(self, time_elapsed_in_frame: float):
        # interactive frames render AT MOST ONE (whole-tier) block: launch
        # cost is flat in column width (see _block_for_logical_range), so
        # after a tier completes, the next tier's cost is ITS flat floor —
        # almost always beyond the remaining frame budget.  The next tier
        # arrives with the next REFINE frame instead of blowing this one.
        if (self._reason not in (None, DrawReason.EXPORT)
                and getattr(self, "_frame_blocks", 0) >= 1):
            return None
        block = super().get_block(time_elapsed_in_frame)
        if block is not None:
            self._frame_blocks = getattr(self, "_frame_blocks", 0) + 1
        return block

    def _block_for_logical_range(self, start: int, length: int):
        # locate the tier containing `start` (starts always sit on a column
        # boundary: lengths are snapped below and blocks never cross tiers)
        ti = max(i for i, t in enumerate(self._tiers) if t["start"] <= start)
        t = self._tiers[ti]
        cum, lo, q = t["cum"], t["col_lo"], t["quantum"]
        s = start - t["start"]
        c0 = int(np.searchsorted(cum, s, side="right")) - 1
        if self._reason == DrawReason.EXPORT:
            target = min(s + length, int(cum[-1]))
            c1 = int(np.searchsorted(cum, target, side="left"))
            c1 = min(max(c1, c0 + 1), len(cum) - 1)
            # snap up to the renderer's slice-width quantum (slice widths
            # are powers of two so each width compiles once)
            c1 = min(c0 + ((c1 - c0 + q - 1) // q) * q, len(cum) - 1)
        else:
            # whole-tier blocks for interactive frames: a column launch
            # touches every group of its tier regardless of width (window
            # read-modify-write, profile spans and grid steps are all
            # per-group), so its cost is flat in width — measured at 2^26:
            # the full 8.9M-particle tier renders in ~11 ms while ANY
            # narrower slice of it costs ~20-36 ms (merged groups spill;
            # non-merged slices still touch every window).  A partial
            # slice is therefore strictly worse than finishing the tier:
            # more time for fewer particles.  Tier granularity (8x steps)
            # replaces width granularity; the photometric scale factor
            # keeps every partial frame exact, and the deepest tier is
            # bounded by COLUMN_MIP_FLOOR_TARGET so the mandatory block
            # stays affordable.
            if start == 0:
                # budget-driven tier promotion for the frame's first
                # block: a mip holds exactly the particles of its
                # parent's prefix columns, so rendering a PARENT tier
                # from column 0 covers every deeper tier's logical range
                # in one launch — same exactly-once particle set, one
                # flat launch cost.  Pick the largest tier whose full
                # fair subsample fits the adaptive recommendation; the
                # flat-cost feedback then promotes/demotes between
                # frames until the largest affordable tier is stable.
                for j in range(len(self._tiers) - 1, ti, -1):
                    tj = self._tiers[j]
                    full = tj["start"] + int(tj["cum"][-1])
                    # 1/64 slack: the recommendation is an adaptive
                    # estimate (and integer-truncated), not a hard cap —
                    # skipping a tier over a rounding hair would halve
                    # the rendered set for nothing
                    if full <= length + (length >> 6) + 1:
                        self._last_block_len = full
                        self._last_block_tier = j
                        return ([0], [tj["ncols"]])
            c1 = len(cum) - 1
        # the base class set _last_block_len to the requested length before
        # dispatching here; correct it to the real count the columns cover
        self._last_block_len = int(cum[c1] - cum[c0])
        self._last_block_tier = ti
        return ([lo + c0], [c1 - c0])


class RenderProgressionWithCells(CellSelectionMixin, RenderProgression):
    """Progression with per-cell fair subsampling and spherical cell culling.

    Requires the particle arrays to be stored in the interleaved LOD order
    produced by ``CellLayout.interleave_order`` (same phase shifts/seed):
    logical fractions then map to contiguous prefix ranges.
    """

    def __init__(self, cell_layout: CellLayout, total_particles: int,
                 initial_particles: int | None = None, seed: int = 1337):
        super().__init__(total_particles, initial_particles)
        self._phase_shifts = cell_layout.default_phase_shifts(seed)
        self._init_cell_selection(cell_layout)

    def get_max_particle_regions_per_block(self) -> int:
        # device ranges are contiguous in interleave order: always one region
        return 1

    def _prefix(self, fraction: float) -> int:
        return self._cell_layout.prefix_length_for_fraction(fraction, self._phase_shifts)

    def _block_for_logical_range(self, start: int, length: int):
        if length == self._total:
            return ([0], [self._total])
        f0 = start / self._total
        f1 = (start + length) / self._total
        p0 = self._prefix(f0)
        p1 = self._prefix(f1)
        return ([p0], [p1 - p0])
