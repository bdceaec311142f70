"""The port's interactive LOD path (CHANGE and REFINE column frames over the
presort) against the reference's, and against its own EXPORT frames,
mirroring the reference's tests of the path (tests/test_presorted.py,
tests/test_visualizer.py) on the 20k- and 30k-particle scenes at 128^2.

At these sizes the layout has no decimation-mip tier (its smallest column
block holds fewer than config.COLUMN_MIP_FLOOR_TARGET particles; the tiers
are tests/test_torch_column_mips.py's), so a CHANGE frame renders every
column in one launch and schedules no REFINE frame.  The
tests that continue a frame install ``_QuantumColumns``, a columns
progression that hands out given column widths one frame at a time, so
that REFINE frames render real partial ranges (128 columns, then 384).

Tolerances: column launches against the reference at the cross-engine
bounds of tests/test_splat_fields.py:75-78 (sum rel 1e-3, max pixel
difference <= 1% of the maximum, correlation > 0.9999) with equal
``dropped``; a completed interactive image against EXPORT to sum rel 1e-4
and correlation > 0.9999, as tests/test_presorted.py holds the
reference."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import topsy_tpu
import topsy_tpu_torch
from topsy_tpu.canvas import OffscreenCanvas as RefCanvas
from topsy_tpu.drawreason import DrawReason as RefReason
from topsy_tpu_torch import config
from topsy_tpu_torch.canvas import OffscreenCanvas
from topsy_tpu_torch.drawreason import DrawReason
from topsy_tpu_torch.ops.splat_giant import BUCKET_DISABLED
from topsy_tpu_torch.progression import RenderProgressionColumns
from topsy_tpu_torch.render import sph as p_sph

# one process's share of the cores when pytest-xdist runs several workers
# (torch's default, every core in each process, oversubscribes them)
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

N, RES = 20000, 128


class _QuantumColumns(RenderProgressionColumns):
    """A columns progression whose interactive frames each render the next
    of ``widths`` columns (the one-tier layout's own progression renders
    all of them in the first frame)."""

    def __init__(self, real_per_column, widths, **kw):
        super().__init__(real_per_column, mip_tiers=[], **kw)
        self._widths = list(widths)

    def _block_for_logical_range(self, start, length):
        cum = self._tiers[0]["cum"]
        c0 = int(np.searchsorted(cum, start, side="right")) - 1
        c1 = min(c0 + self._widths.pop(0), len(cum) - 1)
        self._last_block_len = int(cum[c1] - cum[c0])
        self._last_block_tier = 0
        return [c0], [c1 - c0]


def _port(n=N, **kw):
    v = topsy_tpu_torch.test(n, render_resolution=RES,
                             canvas_class=OffscreenCanvas, device="cpu", **kw)
    v.show_status = False
    v.show_colorbar = False
    return v


def _quantum_columns(vis, widths):
    store = vis.store
    # the Visualizer's first EXPORT took the sorted block path (the lazy
    # policy) and built no presort: build it, as a CHANGE frame would
    store.ensure_presorted()
    prog = _QuantumColumns(store.presorted_layout.real_per_column, widths,
                           cell_layout=getattr(vis._sph.render_progression,
                                               "cell_layout", None))
    vis._sph._render_progression = prog
    return prog


def _cross_engine(a, b):
    assert np.isfinite(a).all()
    for c in range(b.shape[-1]):
        assert a[..., c].sum() == pytest.approx(b[..., c].sum(), rel=1e-3)
    assert np.abs(a - b).max() <= 0.01 * np.abs(b).max()
    assert np.corrcoef(a[..., 0].ravel(), b[..., 0].ravel())[0, 1] > 0.9999


def _matches_export(sph):
    """The completed interactive image against the EXPORT image of the same
    view (tests/test_presorted.py's bounds)."""
    assert not sph.needs_refine()
    assert sph.last_render_mass_scale == pytest.approx(1.0)
    im_cols = sph.get_output_image().numpy().copy()
    sph.render(DrawReason.EXPORT)
    im_export = sph.get_output_image().numpy()
    assert im_cols[..., 0].sum() == pytest.approx(im_export[..., 0].sum(),
                                                  rel=1e-4)
    corr = np.corrcoef(im_cols[..., 0].ravel(),
                       im_export[..., 0].ravel())[0, 1]
    assert corr > 0.9999


def test_interactive_render_uses_columns():
    """A CHANGE render activates the column progression; refining to
    completion reproduces the EXPORT image (tests/test_presorted.py)."""
    vis = _port(30000)
    sph = vis._sph
    sph.render(DrawReason.CHANGE)
    assert isinstance(sph.render_progression, RenderProgressionColumns)
    assert sph.last_column_ranges == [(0, vis.store.presorted_layout.pad_group)]
    for _ in range(20):
        if not sph.needs_refine():
            break
        sph.render(DrawReason.REFINE)
    _matches_export(sph)


def test_refine_frames_continue_the_image():
    """REFINE frames continue a partial CHANGE frame: the photometric scale
    makes the partial frame whole, and the completed sum is EXPORT's."""
    vis = _port()
    sph = vis._sph
    _quantum_columns(vis, [128, 128, 256])
    sph.render(DrawReason.CHANGE)
    assert sph.last_column_ranges == [(0, 128)]
    assert sph.needs_refine() and sph.last_render_mass_scale > 2.0
    partial = sph.get_image()[..., 0]
    for expect in ([(128, 128)], [(256, 256)]):
        sph.render(DrawReason.REFINE)
        assert sph.last_column_ranges == expect
    whole = sph.get_image()[..., 0]
    # a 128-column slice is a fair subsample (tests/test_presorted.py)
    assert partial.sum() == pytest.approx(whole.sum(), rel=0.02)
    assert np.corrcoef(partial.ravel(), whole.ravel())[0, 1] > 0.98
    _matches_export(sph)


@pytest.fixture(scope="module")
def ref_vis():
    v = topsy_tpu.test(N, render_resolution=RES, canvas_class=RefCanvas)
    v.show_status = False
    v._sph._force_feed = True          # the feed path, interpreted
    return v


def _ref_ranges(vis, ranges):
    """The reference renderer's ``_render_columns_range`` over ``ranges``:
    the accumulated image and each launch's dropped count."""
    sph = vis._sph
    assert sph._maybe_activate_columns(RefReason.CHANGE)
    matrix = jnp.asarray(sph._matrix(), dtype=jnp.float32)
    scale = jnp.float32(sph.scale)
    sph._prepare_giants(matrix, scale, keep=False)
    first, dropped = True, []
    for c0, n in ranges:
        first = sph._render_columns_range(matrix, scale, c0, n, first, False)
        dropped.append(int(sph._dropped_splats))
    return np.asarray(sph._image), dropped


def test_column_ranges_match_reference(ref_vis):
    """Columns [0, 128) and then [128, 512), a 384-wide un-merged slice,
    through both renderers' ``_render_columns_range`` on the same scene:
    the images at the cross-engine bounds, the dropped counts equal."""
    ranges = [(0, 128), (128, 384)]
    im_r, d_r = _ref_ranges(ref_vis, ranges)
    vis = _port()
    sph = vis._sph
    assert sph._maybe_activate_columns(DrawReason.CHANGE)
    matrix = sph._matrix().astype(np.float32)
    scale = np.float32(sph.scale)
    sph._prepare_giants(matrix, scale)
    first, d_p = True, []
    for c0, n in ranges:
        sph._dropped_splats = None
        first = sph._render_columns_range(matrix, scale, c0, n, first)
        d_p.append(sph.last_dropped_splats)
    assert d_p == d_r
    _cross_engine(sph._image.numpy(), im_r)


def test_column_path_cell_masking():
    """The column launch honours the cell mask: culled cells contribute
    nothing, and the result equals ``splat_atlas_fields`` on the same
    slice cut by hand with the mask applied (tests/test_presorted.py)."""
    from topsy_tpu_torch.ops import splat_atlas
    vis = _port(30000)
    store, sph = vis.store, vis._sph
    fields = store.presorted_fields()
    values = store.presorted_values_cm_for(sph._buffer_name)
    gb = store.presorted_group_buckets
    # synthetic cells: the left half-space kept, the right one culled
    keep = (fields[0] <= 0.0).to(torch.float32)
    matrix = sph._matrix().astype(np.float32)
    scale = np.float32(sph.scale)
    bucket = int(BUCKET_DISABLED)
    kw = dict(resolution=RES, width=128, depth_channel=False)
    im_culled, _ = p_sph._render_block_columns_fields(
        fields, values, gb, keep, matrix, scale, 0, bucket, **kw)
    im_all, _ = p_sph._render_block_columns_fields(
        fields, values, gb, None, matrix, scale, 0, bucket, **kw)
    im_culled, im_all = im_culled[..., 0].numpy(), im_all[..., 0].numpy()
    assert 0.0 < im_culled.sum() < 0.8 * im_all.sum()
    cut = tuple(f[:, :128].contiguous() for f in fields)
    ref, _ = splat_atlas.splat_atlas_fields(
        cut, values[:, :, :128].contiguous(), matrix, RES, scale, gb,
        mask=keep[:, :128].contiguous(), giants=bucket,
        spill_group_cap=4 * config.SPLAT_SPILL_GROUP_CAP,
        spill_t3_cap=4096)
    np.testing.assert_allclose(im_culled, ref[..., 0].numpy(), rtol=1e-5,
                               atol=1e-12)


def test_interactive_columns_zoomed_culling():
    """A zoomed-in interactive frame selects a cell subset, and refining to
    completion matches the equally culled EXPORT frame
    (tests/test_presorted.py)."""
    vis = _port(30000, with_cells=True)
    sph = vis._sph
    vis.scale = 30.0
    sph.render(DrawReason.CHANGE)
    prog = sph.render_progression
    assert isinstance(prog, RenderProgressionColumns)
    assert prog.get_fraction_volume_selected() < 0.9
    assert prog.get_selected_cell_mask() is not None
    for _ in range(30):
        if not sph.needs_refine():
            break
        sph.render(DrawReason.REFINE)
    _matches_export(sph)


def test_progressive_refinement_converges():
    """A CHANGE draw followed by REFINEs converges to the EXPORT image
    (tests/test_visualizer.py)."""
    vis = _port()
    sph = vis._sph
    sph.render(DrawReason.CHANGE)
    sph.render_progression._recommended = 4000
    sph.render(DrawReason.CHANGE)
    guard = 0
    while sph.needs_refine() and guard < 100:
        sph.render_progression._recommended = 4000
        sph.render(DrawReason.REFINE)
        guard += 1
    refined = sph.get_image()
    sph.invalidate(DrawReason.CHANGE)
    sph.render(DrawReason.EXPORT)
    np.testing.assert_allclose(refined.mean(), sph.get_image().mean(),
                               rtol=1e-3)


def test_interactive_frame_deferred_timing_via_presentation():
    """Interactive frames run barrier-free: ``render`` leaves a deferred
    measurement pending, the presentation readback resolves it from the
    frame clock, and a caller's own sync can report it instead
    (tests/test_visualizer.py)."""
    vis = topsy_tpu_torch.test(N, render_resolution=48,
                               canvas_class=OffscreenCanvas, device="cpu")
    sph = vis._sph
    sph.render(DrawReason.CHANGE)
    assert sph._pending_timing_prog is not None
    vis.draw(DrawReason.CHANGE)
    assert sph._pending_timing_prog is None
    assert sph.last_render_fps > 0
    assert sph._render_timer.last_duration == pytest.approx(
        sph.frame_clock.seconds())

    sph.render(DrawReason.CHANGE)
    assert sph._pending_timing_prog is not None
    sph.notify_frame_time(0.004)
    assert sph._pending_timing_prog is None
    assert sph._render_timer.last_duration == 0.004
    # an EXPORT frame leaves nothing pending; a stale measurement is dropped
    sph.render(DrawReason.CHANGE)
    sph.render(DrawReason.EXPORT)
    assert sph._pending_timing_prog is None


def test_giant_layer_kept_across_refine():
    """At a zoom where the giant plan is nonempty, the CHANGE frame plans
    the exact giant layer once; REFINE frames keep it (the same tensor),
    and it is never scaled by the partial frame's mass factor."""
    from topsy_tpu_torch.ops import splat_atlas, splat_giant
    vis = _port()
    sph = vis._sph
    vis.scale = 60.0
    levels = splat_atlas.default_pyramid(RES).num_levels
    size, _ = splat_giant.giant_plan(vis.store.giant_meta(), RES, 60.0,
                                     levels)
    assert size > 0
    _quantum_columns(vis, [128, 384])
    sph.render(DrawReason.CHANGE)
    layer = sph._giant_image
    assert layer is not None and float(layer[..., 0].sum()) > 0.0
    ms = sph.last_render_mass_scale
    assert ms > 2.0
    # get_image = (columns + giants / ms) * ms: the giants come out exact
    np.testing.assert_allclose(
        sph.get_image(), (sph._image * ms + layer).numpy(), rtol=1e-5,
        atol=1e-12)
    sph.render(DrawReason.REFINE)
    assert sph._giant_image is layer
    assert sph.last_column_ranges == [(128, 384)]
    _matches_export(sph)


def test_refine_chain_and_prevent_sph_rendering():
    """``draw`` requests a REFINE draw while the progression is incomplete
    (the canvas runs it), and ``prevent_sph_rendering`` composes without
    rendering or requesting one."""
    vis = _port()
    sph = vis._sph
    _quantum_columns(vis, [128, 128, 256])
    vis.canvas._scheduled_draw = None
    vis.draw(DrawReason.CHANGE)
    assert sph.needs_refine() and vis.canvas._scheduled_draw is not None
    with vis.prevent_sph_rendering():
        image = sph._image
        vis.draw(DrawReason.REFINE)
        assert sph._image is image and sph.needs_refine()
    vis.canvas.perform_draw()
    assert not sph.needs_refine()
    assert sph.last_column_ranges == [(256, 256)]
    assert sph.last_render_mass_scale == pytest.approx(1.0)
    assert vis.last_frame.shape == (480, 640, 4)
