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
    through the reference renderer's ``_render_columns_range`` and the
    port's ``_launch_columns`` (added to the frame by ``_deposit``) on the
    same scene: the images at the cross-engine bounds, the dropped counts
    equal."""
    ranges = [(0, 128), (128, 384)]
    im_r, d_r = _ref_ranges(ref_vis, ranges)
    vis = _port()
    sph = vis._sph
    assert sph._maybe_activate_columns(DrawReason.CHANGE)
    matrix = sph._matrix().astype(np.float32)
    scale = np.float32(sph.scale)
    sph._prepare_giants(matrix, scale)
    sph._first_deposit, d_p = True, []
    for c0, n in ranges:
        sph._deposit(*sph._launch_columns(matrix, scale, c0, n))
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


# ---- the frame loop's conventions, frame kind by frame kind -----------------

def _record_blocks(prog):
    """Wrap ``prog.get_block`` on the instance: the list it returns gains
    each block handed out, with the tier it names."""
    seen = []
    get_block = prog.get_block

    def spy(t):
        block = get_block(t)
        if block is not None:
            seen.append((block, getattr(prog, "last_block_tier", None)))
        return block

    prog.get_block = spy
    return seen


def _frame_model(sph, kind, blocks, image, ranges):
    """The frame rebuilt from the module-level deposits the renderer's
    launches go through: (output image, dropped, column ranges, particles
    deposited, mass scale).  ``image`` is the image before the frame (a
    REFINE frame continues it), ``ranges`` the column ranges before it."""
    from topsy_tpu_torch.ops import splat_atlas, splat_giant
    from topsy_tpu_torch.render import surface as p_surface
    from topsy_tpu_torch.render.store import bucket_size
    store, prog = sph._store, sph.render_progression
    surface = isinstance(sph, p_surface.SurfaceSPHRenderer)
    combine = p_surface._max_composite if surface else torch.add
    matrix = sph._matrix().astype(np.float32)
    scale = np.float32(sph.scale)
    cut = np.float32(sph._density_cut_value()) if surface else None
    buf = sph._buffer_name
    selection = prog.get_selected_cell_mask()
    table = store.cell_mask_table(selection)
    columns = isinstance(prog, RenderProgressionColumns)
    if kind != "refine":
        image = None
    dropped, deposited = None, 0

    def deposit(im, d, summed):
        nonlocal image, dropped
        dropped = dropped + d if summed and dropped is not None else d
        image = im if image is None else combine(image, im)

    def feed_mask(tier):
        if selection is None:
            return None
        return table[tier.cell_ids.long()].to(torch.float32).reshape(
            -1, tier.layout.pad_group)

    layer, bucket = None, None
    if columns or (kind == "export" and not surface):
        levels = splat_atlas.default_pyramid(RES).num_levels
        size, bucket = splat_giant.giant_plan(
            store.giant_meta(), RES, float(sph.scale), levels)
        if size:
            cand = store.giant_candidates(size)
            args = (cand["pos"], store.giant_values_for(buf, size),
                    cand["buckets"], cand["cell_ids"], table, matrix, scale)
            layer = (p_surface._render_giant_layer_surface(
                *args, cut, resolution=RES) if surface else
                p_sph._render_giant_layer(*args, resolution=RES,
                                          depth_channel=False))
    if kind == "export" and not surface:
        tier = store.main_tier
        for piece in sph.pieces():
            deposit(*splat_atlas.splat_atlas_fields(
                tier.fields(), tier.values_cm_for(buf), matrix, RES, scale,
                tier.group_buckets, mask=feed_mask(tier),
                depth_channel=False, piece=piece, giants=bucket), False)
        deposited = store.n
    else:
        ranges = []
        mips = store.ensure_column_mips() if columns else []
        for (starts, lens), ti in blocks:
            for s, n in zip(starts, lens):
                if n <= 0:
                    continue
                if not columns:
                    deposited += n
                    b = bucket_size(n, store.n_pad)
                    for p in range(0, n, b):
                        flat = (store.flat_pos_smooth,
                                store.flat_values_for(buf),
                                store.flat_cell_ids, table, matrix, scale)
                        kw = dict(resolution=RES, bucket=b)
                        if surface:
                            deposit(p_surface._render_block_surface(
                                *flat, cut, s + p, min(b, n - p), **kw),
                                None, False)
                        else:
                            deposit(*p_sph._render_block(
                                *flat, s + p, min(b, n - p), **kw,
                                depth_channel=False, backend="atlas"), False)
                    continue
                tier = mips[ti] if ti < len(mips) else store.main_tier
                ranges.append((s, n))
                deposited += int(tier.layout.real_per_column[s:s + n].sum())
                if surface:
                    culled = selection is not None
                    deposit(*p_surface._render_block_columns_surface(
                        tier.pos_smooth, tier.values_for(buf), tier.buckets,
                        tier.cell_ids if culled else None,
                        table if culled else None, matrix, scale, cut, s,
                        int(bucket), resolution=RES, width=n,
                        pad_group=tier.layout.pad_group), True)
                else:
                    deposit(*p_sph._render_block_columns_fields(
                        tier.fields(), tier.values_cm_for(buf),
                        tier.group_buckets, feed_mask(tier), matrix, scale,
                        s, int(bucket), resolution=RES, width=n,
                        depth_channel=False), True)
    mass_scale = 1.0 if surface else prog._total / prog._start_index
    if layer is not None:
        image = (combine(image, layer) if surface
                 else image + layer * (1.0 / mass_scale))
    return (image, 0 if dropped is None else int(dropped), ranges,
            deposited, mass_scale)


@pytest.mark.parametrize("kind", ["export", "change", "refine",
                                  "block_change", "no_cell"])
@pytest.mark.parametrize("mode", ["univariate", "surface"])
def test_frame_loop_conventions(mode, kind, monkeypatch):
    """Each kind of frame of both render loops against the frame rebuilt
    from the module-level deposits (``_frame_model``): the output image;
    ``last_dropped_splats`` and its type (the last piece or block of an
    EXPORT or block-path frame, the sum over a column frame's launches);
    ``last_column_ranges`` (an additive EXPORT frame leaves the previous
    frame's); the ``particles_deposited`` delta; ``last_render_mass_scale``
    (1 for the surface).  A REFINE frame continues a partial CHANGE frame;
    ``block_change`` is a CHANGE frame of a fresh Visualizer with
    ``INTERACTIVE_USE_PRESORTED`` off; ``no_cell`` a CHANGE frame whose
    view selects no cell.  Each runs zoomed out, where the giant layer
    runs, and zoomed in, where launches drop splats."""
    from topsy_tpu_torch.ops import splat_atlas
    from topsy_tpu_torch.performance import counters
    from topsy_tpu_torch.render import store as p_store
    # spill budgets small enough that launches drop splats, and several
    # launches a frame: EXPORT pieces, EXPORT column blocks, bucket pieces
    monkeypatch.setattr(config, "SPLAT_SPILL_GROUP_CAP", 1)
    monkeypatch.setattr(splat_atlas, "T3_CAP", 1)
    monkeypatch.setattr(splat_atlas, "COLUMN_SPILL_GROUP_CAP", 1)
    monkeypatch.setattr(splat_atlas, "COLUMN_T3_CAP", 1)
    monkeypatch.setattr(config, "SPLAT_FEED_LAUNCH_CAP", 4096)
    monkeypatch.setattr(config, "MAX_PARTICLES_PER_EXPORT_RENDERCALL", 8000)
    monkeypatch.setattr(p_store, "MAX_BUCKET", 4096)
    if kind == "block_change":
        monkeypatch.setattr(config, "INTERACTIVE_USE_PRESORTED", False)
        monkeypatch.setattr(config, "INITIAL_PARTICLES_TO_RENDER", 6000)
    for scale in (60.0, 5.0):
        vis = _port(with_cells=kind == "no_cell")
        if mode == "surface":
            vis.render_mode = "surface"
            vis._sph.set_density_cut_percentile(0.0)  # giants are diffuse
        sph = vis._sph
        sph.scale = scale
        if kind == "refine":
            _quantum_columns(vis, [128, 384])
            sph.render(DrawReason.CHANGE)
            assert sph.needs_refine()
        elif kind != "block_change":
            sph.render(DrawReason.CHANGE)
            assert isinstance(sph.render_progression,
                              RenderProgressionColumns)
            sph.rotation_matrix = np.array(
                [[0.0, 0.0, 1.0], [0.0, 1.0, 0.0], [-1.0, 0.0, 0.0]]
            ) @ np.asarray(sph.rotation_matrix)
        if kind == "no_cell":
            sph.position_offset = np.full(3, 1e4)
        reason = {"export": DrawReason.EXPORT,
                  "refine": DrawReason.REFINE}.get(kind, DrawReason.CHANGE)
        blocks = _record_blocks(sph.render_progression)
        before = None if sph._image is None else sph._image.clone()
        ranges_before = list(sph.last_column_ranges)
        n0 = counters["particles_deposited"]
        sph.render(reason)
        if kind == "no_cell":
            assert not sph.render_progression.get_selected_cell_mask().any()
        want, dropped, ranges, deposited, mass_scale = _frame_model(
            sph, kind, blocks, before, ranges_before)
        got = sph.get_output_image()
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-6 * float(want.abs().max()))
        assert type(sph.last_dropped_splats) is int
        assert sph.last_dropped_splats == dropped
        assert sph.last_column_ranges == ranges
        assert counters["particles_deposited"] - n0 == deposited
        assert sph.last_render_mass_scale == pytest.approx(mass_scale,
                                                           rel=1e-12)
