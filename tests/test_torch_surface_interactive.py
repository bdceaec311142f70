"""The port's interactive surface (CHANGE and REFINE frames of the surface
mode over the host presort) against topsy_tpu's on the same scene, and the
port against the original topsy's committed surface pixels.

With the host presort a CHANGE frame renders every column in one launch.
The tests that continue a frame install a columns progression that hands
out given column widths one frame at a time (``_quantum``, for either
package), so that REFINE frames render real partial ranges (256 columns
and the other 256) through each renderer's own render loop.  Both packages
render the same host presort.

Tolerances: the raw (value, depth) images at the EXPORT bounds of
tests/test_torch_surface.py (coverage equal, depth rtol 1e-5 / atol 1e-4,
winner values rtol 1e-5 / atol 1e-6) with equal ``last_dropped_splats``
(the port sums the frame's launches; with one launch per frame that is the
reference's count); the committed pixels at the bounds of
tests/test_reference_parity.py."""

import os
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

import topsy_tpu_torch
import topsy_tpu_torch.render.sph
from topsy_tpu.drawreason import DrawReason as RefReason
from topsy_tpu.progression import RenderProgressionColumns as RefColumns
from topsy_tpu_torch.canvas import OffscreenCanvas
from topsy_tpu_torch.drawreason import DrawReason
from topsy_tpu_torch.progression import RenderProgressionColumns

# one process's share of the cores when pytest-xdist runs several workers
# (torch's default, every core in each process, oversubscribes them)
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

EXPECTED = np.load(Path(__file__).parent / "data" / "reference_expected.npz")
N, RES = 20000, 96


def _quantum(sph, real_per_column, widths):
    """Install on the renderer ``sph`` a columns progression (of its own
    package) whose interactive frames each render the next of ``widths``
    columns."""
    base = (RenderProgressionColumns
            if isinstance(sph, topsy_tpu_torch.render.sph.SPHRenderer)
            else RefColumns)

    class Quantum(base):
        def __init__(self):
            super().__init__(real_per_column, mip_tiers=[],
                             cell_layout=getattr(sph.render_progression,
                                                 "cell_layout", None))
            self._widths = list(widths)

        def _block_for_logical_range(self, start, length):
            cum = self._tiers[0]["cum"]
            c0 = int(np.searchsorted(cum, start, side="right")) - 1
            c1 = min(c0 + self._widths.pop(0), len(cum) - 1)
            self._last_block_len = int(cum[c1] - cum[c0])
            self._last_block_tier = 0
            return [c0], [c1 - c0]

    sph._render_progression = Quantum()


def _port_quantum(vis, widths):
    _quantum(vis._sph, vis.store.presorted_layout.real_per_column, widths)


def _surface(v):
    v.show_status = False
    v.show_colorbar = False
    v.render_mode = "surface"
    v.quantity_name = "test-quantity"
    return v


@pytest.fixture(scope="module")
def port():
    """The port's surface Visualizer on the host presort, as ``ref``: its
    store falls back to it when its device build returns None."""
    import topsy_tpu_torch.ops.morton_device as md
    with mock.patch.object(md, "build_presorted_device", lambda *a, **k: None):
        v = _surface(topsy_tpu_torch.test(N, render_resolution=RES,
                                          canvas_class=OffscreenCanvas,
                                          device="cpu"))
        v.store.ensure_presorted()
    assert type(v.store.presorted_layout).__name__ == "PresortedLayout"
    return v


@pytest.fixture(scope="module")
def ref():
    """The reference's surface renderer over the same snapshot, built
    without a Visualizer (which would first render a full-width EXPORT
    frame, one more interpreted kernel compile), on the host presort, as
    ``port``: the two device presorts shuffle each group with other random
    bits, so their column slices would hold other particles."""
    import topsy_tpu.ops.morton_device as md
    from topsy_tpu.loaders import TestDataLoader
    from topsy_tpu.render.store import ParticleStore
    from topsy_tpu.render.surface import SurfaceSPHRenderer
    loader = TestDataLoader(N)
    store = ParticleStore(loader)
    store.quantity_name = "test-quantity"
    with mock.patch.object(md, "build_presorted_device", lambda *a, **k: None):
        store.ensure_presorted()
    assert type(store.presorted_layout).__name__ == "PresortedLayout"
    sph = SurfaceSPHRenderer(store, loader.get_render_progression(), RES)
    sph.position_offset = -loader.get_initial_center()
    return sph


def _export_bounds(a, b):
    cov = b[..., 1] > 0
    assert ((a[..., 1] > 0) == cov).all()
    assert cov.mean() > 0.005
    np.testing.assert_allclose(a[..., 1][cov], b[..., 1][cov], rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(a[..., 0][cov], b[..., 0][cov], rtol=1e-5,
                               atol=1e-6)


def test_change_frame_is_the_export_frame(port):
    """With one tier a CHANGE frame renders every column in one launch,
    with the caps of EXPORT's launch: the same image, bit for bit."""
    sph = port._sph
    sph.invalidate()
    sph.render(DrawReason.EXPORT)
    export = sph.get_output_image().clone()
    port.rotate(0.0, 0.0)
    sph.render(DrawReason.CHANGE)
    assert isinstance(sph.render_progression, RenderProgressionColumns)
    assert len(sph.last_column_ranges) == 1
    assert not sph.needs_refine()
    assert sph.last_render_mass_scale == 1.0
    assert torch.equal(sph.get_output_image(), export)


@pytest.mark.parametrize("scale", [None, 60.0], ids=["default", "zoomed"])
def test_interactive_frames_match_reference(port, ref, scale):
    """A CHANGE frame of 256 columns and a REFINE frame of the other 256
    through both renderers' render loops, at the default view and zoomed
    out until the giant layer runs: each frame's image and dropped count,
    the column ranges, the refine requests."""
    port.reset_view()
    if scale is not None:
        port.scale = scale
    ref.rotation_matrix = port.rotation_matrix
    ref.position_offset = port.position_offset
    ref.scale = port.scale
    _port_quantum(port, [256, 256])
    _quantum(ref, ref._store.presorted_layout.real_per_column, [256, 256])
    for (rp, rr), expect in zip(
            [(DrawReason.CHANGE, RefReason.CHANGE),
             (DrawReason.REFINE, RefReason.REFINE)], [(0, 256), (256, 256)]):
        port._sph.render(rp)
        ref.render(rr)
        assert port._sph.last_column_ranges == [expect]
        if scale is not None:
            assert port._sph._giant_image is not None
        _export_bounds(port._sph.get_image(), np.asarray(ref.get_image()))
        assert port._sph.last_dropped_splats == ref.last_dropped_splats
        assert port._sph.needs_refine() == ref.needs_refine()
        assert port._sph.last_render_mass_scale == 1.0
    assert not port._sph.needs_refine()


def test_giant_layer_kept_across_refine():
    """Zoomed out until the giant plan holds candidates: the CHANGE frame
    plans the surface giant layer once, REFINE frames keep it and composite
    it again (max is idempotent)."""
    from topsy_tpu_torch.ops import splat_atlas, splat_giant
    from topsy_tpu_torch.render.surface import _max_composite
    v = _surface(topsy_tpu_torch.test(N, render_resolution=RES,
                                      canvas_class=OffscreenCanvas,
                                      device="cpu"))
    v.scale = 60.0
    levels = splat_atlas.default_pyramid(RES).num_levels
    size, _ = splat_giant.giant_plan(v.store.giant_meta(), RES, 60.0, levels)
    assert size > 0
    sph = v._sph
    sph.set_density_cut_percentile(0.0)      # giants are diffuse
    _port_quantum(v, [128, 384])
    sph.render(DrawReason.CHANGE)
    layer, bucket = sph._giant_image, sph._giant_bucket
    assert layer is not None and (layer[..., 1] > 0).any()
    image = sph.get_output_image()
    assert torch.equal(_max_composite(image, layer), image)
    sph.render(DrawReason.REFINE)
    assert sph._giant_image is layer and sph._giant_bucket == bucket
    assert sph.last_column_ranges == [(128, 384)]
    assert not sph.needs_refine()


def test_refine_chain_and_deferred_timing(monkeypatch):
    """A surface CHANGE draw leaves a deferred measurement that the
    presentation resolves, requests REFINE draws while incomplete, and the
    canvas runs them to completion; a frame without the columns
    progression renders the scatter fallback: no column range, a barrier
    after every block, its time recorded."""
    v = _surface(topsy_tpu_torch.test(N, render_resolution=48,
                                      canvas_class=OffscreenCanvas,
                                      device="cpu"))
    sph = v._sph
    sph.render(DrawReason.CHANGE)
    assert sph._pending_timing_prog is not None
    _port_quantum(v, [128, 128, 256])
    v.canvas._scheduled_draw = None
    frame = v.draw(DrawReason.CHANGE)
    assert frame.shape == (480, 640, 4) and frame.dtype == np.uint8
    assert sph._pending_timing_prog is None and sph.last_render_fps > 0
    assert sph.needs_refine() and v.canvas._scheduled_draw is not None
    v.canvas.perform_draw()
    assert not sph.needs_refine()
    assert sph.last_column_ranges == [(256, 256)]
    monkeypatch.setattr(topsy_tpu_torch.config, "INTERACTIVE_USE_PRESORTED",
                        False)
    fresh = type(sph)(v.store, v.data_loader.get_render_progression(), 48)
    fresh.position_offset, fresh.scale = sph.position_offset, sph.scale
    fresh.render(DrawReason.CHANGE)
    assert not fresh.last_column_ranges and fresh._pending_timing_prog is None
    assert fresh._render_timer.last_duration > 0.0
    assert fresh._giant_image is None
    assert (fresh.get_image()[..., 1] > 0).any()


# ---- against the original topsy's committed pixels ---------------------------

@pytest.fixture(scope="module")
def surface_vis():
    """The reference's surface scene (test_render_output.py:451-456),
    rendered once and shared by the raw and presentation surface tests."""
    v = topsy_tpu_torch.test(int(1e5), render_resolution=200,
                             canvas_class=None, render_mode="surface",
                             device="cpu")
    v.quantity_name = "test-quantity"
    v.scale = 30.0
    v.rotate(0.0, 1.0)
    v.render_sph(DrawReason.EXPORT)
    return v


def test_surface_vs_reference(surface_vis):
    """reference: tests/test_render_output.py:451-518 (test_surface_render),
    at the bounds of tests/test_reference_parity.py::test_surface_vs_reference
    (its docstring explains them)."""
    result = np.asarray(surface_vis.get_sph_image())
    assert result.shape == (200, 200, 2)
    depth = result[::20, ::20, 1].ravel()
    qty = result[::20, ::20, 0].ravel()
    expect_depth = EXPECTED["test_surface_render.depth_expectation"]
    expect_qty = EXPECTED["test_surface_render.quantity_expectation"]
    covered = expect_depth > 0
    ours_covered = depth > 0
    flipped = covered != ours_covered
    assert flipped.sum() <= 1, \
        f"coverage flips at sampled pixels {np.flatnonzero(flipped)}"

    both = covered & ours_covered
    idx = np.flatnonzero(both)
    rel = (np.abs(depth[both] - expect_depth[both])
           / np.maximum(np.abs(expect_depth[both]), 1e-9))
    DEPTH_AVOID = {33}
    avoid = np.isin(idx, list(DEPTH_AVOID))
    assert rel[avoid].max() < 4.4e-2 if avoid.any() else True
    assert rel[~avoid].max() < 3.3e-2, \
        f"depth off at {idx[~avoid][rel[~avoid] >= 3.3e-2]}: " \
        f"{depth[both][~avoid][rel[~avoid] >= 3.3e-2]}"
    assert (rel < 2e-2).mean() >= 0.85

    QTY_AVOID = {35, 43, 45, 47, 66, 67, 74}
    qavoid = np.isin(idx, list(QTY_AVOID))
    ok_qty = np.isclose(qty[both], expect_qty[both], rtol=1e-3, atol=1e-7)
    assert (~ok_qty[~qavoid]).sum() <= 1, \
        f"winner flips outside the known set at {idx[~qavoid][~ok_qty[~qavoid]]}"
    assert ok_qty.mean() >= 0.70, \
        f"winner quantities match at only {ok_qty.sum()}/{both.sum()}"


def test_surface_presentation_vs_reference(surface_vis):
    """reference: tests/test_render_output.py:521-556, at the bounds of
    tests/test_reference_parity.py::test_surface_presentation_vs_reference."""
    pres = np.asarray(surface_vis.get_sph_presentation_image())
    assert pres.shape == (200, 200, 4)
    expect = EXPECTED["test_surface_render.presentation_expectation"]
    got = pres[::20, ::20].ravel().astype(np.int32)
    err = np.abs(got - expect.astype(np.int32))
    assert (err > 30).sum() <= 10, \
        f"{(err > 30).sum()}/400 elements beyond the reference's atol=30"
    assert err.max() <= 100


# ---- K3 on the interactive launches' narrow slices, on the card ---------------

@pytest.mark.cuda
@pytest.mark.parametrize("col0,width", [(0, 64), (64, 192), (0, 512)],
                         ids=["w64", "w192", "w512"])
def test_k3_on_column_slices_on_card(col0, width):
    """Every K3 call of a surface column launch (groups of the slice width,
    padded to ``column_pad_multiple``) bit-identical to the plain version
    from the same atlas, and the card's plan equal to ``deposit_plan``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from topsy_tpu_torch.ops import zsplat_accum, zsplat_atlas
    from topsy_tpu_torch.render.surface import surface_column_launches
    v = _surface(topsy_tpu_torch.test(50000, render_resolution=256,
                                      canvas_class=OffscreenCanvas,
                                      device="cuda"))
    sph, store = v._sph, v.store
    sph.set_density_cut_percentile(0.0)
    sph.render(DrawReason.CHANGE)
    ps, vals, bks, _, chunks, kw = surface_column_launches(
        store.pos_smooth_presorted, store.presorted_values_for(
            sph._buffer_name), store.presorted_buckets, None, None, col0,
        width, store.presorted_layout.pad_group)
    active = 0
    for sl in chunks:
        main, tier2, tier3, _, shape = zsplat_atlas.deposit_calls(
            ps[sl], vals[sl], sph._matrix().astype(np.float32), 256,
            np.float32(sph.scale), bks[sl],
            density_cut=np.float32(sph._density_cut_value()),
            giants=int(sph._giant_bucket), **kw)
        assert main["group"] == (width if width < 512 else main["group"])
        keys_k = keys_p = zsplat_accum.pack_atlas(
            torch.zeros(shape, device="cuda"))
        for call in (main, tier2, tier3):
            keys_k = keys_k.clone()
            keys_p = keys_p.clone()
            zsplat_accum.accumulate_max_packed_cuda(keys_k, **call)
            zsplat_accum.accumulate_max_packed_plain(keys_p, **call)
            assert torch.equal(keys_k, keys_p)
            win = call.get("window_cols", zsplat_accum.WINDOW_COLS)
            rolled = win == zsplat_accum.WINDOW_COLS
            plan_k = zsplat_accum.deposit_plan_cuda(call["flags"], rolled)
            plan_p = zsplat_accum.deposit_plan(call["flags"], rolled)
            assert all(torch.equal(a, b) for a, b in zip(plan_k, plan_p))
            active += int((call["flags"] // 4
                           == zsplat_accum.FLAG_ACTIVE).sum())
    assert active > 0
