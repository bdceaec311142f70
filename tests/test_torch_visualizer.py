"""The whole slice: topsy_tpu_torch.test(...) through the presorted EXPORT
path (its second EXPORT: the constructor's first takes the sorted block
path by the lazy policy), against the committed golden render and against
the reference visualizer's own presorted feed path.

Tolerances: the golden values use tests/test_golden.py's; the image
against the reference uses the cross-engine bounds of
tests/test_splat_fields.py:75-78 (sum rel 1e-3, max pixel difference
<= 1% of the maximum, correlation > 0.9999); the uint8 presentation images
differ by at most 2 levels at 99.9% of pixels."""

import os

import numpy as np
import pytest
import torch

import topsy_tpu
import topsy_tpu_torch
from topsy_tpu.canvas import OffscreenCanvas as RefCanvas
from topsy_tpu_torch.canvas import OffscreenCanvas
from topsy_tpu_torch.drawreason import DrawReason

# one process's share of the cores when pytest-xdist runs several workers
# (torch's default, every core in each process, oversubscribes them)
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

GOLDEN = os.path.join(os.path.dirname(__file__), "golden_render.npz")
N, RES = 20000, 128


@pytest.fixture(scope="module")
def port():
    v = topsy_tpu_torch.test(N, render_resolution=RES,
                             canvas_class=OffscreenCanvas, device="cpu")
    v.show_status = False
    # the constructor's first export took the sorted path (the lazy
    # policy, as ``ref``'s): the next one presorts
    assert v.store.presorted_layout is None
    v._sph.invalidate()
    return v


@pytest.fixture(scope="module")
def ref():
    v = topsy_tpu.test(N, render_resolution=RES, canvas_class=RefCanvas)
    v.show_status = False
    np.asarray(v.get_sph_image())      # first export: the sorted path
    v._sph.invalidate()
    v._sph._force_feed = True          # presorted feed path, interpreted
    return v


def _cross_engine(a, b):
    a = np.nan_to_num(a)
    b = np.nan_to_num(b)
    assert a.sum() == pytest.approx(b.sum(), rel=1e-3)
    assert np.abs(a - b).max() <= 0.01 * np.abs(b).max()
    assert np.corrcoef(a.ravel(), b.ravel())[0, 1] > 0.9999


def _levels_agree(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    d = np.abs(a.astype(int) - b.astype(int)).max(axis=-1)
    assert np.mean(d <= 2) >= 0.999


def test_density_matches_golden(port):
    golden = np.load(GOLDEN)["density"]
    im = port.get_sph_image()[::16, ::16]
    np.testing.assert_allclose(im, golden, rtol=2e-2,
                               atol=2e-4 * np.abs(golden).max())


def test_density_and_presentation_match_reference(port, ref):
    _cross_engine(port.get_sph_image(), ref.get_sph_image())
    for v in (port, ref):
        v.colormap_autorange()
    _levels_agree(port.get_sph_presentation_image(),
                  np.asarray(ref.get_sph_presentation_image()))
    assert port._sph.last_dropped_splats == ref._sph.last_dropped_splats


def test_quantity_matches_golden_and_reference(port, ref):
    golden = np.load(GOLDEN)["quantity"]
    port.quantity_name = "test-quantity"
    ref.quantity_name = "test-quantity"
    im = port.get_sph_image()
    np.testing.assert_allclose(np.nan_to_num(im[::16, ::16]), golden,
                               rtol=5e-2, atol=5e-7)
    raw_p = port._sph.get_image()
    raw_r = ref._sph.get_image()
    for c in range(2):
        _cross_engine(raw_p[..., c], raw_r[..., c])
    for v in (port, ref):
        v.colormap_autorange()
    _levels_agree(port.get_sph_presentation_image(),
                  np.asarray(ref.get_sph_presentation_image()))


def test_draw_export_frame(port):
    port.show_colorbar = True
    frame = port.draw(DrawReason.EXPORT, target=(160, 120))
    assert frame.shape == (120, 160, 4) and frame.dtype == np.uint8
    assert port.canvas.last_frame is frame
    assert frame[..., :3].std() > 0
    pres = port.get_presentation_image((200, 100))
    assert pres.shape == (100, 200, 4)


def test_piece_loop_covers_every_group(port, monkeypatch):
    """Under a cut launch cap the renderer's pieces tile the groups in
    order and their images sum to the one-launch image (cross-engine
    bounds)."""
    sph = port._sph
    G = port.store.presorted_layout.pad_group
    ng = port.store.n_presorted // G
    assert sph.pieces() == [None]
    sph.invalidate()
    whole = sph.get_image()
    monkeypatch.setattr(topsy_tpu_torch.config, "SPLAT_FEED_LAUNCH_CAP",
                        8 * G)
    pieces = sph.pieces()
    assert len(pieces) >= 2 and pieces[0] == (0, 8)
    assert all(a[0] + a[1] == b[0] for a, b in zip(pieces, pieces[1:]))
    assert pieces[-1][0] + pieces[-1][1] == ng
    sph.invalidate()
    split = sph.get_image()
    sph.invalidate()
    for c in range(2):
        _cross_engine(split[..., c], whole[..., c])


def test_load_entry_point_and_device_default():
    v = topsy_tpu_torch.load("test://3000", resolution=64, device="cpu",
                             canvas_class=OffscreenCanvas)
    assert v.get_sph_image().shape == (64, 64)
    assert v.scale == v.data_loader.get_initial_view_width()
    import torch
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            topsy_tpu_torch.test(1000, render_resolution=32)


def test_non_export_reasons(port):
    """PRESENTATION_CHANGE renders nothing; a univariate CHANGE and a
    surface CHANGE each render an interactive column frame."""
    port.render_sph(DrawReason.PRESENTATION_CHANGE)   # a no-op
    v = topsy_tpu_torch.test(3000, render_resolution=64, device="cpu",
                             canvas_class=OffscreenCanvas)
    v.render_sph(DrawReason.CHANGE)
    assert v._sph.last_column_ranges and not v._sph.needs_refine()
    assert np.isfinite(v._sph.get_image()).all()
    v.render_mode = "surface"
    v.render_sph(DrawReason.CHANGE)
    assert v._sph.last_column_ranges and not v._sph.needs_refine()
    assert np.isfinite(v._sph.get_image()).all()
