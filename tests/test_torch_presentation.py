"""The presented frame: made on the device when nothing composites on the
host, by the float path otherwise (``Visualizer._compose_presentation``).

The device path's uint8 frame must equal, byte for byte, what the float
path's host passes (``_composite_overlays`` with no overlay) make of the
same float32 RGBA: on random values, on every level's rounding boundary
and its float32 neighbours, on 0, 1 and the infinities, and on the
non-contiguous view a non-square window's fit returns.  The path is
chosen by what would composite; each presented frame is counted in
``performance.counters`` as ``present_device_frames`` or
``present_host_frames``."""

import os
import re

import numpy as np
import pytest
import torch

import topsy_tpu_torch
from topsy_tpu_torch import performance
from topsy_tpu_torch import visualizer as vis_module
from topsy_tpu_torch.canvas import OffscreenCanvas
from topsy_tpu_torch.color.maps import fit_to_window
from topsy_tpu_torch.drawreason import DrawReason
from topsy_tpu_torch.visualizer import quantize_rgba8, quantize_rgba8_host

# one process's share of the cores when pytest-xdist runs several workers
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

W, H = 96, 40
WINDOW = (200, 150)         # room for the status line's raster
STATUS = re.compile(r"^\$\d+\$ fps( /\d+\.\d+ds)?( /\d+\.\d+gf)?$")
VALUE_SETS = ["random", "boundaries", "specials", "fit"]


def _values(name: str) -> np.ndarray:
    """A float32 RGBA of one value set: (H, W, 4), or for ``fit`` the
    square render that the window's fit crops and resizes."""
    rng = np.random.default_rng(17)
    if name == "random":
        return rng.uniform(-0.5, 1.5, (H, W, 4)).astype(np.float32)
    if name == "fit":
        return rng.uniform(-0.5, 1.5, (64, 64, 4)).astype(np.float32)
    if name == "boundaries":
        edges = ((np.arange(257) - 0.5) / 255).astype(np.float32)
        vals = np.concatenate([edges, np.nextafter(edges, np.float32(2)),
                               np.nextafter(edges, np.float32(-2))])
    else:
        vals = np.array([0.0, -0.0, 1.0, np.inf, -np.inf], np.float32)
    return np.resize(vals, (H, W, 4))     # the set repeated to fill it


@pytest.fixture(scope="module")
def base():
    return topsy_tpu_torch.test(2000, render_resolution=32, device="cpu",
                                canvas_class=OffscreenCanvas)


@pytest.fixture
def vis(base, monkeypatch):
    """The Visualizer with nothing to composite, in univariate mode, its
    EXPORT image rendered."""
    if base.render_mode != "univariate":
        base.render_mode = "univariate"
    base.crosshairs_visible = False
    base._periodic_tiling = False
    base.show_colorbar = base.show_scalebar = base.show_status = False
    base.__dict__.pop("_override_status_text_until", None)
    base.render_sph(DrawReason.EXPORT)
    monkeypatch.setattr(vis_module, "text_overlays_available", lambda: True)
    return base


def _float_path_frame(v, width, height) -> np.ndarray:
    """The presented frame as the float path makes it: the fit RGBA read
    back as float32 and handed to the host's passes."""
    rgba = fit_to_window(v._colormap.to_rgba(v._sph.get_output_image(),
                                             v._sph.last_render_mass_scale),
                         width, height)
    return v._composite_overlays(rgba.cpu().numpy(), v._active_overlays())


def _opaque_host_levels(rgba: np.ndarray) -> np.ndarray:
    """``quantize_rgba8_host`` of the RGBA with alpha set to 1."""
    rgba = rgba.copy()
    rgba[..., 3] = 1.0
    return quantize_rgba8_host(rgba)


def _counted_draw(v, reason=DrawReason.PRESENTATION_CHANGE, target=(W, H)):
    c = performance.counters
    before = (c["present_device_frames"], c["present_host_frames"])
    frame = v.draw(reason, target=target)
    return frame, (c["present_device_frames"] - before[0],
                   c["present_host_frames"] - before[1])


@pytest.mark.parametrize("values", VALUE_SETS)
def test_device_frame_equals_host_passes(vis, monkeypatch, values):
    """The device path's frame, through ``_compose_presentation``, equals
    the host passes' bytes: C-contiguous uint8, alpha 255; and the two
    quantisation helpers agree on the same values made opaque."""
    arr = _values(values)
    fitted = (fit_to_window(torch.from_numpy(arr), W, H)
              if values == "fit" else torch.from_numpy(arr.copy()))
    if values == "fit":
        assert not fitted.is_contiguous()
    expect = vis._composite_overlays(fitted.numpy(), [])
    monkeypatch.setattr(vis._colormap, "to_rgba",
                        lambda *a: torch.from_numpy(arr.copy()))
    if values != "fit":
        monkeypatch.setattr(vis_module, "fit_to_window", lambda r, w, h: r)
    frame, counts = _counted_draw(vis)
    assert counts == (1, 0)
    assert frame.dtype == np.uint8 and frame.shape == (H, W, 4)
    assert frame.flags["C_CONTIGUOUS"]
    assert (frame[..., 3] == 255).all()
    np.testing.assert_array_equal(frame, expect)
    np.testing.assert_array_equal(quantize_rgba8(fitted).numpy(),
                                  _opaque_host_levels(fitted.numpy()))


@pytest.mark.cuda
@pytest.mark.parametrize("values", VALUE_SETS)
def test_device_quantisation_on_card(values):
    """The card's clamp, scale, offset, uint8 conversion and alpha give
    the host helper's bytes of the opaque image."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    t = torch.from_numpy(_values(values)).cuda()
    if values == "fit":
        t = fit_to_window(t, W, H)
    got = quantize_rgba8(t)
    assert got.is_cuda and got.is_contiguous() and got.dtype == torch.uint8
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  _opaque_host_levels(t.cpu().numpy()))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["univariate", "surface"])
def test_device_frame_on_card(mode):
    """A real frame on the card, EXPORT and CHANGE, at a non-square
    window: the device path's bytes are the float path's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    v = topsy_tpu_torch.test(50000, render_resolution=256, device="cuda",
                             canvas_class=OffscreenCanvas, render_mode=mode)
    v.show_colorbar = v.show_scalebar = v.show_status = False
    for reason in (DrawReason.EXPORT, DrawReason.CHANGE):
        v.rotate(0.3, 0.1)
        frame, counts = _counted_draw(v, reason, target=(320, 200))
        assert counts == (1, 0) and frame.flags["C_CONTIGUOUS"]
        np.testing.assert_array_equal(frame,
                                      _float_path_frame(v, 320, 200))


def _set_overlay(v, which, monkeypatch):
    if which == "crosshairs":
        v.crosshairs_visible = True
    elif which == "periodic":
        # the test loader has no box: give it one, so the wireframe draws
        monkeypatch.setattr(v, "periodicity_scale", 100.0)
        v._periodic_tiling = True
    elif which == "rgba16float":
        v.render_mode = "rgb-hdr"
        v.render_sph(DrawReason.EXPORT)
    elif which == "status":
        # a fixed text, so that both frames draw the same raster
        v.show_status = True
        v.display_status("fixed", timeout=60.0)
        v._last_status_update = 0.0
    else:
        setattr(v, f"show_{which}", True)


@pytest.mark.parametrize("overlay", ["none", "crosshairs", "periodic",
                                     "rgba16float", "colorbar", "scalebar",
                                     "status"])
def test_path_follows_what_composites(vis, monkeypatch, overlay):
    """Crosshairs, the periodic box, a float16 canvas, or a colorbar,
    scale bar or status line where text overlays draw: the float path,
    its frame as before.  None of them: the device path, the same bytes.
    Each presented frame is counted once, on its path."""
    if overlay != "none":
        _set_overlay(vis, overlay, monkeypatch)
    frame, counts = _counted_draw(vis, target=WINDOW)
    assert counts == ((1, 0) if overlay == "none" else (0, 1))
    expect = _float_path_frame(vis, *WINDOW)
    assert frame.dtype == expect.dtype
    np.testing.assert_array_equal(frame, expect)
    if overlay == "rgba16float":
        assert frame.dtype == np.float16
    elif overlay != "none":             # the overlay drew into the frame
        assert (frame != _float_path_frame_without(vis, overlay)).any()


def _float_path_frame_without(v, overlay):
    flag = {"crosshairs": "crosshairs_visible",
            "periodic": "_periodic_tiling"}.get(overlay, f"show_{overlay}")
    setattr(v, flag, False)
    try:
        return _float_path_frame(v, *WINDOW)
    finally:
        setattr(v, flag, True)


def test_status_without_text_overlays_on_device_path(vis, monkeypatch):
    """The status line shown where no text overlay draws: the device path,
    and the status text still follows the frames and the overrides."""
    monkeypatch.setattr(vis_module, "text_overlays_available",
                        lambda: False)
    vis.show_status = True
    vis._last_status_update = 0.0
    frame, counts = _counted_draw(vis, DrawReason.CHANGE)
    assert counts == (1, 0)
    assert vis._sph.last_render_fps > 0
    assert vis._last_status_update > 0
    assert STATUS.match(vis._status.text), vis._status.text
    np.testing.assert_array_equal(frame, _float_path_frame(vis, W, H))
    vis.display_status("centre = [1.00, 2.00, 3.00]")
    vis._last_status_update = 0.0
    _, counts = _counted_draw(vis)
    assert counts == (1, 0)
    assert vis._status.text == "centre = [1.00, 2.00, 3.00]"
