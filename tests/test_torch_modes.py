"""The port's other render modes against topsy_tpu on the same inputs: the
RGB and RGB-HDR mode (``RGBSPHRenderer``, the ``rgb`` buffer), the depth
pick (``DepthSPHRenderer``, ``get_depth_image``), the bivariate mode, the
three colormaps and their autoranging, the 2-D LUT and its HSV copies,
``lattice_composite`` and ``PeriodicSPHRenderer``, the mode switch with its
capability revert, and the double-click pick; then the port against the
original topsy's committed pixels (tests/data/reference_expected.npz) in
five cases of tests/test_reference_parity.py, at its tolerances.

Tolerances: rendered images per channel at the cross-engine bounds of
tests/test_splat_fields.py:75-78 (sum rel 1e-3, max pixel difference <= 1%
of the maximum, correlation > 0.9999), with equal ``dropped`` where both
renderers take the presorted feed path; uint8 presentations <= 2 levels on
99.9% of pixels, the float16 HDR presentation within 1e-2 + 1e-2 |x| on
99.9% of its entries (as tests/test_torch_visualizer.py); colormaps,
lattice composites and LUTs given equal inputs to float32 rounding (atol
1e-5 / rtol 1e-5); device autoranges, the same histogram algorithm on both
sides, to rtol 1e-5."""

import os
from pathlib import Path

import numpy as np
import numpy.testing as npt
import pytest
import torch

import jax.numpy as jnp

import topsy_tpu
import topsy_tpu_torch
from topsy_tpu.canvas import OffscreenCanvas as RefCanvas
from topsy_tpu.drawreason import DrawReason as RefReason
from topsy_tpu.ops import composite as r_comp
from topsy_tpu_torch.canvas import OffscreenCanvas
from topsy_tpu_torch.color import maps as p_maps
from topsy_tpu_torch.drawreason import DrawReason
from topsy_tpu_torch.ops import composite as p_comp

# one process's share of the cores when pytest-xdist runs several workers
# (torch's default, every core in each process, oversubscribes them)
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

EXPECTED = np.load(Path(__file__).parent / "data" / "reference_expected.npz")
N, RES = 20000, 128


def _r_maps():
    """The reference's colormaps, imported where a test needs them: they
    import matplotlib, and this module's card tests run where matplotlib
    is not installed."""
    from topsy_tpu.color import maps
    return maps


def _port_vis(n=N, res=RES, **kw):
    v = topsy_tpu_torch.test(n, render_resolution=res,
                             canvas_class=kw.pop("canvas_class",
                                                 OffscreenCanvas),
                             device="cpu", **kw)
    v.show_status = False
    v.show_colorbar = False
    return v


def _ref_vis(n=N, res=RES, **kw):
    v = topsy_tpu.test(n, render_resolution=res, canvas_class=RefCanvas, **kw)
    v.show_status = False
    v.show_colorbar = False
    return v


@pytest.fixture(scope="module")
def port():
    return _port_vis()


@pytest.fixture(scope="module")
def ref():
    v = _ref_vis()
    np.asarray(v.get_sph_image())      # first export builds the presort
    return v


def _cross_engine(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert np.isfinite(a).all()
    assert a.sum() == pytest.approx(b.sum(), rel=1e-3)
    assert np.abs(a - b).max() <= 0.01 * np.abs(b).max()
    assert np.corrcoef(a.ravel(), b.ravel())[0, 1] > 0.9999


def _levels_agree(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    d = np.abs(a.astype(int) - b.astype(int)).max(axis=-1)
    assert np.mean(d <= 2) >= 0.999


def _switch(port, ref, mode):
    """Both visualizers to ``mode``, the reference on its presorted feed
    path (the port's), each EXPORT-rendered."""
    port.render_mode = mode
    ref.render_mode = mode
    ref._sph._force_feed = True
    ref._sph.invalidate()
    port._sph.invalidate()
    ref._sph.render(RefReason.EXPORT)
    port._sph.render(DrawReason.EXPORT)


def _same_colormap(port, ref, keys):
    port.colormap.update_parameters(
        {k: ref.colormap.get_parameter(k) for k in keys})


# ---- the additive modes ------------------------------------------------------

def test_rgb_and_hdr_match_reference(port, ref):
    """The three band masses through K1 (C_in 3) and K2 (C 3): each band at
    the cross-engine bounds with equal dropped; the autorange and both
    presentations."""
    _switch(port, ref, "rgb")
    a, b = port._sph.get_image(), np.asarray(ref._sph.get_image())
    assert a.shape == b.shape == (RES, RES, 3)
    for c in range(3):
        _cross_engine(a[..., c], b[..., c])
    assert port._sph.last_dropped_splats == ref._sph.last_dropped_splats
    for k in ("vmin", "vmax"):
        assert port.colormap.get_parameter(k) == pytest.approx(
            ref.colormap.get_parameter(k), abs=0.02)
    _same_colormap(port, ref, ("vmin", "vmax"))
    _levels_agree(port.get_sph_presentation_image(),
                  np.asarray(ref.get_sph_presentation_image()))

    port.render_mode = "rgb-hdr"
    ref.render_mode = "rgb-hdr"
    _same_colormap(port, ref, ("vmin", "vmax"))
    pa = port.get_sph_presentation_image()
    pb = np.asarray(ref.get_sph_presentation_image())
    assert pa.dtype == pb.dtype == np.float16 and pa.shape == (RES, RES, 4)
    pa, pb = pa.astype(np.float32), pb.astype(np.float32)
    assert (pa[..., :3] > 1.0).any()          # unclipped
    assert np.mean(np.abs(pa - pb) <= 1e-2 + 1e-2 * np.abs(pb)) >= 0.999
    frame = port.draw(DrawReason.EXPORT, target=(96, 64))
    assert frame.dtype == np.float16 and frame.shape == (64, 96, 4)


def test_bivariate_matches_reference(port, ref):
    """Density and mass-weighted quantity at the cross-engine bounds, both
    axes' autorange and the 2-D LUT presentation."""
    _switch(port, ref, "bivariate")
    port.quantity_name = "test-quantity"
    ref.quantity_name = "test-quantity"
    ref._sph.render(RefReason.EXPORT)
    port._sph.render(DrawReason.EXPORT)
    a, b = port._sph.get_image(), np.asarray(ref._sph.get_image())
    for c in range(2):
        _cross_engine(a[..., c], b[..., c])
    keys = ("vmin", "vmax", "density_vmin", "density_vmax")
    for k in keys:
        assert port.colormap.get_parameter(k) == pytest.approx(
            ref.colormap.get_parameter(k), rel=0.02, abs=0.02)
    _same_colormap(port, ref, keys + ("log",))
    _levels_agree(port.get_sph_presentation_image(),
                  np.asarray(ref.get_sph_presentation_image()))
    content = port.get_sph_image()
    assert content.shape == (RES, RES, 2)
    port.quantity_name = None
    ref.quantity_name = None


def test_depth_image_matches_reference(port, ref):
    """The depth renderer's (mass, mass * quantity, mass * clip z) image at
    the cross-engine bounds, and the picked depth: NaN exactly where the
    reference's is, and within 1e-3 of the view depth (2 * scale) on the
    pixels holding 1e-3 of the densest pixel's mass."""
    _switch(port, ref, "univariate")
    for v in (port, ref):
        v.scale = 40.0
        v.rotation_matrix = np.array([[1.0, 0.0, 0.0], [0.0, 0.0, 1.0],
                                      [0.0, -1.0, 0.0]], dtype=np.float32)
    d_p = port.get_depth_image(DrawReason.EXPORT)
    d_r = np.asarray(ref.get_depth_image(RefReason.EXPORT))
    raw_p = port._sph._get_depth_renderer().get_image()
    raw_r = np.asarray(ref._sph._get_depth_renderer().get_image())
    assert raw_p.shape == raw_r.shape == (RES, RES, 3)
    for c in (0, 2):
        _cross_engine(raw_p[..., c], raw_r[..., c])
    npt.assert_array_equal(np.isnan(d_p), np.isnan(d_r))
    dense = raw_r[..., 0] > 1e-3 * raw_r[..., 0].max()
    assert dense.mean() > 0.1
    assert np.abs(d_p - d_r)[dense].max() <= 1e-3 * 2 * 40.0
    # the pick's own CHANGE frame (one column launch) gives the same image
    d_c = port.get_depth_image()
    npt.assert_array_equal(np.isnan(d_c), np.isnan(d_p))
    assert np.abs(d_c - d_p)[dense].max() <= 1e-3 * 2 * 40.0
    port.reset_view()
    ref.reset_view()


def test_store_keeps_each_buffer():
    """The converted values stay cached per buffer: an RGB view's depth
    pick (which reads ``mass_and_quantity``) converts neither buffer again;
    a quantity switch drops the superseded versions."""
    v = _port_vis(3000, 48, render_mode="rgb")
    store = v.store
    rgb = store.presorted_values_cm_for("rgb")
    assert rgb.shape[0] == 3
    v.get_depth_image()
    mq = store.presorted_values_cm_for("mass_and_quantity")
    v.get_depth_image()
    assert store.presorted_values_cm_for("rgb") is rgb
    assert store.presorted_values_cm_for("mass_and_quantity") is mq
    store.quantity_name = "test-quantity"
    assert store.presorted_values_cm_for("rgb") is not rgb
    assert len(store._main._values) == 1
    with pytest.raises(KeyError):
        store.values_for("no-such-buffer")


# ---- colormaps ----------------------------------------------------------------

def _raw(channels, seed):
    rng = np.random.RandomState(seed)
    raw = (10 ** rng.normal(-2, 1.5, (48, 40, channels))).astype(np.float32)
    raw[:3] = 0.0                         # empty pixels
    raw[5, :, 1:] *= -1.0                 # negative quantities
    return raw


CMAP_CASES = [
    ("rgb", {"type": "rgb", "hdr": False, "log": True, "vmin": -4.0,
             "vmax": -1.0, "gamma": 1.0}, 3),
    ("rgb-gamma", {"type": "rgb", "hdr": False, "log": True, "vmin": -4.5,
                   "vmax": -0.5, "gamma": 0.6}, 3),
    ("rgb-hdr", {"type": "rgb", "hdr": True, "log": True, "vmin": -3.5,
                 "vmax": -1.5}, 3),
    ("bivariate", {"type": "bivariate", "colormap_name": "twilight_shifted",
                   "vmin": -2.0, "vmax": 1.0, "log": True,
                   "density_vmin": -3.0, "density_vmax": 0.5,
                   "weighted_average": True}, 2),
    ("bivariate-unweighted", {"type": "bivariate", "colormap_name": "viridis",
                              "vmin": -3.0, "vmax": 0.0, "log": True,
                              "density_vmin": -3.0, "density_vmax": 0.0,
                              "weighted_average": False}, 2),
]


@pytest.mark.parametrize("mass_scale", [1.0, 4.0])
@pytest.mark.parametrize("name,params,channels", CMAP_CASES,
                         ids=[c[0] for c in CMAP_CASES])
def test_colormap_matches_reference(name, params, channels, mass_scale):
    raw = _raw(channels, 5)
    p_cls = p_maps.resolve_colormap_class(params)
    r_cls = _r_maps().resolve_colormap_class(params)
    assert p_cls.__name__ == r_cls.__name__
    got = p_cls(dict(params)).to_rgba(torch.from_numpy(raw), mass_scale)
    want = np.asarray(r_cls(dict(params)).to_rgba(raw, mass_scale))
    assert got.shape == want.shape == raw.shape[:2] + (4,)
    npt.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name,params,channels", [
    ("rgb", {"type": "rgb", "hdr": False, "log": True, "vmin": None,
             "vmax": None}, 3),
    ("rgb-hdr", {"type": "rgb", "hdr": True, "log": True, "vmin": None,
                 "vmax": None}, 3),
    ("bivariate", {"type": "bivariate", "weighted_average": True,
                   "vmin": None, "vmax": None, "log": None}, 2),
], ids=["rgb", "rgb-hdr", "bivariate"])
def test_autorange_matches_reference(name, params, channels):
    """Both packages' device autoranges (a 4096-bin histogram percentile)
    on the same image."""
    raw = np.abs(_raw(channels, 6))
    p_cm = p_maps.resolve_colormap_class(params)(dict(params))
    r_cm = _r_maps().resolve_colormap_class(params)(dict(params))
    p_cm.autorange_vmin_vmax(torch.from_numpy(raw))
    r_cm.autorange_vmin_vmax(jnp.asarray(raw))
    keys = ["vmin", "vmax", "min_mag", "max_mag", "log"]
    if name == "bivariate":
        keys += ["density_vmin", "density_vmax"]
        npt.assert_allclose(p_cm.get_parameter("ui_range_density"),
                            r_cm.get_parameter("ui_range_density"), rtol=1e-5)
    for k in keys:
        assert p_cm.get_parameter(k) == pytest.approx(
            r_cm.get_parameter(k), rel=1e-5), k


def test_mag_parametrisation_matches_reference():
    params = {"type": "rgb", "hdr": False, "log": True}
    p_cm = p_maps.RGBColormap(dict(params))
    r_cm = _r_maps().RGBColormap(dict(params))
    for cm in (p_cm, r_cm):
        cm.update_parameters({"min_mag": 20.0, "max_mag": 30.0})
    for k in ("vmin", "vmax", "min_mag", "max_mag"):
        assert p_cm.get_parameter(k) == pytest.approx(r_cm.get_parameter(k))
    assert p_cm.get_parameters()["min_mag"] == pytest.approx(20.0)


def test_sample_lut_2d_matches_reference():
    rng = np.random.RandomState(7)
    lut = rng.uniform(0, 1, (30, 20, 4)).astype(np.float32)
    u = rng.uniform(-0.2, 1.2, (33, 17)).astype(np.float32)
    v = rng.uniform(-0.2, 1.2, (33, 17)).astype(np.float32)
    got = p_maps.sample_lut_2d(torch.from_numpy(u), torch.from_numpy(v),
                               torch.from_numpy(lut))
    want = np.asarray(_r_maps().sample_lut_2d(
        jnp.asarray(u), jnp.asarray(v), jnp.asarray(lut)))
    npt.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["twilight_shifted", "viridis", "gray"])
def test_bivariate_lut_matches_reference(name):
    params = {"type": "bivariate", "colormap_name": name}
    got = p_maps.BivariateColormap(dict(params))._generate_mapping_rgba_f32(
        1000)
    want = _r_maps().BivariateColormap(
        dict(params))._generate_mapping_rgba_f32(1000)
    assert got.shape == want.shape == (1000, 1000, 4)
    npt.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_hsv_copies_match_matplotlib(seed):
    """The numpy copies of matplotlib's HSV conversions, on random colours
    and on greys, primaries and black."""
    import matplotlib
    rng = np.random.RandomState(seed)
    rgb = rng.uniform(0, 1, (64, 9, 3)).astype(np.float32)
    rgb[0, :4] = [[0, 0, 0], [1, 1, 1], [0.5, 0.5, 0.5], [1, 0, 0]]
    rgb[1, :3] = [[0, 1, 0], [0, 0, 1], [1, 1, 0]]
    hsv = p_maps.rgb_to_hsv(rgb)
    npt.assert_array_equal(hsv, matplotlib.colors.rgb_to_hsv(rgb))
    npt.assert_array_equal(p_maps.hsv_to_rgb(hsv),
                           matplotlib.colors.hsv_to_rgb(hsv))
    hsv[2, :3, 1] = 0.0                                    # saturation 0
    npt.assert_array_equal(p_maps.hsv_to_rgb(hsv),
                           matplotlib.colors.hsv_to_rgb(hsv))


def test_missing_colormap_raises(monkeypatch):
    """Without matplotlib a colormap absent from luts.npz raises."""
    import sys

    import matplotlib
    p_maps.lut_rgba.cache_clear()
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    try:
        cm = p_maps.BivariateColormap({"type": "bivariate",
                                       "colormap_name": "no-such-map"})
        with pytest.raises(KeyError):
            cm._generate_mapping_rgba_f32(1000)
        stored = p_maps.lut_rgba("viridis", 1000)
    finally:
        p_maps.lut_rgba.cache_clear()
    npt.assert_allclose(stored, matplotlib.colormaps["viridis"](
        np.linspace(0.001, 0.999, 1000)), atol=1e-6)


# ---- periodic tiling -------------------------------------------------------------

@pytest.mark.parametrize("offsets", [
    [[0.0, 0.0]], [[3.25, -7.5], [-0.4, 0.9]], [[200.0, 1.5], [-64.0, 64.0]],
], ids=["identity", "fractional", "outside"])
def test_lattice_composite_matches_reference(offsets):
    rng = np.random.RandomState(8)
    im = rng.uniform(0, 1, (64, 64, 2)).astype(np.float32)
    off = np.asarray(offsets, np.float32)
    w = rng.uniform(0.2, 1.0, len(off)).astype(np.float32)
    got = p_comp.lattice_composite(torch.from_numpy(im), off, w)
    want = np.asarray(r_comp.lattice_composite(jnp.asarray(im),
                                               jnp.asarray(off),
                                               jnp.asarray(w)))
    npt.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_periodic_matches_reference():
    """A periodic snapshot: the lattice's offsets and weights equal the
    reference's, the tiled image and its bare panel at the cross-engine
    bounds, at two views; interactive frames render through the same
    composite."""
    vp = _port_vis(4000, 64, periodic_tiling=True)
    vr = _ref_vis(4000, 64, periodic_tiling=True)
    np.asarray(vr.get_sph_image())
    vr._sph._force_feed = True
    assert vp.data_loader.get_periodicity_scale() == 100.0
    for rot in (0.0, 0.4):
        for v in (vp, vr):
            v.rotate(0.0, rot)
        vp._sph.render(DrawReason.EXPORT)
        vr._sph.render(RefReason.EXPORT)
        o_p, w_p = vp._sph.instance_offsets_and_weights()
        o_r, w_r = vr._sph.instance_offsets_and_weights()
        npt.assert_allclose(o_p, o_r, rtol=1e-6)
        npt.assert_allclose(w_p, w_r, rtol=1e-6)
        tiled = vp._sph.get_image()
        _cross_engine(tiled[..., 0], np.asarray(vr._sph.get_image())[..., 0])
        _cross_engine(vp._sph._image[..., 0].numpy(),
                      np.asarray(vr._sph._image)[..., 0])
        assert tiled[..., 0].sum() >= 0.99 * vp._sph._image[..., 0].sum().item()
    vp.draw(DrawReason.CHANGE)
    npt.assert_allclose(vp._sph.get_image(), tiled, rtol=1e-5,
                        atol=1e-6 * np.abs(tiled).max())


# ---- the Visualizer -----------------------------------------------------------

class RestrictedFormatCanvas(OffscreenCanvas):
    """A canvas that cannot present HDR (tests/test_visualizer.py)."""

    def supported_formats(self):
        return ("rgba8unorm",)


def test_mode_switch_and_capability_revert():
    """Switching to a mode the canvas cannot present fails and reverts;
    constructing in it raises; an invalid mode leaves the mode as it was
    (tests/test_visualizer.py)."""
    v = _port_vis(2000, 32, canvas_class=RestrictedFormatCanvas)
    assert v.canvas_format == "rgba8unorm"
    with pytest.raises(ValueError, match="cannot present"):
        v.render_mode = "rgb-hdr"
    assert v.render_mode == "univariate"
    assert np.isfinite(v.get_sph_image()).all()
    v.render_mode = "rgb"
    with pytest.raises(ValueError, match="Invalid render_mode"):
        v.render_mode = "not-a-mode"
    assert v.render_mode == "rgb"
    assert v.get_sph_presentation_image().dtype == np.uint8
    with pytest.raises(ValueError, match="cannot present"):
        _port_vis(2000, 32, canvas_class=RestrictedFormatCanvas,
                  render_mode="rgb-hdr")


def test_every_mode_in_every_frame_kind():
    """Every render mode renders EXPORT, CHANGE and REFINE frames, and
    periodic tiling too; no mode raises."""
    v = _port_vis(3000, 48)
    for mode in ("univariate", "bivariate", "rgb", "rgb-hdr", "surface"):
        v.render_mode = mode
        for reason in (DrawReason.EXPORT, DrawReason.CHANGE,
                       DrawReason.REFINE):
            frame = v.draw(reason)
            assert frame.shape == (480, 640, 4)
            assert np.isfinite(frame.astype(np.float32)).all()
            assert frame[..., :3].astype(np.float32).std() > 0, mode
        assert v._sph.last_column_ranges == []          # nothing to refine
    v = _port_vis(3000, 48, periodic_tiling=True)
    for reason in (DrawReason.EXPORT, DrawReason.CHANGE, DrawReason.REFINE):
        assert v.draw(reason).shape == (480, 640, 4)


def test_depth_image_and_double_click():
    """tests/test_visualizer.py::test_depth_image_and_double_click."""
    v = _port_vis(20000, RES)
    d = v.get_depth_image()
    assert d.shape == (RES, RES)
    assert np.isfinite(d).any()
    assert v._sph._get_depth_renderer() is v._sph._get_depth_renderer()
    v.canvas.resize_complete(320, 240, 1)
    before = np.asarray(v.position_offset).copy()
    v.canvas.double_click(80, 60)
    after = np.asarray(v.position_offset)
    assert not np.allclose(before, after)


# ---- against the original topsy's committed pixels ---------------------------

def _parity_vis(**kw):
    return topsy_tpu_torch.test(1000, render_resolution=200, canvas_class=None,
                                device="cpu", **kw)


def test_depth_vs_reference():
    """reference: tests/test_render_output.py:303-343 (test_depth_output)."""
    vis = _parity_vis()
    vis.scale = 20.0
    vis.rotation_matrix = np.array([[1.0, 0.0, 0.0],
                                    [0.0, 0.0, 1.0],
                                    [0.0, -1.0, 0.0]], dtype=np.float32)
    vis.render_sph(DrawReason.EXPORT)
    result = np.asarray(vis.get_depth_image(DrawReason.EXPORT))
    expect = EXPECTED["test_depth_output.expect"].astype(np.float32)
    npt.assert_allclose(result[::20, ::20].ravel(), expect, atol=1e-1)


def test_periodic_vs_reference():
    """reference: tests/test_render_output.py:243-279."""
    vis = _parity_vis(periodic_tiling=True)
    vis.scale = 200.0
    vis.render_sph(DrawReason.EXPORT)
    result = np.asarray(vis.get_sph_image())
    expect = EXPECTED["test_periodic_sph_output.expect"].astype(np.float32)
    npt.assert_allclose(result[::20, ::20].ravel(), expect, rtol=1e-1)


def test_bivariate_vs_reference():
    """reference: tests/test_render_output.py:345-449, at the bounds of
    tests/test_reference_parity.py::test_bivariate_vs_reference."""
    vis = _parity_vis(render_mode="bivariate")
    vis.quantity_name = "test-quantity"
    vis.scale = 20.0
    vis.rotate(0.0, 0.5)
    vis.render_sph(DrawReason.EXPORT)
    results = np.asarray(vis.get_sph_image())
    expect_den = EXPECTED["test_bivariate_render.expect_den"].astype(np.float32)
    expect_qty = EXPECTED["test_bivariate_render.expect_qty"].astype(np.float32)
    den = results[::20, ::20, 0].ravel()
    npt.assert_allclose(den, expect_den, rtol=5e-2)
    ratio = den / expect_den
    assert abs(ratio.mean() - 1.0) < 0.004
    assert ratio.std() < 0.015
    npt.assert_allclose(results[::20, ::20, 1].ravel(), expect_qty, atol=1e-4)


def test_hdr_rgb_presentation_vs_reference():
    """reference: tests/test_render_output.py:69-141 (test_hdr_rgb_render),
    at the bounds of
    tests/test_reference_parity.py::test_hdr_rgb_presentation_vs_reference."""
    vis = _parity_vis(render_mode="rgb-hdr")
    vis.scale = 20.0
    vis.colormap.update_parameters({"min_mag": 38.0, "max_mag": 40.0})
    result = np.asarray(vis.get_sph_presentation_image())[..., :3]
    assert result.dtype == np.float16
    expect = EXPECTED["test_hdr_rgb_render.result_ref"].astype(np.float32)
    err = np.abs(result[::20, ::20].ravel().astype(np.float32) - expect)
    assert (err <= 1e-2).mean() >= 0.99, \
        f"{(err > 1e-2).sum()}/{err.size} beyond the reference's atol"
    npt.assert_allclose(result[::20, ::20].ravel().astype(np.float32),
                        expect, atol=2e-2)


def test_bivariate_rgba_vs_reference():
    """reference: tests/test_render_output.py:412,446 (expect_rgba, atol=5)."""
    vis = _parity_vis(render_mode="bivariate")
    vis.quantity_name = "test-quantity"
    vis.scale = 20.0
    vis.rotate(0.0, 0.5)
    vis.render_sph(DrawReason.EXPORT)
    mapped = np.asarray(vis.get_sph_presentation_image())
    assert mapped.dtype == np.uint8
    expect = EXPECTED["test_bivariate_render.expect_rgba"].astype(np.int32)
    got = mapped[::20, ::20].ravel().astype(np.int32)
    npt.assert_allclose(got, expect, atol=5)


# ---- K1 in the new modes' shapes, on the card ----------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("buffer,depth", [("rgb", False),
                                          ("mass_and_quantity", True)],
                         ids=["C_IN3", "DEPTH1"])
def test_feed_kernel_matches_plain_on_card(buffer, depth):
    """K1 with three value rows (RGB) and with the depth channel, on the
    whole layout and on a 192-column slice: integers equal, float32 planes
    to rtol 1e-6."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from topsy_tpu_torch.ops import splat_atlas, splat_feed
    v = topsy_tpu_torch.test(50000, render_resolution=256, device="cuda",
                             canvas_class=OffscreenCanvas)
    store, sph = v.store, v._sph
    fields = store.presorted_fields()
    vals = store.presorted_values_cm_for(buffer)
    gb = store.presorted_group_buckets
    matrix = sph._matrix().astype(np.float32)
    for f, vv, g in ((fields, vals, gb),
                     splat_atlas.slice_column_fields(fields, vals, gb, None,
                                                     64, 192, merge=False)[:3]):
        args, kw = splat_atlas.feed_call(f, vv, matrix, 256,
                                         np.float32(sph.scale), g,
                                         depth_channel=depth)
        assert kw["C_in"] + int(kw["depth_channel"]) == 3
        got = splat_feed.splat_feed_cuda(*args, **kw)
        want = splat_feed.splat_feed_plain(*args, **kw)
        assert (want[8] // 4 > 0).any()
        for a, b in zip(got[:5], want[:5]):
            assert torch.allclose(a, b, rtol=1e-6, atol=0.0)
        for a, b in zip(got[5:], want[5:]):
            assert torch.equal(a, b)
