"""The host shell around the image, held against the JAX package: the
canvas events that call the Visualizer (a shift-drag, a release, the ``s``
key), ``save`` to ``.npy`` / ``.tif`` / a figure, the float16 TIFF writer,
the status line, the crosshairs and the periodic box's wireframe,
``averaging``, synchronised Visualizers (one device and a mesh), the
recorder (a session recorded by either package replays in the other),
``performance.trace`` and the command line (``python -m topsy_tpu_torch``
with the port's ``load`` on the CPU).

Tolerances: images against the reference use the cross-engine bounds of
tests/test_splat_fields.py:75-78 (sum rel 1e-3, max pixel difference <= 1%
of the maximum, correlation > 0.9999); what both packages compute with the
same numpy code (view parameters sampled by the interpolators, the status
text, the overlay strokes' pixels) is compared exactly."""

import os
import re
import runpy
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import topsy_tpu
import topsy_tpu.recorder as r_recorder
import topsy_tpu_torch
import topsy_tpu_torch.recorder as p_recorder
from topsy_tpu import hdr_tiff as r_hdr_tiff
from topsy_tpu.canvas import OffscreenCanvas as RefCanvas
from topsy_tpu.drawreason import DrawReason as RefDrawReason
from topsy_tpu_torch import hdr_tiff, performance
from topsy_tpu_torch.canvas import OffscreenCanvas
from topsy_tpu_torch.drawreason import DrawReason
from topsy_tpu_torch.parallel import make_mesh

# one process's share of the cores when pytest-xdist runs several workers
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

N, RES = 20000, 64
STATUS = re.compile(r"^\$\d+\$ fps( /\d+\.\d+ds)?( /\d+\.\d+gf)?$")


def _port(n=N, **kw):
    v = topsy_tpu_torch.test(n, render_resolution=RES, device="cpu",
                             canvas_class=OffscreenCanvas, **kw)
    v.show_status = False
    return v


def _ref(n=N, **kw):
    v = topsy_tpu.test(n, render_resolution=RES, canvas_class=RefCanvas, **kw)
    v.show_status = False
    return v


@pytest.fixture(scope="module")
def pair():
    return _port(), _ref()


def _dr(v):
    """The DrawReason enum of ``v``'s package."""
    return RefDrawReason if isinstance(v, topsy_tpu.visualizer.Visualizer) \
        else DrawReason


@pytest.fixture
def views(pair):
    """Both Visualizers at their starting view, density, autoranged on an
    EXPORT frame of it, no overlays."""
    for v in pair:
        v.quantity_name = None
        v.reset_view()
        v.render_sph(_dr(v).EXPORT)
        v.colormap_autorange()
        v.crosshairs_visible = False
        v.show_status = v.show_colorbar = v.show_scalebar = False
        v.__dict__.pop("_override_status_text_until", None)
    return pair


def _cross_engine(a, b):
    a, b = np.nan_to_num(a), np.nan_to_num(b)
    assert a.sum() == pytest.approx(b.sum(), rel=1e-3)
    assert np.abs(a - b).max() <= 0.01 * np.abs(b).max()
    assert np.corrcoef(a.ravel(), b.ravel())[0, 1] > 0.9999


def test_canvas_events_reach_the_visualizer(views, tmp_path, monkeypatch):
    """The pinned canvas's shift-drag, pointer release and ``s`` key call
    ``display_status``, ``crosshairs_visible`` and ``save``, as in the
    reference: none raises, and each does what the reference's does."""
    monkeypatch.chdir(tmp_path)
    fresh = _port(500)
    fresh.canvas.release_drag()          # before any drag
    assert fresh.crosshairs_visible is False
    outs = []
    for v in views:
        c = v.canvas
        c.resize_complete(200, 150)
        c.event_handler({"event_type": "pointer_move", "buttons": (1,),
                         "modifiers": ("Shift",), "x": 3.0, "y": 4.0})
        assert v.crosshairs_visible
        status = v._override_status_text
        c.shift_drag(3, 4)
        c.event_handler({"event_type": "pointer_up"})
        assert not v.crosshairs_visible
        c.release_drag()
        outs.append((status, np.asarray(v.position_offset)))
    assert outs[0][0] == outs[1][0]
    assert outs[0][0].startswith("centre = [")
    np.testing.assert_allclose(outs[0][1], outs[1][1], rtol=1e-6)
    port = views[0]
    port.canvas.key_up("s")
    assert os.path.getsize(tmp_path / "output.pdf") > 1000
    port.canvas.event_handler({"event_type": "key_up", "key": "s"})


@pytest.mark.parametrize("ext", ["npy", "png", "tif"])
def test_save_matches_reference(views, tmp_path, ext):
    """``.npy`` is the raw image (the port's own, bit for bit, and the
    reference's within the cross-engine bounds); ``.tif`` the float16 RGB
    of the presentation of the same EXPORT frame; any other name a
    matplotlib figure."""
    port, ref = views
    paths = [str(tmp_path / f"{who}.{ext}") for who in ("port", "ref")]
    for v, path in zip(views, paths):
        v.save(path)
    if ext == "npy":
        a, b = np.load(paths[0]), np.load(paths[1])
        assert a.shape == (RES, RES)
        np.testing.assert_array_equal(a, port.get_sph_image())
        _cross_engine(a, b)
    elif ext == "tif":
        a = hdr_tiff.imread(paths[0])
        assert a.dtype == np.float16 and a.shape == (RES, RES, 3)
        np.testing.assert_array_equal(
            a, port._sph_presentation_image()[..., :3].astype(np.float16))
        np.testing.assert_array_equal(r_hdr_tiff.imread(paths[0]), a)
        b = hdr_tiff.imread(paths[1]).astype(np.float32)
        d = np.abs(a.astype(np.float32) - b).max(axis=-1)
        assert np.mean(d <= 2) >= 0.999       # uint8 levels, as float16
    else:
        for path in paths:
            assert os.path.getsize(path) > 1000


def test_save_tiff_hdr(tmp_path):
    """rgb-hdr: the float16 presentation itself, and the reference's
    float16 TIFF of the same scene within the cross-engine bounds."""
    port = _port(2000, render_mode="rgb-hdr")
    ref = _ref(2000, render_mode="rgb-hdr")
    port.save(str(tmp_path / "p.tiff"))
    ref.save(str(tmp_path / "r.tiff"))
    a = hdr_tiff.imread(str(tmp_path / "p.tiff"))
    assert a.dtype == np.float16 and a.shape == (RES, RES, 3)
    np.testing.assert_array_equal(
        a, port._sph_presentation_image()[..., :3])
    b = hdr_tiff.imread(str(tmp_path / "r.tiff"))
    _cross_engine(a.astype(np.float64), b.astype(np.float64))


@pytest.mark.parametrize("shape", [(5, 7, 3), (4, 6)], ids=["rgb", "gray"])
def test_hdr_tiff_roundtrip(tmp_path, shape):
    im = np.random.RandomState(0).random_sample(shape).astype(np.float16)
    path = str(tmp_path / "rt.tiff")
    hdr_tiff.imwrite(path, im)
    np.testing.assert_array_equal(hdr_tiff.imread(path), im)
    np.testing.assert_array_equal(r_hdr_tiff.imread(path), im)


def test_save_figure_without_matplotlib(views, tmp_path, monkeypatch):
    """Where matplotlib is absent the figure branch raises ImportError
    naming the formats that need nothing; ``.npy`` and ``.tif`` save."""
    port = views[0]
    for name in ("matplotlib", "matplotlib.pyplot"):
        monkeypatch.setitem(sys.modules, name, None)
    with pytest.raises(ImportError, match=r"\.npy.*\.tif"):
        port.save(str(tmp_path / "x.png"))
    port.save(str(tmp_path / "x.npy"))
    port.save(str(tmp_path / "x.tif"))


def _overlay_frames(v, attr, on):
    """The presentation of the last frame with ``attr`` set to ``on`` and
    to its opposite, composed without rendering again."""
    out = []
    with v.prevent_sph_rendering():
        for state in (on, not on):
            setattr(v, attr, state)
            out.append(v.draw(_dr(v).CHANGE, target=(200, 150)
                              ).astype(int))
    setattr(v, attr, False)
    return out


@pytest.mark.parametrize("overlay", ["crosshairs", "cube"])
def test_line_overlays_match_reference(views, overlay):
    """The crosshairs and, when tiling is periodic, the box's wireframe
    stroke the pixels the reference's strokes (the same cv2 lines over
    images that differ within the cross-engine bounds)."""
    if overlay == "crosshairs":
        pair, attr = views, "crosshairs_visible"
    else:
        pair = (_port(4000, periodic_tiling=True),
                _ref(4000, periodic_tiling=True))
        for v in pair:
            v.scale = 80.0
            v.draw(_dr(v).EXPORT)
        attr = "_periodic_tiling"
    masks = []
    for v in pair:
        on, off = _overlay_frames(v, attr, True)
        assert on.shape == (150, 200, 4)
        masks.append(np.abs(on - off)[..., :3].max(axis=-1) > 2)
    assert masks[0].sum() > 200
    assert (masks[0] == masks[1]).mean() >= 0.995
    if overlay == "cube":
        pair[0]._periodic_tiling = True


@pytest.mark.parametrize("fps,mass_scale,geom,expect", [
    (42.4, 1.0, 1.0, "$42$ fps"),
    (7.6, 2.04, 0.25, "$8$ fps /2.0ds /4.0gf"),
    (120.0, 1.1, 0.95, "$120$ fps"),
], ids=["fps", "factors", "below_thresholds"])
def test_status_line_matches_reference(views, monkeypatch, fps, mass_scale,
                                       geom, expect):
    """The status text from the renderer's fps, its downsampling and the
    progression's geometry factor, as the reference writes it; an override
    of ``display_status`` wins while it lasts."""
    clock = [1e10]                # past any earlier override
    texts = []
    for v, mod in zip(views, (topsy_tpu_torch.visualizer,
                              topsy_tpu.visualizer)):
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(
            time=lambda: clock[0], perf_counter=mod.time.perf_counter))
        v._last_status_update = 0.0
        v.__dict__.pop("_override_status_text_until", None)
        monkeypatch.setattr(v._sph, "last_render_fps", fps)
        monkeypatch.setattr(v._sph, "last_render_mass_scale", mass_scale)
        monkeypatch.setattr(v._sph.render_progression,
                            "get_fraction_volume_selected", lambda: geom)
        img = np.zeros((150, 200, 4), np.float32)
        v._update_and_display_status(img)
        got = [v._status.text]
        v.display_status("centre = [1.00, 2.00, 3.00]")
        clock[0] += 0.1
        v._update_and_display_status(img)
        got.append(v._status.text)
        clock[0] += 0.6
        v._update_and_display_status(img)
        got.append(v._status.text)
        assert img[..., :3].max() > 0          # the raster was drawn
        texts.append(got)
        clock[0] = 1e10
    assert texts[0] == texts[1] == [expect, "centre = [1.00, 2.00, 3.00]",
                                    expect]


def test_status_line_after_an_interactive_frame(views):
    """A CHANGE draw with the status shown: the fps of the frame clock."""
    port = views[0]
    port.show_status = True
    port._last_status_update = 0.0
    port.draw(DrawReason.CHANGE, target=(200, 150))
    assert port._sph.last_render_fps > 0
    assert STATUS.match(port._status.text), port._status.text


def test_weighted_quantity_render(views):
    for v in views:
        v.quantity_name = "test-quantity"
        assert v.averaging
    im = views[0].get_sph_image()
    finite = np.isfinite(im)
    assert np.abs(im[finite]).max() <= 1.01e-4
    _cross_engine(im, views[1].get_sph_image())


@pytest.mark.parametrize("partner", ["single", "mesh"])
def test_synchronized_visualizers(partner):
    """Rotating and zooming one Visualizer moves the other; each one's
    EXPORT image then equals a fresh render at that view."""
    v1 = _port(2000)
    kw = {} if partner == "single" else {
        "mesh": make_mesh(2, devices=["cpu"] * 2)}
    v2 = _port(2000, **kw)
    v1.synchronize_with(v2)
    assert v1.is_synchronizing() and v2.is_synchronizing()
    v1.scale = 33.0
    v1.rotate(0.3, -0.2)
    v1.draw(DrawReason.CHANGE)
    assert v2.scale == 33.0
    np.testing.assert_array_equal(v2.rotation_matrix, v1.rotation_matrix)
    v2.canvas.perform_draw()          # v2 draws the update it received
    v2.position_offset = v2.position_offset + np.float32(1.5)
    v2.draw(DrawReason.CHANGE)
    np.testing.assert_array_equal(v1.position_offset, v2.position_offset)
    for v in (v1, v2):
        fresh = _port(2000, **kw)
        fresh.rotation_matrix = v.rotation_matrix
        fresh.scale = v.scale
        fresh.position_offset = v.position_offset
        v._sph.render(DrawReason.EXPORT)
        fresh._sph.render(DrawReason.EXPORT)
        _cross_engine(v.get_sph_image(), fresh.get_sph_image())
    v1.stop_synchronizing()
    assert not v1.is_synchronizing()
    v3 = _port(500)
    v2.synchronize_with(v3)
    with pytest.raises(RuntimeError, match="already synchronizing"):
        v3.synchronize_with(v2)


def _fake_clock(monkeypatch, module):
    now = [0.0]
    monkeypatch.setattr(module, "time", types.SimpleNamespace(
        time=lambda: now[0]))
    return now


def test_recorder_roundtrip(tmp_path, monkeypatch):
    vis = _port(2000)
    now = _fake_clock(monkeypatch, p_recorder)
    rec = p_recorder.VisualizationRecorder(vis)
    rec.record()
    now[0] = 0.05
    vis.scale = 100.0
    vis.draw(DrawReason.CHANGE)
    now[0] = 0.3
    vis.rotate(0.2, 0.0)
    vis.draw(DrawReason.CHANGE)
    now[0] = 0.5
    rec.stop()
    ts_file = tmp_path / "stream.pkl"
    rec.save_timestream(str(ts_file))
    rec2 = p_recorder.VisualizationRecorder(vis)
    rec2.load_timestream(str(ts_file))
    for smooth in (False, True):
        frames = list(rec2._replay(fps=10, resolution=(96, 64),
                                   smooth=smooth))
        assert len(frames) == 5
        assert all(f.shape == (64, 96, 3) and f.dtype == np.uint8
                   for f in frames)
    mp4 = tmp_path / "movie.mp4"
    rec2.save_mp4(str(mp4), fps=10, resolution=(96, 64), smooth=False)
    assert os.path.getsize(mp4) > 0


def _record_session(vis, recorder_module, clock, draw_reason):
    """A scripted ~1 s session: a rotation, a zoom, a vmin/vmax change."""
    rec = recorder_module.VisualizationRecorder(vis)
    rec.record()
    clock[0] = 0.2
    vis.rotate(0.4, -0.1)
    vis.draw(draw_reason.CHANGE)
    clock[0] = 0.5
    vis.scale = vis.scale * 0.5
    vis.draw(draw_reason.CHANGE)
    clock[0] = 0.8
    vmin, vmax = (vis.colormap.get_parameter(k) for k in ("vmin", "vmax"))
    vis.colormap.update_parameters({"vmin": vmin + 0.5, "vmax": vmax - 0.2})
    vis.draw(draw_reason.CHANGE)
    clock[0] = 1.0
    rec.stop()
    return rec


def _replayed(vis, rec, smooth):
    out = []
    for frame in rec._replay(fps=10, resolution=(RES, RES), smooth=smooth,
                             show_colorbar=False, show_scalebar=False):
        out.append((frame, vis.get_sph_image(),
                    np.array(vis.rotation_matrix), float(vis.scale),
                    np.array(vis.position_offset),
                    vis.colormap.get_parameter("vmin")))
    return out


@pytest.mark.parametrize("recorded_by", ["reference", "port"])
def test_recording_replays_in_the_other_package(views, tmp_path,
                                                monkeypatch, recorded_by):
    """A timestream pickled by one package's recorder loads in the
    other's; both replay it to the same views (exactly: the same
    interpolators) and EXPORT images within the cross-engine bounds."""
    port, ref = views
    clocks = {m: _fake_clock(monkeypatch, m) for m in (p_recorder,
                                                       r_recorder)}
    if recorded_by == "reference":
        rec = _record_session(ref, r_recorder, clocks[r_recorder],
                              RefDrawReason)
    else:
        rec = _record_session(port, p_recorder, clocks[p_recorder],
                              DrawReason)
    path = str(tmp_path / "session.pkl")
    rec.save_timestream(path)
    recs = [p_recorder.VisualizationRecorder(port),
            r_recorder.VisualizationRecorder(ref)]
    for r in recs:
        r.load_timestream(path)
    for smooth in (False, True):
        for v in views:
            v.reset_view()
        got_p, got_r = (_replayed(v, r, smooth) for v, r in zip(views, recs))
        assert len(got_p) == len(got_r) == 10
        for p, r in zip(got_p, got_r):
            assert p[0].shape == r[0].shape == (RES, RES, 3)
            _cross_engine(p[1], r[1])
            for a, b in zip(p[2:], r[2:]):
                np.testing.assert_array_equal(a, b)
        assert got_p[-1][5] != got_p[0][5]          # the vmin change


@pytest.mark.parametrize("argv", [
    ["test://2000", "-r", "64"],
    ["test://2000", "-r", "48", "-q", "test-quantity", "--render-mode",
     "bivariate", "+", "test://1500", "-r", "32", "-m", "viridis"],
], ids=["one_window", "two_windows"])
def test_cli_renders_through_offscreen_canvas(monkeypatch, argv):
    """``python -m topsy_tpu_torch ...`` in process, the port's ``load``
    patched to the CPU: each window renders through the offscreen canvas
    as the reference's namespace asks."""
    opened = []
    load = topsy_tpu_torch.load

    def load_on_cpu(*args, **kw):
        vis = load(*args, device="cpu", **kw)
        opened.append(vis)
        return vis

    monkeypatch.setattr(topsy_tpu_torch, "load", load_on_cpu)
    monkeypatch.setattr(sys, "argv", ["topsy_tpu_torch", *argv])
    runpy.run_module("topsy_tpu_torch", run_name="__main__")
    batches = topsy_tpu_torch.parse_args(argv)
    assert len(opened) == len(batches)
    for vis, args in zip(opened, batches):
        assert isinstance(vis.canvas, OffscreenCanvas)
        assert vis.render_mode == args.render_mode
        assert vis.quantity_name == args.quantity
        assert vis._render_resolution == args.resolution
        assert vis.colormap.get_parameter("colormap_name") == args.colormap
        assert vis.last_frame is not None and vis.last_frame.shape == (
            480, 640, 4)


NO_MATPLOTLIB = r"""
import re, sys
status = re.compile(sys.argv[-1])
sys.modules["matplotlib"] = None
sys.modules["matplotlib.pyplot"] = None
import numpy as np
import topsy_tpu_torch
from topsy_tpu_torch.drawreason import DrawReason
load = topsy_tpu_torch.load
opened = []
topsy_tpu_torch.load = lambda *a, **k: opened.append(
    load(*a, device="cpu", **k)) or opened[-1]
sys.argv = ["topsy_tpu_torch", "test://2000", "-r", "64"]
topsy_tpu_torch.main()
vis, = opened
assert vis.show_status and vis.show_colorbar and vis.show_scalebar
assert vis.last_frame.shape == (480, 640, 4)
assert status.match(vis._status.text), vis._status.text
with vis.prevent_sph_rendering():
    with_flags = vis.draw(DrawReason.CHANGE)
    vis.show_status = vis.show_colorbar = vis.show_scalebar = False
    assert np.array_equal(vis.draw(DrawReason.CHANGE), with_flags)
try:
    vis.save("figure.png")
except ImportError as e:
    assert ".npy" in str(e) and ".tif" in str(e), e
else:
    raise AssertionError("saved a figure without matplotlib")
vis.save("raw.npy")
vis.save("rgb.tif")
print("OK")
"""


def test_presentation_without_matplotlib(tmp_path):
    """Where matplotlib is absent (as on a GPU host without it) the command
    line still presents: no text overlay is drawn, the status text is
    kept, and only the figure branch of ``save`` raises."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    env.setdefault("OMP_NUM_THREADS", "1")
    out = subprocess.run([sys.executable, "-c", NO_MATPLOTLIB,
                          STATUS.pattern], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.strip().endswith("OK")
    assert "matplotlib is not installed" in out.stderr


def test_performance_trace(tmp_path):
    """``trace`` writes a Chrome trace of what ran inside it; intervals
    become named ranges while it runs."""
    vis = _port(2000)
    with performance.trace(str(tmp_path)) as t:
        with performance.signposter.use_interval("export_frame"):
            vis._sph.render(DrawReason.EXPORT)
        performance.signposter.emit_event("done")
    assert os.path.getsize(performance.trace_file(str(tmp_path))) > 0
    names = {e.name for e in t.profiler.events()}
    assert "export_frame" in names
    assert "topsy.render" in names
    with pytest.raises(RuntimeError):
        performance.stop_trace()


def test_notebook_entry(monkeypatch, capsys):
    """``is_jupyter`` / ``force_jupyter`` and the Visualizer's display
    hooks on the offscreen canvas."""
    monkeypatch.setattr(topsy_tpu_torch, "_force_is_jupyter", False)
    assert topsy_tpu_torch.is_jupyter() is False
    topsy_tpu_torch.force_jupyter()
    assert topsy_tpu_torch.is_jupyter() is True
    vis = _port(500)
    vis.show()
    vis._ipython_display_()
    assert "Visualizer" in capsys.readouterr().out
