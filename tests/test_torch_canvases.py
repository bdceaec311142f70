"""The port's colormap controllers, canvases and argument parser against
the JAX package's: the controllers' layout specs (the colormap list left
out: the port offers the colormaps it can sample) and their callbacks,
the Qt canvas under tests/test_qt_canvas.py's stubs of the Qt object model
(removed again after each test, so that no later test in the worker sees
them), the Jupyter canvas's widget tree and DOM events (ipywidgets, with a
stubbed ipyevents), and ``parse_args``'s namespaces.

Tolerances: what both packages compute with the same code (spec names,
types, labels and options; forwarded events; PNG bytes; namespaces) is
compared exactly; colormap ranges, which each package autoranges on its
own image, within rel 2e-2."""

import sys
import types

import numpy as np
import pytest

import topsy_tpu
import topsy_tpu_torch
from topsy_tpu.canvas import OffscreenCanvas as RefCanvas
from topsy_tpu.color import ui as r_ui
from topsy_tpu_torch.canvas import OffscreenCanvas
from topsy_tpu_torch.color import ui as p_ui
from topsy_tpu_torch.color.maps import colormap_names

from test_qt_canvas import _QtNamespace

MODES = ["univariate", "bivariate", "rgb", "rgb-hdr"]


@pytest.fixture(scope="module")
def pair():
    port = topsy_tpu_torch.test(3000, render_resolution=64, device="cpu",
                                canvas_class=OffscreenCanvas)
    ref = topsy_tpu.test(3000, render_resolution=64, canvas_class=RefCanvas)
    for v in (port, ref):
        v.show_status = False
    return port, ref


@pytest.fixture
def views(pair):
    for v in pair:
        if v.render_mode != "univariate":
            v.render_mode = "univariate"
        v.quantity_name = None
    return pair


def find_control(spec, name):
    if isinstance(spec, (p_ui.ControlSpec, r_ui.ControlSpec)):
        return spec if spec.name == name else None
    for child in spec.children:
        if (found := find_control(child, name)) is not None:
            return found
    return None


def _tree(spec):
    """Names, types, labels and options exactly (the colormap list left
    out); values and ranges as given."""
    if hasattr(spec, "children"):
        return ("layout", spec.type, [_tree(c) for c in spec.children])
    options = None if spec.name == "colormap" else spec.options
    return ("control", spec.name, spec.type, spec.label, options, spec.value,
            spec.range)


def _same_tree(a, b):
    assert a[:2] == b[:2]
    if a[0] == "layout":
        assert len(a[2]) == len(b[2])
        for x, y in zip(a[2], b[2]):
            _same_tree(x, y)
        return
    assert a[:5] == b[:5]
    for x, y in zip(a[5:], b[5:]):
        if isinstance(x, (tuple, float)) and not isinstance(x, bool):
            assert x == pytest.approx(y, rel=2e-2, abs=1e-9), a[1]
        else:
            assert x == y, a[1]


# a quantity switch in rgb mode raises in both packages: rgb modes render
# density only
LAYOUT_CASES = [(m, None) for m in MODES] + [
    ("univariate", "test-quantity"), ("bivariate", "test-quantity")]


@pytest.mark.parametrize("mode,quantity", LAYOUT_CASES,
                         ids=[f"{m}-{q or 'density'}"
                              for m, q in LAYOUT_CASES])
def test_controller_layout_matches_reference(views, mode, quantity):
    layouts = []
    for v, ui in zip(views, (p_ui, r_ui)):
        v.quantity_name = quantity
        v.render_mode = mode
        layouts.append(ui.UnifiedColorMapController(v).get_layout())
    _same_tree(_tree(layouts[0]), _tree(layouts[1]))
    colormap = find_control(layouts[0], "colormap")
    if colormap is not None:
        assert colormap.options == colormap_names()
        assert colormap.value in colormap.options


def test_controller_callbacks_match_reference(views):
    """Mode switch, quantity, log scale and range slider through the
    controllers leave the same parameters in both packages."""
    params = []
    for v, ui in zip(views, (p_ui, r_ui)):
        ctrl = ui.UnifiedColorMapController(v)
        find_control(ctrl.get_layout(), "quantity").callback("test-quantity")
        assert v.quantity_name == "test-quantity"
        log = find_control(ctrl.get_layout(), "log")
        before = v.colormap.get_parameter("log")
        log.callback(not before)
        assert v.colormap.get_parameter("log") == (not before)
        find_control(ctrl.get_layout(), "range").callback((-3.0, 4.0))
        got = {k: v.colormap.get_parameter(k) for k in ("vmin", "vmax", "log")}
        find_control(ctrl.get_layout(), "quantity").callback(
            ui.ColorMapController.default_quantity_name)
        find_control(ctrl.get_layout(), "render_mode").callback("rgb")
        assert v.render_mode == "rgb"
        layout = ctrl.get_layout()
        find_control(layout, "gamma").callback(2.5)
        find_control(layout, "mag_range").callback((18.0, 33.0))
        got.update({k: v.colormap.get_parameter(k)
                    for k in ("gamma", "min_mag", "max_mag")})
        params.append(got)
    assert params[0] == params[1] == {"vmin": -3.0, "vmax": 4.0, "log": True,
                                      "gamma": 2.5, "min_mag": 18.0,
                                      "max_mag": 33.0}


def test_surface_controller_has_lighting(views):
    port = views[0]
    port.render_mode = "surface"
    ctrl = p_ui.UnifiedColorMapController(port)
    layout = ctrl.get_layout()
    assert find_control(layout, "den_percentile_threshold") is not None
    assert find_control(layout, "smoothing_scale") is not None
    diffuse = find_control(layout, "diffuse_lighting")
    assert diffuse is not None and diffuse.value.startswith("#")
    diffuse.callback("#ff0000")
    assert port.colormap.get_parameter("light_color") == pytest.approx(
        (1.0, 0.0, 0.0))
    find_control(layout, "den_percentile_threshold").callback(60.0)
    assert port._sph.get_density_cut_percentile() == pytest.approx(60.0)


# ---- the Qt canvas under the reference test's stubs -------------------------

def _stub_pyside(monkeypatch):
    pyside = types.ModuleType("PySide6")
    for sub in ("QtCore", "QtGui", "QtWidgets"):
        ns = _QtNamespace(f"PySide6.{sub}")
        setattr(pyside, sub, ns)
        monkeypatch.setitem(sys.modules, f"PySide6.{sub}", ns)
    monkeypatch.setitem(sys.modules, "PySide6", pyside)


@pytest.fixture
def qtmods(monkeypatch):
    """Both packages' ``canvas.qt`` imported under the stubs; afterwards
    neither stays imported, so no later test finds a stubbed QtCanvas."""
    import topsy_tpu.canvas as r_canvas
    import topsy_tpu_torch.canvas as p_canvas
    names = ("topsy_tpu_torch.canvas.qt", "topsy_tpu.canvas.qt")
    saved = {n: sys.modules.pop(n, None) for n in names}
    _stub_pyside(monkeypatch)
    from topsy_tpu.canvas import qt as r_qt
    from topsy_tpu_torch.canvas import qt as p_qt
    yield p_qt, r_qt
    for name, package in zip(names, (p_canvas, r_canvas)):
        sys.modules.pop(name, None)
        if saved[name] is not None:
            sys.modules[name] = package.qt = saved[name]
        elif "qt" in vars(package):
            delattr(package, "qt")


def _qt_vis(p_qt):
    return topsy_tpu_torch.test(1000, render_resolution=32, device="cpu",
                                canvas_class=p_qt.QtCanvas)


def test_qt_canvas_constructs_presents_and_builds_controls(qtmods):
    p_qt, _ = qtmods
    vis = _qt_vis(p_qt)
    canvas = vis.canvas
    assert canvas._window is not None and canvas._record_action is not None
    canvas.present_frame(np.zeros((32, 32, 4), np.float32))
    assert canvas._widget._qimage is not None
    canvas.show()
    ran = []
    canvas.request_draw(lambda: ran.append(True))
    canvas._flush_draw()
    assert ran == [True]
    canvas._toggle_controls()
    assert canvas._controls_dock is not None
    assert isinstance(canvas._controller.get_layout(), p_ui.LayoutSpec)
    canvas._refresh_controls(canvas._controller.get_layout(), True)


class _Pos:
    def x(self):
        return 10.0

    def y(self):
        return 12.0


class _Ev:
    def position(self):
        return _Pos()

    def buttons(self):
        return 1

    def modifiers(self):
        return 0

    def angleDelta(self):
        return types.SimpleNamespace(y=lambda: 120)

    def text(self):
        return "r"


def test_qt_events_forward_as_the_reference(qtmods):
    """Both packages' widgets turn the same Qt events into the same
    toolkit-agnostic events."""
    forwarded = []
    for mod in qtmods:
        events = []
        owner = types.SimpleNamespace(event_handler=events.append,
                                      _last_x=0.0, _last_y=0.0)
        widget = mod._CanvasWidget(owner)
        for handler in ("mouseMoveEvent", "mousePressEvent",
                        "mouseDoubleClickEvent", "wheelEvent",
                        "keyReleaseEvent", "mouseReleaseEvent"):
            getattr(widget, handler)(_Ev())
        forwarded.append((events, owner._last_x, owner._last_y))
    assert forwarded[0] == forwarded[1]
    kinds = [e["event_type"] for e in forwarded[0][0]]
    assert kinds == ["pointer_move", "double_click", "wheel", "key_up",
                     "pointer_up"]


def test_qt_recorder_wiring_and_settings_dialog(qtmods, monkeypatch):
    p_qt, r_qt = qtmods
    vis = _qt_vis(p_qt)
    canvas = vis.canvas
    rec = canvas._get_recorder()
    assert canvas._get_recorder() is rec
    canvas._toggle_record()
    assert rec.recording
    canvas._toggle_record()
    assert not rec.recording
    canvas._snapshot()
    canvas._save_timestream()
    canvas._load_timestream()
    dialogs = [m.RecordingSettingsDialog() for m in (p_qt, r_qt)]
    for prop in ("fps", "resolution", "smooth", "set_vmin_vmax",
                 "set_quantity", "show_colorbar", "show_scalebar"):
        assert getattr(dialogs[0], prop) == getattr(dialogs[1], prop), prop
    assert dialogs[0].fps == 30.0 and dialogs[0].resolution == (1920, 1080)
    captured = {}

    def fake_save_mp4(fname, **kwargs):
        captured["fname"] = fname
        captured.update(kwargs)

    monkeypatch.setattr(rec, "save_mp4", fake_save_mp4)
    monkeypatch.setattr(canvas, "_exec_dialog_accepted", lambda d: True)
    monkeypatch.setattr(p_qt.QtWidgets.QFileDialog, "getSaveFileName",
                        staticmethod(lambda *a, **k: ("movie.mp4", "")),
                        raising=False)
    canvas._save_movie()
    assert captured.pop("fname") == "movie.mp4"
    assert set(captured) == {"fps", "resolution", "smooth", "set_vmin_vmax",
                             "set_quantity", "show_colorbar",
                             "show_scalebar"}
    captured.clear()
    monkeypatch.setattr(canvas, "_exec_dialog_accepted", lambda d: False)
    canvas._save_movie()
    assert not captured


def test_qt_window_link_toggle(qtmods, monkeypatch):
    p_qt, _ = qtmods
    monkeypatch.setattr(p_qt.QtCanvas, "_all_instances", [])
    vis1, vis2 = _qt_vis(p_qt), _qt_vis(p_qt)
    c1, c2 = vis1.canvas, vis2.canvas
    assert len(p_qt.QtCanvas._all_instances) == 2
    c1._on_click_link()
    assert vis1.is_synchronizing() and vis2.is_synchronizing()
    vis1.scale = 7.5
    vis1._view_synchronizer.perpetuate_update(vis1)
    assert vis2.scale == 7.5
    c1._on_click_link()
    assert not vis1.is_synchronizing()
    c2._update_toolbar()


# ---- the Jupyter canvas -----------------------------------------------------

def _widget_names(w, names):
    if hasattr(w, "_topsy_name"):
        names.append(w._topsy_name)
    for child in getattr(w, "children", ()):
        _widget_names(child, names)
    return names


def test_jupyter_widget_tree_matches_reference(views):
    pytest.importorskip("ipywidgets")
    from topsy_tpu.canvas.jupyter import JupyterCanvas as RefJupyter
    from topsy_tpu_torch.canvas.jupyter import JupyterCanvas
    trees, pngs = [], []
    frame = np.random.RandomState(0).randint(0, 255, (64, 64, 4), np.uint8)
    for v, cls, ui in zip(views, (JupyterCanvas, RefJupyter), (p_ui, r_ui)):
        canvas = cls(visualizer=v)
        ctrl = ui.UnifiedColorMapController(v, canvas._refresh_controls)
        canvas._refresh_controls(ctrl.get_layout(), True)
        canvas._refresh_controls(ctrl.get_layout(), False)
        trees.append(_widget_names(canvas._controls_box.children[0], []))
        canvas.present_frame(frame)
        pngs.append(canvas._image_widget.value)
    assert trees[0] == trees[1]
    assert "render_mode" in trees[0] and "colormap" in trees[0]
    assert pngs[0] == pngs[1] and len(pngs[0]) > 0


def test_jupyter_dom_events(views, monkeypatch):
    pytest.importorskip("ipywidgets")
    captured = {}

    class FakeEvent:
        def __init__(self, source=None, watched_events=()):
            captured["source"] = source
            captured["watched"] = tuple(watched_events)

        def on_dom_event(self, cb):
            captured["cb"] = cb

    fake = types.ModuleType("ipyevents")
    fake.Event = FakeEvent
    monkeypatch.setitem(sys.modules, "ipyevents", fake)
    from topsy_tpu_torch.canvas.jupyter import JupyterCanvas
    vis = views[0]
    canvas = JupyterCanvas(visualizer=vis)
    assert captured["source"] is canvas._image_widget
    fire = captured["cb"]
    rot = np.array(vis.rotation_matrix)
    fire({"type": "mousedown", "dataX": 10, "dataY": 10})
    fire({"type": "dragmove", "dataX": 30, "dataY": 15})
    assert not np.allclose(np.array(vis.rotation_matrix), rot)
    pos = np.array(vis.position_offset)
    fire({"type": "dragmove", "dataX": 50, "dataY": 15, "shiftKey": True})
    assert not np.allclose(np.array(vis.position_offset), pos)
    assert vis.crosshairs_visible
    fire({"type": "mouseup", "dataX": 50, "dataY": 15})
    assert not canvas._drag_active and not vis.crosshairs_visible
    scale = float(vis.scale)
    fire({"type": "wheel", "deltaY": 5})
    assert float(vis.scale) != scale
    calls = []
    monkeypatch.setattr(canvas, "double_click",
                        lambda x, y: calls.append(("dbl", x, y)))
    monkeypatch.setattr(canvas, "key_up", lambda k: calls.append(("key", k)))
    fire({"type": "dblclick", "dataX": 32, "dataY": 32})
    fire({"type": "keyup", "key": "r"})
    assert calls == [("dbl", 32, 32), ("key", "r")]
    vis.reset_view()


def test_canvas_class_for_environment_matches_reference():
    from topsy_tpu.canvas import canvas_class_for_environment as ref_choice
    from topsy_tpu_torch.canvas import canvas_class_for_environment
    assert canvas_class_for_environment() is OffscreenCanvas
    assert ref_choice().__name__ == "OffscreenCanvas"


# ---- the argument parser ----------------------------------------------------

@pytest.mark.parametrize("argv", [
    ["test://1000"],
    ["fileA", "-q", "temp", "+", "fileB", "--render-mode", "rgb"],
    ["f", "--load-sphere", "5.0"],
    ["f", "--load-sphere", "5.0", "1", "2", "3", "-t", "-p", "gas", "-c",
     "halo-1", "-m", "viridis", "-r", "512"],
], ids=["single", "two_windows", "sphere", "every_option"])
def test_parse_args_matches_reference(argv):
    got = [vars(a) for a in topsy_tpu_torch.parse_args(list(argv))]
    assert got == [vars(a) for a in topsy_tpu.parse_args(list(argv))]


@pytest.mark.parametrize("argv", [
    ["f", "--load-sphere", "5.0", "1.0"],
    ["f", "--render-mode", "bogus"],
], ids=["sphere_arity", "render_mode"])
def test_parse_args_rejects_as_reference(argv):
    for package in (topsy_tpu_torch, topsy_tpu):
        with pytest.raises(SystemExit):
            package.parse_args(list(argv))
