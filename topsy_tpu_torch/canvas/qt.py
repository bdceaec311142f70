"""Qt canvas: native window with toolbar, recording and colormap popover.

A pinned copy of ``topsy_tpu/canvas/qt.py``: frames paint into a QWidget;
the toolbar offers record / movie export / snapshot / window linking /
colormap controls; the mode controls are materialized from the
toolkit-agnostic ControlSpec/LayoutSpec tree.

Requires PySide6 (import-gated; the offscreen canvas is used when absent).
"""

from __future__ import annotations

import logging

import numpy as np

try:
    from PySide6 import QtCore, QtGui, QtWidgets
except ImportError as _e:  # pragma: no cover
    raise ImportError("PySide6 is required for the Qt canvas") from _e

from ..color.ui import ControlSpec, LayoutSpec, UnifiedColorMapController
from ..recorder import VisualizationRecorder
from . import VisualizerCanvasBase

logger = logging.getLogger(__name__)


class VisualizationRecorderWithQtProgressbar(VisualizationRecorder):
    """Movie export with a cancellable Qt progress dialog (reference:
    canvas/qt/recording.py:124-154): the event loop is pumped with SPH
    re-rendering suppressed so the main window stays responsive without
    triggering extra renders mid-export."""

    def __init__(self, visualizer, parent_widget):
        super().__init__(visualizer)
        self._parent_widget = parent_widget

    def _progress_iterator(self, ntot):
        import time as _time
        progress = QtWidgets.QProgressDialog("Rendering to mp4...", "Stop",
                                             0, ntot, self._parent_widget)
        progress.setWindowModality(QtCore.Qt.WindowModality.WindowModal)
        progress.forceShow()
        last_update = 0.0
        loop = QtCore.QEventLoop()
        try:
            for i in range(ntot):
                # progress updates repaint the main window (slow); throttle
                if _time.time() - last_update > 0.5:
                    last_update = _time.time()
                    progress.setValue(i)
                    with self._visualizer.prevent_sph_rendering():
                        loop.processEvents(
                            QtCore.QEventLoop.ProcessEventsFlag.AllEvents)
                    if progress.wasCanceled():
                        break
                yield i
        finally:
            progress.close()

_app = None


def _ensure_app():
    global _app
    _app = QtWidgets.QApplication.instance()
    if _app is None:
        _app = QtWidgets.QApplication([])
    return _app


class _CanvasWidget(QtWidgets.QWidget):
    def __init__(self, owner: "QtCanvas"):
        super().__init__()
        self._owner = owner
        self._qimage = None
        self.setMouseTracking(True)
        self.setFocusPolicy(QtCore.Qt.StrongFocus)

    def set_frame(self, frame: np.ndarray):
        if frame.dtype != np.uint8:
            frame = (np.clip(frame.astype(np.float32), 0, 1) * 255 + 0.5
                     ).astype(np.uint8)
        h, w = frame.shape[:2]
        self._frame = np.ascontiguousarray(frame)
        self._qimage = QtGui.QImage(self._frame.data, w, h, 4 * w,
                                    QtGui.QImage.Format_RGBA8888)
        self.update()

    def paintEvent(self, event):
        if self._qimage is not None:
            painter = QtGui.QPainter(self)
            painter.drawImage(self.rect(), self._qimage)
            painter.end()

    # -- events forwarded to the toolkit-agnostic handler --------------------

    def mouseMoveEvent(self, e):
        buttons = (1,) if e.buttons() else ()
        mods = ("Shift",) if e.modifiers() & QtCore.Qt.ShiftModifier else ()
        self._owner.event_handler({"event_type": "pointer_move",
                                   "buttons": buttons, "modifiers": mods,
                                   "x": e.position().x(), "y": e.position().y()})

    def mousePressEvent(self, e):
        self._owner._last_x = e.position().x()
        self._owner._last_y = e.position().y()

    def mouseReleaseEvent(self, e):
        self._owner.event_handler({"event_type": "pointer_up"})

    def mouseDoubleClickEvent(self, e):
        self._owner.event_handler({"event_type": "double_click",
                                   "x": e.position().x(), "y": e.position().y()})

    def wheelEvent(self, e):
        self._owner.event_handler({"event_type": "wheel", "dx": 0,
                                   "dy": e.angleDelta().y()})

    def keyReleaseEvent(self, e):
        self._owner.event_handler({"event_type": "key_up",
                                   "key": e.text() or ""})

    def resizeEvent(self, e):
        ratio = self.devicePixelRatioF()
        self._owner.event_handler({"event_type": "resize",
                                   "width": e.size().width(),
                                   "height": e.size().height(),
                                   "pixel_ratio": ratio})


class RecordingSettingsDialog(QtWidgets.QDialog):
    """Movie-export options dialog (reference: canvas/qt/recording.py:15-121):
    smoothing, vmin/vmax + quantity replay, colorbar/scalebar visibility,
    resolution and fps — all plumbed into ``save_mp4``'s kwargs.

    Property getters fall back to sensible defaults when the toolkit
    returns non-values (which also makes them exercisable under the test
    suite's stubbed Qt object model)."""

    _RESOLUTIONS = ["Half HD (960x540)", "HD (1920x1080)", "4K (3840x2160)"]
    _FPS = ["24 fps", "30 fps", "60 fps"]

    def __init__(self, *args):
        super().__init__(*args)
        self.setWindowTitle("Recording settings")
        layout = QtWidgets.QVBoxLayout()
        self.setLayout(layout)

        self._smooth_checkbox = QtWidgets.QCheckBox(
            "Smooth timestream camera movements")
        self._vmin_vmax_checkbox = QtWidgets.QCheckBox(
            "Set vmin/vmax from timestream")
        self._quantity_checkbox = QtWidgets.QCheckBox(
            "Set quantity from timestream")
        self._colorbar_checkbox = QtWidgets.QCheckBox("Show colorbar")
        self._scalebar_checkbox = QtWidgets.QCheckBox("Show scalebar")
        for cb in (self._smooth_checkbox, self._vmin_vmax_checkbox,
                   self._quantity_checkbox, self._colorbar_checkbox,
                   self._scalebar_checkbox):
            cb.setChecked(True)
            layout.addWidget(cb)
            layout.addSpacing(6)

        self._resolution_dropdown = QtWidgets.QComboBox()
        self._resolution_dropdown.addItems(self._RESOLUTIONS)
        self._resolution_dropdown.setCurrentIndex(1)
        self._fps_dropdown = QtWidgets.QComboBox()
        self._fps_dropdown.addItems(self._FPS)
        self._fps_dropdown.setCurrentIndex(1)
        row = QtWidgets.QHBoxLayout()
        row.addWidget(self._resolution_dropdown)
        row.addWidget(self._fps_dropdown)
        layout.addLayout(row)

        buttons = QtWidgets.QHBoxLayout()
        cancel = QtWidgets.QPushButton("Cancel")
        cancel.clicked.connect(self.reject)
        save = QtWidgets.QPushButton("Save")
        save.setDefault(True)
        save.clicked.connect(self.accept)
        buttons.addWidget(cancel)
        buttons.addWidget(save)
        layout.addLayout(buttons)

    @staticmethod
    def _checked(cb) -> bool:
        return bool(cb.isChecked())

    @property
    def fps(self) -> float:
        try:
            return float(str(self._fps_dropdown.currentText()).split()[0])
        except (ValueError, IndexError):
            return 30.0

    @property
    def resolution(self) -> tuple:
        import re
        m = re.match(r".*\((\d+)x(\d+)\)",
                     str(self._resolution_dropdown.currentText()))
        if m:
            return int(m.group(1)), int(m.group(2))
        return 1920, 1080

    @property
    def smooth(self) -> bool:
        return self._checked(self._smooth_checkbox)

    @property
    def set_vmin_vmax(self) -> bool:
        return self._checked(self._vmin_vmax_checkbox)

    @property
    def set_quantity(self) -> bool:
        return self._checked(self._quantity_checkbox)

    @property
    def show_colorbar(self) -> bool:
        return self._checked(self._colorbar_checkbox)

    @property
    def show_scalebar(self) -> bool:
        return self._checked(self._scalebar_checkbox)


class QtCanvas(VisualizerCanvasBase):
    #: every live QtCanvas, for the window-link toggle (reference:
    #: canvas/qt/__init__.py:34-37, 198-205)
    _all_instances: list = []

    def __init__(self, *args, **kwargs):
        _ensure_app()
        super().__init__(*args, **kwargs)
        self._window = QtWidgets.QMainWindow()
        self._window.setWindowTitle(self.title)
        self._widget = _CanvasWidget(self)
        self._window.setCentralWidget(self._widget)
        self._window.resize(768, 768)
        self._recorder = None
        self._build_toolbar()
        self._pending_draw = None
        self._timer = QtCore.QTimer()
        self._timer.setSingleShot(True)
        self._timer.timeout.connect(self._flush_draw)
        QtCanvas._all_instances.append(self)
        self._update_toolbar()

    def __del__(self):
        try:
            QtCanvas._all_instances.remove(self)
        except ValueError:
            pass

    # -- scheduling --------------------------------------------------------------

    def request_draw(self, fn):
        self._pending_draw = fn
        if not self._timer.isActive():
            self._timer.start(0)

    def _flush_draw(self):
        fn, self._pending_draw = self._pending_draw, None
        if fn is not None:
            fn()

    def call_later(self, delay, fn, *args):
        QtCore.QTimer.singleShot(int(delay * 1000), lambda: fn(*args))

    def present_frame(self, frame: np.ndarray):
        self._widget.set_frame(frame)

    # -- toolbar (reference: canvas/qt/__init__.py toolbar actions) ---------------

    def _build_toolbar(self):
        tb = QtWidgets.QToolBar("topsy_tpu_torch")
        self._window.addToolBar(tb)

        self._record_action = tb.addAction("Record", self._toggle_record)
        self._save_movie_action = tb.addAction("Save movie", self._save_movie)
        tb.addAction("Snapshot", self._snapshot)
        self._save_script_action = tb.addAction("Save script",
                                                self._save_timestream)
        tb.addAction("Load script", self._load_timestream)
        self._link_action = tb.addAction("Link", self._on_click_link)
        tb.addAction("Colormap", self._toggle_controls)
        self._controls_dock = None

    def _get_recorder(self):
        if self._recorder is None:
            self._recorder = VisualizationRecorderWithQtProgressbar(
                self._visualizer, self._window)
        return self._recorder

    def _toggle_record(self):
        rec = self._get_recorder()
        if rec.recording:
            rec.stop()
            self._record_action.setText("Record")
        else:
            rec.record()
            self._record_action.setText("Stop")
        self._update_toolbar()

    def _exec_dialog_accepted(self, dialog) -> bool:
        dialog.exec()
        return dialog.result() == QtWidgets.QDialog.DialogCode.Accepted

    def _save_movie(self):
        rec = self._get_recorder()
        # options dialog first, then the file picker (reference:
        # canvas/qt/__init__.py:154-171)
        dialog = RecordingSettingsDialog(self._window)
        if not self._exec_dialog_accepted(dialog):
            return
        fname, _ = QtWidgets.QFileDialog.getSaveFileName(
            self._window, "Save movie", "", "MPEG-4 (*.mp4)")
        if fname:
            rec.save_mp4(str(fname), fps=dialog.fps,
                         resolution=dialog.resolution,
                         smooth=dialog.smooth,
                         set_vmin_vmax=dialog.set_vmin_vmax,
                         set_quantity=dialog.set_quantity,
                         show_colorbar=dialog.show_colorbar,
                         show_scalebar=dialog.show_scalebar)

    # -- window linking (reference: canvas/qt/__init__.py:198-217) ------------

    def _on_click_link(self):
        """Toggle view synchronization across every open QtCanvas window:
        link joins all open visualizers into one ViewSynchronizer,
        unlink removes only THIS window from its synchronizer."""
        vis = self._visualizer
        if vis.is_synchronizing():
            logger.info("Stop synchronizing")
            vis.stop_synchronizing()
        else:
            logger.info("Start synchronizing %d windows",
                        len(self._all_instances))
            from ..view_synchronizer import ViewSynchronizer
            synchronizer = ViewSynchronizer()
            for instance in self._all_instances:
                synchronizer.add_view(instance._visualizer)
        for instance in self._all_instances:
            instance._update_toolbar()

    def _update_toolbar(self):
        """Reference toolbar-state parity (canvas/qt/__init__.py:207-224):
        the link toggle needs >= 2 windows and no active recorder; movie /
        script export need a recorder holding a finished recording."""
        recording = self._recorder is not None and self._recorder.recording
        if recording or len(self._all_instances) < 2:
            self._link_action.setDisabled(True)
        else:
            self._link_action.setDisabled(False)
            self._link_action.setText(
                "Unlink" if self._visualizer.is_synchronizing() else "Link")
        have_recording = self._recorder is not None and not recording
        self._save_movie_action.setDisabled(not have_recording)
        self._save_script_action.setDisabled(not have_recording)

    def _snapshot(self):
        fname, _ = QtWidgets.QFileDialog.getSaveFileName(
            self._window, "Save snapshot", "",
            "Images (*.png *.pdf);;Raw content (*.npy)")
        if fname:
            self._visualizer.save(fname)

    def _save_timestream(self):
        rec = self._get_recorder()
        fname, _ = QtWidgets.QFileDialog.getSaveFileName(
            self._window, "Save camera script", "", "Timestream (*.pkl)")
        if fname:
            rec.save_timestream(fname)

    def _load_timestream(self):
        rec = self._get_recorder()
        fname, _ = QtWidgets.QFileDialog.getOpenFileName(
            self._window, "Load camera script", "", "Timestream (*.pkl)")
        if fname:
            rec.load_timestream(fname)

    def _toggle_controls(self):
        if self._controls_dock is not None:
            self._controls_dock.setVisible(not self._controls_dock.isVisible())
            return
        self._controller = UnifiedColorMapController(self._visualizer,
                                                     self._refresh_controls)
        self._controls_dock = QtWidgets.QDockWidget("Display", self._window)
        self._window.addDockWidget(QtCore.Qt.RightDockWidgetArea,
                                   self._controls_dock)
        self._refresh_controls(self._controller.get_layout(), True)

    def _refresh_controls(self, layout: LayoutSpec, new_widgets: bool):
        if self._controls_dock is None:
            return
        container = QtWidgets.QWidget()
        container.setLayout(self._build_layout(layout))
        self._controls_dock.setWidget(container)

    def _build_layout(self, spec: LayoutSpec):
        box = (QtWidgets.QHBoxLayout() if spec.type == "hbox"
               else QtWidgets.QVBoxLayout())
        for child in spec.children:
            if isinstance(child, LayoutSpec):
                inner = QtWidgets.QWidget()
                inner.setLayout(self._build_layout(child))
                box.addWidget(inner)
            else:
                box.addWidget(self._build_control(child))
        return box

    def _build_control(self, spec: ControlSpec):
        if spec.type in ("combo", "combo-edit"):
            w = QtWidgets.QComboBox()
            w.setEditable(spec.type == "combo-edit")
            w.addItems([str(o) for o in (spec.options or [])])
            w.setCurrentText(str(spec.value))
            w.currentTextChanged.connect(spec.callback)
        elif spec.type == "checkbox":
            w = QtWidgets.QCheckBox(spec.label or spec.name)
            w.setChecked(bool(spec.value))
            w.toggled.connect(spec.callback)
        elif spec.type == "slider":
            lo, hi = spec.range or (0.0, 1.0)
            w = QtWidgets.QSlider(QtCore.Qt.Horizontal)
            w.setRange(0, 1000)
            w.setValue(int(1000 * (spec.value - lo) / max(hi - lo, 1e-30)))
            w.valueChanged.connect(
                lambda v, s=spec, lo=lo, hi=hi: s.callback(lo + (hi - lo) * v / 1000))
        elif spec.type == "range_slider":
            # two spin boxes (Qt has no native range slider)
            w = QtWidgets.QWidget()
            lay = QtWidgets.QHBoxLayout(w)
            lay.setContentsMargins(0, 0, 0, 0)
            lo_box = QtWidgets.QDoubleSpinBox()
            hi_box = QtWidgets.QDoubleSpinBox()
            rng = spec.range or (0.0, 1.0)
            for b, val in ((lo_box, spec.value[0]), (hi_box, spec.value[1])):
                b.setDecimals(3)
                b.setRange(rng[0] - 100, rng[1] + 100)
                b.setValue(val)
            emit = lambda *_: spec.callback((lo_box.value(), hi_box.value()))
            lo_box.valueChanged.connect(emit)
            hi_box.valueChanged.connect(emit)
            if spec.label:
                lay.addWidget(QtWidgets.QLabel(spec.label))
            lay.addWidget(lo_box)
            lay.addWidget(hi_box)
        elif spec.type == "button":
            w = QtWidgets.QPushButton(spec.label or spec.name)
            w.clicked.connect(lambda *_: spec.callback(None))
        elif spec.type == "color_picker":
            w = QtWidgets.QPushButton(spec.label or "Colour")
            w.setStyleSheet(f"background-color: {spec.value}")

            def pick(_=None, s=spec, btn=w):
                color = QtWidgets.QColorDialog.getColor()
                if color.isValid():
                    btn.setStyleSheet(f"background-color: {color.name()}")
                    s.callback(color.name())
            w.clicked.connect(pick)
        else:
            w = QtWidgets.QLabel(str(spec.value))
        return w

    # -- window --------------------------------------------------------------------

    def show(self):
        self._window.show()
        self._visualizer.invalidate()

    def run_qt_loop(self):
        _ensure_app().exec()
