"""Jupyter canvas: ipywidgets frame display + declarative control tree.

A pinned copy of ``topsy_tpu/canvas/jupyter.py``: the mode controls are
materialized from the toolkit-agnostic ControlSpec/LayoutSpec tree, with
the slider-range update workaround (set bounds before values).  Frames are
streamed into an ipywidgets Image; pointer/wheel events are wired through
ipyevents when it is installed.
"""

from __future__ import annotations

import io
import logging

import numpy as np

try:
    import ipywidgets as widgets
except ImportError as _e:  # pragma: no cover
    raise ImportError("ipywidgets is required for the Jupyter canvas") from _e

from ..color.ui import ControlSpec, LayoutSpec, UnifiedColorMapController
from . import VisualizerCanvasBase

logger = logging.getLogger(__name__)


def _frame_to_png_bytes(frame: np.ndarray) -> bytes:
    from PIL import Image
    if frame.dtype != np.uint8:
        frame = (np.clip(frame.astype(np.float32), 0, 1) * 255 + 0.5).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(frame, "RGBA").save(buf, format="png")
    return buf.getvalue()


class JupyterCanvas(VisualizerCanvasBase):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.width_physical, self.height_physical = 640, 640
        self._image_widget = widgets.Image(format="png", width=640, height=640)
        self._controls_box = widgets.VBox([])
        self._controller = None
        self._scheduled = None
        self._wire_events()

    # -- draw scheduling ---------------------------------------------------------

    def request_draw(self, fn):
        self._scheduled = fn
        try:
            import asyncio
            loop = asyncio.get_event_loop()
            loop.call_soon(self._flush)
        except RuntimeError:
            self._flush()

    def _flush(self):
        fn, self._scheduled = self._scheduled, None
        if fn is not None:
            fn()

    def call_later(self, delay, fn, *args):
        import asyncio
        try:
            asyncio.get_event_loop().call_later(delay, fn, *args)
        except RuntimeError:
            fn(*args)

    def present_frame(self, frame: np.ndarray):
        self._image_widget.value = _frame_to_png_bytes(frame)

    # -- events --------------------------------------------------------------------

    def _wire_events(self):
        try:
            from ipyevents import Event
        except ImportError:
            logger.info("ipyevents not installed; mouse interaction disabled "
                        "in the notebook (widget controls still work)")
            return
        ev = Event(source=self._image_widget,
                   watched_events=["dragmove", "mousedown", "mouseup",
                                   "wheel", "dblclick", "keyup"])
        ev.on_dom_event(self._dom_event)
        self._drag_active = False

    def _dom_event(self, event):
        etype = event.get("type")
        if etype == "mousedown":
            self._drag_active = True
            self._last_x, self._last_y = event["dataX"], event["dataY"]
        elif etype == "mouseup":
            self._drag_active = False
            self.event_handler({"event_type": "pointer_up"})
        elif etype == "dragmove" and self._drag_active:
            self.event_handler({"event_type": "pointer_move",
                                "buttons": (1,),
                                "modifiers": ("Shift",) if event.get("shiftKey") else (),
                                "x": event["dataX"], "y": event["dataY"]})
        elif etype == "wheel":
            self.event_handler({"event_type": "wheel", "dx": 0,
                                "dy": event.get("deltaY", 0) * 10})
        elif etype == "dblclick":
            self.event_handler({"event_type": "double_click",
                                "x": event["dataX"], "y": event["dataY"]})
        elif etype == "keyup":
            self.event_handler({"event_type": "key_up", "key": event.get("key")})

    # -- widget tree ------------------------------------------------------------------

    def ipython_display_with_widgets(self):
        from IPython.display import display
        self._controller = UnifiedColorMapController(
            self._visualizer, self._refresh_controls)
        self._refresh_controls(self._controller.get_layout(), True)
        display(widgets.VBox([self._image_widget, self._controls_box]))
        self._visualizer.invalidate()

    def _refresh_controls(self, layout: LayoutSpec, new_widgets: bool):
        if new_widgets:
            self._controls_box.children = [self._build(layout)]
        else:
            self._update_values(self._controls_box.children[0], layout)

    def _build(self, spec):
        if isinstance(spec, LayoutSpec):
            box = widgets.HBox if spec.type == "hbox" else widgets.VBox
            return box([self._build(c) for c in spec.children])
        return self._build_control(spec)

    def _build_control(self, spec: ControlSpec):
        w = None
        if spec.type == "combo":
            w = widgets.Dropdown(options=spec.options, value=spec.value,
                                 description=spec.label or "")
            w.observe(lambda ch, s=spec: s.callback(ch["new"]), names="value")
        elif spec.type == "combo-edit":
            w = widgets.Combobox(options=list(spec.options or []),
                                 value=str(spec.value),
                                 description=spec.label or "",
                                 ensure_option=False)
            w.observe(lambda ch, s=spec: s.callback(ch["new"]), names="value")
        elif spec.type == "checkbox":
            w = widgets.Checkbox(value=bool(spec.value),
                                 description=spec.label or spec.name)
            w.observe(lambda ch, s=spec: s.callback(ch["new"]), names="value")
        elif spec.type == "slider":
            lo, hi = spec.range or (0.0, 1.0)
            w = widgets.FloatSlider(value=spec.value, min=lo, max=hi,
                                    step=(hi - lo) / 100.0,
                                    description=spec.label or spec.name,
                                    continuous_update=True)
            w.observe(lambda ch, s=spec: s.callback(ch["new"]), names="value")
        elif spec.type == "range_slider":
            lo, hi = spec.range or (0.0, 1.0)
            value = tuple(np.clip(spec.value, lo, hi))
            w = widgets.FloatRangeSlider(value=value, min=lo, max=hi,
                                         step=(hi - lo) / 200.0,
                                         description=spec.label or "",
                                         continuous_update=True)
            w.observe(lambda ch, s=spec: s.callback(tuple(ch["new"])),
                      names="value")
        elif spec.type == "button":
            w = widgets.Button(description=spec.label or spec.name)
            w.on_click(lambda _b, s=spec: s.callback(None))
        elif spec.type == "color_picker":
            w = widgets.ColorPicker(value=spec.value,
                                    description=spec.label or "")
            w.observe(lambda ch, s=spec: s.callback(ch["new"]), names="value")
        else:  # label
            w = widgets.Label(value=str(spec.value))
        w._topsy_name = spec.name
        return w

    def _update_values(self, widget, spec):
        """In-place value refresh; bounds are widened before values are set
        (the reference's slider-range workaround, jupyter.py:178-190)."""
        if isinstance(spec, LayoutSpec):
            for child_w, child_s in zip(widget.children, spec.children):
                self._update_values(child_w, child_s)
            return
        try:
            if spec.type in ("slider", "range_slider") and spec.range:
                lo, hi = spec.range
                widget.min = min(lo, widget.min)
                widget.max = max(hi, widget.max)
                widget.min, widget.max = lo, hi
            if spec.type == "range_slider":
                widget.value = tuple(np.clip(spec.value, widget.min, widget.max))
            elif spec.type not in ("button", "label"):
                widget.value = spec.value
        except Exception:  # tolerate transient widget-state races
            logger.debug("widget update failed for %s", spec.name, exc_info=True)

    def show(self):
        from IPython.display import display
        display(self._visualizer)
