"""Canvas classes: event handling and the offscreen presentation target.

A pinned copy of ``VisualizerCanvasBase`` and ``OffscreenCanvas`` from
``topsy_tpu/canvas/__init__.py``: drag rotates at 0.01 rad/px, shift-drag
pans in the view plane, wheel zooms exponentially, double-click recenters
with an arctan-eased glide, and keys s/r/h/w save / autorange / home /
print-view.  The Qt and Jupyter canvases are ROADMAP item M16.
"""

from __future__ import annotations

import copy
import logging
import time

import numpy as np

from . import config

logger = logging.getLogger(__name__)


class VisualizerCanvasBase:
    """Event handling shared by all canvas backends."""

    def __init__(self, *args, **kwargs):
        self._visualizer = kwargs.pop("visualizer")
        self.title = kwargs.pop("title", "topsy_tpu")
        self._last_x = 0.0
        self._last_y = 0.0
        self.width_physical, self.height_physical = 640, 480
        self.pixel_ratio = 1.0
        super().__init__(*args, **kwargs)

    # -- capabilities -----------------------------------------------------------

    def supported_formats(self) -> tuple[str, ...]:
        """Presentation formats this canvas can present.

        The mode-switch machinery consults this before building a pipeline
        (Visualizer._initialize_sph_and_colormap_and_bar), so a backend that
        cannot present HDR makes 'rgb-hdr' fail at initialization — and the
        revert-on-failure path restores the previous mode.  Mirrors the
        reference's present-method capability query, where a canvas
        restricted to rgba-u8 makes HDR pipeline creation raise
        (reference: tests/test_render_mode.py:42-67)."""
        return ("rgba8unorm", "rgba16float")

    # -- event plumbing ---------------------------------------------------------

    def event_handler(self, event: dict):
        etype = event.get("event_type")
        if etype == "pointer_move":
            if len(event.get("buttons", ())) > 0:
                dx = event["x"] - self._last_x
                dy = event["y"] - self._last_y
                if len(event.get("modifiers", ())) == 0:
                    self.drag(dx, dy)
                else:
                    self.shift_drag(dx, dy)
            self._last_x = event["x"]
            self._last_y = event["y"]
        elif etype == "wheel":
            self.mouse_wheel(event.get("dx", 0.0), event.get("dy", 0.0))
        elif etype == "key_up":
            self.key_up(event["key"])
        elif etype == "resize":
            self.resize_complete(event["width"], event["height"],
                                 event.get("pixel_ratio", 1))
        elif etype == "double_click":
            self.double_click(event["x"], event["y"])
        elif etype == "pointer_up":
            self.release_drag()

    # -- interaction semantics ----------------------------------------------------

    def drag(self, dx, dy):
        self._visualizer.rotate(dx * 0.01, dy * 0.01)

    def shift_drag(self, dx, dy):
        biggest = max(self.width_physical, self.height_physical)
        displacement = (2.0 * self.pixel_ratio
                        * np.array([dx, -dy, 0], dtype=np.float32)
                        / biggest * self._visualizer.scale)
        self._visualizer.position_offset = (
            self._visualizer.position_offset
            + self._visualizer.rotation_matrix.T @ displacement)
        self._visualizer.display_status(
            "centre = [{:.2f}, {:.2f}, {:.2f}]".format(
                *self._visualizer.position_offset))
        self._visualizer.crosshairs_visible = True

    def key_up(self, key):
        if key == "s":
            self._visualizer.save()
        elif key == "r":
            self._visualizer.colormap_autorange()
        elif key == "h":
            self._visualizer.reset_view()
        elif key == "w":
            offset = np.array2string(np.asarray(self._visualizer.position_offset),
                                     separator=",")
            rot = np.array2string(np.asarray(self._visualizer.rotation_matrix),
                                  separator=",")
            print(f".translate({offset}).transform(np.array({rot}))")

    def mouse_wheel(self, delta_x, delta_y):
        self._visualizer.scale = self._visualizer.scale * np.exp(delta_y / 1000)

    def release_drag(self):
        if self._visualizer.crosshairs_visible:
            self._visualizer.crosshairs_visible = False
            self._visualizer.invalidate()

    def resize_complete(self, width, height, pixel_ratio=1):
        self.width_physical = int(width * pixel_ratio)
        self.height_physical = int(height * pixel_ratio)
        self.pixel_ratio = pixel_ratio

    def double_click(self, x, y):
        vis = self._visualizer
        original_position = copy.copy(vis.position_offset)

        biggest = max(self.width_physical, self.height_physical)
        cx = self.width_physical / (2 * self.pixel_ratio)
        cy = self.height_physical / (2 * self.pixel_ratio)
        xy_disp = (2.0 * self.pixel_ratio
                   * np.array([cx - x, y - cy, 0], dtype=np.float32)
                   / biggest * vis.scale)
        vis.position_offset = vis.position_offset + vis.rotation_matrix.T @ xy_disp

        depth_im = vis.get_depth_image()
        central = depth_im[depth_im.shape[0] // 2, depth_im.shape[1] // 2]
        if not np.isnan(central):
            z_disp = np.array([0, 0, -central], dtype=np.float32)
            vis.position_offset = vis.position_offset + vis.rotation_matrix.T @ z_disp

        final_position = vis.position_offset
        vis.position_offset = original_position

        def interpolate_position(t):
            w1 = np.arctan(5 * (t * 2 - 1)) / np.pi + 0.5
            return (1 - w1) * original_position + w1 * final_position

        start = time.time()

        def glide():
            t = (time.time() - start) / config.GLIDE_TIME
            if t > 1:
                vis.position_offset = final_position
            else:
                self.call_later(0.0, glide)
                vis.position_offset = interpolate_position(t)

        self.call_later(1.0 / config.TARGET_FPS, glide)

    # -- backend contract ---------------------------------------------------------

    def request_draw(self, fn):
        raise NotImplementedError

    def call_later(self, delay, fn, *args):
        raise NotImplementedError

    def show(self):
        pass


class OffscreenCanvas(VisualizerCanvasBase):
    """Headless canvas: draw requests run synchronously, glide animations run
    to completion immediately (reference: canvas/offscreen.py:8-13)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._pending = []
        self._draining = False
        self._scheduled_draw = None
        self.last_frame = None

    def request_draw(self, fn):
        # defer like a real event loop: only the most recent request survives
        # (the reference's rendercanvas collapses repeated requests the same
        # way); flush with perform_draw()
        self._scheduled_draw = fn

    def perform_draw(self, max_iterations: int = 64):
        """Flush scheduled draws, following refinement chains to quiescence."""
        for _ in range(max_iterations):
            fn, self._scheduled_draw = self._scheduled_draw, None
            if fn is None:
                return
            fn()

    def present_frame(self, frame):
        self.last_frame = frame

    def call_later(self, delay, fn, *args):
        # trampoline: drain iteratively so self-rescheduling animations
        # (the double-click glide) terminate without deep recursion
        self._pending.append((fn, args))
        if self._draining:
            return
        self._draining = True
        try:
            while self._pending:
                f, a = self._pending.pop(0)
                f(*a)
        finally:
            self._draining = False

    def draw(self):
        pass
