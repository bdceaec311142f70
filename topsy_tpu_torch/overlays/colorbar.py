"""Colorbar overlay via a matplotlib Agg figure (reference:
src/topsy/colorbar.py): regenerated whenever vmin/vmax/colormap change.

A pinned copy of ``topsy_tpu/overlays/colorbar.py``.
"""

from __future__ import annotations

import matplotlib
import matplotlib.backends.backend_agg
import matplotlib.colors as colors
import matplotlib.figure as figure
import numpy as np

from . import Overlay


class ColorbarOverlay(Overlay):
    def __init__(self, visualizer, vmin, vmax, colormap, label, *,
                 dpi_logical=72, **kwargs):
        self.dpi_logical = dpi_logical
        self.kwargs = kwargs
        self._aspect_ratio = 0.2
        params = visualizer.colormap.get_parameters()
        self._vmin = params["vmin"]
        self._vmax = params["vmax"]
        self._colormap = params["colormap_name"]
        self.label = label
        self._last_canvas_size = None
        super().__init__(visualizer)

    def get_clipspace_coordinates(self, pixel_width, pixel_height):
        im = self.get_contents()
        height = 2.0
        width = 2.0 * pixel_height * im.shape[1] / im.shape[0] / pixel_width
        x, y = 1.0 - width, -1.0
        if self._last_canvas_size != (pixel_width, pixel_height):
            self.update()
            self._last_canvas_size = (pixel_width, pixel_height)
        return x, y, width, height

    def composite(self, target):
        self._ensure_contents_current()
        super().composite(target)

    def _ensure_contents_current(self):
        params = self._visualizer.colormap.get_parameters()
        if (self._vmin != params["vmin"] or self._vmax != params["vmax"]
                or self._colormap != params["colormap_name"]):
            self._vmin = params["vmin"]
            self._vmax = params["vmax"]
            self._colormap = params["colormap_name"]
            self.update()

    def render_contents(self) -> np.ndarray:
        pixel_ratio = getattr(self._visualizer.canvas, "pixel_ratio", 1.0)
        dpi = self.dpi_logical * pixel_ratio
        canvas_height = getattr(self._visualizer.canvas, "height_physical", 768)

        fig = figure.Figure(
            figsize=(canvas_height * self._aspect_ratio / dpi, canvas_height / dpi),
            dpi=dpi, facecolor=(1.0, 1.0, 1.0, 0.5))
        matplotlib.backends.backend_agg.FigureCanvasAgg(fig)
        cmap = matplotlib.colormaps[self._colormap]
        norm = colors.Normalize(vmin=self._vmin, vmax=self._vmax)
        cb = matplotlib.colorbar.ColorbarBase(
            fig.add_axes([0.05, 0.05, 0.3, 0.9]), cmap=cmap, norm=norm,
            orientation="vertical")
        cb.set_label(self.label)
        fig.canvas.draw()
        w, h = fig.canvas.get_width_height(physical=True)
        rgba = np.frombuffer(fig.canvas.buffer_rgba(), dtype=np.uint8)
        return rgba.reshape((h, w, 4)).astype(np.float32) / 256.0
