"""Text overlays: strings (including mathtext) rasterized once, then blitted.

A pinned copy of ``topsy_tpu/overlays/text.py``.

The rasterizer is the standard matplotlib "mathtext to array" gallery
recipe (https://matplotlib.org/stable/gallery/text_labels_and_annotations/
mathtext_asarray.html — the same public recipe the reference credits,
reference: src/topsy/text.py:30-43).  Rasters are cached per (text, dpi,
style) so live status-line updates only re-render when the string changes;
the on-screen quad is derived from the bitmap's aspect ratio at a requested
logical-pixel height.
"""

from __future__ import annotations

from io import BytesIO

import numpy as np

from . import Overlay

_raster_cache: dict[tuple, np.ndarray] = {}
_RASTER_CACHE_MAX = 64


def text_to_rgba(s: str, *, dpi: float, **kwargs) -> np.ndarray:
    """Rasterize a (possibly LaTeX) string to an RGBA float array, cached.

    Matplotlib gallery recipe (see module docstring): draw onto a
    transparent figure, save to a png buffer at the requested dpi with a
    tight bounding box, and read the pixels back."""
    key = (s, dpi, tuple(sorted(kwargs.items())))
    hit = _raster_cache.get(key)
    if hit is not None:
        return hit

    from matplotlib.figure import Figure
    import matplotlib.pyplot as plt

    fig = Figure(facecolor="none")
    fig.text(0, 0, s, **kwargs)
    with BytesIO() as buf:
        fig.savefig(buf, dpi=dpi, format="png", bbox_inches="tight",
                    pad_inches=0)
        buf.seek(0)
        rgba = plt.imread(buf)

    if len(_raster_cache) >= _RASTER_CACHE_MAX:
        _raster_cache.pop(next(iter(_raster_cache)))
    _raster_cache[key] = rgba
    return rgba


class TextOverlay(Overlay):
    """A string anchored at a clip-space origin.

    ``logical_pixels_height`` fixes the rendered height in logical pixels
    (scaled by the canvas pixel ratio); the width follows from the raster's
    aspect ratio so glyphs are never stretched."""

    def __init__(self, visualizer, text: str, clipspace_origin,
                 logical_pixels_height, *, dpi=200, **style):
        self.text = text
        self.dpi = dpi
        self.clipspace_origin = clipspace_origin
        self.pixelspace_height = logical_pixels_height
        self.kwargs = style  # matplotlib text styling, passed through
        super().__init__(visualizer)

    def _quad_size(self, im: np.ndarray, width: int, height: int):
        """Clip-space (w, h) of the blit quad: physical height fixed by the
        logical-pixel request, width by the raster aspect ratio."""
        ratio = getattr(self._visualizer.canvas, "pixel_ratio", 1.0)
        h_px = self.pixelspace_height * ratio
        aspect = im.shape[1] / im.shape[0]
        return h_px * aspect / width, h_px / height

    def get_clipspace_coordinates(self, width, height):
        x, y = self.clipspace_origin
        w, h = self._quad_size(self.get_contents(), width, height)
        return x, y, w, h

    def render_contents(self) -> np.ndarray:
        return text_to_rgba(self.text, dpi=self.dpi, **self.kwargs)
