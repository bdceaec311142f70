"""Scalebar overlay: a physical-length bar with a 'nice' length label.

A pinned copy of ``topsy_tpu/overlays/scalebar.py``.

Behaviour of the reference scalebar (reference: src/topsy/scalebar.py): the
bar targets half the viewport width, quantized to 1/2/5 x 10^n in the most
natural unit among km/au/pc/kpc/Mpc; an aspect-ratio correction keeps the bar
true when the window is taller than wide.
"""

from __future__ import annotations

import numpy as np

from .. import units
from . import Overlay
from .text import TextOverlay


class BarLengthRecommender:
    """Recommends a 'nice' physical scalebar length for a window width."""

    acceptable_units = ("km", "au", "pc", "kpc", "Mpc")

    def __init__(self, initial_window_width_in_base_units=1.0, base_units="kpc"):
        self.unit_conversion_to_base = np.array([
            units.unit_in_units(u, base_units) for u in self.acceptable_units])
        self._window_width = initial_window_width_in_base_units
        self._update_recommendation()
        self._update_label()

    def _update_recommendation(self):
        # choose the unit in which ~half the window is closest to ~3 units
        magnitude = np.abs(np.log10(self._window_width
                                    / self.unit_conversion_to_base) - 0.5)
        idx = int(np.argmin(magnitude))
        unit = self.acceptable_units[idx]
        conv = self.unit_conversion_to_base[idx]
        target = (self._window_width / 2.0) / conv
        quantized = self._quantize_length(target)
        self._length_in_unit = quantized
        self._unit_name = unit
        self._length_base_units = quantized * conv

    @classmethod
    def _quantize_length(cls, length: float) -> float:
        """Largest 1/2/5 x 10^n <= length."""
        power = np.floor(np.log10(length))
        mantissa = length / 10 ** power
        if mantissa < 2.0:
            return 10.0 ** power
        if mantissa < 5.0:
            return 2.0 * 10.0 ** power
        return 5.0 * 10.0 ** power

    @classmethod
    def _format_scientific_latex(cls, value: float, unit: str) -> str:
        if value == 0:
            return f"0 {unit}"
        if 0.01 <= abs(value) <= 1000:
            if value == int(value):
                return f"{int(value)} {unit}"
            return f"{value:.2f}".rstrip("0").rstrip(".") + f" {unit}"
        exponent = int(np.floor(np.log10(abs(value))))
        mantissa = value / (10 ** exponent)
        return f"${mantissa:.0f} \\times 10^{{{exponent}}}$ {unit}"

    def _update_label(self):
        self._label = self._format_scientific_latex(self._length_in_unit,
                                                    self._unit_name)
        self._label_is_for = (self._length_in_unit, self._unit_name)

    def update_window_width(self, window_width_in_base_units: float):
        if window_width_in_base_units != self._window_width:
            self._window_width = window_width_in_base_units
            self._update_recommendation()

    @property
    def label(self) -> str:
        if self._label_is_for != (self._length_in_unit, self._unit_name):
            self._update_label()
        return self._label

    @property
    def physical_scalebar_length_base_units(self) -> float:
        return self._length_base_units


class BarOverlay(Overlay):
    """A solid bar of given clip-space length and pixel height."""

    def __init__(self, visualizer, x0=0.1, y0=0.1, height_pixels=20,
                 color=(1, 1, 1, 1), initial_length=0.2):
        self.x0 = x0
        self.y0 = y0
        self.height_pixels = height_pixels
        self.color = color
        self.length = initial_length
        super().__init__(visualizer)

    def render_contents(self) -> np.ndarray:
        pixel = np.ones((1, 1, 4), dtype=np.float32)
        pixel[0, 0, :] = self.color
        return pixel

    def get_clipspace_coordinates(self, window_pixel_width, window_pixel_height):
        height_clipspace = 2.0 * self.height_pixels / window_pixel_height
        return self.x0, self.y0, self.length, height_clipspace


class ScalebarOverlay:
    def __init__(self, visualizer):
        self._label = TextOverlay(visualizer, "Scalebar", (-0.9, -0.85), 40,
                                  color=(1, 1, 1, 1))
        self._bar = BarOverlay(visualizer, x0=-0.9, y0=-0.9, height_pixels=10,
                               color=(1, 1, 1, 1))
        self._recommender = BarLengthRecommender(
            1.0, visualizer.data_loader.get_position_units())
        self._visualizer = visualizer
        self._label_is_for_length = None

    def composite(self, target: np.ndarray):
        self._update_length()
        self._bar.length = self._physical_length / self._visualizer.scale
        # the square render is cropped to the window; if the window is taller
        # than wide, the visible x extent shrinks (reference: scalebar.py:131-145)
        canvas = self._visualizer.canvas
        if canvas.width_physical < canvas.height_physical:
            self._bar.length *= canvas.height_physical / canvas.width_physical
        self._label.composite(target)
        self._bar.composite(target)

    def _update_length(self):
        window_width = 2.0 * self._visualizer.scale
        self._recommender.update_window_width(window_width)
        self._physical_length = self._recommender.physical_scalebar_length_base_units
        if self._label_is_for_length != self._physical_length:
            self._label.text = self._recommender.label
            self._label_is_for_length = self._physical_length
            self._label.update()
