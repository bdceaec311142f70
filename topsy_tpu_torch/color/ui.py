"""Toolkit-agnostic declarative UI controllers for the colormap modes.

A pinned copy of ``topsy_tpu/color/ui.py``: ``ControlSpec``/``LayoutSpec``
trees describe the controls abstractly; the Qt and Jupyter canvases
materialize them.  Controllers translate widget events into
visualizer/colormap parameter updates and invalidations.

One difference from the original: it imports matplotlib at the top and
offers every ``mpl.colormaps`` entry, while this copy offers the colormaps
the port can sample (``color.maps.colormap_names``): matplotlib's where
matplotlib is installed, otherwise those stored in ``color/luts.npz``.
"""

from __future__ import annotations

import abc
import logging
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional, Tuple, Union

from .. import config
from ..drawreason import DrawReason
from .maps import colormap_names

logger = logging.getLogger(__name__)


@dataclass
class ControlSpec:
    name: str
    type: str  # 'combo' | 'combo-edit' | 'checkbox' | 'slider' | 'range_slider' | 'button' | 'color_picker' | 'label'
    label: Optional[str] = None
    options: Optional[List[str]] = None
    value: Any = None
    range: Optional[Tuple[float, float]] = None
    callback: Callable[[Any], None] = field(default=lambda _: None)

    def get_first_named_element(self, name):
        return name if self.name == name else None


@dataclass
class LayoutSpec:
    type: str  # 'vbox' | 'hbox'
    children: List[Union["LayoutSpec", ControlSpec]]

    def get_first_named_element(self, name):
        for c in self.children:
            if (result := c.get_first_named_element(name)):
                return result
        return None


class GenericController(abc.ABC):
    def __init__(self, visualizer, refresh_ui_callback=None):
        self.visualizer = visualizer
        self.colormap = visualizer.colormap
        self._refresh_ui_callback = refresh_ui_callback
        self._layout_on_last_refresh = self.get_layout()

    @abc.abstractmethod
    def get_layout(self) -> LayoutSpec:
        ...

    def refresh_ui(self):
        if self._refresh_ui_callback is not None:
            current = self.get_layout()
            changed = self._widgets_differ(current, self._layout_on_last_refresh)
            self._refresh_ui_callback(current, changed)
            self._layout_on_last_refresh = current

    @classmethod
    def _widgets_differ(cls, a, b) -> bool:
        if isinstance(a, ControlSpec) and isinstance(b, ControlSpec):
            return a.name != b.name or a.type != b.type or a.value != b.value
        if isinstance(a, LayoutSpec) and isinstance(b, LayoutSpec):
            if a.type != b.type or len(a.children) != len(b.children):
                return True
            return any(type(c1) is not type(c2) or cls._widgets_differ(c1, c2)
                       for c1, c2 in zip(a.children, b.children))
        return True


class ColorMapController(GenericController):
    """Univariate density / weighted-average controls."""

    default_quantity_name = config.PROJECTED_DENSITY_NAME

    def get_colormap_list(self) -> List[str]:
        return colormap_names()

    def get_quantity_list(self) -> List[str]:
        names = sorted(self.visualizer.data_loader.get_quantity_names(), key=str.lower)
        return [self.default_quantity_name] + names

    def apply_auto(self):
        self.visualizer.colormap_autorange()
        self.refresh_ui()

    def apply_colormap(self, name: str):
        self.visualizer.colormap.update_parameters({"colormap_name": name})
        self.visualizer.invalidate(DrawReason.PRESENTATION_CHANGE)

    def apply_log_scale(self, state: bool):
        params = self.colormap.get_parameters()
        ui_range = params["ui_range_log"] if state else params["ui_range_linear"]
        self.colormap.update_parameters({"log": state, "vmin": ui_range[0],
                                         "vmax": ui_range[1]})
        self.visualizer.invalidate(DrawReason.PRESENTATION_CHANGE)
        self.refresh_ui()

    def apply_quantity(self, name: str):
        self.visualizer.quantity_name = (None if name == self.default_quantity_name
                                         else name)
        self.refresh_ui()

    def apply_slider(self, vmin: float, vmax: float):
        self.colormap.update_parameters({"vmin": vmin, "vmax": vmax})
        self.visualizer.invalidate(DrawReason.PRESENTATION_CHANGE)

    def get_layout(self, suppress_range=False) -> LayoutSpec:
        params = self.visualizer.colormap.get_parameters()
        qty = self.visualizer.quantity_name or self.default_quantity_name
        ui_range = (params.get("ui_range_log", (0.0, 1.0)) if params.get("log")
                    else params.get("ui_range_linear", (0.0, 1.0)))

        first_row = [
            ControlSpec("colormap", "combo", options=self.get_colormap_list(),
                        value=params["colormap_name"], callback=self.apply_colormap),
            ControlSpec("quantity", "combo-edit", options=self.get_quantity_list(),
                        value=qty, callback=self.apply_quantity),
        ]
        if not suppress_range:
            first_row.append(ControlSpec("log", "checkbox", label="Log scale",
                                         value=params.get("log", False),
                                         callback=self.apply_log_scale))
        children: list = [LayoutSpec("hbox", first_row)]
        if not suppress_range:
            children.append(LayoutSpec("hbox", [
                ControlSpec("range", "range_slider",
                            value=(params["vmin"], params["vmax"]),
                            range=ui_range,
                            callback=lambda vv: self.apply_slider(*vv)),
                ControlSpec("auto", "button", label="Auto",
                            callback=lambda _: self.apply_auto()),
            ]))
        return LayoutSpec("vbox", children)


class BivariateColorMapController(ColorMapController):
    def apply_denslider(self, vmin: float, vmax: float):
        self.colormap.update_parameters({"density_vmin": vmin, "density_vmax": vmax})
        self.visualizer.invalidate(DrawReason.PRESENTATION_CHANGE)

    def get_layout(self) -> LayoutSpec:
        layout = super().get_layout()
        params = self.colormap.get_parameters()
        layout.children.append(LayoutSpec("hbox", [
            ControlSpec("range_den", "range_slider",
                        value=(params["density_vmin"], params["density_vmax"]),
                        range=params.get("ui_range_density", (0.0, 1.0)),
                        callback=lambda vv: self.apply_denslider(*vv),
                        label="density"),
        ]))
        return LayoutSpec("vbox", layout.children)


class RGBMapController(GenericController):
    """Magnitude-range + gamma controls for stellar RGB rendering."""

    def apply_mag_range(self, mag_pair):
        lo, hi = mag_pair
        self.visualizer.colormap.update_parameters({"min_mag": lo, "max_mag": hi})
        self.visualizer.invalidate(DrawReason.PRESENTATION_CHANGE)

    def apply_gamma(self, g: float):
        self.visualizer.colormap.update_parameters({"gamma": g})
        self.visualizer.invalidate(DrawReason.PRESENTATION_CHANGE)

    def get_layout(self) -> LayoutSpec:
        params = self.visualizer.colormap.get_parameters()
        return LayoutSpec("vbox", [
            ControlSpec("mag_range", "range_slider", label='mag/"^2',
                        range=(15.0, 40.0),
                        value=(params["min_mag"], params["max_mag"]),
                        callback=self.apply_mag_range),
            ControlSpec("gamma", "slider", label="gamma", range=(0.25, 8.0),
                        value=params["gamma"], callback=self.apply_gamma),
        ])


class SurfaceMapController(ColorMapController):
    @classmethod
    def hex2rgbfloat(cls, hex_color: str):
        hex_color = hex_color.lstrip("#")
        return tuple(int(hex_color[i:i + 2], 16) / 255.0 for i in (0, 2, 4))

    @classmethod
    def rgbfloat2hex(cls, rgb) -> str:
        return "#{:02x}{:02x}{:02x}".format(*(int(c * 255) for c in rgb[:3]))

    def set_den_cut(self, val):
        self.visualizer._sph.set_density_cut_percentile(val)
        self.visualizer.invalidate(DrawReason.CHANGE)

    def set_smoothing_scale(self, val):
        self.visualizer.colormap.update_parameters({"smoothing_scale": val})
        self.visualizer.invalidate(DrawReason.PRESENTATION_CHANGE)

    def set_diffuse_lighting(self, color: str):
        self.visualizer.colormap.update_parameters(
            {"light_color": self.hex2rgbfloat(color)})
        self.visualizer.invalidate(DrawReason.PRESENTATION_CHANGE)

    def set_ambient_lighting(self, color: str):
        self.visualizer.colormap.update_parameters(
            {"ambient_color": self.hex2rgbfloat(color)})
        self.visualizer.invalidate(DrawReason.PRESENTATION_CHANGE)

    def get_layout(self) -> LayoutSpec:
        suppress_range = self.visualizer.quantity_name is None
        standard = super().get_layout(suppress_range=suppress_range).children
        params = self.visualizer.colormap.get_parameters()
        sph_ = self.visualizer._sph
        return LayoutSpec("vbox", [
            ControlSpec("den_percentile_threshold", "slider",
                        label="Density percentile",
                        range=sph_.get_density_cut_percentile_range(),
                        value=sph_.get_density_cut_percentile(),
                        callback=self.set_den_cut),
            ControlSpec("smoothing_scale", "slider", label="Surface smoothing",
                        range=(0.0, 0.05), value=params["smoothing_scale"],
                        callback=self.set_smoothing_scale),
            LayoutSpec("hbox", [
                ControlSpec("diffuse_lighting", "color_picker", label="Diffuse light",
                            value=self.rgbfloat2hex(params["light_color"]),
                            callback=self.set_diffuse_lighting),
                ControlSpec("ambient_lighting", "color_picker", label="Ambient light",
                            value=self.rgbfloat2hex(params["ambient_color"]),
                            callback=self.set_ambient_lighting),
            ]),
        ] + standard)


class UnifiedColorMapController(GenericController):
    """Adds a render-mode dropdown above the mode-specific controls
    (reference: colormap/ui.py:325-390)."""

    def __init__(self, visualizer, refresh_ui_callback=None):
        super().__init__(visualizer, refresh_ui_callback)
        self._controller = self._get_controller_for_mode(visualizer.render_mode)

    def _get_controller_for_mode(self, mode: str) -> GenericController:
        if mode in ("univariate", "density"):
            return ColorMapController(self.visualizer, self._refresh_wrapper)
        if mode == "bivariate":
            return BivariateColorMapController(self.visualizer, self._refresh_wrapper)
        if mode in ("rgb", "rgb-hdr"):
            return RGBMapController(self.visualizer, self._refresh_wrapper)
        if mode == "surface":
            return SurfaceMapController(self.visualizer, self._refresh_wrapper)
        raise ValueError(f"Unknown render mode: {mode}")

    def _update_mode(self, mode: str):
        try:
            self.visualizer.render_mode = mode
            self._controller = self._get_controller_for_mode(self.visualizer.render_mode)
        except ValueError as e:
            logger.error("Failed to set render mode: %s", e)
        self.refresh_ui()

    def _mode_dropdown(self) -> ControlSpec:
        return ControlSpec("render_mode", "combo",
                           options=["univariate", "bivariate", "rgb", "rgb-hdr",
                                    "surface"],
                           value=self.visualizer.render_mode,
                           callback=self._update_mode)

    def _refresh_wrapper(self, root_spec: LayoutSpec, new_widgets: bool):
        if self._refresh_ui_callback is not None:
            self._refresh_ui_callback(self._wrap(root_spec), new_widgets)

    def get_layout(self) -> LayoutSpec:
        if hasattr(self, "_controller"):
            controls = self._controller.get_layout()
        else:
            controls = LayoutSpec("vbox", [ControlSpec(
                "placeholder", "label", value="No controls available")])
        return self._wrap(controls)

    def _wrap(self, controls: LayoutSpec) -> LayoutSpec:
        return LayoutSpec("vbox", [self._mode_dropdown(), controls])
