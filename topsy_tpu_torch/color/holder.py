"""The visualizer's handle on whichever colormap is currently active.

Counterpart of ``topsy_tpu/color/holder.py``: one stable object; parameter
updates merge into the live parameters, and when the merged parameters
leave the current implementation's domain, the registered class that
accepts them is built in its place.
"""

from __future__ import annotations

from .. import config

from . import maps

_DELEGATED = frozenset({
    "get_parameter", "get_parameters", "sph_raw_output_to_content",
    "to_rgba",
})

_INITIAL_PARAMS = {
    "type": "none",
    "colormap_name": config.DEFAULT_COLORMAP,
    "vmin": None,
    "vmax": None,
    "log": False,
}


class ColormapHolder:
    """Stable facade over the active :class:`maps.ColormapBase` instance."""

    def __init__(self):
        self._impl = maps.NoColormap(dict(_INITIAL_PARAMS))

    @property
    def impl(self) -> maps.ColormapBase:
        return self._impl

    def update_parameters(self, updates: dict) -> bool | None:
        """Merge ``updates``; True when a new implementation class was
        built, False when the current one took them."""
        merged = self._impl.get_parameters() | updates
        if type(self._impl).accepts_parameters(merged):
            self._impl.update_parameters(updates)
            return False
        cls = maps.resolve_colormap_class(merged)
        if cls is None:
            if isinstance(self._impl, maps.NoColormap):
                return None
            raise ValueError(f"No colormap class accepts parameters: {merged}")
        self._impl = cls(merged)
        return True

    def autorange(self, sph_render_output):
        self._require_active()
        self._impl.autorange_vmin_vmax(sph_render_output)

    def _require_active(self):
        if isinstance(self._impl, maps.NoColormap):
            raise ValueError("ColormapHolder is not fully initialized")

    def __getattr__(self, name: str):
        if name in _DELEGATED:
            if name not in ("get_parameter", "get_parameters"):
                self._require_active()
            return getattr(self._impl, name)
        raise AttributeError(
            f"{type(self).__name__!r} object has no attribute {name!r}")

    def __getitem__(self, key: str):
        return self._impl.get_parameter(key)

    def __setitem__(self, key: str, value):
        self.update_parameters({key: value})
