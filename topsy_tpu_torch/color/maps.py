"""Univariate colormap: raw (mass, mass * quantity) maps -> RGBA images.

Counterpart of the univariate part of ``topsy_tpu/color/maps.py``
(``_map_univariate``, ``sample_lut_1d``, ``fit_to_window``, ``ColormapBase``,
``NoColormap``, ``Colormap``) on tensors: log/linear scaling, a linear 1-D
LUT lookup, device-side percentile autoranging and the photometric
mass-scale shift of vmin/vmax.  The bivariate, RGB and HDR maps are ROADMAP
item M10.

LUTs come from matplotlib when it is installed; without it, from
``luts.npz`` beside this module (the same matplotlib samples, stored for a
few common colormaps).
"""

from __future__ import annotations

import functools
import logging
import os

import numpy as np
import torch
import torch.nn.functional as F

from .. import config

logger = logging.getLogger(__name__)

_LUT_FILE = os.path.join(os.path.dirname(__file__), "luts.npz")


def _log10(x):
    return torch.log(x) / 2.30258509


@functools.lru_cache(maxsize=None)
def lut_rgba(name: str, num_points: int) -> np.ndarray:
    """(num_points, 4) f32 RGBA samples of a colormap at linspace(0.001,
    0.999)."""
    try:
        import matplotlib
    except ImportError:
        stored = np.load(_LUT_FILE)
        if name not in stored.files or len(stored[name]) != num_points:
            raise KeyError(f"colormap {name!r} with {num_points} samples "
                           "needs matplotlib") from None
        return stored[name]
    cmap = matplotlib.colormaps[name]
    return cmap(np.linspace(0.001, 0.999, num_points)).astype(np.float32)


def sample_lut_1d(values: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """Linear-interpolated 1-D LUT lookup; values already in [0, 1]."""
    n = lut.shape[0]
    x = torch.clamp(values, 0.0, 1.0) * (n - 1)
    i0 = torch.clamp(x.to(torch.int32), 0, n - 2).long()
    frac = (x - i0.to(torch.float32))[..., None]
    return lut[i0] * (1 - frac) + lut[i0 + 1] * frac


def _map_univariate(raw, lut, vmin, vmax, *, log, weighted):
    value = raw[..., 1] / raw[..., 0] if weighted else raw[..., 0]
    if log:
        value = _log10(value)
    norm = torch.clamp((value - vmin) / (vmax - vmin), 0.0, 1.0)
    norm = torch.where(torch.isfinite(norm), norm, 0.0)
    return sample_lut_1d(norm, lut)


def fit_to_window(square: torch.Tensor, width: int,
                  height: int) -> torch.Tensor:
    """Aspect-ratio central crop + bilinear resize (half-pixel centres, no
    antialiasing) of the square render onto a (height, width) window."""
    s = square.shape[0]
    aspect = width / height
    if aspect >= 1.0:
        vis = max(2, int(round(s / aspect)))
        r0 = (s - vis) // 2
        cropped = square[r0:r0 + vis, :, :]
    else:
        vis = max(2, int(round(s * aspect)))
        c0 = (s - vis) // 2
        cropped = square[:, c0:c0 + vis, :]
    chw = cropped.permute(2, 0, 1)[None]
    out = F.interpolate(chw, size=(height, width), mode="bilinear",
                        align_corners=False, antialias=False)
    return out[0].permute(1, 2, 0)


COLORMAP_REGISTRY: list[type["ColormapBase"]] = []


def resolve_colormap_class(parameters: dict) -> type["ColormapBase"] | None:
    for cls in COLORMAP_REGISTRY:
        if cls.accepts_parameters(parameters):
            return cls
    return None


class ColormapBase:
    _default_params: dict = {}

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        COLORMAP_REGISTRY.append(cls)

    def __init__(self, params: dict):
        self._params = self._default_params | params

    @classmethod
    def accepts_parameters(cls, parameters: dict) -> bool:
        return False

    def update_parameters(self, parameters: dict):
        if not self.accepts_parameters(self._params | parameters):
            raise ValueError(f"{self.__class__.__name__} does not accept "
                             f"parameter update: {parameters}")
        self._params.update(parameters)

    def get_parameter(self, name: str):
        return self._params.get(name, None)

    def get_parameters(self) -> dict:
        return self._params.copy()

    def to_rgba(self, raw_image, mass_scale: float = 1.0) -> torch.Tensor:
        raise NotImplementedError

    def sph_raw_output_to_content(self, image) -> np.ndarray:
        """The logical content of a raw image (array or tensor), on the
        host."""
        raise NotImplementedError

    def autorange_vmin_vmax(self, vals):
        raise NotImplementedError


class NoColormap(ColormapBase):
    """Placeholder before a mode is selected."""

    @classmethod
    def accepts_parameters(cls, parameters: dict) -> bool:
        return parameters.get("type", None) == "none"


class Colormap(ColormapBase):
    """Univariate density / weighted-average colormap."""

    input_channels = 2
    percentile_scaling = config.AUTORANGE_PERCENTILES
    may_produce_weighted_average = True

    _default_params = {"colormap_name": "viridis", "vmin": 0.0, "vmax": 1.0,
                       "log": True, "weighted_average": False}

    def __init__(self, params: dict):
        super().__init__(params)
        self._lut = None
        self._lut_for = None

    @classmethod
    def accepts_parameters(cls, parameters: dict) -> bool:
        return parameters.get("type", None) == "density"

    def lut(self, device) -> torch.Tensor:
        name = self._params.get("colormap_name", config.DEFAULT_COLORMAP)
        key = (name, str(device))
        if self._lut is None or self._lut_for != key:
            self._lut = torch.as_tensor(
                lut_rgba(name, config.COLORMAP_NUM_SAMPLES), device=device)
            self._lut_for = key
        return self._lut

    def sph_raw_output_to_content(self, image) -> np.ndarray:
        numpy_image = torch.as_tensor(image).cpu().numpy()
        if self._params["weighted_average"]:
            with np.errstate(invalid="ignore", divide="ignore"):
                return numpy_image[..., 1] / numpy_image[..., 0]
        return numpy_image[..., 0]

    def _effective_vmin_vmax(self, mass_scale: float):
        vmin, vmax = self._params["vmin"], self._params["vmax"]
        if (self.may_produce_weighted_average
                and self._params.get("weighted_average", False)):
            mass_scale = 1.0
        if self._params["log"]:
            shift = np.log10(mass_scale)
            return vmin - shift, vmax - shift
        return vmin / mass_scale, vmax / mass_scale

    def to_rgba(self, raw_image: torch.Tensor,
                mass_scale: float = 1.0) -> torch.Tensor:
        vmin, vmax = self._effective_vmin_vmax(mass_scale)
        dev = raw_image.device
        return _map_univariate(
            raw_image, self.lut(dev),
            torch.tensor(vmin, dtype=torch.float32, device=dev),
            torch.tensor(vmax, dtype=torch.float32, device=dev),
            log=bool(self._params["log"]),
            weighted=bool(self._params.get("weighted_average", False)))

    # -- autorange ---------------------------------------------------------------

    def autorange_vmin_vmax(self, vals):
        if isinstance(vals, torch.Tensor):
            self._autorange_using_values(
                self._raw_to_content_device(vals).reshape(-1))
        else:
            self._autorange_using_values(torch.as_tensor(
                self.sph_raw_output_to_content(np.asarray(vals)).ravel()))

    def _raw_to_content_device(self, raw: torch.Tensor) -> torch.Tensor:
        if self._params["weighted_average"]:
            return raw[..., 1] / raw[..., 0]
        return raw[..., 0]

    def _autorange_using_values(self, vals: torch.Tensor):
        from ..ops import stats
        new_params = {}
        lin_p, n_lin, vmin, vmax = stats.percentiles(vals,
                                                     self.percentile_scaling)
        log_p, n_log, log_min, log_max = stats.percentiles(
            torch.log10(vals), self.percentile_scaling)
        any_neg = bool((vals < 0).any().item())

        if log_max == log_min:
            log_max += 1.0
            log_min -= 1.0
        if vmax == vmin:
            vmax += 1.0
            vmin -= 1.0
        new_params["ui_range_linear"] = (vmin, vmax)
        new_params["ui_range_log"] = (log_min, log_max)
        new_params["log"] = not any_neg

        use_p, use_n = (log_p, n_log) if new_params["log"] else (lin_p, n_lin)
        if use_n > 2 and use_p is not None:
            self._params["vmin"], self._params["vmax"] = \
                float(use_p[0]), float(use_p[-1])
        else:
            logger.warning("Unable to autorange: too few finite values")
            self._params["vmin"], self._params["vmax"] = 0.0, 1.0
        self.update_parameters(new_params)
        logger.info("Autoscale: log=%s vmin=%.4g vmax=%.4g",
                    self._params["log"], self._params["vmin"],
                    self._params["vmax"])
