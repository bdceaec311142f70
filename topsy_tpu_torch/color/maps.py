"""Colormaps: raw SPH maps -> RGBA images.

Counterpart of ``topsy_tpu/color/maps.py`` on tensors (``_map_univariate``,
``_map_rgb``, ``_map_bivariate``, ``sample_lut_1d``, ``sample_lut_2d``,
``fit_to_window``, ``ColormapBase``, ``NoColormap``, ``Colormap``,
``RGBColormap``, ``RGBHDRColormap``, ``BivariateColormap``): log/linear
scaling, linear 1-D and bilinear 2-D LUT lookups, the RGB gamma tonemap
(clipped, or unclipped for HDR) with its mag/arcsec^2 parametrisation,
device-side percentile autoranging and the photometric mass-scale shift of
vmin/vmax.

LUTs come from matplotlib when it is installed; without it, from
``luts.npz`` beside this module (the same matplotlib samples, stored for a
few common colormaps).  The bivariate 2-D LUT is built from those 1-D
samples with numpy copies of matplotlib's HSV conversions.
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


def sample_lut_2d(u: torch.Tensor, v: torch.Tensor,
                  lut: torch.Tensor) -> torch.Tensor:
    """Bilinear 2-D LUT lookup; u indexes rows, v columns, both in [0, 1]."""
    n, m = lut.shape[0], lut.shape[1]
    x = torch.clamp(u, 0.0, 1.0) * (n - 1)
    y = torch.clamp(v, 0.0, 1.0) * (m - 1)
    i0 = torch.clamp(x.to(torch.int32), 0, n - 2).long()
    j0 = torch.clamp(y.to(torch.int32), 0, m - 2).long()
    fx = (x - i0.to(torch.float32))[..., None]
    fy = (y - j0.to(torch.float32))[..., None]
    v00 = lut[i0, j0]
    v01 = lut[i0, j0 + 1]
    v10 = lut[i0 + 1, j0]
    v11 = lut[i0 + 1, j0 + 1]
    return (v00 * (1 - fx) * (1 - fy) + v01 * (1 - fx) * fy
            + v10 * fx * (1 - fy) + v11 * fx * fy)


def _map_univariate(raw, lut, vmin, vmax, *, log, weighted):
    value = raw[..., 1] / raw[..., 0] if weighted else raw[..., 0]
    if log:
        value = _log10(value)
    norm = torch.clamp((value - vmin) / (vmax - vmin), 0.0, 1.0)
    norm = torch.where(torch.isfinite(norm), norm, 0.0)
    return sample_lut_1d(norm, lut)


def _map_rgb(raw, vmin, vmax, gamma, *, log, clip):
    value = _log10(raw) if log else raw
    norm = torch.clamp((value - vmin) / (vmax - vmin), min=0.0)
    norm = torch.where(torch.isfinite(norm), norm, 0.0)
    mapped = norm ** gamma
    if clip:
        mapped = torch.clamp(mapped, 0.0, 1.0)
    return torch.cat([mapped, torch.ones_like(mapped[..., :1])], dim=-1)


def _map_bivariate(raw, lut, vmin, vmax, dmin, dmax, *, log, weighted):
    den = _log10(raw[..., 0])
    u = (den - dmin) / (dmax - dmin)
    val = raw[..., 1] / raw[..., 0] if weighted else raw[..., 0]
    if log:
        val = _log10(val)
    v = (val - vmin) / (vmax - vmin)
    u = torch.where(torch.isfinite(u), u, 0.0)
    v = torch.where(torch.isfinite(v), v, 0.0)
    # LUT rows are colour (quantity), columns lightness (density)
    return sample_lut_2d(v, u, lut)


def rgb_to_hsv(arr: np.ndarray) -> np.ndarray:
    """A numpy copy of ``matplotlib.colors.rgb_to_hsv`` (matplotlib 3.10)
    for float RGB in [0, 1], without its range checks, so that the
    bivariate LUT builds where matplotlib is not installed."""
    arr = np.asarray(arr, dtype=np.promote_types(np.asarray(arr).dtype,
                                                 np.float32))
    in_shape = arr.shape
    arr = arr.reshape(-1, 3)
    out = np.zeros_like(arr)
    arr_max = arr.max(-1)
    ipos = arr_max > 0
    delta = np.ptp(arr, -1)
    s = np.zeros_like(delta)
    s[ipos] = delta[ipos] / arr_max[ipos]
    ipos = delta > 0
    idx = (arr[..., 0] == arr_max) & ipos
    out[idx, 0] = (arr[idx, 1] - arr[idx, 2]) / delta[idx]
    idx = (arr[..., 1] == arr_max) & ipos
    out[idx, 0] = 2. + (arr[idx, 2] - arr[idx, 0]) / delta[idx]
    idx = (arr[..., 2] == arr_max) & ipos
    out[idx, 0] = 4. + (arr[idx, 0] - arr[idx, 1]) / delta[idx]
    out[..., 0] = (out[..., 0] / 6.0) % 1.0
    out[..., 1] = s
    out[..., 2] = arr_max
    return out.reshape(in_shape)


def hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    """A numpy copy of ``matplotlib.colors.hsv_to_rgb`` (matplotlib 3.10)
    for HSV in [0, 1]."""
    hsv = np.asarray(hsv, dtype=np.promote_types(np.asarray(hsv).dtype,
                                                 np.float32))
    in_shape = hsv.shape
    hsv = hsv.reshape(-1, 3)
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    r, g, b = np.empty_like(h), np.empty_like(h), np.empty_like(h)
    i = (h * 6.0).astype(int)
    f = (h * 6.0) - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    for idx, (rr, gg, bb) in (
            (i % 6 == 0, (v, t, p)), (i == 1, (q, v, p)),
            (i == 2, (p, v, t)), (i == 3, (p, q, v)), (i == 4, (t, p, v)),
            (i == 5, (v, p, q)), (s == 0, (v, v, v))):
        r[idx], g[idx], b[idx] = rr[idx], gg[idx], bb[idx]
    return np.stack([r, g, b], axis=-1).reshape(in_shape)


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

    def _generate_mapping_rgba_f32(self, num_points: int) -> np.ndarray:
        return lut_rgba(self._params.get("colormap_name",
                                         config.DEFAULT_COLORMAP), num_points)

    def lut(self, device) -> torch.Tensor:
        name = self._params.get("colormap_name", config.DEFAULT_COLORMAP)
        key = (name, str(device))
        if self._lut is None or self._lut_for != key:
            self._lut = torch.as_tensor(
                self._generate_mapping_rgba_f32(config.COLORMAP_NUM_SAMPLES),
                device=device)
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


class RGBColormap(Colormap):
    """Three-band (I, V, U) rendering with the magnitude per arcsec^2
    parametrisation of vmin / vmax."""

    input_channels = 3
    max_percentile = 99.9
    dynamic_range = 3.0
    may_produce_weighted_average = False

    _sterrad_to_arcsec2 = 2.3504430539466191e-11

    _default_params = {"vmin": 0.0, "vmax": 1.0, "log": True, "gamma": 1.0}

    @classmethod
    def accepts_parameters(cls, parameters: dict) -> bool:
        parameters = cls._default_params | parameters
        return (parameters.get("type", None) == "rgb"
                and not parameters.get("hdr", False) and parameters["log"])

    @classmethod
    def _log_output_to_mag_per_arcsec2(cls, val):
        if val is None:
            return None
        # +4: (10 pc -> kpc)^2
        return -2.5 * (val + np.log10(cls._sterrad_to_arcsec2) - 4)

    @classmethod
    def _mag_per_arcsec2_to_log_output(cls, val):
        if val is None:
            return None
        return val / -2.5 + 4 - np.log10(cls._sterrad_to_arcsec2)

    def get_parameters(self) -> dict:
        params = super().get_parameters()
        params["min_mag"] = self._log_output_to_mag_per_arcsec2(params["vmax"])
        params["max_mag"] = self._log_output_to_mag_per_arcsec2(params["vmin"])
        return params

    def get_parameter(self, name: str):
        if name == "min_mag":
            return self._log_output_to_mag_per_arcsec2(
                super().get_parameter("vmax"))
        if name == "max_mag":
            return self._log_output_to_mag_per_arcsec2(
                super().get_parameter("vmin"))
        return super().get_parameter(name)

    def update_parameters(self, parameters: dict):
        parameters = dict(parameters)
        if "min_mag" in parameters:
            parameters["vmax"] = self._mag_per_arcsec2_to_log_output(
                parameters.pop("min_mag"))
        if "max_mag" in parameters:
            parameters["vmin"] = self._mag_per_arcsec2_to_log_output(
                parameters.pop("max_mag"))
        ColormapBase.update_parameters(self, parameters)

    def sph_raw_output_to_content(self, image) -> np.ndarray:
        return torch.as_tensor(image).cpu().numpy()[..., :3]

    def to_rgba(self, raw_image: torch.Tensor,
                mass_scale: float = 1.0) -> torch.Tensor:
        vmin, vmax = self._effective_vmin_vmax(mass_scale)
        gamma = self._params.get("gamma", 1.0) or 1.0
        return _map_rgb(raw_image[..., :3], float(np.float32(vmin)),
                        float(np.float32(vmax)), float(np.float32(gamma)),
                        log=bool(self._params["log"]),
                        clip=not self.hdr_output())

    def hdr_output(self) -> bool:
        return False

    def autorange_vmin_vmax(self, vals):
        from ..ops import stats
        vals = torch.as_tensor(vals)
        p, n, _lo, hi = stats.percentiles(torch.log10(vals.reshape(-1)),
                                          self.max_percentile)
        if n > 200:
            self._params["vmax"] = float(p[0])
        elif n > 2:
            self._params["vmax"] = float(hi)
        else:
            logger.warning("Unable to autorange RGB map")
            self._params["vmax"] = 1.0
        self._params["vmin"] = self._params["vmax"] - self.dynamic_range
        logger.info("RGB autorange: vmin=%.4g vmax=%.4g",
                    self._params["vmin"], self._params["vmax"])


class RGBHDRColormap(RGBColormap):
    """HDR variant: a wider percentile, an SDR-equivalent dynamic range of
    2.5 dex, unclipped output for a float16 canvas."""

    max_percentile = 99.0
    dynamic_range = 2.5

    @classmethod
    def accepts_parameters(cls, parameters: dict) -> bool:
        parameters = cls._default_params | parameters
        return (parameters.get("type", None) == "rgb"
                and parameters.get("hdr", False) and parameters["log"])

    def hdr_output(self) -> bool:
        return True


class BivariateColormap(Colormap):
    """2-D LUT: hue from the quantity, lightness from the density."""

    default_quantity_name = "rho"

    _default_params = Colormap._default_params | {
        "density_vmin": 0.0, "density_vmax": 1.0,
        "ui_range_density": (0.0, 1.0)}

    @classmethod
    def accepts_parameters(cls, parameters: dict) -> bool:
        return (parameters.get("type", None) == "bivariate"
                and not parameters.get("hdr", False))

    def _generate_mapping_rgba_f32(self, num_points: int) -> np.ndarray:
        """(num_points, num_points, 4): rows the 1-D colormap's samples,
        columns their lightness from 0.001 to 0.999, desaturated over the
        last quarter."""
        rgba = np.ones((num_points, num_points, 4), dtype=np.float32)
        rgba[:, :, :] = lut_rgba(self._params["colormap_name"],
                                 num_points)[:, np.newaxis, :]
        hsv = rgb_to_hsv(rgba[..., :3])
        hsv[..., 2] = np.linspace(0.001, 0.999, num_points)[np.newaxis, :]
        reduce_saturation = np.ones(num_points)
        reduce_saturation[3 * num_points // 4:] = np.linspace(
            1.0, 0.0, num_points // 4)
        hsv[..., 1] *= reduce_saturation[np.newaxis, :]
        rgba[..., :3] = hsv_to_rgb(hsv)
        return rgba

    def sph_raw_output_to_content(self, image) -> np.ndarray:
        ret = torch.as_tensor(image).cpu().numpy().copy()
        if self._params["weighted_average"]:
            with np.errstate(invalid="ignore", divide="ignore"):
                ret[..., 1] /= ret[..., 0]
        else:
            ret[..., 1] = ret[..., 0]
        return ret

    def to_rgba(self, raw_image: torch.Tensor,
                mass_scale: float = 1.0) -> torch.Tensor:
        vmin, vmax = self._effective_vmin_vmax(mass_scale)
        dmin = self._params.get("density_vmin", 0.0) or 0.0
        dmax = self._params.get("density_vmax", 1.0) or 1.0
        shift = np.log10(mass_scale)
        f32 = lambda x: float(np.float32(x))  # noqa: E731
        return _map_bivariate(
            raw_image, self.lut(raw_image.device), f32(vmin), f32(vmax),
            f32(dmin - shift), f32(dmax - shift),
            log=bool(self._params["log"]),
            weighted=bool(self._params.get("weighted_average", False)))

    def autorange_vmin_vmax(self, vals):
        """Device percentiles of both axes: the log density's, then the
        content's (the univariate rule)."""
        from ..ops import stats
        vals = torch.as_tensor(vals)
        dp, dn, dlo, dhi = stats.percentiles(
            torch.log10(vals[..., 0].reshape(-1)), self.percentile_scaling)
        if dn > 2:
            density = (float(dp[0]), float(dp[-1]), (dlo, dhi))
        else:
            density = (0.0, 1.0, (np.nan, np.nan))
        self.update_parameters({"density_vmin": density[0],
                                "density_vmax": density[1],
                                "ui_range_density": density[2]})
        self._autorange_using_values(
            self._raw_to_content_device(vals).reshape(-1))
