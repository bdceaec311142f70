"""Surface colormap: bilateral depth smoothing + screen-space lighting.

Counterpart of ``ColorAsSurfaceMap`` in ``topsy_tpu/color/surface.py`` on
tensors: the (value, depth) map from the surface renderer is depth-smoothed
with the bilateral filter (``ops/smooth.py``), then lit with normals from
central differences of the depth field, diffuse + ambient, optionally with
a material colour from a 1-D colormap of the value channel.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import config
from ..ops.smooth import smooth_image
from ..performance import signposter
from .maps import Colormap, _log10, sample_lut_1d


class ColorAsSurfaceMap(Colormap):
    input_channels = 2

    _default_params = {
        "depth_scale": 1.0,
        "light_direction": [0.0, 1.0 / np.sqrt(2.0), 1.0 / np.sqrt(2.0)],
        "light_color": [1.0, 1.0, 1.0],
        "ambient_color": [0.0, 0.0, 0.2],
        "smoothing_scale": 0.01,
        "weighted_average": False,
        "vmin": 0.0,
        "vmax": 1.0,
        "log": False,
        "colormap_name": config.DEFAULT_COLORMAP,
    }

    @classmethod
    def accepts_parameters(cls, parameters: dict) -> bool:
        return parameters.get("type", None) == "surface"

    def sph_raw_output_to_content(self, numpy_image) -> np.ndarray:
        """The smoothed (value, depth) map, smoothed on the device where
        ``numpy_image`` (an array or a tensor) lies."""
        return smooth_image(torch.as_tensor(numpy_image),
                            self._params.get("smoothing_scale", 0.01)
                            ).cpu().numpy()

    def autorange_vmin_vmax(self, vals):
        if not self._params.get("weighted_average", False):
            return  # vmin/vmax drive only the material colormap
        vals = torch.as_tensor(vals)
        valid = vals[..., 1].reshape(-1) > 0.0
        self._autorange_using_values(vals[..., 0].reshape(-1)[valid])

    def to_rgba(self, raw_image, mass_scale: float = 1.0) -> torch.Tensor:
        # occlusion output needs no photometric rescaling (max semantics)
        raw_image = torch.as_tensor(raw_image)
        dev = raw_image.device
        with signposter.use_interval("topsy.filter"):
            smoothed = smooth_image(raw_image,
                                    self._params.get("smoothing_scale", 0.01))
        value = smoothed[..., 0]
        depth = smoothed[..., 1] * self._params.get("depth_scale", 1.0)

        H, W = depth.shape
        texel = 1.0 / W  # normal z component

        # central differences with clamped edges (texture sampler semantics)
        pad = F.pad(depth[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
        dX = (pad[1:-1, 2:] - pad[1:-1, :-2]) * 0.5
        dY = (pad[2:, 1:-1] - pad[:-2, 1:-1]) * 0.5
        norm = torch.sqrt(dX * dX + dY * dY + texel * texel)
        nx, ny, nz = -dX / norm, -dY / norm, texel / norm

        light = np.asarray(self._params.get("light_direction", [0.0, 0.0, 1.0]),
                           dtype=np.float32)
        n_dot_l = torch.clamp(nx * float(light[0]) + ny * float(light[1])
                              + nz * float(light[2]), min=0.0)

        if self._params.get("weighted_average", False):
            v = _log10(value) if self._params.get("log", False) else value
            vmin, vmax = self._params["vmin"], self._params["vmax"]
            v = torch.clamp((v - vmin) / (vmax - vmin), 0.0, 1.0)
            v = torch.where(torch.isfinite(v), v, 0.0)
            material = sample_lut_1d(v, self.lut(dev))[..., :3]
        else:
            material = torch.ones((H, W, 3), dtype=torch.float32, device=dev)

        light_color = torch.tensor(
            self._params.get("light_color", [1.0, 1.0, 1.0]),
            dtype=torch.float32, device=dev)
        ambient = torch.tensor(
            self._params.get("ambient_color", [0.2, 0.2, 0.2]),
            dtype=torch.float32, device=dev)
        shade = (light_color * n_dot_l[..., None] * material
                 + ambient * material)
        shade = shade * (torch.clamp(depth, 0.0, 0.5) * 2.0)[..., None]
        alpha = torch.ones((H, W, 1), dtype=torch.float32, device=dev)
        return torch.cat([shade, alpha], dim=-1)
