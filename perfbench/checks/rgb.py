"""The check of an RGB stellar-light image (``render_mode`` rgb): the raw
(I, V, U) band image and its RGB tonemap.

* ``raw_max_rel``: the largest pixel difference of the raw image in any of
  the three bands as a share of that band's largest absolute reference
  value (infinite where the program's image is not finite);
* ``rgba_mean_abs``: the mean absolute difference of the presented 8-bit
  RGB, in levels.

The reference is plain PyTorch, with TF32 off while it computes.  The raw
image is ``reference.additive`` with the three band masses as the values.
The tonemap is a frozen copy of the port's ``color/maps.py``
(``RGBColormap.autorange_vmin_vmax`` and ``_map_rgb``), which departs from
upstream topsy's RGB path in these ways, each kept here as the port has it:

* the autorange takes the 99.9th percentile of the finite log10 band
  values of the starting view by ``reference._percentiles``' 4096-bin
  histogram (upstream: ``np.nanpercentile`` over the image read back), the
  largest finite value where 200 or fewer are finite, and ``vmax - 3`` dex
  as ``vmin``;
* the map is applied per band on the device: log10, ``(v - vmin) / (vmax -
  vmin)`` clamped at 0 with non-finite values set to 0, ``^gamma`` (gamma
  1), clipped to [0, 1], alpha 1 (upstream: the same formula in a WGSL
  shader);
* the frame is ``reference.present``: fit to the canvas, 8 bits.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from perfbench import check, reference
from perfbench.checks.additive import compare  # noqa: F401  (3 bands)

MAX_PERCENTILE = 99.9
DYNAMIC_RANGE = 3.0
GAMMA = 1.0


@contextlib.contextmanager
def no_tf32():
    """float32 matrix products in float32, not TF32, inside the block."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn


def autorange(raw) -> dict:
    """The RGB map's range from a raw band image: ``vmax`` the 99.9th
    percentile of the finite log10 values, ``vmin`` 3 dex below."""
    p, n, _, hi = reference._percentiles(torch.log10(raw.reshape(-1).float()),
                                         (MAX_PERCENTILE,))
    if n > 200:
        vmax = float(p[0])
    elif n > 2:
        vmax = hi
    else:
        vmax = 1.0
    return {"vmin": vmax - DYNAMIC_RANGE, "vmax": vmax, "log": True}


def rgb_rgba(raw, cmap: dict):
    """RGBA of a raw (H, W, 3) band image under ``cmap``."""
    f32 = lambda x: float(np.float32(x))  # noqa: E731
    vmin, vmax = f32(cmap["vmin"]), f32(cmap["vmax"])
    value = torch.log(raw) / 2.30258509
    norm = torch.clamp((value - vmin) / (vmax - vmin), min=0.0)
    norm = torch.where(torch.isfinite(norm), norm, torch.zeros_like(norm))
    mapped = torch.clamp(norm ** f32(GAMMA), 0.0, 1.0)
    return torch.cat([mapped, torch.ones_like(mapped[..., :1])], dim=-1)


class Reference:
    """The reference renders of the configuration over the seed's
    snapshot, in ``dtype`` (float32; bfloat16 for the control)."""

    def __init__(self, config, seed, device, setup_view, dtype=torch.float32):
        self.config = config
        self.dtype = dtype
        snap = check.snapshot(config, seed, device)
        self.ps, self.bands = snap["pos_smooth"], snap["rgb"]
        self.res = config["resolution"]
        self.cmap = autorange(self.raw(setup_view))

    def raw(self, view):
        with no_tf32():
            return reference.additive(self.ps, self.bands, check.matrix(view),
                                      self.res, view["scale"],
                                      dtype=self.dtype)

    def frame(self, raw):
        w, h = self.config["canvas"]
        with no_tf32():
            return reference.present(rgb_rgba(raw, self.cmap), w, h)
