"""Bilateral depth filtering for surface rendering.

Counterpart of ``topsy_tpu/ops/smooth.py`` (plain tensor code there too):
a brute-force bilateral filter over a (kernel_size)^2 neighbourhood of one
channel, edges clamped, other channels untouched.  The offsets are taken
one row of the neighbourhood at a time: the kernel_size shifted copies of a
row offset are stacked and reduced together, so a 1024^2 image with the
default smoothing (kernel size 41, 1,681 offsets) costs 41 steps.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import config


def smoothing_kernel_size(spatial_sigma: float) -> int:
    """Kernel size rule of the reference (colormap/surface.py:270-275)."""
    n_pix = int(spatial_sigma * 4) + 1
    return min(n_pix, config.MAX_SURFACE_SMOOTH_PIXELS)


def bilateral_filter(image: torch.Tensor, spatial_sigma: float,
                     range_sigma: float, kernel_size: int,
                     channel: int = 1) -> torch.Tensor:
    """Bilateral-filter one channel of (H, W, C); edges use clamped
    samples."""
    half = kernel_size // 2
    depth = image[..., channel]
    H, W = depth.shape
    padded = F.pad(depth[None, None], (half, half, half, half),
                   mode="replicate")[0, 0]
    sig_s = torch.tensor(spatial_sigma, dtype=torch.float32)
    sig_r = torch.tensor(range_sigma, dtype=torch.float32)
    inv_2ss = (1.0 / (2.0 * sig_s * sig_s)).item()
    inv_2rs = (1.0 / (2.0 * sig_r * sig_r)).item()
    dxs = torch.arange(-half, half + 1, device=image.device)
    wsum = torch.zeros_like(depth)
    vsum = torch.zeros_like(depth)
    for dy in range(-half, half + 1):
        band = padded[half + dy:half + dy + H]                  # (H, W + 2h)
        shifted = band.unfold(1, W, 1).permute(1, 0, 2)         # (k, H, W)
        spatial2 = (dy * dy + dxs * dxs).to(torch.float32)
        w_spatial = torch.exp(-spatial2 * inv_2ss)[:, None, None]
        diff = shifted - depth
        w = w_spatial * torch.exp(-(diff * diff) * inv_2rs)
        wsum = wsum + w.sum(dim=0)
        vsum = vsum + (shifted * w).sum(dim=0)
    out = image.clone()
    out[..., channel] = vsum / wsum
    return out


def smooth_image(image, smoothing_scale: float,
                 resolution: int | None = None, channel: int = 1):
    """The reference's parameterization: spatial sigma in pixels is
    smoothing_scale * width; range sigma is 2 * smoothing_scale."""
    image = torch.as_tensor(image)
    if resolution is None:
        resolution = image.shape[1]
    sig = max(smoothing_scale, 1e-5)
    spatial_sigma = sig * resolution
    range_sigma = sig * 2.0
    ks = smoothing_kernel_size(spatial_sigma)
    return bilateral_filter(image, spatial_sigma, range_sigma,
                            kernel_size=ks, channel=channel)
