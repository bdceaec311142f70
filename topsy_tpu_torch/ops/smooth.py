"""Bilateral depth filtering for surface rendering.

Counterpart of ``topsy_tpu/ops/smooth.py`` (plain tensor code there too):
a brute-force bilateral filter over a (kernel_size)^2 neighbourhood of one
channel, edges clamped, other channels untouched.

``bilateral_filter`` runs a hand-written CUDA kernel
(``csrc/bilateral.cu``, one launch) on CUDA tensors and the plain version
(``bilateral_filter_plain``) on others.  The plain version takes the
offsets one row of the neighbourhood at a time: the kernel_size shifted
copies of a row offset are stacked and reduced together, so a 1024^2 image
with the default smoothing (kernel size 41, 1,681 offsets) costs 41 steps.
The kernel does each tap's float32 operations as the plain version does and
sums each neighbourhood row before adding it to the totals; only the order
of the sums differs.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from .. import config
from ..performance import counters


def smoothing_kernel_size(spatial_sigma: float) -> int:
    """Kernel size rule of the reference (colormap/surface.py:270-275)."""
    n_pix = int(spatial_sigma * 4) + 1
    return min(n_pix, config.MAX_SURFACE_SMOOTH_PIXELS)


def _inv_two_squares(sigma: float) -> float:
    """1 / (2 sigma^2), rounded as float32 operations."""
    sig = torch.tensor(sigma, dtype=torch.float32)
    return (1.0 / (2.0 * sig * sig)).item()


def bilateral_filter_plain(image: torch.Tensor, spatial_sigma: float,
                           range_sigma: float, kernel_size: int,
                           channel: int = 1) -> torch.Tensor:
    """Bilateral-filter one channel of (H, W, C) in plain PyTorch; edges
    use clamped samples."""
    half = kernel_size // 2
    depth = image[..., channel]
    H, W = depth.shape
    padded = F.pad(depth[None, None], (half, half, half, half),
                   mode="replicate")[0, 0]
    inv_2ss = _inv_two_squares(spatial_sigma)
    inv_2rs = _inv_two_squares(range_sigma)
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


#: ``topsy_bilateral_filter``'s answer for a kernel size whose tile and
#: spatial weights do not fit a block's shared memory (above 157 on an H100;
#: the surface's cap is 101 taps)
_TOO_LARGE = -1


@functools.lru_cache(maxsize=None)
def _bind():
    from . import cuda_build
    fn = cuda_build.library("bilateral").topsy_bilateral_filter
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [P, P, I, I, I, I, L, L, L, L, L, L, I, ctypes.c_float,
                   ctypes.c_float, P]
    fn.restype = I
    return fn


def bilateral_filter_cuda(image: torch.Tensor, spatial_sigma: float,
                          range_sigma: float, kernel_size: int,
                          channel: int = 1) -> torch.Tensor:
    """``bilateral_filter_plain`` by the kernel (``csrc/bilateral.cu``),
    launched on the current stream into a new image of ``image``'s layout:
    a CUDA float32 (H, W, C) tensor of any strides, and a kernel size whose
    tile fits a block's shared memory."""
    if not image.is_cuda:
        raise ValueError(f"image: expected a CUDA tensor, got {image.device}")
    if image.dtype != torch.float32:
        raise TypeError(f"image: expected torch.float32, got {image.dtype}")
    if image.dim() != 3:
        raise ValueError(f"image: expected (H, W, C), got shape "
                         f"{tuple(image.shape)}")
    H, W, C = image.shape
    if not -C <= channel < C:
        raise ValueError(f"channel {channel} out of range for {C} channels")
    if kernel_size < 1:
        raise ValueError(f"kernel_size {kernel_size} below 1")
    out = torch.empty_like(image)
    with torch.cuda.device(image.device):     # the launch's current device
        err = _bind()(image.data_ptr(), out.data_ptr(), H, W, C, channel % C,
                      *image.stride(), *out.stride(), kernel_size // 2,
                      _inv_two_squares(spatial_sigma),
                      _inv_two_squares(range_sigma),
                      torch.cuda.current_stream().cuda_stream)
    if err == _TOO_LARGE:
        raise ValueError(f"kernel_size {kernel_size}: its tile does not fit "
                         f"a block's shared memory on {image.device}")
    if err != 0:
        raise RuntimeError(f"bilateral filter kernel launch failed: "
                           f"cudaError {err}")
    counters["filter_launches"] += 1
    return out


def bilateral_filter(image: torch.Tensor, spatial_sigma: float,
                     range_sigma: float, kernel_size: int,
                     channel: int = 1) -> torch.Tensor:
    """Bilateral-filter one channel of (H, W, C); edges use clamped
    samples.  The kernel for a CUDA tensor, the plain version otherwise."""
    if image.is_cuda:
        return bilateral_filter_cuda(image, spatial_sigma, range_sigma,
                                     kernel_size, channel)
    return bilateral_filter_plain(image, spatial_sigma, range_sigma,
                                  kernel_size, channel)


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
