"""The surface's bilateral filter (``ops/smooth.py``): on a CPU tensor the
plain version, on a CUDA tensor the kernel (``csrc/bilateral.cu``).

CPU: ``bilateral_filter`` is the plain version and launches nothing; the
neighbourhood spans 2 * (kernel_size // 2) + 1 pixels a side, odd or even
sizes, up to the cap's 101 (``tests/test_torch_zsplat_atlas.py`` holds the
plain version's ``smooth_image`` against the JAX package's).  The card
(``cuda``, skipped without one): the kernel against the plain version at
the surface cell's image and at odd shapes, kernel sizes, channels, layouts
and depths with a sharp step and uncovered zeros; the other channels
bit-equal, one launch counted a call; ``smooth_image`` by the kernel
against the JAX package's on the CPU; and what the kernel does not take,
a kernel size too large to stage in shared memory among it, raises.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from topsy_tpu_torch import config
from topsy_tpu_torch.ops import smooth
from topsy_tpu_torch.performance import counters

# The kernel and the plain version round every tap's float32 operations
# alike and differ only in the order of the sums: the kernel adds each
# neighbourhood row's taps in sequence, PyTorch reduces them in its own
# order.  Both sum positive weights (and samples times them), so the
# difference is a few roundings of the local depth scale (the largest
# |depth| in the neighbourhood): on the CPU, the kernel's order emulated
# against the plain version differs by at most 5e-7 of it at kernel sizes
# 41 and 101.
RTOL = 1e-6


def _image(H, W, C=2, channel=1, seed=0):
    """A surface-like float32 (H, W, C) image: the depth channel a smooth
    field in [0.1, 0.6] with noise, a sharp step of 0.3 and an uncovered
    disc of zeros; the others random."""
    rng = np.random.default_rng(seed)
    img = rng.random((H, W, C)).astype(np.float32)
    yy, xx = np.meshgrid(np.linspace(0, 1, H), np.linspace(0, 1, W),
                         indexing="ij")
    depth = (0.3 + 0.2 * np.sin(6 * xx) * np.cos(4 * yy)
             + rng.normal(0, 0.01, (H, W)) + 0.3 * (xx > 0.5))
    depth[(xx - 0.3) ** 2 + (yy - 0.7) ** 2 < 0.02] = 0.0
    img[..., channel] = depth
    return img


def _rel_err(out, ref, img, channel, half):
    """Largest difference of the filtered channel over the largest |value|
    in each pixel's neighbourhood (edges clamped)."""
    loc = F.max_pool2d(F.pad(img[..., channel].abs()[None, None],
                             (half,) * 4, mode="replicate"),
                       2 * half + 1, stride=1)[0, 0]
    diff = (out[..., channel] - ref[..., channel]).abs()
    return float((diff / loc.clamp(min=1e-30)).max())


# ---------------------------------------------------------------------------
# the CPU
# ---------------------------------------------------------------------------

def test_cpu_tensor_takes_the_plain_version():
    img = torch.from_numpy(_image(24, 40))
    before = counters["filter_launches"]
    got = smooth.bilateral_filter(img, 3.0, 0.05, 9)
    assert torch.equal(got, smooth.bilateral_filter_plain(img, 3.0, 0.05, 9))
    assert counters["filter_launches"] == before
    assert torch.equal(got[..., 0], img[..., 0])


@pytest.mark.parametrize("kernel_size,taps", [
    (1, 1), (2, 3), (3, 3), (4, 5), (40, 41), (41, 41),
    (config.MAX_SURFACE_SMOOTH_PIXELS, 101)])
def test_taps_a_side(kernel_size, taps):
    """An impulse on zeros, both sigmas so wide that every weight is ~1:
    the centre reads ~1 / taps^2, a pixel half a window away still sees
    the impulse, one pixel further nothing."""
    half = taps // 2
    n = 2 * half + 3
    img = torch.zeros((n, n, 2))
    c = half + 1
    img[c, c, 1] = 1.0
    out = smooth.bilateral_filter(img, 1e4, 1e3, kernel_size)[..., 1]
    assert out[c, c] == pytest.approx(1.0 / taps ** 2, rel=1e-3)
    for dy, dx in ((0, half), (half, 0), (-half, -half)):
        assert out[c + dy, c + dx] > 0.0
    for dy, dx in ((0, half + 1), (half + 1, 0), (-half - 1, 1)):
        assert out[c + dy, c + dx] == 0.0


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def _layout(img, layout):
    """The image on the card: contiguous, a transposed view (dense), or a
    view of every other column of a wider image (not dense)."""
    if layout == "transposed":
        return torch.from_numpy(np.ascontiguousarray(
            img.transpose(1, 0, 2))).cuda().transpose(0, 1)
    if layout == "strided":
        wide = np.repeat(img, 2, axis=1)
        return torch.from_numpy(wide).cuda()[:, ::2]
    return torch.from_numpy(img).cuda()


CASES = {
    # id: (H, W, C, channel, kernel_size, layout)
    "surface": (1024, 1024, 2, 1, 41, "contiguous"),
    "non_square": (37, 1000, 2, 1, 41, "contiguous"),
    "size_1": (64, 80, 2, 1, 1, "contiguous"),
    "size_3": (64, 80, 2, 1, 3, "contiguous"),
    "size_cap": (200, 260, 2, 1, config.MAX_SURFACE_SMOOTH_PIXELS,
                 "contiguous"),
    "larger_than_image": (20, 30, 2, 1, 81, "contiguous"),
    "channel_0": (64, 80, 2, 0, 13, "contiguous"),
    "three_channels": (64, 80, 3, 1, 13, "contiguous"),
    "three_channels_last": (64, 80, 3, 2, 13, "contiguous"),
    "transposed": (90, 70, 2, 1, 21, "transposed"),
    "strided": (90, 70, 2, 1, 21, "strided"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_matches_plain(case):
    _card()
    H, W, C, channel, ks, layout = CASES[case]
    img = _layout(_image(H, W, C, channel), layout)
    assert tuple(img.shape) == (H, W, C)
    args = (img, max(ks, 1) / 4.0, 0.02, ks, channel)
    before = counters["filter_launches"]
    got = smooth.bilateral_filter(*args)
    assert counters["filter_launches"] == before + 1
    ref = smooth.bilateral_filter_plain(*args)
    torch.cuda.synchronize()
    others = [c for c in range(C) if c != channel]
    assert torch.equal(got[..., others], img[..., others])
    assert torch.isfinite(got).all()
    assert _rel_err(got, ref, img, channel, ks // 2) <= RTOL


@pytest.mark.cuda
@pytest.mark.parametrize("H,W,scale", [(1024, 1024, 0.01), (200, 260, 0.1)])
def test_kernel_matches_reference(H, W, scale):
    """``smooth_image`` by the kernel against the JAX package's (on the
    CPU) on the same image: the surface cell's 1024^2 at kernel size 41
    and 200 x 260 at the cap (kernel size 100, 101 taps).  The reference
    sums all offsets in one sequence, with XLA's exp: rtol 1e-5, as the
    plain version is held to it."""
    _card()
    from topsy_tpu.ops import smooth as r_smooth
    img = _image(H, W)
    ks = smooth.smoothing_kernel_size(scale * W)
    assert ks == (41 if H == 1024 else config.MAX_SURFACE_SMOOTH_PIXELS)
    before = counters["filter_launches"]
    got = smooth.smooth_image(torch.from_numpy(img).cuda(), scale)
    assert counters["filter_launches"] == before + 1
    got = got.cpu().numpy()
    ref = np.asarray(r_smooth.smooth_image(img, scale))
    np.testing.assert_array_equal(got[..., 0], img[..., 0])
    np.testing.assert_allclose(got[..., 1], ref[..., 1], rtol=1e-5,
                               atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["float64", "bfloat16", "channel",
                                 "kernel_size", "kernel_size_too_large"])
def test_kernel_refuses(bad):
    """What the kernel does not take raises before any launch; 161 taps a
    side do not fit a block's shared memory (157 is the H100's largest)."""
    _card()
    img = torch.from_numpy(_image(40, 50)).cuda()
    kw = dict(spatial_sigma=2.0, range_sigma=0.02, kernel_size=9, channel=1)
    if bad in ("float64", "bfloat16"):
        img = img.to(getattr(torch, bad))
    elif bad == "channel":
        kw["channel"] = 2
    elif bad == "kernel_size":
        kw["kernel_size"] = 0
    else:
        kw["kernel_size"] = 161
    before = counters["filter_launches"]
    with pytest.raises((TypeError, ValueError)):
        smooth.bilateral_filter(img, **kw)
    assert counters["filter_launches"] == before
