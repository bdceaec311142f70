"""The 2x pyramid upsampling of ``ops/composite.py`` against the reference's
(``topsy_tpu/ops/composite.py``): the interpolation matrices of every kind
to 1e-7 (the port builds them with the same numpy code), and each
``upsample2x_*`` function, channel-last (H, W, C) and channel-major (C, H,
W), on the same seeded input to a relative 1e-6 of the output's maximum
(float32 products, summed in another order).  The 'catmull' kind is held
also by its defining properties: it interpolates (a constant stays
constant, a linear ramp stays linear inside the clamped edges) and it is
the 4-tap Catmull-Rom cubic."""

import numpy as np
import pytest
import torch

from topsy_tpu.ops import composite as r_comp
from topsy_tpu_torch.ops import composite as p_comp

KINDS = ["linear", "catmull", "spline"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", [1, 2, 3, 8, 64])
def test_upsample_matrix_matches_reference(kind, n):
    m_p = p_comp._upsample2x_matrix(n, kind)
    m_r = r_comp._upsample2x_matrix(n, kind)
    assert m_p.shape == m_r.shape == (n, 2 * n)
    assert m_p.dtype == np.float32
    np.testing.assert_allclose(m_p, m_r, rtol=0, atol=1e-7)


@pytest.mark.parametrize("t", [0.0, 0.25, 0.75, 1.0, 1.25, 1.75, 2.0, 3.0])
def test_catmull_weight_matches_reference(t):
    for s in (t, -t):
        assert p_comp._catmull_weight(s) == r_comp._catmull_weight(s)


def test_catmull_matrix_interpolates():
    """Columns sum to 1 (a constant is kept); away from the clamped edges
    a linear ramp maps to the ramp at the fine half-pixel centres."""
    n = 16
    m = p_comp._upsample2x_matrix(n, "catmull").astype(np.float64)
    np.testing.assert_allclose(m.sum(axis=0), 1.0, atol=1e-6)
    fine = np.arange(n, dtype=np.float64) @ m
    xc = np.arange(2 * n) / 2.0 - 0.25
    inner = slice(4, 2 * n - 4)
    np.testing.assert_allclose(fine[inner], xc[inner], atol=1e-5)


def _cl(seed, c, h=12, w=20):
    return np.random.RandomState(seed).uniform(
        0.0, 3.0, (h, w, c)).astype(np.float32)


FUNCS = {
    "upsample2x_linear": ("cl", lambda m, x: m.upsample2x_linear(x)),
    "upsample2x_catmull": ("cl", lambda m, x: m.upsample2x_catmull(x)),
    "upsample2x_kind_linear": ("cl",
                               lambda m, x: m.upsample2x_kind(x, "linear")),
    "upsample2x_kind_catmull": ("cl",
                                lambda m, x: m.upsample2x_kind(x, "catmull")),
    "upsample2x_kind_spline": ("cl",
                               lambda m, x: m.upsample2x_kind(x, "spline")),
    "upsample2x_linear_cm": ("cm", lambda m, x: m.upsample2x_linear_cm(x)),
    "upsample2x_catmull_cm": ("cm", lambda m, x: m.upsample2x_catmull_cm(x)),
    "upsample2x_kind_cm_catmull": ("cm", lambda m, x:
                                   m.upsample2x_kind_cm(x, "catmull")),
}


@pytest.mark.parametrize("c", [1, 2, 3])
@pytest.mark.parametrize("name", sorted(FUNCS))
def test_upsample_matches_reference(name, c):
    layout, fn = FUNCS[name]
    x = _cl(c, c)
    if layout == "cm":
        x = np.ascontiguousarray(x.transpose(2, 0, 1))
    want = np.asarray(fn(r_comp, x))
    got = fn(p_comp, torch.from_numpy(x))
    assert got.dtype == torch.float32
    got = got.numpy()
    assert got.shape == want.shape == (
        (24, 40, c) if layout == "cl" else (c, 24, 40))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


def test_linear_shifts_equal_linear_matrix():
    """The channel-last shift form and the channel-major matrix form are
    the same 'linear' filter."""
    x = _cl(7, 2)
    a = p_comp.upsample2x_linear(torch.from_numpy(x)).numpy()
    b = p_comp.upsample2x_linear_cm(
        torch.from_numpy(np.ascontiguousarray(x.transpose(2, 0, 1))))
    np.testing.assert_allclose(a, b.permute(1, 2, 0).numpy(), rtol=0,
                               atol=1e-6 * np.abs(a).max())
