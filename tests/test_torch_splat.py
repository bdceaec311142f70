"""The port's splat front end and scatter ground truth against the
reference (topsy_tpu/ops/splat.py), on the same seeded inputs.

Tolerances: float32 outputs rtol 1e-6 (the same f32 operations; XLA and
PyTorch may round a transcendental differently by one ulp); integer and
boolean outputs equal."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from topsy_tpu import camera
from topsy_tpu.ops import splat as r_splat

from topsy_tpu_torch.ops import splat as p_splat

RES, SCALE = 128, 60.0


@pytest.fixture(scope="module")
def particles():
    rng = np.random.RandomState(7)
    n = 4000
    pos = rng.normal(0.0, 25.0, size=(n, 3)).astype(np.float32)
    h = np.exp(rng.uniform(np.log(0.05), np.log(40.0), n)).astype(np.float32)
    ps = np.concatenate([pos, h[:, None]], 1)
    vals = np.stack([rng.uniform(0.5, 1.5, n),
                     rng.normal(0.0, 1.0, n)], 1).astype(np.float32)
    import scipy.spatial.transform as sst
    rot = sst.Rotation.from_euler("xy", [30, 20], degrees=True).as_matrix()
    matrix = camera.world_to_clip_matrix(rot, np.zeros(3), SCALE)
    return ps, vals, matrix


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_project(particles):
    ps, _, matrix = particles
    ref = r_splat.project(jnp.asarray(ps), jnp.asarray(matrix), RES, SCALE)
    got = p_splat.project(torch.from_numpy(ps), matrix, RES, SCALE)
    for r, g in zip(ref[:4], got[:4]):
        np.testing.assert_allclose(_np(g), _np(r), rtol=1e-6, atol=0)
    np.testing.assert_array_equal(_np(got[4]), _np(ref[4]))


@pytest.mark.parametrize("e", [np.arange(-20, 21, dtype=np.int32)])
def test_exp2_int(e):
    np.testing.assert_array_equal(
        p_splat.exp2_int(torch.from_numpy(e)).numpy(),
        np.asarray(r_splat.exp2_int(jnp.asarray(e))))


def test_ceil_log2_pos():
    rng = np.random.RandomState(1)
    x = np.concatenate([np.exp2(np.arange(-30, 30)).astype(np.float32),
                        rng.uniform(1e-6, 1e6, 2000).astype(np.float32)])
    np.testing.assert_array_equal(
        p_splat.ceil_log2_pos(torch.from_numpy(x)).numpy(),
        np.asarray(r_splat.ceil_log2_pos(jnp.asarray(x))))


def test_assign_levels(particles):
    ps, _, _ = particles
    h_px = ps[:, 3] * np.float32(RES / (2.0 * SCALE))
    ref = r_splat.assign_levels(jnp.asarray(h_px), 4)
    got = p_splat.assign_levels(torch.from_numpy(h_px), 4)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), rtol=1e-6)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))


@pytest.mark.parametrize("ppw", [0.37, 1.0, 4.2667, 17.0])
def test_levels_from_buckets(ppw):
    buckets = np.arange(-80, 60, dtype=np.int32)
    ref = r_splat.levels_from_buckets(jnp.asarray(buckets), ppw, 7)
    got = p_splat.levels_from_buckets(torch.from_numpy(buckets), ppw, 7)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("mode", ["exact", "lowrank"])
def test_norm_factor(mode):
    h = np.geomspace(0.3, 20.0, 500).astype(np.float32)
    ref = r_splat.norm_factor(jnp.asarray(h), mode)
    got = p_splat.norm_factor(torch.from_numpy(h), mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)


@pytest.mark.parametrize("depth_channel", [False, True])
def test_splat_coefficients(particles, depth_channel):
    ps, vals, matrix = particles
    pyr = r_splat.default_pyramid(RES)
    rng = np.random.RandomState(3)
    emask = rng.random_sample(len(ps)) < 0.8
    ref = r_splat.splat_coefficients(
        jnp.asarray(ps), jnp.asarray(vals), jnp.asarray(matrix), RES, SCALE,
        pyr, jnp.asarray(emask), mode="lowrank", depth_channel=depth_channel)
    got = p_splat.splat_coefficients(
        torch.from_numpy(ps), torch.from_numpy(vals), matrix, RES, SCALE,
        p_splat.default_pyramid(RES), torch.from_numpy(emask),
        mode="lowrank", depth_channel=depth_channel)
    for key in ("level", "tiny", "giant"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]),
                                      err_msg=key)
    for key in ("cx", "cy", "h_eff", "coef", "coef_giant", "cx_fine",
                "cy_fine", "h_px"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                   rtol=1e-6, atol=0, err_msg=key)


def test_splat_scatter(particles):
    """The ground truth itself: the same windowed scatter-add (index_add_ vs
    XLA scatter) and the same giant layer; f32 sums in another order, so
    the image agrees to 1e-5 of its maximum."""
    ps, vals, matrix = particles
    ref = np.asarray(r_splat.splat_scatter(jnp.asarray(ps), jnp.asarray(vals),
                                           jnp.asarray(matrix), RES, SCALE))
    got = p_splat.splat_scatter(torch.from_numpy(ps), torch.from_numpy(vals),
                                matrix, RES, SCALE, chunk=1000).numpy()
    assert got.shape == ref.shape == (RES, RES, 2)
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    assert got[..., 0].sum() == pytest.approx(ref[..., 0].sum(), rel=1e-6)
