"""The port's z-buffered atlas splatter (zsplat_atlas: plain front end,
kernel K3's plain version, spill tiers, max-composite collapse) against the
reference's, on the scenes of tests/test_zsplat_atlas.py: 30k particles at
RES 128 (two views), a density cut, the heavy-spill scene with and without
the tier-3 cap, and giants excluded above a bucket threshold.  Also the
port's scatter ground truth against the port's atlas path, and the giant
layer and the bilateral filter against the reference's.

Tolerances are the reference's own cross-path bounds
(tests/test_zsplat_atlas.py:59-65): coverage equal, depth rtol 1e-5 /
atol 1e-4, winner values rtol 1e-5 / atol 1e-6; dropped counts equal.  The
two packages sum the collapse's interpolation products in other orders,
which moves depths by a few ulp."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from topsy_tpu import camera
from topsy_tpu.ops import smooth as r_smooth
from topsy_tpu.ops import splat_giant as r_giant
from topsy_tpu.ops import zsplat_atlas as r_za

from topsy_tpu_torch.loaders import TestDataLoader
from topsy_tpu_torch.ops import morton
from topsy_tpu_torch.ops import smooth as p_smooth
from topsy_tpu_torch.ops import splat_giant as p_giant
from topsy_tpu_torch.ops import zsplat as p_zsplat
from topsy_tpu_torch.ops import zsplat_atlas as p_za
from topsy_tpu_torch.ops.splat import default_pyramid, levels_from_buckets

# one process's share of the cores when pytest-xdist runs several workers
# (torch's default, every core in each process, oversubscribes them)
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

RES = 128
SCALE = 120.0


def _arrays(ps_np, vals_np):
    layout = morton.build_presorted(ps_np)
    return (layout.apply(ps_np, fill=morton.PAD_POS), layout.apply(vals_np),
            np.asarray(layout.buckets, np.int32))


@pytest.fixture(scope="module")
def scene():
    loader = TestDataLoader(30000, seed=1337)
    ps_np = loader.get_pos_smooth().astype(np.float32)
    vals_np = np.stack([loader.get_mass(),
                        loader.get_named_quantity("test-quantity")],
                       axis=1).astype(np.float32)
    return _arrays(ps_np, vals_np)


@pytest.fixture(scope="module")
def spill_scene():
    rng = np.random.RandomState(2)
    n = 4096
    ps_np = np.zeros((n, 4), dtype=np.float32)
    corners = np.array([[-80, -80], [80, -80], [-80, 80], [80, 80]])
    c = corners[np.arange(n) % 4]
    ps_np[:, 0] = c[:, 0] + rng.uniform(-15, 15, n)
    ps_np[:, 1] = c[:, 1] + rng.uniform(-15, 15, n)
    ps_np[:, 2] = rng.uniform(-40, 40, n)
    ps_np[:, 3] = rng.uniform(2.0, 6.0, n)
    vals_np = np.stack([np.ones(n), rng.uniform(0, 1, n)],
                       axis=1).astype(np.float32)
    return _arrays(ps_np, vals_np)


def _matrix(rot_deg=0.0):
    import scipy.spatial.transform as sst
    rot = sst.Rotation.from_euler("xy", [rot_deg, rot_deg * 0.6],
                                  degrees=True).as_matrix()
    return camera.world_to_clip_matrix(rot, np.zeros(3), SCALE)


def _both(arrays, rot_deg=0.0, scale=SCALE, **kw):
    ps, vals, buckets = arrays
    m = _matrix(rot_deg) if scale == SCALE else camera.world_to_clip_matrix(
        np.eye(3), np.zeros(3), scale)
    im_r, d_r = r_za.zsplat_atlas(jnp.asarray(ps), jnp.asarray(vals),
                                  jnp.asarray(m), RES, jnp.float32(scale),
                                  jnp.asarray(buckets), **kw)
    im_p, d_p = p_za.zsplat_atlas(torch.from_numpy(ps),
                                  torch.from_numpy(vals), m, RES,
                                  np.float32(scale),
                                  torch.from_numpy(buckets), **kw)
    return (np.asarray(im_r), int(d_r)), (im_p.numpy(), int(d_p))


def _both_port(arrays, scale, **kw):
    ps, vals, buckets = arrays
    m = camera.world_to_clip_matrix(np.eye(3), np.zeros(3), scale)
    im, d = p_za.zsplat_atlas(torch.from_numpy(ps), torch.from_numpy(vals),
                              m, RES, np.float32(scale),
                              torch.from_numpy(buckets), **kw)
    return None, (im.numpy(), int(d))


def _agree(im_a, im_b):
    cov_a, cov_b = im_a[..., 1] > 0, im_b[..., 1] > 0
    assert (cov_a == cov_b).all(), int((cov_a != cov_b).sum())
    both = cov_a
    assert both.sum() > 20
    np.testing.assert_allclose(im_a[..., 1][both], im_b[..., 1][both],
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(im_a[..., 0][both], im_b[..., 0][both],
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("rot_deg", [0.0, 30.0])
def test_matches_reference(scene, rot_deg):
    (im_r, d_r), (im_p, d_p) = _both(scene, rot_deg)
    assert d_p == d_r == 0
    _agree(im_p, im_r)


def test_density_cut_matches_reference(scene):
    ps, vals, _ = scene
    rho = vals[:, 0] / np.clip(ps[:, 3], 1e-30, 1e10) ** 3
    cut = float(np.quantile(rho[vals[:, 0] > 0], 0.8))
    (im_r, d_r), (im_p, d_p) = _both(scene, density_cut=cut)
    assert d_p == d_r
    _agree(im_p, im_r)


@pytest.mark.parametrize("t3_cap,cap", [(None, None), (4096, 1)])
def test_heavy_spill_matches_reference(spill_scene, t3_cap, cap):
    """Interleaved distant clusters force window misfits en masse: tier 3
    as the sequential merge (no ``t3_cap``) and as the one-particle-group
    pass under a cut spill budget, where splats are dropped and the counts
    must agree."""
    (im_r, d_r), (im_p, d_p) = _both(spill_scene, t3_cap=t3_cap,
                                     spill_group_cap=cap)
    assert d_p == d_r
    assert (d_p > 0) == (cap is not None)
    _agree(im_p, im_r)


def test_giants_excluded_match_reference(scene):
    """Over-window splats at or above a bucket threshold are left to the
    dense giant layer (about 600 at this zoom)."""
    ps, vals, buckets = scene
    thr = int(np.quantile(buckets, 0.5))
    (im_r, d_r), (im_p, d_p) = _both(scene, giants=thr)
    assert d_p == d_r
    _agree(im_p, im_r)
    _, (full, _) = _both_port(scene, scale=SCALE)
    assert not np.array_equal(full, im_p)     # some splats were giants


def test_scatter_matches_atlas(scene):
    """The port's scatter-max ground truth with the atlas's bucket levels
    against the port's atlas path."""
    ps, vals, buckets = scene
    m = _matrix(30.0)
    pyr = default_pyramid(RES)
    lev = levels_from_buckets(torch.from_numpy(buckets), RES / (2 * SCALE),
                              pyr.num_levels)
    im_s = p_zsplat.zsplat_scatter(torch.from_numpy(ps),
                                   torch.from_numpy(vals), m, RES,
                                   np.float32(SCALE), level_override=lev,
                                   chunk=1 << 14).numpy()
    im_a, d = p_za.zsplat_atlas(torch.from_numpy(ps), torch.from_numpy(vals),
                                m, RES, np.float32(SCALE),
                                torch.from_numpy(buckets))
    assert int(d) == 0
    _agree(im_a.numpy(), im_s)


def test_giant_layer_and_smoothing_match_reference():
    rng = np.random.RandomState(5)
    n, res = 40, 64
    cy, cx = rng.uniform(-10, res + 10, (2, n)).astype(np.float32)
    h = rng.uniform(4.0, 40.0, n).astype(np.float32)
    z = rng.uniform(0.1, 0.9, n).astype(np.float32)
    hch = rng.uniform(0.01, 0.1, n).astype(np.float32)
    q = rng.normal(0, 1, n).astype(np.float32)
    act = rng.random_sample(n) < 0.8
    ref = np.asarray(r_giant.zsplat_giant_image(
        *(jnp.asarray(a) for a in (cy, cx, h, z, hch, q, act)), res))
    got = p_giant.zsplat_giant_image(
        *(torch.from_numpy(a) for a in (cy, cx, h, z, hch, q, act)),
        res).numpy()
    _agree(got, ref)

    img = np.stack([rng.normal(0, 1, (res, res)),
                    np.clip(rng.normal(0.5, 0.2, (res, res)), 0, None)],
                   axis=-1).astype(np.float32)
    # kernel sizes 2, 6, 13 and the cap's 100
    for scale in (0.004, 0.02, 0.05, 0.5):
        ref = np.asarray(r_smooth.smooth_image(img, scale))
        got = p_smooth.smooth_image(torch.from_numpy(img), scale).numpy()
        assert p_smooth.smoothing_kernel_size(scale * res) == \
            r_smooth.smoothing_kernel_size(scale * res)
        np.testing.assert_array_equal(got[..., 0], img[..., 0])
        np.testing.assert_allclose(got[..., 1], ref[..., 1], rtol=1e-5,
                                   atol=1e-6)
