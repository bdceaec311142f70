"""The port's flat splat path ``splat_atlas`` (the per-frame sort, the
spill tiers) against the reference's
``engine="pallas"`` (its Pallas kernel interpreted, as
tests/test_splat_atlas.py:101 runs it), at the three group widths the path
chooses by the number of particles it is given: G = 512 (2^18 rows, the
block path's bucket, of which the GMM scene's 20,000 are active), G = 128
(20,000 rows) and G = 64 (5,000 rows).

The sorted operands, the anchors, fit masks and flags are compared through
``_stop_after``; they may differ only for particles on a band or column
edge (float rounding of the same arithmetic), counted and bounded at 1e-3
of the rows.  Images at the cross-engine bounds of
tests/test_splat_fields.py:75-78 (sum rel 1e-3, max pixel difference <= 1%
of the maximum, correlation > 0.9999) and the same ``dropped``."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from topsy_tpu import camera
from topsy_tpu.loaders import TestDataLoader
from topsy_tpu.ops import splat_atlas as r_atlas

from topsy_tpu_torch.ops import splat as p_splat
from topsy_tpu_torch.ops import splat_atlas as p_atlas

torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

RES = 128
SCALE = np.float32(200.0)
ROWS = {512: 1 << 18, 128: 20000, 64: 5000}


@pytest.fixture(scope="module")
def scene():
    loader = TestDataLoader(20000, seed=1337)
    ps = loader.get_pos_smooth().astype(np.float32)
    mass = loader.get_mass()
    vals = np.stack([mass, mass * loader.get_named_quantity(
        "test-quantity")], axis=1).astype(np.float32)
    matrix = camera.world_to_clip_matrix(np.eye(3), np.zeros(3),
                                         SCALE).astype(np.float32)
    return ps, vals, matrix


def _rows(scene, G):
    """(pos_smooth, values, mask) of ROWS[G] rows: the scene's particles in
    the snapshot's order, cycled, the extra rows masked off."""
    ps, vals, _ = scene
    n = ROWS[G]
    idx = np.arange(n) % len(ps)
    mask = np.arange(n) < min(n, len(ps))
    return ps[idx], vals[idx], mask


def _both(scene, G, giants="auto", stop=None):
    ps, vals, mask = _rows(scene, G)
    matrix = scene[2]
    ref = r_atlas.splat_atlas(
        jnp.asarray(ps), jnp.asarray(vals), jnp.asarray(matrix), RES, SCALE,
        extra_mask=jnp.asarray(mask), engine="pallas", giants=giants,
        _stop_after=stop)
    got = p_atlas.splat_atlas(
        torch.from_numpy(ps), torch.from_numpy(vals), matrix, RES, SCALE,
        extra_mask=torch.from_numpy(mask), giants=giants, _stop_after=stop)
    return ref, got


@pytest.mark.parametrize("G", [512, 128, 64])
def test_group_width_follows_rows(G):
    assert p_atlas.sorted_group_size(ROWS[G]) == G


@pytest.mark.parametrize("G", [512, 128, 64])
def test_sorted_operands_and_anchors_match_reference(scene, G):
    n = ROWS[G]
    ref, got = _both(scene, G, stop="frontend")
    for name, a, b in zip(("ay", "ax", "inv_h", "coef"), got, ref):
        b = np.asarray(b)
        assert a.shape == b.shape, name
        assert int((a.numpy() != b).reshape(len(b), -1).any(1).sum()) \
            <= 1e-3 * n, name
    ref, got = _both(scene, G, stop="anchors")
    for name, a, b in zip(("w0", "c0", "c0e", "coef_fit", "flags"), got,
                          ref):
        b = np.asarray(b)
        assert a.shape == b.shape, name
        n_diff = int((a.numpy() != b).reshape(len(b), -1).any(1).sum())
        assert n_diff <= 1e-3 * n, (name, n_diff)


CASES = [(512, "auto"), (128, "none"), (64, "auto")]


@pytest.mark.parametrize("G,giants", CASES,
                         ids=[f"G{g}-sorted-{gi}" for g, gi in CASES])
def test_image_matches_reference(scene, G, giants):
    (im_r, d_r), (im_p, d_p) = _both(scene, G, giants)
    a, b = im_p.numpy().astype(np.float64), np.asarray(im_r, np.float64)
    assert a.shape == b.shape == (RES, RES, 2)
    for c in range(2):
        assert a[..., c].sum() == pytest.approx(b[..., c].sum(), rel=1e-3)
    assert np.abs(a - b).max() <= 0.01 * np.abs(b).max()
    assert np.corrcoef(a[..., 0].ravel(), b[..., 0].ravel())[0, 1] > 0.9999
    assert int(d_p) == int(d_r)


def test_bucket_threshold_giants_are_not_ported(scene):
    """The reference's third ``giants`` form, a smoothing-bucket threshold,
    belongs to its ``presorted_buckets`` option, which the port does not
    carry (its presorted renders run the feed kernel): it raises."""
    ps, vals, mask = _rows(scene, 64)
    with pytest.raises(ValueError, match="giants"):
        p_atlas.splat_atlas(torch.from_numpy(ps), torch.from_numpy(vals),
                            scene[2], RES, SCALE, giants=3)


def test_sparse_scene_spills_and_conserves():
    """tests/test_splat_atlas.py's sparse scene at 256^2, where groups span
    more than a window's profile columns: the spill tiers deposit what the
    windows cannot hold, nothing is dropped, and the mass is the scatter
    truth's."""
    rng = np.random.RandomState(0)
    ps = np.zeros((300, 4), np.float32)
    ps[:, :3] = rng.uniform(-150, 150, (300, 3))
    ps[:, 3] = rng.uniform(3.0, 8.0, 300)
    vals = np.ones((300, 1), np.float32)
    matrix = camera.world_to_clip_matrix(np.eye(3), np.zeros(3),
                                         SCALE).astype(np.float32)
    ps_t, vals_t = torch.from_numpy(ps), torch.from_numpy(vals)
    res = 2 * RES
    fitted = p_atlas.splat_atlas(ps_t, vals_t, matrix, res, SCALE,
                                 _stop_after="anchors")[3]
    front = p_atlas.splat_atlas(ps_t, vals_t, matrix, res, SCALE,
                                _stop_after="frontend")[3]
    assert int(((front != 0) & (fitted == 0)).any(1).sum()) > 0
    im, dropped = p_atlas.splat_atlas(ps_t, vals_t, matrix, res, SCALE)
    assert int(dropped) == 0
    ref = p_splat.splat_scatter(ps_t, vals_t, matrix, res, SCALE)
    assert float(im[..., 0].sum()) == pytest.approx(float(ref[..., 0].sum()),
                                                    rel=0.01)


def test_single_particle_against_bruteforce():
    """One splat over several pyramid levels keeps its mass and centre
    (tests/test_splat_atlas.py:35), against the float64 ideal for the
    giant that leaves the viewport."""
    matrix = camera.world_to_clip_matrix(np.eye(3), np.zeros(3),
                                         SCALE).astype(np.float32)
    area = (2.0 * float(SCALE) / RES) ** 2
    for h in (4.0, 16.0, 150.0):
        ps = np.array([[0.0, 0.0, 0.0, h]], np.float32)
        vals = np.array([[3.0]], np.float32)
        im, dropped = p_atlas.splat_atlas(torch.from_numpy(ps),
                                          torch.from_numpy(vals), matrix,
                                          RES, SCALE)
        im = im[..., 0].numpy()
        assert int(dropped) == 0
        expect = 3.0
        if h * RES / (2 * float(SCALE)) > 8.0:
            expect = p_splat.splat_bruteforce(ps, vals, matrix, RES,
                                              float(SCALE))[..., 0].sum() \
                * area
        assert im.sum() * area == pytest.approx(expect, rel=0.02)
        ys, xs = np.mgrid[0:RES, 0:RES]
        assert (im * xs).sum() / im.sum() == pytest.approx(63.5, abs=0.1)
        assert (im * ys).sum() / im.sum() == pytest.approx(63.5, abs=0.1)
