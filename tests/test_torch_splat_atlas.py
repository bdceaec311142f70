"""The port's presorted splat path (splat_atlas_fields) against the
reference's (topsy_tpu/ops/splat_atlas.py, engine="pallas", so its spill
tiers are the ones the port mirrors), on the 50k-particle host-presorted
scene of tests/test_splat_fields.py at RES 256.

Bounds are the reference's own cross-engine bounds
(tests/test_splat_fields.py:75-78): image sum rel 1e-3, max pixel
difference <= 1% of the image maximum, correlation > 0.9999, and equal
``dropped`` counts.  The ``cuda`` cases (skipped without a GPU) run the
port on CUDA tensors, so through the spill kernel and K2."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from topsy_tpu import camera
from topsy_tpu import config as r_config
from topsy_tpu.loaders import TestDataLoader
from topsy_tpu.ops import morton
from topsy_tpu.ops import splat_atlas as r_atlas

from topsy_tpu_torch import config as p_config
from topsy_tpu_torch import convert
from topsy_tpu_torch.ops import splat as p_splat
from topsy_tpu_torch.ops import splat_atlas as p_atlas
from topsy_tpu_torch.ops import splat_giant as p_giant
from topsy_tpu_torch.performance import counters

# one process's share of the cores when pytest-xdist runs several workers
# (torch's default, every core in each process, oversubscribes them)
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

RES, SCALE = 256, 120.0


@pytest.fixture(scope="module")
def scene():
    loader = TestDataLoader(50000, seed=1337)
    ps = loader.get_pos_smooth().astype(np.float32)
    mass = loader.get_mass().astype(np.float32)
    qty = loader.get_named_quantity("test-quantity").astype(np.float32)
    values = np.stack([mass, mass * qty], axis=1)
    layout = morton.build_presorted(ps)
    st = convert.state_from_reference(layout, ps, values, "cpu")
    ref_in = (tuple(jnp.asarray(f.numpy()) for f in st["fields"]),
              tuple(jnp.asarray(v.numpy()) for v in st["values_cm"]),
              jnp.asarray(st["group_buckets"].numpy()))
    return ps, values, layout, st, ref_in


def _matrix(rot_deg):
    import scipy.spatial.transform as sst
    rot = (sst.Rotation.from_euler("xy", [rot_deg, rot_deg * 0.7],
                                   degrees=True).as_matrix()
           if rot_deg else np.eye(3))
    return camera.world_to_clip_matrix(rot, np.zeros(3), SCALE)


_REF_FNS = {}


def _ref(ref_in, matrix, mask=None, **static):
    """The reference, jitted once per static configuration and collapse
    filter, which it reads when it traces (the view matrix is traced, so
    views share one compile)."""
    fields, values_cm, gb = ref_in
    key = tuple(sorted(static.items())) + (mask is None,
                                           r_config.PYRAMID_COLLAPSE_FILTER)
    run = _REF_FNS.get(key)
    if run is None:
        def run(f, v, m, k, msk):
            return r_atlas.splat_atlas_fields(f, v, m, RES, SCALE, k,
                                              mask=msk, engine="pallas",
                                              **static)
        run = _REF_FNS[key] = jax.jit(run)
    im, d = run(fields, values_cm, jnp.asarray(matrix), gb,
                None if mask is None else jnp.asarray(mask))
    return np.asarray(im), int(d)


def _port(st, matrix, mask=None, **kw):
    im, d = p_atlas.splat_atlas_fields(
        st["fields"], st["values_cm"], matrix, RES, SCALE,
        st["group_buckets"],
        mask=None if mask is None else torch.from_numpy(mask), **kw)
    return im.numpy(), int(d)


def _assert_cross_engine(im_p, d_p, im_r, d_r):
    assert d_p == d_r
    assert im_p.shape == im_r.shape
    assert np.isfinite(im_p).all()
    for c in range(im_r.shape[-1]):
        assert im_p[..., c].sum() == pytest.approx(im_r[..., c].sum(),
                                                   rel=1e-3)
    assert np.abs(im_p - im_r).max() <= 0.01 * np.abs(im_r).max()
    corr = np.corrcoef(im_p[..., 0].ravel(), im_r[..., 0].ravel())[0, 1]
    assert corr > 0.9999


@pytest.mark.parametrize("rot_deg", [0.0, 35.0])
def test_fields_match_reference(scene, rot_deg):
    _, _, _, st, ref_in = scene
    m = _matrix(rot_deg)
    _assert_cross_engine(*_port(st, m), *_ref(ref_in, m))


@pytest.mark.parametrize("rot_deg", [0.0, 35.0])
def test_catmull_collapse_matches_reference(scene, rot_deg, monkeypatch):
    """config.PYRAMID_COLLAPSE_FILTER = "catmull" in both packages: the
    port renders (it raised ValueError before) and matches the reference
    under the same bounds; the image differs from the default 'spline'
    collapse's, so the filter was applied."""
    _, _, _, st, ref_in = scene
    m = _matrix(rot_deg)
    im_spline, _ = _port(st, m)
    for cfg in (r_config, p_config):
        monkeypatch.setattr(cfg, "PYRAMID_COLLAPSE_FILTER", "catmull")
    im_p, d_p = _port(st, m)
    _assert_cross_engine(im_p, d_p, *_ref(ref_in, m))
    assert np.abs(im_p - im_spline).max() > 1e-4 * np.abs(im_p).max()
    assert im_p[..., 0].sum() == pytest.approx(im_spline[..., 0].sum(),
                                               rel=1e-3)


def test_dropped_counts_match_under_a_small_spill_budget(scene):
    """With the spill budget cut to 8 groups the tiers drop splats; both
    packages must count the same."""
    _, _, _, st, ref_in = scene
    m = _matrix(35.0)
    im_p, d_p = _port(st, m, spill_group_cap=8)
    im_r, d_r = _ref(ref_in, m, spill_group_cap=8)
    assert d_r > 0
    assert d_p == d_r
    assert im_p[..., 0].sum() == pytest.approx(im_r[..., 0].sum(), rel=1e-3)


def test_mask(scene):
    _, _, layout, st, ref_in = scene
    G = layout.pad_group
    rng = np.random.RandomState(3)
    mask = (rng.random_sample(layout.n_out) < 0.5).astype(np.float32)
    mask = mask.reshape(-1, G)
    m = _matrix(0.0)
    _assert_cross_engine(*_port(st, m, mask), *_ref(ref_in, m, mask))


def test_depth_channel(scene):
    _, _, _, st, ref_in = scene
    m = _matrix(15.0)
    im_p, d_p = _port(st, m, depth_channel=True)
    assert im_p.shape[-1] == 3
    _assert_cross_engine(im_p, d_p, *_ref(ref_in, m, depth_channel=True))


def test_giant_threshold(scene):
    """The renderer's giant mode: exclusion by bucket threshold (no dense
    layer inside splat_atlas_fields)."""
    _, _, _, st, ref_in = scene
    L = p_splat.default_pyramid(RES).num_levels
    size, thresh = p_giant.giant_plan(st["giant_meta"], RES, SCALE, L)
    assert size > 0
    m = _matrix(10.0)
    _assert_cross_engine(*_port(st, m, giants=thresh),
                         *_ref(ref_in, m, giants=thresh))


def test_piece_loop_sums_to_full(scene):
    _, _, layout, st, _ = scene
    m = _matrix(20.0)
    ng = layout.n_out // layout.pad_group
    im_full, _ = _port(st, m)
    g_split = (ng // 2 // 16) * 16
    acc = None
    for piece in ((0, g_split), (g_split, ng - g_split)):
        im, _ = _port(st, m, piece=piece)
        acc = im if acc is None else acc + im
    np.testing.assert_allclose(acc, im_full, rtol=1e-4, atol=1e-5)


def test_mass_against_scatter(scene):
    ps, values, _, st, _ = scene
    m = _matrix(0.0)
    im, dropped = _port(st, m)
    assert dropped == 0
    ref = p_splat.splat_scatter(torch.from_numpy(ps), torch.from_numpy(values),
                                m, RES, SCALE).numpy()
    assert im[..., 0].sum() == pytest.approx(ref[..., 0].sum(), rel=1e-2)
    corr = np.corrcoef(im[..., 0].ravel(), ref[..., 0].ravel())[0, 1]
    assert corr > 0.999


def _mask(layout, seed=3):
    rng = np.random.RandomState(seed)
    return (rng.random_sample(layout.n_out) < 0.5).astype(np.float32).reshape(
        -1, layout.pad_group)


@pytest.mark.parametrize("merge,width,pad_multiple", [
    (False, 128, 8), (False, 128, 64), (False, 384, 8), (False, 384, 64),
    (True, 128, 8), (True, 128, 64)])
def test_slice_column_fields_matches_reference(scene, merge, width,
                                               pad_multiple):
    """The column slice (fields, values, buckets, mask) equals the
    reference's, merged and un-merged, with the group axis padded; col0 200
    is clipped for the 384-wide slice."""
    _, _, layout, st, ref_in = scene
    mask = _mask(layout)
    got = p_atlas.slice_column_fields(
        st["fields"], st["values_cm"], st["group_buckets"],
        torch.from_numpy(mask), 200, width, merge=merge,
        pad_multiple=pad_multiple)
    ref = r_atlas.slice_column_fields(*ref_in, jnp.asarray(mask),
                                      jnp.int32(200), width, merge=merge,
                                      pad_multiple=pad_multiple)
    assert got[0][0].shape[0] % pad_multiple == 0
    for g, r in zip(got[0], ref[0]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    np.testing.assert_array_equal(got[1].numpy(),
                                  np.stack([np.asarray(v) for v in ref[1]]))
    for g, r in zip(got[2:], ref[2:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_slice_column_fields_merged_needs_a_divisor(scene):
    _, _, _, st, ref_in = scene
    with pytest.raises(ValueError, match="divisor"):
        p_atlas.slice_column_fields(st["fields"], st["values_cm"],
                                    st["group_buckets"], None, 0, 384)
    with pytest.raises(AssertionError):
        r_atlas.slice_column_fields(*ref_in, None, jnp.int32(0), 384)


def test_column_slice_matches_reference(scene):
    """A 384-wide un-merged column slice under the interactive launch's
    spill budgets (512 tier-2 groups, 4,096 tier-3 stragglers): the
    cross-engine bounds and equal ``dropped``."""
    _, _, _, st, ref_in = scene
    m = _matrix(35.0)
    budgets = dict(spill_group_cap=512, spill_t3_cap=4096)
    sl = p_atlas.slice_column_fields(st["fields"], st["values_cm"],
                                     st["group_buckets"], None, 128, 384,
                                     merge=False)
    im_p, d_p = p_atlas.splat_atlas_fields(sl[0], sl[1], m, RES, SCALE,
                                           sl[2], **budgets)
    r_f, r_v, r_gb, _ = r_atlas.slice_column_fields(
        *ref_in, None, jnp.int32(128), 384, merge=False)
    im_r, d_r = jax.jit(lambda f, v, mm, k: r_atlas.splat_atlas_fields(
        f, v, mm, RES, SCALE, k, engine="pallas", **budgets))(
        r_f, r_v, jnp.asarray(m), r_gb)
    assert sl[0][0].shape[1] == 384
    _assert_cross_engine(im_p.numpy(), int(d_p), np.asarray(im_r), int(d_r))


def _on_card(x):
    if isinstance(x, (tuple, list)):
        return type(x)(_on_card(v) for v in x)
    return x.cuda()


CARD_CASES = {
    # id: (rotation, column slice (col0, width) or None, budgets)
    "rot0": (0.0, None, {}),
    "rot35": (35.0, None, {}),
    "budget8": (35.0, None, dict(spill_group_cap=8)),
    "column384": (35.0, (128, 384),
                  dict(spill_group_cap=512, spill_t3_cap=4096)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CARD_CASES))
def test_card_spill_kernel_matches_reference(scene, case):
    """``splat_atlas_fields`` on CUDA tensors, so that its spill tiers'
    operands come from the kernel (csrc/spill_tiers.cu) and its deposits
    from K2, against the reference's on the CPU: the cross-engine bounds
    and equal ``dropped``, also with the spill budget cut to 8 groups,
    where both drop splats, and on a column slice under the interactive
    launch's budgets."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    _, _, _, st, ref_in = scene
    rot_deg, column, budgets = CARD_CASES[case]
    m = _matrix(rot_deg)
    fields, values, gb = st["fields"], st["values_cm"], st["group_buckets"]
    if column is not None:
        fields, values, gb, _ = p_atlas.slice_column_fields(
            fields, values, gb, None, *column, merge=False)
    before = counters["spill_launches"]
    im_p, d_p = p_atlas.splat_atlas_fields(
        _on_card(fields), _on_card(values), m, RES, SCALE, _on_card(gb),
        **budgets)
    assert counters["spill_launches"] == before + 1
    if column is None:
        im_r, d_r = _ref(ref_in, m, **budgets)
    else:
        r_f, r_v, r_gb, _ = r_atlas.slice_column_fields(
            *ref_in, None, jnp.int32(column[0]), column[1], merge=False)
        im_r, d_r = jax.jit(lambda f, v, mm, k: r_atlas.splat_atlas_fields(
            f, v, mm, RES, SCALE, k, engine="pallas", **budgets))(
            r_f, r_v, jnp.asarray(m), r_gb)
        im_r, d_r = np.asarray(im_r), int(d_r)
    if budgets.get("spill_group_cap") == 8:
        assert d_r > 0
    _assert_cross_engine(im_p.cpu().numpy(), int(d_p), im_r, d_r)
