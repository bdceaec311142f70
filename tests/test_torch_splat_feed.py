"""The port's plain feed (splat_feed_plain) against the reference's Pallas
feed kernel run in interpret mode, output by output, on the 50k-particle
host-presorted scene of tests/test_splat_fields.py at RES 256.

Tolerances: the f32 planes (ay, ax, ih, cfit, cspill) rtol 1e-6; the int32
vectors (w0, c0, ce, flags, nspill) equal.  Column slices of the layout
(``splat_atlas.slice_column_fields``, as the interactive path cuts them)
give groups whose width is not a power of two."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from topsy_tpu import camera
from topsy_tpu.loaders import TestDataLoader
from topsy_tpu.ops import morton
from topsy_tpu.ops import splat_feed as r_feed

from topsy_tpu_torch import convert
from topsy_tpu_torch.ops import splat_atlas as p_atlas
from topsy_tpu_torch.ops import splat_feed as p_feed
from topsy_tpu_torch.ops import splat_giant as p_giant

RES, SCALE = 256, 120.0


@pytest.fixture(scope="module")
def scene():
    loader = TestDataLoader(50000, seed=1337)
    ps = loader.get_pos_smooth().astype(np.float32)
    mass = loader.get_mass().astype(np.float32)
    qty = loader.get_named_quantity("test-quantity").astype(np.float32)
    values = np.stack([mass, mass * qty], axis=1)
    layout = morton.build_presorted(ps)
    return layout, convert.state_from_reference(layout, ps, values, "cpu")


def _matrix(rot_deg, scale):
    import scipy.spatial.transform as sst
    rot = (sst.Rotation.from_euler("xy", [rot_deg, rot_deg * 0.7],
                                   degrees=True).as_matrix()
           if rot_deg else np.eye(3))
    return camera.world_to_clip_matrix(rot, np.zeros(3), scale)


def _run_both(st, *, rot_deg=0.0, scale=SCALE, g0=0, piece_groups=None,
              prange=None, mask=None, depth_channel=False,
              bucket_thresh=p_giant.BUCKET_DISABLED):
    fields, values_cm, gb = st["fields"], st["values_cm"], st["group_buckets"]
    n_groups = fields[0].shape[0]
    pg = n_groups if piece_groups is None else piece_groups
    pyramid = p_atlas.default_pyramid(RES)
    row_offs, atlas_rows, atlas_cols = p_atlas.atlas_layout(pyramid)
    scale = np.float32(scale)
    ppw = RES / (2.0 * scale)
    pergroup, _ = p_atlas._pergroup_table(gb, ppw, pyramid, row_offs)
    start, count = (0, 0) if prange is None else prange
    params_f, sp_i = p_atlas.feed_params(_matrix(rot_deg, scale), ppw, g0,
                                         start, count, bucket_thresh)
    kw = dict(C_in=2, depth_channel=depth_channel, resolution=RES,
              atlas_rows=atlas_rows, atlas_cols=atlas_cols, window_rows=96,
              band=p_atlas.BAND, col_pad=float(p_atlas.COL_PAD),
              foot=p_atlas.FOOT, piece_groups=pg, ranged=prange is not None,
              has_mask=mask is not None,
              sentinel_ay=float(atlas_rows - p_atlas.ROW_PAD
                                + p_atlas.FOOT + 2.0))
    got = p_feed.splat_feed_plain(
        fields, values_cm, pergroup, params_f, sp_i,
        None if mask is None else torch.from_numpy(mask), **kw)
    kw.pop("has_mask")
    ref = r_feed.splat_feed_pallas(
        tuple(jnp.asarray(f.numpy()) for f in fields),
        tuple(jnp.asarray(v.numpy()) for v in values_cm),
        jnp.asarray(pergroup.numpy()), jnp.asarray(params_f),
        jnp.asarray(sp_i), None if mask is None else jnp.asarray(mask),
        has_mask=mask is not None, interpret=True, **kw)
    return got, ref


def _compare(got, ref):
    names = ["ay", "ax", "ih"]
    for name, g, r in zip(names, got[:3], ref[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=0, err_msg=name)
    for which, g_all, r_all in (("cfit", got[3], ref[3]),
                                ("cspill", got[4], ref[4])):
        assert g_all.shape[0] == len(r_all)
        for c in range(len(r_all)):
            np.testing.assert_allclose(g_all[c].numpy(), np.asarray(r_all[c]),
                                       rtol=1e-6, atol=0,
                                       err_msg=f"{which}[{c}]")
    for name, g, r in zip(["w0", "c0", "ce", "flags", "nspill"], got[5:],
                          ref[5:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=name)


@pytest.mark.parametrize("rot_deg", [0.0, 35.0])
def test_feed_plain_matches_reference(scene, rot_deg):
    _, st = scene
    got, ref = _run_both(st, rot_deg=rot_deg)
    _compare(got, ref)
    # the scene exercises the spill path and several kinds / size classes
    flags = got[8].numpy()
    assert len(np.unique(flags)) >= 3


def test_feed_ranged(scene):
    layout, st = scene
    half = (layout.n_out // 2 // 4096) * 4096
    got, ref = _run_both(st, rot_deg=20.0, prange=(half - 1000, half))
    _compare(got, ref)


def test_feed_mask(scene):
    layout, st = scene
    G = layout.pad_group
    rng = np.random.RandomState(3)
    mask = (rng.random_sample(layout.n_out) < 0.5).astype(np.float32)
    got, ref = _run_both(st, mask=mask.reshape(-1, G))
    _compare(got, ref)


def test_feed_depth_channel(scene):
    _, st = scene
    got, ref = _run_both(st, rot_deg=15.0, depth_channel=True)
    assert got[3].shape[0] == 3
    _compare(got, ref)


def test_feed_giant_threshold(scene):
    """The giant plan's bucket threshold excludes the largest-smoothing
    buckets from the windowed deposit (sp_i[3])."""
    layout, st = scene
    scale = 60.0
    pyramid = p_atlas.default_pyramid(RES)
    size, b_thresh = p_giant.giant_plan(st["giant_meta"], RES, scale,
                                        pyramid.num_levels)
    assert size > 0 and b_thresh != p_giant.BUCKET_DISABLED
    got, ref = _run_both(st, scale=scale, bucket_thresh=b_thresh)
    _compare(got, ref)
    off, _ = _run_both(st, scale=scale)
    assert (np.abs(got[3].numpy()).sum() + np.abs(got[4].numpy()).sum()
            < np.abs(off[3].numpy()).sum() + np.abs(off[4].numpy()).sum())


def test_feed_nonzero_piece(scene):
    layout, st = scene
    ng = layout.n_out // layout.pad_group
    pg = 192
    assert ng >= 2 * pg
    got, ref = _run_both(st, rot_deg=10.0, g0=pg, piece_groups=pg)
    assert got[0].shape[0] == pg
    _compare(got, ref)


def _sliced(st, width, col0=64):
    """The scene's state cut to columns [col0, col0 + width), one group per
    original group, as the interactive column launch cuts it."""
    fields, values_cm, gb, _ = p_atlas.slice_column_fields(
        st["fields"], st["values_cm"], st["group_buckets"], None, col0,
        width, merge=False)
    return dict(st, fields=fields, values_cm=values_cm, group_buckets=gb)


@pytest.mark.parametrize("width", [128, 192, 384])
def test_feed_plain_matches_reference_at_slice_widths(scene, width):
    """Groups of any width (one interactive column slice each) through the
    plain feed and the interpreted Pallas feed."""
    _, st = scene
    sl = _sliced(st, width)
    got, ref = _run_both(sl, rot_deg=25.0)
    assert got[0].shape[1] == width
    _compare(got, ref)
    assert (got[8].numpy() // 4 > 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("width,piece", [(192, None), (320, None),
                                         (384, None), (384, (8, 37))])
def test_kernel_matches_plain_on_card_at_slice_widths(scene, width, piece):
    """K1 at group widths that are not powers of two (its lanes padded to
    the next power of two and masked), on all groups and on a piece whose
    group count does not fill the last program: integers equal, f32 planes
    to rtol 1e-6."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, st = scene
    sl = _sliced(st, width)
    dev = torch.device("cuda")
    args, kw = p_atlas.feed_call(tuple(f.to(dev) for f in sl["fields"]),
                                 sl["values_cm"].to(dev),
                                 _matrix(20.0, SCALE), RES, np.float32(SCALE),
                                 sl["group_buckets"].to(dev),
                                 pyramid=p_atlas.default_pyramid(RES),
                                 piece=piece)
    got = p_feed.splat_feed_triton(*args, **kw)
    ref = p_feed.splat_feed_plain(*args, **kw)
    assert got[0].shape == ref[0].shape
    assert (ref[8] // 4 > 0).any()
    for g, r in zip(got[:5], ref[:5]):
        assert torch.allclose(g, r, rtol=1e-6, atol=0.0)
    for g, r in zip(got[5:], ref[5:]):
        assert torch.equal(g, r)


@pytest.mark.cuda
@pytest.mark.parametrize("piece", [None, (192, 192)])
def test_kernel_matches_plain_on_card(scene, piece):
    """K1 against the plain version on the card, on all groups and on a
    piece at a nonzero group offset: integers equal, f32 planes to rtol
    1e-6."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, st = scene
    dev = torch.device("cuda")
    fields = tuple(f.to(dev) for f in st["fields"])
    pyramid = p_atlas.default_pyramid(RES)
    args, kw = p_atlas.feed_call(fields, st["values_cm"].to(dev),
                                 _matrix(20.0, SCALE), RES,
                                 np.float32(SCALE),
                                 st["group_buckets"].to(dev),
                                 pyramid=pyramid, piece=piece)
    got = p_feed.splat_feed_triton(*args, **kw)
    ref = p_feed.splat_feed_plain(*args, **kw)
    if piece is not None:
        assert got[0].shape[0] == piece[1]
    for g, r in zip(got[:5], ref[:5]):
        assert torch.allclose(g, r, rtol=1e-6, atol=0.0)
    for g, r in zip(got[5:], ref[5:]):
        assert torch.equal(g, r)
