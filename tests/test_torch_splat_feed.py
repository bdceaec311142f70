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


@pytest.mark.parametrize("width", [128, 192, 384, 189])
def test_feed_plain_matches_reference_at_slice_widths(scene, width):
    """Groups of any width (one interactive column slice each) through the
    plain feed and the interpreted Pallas feed; 189 is not a multiple of 4
    (the CUDA kernel's lane-by-lane path)."""
    _, st = scene
    sl = _sliced(st, width)
    got, ref = _run_both(sl, rot_deg=25.0)
    assert got[0].shape[1] == width
    _compare(got, ref)
    assert (got[8].numpy() // 4 > 0).any()


#: lanes of a few groups set to values a snapshot may hold: h NaN, +inf, 0
#: or negative; a NaN or infinite coordinate
ODD_LANES = ("h_nan", "h_inf", "h_zero", "h_negative", "pos_nan", "pos_inf")


def _odd(st, kind, seed=5):
    """The scene's state with 40 lanes of 20 groups (each of them holding
    visible particles) set to ``kind``'s odd value."""
    x, y, z, h = (f.clone() for f in st["fields"])
    rng = np.random.RandomState(seed)
    n_groups, G = x.shape
    live = np.flatnonzero((h.numpy() > 0).sum(axis=1) > G // 2)
    groups = np.repeat(rng.choice(live, 20, replace=False), 2)
    lanes = rng.randint(0, G, len(groups))
    if kind == "h_nan":
        h[groups, lanes] = float("nan")
    elif kind == "h_inf":
        h[groups, lanes] = float("inf")
    elif kind == "h_zero":
        h[groups, lanes] = 0.0
    elif kind == "h_negative":
        h[groups, lanes] = -torch.from_numpy(
            rng.uniform(0.01, 1.0, len(groups)).astype(np.float32))
    elif kind == "pos_nan":
        for f in (x, y, z):
            f[groups[::3], lanes[::3]] = float("nan")
        x[groups[1::3], lanes[1::3]] = float("nan")
    else:
        x[groups[::2], lanes[::2]] = float("inf")
        y[groups[1::2], lanes[1::2]] = -float("inf")
    return dict(st, fields=(x, y, z, h))


@pytest.mark.parametrize("kind", ODD_LANES)
def test_feed_plain_matches_reference_on_odd_lanes(scene, kind):
    """NaN, infinite, zero and negative smoothing lengths and NaN or
    infinite positions: the plain feed as the interpreted Pallas feed,
    NaN where it has NaN (a NaN h makes its group's extents NaN, and the
    int32 anchors of such a group 0, as XLA converts NaN)."""
    _, st = scene
    odd = _odd(st, kind)
    got, ref = _run_both(odd, rot_deg=35.0)
    _compare(got, ref)
    if kind == "h_nan":
        assert torch.isnan(got[2]).any()


def test_feed_plain_matches_reference_on_odd_lanes_at_width_189(scene):
    """Odd lanes in groups of 189 lanes, ranged and masked."""
    layout, st = scene
    sl = _sliced(_odd(st, "h_nan"), 189)
    n_groups = sl["fields"][0].shape[0]
    rng = np.random.RandomState(9)
    mask = (rng.random_sample((n_groups, 189)) < 0.7).astype(np.float32)
    got, ref = _run_both(sl, rot_deg=25.0, mask=mask,
                         prange=(1000, n_groups * 189 - 3000))
    _compare(got, ref)


def test_scalars_mirror_the_kernel_struct():
    """The wrapper's ctypes structure names the fields of
    ``csrc/splat_feed.cu``'s FeedScalars in order, with their C types, so
    the by-value parameters line up (the library also checks the size)."""
    import ctypes
    import re
    from pathlib import Path
    src = (Path(p_feed.__file__).resolve().parent.parent / "csrc"
           / "splat_feed.cu").read_text()
    body = re.search(r"struct FeedScalars \{(.*?)\};", src, re.S).group(1)
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    want = []
    for line in body.splitlines():
        decl = line.split("//")[0].strip().rstrip(";")
        if not decl:
            continue
        ctype, names = re.match(r"(long long|float|int)\s+(.*)", decl).groups()
        for n in (n.strip() for n in names.split(",")):
            m = re.match(r"(\w+)\[(\w+)\]", n)
            count = 1 if m is None else int(consts.get(m[2], m[2]))
            want.append((n if m is None else m[1], ctype, count))
    ctypes_of = {"long long": ctypes.c_longlong, "float": ctypes.c_float,
                 "int": ctypes.c_int}
    got = p_feed._Scalars._fields_
    assert [n for n, *_ in want] == [n for n, _ in got]
    for (name, ctype, count), (_, t) in zip(want, got):
        base = ctypes_of[ctype]
        assert t is base if count == 1 else (t._type_ is base
                                             and t._length_ == count), name
    size = sum(ctypes.sizeof(ctypes_of[c]) * k for _, c, k in want)
    assert ctypes.sizeof(p_feed._Scalars) == size


def test_scalars_round_as_the_plain_version(scene):
    """The kernel's parameters are the float32 values the plain feed uses:
    the matrix, the view's scale and the constants, and the piece's
    integers; a piece outside the layout raises."""
    _, st = scene
    args, kw = p_atlas.feed_call(st["fields"], st["values_cm"],
                                 _matrix(20.0, SCALE), RES, np.float32(SCALE),
                                 st["group_buckets"],
                                 pyramid=p_atlas.default_pyramid(RES),
                                 piece=(8, 37), prange=(5000, 9000))
    params_f, sp_i = args[3], args[4]
    n_groups, G = st["fields"][0].shape
    key = (params_f.tobytes(), sp_i.tobytes(), n_groups, G, kw["C_in"],
           kw["depth_channel"], kw["resolution"], kw["atlas_rows"],
           kw["atlas_cols"], kw["window_rows"], kw["band"], kw["col_pad"],
           kw["foot"], kw["piece_groups"], kw["ranged"], kw["has_mask"],
           kw["sentinel_ay"], "lowrank")
    s = p_feed._scalars(*key)
    assert list(s.m) == [float(v) for v in params_f[:12]]
    assert (s.ppw, s.inv_ppw) == (float(params_f[12]), float(params_f[13]))
    assert (s.g0, s.piece_groups, s.G, s.start, s.count) == (8, 37, G, 5000,
                                                             9000)
    assert (s.ranged, s.has_mask, s.c_in, s.depth) == (1, 0, 2, 0)
    assert s.v_cstride == n_groups * G
    assert s.margin == np.float32(kw["col_pad"] - kw["foot"] + 4.0)
    assert list(s.sz_r) == [16.0, 32.0, 48.0]
    assert list(s.sz_c) == [32.0, 64.0, 128.0]
    assert s.giant_h == np.float32(kw["foot"] / 2.0)
    bad = list(key)
    bad[13] = n_groups          # n_groups groups from g0 = 8
    with pytest.raises(ValueError, match="outside"):
        p_feed._scalars(*bad)


def test_feed_wrapper_refuses_other_devices(scene):
    """``splat_feed`` runs the plain version for CPU tensors only; the CUDA
    wrapper refuses CPU tensors (no fallback either way)."""
    _, st = scene
    args, kw = p_atlas.feed_call(st["fields"], st["values_cm"],
                                 _matrix(0.0, SCALE), RES, np.float32(SCALE),
                                 st["group_buckets"],
                                 pyramid=p_atlas.default_pyramid(RES),
                                 piece=(0, 4))
    with pytest.raises(ValueError, match="CUDA"):
        p_feed.splat_feed_cuda(*args, **kw)
    before = p_feed.launches
    out = p_feed.splat_feed(*args, **kw)
    assert out[0].shape == (4, st["fields"][0].shape[1])
    assert p_feed.launches == before


# ---- K1 on the card against the plain version ----------------------------

def _card_equal(got, ref, equal_nan=False):
    """Integers equal, f32 planes to rtol 1e-6 (NaN where the plain version
    has NaN, with ``equal_nan``)."""
    assert got[0].shape == ref[0].shape
    for g, r in zip(got[:5], ref[:5]):
        assert torch.allclose(g, r, rtol=1e-6, atol=0.0, equal_nan=equal_nan)
    for g, r in zip(got[5:], ref[5:]):
        assert torch.equal(g, r)


@pytest.mark.cuda
@pytest.mark.parametrize("width,piece", [(192, None), (320, None),
                                         (384, None), (384, (8, 37)),
                                         (189, None), (189, (8, 37))])
def test_kernel_matches_plain_on_card_at_slice_widths(scene, width, piece):
    """K1 at group widths that are not powers of two (a block of
    ceil(G / 4) threads rounded up to a warp, no padded lanes; 189 takes
    the lane-by-lane path), on all groups and on a piece that does not
    start at group 0: integers equal, f32 planes to rtol 1e-6."""
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
    got = p_feed.splat_feed_cuda(*args, **kw)
    ref = p_feed.splat_feed_plain(*args, **kw)
    assert (ref[8] // 4 > 0).any()
    _card_equal(got, ref)


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
    got = p_feed.splat_feed_cuda(*args, **kw)
    ref = p_feed.splat_feed_plain(*args, **kw)
    if piece is not None:
        assert got[0].shape[0] == piece[1]
    _card_equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ODD_LANES)
@pytest.mark.parametrize("width", [512, 189])
def test_kernel_matches_plain_on_card_on_odd_lanes(scene, kind, width):
    """The card twins of the odd-lane cases: K1 against the plain version
    with NaN, infinite, zero and negative h and NaN or infinite positions,
    at G = 512 and at 189: integers equal, f32 planes to rtol 1e-6 and
    NaN where the plain version has NaN."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, st = scene
    odd = _odd(st, kind)
    if width != 512:
        odd = _sliced(odd, width)
    dev = torch.device("cuda")
    args, kw = p_atlas.feed_call(tuple(f.to(dev) for f in odd["fields"]),
                                 odd["values_cm"].to(dev),
                                 _matrix(35.0, SCALE), RES, np.float32(SCALE),
                                 odd["group_buckets"].to(dev),
                                 pyramid=p_atlas.default_pyramid(RES))
    _card_equal(p_feed.splat_feed_cuda(*args, **kw),
                p_feed.splat_feed_plain(*args, **kw), equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("width,piece", [(512, None), (512, (8, 37)),
                                         (189, None), (189, (8, 37))])
@pytest.mark.parametrize("c_in,depth,ranged,masked",
                         [(3, True, True, True), (3, False, False, True),
                          (1, True, True, False), (2, True, False, False)])
def test_kernel_variants_match_plain_on_card(scene, width, piece, c_in,
                                             depth, ranged, masked):
    """K1's template variants: three value rows with the depth channel, a
    particle range and a mask, and the others, at G = 512 and 189, on all
    groups and on a piece: integers equal, f32 planes to rtol 1e-6."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    layout, st = scene
    src = st if width == 512 else _sliced(st, width)
    dev = torch.device("cuda")
    fields = tuple(f.to(dev) for f in src["fields"])
    vals = src["values_cm"].to(dev)
    vals = torch.cat([vals, vals[:1] * 0.5])[:c_in].contiguous()
    n_groups, G = fields[0].shape
    rng = np.random.RandomState(11)
    mask = (torch.from_numpy((rng.random_sample((n_groups, G)) < 0.6)
                             .astype(np.float32)).to(dev) if masked else None)
    prange = (G * 3 + 17, n_groups * G // 2) if ranged else None
    args, kw = p_atlas.feed_call(fields, vals, _matrix(15.0, SCALE), RES,
                                 np.float32(SCALE),
                                 src["group_buckets"].to(dev), mask=mask,
                                 pyramid=p_atlas.default_pyramid(RES),
                                 depth_channel=depth, piece=piece,
                                 prange=prange)
    got = p_feed.splat_feed_cuda(*args, **kw)
    assert len(got[3]) == c_in + int(depth)
    _card_equal(got, p_feed.splat_feed_plain(*args, **kw))
