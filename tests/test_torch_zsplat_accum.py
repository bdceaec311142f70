"""The port's plain z-buffered deposit (accumulate_max_groups_plain) against
the reference's Pallas kernel accumulate_max_groups_pallas in interpret
mode, in the three call shapes zsplat_atlas makes:

* the main pass: G=512, 256-column windows with 128 profile columns, every
  size class;
* spill tier 2: G=64, ``window_cols=atlas_cols`` (full-width windows);
* spill tier 3: G=1, the full class.

Inputs (seeded numpy) include invalid particles (ih <= 0), particles on
both edges of the +-8 footprint, exact depth ties with different values,
and inactive groups.  The atlas planes must be equal: the plain version
rounds the fused multiply-adds of the reference's CPU compile once each
(``zsplat_accum.sum_order``), and max is order-independent.  A card test
holds kernel K3 bit-identical to the plain version on the same inputs."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from topsy_tpu.ops import zsplat_pallas as r_zp

from topsy_tpu_torch.ops import zsplat_accum as p_za

# one process's share of the cores when pytest-xdist runs several workers
# (torch's default, every core in each process, oversubscribes them)
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

ATLAS_ROWS = 320
ATLAS_COLS = 512
WINDOW_ROWS = 96


def _groups(rng, G, classes, rolled, window_cols):
    """Operands for one group per entry of ``classes`` (None = inactive)."""
    profile_cols = r_zp.PROFILE_COLS if rolled else window_cols
    n = len(classes)
    w0 = (8 * rng.randint(0, (ATLAS_ROWS - WINDOW_ROWS) // 8, n)).astype(
        np.int32)
    if rolled:
        c0 = (128 * rng.randint(0, (ATLAS_COLS - 256) // 128 + 1, n)).astype(
            np.int32)
        ce = (c0 + rng.randint(0, 129, n)).astype(np.int32)
    else:
        c0 = np.zeros(n, np.int32)
        ce = c0.copy()
    cbase = ce if rolled else c0
    ay = np.empty((n, G), np.float32)
    ax = np.empty((n, G), np.float32)
    flags = np.zeros(n, np.int32)
    for g, sz in enumerate(classes):
        rows, cols = p_za.class_extents(FULL if sz is None else sz,
                                        WINDOW_ROWS, profile_cols)
        ay[g] = w0[g] + rng.uniform(-6.0, rows + 6.0, G)
        ax[g] = cbase[g] + rng.uniform(-6.0, cols + 6.0, G)
        if sz is not None:
            flags[g] = r_zp.FLAG_ACTIVE * 4 + sz
    ih = (1.0 / rng.uniform(0.71, 4.0, (n, G))).astype(np.float32)
    ih[rng.random_sample((n, G)) < 0.1] *= -1.0            # invalid
    z = rng.uniform(0.2, 0.8, (n, G)).astype(np.float32)
    hch = rng.uniform(1e-3, 3e-2, (n, G)).astype(np.float32)
    val = rng.normal(0.0, 1.0, (n, G)).astype(np.float32)
    if G >= 4:
        # footprint edges: dy = -8 (excluded) and dy = +8 (included)
        ay[:, 0] = w0 + 9.0
        ay[:, 1] = w0 + 1.0
        ih[:, :2] = 0.125
        # an exact depth tie: a duplicate particle with another value
        ay[:, 3], ax[:, 3], ih[:, 3] = ay[:, 2], ax[:, 2], abs(ih[:, 2])
        ih[:, 2] = ih[:, 3]
        z[:, 3], hch[:, 3] = z[:, 2], hch[:, 2]
        val[:, 3] = val[:, 2] + 1.0
    pay = np.stack([z, hch, val], axis=1)
    return (ay[:, None], ax[:, None], ih[:, None], pay, w0, c0, ce, flags)


FULL = r_zp.FULL_CLASS

SHAPES = {
    # name: (G, window_cols, classes, seed)
    "main_G512": (512, r_zp.WINDOW_COLS, [0, 1, 2, 3, None, 0, 1, 2, 3, 1],
                  0),
    "tier2_G64": (64, ATLAS_COLS, [FULL, FULL, None, FULL], 1),
    "tier3_G1": (1, r_zp.WINDOW_COLS, [FULL] * 6 + [None, FULL], 2),
}


@pytest.fixture(scope="module", params=sorted(SHAPES))
def shape_case(request):
    G, window_cols, classes, seed = SHAPES[request.param]
    rng = np.random.RandomState(seed)
    args = _groups(rng, G, classes, window_cols == r_zp.WINDOW_COLS,
                   window_cols)
    ref = np.asarray(r_zp.accumulate_max_groups_pallas(
        *(jnp.asarray(a) for a in args), atlas_rows=ATLAS_ROWS,
        atlas_cols=ATLAS_COLS, group=G, interpret=True,
        window_cols=window_cols, window_rows=WINDOW_ROWS, subgroups=1))
    return request.param, G, window_cols, args, ref


def _plain(args, G, window_cols, atlas0=None):
    return p_za.accumulate_max_groups_plain(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in args),
        atlas_rows=ATLAS_ROWS, atlas_cols=ATLAS_COLS, group=G,
        window_cols=window_cols, window_rows=WINDOW_ROWS, atlas0=atlas0)


def test_plain_equals_interpreted_pallas(shape_case):
    name, G, window_cols, args, ref = shape_case
    got = _plain(args, G, window_cols).numpy()
    assert (ref[0] > 0).sum() > 100, name
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])


def test_merge_onto_existing_atlas_order_free(shape_case):
    """Depositing in two halves onto the first half's atlas, in either
    order, gives the one-call atlas (the packed max is order-free)."""
    name, G, window_cols, args, ref = shape_case
    n = args[0].shape[0]
    halves = [tuple(a[:n // 2] for a in args), tuple(a[n // 2:] for a in args)]
    for first, second in (halves, halves[::-1]):
        part = _plain(first, G, window_cols)
        got = _plain(second, G, window_cols, atlas0=part).numpy()
        np.testing.assert_array_equal(got, ref)


def test_pack_roundtrip_and_order():
    rng = np.random.RandomState(3)
    d = np.concatenate([rng.normal(0, 1, 1000), [0.0, -0.0, 1e-40, -1e-40,
                                                3e38, -3e38]]).astype(
        np.float32)
    v = rng.normal(0, 1, d.size).astype(np.float32)
    atlas = torch.from_numpy(np.stack([d, v])[:, None, :])
    back = p_za.unpack_atlas(p_za.pack_atlas(atlas)).numpy()
    np.testing.assert_array_equal(back, atlas.numpy())   # -0.0 == +0.0
    keys = p_za.pack_keys(torch.from_numpy(d), torch.from_numpy(v)).numpy()
    order = np.lexsort((v, d))
    assert (np.diff(keys[order]) >= 0).all()


@pytest.mark.cuda
def test_kernel_bit_identical_to_plain_on_card(shape_case):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    name, G, window_cols, args, ref = shape_case
    dev = torch.device("cuda")
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in args]
    kw = dict(atlas_rows=ATLAS_ROWS, atlas_cols=ATLAS_COLS, group=G,
              window_cols=window_cols, window_rows=WINDOW_ROWS)
    got = p_za.accumulate_max_groups_cuda(*t, **kw)
    plain = p_za.accumulate_max_groups_plain(*t, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, plain), name
    np.testing.assert_array_equal(got.cpu().numpy(), ref)
