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


# ---------------------------------------------------------------------------
# the kernel's work list and per-panel cull (plain mirrors)
# ---------------------------------------------------------------------------

def _edge_groups(rng, G, window_cols):
    """``_groups`` of every class (rolled when ``window_cols`` is the
    windowed width) with particles placed on the cull's edges: dy = -8 and
    +8 across a panel edge (rows 16, 32, 48) and dx likewise (columns 32,
    64, 128), the front end's sentinel and NaN-mapped anchors with ih > 0,
    non-finite and far anchors, and a column base whose rectangle runs past
    ``ATLAS_COLS``."""
    rolled = window_cols == r_zp.WINDOW_COLS
    classes = [0, 1, 2, 3, 3, None] if rolled else [FULL, FULL, None, FULL]
    ay, ax, ih, pay, w0, c0, ce, flags = _groups(rng, G, classes, rolled,
                                                 window_cols)
    ay, ax, ih = ay[:, 0].copy(), ax[:, 0].copy(), ih[:, 0].copy()
    cbase = ce if rolled else c0
    if rolled:
        ce[-2] = ATLAS_COLS - 40           # its 128 columns pass the atlas
        cbase = ce
    edges = [(e, s) for e in (16, 32, 48) for s in (-8.0, 8.0)]
    for k, (e, sgn) in enumerate(edges[:max(0, G - 16) // 2]):
        j = 16 + 2 * k
        ay[:, j] = w0 + e - sgn            # row e at dy = sgn
        ax[:, j] = cbase + 10.5
        ay[:, j + 1] = w0 + 5.25
        ax[:, j + 1] = cbase + 2 * e - sgn  # column 2e at dx = sgn
        ih[:, j:j + 2] = 0.125
    if G >= 32:
        sentinel = float(ATLAS_ROWS - 64 + 8.0 + 2.0)
        ay[:, 4], ih[:, 4] = sentinel, 0.5          # sentinel anchor row
        ax[:, 5], ih[:, 5] = 16.0, 0.5              # NaN-mapped column
        ay[:, 6], ih[:, 6] = np.nan, 0.5
        ax[:, 7], ih[:, 7] = np.inf, 0.5
        ay[:, 8], ih[:, 8] = 1e9, 0.5
        ax[:, 9], ih[:, 9] = ATLAS_COLS - 2.5, 0.3  # at the atlas's edge
    return (ay[:, None], ax[:, None], ih[:, None], pay, w0, c0, ce, flags)


CULL_SHAPES = {name: (G, window_cols, seed)
               for name, (G, window_cols, _, seed) in SHAPES.items()}
CULL_SHAPES.update({"edges_main_G64": (64, r_zp.WINDOW_COLS, 5),
                    "edges_main_G128": (128, r_zp.WINDOW_COLS, 6),
                    "edges_tier2_G64": (64, ATLAS_COLS, 7)})


@pytest.fixture(scope="module", params=sorted(CULL_SHAPES))
def cull_case(request):
    G, window_cols, seed = CULL_SHAPES[request.param]
    rng = np.random.RandomState(seed)
    if request.param in SHAPES:
        args = _groups(rng, G, SHAPES[request.param][2],
                       window_cols == r_zp.WINDOW_COLS, window_cols)
    else:
        args = _edge_groups(rng, G, window_cols)
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
    return request.param, G, window_cols, t


def _kw(G, window_cols, **extra):
    return dict(group=G, window_cols=window_cols, window_rows=WINDOW_ROWS,
                **extra)


def _call_shape(t, G, window_cols):
    """(rolled, profile columns, column bases) of a call."""
    prof = r_zp.PROFILE_COLS if window_cols == r_zp.WINDOW_COLS \
        else window_cols
    rolled = prof != window_cols
    return rolled, prof, (t[6] if rolled else t[5])


def _frag_keys(t, G, window_cols, g, i, r, c):
    """The plain version's arithmetic for particle i of group g over the
    rows r x columns c (1-D offsets in the rectangle): (rows, columns, keys)
    of the fragments it merges."""
    ay, ax, ih, pay, w0, c0, ce, flags = t
    n = w0.shape[0]
    _, prof, cbase = _call_shape(t, G, window_cols)
    sz = int(flags[g]) % 4
    rows, cols = p_za.class_extents(sz, WINDOW_ROWS, prof)
    order = p_za.sum_order(G, cols)
    a_y, a_x = ay.reshape(n, G)[g, i], ax.reshape(n, G)[g, i]
    ih_i = ih.reshape(n, G)[g, i]
    shape = (r.numel(), c.numel())
    dy = ((w0[g].float() + r.float()) - a_y)[:, None].expand(shape)
    dx = ((cbase[g].float() + c.float()) - a_x)[None, :].expand(shape)
    if order == 0:
        s = dy * dy + dx * dx
    elif order == 1:
        s = p_za._fma32(dx, dx, dy * dy)
    else:
        s = p_za._fma32(dy, dy, dx * dx)
    tt = p_za._fma32(-s, (ih_i * ih_i).expand(shape), torch.full(shape, 4.0))
    k = torch.sqrt(torch.clamp(tt, min=0.0).double()).float()
    dep = p_za._fma32(k, pay[g, 1, i].expand(shape), pay[g, 0, i].expand(shape))
    rr, cc = r[:, None].expand(shape), c[None, :].expand(shape)
    ok = ((dy > -p_za.FOOT) & (dy <= p_za.FOOT) & (dx > -p_za.FOOT)
          & (dx <= p_za.FOOT) & (tt > 0.0) & (ih_i > 0.0) & (rr >= 0)
          & (rr < rows) & (cc >= 0) & (cc < cols)
          & (rr + int(w0[g]) >= 0) & (rr + int(w0[g]) < ATLAS_ROWS)
          & (cc + int(cbase[g]) >= 0) & (cc + int(cbase[g]) < ATLAS_COLS))
    return rr[ok], cc[ok], p_za.pack_keys(dep[ok], pay[g, 2, i].expand(
        shape)[ok])


def _hits(t, G, window_cols):
    """Every fragment the plain version merges, (group, particle, row,
    column) offsets in the group's rectangle, over the rows and columns
    floor(a) - 8 .. floor(a) + 9 (the only ones with -8 < d <= 8)."""
    ay, ax, ih, pay, w0, c0, ce, flags = t
    n = w0.shape[0]
    rolled, _, cbase = _call_shape(t, G, window_cols)
    off = torch.arange(-8, 10)
    out = []
    for g in range(n):
        f = int(flags[g])
        if f // 4 != p_za.FLAG_ACTIVE or not (rolled or f % 4 == FULL):
            continue
        for i in range(G):
            a_y, a_x = float(ay.reshape(n, G)[g, i]), \
                float(ax.reshape(n, G)[g, i])
            if not (np.isfinite(a_y) and np.isfinite(a_x)):
                continue
            r = int(np.floor(min(a_y, 1e8))) - int(w0[g]) + off
            c = int(np.floor(min(a_x, 1e8))) - int(cbase[g]) + off
            rr, cc, _ = _frag_keys(t, G, window_cols, g, i, r, c)
            out.extend((g, i, a, b) for a, b in zip(rr.tolist(), cc.tolist()))
    return out


@pytest.mark.parametrize("rolled", [True, False])
def test_deposit_plan_lists_active_groups_in_class_order(rolled):
    rng = np.random.RandomState(11)
    flags = torch.from_numpy(rng.randint(0, 12, 500).astype(np.int32))
    order, class_off = p_za.deposit_plan(flags, rolled)
    want = []
    for sz in range(4):
        want.append([g for g in range(500) if int(flags[g]) // 4 == 1
                     and int(flags[g]) % 4 == sz and (rolled or sz == FULL)])
    assert class_off.tolist() == np.cumsum(
        [0] + [len(w) for w in want]).tolist()
    assert order[:class_off[-1]].tolist() == sum(want, [])
    assert sorted(order.tolist()) == list(range(500))


def test_cull_lists_every_merged_fragment(cull_case):
    """Every fragment the plain version merges lies in its particle's box,
    and the particle is on the list of the panel that holds the pixel."""
    name, G, window_cols, t = cull_case
    boxes = p_za.particle_boxes(*t[:3], *t[4:], atlas_rows=ATLAS_ROWS,
                                atlas_cols=ATLAS_COLS,
                                **_kw(G, window_cols))
    lists = p_za.tile_lists(boxes, t[7], window_cols=window_cols,
                            window_rows=WINDOW_ROWS)
    hits = _hits(t, G, window_cols)
    assert len(hits) > 100, name
    listed = {k: set(v.tolist()) for k, v in lists.items()}
    for g, i, r, c in hits:
        b = boxes[g, i].tolist()
        assert b[0] <= r <= b[1] and b[2] <= c <= b[3], (name, g, i, r, c, b)
        pr, pc = p_za.PANELS[int(t[7][g]) % 4]
        assert i in listed[(g, r // pr, c // pc)], (name, g, i, r, c)
    # the box is tight along each axis: its end rows and columns hold a hit
    # of the particle or fail only the other axis's test
    assert sum(int(b[1] - b[0] + 1) * int(b[3] - b[2] + 1)
               for b in boxes.reshape(-1, 4) if b[0] <= b[1]) < 4 * len(hits)


def test_box_deposit_equals_plain(cull_case):
    """The kernel's algorithm in plain PyTorch: evaluating each listed
    particle over its box inside each listed panel only gives the plain
    version's atlas exactly."""
    name, G, window_cols, t = cull_case
    ay, ax, ih, pay, w0, c0, ce, flags = t
    kw = _kw(G, window_cols)
    keys0 = p_za.pack_atlas(torch.zeros((2, ATLAS_ROWS, ATLAS_COLS)))
    plain = p_za.accumulate_max_packed_plain(keys0.clone(), *t, **kw)
    boxes = p_za.particle_boxes(ay, ax, ih, w0, c0, ce, flags,
                                atlas_rows=ATLAS_ROWS, atlas_cols=ATLAS_COLS,
                                **kw)
    _, _, cbase = _call_shape(t, G, window_cols)
    flat = keys0.clone().view(-1)
    for (g, tr, tc), idx in p_za.tile_lists(
            boxes, flags, window_cols=window_cols,
            window_rows=WINDOW_ROWS).items():
        pr, pc = p_za.PANELS[int(flags[g]) % 4]
        for i in idx.tolist():
            r0, r1, c0_, c1 = boxes[g, i].tolist()
            r = torch.arange(max(r0, tr * pr), min(r1, tr * pr + pr - 1) + 1)
            c = torch.arange(max(c0_, tc * pc), min(c1, tc * pc + pc - 1) + 1)
            rr, cc, key = _frag_keys(t, G, window_cols, g, i, r, c)
            flat.scatter_reduce_(0, (rr + int(w0[g])) * ATLAS_COLS
                                 + cc + int(cbase[g]), key, "amax")
    assert torch.equal(flat.view(ATLAS_ROWS, ATLAS_COLS), plain), name


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("rolled", [True, False])
def test_plan_kernel_matches_plain_on_card(rolled):
    dev = _card()
    rng = np.random.RandomState(12)
    for n in (1, 7, 1000, 40000):
        flags = torch.from_numpy(rng.randint(0, 12, n).astype(np.int32))
        want = p_za.deposit_plan(flags, rolled)
        got = p_za.deposit_plan_cuda(flags.to(dev), rolled)
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b), (n, rolled)


def _card_equal(t, keys0, **kw):
    dev = torch.device("cuda")
    t = [a.to(dev) for a in t]
    got = p_za.accumulate_max_packed_cuda(keys0.to(dev), *t, **kw)
    plain = p_za.accumulate_max_packed_plain(keys0.to(dev), *t, **kw)
    torch.cuda.synchronize()
    return torch.equal(got, plain)


@pytest.mark.cuda
def test_kernel_bit_identical_on_cull_cases_on_card(cull_case):
    """K3 against the plain version on the cull's edge cases (G = 64 and 128
    in the rolled main shape, full-width groups, edge anchors), onto an
    atlas that already holds keys."""
    _card()
    name, G, window_cols, t = cull_case
    rng = np.random.RandomState(13)
    atlas0 = torch.from_numpy(np.stack([
        rng.uniform(0.0, 0.9, (ATLAS_ROWS, ATLAS_COLS)),
        rng.normal(0.0, 1.0, (ATLAS_ROWS, ATLAS_COLS))]).astype(np.float32))
    for keys0 in (p_za.pack_atlas(torch.zeros_like(atlas0)),
                  p_za.pack_atlas(atlas0)):
        assert _card_equal(t, keys0, **_kw(G, window_cols)), name


@pytest.mark.cuda
def test_kernel_bit_identical_at_right_edge_on_card():
    """Full-width (tier-2) groups whose particles sit at the right edge of
    a 1,152-column atlas."""
    _card()
    rng = np.random.RandomState(14)
    cols, G = 1152, 64
    ay, ax, ih, pay, w0, c0, ce, flags = _groups(
        rng, G, [FULL, FULL, None, FULL], False, cols)
    ax[:, 0] = rng.uniform(cols - 14.0, cols + 2.0, (4, G))
    t = [torch.from_numpy(np.ascontiguousarray(a))
         for a in (ay, ax, ih, pay, w0, c0, ce, flags)]
    keys0 = p_za.pack_atlas(torch.zeros((2, ATLAS_ROWS, cols)))
    assert _card_equal(t, keys0, group=G, window_cols=cols,
                       window_rows=WINDOW_ROWS)


@pytest.mark.cuda
def test_kernel_bit_identical_on_forced_stragglers_on_card():
    """Every call of a surface deposit on a spill-heavy scene, and the
    one-particle tier 3 of a zero-row fit window (every gathered spilled
    particle a straggler)."""
    from topsy_tpu_torch import camera
    from topsy_tpu_torch.ops import morton
    from topsy_tpu_torch.ops import zsplat_atlas as p_zatl
    dev = _card()
    rng = np.random.RandomState(2)
    n = 4096
    ps = np.zeros((n, 4), np.float32)
    corners = np.array([[-80, -80], [80, -80], [-80, 80], [80, 80]])
    c = corners[np.arange(n) % 4]
    ps[:, :2] = c + rng.uniform(-15, 15, (n, 2))
    ps[:, 2] = rng.uniform(-40, 40, n)
    ps[:, 3] = rng.uniform(2.0, 6.0, n)
    vals = np.stack([np.ones(n), rng.uniform(0, 1, n)], 1).astype(np.float32)
    layout = morton.build_presorted(ps)
    args = (torch.from_numpy(layout.apply(ps, fill=morton.PAD_POS)).to(dev),
            torch.from_numpy(layout.apply(vals)).to(dev),
            camera.world_to_clip_matrix(np.eye(3), np.zeros(3), 120.0), 128,
            np.float32(120.0),
            torch.from_numpy(np.asarray(layout.buckets, np.int32)).to(dev))
    for rows in (p_zatl.WINDOW_ROWS, 0):
        main, tier2, tier3, _, shape = p_zatl.deposit_calls(
            *args, t3_cap=256, window_rows=rows)
        assert int((tier3["flags"] // 4 == p_za.FLAG_ACTIVE).sum()) > 0 \
            or rows
        keys0 = p_za.pack_atlas(torch.zeros(shape, device=dev))
        for kw in (main, tier2, tier3):
            kw = dict(kw)
            t = [kw.pop(k) for k in ("ay_g", "ax_g", "ih_g", "pay_g", "w0",
                                     "c0", "ce", "flags")]
            assert _card_equal(t, keys0, **kw), rows


def test_k3_census_counts_the_cull(cull_case):
    """chip_smoke.k3_census's panels, list entries and evaluated pairs
    against a walk over ``tile_lists`` and the boxes."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    name, G, window_cols, t = cull_case
    kw = dict(zip(("ay_g", "ax_g", "ih_g", "pay_g", "w0", "c0", "ce",
                   "flags"), t), **_kw(G, window_cols))
    keys = p_za.pack_atlas(torch.zeros((2, ATLAS_ROWS, ATLAS_COLS)))
    got = cs.k3_census(kw, keys)
    boxes = p_za.particle_boxes(*t[:3], *t[4:], atlas_rows=ATLAS_ROWS,
                                atlas_cols=ATLAS_COLS, **_kw(G, window_cols))
    lists = p_za.tile_lists(boxes, t[7], window_cols=window_cols,
                            window_rows=WINDOW_ROWS)
    pairs = 0
    for (g, tr, tc), idx in lists.items():
        pr, pc = p_za.PANELS[int(t[7][g]) % 4]
        for i in idx.tolist():
            r0, r1, c0, c1 = boxes[g, i].tolist()
            pairs += ((min(r1, tr * pr + pr - 1) - max(r0, tr * pr) + 1)
                      * (min(c1, tc * pc + pc - 1) - max(c0, tc * pc) + 1))
    assert got["panels"] == len(lists), name
    assert got["entries"] == sum(v.numel() for v in lists.values()), name
    assert got["pairs"] == pairs, name
    dispatched = p_za._dispatched(t[7], window_cols == r_zp.WINDOW_COLS)
    assert got["by_class"] == [int((dispatched == k).sum())
                               for k in range(4)], name
