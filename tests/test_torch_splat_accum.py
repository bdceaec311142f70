"""The port's plain deposit (accumulate_groups_plain) against the
reference's Pallas kernel accumulate_groups_pallas in interpret mode, in
the three call shapes the reference makes:

* the main pass: G=512, 256-column windows with 128 profile columns;
* spill tier 2: G=64, ``window_cols=atlas_cols`` (full-width windows);
* spill tier 3: G=1, size class 1 or FULL.

Every kind (ALL_TINY, POLY, MIXED, MASKED, INACTIVE) and every size class
appears.  Tolerance: atlas max abs diff <= 1e-5 * max|atlas| — both sides
multiply the same bf16-rounded operands exactly in f32; only the order of
the f32 sums differs.  Inputs are built as in
tests/test_splat_pallas_fresh.py, from a seeded numpy generator."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from topsy_tpu.ops import splat_pallas as r_pallas
from topsy_tpu.ops.splat import H_MAX

from topsy_tpu_torch.ops import splat_accum as p_accum
from topsy_tpu_torch.ops.splat_accum import (FLAG_ALL_TINY, FLAG_INACTIVE,
                                             FLAG_MASKED, FLAG_MIXED,
                                             FLAG_POLY, FULL_CLASS)

# one process's share of the cores when pytest-xdist runs several workers
# (torch's default, every core in each process, oversubscribes them)
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

C = 2
ATLAS_ROWS = 400
ATLAS_COLS = 512
WINDOW_ROWS = 96


def _group(rng, kind, G, w0, cbase, rows_eval, cols_eval, nc=C):
    ay = w0 + rng.uniform(1.0, rows_eval - 1.0, G)
    ax = cbase + rng.uniform(1.0, cols_eval - 1.0, G)
    poly = 1.0 / rng.uniform(0.71, 3.5, G)
    big = 1.0 / rng.uniform(3.6, 16.0, G)
    if kind == FLAG_ALL_TINY:
        ih = -np.ones(G)
    elif kind == FLAG_POLY:
        ih = poly
    elif kind == FLAG_MIXED:
        ih = np.where(rng.random_sample(G) < 0.4, -1.0, poly)
    elif kind == FLAG_MASKED:
        r = rng.random_sample(G)
        ih = np.where(r < 0.3, big, np.where(r < 0.5, -1.0, poly))
    else:
        ih = poly
    coef = rng.normal(0.0, 1.0, (nc, G))
    coef[:, rng.random_sample(G) < 0.1] = 0.0   # some invisible particles
    if kind == FLAG_INACTIVE:
        coef[:] = 0.0
    return ay, ax, ih, coef


def _build(specs, G, rolled, seed, nc=C, run=1, edges=False):
    """specs: list of (kind, size_class); returns numpy operands with flags
    from the reference's group_flags (the size class applies to TINY/POLY
    groups only, as in the reference).  ``run``: blocks of that many
    consecutive groups share their anchors; ``edges``: every third block
    is anchored where its rectangle crosses the atlas's bottom or right
    edge."""
    rng = np.random.RandomState(seed)
    n = len(specs)
    ay = np.zeros((n, G)); ax = np.zeros((n, G)); ih = np.zeros((n, G))
    coef = np.zeros((nc, n, G))
    w0 = np.zeros(n, np.int32); c0 = np.zeros(n, np.int32)
    ce = np.zeros(n, np.int32); sizes = np.zeros(n, np.int32)
    profile_cols = p_accum.PROFILE_COLS if rolled else ATLAS_COLS
    for g, (kind, sz) in enumerate(specs):
        rows_eval, cols_eval = p_accum._extents(sz, WINDOW_ROWS, profile_cols)
        if g % run:
            w0[g], c0[g], ce[g] = w0[g - 1], c0[g - 1], ce[g - 1]
        elif edges and (g // run) % 3 == 2:
            w0[g] = ATLAS_ROWS - 8 * rng.randint(1, 5)
            if rolled:
                c0[g] = ATLAS_COLS - 256
                ce[g] = ATLAS_COLS - rng.randint(1, 40)
        else:
            w0[g] = 8 * rng.randint(0, (ATLAS_ROWS - WINDOW_ROWS) // 8 + 1)
            if rolled:
                c0[g] = 128 * rng.randint(0, (ATLAS_COLS - 256) // 128 + 1)
                ce[g] = c0[g] + rng.randint(0, 129)
        cbase = ce[g] if rolled else c0[g]
        ay[g], ax[g], ih[g], coef[:, g] = _group(rng, kind, G, w0[g], cbase,
                                                 rows_eval, cols_eval, nc)
        sizes[g] = sz
    ay, ax, ih, coef = (a.astype(np.float32) for a in (ay, ax, ih, coef))
    flags = np.asarray(r_pallas.group_flags(
        jnp.asarray(ih), jnp.asarray(coef.transpose(1, 2, 0)), H_MAX,
        sizes=jnp.asarray(sizes)))
    return ay, ax, ih, coef, w0, c0, ce, flags


def _run(ops, G, window_cols, atlas0=None):
    ay, ax, ih, coef, w0, c0, ce, flags = ops
    n = len(w0)
    kw = dict(atlas_rows=ATLAS_ROWS, atlas_cols=ATLAS_COLS, C=C, group=G,
              window_cols=window_cols, window_rows=WINDOW_ROWS)
    ref = np.asarray(r_pallas.accumulate_groups_pallas(
        jnp.asarray(ay.reshape(n, 1, G)), jnp.asarray(ax.reshape(n, 1, G)),
        jnp.asarray(ih.reshape(n, 1, G)),
        jnp.asarray(coef.transpose(1, 0, 2)), jnp.asarray(w0),
        jnp.asarray(c0), jnp.asarray(ce), jnp.asarray(flags),
        interpret=True,
        atlas0=None if atlas0 is None else jnp.asarray(atlas0), **kw))
    got = p_accum.accumulate_groups_plain(
        torch.from_numpy(ay), torch.from_numpy(ax), torch.from_numpy(ih),
        torch.from_numpy(coef), torch.from_numpy(w0), torch.from_numpy(c0),
        torch.from_numpy(ce), torch.from_numpy(flags.copy()),
        atlas0=None if atlas0 is None else torch.from_numpy(atlas0.copy()),
        **kw).numpy()
    return got, ref


def _assert_close(got, ref, base=None):
    dep = ref if base is None else ref - base
    assert np.abs(dep).max() > 0.0
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


ALL_SIZED = ([(FLAG_ALL_TINY, s) for s in range(4)]
             + [(FLAG_POLY, s) for s in range(4)]
             + [(FLAG_MIXED, FULL_CLASS), (FLAG_MASKED, FULL_CLASS),
                (FLAG_INACTIVE, FULL_CLASS)])


def test_main_pass_shape():
    """G=512, 256-column rolled windows, every kind and size class, plus
    a MIXED group flagged with a small class (no reference branch: no
    deposit)."""
    specs = ALL_SIZED + [(FLAG_MIXED, 1), (FLAG_POLY, 0), (FLAG_POLY, 2),
                         (FLAG_MASKED, FULL_CLASS), (FLAG_ALL_TINY, 1)]
    ops = _build(specs, 512, rolled=True, seed=11)
    flags = ops[-1]
    kinds = set((flags // 4).tolist())
    assert kinds == {0, 1, 2, 3, 4}
    assert set((flags % 4)[flags // 4 == FLAG_POLY].tolist()) == {0, 1, 2, 3}
    got, ref = _run(ops, 512, p_accum.WINDOW_COLS)
    _assert_close(got, ref)


def test_spill_tier2_shape():
    """G=64 over full-width windows (window_cols = atlas_cols, c0 = ce =
    0), accumulated onto a nonzero atlas; flags carry the full class."""
    specs = ([(FLAG_ALL_TINY, FULL_CLASS), (FLAG_POLY, FULL_CLASS),
              (FLAG_MIXED, FULL_CLASS), (FLAG_MASKED, FULL_CLASS),
              (FLAG_INACTIVE, FULL_CLASS)] * 3 + [(FLAG_POLY, 1)])
    ops = _build(specs, 64, rolled=False, seed=12)
    base = np.random.RandomState(5).normal(
        0.0, 1.0, (C, ATLAS_ROWS, ATLAS_COLS)).astype(np.float32)
    got, ref = _run(ops, 64, ATLAS_COLS, atlas0=base)
    _assert_close(got, ref, base)


def test_spill_tier3_shape():
    """G=1 one-particle groups with size class 1 or FULL, as spill tier 3
    builds them, accumulated onto a nonzero atlas."""
    specs = ([(FLAG_ALL_TINY, 1), (FLAG_POLY, 1), (FLAG_MASKED, FULL_CLASS),
              (FLAG_POLY, FULL_CLASS), (FLAG_ALL_TINY, FULL_CLASS),
              (FLAG_INACTIVE, FULL_CLASS), (FLAG_POLY, 1),
              (FLAG_MASKED, FULL_CLASS)] * 3)
    ops = _build(specs, 1, rolled=True, seed=13)
    flags = ops[-1]
    assert set((flags // 4).tolist()) >= {0, 1, 2, 4}
    base = np.random.RandomState(6).normal(
        0.0, 1.0, (C, ATLAS_ROWS, ATLAS_COLS)).astype(np.float32)
    got, ref = _run(ops, 1, p_accum.WINDOW_COLS, atlas0=base)
    _assert_close(got, ref, base)


def test_group_flags_match_reference():
    rng = np.random.RandomState(4)
    n, G = 64, 32
    ih = np.where(rng.random_sample((n, G)) < 0.3, -1.0,
                  1.0 / rng.uniform(0.5, 16.0, (n, G))).astype(np.float32)
    ih[:8] = -1.0
    ih[8:16] = np.abs(ih[8:16]) + 0.3
    coef = rng.normal(0, 1, (n, G, C)).astype(np.float32)
    coef[::7] = 0.0
    sizes = rng.randint(0, 4, n).astype(np.int32)
    for sz in (None, sizes):
        ref = r_pallas.group_flags(jnp.asarray(ih), jnp.asarray(coef), H_MAX,
                                   sizes=None if sz is None
                                   else jnp.asarray(sz))
        got = p_accum.group_flags(torch.from_numpy(ih),
                                  torch.from_numpy(coef), H_MAX,
                                  sizes=None if sz is None
                                  else torch.from_numpy(sz))
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_wrapper_uses_plain_version_on_cpu():
    specs = [(FLAG_POLY, 0)] * 8
    ay, ax, ih, coef, w0, c0, ce, flags = _build(specs, 64, True, 3)
    t = [torch.from_numpy(a.copy()) for a in (ay, ax, ih, coef, w0, c0, ce, flags)]
    before = p_accum.launches
    kw = dict(atlas_rows=ATLAS_ROWS, atlas_cols=ATLAS_COLS, C=C, group=64,
              window_rows=WINDOW_ROWS)
    a = p_accum.accumulate_groups(*t, **kw)
    b = p_accum.accumulate_groups_plain(*t, **kw)
    assert p_accum.launches == before
    np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("rolled", [True, False])
def test_deposit_plan_matches_walk(rolled):
    """The kernel's work list (groups that deposit, sorted stably by size
    class) against a walk over the flags."""
    rng = np.random.RandomState(8)
    n = 300
    flags = (rng.randint(0, 5, n) * 4 + rng.randint(0, 4, n)).astype(np.int32)
    order, class_off = (t.numpy() for t in p_accum.deposit_plan(
        torch.from_numpy(flags), rolled))
    classes = [[] for _ in p_accum.SIZE_CLASSES]
    for g, f in enumerate(flags.tolist()):
        kind, sz = f // 4, f % 4
        if FLAG_ALL_TINY <= kind <= FLAG_MASKED and (
                sz == FULL_CLASS or (rolled and kind <= FLAG_POLY)):
            classes[sz].append(g)
    assert sorted(order.tolist()) == list(range(n))
    assert class_off.shape == (len(classes) + 1,) and class_off[0] == 0
    for k, members in enumerate(classes):
        assert order[class_off[k]:class_off[k + 1]].tolist() == members
    assert class_off[-1] == sum(map(len, classes))


def _card_case(C_, G, rolled, seed):
    """Every (kind, class) pairing (the ones that deposit nothing too), in
    runs of three groups sharing a window, every third run at an atlas
    edge."""
    specs = [s for s in ALL_SIZED + [(FLAG_MIXED, 1)] for _ in range(3)]
    window_cols = p_accum.WINDOW_COLS if rolled else ATLAS_COLS
    ops = _build(specs, G, rolled, seed, nc=C_, run=3, edges=True)
    return ops, dict(atlas_rows=ATLAS_ROWS, atlas_cols=ATLAS_COLS, C=C_,
                     group=G, window_cols=window_cols,
                     window_rows=WINDOW_ROWS)


@pytest.mark.cuda
@pytest.mark.parametrize("rolled", [True, False])
@pytest.mark.parametrize("G", [1, 64, 512, 128, 192, 384, 16, 24, 48])
@pytest.mark.parametrize("C_", [1, 2, 3, 4])
def test_kernel_matches_plain_on_card(C_, G, rolled):
    """K2 against the plain version on the card: every (kind, class)
    pairing, C = 1..4, groups of 1, 64 and 512 particles, the interactive
    column slices' main-pass widths 128, 192 and 384 and their tier-2
    widths 16, 24 and 48, rolled (256-column
    windows) and unrolled (full-width) launches, anchors clipped at the
    atlas's bottom and right edges, runs of groups sharing one window;
    accumulated onto a nonzero atlas.  Held at 1e-5 * max|atlas|."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    ops, kw = _card_case(C_, G, rolled, 21 + C_)
    t = [torch.from_numpy(np.array(a)).to(dev) for a in ops]
    base = torch.from_numpy(np.random.RandomState(7).normal(
        0.0, 1e-3, (C_, ATLAS_ROWS, ATLAS_COLS)).astype(np.float32)).to(dev)
    before = p_accum.launches
    got = p_accum.accumulate_groups_cuda(*t, atlas0=base.clone(), **kw)
    ref = p_accum.accumulate_groups_plain(*t, atlas0=base.clone(), **kw)
    torch.cuda.synchronize()
    assert p_accum.launches == before + 1
    assert (ref - base).abs().max().item() > 0.0
    assert ((got - ref).abs().max() <= 1e-5 * ref.abs().max()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("rolled", [True, False])
@pytest.mark.parametrize("n", [1, 1000, 33000])
def test_plan_kernel_matches_plain_on_card(n, rolled):
    """The plan kernel's work list equals ``deposit_plan``'s."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.RandomState(n)
    flags = torch.from_numpy((rng.randint(0, 5, n) * 4 + rng.randint(0, 4, n))
                             .astype(np.int32)).cuda()
    got = p_accum.deposit_plan_cuda(flags, rolled)
    want = p_accum.deposit_plan(flags, rolled)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _chip_smoke():
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("rolled", [True, False])
def test_k2_bound_counts_support(rolled):
    """chip_smoke.k2_work's operation counts against a walk over every
    (group, live particle, line): the bf16 product over the whole
    rectangle, the Horner chains only where the line lies inside the
    particle's support (and footprint, for MASKED groups), a select where
    the profiles are clamped, the hat for tiny particles."""
    cs = _chip_smoke()
    G = 16
    window_cols = p_accum.WINDOW_COLS if rolled else ATLAS_COLS
    ops = _build(ALL_SIZED + [(FLAG_MIXED, 1)], G, rolled, seed=31)
    ay, ax, ih, coef, w0, c0, ce, flags = ops
    kw = dict(zip(("ay_g", "ax_g", "ih_g", "coef_g", "w0", "c0", "ce",
                   "flags"), (torch.from_numpy(np.array(a)) for a in ops)),
              atlas_rows=ATLAS_ROWS, atlas_cols=ATLAS_COLS, C=C, group=G,
              window_cols=window_cols, window_rows=WINDOW_ROWS)
    _, bf16, f32 = cs.k2_work(kw)
    profile_cols = p_accum.PROFILE_COLS if rolled else ATLAS_COLS
    want_bf16 = want_f32 = clamped = 0
    for g, f in enumerate(flags.tolist()):
        kind, sz = f // 4, f % 4
        if kind == FLAG_INACTIVE or (sz != FULL_CLASS and not (
                rolled and kind <= FLAG_POLY)):
            continue
        rows_eval, cols_eval = p_accum._extents(sz, WINDOW_ROWS, profile_cols)
        rank = 1 if kind == FLAG_ALL_TINY else 2
        for i in range(G):
            if not coef[:, g, i].any():
                continue
            want_bf16 += 2 * C * rows_eval * cols_eval * rank
            for lines, base, pos in ((rows_eval, w0[g], ay[g, i]),
                                     (cols_eval, ce[g] if rolled else c0[g],
                                      ax[g, i])):
                for line in range(lines):
                    if kind == FLAG_ALL_TINY or ih[g, i] < 0:
                        want_f32 += cs.K2_OPS_PER_HAT_LINE
                        continue
                    d = np.float32(base + line) - pos
                    inside = d * d * (ih[g, i] * ih[g, i]) < p_accum.SUPPORT2
                    if kind == FLAG_MASKED:
                        inside &= -p_accum.FOOT < d <= p_accum.FOOT
                    want_f32 += (cs.K2_OPS_PER_POLY_LINE if inside
                                 else cs.K2_OPS_PER_CLAMPED_LINE)
                    clamped += not inside
    assert clamped > 0
    assert bf16 == want_bf16
    assert f32 == want_f32
