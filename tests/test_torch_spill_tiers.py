"""The spill tiers' operands (``ops/splat_atlas.py`` ``spill_tiers``): on a
CPU tensor the plain version, on a CUDA tensor the kernel
(``csrc/spill_tiers.cu``).

CPU: the kernel's selection rule (a histogram of the counts finds the k-th
largest, then a scan in index order takes every group above it and the
first ties, a chunk of groups per warp) and its tier-3 order rule (a scan
of the stragglers, a chunk of slots per warp) are emulated here, chunk by
chunk, and held against the plain version's sorts; CPU tensors
take the plain version and launch nothing; the ctypes structure mirrors
the kernel's; the outputs' layout is aligned and disjoint.  The card
(``cuda``, skipped without one): the kernel against the plain version on
the same device tensors, bit for bit in every tier operand (inactive
entries included) and in ``dropped``, at the EXPORT pieces' shapes, the
column launches' widths and budgets, C = 1 to 4 and the edge cases; and
``splat_atlas_fields``' image and dropped count through the kernel and
through the plain chain.
"""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from topsy_tpu_torch.ops import splat_accum, splat_atlas
from topsy_tpu_torch.ops.splat import H_MAX, default_pyramid
from topsy_tpu_torch.performance import counters

THREADS = 1024    # SCAN_THREADS in csrc/spill_tiers.cu
WARPS = THREADS // 32


# ---------------------------------------------------------------------------
# the kernel's rules, emulated chunk by chunk
# ---------------------------------------------------------------------------

def _exclusive(values):
    return np.concatenate([[0], np.cumsum(values)[:-1]]).astype(np.int64)


def _chunks(n, parts, quantum=1):
    """[start, end) of each part's contiguous chunk of n items, its length
    a multiple of ``quantum``: a thread's (1) or a warp's (32)."""
    size = -(-n // (parts * quantum)) * quantum
    return [(min(t * size, n), min(t * size + size, n))
            for t in range(parts)]


def _select_like_kernel(counts: np.ndarray, k: int, G: int) -> np.ndarray:
    """``select_kernel``'s gathered groups: the bins' scan a chunk of bins
    a thread, the index-order scan a chunk of groups a warp (the lanes of a
    round in index order, ranked by ballots)."""
    c = np.clip(counts, 0, G)
    hist = np.bincount(c, minlength=G + 1)
    rev = hist[::-1]                                   # rev[r]: bin G - r
    spans = _chunks(G + 1, THREADS)
    here = np.array([rev[a:b].sum() for a, b in spans])
    above = _exclusive(here)
    (crossing,) = np.nonzero((above < k) & (above + here >= k))
    assert len(crossing) == 1
    a, b = spans[crossing[0]]
    cum = above[crossing[0]]
    for r in range(a, b):
        if cum + rev[r] >= k:
            t, need = G - r, k - cum
            break
        cum += rev[r]
    spans = _chunks(len(c), WARPS, 32)
    ties = np.array([(c[a:b] == t).sum() for a, b in spans])
    over = np.array([(c[a:b] > t).sum() for a, b in spans])
    tie = _exclusive(ties)
    pos = _exclusive(over + np.clip(need - tie, 0, ties))
    out = np.full(k, -1)
    for (a, b), tie_t, pos_t in zip(spans, tie, pos):
        for i in range(a, b):
            keep = c[i] > t
            if c[i] == t:
                keep = tie_t < need
                tie_t += 1
            if keep:
                out[pos_t] = i
                pos_t += 1
    assert (out >= 0).all()
    return out


def _tier3_like_kernel(straggler: np.ndarray, T3: int) -> np.ndarray:
    """``tier3_kernel``'s gathered slot at each tier-3 entry (the scan a
    chunk of slots a warp)."""
    cap = len(straggler)
    spans = _chunks(cap, WARPS, 32)
    strag = np.array([straggler[a:b].sum() for a, b in spans])
    before, n3 = _exclusive(strag), int(strag.sum())
    out = np.full(T3, -1)
    for (a, b), sb in zip(spans, before):
        seen = 0
        for q in range(a, b):
            pos = sb + seen if straggler[q] else n3 + (q - sb - seen)
            seen += int(straggler[q])
            if pos < T3:
                assert out[pos] == -1
                out[pos] = q
    assert (out >= 0).all()
    return out


def _counts(kind: str, n: int, G: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "zero":
        return np.zeros(n, np.int64)
    if kind == "equal":
        return np.full(n, 7)
    if kind == "few":
        c = np.zeros(n, np.int64)
        few = min(5, n - 1)
        c[rng.choice(n, size=few, replace=False)] = rng.integers(1, G + 1,
                                                                 few)
        return c
    if kind == "full":
        return rng.choice([0, G], size=n)
    # heavy ties: a few levels, most groups at 0
    return rng.choice([0, 0, 0, 1, 2, 3, G // 2, G], size=n)


@pytest.mark.parametrize("kind", ["ties", "zero", "equal", "few", "full"])
@pytest.mark.parametrize("n,G,k", [
    (32768, 512, 128), (832, 512, 128), (32768, 64, 512), (32768, 256, 512),
    (1000, 128, 1000), (5000, 512, 1), (64, 16, 64), (3, 8, 2)])
def test_selection_rule_matches_topk_then_sort(kind, n, G, k):
    """The histogram threshold and the index-order scan gather exactly
    ``torch.sort(_topk_desc_stable(counts, k)).values``: ties at the
    threshold, all-zero counts, k = n_groups and fewer spilling groups
    than k among the cases."""
    counts = _counts(kind, n, G, seed=n + k)
    want = torch.sort(splat_atlas._topk_desc_stable(
        torch.from_numpy(counts), k)).values.numpy()
    np.testing.assert_array_equal(_select_like_kernel(counts, k, G), want)


@pytest.mark.parametrize("share", [0.0, 0.001, 0.02, 0.5, 1.0])
@pytest.mark.parametrize("cap,T3", [(65536, 1024), (131072, 4096),
                                    (2048, 2048), (1000, 1024 // 2)])
def test_tier3_order_rule_matches_sort(share, cap, T3):
    """The straggler scan places the first T3 stragglers in gathered order,
    then non-stragglers, as the plain version's sort does: none, fewer
    than T3, more than T3 and all of the slots straggling."""
    rng = np.random.default_rng(cap + T3)
    straggler = rng.random(cap) < share
    ar = torch.arange(cap)
    st = torch.from_numpy(straggler)
    want = torch.sort(torch.where(st, ar, ar + cap)).indices[:T3].numpy()
    np.testing.assert_array_equal(_tier3_like_kernel(straggler, T3), want)


# ---------------------------------------------------------------------------
# a feed piece's spill operands
# ---------------------------------------------------------------------------

RES = 1024


def _piece(n_groups, G, C, *, seed, device, kind="mixed", window_rows=96):
    """(args, kwargs) of a ``spill_tiers`` call over a synthetic feed
    piece: per-group spill rates on a few levels (heavy ties), rows
    spread about a group centre (stragglers), some groups at the atlas
    bottom (clipped anchors), tiny, polynomial and masked (h > H_MAX)
    smoothing, and coefficients zero where a slot did not spill, -0.0 in
    channel 0 of some spilled slots."""
    _, atlas_rows, atlas_cols = splat_atlas.atlas_layout(default_pyramid(RES))
    g = torch.Generator(device=device).manual_seed(seed)

    def rand(*shape):
        return torch.rand(shape, generator=g, device=device)

    rates = torch.tensor([0.0, 0.0, 0.004, 0.03, 0.2, 1.0], device=device)
    if kind == "none":
        rates = torch.zeros(1, device=device)
    elif kind == "few":
        rates = torch.tensor([0.0] * 200 + [0.5], device=device)
    elif kind == "ties":
        rates = torch.tensor([0.0, 1.0], device=device)
    rate = rates[(rand(n_groups) * len(rates)).long().clamp(max=len(rates)
                                                            - 1)]
    spilled = rand(n_groups, G) < rate[:, None]
    spread = 4.0 if kind != "stragglers" else 400.0
    centre = rand(n_groups, 1) * atlas_rows
    if kind == "bottom":
        centre = atlas_rows - 12.0 * rand(n_groups, 1)
    else:
        bottom = rand(n_groups, 1) < 0.02
        centre = torch.where(bottom, atlas_rows - 12.0 * rand(n_groups, 1),
                             centre)
    ay = centre + spread * (2.0 * rand(n_groups, G) - 1.0)
    ax = rand(n_groups, G) * atlas_cols
    h = 0.3 + rand(n_groups, G) * 2.0 * H_MAX
    ih = torch.where(rand(n_groups, G) < 0.3, -1.0, 1.0 / h)
    if kind == "nan":
        ih = torch.where(rand(n_groups, G) < 0.001, torch.nan, ih)
    coef = torch.where(spilled, 2.0 * rand(C, n_groups, G) - 1.0, 0.0)
    if C > 1:
        coef[0] = torch.where(spilled & (rand(n_groups, G) < 0.05), -0.0,
                              coef[0])
    counts = spilled.sum(dim=1, dtype=torch.int32)
    coef = coef.reshape(C, -1)
    args = (ay.reshape(-1), ax.reshape(-1), ih.reshape(-1), coef, counts)
    kw = dict(C=C, G=G, atlas_rows=atlas_rows, atlas_cols=atlas_cols,
              window_rows=window_rows)
    return args, kw


def _bits(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _assert_same(got, want):
    """Every entry of two tiers' keyword dicts equal, floats bit for bit."""
    assert got.keys() == want.keys()
    for key, w in want.items():
        g = got[key]
        if not isinstance(w, torch.Tensor):
            assert g == w, key
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, key
        assert torch.equal(_bits(g), _bits(w)), key


def test_cpu_tensors_take_the_plain_version():
    args, kw = _piece(64, 128, 2, seed=3, device="cpu")
    before = counters["spill_launches"]
    tier2, tier3, dropped = splat_atlas.spill_tiers(*args, **kw)
    assert counters["spill_launches"] == before
    w2, w3, wd = splat_atlas.spill_tiers_plain(*args, **kw)
    _assert_same(tier2, w2)
    _assert_same(tier3, w3)
    assert dropped.dtype == torch.int64 and dropped.dim() == 0
    assert torch.equal(dropped, wd)


def test_scalars_mirror_the_kernel_struct():
    """The wrapper's ctypes structure names the fields of
    ``csrc/spill_tiers.cu``'s SpillScalars in order, with their C types."""
    src = (Path(splat_atlas.__file__).resolve().parent.parent / "csrc"
           / "spill_tiers.cu").read_text()
    body = re.search(r"struct SpillScalars \{(.*?)\};", src, re.S).group(1)
    want = []
    for line in body.splitlines():
        decl = line.split("//")[0].strip().rstrip(";")
        if decl:
            ctype, names = re.match(r"(long long|float|int)\s+(.*)",
                                    decl).groups()
            want += [(n.strip(), ctype) for n in names.split(",")]
    ctypes_of = {"long long": ctypes.c_longlong, "float": ctypes.c_float,
                 "int": ctypes.c_int}
    got = splat_atlas._SpillScalars._fields_
    assert [(n, ctypes_of[c]) for n, c in want] == list(got)


@pytest.mark.parametrize("n_groups,G,C,caps", [
    (32768, 512, 2, (None, None)), (832, 512, 3, (None, None)),
    (32768, 64, 2, (512, 4096)), (32768, 128, 1, (512, 4096)),
    (32768, 256, 4, (512, 4096)), (16, 189, 2, (None, None))])
def test_output_layout_is_aligned_and_disjoint(n_groups, G, C, caps):
    """The kernel's outputs: tier 2's (3 + C) rows, then tier 3's, in the
    float buffer; tier 2's w0, zeros and flags, tier 3's four rows, the
    gathered groups, a byte a gathered slot and tier 3's slots in the
    int32 one; each
    block 16-byte aligned, none overlapping, the buffers just large
    enough; the budgets those of the plain version."""
    _, atlas_rows, atlas_cols = splat_atlas.atlas_layout(default_pyramid(RES))
    G_SPILL, k, T3 = splat_atlas._spill_budgets(n_groups, G, *caps)
    if k > n_groups or (k * G) % G_SPILL:
        with pytest.raises(ValueError):
            splat_atlas._spill_plan(n_groups, G, C, atlas_rows, atlas_cols,
                                    96, G_SPILL, k, T3)
        return
    s, n_f, n_i = splat_atlas._spill_plan(n_groups, G, C, atlas_rows,
                                          atlas_cols, 96, G_SPILL, k, T3)
    cap = k * G
    assert (s.g_spill, s.k_groups, s.t3, s.n_sg) == (G_SPILL, k, T3,
                                                     cap // G_SPILL)
    f_blocks = [(0, (3 + C) * cap), (s.f_t3, (3 + C) * T3)]
    i_blocks = [(0, 3 * s.n_sg), (s.i_t3, 4 * T3), (s.i_gidx, k),
                (s.i_slots, -(-cap // 4)), (s.i_order, T3)]
    for blocks, total in ((f_blocks, n_f), (i_blocks, n_i)):
        for (a, la), (b, _) in zip(blocks, blocks[1:]):
            assert a % 4 == 0 and a + la <= b
        assert blocks[-1][0] % 4 == 0 and sum(blocks[-1]) == total


def test_plan_refuses_what_the_kernel_does_not_take():
    _, atlas_rows, atlas_cols = splat_atlas.atlas_layout(default_pyramid(RES))
    for n_groups, G, C in ((64, splat_atlas.SPILL_KERNEL_MAX_G * 2, 2),
                           (4096, 512, 5), (1, 64, 2)):
        with pytest.raises(ValueError):
            splat_atlas._spill_plan(n_groups, G, C, atlas_rows, atlas_cols,
                                    96, *splat_atlas._spill_budgets(
                                        n_groups, G, None, None))


def _shapes(tiers):
    return [{k: tuple(v.shape) for k, v in t.items()
             if isinstance(v, torch.Tensor)} for t in tiers]


def test_kernel_budgets_follow_the_settings(monkeypatch):
    """The wrapper resolves tier 2's and tier 3's budgets from
    ``config.SPLAT_SPILL_GROUP_CAP`` and ``T3_CAP`` on every call, as the
    plain version does, and not once per shape: the kernel's launch is
    replaced by a stub that records its scalars (the operands' device
    check too, so that CPU tensors reach it), and the outputs' shapes
    follow the plain version's after the settings change."""
    launched = []

    def stub(scalars, *pointers):
        launched.append(scalars._obj)
        return 0

    monkeypatch.setattr(splat_atlas, "_bind_spill", lambda: stub)
    monkeypatch.setattr(splat_accum, "_check", lambda *a: None)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 0, raising=False)
    args, kw = _piece(4096, 512, 2, seed=5, device="cpu")
    for group_cap, t3_cap in ((None, None), (8, 256), (32, 100)):
        if group_cap is not None:
            monkeypatch.setattr(splat_atlas.config, "SPLAT_SPILL_GROUP_CAP",
                                group_cap)
            monkeypatch.setattr(splat_atlas, "T3_CAP", t3_cap)
        got = splat_atlas.spill_tiers_cuda(*args, **kw)
        want = splat_atlas.spill_tiers_plain(*args, **kw)
        s = launched[-1]
        assert (s.g_spill, s.k_groups, s.t3) == splat_atlas._spill_budgets(
            4096, 512, None, None)
        assert _shapes(got[:2]) == _shapes(want[:2])
    assert len({(s.k_groups, s.t3) for s in launched}) == 3


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def _both(args, kw):
    before = counters["spill_launches"]
    got = splat_atlas.spill_tiers(*args, **kw)
    assert counters["spill_launches"] == before + 1
    want = splat_atlas.spill_tiers_plain(*args, **kw)
    torch.cuda.synchronize()
    return got, want


CASES = {
    # the EXPORT frame's two feed pieces at 2^24 (17,203,200 slots)
    "export_piece0": (32768, 512, 2, "mixed", {}),
    "export_piece1": (832, 512, 2, "mixed", {}),
    # column launches: widths below 512, the raised budgets
    **{f"column{w}": (32768, w, 2, "mixed",
                      dict(group_cap=splat_atlas.COLUMN_SPILL_GROUP_CAP,
                           t3_cap=splat_atlas.COLUMN_T3_CAP))
       for w in (64, 128, 256)},
    **{f"C{c}": (4096, 512, c, "mixed", {}) for c in (1, 3, 4)},
    "nothing_spilled": (4096, 512, 2, "none", {}),
    "fewer_than_k": (4096, 512, 2, "few", {}),
    "ties": (4096, 512, 2, "ties", {}),
    "more_stragglers_than_t3": (4096, 512, 2, "stragglers", {}),
    "clipped_at_bottom": (4096, 512, 2, "bottom", {}),
    "nan_ih": (4096, 512, 2, "nan", {}),
    # the flat path's 64-row windows
    "flat_windows": (4096, 512, 2, "mixed", dict(window_rows=64)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_matches_plain_on_card(case):
    _card()
    n_groups, G, C, kind, extra = CASES[case]
    extra = dict(extra)
    window_rows = extra.pop("window_rows", 96)
    args, kw = _piece(n_groups, G, C, seed=22, device="cuda", kind=kind,
                      window_rows=window_rows)
    (t2, t3, dropped), (w2, w3, wd) = _both(args, dict(kw, **extra))
    _assert_same(t2, w2)
    _assert_same(t3, w3)
    assert dropped.dtype == torch.int64 and dropped.dim() == 0
    assert torch.equal(dropped, wd)
    # the case exercises what it names
    if kind == "none":
        assert int(wd) == 0 and not (w2["flags"] // 4).any()
    if kind == "stragglers":
        assert int((w3["flags"] // 4 > 0).sum()) == w3["w0"].shape[0]
        assert int(wd) > 0
    if kind == "bottom":
        kind3, size3 = w3["flags"] // 4, w3["flags"] % 4
        sized = ((kind3 == splat_accum.FLAG_ALL_TINY)
                 | (kind3 == splat_accum.FLAG_POLY))
        assert bool((sized & (size3 == splat_accum.FULL_CLASS)).any())


@pytest.mark.cuda
def test_kernel_follows_changed_budget_settings_on_card(monkeypatch):
    """The settings' budgets changed after the kernel ran at a shape: the
    next call at that shape takes the new ones, bit-equal to the plain
    version, which reads them live."""
    _card()
    args, kw = _piece(4096, 512, 2, seed=9, device="cuda")
    _both(args, kw)
    monkeypatch.setattr(splat_atlas.config, "SPLAT_SPILL_GROUP_CAP", 8)
    monkeypatch.setattr(splat_atlas, "T3_CAP", 256)
    (t2, t3, dropped), (w2, w3, wd) = _both(args, kw)
    _assert_same(t2, w2)
    _assert_same(t3, w3)
    assert torch.equal(dropped, wd) and int(wd) > 0


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take():
    _card()
    args, kw = _piece(64, 128, 2, seed=1, device="cuda")
    with pytest.raises(TypeError):
        splat_atlas.spill_tiers(*args[:4], args[4].long(), **kw)
    strided = torch.empty(2 * args[0].numel(), device="cuda")[::2]
    with pytest.raises(ValueError):
        splat_atlas.spill_tiers(strided, *args[1:], **kw)
    with pytest.raises(ValueError):
        splat_atlas.spill_tiers(*args[:3], args[3].t().contiguous().t(),
                                args[4], **kw)
    with pytest.raises(ValueError):
        splat_atlas.spill_tiers(*args, **dict(kw, C=5))


@pytest.fixture(scope="module")
def store():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from topsy_tpu_torch.loaders import TestDataLoader
    from topsy_tpu_torch.render.store import ParticleStore
    st = ParticleStore(TestDataLoader(1 << 18, seed=22), device="cuda")
    st.ensure_presorted()
    return st


@pytest.mark.cuda
@pytest.mark.parametrize("scale", [8.0, 60.0, 400.0])
@pytest.mark.parametrize("depth_channel", [False, True])
def test_fields_image_and_dropped_match_the_plain_chain(store, monkeypatch,
                                                        scale, depth_channel):
    """``splat_atlas_fields`` through the kernel and through the plain
    chain (the wrapper's kernel call replaced by ``spill_tiers_plain`` in
    this test): the same image and dropped count, bit for bit.  K2's
    float4 atomics add in no fixed order, so both runs deposit with K2's
    plain version, whose sums are ordered."""
    from topsy_tpu_torch import camera
    tier = store.main_tier
    fields = tier.fields()
    values = tier.values_cm_for("mass_and_quantity")
    matrix = camera.world_to_clip_matrix(np.eye(3), np.zeros(3), scale)
    monkeypatch.setattr(splat_accum, "accumulate_groups",
                        splat_accum.accumulate_groups_plain)

    def render():
        return splat_atlas.splat_atlas_fields(
            fields, values, matrix, 512, np.float32(scale),
            tier.group_buckets, depth_channel=depth_channel, giants="none")

    before = counters["spill_launches"]
    image, dropped = render()
    assert counters["spill_launches"] == before + 1
    monkeypatch.setattr(splat_atlas, "spill_tiers_cuda",
                        splat_atlas.spill_tiers_plain)
    want_image, want_dropped = render()
    torch.cuda.synchronize()
    assert torch.equal(_bits(image), _bits(want_image))
    assert torch.equal(dropped, want_dropped)
