"""The port's decimation-mip tiers (``ops/morton_device.build_mip_layout``,
``render/store.ensure_column_mips``, tier selection in ``render/sph.py``
and ``render/surface.py``) against the reference's, mirroring
tests/test_column_mips.py on its 60,000-particle scene at 128^2 with
``COLUMN_MIP_FLOOR_TARGET`` = 1500 (two mip tiers and the main layout).

A mip tier holds exactly the particles of its parent's first
min_slice_width columns.  With one and the same layout in both packages
(the reference's, carried across with ``convert.device_layout_from_
reference``), each partial frame of a mip-started view equals the
reference's: the univariate image at the cross-engine bounds of
tests/test_splat_fields.py:75-78 (sum rel 1e-3, largest pixel difference
<= 1% of the maximum, correlation > 0.9999) with the same ``dropped``, the
surface image at the EXPORT bounds of tests/test_torch_surface.py
(coverage equal, depth rtol 1e-5 / atol 1e-4, values rtol 1e-5 / atol
1e-6), the same column ranges, tiers and mass scales.  The port alone: a
mip-started view refined to completion matches its EXPORT image, and its
first frame is a fair subsample (tests/test_column_mips.py:165-170)."""

import os
from unittest import mock

import numpy as np
import pytest
import torch

from topsy_tpu import config as r_config
from topsy_tpu.drawreason import DrawReason as RefReason
from topsy_tpu.loaders import TestDataLoader as RefLoader
from topsy_tpu.ops import morton_device as r_md

import topsy_tpu_torch
from topsy_tpu_torch import config, convert
from topsy_tpu_torch.drawreason import DrawReason
from topsy_tpu_torch.loaders import TestDataLoader
from topsy_tpu_torch.ops import morton, morton_device
from topsy_tpu_torch.progression import RenderProgressionColumns
from topsy_tpu_torch.render.store import ParticleStore

# one process's share of the cores when pytest-xdist runs several workers
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

N, RES = 60000, 128
FLOOR_TARGET = 1500


@pytest.fixture(scope="module")
def snap():
    return TestDataLoader(N, seed=1337).get_pos_smooth().astype(np.float32)


@pytest.fixture(scope="module")
def parent(snap):
    layout = morton_device.build_presorted_device(torch.from_numpy(snap))
    assert layout is not None
    return layout


def _real_sources(layout, n):
    g = np.asarray(layout.gidx)
    return np.sort(g[g < n])


def _buckets_per_particle(layout):
    """The bucket of each of the N particles in ``layout`` (-1 if absent)."""
    g = np.asarray(layout.gidx)
    real = g < N
    out = np.full(N, -1, np.int32)
    out[g[real]] = np.asarray(layout.buckets)[real]
    return out


def test_mip_layout_is_exact_parent_prefix(snap, parent):
    """The mip holds exactly the particles of the parent's first
    min_slice_width columns, each once, with their own buckets."""
    mip = morton_device.build_mip_layout(parent, torch.from_numpy(snap))
    assert mip is not None
    n = parent.n_real
    w = morton.min_slice_width(parent)
    ng = parent.n_out // parent.pad_group
    expected = parent.gidx.numpy().reshape(ng, parent.pad_group)[:, :w]
    expected = np.sort(expected[expected < n])
    np.testing.assert_array_equal(_real_sources(mip, n), expected)
    assert mip.n_real == n  # composed to the ORIGINAL arrays
    assert int(mip.real_per_column.sum()) == len(expected)
    gidx = mip.gidx.numpy()
    real = gidx < n
    buckets = mip.buckets.numpy()
    np.testing.assert_array_equal(buckets[real],
                                  morton.smoothing_buckets(snap[gidx[real],
                                                                3]))
    assert np.all(np.diff(buckets[real]) >= 0)


def test_mip_matches_reference_on_one_parent(snap):
    """On the reference's parent layout carried across, the port's mip
    holds the reference's mip's particles, with its n_out, run quantum,
    real_per_column and buckets."""
    ref_parent = r_md.build_presorted_device(snap)
    ref_mip = r_md.build_mip_layout(ref_parent, snap)
    mip = morton_device.build_mip_layout(
        convert.device_layout_from_reference(ref_parent, "cpu"),
        torch.from_numpy(snap))
    assert (mip.n_out, mip.run_quantum) == (ref_mip.n_out,
                                           ref_mip.run_quantum)
    np.testing.assert_array_equal(mip.real_per_column,
                                  ref_mip.real_per_column)
    np.testing.assert_array_equal(_real_sources(mip, N),
                                  _real_sources(ref_mip, N))
    np.testing.assert_array_equal(_buckets_per_particle(mip),
                                  _buckets_per_particle(ref_mip))


def test_store_builds_mip_chain(monkeypatch):
    """ensure_column_mips chains tiers until the interactive floor is below
    COLUMN_MIP_FLOOR_TARGET, each tier the prefix of its parent; small
    snapshots build none."""
    monkeypatch.setattr(config, "COLUMN_MIP_FLOOR_TARGET", FLOOR_TARGET)
    store = ParticleStore(TestDataLoader(N, seed=1337), device="cpu")
    tiers = store.ensure_column_mips()
    assert len(tiers) == config.COLUMN_MIP_MAX_TIERS
    layouts = [t.layout for t in tiers] + [store.presorted_layout]
    for child, parent_l in zip(layouts[:-1], layouts[1:]):
        w = morton.min_slice_width(parent_l)
        assert int(child.real_per_column.sum()) == \
            int(parent_l.real_per_column[:w].sum())
    store2 = ParticleStore(TestDataLoader(4000, seed=1), device="cpu")
    monkeypatch.setattr(config, "COLUMN_MIP_FLOOR_TARGET", 1 << 21)
    assert store2.ensure_column_mips() == []


def test_tiered_progression_exact_coverage(monkeypatch):
    """Walking the tiered progression to completion renders every particle
    exactly once (mips first, then parent columns above each floor)."""
    monkeypatch.setattr(config, "COLUMN_MIP_FLOOR_TARGET", FLOOR_TARGET)
    store = ParticleStore(TestDataLoader(N, seed=1337), device="cpu")
    mips = store.ensure_column_mips()
    main = store.presorted_layout
    prog = RenderProgressionColumns(
        main.real_per_column, col_quantum=morton.min_slice_width(main),
        mip_tiers=[(m.layout.real_per_column,
                    morton.min_slice_width(m.layout)) for m in mips],
        initial_particles=700)
    assert prog._total == N
    layouts = [m.layout for m in mips] + [main]
    counts = np.zeros(N, dtype=np.int64)
    tiers_seen = set()
    prog.start_frame(DrawReason.CHANGE)
    for _ in range(300):
        block = prog.get_block(0.0)
        if block is None:
            if not prog.needs_refine():
                break
            prog.end_frame_get_scalefactor()
            prog.start_frame(DrawReason.REFINE)
            continue
        (c0,), (nc,) = block
        ti = prog.last_block_tier
        tiers_seen.add(ti)
        lay = layouts[ti]
        gidx = lay.gidx.numpy().reshape(-1, lay.pad_group)
        got = gidx[:, c0:c0 + nc].ravel()
        got = got[got < N]
        np.add.at(counts, got, 1)
        assert prog._last_block_len == len(got)
        prog.end_block(0.005)
    assert tiers_seen == set(range(len(layouts)))
    assert prog.end_frame_get_scalefactor() == 1.0
    assert (counts == 1).all()


def _port_vis(mode="univariate"):
    v = topsy_tpu_torch.test(N, render_resolution=RES, device="cpu")
    v.show_status = False
    v.show_colorbar = False
    v.render_mode = mode
    v.quantity_name = "test-quantity"
    return v


def test_interactive_mip_render_matches_export(monkeypatch):
    """A CHANGE frame starting in the deepest mip tier, refined to
    completion, reproduces the EXPORT image (sum rel 1e-4, correlation >
    0.9999), and the first partial frame is a fair subsample under the
    exact photometric scale (sum rel 0.05, correlation > 0.9)."""
    monkeypatch.setattr(config, "COLUMN_MIP_FLOOR_TARGET", FLOOR_TARGET)
    monkeypatch.setattr(config, "INITIAL_PARTICLES_TO_RENDER", 500)
    sph = _port_vis()._sph
    sph.render(DrawReason.CHANGE)
    prog = sph.render_progression
    assert isinstance(prog, RenderProgressionColumns)
    assert len(prog._tiers) == config.COLUMN_MIP_MAX_TIERS + 1
    assert prog.last_block_tier == 0
    scale0 = sph.last_render_mass_scale
    assert scale0 > 1.0
    im0 = sph.get_output_image()[..., 0].numpy() * scale0
    tiers = [0]
    for _ in range(300):
        if not sph.needs_refine():
            break
        sph.render(DrawReason.REFINE)
        tiers.append(prog.last_block_tier)
    assert tiers == [0, 1, 2]
    assert sph.last_render_mass_scale == pytest.approx(1.0)
    im_cols = sph.get_output_image().numpy().copy()
    sph.render(DrawReason.EXPORT)
    im_export = sph.get_output_image().numpy()
    assert im_cols[..., 0].sum() == pytest.approx(im_export[..., 0].sum(),
                                                  rel=1e-4)
    assert np.corrcoef(im_cols[..., 0].ravel(),
                       im_export[..., 0].ravel())[0, 1] > 0.9999
    assert im0.sum() == pytest.approx(im_export[..., 0].sum(), rel=0.05)
    assert np.corrcoef(im0.ravel(), im_export[..., 0].ravel())[0, 1] > 0.9


@pytest.fixture(scope="module")
def ref_store():
    """The reference's store over the scene, its device presort and mip
    chain built with the reduced floor target."""
    from topsy_tpu.render.store import ParticleStore as RefStore
    with mock.patch.object(r_config, "COLUMN_MIP_FLOOR_TARGET",
                           FLOOR_TARGET):
        store = RefStore(RefLoader(N))
        store.quantity_name = "test-quantity"
        assert len(store.ensure_column_mips()) == 2
    return store


def _port_on_reference_layout(ref_store, mode):
    """The port's Visualizer whose store builds exactly the reference's
    layout and mip chain (carried across)."""
    main = convert.device_layout_from_reference(ref_store.presorted_layout,
                                                "cpu")
    mips = [convert.device_layout_from_reference(t.layout, "cpu")
            for t in ref_store.ensure_column_mips()][::-1]
    chain = {id(p): c for p, c in zip([main] + mips, mips)}
    with mock.patch.object(morton_device, "build_presorted_device",
                           lambda *a, **k: main), \
            mock.patch.object(morton_device, "build_mip_layout",
                              lambda layout, *a, **k: chain[id(layout)]):
        v = _port_vis(mode)
        assert len(v.store.ensure_column_mips()) == 2
    return v


def _ref_renderer(ref_store, mode):
    from topsy_tpu.render.sph import SPHRenderer
    from topsy_tpu.render.surface import SurfaceSPHRenderer
    cls = SurfaceSPHRenderer if mode == "surface" else SPHRenderer
    r = cls(ref_store, ref_store._loader.get_render_progression(), RES)
    r.position_offset = -ref_store._loader.get_initial_center()
    return r


def _same_image(mode, a, b):
    if mode == "surface":
        cov = b[..., 1] > 0
        assert ((a[..., 1] > 0) == cov).all()
        assert cov.mean() > 0.005
        np.testing.assert_allclose(a[..., 1][cov], b[..., 1][cov],
                                   rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(a[..., 0][cov], b[..., 0][cov],
                                   rtol=1e-5, atol=1e-6)
        return
    assert np.isfinite(a).all()
    for c in range(b.shape[-1]):
        assert a[..., c].sum() == pytest.approx(b[..., c].sum(), rel=1e-3)
    assert np.abs(a - b).max() <= 0.01 * np.abs(b).max()
    assert np.corrcoef(a[..., 0].ravel(), b[..., 0].ravel())[0, 1] > 0.9999


@pytest.mark.parametrize("mode", ["univariate", "surface"])
def test_partial_frames_match_reference(ref_store, mode, monkeypatch):
    """Through one layout, the first (mip-tier) CHANGE frame and each
    REFINE frame of a view equal the reference's: images, dropped counts,
    column ranges, tiers, mass scales and refine requests."""
    for cfg in (config, r_config):
        monkeypatch.setattr(cfg, "COLUMN_MIP_FLOOR_TARGET", FLOOR_TARGET)
        monkeypatch.setattr(cfg, "INITIAL_PARTICLES_TO_RENDER", 500)
    port = _port_on_reference_layout(ref_store, mode)._sph
    ref = _ref_renderer(ref_store, mode)
    frames = []
    for rp, rr in [(DrawReason.CHANGE, RefReason.CHANGE)] + \
            [(DrawReason.REFINE, RefReason.REFINE)] * 2:
        port.render(rp)
        ref.render(rr)
        tier = port.render_progression.last_block_tier
        assert tier == ref.render_progression.last_block_tier
        frames.append((tier, list(port.last_column_ranges)))
        _same_image(mode, port.get_image(), np.asarray(ref.get_image()))
        assert port.last_dropped_splats == int(ref._dropped_splats)
        assert port.last_render_mass_scale == ref.last_render_mass_scale
        assert port.needs_refine() == ref.needs_refine()
    assert frames == [(0, [(0, 512)]), (1, [(128, 384)]), (2, [(128, 384)])]
    assert not port.needs_refine()


def test_depth_pick_renders_its_tier(ref_store, monkeypatch):
    """The depth pick renders the tier its copied progression picks (the
    deepest mip on a fresh view), as the reference's does, and the picked
    depth equals the reference's through one layout (NaN where no mass,
    within 1e-3 of the view depth on the pixels holding 1e-3 of the
    densest pixel's mass)."""
    for cfg in (config, r_config):
        monkeypatch.setattr(cfg, "COLUMN_MIP_FLOOR_TARGET", FLOOR_TARGET)
        monkeypatch.setattr(cfg, "INITIAL_PARTICLES_TO_RENDER", 500)
    port = _port_on_reference_layout(ref_store, "univariate")._sph
    ref = _ref_renderer(ref_store, "univariate")
    port.render(DrawReason.CHANGE)
    ref.render(RefReason.CHANGE)
    d_p = port.get_depth_image()
    d_r = ref.get_depth_image()
    dr = port._get_depth_renderer()
    assert dr.render_progression.last_block_tier == 0
    assert dr.last_column_ranges == [(0, 512)]
    assert dr.render_progression.last_block_tier == \
        ref._get_depth_renderer().render_progression.last_block_tier
    np.testing.assert_array_equal(np.isnan(d_p), np.isnan(d_r))
    mass = dr.get_image()[..., 0]
    dense = mass > 1e-3 * mass.max()
    assert dense.mean() > 0.01
    assert np.abs(d_p - d_r)[dense].max() <= 1e-3 * 2 * port.scale
