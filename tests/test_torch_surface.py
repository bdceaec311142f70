"""The surface slice: topsy_tpu_torch.test(...) switched to the surface
(z-buffered) render mode, EXPORT frames, against topsy_tpu.test(...)
switched the same way (its column path through the interpreted Pallas
kernel).

Tolerances: the raw (value, depth) image at the reference's cross-path
bounds (tests/test_zsplat_atlas.py:59-65: coverage equal, depth rtol 1e-5
/ atol 1e-4, winner values rtol 1e-5 / atol 1e-6); equal
``last_dropped_splats``; the uint8 presentation images differ by at most 2
levels at 99.9% of pixels (as tests/test_torch_visualizer.py)."""

import os

import numpy as np
import pytest
import torch

import topsy_tpu
import topsy_tpu_torch
from topsy_tpu_torch.canvas import OffscreenCanvas
from topsy_tpu_torch.drawreason import DrawReason
from topsy_tpu_torch.progression import RenderProgressionColumns

# one process's share of the cores when pytest-xdist runs several workers
# (torch's default, every core in each process, oversubscribes them)
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

N, RES = 20000, 96


def _surface(v):
    v.show_status = False
    v.render_mode = "surface"
    v.quantity_name = "test-quantity"
    return v


@pytest.fixture(scope="module")
def port():
    return _surface(topsy_tpu_torch.test(N, render_resolution=RES,
                                         canvas_class=OffscreenCanvas,
                                         device="cpu"))


@pytest.fixture(scope="module")
def ref():
    from topsy_tpu.canvas import OffscreenCanvas as RefCanvas
    return _surface(topsy_tpu.test(N, render_resolution=RES,
                                   canvas_class=RefCanvas))


def test_raw_image_and_dropped_match_reference(port, ref):
    from topsy_tpu.drawreason import DrawReason as RefReason
    ref._sph.render(RefReason.EXPORT)
    port._sph.render(DrawReason.EXPORT)
    a, b = port._sph.get_image(), np.asarray(ref._sph.get_image())
    assert a.shape == b.shape == (RES, RES, 2)
    cov = b[..., 1] > 0
    assert ((a[..., 1] > 0) == cov).all()
    assert cov.mean() > 0.005
    np.testing.assert_allclose(a[..., 1][cov], b[..., 1][cov], rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(a[..., 0][cov], b[..., 0][cov], rtol=1e-5,
                               atol=1e-6)
    assert port._sph.last_dropped_splats == ref._sph.last_dropped_splats
    assert isinstance(port._sph._render_progression, RenderProgressionColumns)
    assert port._sph.last_render_mass_scale == 1.0


def test_presentation_matches_reference(port, ref):
    a = port.get_sph_presentation_image()
    b = np.asarray(ref.get_sph_presentation_image())
    assert a.shape == b.shape == (RES, RES, 4) and a.dtype == b.dtype
    d = np.abs(a.astype(int) - b.astype(int)).max(axis=-1)
    assert np.mean(d <= 2) >= 0.999
    assert a[..., :3].std() > 0
    content = port.get_sph_image()
    assert content.shape == (RES, RES, 2) and np.isfinite(content).all()


def test_narrow_column_launch_matches_scatter(monkeypatch):
    """A small snapshot leaves the tail columns of the presort empty, so the
    EXPORT block is narrower than a group (the column-slice path, groups of
    the slice width); its image must match the port's scatter-max truth
    over the same presorted arrays and cut, with the giant layer folded in,
    at the same bounds."""
    from topsy_tpu_torch.ops import splat, zsplat
    from topsy_tpu_torch.ops.splat_giant import BUCKET_DISABLED, GIANT_H
    from topsy_tpu_torch.render import surface

    v = topsy_tpu_torch.test(2000, render_resolution=64, device="cpu",
                             render_mode="surface",
                             canvas_class=OffscreenCanvas)
    v.quantity_name = "test-quantity"
    sph, store = v._sph, v.store
    widths = []
    orig = surface._render_block_columns_surface

    def spy(*args, **kw):
        widths.append(kw["width"])
        return orig(*args, **kw)

    monkeypatch.setattr(surface, "_render_block_columns_surface", spy)
    sph.invalidate()
    got = sph.get_image()
    assert widths and widths[0] < store.presorted_layout.pad_group
    ps, bks = store.pos_smooth_presorted, store.presorted_buckets
    scale = np.float32(sph.scale)
    matrix = sph._matrix().astype(np.float32)
    lev = splat.levels_from_buckets(bks, 64 / (2.0 * scale),
                                    splat.default_pyramid(64).num_levels)
    mask = None
    if sph._giant_bucket != BUCKET_DISABLED:
        h_px = splat.project(ps, matrix, 64, scale)[3]
        mask = ~((h_px * splat.exp2_int(-lev) > GIANT_H)
                 & (bks >= sph._giant_bucket))
    truth = zsplat.zsplat_scatter(
        ps, store.presorted_values_for("surface_values"), matrix, 64, scale,
        density_cut=np.float32(sph._density_cut_value()), extra_mask=mask,
        level_override=lev)
    if sph._giant_image is not None:
        truth = surface._max_composite(truth, sph._giant_image)
    truth = truth.numpy()
    cov = truth[..., 1] > 0
    assert cov.sum() > 20
    assert ((got[..., 1] > 0) == cov).all()
    np.testing.assert_allclose(got[..., 1][cov], truth[..., 1][cov],
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got[..., 0][cov], truth[..., 0][cov],
                               rtol=1e-5, atol=1e-6)


def test_density_cut_and_modes(port):
    sph = port._sph
    assert sph.get_density_cut_percentile_range() == (0.0, 100.0)
    assert sph.get_density_cut_percentile() == 50.0
    before = sph.get_image()
    sph.set_density_cut_percentile(90.0)
    sph.invalidate()
    after = sph.get_image()
    assert (after[..., 1] > 0).sum() < (before[..., 1] > 0).sum()
    sph.set_density_cut_percentile(50.0)
    sph.invalidate()
    sph.render(DrawReason.CHANGE)
    assert sph.last_column_ranges and not sph.needs_refine()
    assert (sph.get_image()[..., 1] > 0).any()
    frame = port.draw(DrawReason.EXPORT, target=(120, 96))
    assert frame.shape == (96, 120, 4) and frame.dtype == np.uint8
    port.render_mode = "bivariate"
    frame = port.draw(DrawReason.EXPORT, target=(120, 96))
    assert frame.shape == (96, 120, 4) and frame[..., :3].std() > 0
    port.render_mode = "surface"
