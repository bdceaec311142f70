"""The port's Visualizer over a particle mesh (``mesh=``,
``render/distributed.py``), mirroring tests/test_distributed_visualizer.py
case by case on 8 CPU shards (``make_mesh(8, devices=["cpu"] * 8)``): the
full render loop (LOD blocks, culling, quantity switching, the surface,
the depth pick, periodic tiling) over the mesh against the port on one
device, at that file's tolerances.  Also
tests/test_column_mips.py::test_distributed_mip_render_matches_export (a
mip-started CHANGE view refined to completion equals the mesh's EXPORT
image), and the port's mesh Visualizer against the reference's mesh
Visualizer on its 8 virtual CPU devices (the lazy first EXPORT of both,
the strided block path, then an EXPORT of the presorted slabs) at the
cross-engine bounds of tests/test_splat_fields.py:75-78."""

import os

import numpy as np
import pytest
import torch

import topsy_tpu_torch
from topsy_tpu_torch import config
from topsy_tpu_torch.canvas import OffscreenCanvas
from topsy_tpu_torch.drawreason import DrawReason
from topsy_tpu_torch.parallel import make_mesh
from topsy_tpu_torch.progression import RenderProgressionColumns
from topsy_tpu_torch.render import distributed

# one process's share of the cores when pytest-xdist runs several workers
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

RES = 64


def cpu_mesh(d=8):
    return make_mesh(d, devices=["cpu"] * d)


def vis_pair(n=8000, **kw):
    v1 = topsy_tpu_torch.test(n, render_resolution=RES, device="cpu",
                              canvas_class=OffscreenCanvas, **kw)
    v8 = topsy_tpu_torch.test(n, render_resolution=RES, device="cpu",
                              canvas_class=OffscreenCanvas, mesh=cpu_mesh(),
                              **kw)
    for v in (v1, v8):
        v.show_status = False
    return v1, v8


@pytest.fixture
def pair():
    """One device and the mesh on the same cell-ordered snapshot; both
    constructors rendered the lazy first EXPORT (the block path)."""
    return vis_pair(with_cells=True)


def test_distributed_matches_single_chip(pair):
    v1, v8 = pair
    assert isinstance(v8._sph, distributed.DistributedSPHRenderer)
    im1 = v1.get_sph_image()
    im8 = v8.get_sph_image()
    np.testing.assert_allclose(im8, im1, rtol=1e-3,
                               atol=1e-6 * np.abs(im1).max())


def test_distributed_quantity_switch(pair):
    v1, v8 = pair
    v1.quantity_name = "test-quantity"
    v8.quantity_name = "test-quantity"
    im1 = v1.get_sph_image()
    im8 = v8.get_sph_image()
    valid = np.isfinite(im1) & np.isfinite(im8)
    np.testing.assert_allclose(im8[valid], im1[valid], rtol=1e-2,
                               atol=2e-7)


def test_distributed_rgb_mode(pair):
    _, v8 = pair
    v8.render_mode = "rgb"
    assert isinstance(v8._sph, distributed.DistributedRGBSPHRenderer)
    pres = v8.get_sph_presentation_image()
    assert pres.shape == (RES, RES, 4)
    assert np.asarray(pres).std() > 0


def test_distributed_zoomed_culling(pair):
    """Zooming in selects a cell subset; the mesh still matches."""
    v1, v8 = pair
    for v in (v1, v8):
        v.scale = 8.0
        v.position_offset = np.array([5.0, 5.0, 0.0])
    im1 = v1.get_sph_image()
    im8 = v8.get_sph_image()
    np.testing.assert_allclose(im8, im1, rtol=1e-3,
                               atol=1e-6 * np.abs(im1).max())
    assert v8._sph.render_progression.get_fraction_volume_selected() < 1.0


def test_distributed_depth_image(pair):
    _, v8 = pair
    d = v8.get_depth_image()
    assert d.shape == (RES, RES)
    assert np.isfinite(d[RES // 2, RES // 2])
    assert isinstance(v8._sph._depth_renderer,
                      distributed.DistributedDepthSPHRenderer)


def test_distributed_surface_matches_single_chip(pair):
    """Surface mode over the mesh: per-shard K3 plain versions and the
    depth arg-max combine reproduce the single device's front-most
    image."""
    v1, v8 = pair
    v1.render_mode = "surface"
    v8.render_mode = "surface"
    assert isinstance(v8._sph, distributed.DistributedSurfaceSPHRenderer)
    im1 = v1._sph.get_image()
    im8 = v8._sph.get_image()
    assert im1.shape == im8.shape
    np.testing.assert_allclose(im8[..., -1], im1[..., -1], rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(im8[..., 0], im1[..., 0], rtol=1e-4,
                               atol=1e-6 * max(np.abs(im1[..., 0]).max(),
                                               1e-30))
    assert (im1[..., -1] > 0).mean() > 0.005
    assert (im8[..., -1] > 0).any()


def test_distributed_surface_presentation(pair):
    _, v8 = pair
    v8.render_mode = "surface"
    pres = v8.get_sph_presentation_image()
    assert pres.shape == (RES, RES, 4)
    assert np.asarray(pres).std() > 0


def test_distributed_periodic_tiling_matches_single_chip():
    """The panel renders over the mesh, the lattice composite runs on the
    combined panel."""
    v1, v8 = vis_pair(4000, periodic_tiling=True)
    assert isinstance(v8._sph, distributed.DistributedPeriodicSPHRenderer)
    im1 = v1._sph.get_output_image().numpy()
    im8 = v8._sph.get_output_image().numpy()
    assert im1.shape == im8.shape
    np.testing.assert_allclose(im8, im1, rtol=1e-3,
                               atol=1e-5 * np.abs(im1).max())
    assert im8[..., 0].sum() >= v8._sph._image.numpy()[..., 0].sum() * 0.99


def test_distributed_periodic_interactive_change_frame():
    """CHANGE and REFINE frames of the periodic mesh renderer take the
    mesh's column launches, and the completed view equals EXPORT."""
    v8 = topsy_tpu_torch.test(4000, render_resolution=RES, device="cpu",
                              canvas_class=OffscreenCanvas,
                              periodic_tiling=True, mesh=cpu_mesh())
    sph = v8._sph
    assert isinstance(sph, distributed.DistributedPeriodicSPHRenderer)
    assert (type(sph)._launch_columns
            is distributed.DistributedSPHRenderer._launch_columns)
    sph.render(DrawReason.EXPORT)
    v8.rotate(0.3, 0.0)
    sph.render(DrawReason.CHANGE)
    im = sph.get_output_image().numpy()
    assert np.isfinite(im[..., 0]).all() and im[..., 0].sum() > 0
    for _ in range(300):
        if not sph.needs_refine():
            break
        sph.render(DrawReason.REFINE)
    assert not sph.needs_refine()
    assert sph.last_render_mass_scale == pytest.approx(1.0)
    im_cols = sph.get_output_image().numpy().copy()
    sph.render(DrawReason.EXPORT)
    im_export = sph.get_output_image().numpy()
    assert im_cols[..., 0].sum() == pytest.approx(im_export[..., 0].sum(),
                                                  rel=1e-4)
    corr = np.corrcoef(im_cols[..., 0].ravel(),
                       im_export[..., 0].ravel())[0, 1]
    assert corr > 0.9999


def test_distributed_mip_render_matches_export(monkeypatch):
    """tests/test_column_mips.py::test_distributed_mip_render_matches_export:
    the mesh's column path routes mip tiers per shard; a mip-started CHANGE
    view refined to completion reproduces the mesh's EXPORT image, and its
    first frame is a fair subsample."""
    monkeypatch.setattr(config, "COLUMN_MIP_FLOOR_TARGET", 200)
    monkeypatch.setattr(config, "INITIAL_PARTICLES_TO_RENDER", 500)
    vis = topsy_tpu_torch.test(60000, render_resolution=128, device="cpu",
                               canvas_class=OffscreenCanvas,
                               mesh=cpu_mesh())
    vis.show_status = False
    sph = vis._sph
    sph.render(DrawReason.CHANGE)
    assert isinstance(sph.render_progression, RenderProgressionColumns)
    assert len(sph.render_progression._tiers) >= 2  # >= 1 mip + main
    assert sph.render_progression.last_block_tier == 0
    assert sph.last_render_mass_scale > 1.0
    im0 = (sph.get_output_image()[..., 0] * sph.last_render_mass_scale
           ).numpy().copy()
    for _ in range(300):
        if not sph.needs_refine():
            break
        sph.render(DrawReason.REFINE)
    assert not sph.needs_refine()
    assert sph.last_render_mass_scale == pytest.approx(1.0)
    im_cols = sph.get_output_image().numpy().copy()
    sph.render(DrawReason.EXPORT)
    im_export = sph.get_output_image().numpy()
    assert im_cols[..., 0].sum() == pytest.approx(im_export[..., 0].sum(),
                                                  rel=1e-4)
    corr = np.corrcoef(im_cols[..., 0].ravel(),
                       im_export[..., 0].ravel())[0, 1]
    assert corr > 0.9999
    assert im0.sum() == pytest.approx(im_export[..., 0].sum(), rel=0.05)
    assert np.corrcoef(im0.ravel(), im_export[..., 0].ravel())[0, 1] > 0.9


def test_mesh_visualizer_matches_reference_mesh():
    """The port's mesh Visualizer against the reference's on its 8 virtual
    CPU devices: the same snapshot and view; both constructors' lazy first
    EXPORT (the strided block path, the density channel), then the
    quantity's EXPORT (the presorted slabs of each package's own layout,
    both channels)."""
    import topsy_tpu
    from topsy_tpu.canvas import OffscreenCanvas as RefCanvas
    from topsy_tpu.parallel import make_mesh as ref_mesh
    ref = topsy_tpu.test(8000, render_resolution=RES, canvas_class=RefCanvas,
                         with_cells=True, mesh=ref_mesh(8))
    port = topsy_tpu_torch.test(8000, render_resolution=RES, device="cpu",
                                canvas_class=OffscreenCanvas,
                                with_cells=True, mesh=cpu_mesh())
    for v in (ref, port):
        v.show_status = False
    for step, channels in (("density", (0,)), ("quantity", (0, 1))):
        if step == "quantity":
            for v in (ref, port):
                v.quantity_name = "test-quantity"
        got = port._sph.get_image()
        want = np.asarray(ref._sph.get_image())
        assert got.shape == want.shape
        for c in channels:
            a = got[..., c].astype(np.float64)
            b = want[..., c].astype(np.float64)
            assert a.sum() == pytest.approx(b.sum(), rel=1e-3), (step, c)
            assert np.abs(a - b).max() <= 0.01 * np.abs(b).max(), (step, c)
            assert np.corrcoef(a.ravel(), b.ravel())[0, 1] > 0.9999, \
                (step, c)
