"""The renderers' keyword surface is the reference's: every renderer class
takes ``wrapping=`` and ``share_render_progression=`` (the periodic
renderers wrap by default), has the ``resolution`` property, and builds
its depth renderer through the shared progression.  The signatures are
held against the reference's classes; the depth pick through the shared
progression is held equal, bit for bit, to the pick of a depth renderer
given a copy of the progression directly, as the port built it before."""

import copy
import inspect

import numpy as np
import pytest
import torch

from topsy_tpu.render import distributed as r_distributed
from topsy_tpu.render import periodic as r_periodic
from topsy_tpu.render import sph as r_sph
from topsy_tpu.render import surface as r_surface

from topsy_tpu_torch.camera import x_rotation_matrix, y_rotation_matrix
from topsy_tpu_torch.drawreason import DrawReason
from topsy_tpu_torch.loaders import TestDataLoader
from topsy_tpu_torch.parallel import make_mesh
from topsy_tpu_torch.render import distributed, periodic, sph, surface
from topsy_tpu_torch.render.store import ParticleStore

RES = 64

CLASSES = {
    "SPHRenderer": (sph, r_sph, False),
    "RGBSPHRenderer": (sph, r_sph, False),
    "DepthSPHRenderer": (sph, r_sph, False),
    "SurfaceSPHRenderer": (surface, r_surface, False),
    "PeriodicSPHRenderer": (periodic, r_periodic, False),
    "DistributedSPHRenderer": (distributed, r_distributed, True),
    "DistributedSurfaceSPHRenderer": (distributed, r_distributed, True),
    "DistributedPeriodicSPHRenderer": (distributed, r_distributed, True),
}


@pytest.fixture(scope="module")
def scene():
    loader = TestDataLoader(5000, seed=11)
    return loader, ParticleStore(loader, device="cpu")


def _view(r):
    r.rotation_matrix = x_rotation_matrix(0.4) @ y_rotation_matrix(-0.3)
    r.position_offset = np.array([1.0, -2.0, 0.5])
    r.scale = 25.0


def _signature(cls):
    return [(p.name, p.kind, p.default)
            for p in inspect.signature(cls.__init__).parameters.values()]


@pytest.mark.parametrize("name", sorted(CLASSES))
def test_constructor_signature_matches_reference(name):
    port, ref, _ = CLASSES[name]
    assert _signature(getattr(port, name)) == _signature(getattr(ref, name))


@pytest.mark.parametrize("name", sorted(CLASSES))
def test_keywords_reach_the_renderer(scene, name):
    loader, store = scene
    port, _, meshed = CLASSES[name]
    cls = getattr(port, name)
    args = (store, None, RES)
    if meshed:
        args += (make_mesh(2, devices=["cpu"] * 2),)
    if "Periodic" in name:
        args += (100.0,)
    prog = loader.get_render_progression()
    params = inspect.signature(cls.__init__).parameters
    kw = {} if "Periodic" in name else {"wrapping": True}
    if "share_render_progression" in params:
        r = cls(*args, share_render_progression=prog, **kw)
    else:     # the mesh's periodic renderer, as the reference's
        r = cls(args[0], prog, *args[2:], **kw)
    assert r.render_progression is prog
    assert r.resolution == RES
    assert r._wrapping is True
    if "Periodic" in name:
        assert r._periodicity_scale == 100.0 and r._display_image is None
    if meshed:
        assert r._mesh is args[3]
    plain = cls(store, loader.get_render_progression(), *args[2:])
    assert plain._wrapping is ("Periodic" in name)


def _pick(r, reason):
    image = r.get_image()
    with np.errstate(invalid="ignore", divide="ignore"):
        return (image[..., -1] / image[..., 0] - 0.5) * r.scale * 2.0


@pytest.mark.parametrize("reason", [DrawReason.CHANGE, DrawReason.EXPORT])
def test_depth_pick_through_shared_progression(scene, reason):
    """``get_depth_image`` (a DepthSPHRenderer over a copy of the owner's
    progression, passed as ``share_render_progression``) equals the pick
    of a DepthSPHRenderer given that copy as its own progression; the
    depth renderer inherits the owner's wrapping."""
    loader, store = scene
    threads = torch.get_num_threads()
    torch.set_num_threads(1)      # the plain deposit's sums in one order
    try:
        owner = sph.SPHRenderer(store, loader.get_render_progression(), RES)
        _view(owner)
        owner.render(DrawReason.EXPORT)
        pick = owner.get_depth_image(reason)
        assert owner._depth_renderer._wrapping is False
        assert owner._depth_renderer.render_progression is not \
            owner.render_progression
        before = sph.DepthSPHRenderer(
            store, copy.copy(owner.render_progression), RES)
        _view(before)
        before.render(reason)
        np.testing.assert_array_equal(pick, _pick(before, reason))
    finally:
        torch.set_num_threads(threads)
    assert np.isfinite(pick).any()
