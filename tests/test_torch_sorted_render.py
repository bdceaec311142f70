"""The port's block paths in the renderers against the reference's: the
store's flat arrays, the lazy EXPORT policy (a one-shot EXPORT through the
per-frame-sorted block path, then the presort), interactive frames without
the column progression (blocks pieced by ``bucket_size``, a device barrier
after each), ``splat_backend="scatter"`` and the surface scatter fallback.

The reference runs its sorted path in its CPU engine ("scan", float32
products), the port in K2's semantics (bf16 products): images at the
cross-engine bounds of tests/test_splat_fields.py:75-78 (sum rel 1e-3, max
pixel difference <= 1% of the maximum, correlation > 0.9999) with the same
``dropped``; the scatter backends and the surface fallback at the bounds
of tests/test_torch_surface_interactive.py (coverage equal, depth rtol
1e-5 / atol 1e-4, values rtol 1e-5 / atol 1e-6).  Reference renderers are
built without a Visualizer (which would first render an EXPORT frame)."""

import os

import numpy as np
import pytest
import torch

from topsy_tpu import config as r_config
from topsy_tpu import progression as r_prog
from topsy_tpu.drawreason import DrawReason as RefReason
from topsy_tpu.loaders import TestDataLoader as RefLoader
from topsy_tpu.render import sph as r_sph
from topsy_tpu.render import store as r_store
from topsy_tpu.render import surface as r_surface

from topsy_tpu_torch import config as p_config
from topsy_tpu_torch import progression as p_prog
from topsy_tpu_torch.drawreason import DrawReason
from topsy_tpu_torch.loaders import TestDataLoader
from topsy_tpu_torch.render import sph as p_sph
from topsy_tpu_torch.render import store as p_store
from topsy_tpu_torch.render import surface as p_surface

torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

N, RES = 20000, 128


def _cross_engine(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert np.isfinite(a).all()
    for c in range(b.shape[-1]):
        assert a[..., c].sum() == pytest.approx(b[..., c].sum(), rel=1e-3)
    assert np.abs(a - b).max() <= 0.01 * np.abs(b).max()
    assert np.corrcoef(a[..., 0].ravel(), b[..., 0].ravel())[0, 1] > 0.9999


def _surface_bounds(a, b):
    cov = b[..., 1] > 0
    assert ((a[..., 1] > 0) == cov).all()
    assert cov.mean() > 0.005
    np.testing.assert_allclose(a[..., 1][cov], b[..., 1][cov], rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(a[..., 0][cov], b[..., 0][cov], rtol=1e-5,
                               atol=1e-6)


def _renderers(kind="sph", backend=None, with_cells=False):
    """(port, reference) renderers of one class over the scene's stores,
    the quantity selected, the loader's initial view."""
    out = []
    for loader_cls, store_mod, mod, dev in (
            (TestDataLoader, p_store, p_sph if kind == "sph" else p_surface,
             {"device": "cpu"}),
            (RefLoader, r_store, r_sph if kind == "sph" else r_surface, {})):
        loader = loader_cls(N, with_cells=with_cells)
        store = store_mod.ParticleStore(loader, **dev)
        store.quantity_name = "test-quantity"
        cls = (mod.SPHRenderer if kind == "sph"
               else mod.SurfaceSPHRenderer)
        sph = cls(store, loader.get_render_progression(), RES,
                  backend=backend)
        sph.position_offset = -loader.get_initial_center()
        sph.scale = loader.get_initial_view_width()
        out.append(sph)
    return out


def _layout(store):
    """The store's cached presort, None before it is built (the
    reference's property raises then)."""
    if isinstance(store, p_store.ParticleStore):
        return store.presorted_layout
    return getattr(store, "_presorted_layout", None)


def _image(sph):
    im = sph.get_image()
    return im.numpy() if isinstance(im, torch.Tensor) else np.asarray(im)


@pytest.mark.parametrize("with_cells", [False, True],
                         ids=["no_cells", "cells"])
def test_flat_store_matches_reference(with_cells):
    """The flat arrays equal the reference's store, bit for bit, built only
    when read: the presort never builds them, nor they the presort."""
    port = p_store.ParticleStore(TestDataLoader(3000, with_cells=with_cells),
                                 device="cpu")
    ref = r_store.ParticleStore(RefLoader(3000, with_cells=with_cells))
    assert port.n_pad == ref.n_pad == 4096
    port.ensure_presorted()
    port.main_tier.fields()
    assert not port._flat
    np.testing.assert_array_equal(port.flat_pos_smooth.numpy(),
                                  np.asarray(ref.pos_smooth))
    np.testing.assert_array_equal(port.flat_cell_ids.numpy(),
                                  np.asarray(ref.cell_ids))
    for name in (None, "test-quantity"):
        port.quantity_name = ref.quantity_name = name
        for buf in ("mass_and_quantity", "surface_values", "rgb"):
            np.testing.assert_array_equal(
                port.flat_values_for(buf).numpy(),
                np.asarray(ref.values_for(buf)))
        np.testing.assert_array_equal(port.surface_values.numpy(),
                                      np.asarray(ref.surface_values))
    fresh = p_store.ParticleStore(TestDataLoader(3000), device="cpu")
    fresh.flat_values_for("mass_and_quantity")
    assert fresh.presorted_layout is None


def test_bucket_size_rules():
    """tests/test_store.py:14's cases, and the reference's bucket for every
    block length of a range."""
    bs = p_store.bucket_size
    assert bs(1, 10**9) == p_store.MIN_BUCKET
    assert bs(p_store.MIN_BUCKET, 10**9) == p_store.MIN_BUCKET
    assert bs(p_store.MIN_BUCKET + 1, 10**9) == 2 * p_store.MIN_BUCKET
    assert bs(10**9, 10**9) == p_store.MAX_BUCKET
    assert bs(10**9, 5000) == 5000
    for n in (1, 4095, 4097, 70000, 1 << 22, (1 << 22) + 1, 3 << 22):
        for n_max in (5000, 1 << 20, 10**9):
            assert bs(n, n_max) == r_store.bucket_size(n, n_max)


def test_export_policy_matches_reference():
    """A one-shot EXPORT renders the flat arrays through the sorted block
    path and builds no presort; the next EXPORT presorts (the port through
    the feed kernel's plain version, the reference through its
    interpreted feed kernel), as ``_use_presorted`` decides in both."""
    port, ref = _renderers()
    ref._force_feed = True
    for sph in (port, ref):
        assert not sph._use_presorted()
        sph.render(DrawReason.EXPORT if sph is port else RefReason.EXPORT)
        assert _layout(sph._store) is None
        assert sph._use_presorted()
    _cross_engine(_image(port), _image(ref))
    assert port.last_dropped_splats == ref.last_dropped_splats
    sorted_image = _image(port)
    for sph in (port, ref):
        sph.invalidate()
        sph.render(DrawReason.EXPORT if sph is port else RefReason.EXPORT)
        assert _layout(sph._store) is not None
    _cross_engine(_image(port), _image(ref))
    _cross_engine(sorted_image, _image(port))


def _fixed_blocks(sph, size):
    """Install on ``sph`` a progression (of its own package) whose
    interactive frames each render one block of ``size`` particles: the
    time-budgeted recommendation would follow each package's host clock."""
    ours = isinstance(sph, p_sph.SPHRenderer)
    base = (p_prog if ours else r_prog).RenderProgression
    export = DrawReason.EXPORT if ours else RefReason.EXPORT

    class Fixed(base):
        def get_block(self, t):
            if self._reason == export:
                return super().get_block(t)
            if not self._first_block or self._start_index >= self._total:
                return None
            self._first_block = False
            self._last_block_len = min(size, self._total - self._start_index)
            return self._block_for_logical_range(self._start_index,
                                                 self._last_block_len)

    sph._render_progression = Fixed(N)


def test_block_frames_match_reference(monkeypatch):
    """Without the column progression a CHANGE frame and its REFINE frames
    render blocks of the flat arrays, each in bucket pieces (4,096 rows
    here) with a barrier after each piece, and the frame's time is
    recorded; each frame's image, mass scale and drops are the
    reference's, and the completed image is EXPORT's."""
    for cfg in (p_config, r_config):
        monkeypatch.setattr(cfg, "INTERACTIVE_USE_PRESORTED", False)
    for mod in (p_store, r_store):
        monkeypatch.setattr(mod, "MAX_BUCKET", 4096)
    port, ref = _renderers()
    for sph in (port, ref):
        _fixed_blocks(sph, 8000)
    frames = 0
    for reason, rreason in ((DrawReason.CHANGE, RefReason.CHANGE),
                            (DrawReason.REFINE, RefReason.REFINE),
                            (DrawReason.REFINE, RefReason.REFINE)):
        port.render(reason)
        ref.render(rreason)
        frames += 1
        assert port.last_render_mass_scale == pytest.approx(
            ref.last_render_mass_scale)
        assert port._render_timer.last_duration > 0.0
        assert not port.last_column_ranges
        _cross_engine(_image(port), _image(ref))
        assert port.last_dropped_splats == ref.last_dropped_splats
    assert frames == 3 and not port.needs_refine()
    assert port.last_render_mass_scale == 1.0
    done = _image(port)
    port.invalidate()
    port.render(DrawReason.EXPORT)
    assert port._store.presorted_layout is None
    a, b = done[..., 0].astype(np.float64), _image(port)[..., 0]
    assert a.sum() == pytest.approx(b.sum(), rel=1e-4)
    assert np.corrcoef(a.ravel(), b.ravel())[0, 1] > 0.9999


def test_scatter_backend_matches_reference():
    """``splat_backend="scatter"``: every frame renders blocks through
    ``splat_scatter``, EXPORT and CHANGE alike (no presort, no columns)."""
    port, ref = _renderers(backend="scatter")
    for reason, rreason in ((DrawReason.EXPORT, RefReason.EXPORT),
                            (DrawReason.CHANGE, RefReason.CHANGE)):
        port.invalidate()
        ref.invalidate()
        port.render(reason)
        ref.render(rreason)
        assert port._store.presorted_layout is None
        assert not isinstance(port.render_progression,
                              p_prog.RenderProgressionColumns)
        a, b = _image(port), _image(ref)
        np.testing.assert_allclose(a, b, rtol=1e-4,
                                   atol=1e-5 * np.abs(b).max())
        assert port.last_dropped_splats == 0


def test_scatter_backend_repeated_exports_never_presort():
    """``_use_presorted`` is False for every EXPORT of the scatter backend:
    repeated exports keep rendering blocks through ``splat_scatter``, as
    the reference's do."""
    port, ref = _renderers(backend="scatter")
    first = None
    for _ in range(2):
        for sph in (port, ref):
            sph.invalidate()
            sph.render(DrawReason.EXPORT if sph is port else RefReason.EXPORT)
            assert not sph._use_presorted()
            assert _layout(sph._store) is None
        first = _image(port) if first is None else first
        np.testing.assert_array_equal(_image(port), first)
        np.testing.assert_allclose(_image(port), _image(ref), rtol=1e-4,
                                   atol=1e-5 * np.abs(first).max())


def test_surface_fallback_matches_reference(monkeypatch):
    """Without the column progression the surface renders the flat arrays
    through ``zsplat_scatter`` in bucket pieces, max-composited, with the
    truncated giants: the reference's ``_render_block_surface``."""
    for cfg in (p_config, r_config):
        monkeypatch.setattr(cfg, "INTERACTIVE_USE_PRESORTED", False)
    for mod in (p_store, r_store):
        monkeypatch.setattr(mod, "MAX_BUCKET", 8192)
    port, ref = _renderers("surface", with_cells=True)
    port.render(DrawReason.EXPORT)
    ref.render(RefReason.EXPORT)
    assert port._store.presorted_layout is None
    assert port._giant_image is None
    _surface_bounds(_image(port), _image(ref))
    port.scale = ref.scale = 0.5 * port.scale
    port.render(DrawReason.CHANGE)
    ref.render(RefReason.CHANGE)
    assert port.last_render_mass_scale == ref.last_render_mass_scale == 1.0
    assert port.needs_refine() == ref.needs_refine()
    _surface_bounds(_image(port), _image(ref))

