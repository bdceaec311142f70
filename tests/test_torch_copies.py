"""The port keeps pinned copies of the reference's jax-free modules (it
imports nothing of topsy_tpu); each copy must equal the original: the
restated config constants, the world-to-clip matrix, the draw reasons, the
kernel tables, the synthetic snapshot (bit for bit, with and without
cells), the array loader with given smoothing lengths, the native kNN
smoothing, the host presort, the progressions' block sequences, the cell
layout and the scalebar units.  Exact equality throughout: the copies run
the same numpy code."""

import numpy as np
import pytest

from topsy_tpu import camera as r_camera
from topsy_tpu import config as r_config
from topsy_tpu import drawreason as r_dr
from topsy_tpu import loaders as r_loaders
from topsy_tpu import native as r_native
from topsy_tpu import progression as r_prog
from topsy_tpu import units as r_units
from topsy_tpu.ops import kernels as r_kernels
from topsy_tpu.ops import morton as r_morton

from topsy_tpu_torch import camera as p_camera
from topsy_tpu_torch import config as p_config
from topsy_tpu_torch import drawreason as p_dr
from topsy_tpu_torch import loaders as p_loaders
from topsy_tpu_torch import native as p_native
from topsy_tpu_torch import progression as p_prog
from topsy_tpu_torch import units as p_units
from topsy_tpu_torch.ops import kernels as p_kernels
from topsy_tpu_torch.ops import morton as p_morton

N = 50_000


@pytest.fixture(scope="module")
def loaders():
    return {cells: (r_loaders.TestDataLoader(N, with_cells=cells),
                    p_loaders.TestDataLoader(N, with_cells=cells))
            for cells in (False, True)}


@pytest.fixture(scope="module")
def layouts(loaders):
    ref, port = loaders[False]
    ps = ref.get_pos_smooth().astype(np.float32)
    return r_morton.build_presorted(ps), p_morton.build_presorted(ps)


def _config():
    names = [n for n in vars(p_config) if n.isupper()]
    assert len(names) > 20
    assert {"COLUMN_MIP_FLOOR_TARGET", "COLUMN_MIP_MAX_TIERS",
            "INTERACTIVE_USE_PRESORTED"} <= set(names)
    for n in names:
        assert getattr(p_config, n) == getattr(r_config, n), n


def _camera():
    rng = np.random.RandomState(0)
    for _ in range(3):
        q, _r = np.linalg.qr(rng.normal(size=(3, 3)))
        off = rng.normal(0, 10, 3)
        s = rng.uniform(1, 300)
        np.testing.assert_array_equal(
            p_camera.world_to_clip_matrix(q, off, s),
            r_camera.world_to_clip_matrix(q, off, s))
        angle = rng.uniform(-np.pi, np.pi)
        for name in ("x_rotation_matrix", "y_rotation_matrix"):
            np.testing.assert_array_equal(getattr(p_camera, name)(angle),
                                          getattr(r_camera, name)(angle))


def _drawreason():
    assert ([(m.name, m.value) for m in p_dr.DrawReason]
            == [(m.name, m.value) for m in r_dr.DrawReason])


def _kernels():
    for args in ((), (6, 12)):
        a, b = p_kernels.lowrank_kernel(*args), r_kernels.lowrank_kernel(*args)
        np.testing.assert_array_equal(a.coeffs, b.coeffs)
        np.testing.assert_array_equal(a.signs, b.signs)
        assert p_kernels.lowrank_integral(*args) == \
            r_kernels.lowrank_integral(*args)
    np.testing.assert_array_equal(p_kernels.radial_edge_poly(),
                                  r_kernels.radial_edge_poly())
    for mode in ("exact", "lowrank"):
        for a, b in zip(p_kernels.norm_table(mode), r_kernels.norm_table(mode)):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(p_kernels.radial_table(), r_kernels.radial_table()):
        np.testing.assert_array_equal(a, b)
    assert p_kernels.KERNEL_SUPPORT == r_kernels.KERNEL_SUPPORT


def _loader(loaders, cells):
    ref, port = loaders[cells]
    assert len(ref) == len(port) == N
    for get in ("get_positions", "get_smooth", "get_mass", "get_rgb_masses",
                "get_pos_smooth", "get_cell_ids"):
        a, b = getattr(port, get)(), getattr(ref, get)()
        if b is None:
            assert a is None
            continue
        assert a.dtype == b.dtype, get
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(port.get_named_quantity("test-quantity"),
                                  ref.get_named_quantity("test-quantity"))
    assert port.get_initial_view_width() == ref.get_initial_view_width()


def _presort(layouts):
    ref, port = layouts
    for f in ("order", "dst", "buckets", "real_per_column"):
        np.testing.assert_array_equal(getattr(port, f), getattr(ref, f))
    for f in ("n_out", "pad_group", "run_quantum", "n_real"):
        assert getattr(port, f) == getattr(ref, f)
    assert p_morton.min_slice_width(port) == r_morton.min_slice_width(ref)
    assert p_morton.slice_widths(port) == r_morton.slice_widths(ref)
    assert p_morton.DELTA_OCTAVE == r_morton.DELTA_OCTAVE
    assert p_morton.PAD_POS == r_morton.PAD_POS


def _blocks(prog, reason, dr, n_max=64):
    prog.start_frame(reason)
    out = []
    while len(out) < n_max and (b := prog.get_block(0.0)) is not None:
        out.append((b, getattr(prog, "last_block_tier", None)))
        prog.end_block(0.0)
    scale = prog.end_frame_get_scalefactor()
    return out, scale


def _progressions(loaders, layouts, monkeypatch):
    for cfg in (r_config, p_config):
        monkeypatch.setattr(cfg, "MAX_PARTICLES_PER_EXPORT_RENDERCALL", 7000)
    ref_l, port_l = loaders[True]
    cases = [
        (lambda m: m.RenderProgression(10 ** 5), None),
        (lambda m, l: m.RenderProgressionWithCells(
            l.get_cell_layout(), N), "cells"),
        (lambda m, l: m.RenderProgressionColumns(
            layouts[0].real_per_column, col_quantum=r_morton.min_slice_width(
                layouts[0])), "columns"),
    ]
    for make, kind in cases:
        for reason_name in ("EXPORT", "CHANGE"):
            seqs = []
            for m, dr, loader in ((r_prog, r_dr, ref_l), (p_prog, p_dr, port_l)):
                prog = make(m) if kind is None else make(m, loader)
                prog.select_sphere(np.zeros(3), 30.0)
                seqs.append(_blocks(prog, getattr(dr.DrawReason, reason_name),
                                    dr))
            (a, sa), (b, sb) = seqs
            assert len(a) >= 1
            if reason_name == "EXPORT" and kind is not None:
                assert len(a) >= 2, kind
            assert repr(a) == repr(b), (kind, reason_name)
            assert sa == sb


def _cells(loaders):
    ref, port = loaders[True]
    a, b = port.get_cell_layout(), ref.get_cell_layout()
    assert a.get_num_cells() == b.get_num_cells()
    for c in (0, 17, a.get_num_cells() - 1):
        assert a.cell_slice(c) == b.cell_slice(c)
    np.testing.assert_array_equal(a.cells_in_sphere([1.0, 2.0, 3.0], 20.0),
                                  b.cells_in_sphere([1.0, 2.0, 3.0], 20.0))
    np.testing.assert_array_equal(a.interleave_order(), b.interleave_order())


def _array_loader():
    """Given smoothing lengths: nothing is computed, every array equal (the
    within-cell shuffle draws from numpy's global generator, seeded alike
    for both)."""
    ref_l = r_loaders.TestDataLoader(N)
    args = (ref_l.get_positions(),)
    kw = dict(mass=ref_l.get_mass(), smooth=ref_l.get_smooth(),
              quantities={"q": ref_l.get_named_quantity("test-quantity")})
    np.random.seed(3)
    ref = r_loaders.ArrayDataLoader(*args, **kw)
    np.random.seed(3)
    port = p_loaders.ArrayDataLoader(*args, device="cpu", **kw)
    for get in ("get_positions", "get_smooth", "get_mass", "get_pos_smooth",
                "get_cell_ids"):
        a, b = getattr(port, get)(), getattr(ref, get)()
        assert a.dtype == b.dtype, get
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(port.get_named_quantity("q"),
                                  ref.get_named_quantity("q"))


def _native_knn():
    pos = r_loaders.TestDataLoader(20_000).get_positions()
    a, b = p_native.knn_smooth(pos, 32), r_native.knn_smooth(pos, 32)
    if b is None:
        assert a is None
        return
    np.testing.assert_array_equal(a, b)


def _units():
    for u in ("km", "au", "pc", "kpc", "Mpc", "3.085678e+19 m"):
        assert p_units.unit_in_units(u, "kpc") == r_units.unit_in_units(u,
                                                                         "kpc")


CASES = ["config", "camera", "drawreason", "kernels", "loader",
         "loader_cells", "array_loader", "native_knn", "presort",
         "progressions", "cells", "units"]


@pytest.mark.parametrize("name", CASES)
def test_copy_matches_reference(name, loaders, layouts, monkeypatch):
    {"config": _config,
     "camera": _camera,
     "drawreason": _drawreason,
     "kernels": _kernels,
     "loader": lambda: _loader(loaders, False),
     "loader_cells": lambda: _loader(loaders, True),
     "array_loader": _array_loader,
     "native_knn": _native_knn,
     "presort": lambda: _presort(layouts),
     "progressions": lambda: _progressions(loaders, layouts, monkeypatch),
     "cells": lambda: _cells(loaders),
     "units": _units}[name]()
