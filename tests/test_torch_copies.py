"""The port keeps pinned copies of the reference's jax-free modules (it
imports nothing of topsy_tpu); each copy must equal the original: the
restated config constants, the world-to-clip matrix, the draw reasons, the
kernel tables, the synthetic snapshot (bit for bit, with and without
cells), the array loader with given smoothing lengths, the native kNN
smoothing, the host presort, the progressions' block sequences, the cell
layout, the scalebar units, the recorder's interpolators, the view
synchroniser, the float16 TIFF writer (byte for byte) and reader, the line
overlays' clip points and strokes, and the colormap controllers' layout
specs; and, case by case, the helpers the reference's own tests exercise
(``Camera``, ``clip_to_pixel``, ``kernel_image``, ``norm_value``,
``native.available``, ``util.is_inside_ipython``), each under the
reference test's property as well.  Exact equality throughout: the copies
run the same numpy code.
The one stated difference is the controllers' colormap list: the
original offers every matplotlib colormap, the port those it can sample
(``color.maps.colormap_names``)."""

import types

import numpy as np
import pytest

from topsy_tpu import camera as r_camera
from topsy_tpu import config as r_config
from topsy_tpu import drawreason as r_dr
from topsy_tpu import loaders as r_loaders
from topsy_tpu import native as r_native
from topsy_tpu import progression as r_prog
from topsy_tpu import hdr_tiff as r_hdr_tiff
from topsy_tpu import units as r_units
from topsy_tpu import util as r_util
from topsy_tpu import view_synchronizer as r_sync
from topsy_tpu.color import ui as r_ui
from topsy_tpu.overlays import line as r_line
from topsy_tpu.recorder import interpolator as r_interp
from topsy_tpu.ops import kernels as r_kernels
from topsy_tpu.ops import morton as r_morton

from topsy_tpu_torch import camera as p_camera
from topsy_tpu_torch import config as p_config
from topsy_tpu_torch import drawreason as p_dr
from topsy_tpu_torch import loaders as p_loaders
from topsy_tpu_torch import native as p_native
from topsy_tpu_torch import progression as p_prog
from topsy_tpu_torch import hdr_tiff as p_hdr_tiff
from topsy_tpu_torch import units as p_units
from topsy_tpu_torch import util as p_util
from topsy_tpu_torch import view_synchronizer as p_sync
from topsy_tpu_torch.color import maps as p_maps
from topsy_tpu_torch.color import ui as p_ui
from topsy_tpu_torch.overlays import line as p_line
from topsy_tpu_torch.recorder import interpolator as p_interp
from topsy_tpu_torch.ops import kernels as p_kernels
from topsy_tpu_torch.ops import morton as p_morton

# the reference's native kNN, loaded before any comparison (see the module)
from reference_native import reference_native_loaded  # noqa: E402,F401

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
    from topsy_tpu.visualizer import VisualizerBase as RefBase
    from topsy_tpu_torch.visualizer import VisualizerBase
    assert (VisualizerBase.colorbar_aspect_ratio
            == RefBase.colorbar_aspect_ratio == r_config.COLORBAR_ASPECT_RATIO)


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


def _rotation(seed):
    q, _ = np.linalg.qr(np.random.RandomState(seed).normal(size=(3, 3)))
    return q * np.sign(np.linalg.det(q))


def _interpolators():
    """Every sampler of both packages over the same streams, sampled on the
    same frame clock, gives the same values (or both no value)."""
    rng = np.random.RandomState(4)
    times = np.cumsum(rng.uniform(0.05, 0.4, 8))
    times[0] = 0.0
    streams = {
        "scalar": [(t, float(v)) for t, v in zip(times, rng.normal(size=8))],
        "vector": [(t, v) for t, v in zip(times, rng.normal(size=(8, 3)))],
        "rotation": [(t, _rotation(i)) for i, t in enumerate(times)],
        "step": [(t, s) for t, s in zip(times, "aabbbcdd")],
        "single": [(0.0, 2.5)],
    }
    cases = [("LinearInterpolator", "scalar"), ("LinearInterpolator", "vector"),
             ("RotationInterpolator", "rotation"),
             ("SmoothedLinearInterpolator", "scalar"),
             ("SmoothedLinearInterpolator", "vector"),
             ("SmoothedLinearInterpolator", "single"),
             ("SmoothedRotationInterpolator", "rotation"),
             ("StepInterpolator", "step"), ("StepInterpolator", "scalar"),
             ("SmoothedStepInterpolator", "scalar"),
             ("SmoothedStepInterpolator", "single")]
    clock = np.arange(0.0, times[-1] + 0.5, 1 / 30)
    for cls, stream in cases:
        ref = getattr(r_interp, cls)(streams[stream])
        port = getattr(p_interp, cls)(streams[stream])
        for t in clock:
            a, b = port(t), ref(t)
            if b is r_interp.Interpolator.no_value:
                assert a is p_interp.Interpolator.no_value, (cls, stream, t)
            else:
                np.testing.assert_array_equal(a, b, err_msg=f"{cls} {t}")
    sample = r_interp.LinearInterpolator(streams["vector"])
    for a, b in zip(p_interp.gaussian_smooth(sample, times[-1], 0.25, 30),
                    r_interp.gaussian_smooth(sample, times[-1], 0.25, 30)):
        assert a[0] == b[0]
        np.testing.assert_array_equal(a[1], b[1])


class _Target:
    """A view of tests/test_synchronizer.py: counts its attribute sets."""

    def __init__(self):
        object.__setattr__(self, "set_count", 0)
        object.__setattr__(self, "rotation_matrix", np.eye(3))
        object.__setattr__(self, "scale", 1.0)
        object.__setattr__(self, "position_offset", np.zeros(3))
        object.__setattr__(self, "table", {"k": 0.0})

    def __setattr__(self, key, value):
        object.__setattr__(self, "set_count", self.set_count + 1)
        object.__setattr__(self, key, value)


def _synchronizer():
    """The same script of updates, echoes, completions and removals on
    three views of each package leaves the same states and set counts."""
    def run(m):
        views = [_Target() for _ in range(3)]
        vs = m.ViewSynchronizer(synchronize=["rotation_matrix", "scale",
                                             "position_offset", "table[k]"])
        for v in views:
            vs.add_view(v)
        a, b, c = views
        a.scale, a.rotation_matrix = 5.0, _rotation(1)
        a.table["k"] = 3.0
        vs.perpetuate_update(a)
        vs.perpetuate_update(b)                 # an echo: dropped
        vs.update_completed(c)
        c.position_offset = np.arange(3.0)
        vs.perpetuate_update(c)
        vs.remove_view(b)
        a.scale = 9.0
        vs.perpetuate_update(a)
        paths = ("scale", "position_offset", "table[k]", "rotation_matrix")
        return [(v.set_count, [m._resolve_path_get(v, p) for p in paths])
                for v in views]
    for (na, va), (nb, vb) in zip(run(p_sync), run(r_sync)):
        assert na == nb
        for x, y in zip(va, vb):
            np.testing.assert_array_equal(x, y)


def _hdr_tiff(tmp_path):
    """Byte-identical files; each package reads the other's."""
    rng = np.random.RandomState(0)
    for shape in ((5, 7, 3), (4, 6), (3, 2, 4)):
        im = rng.random_sample(shape).astype(np.float16)
        pa, pb = tmp_path / "port.tif", tmp_path / "ref.tif"
        p_hdr_tiff.imwrite(str(pa), im)
        r_hdr_tiff.imwrite(str(pb), im)
        assert pa.read_bytes() == pb.read_bytes(), shape
        np.testing.assert_array_equal(p_hdr_tiff.imread(str(pb)), im)
        np.testing.assert_array_equal(r_hdr_tiff.imread(str(pa)), im)


def _lines():
    """The crosshairs' and the periodic box's clip points and strokes."""
    rng = np.random.RandomState(2)
    for i in range(3):
        view = types.SimpleNamespace(
            rotation_matrix=_rotation(i), position_offset=rng.normal(0, 20, 3),
            scale=rng.uniform(40, 200), periodicity_scale=100.0)
        base = rng.random_sample((60, 80, 4)).astype(np.float32)
        out = []
        for m in (p_line, r_line):
            cross = m.Line(view, [(-1, 0, 0, 0), (1, 0, 0, 0), (200, 200, 0, 0),
                                  (0, 1, 0, 0), (0, -1, 0, 0)],
                           (1, 1, 1, 0.3), 10.0)
            cube = m.SimCube(view, (1, 1, 1, 0.3), 10.0)
            img = base.copy()
            cross.composite(img)
            cube.composite(img)
            out.append((cross.get_clipspace_points(),
                        cube.get_clipspace_points(), img))
        for a, b in zip(*out):
            np.testing.assert_array_equal(a, b)
        assert not np.array_equal(out[0][2], base)
    view.periodicity_scale = None
    assert len(p_line.SimCube(view).get_clipspace_points()) == 0


class _ControllerView:
    """What the colormap controllers read of a visualizer."""

    _params = {"colormap_name": "viridis", "vmin": -1.0, "vmax": 2.0,
               "log": True, "ui_range_log": (-3.0, 3.0),
               "ui_range_linear": (0.0, 5.0), "density_vmin": 0.1,
               "density_vmax": 0.9, "ui_range_density": (0.0, 1.0),
               "min_mag": 20.0, "max_mag": 30.0, "gamma": 1.5,
               "smoothing_scale": 0.01, "light_color": (1.0, 0.5, 0.25),
               "ambient_color": (0.1, 0.2, 0.3)}

    def __init__(self, render_mode, quantity_name):
        self.render_mode = render_mode
        self.quantity_name = quantity_name
        self.colormap = types.SimpleNamespace(
            get_parameters=lambda: dict(self._params),
            get_parameter=self._params.get)
        self.data_loader = types.SimpleNamespace(
            get_quantity_names=lambda: ["temp", "Rho", "metals"])
        self._sph = types.SimpleNamespace(
            get_density_cut_percentile_range=lambda: (0.0, 99.5),
            get_density_cut_percentile=lambda: 50.0)


def _spec_tree(spec, port):
    """A layout spec as nested tuples; the colormap list left out."""
    if hasattr(spec, "children"):
        return ("layout", spec.type,
                [_spec_tree(c, port) for c in spec.children])
    options = spec.options
    if spec.name == "colormap":
        names = p_maps.colormap_names()
        assert (options == names) if port else spec.value in options
        options = None
    return ("control", spec.name, spec.type, spec.label, options,
            spec.value, spec.range)


def _ui_spec():
    for mode in ("univariate", "bivariate", "rgb", "rgb-hdr", "surface"):
        for quantity in (None, "temp"):
            trees = [_spec_tree(m.UnifiedColorMapController(
                         _ControllerView(mode, quantity)).get_layout(),
                         port=m is p_ui)
                     for m in (p_ui, r_ui)]
            assert trees[0] == trees[1], (mode, quantity)
    assert (p_ui.SurfaceMapController.hex2rgbfloat("#ff8020")
            == r_ui.SurfaceMapController.hex2rgbfloat("#ff8020"))
    assert (p_ui.SurfaceMapController.rgbfloat2hex((1.0, 0.5, 0.125))
            == r_ui.SurfaceMapController.rgbfloat2hex((1.0, 0.5, 0.125)))


CASES = ["config", "camera", "drawreason", "kernels", "loader",
         "loader_cells", "array_loader", "native_knn", "presort",
         "progressions", "cells", "units", "interpolators", "synchronizer",
         "hdr_tiff", "lines", "ui_spec"]


@pytest.mark.parametrize("name", CASES)
def test_copy_matches_reference(name, loaders, layouts, monkeypatch,
                                tmp_path):
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
     "units": _units,
     "interpolators": _interpolators,
     "synchronizer": _synchronizer,
     "hdr_tiff": lambda: _hdr_tiff(tmp_path),
     "lines": _lines,
     "ui_spec": _ui_spec}[name]()


def _camera_class():
    # tests/test_camera.py::test_camera_rotate_composition, on both copies
    cams = [m.Camera(scale=2.0) for m in (p_camera, r_camera)]
    for cam in cams:
        cam.rotate(0.1, -0.2)
    expected = (p_camera.x_rotation_matrix(0.1)
                @ p_camera.y_rotation_matrix(-0.2))
    assert cams[0].rotation_matrix == pytest.approx(expected)
    assert np.allclose(cams[0].rotation_matrix @ cams[0].rotation_matrix.T,
                       np.eye(3))
    np.testing.assert_array_equal(cams[0].rotation_matrix,
                                  cams[1].rotation_matrix)
    rng = np.random.RandomState(1)
    q, _r = np.linalg.qr(rng.normal(size=(3, 3)))
    off = rng.normal(0, 10, 3)
    cams = [m.Camera(q, off, 37.5) for m in (p_camera, r_camera)]
    np.testing.assert_array_equal(cams[0].matrix(), cams[1].matrix())
    dup = cams[0].copy()
    dup.rotate(0.3, 0.0)
    dup.position_offset[0] += 1.0
    assert isinstance(dup, p_camera.Camera) and dup.scale == 37.5
    np.testing.assert_array_equal(cams[0].rotation_matrix, q)
    np.testing.assert_array_equal(cams[0].position_offset, off)


def _clip_to_pixel():
    # tests/test_camera.py::test_clip_to_pixel_centres, then equality
    res = 8
    assert p_camera.clip_to_pixel(np.array([0.0, 0.0]), res) == \
        pytest.approx([3.5, 3.5])
    assert p_camera.clip_to_pixel(np.array([-1 + 1 / res, 1 - 1 / res]),
                                  res) == pytest.approx([0.0, 0.0])
    xy = np.random.RandomState(2).uniform(-1.2, 1.2, (5, 7, 2))
    for r in (8, 64, 1024):
        np.testing.assert_array_equal(p_camera.clip_to_pixel(xy, r),
                                      r_camera.clip_to_pixel(xy, r))


def _kernel_image(n):
    # tests/test_kernels.py::test_kernel_image_mass_conserving
    im = p_kernels.kernel_image(n)
    assert im.sum() * (4.0 / n) ** 2 == pytest.approx(1.0, rel=1e-6)
    np.testing.assert_array_equal(im, r_kernels.kernel_image(n))


def _norm_value(mode):
    # tests/test_kernels.py::test_norm_table's properties, read through
    # norm_value: c(3) near 1, finite and positive, clamped off the table
    hs, _cs = p_kernels.norm_table(mode)
    assert p_kernels.norm_value(3.0, mode) == pytest.approx(1.0, rel=0.01)
    h = np.concatenate([[hs[0] / 10, hs[-1] * 10],
                        np.exp(np.random.RandomState(3).uniform(
                            np.log(hs[0]), np.log(hs[-1]), 200))])
    c = p_kernels.norm_value(h, mode)
    assert np.all(np.isfinite(c)) and np.all(c > 0)
    assert c[0] == p_kernels.norm_value(hs[0], mode)
    np.testing.assert_array_equal(c, r_kernels.norm_value(h, mode))


def _native_available(monkeypatch):
    # tests/test_knn_native.py gates its cases on available(); the port's
    # loads here as the reference's does, and then its kNN is exact
    from scipy.spatial import cKDTree
    assert p_native.available() is r_native.available() is True
    rng = np.random.RandomState(1)
    pos = rng.normal(0, 1, (3000, 3)).astype(np.float32)
    pos[:500] *= 0.02
    h = p_native.knn_smooth(pos, 32)
    d, _ = cKDTree(pos).query(pos, k=33)
    np.testing.assert_allclose(h, 0.5 * d[:, -1], rtol=1e-5)
    np.testing.assert_array_equal(h, r_native.knn_smooth(pos, 32))
    # a runtime that failed to build reports False and builds nothing
    monkeypatch.setattr(p_native, "_lib", None)
    monkeypatch.setattr(p_native, "_build_failed", True)
    assert p_native.available() is False


def _is_inside_ipython(monkeypatch):
    import builtins
    assert p_util.is_inside_ipython() is r_util.is_inside_ipython() is False
    monkeypatch.setattr(builtins, "__IPYTHON__", True, raising=False)
    assert p_util.is_inside_ipython() is r_util.is_inside_ipython() is True


HELPERS = ["camera_class", "clip_to_pixel", "kernel_image_64",
           "kernel_image_32", "kernel_image_16", "kernel_image_8",
           "norm_value_exact", "norm_value_lowrank", "native_available",
           "is_inside_ipython"]


@pytest.mark.parametrize("name", HELPERS)
def test_helper_matches_reference(name, monkeypatch):
    {"camera_class": _camera_class,
     "clip_to_pixel": _clip_to_pixel,
     "kernel_image_64": lambda: _kernel_image(64),
     "kernel_image_32": lambda: _kernel_image(32),
     "kernel_image_16": lambda: _kernel_image(16),
     "kernel_image_8": lambda: _kernel_image(8),
     "norm_value_exact": lambda: _norm_value("exact"),
     "norm_value_lowrank": lambda: _norm_value("lowrank"),
     "native_available": lambda: _native_available(monkeypatch),
     "is_inside_ipython": lambda: _is_inside_ipython(monkeypatch)}[name]()
