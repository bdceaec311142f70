"""The PyTorch port imports and renders every mode (univariate EXPORT
through the sorted block path and the presort, CHANGE and REFINE frames,
surface EXPORT and CHANGE frames, rgb, rgb-hdr, bivariate, the depth pick
and periodic tiling; an EXPORT frame with the Catmull-Rom pyramid
collapse), renders over a two-shard CPU mesh (the block path,
a CHANGE frame of the mesh's columns, the surface), presorts on the device
and
renders a device loader's snapshot from a decimation-mip tier, computes
smoothing lengths (the device kNN on the CPU, an ArrayDataLoader's native
kNN) and renders them through the scatter backend, imports every module
of the host shell, saves to .npy / .tif / a figure, records and replays a
session (and replays one the JAX package's recorder pickled) and runs the
command line, with jax and topsy_tpu made unimportable, and its sources
import neither."""

import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import sys
sys.modules["jax"] = None          # any 'import jax' now raises ImportError
sys.modules["topsy_tpu"] = None    # and so does any 'import topsy_tpu...'
import numpy as np
import topsy_tpu_torch
from topsy_tpu_torch.canvas import OffscreenCanvas
vis = topsy_tpu_torch.test(2000, render_resolution=64, device="cpu",
                           canvas_class=OffscreenCanvas)
vis.show_status = False
im = vis.get_sph_image()
assert im.shape == (64, 64) and np.isfinite(im).all() and im.sum() > 0
assert vis.store.presorted_layout is None     # the sorted block path
from topsy_tpu_torch.loaders import ArrayDataLoader
from topsy_tpu_torch.ops.knn_device import knn_smooth_device
pos = vis.data_loader.get_positions()
h = knn_smooth_device(pos, 32, device="cpu").numpy()
assert h.shape == (2000,) and (h > 0).all()
avis = topsy_tpu_torch.visualizer.Visualizer(
    data_loader_class=ArrayDataLoader, data_loader_args=(pos,),
    data_loader_kwargs={"device": "cpu"}, render_resolution=64,
    device="cpu", canvas_class=OffscreenCanvas, splat_backend="scatter")
assert np.isfinite(avis._sph.get_image()).all()
pres = vis.get_sph_presentation_image()
assert pres.shape == (64, 64, 4) and pres.dtype == np.uint8
from topsy_tpu_torch.drawreason import DrawReason
vis.show_colorbar = vis.show_scalebar = False
frame = vis.draw(DrawReason.CHANGE)
assert frame.shape == (480, 640, 4) and vis._sph.last_column_ranges
vis._sph.render(DrawReason.REFINE)
assert np.isfinite(vis._sph.get_image()).all()
vis.render_mode = "surface"
raw = vis._sph.get_image()
assert raw.shape == (64, 64, 2) and np.isfinite(raw).all()
assert (raw[..., 1] > 0).any()
pres = vis.get_sph_presentation_image()
assert pres.shape == (64, 64, 4) and pres.dtype == np.uint8
vis.draw(DrawReason.CHANGE)
assert vis._sph.last_column_ranges and (vis._sph.get_image()[..., 1] > 0).any()
for mode, dtype in (("rgb", np.uint8), ("rgb-hdr", np.float16),
                    ("bivariate", np.uint8)):
    vis.render_mode = mode
    pres = vis.get_sph_presentation_image()
    assert pres.shape == (64, 64, 4) and pres.dtype == dtype, mode
    assert pres[..., :3].astype(np.float32).std() > 0, mode
    assert vis.draw(DrawReason.CHANGE).dtype == dtype
depth = vis.get_depth_image()
assert depth.shape == (64, 64) and np.isfinite(depth).any()
from topsy_tpu_torch import config
from topsy_tpu_torch.loaders import TestDataDeviceLoader
from topsy_tpu_torch.ops.morton_device import DevicePresortedLayout
from topsy_tpu_torch.visualizer import Visualizer
assert isinstance(vis.store.presorted_layout, DevicePresortedLayout)
config.COLUMN_MIP_FLOOR_TARGET = 300
config.INITIAL_PARTICLES_TO_RENDER = 100
dvis = Visualizer(data_loader_class=TestDataDeviceLoader,
                  data_loader_args=(4000,),
                  data_loader_kwargs={"device": "cpu"},
                  render_resolution=64, device="cpu",
                  canvas_class=OffscreenCanvas)
dvis.show_status = dvis.show_colorbar = dvis.show_scalebar = False
dvis.draw(DrawReason.CHANGE)
assert dvis.store.ensure_column_mips()
assert dvis._sph.render_progression.last_block_tier == 0
while dvis._sph.needs_refine():
    dvis.draw(DrawReason.REFINE)
assert np.isfinite(dvis._sph.get_image()).all()
tiled = topsy_tpu_torch.test(2000, render_resolution=64, device="cpu",
                             canvas_class=OffscreenCanvas,
                             periodic_tiling=True)
im = tiled.get_sph_image()
assert im.shape == (64, 64) and np.isfinite(im).all() and im.sum() > 0
from topsy_tpu_torch.parallel import make_mesh
mvis = topsy_tpu_torch.test(2000, render_resolution=64, device="cpu",
                            canvas_class=OffscreenCanvas,
                            mesh=make_mesh(2, devices=["cpu"] * 2))
mvis.show_status = mvis.show_colorbar = mvis.show_scalebar = False
im = mvis.get_sph_image()
assert im.shape == (64, 64) and np.isfinite(im).all() and im.sum() > 0
assert mvis.store.presorted_layout is None    # the strided block path
mvis.draw(DrawReason.CHANGE)
assert mvis._sph.last_column_ranges and mvis._sph._splatter.has_presorted()
mvis.render_mode = "surface"
assert (mvis._sph.get_image()[..., 1] > 0).any()
import importlib
import os
import pickle
import runpy
for name in ("performance", "view_synchronizer", "recorder",
             "recorder.interpolator", "color.ui", "canvas", "canvas.jupyter",
             "hdr_tiff", "overlays.line", "util"):
    importlib.import_module("topsy_tpu_torch." + name)
try:
    importlib.import_module("topsy_tpu_torch.canvas.qt")
except ImportError as e:          # PySide6 is not installed
    assert "PySide6" in str(e), e
out_dir = sys.argv[1]
vis.render_mode = "univariate"
for ext in ("npy", "tif", "png"):
    vis.save(os.path.join(out_dir, "saved." + ext))
    assert os.path.getsize(os.path.join(out_dir, "saved." + ext)) > 0
from topsy_tpu_torch import hdr_tiff
assert hdr_tiff.imread(os.path.join(out_dir, "saved.tif")).shape == (64, 64, 3)
from topsy_tpu_torch.recorder import VisualizationRecorder
rec = VisualizationRecorder(vis)
rec.record()
vis.rotate(0.2, 0.1)
vis.draw(DrawReason.CHANGE)
rec.stop()
rec._end_time = 0.3
frames = list(rec._replay(fps=10, resolution=(48, 32), smooth=True))
assert len(frames) == 3 and frames[0].shape == (32, 48, 3)
rec.load_timestream(os.path.join(out_dir, "reference_session.pkl"))
frames = list(rec._replay(fps=10, resolution=(48, 32), smooth=False))
assert len(frames) == 5 and all(np.isfinite(f).all() for f in frames)
vis._sph.render(DrawReason.EXPORT)
spline = vis._sph.get_image()
config.PYRAMID_COLLAPSE_FILTER = "catmull"
vis._sph.render(DrawReason.EXPORT)
catmull = vis._sph.get_image()
config.PYRAMID_COLLAPSE_FILTER = "spline"
assert catmull.shape == spline.shape and np.isfinite(catmull).all()
assert catmull.sum() > 0 and not np.array_equal(catmull, spline)
from topsy_tpu_torch import performance
with performance.trace(os.path.join(out_dir, "trace")) as t:
    vis._sph.render(DrawReason.EXPORT)
assert t.profiler is not None
load = topsy_tpu_torch.load
topsy_tpu_torch.load = lambda *a, **k: load(*a, device="cpu", **k)
sys.argv = ["topsy_tpu_torch", "test://1000", "-r", "32"]
runpy.run_module("topsy_tpu_torch", run_name="__main__")
for banned in ("jax", "topsy_tpu"):
    loaded = [m for m in sys.modules
              if m == banned or m.startswith(banned + ".")]
    assert all(sys.modules[m] is None for m in loaded), loaded
print("OK")
"""

BANNED_IMPORT = re.compile(r"^\s*(from|import) (jax|topsy_tpu)(\.|\s|$)")


def _reference_session(path):
    """A half-second session recorded and pickled by the JAX package."""
    import types
    import topsy_tpu
    import topsy_tpu.recorder as r_recorder
    from topsy_tpu.canvas import OffscreenCanvas as RefCanvas
    from topsy_tpu.drawreason import DrawReason
    now = [0.0]
    clock = types.SimpleNamespace(time=lambda: now[0])
    saved, r_recorder.time = r_recorder.time, clock
    try:
        vis = topsy_tpu.test(1000, render_resolution=32,
                             canvas_class=RefCanvas)
        rec = r_recorder.VisualizationRecorder(vis)
        rec.record()
        now[0] = 0.2
        vis.rotate(0.3, 0.0)
        vis.scale = 60.0
        vis.draw(DrawReason.CHANGE)
        now[0] = 0.5
        rec.stop()
        rec.save_timestream(path)
    finally:
        r_recorder.time = saved


def test_port_renders_without_jax(tmp_path):
    _reference_session(str(tmp_path / "reference_session.pkl"))
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    # one process's share of the cores when pytest-xdist runs several
    # workers (torch's default, every core, oversubscribes them)
    env.setdefault("OMP_NUM_THREADS", str(max(1, (os.cpu_count() or 1) // int(
        os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))))
    out = subprocess.run([sys.executable, "-c", SCRIPT, str(tmp_path)],
                         cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.strip().endswith("OK")


@pytest.mark.parametrize("path", [
    "topsy_tpu_torch", "chip_smoke.py", "k2_variants.py", "k3_host_cost.py"])
def test_no_jax_import_in_port_sources(path):
    full = os.path.join(ROOT, path)
    files = ([full] if full.endswith(".py") else
             [os.path.join(d, f) for d, _, fs in os.walk(full) for f in fs
              if f.endswith(".py")])
    assert files
    for f in files:
        with open(f) as fh:
            for line in fh:
                assert not BANNED_IMPORT.match(line), (f, line)
