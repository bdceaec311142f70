"""Constants the PyTorch port restates from jax-importing reference modules
must equal the reference's values."""

import numpy as np
import pytest

from topsy_tpu import config
from topsy_tpu.ops import knn_device as r_knn_device
from topsy_tpu.render import store as r_store
from topsy_tpu.ops import morton_device as r_morton_device
from topsy_tpu.ops import splat as r_splat
from topsy_tpu.ops import splat_atlas as r_atlas
from topsy_tpu.ops import splat_giant as r_giant
from topsy_tpu.ops import splat_pallas as r_pallas
from topsy_tpu.ops import zsplat as r_zsplat
from topsy_tpu.ops import zsplat_atlas as r_zatlas
from topsy_tpu.ops import zsplat_pallas as r_zpallas

from topsy_tpu_torch import config as p_config
from topsy_tpu_torch.color import maps as p_maps
from topsy_tpu_torch.ops import knn_device as p_knn_device
from topsy_tpu_torch.render import store as p_store
from topsy_tpu_torch.ops import morton_device as p_morton_device
from topsy_tpu_torch.ops import splat as p_splat
from topsy_tpu_torch.ops import splat_accum as p_accum
from topsy_tpu_torch.ops import splat_atlas as p_atlas
from topsy_tpu_torch.ops import splat_giant as p_giant
from topsy_tpu_torch.ops import stats as p_stats
from topsy_tpu_torch.ops import zsplat as p_zsplat
from topsy_tpu_torch.ops import zsplat_accum as p_zaccum
from topsy_tpu_torch.ops import zsplat_atlas as p_zatlas
from topsy_tpu.ops import stats as r_stats
from topsy_tpu.parallel import mesh as r_mesh
from topsy_tpu.parallel import render_step as r_render_step
from topsy_tpu_torch.parallel import mesh as p_mesh
from topsy_tpu_torch.parallel import render_step as p_render_step

PINNED = [
    (p_splat, r_splat, ["H_MIN", "H_MAX", "H_TRUNC", "WINDOW"]),
    (p_atlas, r_atlas, ["GROUP", "FOOT", "BAND", "COL_PAD", "ROW_PAD",
                        "WINDOW_ROWS", "WINDOW_COLS",
                        "TIER3_PALLAS_MIN_GROUPS"]),
    (p_store, r_store, ["PAD_MULTIPLE", "MIN_BUCKET", "MAX_BUCKET"]),
    (p_knn_device, r_knn_device, ["BLOCK", "TILE"]),
    (p_config, config, ["INTERACTIVE_USE_PRESORTED",
                        "MAX_PARTICLES_PER_EXPORT_RENDERCALL"]),
    (p_accum, r_pallas, ["FLAG_INACTIVE", "FLAG_ALL_TINY", "FLAG_POLY",
                         "FLAG_MIXED", "FLAG_MASKED", "SIZE_CLASSES",
                         "FULL_CLASS", "COL_ALIGN", "PROFILE_COLS",
                         "SUBGROUPS", "WINDOW_ROWS", "WINDOW_COLS",
                         "SUPPORT2"]),
    (p_giant, r_giant, ["FOOT", "GIANT_H", "CAP", "GIANT_RANK",
                        "GIANT_DEGREE", "NBIG", "BUCKET_DISABLED"]),
    (p_stats, r_stats, ["HIST_BINS"]),
    (p_zaccum, r_zpallas, ["NEG", "FLAG_SKIP", "FLAG_ACTIVE", "FULL_CLASS",
                           "SIZE_CLASSES", "PROFILE_COLS", "WINDOW_COLS",
                           "WINDOW_ROWS"]),
    (p_zsplat, r_zsplat, ["HEMI_SUPPORT"]),
    (p_zatlas, r_zatlas, ["GROUP"]),
    (p_morton_device, r_morton_device, ["R_CAP"]),
    (p_mesh, r_mesh, ["PARTICLE_AXIS"]),
]

# (module, attribute path) pairs whose reference modules import matplotlib,
# resolved inside the test so that the file collects without matplotlib
# (the card tests run where it is not installed)
LAZY_PINNED = [
    ("visualizer", "VALID_RENDER_MODES"),
    *[("color.maps", f"RGBColormap.{a}") for a in (
        "input_channels", "max_percentile", "dynamic_range",
        "_sterrad_to_arcsec2", "_default_params")],
    *[("color.maps", f"RGBHDRColormap.{a}")
      for a in ("max_percentile", "dynamic_range")],
    *[("color.maps", f"BivariateColormap.{a}")
      for a in ("default_quantity_name", "_default_params")],
    ("render.periodic", "PeriodicSPHRenderer.num_repetitions"),
]

CASES = [(p, r, name) for p, r, names in PINNED for name in names]


@pytest.mark.parametrize(
    "port,ref,name", CASES,
    ids=[f"{r.__name__.rsplit('.', 1)[-1]}.{n}" for _, r, n in CASES])
def test_restated_constant_matches_reference(port, ref, name):
    assert getattr(port, name) == getattr(ref, name)


@pytest.mark.parametrize("module,path", LAZY_PINNED,
                         ids=[f"{m}.{p}" for m, p in LAZY_PINNED])
def test_restated_constant_of_matplotlib_module_matches_reference(module,
                                                                  path):
    import importlib
    values = []
    for package in ("topsy_tpu_torch", "topsy_tpu"):
        obj = importlib.import_module(f"{package}.{module}")
        for part in path.split("."):
            obj = getattr(obj, part)
        values.append(obj)
    assert values[0] == values[1]


def test_accum_foot_matches_atlas_foot():
    assert p_accum.FOOT == r_atlas.FOOT


def test_t3_cap_and_window_rows_match_reference_literals():
    """The spill tier-3 budget (1024) and the presorted window height (96)
    are literals inside the reference's functions."""
    import inspect
    src = inspect.getsource(r_atlas.spill_pass)
    assert "1024 if t3_cap is None" in src
    assert p_atlas.T3_CAP == 1024
    assert "window_rows = 96" in inspect.getsource(r_atlas.splat_atlas_fields)
    assert p_atlas.PRESORTED_WINDOW_ROWS == 96


def test_surface_literals_match_reference():
    """The surface path's window height (96), tier-3 budget without a cap
    (1024) and footprint (8) are literals inside the reference's
    functions."""
    import inspect
    src = inspect.getsource(r_zatlas.zsplat_atlas)
    assert "window_rows = 96" in src and p_zatlas.WINDOW_ROWS == 96
    assert "1024 if t3_cap is None" in src and p_zatlas.T3_DEFAULT == 1024
    assert "foot = 8.0" in inspect.getsource(r_zpallas._max_deposit)
    assert p_zaccum.FOOT == 8.0 == p_atlas.FOOT


def test_packaged_luts_match_matplotlib():
    import matplotlib
    stored = np.load(p_maps._LUT_FILE)
    n = config.COLORMAP_NUM_SAMPLES
    for name in stored.files:
        ref = matplotlib.colormaps[name](np.linspace(0.001, 0.999, n))
        np.testing.assert_array_equal(stored[name], ref.astype(np.float32))


def test_sorted_path_literals_match_reference():
    """The sorted path's group widths by particle count (512 from 2^18, 128
    from 2^14, else 64) and the finishing pass's chunk (4096) are literals
    inside the reference's functions."""
    import inspect
    src = inspect.getsource(r_atlas.splat_atlas)
    assert "if n >= 1 << 18:" in src and "elif n >= 1 << 14:" in src
    assert "G = 128" in src and "G = 64" in src
    assert [p_atlas.sorted_group_size(n) for n in
            (1, (1 << 14) - 1, 1 << 14, (1 << 18) - 1, 1 << 18)] == \
        [64, 64, 128, 128, 512]
    assert r_knn_device._BRUTE_CHUNK == p_knn_device.BRUTE_CHUNK == 4096


def test_knn_device_max_n_is_the_ports_own():
    """The port routes the array loader's kNN to the card by a memory
    bound of its own (``knn_device.device_bytes``, held against the card's
    peak allocation in chip_smoke.py phase A), not by the reference's
    2^18, which a TPU runtime's crash set: 2^24 positions fit 16 GiB, and
    the bound grows linearly in n."""
    assert config.KNN_DEVICE_MAX_N == 1 << 18
    assert not hasattr(p_config, "KNN_DEVICE_MAX_N")
    assert p_knn_device.device_bytes(1 << 24) <= 16 << 30
    assert p_knn_device.device_bytes(1 << 25) \
        - p_knn_device.device_bytes(1 << 24) \
        == p_knn_device.BYTES_PER_PARTICLE << 24


def test_mesh_pad_quantum_matches_reference_literal():
    """The mesh presort pads its layout to 4096 slots per shard, a literal
    inside the reference's ``ensure_presorted`` and ``_build_mesh_mips``."""
    import inspect
    src = inspect.getsource(r_render_step.DistributedSplatter)
    assert "pad_total=4096 * self.n_devices" in src
    assert "pad_total=4096 * nl_dev" in src
    assert p_render_step.PAD_QUANTUM == 4096
