"""Constants the PyTorch port restates from jax-importing reference modules
must equal the reference's values."""

import numpy as np
import pytest

from topsy_tpu import config
from topsy_tpu.ops import splat as r_splat
from topsy_tpu.ops import splat_atlas as r_atlas
from topsy_tpu.ops import splat_giant as r_giant
from topsy_tpu.ops import splat_pallas as r_pallas

from topsy_tpu_torch.color import maps as p_maps
from topsy_tpu_torch.ops import splat as p_splat
from topsy_tpu_torch.ops import splat_accum as p_accum
from topsy_tpu_torch.ops import splat_atlas as p_atlas
from topsy_tpu_torch.ops import splat_giant as p_giant
from topsy_tpu_torch.ops import stats as p_stats
from topsy_tpu.ops import stats as r_stats

PINNED = [
    (p_splat, r_splat, ["H_MIN", "H_MAX", "H_TRUNC", "WINDOW"]),
    (p_atlas, r_atlas, ["GROUP", "FOOT", "BAND", "COL_PAD", "ROW_PAD",
                        "WINDOW_COLS", "TIER3_PALLAS_MIN_GROUPS"]),
    (p_accum, r_pallas, ["FLAG_INACTIVE", "FLAG_ALL_TINY", "FLAG_POLY",
                         "FLAG_MIXED", "FLAG_MASKED", "SIZE_CLASSES",
                         "FULL_CLASS", "COL_ALIGN", "PROFILE_COLS",
                         "SUBGROUPS", "WINDOW_ROWS", "WINDOW_COLS",
                         "SUPPORT2"]),
    (p_giant, r_giant, ["FOOT", "GIANT_H", "CAP", "GIANT_RANK",
                        "GIANT_DEGREE", "NBIG", "BUCKET_DISABLED"]),
    (p_stats, r_stats, ["HIST_BINS"]),
]

CASES = [(p, r, name) for p, r, names in PINNED for name in names]


@pytest.mark.parametrize(
    "port,ref,name", CASES,
    ids=[f"{r.__name__.rsplit('.', 1)[-1]}.{n}" for _, r, n in CASES])
def test_restated_constant_matches_reference(port, ref, name):
    assert getattr(port, name) == getattr(ref, name)


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


def test_packaged_luts_match_matplotlib():
    import matplotlib
    stored = np.load(p_maps._LUT_FILE)
    n = config.COLORMAP_NUM_SAMPLES
    for name in stored.files:
        ref = matplotlib.colormaps[name](np.linspace(0.001, 0.999, n))
        np.testing.assert_array_equal(stored[name], ref.astype(np.float32))
