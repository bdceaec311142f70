"""CPU tests of the ``rgb.export`` cell (configuration ``galaxy_2e24_rgb``):
a sound run is correct and gives the numbers its limits bound, and a run
whose timed path is broken underneath, or the bfloat16 control in the
program's place, comes out not correct.  Run at a size a test run holds,
with the harness's look for a card skipped.

    python -m pytest perfbench -q
"""

from __future__ import annotations

import pytest

from perfbench import control, harness
from perfbench.test_perfbench_check import (SEED, SMALL,  # noqa: F401
                                            altered_answer, bench,
                                            half_the_particles, stale_frames)

CELL = "rgb.export"


def run(bench, fault=None, seconds=1.0):
    return harness.run_cell(bench, CELL, SEED, seconds, False, device="cpu",
                            scale_down=SMALL, fault=fault)


def test_a_sound_rgb_run_is_correct(bench):
    out = run(bench)
    assert out["checked"] > 0
    assert set(out["checks"]) == {"raw_max_rel", "rgba_mean_abs"}
    assert all(c["value"] is not None for c in out["checks"].values())
    assert out["correct"], out["checks"]
    prog, ref = out["ranges"]["program"], out["ranges"]["reference"]
    assert prog["log"] and ref["log"]
    assert abs(prog["vmax"] - ref["vmax"]) < 1e-3


@pytest.mark.parametrize("fault", [stale_frames, half_the_particles,
                                   altered_answer],
                         ids=["stale", "half", "altered"])
def test_a_broken_rgb_path_is_not_correct(bench, fault, monkeypatch):
    out = run(bench, fault=lambda vis: fault(vis, monkeypatch))
    assert out["checked"] > 0
    assert not out["correct"], out["checks"]


def test_the_bfloat16_rgb_control_is_not_correct(bench):
    got = control.control(bench, CELL, SEED, "cpu", scale_down=SMALL)
    assert not got["passes"], got["checks"]
