"""CPU tests of the check that decides ``correct``: a sound run passes, and
a run whose timed path is broken underneath, or the bfloat16 control in
the program's place, comes out not correct.  They drive the rest of a run
at a size a test run holds, with the harness's look for a card skipped.

    python -m pytest perfbench -q
"""

from __future__ import annotations

import json
import os

import pytest
import torch

from perfbench import control, harness

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = {"n_particles": 1 << 15, "resolution": 128, "canvas": [128, 128]}
SEED = 2 ** 31 + 12345


@pytest.fixture(scope="module")
def bench():
    torch.set_num_threads(4)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def run(bench, workload, fault=None, seconds=2.0):
    return harness.run_cell(bench, workload, SEED, seconds, False,
                            device="cpu", scale_down=SMALL, fault=fault)


def stale_frames(vis, mp):
    """A step that returns its state unchanged: every draw presents the
    last image rendered before the window."""
    mp.setattr(vis, "render_sph", lambda *a, **k: None)


def half_the_particles(vis, mp):
    """Half of the particles left out: the deposit skips every other
    group."""
    from topsy_tpu_torch.ops import splat_accum, zsplat_atlas
    orig_k2 = splat_accum.accumulate_groups
    orig_k3 = zsplat_atlas.accumulate_max_packed

    def k2(ay_g, ax_g, ih_g, coef_g, w0, c0, ce, flags, **kw):
        flags = flags.clone()
        flags[1::2] = 0
        return orig_k2(ay_g, ax_g, ih_g, coef_g, w0, c0, ce, flags, **kw)

    def k3(keys, **kw):
        kw["flags"] = kw["flags"].clone()
        kw["flags"][1::2] = 0
        return orig_k3(keys, **kw)

    mp.setattr(splat_accum, "accumulate_groups", k2)
    mp.setattr(zsplat_atlas, "accumulate_max_packed", k3)


def altered_answer(vis, mp):
    """An answer altered where it is produced: the centre of the renderer's
    image, where the snapshot is densest, scaled by 1.5."""
    sph = vis._sph
    orig = sph.get_output_image

    def altered():
        im = orig().clone()
        c, n = im.shape[0] // 2, im.shape[0] // 16
        im[c - n:c + n, c - n:c + n] *= 1.5
        return im

    mp.setattr(sph, "get_output_image", altered)


CELLS = ["density.export", "density.interactive", "surface.interactive"]


@pytest.mark.parametrize("workload", CELLS)
def test_a_sound_run_is_correct(bench, workload):
    out = run(bench, workload)
    assert out["checked"] > 0
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", [stale_frames, half_the_particles,
                                   altered_answer],
                         ids=["stale", "half", "altered"])
def test_a_broken_timed_path_is_not_correct(bench, workload, fault,
                                            monkeypatch):
    out = run(bench, workload, fault=lambda vis: fault(vis, monkeypatch))
    assert out["checked"] > 0
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("workload", CELLS)
def test_the_bfloat16_control_is_not_correct(bench, workload):
    got = control.control(bench, workload, SEED, "cpu", scale_down=SMALL)
    assert not got["passes"], got["checks"]


def test_on_the_card_a_short_run_is_correct(bench):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = harness.run_cell(bench, "density.export", SEED, 3.0, False,
                           device="cuda")
    assert out["correct"], out["checks"]


test_on_the_card_a_short_run_is_correct = pytest.mark.cuda(
    test_on_the_card_a_short_run_is_correct)
