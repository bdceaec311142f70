"""The RGB stellar-light export (``render_mode`` rgb, EXPORT frames through
``Visualizer.draw``) against the benchmark's plain reference
(``perfbench/checks/rgb.py``) within the ``galaxy_2e24_rgb``
configuration's limits, and the store's band masses: a device loader's
adopted in place, a host loader's uploaded once (``band_bytes_uploaded``),
each inside one ``topsy.bands`` interval.  CPU, 2^12 particles, 64².
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import pytest
import torch

from topsy_tpu_torch import performance
from topsy_tpu_torch.canvas import OffscreenCanvas
from topsy_tpu_torch.drawreason import DrawReason
from topsy_tpu_torch.loaders import TestDataDeviceLoader, TestDataLoader
from topsy_tpu_torch.render.store import ParticleStore
from topsy_tpu_torch.visualizer import Visualizer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from perfbench import check, harness  # noqa: E402
from perfbench.checks import rgb  # noqa: E402

N, RES = 1 << 12, 64
SEED = 2 ** 31 + 19
TURNS = (0.3, 0.0087)
with open(os.path.join(ROOT, "perfbench", "configs",
                       "galaxy_2e24_rgb.json")) as _f:
    CONFIG = json.load(_f) | {"n_particles": N, "resolution": RES,
                              "canvas": [RES, RES]}
LIMITS = CONFIG["limits"]


@pytest.fixture(autouse=True)
def _tracing_restored():
    was = performance.set_tracing(False)
    performance.signposter.clear()
    yield
    performance.set_tracing(was)
    performance.signposter.clear()


def export(snap, turns):
    """(setup view, [(view, raw image, presented frame)]) of the
    configuration's Visualizer over ``snap``: EXPORT frames of a short
    turntable, ``turns`` radians a frame."""
    vis = harness.build(CONFIG, SEED, "cpu", snap)
    setup_view = harness.view_of(vis)
    out = []
    for turn in turns:
        vis.rotate(turn, 0.0)
        frame = vis.draw(DrawReason.EXPORT)
        out.append((harness.view_of(vis),
                    vis._sph.get_output_image().clone(), frame.copy()))
    return setup_view, out


@pytest.fixture(scope="module")
def sound():
    """The sound run's answers, the reference and its raw images of them."""
    setup_view, answers = export(check.snapshot(CONFIG, SEED, "cpu"), TURNS)
    ref = rgb.Reference(CONFIG, SEED, "cpu", setup_view)
    return setup_view, answers, ref, [ref.raw(v) for v, _, _ in answers]


def worst(answers, ref, raws_ref):
    out = {}
    for (_, raw, frame), raw_ref in zip(answers, raws_ref):
        got = rgb.compare(raw, raw_ref, frame, ref.frame(raw_ref))
        for k, v in got.items():
            out[k] = max(out.get(k, -np.inf), v)
    return out


def test_rgb_export_matches_the_reference(sound):
    _, answers, ref, raws_ref = sound
    assert all(frame.dtype == np.uint8 and frame.shape == (RES, RES, 4)
               for _, _, frame in answers)
    assert all(raw.shape == (RES, RES, 3) for _, raw, _ in answers)
    got = worst(answers, ref, raws_ref)
    assert set(got) == set(LIMITS)
    assert check.within(got, LIMITS), got
    assert ref.cmap["vmax"] - ref.cmap["vmin"] == rgb.DYNAMIC_RANGE


def test_the_bfloat16_reference_fails_a_limit_twice_over(sound):
    setup_view, answers, ref, raws_ref = sound
    low = rgb.Reference(CONFIG, SEED, "cpu", setup_view,
                        dtype=torch.bfloat16)
    got = {}
    for (view, _, _), raw in zip(answers, raws_ref):
        raw_low = low.raw(view)
        one = rgb.compare(raw_low.float(), raw, low.frame(raw_low),
                          ref.frame(raw))
        for k, v in one.items():
            got[k] = max(got.get(k, -np.inf), v)
    assert any(got[k] >= 2 * lim for k, lim in LIMITS.items()), got


def swapped_bands(snap):
    return snap | {"rgb": snap["rgb"][:, [1, 0, 2]].contiguous()}


def half_the_particles(snap):
    return snap | {k: snap[k][::2].contiguous()
                   for k in ("pos_smooth", "mass", "rgb")}


@pytest.mark.parametrize("fault", [swapped_bands, half_the_particles],
                         ids=["swap", "half"])
def test_a_faulty_render_fails_the_check(sound, fault):
    _, _, ref, raws_ref = sound
    _, answers = export(fault(check.snapshot(CONFIG, SEED, "cpu")),
                        TURNS[:1])
    got = worst(answers, ref, raws_ref)
    assert not check.within(got, LIMITS), got


def test_a_device_loaders_bands_are_adopted():
    loader = TestDataDeviceLoader(N, seed=7, device="cpu")
    bands = loader.device_arrays()["rgb"]
    pos = loader.get_positions()
    np.testing.assert_allclose(
        bands.numpy(), np.abs(np.stack([np.sin(pos[:, 0] / 10.0),
                                        np.cos(pos[:, 1] / 10.0),
                                        np.cos(pos[:, 2] / 10.0)], axis=1)),
        rtol=1e-6, atol=1e-7)
    before = performance.counters["band_bytes_uploaded"]
    store = ParticleStore(loader, device="cpu")
    assert (store.rgb.untyped_storage().data_ptr()
            == bands.untyped_storage().data_ptr())
    assert torch.equal(store.values_for("rgb"), bands)
    assert performance.counters["band_bytes_uploaded"] == before


def test_a_host_loaders_bands_are_uploaded_once():
    loader = TestDataLoader(N)
    before = performance.counters["band_bytes_uploaded"]
    store = ParticleStore(loader, device="cpu")
    first = store.rgb
    assert store.rgb is first
    assert torch.equal(first, torch.from_numpy(loader.get_rgb_masses()))
    assert performance.counters["band_bytes_uploaded"] - before == N * 12


def test_bands_of_the_wrong_shape_are_refused():
    loader = TestDataDeviceLoader(N, seed=7, device="cpu")
    loader.device_arrays()["rgb"] = torch.ones(N, 2)
    with pytest.raises(ValueError, match="rgb"):
        ParticleStore(loader, device="cpu").rgb


def test_topsy_bands_spans_the_adoption_and_the_gather():
    """One ``topsy.bands`` in set-up (the constructor's first EXPORT adopts
    the bands), one more where the presorted channel-major gather is built
    (the second EXPORT), none after."""
    def bands():
        return sum(1 for iv in performance.signposter.intervals
                   if iv is not None and iv.name == "topsy.bands")

    performance.set_tracing(True)
    vis = Visualizer(data_loader_class=TestDataDeviceLoader,
                     data_loader_args=(N,),
                     data_loader_kwargs={"device": "cpu"},
                     render_resolution=RES, canvas_class=OffscreenCanvas,
                     render_mode="rgb", device="cpu")
    vis.show_status = vis.show_colorbar = vis.show_scalebar = False
    assert bands() == 1
    assert vis.store.presorted_layout is None
    vis.draw(DrawReason.EXPORT)
    assert vis.store.presorted_layout is not None
    assert bands() == 2
    vis.draw(DrawReason.EXPORT)
    assert bands() == 2
