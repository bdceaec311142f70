"""The port against the original topsy's own committed pixel values
(tests/data/reference_expected.npz), on the scenes and at the tolerances of
tests/test_reference_parity.py, unchanged: the univariate density, the
mass-weighted quantity and the presentation image, each with and without
cells.  The module docstring of tests/test_reference_parity.py explains
the bounds."""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import numpy.testing as npt
import pytest
import torch

import topsy_tpu_torch
from topsy_tpu_torch.drawreason import DrawReason

# one process's share of the cores when pytest-xdist runs several workers
# (torch's default, every core in each process, oversubscribes them)
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

EXPECTED = np.load(Path(__file__).parent / "data" / "reference_expected.npz")


@pytest.fixture(params=[False, True], ids=["nocells", "cells"])
def vis(request):
    v = topsy_tpu_torch.test(1000, render_resolution=200, canvas_class=None,
                             with_cells=request.param, device="cpu")
    v.scale = 200.0
    return v


def test_density_vs_reference(vis):
    """reference: tests/test_render_output.py:199-241 (test_sph_output)."""
    vis.render_sph(DrawReason.EXPORT)
    result = np.asarray(vis.get_sph_image())
    assert result.shape == (200, 200)
    test = result[::20, ::20].ravel()
    expect = EXPECTED["test_sph_output.expect"].astype(np.float32)

    npt.assert_allclose(test, expect, rtol=5e-1)
    ratio = test / expect
    assert abs(ratio.mean() - 1.0) < 0.0015
    assert ratio.std() < 0.015


def test_weighted_quantity_vs_reference(vis):
    """reference: tests/test_render_output.py:161-198: the reference's atol
    on >= 90% of the sampled pixels and 7e-7 everywhere."""
    vis.quantity_name = "test-quantity"
    vis.scale = 20.0
    vis.rotate(0.0, 0.4)
    vis.render_sph(DrawReason.EXPORT)
    result = np.asarray(vis.get_sph_image())
    assert result.shape == (200, 200)
    test = result[::20, ::20].ravel()
    expect = EXPECTED["test_sph_weighted_output.expect"].astype(np.float32)
    err = np.abs(test - expect)
    assert (err <= 1.5e-7).mean() >= 0.90
    npt.assert_allclose(test, expect, atol=7e-7)


def test_render_presentation_vs_reference(vis):
    """reference: tests/test_render_output.py:27-65 (test_render)."""
    result = np.asarray(vis.get_sph_presentation_image())
    assert result.dtype == np.uint8
    expect = EXPECTED["test_render.reference_result"].astype(np.int32)
    got = result[::20, ::20].ravel().astype(np.int32)
    npt.assert_allclose(got, expect, atol=5)
