"""The port's giant layer and its host planning against the reference
(topsy_tpu/ops/splat_giant.py).

Tolerances: the planning (candidate slots, capable buckets, plan sizes,
the per-frame plan) is host integer math and must be equal; giant_image
agrees to 1e-5 of the image maximum (both run float32 products — the
reference at HIGHEST precision, the port with TF32 off — and sum in
another order); giant_norm rtol 1e-6."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from topsy_tpu.loaders import TestDataLoader
from topsy_tpu.ops import morton
from topsy_tpu.ops import splat_giant as r_giant

from topsy_tpu_torch.ops import splat_giant as p_giant


@pytest.fixture(scope="module")
def layout():
    ps = TestDataLoader(30000, seed=1337).get_pos_smooth().astype(np.float32)
    return morton.build_presorted(ps)


def test_candidate_slots(layout):
    ref = r_giant.candidate_slots(layout)
    got = p_giant.candidate_slots(layout)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g, r)
        assert g.dtype == r.dtype


@pytest.mark.parametrize("res", [128, 256, 1024])
@pytest.mark.parametrize("scale", [400.0, 200.0, 120.0, 60.0, 30.0, 10.0])
def test_giant_plan(layout, res, scale):
    meta = r_giant.candidate_slots(layout)
    L = min(7, max(1, int(np.log2(max(res, 16) / 16)) + 1))
    assert (p_giant.giant_plan(meta, res, scale, L)
            == r_giant.giant_plan(meta, res, scale, L))
    np.testing.assert_array_equal(
        p_giant.capable_buckets(meta[2], res, scale, L),
        r_giant.capable_buckets(meta[2], res, scale, L))


@pytest.mark.parametrize("m", [1, 255, 256, 1000, 8192])
def test_plan_sizes(m):
    assert p_giant.plan_sizes(m) == r_giant.plan_sizes(m)


def test_giant_norm():
    h = np.geomspace(1.0, 300.0, 400).astype(np.float32)
    ref = r_giant.giant_norm(jnp.asarray(h), jnp.float32(2.56))
    got = p_giant.giant_norm(torch.from_numpy(h), torch.tensor(2.56))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)


@pytest.fixture(scope="module")
def giants():
    rng = np.random.RandomState(9)
    cap, res = 300, 96
    cy = rng.uniform(-40, res + 40, cap).astype(np.float32)
    cx = rng.uniform(-40, res + 40, cap).astype(np.float32)
    h = np.exp(rng.uniform(np.log(8.0), np.log(120.0), cap)).astype(np.float32)
    coef = rng.uniform(0.1, 1.0, (cap, 2)).astype(np.float32)
    coef[::13] = 0.0                        # inactive pool slots
    return cy, cx, h, coef, res


def test_giant_image(giants):
    cy, cx, h, coef, res = giants
    ref = np.asarray(r_giant.giant_image(jnp.asarray(cy), jnp.asarray(cx),
                                         jnp.asarray(h), jnp.asarray(coef),
                                         res))
    got = p_giant.giant_image(torch.from_numpy(cy), torch.from_numpy(cx),
                              torch.from_numpy(h), torch.from_numpy(coef),
                              res).numpy()
    assert got.shape == ref.shape == (res, res, 2)
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


def test_select_giants_topk():
    rng = np.random.RandomState(2)
    n = 5000
    h = rng.uniform(0.1, 50.0, n).astype(np.float32)
    mask = rng.random_sample(n) < 0.05
    ref = r_giant.select_giants_topk(jnp.asarray(mask), jnp.asarray(h), 512)
    got = p_giant.select_giants_topk(torch.from_numpy(mask),
                                     torch.from_numpy(h), 512)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
