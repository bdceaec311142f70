"""The port's presort built on the device (``topsy_tpu_torch/ops/
morton_device.py``) against the reference's (``topsy_tpu/ops/
morton_device.py``), at the sizes of tests/test_morton_device.py (50,000
particles; 3,000 and 5,000 for the capacity padding), on the CPU.

The layout is held by its invariants (tests/test_morton_device.py:36-133:
each particle once, pads carry the sentinel, real slots form each group's
prefix, ``real_per_column``, buckets non-decreasing and changing only at
``run_quantum`` multiples, buckets bounding h, the shuffle in effect) and
by its structure against the reference's build on the same positions:
``n_out``, ``run_quantum``, ``real_per_column`` and each particle's bucket
are equal (they depend on the buckets only, not on the random bits).  The
rendered image of the device layout equals the host layout's at the
cross-engine bounds (sum rel 1e-3, correlation > 0.9999), and the store
falls back to the host presort, logged, when the device build returns
None."""

import logging
import os

import numpy as np
import pytest
import torch

from topsy_tpu.ops import morton_device as r_md
from topsy_tpu.ops import splat_giant as r_giant
from topsy_tpu_torch import camera, convert
from topsy_tpu_torch.loaders import TestDataDeviceLoader, TestDataLoader
from topsy_tpu_torch.ops import morton, morton_device, splat_atlas, splat_giant
from topsy_tpu_torch.render.store import ParticleStore

# one process's share of the cores when pytest-xdist runs several workers
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

N = 50000


def _ps(n, seed):
    return TestDataLoader(n, seed=seed).get_pos_smooth().astype(np.float32)


@pytest.fixture(scope="module")
def snap():
    loader = TestDataLoader(N, seed=1337)
    ps = loader.get_pos_smooth().astype(np.float32)
    mass = loader.get_mass().astype(np.float32)
    qty = loader.get_named_quantity("test-quantity").astype(np.float32)
    return ps, np.stack([mass, mass * qty], axis=1)


@pytest.fixture(scope="module")
def dlayout(snap):
    layout = morton_device.build_presorted_device(torch.from_numpy(snap[0]))
    assert layout is not None
    return layout


def _invariants(layout, n):
    gidx = layout.gidx.numpy()
    assert layout.gidx.dtype == torch.int32
    assert layout.buckets.dtype == torch.int32
    assert layout.n_real == n
    assert layout.n_out % 4096 == 0
    assert len(gidx) == layout.n_out
    real = gidx < n
    # real slots gather each particle exactly once; pads carry the sentinel
    assert np.array_equal(np.sort(gidx[real]), np.arange(n))
    assert np.all(gidx[~real] == n)
    # real slots are a prefix of every pad_group group
    r2 = real.reshape(-1, layout.pad_group)
    assert np.all(r2[:, :-1] >= r2[:, 1:])
    assert np.array_equal(layout.real_per_column, r2.sum(axis=0))
    # buckets non-decreasing, changing only at run_quantum multiples
    buckets = layout.buckets.numpy()
    assert np.all(np.diff(buckets) >= 0)
    change = np.flatnonzero(np.diff(buckets)) + 1
    assert np.all(change % layout.run_quantum == 0)


def test_device_layout_invariants(snap, dlayout):
    _invariants(dlayout, len(snap[0]))


def test_device_buckets_bound_smoothing(snap, dlayout):
    """Each real slot's bucket upper edge bounds its particle's h (the
    level-derivation guarantee, ops/splat.levels_from_buckets)."""
    ps = snap[0]
    gidx = dlayout.gidx.numpy()
    buckets = dlayout.buckets.numpy()
    real = gidx < len(ps)
    h = ps[gidx[real], 3]
    upper = 2.0 ** ((buckets[real] + 1.0) * morton.DELTA_OCTAVE)
    assert np.all(h <= upper * (1 + 1e-5))
    lower = 2.0 ** (buckets[real] * morton.DELTA_OCTAVE)
    # f32 log2 may flip the floor at bucket boundaries only
    assert (h < lower * (1 - 1e-5)).mean() < 1e-3


def test_device_shuffle_randomizes_groups(dlayout):
    gidx = dlayout.gidx.numpy()
    real = gidx < dlayout.n_real
    g_id = np.repeat(np.arange(len(gidx) // dlayout.pad_group),
                     dlayout.pad_group)
    same = real[1:] & real[:-1] & (g_id[1:] == g_id[:-1])
    # without shuffling, within-group sources would be sorted ascending
    asc = (np.diff(gidx.astype(np.int64)) > 0)[same]
    assert asc.mean() < 0.9


@pytest.mark.parametrize("n", [N, 3000, 5000])
def test_layout_structure_matches_reference(n):
    """n_out, run_quantum, real_per_column and every particle's bucket
    equal the reference's device build on the same positions (3,000 and
    5,000 exercise the capacity padding)."""
    ps = _ps(n, 1337 if n == N else 7)
    port = morton_device.build_presorted_device(torch.from_numpy(ps))
    ref = r_md.build_presorted_device(ps)
    _invariants(port, n)
    assert (port.n_out, port.run_quantum, port.pad_group) == \
        (ref.n_out, ref.run_quantum, ref.pad_group)
    np.testing.assert_array_equal(port.real_per_column, ref.real_per_column)

    def per_particle(gidx, buckets):
        real = gidx < n
        out = np.empty(n, np.int32)
        out[gidx[real]] = buckets[real]
        return out

    np.testing.assert_array_equal(
        per_particle(port.gidx.numpy(), port.buckets.numpy()),
        per_particle(np.asarray(ref.gidx), np.asarray(ref.buckets)))


def test_apply_and_carried_layout(snap):
    """``apply`` gathers source rows (pads take the fill), and the
    reference's layout carried across applies as the reference's does."""
    ps, values = snap
    ref = r_md.build_presorted_device(ps)
    layout = convert.device_layout_from_reference(ref, "cpu")
    got = layout.apply(torch.from_numpy(ps), fill=morton.PAD_POS).numpy()
    np.testing.assert_array_equal(got, np.asarray(ref.apply(
        ps, fill=morton.PAD_POS)))
    gidx = layout.gidx.numpy()
    real = gidx < len(ps)
    assert np.all(got[~real] == morton.PAD_POS)
    np.testing.assert_array_equal(
        layout.apply(torch.from_numpy(values)).numpy(),
        np.asarray(ref.apply(values)))


def test_candidate_slots_on_the_device_layout(snap):
    """The giant pool of a device layout (real slots are gidx < n_real)
    equals the reference's on the same layout and the host branch's on
    the host layout's gather form."""
    ps = snap[0]
    ref = r_md.build_presorted_device(ps)
    got = splat_giant.candidate_slots(
        convert.device_layout_from_reference(ref, "cpu"))
    for a, b in zip(got, r_giant.candidate_slots(ref)):
        np.testing.assert_array_equal(a, b)
    host = morton.build_presorted(ps)
    for a, b in zip(splat_giant.candidate_slots(
            convert.device_layout_from_host(host, "cpu")),
            splat_giant.candidate_slots(host)):
        np.testing.assert_array_equal(a, b)


def test_device_image_matches_host(snap, dlayout):
    """The device layout renders the host layout's image (EXPORT through
    ``splat_atlas_fields``): sum within rel 1e-3, correlation > 0.9999,
    nothing dropped."""
    ps, values = snap
    resolution, scale = 128, 120.0
    matrix = camera.world_to_clip_matrix(np.eye(3), np.zeros(3),
                                         scale).astype(np.float32)
    images = []
    for st in (convert.state_from_layout(dlayout, torch.from_numpy(ps),
                                         torch.from_numpy(values)),
               convert.state_from_reference(morton.build_presorted(ps), ps,
                                            values, "cpu")):
        im, dropped = splat_atlas.splat_atlas_fields(
            st["fields"], st["values_cm"], matrix, resolution,
            np.float32(scale), st["group_buckets"])
        assert int(dropped) == 0
        images.append(im.numpy())
    im_d, im_h = images
    assert im_d[..., 0].sum() == pytest.approx(im_h[..., 0].sum(), rel=1e-3)
    assert np.corrcoef(im_d[..., 0].ravel(),
                       im_h[..., 0].ravel())[0, 1] > 0.9999


def test_store_presorts_on_the_device():
    """The store builds its layout on the device from the positions it
    holds, and its presorted arrays are that layout's gathers."""
    loader = TestDataLoader(5000, seed=7)
    store = ParticleStore(loader, device="cpu")
    store.ensure_presorted()
    layout = store.presorted_layout
    assert isinstance(layout, morton_device.DevicePresortedLayout)
    ps = loader.get_pos_smooth().astype(np.float32)
    np.testing.assert_array_equal(
        store.pos_smooth_presorted.numpy(),
        layout.apply(torch.from_numpy(ps), fill=morton.PAD_POS).numpy())
    np.testing.assert_array_equal(store.presorted_buckets.numpy(),
                                  layout.buckets.numpy())


def test_store_falls_back_to_host_presort(monkeypatch, caplog):
    """More runs than R_CAP: the device build returns None (logged), the
    store falls back to the host presort (logged), builds no mip tier and
    renders from it."""
    from topsy_tpu_torch.drawreason import DrawReason
    from topsy_tpu_torch.render.sph import SPHRenderer
    monkeypatch.setattr(morton_device, "R_CAP", 4)
    loader = TestDataLoader(5000, seed=7)
    store = ParticleStore(loader, device="cpu")
    with caplog.at_level(logging.WARNING):
        store.ensure_presorted()
    assert "Device presort fallback" in caplog.text
    assert "host presort fallback" in caplog.text
    layout = store.presorted_layout
    assert isinstance(layout, morton.PresortedLayout)
    host = morton.build_presorted(loader.get_pos_smooth().astype(np.float32))
    assert layout.n_out == host.n_out
    np.testing.assert_array_equal(layout.dst, host.dst)
    assert store.ensure_column_mips() == []
    sph = SPHRenderer(store, loader.get_render_progression(), 64)
    sph.render(DrawReason.CHANGE)
    assert sph.last_column_ranges == [(0, layout.pad_group)]
    assert np.isfinite(sph.get_image()).all()


def test_device_loader_distribution():
    """TestDataDeviceLoader on the CPU: its component blocks hold exactly
    TestDataLoader's counts; the smoothing and the quantity are the
    formulas of its positions (exactly, restated here in float32, and the
    smoothing within rel 1e-5 of TestDataLoader's float64 density); each
    component's mean and standard deviation lie within 5 sigma of their
    sampling error; the draw is seeded."""
    n = 200_000
    loader = TestDataDeviceLoader(n, seed=1337, device="cpu")
    dev = loader.device_arrays()
    ps = dev["pos_smooth"]
    assert ps.shape == (n, 4) and ps.dtype == torch.float32
    pos = ps[:, :3]
    w = (0.5, 0.4, 0.1)
    means = np.array([[0.0, 0.0, 0.0], [0.0, 0.0, 0.0], [6.0, 10.0, 0.0]])
    stds = np.array([[20.0, 20.0, 20.0], [4.0, 0.2, 4.0], [2.0, 2.0, 3.0]])
    n0, n1 = int(n * w[0]), int(n * w[1])
    host = TestDataLoader(n, seed=1337)
    for (a, b), mean, std in zip(((0, n0), (n0, n0 + n1), (n0 + n1, n)),
                                 means, stds):
        x = pos[a:b].double().numpy()
        m = b - a
        assert np.all(np.abs(x.mean(axis=0) - mean) <= 5 * std / np.sqrt(m))
        assert np.all(np.abs(x.std(axis=0) - std)
                      <= 5 * std / np.sqrt(2 * m))
    den = torch.zeros(n)
    for wi, mean, std in zip(w, means, stds):
        norm = float((2 * np.pi) ** 1.5
                     * np.prod(np.float32(std).astype(np.float64)))
        d2 = (pos - torch.tensor(mean, dtype=torch.float32)) ** 2 \
            / torch.tensor(std, dtype=torch.float32) ** 2
        den = den + wi * torch.exp(-torch.sum(d2, dim=1)) / norm
    assert torch.equal(ps[:, 3], 2.0 / (den * n) ** 0.333333)
    np.testing.assert_allclose(
        ps[:, 3].numpy(),
        2.0 / host._evaluate_density(pos.numpy()) ** 0.333333, rtol=1e-5)
    assert torch.equal(dev["quantities"]["test-quantity"],
                       torch.sin(pos[:, 0]) * torch.cos(pos[:, 1])
                       * torch.cos(pos[:, 2]) * 1e-4)
    assert torch.equal(dev["mass"], torch.full((n,), 1e-8))
    np.testing.assert_array_equal(loader.get_positions(), pos.numpy())
    again = TestDataDeviceLoader(n, seed=1337, device="cpu")
    assert torch.equal(again.device_arrays()["pos_smooth"], ps)
    other = TestDataDeviceLoader(n, seed=7, device="cpu")
    assert not torch.equal(other.device_arrays()["pos_smooth"], ps)


def test_store_adopts_device_arrays():
    """The store adopts a device loader's tensors in place (no copy), and
    refuses tensors on another device than its own."""
    loader = TestDataDeviceLoader(5000, seed=7, device="cpu")
    store = ParticleStore(loader, device="cpu")
    assert store.pos_smooth is loader.device_arrays()["pos_smooth"]
    store.quantity_name = "test-quantity"
    vals = store.values_for("mass_and_quantity")
    dev = loader.device_arrays()
    assert torch.equal(vals[:, 1],
                       dev["mass"] * dev["quantities"]["test-quantity"])
    store.ensure_presorted()
    assert isinstance(store.presorted_layout,
                      morton_device.DevicePresortedLayout)
    with pytest.raises(ValueError):
        ParticleStore(loader, device="meta")
