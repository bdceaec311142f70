"""The port's particle mesh (``topsy_tpu_torch/parallel``) against the
reference's, mirroring tests/test_parallel.py on its 6,000-particle scene
at 64^2 and scale 200.

The reference runs on the suite's 8 virtual CPU devices
(``DistributedSplatter(make_mesh(8))``), the port on 8 CPU shards
(``make_mesh(8, devices=["cpu"] * 8)``).  The strided block path
(``render``) is compared as it stands; the presorted paths on one layout,
the reference's carried across (``convert.splatter_layout_from_reference``),
with the reference's feed path forced (``_force_feed``: off the TPU its
mesh steps otherwise take the feed-off engine, tests/test_parallel.py:
258-285).  Additive images are held at the cross-engine bounds of
tests/test_splat_fields.py:75-78 (sum rel 1e-3, largest pixel difference
<= 1% of the maximum, correlation > 0.9999) with equal ``dropped``; the
surface at coverage flips <= 1e-4 of the covered pixels and values equal
on >= 99.9% of them.  The port alone: strided sharding, shard-count
invariance at D = 1, 2 and 8, ``from_process_local`` in one process, the
padded-length validation, the depth arg-max combine and each shard's
launches inside its device guard."""

import contextlib
import os

import numpy as np
import pytest
import torch

from topsy_tpu import camera
from topsy_tpu.loaders import TestDataLoader
from topsy_tpu.parallel import DistributedSplatter as RefSplatter
from topsy_tpu.parallel import make_mesh as ref_mesh
from topsy_tpu.parallel import strided_shard as ref_strided
from topsy_tpu.parallel import unstride as ref_unstride

from topsy_tpu_torch import convert
from topsy_tpu_torch.ops import splat_accum, splat_feed, zsplat_atlas
from topsy_tpu_torch.parallel import (DistributedSplatter, make_mesh,
                                      render_step, strided_shard, unstride)

# one process's share of the cores when pytest-xdist runs several workers
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

RES = 64
SCALE = 200.0
NSIDE = 4


def cpu_mesh(d):
    return make_mesh(d, devices=["cpu"] * d)


@pytest.fixture(scope="module")
def data():
    loader = TestDataLoader(6000, seed=3)
    ps = loader.get_pos_smooth()
    mass = loader.get_mass()
    qty = loader.get_named_quantity("test-quantity")
    vals = np.stack([mass, mass * qty], axis=1)
    matrix = camera.world_to_clip_matrix(np.eye(3), np.zeros(3), SCALE)
    lo = ps[:, :3].min()
    hi = ps[:, :3].max() + 1e-3
    cell = ((ps[:, :3] - lo) / (hi - lo) * NSIDE).astype(np.int32)
    cell_ids = (cell[:, 0] * NSIDE + cell[:, 1]) * NSIDE + cell[:, 2]
    cell_mask = np.random.RandomState(5).random_sample(NSIDE ** 3) < 0.5
    return ps, vals, matrix, cell_ids, cell_mask


@pytest.fixture(scope="module")
def ref(data):
    """The reference's 8-device splatter and its images: the strided block
    path (whole, an LOD prefix, culled), and on its presorted layout with
    the feed path the presorted EXPORT (giants exact in-call, and culled),
    a column slice with a giant threshold and the full-width surface
    column launch."""
    ps, vals, matrix, cell_ids, cell_mask = data
    sp = RefSplatter(ref_mesh(8), ps, vals, RES, cell_ids=cell_ids)
    out = {"splatter": sp,
           "block": np.asarray(sp.render(matrix, SCALE)),
           "prefix": np.asarray(sp.render(matrix, SCALE, 0, 2000)),
           "block_culled": np.asarray(sp.render(matrix, SCALE,
                                                cell_mask=cell_mask))}
    sp.ensure_presorted()
    sp._force_feed = True
    for key, kw in (("pre", {}), ("pre_culled", {"cell_mask": cell_mask})):
        im, d = sp.render_presorted(matrix, SCALE, **kw)
        out[key] = (np.asarray(im), int(d))
    im, d = sp.render_columns(matrix, SCALE, 128, 128, giant_bucket=3)
    out["cols"] = (np.asarray(im), int(d))
    im, d = sp.render_columns_surface(matrix, SCALE, 0.0, 0,
                                      sp.presorted_layout.pad_group)
    out["surface"] = (np.asarray(im), int(d))
    return out


@pytest.fixture(scope="module")
def port(data, ref):
    """The port's 8-shard splatter with the reference's layout."""
    ps, vals, _, cell_ids, _ = data
    sp = DistributedSplatter(cpu_mesh(8), ps, vals, RES, cell_ids=cell_ids)
    convert.splatter_layout_from_reference(sp, ref["splatter"])
    return sp


def assert_images_agree(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    for c in range(want.shape[-1]):
        a, b = got[..., c], want[..., c]
        assert a.sum() == pytest.approx(b.sum(), rel=1e-3), c
        assert np.abs(a - b).max() <= 0.01 * np.abs(b).max(), c
        assert np.corrcoef(a.ravel(), b.ravel())[0, 1] > 0.9999, c


@pytest.mark.parametrize("n,d", [(23, 4), (6000, 8), (7, 8), (10, 1)])
def test_strided_shard_matches_reference(n, d):
    """test_parallel.py::test_strided_shard_roundtrip, against the
    reference's functions, for numpy arrays and torch tensors."""
    arr = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    want = ref_strided(arr, d)
    np.testing.assert_array_equal(strided_shard(arr, d), want)
    np.testing.assert_array_equal(
        strided_shard(torch.from_numpy(arr), d).numpy(), want)
    np.testing.assert_array_equal(unstride(want), ref_unstride(want))
    np.testing.assert_array_equal(
        unstride(torch.from_numpy(want)).numpy(), ref_unstride(want))
    assert np.all(unstride(want)[:n] == arr)


def test_shard_count_invariance(data):
    """test_parallel.py::test_shard_count_invariance: the port's block path
    at D = 1, 2 and 8."""
    ps, vals, matrix = data[:3]
    images = {d: DistributedSplatter(cpu_mesh(d), ps, vals, RES)
              .render(matrix, SCALE).numpy() for d in (1, 2, 8)}
    for d in (2, 8):
        np.testing.assert_allclose(images[d], images[1], rtol=1e-4,
                                   atol=1e-12 + 1e-6 * np.abs(images[1]).max())


def test_block_render_matches_reference(data, ref, port):
    """The strided block path (``render``): the whole snapshot and an LOD
    prefix, against the reference's mesh."""
    matrix = data[2]
    assert_images_agree(port.render(matrix, SCALE).numpy(), ref["block"])
    im = port.render(matrix, SCALE, 0, 2000).numpy()
    assert_images_agree(im, ref["prefix"])
    assert 0 < im[..., 0].sum() < ref["block"][..., 0].sum()


def test_render_presorted_matches_reference(data, ref, port):
    im, d = port.render_presorted(data[2], SCALE)
    assert_images_agree(im.numpy(), ref["pre"][0])
    assert int(d) == ref["pre"][1]


def test_render_columns_matches_reference(data, ref, port):
    """A 128-column slice with a giant bucket threshold (the interactive
    path's call) against the reference's feed column step."""
    im, d = port.render_columns(data[2], SCALE, 128, 128, giant_bucket=3)
    assert_images_agree(im.numpy(), ref["cols"][0])
    assert int(d) == ref["cols"][1]


def test_render_columns_surface_matches_reference(data, ref, port):
    """The surface column launch at the lowest cut (every particle):
    per-shard K3 plain versions, then the depth arg-max combine."""
    G = port.presorted_layout.pad_group
    got, d = port.render_columns_surface(data[2], SCALE, 0.0, 0, G)
    got = got.numpy()
    want, d_ref = ref["surface"]
    cov_g, cov_w = got[..., 1] > 0, want[..., 1] > 0
    assert cov_w.mean() > 0.01
    assert (cov_g != cov_w).sum() <= 1e-4 * cov_w.sum()
    both = cov_g & cov_w
    np.testing.assert_allclose(got[..., 1][both], want[..., 1][both],
                               rtol=1e-5, atol=1e-4)
    assert np.isclose(got[..., 0][both], want[..., 0][both], rtol=1e-5,
                      atol=1e-6).mean() >= 0.999
    assert int(d) == d_ref


def test_cell_culling_matches_reference(data, ref, port):
    """Cell culling on the block path (the per-shard table gather) and on
    the presorted slabs (the per-slab feed mask)."""
    matrix, cell_mask = data[2], data[4]
    assert_images_agree(port.render(matrix, SCALE,
                                    cell_mask=cell_mask).numpy(),
                        ref["block_culled"])
    im, d = port.render_presorted(matrix, SCALE, cell_mask=cell_mask)
    assert_images_agree(im.numpy(), ref["pre_culled"][0])
    assert int(d) == ref["pre_culled"][1]
    assert im[..., 0].sum() < 0.9 * ref["pre"][0][..., 0].sum()


@contextlib.contextmanager
def one_thread():
    """Bit-for-bit comparisons run on one thread: the plain deposit's
    multi-threaded accumulation order varies from run to run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _process_local(ps, vals, d, **kw):
    """``from_process_local`` in one process: the local rows are all rows,
    in strided (shard-major) order."""
    local_pos = strided_shard(ps.astype(np.float32), d).reshape(-1, 4)
    local_vals = strided_shard(vals.astype(np.float32), d).reshape(
        -1, vals.shape[1])
    return DistributedSplatter.from_process_local(
        cpu_mesh(d), local_pos, local_vals, RES, len(ps), **kw)


def test_from_process_local_matches_standard(data):
    """test_parallel.py::test_from_process_local_matches_standard and
    ::test_from_process_local_presorted: the same shards give the block
    path bit for bit; the process's own layout gives the presorted image
    within summation order."""
    ps, vals, matrix = data[:3]
    std = DistributedSplatter(cpu_mesh(8), ps, vals, RES)
    pl = _process_local(ps, vals, 8)
    assert pl.n_cells == 1 and pl.supports_presorted()
    with one_thread():
        np.testing.assert_array_equal(pl.render(matrix, SCALE).numpy(),
                                      std.render(matrix, SCALE).numpy())
    im_std, d_std = std.render_presorted(matrix, SCALE)
    im_pl, d_pl = pl.render_presorted(matrix, SCALE)
    assert int(d_pl) == int(d_std) == 0
    np.testing.assert_allclose(im_pl.numpy(), im_std.numpy(), rtol=1e-3,
                               atol=1e-5 * float(im_std.abs().max()))
    half = pl.render(matrix, SCALE, 0, len(ps) // 2).numpy()
    assert 0 < half[..., 0].sum() < im_std.numpy()[..., 0].sum()


def test_from_process_local_padded_len(data):
    """test_parallel.py::test_from_process_local_padded_len_validation: an
    invalid agreed length raises; a longer valid one pads with inactive
    groups and leaves the image unchanged."""
    ps, vals, matrix = data[:3]
    with pytest.raises(ValueError, match="padded_local_len"):
        _process_local(ps, vals, 8).ensure_presorted(padded_local_len=4097)
    a = _process_local(ps, vals, 8)
    a.ensure_presorted()
    natural = a._presorted["local_n"]
    assert natural == a.natural_local_len
    b = _process_local(ps, vals, 8)
    b.ensure_presorted(padded_local_len=natural + 4096)
    assert b._presorted["local_n"] == natural + 4096
    np.testing.assert_allclose(b.render_presorted(matrix, SCALE)[0].numpy(),
                               a.render_presorted(matrix, SCALE)[0].numpy(),
                               rtol=1e-5, atol=1e-7)


def test_combine_depth_argmax():
    """The surface combine: the largest depth wins; among shards holding
    it the larger payload; ``dropped`` summed as a tensor."""
    mesh = cpu_mesh(3)
    depth = torch.tensor([[1.0, 2.0], [3.0, 2.0], [0.5, 2.0]])
    value = torch.tensor([[10.0, 7.0], [20.0, 9.0], [30.0, 8.0]])
    parts = [(torch.stack([value[k], depth[k]], -1)[None],
              torch.tensor(k)) for k in range(3)]
    image, dropped = render_step.combine(parts, mesh, mode="depth_argmax")
    assert image.shape == (1, 2, 2)
    assert image[0, :, 1].tolist() == [3.0, 2.0]
    assert image[0, :, 0].tolist() == [20.0, 9.0]
    assert isinstance(dropped, torch.Tensor) and int(dropped) == 3
    total, _ = render_step.combine(parts, mesh)
    torch.testing.assert_close(total, sum(p[0] for p in parts))


def test_launch_device_guard(data, port, monkeypatch):
    """Every shard's kernel launches run inside ``device_guard`` of that
    shard's device, one guard per shard and path, none outside (a ctypes
    launch runs in the current device's context, so a second
    card needs it); the guard makes a CUDA device current."""
    matrix = data[2]
    events, current = [], []

    @contextlib.contextmanager
    def fake_guard(device):
        current.append(torch.device(device))
        events.append(("enter", torch.device(device)))
        try:
            yield
        finally:
            current.pop()

    def recording(name, fn):
        def call(*args, **kw):
            events.append((name, current[-1] if current else None))
            return fn(*args, **kw)
        return call

    monkeypatch.setattr(render_step, "device_guard", fake_guard)
    monkeypatch.setattr(splat_feed, "splat_feed",
                        recording("K1", splat_feed.splat_feed))
    monkeypatch.setattr(splat_accum, "accumulate_groups",
                        recording("K2", splat_accum.accumulate_groups))
    monkeypatch.setattr(zsplat_atlas, "accumulate_max_packed",
                        recording("K3", zsplat_atlas.accumulate_max_packed))
    G = port.presorted_layout.pad_group
    mesh = port.mesh
    for run, kinds in (
            (lambda: port.render(matrix, SCALE, 0, 3000), {"K2"}),
            (lambda: port.render_presorted(matrix, SCALE), {"K1", "K2"}),
            (lambda: port.render_columns(matrix, SCALE, 0, 64), {"K1", "K2"}),
            (lambda: port.render_columns_surface(matrix, SCALE, 0.0, 0, G),
             {"K3"})):
        events.clear()
        run()
        enters = [i for i, e in enumerate(events) if e[0] == "enter"]
        assert [events[i][1] for i in enters] == list(mesh.devices)
        assert enters[0] == 0
        for k, i in enumerate(enters):
            stop = enters[k + 1] if k + 1 < len(enters) else len(events)
            inside = events[i + 1:stop]
            assert {name for name, _ in inside} == kinds
            assert all(dev == mesh.devices[k] for _, dev in inside)

    monkeypatch.undo()
    entered = []

    class FakeCudaDevice:
        def __init__(self, device):
            entered.append(device)

    monkeypatch.setattr(torch.cuda, "device", FakeCudaDevice)
    assert isinstance(render_step.device_guard("cuda:1"), FakeCudaDevice)
    assert entered == [torch.device("cuda", 1)]
    assert isinstance(render_step.device_guard("cpu"),
                      contextlib.nullcontext)
