"""The port's smoothing lengths and array / pynbody entry points against
the reference's: the multigrid estimate (``ops/knn.py``), the exact device
kNN (``ops/knn_device.py``, run on the CPU here) against the reference's,
a KD-tree and the native host kNN on tests/test_knn_native.py's scenes,
``ArrayDataLoader`` with given and with computed smoothing, and the pynbody
loaders and ``load()`` through one ``sys.modules["pynbody"]`` stub shared
by both packages.

Tolerances: the exact kNN within rel 1e-4 of the KD-tree and the
reference (tests/test_knn_native.py:135), 1e-5 on the brute-force path
(:162); the multigrid estimate within rel 1e-5 of the reference's (the
same float32 arithmetic, histogram sums in another order); the loaders'
arrays equal."""

import os
import sys
import types

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from topsy_tpu import loaders as r_loaders
from topsy_tpu.ops import knn as r_knn
from topsy_tpu.ops import knn_device as r_knn_device

from topsy_tpu_torch import loaders as p_loaders
from topsy_tpu_torch import native as p_native
from topsy_tpu_torch.ops import knn as p_knn
from topsy_tpu_torch.ops import knn_device as p_knn_device

# the reference's native kNN, loaded before any comparison (see the module)
from reference_native import reference_native_loaded  # noqa: E402,F401

torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))


def _kdtree_h(pos, nn):
    d, _ = cKDTree(pos).query(pos, k=nn + 1)
    return 0.5 * d[:, -1]


def _rel(a, b):
    return float((np.abs(a - b) / np.maximum(b, 1e-30)).max())


@pytest.fixture(scope="module")
def clustered():
    """tests/test_knn_native.py:135's scene: 3 decades of density
    contrast."""
    rng = np.random.RandomState(5)
    pos = rng.normal(0, 1, (20000, 3)).astype(np.float32)
    pos[:4000] *= 0.02
    return pos


def test_multigrid_estimate_matches_reference():
    loader = r_loaders.TestDataLoader(30000, seed=7)
    pos = loader.get_positions().astype(np.float32)
    got = p_knn.smoothing_lengths(pos, n_neighbors=32, device="cpu").numpy()
    ref = np.asarray(r_knn.smoothing_lengths(pos, n_neighbors=32))
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert _rel(got, ref) < 1e-5


def test_device_knn_exact_clustered(clustered):
    """Exact against the KD-tree, the reference's device kNN and the
    native host kNN; the tile budget of the reference's test."""
    h = p_knn_device.knn_smooth_device(clustered, 32, initial_tiles=96,
                                       device="cpu").numpy()
    assert _rel(h, _kdtree_h(clustered, 32)) < 1e-4
    ref = np.asarray(r_knn_device.knn_smooth_device(clustered, 32,
                                                    initial_tiles=96))
    assert _rel(h, ref) < 1e-4
    native = p_native.knn_smooth(clustered, 32)
    if native is not None:
        assert _rel(h, native) < 1e-4


def test_device_knn_finishing_pass_exact(clustered):
    """A tile budget of 4 leaves many queries unproven: the finishing pass
    makes them exact, at 64 neighbours (the array loader's default)."""
    h, stats = p_knn_device.knn_smooth_device_stats(
        clustered, 64, initial_tiles=4, device="cpu")
    h = h.numpy()
    assert stats["finishing"] > 0 and stats["selected_blocks"] > 0
    assert _rel(h, _kdtree_h(clustered, 64)) < 1e-4


def test_device_knn_exact_at_small_length_scale(clustered):
    """Positions on a 1e-5 scale (squared distances ~1e-14) with queries in
    the finishing pass: the flag in the sign keeps the bound exact (-kth,
    where the reference's -(kth + 1) rounds kth away)."""
    pos = clustered * np.float32(1e-5)
    h, stats = p_knn_device.knn_smooth_device_stats(pos, 32, initial_tiles=8,
                                                    device="cpu")
    h = h.numpy()
    assert stats["finishing"] > 0
    assert _rel(h, _kdtree_h(pos, 32)) < 1e-4


@pytest.mark.parametrize("step_elems", [1 << 26, 1 << 22, 1 << 20],
                         ids=["one_step", "batched_blocks", "split_blocks"])
def test_finishing_pass_equals_full_brute_force(clustered, monkeypatch,
                                                step_elems):
    """The finishing pass over flagged queries (every 3rd slot, loose
    bounds) equals the nn-th distance over every particle, bit for bit,
    whether its blocks share one launch, are batched over several, or
    (STEP_ELEMS under one block's relevant tiles) stream their tiles past
    a running top-nn; the last block is padded."""
    monkeypatch.setattr(p_knn_device, "STEP_ELEMS", step_elems)
    pos = torch.from_numpy(clustered)
    n = pos.shape[0]
    npad = -(-n // p_knn_device.BRUTE_CHUNK) * p_knn_device.BRUTE_CHUNK
    srt = torch.cat([pos[p_knn_device.morton_order(pos)],
                     torch.full((npad - n, 3), 1e19)])
    uidx = torch.arange(0, n, 3)
    d2 = p_knn_device._sq_dist(srt[uidx], srt[:n])
    d2[torch.arange(uidx.numel()), uidx] = p_knn_device.BIG
    exact = torch.topk(d2, 32, dim=1, largest=False).values[:, -1]
    got = p_knn_device._brute_kth_d2(srt, uidx, 4.0 * exact, nn=32,
                                     n_real=n)
    assert uidx.numel() % p_knn_device.BLOCK
    torch.testing.assert_close(got, exact, rtol=0, atol=0)


def test_device_knn_brute_force_small():
    """tests/test_knn_native.py:162: n <= BLOCK is brute-forced."""
    rng = np.random.RandomState(6)
    pos = rng.normal(0, 1, (400, 3)).astype(np.float32)
    h = p_knn_device.knn_smooth_device(pos, 32, device="cpu").numpy()
    assert _rel(h, _kdtree_h(pos, 32)) < 1e-5
    ref = np.asarray(r_knn_device.knn_smooth_device(pos, 32))
    assert _rel(h, ref) < 1e-5


def test_morton_order_matches_reference(clustered):
    ref = np.asarray(r_knn_device._morton_order(clustered))
    got = p_knn_device.morton_order(torch.from_numpy(clustered)).numpy()
    np.testing.assert_array_equal(got, ref)


def _array_loaders(smooth, **kw):
    rng = np.random.RandomState(11)
    pos = rng.normal(0, 5, (6000, 3)).astype(np.float32)
    mass = rng.uniform(0.5, 1.5, 6000).astype(np.float32)
    qty = {"temp": rng.uniform(1, 2, 6000).astype(np.float32)}
    rgb = rng.uniform(0, 1, (6000, 3)).astype(np.float32)
    h = None if not smooth else rng.uniform(0.1, 0.3, 6000).astype(
        np.float32)
    args = dict(mass=mass, smooth=h, quantities=qty, rgb_masses=rgb, **kw)
    return (_seeded(r_loaders.ArrayDataLoader, pos, **args),
            _seeded(p_loaders.ArrayDataLoader, pos, device="cpu", **args))


def _seeded(make, *args, **kw):
    """The within-cell shuffle draws from numpy's global generator: both
    packages' loaders are built from the same state."""
    np.random.seed(1)
    return make(*args, **kw)


@pytest.mark.parametrize("smooth", [True, False],
                         ids=["given_smoothing", "computed_smoothing"])
def test_array_loader_matches_reference(smooth):
    """Off the card both packages compute missing smoothing lengths with
    the native host kNN: every array equal."""
    ref, port = _array_loaders(smooth)
    assert len(port) == len(ref)
    for get in ("get_positions", "get_smooth", "get_mass", "get_rgb_masses",
                "get_pos_smooth", "get_cell_ids"):
        np.testing.assert_array_equal(getattr(port, get)(),
                                      getattr(ref, get)())
    np.testing.assert_array_equal(port.get_named_quantity("temp"),
                                  ref.get_named_quantity("temp"))
    assert port.get_quantity_names() == ref.get_quantity_names()
    assert port.get_initial_view_width() == ref.get_initial_view_width()
    assert port.get_cell_layout().get_num_cells() == \
        ref.get_cell_layout().get_num_cells()


def test_array_loader_routes_cuda_to_device_knn(monkeypatch):
    """On a CUDA device whose free memory holds the device kNN's bound the
    missing smoothing lengths come from the device kNN, and its failure
    raises; below the bound, from the native host kNN."""
    calls = []

    def fake(positions, nn, device):
        calls.append((len(positions), nn, torch.device(device).type))
        raise RuntimeError("device kNN failed")

    free = [p_knn_device.device_bytes(700)]
    monkeypatch.setattr(p_knn_device, "knn_smooth_device", fake)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device: (free[0], 80 << 30))
    pos = np.random.RandomState(0).normal(size=(700, 3)).astype(np.float32)
    with pytest.raises(RuntimeError, match="device kNN failed"):
        p_loaders.ArrayDataLoader(pos, device="cuda")
    assert calls == [(700, 64, "cuda")]
    free[0] -= 1
    loader = p_loaders.ArrayDataLoader(pos, device="cuda", with_cells=False)
    assert len(calls) == 1       # over the bound: the native host kNN
    ref = p_native.knn_smooth(pos, 64)
    if ref is not None:
        np.testing.assert_array_equal(loader.get_smooth(), ref)


class _Units:
    def __init__(self, s):
        self._s = s

    def __str__(self):
        return self._s

    def latex(self):
        return "" if self._s == "1" else r"\mathrm{" + self._s + "}"

    def in_units(self, _):
        return 50.0


class _Arr(np.ndarray):
    pass


def _arr(a, units):
    out = np.asarray(a).view(_Arr)
    out.units = _Units(units)
    return out


class _Snap:
    """What the loaders read of a pynbody snapshot."""

    def __init__(self, n, seed):
        rng = np.random.RandomState(seed)
        self._d = {"pos": _arr(rng.normal(0, 10, (n, 3)), "kpc"),
                   "mass": _arr(rng.uniform(1, 2, n), "Msol"),
                   "smooth": _arr(rng.uniform(0.2, 1, n), "kpc"),
                   "temp": _arr(rng.uniform(1e3, 1e5, (n, 1)), "K"),
                   "I_mag": _arr(rng.uniform(-5, 5, n), "1"),
                   "V_mag": _arr(rng.uniform(-5, 5, n), "1"),
                   "U_mag": _arr(rng.uniform(-5, 5, n), "1")}
        self.properties = {"boxsize": _Units("kpc")}
        self.filename = "snap.stub"
        self.ancestor = self

    def __len__(self):
        return len(self._d["pos"])

    def __getitem__(self, key):
        if isinstance(key, str):
            return self._d[key]
        return self                      # a family selection

    def __setitem__(self, key, value):
        self._d[key] = _arr(value, "kpc")

    def loadable_keys(self):
        return sorted(self._d)

    def physical_units(self, *args):
        pass


@pytest.fixture
def pynbody_stub(monkeypatch, tmp_path):
    """One pynbody stand-in for both packages: ``load`` returns a seeded
    snapshot, ``sph.smooth`` its smoothing; the smoothing cache lands
    in a temporary directory."""
    stub = types.ModuleType("pynbody")
    stub.load = lambda filename, **kw: _Snap(3000, 3)
    stub.family = types.SimpleNamespace(
        get_family=lambda name: types.SimpleNamespace(name=name))
    stub.sph = types.SimpleNamespace(
        smooth=lambda snap: np.asarray(snap["smooth"]) * 2.0)
    stub.filt = types.SimpleNamespace(Sphere=lambda *a: ("sphere", a))
    monkeypatch.setitem(sys.modules, "pynbody", stub)
    monkeypatch.chdir(tmp_path)
    return stub


def _same_loader(ref, port, quantity):
    for get in ("get_positions", "get_smooth", "get_mass", "get_rgb_masses",
                "get_cell_ids"):
        np.testing.assert_array_equal(getattr(port, get)(),
                                      getattr(ref, get)())
    np.testing.assert_array_equal(port.get_named_quantity(quantity),
                                  ref.get_named_quantity(quantity))
    assert port.get_quantity_label(quantity) == \
        ref.get_quantity_label(quantity)
    assert port.get_periodicity_scale() == ref.get_periodicity_scale()
    assert port.get_initial_view_width() == ref.get_initial_view_width()
    assert port.get_position_units() == ref.get_position_units()


def test_pynbody_loaders_match_reference(pynbody_stub):
    snap = _Snap(3000, 3)
    _same_loader(_seeded(r_loaders.PynbodyDataInMemory, snap),
                 _seeded(p_loaders.PynbodyDataInMemory, snap), "temp")
    ref = _seeded(r_loaders.PynbodyDataLoader, "snap.stub", "none", "gas")
    port = _seeded(p_loaders.PynbodyDataLoader, "snap.stub", "none", "gas")
    _same_loader(ref, port, "temp")
    np.testing.assert_array_equal(port.get_initial_center(), np.zeros(3))


def test_load_and_topsy_entry_points(pynbody_stub):
    import topsy_tpu_torch
    from topsy_tpu_torch.canvas import OffscreenCanvas
    vis = topsy_tpu_torch.load("snap.stub", particle="gas", resolution=32,
                               device="cpu", canvas_class=OffscreenCanvas)
    assert isinstance(vis.data_loader, p_loaders.PynbodyDataLoader)
    assert vis.get_sph_image().shape == (32, 32)
    vis = topsy_tpu_torch.topsy(_Snap(2000, 4), quantity="temp",
                                render_resolution=32, device="cpu",
                                canvas_class=OffscreenCanvas)
    assert isinstance(vis.data_loader, p_loaders.PynbodyDataInMemory)
    assert vis.quantity_name == "temp"
    raw = vis._sph.get_image()
    assert np.isfinite(raw).all() and raw[..., 0].sum() > 0
