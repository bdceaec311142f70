"""Data loaders: host-side snapshot access.

A pinned copy of ``AbstractDataLoader``, ``TestDataLoader``,
``PynbodyDataInMemory``, ``PynbodyDataLoader`` and ``_import_pynbody``
from ``topsy_tpu/loaders.py`` (the loader contract, the seeded
Gaussian-mixture snapshot with the same numpy draws, seeds and constants,
and snapshot files through pynbody, imported only when one is loaded).
Arrays come back in the interleaved LOD order when cells are used
(``cells.CellLayout.interleave_order``).  ``TestDataDeviceLoader`` is the
counterpart of the reference's: the same mixture generated on the device
with torch, adopted in place by the store (``device_arrays``).
``ArrayDataLoader`` is the reference's, with the smoothing lengths it
computes on a CUDA device by the exact device kNN, and no quiet fallback
to the host when that fails.
"""

from __future__ import annotations

import logging
import pickle
from abc import ABC, abstractmethod

import numpy as np
import torch

from . import config
from .cells import CellLayout

logger = logging.getLogger(__name__)


class AbstractDataLoader(ABC):
    """Contract for particle data access (reference: loader.py:16-77)."""

    _cell_layout: CellLayout | None = None

    @abstractmethod
    def __len__(self):
        ...

    @abstractmethod
    def get_positions(self) -> np.ndarray:
        ...

    @abstractmethod
    def get_smooth(self) -> np.ndarray:
        ...

    @abstractmethod
    def get_mass(self) -> np.ndarray:
        ...

    @abstractmethod
    def get_named_quantity(self, name: str) -> np.ndarray:
        ...

    @abstractmethod
    def get_quantity_label(self, quantity_name):
        ...

    @abstractmethod
    def get_rgb_masses(self) -> np.ndarray:
        ...

    @abstractmethod
    def get_position_units(self) -> str:
        ...

    def get_quantity_names(self):
        return []

    def get_pos_smooth(self) -> np.ndarray:
        """Positions and smoothing packed as float32 (N, 4)."""
        pos_smooth = np.empty((len(self), 4), dtype=np.float32)
        pos_smooth[:, :3] = self.get_positions()
        pos_smooth[:, 3] = self.get_smooth()
        return pos_smooth

    def get_periodicity_scale(self):
        return np.inf

    def get_cell_layout(self) -> CellLayout | None:
        return self._cell_layout

    def get_cell_ids(self) -> np.ndarray | None:
        """Per-particle cell index (render order), or None without cells."""
        if self._cell_layout is None:
            return None
        return self._cell_layout.cell_ids_per_particle()[self._lod_order()]

    def _lod_order(self) -> np.ndarray:
        """Permutation from cell-sorted order to interleaved LOD order."""
        if getattr(self, "_interleave", None) is None:
            self._interleave = self._cell_layout.interleave_order()
        return self._interleave

    def get_render_progression(self):
        from . import progression
        if self._cell_layout is not None:
            return progression.RenderProgressionWithCells(self._cell_layout, len(self))
        return progression.RenderProgression(len(self))

    def get_initial_center(self) -> np.ndarray:
        return np.zeros(3, dtype=np.float32)

    def get_initial_view_width(self) -> float:
        period_scale = self.get_periodicity_scale()
        if period_scale is not None and np.isfinite(period_scale):
            return period_scale / 2
        return config.DEFAULT_SCALE

    def get_filename(self) -> str:
        return "data"

    def device_arrays(self) -> dict | None:
        """Optional device-resident snapshot for loaders that generate (or
        already hold) their data on the device: ``{'pos_smooth': (n, 4),
        'mass': (n,), 'quantities': {name: (n,)}}`` float32 tensors, and
        optionally ``'rgb'``: (n, 3) band masses (``get_rgb_masses``).  When
        non-None the ParticleStore adopts these tensors in place and never
        calls the host getters on the hot path (without ``'rgb'`` it
        uploads ``get_rgb_masses()`` once, where a mode reads the bands).
        Default None: the host numpy path."""
        return None


class TestDataLoader(AbstractDataLoader):
    """Seeded synthetic data: 3-component Gaussian mixture with analytic
    density and smoothing lengths (reference: loader.py:241-332)."""

    __test__ = False  # not a pytest class

    def __init__(self, n_particles: int = config.TEST_DATA_NUM_PARTICLES_DEFAULT,
                 n_cells: int = 10, seed: int = 1337, with_cells: bool = False,
                 periodic: bool = False):
        self._n_particles = int(n_particles)
        self._gmm_weights = [0.5, 0.4, 0.1]
        self._gmm_means = np.array([[0.0, 0.0, 0.0], [0.0, 0.0, 0.0], [6.0, 10.0, 0.0]])
        self._gmm_std = np.array([[20.0, 20.0, 20.0], [4.0, 0.2, 4.0], [2.0, 2.0, 3.0]])

        self._pos = self._generate_samples(seed)
        self._den = self._evaluate_density(self._pos)
        self._periodic = periodic

        if with_cells:
            self._cell_layout, ordering = CellLayout.from_positions(
                self._pos, self._pos.min() - 1e-3, self._pos.max() + 1, n_cells)
            order = ordering[self._lod_order()]
            self._pos = self._pos[order]
            self._den = self._den[order]

    def _generate_samples(self, seed: int) -> np.ndarray:
        np.random.seed(seed)
        n = self._n_particles
        pos = np.empty((n, 3), dtype=np.float32)
        if n == 1:
            pos[0] = self._gmm_means[0]
        else:
            offset = 0
            for i, weight in enumerate(self._gmm_weights):
                cpt_len = int(n * weight)
                if i == len(self._gmm_weights) - 1:
                    cpt_len = n - offset  # absorb rounding remainder
                samples = np.random.normal(size=(cpt_len, 3), scale=1.0).astype(np.float32)
                pos[offset:offset + cpt_len] = samples * self._gmm_std[np.newaxis, i, :] + self._gmm_means[i]
                offset += cpt_len
            assert offset == n
        return np.random.permutation(pos)

    def _evaluate_density(self, pos: np.ndarray) -> np.ndarray:
        """Analytic GMM number density, scaled to particles per unit volume."""
        den = np.zeros(len(pos))
        for i, weight in enumerate(self._gmm_weights):
            den += weight * np.exp(
                -np.sum((pos - self._gmm_means[i]) ** 2 / self._gmm_std[i] ** 2, axis=1)
            ) / ((2 * np.pi) ** 1.5 * np.prod(self._gmm_std[i]))
        return den * self._n_particles

    def __len__(self):
        return self._n_particles

    def get_positions(self):
        return self._pos

    def get_smooth(self):
        return (2.0 / self._den ** 0.333333).astype(np.float32)

    def get_mass(self):
        return np.repeat(np.float32(1e-8), self._n_particles)

    def get_named_quantity(self, name):
        if name == "test-quantity":
            p = self._pos
            return (np.sin(p[:, 0]) * np.cos(p[:, 1]) * np.cos(p[:, 2]) * 1e-4).astype(np.float32)
        raise KeyError("Unknown quantity name")

    def get_quantity_names(self):
        return ["test-quantity"]

    def get_quantity_label(self, quantity_name):
        if quantity_name is None:
            return r"test density / $M_{\odot} / \mathrm{kpc}^2$"
        if quantity_name == "test-quantity":
            return "test quantity"
        return "unknown"

    def get_position_units(self):
        return "kpc"

    def get_periodicity_scale(self):
        return 100.0 if self._periodic else None

    def get_rgb_masses(self):
        rgb = np.empty((self._n_particles, 3), dtype=np.float32)
        rgb[:, 0] = abs(np.sin(self._pos[:, 0] / 10.0))
        rgb[:, 1] = abs(np.cos(self._pos[:, 1] / 10.0))
        rgb[:, 2] = abs(np.cos(self._pos[:, 2] / 10.0))
        return rgb

    def get_filename(self):
        return "test data"


GMM_WEIGHTS = (0.5, 0.4, 0.1)
GMM_MEANS = ((0.0, 0.0, 0.0), (0.0, 0.0, 0.0), (6.0, 10.0, 0.0))
GMM_STD = ((20.0, 20.0, 20.0), (4.0, 0.2, 4.0), (2.0, 2.0, 3.0))


def test_data_device(n: int, seed: int = 1337, device="cuda"):
    """TestDataLoader's synthetic snapshot generated on ``device``.

    Returns float32 tensors (pos_smooth (n, 4), mass (n,), quantity (n,)):
    the same 3-component Gaussian mixture in contiguous component blocks
    (``int(n * w)`` particles for the first two), the analytic-density
    smoothing ``2 / den^0.333333`` and the test-quantity formula as
    TestDataLoader, drawn from a torch generator seeded with ``seed``.  The
    draw is not TestDataLoader's numpy stream (nor the reference's
    ``jax.random`` one); the distribution is the same.  Large-n helper: the
    blocks skip TestDataLoader's n == 1 special case."""
    if n < 16:
        raise ValueError("test_data_device is a large-n benchmark helper")
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    z = torch.randn((n, 3), generator=gen, device=dev)
    means = torch.tensor(GMM_MEANS, dtype=torch.float32, device=dev)
    stds = torch.tensor(GMM_STD, dtype=torch.float32, device=dev)
    n0, n1 = int(n * GMM_WEIGHTS[0]), int(n * GMM_WEIGHTS[1])
    comp = torch.full((n,), 2, dtype=torch.int64, device=dev)
    comp[:n0] = 0
    comp[n0:n0 + n1] = 1
    pos = z * stds[comp] + means[comp]
    smooth = 2.0 / _gmm_density(pos) ** 0.333333
    mass = torch.full((n,), 1e-8, dtype=torch.float32, device=dev)
    qty = (torch.sin(pos[:, 0]) * torch.cos(pos[:, 1]) * torch.cos(pos[:, 2])
           * 1e-4)
    return torch.cat([pos, smooth[:, None]], dim=1), mass, qty


def _gmm_density(pos: torch.Tensor) -> torch.Tensor:
    """The mixture's analytic number density at ``pos`` (n, 3), in
    particles per unit volume for n particles, in float32."""
    den = torch.zeros(pos.shape[0], dtype=torch.float32, device=pos.device)
    for w, mean, std in zip(GMM_WEIGHTS, GMM_MEANS, GMM_STD):
        norm = float((2 * np.pi) ** 1.5
                     * np.prod(np.float32(std).astype(np.float64)))
        m = torch.tensor(mean, dtype=torch.float32, device=pos.device)
        s2 = torch.tensor(std, dtype=torch.float32, device=pos.device) ** 2
        den = den + w * torch.exp(-torch.sum((pos - m) ** 2 / s2, dim=1)) / norm
    return den * pos.shape[0]


class TestDataDeviceLoader(AbstractDataLoader):
    """TestDataLoader's synthetic snapshot, generated and kept on the
    device (:func:`test_data_device`), through the standard loader contract
    plus :meth:`device_arrays` (the band masses of ``get_rgb_masses``
    included), which the ParticleStore adopts in place:
    the Visualizer's path runs without a snapshot byte crossing from the
    host.  The host getters read back from the device."""

    __test__ = False

    def __init__(self, n_particles: int, seed: int = 1337, device="cuda"):
        self._n_particles = int(n_particles)
        ps, mass, qty = test_data_device(self._n_particles, seed=seed,
                                         device=device)
        p = ps[:, :3]
        rgb = torch.stack([torch.abs(torch.sin(p[:, 0] / 10.0)),
                           torch.abs(torch.cos(p[:, 1] / 10.0)),
                           torch.abs(torch.cos(p[:, 2] / 10.0))], dim=1)
        self._dev = {"pos_smooth": ps, "mass": mass,
                     "quantities": {"test-quantity": qty}, "rgb": rgb}

    def device_arrays(self) -> dict:
        return self._dev

    def __len__(self):
        return self._n_particles

    def get_positions(self):
        return self._dev["pos_smooth"][:, :3].cpu().numpy()

    def get_smooth(self):
        return self._dev["pos_smooth"][:, 3].cpu().numpy()

    def get_mass(self):
        return self._dev["mass"].cpu().numpy()

    def get_named_quantity(self, name):
        if name == "test-quantity":
            return self._dev["quantities"]["test-quantity"].cpu().numpy()
        raise KeyError("Unknown quantity name")

    def get_quantity_names(self):
        return ["test-quantity"]

    def get_quantity_label(self, quantity_name):
        if quantity_name is None:
            return r"test density / $M_{\odot} / \mathrm{kpc}^2$"
        if quantity_name == "test-quantity":
            return "test quantity"
        return "unknown"

    def get_position_units(self):
        return "kpc"

    def get_rgb_masses(self):
        return self._dev["rgb"].cpu().numpy()

    def get_filename(self):
        return "test data (device)"


class ArrayDataLoader(AbstractDataLoader):
    """Loader for raw numpy arrays; no pynbody required.

    Smoothing lengths, when not given, are computed on a CUDA ``device``
    whose free memory holds the device kNN's bound
    (``knn_device.fits_device``) by the exact device kNN
    (``ops/knn_device.py``, pynbody's h = d_nn / 2); otherwise by the
    native host kNN (``native.knn_smooth``, also exact) or, without a
    compiler, the multigrid estimate (``ops/knn.py``).  A failure of the
    device kNN raises: it never continues quietly on the host.
    """

    def __init__(self, positions: np.ndarray, mass: np.ndarray | None = None,
                 smooth: np.ndarray | None = None,
                 quantities: dict[str, np.ndarray] | None = None,
                 rgb_masses: np.ndarray | None = None,
                 position_units: str = "kpc",
                 periodicity_scale: float | None = None,
                 with_cells: bool = True,
                 nside: int = config.DEFAULT_CELLS_NSIDE,
                 n_neighbors: int = 64, device="cuda"):
        positions = np.asarray(positions, dtype=np.float32)
        n = len(positions)
        if mass is None:
            mass = np.ones(n, dtype=np.float32)
        if smooth is None:
            dev = torch.device(device)
            from .ops import knn_device
            if dev.type == "cuda" and knn_device.fits_device(n, dev):
                smooth = knn_device.knn_smooth_device(
                    positions, n_neighbors, device=dev).cpu().numpy()
            else:
                if dev.type == "cuda":
                    logger.info("ArrayDataLoader: %d positions exceed the "
                                "device kNN's memory bound; the host kNN "
                                "computes the smoothing lengths", n)
                from . import native
                smooth = native.knn_smooth(positions, n_neighbors)
                if smooth is None:
                    from .ops.knn import smoothing_lengths
                    smooth = smoothing_lengths(
                        positions, n_neighbors,
                        device=dev).cpu().numpy()
        self._quantities = {k: np.asarray(v, dtype=np.float32)
                            for k, v in (quantities or {}).items()}
        self._rgb = rgb_masses
        self._position_units = position_units
        self._periodicity_scale = periodicity_scale

        order = np.arange(n)
        if with_cells and n > 0:
            lo = positions.min() - 1e-3
            hi = positions.max() + max(1e-3, 1e-5 * np.ptp(positions))
            self._cell_layout, ordering = CellLayout.from_positions(
                positions, lo, hi, nside)
            order = ordering[self._cell_layout.randomize_within_cells()][
                self._lod_order()]

        self._pos = positions[order]
        self._mass = np.asarray(mass, dtype=np.float32)[order]
        self._smooth = np.asarray(smooth, dtype=np.float32)[order]
        self._quantities = {k: v[order] for k, v in self._quantities.items()}
        if self._rgb is not None:
            self._rgb = np.asarray(self._rgb, dtype=np.float32)[order]

    def __len__(self):
        return len(self._pos)

    def get_positions(self):
        return self._pos

    def get_smooth(self):
        return self._smooth

    def get_mass(self):
        return self._mass

    def get_named_quantity(self, name):
        return self._quantities[name]

    def get_quantity_names(self):
        return sorted(self._quantities.keys())

    def get_quantity_label(self, quantity_name):
        if quantity_name is None:
            return r"density / $M_{\odot} / \mathrm{kpc}^2$"
        return quantity_name

    def get_rgb_masses(self):
        if self._rgb is None:
            raise ValueError("No RGB band masses were provided to "
                             "ArrayDataLoader")
        return self._rgb

    def get_position_units(self):
        return self._position_units

    def get_periodicity_scale(self):
        return self._periodicity_scale


class PynbodyDataInMemory(AbstractDataLoader):
    """Loader wrapping an already-open pynbody snapshot (host-side I/O only;
    reference: loader.py:79-155)."""

    _name_smooth_array = "smooth"

    def __init__(self, snapshot):
        self.snapshot = snapshot
        pos = np.asarray(snapshot["pos"])
        boxmin = pos.min()
        boxmax = pos.max()
        boxrange = boxmax - boxmin
        self._initial_view_width = float(boxrange)
        boxmin -= config.CELL_LAYOUT_FRACTIONAL_PADDING * boxrange
        boxmax += config.CELL_LAYOUT_FRACTIONAL_PADDING * boxrange
        self._cell_layout, ordering = CellLayout.from_positions(
            pos, boxmin, boxmax, config.DEFAULT_CELLS_NSIDE)
        self._particle_order = ordering[self._cell_layout.randomize_within_cells()][self._lod_order()]
        self._position_units = str(snapshot["pos"].units)

    def __len__(self):
        return len(self.snapshot)

    def get_positions(self):
        return np.asarray(self.snapshot["pos"]).astype(np.float32)[self._particle_order]

    def get_smooth(self):
        return np.asarray(self.snapshot[self._name_smooth_array]).astype(np.float32)[self._particle_order]

    def get_mass(self):
        return np.asarray(self.snapshot["mass"]).astype(np.float32)[self._particle_order]

    def get_named_quantity(self, name):
        qty = self.snapshot[name]
        if len(qty.shape) == 2:
            qty = qty[:, 0]
        return np.asarray(qty).astype(np.float32)[self._particle_order]

    def get_quantity_names(self):
        return self.snapshot.loadable_keys()

    def get_quantity_label(self, quantity_name):
        if quantity_name is None:
            return r"density / $M_{\odot} / \mathrm{kpc}^2$"
        lunit = self.snapshot[quantity_name].units.latex()
        if lunit != "":
            lunit = "$/" + lunit + "$"
        return quantity_name + lunit

    def _effective_mass_for_band(self, band):
        return (10 ** (-0.4 * np.asarray(self.snapshot[band + "_mag"])))[self._particle_order]

    def get_rgb_masses(self):
        """SSP I/V/U band magnitudes converted to linear 'masses'
        (reference: loader.py:115-121)."""
        rgb = np.empty((len(self.snapshot), 3), dtype=np.float32)
        rgb[:, 0] = self._effective_mass_for_band("I") * 0.5
        rgb[:, 1] = self._effective_mass_for_band("V")
        rgb[:, 2] = self._effective_mass_for_band("U")
        rgb[np.isnan(rgb)] = 0.0
        return rgb

    def get_position_units(self):
        return self._position_units

    def get_periodicity_scale(self):
        if "boxsize" in self.snapshot.properties:
            return float(self.snapshot.properties["boxsize"].in_units("kpc"))
        return None

    def get_initial_view_width(self):
        return self._initial_view_width

    def get_filename(self):
        return self.snapshot.filename

    def get_cell_ids(self):
        if self._cell_layout is None:
            return None
        return self._cell_layout.cell_ids_per_particle()[self._lod_order()]


class PynbodyDataLoader(PynbodyDataInMemory):
    """Loads a snapshot file via pynbody: physical units, family selection,
    centering, smoothing-length computation with an on-disk cache
    (reference: loader.py:157-238)."""

    _name_smooth_array = "topsy_smooth"

    def __init__(self, filename: str, center: str = "none", particle: str = "dm",
                 take_region=None):
        pynbody = _import_pynbody()
        logger.info("Loading %s (center=%s, particle=%s)", filename, center, particle)
        if take_region is None:
            snapshot = pynbody.load(filename)
        else:
            snapshot = pynbody.load(filename, take_region=take_region)
        snapshot.physical_units()
        self.filename = filename

        fam = pynbody.family.get_family(particle)
        snapshot = snapshot[fam]
        self._family_name = fam.name

        _ = snapshot["pos"]
        if np.ptp(snapshot["pos"]) < 1.0:
            logger.info("Positions span <1 kpc; re-expressing in AU")
            snapshot.physical_units("au")

        self.snapshot = snapshot
        self._perform_centering(center)
        super().__init__(snapshot)
        self._perform_smoothing()

    @property
    def _smooth_cache_filename(self):
        return f"{self.filename}-topsy-smooth-{self._family_name}.pkl"

    def _perform_centering(self, center: str):
        pynbody = _import_pynbody()
        if center.startswith("halo-"):
            halo_number = int(center[5:])
            h = self.snapshot.ancestor.halos()
            cen = pynbody.analysis.halo.center(h[halo_number], return_cen=True)
        elif center == "zoom":
            f_dm = self.snapshot.ancestor.dm
            cen = pynbody.analysis.halo.center(
                f_dm[f_dm["mass"] < 1.01 * f_dm["mass"].min()], return_cen=True)
        elif center == "all":
            cen = pynbody.analysis.halo.center(self.snapshot, return_cen=True)
        elif center == "none":
            cen = np.zeros(3)
        else:
            raise ValueError("Unknown centering type")
        self._initial_center = cen

    def get_initial_center(self):
        return self._initial_center

    def _perform_smoothing(self):
        pynbody = _import_pynbody()
        try:
            smooth = pickle.load(open(self._smooth_cache_filename, "rb"))
            if len(smooth) != len(self.snapshot):
                raise ValueError("Incorrect number of particles in cached smoothing data")
            self.snapshot[self._name_smooth_array] = smooth
            logger.info("Loaded cached smoothing lengths")
        except Exception:
            logger.info("Computing smoothing lengths (cached for future runs)")
            self.snapshot[self._name_smooth_array] = pynbody.sph.smooth(self.snapshot)
            try:
                pickle.dump(self.snapshot[self._name_smooth_array],
                            open(self._smooth_cache_filename, "wb"))
            except IOError:
                logger.warning("Unable to save smoothing data to disk")


def _import_pynbody():
    try:
        import pynbody
    except ImportError as exc:  # pragma: no cover
        raise ImportError(
            "pynbody is required to load simulation snapshot files. "
            "Install it, or use synthetic data via topsy_tpu_torch.test() / "
            "'test://N'."
        ) from exc
    return pynbody
