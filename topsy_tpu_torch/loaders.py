"""Data loaders: host-side snapshot access.

A pinned copy of ``AbstractDataLoader`` and ``TestDataLoader`` from
``topsy_tpu/loaders.py`` (the loader contract and the seeded
Gaussian-mixture snapshot, same numpy draws, seeds and constants).  Arrays
come back in the interleaved LOD order when cells are used
(``cells.CellLayout.interleave_order``).  ``TestDataDeviceLoader`` is the
counterpart of the reference's: the same mixture generated on the device
with torch, adopted in place by the store (``device_arrays``).  Snapshot
files through pynbody are ROADMAP item M14.
"""

from __future__ import annotations

import logging
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
        'mass': (n,), 'quantities': {name: (n,)}}`` float32 tensors.  When
        non-None the ParticleStore adopts these tensors in place and never
        calls the host getters on the hot path.  Default None: the host
        numpy path."""
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
    plus :meth:`device_arrays`, which the ParticleStore adopts in place:
    the Visualizer's path runs without a snapshot byte crossing from the
    host.  The host getters read back from the device."""

    __test__ = False

    def __init__(self, n_particles: int, seed: int = 1337, device="cuda"):
        self._n_particles = int(n_particles)
        ps, mass, qty = test_data_device(self._n_particles, seed=seed,
                                         device=device)
        self._dev = {"pos_smooth": ps, "mass": mass,
                     "quantities": {"test-quantity": qty}}

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
        p = self._dev["pos_smooth"]
        return torch.stack([torch.abs(torch.sin(p[:, 0] / 10.0)),
                            torch.abs(torch.cos(p[:, 1] / 10.0)),
                            torch.abs(torch.cos(p[:, 2] / 10.0))],
                           dim=1).cpu().numpy()

    def get_filename(self):
        return "test data (device)"
