"""Spatial cell layout: uniform nside^3 grid segmentation of the particles.

A pinned copy of ``topsy_tpu/cells.py``.

Semantics follow the reference cell layout (reference:
src/topsy/cell_layout.py:8-113): particles are sorted by cell, each cell is a
contiguous (offset, length) segment, and the order *within* a cell is
randomized so that any prefix of a cell is a fair subsample.

TPU-native addition: :meth:`CellLayout.interleave_order` materializes the
reference's per-cell phase-shifted progressive subsampling (reference:
src/topsy/progressive_render.py:152-187) as a single global particle order in
which every *global prefix* contains exactly the reference's per-cell
selection for the corresponding fraction.  Progressive LOD on device then
becomes a contiguous prefix range — no per-frame index gathers.
"""

from __future__ import annotations

import numpy as np


class CellLayout:
    """Segmentation of a particle set into a uniform grid of cells."""

    def __init__(self, centres: np.ndarray, offsets: np.ndarray, lengths: np.ndarray):
        self._centres = np.ascontiguousarray(centres, dtype=np.float64)
        self._offsets = np.asarray(offsets, dtype=np.intp)
        self._lengths = np.asarray(lengths, dtype=np.intp)
        self._num_particles = int(self._lengths.sum())
        self._cell_size = float(np.linalg.norm(self._centres[1] - self._centres[0]))

    # -- queries -------------------------------------------------------------

    def get_num_cells(self) -> int:
        return len(self._lengths)

    def get_num_particles(self) -> int:
        return self._num_particles

    def get_cell_length(self, cell_index):
        return self._lengths[cell_index]

    def get_cell_offset(self, cell_index):
        return self._offsets[cell_index]

    def cell_slice(self, cell_index: int) -> slice:
        start = self._offsets[cell_index]
        return slice(start, start + self._lengths[cell_index])

    def cell_index_from_offset(self, offset: int) -> int:
        cell_index = int(np.searchsorted(self._offsets, offset, side="right") - 1)
        if cell_index < 0 or cell_index >= len(self._lengths):
            raise ValueError("Offset is out of bounds")
        return cell_index

    def cells_in_sphere(self, centre, radius: float) -> np.ndarray:
        """Indices of cells whose centre lies within radius (+ a cell-diagonal
        expansion) of ``centre`` (reference: cell_layout.py:26-31)."""
        expand_radius = self._cell_size * np.sqrt(3.0)
        offsets = self._centres - np.asarray(centre)
        selection = np.linalg.norm(offsets, axis=1) < (radius + expand_radius)
        return np.where(selection)[0]

    def cell_ids_per_particle(self) -> np.ndarray:
        """int32 array mapping each particle slot to its cell index."""
        ids = np.zeros(self._num_particles, dtype=np.int32)
        for i, (o, l) in enumerate(zip(self._offsets, self._lengths)):
            ids[o:o + l] = i
        return ids

    # -- orderings -----------------------------------------------------------

    def randomize_within_cells(self, rng: np.random.RandomState | None = None) -> np.ndarray:
        """Reordering that shuffles particles within each cell but preserves
        the cell segmentation (reference: cell_layout.py:17-24)."""
        if rng is None:
            rng = np.random
        reordering = np.empty(self._num_particles, dtype=np.intp)
        for offset, length in zip(self._offsets, self._lengths):
            reordering[offset:offset + length] = rng.permutation(length) + offset
        return reordering

    def interleave_order(self, phase_shifts: np.ndarray | None = None,
                         seed: int = 1337) -> np.ndarray:
        """Global LOD order materializing the per-cell progressive selection.

        The reference selects, for a logical fraction f, within-cell indices
        i < floor(f * L_c + phi_c) from every cell c (reference:
        progressive_render.py:152-187, phi_c = phase permutation / num_cells).
        Sorting all particles by the key (i + 1 - phi_c) / L_c makes the set
        selected at fraction f exactly the global prefix of length
        sum_c floor(f * L_c + phi_c).  Returns an index array into the
        cell-sorted particle arrays.
        """
        if phase_shifts is None:
            phase_shifts = self.default_phase_shifts(seed)
        phi = phase_shifts.astype(np.float64) / self.get_num_cells()
        from . import native
        order = native.interleave_order(self._offsets, self._lengths, phi)
        if order is not None:
            return order
        keys = np.empty(self._num_particles, dtype=np.float64)
        for c, (o, l) in enumerate(zip(self._offsets, self._lengths)):
            if l:
                keys[o:o + l] = (np.arange(1, l + 1) - phi[c]) / l
        return np.argsort(keys, kind="stable")

    def default_phase_shifts(self, seed: int = 1337) -> np.ndarray:
        """Per-cell phase shifts; a seeded permutation, matching the
        reference's construction (reference: progressive_render.py:144-145)."""
        return np.random.RandomState(seed).permutation(self.get_num_cells())

    def prefix_length_for_fraction(self, fraction: float,
                                   phase_shifts: np.ndarray | None = None,
                                   seed: int = 1337) -> int:
        """Number of particles selected at logical fraction ``fraction`` —
        the prefix length in interleave order equal to the reference's
        per-cell selection count."""
        if phase_shifts is None:
            phase_shifts = self.default_phase_shifts(seed)
        phi = phase_shifts.astype(np.float64) / self.get_num_cells()
        return int(np.floor(fraction * self._lengths + phi).sum())

    # -- construction ----------------------------------------------------------

    @classmethod
    def from_positions(cls, particle_positions: np.ndarray, box_min: float,
                       box_max: float, nside: int):
        """Build a layout from arbitrary-order positions.

        Returns (cell_layout, particle_ordering); semantics as the reference
        (reference: cell_layout.py:63-113).
        """
        particle_positions = np.asarray(particle_positions)
        if particle_positions.min() < box_min or particle_positions.max() >= box_max:
            raise ValueError("Particle positions are outside the box")

        cell_size = (box_max - box_min) / nside
        cell_cen0 = box_min + cell_size / 2

        grid_1d = cell_cen0 + cell_size * np.arange(nside)
        gx, gy, gz = np.meshgrid(grid_1d, grid_1d, grid_1d, indexing="ij")
        centres = np.stack([gx.ravel(), gy.ravel(), gz.ravel()], axis=1)

        from . import native
        result = native.cell_sort(particle_positions, box_min, box_max, nside)
        if result is not None:
            ordering, offsets, lengths = result
            return cls(centres, offsets, lengths), ordering

        pos_indices = np.floor((particle_positions - box_min) / cell_size).astype(np.intp)
        if pos_indices.min() < 0 or pos_indices.max() >= nside:
            raise ValueError("Particle positions are too close to edge of box; expand box size")

        cell_indices = pos_indices[:, 2] + nside * (pos_indices[:, 1] + nside * pos_indices[:, 0])
        ordering = np.argsort(cell_indices, kind="stable")

        lengths = np.bincount(cell_indices, minlength=nside**3)
        offsets = np.cumsum(lengths) - lengths
        return cls(centres, offsets, lengths), ordering
