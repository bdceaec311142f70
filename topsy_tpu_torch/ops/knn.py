"""Smoothing lengths estimated from a multigrid cloud-in-cell density.

Counterpart of ``topsy_tpu/ops/knn.py`` in plain PyTorch, on the device of
the positions: the particles are binned into 3-D CIC histograms at several
grid resolutions, each particle reads its local count back by trilinear
interpolation at the finest level whose count is statistically reliable
(>= max(n_neighbors / 2, 8)), and h = eta * n^(-1/3) with eta = (3
n_neighbors / (32 pi))^(1/3), the 2h-support M4 convention.  The estimate
follows kNN smoothing lengths statistically (the same density scaling,
~10% scatter); ``ops/knn_device.py`` and the native host kNN are exact.
"""

from __future__ import annotations

import numpy as np
import torch

_OFFSETS = [(dz, dy, dx) for dz in (0, 1) for dy in (0, 1) for dx in (0, 1)]


def _corners(pos01: torch.Tensor, res: int):
    """(weight, (i, j, k) grid index) of each of the 8 CIC corners."""
    x = pos01 * res - 0.5
    i0 = torch.floor(x).to(torch.int64)
    f = x - i0.to(torch.float32)
    for dz, dy, dx in _OFFSETS:
        w = (torch.abs(1 - dx - f[:, 0]) * torch.abs(1 - dy - f[:, 1])
             * torch.abs(1 - dz - f[:, 2]))
        idx = tuple(torch.clamp(i0[:, a] + d, -1, res) + 1
                    for a, d in enumerate((dx, dy, dz)))
        yield w, idx


def _cic_histogram(pos01: torch.Tensor, res: int) -> torch.Tensor:
    """Cloud-in-cell 3-D histogram of positions normalised to [0, 1)^3,
    with one guard cell on each side: (res + 2)^3."""
    grid = torch.zeros((res + 2, res + 2, res + 2), dtype=torch.float32,
                       device=pos01.device)
    for w, idx in _corners(pos01, res):
        grid.index_put_(idx, w, accumulate=True)
    return grid


def _trilinear_sample(grid: torch.Tensor, pos01: torch.Tensor,
                      res: int) -> torch.Tensor:
    out = torch.zeros(pos01.shape[0], dtype=torch.float32,
                      device=pos01.device)
    for w, idx in _corners(pos01, res):
        out = out + w * grid[idx]
    return out


def _smoothing_from_grids(pos01, box_size, levels: tuple[int, ...],
                          n_neighbors: int) -> torch.Tensor:
    n_min = float(max(n_neighbors // 2, 8))
    density = None
    for res in levels:
        cnt = _trilinear_sample(_cic_histogram(pos01, res), pos01, res)
        cell_vol = (box_size / res) ** 3
        dens = torch.clamp(cnt, min=0.03) / cell_vol
        density = dens if density is None else torch.where(
            cnt >= n_min, dens, density)
    eta = (3.0 * n_neighbors / (32.0 * np.pi)) ** (1.0 / 3.0)
    return eta * density ** (-1.0 / 3.0)


def smoothing_lengths(positions, n_neighbors: int = 32,
                      levels: tuple[int, ...] = (16, 32, 64, 128, 256),
                      device=None) -> torch.Tensor:
    """Estimated SPH smoothing lengths (n,) float32 from (n, 3) positions
    (a tensor, on its device, or numpy, put on ``device``)."""
    positions = torch.as_tensor(positions, dtype=torch.float32,
                                device=device)
    lo = positions.amin(dim=0)
    hi = positions.amax(dim=0)
    span = torch.clamp((hi - lo).amax(), min=1e-30)
    pos01 = (positions - lo) / span
    return _smoothing_from_grids(pos01, span, tuple(levels), n_neighbors)
