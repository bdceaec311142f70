"""Device-side percentiles for colormap autoranging.

Counterpart of ``topsy_tpu/ops/stats.py``: a min/max pass, a 4096-bin
histogram and cumulative interpolation, so only a few scalars are read back.
"""

from __future__ import annotations

import numpy as np
import torch

HIST_BINS = 4096


def _percentiles_impl(values: torch.Tensor, qs: torch.Tensor,
                      n_bins: int = HIST_BINS):
    finite = torch.isfinite(values)
    n_finite = finite.sum()
    safe = torch.where(finite, values, 0.0)
    lo = torch.where(finite, values, torch.inf).min()
    hi = torch.where(finite, values, -torch.inf).max()
    span = torch.clamp(hi - lo, min=1e-30)

    scaled = torch.nan_to_num((safe - lo) / span * n_bins, nan=0.0,
                              posinf=0.0, neginf=0.0)
    idx = torch.clamp(scaled.to(torch.int32), 0, n_bins - 1).long()
    hist = torch.zeros((n_bins,), dtype=torch.float32, device=values.device)
    hist.index_add_(0, idx, finite.to(torch.float32))
    cdf = torch.cumsum(hist, 0) / torch.clamp(n_finite, min=1)

    targets = qs / 100.0
    bin_idx = torch.clamp(torch.searchsorted(cdf, targets), 0, n_bins - 1)
    cdf_lo = torch.where(bin_idx > 0, cdf[torch.clamp(bin_idx - 1, min=0)],
                         0.0)
    cdf_hi = cdf[bin_idx]
    frac = torch.where(cdf_hi > cdf_lo,
                       (targets - cdf_lo) / (cdf_hi - cdf_lo), 0.5)
    edges = lo + (bin_idx.to(torch.float32) + frac) * (span / n_bins)
    return edges, n_finite, lo, hi


def percentiles(values: torch.Tensor, qs) -> tuple:
    """Percentile(s) of the finite entries of ``values``.

    Returns (percentile values as numpy, finite count, finite min, finite
    max) after one small readback."""
    values = values.reshape(-1).to(torch.float32)
    qs_arr = torch.as_tensor(np.atleast_1d(np.asarray(qs, dtype=np.float32)),
                             device=values.device)
    edges, n_finite, lo, hi = _percentiles_impl(values, qs_arr)
    lo_hi = torch.stack([lo, hi]).cpu().numpy()
    return (edges.cpu().numpy(), int(n_finite.item()), float(lo_hi[0]),
            float(lo_hi[1]))
