"""Exact full-support rendering of giant splats.

Counterpart of ``topsy_tpu/ops/splat_giant.py``.  Splats whose support
exceeds the level deposit window (``h_l > GIANT_H``) are excluded from the
windowed deposit and accumulated densely over the fine framebuffer through
the separable rank-6 kernel, ``rank * C`` float32 products of shape
(res, cap) @ (cap, res), plus an exact radial subpass for the NBIG biggest.
The products run in full float32 (TF32 off, set in
``topsy_tpu_torch/__init__.py``), as the reference forces
``Precision.HIGHEST``: corner pixels are often dominated by one giant.

``zsplat_giant_image`` is the surface mode's counterpart: the exact
front-most hemisphere fragments of the giants over the whole framebuffer.

The candidate planning (``candidate_slots`` .. ``giant_plan``) is host numpy;
``candidate_slots`` reads the host or the device presort layout.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import config
from . import kernels

FOOT = 8.0
GIANT_H = FOOT / kernels.KERNEL_SUPPORT  # 4.0 level px
CAP = int(getattr(config, "SPLAT_GIANT_CAP", 8192))
GIANT_RANK = 6
GIANT_DEGREE = 12
NBIG = 64
#: bucket threshold meaning "exclude nothing"
BUCKET_DISABLED = 1 << 20

# giants per step of the exact subpass: bounds the (chunk, res, res)
# temporaries (64 MB at 1024^2)
_EXACT_CHUNK = 16


@functools.lru_cache(maxsize=None)
def _inv_integral() -> float:
    return 1.0 / kernels.lowrank_integral(GIANT_RANK, GIANT_DEGREE)


def giant_norm(h_px, px_per_world):
    """Deposit weight for a giant: ``c_inf / h_world^2`` with the
    continuous normalisation and the unclamped smoothing."""
    inv_h_world = px_per_world / torch.clamp(h_px, min=1e-30)
    return _inv_integral() * inv_h_world * inv_h_world


def _horner(coeffs, t2: torch.Tensor) -> torch.Tensor:
    acc = torch.full_like(t2, float(coeffs[0]))
    for c in coeffs[1:]:
        acc = acc * t2 + float(c)
    return acc


def giant_image(cy, cx, h_px, coef, resolution: int):
    """Dense full-support accumulation of (capped) giant splats.

    cy, cx, h_px: (cap,) centres and smoothing in fine pixels; coef: (cap, C)
    deposit coefficients (zero rows are inactive).  Returns (res, res, C)."""
    lrk = kernels.lowrank_kernel(GIANT_RANK, GIANT_DEGREE)
    cap = cy.shape[0]
    C = coef.shape[1]
    dev = cy.device
    sup2 = kernels.KERNEL_SUPPORT ** 2

    nbig = min(NBIG, cap)
    score = torch.where(torch.isfinite(h_px), h_px, -1.0)
    big_idx = _topk_indices(score, nbig)
    is_big = torch.zeros((cap,), dtype=torch.bool, device=dev)
    is_big[big_idx] = True
    out = _exact_subpass(cy[big_idx], cx[big_idx], h_px[big_idx],
                         coef[big_idx], resolution)
    coef = torch.where(is_big[:, None], 0.0, coef)

    inv_h = 1.0 / torch.clamp(h_px, min=1e-30)
    grid = torch.arange(resolution, dtype=torch.float32, device=dev)

    def profiles(centre):
        t = (grid[None, :] - centre[:, None]) * inv_h[:, None]
        t2 = t * t
        t2 = torch.clamp(torch.where(torch.isfinite(t2), t2, sup2), 0.0, sup2)
        return [_horner(lrk.coeffs[k], t2) for k in range(lrk.rank)]

    P = profiles(cy)
    Q = profiles(cx)
    for k in range(lrk.rank):
        sk = float(lrk.signs[k])
        for c in range(C):
            contrib = P[k].t() @ (Q[k] * (coef[:, c] * sk)[:, None])
            out[:, :, c] += contrib
    return out


def _exact_subpass(cy, cx, h_px, coef, resolution: int):
    """Exact radial accumulation of the few biggest giants:
    ``k2(q) = g(q^2/2 - 1) * (4 - q^2)^3.5`` evaluated densely per pixel."""
    C = coef.shape[1]
    dev = cy.device
    gcoeffs = kernels.radial_edge_poly()
    rescale = kernels.lowrank_integral(GIANT_RANK, GIANT_DEGREE)
    sup2 = kernels.KERNEL_SUPPORT ** 2
    grid = torch.arange(resolution, dtype=torch.float32, device=dev)
    out = torch.zeros((resolution, resolution, C), dtype=torch.float32,
                      device=dev)
    for s in range(0, cy.shape[0], _EXACT_CHUNK):
        e = s + _EXACT_CHUNK
        inv = 1.0 / torch.clamp(h_px[s:e], min=1e-30)
        ty2 = ((grid[None, :] - cy[s:e, None]) * inv[:, None]) ** 2
        tx2 = ((grid[None, :] - cx[s:e, None]) * inv[:, None]) ** 2
        q2 = ty2[:, :, None] + tx2[:, None, :]
        q2 = torch.clamp(torch.where(torch.isfinite(q2), q2, sup2), 0.0, sup2)
        u = q2 * 0.5 - 1.0
        g = _horner(gcoeffs, u)
        t = sup2 - q2
        k2 = g * (t * t * t) * torch.sqrt(t)
        out += torch.einsum("gyx,gc->yxc", k2, coef[s:e] * rescale)
    return out


def zsplat_giant_image(cy, cx, h_px, z01, h_clip_half, qty, active,
                       resolution: int, chunk: int = 16):
    """Dense full-support z-buffered giant pass for surface mode: ``depth =
    z01 + h_clip_half * sqrt(4 - q^2)`` with q on the true pixel smoothing
    over the whole framebuffer, front-most fragment kept (first giant on a
    depth tie, as the reference's argmax), ``chunk`` giants at a time.
    Returns the (res, res, 2) [value, depth] layer (depth 0 = empty)."""
    from .zsplat import HEMI_SUPPORT
    dev = cy.device
    sup2 = HEMI_SUPPORT * HEMI_SUPPORT
    grid = torch.arange(resolution, dtype=torch.float32, device=dev)
    vbuf = torch.zeros((resolution, resolution), dtype=torch.float32,
                       device=dev)
    dbuf = torch.full((resolution, resolution), -torch.inf,
                      dtype=torch.float32, device=dev)
    for s in range(0, cy.shape[0], chunk):
        e = s + chunk
        inv = 1.0 / torch.clamp(h_px[s:e], min=1e-30)
        dy2 = ((grid[None, :] - cy[s:e, None]) * inv[:, None]) ** 2
        dx2 = ((grid[None, :] - cx[s:e, None]) * inv[:, None]) ** 2
        q2 = dy2[:, :, None] + dx2[:, None, :]
        q2 = torch.where(torch.isfinite(q2), q2, sup2)
        k = torch.sqrt(torch.clamp(sup2 - q2, min=0.0))
        inside = (q2 < sup2) & active[s:e, None, None]
        depth = torch.where(inside, z01[s:e, None, None]
                            + k * h_clip_half[s:e, None, None], -torch.inf)
        di, win = torch.max(depth, dim=0)
        take = di > dbuf
        vbuf = torch.where(take, qty[s:e][win], vbuf)
        dbuf = torch.where(take, di, dbuf)
    dbuf = torch.clamp(dbuf, min=0.0)
    vbuf = torch.where(dbuf > 0.0, vbuf, 0.0)
    return torch.stack([vbuf, dbuf], dim=-1)


def _topk_indices(score: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest scores, ties to the lower index (the
    order ``jax.lax.top_k`` returns)."""
    _, order = torch.sort(score, descending=True, stable=True)
    return order[:k]


def select_giants_topk(giant_mask, h_px, cap: int):
    """Compact giants to a static cap: (idx (cap,), valid (cap,), excluded
    (n,) bool).  The port selects exactly at every size (the reference
    switches to ``approx_max_k`` above 2^18 particles)."""
    n = h_px.shape[0]
    cap = min(cap, n)
    score = torch.where(giant_mask, h_px, -1.0)
    idx = _topk_indices(score, cap)
    top = score[idx]
    valid = top > 0.0
    excluded = torch.zeros((n,), dtype=torch.bool, device=h_px.device)
    excluded[idx] = valid
    return idx, valid, excluded


# ---------------------------------------------------------------------------
# static per-layout candidate selection (host numpy)
# ---------------------------------------------------------------------------

def candidate_slots(layout, cap: int = CAP):
    """Static giant-candidate metadata for a presort layout: (slots
    ascending (m,) int32, slot buckets (m,) int32, hist_buckets (B,) int32,
    hist_counts (B,) int64) — the last min(cap, n_real) real slots, whose
    buckets are the largest, and the histogram of every real particle's
    bucket.  Host numpy results, for the host ``PresortedLayout`` (``dst``
    lists the real slots) and the device layout (real slots are ``gidx <
    n_real``; one pass on its device, then m slots and the histogram read
    back)."""
    m = int(min(cap, layout.n_real))
    z = np.zeros(0, np.int32)
    if m == 0:
        return z, z, z, np.zeros(0, np.int64)
    dst = getattr(layout, "dst", None)
    if dst is not None:
        real_slots = np.sort(np.asarray(dst))
        slots = real_slots[-m:].astype(np.int32)
        all_buckets = np.asarray(layout.buckets)[real_slots]
        buckets = all_buckets[-m:]
        hist_buckets, hist_counts = np.unique(all_buckets, return_counts=True)
    else:
        real = layout.gidx < layout.n_real
        # count of real slots at or after each slot
        cum = torch.flip(torch.cumsum(torch.flip(real, (0,)), 0), (0,))
        slots_d = torch.nonzero(real & (cum <= m)).flatten()
        b_real = layout.buckets[real].to(torch.int64)
        bmin = int(b_real.min())
        hist = torch.bincount(b_real - bmin).cpu().numpy()
        slots = slots_d.cpu().numpy().astype(np.int32)
        buckets = layout.buckets[slots_d].cpu().numpy()
        nz = hist > 0
        hist_buckets = np.arange(bmin, bmin + len(hist))[nz]
        hist_counts = hist[nz]
    return (slots, buckets.astype(np.int32),
            hist_buckets.astype(np.int32), hist_counts.astype(np.int64))


def capable_buckets(buckets: np.ndarray, resolution: int, scale: float,
                    num_levels: int) -> np.ndarray:
    """Which buckets could contain giants at this zoom (host math)."""
    from .morton import DELTA_OCTAVE

    from .splat import H_MAX
    ppw = resolution / (2.0 * float(scale))
    b = buckets.astype(np.float64)
    h_up_px = np.exp2((b + 1.0) * DELTA_OCTAVE) * ppw
    lev = np.clip(np.ceil((b + 1.0) * DELTA_OCTAVE + np.log2(ppw / H_MAX)),
                  0, num_levels - 1)
    return h_up_px * np.exp2(-lev) > GIANT_H


def plan_sizes(m: int) -> list[int]:
    """Dense-pass sizes for a pool of m slots: powers of two from 256 up
    to m, plus m."""
    sizes, s = [], 256
    while s < m:
        sizes.append(s)
        s *= 2
    sizes.append(m)
    return sizes


def giant_plan(meta, resolution: int, scale: float,
               num_levels: int) -> tuple[int, int]:
    """Per-frame host decision: (size, bucket_threshold); size 0 with
    BUCKET_DISABLED means no dense pass and no exclusion."""
    slots, cand_buckets, hist_buckets, hist_counts = meta
    m = len(cand_buckets)
    if m == 0:
        return 0, BUCKET_DISABLED
    cap_mask = capable_buckets(hist_buckets, resolution, scale, num_levels)
    if not cap_mask.any():
        return 0, BUCKET_DISABLED
    b_thresh = int(hist_buckets[cap_mask].min())
    k_total = int(hist_counts[hist_buckets >= b_thresh].sum())
    if k_total > m:
        return 0, BUCKET_DISABLED
    for s in plan_sizes(m):
        if s >= k_total:
            return s, b_thresh
    return m, b_thresh
