"""The least work a kernel call needs, and the card's published peaks.

A call's work is counted from its inputs alone: each input and output byte
once, and the operations that its particles' supports and footprints need.
It does not depend on how the kernel tiles, classes or pads the work, so a
redesigned kernel is held to the same yardstick.  Adapted from
``k2_work`` and ``k3_work`` of ``chip_smoke.py``, with their size-class
rectangles replaced by each particle's own footprint.

K2 (the additive deposit) takes per slot an anchor (ay, ax) in atlas
pixels, ``ih`` (1 / h in level pixels, negative for a tiny particle) and C
coefficients, per group four integers, and deposits into a (C, rows, cols)
atlas.  A live particle (a coefficient that is not 0) covers the atlas
lines within its support, ``|d| ih < 2``, and its footprint, ``-8 < d <=
8``, on each axis (a tiny one its cloud-in-cell hat, ``|d| < 1``).  Its
deposit is a separable product of rank 2 (1 for a hat) over those lines:
``2 C rank`` operations per covered pixel, on the tensor cores; each
covered line costs two degree-6 polynomials, 24 float32 operations (a hat
line 3).

K3 (the z-buffer) takes per slot an anchor, ``ih`` and three payload
floats and per group four integers, and merges into (rows, cols) packed
64-bit keys.  A valid particle (``ih > 0``) of an active group covers the
pixels of its footprint box; 2 float32 operations per footprint line, 4
per fragment (a pixel in the box), 4 more per hit (a fragment inside the
hemisphere).  Each hit pixel's key is read and written once.
"""

from __future__ import annotations

import torch

# published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
# 700 W)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12

SUPPORT = 2.0
FOOT = 8.0
K2_RANK = 2
K2_OPS_PER_POLY_LINE = 24
K2_OPS_PER_HAT_LINE = 3
K3_OPS_PER_LINE = 2
K3_OPS_PER_FRAGMENT = 4
K3_OPS_PER_HIT = 4
K3_FLAG_ACTIVE = 1
_OFFSETS = 20          # lines examined per axis around a particle's anchor
_CHUNK = 1 << 20


def bound_s(nbytes: float, ops_f32: float = 0.0, ops_bf16: float = 0.0):
    """The least time of a call: the largest of its bytes over the memory
    rate and its operations over their peak rate."""
    return max(nbytes / HBM_BYTES_PER_S, ops_f32 / F32_OPS_PER_S,
               ops_bf16 / BF16_OPS_PER_S)


def _lines(pos, ih, limit: int, hat):
    """(n, _OFFSETS) bool: the integer lines of [0, limit) around each
    anchor inside its support and footprint (its hat where ``hat``)."""
    base = torch.floor(pos)[:, None] - (_OFFSETS // 2 - 1)
    line = base + torch.arange(_OFFSETS, device=pos.device,
                               dtype=pos.dtype)[None, :]
    d = line - pos[:, None]
    inside = (d * d * (ih * ih)[:, None] < SUPPORT * SUPPORT) \
        & (d > -FOOT) & (d <= FOOT)
    inside = torch.where(hat[:, None], d.abs() < 1.0, inside)
    return inside & (line >= 0) & (line < limit)


def k2_call(args, kw) -> float:
    """The least time (s) of one K2 call (``accumulate_groups``'s
    arguments)."""
    return bound_s(*k2_counts(args, kw))


def k2_counts(args, kw):
    """(bytes, float32 operations, bf16 operations) of one K2 call."""
    kw = dict(zip(("ay_g", "ax_g", "ih_g", "coef_g", "w0"), args)) | kw
    ay_g, ax_g, ih_g, coef_g, w0 = (kw[k] for k in ("ay_g", "ax_g", "ih_g",
                                                    "coef_g", "w0"))
    C, G = kw["C"], kw["group"]
    rows, cols = kw["atlas_rows"], kw["atlas_cols"]
    n = w0.shape[0]
    ay, ax, ih = (t.reshape(-1).float() for t in (ay_g, ax_g, ih_g))
    if isinstance(coef_g, (list, tuple)):
        coef = torch.stack([c.reshape(-1) for c in coef_g])
    else:
        coef = coef_g.reshape(C, -1)
    bf16 = f32 = 0.0
    for s in range(0, ay.numel(), _CHUNK):
        sl = slice(s, s + _CHUNK)
        live = (coef[:, sl] != 0).any(dim=0)
        if not bool(live.any()):
            continue
        hat = ih[sl][live] < 0
        ly = _lines(ay[sl][live], ih[sl][live], rows, hat).sum(dim=1)
        lx = _lines(ax[sl][live], ih[sl][live], cols, hat).sum(dim=1)
        rank = torch.where(hat, 1, K2_RANK)
        bf16 += 2.0 * C * float((rank * ly * lx).sum())
        per_line = torch.where(hat, K2_OPS_PER_HAT_LINE, K2_OPS_PER_POLY_LINE)
        f32 += float((per_line * (ly + lx)).sum())
    nbytes = n * G * (3 + C) * 4 + n * 16 + 2 * C * rows * cols * 4
    return nbytes, f32, bf16


def k3_call(args, kw) -> float:
    """The least time (s) of one K3 call (``accumulate_max_packed``'s
    arguments)."""
    return bound_s(*k3_counts(args, kw))


def k3_counts(args, kw):
    """(bytes, float32 operations) of one K3 call."""
    kw = dict(zip(("keys", "ay_g", "ax_g", "ih_g"), args)) | kw
    keys, ay_g, ax_g, ih_g, flags = (kw[k] for k in ("keys", "ay_g", "ax_g",
                                                     "ih_g", "flags"))
    G = kw["group"]
    rows, cols = keys.shape
    n = flags.shape[0]
    active = (flags // 4) == K3_FLAG_ACTIVE
    n_active = int(active.sum())
    slot_active = active.repeat_interleave(G)
    ay, ax, ih = (t.reshape(-1).float() for t in (ay_g, ax_g, ih_g))
    lines = frags = hits = 0.0
    hit_px = torch.zeros(rows * cols, dtype=torch.bool, device=keys.device)
    off = torch.arange(_OFFSETS, device=keys.device)
    for s in range(0, ay.numel(), _CHUNK):
        sl = slice(s, s + _CHUNK)
        ok = slot_active[sl] & (ih[sl] > 0)
        if not bool(ok.any()):
            continue
        py, px, pih = ay[sl][ok], ax[sl][ok], ih[sl][ok]
        y = torch.floor(py)[:, None] - (_OFFSETS // 2 - 1) + off
        x = torch.floor(px)[:, None] - (_OFFSETS // 2 - 1) + off
        dy, dx = y - py[:, None], x - px[:, None]
        in_y = (dy > -FOOT) & (dy <= FOOT) & (y >= 0) & (y < rows)
        in_x = (dx > -FOOT) & (dx <= FOOT) & (x >= 0) & (x < cols)
        lines += float(in_y.sum() + in_x.sum())
        frags += float((in_y.sum(1) * in_x.sum(1)).sum())
        for b in range(0, py.numel(), 1 << 14):
            bs = slice(b, b + (1 << 14))
            t = 4.0 - ((dy[bs] ** 2)[:, :, None] + (dx[bs] ** 2)[:, None, :]) \
                * (pih[bs] ** 2)[:, None, None]
            hit = in_y[bs][:, :, None] & in_x[bs][:, None, :] & (t > 0.0)
            hits += float(hit.sum())
            pix = (y[bs].long()[:, :, None] * cols + x[bs].long()[:, None, :])
            hit_px[pix[hit]] = True
    ops = (K3_OPS_PER_LINE * lines + K3_OPS_PER_FRAGMENT * frags
           + K3_OPS_PER_HIT * hits)
    nbytes = n * 4 + n_active * (G * 6 * 4 + 3 * 4) + int(hit_px.sum()) * 16
    return nbytes, ops
