"""The additive low-rank deposit: kernel K2 and its plain PyTorch version.

Counterpart of ``topsy_tpu/ops/splat_pallas.py`` (the TPU kernel
``accumulate_groups_pallas`` and ``group_flags``).  ``accumulate_groups``
launches the hand-written CUDA kernel (``csrc/splat_accum.cu``) for CUDA
tensors and runs ``accumulate_groups_plain`` for CPU tensors.  The
semantics are the reference's; its TPU schedule (VMEM band windows, DMA
flush/load, fresh-skip flags, ROW_QUANTUM, pltpu.roll, SUBGROUPS grid steps)
is not reproduced: a deposit lands directly at ``atlas[c, w0 + r, cbase +
w]`` for the flag's exact (rows_eval, cols_eval) rectangle.

Wrapper note (``accumulate_groups`` on a CUDA tensor): replaces
``topsy_tpu/ops/splat_pallas.py::accumulate_groups_pallas``.  On the H100
its time goes mostly to the float32 profile evaluation, (rows + cols) x G
x rank degree-6 Horner steps per group; its least time is set by the bf16
products (PERF.md).  Every entry of a group's rectangle is
nonzero (in float32 the profiles' tails are), so the merge into the
L2-resident atlas is 1.4e8 f32 additions per 2^24 main pass: as float4
reductions they cost little.  A one-block plan
kernel sorts the groups by size class on the card (``deposit_plan`` is its
plain version); one persistent launch per class with class-shaped tiles
stages each group's inputs by ``cp.async``, multiplies bf16 P*coef by bf16
Q with ``wgmma`` while it evaluates the next chunk, and flushes four
neighbouring entries per vector reduction.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import kernels

WINDOW_ROWS = 64
WINDOW_COLS = 256
PROFILE_COLS = 128
COL_ALIGN = 128
SUBGROUPS = 8

FLAG_INACTIVE = 0
FLAG_ALL_TINY = 1
FLAG_POLY = 2
FLAG_MIXED = 3
FLAG_MASKED = 4

SIZE_CLASSES = ((16, 32), (32, 64), (48, 128), (None, None))
FULL_CLASS = len(SIZE_CLASSES) - 1

SUPPORT2 = kernels.KERNEL_SUPPORT ** 2
FOOT = 8.0  # = splat_atlas.FOOT (the deposit footprint half-width)

#: launches of the CUDA kernel (incremented only where it is launched)
launches = 0

#: operand elements per batched ``bmm`` of the plain version (bounds memory)
_BATCH_ELEMS = 1 << 25


def group_flags(ih_groups: torch.Tensor, coef_groups: torch.Tensor,
                h_max: float, sizes: torch.Tensor | None = None) -> torch.Tensor:
    """Combined flag kind * 4 + size_class per group.

    ih_groups: (n_groups, G); coef_groups: (n_groups, G, C); sizes:
    (n_groups,) size classes or None for the full window everywhere."""
    active = torch.abs(coef_groups).sum(dim=(1, 2)) > 0.0
    all_tiny = ih_groups.amax(dim=1) < 0.0
    any_tiny = ih_groups.amin(dim=1) < 0.0
    big_th = (1.0 / h_max) * (1.0 - 1e-6)
    any_big = ((ih_groups > 0.0) & (ih_groups < big_th)).any(dim=1)
    kind = torch.where(
        ~active, FLAG_INACTIVE,
        torch.where(all_tiny, FLAG_ALL_TINY,
                    torch.where(any_big, FLAG_MASKED,
                                torch.where(any_tiny, FLAG_MIXED,
                                            FLAG_POLY)))).to(torch.int32)
    if sizes is None:
        sz = torch.full_like(kind, FULL_CLASS)
    else:
        sz = torch.where((kind == FLAG_ALL_TINY) | (kind == FLAG_POLY),
                         sizes.to(torch.int32), FULL_CLASS).to(torch.int32)
    return kind * 4 + sz


def _extents(sz: int, window_rows: int, profile_cols: int):
    r_e, c_e = SIZE_CLASSES[sz]
    rows_eval = window_rows if r_e is None else min(r_e, window_rows)
    cols_eval = profile_cols if c_e is None else min(c_e, profile_cols)
    return rows_eval, cols_eval


def _coef_channels(coef_g, C: int, n: int, G: int) -> torch.Tensor:
    """(C, n, G) channel-major coefficients from a (C, n, G) tensor or a
    C-sequence of (n, G) tensors."""
    if isinstance(coef_g, (list, tuple)):
        assert len(coef_g) == C
        return torch.stack([c.reshape(n, G) for c in coef_g])
    return coef_g.reshape(C, n, G)


def _horner(coeffs, t2: torch.Tensor) -> torch.Tensor:
    """Horner evaluation with fused multiply-adds (one rounding per step),
    as XLA compiles the reference's ``acc * t2 + c``: each step is exact in
    float64 and then rounded to float32."""
    t = t2.double()
    acc = torch.full_like(t, float(coeffs[0]))
    for c in coeffs[1:]:
        acc = (acc * t + float(c)).float().double()
    return acc.float()


def _profiles(d: torch.Tensor, ih: torch.Tensor, kind: int, lrk,
              signed: bool, foot: float) -> torch.Tensor:
    """(B, rank, E, G) profiles at offsets d (B, E, G); ih (B, 1, G)."""
    if kind == FLAG_ALL_TINY:
        hat = torch.clamp(1.0 - torch.abs(d), min=0.0)
        return torch.stack([hat, torch.zeros_like(hat)], dim=1)
    t2 = torch.clamp(d * d * (ih * ih), max=SUPPORT2)
    prof = []
    for k in range(lrk.rank):
        acc = _horner(lrk.coeffs[k], t2)
        if signed:
            acc = acc * float(lrk.signs[k])
        prof.append(acc)
    if kind in (FLAG_MIXED, FLAG_MASKED):
        tiny = ih < 0.0
        hat = torch.clamp(1.0 - torch.sqrt(torch.clamp(t2, min=0.0)), min=0.0)
        prof = [torch.where(tiny, hat if k == 0 else torch.zeros_like(t2), p)
                for k, p in enumerate(prof)]
    out = torch.stack(prof, dim=1)
    if kind == FLAG_MASKED:
        m = ((d > -foot) & (d <= foot)).to(torch.float32)
        out = out * m[:, None]
    return out


def _deposit_batch(atlas, idx, ay, ax, ih, coef, w0, cbase, kind: int,
                   rows_eval: int, cols_eval: int, lrk, foot: float):
    dev = atlas.device
    C, atlas_rows, atlas_cols = atlas.shape
    ayb, axb, ihb = ay[idx], ax[idx], ih[idx][:, None, :]
    coefb = coef[:, idx].permute(1, 0, 2)                      # (B, C, G)
    w0b, cb = w0[idx], cbase[idx]
    B, G = ayb.shape
    rows = torch.arange(rows_eval, device=dev, dtype=torch.float32)
    cols = torch.arange(cols_eval, device=dev, dtype=torch.float32)
    dy = ((w0b[:, None].to(torch.float32) + rows[None, :])[:, :, None]
          - ayb[:, None, :])                                   # (B, R, G)
    dx = ((cb[:, None].to(torch.float32) + cols[None, :])[:, :, None]
          - axb[:, None, :])                                   # (B, W, G)
    P = _profiles(dy, ihb, kind, lrk, True, foot)              # (B, K, R, G)
    Q = _profiles(dx, ihb, kind, lrk, False, foot)             # (B, K, W, G)
    K = P.shape[1]
    # bf16 operands, f32 accumulation: the product P * coef is rounded, as
    # the reference rounds it (splat_pallas._deposit)
    pc = (P[:, :, None] * coefb[:, None, :, None, :]).bfloat16().float()
    a = pc.permute(0, 2, 3, 1, 4).reshape(B, C * rows_eval, K * G)
    b = Q.bfloat16().float().permute(0, 2, 1, 3).reshape(B, cols_eval, K * G)
    out = torch.bmm(a, b.transpose(1, 2)).reshape(B, C, rows_eval, cols_eval)

    r_idx = (w0b[:, None].long() + torch.arange(rows_eval, device=dev))
    c_idx = (cb[:, None].long() + torch.arange(cols_eval, device=dev))
    ch = torch.arange(C, device=dev).view(1, C, 1, 1).expand(B, C, rows_eval,
                                                             cols_eval)
    rr = r_idx.view(B, 1, rows_eval, 1).expand_as(ch)
    cc = c_idx.view(B, 1, 1, cols_eval).expand_as(ch)
    ok = (rr >= 0) & (rr < atlas_rows) & (cc >= 0) & (cc < atlas_cols)
    atlas.index_put_((ch[ok], rr[ok], cc[ok]), out[ok], accumulate=True)


def accumulate_groups_plain(ay_g, ax_g, ih_g, coef_g, w0, c0, ce, flags, *,
                            atlas_rows: int, atlas_cols: int, C: int,
                            group: int, atlas0=None,
                            window_cols: int = WINDOW_COLS,
                            window_rows: int = WINDOW_ROWS):
    """Plain PyTorch deposit with the kernel's semantics.

    Groups of one (kind, size class) are batched; each batch is one bf16-
    rounded f32 ``bmm`` and one ``index_put_(accumulate=True)``.  Accumulates
    onto ``atlas0`` in place (zeros if None) and returns the atlas."""
    n = w0.shape[0]
    G = group
    dev = w0.device
    ay = ay_g.reshape(n, G)
    ax = ax_g.reshape(n, G)
    ih = ih_g.reshape(n, G)
    coef = _coef_channels(coef_g, C, n, G)
    atlas = (torch.zeros((C, atlas_rows, atlas_cols), dtype=torch.float32,
                         device=dev) if atlas0 is None else atlas0)
    profile_cols = PROFILE_COLS if window_cols == WINDOW_COLS else window_cols
    rolled = profile_cols != window_cols
    cbase = ce if rolled else c0
    lrk = kernels.lowrank_kernel()
    kind_all = flags // 4
    sz_all = flags % 4
    for kind in (FLAG_ALL_TINY, FLAG_POLY, FLAG_MIXED, FLAG_MASKED):
        sized = rolled and kind in (FLAG_ALL_TINY, FLAG_POLY)
        for sz in (range(len(SIZE_CLASSES)) if sized else (FULL_CLASS,)):
            sel = torch.nonzero((kind_all == kind) & (sz_all == sz)).flatten()
            if sel.numel() == 0:
                continue
            rows_eval, cols_eval = _extents(sz, window_rows, profile_cols)
            per_group = 2 * G * (C * rows_eval + cols_eval) * 2
            step = max(1, _BATCH_ELEMS // per_group)
            for s in range(0, sel.numel(), step):
                _deposit_batch(atlas, sel[s:s + step], ay, ax, ih, coef, w0,
                               cbase, kind, rows_eval, cols_eval, lrk, FOOT)
    return atlas


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------

#: rows of the kernel's largest class tile
KERNEL_MAX_ROWS = 96


def deposit_plan(flags: torch.Tensor, rolled: bool):
    """The kernel's work list, as its plan kernel computes it on the card.

    Returns int32 tensors ``(order, class_off)``: ``order`` lists the groups
    that deposit (the reference's dispatch rule) sorted stably by size
    class, then the others; class k is ``order[class_off[k]:class_off[k +
    1]]`` (k < 4)."""
    nclass = len(SIZE_CLASSES)
    kind, sz = flags // 4, flags % 4
    dep = ((kind >= FLAG_ALL_TINY) & (kind <= FLAG_MASKED)
           & ((sz == FULL_CLASS) | (rolled & (kind <= FLAG_POLY))))
    key = torch.where(dep, sz, nclass).long()
    skey, order = torch.sort(key, stable=True)
    class_off = torch.searchsorted(
        skey, torch.arange(nclass + 1, device=flags.device), out_int32=True)
    return order.to(torch.int32), class_off


_lrk_host = None


def _lrk_arrays():
    global _lrk_host
    if _lrk_host is None:
        lrk = kernels.lowrank_kernel()
        if lrk.rank != 2 or lrk.degree != 6:
            raise ValueError("csrc/splat_accum.cu is built for rank 2, "
                             f"degree 6; got {lrk.rank}, {lrk.degree}")
        _lrk_host = (np.ascontiguousarray(lrk.coeffs, np.float32).ravel(),
                     np.ascontiguousarray(lrk.signs, np.float32))
    return _lrk_host


def _bind(build_defines=()):
    from . import cuda_build
    lib = cuda_build.library("splat_accum", build_defines)
    fn, plan = lib.topsy_accumulate_groups, lib.topsy_deposit_plan
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, ctypes.c_longlong, P, P, P, P, P, P, I, I,
                       I, I, I, I, I, I, I, ctypes.c_float, P, P, P]
        fn.restype = I
        plan.argtypes = [P, I, I, P, P]
        plan.restype = I
    return fn, plan


def deposit_plan_cuda(flags: torch.Tensor, rolled: bool):
    """``deposit_plan`` by the kernel's plan kernel (for CUDA flags)."""
    _check(flags, "flags", torch.int32, flags.shape, flags.device)
    n = flags.shape[0]
    out = torch.empty(n + len(SIZE_CLASSES) + 1, dtype=torch.int32,
                      device=flags.device)
    err = _bind()[1](flags.data_ptr(), n, int(rolled), out.data_ptr(),
                     torch.cuda.current_stream(flags.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"deposit plan kernel launch failed: cudaError {err}")
    return out[:n], out[n:]


def _check(t: torch.Tensor, name: str, dtype, shape, device):
    if t.device != device or not t.is_cuda:
        raise ValueError(f"{name}: expected a tensor on {device}, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def accumulate_groups_cuda(ay_g, ax_g, ih_g, coef_g, w0, c0, ce, flags, *,
                           atlas_rows: int, atlas_cols: int, C: int,
                           group: int, atlas0=None,
                           window_cols: int = WINDOW_COLS,
                           window_rows: int = WINDOW_ROWS,
                           build_defines=()):
    """Launch kernel K2 (``csrc/splat_accum.cu``) on the current stream.

    ``build_defines``: the ``-D`` flags of a breakdown build of the kernel
    with one part switched off (``k2_variants.py``); none for the port's."""
    global launches
    n = w0.shape[0]
    G = group
    dev = w0.device
    ay = ay_g.reshape(n, G)
    ax = ax_g.reshape(n, G)
    ih = ih_g.reshape(n, G)
    coef = _coef_channels(coef_g, C, n, G)
    for name, t in (("ay", ay), ("ax", ax), ("ih", ih)):
        _check(t, name, torch.float32, (n, G), dev)
    _check(coef, "coef", torch.float32, (C, n, G), dev)
    for name, t in (("w0", w0), ("c0", c0), ("ce", ce), ("flags", flags)):
        _check(t, name, torch.int32, (n,), dev)
    if atlas0 is None:
        atlas0 = torch.zeros((C, atlas_rows, atlas_cols), dtype=torch.float32,
                             device=dev)
    _check(atlas0, "atlas0", torch.float32, (C, atlas_rows, atlas_cols), dev)
    if not 0 <= window_rows <= KERNEL_MAX_ROWS:
        raise ValueError(f"window_rows {window_rows} outside [0, "
                         f"{KERNEL_MAX_ROWS}]")
    if atlas_cols % 4 or atlas0.data_ptr() % 16:
        raise ValueError("the atlas rows must be 16-byte aligned (atlas_cols "
                         f"{atlas_cols} a multiple of 4)")
    profile_cols = PROFILE_COLS if window_cols == WINDOW_COLS else window_cols
    rolled = profile_cols != window_cols
    plan = torch.empty(n + len(SIZE_CLASSES) + 1, dtype=torch.int32,
                       device=dev)
    vec_in = int(G % 4 == 0 and all(t.data_ptr() % 16 == 0
                                    for t in (ay, ax, ih, coef)))
    coeffs, signs = _lrk_arrays()
    fn = _bind(build_defines)[0]
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(ay.data_ptr(), ax.data_ptr(), ih.data_ptr(), coef.data_ptr(),
             n * G, w0.data_ptr(), c0.data_ptr(), ce.data_ptr(),
             flags.data_ptr(), plan.data_ptr(), atlas0.data_ptr(), n, G, C,
             atlas_rows, atlas_cols, window_rows, profile_cols, int(rolled),
             vec_in, FOOT, coeffs.ctypes.data, signs.ctypes.data, stream)
    if err != 0:
        raise RuntimeError(f"accumulate_groups kernel launch failed: "
                           f"cudaError {err}")
    launches += 1
    return atlas0


def accumulate_groups(ay_g, ax_g, ih_g, coef_g, w0, c0, ce, flags, **kw):
    """The deposit: kernel K2 for CUDA tensors, the plain version for CPU
    tensors.  Same arguments as ``accumulate_groups_plain``."""
    if w0.is_cuda:
        return accumulate_groups_cuda(ay_g, ax_g, ih_g, coef_g, w0, c0, ce,
                                      flags, **kw)
    if w0.device.type != "cpu":
        raise ValueError(f"accumulate_groups: unsupported device {w0.device}")
    return accumulate_groups_plain(ay_g, ax_g, ih_g, coef_g, w0, c0, ce,
                                   flags, **kw)
