"""The z-buffered (front-most fragment) deposit: kernel K3 and its plain
PyTorch version.

Counterpart of ``topsy_tpu/ops/zsplat_pallas.py`` (the TPU kernel
``accumulate_max_groups_pallas``).  Each active group of G particles
evaluates, over its size class's (rows_eval, cols_eval) rectangle at atlas
rows ``w0 + r`` and columns ``cbase + c``, every particle's hemisphere depth

    depth = z01 + sqrt(max(4 - (dy^2 + dx^2) * ih^2, 0)) * h_clip_half

for ih > 0, t > 0 and -FOOT < dy, dx <= FOOT, keeps the per-pixel winner
(largest depth, on a depth tie the largest value) and merges it into the
(depth, value) atlas with ``d > cur_d or (d == cur_d and v > cur_v)``.

Both versions merge through one packed 64-bit key per pixel, ``key =
ord(depth) * 2^32 + ord(value)`` with ``ord`` the order-preserving float ->
int32 map (-0.0 taken as +0.0): the lexicographic (depth, value) maximum is
then the integer maximum, which is associative and commutative, so the
group reduction and the window merge give the reference's atlas exactly in
any order.  ``pack_atlas`` / ``unpack_atlas`` convert the (2, R, C) atlas.
Pixels where a group has no fragment are left alone: the reference merges
(NEG, ...) there, which never wins against an atlas depth above NEG (the
atlas starts at zeros).

Rounding.  On the CPU the reference's expression is compiled with fused
multiply-adds: ``4 - s * ih^2`` and ``z01 + k * h_clip_half`` are single
roundings, and the inner sum ``s = dy^2 + dx^2`` is contracted as XLA
happens to fuse it for the call shape (``sum_order``): ``fma(dy, dy,
dx^2)`` in the statically unrolled narrow classes (cols_eval <= 64),
``fma(dx, dx, dy^2)`` in the looped wide classes of groups of 128 or more,
and separate roundings in the looped classes of smaller groups.  The plain
version rounds each fused step once (``_fma32``), the kernel uses ``fmaf``
and is built with ``--fmad=false``; ``tests/test_torch_zsplat_accum.py``
holds the plain version equal to the interpreted Pallas kernel in the three
call shapes.

Wrapper note (``accumulate_max_groups_cuda``): replaces
``topsy_tpu/ops/zsplat_pallas.py::accumulate_max_groups_pallas``; on the
H100 it is bound by the float32 hemisphere evaluations (rows_eval x
cols_eval x G per active group); the kernel (``csrc/zsplat_accum.cu``)
stages a group's particles in shared memory once per 16 x 32 pixel tile,
skips particles outside a pixel's footprint before the square root, and
merges each pixel's winner with one 64-bit ``atomicMax``.
"""

from __future__ import annotations

import ctypes

import torch

from .splat_accum import (FULL_CLASS, PROFILE_COLS, SIZE_CLASSES,
                          WINDOW_COLS, WINDOW_ROWS, _check)

NEG = -3.0e38  # the reference's effectively -inf depth

FLAG_SKIP = 0      # no valid fragment in the group
FLAG_ACTIVE = 1    # active: combined flag is FLAG_ACTIVE * 4 + size_class

FOOT = 8.0         # footprint truncation, as splat_atlas.FOOT

#: launches of the CUDA kernel (incremented only where it is launched)
launches = 0

#: (group, row, column, particle) entries per step of the plain version
#: (bounds its memory)
_BATCH_ELEMS = 1 << 22

_TWO32 = 1 << 32
_TWO31 = 1 << 31


def sum_order(group: int, cols_eval: int) -> int:
    """How the reference's ``dy^2 + dx^2`` is rounded on the CPU for this
    call shape: 0 separately, 1 as ``fma(dx, dx, dy^2)``, 2 as ``fma(dy,
    dy, dx^2)`` (see the module note)."""
    if cols_eval <= 64:
        return 2
    return 1 if group >= 128 else 0


def class_extents(sz: int, window_rows: int, profile_cols: int):
    """(rows_eval, cols_eval) of size class ``sz``, as ``_group_body``."""
    r_e, c_e = SIZE_CLASSES[sz]
    rows_eval = window_rows if r_e is None else min(r_e, window_rows)
    cols_eval = profile_cols if c_e is None else min(c_e, profile_cols)
    return rows_eval, cols_eval


def _sord(x: torch.Tensor) -> torch.Tensor:
    """Order-preserving float32 -> int32 (as int64), -0.0 taken as +0.0."""
    i = (x + 0.0).view(torch.int32)
    return torch.where(i >= 0, i, i ^ 0x7FFFFFFF).to(torch.int64)


def _from_sord(s: torch.Tensor) -> torch.Tensor:
    i = s.to(torch.int32)
    return torch.where(i >= 0, i, i ^ 0x7FFFFFFF).view(torch.float32)


def pack_keys(depth: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    """int64 keys ordered as the (depth, value) lexicographic order."""
    return _sord(depth) * _TWO32 + (_sord(value) + _TWO31)


def pack_atlas(atlas: torch.Tensor) -> torch.Tensor:
    """(2=[depth, value], R, C) f32 atlas -> (R, C) int64 keys."""
    return pack_keys(atlas[0], atlas[1])


def unpack_atlas(keys: torch.Tensor) -> torch.Tensor:
    """(R, C) int64 keys -> (2=[depth, value], R, C) f32 atlas."""
    return torch.stack([_from_sord(keys >> 32),
                        _from_sord((keys & 0xFFFFFFFF) - _TWO31)])


def _fma32(a, b, c) -> torch.Tensor:
    """float32 a * b + c rounded once, as a fused multiply-add.  The product
    is exact in float64; the sum is rounded to odd in float64 (``s`` with
    its exact error ``e`` from TwoSum), which then rounds to float32
    correctly (53 >= 24 + 2 bits)."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    e = (p - (s - bb)) + (c - bb)
    bits = s.view(torch.int64)
    # toward zero when the rounding went away from zero, then force the
    # last bit odd; exact sums stay as they are
    away = (e != 0) & ((e > 0) != (s > 0))
    odd = torch.where(away, bits - 1, bits) | 1
    return torch.where(e != 0, odd, bits).view(torch.float64).float()


def _deposit_batch(flat, ay, ax, ih, pay, w0, cbase, c0: int, nr: int,
                   nc: int, order: int, atlas_rows: int, atlas_cols: int):
    """Merge the fragments of B groups over rows [0, nr) and columns
    [c0, c0 + nc) of their rectangles into the flat packed atlas ``flat``;
    ay/ax/ih (B, G), pay (B, 3, G).  Only the (group, row, column,
    particle) entries inside the footprint of a valid particle are
    evaluated."""
    dev = ay.device
    rows = torch.arange(nr, device=dev, dtype=torch.float32)
    cols = torch.arange(c0, c0 + nc, device=dev, dtype=torch.float32)
    dy = ((w0.to(torch.float32)[:, None] + rows[None, :])[:, :, None]
          - ay[:, None, :])                                    # (B,R,G)
    dx = ((cbase.to(torch.float32)[:, None] + cols[None, :])[:, :, None]
          - ax[:, None, :])                                    # (B,W,G)
    in_y = (dy > -FOOT) & (dy <= FOOT) & (ih > 0.0)[:, None, :]
    in_x = (dx > -FOOT) & (dx <= FOOT)
    b, r, w, g = torch.nonzero(in_y[:, :, None, :] & in_x[:, None, :, :],
                               as_tuple=True)
    dyv, dxv = dy[b, r, g], dx[b, w, g]
    if order == 0:
        sv = dyv * dyv + dxv * dxv
    elif order == 1:
        sv = _fma32(dxv, dxv, dyv * dyv)
    else:
        sv = _fma32(dyv, dyv, dxv * dxv)
    ihv = ih[b, g]
    t = _fma32(-sv, ihv * ihv, torch.full_like(sv, 4.0))
    # the square root rounded correctly: float32 sqrt of PyTorch's CPU
    # kernels is not (about 0.6% of inputs), the float64 one rounded to
    # float32 is
    k = torch.sqrt(torch.clamp(t, min=0.0).double()).float()
    dep = _fma32(k, pay[b, 1, g], pay[b, 0, g])
    arow = w0[b].long() + r
    acol = cbase[b].long() + c0 + w
    ok = ((t > 0.0) & (arow >= 0) & (arow < atlas_rows) & (acol >= 0)
          & (acol < atlas_cols))
    flat.scatter_reduce_(0, (arow * atlas_cols + acol)[ok],
                         pack_keys(dep[ok], pay[b, 2, g][ok]), "amax")


def accumulate_max_packed_plain(keys, ay_g, ax_g, ih_g, pay_g, w0, c0, ce,
                                flags, *, group: int,
                                window_cols: int = WINDOW_COLS,
                                window_rows: int = WINDOW_ROWS):
    """The plain deposit into packed keys (R, C) int64, in place.

    Groups of one size class are batched, at most ``_BATCH_ELEMS``
    (group, row, column, particle) entries a step; the fragments inside a
    valid particle's footprint are evaluated and merged with
    ``scatter_reduce_(..., 'amax')`` (the max of packed keys is the group's
    winner and the atlas merge at once)."""
    n = w0.shape[0]
    G = group
    atlas_rows, atlas_cols = keys.shape
    ay = ay_g.reshape(n, G)
    ax = ax_g.reshape(n, G)
    ih = ih_g.reshape(n, G)
    pay = pay_g.reshape(n, 3, G)
    profile_cols = PROFILE_COLS if window_cols == WINDOW_COLS else window_cols
    rolled = profile_cols != window_cols
    cbase = ce if rolled else c0
    flat = keys.view(-1)
    for sz in (range(len(SIZE_CLASSES)) if rolled else (FULL_CLASS,)):
        sel = torch.nonzero(flags == FLAG_ACTIVE * 4 + sz).flatten()
        if sel.numel() == 0:
            continue
        rows_eval, cols_eval = class_extents(sz, window_rows, profile_cols)
        order = sum_order(G, cols_eval)
        nc = max(1, min(cols_eval, _BATCH_ELEMS // (rows_eval * G)))
        step = max(1, _BATCH_ELEMS // (rows_eval * nc * G))
        for s in range(0, sel.numel(), step):
            idx = sel[s:s + step]
            for c0_ in range(0, cols_eval, nc):
                _deposit_batch(flat, ay[idx], ax[idx], ih[idx], pay[idx],
                               w0[idx], cbase[idx], c0_,
                               rows_eval, min(nc, cols_eval - c0_), order,
                               atlas_rows, atlas_cols)
    return keys


def accumulate_max_groups_plain(ay_g, ax_g, ih_g, pay_g, w0, c0, ce, flags,
                                *, atlas_rows: int, atlas_cols: int,
                                group: int, atlas0=None,
                                window_cols: int = WINDOW_COLS,
                                window_rows: int = WINDOW_ROWS):
    """Plain PyTorch deposit with the reference's arguments and result:
    ay/ax/ih (n_groups, 1, G) with ih <= 0 marking invalid particles; pay
    (n_groups, 3, G) = [z01, h_clip_half, value]; w0/c0/ce/flags
    (n_groups,) int32; returns the (2=[depth, value], atlas_rows,
    atlas_cols) atlas merged onto ``atlas0`` (zeros if None)."""
    if atlas0 is None:
        atlas0 = torch.zeros((2, atlas_rows, atlas_cols), dtype=torch.float32,
                             device=w0.device)
    keys = pack_atlas(atlas0)
    accumulate_max_packed_plain(keys, ay_g, ax_g, ih_g, pay_g, w0, c0, ce,
                                flags, group=group, window_cols=window_cols,
                                window_rows=window_rows)
    return unpack_atlas(keys)


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------

def _bind():
    from . import cuda_build
    lib = cuda_build.library("zsplat_accum")
    fn = lib.topsy_accumulate_max_groups
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, P, P, P, P, P,
                       I, I, I, I, I, I, I, I, ctypes.c_float, P]
        fn.restype = I
    return fn


def accumulate_max_packed_cuda(keys, ay_g, ax_g, ih_g, pay_g, w0, c0, ce,
                               flags, *, group: int,
                               window_cols: int = WINDOW_COLS,
                               window_rows: int = WINDOW_ROWS):
    """Launch kernel K3 (``csrc/zsplat_accum.cu``) on the current stream,
    merging into the packed keys (R, C) int64 in place."""
    global launches
    n = w0.shape[0]
    G = group
    dev = w0.device
    atlas_rows, atlas_cols = keys.shape
    ay = ay_g.reshape(n, G)
    ax = ax_g.reshape(n, G)
    ih = ih_g.reshape(n, G)
    pay = pay_g.reshape(n, 3, G)
    for name, t in (("ay", ay), ("ax", ax), ("ih", ih)):
        _check(t, name, torch.float32, (n, G), dev)
    _check(pay, "pay", torch.float32, (n, 3, G), dev)
    for name, t in (("w0", w0), ("c0", c0), ("ce", ce), ("flags", flags)):
        _check(t, name, torch.int32, (n,), dev)
    _check(keys, "keys", torch.int64, (atlas_rows, atlas_cols), dev)
    profile_cols = PROFILE_COLS if window_cols == WINDOW_COLS else window_cols
    rolled = int(profile_cols != window_cols)
    orders = sum(sum_order(G, class_extents(sz, window_rows,
                                            profile_cols)[1]) << (2 * sz)
                 for sz in range(len(SIZE_CLASSES)))
    fn = _bind()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(ay.data_ptr(), ax.data_ptr(), ih.data_ptr(), pay.data_ptr(),
             w0.data_ptr(), c0.data_ptr(), ce.data_ptr(), flags.data_ptr(),
             keys.data_ptr(), n, G, atlas_rows, atlas_cols, window_rows,
             profile_cols, rolled, orders, FOOT, stream)
    if err != 0:
        raise RuntimeError(f"accumulate_max_groups kernel launch failed: "
                           f"cudaError {err}")
    launches += 1
    return keys


def accumulate_max_groups_cuda(ay_g, ax_g, ih_g, pay_g, w0, c0, ce, flags, *,
                               atlas_rows: int, atlas_cols: int, group: int,
                               atlas0=None, window_cols: int = WINDOW_COLS,
                               window_rows: int = WINDOW_ROWS):
    """Kernel K3 with the reference's arguments and (2, R, C) result."""
    if atlas0 is None:
        atlas0 = torch.zeros((2, atlas_rows, atlas_cols), dtype=torch.float32,
                             device=w0.device)
    keys = pack_atlas(atlas0)
    accumulate_max_packed_cuda(keys, ay_g, ax_g, ih_g, pay_g, w0, c0, ce,
                               flags, group=group, window_cols=window_cols,
                               window_rows=window_rows)
    return unpack_atlas(keys)


def accumulate_max_packed(keys, *args, **kw):
    """The deposit into packed keys: kernel K3 for CUDA tensors, the plain
    version for CPU tensors.  Same arguments as
    ``accumulate_max_packed_plain``."""
    if keys.is_cuda:
        return accumulate_max_packed_cuda(keys, *args, **kw)
    if keys.device.type != "cpu":
        raise ValueError(f"accumulate_max_packed: unsupported device "
                         f"{keys.device}")
    return accumulate_max_packed_plain(keys, *args, **kw)
