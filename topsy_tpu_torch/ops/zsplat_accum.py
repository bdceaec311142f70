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

Wrapper note (``accumulate_max_packed_cuda``): replaces
``topsy_tpu/ops/zsplat_pallas.py::accumulate_max_groups_pallas``; on the
H100 its least time is the float32 work of the fragments (the pixels of
each valid particle's +-8 footprint inside its group's rectangle, a square
root per hit).  The kernel (``csrc/zsplat_accum.cu``) launches no block for
an inactive group: a plan kernel sorts the active groups by size class on
the card (``deposit_plan`` is its plain version) and one persistent launch
per class walks them.  A block stages its group once, culls each particle
to its box, the rows and columns where it can hit (``particle_boxes``),
visits only the panels of the rectangle that a box meets
(``tile_lists``), merges the hits into the panel's keys in shared memory
and then each touched pixel into the atlas with one 64-bit ``atomicMax``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .splat_accum import (FULL_CLASS, PROFILE_COLS, SIZE_CLASSES,
                          WINDOW_COLS, WINDOW_ROWS, _check)

NEG = -3.0e38  # the reference's effectively -inf depth

FLAG_SKIP = 0      # no valid fragment in the group
FLAG_ACTIVE = 1    # active: combined flag is FLAG_ACTIVE * 4 + size_class

FOOT = 8.0         # footprint truncation, as splat_atlas.FOOT

#: launches of the CUDA kernel (incremented only where it is launched) and
#: of its plan kernel (once per kernel call and per ``deposit_plan_cuda``)
launches = 0
plan_launches = 0

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


def _profile_cols(window_cols: int) -> int:
    """The columns a call's rectangles span: the profile of a windowed
    (rolled) call, else the whole window."""
    return PROFILE_COLS if window_cols == WINDOW_COLS else window_cols


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
    profile_cols = _profile_cols(window_cols)
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
# the kernel's work list and cull, in plain PyTorch
# ---------------------------------------------------------------------------

#: the kernel's panel per size class: (rows, columns) of the class rectangle
#: whose keys a block holds in shared memory at a time
PANELS = ((16, 32), (32, 64), (48, 128), (48, 128))

#: largest group the kernel takes
KERNEL_MAX_G = 2048

#: atlas extent the kernel takes (its anchors are cut at 2^23)
KERNEL_MAX_EXTENT = 1 << 22


def _dispatched(flags: torch.Tensor, rolled: bool) -> torch.Tensor:
    """The size class of each group the deposit dispatches (active, and of
    any class in rolled launches, else of the full class), else
    ``len(SIZE_CLASSES)``."""
    sz = flags % 4
    dep = (flags // 4 == FLAG_ACTIVE) & ((sz == FULL_CLASS) | rolled)
    return torch.where(dep, sz, len(SIZE_CLASSES))


def deposit_plan(flags: torch.Tensor, rolled: bool):
    """The kernel's work list, as its plan kernel computes it on the card.

    Returns int32 tensors ``(order, class_off)``: ``order`` lists the groups
    the deposit dispatches sorted stably by size class, then the others;
    class k is ``order[class_off[k]:class_off[k + 1]]`` (k < 4)."""
    nclass = len(SIZE_CLASSES)
    skey, order = torch.sort(_dispatched(flags, rolled).long(), stable=True)
    class_off = torch.searchsorted(
        skey, torch.arange(nclass + 1, device=flags.device), out_int32=True)
    return order.to(torch.int32), class_off


def _hit_interval(a, ih2, base, n, limit):
    """[lo, hi] offsets o in [0, n) from ``base`` (B, 1) at which positions
    ``a`` (B, G) can hit, as the kernel's ``hit_interval``: atlas index
    base + o in [0, limit), -FOOT < d <= FOOT and fl(d^2) * ih2 < 4 (exact:
    the float32 product of two floats is exact in float64), d = float(base
    + o) - a; (B, G) int64 each, lo > hi when empty."""
    k = torch.floor(torch.where(torch.isfinite(a), a, 0.0)).long()
    x = k[..., None] + torch.arange(-8, 10, device=a.device)   # (B, G, 18)
    o = x - base[..., None]
    d = x.float() - a[..., None]
    ok = ((o >= 0) & (o < n[..., None]) & (x >= 0) & (x < limit) & (d > -FOOT)
          & (d <= FOOT)
          & ((d * d).double() * ih2[..., None].double() < 4.0))
    big = torch.iinfo(torch.int64).max
    lo = torch.where(ok, o, big).amin(-1)
    hi = torch.where(ok, o, -big).amax(-1)
    return lo, hi


def particle_boxes(ay_g, ax_g, ih_g, w0, c0, ce, flags, *, group: int,
                   atlas_rows: int, atlas_cols: int,
                   window_cols: int = WINDOW_COLS,
                   window_rows: int = WINDOW_ROWS):
    """Each particle's box, as the kernel computes it: the rows and columns
    of its group's rectangle (offsets from w0 and the column base) where a
    fragment can hit (t > 0), clipped to the rectangle and the atlas.
    Every hit satisfies fl(dy^2) * ih^2 < 4 and fl(dx^2) * ih^2 < 4 (s is
    at least either square in every summation order), so the box holds
    every fragment that can change the atlas.  Returns int32 (n_groups, G,
    4) [row lo, row hi, col lo, col hi]; (1, 0, 1, 0) (empty) for invalid
    particles and for groups the deposit does not dispatch."""
    n = w0.shape[0]
    G = group
    ay = ay_g.reshape(n, G)
    ax = ax_g.reshape(n, G)
    ih = ih_g.reshape(n, G)
    profile_cols = _profile_cols(window_cols)
    rolled = profile_cols != window_cols
    cbase = (ce if rolled else c0).long()[:, None]
    cls = _dispatched(flags, rolled)
    ext = torch.tensor([class_extents(sz, window_rows, profile_cols)
                        for sz in range(len(SIZE_CLASSES))] + [(0, 0)],
                       device=w0.device)[cls.long()]            # (n, 2)
    ih2 = ih * ih
    far = (torch.abs(ay) < 2.0 ** 23) & (torch.abs(ax) < 2.0 ** 23)
    r_lo, r_hi = _hit_interval(ay, ih2, w0.long()[:, None], ext[:, :1],
                               atlas_rows)
    c_lo, c_hi = _hit_interval(ax, ih2, cbase, ext[:, 1:], atlas_cols)
    ok = (ih > 0.0) & far & (r_lo <= r_hi) & (c_lo <= c_hi)
    box = torch.stack([r_lo, r_hi, c_lo, c_hi], dim=-1)
    empty = torch.tensor([1, 0, 1, 0], device=w0.device)
    return torch.where(ok[..., None], box, empty).to(torch.int32)


def tile_lists(boxes, flags, *, window_cols: int = WINDOW_COLS,
               window_rows: int = WINDOW_ROWS):
    """The kernel's per-panel cull: {(group, panel row, panel column):
    int64 indices of the group's particles whose box meets the panel} over
    the panels (``PANELS`` of the group's size class tiling its rectangle)
    that at least one box meets.  The kernel visits these panels only, and
    in each evaluates each listed particle over its box inside the panel."""
    profile_cols = _profile_cols(window_cols)
    rolled = profile_cols != window_cols
    cls = _dispatched(flags, rolled)
    out = {}
    for g in torch.nonzero(cls < len(SIZE_CLASSES)).flatten().tolist():
        sz = int(cls[g])
        rows_eval, cols_eval = class_extents(sz, window_rows, profile_cols)
        pr, pc = PANELS[sz]
        b = boxes[g].long()
        for r0 in range(0, rows_eval, pr):
            for c0 in range(0, cols_eval, pc):
                meets = ((torch.minimum(b[:, 1], torch.tensor(r0 + pr - 1))
                          >= torch.clamp(b[:, 0], min=r0))
                         & (torch.minimum(b[:, 3], torch.tensor(c0 + pc - 1))
                            >= torch.clamp(b[:, 2], min=c0)))
                idx = torch.nonzero(meets).flatten()
                if idx.numel():
                    out[(g, r0 // pr, c0 // pc)] = idx
    return out


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _bind(build_defines=()):
    """(kernel call, plan call) of the library built with ``build_defines``,
    bound once."""
    from . import cuda_build
    lib = cuda_build.library("zsplat_accum", build_defines)
    fn, plan = lib.topsy_accumulate_max_groups, lib.topsy_zdeposit_plan
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, P, P, P, P, P, P, P, P, P,
                   I, I, I, I, I, I, I, I, I, ctypes.c_float, P]
    fn.restype = I
    plan.argtypes = [P, I, I, P, P]
    plan.restype = I
    return fn, plan


@functools.lru_cache(maxsize=None)
def _call_constants(G: int, window_rows: int, window_cols: int):
    """(profile_cols, rolled, orders) of one call shape: ``orders`` holds
    each size class's ``sum_order`` in 2 bits."""
    profile_cols = _profile_cols(window_cols)
    orders = sum(sum_order(G, class_extents(sz, window_rows,
                                            profile_cols)[1]) << (2 * sz)
                 for sz in range(len(SIZE_CLASSES)))
    return profile_cols, int(profile_cols != window_cols), orders


def deposit_plan_cuda(flags: torch.Tensor, rolled: bool):
    """``deposit_plan`` by the kernel's plan kernel (for CUDA flags)."""
    global plan_launches
    _check(flags, "flags", torch.int32, flags.shape, flags.device)
    n = flags.shape[0]
    out = torch.empty(n + len(SIZE_CLASSES) + 1, dtype=torch.int32,
                      device=flags.device)
    err = _bind()[1](flags.data_ptr(), n, int(rolled), out.data_ptr(),
                     torch.cuda.current_stream(flags.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"zdeposit plan kernel launch failed: cudaError "
                           f"{err}")
    if n:
        plan_launches += 1
    return out[:n], out[n:]


def accumulate_max_packed_cuda(keys, ay_g, ax_g, ih_g, pay_g, w0, c0, ce,
                               flags, *, group: int,
                               window_cols: int = WINDOW_COLS,
                               window_rows: int = WINDOW_ROWS,
                               build_defines=()):
    """Launch kernel K3 (``csrc/zsplat_accum.cu``) on the current stream,
    merging into the packed keys (R, C) int64 in place: the plan kernel,
    then one launch per size class the call can dispatch.
    ``build_defines``: the ``-D`` flags of a breakdown build of the kernel
    with one part switched off (``k2_variants.py``); none for the port's."""
    global launches, plan_launches
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
    profile_cols, rolled, orders = _call_constants(G, window_rows,
                                                   window_cols)
    if not 1 <= G <= KERNEL_MAX_G:
        raise ValueError(f"group {G} outside [1, {KERNEL_MAX_G}]")
    if (max(atlas_rows, atlas_cols, window_rows, profile_cols)
            >= KERNEL_MAX_EXTENT or window_rows < 0):
        raise ValueError(f"atlas ({atlas_rows}, {atlas_cols}) or window "
                         f"({window_rows}, {profile_cols}) outside the "
                         f"kernel's [0, {KERNEL_MAX_EXTENT})")
    plan = torch.empty(n + len(SIZE_CLASSES) + 1, dtype=torch.int32,
                       device=dev)
    vec_in = int(G % 4 == 0 and all(t.data_ptr() % 16 == 0
                                    for t in (ay, ax, ih, pay)))
    fn = _bind(tuple(build_defines))[0]
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(ay.data_ptr(), ax.data_ptr(), ih.data_ptr(), pay.data_ptr(),
             w0.data_ptr(), c0.data_ptr(), ce.data_ptr(), flags.data_ptr(),
             plan.data_ptr(), keys.data_ptr(), n, G, atlas_rows, atlas_cols,
             window_rows, profile_cols, rolled, vec_in, orders, FOOT, stream)
    if err != 0:
        raise RuntimeError(f"accumulate_max_groups kernel launch failed: "
                           f"cudaError {err}")
    launches += 1
    if n:
        plan_launches += 1
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
