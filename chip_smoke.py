"""Smoke run of the PyTorch/CUDA port (topsy_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--mesh-only]

Builds the port's hand-written kernels from this checkout (the CUDA feed
kernel K1, the CUDA deposit kernel K2 and the CUDA z-buffer kernel K3, into
build/torch_kernels/; the host presort's native library into
build/torch_native/), builds the 2^24-particle synthetic snapshot at
1024x1024 with the (density, mass * quantity) channels — the scene bench.py
renders — through ``Visualizer(..., device="cuda")``, whose constructor
renders the lazy policy's one-shot EXPORT (the per-frame-sorted block
path, no presort) and whose store then presorts on the card.  Phase P times that device presort (and its decimation-mip
tier) beside the host presort, checks the layout's invariants on the card
and the mip tier as exactly its parent's first columns, and fails if the
scene took the host fallback.  It holds K1 and K2 against their plain
PyTorch versions on the card at the shapes the EXPORT path gives them
(every piece of the renderer's piece loop), then K1 alone (phase K1o) at
G = 189 (its lane-by-lane path) and on lanes with NaN, infinite, zero and
negative h and NaN or infinite positions, drives the univariate EXPORT
path (warm-up and timed frames, the SPH image and the presentation image)
and checks the image against the port's scatter ground truth.  Phase D
drives bench.py's own path, ``TestDataDeviceLoader`` through a second
Visualizer: the time to its first EXPORT image by the lazy policy (the
sorted block path) and with the presort built first, its EXPORT frames and
the image against the scatter truth.  On the scene's Visualizer it drives the
interactive path (phase I): K1 and K2 against their plain versions, each
call timed alone beside its plain version and its bound, on column slices
of the main layout (one quantum wide, three, the REFINE launch above the
mip's columns, the full width) and on the mip tier's CHANGE launch; seven
views, each a CHANGE draw (the first on the mip tier, held as a fair
subsample of its view's EXPORT image) and the REFINE draws that complete
it, timed by the frame clock from the first launch to the end of the
presentation readback, the completed images against the EXPORT image of
their view, and a zoomed-out view where the giant layer runs, against the
scatter truth and its EXPORT image.  On the same store it drives the other
additive modes (phases M1-M4): RGB and RGB-HDR (K1 with three value rows
and K2 at C = 3 held on every call of the first piece, EXPORT frames, each
band against the scatter truth, both presentations), bivariate (EXPORT
frames, the 2-D LUT presentation), the depth pick (one CHANGE frame of the
tier its progression picks, K1's depth channel and K2 at C = 3 held on
every call of its launch, the picked depth against the scatter truth of the
same particles) and periodic tiling (EXPORT frames, the lattice composite
against a float64 one).  Then it switches the same Visualizer to the
surface mode and, at the default density cut and at the lowest one (every
particle, much of the image covered), holds K3 bit-identical to its plain
version on every K3 call of the main layout's full-width column launch
(plus forced stragglers), drives the surface EXPORT path (each tier's own
columns) and checks its (value, depth) image against the port's
scatter-max ground truth; and drives the interactive surface (phase SI:
K3 on main-layout slices, its REFINE launch and the mip tier's CHANGE
launch, five views timed by the frame clock, the completed image against
EXPORT, and a view zoomed out only as far as the surface giant layer
runs, against the scatter truth, with the layer alone against its own
float64 evaluation over every particle the windowed deposit excluded).
Phases L1-L5 drive the block paths: a fresh renderer's
one-shot EXPORT through the sorted path (K2 at G = 512 with 64-row windows
and tier 2 at G = 64, every call held against its plain version, the
image against the scatter truth and the presorted EXPORT, its time beside
the presort plus the presorted frame, the dense giant layer of each of its
pieces timed alone, then the second EXPORT presorts), small scenes (2^16
and 2^13 particles at 256^2: K2 at G = 128 and 64, tier 2 at 16, held per
call), CHANGE and REFINE frames of the scene without the column
progression (a barrier after each block, per-block CUDA-event times, to
completion, against EXPORT; K2 at G = 128 and tier 2 at 16 held on every
call of the first two frames) and the surface scatter fallback against the
column path's surface image.  Phase A times the exact device kNN
(``ops/knn_device.py``, 64 neighbours) on the scene's first 2^18 to 2^24
positions, each of its passes apart, holds its peak allocation under its
memory bound, holds it at 2^20 against the native host kNN and a KD-tree,
and
times an ``ArrayDataLoader`` Visualizer over 2^22 positions without
smoothing lengths to its first image, against its scatter truth.  Phase
G drives the particle mesh (``parallel/``, ``render/distributed.py``) at
the scene's full size: one shard per card, or two shards on one card
(then it says that the branch with one shard per card, peer copies and
NCCL did not run).  A mesh Visualizer (``Visualizer(mesh=...)``) over the
scene's loader: its lazy first EXPORT through the strided sorted path
(shard 0's K2 calls held), its slabs and mip tiers, presorted EXPORT
frames (shard 0's K1 and K2 calls held, the combine and each shard's
launch timed alone, one frame traced by torch.profiler into
build/mesh_export_<D>.trace.json with each card's kernel span and busy
time printed) against the single device's EXPORT and the scatter
truth; interactive views to completion against the mesh's EXPORT; RGB
and the depth pick against the single device; the surface at the default
cut and zoomed out (shard 0's K3 calls held bit-identical, the giant
layer alone against its float64 evaluation) against the single device;
periodic tiling; and two processes over 2^22 rows split unequally through
``parallel/multiprocess.py`` (NCCL where each has a card, gloo where they
share one; the negotiated slab length, both exit codes, a timeout) against
one process's mesh.  Phase H drives the host shell on the scene's
Visualizer: ``save`` to ``.npy`` (bit for bit ``get_sph_image()``),
``.tif`` (float16 RGB equal to the presentation of the same frame) and a
figure (its ImportError where matplotlib is absent); a recorded session
(a rotation, a zoom, a vmin/vmax change, explicit timestamps) replayed as
30 EXPORT frames at 1024^2 through the recorder, each timed by CUDA
events, the first against a direct EXPORT at the recorded starting view,
``save_mp4`` where cv2 imports and the timestream through its pickle; two
synchronised Visualizers over ``TestDataDeviceLoader(2**22)`` against a
fresh render at their view; one EXPORT frame traced by
``performance.trace`` (its span, the card's busy time, the idle share and
the kernels run); the command line ``topsy_tpu_torch test://16777216 -r
1024`` in process through the offscreen canvas; and the status line of
one CHANGE frame (the fps of the frame clock's CUDA events).
``--mesh-only`` runs the scene and phase G alone, on every card of the
machine.  It prints:

* the card's name and power limit (nvidia-smi);
* ptxas' registers, stack and spills for every K1, K2 and K3 kernel
  instantiation;
* per timed K1 call, beside its time back to back by CUDA events, the
  kernel's own time (torch.profiler's kernel durations) and the
  wrapper's host time per call (``k1_costs``);
* per K2 call its groups by (kind, size class), the atlas entries it
  deposits, how many are nonzero and how many float4 reductions carry
  them, its bound (bytes, bf16 and float32 operations), and for the main
  pass and tier 2 the runs of consecutive groups sharing a window;
* per K3 call its plan (the card's, checked equal to the plain one) by
  size class, the panels it visits, its cull's list entries, the (pixel,
  particle) pairs it evaluates against the fragments and hits its bound
  counts, and its global atomics; each timed K3 call restarts from its own
  starting atlas;
* phase P's device and host presort times, the layout's runs and tiers
  with their real counts; phase D's time to the first image and EXPORT
  frame;
* per interactive frame its time, column ranges, dropped splats, mass
  scale and tier (deepest mip 0, the main layout last), and per view its
  frames to completion;
* one ``{"kernels": [...]}`` JSON line: per kernel its launches on each
  path that runs it (each path's counts zeroed just before it and read
  just after), its largest difference from the plain version, the
  kernel's and the plain version's time, the bound (the least time the
  card could take for the same work: bytes over 3.35 TB/s or operations
  over the peak rate of their type, whichever is larger) and the library
  call's time (null: no single PyTorch call computes any of the three);
  for K1 and K2 also every interactive call of phase I1 and every timed
  call of phase M (C = 3, the depth channel), its time, its plain
  version's and its bound; for K3 every timed call of phases S2 and SI;
  and K2 once more for each block path of phase L (``sorted``,
  ``sorted_small``, ``sorted_blocks``), with the launches of that path's
  run and its calls' shapes; phase H's paths are ``save``,
  ``recorder_replay``, ``synchronised_export``, ``profiled_export``,
  ``cli`` and ``status_frame``;
* last, ``{"ok": true, "device": {...}}``.

Every phase raises on failure, so the script exits nonzero and prints no
result; it also exits nonzero when no CUDA device is available.
"""

from __future__ import annotations

import copy
import json
import logging
import os
import statistics
import subprocess
import sys
import time
from contextlib import contextmanager

N_PARTICLES = 1 << 24
RESOLUTION = 1024
FRAMES = 5

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
# float32 operations of K3's work (a fused multiply-add counts 2): dy, dy^2
# per particle and footprint row and dx, dx^2 per particle and footprint
# column; the fused s = dy^2 + dx^2 and t = 4 - s ih^2 per fragment (a
# pixel of the class rectangle inside a valid particle's footprint); the
# square root, the fused depth z + k h and the winner comparison per hit
# (a fragment with t > 0)
K3_OPS_PER_LINE = 2
K3_OPS_PER_FRAGMENT = 4
K3_OPS_PER_HIT = 4
# float32 operations of K1 per particle slot: projection (3 fused rows,
# 18), level and norm polynomial (degree 12, 24), anchors, fits and
# coefficients (about 18)
K1_OPS_PER_SLOT = 60
# float32 operations of K2's profiles per (row or column, live particle):
# inside the particle's support two degree-6 Horner evaluations, 12 fused
# multiply-adds (a fused multiply-add counts 2); outside it, where t2 is
# clamped to 4 and the profiles are constants, one select; a tiny
# particle's hat 1 - |d| clipped at 0
K2_OPS_PER_POLY_LINE = 24
K2_OPS_PER_CLAMPED_LINE = 1
K2_OPS_PER_HAT_LINE = 3
# the surface frames: the default density cut (the 50th percentile) and
# the lowest one, which keeps every particle and covers much of the image
SURFACE_CUTS = (("cut50", 50.0), ("cut0", 0.0))
# the periodic TestDataLoader's box (loaders.TestDataLoader(periodic=True))
PERIODICITY = 100.0
# phase A runs the device kNN at 2^24 only when 2^22's time predicts it
# inside this many milliseconds
KNN_BUDGET_MS = 120_000.0


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond, msg: str):
    if not bool(cond):
        fail(msg)


def log(msg: str):
    print(msg, flush=True)


def timed_ms(fn, reps: int) -> float:
    """Mean milliseconds per call on the current stream (CUDA events)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timed_from_ms(fn, reset, reps: int) -> float:
    """Mean milliseconds of one call on the current stream (CUDA events
    around each call alone), ``reset()`` restoring the call's starting
    state before each call, outside the events."""
    import torch
    reset()
    fn()
    total = 0.0
    for _ in range(reps):
        reset()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def bound(nbytes: float, ops: float, ops_per_s: float):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate of their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def build_scene(dev):
    """The smoke scene, ``bench.py``'s: the seeded 2^24-particle
    TestDataLoader snapshot at 1024x1024, (density, mass * quantity), scale
    200, through ``Visualizer(..., device=dev)``, whose constructor renders
    the one-shot EXPORT of the lazy policy (the sorted block path); the
    presort is then built explicitly and one presorted EXPORT frame
    rendered.  Returns the Visualizer."""
    from topsy_tpu_torch.loaders import TestDataLoader
    from topsy_tpu_torch.visualizer import (DrawReason, OffscreenCanvas,
                                            Visualizer)
    vis = Visualizer(data_loader_class=TestDataLoader,
                     data_loader_args=(N_PARTICLES,),
                     data_loader_kwargs={"seed": 1337},
                     render_resolution=RESOLUTION,
                     canvas_class=OffscreenCanvas, device=dev)
    vis.show_status = False
    # the constructor's EXPORT (the colormap's autorange) is the lazy
    # policy's one-shot image: the sorted block path, no presort
    check(vis.store.presorted_layout is None, "the scene's first EXPORT "
          "built the presort")
    vis.store.ensure_presorted()
    vis.quantity_name = "test-quantity"
    vis.scale = 200.0
    vis._sph.render(DrawReason.EXPORT)
    return vis


def feed_args(vis, piece, sph=None):
    """K1's (args, kwargs) for one piece, exactly as the renderer ``sph``
    (the Visualizer's by default) feeds it: its buffer, its depth
    channel."""
    import numpy as np
    from topsy_tpu_torch.ops import splat_atlas
    sph = vis._sph if sph is None else sph
    store = vis.store
    fields, values_cm, gb, mask = tier_arrays(store, sph, store.main_tier)
    return splat_atlas.feed_call(
        fields, values_cm, sph._matrix().astype(np.float32), RESOLUTION,
        np.float32(sph.scale), gb, mask=mask,
        depth_channel=sph._depth_channel, piece=piece,
        bucket_thresh=sph._giant_bucket)


def tier_arrays(store, sph, tier):
    """(fields, channel-major values, group buckets, cull mask) of the
    renderer ``sph``'s buffer over ``tier``: the main layout
    (``store.main_tier``) or a decimation mip
    (``store.ensure_column_mips()[i]``), exactly as its launches read
    them."""
    return (tier.fields(), tier.values_cm_for(sph._buffer_name),
            tier.group_buckets, sph._feed_cull_mask(tier))


def k2_calls(feed_out, G, atlas_rows, atlas_cols):
    """({shape: K2 kwargs}, dropped) for the K2 calls that follow one
    feed: the main pass, spill tiers 2 and 3 and the forced stragglers.
    When every spilled particle fits its tier-2 window, the scene's tier-3
    call deposits nothing; a zero-row tier-2 window makes every gathered
    spilled particle a straggler, so the one-particle shape also runs on
    real anchors."""
    from topsy_tpu_torch.ops import splat_atlas
    common = dict(C=len(feed_out[3]), G=G, atlas_rows=atlas_rows,
                  atlas_cols=atlas_cols)
    main_kw, tier2_kw, tier3_kw, dropped = splat_atlas.deposit_calls(
        feed_out, **common)
    _, _, stragglers_kw, _ = splat_atlas.deposit_calls(
        feed_out, window_rows=0, **common)
    stragglers_kw["window_rows"] = splat_atlas.PRESORTED_WINDOW_ROWS
    return {"main": main_kw, "tier2": tier2_kw, "tier3": tier3_kw,
            "tier3_stragglers": stragglers_kw}, dropped


def surface_chunk_calls(vis, sl, cut, gb, **extra):
    """K3's calls for the column chunk ``sl`` of a surface EXPORT frame at
    density cut ``cut`` and giant bucket threshold ``gb``, with the
    one-particle-group tier 3 and four times the spill-group cap (phase
    S2): ``zsplat_atlas.deposit_calls``'s (main, tier2, tier3, dropped,
    atlas shape); ``extra``: more of its arguments (window_rows=0 forces
    stragglers)."""
    import numpy as np
    from topsy_tpu_torch.ops import splat_atlas, zsplat_atlas
    ssph, store = vis._sph, vis.store
    return zsplat_atlas.deposit_calls(
        store.pos_smooth_presorted[sl],
        store.presorted_values_for(ssph._buffer_name)[sl],
        ssph._matrix().astype(np.float32), RESOLUTION,
        np.float32(ssph.scale), store.presorted_buckets[sl], density_cut=cut,
        giants=gb, spill_group_cap=splat_atlas.COLUMN_SPILL_GROUP_CAP,
        t3_cap=splat_atlas.COLUMN_T3_CAP, **extra)


def k2_work(kw):
    """(bytes, bf16 FLOP, float32 FLOP) that one K2 call needs on this
    run's data.  Bytes: every input read once, the atlas read and written
    once.  Over the groups that deposit (the reference's dispatch rule) and
    their live particles (a nonzero coefficient): the bf16 product,
    2 (C rows_eval) cols_eval (rank n_live), rank 1 for ALL_TINY groups
    (every entry of a rectangle is nonzero in float32: the profiles'
    tails, phase K2); the float32 profiles, per row or column of the
    rectangle and live particle: for a tiny particle the hat
    (K2_OPS_PER_HAT_LINE), else, where the line lies inside the particle's
    support (d^2 ih^2 < 4, and inside the footprint for MASKED groups), two
    degree-6 Horner evaluations of fused multiply-adds
    (K2_OPS_PER_POLY_LINE), and outside it a select of the clamped
    constant (K2_OPS_PER_CLAMPED_LINE)."""
    import torch
    from topsy_tpu_torch.ops import splat_accum as sa
    flags, C, G = kw["flags"], kw["C"], kw["group"]
    dev = flags.device
    n = flags.shape[0]
    win = kw.get("window_cols", sa.WINDOW_COLS)
    prof = sa.PROFILE_COLS if win == sa.WINDOW_COLS else win
    rolled = prof != win
    cbase = kw["ce"] if rolled else kw["c0"]
    ay, ax, ih = (kw[k].reshape(n, G) for k in ("ay_g", "ax_g", "ih_g"))
    live = (sa._coef_channels(kw["coef_g"], C, n, G) != 0).any(dim=0)
    kind, sz = flags // 4, flags % 4
    bf16 = f32 = 0.0
    for k in range(sa.FLAG_ALL_TINY, sa.FLAG_MASKED + 1):
        for c in range(len(sa.SIZE_CLASSES)):
            if c != sa.FULL_CLASS and not (rolled and k <= sa.FLAG_POLY):
                continue                           # deposits nothing
            sel = torch.nonzero((kind == k) & (sz == c)).flatten()
            r, w = sa._extents(c, kw["window_rows"], prof)
            rank = 1 if k == sa.FLAG_ALL_TINY else 2
            for s in range(0, sel.numel(), 256):
                g = sel[s:s + 256]
                lv = live[g]
                bf16 += 2.0 * (C * r) * w * rank * int(lv.sum())
                tiny = ih[g] < 0 if k != sa.FLAG_ALL_TINY else \
                    torch.ones_like(lv)
                f32 += K2_OPS_PER_HAT_LINE * (r + w) * int((lv & tiny).sum())
                poly = (lv & ~tiny)[:, None, :]
                for lines, base, pos in ((r, kw["w0"][g], ay[g]),
                                         (w, cbase[g], ax[g])):
                    d = ((base[:, None].float() + torch.arange(
                        lines, device=dev, dtype=torch.float32))[:, :, None]
                        - pos[:, None, :])               # (B, lines, G)
                    inside = d * d * (ih[g] * ih[g])[:, None, :] < sa.SUPPORT2
                    if k == sa.FLAG_MASKED:
                        inside &= (d > -sa.FOOT) & (d <= sa.FOOT)
                    n_in = int((inside & poly).sum())
                    f32 += (K2_OPS_PER_POLY_LINE * n_in
                            + K2_OPS_PER_CLAMPED_LINE
                            * (lines * int(poly.sum()) - n_in))
    nbytes = n * G * (3 + C) * 4 + n * 16 + 2 * C * kw["atlas_rows"] * \
        kw["atlas_cols"] * 4
    return nbytes, bf16, f32


def k1_bound(fkw, G):
    """(bound_ms, bound_by) of one K1 call over ``fkw['piece_groups']``
    groups of G slots: per slot the four fields and the C_in values read
    and the three anchors and the C channels (C_in, plus the depth
    channel) of each of cfit and cspill written, per group its 8-float
    table row read and 5 integers written, all 4 bytes;
    ``K1_OPS_PER_SLOT`` float32 operations per slot."""
    groups = fkw["piece_groups"]
    slots = groups * G
    c_in = fkw["C_in"]
    c = c_in + int(fkw["depth_channel"])
    return bound(slots * (4 + c_in) * 4 + groups * 8 * 4
                 + slots * (3 + 2 * c) * 4 + groups * 5 * 4,
                 slots * K1_OPS_PER_SLOT, F32_OPS_PER_S)


def k2_bound(kw):
    """(bound_ms, bound_by, detail): the largest of bytes over the memory
    rate, bf16 operations over the tensor cores' rate and float32
    operations over the float32 rate."""
    nbytes, bf16, f32 = k2_work(kw)
    times = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "bf16 operations": bf16 / BF16_OPS_PER_S * 1e3,
             "float32 operations": f32 / F32_OPS_PER_S * 1e3}
    top = max(times, key=times.get)
    detail = ", ".join(f"{k} {v:.4f} ms" for k, v in times.items())
    return times[top], "bytes" if top == "bytes" else "operations", \
        f"{detail} ({top})"


def ptxas_resources(log_text: str):
    """(kernel, 'registers, shared memory, spills') per function of an
    ``nvcc -Xptxas -v`` log; K1's variants as <C_IN, DEPTH, RANGED,
    HAS_MASK>, K2's class kernels as <C, rows, columns>, K3's as <panel
    rows, panel columns>."""
    import re
    out, name = [], None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            t = re.search(r"deposit_class_kernelILi(\d+)ELi(\d+)ELi(\d+)E",
                          m.group(1))
            f = re.search(r"feed_kernelILi(\d)ELb([01])ELb([01])ELb([01])E",
                          m.group(1))
            z = re.search(r"zdeposit_class_kernelILi(\d+)ELi(\d+)E",
                          m.group(1))
            name = (f"feed_kernel<C_IN={f[1]}, DEPTH={f[2]}, "
                    f"RANGED={f[3]}, HAS_MASK={f[4]}>" if f else
                    f"deposit_class_kernel<C={t[1]}, rows={t[2]}, "
                    f"cols={t[3]}>" if t else
                    f"zdeposit_class_kernel<panel rows={z[1]}, cols={z[2]}>"
                    if z else
                    re.sub(r".*_cu_\w{8}\d+(\w+?)E.*", r"\1", m.group(1)))
            out.append([name, []])
        elif name and ("spill" in line or "registers" in line):
            out[-1][1].append(line.replace("ptxas info    :", "").strip())
    return [(n, "; ".join(r)) for n, r in out]


K2_KINDS = {1: "tiny", 2: "poly", 3: "mixed", 4: "masked"}


def k2_census(kw):
    """What one K2 call deposits: its groups by (kind, size class) as the
    flags give them, and over the groups that deposit (the reference's
    dispatch rule), the in-bounds entries of their rectangles, how many of
    those are nonzero (a scalar atomic add each, in a design that skips
    zeros) and how many four-column quads aligned to the atlas hold a
    nonzero entry (a float4 reduction each in K2).  The product is the
    plain version's (bf16 operands, f32 sums)."""
    import torch
    from topsy_tpu_torch.ops import kernels
    from topsy_tpu_torch.ops import splat_accum as sa
    flags, C, G = kw["flags"], kw["C"], kw["group"]
    dev = flags.device
    n = flags.shape[0]
    win = kw.get("window_cols", sa.WINDOW_COLS)
    prof = sa.PROFILE_COLS if win == sa.WINDOW_COLS else win
    rolled = prof != win
    cbase = kw["ce"] if rolled else kw["c0"]
    ay, ax, ih = (kw[k].reshape(n, G) for k in ("ay_g", "ax_g", "ih_g"))
    coef = sa._coef_channels(kw["coef_g"], C, n, G)
    lrk = kernels.lowrank_kernel()
    hist, entries, nonzero, quads = {}, 0, 0, 0
    for kind, kname in K2_KINDS.items():
        for sz in range(4):
            sel = torch.nonzero(flags == kind * 4 + sz).flatten()
            if sel.numel() == 0:
                continue
            hist[f"{kname}/{sz}"] = sel.numel()
            if sz != sa.FULL_CLASS and not (rolled and kind in (1, 2)):
                continue                          # deposits nothing
            R, W = sa._extents(sz, kw["window_rows"], prof)
            for s in range(0, sel.numel(), 256):
                g = sel[s:s + 256]
                rows = kw["w0"][g].long()[:, None] + torch.arange(R, device=dev)
                cols = cbase[g].long()[:, None] + torch.arange(W, device=dev)
                ok_r = (rows >= 0) & (rows < kw["atlas_rows"])
                ok_c = (cols >= 0) & (cols < kw["atlas_cols"])
                entries += C * int((ok_r.sum(1) * ok_c.sum(1)).sum())
                ihb = ih[g][:, None, :]
                P = sa._profiles(rows.float()[:, :, None] - ay[g][:, None, :],
                                 ihb, kind, lrk, True, sa.FOOT)
                Q = sa._profiles(cols.float()[:, :, None] - ax[g][:, None, :],
                                 ihb, kind, lrk, False, sa.FOOT)
                B, K = g.numel(), P.shape[1]
                pc = (P[:, :, None] * coef[:, g].permute(1, 0, 2)[
                    :, None, :, None, :]).bfloat16().float()
                a = pc.permute(0, 2, 3, 1, 4).reshape(B, C * R, K * G)
                b = Q.bfloat16().float().permute(0, 2, 1, 3).reshape(
                    B, W, K * G)
                out = torch.bmm(a, b.transpose(1, 2)).reshape(B, C, R, W)
                nz = ((out != 0) & ok_r[:, None, :, None]
                      & ok_c[:, None, None, :]).float()
                nonzero += int(nz.sum())
                shift = (cols[:, :1] % 4) + torch.arange(W, device=dev)
                aligned = torch.zeros((B, C, R, W + 8), device=dev)
                aligned.scatter_(3, shift[:, None, None, :].expand_as(nz), nz)
                quads += int(aligned.view(B, C, R, -1, 4).amax(-1).sum())
    return hist, entries, nonzero, quads


def anchor_runs(kw):
    """Lengths of the runs of consecutive depositing groups (in group
    order) that share their window anchor (w0, c0), and of those that
    share their exact deposit base (w0, ce)."""
    import torch
    flags = kw["flags"]
    kind, sz = flags // 4, flags % 4
    dep = (kind > 0) & ((sz == 3) | (kind <= 2))
    out = {}
    for name, key in (("w0,c0", kw["c0"]), ("w0,ce", kw["ce"])):
        w0, c = kw["w0"][dep], key[dep]
        if w0.numel() == 0:
            out[name] = []
            continue
        new = torch.ones_like(w0, dtype=torch.bool)
        new[1:] = (w0[1:] != w0[:-1]) | (c[1:] != c[:-1])
        starts = torch.nonzero(new).flatten()
        ends = torch.cat([starts[1:], starts.new_tensor([w0.numel()])])
        out[name] = (ends - starts).tolist()
    return out


def run_summary(lengths):
    import numpy as np
    if not lengths:
        return "no depositing groups"
    a = np.asarray(lengths)
    tot = a.sum()
    return (f"{a.size} runs over {tot} groups, mean {a.mean():.3f}, median "
            f"{np.median(a):.0f}, max {a.max()}; groups in runs >= 2: "
            f"{a[a >= 2].sum() / tot:.3f}, >= 4: {a[a >= 4].sum() / tot:.3f}"
            f", >= 8: {a[a >= 8].sum() / tot:.3f}")


def k3_work(kw, keys):
    """(bytes, float32 operations, fragments, hits, hit pixels) that one
    K3 call needs on this run's inputs (``keys``: the (R, C) packed atlas).
    Fragments and hits as for K3_OPS_*; only a hit can change the atlas.
    Bytes: every group's flag and the active groups' particles and anchors
    read once, each hit pixel's (depth, value) read and written once.  Hit
    pixels: the distinct (group, pixel) pairs with a hit, the least number
    of merges into the atlas (a global atomic each in K3)."""
    import torch
    from topsy_tpu_torch.ops import zsplat_accum as za
    R, C = keys.shape
    flags, G = kw["flags"], kw["group"]
    n = flags.shape[0]
    win = kw.get("window_cols", za.WINDOW_COLS)
    prof = za.PROFILE_COLS if win == za.WINDOW_COLS else win
    rolled = prof != win
    cbase = kw["ce"] if rolled else kw["c0"]
    ay_a, ax_a, ih_a = (kw[k].reshape(n, G) for k in ("ay_g", "ax_g", "ih_g"))
    foot = za.FOOT
    off = torch.arange(1 - int(foot), int(foot) + 1, device=flags.device)
    hit_px = torch.zeros(R * C, dtype=torch.bool, device=flags.device)
    lines = frags = hits = active = merges = 0
    for sz in (range(len(za.SIZE_CLASSES)) if rolled else (za.FULL_CLASS,)):
        sel = torch.nonzero(flags == za.FLAG_ACTIVE * 4 + sz).flatten()
        active += sel.numel()
        rows_eval, cols_eval = za.class_extents(sz, kw["window_rows"], prof)
        for s in range(0, sel.numel(), 1024):
            g = sel[s:s + 1024]
            ay, ax, ih = ay_a[g], ax_a[g], ih_a[g]
            w0 = kw["w0"][g].long()[:, None, None]
            cb = cbase[g].long()[:, None, None]
            y = torch.floor(ay).long()[..., None] + off       # (B, G, 16)
            x = torch.floor(ax).long()[..., None] + off
            dy = y.float() - ay[..., None]
            dx = x.float() - ax[..., None]
            valid = (ih > 0.0)[..., None]
            in_y = ((dy > -foot) & (dy <= foot) & (y >= w0)
                    & (y < w0 + rows_eval) & (y >= 0) & (y < R) & valid)
            in_x = ((dx > -foot) & (dx <= foot) & (x >= cb)
                    & (x < cb + cols_eval) & (x >= 0) & (x < C) & valid)
            frag = in_y[..., :, None] & in_x[..., None, :]
            t = 4.0 - ((dy * dy)[..., :, None] + (dx * dx)[..., None, :]) \
                * (ih * ih)[..., None, None]
            hit = frag & (t > 0.0)
            lines += int(in_y.sum()) + int(in_x.sum())
            frags += int(frag.sum())
            hits += int(hit.sum())
            pix = y[..., :, None] * C + x[..., None, :]
            hit_px[pix[hit]] = True
            gid = torch.arange(g.numel(), device=flags.device)
            merges += torch.unique(
                (gid[:, None, None, None] * (R * C) + pix)[hit]).numel()
    nbytes = n * 4 + active * (G * 6 * 4 + 3 * 4) + int(hit_px.sum()) * 16
    ops = (K3_OPS_PER_LINE * lines + K3_OPS_PER_FRAGMENT * frags
           + K3_OPS_PER_HIT * hits)
    return nbytes, float(ops), frags, hits, merges


def k3_census(kw, keys):
    """What one K3 call does, counted from its inputs by the plain mirrors
    of the kernel's plan and cull (``zsplat_accum.deposit_plan``,
    ``particle_boxes``, ``PANELS``): the groups it dispatches by size
    class; the panels it visits (those some box meets); its list entries
    ((panel, particle) pairs whose box meets the panel); the (pixel,
    particle) pairs it evaluates (each box inside each panel) and the lane
    slots they occupy (32 per pass of a warp)."""
    import torch
    from topsy_tpu_torch.ops import zsplat_accum as za
    R, C = keys.shape
    flags, G = kw["flags"], kw["group"]
    win = kw.get("window_cols", za.WINDOW_COLS)
    prof = za.PROFILE_COLS if win == za.WINDOW_COLS else win
    order, class_off = za.deposit_plan(flags, prof != win)
    off = class_off.tolist()
    out = dict(by_class=[off[k + 1] - off[k] for k in range(4)], panels=0,
               entries=0, pairs=0, lane_slots=0)
    for sz in range(4):
        rows_eval, cols_eval = za.class_extents(sz, kw["window_rows"], prof)
        pr, pc = za.PANELS[sz]
        sel = order[off[sz]:off[sz + 1]].long()
        for s in range(0, sel.numel(), 1024):
            g = sel[s:s + 1024]
            box = za.particle_boxes(
                *(kw[k][g] for k in ("ay_g", "ax_g", "ih_g", "w0", "c0", "ce",
                                     "flags")),
                group=G, atlas_rows=R, atlas_cols=C, window_cols=win,
                window_rows=kw["window_rows"]).long()
            for r0 in range(0, rows_eval, pr):
                for c0 in range(0, cols_eval, pc):
                    h = (torch.clamp(box[..., 1], max=r0 + pr - 1)
                         - torch.clamp(box[..., 0], min=r0) + 1)
                    w = (torch.clamp(box[..., 3], max=c0 + pc - 1)
                         - torch.clamp(box[..., 2], min=c0) + 1)
                    area = torch.clamp(h, min=0) * torch.clamp(w, min=0)
                    meets = area > 0
                    out["panels"] += int(meets.any(dim=1).sum())
                    out["entries"] += int(meets.sum())
                    out["pairs"] += int(area.sum())
                    out["lane_slots"] += int(((area + 31) // 32 * 32).sum())
    return out


def compare_feed(label, out_k, out_p, finite=True) -> float:
    """K1's outputs against its plain version's: finite (or, with
    ``finite=False``, NaN exactly where the plain version has NaN), f32
    planes within rtol 1e-6, integers equal.  Returns the largest f32
    difference."""
    import torch
    err = 0.0
    for name, a, b in zip(("ay", "ax", "ih", "cfit", "cspill"), out_k[:5],
                          out_p[:5]):
        if finite:
            check(torch.isfinite(a).all(), f"K1 {label} {name} not finite")
        check(torch.allclose(a, b, rtol=1e-6, atol=0.0, equal_nan=not finite),
              f"K1 {label} {name} differs from the plain version beyond "
              f"rtol 1e-6: max {(a - b).abs().nan_to_num().max().item()}")
        err = max(err, (a - b).abs().nan_to_num().max().item())
    for name, a, b in zip(("w0", "c0", "ce", "flags", "nspill"), out_k[5:],
                          out_p[5:]):
        n_diff = int((a != b).sum().item())
        check(n_diff == 0, f"K1 {label} {name}: {n_diff} groups differ")
    return err


def phase_feed_odd(vis) -> float:
    """Phase K1o: K1 against its plain version where it takes its
    lane-by-lane path and where lanes hold odd values.  The main layout's
    columns [64, 253) (G = 189, not a multiple of 4) as the interactive
    column launch cuts them, over 1,024 groups around the middle of the
    groups that EXPORT piece 0 finds active; then the same groups with 40
    lanes (inside those columns) of 20 active groups set, case by case, to h NaN, +inf, 0 or negative and to
    NaN or infinite positions, at G = 512 and on the 189 columns.  Integers equal, f32 planes to rtol 1e-6, NaN where
    the plain version has NaN.  Returns the largest difference."""
    import numpy as np
    import torch
    from topsy_tpu_torch.ops import splat_atlas, splat_feed
    from topsy_tpu_torch.render.sph import column_launches
    sph, store = vis._sph, vis.store
    matrix = sph._matrix().astype(np.float32)
    scale = np.float32(sph.scale)
    fields, vals, gb, msk = tier_arrays(store, sph, store.main_tier)
    n_groups, G = fields[0].shape
    p0 = sph.pieces()[0]
    fargs, fkw = feed_args(vis, p0)
    active = torch.nonzero(splat_feed.splat_feed_cuda(*fargs, **fkw)[8] // 4
                           > 0).flatten().cpu().numpy() + (p0 or (0,))[0]
    check(len(active) >= 20, "K1o: EXPORT piece 0 has under 20 active groups")
    n = min(1024, n_groups)
    g0 = int(np.clip(active[len(active) // 2] - n // 2, 0, n_groups - n))
    live = active[(active >= g0) & (active < g0 + n)]
    rng = np.random.RandomState(13)
    dev = fields[0].device
    groups = torch.as_tensor(np.repeat(rng.choice(live, 20, replace=False), 2),
                             device=dev)
    lanes = torch.as_tensor(rng.randint(64, 64 + 189, 40), device=dev)
    err = 0.0
    cases = {"plain": None, "h_nan": float("nan"), "h_inf": float("inf"),
             "h_zero": 0.0, "h_negative": -0.5, "pos_nan": float("nan"),
             "pos_inf": float("inf")}
    for case, value in cases.items():
        f = list(fields)
        if value is not None:
            k = 3 if case.startswith("h_") else 0
            f[k] = f[k].clone()
            f[k][groups, lanes] = value
            if case == "pos_nan":
                f[1] = f[1].clone()
                f[1][groups[::2], lanes[::2]] = value
        for width in (G, 189):
            src = (tuple(f), vals, gb, msk) if width == G else \
                column_launches(tuple(f), vals, gb, msk, 64, width)[:4]
            fargs, fkw = splat_atlas.feed_call(
                *src[:2], matrix, RESOLUTION, scale, src[2], mask=src[3],
                piece=(g0, n), bucket_thresh=sph._giant_bucket)
            label = f"K1o {case} G {width}"
            out_k = splat_feed.splat_feed_cuda(*fargs, **fkw)
            out_p = splat_feed.splat_feed_plain(*fargs, **fkw)
            e = compare_feed(label, out_k, out_p, finite=case == "plain")
            err = max(err, e)
            nan_groups = int(torch.isnan(out_p[2]).any(dim=1).sum().item())
            msg = (f"phase {label}: ok; {fkw['piece_groups']} groups, "
                   f"max abs diff {e:.3e}; groups with a NaN ih "
                   f"{nan_groups}; flags {torch.bincount(out_k[8].long()).tolist()}")
            if case == "plain" and width == 189:
                time_k1("w189_1024_groups", fargs, fkw, width)
                msg += f"; {k1_note('w189_1024_groups')}"
            log(msg)
    return err


def compare_k2(label, kw):
    """One K2 call against its plain version from a zero atlas, within
    1e-5 of the atlas maximum.  Returns (max abs diff, max|atlas|, active
    groups)."""
    from topsy_tpu_torch.ops import splat_accum
    a_k = splat_accum.accumulate_groups_cuda(**kw)
    a_p = splat_accum.accumulate_groups_plain(**kw)
    ref_max = a_p.abs().max().item()
    err = (a_k - a_p).abs().max().item()
    check(bool(a_k.isfinite().all()), f"K2 {label}: atlas not finite")
    check(err <= 1e-5 * ref_max, f"K2 {label}: max abs diff {err} > 1e-5 * "
          f"{ref_max}")
    return err, ref_max, int(((kw["flags"] // 4) > 0).sum().item())


def interactive_times(times):
    """The kernels line's entries for phase I1's calls, keyed
    "w<slice width>_p<piece>[_<K2 shape>]"."""
    return {f"interactive_{k}_by_call": {key: t[i] for key, t in times.items()}
            for i, k in enumerate(("ms", "plain_ms", "bound_ms"))}


FRAME_FIELDS = "(ms by the frame clock, column ranges, dropped, mass scale, tier)"


def frame_record(sph):
    """(frame ms by the frame clock, column ranges, dropped, mass scale,
    tier) of the renderer's last interactive frame, after its
    presentation; the tier is the progression's ``last_block_tier``
    (deepest mip 0, the main layout last)."""
    return (sph.frame_clock.seconds() * 1e3, list(sph.last_column_ranges),
            sph.last_dropped_splats, sph.last_render_mass_scale,
            sph.render_progression.last_block_tier)


def show_frames(frames):
    return [(round(f[0], 3),) + tuple(f[1:]) for f in frames]


def drive_view(vis, max_frames=64, first_image=None):
    """A CHANGE draw, then REFINE draws until the progression is complete:
    the user's interactive path.  Returns each frame's ``frame_record``;
    ``first_image`` (a list) receives the first frame's photometrically
    scaled density image."""
    from topsy_tpu_torch.visualizer import DrawReason
    sph = vis._sph
    vis.draw(DrawReason.CHANGE)
    frames = [frame_record(sph)]
    if first_image is not None:
        first_image.append(sph.get_image()[..., 0].astype("float64"))
    while sph.needs_refine():
        check(len(frames) < max_frames, f"no completion in {max_frames} "
              "frames")
        vis.draw(DrawReason.REFINE)
        frames.append(frame_record(sph))
    return frames


def export_drops(vis):
    """(splats each piece of an EXPORT frame at the current view drops, the
    visible splats of the frame): the renderer reports the last piece's
    drops only, as the reference does."""
    from topsy_tpu_torch.ops import splat, splat_atlas, splat_feed
    _, atlas_rows, atlas_cols = splat_atlas.atlas_layout(
        splat.default_pyramid(RESOLUTION))
    G = vis.store.presorted_layout.pad_group
    drops, visible = [], 0
    for piece in vis._sph.pieces():
        fargs, fkw = feed_args(vis, piece)
        out = splat_feed.splat_feed(*fargs, **fkw)
        visible += int(((out[3][0] != 0) | (out[4][0] != 0)).sum().item())
        *_, dropped = splat_atlas.deposit_calls(
            out, C=2, G=G, atlas_rows=atlas_rows, atlas_cols=atlas_cols)
        drops.append(int(dropped.item()))
    return drops, visible


def against_export(vis, tag):
    """The completed interactive image of the current view against the
    EXPORT image of the same view: the mass scale within 1e-6 of 1,
    correlation > 0.9999, and the density sums within rel 1e-4 once each
    side's dropped splats are counted; returns the EXPORT density image.
    The EXPORT pieces keep the
    reference's spill budget and the interactive launch a 4x one, so they
    drop different numbers of splats; when every particle of the snapshot
    has the same mass (checked), each deposited splat adds the same to the
    density sum, and sum_I / sum_E - 1 must equal
    (d_E - d_I) / (visible - d_E) (0 when neither drops)."""
    import numpy as np
    from topsy_tpu_torch.visualizer import DrawReason
    mass = vis.data_loader.get_mass()
    check((mass == mass[0]).all(), f"{tag}: the snapshot's masses differ, "
          "so dropped splats do not count for equal shares of the density")
    sph = vis._sph
    ms = sph.last_render_mass_scale
    d_i = sph.last_dropped_splats
    im_i = sph.get_output_image()[..., 0].double().cpu().numpy()
    sph.invalidate()
    sph.render(DrawReason.EXPORT)
    im_e = sph.get_output_image()[..., 0].double().cpu().numpy()
    drops, visible = export_drops(vis)
    d_e = sum(drops)
    rel = im_i.sum() / im_e.sum() - 1.0
    counted = (d_e - d_i) / (visible - d_e)
    corr = float(np.corrcoef(im_i.ravel(), im_e.ravel())[0, 1])
    diff = np.abs(im_i - im_e).max() / np.abs(im_e).max()
    log(f"phase {tag}: interactive against EXPORT at scale {sph.scale}: "
        f"mass scale {ms!r}, density sum rel diff {rel:.6e}, of which "
        f"dropped splats account for {counted:.6e} (interactive frame drops "
        f"{d_i}, EXPORT pieces {drops}, of {visible} visible splats); corr "
        f"{corr:.7f}, max pixel diff {diff:.3e} of the max")
    check(abs(ms - 1.0) <= 1e-6, f"{tag}: mass scale {ms} after completion")
    check(corr > 0.9999, f"{tag}: correlation {corr} <= 0.9999")
    check(abs(rel - counted) <= 1e-4, f"{tag}: density sum rel diff {rel} "
          f"is not the dropped splats' {counted} within 1e-4")
    return im_e


def trace_frame(fn, path: str) -> dict:
    """One call of ``fn`` under ``torch.profiler`` (CPU and CUDA), its
    Chrome trace written to ``path``.  Returns, in ms from the call's start
    on the host, its host span and per card the first kernel's start, the
    last kernel's end and the kernels' busy time (device activity only)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    cards = range(torch.cuda.device_count())
    for c in cards:
        torch.cuda.synchronize(c)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("traced_frame"):
            fn()
        for c in cards:
            torch.cuda.synchronize(c)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    events = prof.events()
    host = [e for e in events if e.name == "traced_frame"
            and e.device_type == torch.autograd.DeviceType.CPU][0]
    t0 = host.time_range.start
    spans = {}
    for e in events:
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or e.name == "traced_frame"):
            continue
        a, b = e.time_range.start - t0, e.time_range.end - t0
        lo, hi, busy = spans.get(e.device_index, (a, b, 0.0))
        spans[e.device_index] = (min(lo, a), max(hi, b), busy + b - a)
    out = {"host_ms": (host.time_range.end - t0) / 1e3,
           "cards": {str(c): {"first_ms": lo / 1e3, "last_ms": hi / 1e3,
                              "busy_ms": busy / 1e3}
                     for c, (lo, hi, busy) in sorted(spans.items())}}
    log(f"trace of one frame ({path}): "
        + (json.dumps(out) if spans else
           "the profiler shows no device time"))
    return out


#: K1's timed calls, {call: {"ms", "device_ms", "host_us", "bound_ms",
#: "groups", "G", "device_by"}}: back to back by CUDA events, the kernel
#: alone (by the profiler or by events), the wrapper's host time, the bound
K1_CALLS: dict = {}


def time_k1(key, fargs, fkw, G, reps=5, plain_reps=2):
    """(ms, plain ms, bound ms) of one K1 call, timed back to back by CUDA
    events beside its plain version and bound; its device-only time and
    the wrapper's host time (``k1_costs``) go into ``K1_CALLS[key]``."""
    from topsy_tpu_torch.ops import splat_feed

    def fn():
        splat_feed.splat_feed_cuda(*fargs, **fkw)
    ms = timed_ms(fn, reps)
    plain = timed_ms(lambda: splat_feed.splat_feed_plain(*fargs, **fkw),
                     plain_reps)
    b = k1_bound(fkw, G)[0]
    device_ms, host_us, source = k1_costs(fn)
    K1_CALLS[key] = {"ms": ms, "device_ms": device_ms, "host_us": host_us,
                     "bound_ms": b, "groups": fkw["piece_groups"], "G": G,
                     "device_by": source}
    return ms, plain, b


def k1_note(key) -> str:
    """The device-only time and host time of a ``time_k1`` call."""
    c = K1_CALLS[key]
    return (f"kernel alone {c['device_ms']:.4f} ms by {c['device_by']} "
            f"({c['bound_ms'] / c['device_ms']:.1%} of bound), wrapper host "
            f"{c['host_us']:.1f} us")


def queued_ms(fn, calls: int = 20) -> float:
    """Mean ms of one call of ``fn`` by CUDA events around it alone,
    enqueued behind a busy wait on the card, so that the events time the
    card's work and not the host's enqueue."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    total = 0.0
    for _ in range(calls):
        torch.cuda._sleep(1_000_000)        # ~0.5 ms of the card busy
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / calls


def k1_costs(fn, calls: int = 20):
    """(device ms, host us, device source) of one call of the K1 wrapper
    ``fn``: the kernel's own duration on the card (the mean of
    torch.profiler's kernel durations over ``calls`` calls, source
    "profiler"; the trace may miss launches of a ctypes library, the
    first few of a profile or, late in a long process, all of them: then
    ``queued_ms``, source "events"; fails if the trace shows another
    kernel or more than one a call) and the host time of the wrapper
    (``perf_counter`` around ``calls`` calls enqueued onto an idle card,
    per call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith(("Memcpy", "Memset"))]
    names = {e.name for e in kernels}
    check(len(kernels) <= calls and len(names) <= 1,
          f"the trace of {calls} K1 calls shows {len(kernels)} kernels: "
          f"{sorted(names)}")
    if kernels:
        source = "profiler"
        device_ms = (sum(e.time_range.elapsed_us() for e in kernels)
                     / len(kernels) / 1e3)
    else:
        source, device_ms = "events", queued_ms(fn, calls)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host_us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return device_ms, host_us, source


def cuda_ms(fn):
    """(CUDA-event ms, host wall ms, result) of one call of ``fn`` on the
    current stream, synchronised before and after."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), (time.perf_counter() - t0) * 1e3, out


def check_layout(tag, layout, pos_smooth, complete=True):
    """The presort layout's invariants on the card (tests/
    test_morton_device.py): each particle once (each of the snapshot's, or
    with ``complete=False``, a mip tier's, none twice), pads carry the
    sentinel, real slots form each group's prefix, ``real_per_column``, buckets
    non-decreasing and changing only at ``run_quantum`` multiples, buckets
    bounding h (below-edge share < 1e-3), the within-group shuffle in
    effect.  Returns (runs, share below the bucket edge, ascending share)."""
    import numpy as np
    import torch
    from topsy_tpu_torch.ops.morton import DELTA_OCTAVE
    n, G = layout.n_real, layout.pad_group
    gidx = layout.gidx.long()
    real = gidx < n
    counts = torch.bincount(gidx[real], minlength=n)
    once = (counts == 1) if complete else (counts <= 1)
    check(counts.numel() == n and bool(once.all()),
          f"{tag}: the real slots do not hold each particle once")
    check(bool((gidx[~real] == n).all()), f"{tag}: a pad lacks the sentinel")
    r2 = real.reshape(-1, G)
    check(bool((r2[:, :-1] >= r2[:, 1:]).all()),
          f"{tag}: real slots are not group prefixes")
    check(np.array_equal(layout.real_per_column,
                         r2.sum(dim=0).cpu().numpy()),
          f"{tag}: real_per_column is wrong")
    b = layout.buckets.long()
    check(bool((b[1:] >= b[:-1]).all()), f"{tag}: buckets decrease")
    change = torch.nonzero(b[1:] != b[:-1]).flatten() + 1
    check(bool((change % layout.run_quantum == 0).all()),
          f"{tag}: a bucket changes off a run_quantum multiple")
    h = pos_smooth[gidx[real], 3].double()
    br = b[real].double()
    check(bool((h <= torch.exp2((br + 1.0) * DELTA_OCTAVE)
                * (1 + 1e-5)).all()), f"{tag}: a bucket's upper edge is "
          "below its particle's h")
    below = float((h < torch.exp2(br * DELTA_OCTAVE) * (1 - 1e-5))
                  .double().mean())
    check(below < 1e-3, f"{tag}: {below} of h below their bucket's edge")
    g_id = torch.arange(layout.n_out, device=gidx.device) // G
    same = real[1:] & real[:-1] & (g_id[1:] == g_id[:-1])
    asc = float(((gidx[1:] - gidx[:-1]) > 0)[same].double().mean())
    check(asc < 0.9, f"{tag}: within-group sources ascend on {asc}: no "
          "shuffle")
    return int(torch.unique(b[real]).numel()), below, asc


def layout_spills(vis, layouts):
    """K1's spilled particles (those outside their group's fit window, which
    the spill tiers then deposit) at the scene's view, summed over the
    EXPORT pieces, for each gather layout of ``layouts`` ({name: layout}):
    a measure of how compact the layout's groups are on screen."""
    import numpy as np
    from topsy_tpu_torch import config, convert
    from topsy_tpu_torch.ops import splat_atlas, splat_feed
    sph, store = vis._sph, vis.store
    values = store.values_for(sph._buffer_name)
    out = {}
    for name, lay in layouts.items():
        G = lay.pad_group
        ng = lay.n_out // G
        fields = tuple(f.reshape(ng, G) for f in convert.presorted_positions(
            lay, store.pos_smooth))
        vcm = convert.presorted_values_cm(lay, values)
        gb = lay.buckets.reshape(ng, G)[:, 0].contiguous()
        piece_g = min(ng, config.SPLAT_FEED_LAUNCH_CAP // G)
        total = 0
        for g0 in range(0, ng, piece_g):
            fargs, fkw = splat_atlas.feed_call(
                fields, vcm, sph._matrix().astype(np.float32), RESOLUTION,
                np.float32(sph.scale), gb,
                piece=(g0, min(piece_g, ng - g0)),
                bucket_thresh=sph._giant_bucket)
            total += int(splat_feed.splat_feed(*fargs, **fkw)[9].sum())
        out[name] = total
    return out


def phase_presort(vis):
    """Phase P, the presort built on the card, on the scene's positions
    there: the device build (CUDA events, median of 3 after 1 warm-up)
    beside the host presort (wall time, one run after its native library is
    built), the layout's invariants on the card, the mip tier as exactly
    its parent's first min_slice_width columns.  Fails if the scene's store
    took the host fallback.  Returns a summary dict."""
    import numpy as np
    import torch
    from topsy_tpu_torch import convert, native
    from topsy_tpu_torch.ops import morton, morton_device
    t_all = time.perf_counter()
    store = vis.store
    layout = store.presorted_layout
    check(isinstance(layout, morton_device.DevicePresortedLayout),
          f"the scene's store holds a {type(layout).__name__}: the host "
          "presort fallback ran")
    ps, n = store.pos_smooth, store.n
    build = lambda: morton_device.build_presorted_device(ps, n_real=n)
    build()                                          # warm-up
    runs = [cuda_ms(build) for _ in range(3)]
    dev_ms = [r[0] for r in runs]
    check(all(r[2] is not None for r in runs), "the device build fell back")
    again = runs[-1][2]
    check(again.n_out == layout.n_out and np.array_equal(
        again.real_per_column, layout.real_per_column),
          "a rebuild differs in its structure")
    del runs, again
    # the build's three stages alone (CUDA events), as build_presorted_device
    # runs them
    n_cap = 1 << (max(int(ps.shape[0]), 1) - 1).bit_length()
    ps_cap = ps if ps.shape[0] == n_cap else torch.cat(
        [ps, ps.new_full((n_cap - ps.shape[0], 4), morton.PAD_POS)])
    sort_ms, _, (b_sorted, perm) = cuda_ms(
        lambda: morton_device._sort_stage(ps_cap, n))
    run_ms, _, (os_r, bucket_r, len_r, n_out_t, n_runs_t) = cuda_ms(
        lambda: morton_device._run_stage(b_sorted, n, layout.run_quantum,
                                         4096))
    slot_ms, _, _ = cuda_ms(lambda: morton_device._slot_stage(
        perm, os_r, bucket_r, len_r, n_real=n, n_out=int(n_out_t),
        n_runs=int(n_runs_t), pad_group=layout.pad_group, seed=1337))
    stages = dict(sort_ms=sort_ms, run_ms=run_ms, slot_ms=slot_ms)
    del ps_cap, b_sorted, perm, os_r, bucket_r, len_r
    native_ok = native._load() is not None
    ps_host = vis.data_loader.get_pos_smooth().astype(np.float32)
    t0 = time.perf_counter()
    host = morton.build_presorted(ps_host)
    host_s = time.perf_counter() - t0
    spilled = layout_spills(vis, {
        "device": layout,
        "host": convert.device_layout_from_host(host, ps.device)})
    n_runs, below, asc = check_layout("P main layout", layout, ps)
    log(f"phase P: device presort of {n} particles (the scene's positions on"
        f" the card): median {statistics.median(dev_ms):.3f} ms (CUDA events;"
        f" runs {[round(t, 3) for t in dev_ms]}); host presort "
        f"(ops/morton.build_presorted, {'native g++' if native_ok else 'numpy'}"
        f") {host_s:.3f} s wall; n_out {layout.n_out} (host layout "
        f"{host.n_out}), {n_runs} runs, run_quantum {layout.run_quantum}, "
        f"groups {layout.n_out // layout.pad_group}; stages alone: key sort "
        f"{sort_ms:.3f} ms, runs {run_ms:.3f} ms, slots and shuffle "
        f"{slot_ms:.3f} ms; invariants held on the "
        f"card (h below its bucket's edge on {below:.3e}, within-group "
        f"sources ascending on {asc:.4f}); K1's spilled particles at the "
        f"scene's view over the device layout {spilled['device']}, over the "
        f"host layout {spilled['host']}")
    del ps_host, host

    # the decimation-mip chain, each tier exactly its parent's prefix
    # columns
    mip_ms = [cuda_ms(lambda: morton_device.build_mip_layout(layout, ps))[0]
              for _ in range(4)][1:]
    tiers = store.ensure_column_mips()
    check(len(tiers) >= 1, "the scene has no decimation-mip tier")
    parent = layout
    for i, tier in reversed(list(enumerate(tiers))):
        mip = tier.layout
        w = morton.min_slice_width(parent)
        pg = parent.gidx.reshape(-1, parent.pad_group)[:, :w].reshape(-1)
        expect = torch.sort(pg[pg < n]).values
        got = torch.sort(mip.gidx[mip.gidx < n]).values
        check(torch.equal(got, expect), f"mip tier {i} is not its parent's "
              f"first {w} columns")
        t_runs, _, _ = check_layout(f"P mip tier {i}", mip, ps,
                                    complete=False)
        log(f"phase P mip tier {i}: {int(mip.real_per_column.sum())} real "
            f"particles (its parent's first {w} of {parent.pad_group} "
            f"columns, exactly), n_out {mip.n_out}, {t_runs} runs, groups "
            f"{mip.n_out // mip.pad_group}, slice floor "
            f"{int(mip.real_per_column[:morton.min_slice_width(mip)].sum())}")
        parent = mip
    log(f"phase P: tiers {len(tiers)} (deepest first, real counts "
        f"{[int(t.layout.real_per_column.sum()) for t in tiers]}); main "
        f"layout {int(layout.real_per_column.sum())} real; build_mip_layout "
        f"median {statistics.median(mip_ms):.3f} ms (CUDA events; runs "
        f"{[round(t, 3) for t in mip_ms]}); {time.perf_counter() - t_all:.1f}"
        " s")
    return dict(device_presort_ms=dev_ms, **stages, host_presort_s=host_s,
                spilled=spilled,
                native=native_ok, n_out=layout.n_out, runs=n_runs,
                mip_ms=mip_ms,
                tier_reals=[int(t.layout.real_per_column.sum())
                            for t in tiers])


def phase_device_loader(dev, scene_sph):
    """Phase D, bench.py's path: ``Visualizer`` over ``TestDataDeviceLoader
    (2**24, seed=1337)`` on the card at 1024^2.  Times the loader alone,
    then the Visualizer to its first image (host wall, synchronised) twice:
    by the lazy policy (the sorted block path, no presort) and with the
    presort built first (the device presort and a presorted frame, the
    path of the rest of the phase), then EXPORT frames (median of 5 after 2 warm-ups), then
    the scene's (``scene_sph``) and its own EXPORT frames alternately, both
    held in memory (scene, device loader, scene, device loader: a gap that
    follows the loader is its layout's, one that follows the order is the
    card's), and holds the image against its scatter truth (density sum rel
    1e-2, correlation > 0.999).  Returns (launches during the frames, a summary
    dict)."""
    import numpy as np
    import torch
    from topsy_tpu_torch.loaders import TestDataDeviceLoader
    from topsy_tpu_torch.ops import morton_device, splat
    from topsy_tpu_torch.render import sph as sph_module
    from topsy_tpu_torch.visualizer import OffscreenCanvas, Visualizer
    t0 = time.perf_counter()
    loader = TestDataDeviceLoader(N_PARTICLES, seed=1337, device=dev)
    torch.cuda.synchronize()
    loader_s = time.perf_counter() - t0
    del loader
    def first_image():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vis = Visualizer(data_loader_class=TestDataDeviceLoader,
                         data_loader_args=(N_PARTICLES,),
                         data_loader_kwargs={"seed": 1337, "device": dev},
                         render_resolution=RESOLUTION,
                         canvas_class=OffscreenCanvas, device=dev)
        vis._sph.get_image()
        return vis, time.perf_counter() - t0

    # the first image by the lazy policy (the sorted block path) ...
    vis, policy_s = first_image()
    check(vis.store.presorted_layout is None, "D: the policy's first EXPORT "
          "built the presort")
    del vis
    torch.cuda.empty_cache()
    # ... and with the presort built first (the first EXPORT presorted)
    use_presorted = sph_module.SPHRenderer._use_presorted
    sph_module.SPHRenderer._use_presorted = lambda self: True
    try:
        vis, first_s = first_image()
    finally:
        sph_module.SPHRenderer._use_presorted = use_presorted
    store, sph = vis.store, vis._sph
    check(isinstance(store.presorted_layout,
                     morton_device.DevicePresortedLayout),
          "the device loader's store took the host presort fallback")
    check(store.pos_smooth.data_ptr()
          == vis.data_loader.device_arrays()["pos_smooth"].data_ptr(),
          "the store copied the device loader's positions")
    reset_counts()
    frame_ms, _ = export_frame_ms(sph)
    launches = read_counts("device loader EXPORT", ("splat_feed",
                                                    "accumulate_groups"))
    alternate = [(who, statistics.median(export_frame_ms(s)[0])) for who, s
                 in (("scene", scene_sph), ("device loader", sph)) * 2]
    raw = sph.get_image()
    check(raw.shape == (RESOLUTION, RESOLUTION, 2)
          and np.isfinite(raw).all(), f"device loader image {raw.shape} "
          "not finite")
    truth = splat.splat_scatter(
        store.pos_smooth, store.values_for(sph._buffer_name),
        sph._matrix().astype(np.float32), RESOLUTION, np.float32(sph.scale))
    truth = truth[..., 0].cpu().numpy().astype(np.float64)
    den = raw[..., 0].astype(np.float64)
    rel = abs(den.sum() / truth.sum() - 1.0)
    corr = float(np.corrcoef(den.ravel(), truth.ravel())[0, 1])
    med = statistics.median(frame_ms)
    log(f"phase D: TestDataDeviceLoader({N_PARTICLES}, seed=1337) on the "
        f"card: loader alone {loader_s:.3f} s; Visualizer to the first "
        f"EXPORT image (loader, store, first frame and autorange, readback) "
        f"by the lazy policy (the sorted block path) {policy_s:.3f} s wall, "
        f"with the presort built first (device presort, presorted frame) "
        f"{first_s:.3f} s wall: the faster first image is "
        f"{'the policy' if policy_s < first_s else 'the presort first'}; n_out "
        f"{store.n_presorted}; EXPORT {FRAMES} frames, median {med:.3f} "
        f"ms/frame (frames {[round(t, 3) for t in frame_ms]}), "
        f"{N_PARTICLES / (med / 1e3):.6e} splats/s, last_dropped_splats "
        f"{sph.last_dropped_splats}; against splat_scatter: density sum rel "
        f"diff {rel:.3e}, corr {corr:.6f}; launches {launches}")
    log("phase D: EXPORT frame medians, alternately, both Visualizers held: "
        + ", ".join(f"{who} {ms:.3f} ms" for who, ms in alternate))
    check(rel <= 1e-2, f"D: density sum rel diff {rel} > 1e-2")
    check(corr > 0.999, f"D: density correlation {corr} <= 0.999")
    return launches, dict(loader_s=loader_s, first_image_s=first_s,
                          policy_first_image_s=policy_s, frame_ms=frame_ms, alternate=alternate, rel=rel,
                          corr=corr)


def phase_interactive(vis):
    """Phases I1-I4, the interactive LOD path (CHANGE and REFINE column
    frames) on the EXPORT scene's Visualizer; the view is restored after.
    Returns (launches during I2's frames, K1's and K2's largest
    differences from their plain versions in I1, a summary dict)."""
    import numpy as np
    import torch
    from topsy_tpu_torch.ops import (splat, splat_accum, splat_atlas,
                                     splat_feed, splat_giant)
    from topsy_tpu_torch.ops.morton import min_slice_width
    from topsy_tpu_torch.progression import RenderProgressionColumns
    from topsy_tpu_torch.render.sph import (_render_block_columns_fields,
                                            column_launches)
    from topsy_tpu_torch.visualizer import DrawReason
    t_all = time.perf_counter()
    sph, store = vis._sph, vis.store
    rotation, scale0 = np.array(sph.rotation_matrix), sph.scale
    vis.show_colorbar = vis.show_scalebar = vis.show_status = False
    _, atlas_rows, atlas_cols = splat_atlas.atlas_layout(
        splat.default_pyramid(RESOLUTION))
    summary = {}

    # ---- I1: K1 and K2 on column slices of one quantum and of three, on
    # the REFINE launch of the main layout (its columns above the mip
    # tier's), on its full width, and on the CHANGE launch of the mip tier
    # (all of its columns), each call timed alone
    q = min_slice_width(store.presorted_layout)
    pad_group = store.presorted_layout.pad_group
    tiers = store.ensure_column_mips()
    check(len(tiers) >= 1, "the scene has no decimation-mip tier")
    matrix = sph._matrix().astype(np.float32)
    scale = np.float32(sph.scale)
    feed_err = accum_err = 0.0
    # per call "[tier<i>_]w<width>_p<piece>[_<shape>]": (ms, plain ms,
    # bound ms)
    feed_t, accum_t = {}, {}
    launches_i1 = [(None, 0, q), (None, q, 3 * q), (None, q, pad_group - q),
                   (None, 0, pad_group), (0, 0, pad_group)]
    for ti, col0, width in launches_i1:
        tier = store.main_tier if ti is None else tiers[ti]
        src = tier_arrays(store, sph, tier)
        sliced, vals, gb, msk, pieces, kw = column_launches(*src, col0, width)
        drops, kernels_ms = [], 0.0
        name = "main" if ti is None else f"tier {ti}"
        for i, piece in enumerate(pieces):
            label = f"I1 {name} [{col0}, {col0 + width}) piece {piece}"
            key = ("" if ti is None else f"tier{ti}_") + f"w{width}_p{i}"
            fargs, fkw = splat_atlas.feed_call(
                sliced, vals, matrix, RESOLUTION, scale, gb, mask=msk,
                piece=piece, bucket_thresh=sph._giant_bucket)
            out_k = splat_feed.splat_feed_cuda(*fargs, **fkw)
            feed_err = max(feed_err, compare_feed(
                label, out_k, splat_feed.splat_feed_plain(*fargs, **fkw)))
            main_kw, t2_kw, t3_kw, dropped = splat_atlas.deposit_calls(
                out_k, C=2, G=width, atlas_rows=atlas_rows,
                atlas_cols=atlas_cols, **kw)
            drops.append(int(dropped.item()))
            feed_t[key] = time_k1(f"interactive_{key}", fargs, fkw, width)
            kernels_ms += feed_t[key][0]
            timing = (f"K1 {feed_t[key][0]:.3f} ms (plain "
                      f"{feed_t[key][1]:.3f} ms, bound {feed_t[key][2]:.4f} "
                      f"ms; {k1_note(f'interactive_{key}')})")
            for shape, dkw in (("main", main_kw), ("tier2", t2_kw),
                               ("tier3", t3_kw)):
                err, ref_max, active = compare_k2(f"{label} {shape}", dkw)
                accum_err = max(accum_err, err)
                t = accum_t[f"{key}_{shape}"] = (
                    timed_ms(lambda: splat_accum.accumulate_groups_cuda(
                        **dkw), 5),
                    timed_ms(lambda: splat_accum.accumulate_groups_plain(
                        **dkw), 2),
                    k2_bound(dkw)[0])
                kernels_ms += t[0]
                timing += (f"; K2 {shape} (G {dkw['group']}, groups "
                           f"{dkw['flags'].shape[0]}, active {active}) "
                           f"{t[0]:.3f} ms (plain {t[1]:.3f} ms, bound "
                           f"{t[2]:.4f} ms)")
            log(f"phase {label}: ok; K1 bit-exact on integers, K2 within 1e-5"
                f" of the atlas maximum; dropped {drops[-1]}; {timing}")
            del out_k, main_kw, t2_kw, t3_kw
        launch_ms = timed_ms(lambda: _render_block_columns_fields(
            *src, matrix, scale, col0, int(sph._giant_bucket),
            resolution=RESOLUTION, width=width, depth_channel=False), 5)
        log(f"phase I1 {name} slice [{col0}, {col0 + width}): width {width} "
            f"(power of two: {width & (width - 1) == 0}), n_groups "
            f"{sliced[0].shape[0]}, pieces {pieces}, dropped {drops}; whole "
            f"column launch {launch_ms:.3f} ms, of which the kernels alone "
            f"{kernels_ms:.3f} ms")
        tag = ("" if ti is None else f"tier{ti}_") + f"width_{width}"
        summary[f"launch_ms_{tag}"] = launch_ms
        summary[f"kernels_ms_{tag}"] = kernels_ms
    check((3 * q) & (3 * q - 1), "the 3-quantum slice is a power of two")
    summary.update(feed_t=feed_t, accum_t=accum_t)

    # ---- I2: interactive views, each a CHANGE draw then REFINE draws ------
    # the first view starts on the deepest mip tier (the recommendation
    # starts at config.INITIAL_PARTICLES_TO_RENDER); later views render
    # the tier the measured frame times afford
    main_tier = len(tiers)
    change_ms, refine_ms, n_frames, all_frames = [], [], [], 0
    first_tiers = []
    for v in range(2 + FRAMES):                  # two warm-up views
        if v == 1:
            # view 0's checks render EXPORT frames: the counts are the
            # frames' of views 1 on
            reset_counts()
        vis.rotate(0.0, 0.05)
        first = []
        frames = drive_view(vis, first_image=first if v == 0 else None)
        check(isinstance(sph.render_progression, RenderProgressionColumns),
              "CHANGE did not activate the columns progression")
        all_frames += len(frames) if v else 0
        first_tiers.append(frames[0][4])
        if v >= 2:
            change_ms.append(frames[0][0])
            refine_ms += [f[0] for f in frames[1:]]
            n_frames.append(len(frames))
        log(f"phase I2 view {v}{' (warm-up)' if v < 2 else ''}: frames "
            f"{FRAME_FIELDS} {show_frames(frames)}")
        if v == 0:
            check(frames[0][4] == 0 and frames[0][3] > 1.0, "the first "
                  f"CHANGE frame rendered tier {frames[0][4]} at mass scale "
                  f"{frames[0][3]}, not the deepest mip")
            check(len(frames) > 1 and frames[-1][4] == main_tier, "the "
                  "REFINE frames did not reach the main layout")
            # the completed tiered view against its EXPORT image, and its
            # first (mip) frame as a fair subsample of it
            im_e = against_export(vis, "I3 view 0 (mip-started)")
            im0 = first[0]
            rel0 = im0.sum() / im_e.sum() - 1.0
            corr0 = float(np.corrcoef(im0.ravel(), im_e.ravel())[0, 1])
            log(f"phase I3 view 0: its first frame (tier 0, mass scale "
                f"{frames[0][3]!r}) against its view's EXPORT image: density"
                f" sum rel diff {rel0:.6e}, corr {corr0:.6f}")
            check(abs(rel0) <= 0.05, f"the mip frame's sum differs by {rel0}")
            check(corr0 > 0.9, f"the mip frame's correlation {corr0} <= 0.9")
            summary.update(mip_frame_rel=rel0, mip_frame_corr=corr0)
    launches = read_counts("interactive", ("splat_feed",
                                           "accumulate_groups"))
    promoted = [v for v, t in enumerate(first_tiers) if t == main_tier]
    # the frame's two parts alone (CUDA events): the CHANGE render and the
    # presentation (colormap, fit to the canvas, readback)
    render_ms = timed_ms(lambda: sph.render(DrawReason.CHANGE), 5)
    render_tier = sph.render_progression.last_block_tier
    present_ms = timed_ms(lambda: vis._compose_presentation(
        vis.canvas.width_physical, vis.canvas.height_physical), 5)
    while sph.needs_refine():                   # complete the view again
        sph.render(DrawReason.REFINE)
    summary.update(
        change_median_ms=statistics.median(change_ms),
        refine_median_ms=(statistics.median(refine_ms) if refine_ms
                          else None),
        frames_to_completion=n_frames, first_frame_tiers=first_tiers,
        promoted_views=promoted, render_ms=render_ms, present_ms=present_ms)
    log(f"phase I2: {FRAMES} views; CHANGE frame median "
        f"{summary['change_median_ms']:.3f} ms (frames "
        f"{[round(t, 3) for t in change_ms]}); REFINE frames "
        f"{[round(t, 3) for t in refine_ms]}; frames to completion "
        f"{n_frames}; first frame's tier per view {first_tiers} (main "
        f"layout {main_tier}; views the budget promoted to it: {promoted}); "
        f"launches during the {all_frames} frames of views 1 on "
        f"{launches}; alone: "
        f"a CHANGE render (tier {render_tier}) {render_ms:.3f} ms, "
        f"presentation {present_ms:.3f} ms")

    # ---- I3: the completed interactive image against EXPORT ---------------
    against_export(vis, "I3")

    # ---- I4: a view where the giant layer runs -----------------------------
    # zoomed in, more buckets hold giants than the candidate pool holds
    # (the plan then disables the layer); zoomed out, fewer do
    num_levels = splat.default_pyramid(RESOLUTION).num_levels
    for s in (250.0, 300.0, 400.0, 800.0):
        size, thresh = splat_giant.giant_plan(store.giant_meta(), RESOLUTION,
                                              s, num_levels)
        log(f"phase I4 giant plan at scale {s}: {size} candidates, bucket "
            f"threshold {thresh}")
        if size > 0:
            break
    check(size > 0, "no scale up to 800 plans a giant layer")
    vis.scale = s
    sph.render(DrawReason.EXPORT)
    check(sph._giant_image is not None, "the EXPORT frame drew no giant layer")
    raw = sph.get_image()[..., 0].astype(np.float64)
    ps = torch.as_tensor(vis.data_loader.get_pos_smooth(),
                         device=store.device)
    vals = store.values_for(sph._buffer_name)
    truth = splat.splat_scatter(ps, vals, sph._matrix().astype(np.float32),
                                RESOLUTION, np.float32(s))
    truth = truth[..., 0].cpu().numpy().astype(np.float64)
    del ps, vals
    rel = abs(raw.sum() / truth.sum() - 1.0)
    corr = float(np.corrcoef(raw.ravel(), truth.ravel())[0, 1])
    log(f"phase I4 EXPORT at scale {s} with the giant layer: density sum rel"
        f" diff {rel:.3e}, corr {corr:.6f} against splat_scatter")
    check(rel <= 1e-2, f"I4 density sum rel diff {rel} > 1e-2")
    check(corr > 0.999, f"I4 density correlation {corr} <= 0.999")
    frames = drive_view(vis)
    log(f"phase I4 view: frames {FRAME_FIELDS} {show_frames(frames)}")
    check(sph._giant_image is not None, "the interactive frame drew no giant "
          "layer")
    against_export(vis, "I4")
    summary["giant_scale"] = s

    vis.rotation_matrix = rotation
    vis.scale = scale0
    sph.render(DrawReason.EXPORT)
    log(f"phase I: {time.perf_counter() - t_all:.1f} s")
    return launches, feed_err, accum_err, summary

def export_frame_ms(sph):
    """(CUDA-event ms, host wall ms) of FRAMES EXPORT frames of the renderer
    ``sph``, each alone, after 2 warm-up frames."""
    import torch
    from topsy_tpu_torch.visualizer import DrawReason
    for _ in range(2):
        sph.invalidate()
        sph.render(DrawReason.EXPORT)
    frame_ms, wall_ms = [], []
    for _ in range(FRAMES):
        sph.invalidate()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        sph.render(DrawReason.EXPORT)
        end.record()
        torch.cuda.synchronize()
        wall_ms.append((time.perf_counter() - t0) * 1e3)
        frame_ms.append(start.elapsed_time(end))
    return frame_ms, wall_ms


def collapse_f64(atlas, pyramid, kind):
    """``splat_atlas.collapse_atlas`` evaluated in float64: the same crops
    and the same (float32) interpolation matrices of ``kind``, each level's
    two products and sums in float64.  Returns (res, res, C) float64."""
    import torch
    from topsy_tpu_torch.ops import splat_atlas
    from topsy_tpu_torch.ops.composite import _upsample2x_matrix
    row_offs, _, _ = splat_atlas.atlas_layout(pyramid)
    a = atlas.double()
    pad = splat_atlas.COL_PAD
    levels = [a[:, r0:r0 + n, pad:pad + n]
              for r0, n in zip(row_offs, pyramid.level_resolutions)]
    out = levels[-1]
    for lvl in range(pyramid.num_levels - 2, -1, -1):
        target = pyramid.level_resolutions[lvl]
        mh, mw = (torch.as_tensor(_upsample2x_matrix(n, kind),
                                  dtype=torch.float64, device=a.device)
                  for n in out.shape[1:])
        up = torch.einsum("chw,hH,wW->cHW", out, mh, mw)
        out = levels[lvl] + up[:, :target, :target]
    return out.permute(1, 2, 0)


def phase_catmull(vis, export_image, card):
    """Phase C: the EXPORT path of the scene's view with
    ``config.PYRAMID_COLLAPSE_FILTER = "catmull"``, restored afterwards.
    K1 and K2 held against their plain versions on piece 0 as in phases
    4-5; the collapse alone (piece 0's atlas after its three K2 calls)
    against its float64 evaluation within 1e-5 of the image maximum, timed
    beside the 'spline' collapse; EXPORT frames in turns, 'spline',
    'catmull', 'catmull', 'spline' (each turn 2 warm-ups and 5 frames by
    CUDA events; the medians of each filter's 10), each catmull frame
    launching the EXPORT path's one K1 and three K2 calls a piece;
    the frame against phase 7's 'spline' frame: sums within rel 1e-3,
    density correlation > 0.9999.  Returns (launches, K1 max diff, K2 max
    diff, summary)."""
    import numpy as np
    import torch
    from topsy_tpu_torch import config
    from topsy_tpu_torch.ops import splat, splat_accum, splat_atlas, \
        splat_feed
    sph = vis._sph
    G = vis.store.presorted_layout.pad_group
    pyr = splat.default_pyramid(RESOLUTION)
    _, atlas_rows, atlas_cols = splat_atlas.atlas_layout(pyr)
    saved = config.PYRAMID_COLLAPSE_FILTER
    check(saved == "spline", f"the scene's collapse filter is {saved!r}")
    summary = {"card": card}
    try:
        config.PYRAMID_COLLAPSE_FILTER = "catmull"
        # ---- C1: K1 and K2 on piece 0, exactly as phases 4-5 ---------------
        piece = sph.pieces()[0]
        fargs, fkw = feed_args(vis, piece)
        out_k = splat_feed.splat_feed_cuda(*fargs, **fkw)
        feed_err = compare_feed(f"C piece {piece}", out_k,
                                splat_feed.splat_feed_plain(*fargs, **fkw))
        calls, _ = k2_calls(out_k, G, atlas_rows, atlas_cols)
        accum_err = 0.0
        for shape, kw in calls.items():
            err, ref_max, active = compare_k2(f"C piece {piece} {shape}", kw)
            accum_err = max(accum_err, err)
            log(f"phase C K2 piece {piece} {shape}: ok; groups "
                f"{kw['flags'].shape[0]} of {kw['group']} (active {active}); "
                f"max|atlas| {ref_max:.4e}, max abs diff {err:.3e}")
        log(f"phase C K1 piece {piece}: ok; max abs diff {feed_err:.3e}")
        # ---- C2: the collapse alone against float64 ------------------------
        atlas = splat_accum.accumulate_groups(**calls["main"])
        splat_accum.accumulate_groups(**calls["tier2"], atlas0=atlas)
        splat_accum.accumulate_groups(**calls["tier3"], atlas0=atlas)
        del out_k, calls
        got = splat_atlas.collapse_atlas(atlas, pyr)
        want = collapse_f64(atlas, pyr, "catmull")
        peak = float(want.abs().max())
        err = float((got.double() - want).abs().max())
        check(np.isfinite(peak) and peak > 0, "the catmull collapse of "
              "piece 0 is empty")
        check(err <= 1e-5 * peak, f"the catmull collapse differs from its "
              f"float64 evaluation by {err} > 1e-5 * {peak}")
        collapse_ms = timed_ms(lambda: splat_atlas.collapse_atlas(atlas, pyr),
                               10)
        config.PYRAMID_COLLAPSE_FILTER = "spline"
        spline_collapse_ms = timed_ms(
            lambda: splat_atlas.collapse_atlas(atlas, pyr), 10)
        del atlas, got, want
        log(f"phase C2: piece 0's collapse with 'catmull' within "
            f"{err:.3e} of its float64 evaluation (image max {peak:.4e}, "
            f"{err / peak:.2e} of it); {collapse_ms:.3f} ms against "
            f"'spline' {spline_collapse_ms:.3f} ms (CUDA events, mean of "
            "10)")
        # ---- C3: EXPORT frames in turns: spline, catmull, catmull, spline ---
        spline_ms = export_frame_ms(sph)[0]
        config.PYRAMID_COLLAPSE_FILTER = "catmull"
        reset_counts()
        frame_ms, wall_ms = export_frame_ms(sph)
        frame_ms += export_frame_ms(sph)[0]
        launches = read_counts("catmull EXPORT", ("splat_feed",
                                                  "accumulate_groups"))
        raw = sph.get_image()
        config.PYRAMID_COLLAPSE_FILTER = "spline"
        spline_ms += export_frame_ms(sph)[0]
        n_frames = 2 * (FRAMES + 2)
        pieces = len(sph.pieces())
        check(launches["splat_feed"] == pieces * n_frames
              and launches["accumulate_groups"] == 3 * pieces * n_frames,
              f"the {n_frames} catmull EXPORT frames of {pieces} pieces "
              f"launched {launches}")
    finally:
        config.PYRAMID_COLLAPSE_FILTER = saved
    med = statistics.median(frame_ms)
    check(raw.shape == export_image.shape and np.isfinite(raw).all(),
          f"the catmull EXPORT image {raw.shape} is not finite")
    a, b = raw.astype(np.float64), export_image.astype(np.float64)
    rels = [abs(a[..., c].sum() / b[..., c].sum() - 1.0)
            for c in range(a.shape[-1])]
    corr = float(np.corrcoef(a[..., 0].ravel(), b[..., 0].ravel())[0, 1])
    max_rel = float(np.abs(a - b).max() / np.abs(b).max())
    check(max(rels) <= 1e-3, f"catmull against spline: channel sums rel "
          f"{rels} > 1e-3")
    check(corr > 0.9999, f"catmull against spline: density correlation "
          f"{corr} <= 0.9999")
    summary.update(export_ms=med,
                   spline_export_ms=statistics.median(spline_ms),
                   frames_ms=[round(t, 3) for t in frame_ms],
                   spline_frames_ms=[round(t, 3) for t in spline_ms],
                   wall_ms=statistics.median(wall_ms),
                   collapse_ms=collapse_ms,
                   spline_collapse_ms=spline_collapse_ms,
                   collapse_f64_rel=err / peak, sum_rel=rels, corr=corr,
                   max_rel=max_rel, dropped=sph.last_dropped_splats,
                   launches=launches)
    log("phase C: " + json.dumps(summary))
    return launches, feed_err, accum_err, summary


#: the launch counters of ``performance.counters``, by kernel
COUNTERS = {"splat_feed": "k1_launches", "accumulate_groups": "k2_launches",
            "accumulate_max_groups": "k3_launches",
            "zdeposit_plan": "k3_plan_launches"}


def reset_counts():
    from topsy_tpu_torch.performance import counters
    for name in COUNTERS.values():
        counters[name] = 0


def read_counts(tag, need):
    """The kernels' launches since ``reset_counts``; fails unless every
    kernel of ``need`` was launched."""
    from topsy_tpu_torch.performance import counters
    got = {k: counters[name] for k, name in COUNTERS.items()}
    check(all(got[k] > 0 for k in need),
          f"a kernel of the {tag} path was not launched: {got}")
    return got


def held_calls(tag, vis, sph, pieces, timed, times, column=None,
               tier=None):
    """K1 and K2 against their plain versions on every call of the given
    EXPORT pieces of the renderer ``sph`` (its buffer and depth channel)
    or, with ``column=(col0, width)``, of every piece of that column
    launch over ``tier`` (``store.PresortedMipTier``); the first
    piece's calls timed beside their plain versions and bounds into
    ``times`` ({call: (ms, plain ms, bound ms)}).  Returns (K1's and K2's
    largest differences)."""
    import numpy as np
    from topsy_tpu_torch.ops import splat, splat_accum, splat_atlas, \
        splat_feed
    from topsy_tpu_torch.render.sph import column_launches
    store = vis.store
    _, atlas_rows, atlas_cols = splat_atlas.atlas_layout(
        splat.default_pyramid(RESOLUTION))
    G = store.presorted_layout.pad_group
    feed_err = accum_err = 0.0
    kw_col = {}
    if column is not None:
        fields, vals, gb, msk, pieces, kw_col = column_launches(
            *tier_arrays(store, sph, tier), *column)
        G = column[1]
    for i, piece in enumerate(pieces):
        label = f"{tag} piece {piece}"
        if column is None:
            fargs, fkw = feed_args(vis, piece, sph)
        else:
            fargs, fkw = splat_atlas.feed_call(
                fields, vals, sph._matrix().astype(np.float32), RESOLUTION,
                np.float32(sph.scale), gb, mask=msk,
                depth_channel=sph._depth_channel, piece=piece,
                bucket_thresh=sph._giant_bucket)
        out_k = splat_feed.splat_feed_cuda(*fargs, **fkw)
        feed_err = max(feed_err, compare_feed(
            label, out_k, splat_feed.splat_feed_plain(*fargs, **fkw)))
        main_kw, t2_kw, t3_kw, dropped = splat_atlas.deposit_calls(
            out_k, C=len(out_k[3]), G=G, atlas_rows=atlas_rows,
            atlas_cols=atlas_cols, **kw_col)
        msg = (f"phase {label}: K1 (C_in {fkw['C_in']}, depth "
               f"{int(fkw['depth_channel'])}) bit-exact on integers")
        if i == 0 and timed:
            t = times[f"{tag}_K1"] = time_k1(tag.replace(" ", "_"), fargs,
                                             fkw, G)
            msg += (f" {t[0]:.3f} ms (plain {t[1]:.3f} ms, bound {t[2]:.4f} "
                    f"ms; {k1_note(tag.replace(' ', '_'))})")
        for shape, dkw in (("main", main_kw), ("tier2", t2_kw),
                           ("tier3", t3_kw)):
            err, ref_max, active = compare_k2(f"{label} {shape}", dkw)
            accum_err = max(accum_err, err)
            msg += (f"; K2 {shape} (C {dkw['C']}, groups "
                    f"{dkw['flags'].shape[0]} of {dkw['group']}, active "
                    f"{active}) within {err:.3e} of max|atlas| {ref_max:.4e}")
            if i == 0 and timed:
                b_ms, _, b_detail = k2_bound(dkw)
                t = times[f"{tag}_K2_{shape}"] = (
                    timed_ms(lambda: splat_accum.accumulate_groups_cuda(
                        **dkw), 5),
                    timed_ms(lambda: splat_accum.accumulate_groups_plain(
                        **dkw), 2), b_ms)
                msg += (f" {t[0]:.3f} ms (plain {t[1]:.3f} ms, bound "
                        f"{b_detail})")
        log(msg + f"; dropped {int(dropped.item())}")
        del out_k, main_kw, t2_kw, t3_kw
    return feed_err, accum_err


def against_truth(tag, raw, truth, channels):
    """Per channel: the image's sum within rel 1e-2 of the scatter truth's
    and correlation > 0.999."""
    import numpy as np
    out = []
    for c in channels:
        a = raw[..., c].astype(np.float64)
        b = truth[..., c].astype(np.float64)
        rel = abs(a.sum() / b.sum() - 1.0)
        corr = float(np.corrcoef(a.ravel(), b.ravel())[0, 1])
        out.append(f"channel {c}: sum rel diff {rel:.3e}, corr {corr:.6f}")
        check(rel <= 1e-2, f"{tag} channel {c}: sum rel diff {rel} > 1e-2")
        check(corr > 0.999, f"{tag} channel {c}: correlation {corr} <= 0.999")
    log(f"phase {tag} against splat_scatter: " + "; ".join(out))


def pick_truth(store, dr, tier, c0, width):
    """(the scatter truth of the depth renderer ``dr``'s CHANGE frame,
    the particles its launch covers): columns [c0, c0 + width) of ``tier``
    (the main layout or a decimation mip), with the particles its giant
    plan excludes from the launch masked out, divided by nothing; plus, when
    the view has a giant layer, the whole snapshot's excluded particles
    divided by the frame's mass scale (the layer is always complete and
    ``get_output_image`` folds it in so)."""
    import numpy as np
    import torch
    from topsy_tpu_torch.ops import splat
    from topsy_tpu_torch.ops.splat_giant import BUCKET_DISABLED, GIANT_H
    matrix = dr._matrix().astype(np.float32)
    scale = np.float32(dr.scale)
    num_levels = splat.default_pyramid(RESOLUTION).num_levels
    gb = int(dr._giant_bucket)
    arrays = (tier.pos_smooth, tier.values_for(dr._buffer_name),
              tier.buckets)
    G = tier.layout.pad_group

    def giants(ps, buckets):
        if gb == BUCKET_DISABLED:
            return torch.zeros_like(buckets, dtype=torch.bool)
        lev = splat.levels_from_buckets(buckets, RESOLUTION / (2.0 * scale),
                                        num_levels)
        h_px = splat.project(ps, matrix, RESOLUTION, scale)[3]
        return (h_px * splat.exp2_int(-lev) > GIANT_H) & (buckets >= gb)

    def columns(x):
        tail = tuple(x.shape[1:])
        return x.reshape((-1, G) + tail)[:, c0:c0 + width].reshape(
            (-1,) + tail)

    ps, vals, bks = (columns(a) for a in arrays)
    truth = splat.splat_scatter(ps, vals, matrix, RESOLUTION, scale,
                                extra_mask=~giants(ps, bks),
                                depth_channel=True)
    n_pick = int((vals[:, 0] != 0).sum())
    if dr._giant_image is not None:
        ps, vals = store.pos_smooth_presorted, store.presorted_values_for(
            dr._buffer_name)
        truth = truth + splat.splat_scatter(
            ps, vals, matrix, RESOLUTION, scale,
            extra_mask=giants(ps, store.presorted_buckets),
            depth_channel=True) / dr.last_render_mass_scale
    return truth, n_pick


def phase_modes(vis):
    """Phases M1-M4, the other additive modes on the EXPORT scene's
    Visualizer (its store and view): RGB and RGB-HDR, bivariate, the depth
    pick and periodic tiling.  Returns (launches per path, K1's and K2's
    largest differences, call times {call: (ms, plain ms, bound ms)}, a
    summary dict)."""
    import numpy as np
    import torch
    from topsy_tpu_torch.ops import splat
    from topsy_tpu_torch.ops.composite import lattice_composite
    from topsy_tpu_torch.render import sph as sph_module
    from topsy_tpu_torch.render.periodic import PeriodicSPHRenderer
    from topsy_tpu_torch.visualizer import DrawReason
    t_all = time.perf_counter()
    store = vis.store
    dev = store.device
    vis.show_colorbar = vis.show_scalebar = vis.show_status = False
    ps = store.pos_smooth
    launches, times, summary = {}, {}, {}
    feed_err = accum_err = 0.0

    # ---- M1: RGB and RGB-HDR --------------------------------------------
    vis.render_mode = "rgb"               # renders (autorange) one frame
    sph = vis._sph
    check(isinstance(sph, sph_module.RGBSPHRenderer), "not the RGB renderer")
    fe, ae = held_calls("M1 rgb", vis, sph, sph.pieces()[:1], True, times)
    feed_err, accum_err = max(feed_err, fe), max(accum_err, ae)
    reset_counts()
    frames = export_frame_ms(sph)[0]
    launches["rgb_export"] = read_counts("RGB EXPORT", ("splat_feed",
                                                        "accumulate_groups"))
    summary["rgb_frame_ms"] = frames
    raw = sph.get_image()
    check(raw.shape == (RESOLUTION, RESOLUTION, 3) and np.isfinite(raw).all(),
          f"RGB image {raw.shape} not finite")
    truth = splat.splat_scatter(
        ps, store.values_for("rgb"),
        sph._matrix().astype(np.float32), RESOLUTION, np.float32(sph.scale))
    against_truth("M1 rgb", raw, truth.cpu().numpy(), range(3))
    del truth
    out = sph.get_output_image()
    ms = sph.last_render_mass_scale
    present = {"rgb": timed_ms(lambda: vis.colormap.to_rgba(out, ms), 5)}
    pres = vis.get_sph_presentation_image()
    check(pres.shape == (RESOLUTION, RESOLUTION, 4) and pres.dtype == np.uint8
          and pres[..., :3].std() > 0, f"RGB presentation {pres.shape} "
          f"{pres.dtype} or constant")
    vis.render_mode = "rgb-hdr"
    out = vis._sph.get_output_image()
    present["rgb-hdr"] = timed_ms(lambda: vis.colormap.to_rgba(out, ms), 5)
    pres = vis.get_sph_presentation_image()
    check(pres.shape == (RESOLUTION, RESOLUTION, 4)
          and pres.dtype == np.float16
          and pres[..., :3].astype(np.float32).std() > 0,
          f"RGB-HDR presentation {pres.shape} {pres.dtype} or constant")
    log(f"phase M1: RGB EXPORT {FRAMES} frames, median "
        f"{statistics.median(frames):.3f} ms/frame (frames "
        f"{[round(t, 3) for t in frames]}), dropped (last piece) "
        f"{sph.last_dropped_splats}; launches {launches['rgb_export']}; "
        f"presentation (colormap alone) rgb {present['rgb']:.3f} ms, rgb-hdr "
        f"{present['rgb-hdr']:.3f} ms; HDR maximum "
        f"{float(pres[..., :3].astype(np.float32).max()):.4f}")

    # ---- M2: bivariate ------------------------------------------------------
    vis.render_mode = "bivariate"
    sph = vis._sph
    reset_counts()
    frames = export_frame_ms(sph)[0]
    launches["bivariate_export"] = read_counts(
        "bivariate EXPORT", ("splat_feed", "accumulate_groups"))
    summary["bivariate_frame_ms"] = frames
    out = sph.get_output_image()
    present["bivariate"] = timed_ms(
        lambda: vis.colormap.to_rgba(out, sph.last_render_mass_scale), 5)
    pres = vis.get_sph_presentation_image()
    check(pres.shape == (RESOLUTION, RESOLUTION, 4) and pres.dtype == np.uint8
          and pres[..., :3].std() > 0, "bivariate presentation constant")
    log(f"phase M2: bivariate EXPORT {FRAMES} frames, median "
        f"{statistics.median(frames):.3f} ms/frame (frames "
        f"{[round(t, 3) for t in frames]}); launches "
        f"{launches['bivariate_export']}; presentation (2-D LUT lookup) "
        f"{present['bivariate']:.3f} ms")
    summary["present_ms"] = present

    # ---- M3: the depth pick ------------------------------------------------
    # the user's path: an interactive view, then a double-click; the pick
    # renders one CHANGE frame of the tier its copy of the view's
    # progression picks
    vis.render_mode = "univariate"
    sph = vis._sph
    vis.draw(DrawReason.CHANGE)
    expect = copy.copy(sph.render_progression)
    expect.start_frame(DrawReason.CHANGE)
    (c0,), (width,) = expect.get_block(0.0)
    expect_tier = expect.last_block_tier
    reset_counts()
    depth = vis.get_depth_image()           # the pick's own CHANGE frame
    launches["depth_pick"] = read_counts("depth pick", ("splat_feed",
                                                        "accumulate_groups"))
    dr = sph._get_depth_renderer()
    pick_tier = dr.render_progression.last_block_tier
    check(dr.last_column_ranges == [(c0, width)] and pick_tier == expect_tier,
          f"the pick's frame launched {dr.last_column_ranges} on tier "
          f"{pick_tier}, its progression picks {[(c0, width)]} on tier "
          f"{expect_tier}")
    pick_ms = timed_ms(lambda: vis.get_depth_image(), 3)
    mips = store.ensure_column_mips()
    tier = mips[pick_tier] if pick_tier < len(mips) else store.main_tier
    fe, ae = held_calls("M3 depth", vis, dr, None, True, times,
                        column=(c0, width), tier=tier)
    feed_err, accum_err = max(feed_err, fe), max(accum_err, ae)
    # the truth of the same particles: the launched columns of the tier
    # (rescaled by the mass scale, as the pick's image is) and the view's
    # complete giant layer
    ms = dr.last_render_mass_scale
    raw = dr.get_image() / ms
    truth, n_pick = pick_truth(store, dr, tier, c0, width)
    truth = truth.cpu().numpy()
    against_truth("M3 depth renderer (the pick's particles)", raw, truth,
                  (0, 2))
    with np.errstate(invalid="ignore", divide="ignore"):
        d_truth = (truth[..., 2] / truth[..., 0] - 0.5) * dr.scale * 2.0
    dense = truth[..., 0] > 1e-3 * truth[..., 0].max()
    err = np.abs(depth - d_truth)[dense] / (2.0 * dr.scale)
    nan_agree = float((np.isnan(depth) == np.isnan(d_truth)).mean())
    log(f"phase M3: depth pick {pick_ms:.3f} ms (CUDA events, readback and "
        f"host division included); its frame rendered tier {pick_tier} "
        f"columns {dr.last_column_ranges} ({n_pick} particles, mass "
        f"scale {ms!r}, giant layer {dr._giant_image is not None}); the "
        f"pick's launch dropped "
        f"{dr.last_dropped_splats} splats; launches {launches['depth_pick']}; "
        f"against the scatter truth of those particles on the "
        f"{dense.mean():.4f} of pixels holding 1e-3 of the densest pixel's "
        f"mass: |d depth| / view depth median {np.median(err):.3e}, p99 "
        f"{np.percentile(err, 99):.3e}, max {err.max():.3e}; NaN pattern "
        f"agrees on {nan_agree:.6f}")
    # the pick's launch drops splats that the truth keeps (the mass
    # channel's sum differs by their share), which moves the weighted
    # depth of the pixels they cover
    check(np.median(err) <= 1e-4 and np.percentile(err, 99) <= 5e-3
          and err.max() <= 1e-2, "the depth pick differs from the scatter "
          "truth")
    summary.update(pick_ms=pick_ms, pick_tier=pick_tier,
                   pick_columns=[c0, width])
    del truth, raw

    # ---- M4: periodic tiling over the scene's store -----------------------
    psph = PeriodicSPHRenderer(store, vis.data_loader.get_render_progression(),
                               RESOLUTION, PERIODICITY)
    psph.rotation_matrix = sph.rotation_matrix
    psph.position_offset = sph.position_offset
    psph.scale = sph.scale
    reset_counts()
    frames = export_frame_ms(psph)[0]
    launches["periodic_export"] = read_counts(
        "periodic EXPORT", ("splat_feed", "accumulate_groups"))
    summary["periodic_frame_ms"] = frames
    offsets, weights = psph.lattice_pixels()
    panel = sph_module.SPHRenderer.get_output_image(psph)
    lattice_ms = timed_ms(lambda: lattice_composite(panel, offsets, weights),
                          5)
    tiled = psph.get_output_image().double()
    expect = torch.zeros_like(tiled)
    p64 = panel.double()
    H, W = p64.shape[:2]
    rows = torch.arange(H, device=dev)[:, None]
    cols = torch.arange(W, device=dev)[None, :]
    for (dy, dx), w in zip(offsets.astype(np.float64), weights):
        iy, ix = int(np.floor(dy)), int(np.floor(dx))
        fy, fx = dy - iy, dx - ix
        for sy, sx, f in ((iy, ix, (1 - fy) * (1 - fx)),
                          (iy, ix + 1, (1 - fy) * fx),
                          (iy + 1, ix, fy * (1 - fx)), (iy + 1, ix + 1, fy * fx)):
            valid = (((rows >= sy) if sy >= 0 else (rows < H + sy))
                     & ((cols >= sx) if sx >= 0 else (cols < W + sx)))
            rolled = torch.roll(p64, (sy, sx), dims=(0, 1))
            expect += rolled * valid[..., None] * (f * float(w))
    diff = float((tiled - expect).abs().max() / expect.abs().max())
    bare, full = float(p64[..., 0].sum()), float(tiled[..., 0].sum())
    log(f"phase M4: periodic tiling over the scene's store (periodicity "
        f"{PERIODICITY}, the periodic TestDataLoader's box): {len(weights)} "
        f"lattice instances, weights sum {float(weights.sum()):.4f}; EXPORT "
        f"{FRAMES} frames, median {statistics.median(frames):.3f} ms/frame "
        f"(frames {[round(t, 3) for t in frames]}); lattice_composite alone "
        f"{lattice_ms:.3f} ms; tiled image against a float64 roll-and-mask "
        f"composite: max diff {diff:.3e} of the max; density sum tiled / "
        f"bare panel {full / bare:.4f}; launches {launches['periodic_export']}")
    check(np.isfinite(tiled.cpu().numpy()).all(), "periodic image not finite")
    check(diff <= 1e-5, f"the lattice composite differs by {diff}")
    check(full >= bare, "the tiled image holds less than the bare panel")
    summary["lattice_ms"] = lattice_ms
    del ps, tiled, expect, p64, psph
    log(f"phase M: {time.perf_counter() - t_all:.1f} s")
    return launches, feed_err, accum_err, times, summary



# ---------------------------------------------------------------------------
# phases L (the sorted block paths) and A (the array entry point)
# ---------------------------------------------------------------------------

K2_ARGS = ("ay_g", "ax_g", "ih_g", "coef_g", "w0", "c0", "ce", "flags")


@contextmanager
def timing_calls(module, *names):
    """CUDA-event milliseconds of every call of the functions ``names`` of
    ``module`` while the block is active: {name: [ms per call]}, filled
    as the block exits (after a device barrier)."""
    import torch
    originals = {name: getattr(module, name) for name in names}
    pending, times = [], {name: [] for name in names}

    def timed(name):
        fn = originals[name]

        def call(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            end.record()
            pending.append((name, start, end))
            return out
        return call

    for name in names:
        setattr(module, name, timed(name))
    try:
        yield times
    finally:
        for name, fn in originals.items():
            setattr(module, name, fn)
        torch.cuda.synchronize()
        for name, start, end in pending:
            times[name].append(start.elapsed_time(end))


@contextmanager
def recording_k2():
    """Records the keyword arguments of every K2 call the renderers make
    (``splat_accum.accumulate_groups``, the wrapper that launches K2 on a
    CUDA tensor) while the block is active, its starting atlas left out:
    ``compare_k2`` replays each from a zero atlas."""
    from topsy_tpu_torch.ops import splat_accum
    calls = []
    original = splat_accum.accumulate_groups

    def record(*args, **kw):
        call = dict(zip(K2_ARGS, args), **kw)
        call.pop("atlas0", None)
        calls.append(call)
        return original(*args, **kw)

    splat_accum.accumulate_groups = record
    try:
        yield calls
    finally:
        splat_accum.accumulate_groups = original


def k2_shape(kw):
    """The call shape of a recorded K2 call: the main pass, spill tier 2
    (full-width windows) or spill tier 3 (one-particle groups)."""
    from topsy_tpu_torch.ops import splat_accum
    if kw["group"] == 1:
        return "tier3"
    if kw.get("window_cols", splat_accum.WINDOW_COLS) != \
            splat_accum.WINDOW_COLS:
        return "tier2"
    return "main"


def hold_k2_calls(tag, calls, launches):
    """Every recorded K2 call of a path against its plain version (within
    1e-5 of the atlas maximum), the first call of each (shape, G, window
    rows) timed beside its plain version and bound.  Returns the
    kernels-line entry of the path (``launches`` from its run; its ``ms``
    and bound those of its first main pass) and {shape: (G, window rows,
    groups)} of the calls."""
    err_max, times, shapes = 0.0, {}, {}
    for i, kw in enumerate(calls):
        shape = k2_shape(kw)
        key = f"{shape}_G{kw['group']}_rows{kw['window_rows']}"
        err, ref_max, active = compare_k2(f"{tag} call {i} {shape}", kw)
        err_max = max(err_max, err)
        shapes.setdefault(shape, set()).add(
            (kw["group"], kw["window_rows"], kw["flags"].shape[0]))
        msg = (f"phase {tag} K2 call {i} {shape}: G {kw['group']}, window "
               f"rows {kw['window_rows']}, cols {kw.get('window_cols', 256)},"
               f" groups {kw['flags'].shape[0]} (active {active}); within "
               f"{err:.3e} of max|atlas| {ref_max:.4e}")
        if key not in times:
            from topsy_tpu_torch.ops import splat_accum
            b_ms, b_by, b_detail = k2_bound(kw)
            times[key] = (
                timed_ms(lambda: splat_accum.accumulate_groups_cuda(**kw), 5),
                timed_ms(lambda: splat_accum.accumulate_groups_plain(**kw), 2),
                b_ms, b_by)
            t = times[key]
            msg += (f"; {t[0]:.3f} ms (plain {t[1]:.3f} ms); bound {b_detail}"
                    f", {t[2] / t[0]:.1%} of it")
        log(msg)
    main = next(v for k, v in times.items() if k.startswith("main"))
    entry = {"launches": launches, "max_abs_err": err_max, "ms": main[0],
             "plain_ms": main[1], "bound_ms": main[2], "bound_by": main[3],
             "library_ms": None,
             "ms_by_call": {k: v[0] for k, v in times.items()},
             "plain_ms_by_call": {k: v[1] for k, v in times.items()},
             "bound_ms_by_call": {k: v[2] for k, v in times.items()}}
    return entry, {k: sorted(v) for k, v in shapes.items()}


def fresh_renderer(store, loader, cls=None, **kw):
    """A renderer of ``cls`` (SPHRenderer) over ``store`` at the scene's
    resolution and the loader's own initial view."""
    from topsy_tpu_torch.render.sph import SPHRenderer
    sph = (cls or SPHRenderer)(store, loader.get_render_progression(),
                               kw.pop("resolution", RESOLUTION), **kw)
    sph.position_offset = -loader.get_initial_center()
    sph.scale = loader.get_initial_view_width()
    return sph


def images_agree(tag, a, b, rel_max, corr_min):
    """Density channel of ``a`` against ``b``: sum rel diff within
    ``rel_max``, correlation above ``corr_min``; logs the largest pixel
    difference too.  Returns (rel, corr)."""
    import numpy as np
    a, b = a[..., 0].astype(np.float64), b[..., 0].astype(np.float64)
    rel = abs(a.sum() / b.sum() - 1.0)
    corr = float(np.corrcoef(a.ravel(), b.ravel())[0, 1])
    diff = float(np.abs(a - b).max() / np.abs(b).max())
    log(f"phase {tag}: density sum rel diff {rel:.3e}, corr {corr:.7f}, max "
        f"pixel diff {diff:.3e} of the max")
    check(np.isfinite(a).all(), f"{tag}: image not finite")
    check(rel <= rel_max, f"{tag}: density sum rel diff {rel} > {rel_max}")
    check(corr > corr_min, f"{tag}: correlation {corr} <= {corr_min}")
    return rel, corr


def scatter_truth(store, sph):
    """``splat_scatter`` of the store's particles at the renderer's view,
    (res, res, C) numpy."""
    import numpy as np
    from topsy_tpu_torch.ops import splat
    return splat.splat_scatter(
        store.pos_smooth, store.values_for(sph._buffer_name),
        sph._matrix().astype(np.float32), sph._resolution,
        np.float32(sph.scale)).cpu().numpy()


def phase_sorted(vis, export_image, view):
    """Phases L1-L4, the block paths: L1 a fresh renderer over a fresh
    store of the scene's loader renders its one-shot EXPORT through the
    per-frame-sorted block path (no presort built), every K2 call of the
    frame held against its plain version, the frame again with the
    allocator warm and each piece's dense giant layer (``giant_image`` on
    the piece's own giants) timed by CUDA events, the image against the
    scatter truth and the presorted EXPORT image (``export_image``) of
    ``view`` (rotation, offset, scale), its time beside the presort plus
    the presorted frame, then its second EXPORT presorts; L3 small scenes
    (2^16 and 2^13 particles, 256^2) whose sorted path runs K2 at G = 128
    and 64 and tier 2 at 16; L4 CHANGE and REFINE frames of the scene
    without the column progression, a barrier after each block, per-block
    CUDA-event times, until the view completes, against EXPORT, every K2
    call of its first two frames (blocks of ~2^17 rows: G = 128, tier 2 at
    16) held against its plain version.  Returns (the kernels-line entries
    by path, launches by path, a summary dict)."""
    import numpy as np
    import torch
    from topsy_tpu_torch import config
    from topsy_tpu_torch.loaders import TestDataLoader
    from topsy_tpu_torch.ops import splat_giant
    from topsy_tpu_torch.render.store import ParticleStore
    from topsy_tpu_torch.visualizer import DrawReason
    t_all = time.perf_counter()
    dev = vis.store.device
    loader = vis.data_loader
    entries, launches, summary = {}, {}, {}

    # ---- L1: the one-shot EXPORT through the sorted block path ----------
    store = ParticleStore(loader, device=dev)
    store.quantity_name = vis.store.quantity_name
    sph = fresh_renderer(store, loader)
    sph.rotation_matrix, sph.position_offset, sph.scale = view
    check(not sph._use_presorted(), "L1: a fresh renderer would presort")
    reset_counts()
    with recording_k2() as calls:
        oneshot_ms, oneshot_wall, _ = cuda_ms(
            lambda: sph.render(DrawReason.EXPORT))
    launches["sorted_export"] = read_counts("sorted EXPORT",
                                            ("accumulate_groups",))
    check(store.presorted_layout is None, "L1: the one-shot EXPORT built "
          "the presort")
    check(launches["sorted_export"]["splat_feed"] == 0, "L1: the sorted "
          "path launched the feed kernel")
    raw = sph.get_image()
    check(raw.shape == (RESOLUTION, RESOLUTION, 2), f"L1 image {raw.shape}")
    entries["sorted"], summary["sorted_calls"] = hold_k2_calls(
        "L1 sorted", calls, launches["sorted_export"]["accumulate_groups"])
    del calls
    images_agree("L1 sorted EXPORT against splat_scatter", raw,
                 scatter_truth(store, sph), 1e-2, 0.999)
    images_agree("L1 sorted EXPORT against the presorted EXPORT", raw,
                 export_image, 1e-3, 0.9999)
    # the same frame again, the allocator warm (the policy would presort),
    # each piece's dense giant layer (its own giants) timed by CUDA events
    sph._export_renders = 0
    sph.invalidate()
    with timing_calls(splat_giant, "giant_image") as giant_calls:
        warm_ms, _, _ = cuda_ms(lambda: sph.render(DrawReason.EXPORT))
    giant_ms = giant_calls["giant_image"]
    check(len(giant_ms) == launches["sorted_export"]["accumulate_groups"]
          // 3, f"L1: {len(giant_ms)} giant layers, not one per piece")
    check(sph._use_presorted(), "L1: the second EXPORT would not presort")
    presort_ms, _, _ = cuda_ms(store.ensure_presorted)
    sph.invalidate()
    presorted_ms, _, _ = cuda_ms(lambda: sph.render(DrawReason.EXPORT))
    check(store.presorted_layout is not None, "L1: no presort after the "
          "second EXPORT")
    images_agree("L1 second EXPORT (presorted) against the scene's",
                 sph.get_image(), export_image, 1e-4, 0.99999)
    faster = ("the one-shot sorted EXPORT" if oneshot_ms
              < presort_ms + presorted_ms else "the presort and its frame")
    log(f"phase L1: one-shot sorted EXPORT {oneshot_ms:.3f} ms (CUDA events;"
        f" {oneshot_wall:.3f} ms wall; flat arrays built in it; dropped "
        f"{sph.last_dropped_splats} in its last piece; again, warm, "
        f"{warm_ms:.3f} ms, of which the pieces' dense giant layers "
        f"{[round(t, 3) for t in giant_ms]} ms, {sum(giant_ms):.3f} ms) "
        f"against the presort "
        f"{presort_ms:.3f} ms + the presorted EXPORT {presorted_ms:.3f} ms ="
        f" {presort_ms + presorted_ms:.3f} ms: the faster first image is "
        f"{faster}")
    summary.update(oneshot_ms=oneshot_ms, warm_ms=warm_ms,
                   giant_layers_ms=giant_ms, presort_ms=presort_ms,
                   presorted_ms=presorted_ms)
    del sph, store, raw
    torch.cuda.empty_cache()

    # ---- L3: small scenes, K2 at G = 128 and 64, tier 2 at 16 -----------
    small_calls, small_launches = [], 0
    for n, expect_g in ((1 << 16, 128), (1 << 13, 64)):
        sloader = TestDataLoader(n, seed=1337)
        sstore = ParticleStore(sloader, device=dev)
        sstore.quantity_name = "test-quantity"
        ssph = fresh_renderer(sstore, sloader, resolution=256)
        reset_counts()
        with recording_k2() as calls:
            ssph.render(DrawReason.EXPORT)
            sraw = ssph.get_image()
        got = read_counts(f"sorted EXPORT of {n}", ("accumulate_groups",))
        small_launches += got["accumulate_groups"]
        groups = sorted({kw["group"] for kw in calls})
        check(groups == [1, 16, expect_g], f"L3 {n}: K2 group widths "
              f"{groups}, not [1, 16, {expect_g}]")
        images_agree(f"L3 {n} particles at 256^2 against splat_scatter",
                     sraw, scatter_truth(sstore, ssph), 1e-2, 0.999)
        small_calls += calls
    entries["sorted_small"], summary["small_calls"] = hold_k2_calls(
        "L3 small", small_calls, small_launches)
    del small_calls

    # ---- L4: interactive frames without the column progression ----------
    config.INTERACTIVE_USE_PRESORTED = False
    try:
        sph = fresh_renderer(vis.store, loader)
        sph.rotation_matrix, sph.position_offset, sph.scale = view
        block_ms = []
        launch = sph._launch_block

        def timed_launch(*args):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            im = launch(*args)
            end.record()
            block_ms[-1].append((start, end, args[3]))
            return im

        sph._launch_block = timed_launch
        frames, held = [], []
        reason = DrawReason.CHANGE
        reset_counts()
        while True:
            block_ms.append([])
            if len(frames) < 2:
                with recording_k2() as calls:
                    sph.render(reason)
                held += calls
            else:
                sph.render(reason)
            torch.cuda.synchronize()
            frames.append((sph._render_timer.last_duration * 1e3,
                           [(round(s.elapsed_time(e), 3), c)
                            for s, e, c in block_ms[-1]],
                           sph.last_render_mass_scale))
            check(not sph.last_column_ranges, "L4: a column launch")
            if not sph.needs_refine():
                break
            check(len(frames) < 400, "L4: no completion in 400 frames")
            reason = DrawReason.REFINE
        launches["sorted_blocks"] = read_counts("block frames",
                                                ("accumulate_groups",))
        entries["sorted_blocks"], summary["block_calls"] = hold_k2_calls(
            "L4 blocks", held, launches["sorted_blocks"]["accumulate_groups"])
        groups = sorted({kw["group"] for kw in held})
        check(groups == [1, 16, 128], f"L4: K2 group widths {groups}, not "
              "[1, 16, 128]")
        del held, calls
        blocks = [len(f[1]) for f in frames]
        log(f"phase L4: {len(frames)} frames to completion, {sum(blocks)} "
            f"blocks (per frame {blocks}); frame ms by the barriers' CUDA "
            f"events {[round(f[0], 3) for f in frames]}; per-block (ms, "
            f"particles) of the first frames {[f[1] for f in frames[:3]]}; "
            f"mass scale after the first frame {frames[0][2]!r}")
        check(abs(sph.last_render_mass_scale - 1.0) <= 1e-6,
              "L4: the completed frame's mass scale is not 1")
        images_agree("L4 completed block frames against EXPORT",
                     sph.get_image(), export_image, 1e-3, 0.9999)
        summary["block_frames"] = [(f[0], len(f[1])) for f in frames]
    finally:
        config.INTERACTIVE_USE_PRESORTED = True
    del sph
    torch.cuda.empty_cache()
    log(f"phase L: {time.perf_counter() - t_all:.1f} s")
    return entries, launches, summary


def phase_surface_fallback(vis, cut_percentile=50.0):
    """Phase L5: the surface scatter fallback (no column progression: the
    flat arrays through ``zsplat_scatter`` in bucket pieces, truncated
    giants) against the column path's surface EXPORT image at the scene's
    view (scale 200, where no giant layer runs), at the surface checks'
    tolerances (coverage flips <= 1e-4, depth rtol 1e-5 / atol 1e-4, winner
    values equal on >= 99.9%).  Returns a summary dict."""
    import numpy as np
    from topsy_tpu_torch import config
    from topsy_tpu_torch.ops.splat_giant import BUCKET_DISABLED
    from topsy_tpu_torch.render.surface import SurfaceSPHRenderer
    from topsy_tpu_torch.visualizer import DrawReason
    ssph = vis._sph
    ssph.set_density_cut_percentile(cut_percentile)
    ssph.invalidate()
    ssph.render(DrawReason.EXPORT)
    check(int(ssph._giant_bucket) == BUCKET_DISABLED,
          "L5: a giant layer runs at the scene's view")
    col = ssph.get_image()
    config.INTERACTIVE_USE_PRESORTED = False
    try:
        fb = fresh_renderer(vis.store, vis.data_loader, SurfaceSPHRenderer)
        fb.rotation_matrix, fb.position_offset, fb.scale = (
            ssph.rotation_matrix, ssph.position_offset, ssph.scale)
        fb.set_density_cut_percentile(cut_percentile)
        fb_ms, _, _ = cuda_ms(lambda: fb.render(DrawReason.EXPORT))
    finally:
        config.INTERACTIVE_USE_PRESORTED = True
    check(not fb.last_column_ranges and fb._surface_giant_layer is None,
          "L5: the fallback ran the column path")
    raw = fb.get_image()
    cov_c, cov_f = col[..., 1] > 0, raw[..., 1] > 0
    flips = int((cov_c != cov_f).sum())
    both = cov_c & cov_f
    d_ok = np.isclose(raw[..., 1][both], col[..., 1][both], rtol=1e-5,
                      atol=1e-4)
    v_ok = np.isclose(raw[..., 0][both], col[..., 0][both], rtol=1e-5,
                      atol=1e-6)
    log(f"phase L5: surface scatter fallback EXPORT {fb_ms:.3f} ms (CUDA "
        f"events) at cut percentile {cut_percentile}; covered "
        f"{int(cov_f.sum())} px, coverage flips {flips}, depth within rtol "
        f"1e-5/atol 1e-4 on {d_ok.mean():.6f}, winner values agree on "
        f"{v_ok.mean():.6f} of both-covered pixels, against the column "
        f"path's EXPORT image")
    check(cov_f.sum() > 0, "L5: the fallback covers nothing")
    check(flips <= 1e-4 * cov_c.sum(), f"L5: coverage flips {flips}")
    check(d_ok.all(), f"L5: depth differs on {int((~d_ok).sum())} pixels")
    check(v_ok.mean() >= 0.999, f"L5: winner values agree on {v_ok.mean()}")
    return dict(fallback_ms=fb_ms, flips=flips, covered=int(cov_f.sum()))


def phase_arrays(dev, loader, exps=(18, 20, 22, 24), check_exp=20,
                 array_exp=22):
    """Phase A, the array entry point: ``knn_smooth_device`` (64
    neighbours, the array loader's default) on the scene's first 2^18,
    2^20, 2^22 and, when 2^22 predicts it inside the budget, 2^24
    positions (CUDA events, each pass apart: the local pass, the
    selected-tile pass with its proof, the finishing pass, the rest; the
    share of queries in the finishing pass; the peak allocation held under
    ``knn_device.device_bytes``);
    at 2^20 against ``native.knn_smooth`` on every particle and
    ``scipy.spatial.cKDTree`` on a seeded 10^4 (rel < 1e-4); then an
    ``ArrayDataLoader`` Visualizer over 2^22 positions without smoothing
    lengths: its time to the first EXPORT image (the sorted path) and the
    image against ``splat_scatter`` of the same smoothing.  Returns a
    summary dict."""
    import numpy as np
    import torch
    from scipy.spatial import cKDTree
    from topsy_tpu_torch import native
    from topsy_tpu_torch.loaders import ArrayDataLoader
    from topsy_tpu_torch.ops import knn_device
    from topsy_tpu_torch.visualizer import OffscreenCanvas, Visualizer
    t_all = time.perf_counter()
    nn = 64
    passes = ("_local_pass", "_tiled_kth_d2", "_brute_kth_d2")
    pos_all = loader.get_positions()
    summary = {}
    for i, k in enumerate(exps):
        n = 1 << k
        if i and 4.5 * summary["knn_ms"][exps[i - 1]] > KNN_BUDGET_MS:
            log(f"phase A: knn_smooth_device at 2^{k} skipped: 2^"
                f"{exps[i - 1]} took {summary['knn_ms'][exps[i - 1]]:.1f} ms,"
                f" so 2^{k} would pass the {KNN_BUDGET_MS / 1e3:.0f} s budget")
            continue
        pos = torch.from_numpy(np.ascontiguousarray(pos_all[:n])).to(dev)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with timing_calls(knn_device, *passes) as pass_ms:
            ms, wall, (h, stats) = cuda_ms(
                lambda: knn_device.knn_smooth_device_stats(pos, nn))
        peak = torch.cuda.max_memory_allocated() - base
        bound_b = knn_device.device_bytes(n)
        check(bool(torch.isfinite(h).all()) and bool((h > 0).all()),
              f"A: smoothing lengths at 2^{k} not finite and positive")
        check(peak <= bound_b, f"A: the device kNN at 2^{k} allocated "
              f"{peak} bytes, over its bound {bound_b}")
        split = {p: sum(v) for p, v in pass_ms.items()}
        split["_tiled_kth_d2"] -= split["_local_pass"]
        split = {"local": split["_local_pass"],
                 "selected": split["_tiled_kth_d2"],
                 "finishing": split["_brute_kth_d2"]}
        split["sort_and_rest"] = ms - sum(split.values())
        summary.setdefault("knn_ms", {})[k] = ms
        summary.setdefault("knn_split_ms", {})[k] = split
        summary.setdefault("knn_finishing", {})[k] = stats["finishing"] / n
        summary.setdefault("knn_peak_bytes", {})[k] = (peak, bound_b)
        log(f"phase A: knn_smooth_device 2^{k} = {n} positions, {nn} "
            f"neighbours: {ms:.3f} ms (CUDA events; {wall:.3f} ms wall); "
            f"passes (CUDA events) {json.dumps(split)} ms; "
            f"blocks {stats['blocks']}, {stats['selected_blocks']} took the "
            f"selected-tile pass, {stats['finishing']} queries "
            f"({stats['finishing'] / n:.4%}) the finishing pass; peak device "
            f"allocation {peak / 2**30:.3f} GiB above its input, "
            f"{peak / bound_b:.1%} of its bound "
            f"(knn_device.device_bytes) {bound_b / 2**30:.3f} GiB")
        if k == check_exp:
            host = pos_all[:n]
            t0 = time.perf_counter()
            h_native = native.knn_smooth(host, nn)
            native_s = time.perf_counter() - t0
            check(h_native is not None, "A: the native kNN did not build")
            got = h.cpu().numpy()
            rel = float((np.abs(got - h_native) / h_native).max())
            rng = np.random.RandomState(1337)
            q = rng.choice(n, 10_000, replace=False)
            t0 = time.perf_counter()
            d, _ = cKDTree(host).query(host[q], k=nn + 1)
            kd_s = time.perf_counter() - t0
            rel_kd = float((np.abs(got[q] - 0.5 * d[:, -1])
                            / (0.5 * d[:, -1])).max())
            log(f"phase A: at 2^{k} against native.knn_smooth ({native_s:.3f}"
                f" s wall on the host) max rel diff {rel:.3e} over every "
                f"particle; against cKDTree ({kd_s:.3f} s) on 10^4 seeded "
                f"particles {rel_kd:.3e}")
            check(rel < 1e-4, f"A: against the native kNN rel {rel}")
            check(rel_kd < 1e-4, f"A: against cKDTree rel {rel_kd}")
            summary.update(native_s=native_s, native_rel=rel, kd_rel=rel_kd)
        del pos, h
        torch.cuda.empty_cache()

    n = 1 << array_exp
    pos = np.ascontiguousarray(pos_all[:n])
    qty = np.sin(pos[:, 0]).astype(np.float32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    avis = Visualizer(data_loader_class=ArrayDataLoader,
                      data_loader_args=(pos,),
                      data_loader_kwargs={"quantities": {"q": qty},
                                          "device": dev},
                      render_resolution=RESOLUTION,
                      canvas_class=OffscreenCanvas, device=dev)
    raw = avis._sph.get_image()
    first_s = time.perf_counter() - t0
    check(avis.store.presorted_layout is None, "A: the array Visualizer's "
          "first EXPORT built the presort")
    rel, corr = images_agree(
        "A array loader's first EXPORT against splat_scatter", raw,
        scatter_truth(avis.store, avis._sph), 1e-2, 0.999)
    log(f"phase A: ArrayDataLoader({n} positions, no smoothing lengths) "
        f"Visualizer to its first EXPORT image (device kNN, cells, store, "
        f"the sorted EXPORT, autorange, readback) {first_s:.3f} s wall; "
        f"{time.perf_counter() - t_all:.1f} s")
    summary.update(array_first_image_s=first_s, array_rel=rel,
                   array_corr=corr)
    del avis
    torch.cuda.empty_cache()
    return summary


# ---------------------------------------------------------------------------
# phase G: the particle mesh
# ---------------------------------------------------------------------------

@contextmanager
def logged_warnings(*names):
    """The WARNING records of the loggers ``names`` while the block runs."""
    import logging
    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    handler = Keep(logging.WARNING)
    loggers = [logging.getLogger(n) for n in names]
    for lg in loggers:
        lg.addHandler(handler)
    try:
        yield records
    finally:
        for lg in loggers:
            lg.removeHandler(handler)


def card_mesh():
    """One shard per card on a machine with two or more cards, else two
    shards on cuda:0; and whether the cards are distinct."""
    import torch
    from topsy_tpu_torch.parallel import make_mesh
    n = torch.cuda.device_count()
    if n >= 2:
        return make_mesh(n), True
    return make_mesh(2, devices=["cuda:0"] * 2), False


@contextmanager
def recording_shards(n_local):
    """Records the kernel calls each shard makes inside its device guard
    (``render_step.device_guard``, entered once per local shard and path
    in shard order): {"K1": [(shard, args, kwargs)], "K2": [(shard, K2
    kwargs without the starting atlas)], "K3": [(shard, starting keys,
    kwargs)]}."""
    from topsy_tpu_torch.ops import splat_accum, splat_feed, zsplat_atlas
    from topsy_tpu_torch.parallel import render_step
    calls = {"K1": [], "K2": [], "K3": []}
    state = {"enters": 0, "shard": None}
    originals = (render_step.device_guard, splat_feed.splat_feed,
                 splat_accum.accumulate_groups,
                 zsplat_atlas.accumulate_max_packed)
    guard, feed, accum, zaccum = originals

    @contextmanager
    def shard_guard(device):
        state["shard"] = state["enters"] % n_local
        state["enters"] += 1
        try:
            with guard(device):
                yield
        finally:
            state["shard"] = None

    def rec_feed(*args, **kw):
        calls["K1"].append((state["shard"], args, kw))
        return feed(*args, **kw)

    def rec_accum(*args, **kw):
        call = dict(zip(K2_ARGS, args), **kw)
        call.pop("atlas0", None)
        calls["K2"].append((state["shard"], call))
        return accum(*args, **kw)

    def rec_zaccum(keys, *args, **kw):
        calls["K3"].append((state["shard"], keys.clone(), kw))
        return zaccum(keys, *args, **kw)

    render_step.device_guard = shard_guard
    splat_feed.splat_feed = rec_feed
    splat_accum.accumulate_groups = rec_accum
    zsplat_atlas.accumulate_max_packed = rec_zaccum
    try:
        yield calls
    finally:
        (render_step.device_guard, splat_feed.splat_feed,
         splat_accum.accumulate_groups,
         zsplat_atlas.accumulate_max_packed) = originals


def hold_k1_calls(tag, calls):
    """Every recorded K1 call against its plain version; the first timed
    beside its plain version and bound.  Returns (largest difference,
    (ms, plain ms, bound ms))."""
    from topsy_tpu_torch.ops import splat_feed
    err, t = 0.0, None
    for i, (args, kw) in enumerate(calls):
        out_k = splat_feed.splat_feed_cuda(*args, **kw)
        err = max(err, compare_feed(f"{tag} call {i}", out_k,
                                    splat_feed.splat_feed_plain(*args, **kw)))
        msg = (f"phase {tag} K1 call {i}: groups {kw['piece_groups']} of "
               f"{args[0][0].shape[1]} (C_in {kw['C_in']}, depth "
               f"{int(kw['depth_channel'])}), bit-exact on integers")
        if i == 0:
            key = tag.replace(" ", "_")
            t = time_k1(key, args, kw, args[0][0].shape[1])
            msg += (f"; {t[0]:.3f} ms (plain {t[1]:.3f} ms, bound {t[2]:.4f} "
                    f"ms; {k1_note(key)})")
        log(msg)
    return err, t


def hold_k3_calls(tag, calls):
    """Every recorded K3 call bit-identical to its plain version from the
    call's own starting keys; the first timed, beside its bound from
    ``k3_work`` on its own inputs.  Returns (number held, (ms, plain ms,
    bound ms, bound by))."""
    import torch
    from topsy_tpu_torch.ops import zsplat_accum
    t = None
    for i, (keys0, kw) in enumerate(calls):
        k = keys0.clone()
        zsplat_accum.accumulate_max_packed_cuda(k, **kw)
        p = keys0.clone()
        torch.cuda.synchronize()
        tp = time.perf_counter()
        zsplat_accum.accumulate_max_packed_plain(p, **kw)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - tp) * 1e3
        n_diff = int((k != p).sum().item())
        check(n_diff == 0, f"{tag} K3 call {i}: {n_diff} keys differ from "
              "the plain version")
        msg = (f"phase {tag} K3 call {i}: groups {kw['flags'].shape[0]} of "
               f"{kw['group']}, bit-identical")
        if i == 0:
            k_t = keys0.clone()
            nbytes, ops = k3_work(kw, keys0)[:2]
            t = (timed_from_ms(
                lambda: zsplat_accum.accumulate_max_packed_cuda(k_t, **kw),
                lambda: k_t.copy_(keys0), 5), plain_ms,
                *bound(nbytes, ops, F32_OPS_PER_S))
            msg += (f"; {t[0]:.3f} ms (plain {plain_ms:.3f} ms, host wall);"
                    f" bound {t[2]:.4f} ms ({t[3]}), {t[2] / t[0]:.1%} of "
                    "it")
        log(msg)
    return len(calls), t


def visible_count(store, sph):
    """Particles of the store inside the renderer's view."""
    import numpy as np
    from topsy_tpu_torch.ops import splat
    *_, visible = splat.project(store.pos_smooth,
                                sph._matrix().astype(np.float32),
                                RESOLUTION, np.float32(sph.scale))
    return int(visible.sum().item())


def mesh_against_export(vis, tag):
    """The completed interactive image of the mesh renderer's view against
    its EXPORT image of the view, at phase I's bounds: the mass scale
    within 1e-6 of 1, correlation > 0.9999, the density sums within 1e-4
    once each side's dropped splats are counted (as shares of the
    visible splats: every particle has the same mass)."""
    import numpy as np
    from topsy_tpu_torch.visualizer import DrawReason
    sph = vis._sph
    ms = sph.last_render_mass_scale
    d_i = sph.last_dropped_splats
    im_i = sph.get_output_image()[..., 0].double().cpu().numpy()
    sph.invalidate()
    sph.render(DrawReason.EXPORT)
    d_e = sph.last_dropped_splats
    im_e = sph.get_output_image()[..., 0].double().cpu().numpy()
    visible = visible_count(vis.store, sph)
    rel = im_i.sum() / im_e.sum() - 1.0
    counted = (d_e - d_i) / max(visible - d_e, 1)
    corr = float(np.corrcoef(im_i.ravel(), im_e.ravel())[0, 1])
    log(f"phase {tag}: completed view against the mesh EXPORT: mass scale "
        f"{ms!r}, density sum rel diff {rel:.6e} (dropped: interactive "
        f"{d_i}, EXPORT {d_e}, of {visible} visible), corr {corr:.7f}")
    check(abs(ms - 1.0) <= 1e-6, f"{tag}: mass scale {ms}")
    check(corr > 0.9999, f"{tag}: correlation {corr} <= 0.9999")
    check(abs(rel - counted) <= 1e-4, f"{tag}: density sum rel diff {rel}")


def surfaces_agree(tag, a, b):
    """Two (value, depth) surface images: coverage flips <= 1e-4 of the
    covered pixels, depths within rtol 1e-5 / atol 1e-4 and values equal
    (rtol 1e-5, atol 1e-6) on >= 99.9% of the pixels both cover."""
    import numpy as np
    cov_a, cov_b = a[..., 1] > 0, b[..., 1] > 0
    flips = int((cov_a != cov_b).sum())
    both = cov_a & cov_b
    d_ok = np.isclose(a[..., 1][both], b[..., 1][both], rtol=1e-5, atol=1e-4)
    v_ok = np.isclose(a[..., 0][both], b[..., 0][both], rtol=1e-5, atol=1e-6)
    log(f"phase {tag}: covered {int(cov_b.sum())} px, coverage flips "
        f"{flips}, depths within rtol 1e-5 on {d_ok.mean():.6f}, values "
        f"equal on {v_ok.mean():.6f} of both-covered pixels")
    check(cov_b.sum() > 0, f"{tag}: nothing covered")
    check(flips <= 1e-4 * cov_b.sum(), f"{tag}: coverage flips {flips}")
    check(d_ok.mean() >= 0.999, f"{tag}: depths agree on {d_ok.mean()}")
    check(v_ok.mean() >= 0.999, f"{tag}: values agree on {v_ok.mean()}")


def giant_layer_truth(tag, ssph, store):
    """The surface giant layer of the renderer's last frame alone against
    an independent float64 evaluation: every particle the windowed deposit
    excluded (visible, above the density cut, in a bucket at or above the
    giant plan's threshold and wider than ``GIANT_H`` level pixels), each a
    full-support hemisphere ``z01 + sqrt(4 - q^2) h_clip / 2`` on its
    true pixel smoothing, the front-most kept.  Coverage flips <= 1e-4,
    depths within rtol 1e-5 / atol 1e-4, values equal on >= 99.9%.
    Returns (giants, pixels the layer covers, pixels it wins in the
    frame)."""
    import numpy as np
    import torch
    from topsy_tpu_torch.ops import morton_device, splat
    from topsy_tpu_torch.ops.splat_giant import GIANT_H
    layer = ssph._surface_giant_layer
    check(layer is not None, f"{tag}: the frame drew no giant layer")
    matrix = ssph._matrix().astype(np.float32)
    scale = np.float32(ssph.scale)
    ps = store.pos_smooth
    vals = store.values_for(ssph._buffer_name)
    cx, cy, z01, h_px, visible = splat.project(ps, matrix, RESOLUTION, scale)
    nl = splat.default_pyramid(RESOLUTION).num_levels
    buckets = morton_device.smoothing_buckets(ps[:, 3])
    lev = splat.levels_from_buckets(buckets, RESOLUTION / (2.0 * scale), nl)
    h_l = h_px * splat.exp2_int(-lev)
    h = ps[:, 3].double()
    # the density in float32, as the deposit and the layer compute it (the
    # lowest cut is the snapshot's least density, so the sparsest particle
    # passes or fails it by float32 rounding)
    hw = torch.clamp(ps[:, 3], min=1e-30)
    rho = vals[:, 0] / (hw * hw * hw)
    cut = ssph._density_cut_value()
    giant = (visible & (rho > cut) & (h_l > GIANT_H)
             & (buckets >= int(ssph._giant_bucket)))
    idx = torch.nonzero(giant).flatten()
    grid = torch.arange(RESOLUTION, dtype=torch.float64, device=ps.device)
    depth = torch.full((RESOLUTION, RESOLUTION), -torch.inf,
                       dtype=torch.float64, device=ps.device)
    value = torch.zeros_like(depth)
    hch = h / float(scale) * 0.5
    for s in range(0, idx.numel(), 64):
        i = idx[s:s + 64]
        inv = 1.0 / h_px[i].double()
        q2 = (((grid[None, :] - cy[i, None].double()) * inv[:, None]) ** 2
              )[:, :, None] + (((grid[None, :] - cx[i, None].double())
                                * inv[:, None]) ** 2)[:, None, :]
        d = torch.where(q2 < 4.0, z01[i, None, None].double()
                        + torch.sqrt(torch.clamp(4.0 - q2, min=0.0))
                        * hch[i, None, None], -torch.inf)
        best, win = d.max(dim=0)
        take = best > depth
        value = torch.where(take, vals[:, 1].double()[i][win], value)
        depth = torch.where(take, best, depth)
    depth = torch.clamp(depth, min=0.0)
    value = torch.where(depth > 0, value, 0.0)
    truth = torch.stack([value, depth], dim=-1).cpu().numpy()
    got = layer.double().cpu().numpy()
    surfaces_agree(f"{tag} giant layer alone against its float64 evaluation",
                   got, truth)
    frame = ssph.get_output_image()[..., 1].cpu().numpy()
    covers = int((got[..., 1] > 0).sum())
    wins = int(((got[..., 1] == frame) & (frame > 0)).sum())
    log(f"phase {tag}: {idx.numel()} giants; the layer covers {covers} px "
        f"and is front-most on {wins} px of the frame's "
        f"{int((frame > 0).sum())} covered")
    return idx.numel(), covers, wins


def zoom_out_scale(store, start, stop, step=5.0):
    """The smallest scale in [start, stop) whose giant plan takes
    candidates: the view closest to the scene's in which the surface
    giant layer runs (so the windowed deposit keeps part of the image)."""
    import numpy as np
    from topsy_tpu_torch.ops import splat
    from topsy_tpu_torch.ops.splat_giant import giant_plan
    nl = splat.default_pyramid(RESOLUTION).num_levels
    for zs in np.arange(start, stop, step):
        size, _ = giant_plan(store.giant_meta(), RESOLUTION, float(zs), nl)
        if size > 0:
            return float(zs), size
    fail(f"no scale in [{start}, {stop}) plans a giant layer")


def set_view(sph_or_vis, view):
    rotation, offset, scale = view
    sph_or_vis.rotation_matrix = rotation
    sph_or_vis.position_offset = offset
    sph_or_vis.scale = scale


def phase_mesh(vis, export_image, truth_density, view):
    """Phase G, the particle mesh at the scene's full size: one shard per
    card, or two shards on one card.  G1 the mesh Visualizer's lazy first
    EXPORT (the strided sorted path, shard 0's K2 calls held) and its
    presorted EXPORT frames (the slabs and their mip tiers; shard 0's K1
    and K2 calls held; the combine and each shard's launch timed alone;
    one frame traced)
    against the single device's EXPORT and the scatter truth; G2
    interactive views to completion against the mesh's EXPORT; G3 RGB and
    the depth pick; G4 the surface (shard 0's K3 calls held bit-identical)
    at the default cut and zoomed out with its giant layer checked alone;
    G5 periodic tiling; G6 two processes over unequal rows through
    ``parallel/multiprocess.py``.  Returns (launches per path, K1 error,
    K2 error, the kernels-line entries of K2's mesh paths, summary); fails
    if the mesh took either of the reference's logged degradations."""
    with logged_warnings("topsy_tpu_torch.parallel.render_step",
                         "topsy_tpu_torch.render.distributed") as degraded:
        out = _phase_mesh(vis, export_image, truth_density, view)
    # the reference's two logged degradations: a splatter without rows to
    # presort (the block path instead), a surface without the column path
    # (one device instead)
    check(not degraded, f"the mesh phase degraded: {degraded}")
    return out


def _phase_mesh(vis, export_image, truth_density, view):
    import numpy as np
    import torch
    from topsy_tpu_torch import config
    from topsy_tpu_torch.ops import morton, splat_atlas
    from topsy_tpu_torch.parallel import (DistributedSplatter, make_mesh,
                                          multiprocess, render_step)
    from topsy_tpu_torch.render import distributed
    from topsy_tpu_torch.render.periodic import PeriodicSPHRenderer
    from topsy_tpu_torch.visualizer import (DrawReason, OffscreenCanvas,
                                            Visualizer)
    t_all = time.perf_counter()
    mesh, distinct = card_mesh()
    D = mesh.n_devices
    log(f"phase G: mesh of {D} shards on {[str(d) for d in mesh.devices]}"
        + ("" if distinct else "; this machine has one card, so the branch "
           "with one shard per card (peer copies between cards, each "
           "shard's launches under a second card's device guard, NCCL "
           "between processes) did not run"))
    loader, store = vis.data_loader, vis.store
    launches, summary = {}, {"shards": [str(d) for d in mesh.devices],
                             "one_shard_per_card": distinct}
    feed_err = accum_err = 0.0

    # ---- G1: the mesh Visualizer; its lazy first EXPORT, then presorted
    t0 = time.perf_counter()
    mvis = Visualizer(data_loader_class=lambda: loader,
                      render_resolution=RESOLUTION,
                      canvas_class=OffscreenCanvas,
                      device=mesh.first_device, mesh=mesh)
    mvis.show_status = mvis.show_colorbar = mvis.show_scalebar = False
    msph = mvis._sph
    check(isinstance(msph, distributed.DistributedSPHRenderer),
          "the mesh Visualizer's renderer is not the mesh's")
    check(not msph._splatter.has_presorted()
          and mvis.store.presorted_layout is None,
          "the mesh Visualizer's first EXPORT built a presort")
    mvis.quantity_name = "test-quantity"
    set_view(mvis, view)
    log(f"phase G1: mesh Visualizer built (its first EXPORT the strided "
        f"sorted path) in {time.perf_counter() - t0:.2f} s")
    lazy = distributed.DistributedSPHRenderer(
        mvis.store, loader.get_render_progression(), RESOLUTION, mesh)
    set_view(lazy, view)
    reset_counts()
    with recording_shards(len(mesh.devices)) as rec:
        lazy_ms, lazy_wall, _ = cuda_ms(
            lambda: lazy.render(DrawReason.EXPORT))
    launches["mesh_sorted_export"] = read_counts(
        "mesh sorted EXPORT", ("accumulate_groups",))
    check(not lazy._splatter.has_presorted(), "the lazy EXPORT built slabs")
    lazy_img = lazy.get_image()
    log(f"phase G1 lazy first EXPORT (the strided sorted path over {D} "
        f"shards, pieces of MAX_BUCKET rows per shard): {lazy_ms:.3f} ms "
        f"(CUDA events; {lazy_wall:.3f} ms wall); launches "
        f"{launches['mesh_sorted_export']}")
    images_agree("G1 lazy EXPORT against the single device's EXPORT",
                 lazy_img, export_image, 1e-3, 0.9999)
    images_agree("G1 lazy EXPORT against splat_scatter", lazy_img,
                 truth_density[..., None], 1e-2, 0.999)
    sorted_entry, sorted_shapes = hold_k2_calls(
        "G1 sorted shard 0", [c for s, c in rec["K2"] if s == 0],
        launches["mesh_sorted_export"]["accumulate_groups"])
    accum_err = max(accum_err, sorted_entry["max_abs_err"])
    summary.update(lazy_export_ms=lazy_ms, sorted_shapes=sorted_shapes)
    del lazy, lazy_img, rec

    # the slabs of the Visualizer's splatter were built by the quantity
    # switch's autorange (its second EXPORT); a fresh splatter times them
    fresh = DistributedSplatter(mesh, store.pos_smooth,
                                store.values_for(msph._buffer_name),
                                RESOLUTION)
    slab_ms, slab_wall, _ = cuda_ms(fresh.ensure_presorted)
    del fresh
    splatter = msph._get_splatter()
    check(splatter.has_presorted(), "the mesh's second EXPORT built no slabs")
    layout = splatter.presorted_layout
    G = layout.pad_group
    w = morton.min_slice_width(layout)
    floor = int(layout.real_per_column[:min(w, G)].sum())
    target = config.COLUMN_MIP_FLOOR_TARGET * D
    mips = splatter.presorted_mip_layouts()
    log(f"phase G1 slabs: presort, {len(mips)} mip tier(s) and slabs in "
        f"{slab_ms:.3f} ms (CUDA events; {slab_wall:.3f} ms wall); n_out {layout.n_out}, {layout.n_out // D} "
        f"slots ({layout.n_out // D // G} groups) per shard; main layout's "
        f"first {w} columns hold {floor} particles against the mip floor "
        f"{target} (COLUMN_MIP_FLOOR_TARGET x {D}): "
        + (f"tiers of {[int(m.real_per_column.sum()) for m in mips]} real "
           "particles formed" if mips else "no tier formed"))
    for k, (dev, slab) in enumerate(zip(mesh.devices,
                                        splatter._presorted["slabs"])):
        log(f"phase G1 shard {k} on {dev}: {slab.fields[0].shape[0]} groups "
            f"of {G}, {int((slab.values_cm[0] > 0).sum().item())} particles")
    summary.update(slabs_ms=slab_ms, tiers=[int(m.real_per_column.sum())
                                          for m in mips],
                   mip_floor=[floor, target])
    reset_counts()
    frame_ms, wall_ms = export_frame_ms(msph)
    launches["mesh_export"] = read_counts(
        "mesh EXPORT", ("splat_feed", "accumulate_groups"))
    med = statistics.median(frame_ms)
    img = msph.get_image()
    log(f"phase G1 mesh EXPORT: {FRAMES} frames, median {med:.3f} ms/frame "
        f"(CUDA events; host wall median {statistics.median(wall_ms):.3f} "
        f"ms), {N_PARTICLES / (med / 1e3):.6e} splats/s, dropped "
        f"{msph.last_dropped_splats}, frames ms "
        f"{[round(t, 3) for t in frame_ms]}; launches "
        f"{launches['mesh_export']}")
    images_agree("G1 mesh EXPORT against the single device's EXPORT", img,
                 export_image, 1e-3, 0.9999)
    images_agree("G1 mesh EXPORT against splat_scatter", img,
                 truth_density[..., None], 1e-2, 0.999)
    with recording_shards(len(mesh.devices)) as rec:
        msph.invalidate()
        msph.render(DrawReason.EXPORT)
    k1 = [(a, k) for s, a, k in rec["K1"] if s == 0]
    k2 = [c for s, c in rec["K2"] if s == 0]
    check(k1 and k2, "shard 0 made no K1 or K2 call in the EXPORT frame")
    err, k1_t = hold_k1_calls("G1 presorted shard 0", k1)
    feed_err = max(feed_err, err)
    export_entry, _ = hold_k2_calls("G1 presorted shard 0", k2,
                                    launches["mesh_export"]
                                    ["accumulate_groups"])
    accum_err = max(accum_err, export_entry["max_abs_err"])
    matrix = msph._matrix().astype(np.float32)
    scale = np.float32(msph.scale)
    # every shard's launch alone, on its own device (the slabs are
    # contiguous runs of the (bucket, Morton) order, so their costs differ)
    shard_ms = []
    for dev, slab in zip(mesh.devices, splatter._presorted["slabs"]):
        with render_step.device_guard(dev):
            shard_ms.append(timed_ms(
                lambda slab=slab: splat_atlas.splat_atlas_fields(
                    slab.fields, slab.values_cm, matrix, RESOLUTION, scale,
                    slab.group_buckets, giants=msph._giant_bucket), 5))
    part = msph.get_output_image()
    partials = [(part.clone(), torch.zeros((), dtype=torch.int64,
                                           device=part.device))
                for _ in mesh.devices]
    combine_ms = timed_ms(lambda: render_step.combine(partials, mesh), 20)
    log(f"phase G1: each shard's presorted launch alone (splat_atlas_fields "
        f"over its slab's groups) {[round(t, 3) for t in shard_ms]} ms; the "
        f"combine of {D} partial framebuffers alone {combine_ms:.4f} ms "
        f"(CUDA events)")
    summary.update(export_ms=frame_ms, shard_launch_ms=shard_ms,
                   combine_ms=combine_ms, k1_shard0=k1_t,
                   k2_shard0_ms=export_entry["ms"])
    summary["export_trace"] = trace_frame(
        lambda: (msph.invalidate(), msph.render(DrawReason.EXPORT)),
        os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                     f"mesh_export_{D}.trace.json"))
    del rec, partials, part

    # ---- G2: interactive views over the mesh
    t0 = time.perf_counter()
    set_view(mvis, view)
    counts, change_ms, n_frames, tiers_seen = {}, [], [], []
    for v in range(2 + FRAMES):
        mvis.rotate(0.0, 0.05)
        reset_counts()
        frames = drive_view(mvis)
        for k, c in read_counts("mesh interactive", ("splat_feed",
                                                    "accumulate_groups")
                                ).items():
            counts[k] = counts.get(k, 0) + (c if v >= 2 else 0)
        log(f"phase G2 view {v}{' (warm-up)' if v < 2 else ''}: frames "
            f"{FRAME_FIELDS} {show_frames(frames)}")
        if v >= 2:
            change_ms.append(frames[0][0])
            n_frames.append(len(frames))
            tiers_seen.append([f[4] for f in frames])
            mesh_against_export(mvis, f"G2 view {v}")
    launches["mesh_interactive"] = counts
    log(f"phase G2: {FRAMES} views, first frame median "
        f"{statistics.median(change_ms):.3f} ms by the frame clock (frames "
        f"{[round(t, 3) for t in change_ms]}); frames to completion "
        f"{n_frames}; tiers {tiers_seen}; launches {counts}; "
        f"{time.perf_counter() - t0:.1f} s")
    summary.update(change_ms=change_ms, frames=n_frames, view_tiers=tiers_seen)

    # ---- G3: RGB and the depth pick against the single device
    vis.render_mode = "rgb"
    set_view(vis, view)
    vis._sph.render(DrawReason.EXPORT)
    rgb1 = vis._sph.get_image()
    mvis.render_mode = "rgb"
    set_view(mvis, view)
    check(isinstance(mvis._sph, distributed.DistributedRGBSPHRenderer),
          "not the mesh's RGB renderer")
    mvis._sph.render(DrawReason.EXPORT)        # builds its slabs
    reset_counts()
    rgb_ms, _, _ = cuda_ms(lambda: mvis._sph.render(DrawReason.EXPORT))
    launches["mesh_rgb_export"] = read_counts(
        "mesh RGB EXPORT", ("splat_feed", "accumulate_groups"))
    rgb8 = mvis._sph.get_image()
    for c in range(3):
        images_agree(f"G3 mesh RGB band {c} against the single device",
                     rgb8[..., c:c + 1], rgb1[..., c:c + 1], 1e-3, 0.9999)
    mvis.render_mode = "univariate"
    vis.render_mode = "univariate"
    for v in (vis, mvis):
        v.quantity_name = "test-quantity"
        set_view(v, view)
        # the mesh depth renderer's first EXPORT is the lazy block path,
        # its second the presorted slabs (the single device's store has
        # its presort already)
        v.get_depth_image(DrawReason.EXPORT)
        v.get_depth_image(DrawReason.EXPORT)
    dr1 = vis._sph._depth_renderer.get_image()
    dr8 = mvis._sph._depth_renderer.get_image()
    for c in (0, 2):
        images_agree(f"G3 mesh depth renderer channel {c} (EXPORT) against "
                     "the single device", dr8[..., c:c + 1], dr1[..., c:c + 1],
                     1e-3, 0.9999)
    mvis.get_depth_image()     # the depth renderer's first frame
    reset_counts()
    pick_ms, _, pick = cuda_ms(lambda: mvis.get_depth_image())
    launches["mesh_pick"] = read_counts("mesh pick", ("splat_feed",
                                                      "accumulate_groups"))
    c = RESOLUTION // 2
    check(np.isfinite(pick[c - 8:c + 8, c - 8:c + 8]).all(),
          "the mesh pick has no depth at the centre")
    log(f"phase G3: mesh RGB EXPORT {rgb_ms:.3f} ms; the pick (a CHANGE "
        f"frame of the mesh's depth renderer, tier "
        f"{mvis._sph._depth_renderer.render_progression.last_block_tier}) "
        f"{pick_ms:.3f} ms; launches RGB {launches['mesh_rgb_export']}, "
        f"pick {launches['mesh_pick']}")
    summary.update(rgb_ms=rgb_ms, pick_ms=pick_ms)
    del rgb1, rgb8, dr1, dr8

    # ---- G4: the surface at the default cut, then zoomed out
    vis.render_mode = "surface"
    mvis.render_mode = "surface"
    ssph1, ssph8 = vis._sph, mvis._sph
    check(isinstance(ssph8, distributed.DistributedSurfaceSPHRenderer),
          "not the mesh's surface renderer")
    k3_held, k3_t = 0, None
    for tag, zoom in (("cut50", None), ("cut0 zoomed out", True)):
        pct = 50.0 if zoom is None else 0.0
        if zoom:
            zs, size = zoom_out_scale(store, view[2] + 5.0, 800.0)
            sview = (view[0], view[1], zs)
        else:
            sview = view
        for s in (ssph1, ssph8):
            set_view(s, sview)
            s.set_density_cut_percentile(pct)
            s.invalidate()
            s.render(DrawReason.EXPORT)
        reset_counts()
        with recording_shards(len(mesh.devices)) as rec:
            ssph8.render(DrawReason.EXPORT)
        launches[f"mesh_surface_export_{tag.split()[0]}"] = read_counts(
            f"mesh surface EXPORT {tag}", ("accumulate_max_groups",
                                           "zdeposit_plan"))
        n, t = hold_k3_calls(f"G4 {tag} shard 0",
                             [(k, kw) for s, k, kw in rec["K3"] if s == 0])
        check(n > 0, f"G4 {tag}: shard 0 made no K3 call")
        k3_held += n
        k3_t = k3_t or t
        del rec
        # unrecorded frames, both renderers (the recording clones keys)
        s_ms = statistics.median(export_frame_ms(ssph8)[0])
        s1_ms = statistics.median(export_frame_ms(ssph1)[0])
        s1 = ssph1.get_image()
        s8 = ssph8.get_image()
        log(f"phase G4 {tag}: scale {sview[2]}, mesh surface EXPORT median "
            f"{s_ms:.3f} ms against one device's {s1_ms:.3f} ms (CUDA "
            f"events, {FRAMES} frames each), dropped "
            f"{ssph8.last_dropped_splats}; launches per frame "
            f"{launches[f'mesh_surface_export_{tag.split()[0]}']}")
        surfaces_agree(f"G4 {tag} mesh surface against the single device",
                       s8, s1)
        if zoom:
            g, covers, wins = giant_layer_truth(f"G4 {tag} mesh", ssph8,
                                                store)
            summary.update(surface_zoom_scale=zs, surface_giants=g,
                           surface_giant_px=[covers, wins])
        summary[f"surface_{tag.split()[0]}_ms"] = [s_ms, s1_ms]
    summary.update(k3_calls_held=k3_held, k3_shard0=k3_t)

    # ---- G5: periodic tiling over the mesh
    p1 = PeriodicSPHRenderer(store, loader.get_render_progression(),
                             RESOLUTION, PERIODICITY)
    p8 = distributed.DistributedPeriodicSPHRenderer(
        mvis.store, loader.get_render_progression(), RESOLUTION, mesh,
        PERIODICITY)
    for p in (p1, p8):
        set_view(p, view)
        p.render(DrawReason.EXPORT)
    p8.render(DrawReason.EXPORT)   # the lazy block path first, then slabs
    reset_counts()
    per_ms, _, _ = cuda_ms(lambda: p8.render(DrawReason.EXPORT))
    launches["mesh_periodic_export"] = read_counts(
        "mesh periodic EXPORT", ("splat_feed", "accumulate_groups"))
    p1.render(DrawReason.EXPORT)
    images_agree("G5 mesh periodic EXPORT against the single device",
                 p8.get_output_image().cpu().numpy(),
                 p1.get_output_image().cpu().numpy(), 1e-3, 0.9999)
    log(f"phase G5: mesh periodic EXPORT {per_ms:.3f} ms; launches "
        f"{launches['mesh_periodic_export']}")
    summary["periodic_ms"] = per_ms
    del p1, p8, mvis, msph, splatter, ssph8
    torch.cuda.empty_cache()

    # ---- G6: two processes over unequal rows
    t0 = time.perf_counter()
    n_mp, share = 1 << 22, 0.25
    out = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "mesh_mp.npz")
    got = multiprocess.launch(n_mp, 2, out, device="cuda", share=share,
                              resolution=RESOLUTION, scale=float(view[2]),
                              timeout=300)
    mp_s = time.perf_counter() - t0
    workers = [json.loads(line) for so in got["stdout"]
               for line in so.splitlines() if line.startswith("{")]
    natural, negotiated = got["natural"], got["negotiated"]
    log(f"phase G6: 2 processes, backend {got['backend']}, over {n_mp} rows "
        f"split {share} / {1 - share}: natural slab lengths "
        f"{natural.tolist()}, negotiated {negotiated.tolist()}; both exited "
        f"0 in {mp_s:.1f} s wall; workers {workers}")
    check(natural[0] != natural[1], "the unequal split gave equal slabs")
    check((negotiated == natural.max()).all(), "the negotiated length is "
          "not the largest natural one")
    ps_mp, vals_mp = multiprocess.scene(n_mp)
    _, (g_ps, g_vals), _ = multiprocess.split_rows(ps_mp, vals_mp, 2, share)
    one = DistributedSplatter(make_mesh(2, devices=["cuda:0"] * 2), g_ps,
                              g_vals, RESOLUTION)
    from topsy_tpu_torch import camera
    mp_matrix = camera.world_to_clip_matrix(np.eye(3), np.zeros(3),
                                            float(view[2]))
    images_agree("G6 block path against one process",
                 got["block"], one.render(mp_matrix, view[2]).cpu().numpy(),
                 1e-3, 0.9999)
    want, _ = one.render_presorted(mp_matrix, view[2])
    want = want.cpu().numpy()
    images_agree("G6 presorted EXPORT against one process", got["pre"],
                 want, 1e-3, 0.9999)
    images_agree("G6 full-width column launch against one process",
                 got["col"], want, 1e-3, 0.9999)
    launches["mesh_process_local"] = next(
        (wk["launches"] for wk in workers if wk.get("rank") == 0
         and "launches" in wk), {})
    check(launches["mesh_process_local"].get("accumulate_groups", 0) > 0,
          "the workers launched no K2")
    summary.update(process_local_s=mp_s, natural=natural.tolist(),
                   negotiated=negotiated.tolist(),
                   backend=str(got["backend"]))
    del one, got
    g_s = time.perf_counter() - t_all
    log(f"phase G: {g_s:.1f} s")
    summary["seconds"] = g_s
    entries = {"mesh_sorted": sorted_entry, "mesh_export": export_entry}
    return launches, feed_err, accum_err, entries, summary


# ---------------------------------------------------------------------------
# phase H: the host shell around the image
# ---------------------------------------------------------------------------

STATUS_TEXT = r"^\$\d+\$ fps( /\d+\.\d+ds)?( /\d+\.\d+gf)?$"
REPLAY_FPS = 30


def trace_summary(prof, tag: str) -> dict:
    """From a ``torch.profiler`` trace holding one ``record_function(tag)``
    range: its span (from the range's start on the host to the end of the
    later of the range and the card's last activity), the card's busy time
    (the union of its kernels, copies and fills), the idle share of the
    span, the kernels run on the card and the host's kernel launch calls,
    in ms."""
    import torch
    events = prof.events()
    host = [e for e in events if e.name == tag
            and e.device_type == torch.autograd.DeviceType.CPU]
    check(len(host) == 1, f"the trace holds {len(host)} ranges {tag!r}")
    t0, t1 = host[0].time_range.start, host[0].time_range.end
    device = sorted((e.time_range.start, e.time_range.end, e.name)
                    for e in events
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and e.name != tag)
    check(device, f"the trace of {tag} shows no device time")
    busy, end = 0.0, float("-inf")
    for a, b, _ in device:
        if b > end:
            busy += b - max(a, end)
            end = b
    span = max(t1, end) - t0
    kernels = [n for _, _, n in device
               if not n.startswith(("Memcpy", "Memset"))]
    launches = sum(1 for e in events if "LaunchKernel" in e.name
                   and t0 <= e.time_range.start <= t1)
    return {"span_ms": span / 1e3, "host_ms": (t1 - t0) / 1e3,
            "busy_ms": busy / 1e3, "idle_share": 1.0 - busy / span,
            "kernels": len(kernels), "copies_and_fills":
            len(device) - len(kernels), "launch_calls": launches,
            "first_device_ms": (device[0][0] - t0) / 1e3}


def phase_host_shell(vis, dev):
    """Phase H, the host shell on the scene's Visualizer (univariate,
    ``test-quantity``, 2^24 at 1024^2): H1 ``save`` to ``.npy`` (equal to
    ``get_sph_image()`` bit for bit), ``.tif`` (float16 RGB read back
    through ``hdr_tiff``, equal to the presentation of the same frame) and
    a figure (written where matplotlib imports, else its ImportError);
    H2 the recorder: a scripted session with explicit timestamps (a
    rotation, a zoom, a vmin/vmax change, 1 s) replayed through
    ``_replay`` at 1024^2, each frame timed by CUDA events, the first
    against a direct EXPORT at the recorded starting view, ``save_mp4``
    where cv2 imports, the timestream through a pickle; H3 two
    synchronised Visualizers over ``TestDataDeviceLoader(2**22)``; H4 one
    EXPORT frame traced by ``performance.trace``; H5 the command line
    ``topsy_tpu_torch test://16777216 -r 1024`` in process; H6 one CHANGE
    frame with the status line.  Returns (launches per path, summary)."""
    import pickle
    import re
    import types

    import numpy as np
    import torch

    import topsy_tpu_torch
    from topsy_tpu_torch import hdr_tiff, performance
    from topsy_tpu_torch import recorder as recorder_module
    from topsy_tpu_torch import visualizer as visualizer_module
    from topsy_tpu_torch.loaders import TestDataDeviceLoader
    from topsy_tpu_torch.visualizer import (DrawReason, OffscreenCanvas,
                                            Visualizer)
    t_all = time.perf_counter()
    out_dir = os.path.join("build", "host_shell")
    os.makedirs(out_dir, exist_ok=True)
    launches, summary = {}, {}
    text = visualizer_module.text_overlays_available()
    log(f"phase H: matplotlib {'imports' if text else 'is absent'}; cv2 "
        f"{'imports' if _imports('cv2') else 'is absent'}")
    vis.show_status = vis.show_colorbar = vis.show_scalebar = False

    # ---- H1: save, one EXPORT frame per format -----------------------------
    reset_counts()
    save_ms = {}
    for ext in ("npy", "tif", "png"):
        path = os.path.join(out_dir, f"scene.{ext}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            vis.save(path)
        except ImportError as e:
            check(ext == "png" and not text, f"H1 save .{ext}: {e}")
            check(".npy" in str(e) and ".tif" in str(e), f"H1: the figure "
                  f"branch's ImportError names no other format: {e}")
            log(f"phase H1: save .{ext}: matplotlib is absent, the figure "
                f"branch raised ImportError: {e}")
            continue
        save_ms[ext] = (time.perf_counter() - t0) * 1e3
        if ext == "npy":
            saved = np.load(path)
            check(np.array_equal(saved, vis.get_sph_image()), "H1: the .npy "
                  "is not get_sph_image() bit for bit")
        elif ext == "tif":
            saved = hdr_tiff.imread(path)
            pres = vis._sph_presentation_image()[..., :3].astype(np.float16)
            check(saved.dtype == np.float16
                  and saved.shape == (RESOLUTION, RESOLUTION, 3)
                  and np.array_equal(saved, pres), f"H1: the .tif "
                  f"({saved.dtype}, {saved.shape}) is not the presentation's "
                  "float16 RGB")
        else:
            check(os.path.getsize(path) > 1000, "H1: the figure is empty")
        log(f"phase H1: save .{ext} {save_ms[ext]:.3f} ms (host wall, one "
            f"EXPORT frame, readback and write), {os.path.getsize(path)} "
            "bytes, held")
    launches["save"] = read_counts("save", ("splat_feed",
                                            "accumulate_groups"))
    summary["save_ms"] = save_ms

    # ---- H2: the recorder ----------------------------------------------------
    clock = [0.0]
    real_time = recorder_module.time
    recorder_module.time = types.SimpleNamespace(time=lambda: clock[0])
    try:
        rec = recorder_module.VisualizationRecorder(vis)
        rec.record()
        clock[0] = 0.3
        vis.rotate(0.3, 0.1)
        vis.draw(DrawReason.CHANGE)
        clock[0] = 0.6
        vis.scale = vis.scale * 0.6
        vis.draw(DrawReason.CHANGE)
        clock[0] = 0.8
        vmin, vmax = (vis.colormap.get_parameter(k) for k in ("vmin", "vmax"))
        vis.colormap.update_parameters({"vmin": vmin + 0.2 * (vmax - vmin)})
        vis.draw(DrawReason.CHANGE)
        clock[0] = 1.0
        rec.stop()
    finally:
        recorder_module.time = real_time
    start = {k: rec._streams[k][0][1]
             for k in ("rotation_matrix", "scale", "position_offset")}
    reset_counts()
    frames_ms, wall_ms = [], []
    first_raw = None
    replay = rec._replay(fps=REPLAY_FPS, resolution=(RESOLUTION, RESOLUTION),
                         smooth=False, show_colorbar=False,
                         show_scalebar=False)
    while True:
        ms, wall, frame = cuda_ms(lambda: next(replay, None))
        if frame is None:
            break
        check(frame.shape == (RESOLUTION, RESOLUTION, 3)
              and frame.dtype == np.uint8, f"H2: replayed frame "
              f"{frame.shape} {frame.dtype}")
        if first_raw is None:
            first_raw = vis._sph.get_image()
        frames_ms.append(ms)
        wall_ms.append(wall)
    launches["recorder_replay"] = read_counts(
        "recorder replay", ("splat_feed", "accumulate_groups"))
    n = len(frames_ms)
    check(n == REPLAY_FPS, f"H2: {n} frames replayed, not {REPLAY_FPS}")
    set_view(vis, (start["rotation_matrix"], start["position_offset"],
                   start["scale"]))
    vis._sph.render(DrawReason.EXPORT)
    images_agree("H2 first replayed frame against a direct EXPORT at the "
                 "recorded starting view", first_raw, vis._sph.get_image(),
                 1e-3, 0.9999)
    p90 = float(np.percentile(frames_ms, 90))
    per_frame = {k: v / n for k, v in launches["recorder_replay"].items()}
    log(f"phase H2: replayed {n} EXPORT frames at {RESOLUTION}^2: median "
        f"{statistics.median(frames_ms):.3f} ms, p90 {p90:.3f} ms (CUDA "
        f"events around each frame: render, colormap, readback, compose; "
        f"host wall median {statistics.median(wall_ms):.3f} ms); launches "
        f"per frame {per_frame}; frames ms {[round(t, 3) for t in frames_ms]}")
    mp4_ms = None
    if _imports("cv2"):
        path = os.path.join(out_dir, "session.mp4")
        t0 = time.perf_counter()
        rec.save_mp4(path, fps=REPLAY_FPS, resolution=(RESOLUTION, RESOLUTION))
        mp4_ms = (time.perf_counter() - t0) * 1e3
        check(os.path.getsize(path) > 0, "H2: the mp4 is empty")
        log(f"phase H2: save_mp4 (cv2 imports): {n} smoothed frames in "
            f"{mp4_ms:.1f} ms (host wall), {os.path.getsize(path)} bytes")
    else:
        log("phase H2: cv2 is absent: save_mp4 not called")
    path = os.path.join(out_dir, "session.pkl")
    rec.save_timestream(path)
    again = recorder_module.VisualizationRecorder(vis)
    again.load_timestream(path)
    check(again._end_time == rec._end_time
          and pickle.dumps(again._streams) == pickle.dumps(rec._streams),
          "H2: the timestream did not survive its pickle")
    log(f"phase H2: the timestream ({sum(map(len, rec._streams.values()))} "
        "events) round-trips through its pickle")
    summary["replay"] = dict(frames=n, median_ms=statistics.median(frames_ms),
                             p90_ms=p90, frames_ms=frames_ms,
                             launches_per_frame=per_frame, mp4_ms=mp4_ms)
    set_view(vis, (start["rotation_matrix"], start["position_offset"],
                   start["scale"]))

    # ---- H3: the synchroniser ------------------------------------------------
    def device_vis():
        v = Visualizer(data_loader_class=TestDataDeviceLoader,
                       data_loader_args=(1 << 22,),
                       data_loader_kwargs={"seed": 1337, "device": dev},
                       render_resolution=RESOLUTION,
                       canvas_class=OffscreenCanvas, device=dev)
        v.show_status = v.show_colorbar = v.show_scalebar = False
        return v
    v1, v2 = device_vis(), device_vis()
    v1.synchronize_with(v2)
    v1.rotate(0.4, -0.2)
    v1.scale = v1.scale * 0.7
    v1.draw(DrawReason.CHANGE)
    check(v2.scale == v1.scale
          and np.array_equal(v2.rotation_matrix, v1.rotation_matrix)
          and np.array_equal(v2.position_offset, v1.position_offset),
          "H3: the second Visualizer did not follow the first")
    fresh = device_vis()
    set_view(fresh, (v1.rotation_matrix, v1.position_offset, v1.scale))
    fresh._sph.render(DrawReason.EXPORT)
    truth = fresh._sph.get_image()
    reset_counts()
    for i, v in enumerate((v1, v2)):
        v._sph.render(DrawReason.EXPORT)
        images_agree(f"H3 synchronised Visualizer {i + 1} against a fresh "
                     "render at its view", v._sph.get_image(), truth,
                     1e-3, 0.9999)
    launches["synchronised_export"] = read_counts(
        "synchronised EXPORT", ("splat_feed", "accumulate_groups"))
    v1.stop_synchronizing()
    del v1, v2, fresh, truth
    torch.cuda.empty_cache()

    # ---- H4: one single-device EXPORT frame traced ---------------------------
    vis._sph.invalidate()
    vis._sph.render(DrawReason.EXPORT)          # warm
    torch.cuda.synchronize()
    trace_dir = os.path.join(out_dir, "trace")
    reset_counts()
    with performance.trace(trace_dir) as traced:
        with torch.profiler.record_function("export_frame"):
            vis._sph.invalidate()
            vis._sph.render(DrawReason.EXPORT)
    launches["profiled_export"] = read_counts(
        "profiled EXPORT", ("splat_feed", "accumulate_groups"))
    tsum = trace_summary(traced.profiler, "export_frame")
    log(f"phase H4: one EXPORT frame under performance.trace "
        f"({performance.trace_file(trace_dir)}): span {tsum['span_ms']:.3f} "
        f"ms (host range {tsum['host_ms']:.3f} ms), card busy "
        f"{tsum['busy_ms']:.3f} ms, idle share {tsum['idle_share']:.3f}, "
        f"{tsum['kernels']} kernels and {tsum['copies_and_fills']} copies or "
        f"fills on the card, {tsum['launch_calls']} kernel launch calls on "
        f"the host, first device activity at {tsum['first_device_ms']:.3f} "
        f"ms; K1/K2 counted {launches['profiled_export']}")
    summary["trace"] = tsum

    # ---- H5: the command line, in process ------------------------------------
    opened = []
    load = topsy_tpu_torch.load

    def load_and_keep(*args, **kw):
        opened.append(load(*args, **kw))
        return opened[-1]

    argv, sys.argv = sys.argv, ["topsy_tpu_torch", f"test://{N_PARTICLES}",
                                "-r", str(RESOLUTION)]
    topsy_tpu_torch.load = load_and_keep
    package_logger = logging.getLogger("topsy_tpu_torch")
    handlers, level = list(package_logger.handlers), package_logger.level
    reset_counts()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        topsy_tpu_torch.main()
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
    finally:
        sys.argv = argv
        topsy_tpu_torch.load = load
        package_logger.handlers[:] = handlers  # the CLI's DEBUG handler off
        package_logger.setLevel(level)
    launches["cli"] = read_counts("command line", ("splat_feed",
                                                   "accumulate_groups"))
    check(len(opened) == 1 and isinstance(opened[0].canvas, OffscreenCanvas),
          "H5: the command line did not open one offscreen Visualizer")
    frame = opened[0].last_frame
    check(frame is not None and frame.shape == (480, 640, 4)
          and frame[..., :3].std() > 0, "H5: the command line presented no "
          "frame")
    log(f"phase H5: topsy_tpu_torch test://{N_PARTICLES} -r {RESOLUTION} "
        f"in process: {cli_s:.3f} s (host wall: the snapshot's generation, "
        f"the constructor's EXPORT, the offscreen canvas's draws); launches "
        f"{launches['cli']}")
    summary["cli_s"] = cli_s
    del opened, frame
    torch.cuda.empty_cache()

    # ---- H6: the status line -------------------------------------------------
    vis.show_status = True
    vis._last_status_update = 0.0
    vis.__dict__.pop("_override_status_text_until", None)
    reset_counts()
    vis.draw(DrawReason.CHANGE)
    launches["status_frame"] = read_counts("status frame", ("splat_feed",
                                                            "accumulate_groups"))
    sph = vis._sph
    check(sph.frame_clock._cuda, "H6: the frame clock is not CUDA events")
    status = vis._status.text
    check(re.match(STATUS_TEXT, status) and sph.last_render_fps > 0,
          f"H6: status {status!r}, fps {sph.last_render_fps}")
    log(f"phase H6: status line {status!r}: fps {sph.last_render_fps:.3f} "
        f"from the frame clock's CUDA events (this frame "
        f"{sph.frame_clock.seconds() * 1e3:.3f} ms); the raster "
        + ("was drawn" if text else "was not drawn (matplotlib is absent)"))
    vis.show_status = False
    summary["status"] = status
    log(f"phase H: {time.perf_counter() - t_all:.1f} s")
    return launches, summary


def _imports(name: str) -> bool:
    import importlib
    try:
        importlib.import_module(name)
    except ImportError:
        return False
    return True


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")

    import topsy_tpu_torch  # noqa: F401  (sets full-f32 matmuls)
    from topsy_tpu_torch.ops import (cuda_build, kernels, splat, splat_accum,
                                     splat_atlas, splat_feed, zsplat,
                                     zsplat_accum, zsplat_atlas)
    from topsy_tpu_torch.ops.smooth import smooth_image
    from topsy_tpu_torch.ops.splat_giant import BUCKET_DISABLED, GIANT_H
    from topsy_tpu_torch.render import surface
    from topsy_tpu_torch.visualizer import DrawReason

    # ---- phase 1: the card -------------------------------------------------
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")

    # ---- phase 2: build the kernels from this checkout ---------------------
    t0 = time.perf_counter()
    sources = ("splat_feed", "splat_accum", "zsplat_accum")
    for name in sources:
        # built from this checkout's sources, never an earlier build's
        (cuda_build.BUILD_DIR / f"lib{name}.so").unlink(missing_ok=True)
    cuda_build.build(list(sources))     # one nvcc per source, in parallel
    log(f"phase build: {time.perf_counter() - t0:.2f} s (nvcc for "
        f"{', '.join(f'csrc/{n}.cu' for n in sources)} in parallel)")
    for name, res in ptxas_resources(cuda_build.build_logs["splat_feed"]):
        log(f"ptxas K1 {name}: {res}")
    for name, res in ptxas_resources(cuda_build.build_logs["splat_accum"]):
        log(f"ptxas K2 {name}: {res}")
    for name, res in ptxas_resources(cuda_build.build_logs["zsplat_accum"]):
        log(f"ptxas K3 {name}: {res}")

    # ---- phase 3: the scene ------------------------------------------------
    t0 = time.perf_counter()
    vis = build_scene(dev)
    sph = vis._sph
    torch.cuda.synchronize()
    store = vis.store
    G = store.presorted_layout.pad_group
    ng = store.n_presorted // G
    check(ng >= splat_atlas.TIER3_PALLAS_MIN_GROUPS,
          "the scene is too small for the reference's tier-3 pass")
    pieces = sph.pieces()
    log(f"phase scene: {time.perf_counter() - t0:.2f} s; n={N_PARTICLES} "
        f"n_presorted={store.n_presorted} groups={ng} res={RESOLUTION}; "
        f"pieces {pieces}; giant bucket threshold {sph._giant_bucket}")

    # ---- phase P: the presort built on the card ----------------------------
    psummary = phase_presort(vis)

    # ---- phases 4-5: each kernel against its plain version, every piece ----
    matrix = sph._matrix().astype(np.float32)
    scale = np.float32(sph.scale)
    _, atlas_rows, atlas_cols = splat_atlas.atlas_layout(
        splat.default_pyramid(RESOLUTION))
    lrk = kernels.lowrank_kernel()
    tails = [float(splat_accum._horner(c, torch.tensor([splat_accum.SUPPORT2])))
             for c in lrk.coeffs]
    log(f"K2 profile tails p_k(t2 = {splat_accum.SUPPORT2}) in float32 "
        f"fused Horner steps: {tails} (nonzero: every entry of an active "
        "POLY rectangle is nonzero)")
    feed_err, accum_err = 0.0, 0.0
    feed_ms = feed_plain_ms = feed_bound = None
    accum_ms, accum_plain_ms, accum_bound = {}, {}, {}
    for i, piece in enumerate(pieces):
        # K1, exactly as the renderer feeds this piece
        fargs, fkw = feed_args(vis, piece)
        out_k = splat_feed.splat_feed_cuda(*fargs, **fkw)
        err = compare_feed(f"piece {piece}", out_k,
                           splat_feed.splat_feed_plain(*fargs, **fkw))
        feed_err = max(feed_err, err)
        t_ms, t_plain, _ = time_k1(f"export_piece{i}", fargs, fkw, G, 10, 3)
        if i == 0:
            feed_ms, feed_plain_ms = t_ms, t_plain
            feed_bound = k1_bound(fkw, G)
        kinds = torch.bincount((out_k[8] // 4).long(), minlength=5).tolist()
        log(f"phase K1 piece {piece}: ok; max abs diff {err:.3e}; groups by "
            f"kind [inactive, tiny, poly, mixed, masked] = {kinds}; spilled "
            f"particles {int(out_k[9].sum().item())}; {t_ms:.3f} ms (plain "
            f"{t_plain:.3f} ms; {k1_note(f'export_piece{i}')})")

        # K2 in the three call shapes that follow this feed
        calls, dropped = k2_calls(out_k, G, atlas_rows, atlas_cols)
        for shape, kw in calls.items():
            err, ref_max, active = compare_k2(f"piece {piece} {shape}", kw)
            accum_err = max(accum_err, err)
            if shape == "tier3_stragglers":
                check(active > 0 or int(out_k[9].sum().item()) == 0,
                      f"K2 piece {piece} tier3_stragglers: no active group "
                      "although particles spilled")
            timing = ""
            if i == 0:
                accum_ms[shape] = timed_ms(
                    lambda: splat_accum.accumulate_groups_cuda(**kw), 5)
                accum_plain_ms[shape] = timed_ms(
                    lambda: splat_accum.accumulate_groups_plain(**kw), 2)
                b_ms, b_by, b_detail = k2_bound(kw)
                accum_bound[shape] = (b_ms, b_by)
                timing = (f"; {accum_ms[shape]:.3f} ms (plain "
                          f"{accum_plain_ms[shape]:.3f} ms); bound "
                          f"{b_ms:.4f} ms = {b_detail}, "
                          f"{b_ms / accum_ms[shape]:.1%} of it")
            log(f"phase K2 piece {piece} {shape}: ok; groups "
                f"{kw['flags'].shape[0]} of {kw['group']} (active {active}); "
                f"max|atlas| {ref_max:.4e}, max abs diff {err:.3e}{timing}")
            hist, entries, nonzero, quads = k2_census(kw)
            log(f"phase K2 piece {piece} {shape} census: groups by "
                f"kind/class {hist}; deposited entries {entries}, nonzero "
                f"{nonzero}, float4 reductions {quads}")
            if shape in ("main", "tier2"):
                for key, lengths in anchor_runs(kw).items():
                    log(f"phase K2 piece {piece} {shape} runs sharing ({key}): "
                        f"{run_summary(lengths)}")
        log(f"piece {piece} dropped {int(dropped.item())}")
        del out_k

    # ---- phase K1o: K1 at G = 189 and on odd lanes ------------------------
    feed_err = max(feed_err, phase_feed_odd(vis))

    # ---- phase 6: the EXPORT path ------------------------------------------
    reset_counts()
    frame_ms, wall_ms = export_frame_ms(sph)
    image = vis.get_sph_image()
    pres = vis.get_sph_presentation_image()
    launches = read_counts("EXPORT", ("splat_feed", "accumulate_groups"))
    med = statistics.median(frame_ms)
    log(f"phase EXPORT: {FRAMES} frames, median {med:.3f} ms/frame "
        f"(CUDA events; host wall median {statistics.median(wall_ms):.3f} "
        f"ms), {N_PARTICLES / (med / 1e3):.6e} splats/s, "
        f"last_dropped_splats {sph.last_dropped_splats}, frames ms "
        f"{[round(t, 3) for t in frame_ms]}")
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        f" GiB; launches during the EXPORT frames {launches}")

    # ---- phase 7: the output is right --------------------------------------
    raw = sph.get_image()
    check(raw.shape == (RESOLUTION, RESOLUTION, 2), f"image shape {raw.shape}")
    check(np.isfinite(raw).all(), "image not finite")
    check(image.shape == (RESOLUTION, RESOLUTION), "SPH content shape")
    t0 = time.perf_counter()
    ps = torch.as_tensor(vis.data_loader.get_pos_smooth(), device=dev)
    vals = store.values_for(sph._buffer_name)
    truth = splat.splat_scatter(ps, vals, matrix, RESOLUTION, scale)
    truth = truth[..., 0].cpu().numpy().astype(np.float64)
    den = raw[..., 0].astype(np.float64)
    rel = abs(den.sum() / truth.sum() - 1.0)
    corr = float(np.corrcoef(den.ravel(), truth.ravel())[0, 1])
    log(f"phase truth: density sum rel diff {rel:.3e}, corr {corr:.6f} "
        f"against splat_scatter ({time.perf_counter() - t0:.1f} s)")
    check(rel <= 1e-2, f"density sum rel diff {rel} > 1e-2")
    check(corr > 0.999, f"density correlation {corr} <= 0.999")
    check(pres.shape == (RESOLUTION, RESOLUTION, 4) and pres.dtype == np.uint8,
          f"presentation image {pres.shape} {pres.dtype}")
    check(pres[..., :3].std() > 0, "presentation image is constant")

    export_image = raw
    truth_density = truth
    view = (np.array(sph.rotation_matrix), np.array(sph.position_offset),
            sph.scale)
    del ps, vals
    if "--mesh-only" in sys.argv[1:]:
        # phase G alone, over every card of the machine
        glaunches, _, _, _, gsummary = phase_mesh(vis, export_image,
                                                  truth_density, view)
        print(json.dumps({"mesh": gsummary, "launches": glaunches}),
              flush=True)
        log(f"card: {card}")
        return 0

    # ---- phase C: the EXPORT path with the Catmull-Rom pyramid collapse ---
    claunches, c_feed_err, c_accum_err, csummary = phase_catmull(
        vis, export_image, card)
    feed_err = max(feed_err, c_feed_err)
    accum_err = max(accum_err, c_accum_err)

    # ---- phase D: the device loader, bench.py's path ------------------------
    dlaunches, dsummary = phase_device_loader(dev, sph)
    torch.cuda.empty_cache()

    # ---- phases I1-I4: the interactive path on the same Visualizer ---------
    ilaunches, i_feed_err, i_accum_err, isummary = phase_interactive(vis)
    feed_err = max(feed_err, i_feed_err)
    accum_err = max(accum_err, i_accum_err)

    # ---- phases M1-M4: the other additive modes on the same Visualizer -----
    mlaunches, m_feed_err, m_accum_err, mtimes, msummary = phase_modes(vis)
    feed_err = max(feed_err, m_feed_err)
    accum_err = max(accum_err, m_accum_err)

    # ---- phases L1-L4: the block paths over the scene's loader and store ---
    lentries, llaunches, lsummary = phase_sorted(vis, export_image, view)
    accum_err = max(accum_err, *(e["max_abs_err"] for e in lentries.values()))

    # ---- phase S1: the surface mode on the same Visualizer -----------------
    t0 = time.perf_counter()
    vis.render_mode = "surface"           # renders (autorange) one frame
    torch.cuda.synchronize()
    ssph = vis._sph
    check(isinstance(ssph, surface.SurfaceSPHRenderer), "not the surface "
          "renderer")
    # the EXPORT frame renders each tier's own columns: all of the deepest
    # mip's, then each parent's above its mip's
    from topsy_tpu_torch.ops.morton import min_slice_width
    smips = store.ensure_column_mips()
    slayouts = [m.layout for m in smips] + [store.presorted_layout]
    prog = ssph._render_progression
    prog.start_frame(DrawReason.EXPORT)
    blocks = []
    while (b := prog.get_block(0.0)) is not None:
        blocks.append((b, prog.last_block_tier))
        prog.end_block(0.0)
    prog.end_frame_get_scalefactor()
    covered = sum(int(slayouts[t].real_per_column[c0:c0 + w].sum())
                  for ([c0], [w]), t in blocks)
    starts = [0] + [min_slice_width(lay) for lay in slayouts[1:]]
    check([t for _, t in blocks] == list(range(len(slayouts)))
          and [b[0][0] for b, _ in blocks] == starts
          and covered == store.n, f"the EXPORT blocks {blocks} are not each "
          f"tier's own columns from {starts}, covering {covered} particles")
    sps = store.pos_smooth_presorted
    svals = store.presorted_values_for(ssph._buffer_name)
    sbks = store.presorted_buckets
    chunks = surface.column_chunks(sps.shape[0], G)
    chunk_groups = [((c.start or 0) // G,
                     ((c.stop or sps.shape[0]) - (c.start or 0)) // G)
                    for c in chunks]
    pyr = splat.default_pyramid(RESOLUTION)
    log(f"phase S1: {time.perf_counter() - t0:.2f} s; EXPORT blocks "
        f"(block, tier) {blocks}; S2 holds K3 on the main layout's full-width"
        f" column launch, chunks {chunk_groups} (first group, groups); SI1 on"
        " the frames' own launches")

    k3_err = 0.0
    k3_ms, k3_plain_ms, k3_bound = {}, {}, {}

    def k3_compare(label, kw, keys0, timing):
        """Kernel and plain version on the whole call from the same atlas
        state; returns the kernel's keys."""
        nonlocal k3_err
        nbytes, ops, frags, hits, merges = k3_work(kw, keys0)
        k = keys0.clone()
        zsplat_accum.accumulate_max_packed_cuda(k, **kw)
        p = keys0.clone()
        torch.cuda.synchronize()
        tp = time.perf_counter()
        zsplat_accum.accumulate_max_packed_plain(p, **kw)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - tp
        a, b = zsplat_accum.unpack_atlas(k), zsplat_accum.unpack_atlas(p)
        n_diff = int((a != b).sum().item())
        err = float((a - b).abs().max().item())
        check(n_diff == 0, f"K3 {label}: {n_diff} atlas entries differ from "
              f"the plain version (max abs diff {err})")
        k3_err = max(k3_err, err)
        active = int((kw["flags"] // 4 == zsplat_accum.FLAG_ACTIVE).sum())
        # the card's work list against its plain mirror; the census
        win = kw.get("window_cols", zsplat_accum.WINDOW_COLS)
        rolled = win == zsplat_accum.WINDOW_COLS
        plan_k = zsplat_accum.deposit_plan_cuda(kw["flags"], rolled)
        plan_p = zsplat_accum.deposit_plan(kw["flags"], rolled)
        check(all(torch.equal(x, y) for x, y in zip(plan_k, plan_p)),
              f"K3 {label}: the plan kernel differs from deposit_plan")
        cen = k3_census(kw, keys0)
        check(sum(cen["by_class"]) == (active if rolled else int(
            (kw["flags"] == 4 * zsplat_accum.FLAG_ACTIVE
             + zsplat_accum.FULL_CLASS).sum())),
              f"K3 {label}: the plan lists {cen['by_class']} groups, not the "
              f"{active} active ones")
        extra = ""
        if timing:
            k_t = keys0.clone()
            k3_ms[label] = timed_from_ms(
                lambda: zsplat_accum.accumulate_max_packed_cuda(k_t, **kw),
                lambda: k_t.copy_(keys0), 5)
            k3_plain_ms[label] = plain_s * 1e3
            k3_bound[label] = bound(nbytes, ops, F32_OPS_PER_S)
            extra = (f"; {k3_ms[label]:.3f} ms (plain {plain_s * 1e3:.3f} "
                     f"ms); bound {k3_bound[label][0]:.4f} ms "
                     f"({k3_bound[label][1]}), "
                     f"{k3_bound[label][0] / k3_ms[label]:.1%} of it")
        log(f"phase S2 {label}: bit-identical; groups {kw['flags'].shape[0]}"
            f" of {kw['group']} (active {active}); fragments {frags}, hits "
            f"{hits}, bytes {nbytes}{extra}")
        log(f"phase S2 {label} census: plan (card = plain) groups by class "
            f"{cen['by_class']}; panels visited {cen['panels']}; list "
            f"entries {cen['entries']}; (pixel, particle) pairs evaluated "
            f"{cen['pairs']} ({cen['pairs'] / max(frags, 1):.3f} of the "
            f"fragments, {cen['pairs'] / max(hits, 1):.3f} of the hits) in "
            f"{cen['lane_slots']} lane slots; global atomics {merges} (hit "
            f"pixels per group)")
        return k

    def surface_truth(tag, sraw, cut, gb):
        """The surface renderer's (value, depth) image against the
        scatter-max truth over the presorted arrays at its view, cut and
        giant plan (its giant layer composited): coverage flips <= 1e-4 of
        the covered pixels, depth within rtol 1e-5 / atol 1e-4, winner
        values equal on >= 99.9%.  Returns the covered share."""
        t0 = time.perf_counter()
        check(sraw.shape == (RESOLUTION, RESOLUTION, 2),
              f"surface image shape {sraw.shape}")
        check(np.isfinite(sraw).all(), "surface image not finite")
        smatrix = ssph._matrix().astype(np.float32)
        sscale = np.float32(ssph.scale)
        lev = splat.levels_from_buckets(sbks, RESOLUTION / (2.0 * sscale),
                                        pyr.num_levels)
        gmask = None
        if gb != BUCKET_DISABLED:
            _, _, _, h_px, _ = splat.project(sps, smatrix, RESOLUTION, sscale)
            h_l = h_px * splat.exp2_int(-lev)
            gmask = ~((h_l > GIANT_H) & (sbks >= gb))
        struth = zsplat.zsplat_scatter(sps, svals, smatrix, RESOLUTION,
                                       sscale, density_cut=cut,
                                       extra_mask=gmask, level_override=lev)
        layer = ssph._surface_giant_layer
        if layer is not None:
            struth = surface._max_composite(struth, layer)
        struth = struth.cpu().numpy()
        cov_t, cov_r = struth[..., 1] > 0, sraw[..., 1] > 0
        flips = int((cov_t != cov_r).sum())
        both = cov_t & cov_r
        d_ok = np.isclose(sraw[..., 1][both], struth[..., 1][both],
                          rtol=1e-5, atol=1e-4)
        v_ok = np.isclose(sraw[..., 0][both], struth[..., 0][both],
                          rtol=1e-5, atol=1e-6)
        if layer is None:
            giant = "no giant layer"
        else:
            ld = layer[..., 1].cpu().numpy()
            giant = (f"giant layer covers {int((ld > 0).sum())} px, "
                     f"front-most on {int(((ld == sraw[..., 1]) & cov_r).sum())}"
                     " px")
        log(f"phase {tag} truth: covered {int(cov_r.sum())} px "
            f"({cov_r.mean():.4f} of the image), coverage flips {flips} "
            f"({flips / max(cov_t.sum(), 1):.3e} of covered), depth within "
            f"rtol 1e-5/atol 1e-4 on {d_ok.mean():.6f}, winner values agree "
            f"on {v_ok.mean():.6f} of both-covered pixels "
            f"({int((~v_ok).sum())} differ), against zsplat_scatter; {giant}"
            f" ({time.perf_counter() - t0:.1f} s)")
        check(cov_r.sum() > 0, f"{tag}: the surface image covers nothing")
        check(flips <= 1e-4 * cov_t.sum(), f"{tag}: coverage flips {flips}")
        check(d_ok.all(), f"{tag}: depth differs on {int((~d_ok).sum())} "
              "pixels")
        check(v_ok.mean() >= 0.999, f"{tag}: winner values agree on "
              f"{v_ok.mean()}")
        return float(cov_r.mean())

    def surface_frames(tag, percentile):
        """Phases S2-S4 at one density-cut percentile; returns the kernels'
        launches during its timed EXPORT frames and the covered share of
        the image."""
        ssph.set_density_cut_percentile(percentile)
        ssph.invalidate()
        ssph.render(DrawReason.EXPORT)
        cut = np.float32(ssph._density_cut_value())
        gb = int(ssph._giant_bucket)
        log(f"phase S1 {tag}: density cut {float(cut):.6e} (percentile "
            f"{percentile}); giant plan: bucket threshold {gb} "
            f"({'disabled' if gb == BUCKET_DISABLED else 'layer'})")

        # ---- S2: K3 against its plain version on every call of a frame
        t0 = time.perf_counter()
        for ci, sl in enumerate(chunks):
            main_kw, t2_kw, t3_kw, drop, shape = surface_chunk_calls(
                vis, sl, cut, gb)
            keys = zsplat_accum.pack_atlas(torch.zeros(shape, device=dev))
            for name, kw in (("main", main_kw), ("tier2", t2_kw),
                             ("tier3", t3_kw)):
                keys = k3_compare(f"{tag}_chunk{ci}_{name}", kw, keys,
                                  timing=ci == 0)
            log(f"phase S2 {tag} chunk {ci}: dropped {int(drop.item())}")
            if ci == 0:
                # the frame's plain parts around K3 at this chunk's shapes
                front_ms = timed_ms(
                    lambda: surface_chunk_calls(vis, sl, cut, gb), 3)
                collapse_ms = timed_ms(lambda: zsplat_atlas.collapse_max_atlas(
                    zsplat_accum.unpack_atlas(keys), pyr), 3)
                log(f"phase S2 {tag} chunk 0 plain parts: front end, anchors "
                    f"and spill gathers (deposit_calls) {front_ms:.3f} ms; "
                    f"unpack and max-composite collapse {collapse_ms:.3f} ms")
                # a zero-row fit window makes every gathered spilled
                # particle a straggler, so the one-particle shape sees real
                # anchors
                _, _, forced, _, _ = surface_chunk_calls(vis, sl, cut, gb,
                                                         window_rows=0)
                check((forced["flags"] // 4 == zsplat_accum.FLAG_ACTIVE).any(),
                      f"{tag} forced tier 3: no active straggler")
                k3_compare(f"{tag}_chunk0_tier3_forced", forced,
                           zsplat_accum.pack_atlas(
                               torch.zeros(shape, device=dev)), timing=True)
            del main_kw, t2_kw, t3_kw, keys
        log(f"phase S2 {tag}: {time.perf_counter() - t0:.1f} s")

        # ---- S3: the surface EXPORT path
        reset_counts()
        sframe_ms, swall_ms = export_frame_ms(ssph)
        slaunches = read_counts(f"surface EXPORT {tag}",
                                ("accumulate_max_groups", "zdeposit_plan"))
        smed = statistics.median(sframe_ms)
        simg = ssph.get_output_image()
        smooth_ms = timed_ms(lambda: smooth_image(simg, 0.01), 3)
        present_ms = timed_ms(lambda: vis.colormap.to_rgba(simg), 3)
        t0 = time.perf_counter()
        content = vis.get_sph_image()          # smoothed on the card
        content_ms = (time.perf_counter() - t0) * 1e3
        log(f"phase S3 {tag} surface EXPORT: {FRAMES} frames, median "
            f"{smed:.3f} ms/frame (CUDA events; host wall median "
            f"{statistics.median(swall_ms):.3f} ms), "
            f"{N_PARTICLES / (smed / 1e3):.6e} particles/s, "
            f"last_dropped_splats {ssph.last_dropped_splats}, frames ms "
            f"{[round(t, 3) for t in sframe_ms]}; bilateral filter "
            f"{smooth_ms:.3f} ms, presentation (filter + lighting) "
            f"{present_ms:.3f} ms, get_sph_image {content_ms:.3f} ms (host "
            f"wall); launches during the frames {slaunches}")
        # ---- S3: the surface EXPORT path
        reset_counts()
        sframe_ms, swall_ms = export_frame_ms(ssph)
        slaunches = read_counts(f"surface EXPORT {tag}",
                                ("accumulate_max_groups", "zdeposit_plan"))
        check(content.shape == (RESOLUTION, RESOLUTION, 2)
              and np.isfinite(content).all(),
              f"surface get_sph_image {content.shape} not finite")

        # ---- S4: the surface output is right
        sraw = ssph.get_image()
        cov_mean = surface_truth(f"S4 {tag}", sraw, cut, gb)
        spres = vis.get_sph_presentation_image()
        check(spres.shape == (RESOLUTION, RESOLUTION, 4)
              and spres.dtype == np.uint8,
              f"surface presentation image {spres.shape} {spres.dtype}")
        check(spres[..., :3].std() > 0,
              "surface presentation image is constant")
        return slaunches, cov_mean

    runs = {tag: surface_frames(tag, pct) for tag, pct in SURFACE_CUTS}
    slaunches = {tag: r[0] for tag, r in runs.items()}
    check(runs["cut0"][1] >= 0.5, f"the lowest cut covers {runs['cut0'][1]} "
          "of the image, not at least half")

    # ---- phase SI: the interactive surface at both cuts --------------------
    from topsy_tpu_torch.render.surface import surface_column_launches
    si_launches, si_summary = {}, {}
    srotation, sscale0 = np.array(ssph.rotation_matrix), ssph.scale
    q = min_slice_width(store.presorted_layout)
    for tag, pct in SURFACE_CUTS:
        t0 = time.perf_counter()
        vis.rotation_matrix = srotation
        vis.scale = sscale0
        ssph.set_density_cut_percentile(pct)
        ssph.render(DrawReason.CHANGE)
        cut = np.float32(ssph._density_cut_value())
        gb = int(ssph._giant_bucket)
        # SI1: K3 on main-layout slices one and three quanta wide, on the
        # main layout's REFINE launch (its columns above the mip's) and its
        # full width, and on the mip tier's CHANGE launch, every call held
        # and timed
        for ti, col0, width in ((None, 0, q), (None, q, 3 * q),
                                (None, q, G - q), (None, 0, G), (0, 0, G)):
            t = store.main_tier if ti is None else smips[ti]
            arrays = (t.pos_smooth, t.values_for(ssph._buffer_name),
                      t.buckets)
            name = "" if ti is None else f"tier{ti}_"
            ps_c, vals_c, bks_c, _, chunks_c, kw_c = surface_column_launches(
                *arrays, None, None, col0, width, G)
            for ci, sl in enumerate(chunks_c):
                main_kw, t2_kw, t3_kw, drop, shape = zsplat_atlas.deposit_calls(
                    ps_c[sl], vals_c[sl], ssph._matrix().astype(np.float32),
                    RESOLUTION, np.float32(ssph.scale), bks_c[sl],
                    density_cut=cut, giants=gb, **kw_c)
                check(main_kw["group"] == min(width, 512),
                      f"SI width {width}: groups of {main_kw['group']}")
                keys = zsplat_accum.pack_atlas(torch.zeros(shape, device=dev))
                for shape_, kw in (("main", main_kw), ("tier2", t2_kw),
                                   ("tier3", t3_kw)):
                    keys = k3_compare(
                        f"SI_{tag}_{name}c{col0}_w{width}_chunk{ci}_{shape_}",
                        kw, keys, timing=ci == 0)
                log(f"phase SI {tag} {name or 'main '}columns [{col0}, "
                    f"{col0 + width}) chunk {ci}: dropped {int(drop.item())}")
                del main_kw, t2_kw, t3_kw, keys
        # SI2: interactive views, each a CHANGE draw then REFINE draws
        reset_counts()
        change_ms, n_frames, drops, tiers_seen = [], [], [], []
        for v in range(2 + FRAMES):
            vis.rotate(0.0, 0.05)
            frames = drive_view(vis)
            if v >= 2:
                change_ms.append(frames[0][0])
                n_frames.append(len(frames))
                drops.append([f[2] for f in frames])
                tiers_seen.append([f[4] for f in frames])
            log(f"phase SI2 {tag} view {v}{' (warm-up)' if v < 2 else ''}: "
                f"frames {FRAME_FIELDS} {show_frames(frames)}")
        si_launches[tag] = read_counts(f"interactive surface {tag}",
                                       ("accumulate_max_groups",
                                        "zdeposit_plan"))
        # SI3: the completed interactive image against EXPORT of the view
        im_i = ssph.get_output_image().clone()
        ssph.invalidate()
        ssph.render(DrawReason.EXPORT)
        im_e = ssph.get_output_image()
        cov_i, cov_e = im_i[..., 1] > 0, im_e[..., 1] > 0
        flips = int((cov_i != cov_e).sum())
        both = cov_i & cov_e
        v_eq = float((im_i[..., 0][both] == im_e[..., 0][both]).float()
                     .mean())
        d_eq = float((im_i[..., 1][both] == im_e[..., 1][both]).float()
                     .mean())
        log(f"phase SI2 {tag}: {FRAMES} views; CHANGE frame median "
            f"{statistics.median(change_ms):.3f} ms by the frame clock "
            f"(frames {[round(t, 3) for t in change_ms]}); frames to "
            f"completion {n_frames}; tiers per frame {tiers_seen}; dropped "
            f"per frame {drops}; launches {si_launches[tag]}")
        log(f"phase SI3 {tag}: the completed interactive image against the "
            f"EXPORT image of its view: coverage flips {flips} of "
            f"{int(cov_e.sum())} covered; values equal on {v_eq:.6f}, depths "
            f"equal on {d_eq:.6f} of both-covered pixels; bit-identical "
            f"{bool(torch.equal(im_i, im_e))}")
        check(flips <= 1e-4 * int(cov_e.sum()), f"SI3 {tag}: coverage flips "
              f"{flips}")
        check(v_eq >= 0.999, f"SI3 {tag}: values equal on {v_eq}")
        si_summary[tag] = dict(change_ms=change_ms, frames=n_frames,
                               tiers=tiers_seen, dropped=drops, flips=flips,
                               bit_identical=bool(torch.equal(im_i, im_e)))
        log(f"phase SI {tag}: {time.perf_counter() - t0:.1f} s")
    # SI4: zoomed out only as far as the surface giant plan takes
    # candidates, at the lowest cut (giants are diffuse): the frame against
    # the scatter truth (which composites the same layer), and the layer
    # alone against its own float64 evaluation over every particle the
    # windowed deposit excluded
    vis.rotation_matrix = srotation
    zs, size = zoom_out_scale(store, sscale0 + 5.0, 800.0)
    vis.scale = zs
    frames = drive_view(vis)
    check(ssph._surface_giant_layer is not None, "the interactive surface "
          "frame drew no giant layer")
    log(f"phase SI4 at scale {zs} ({size} giant candidates): frames "
        f"{FRAME_FIELDS} {show_frames(frames)}")
    surface_truth("SI4 cut0 zoomed out", ssph.get_image(),
                  np.float32(ssph._density_cut_value()),
                  int(ssph._giant_bucket))
    n_giants, covers, wins = giant_layer_truth("SI4 cut0 zoomed out", ssph,
                                               store)
    si_summary.update(giant_scale=zs, giants=n_giants,
                      giant_layer_px=[covers, wins])
    vis.scale = sscale0

    # ---- phase L5: the surface scatter fallback -----------------------------
    lsummary["surface_fallback"] = phase_surface_fallback(vis)

    # ---- phase A: the array entry point and its smoothing lengths ----------
    asummary = phase_arrays(dev, vis.data_loader)

    # ---- phase G: the particle mesh ----------------------------------------
    glaunches, g_feed_err, g_accum_err, gentries, gsummary = phase_mesh(
        vis, export_image, truth_density, view)
    feed_err = max(feed_err, g_feed_err)
    accum_err = max(accum_err, g_accum_err)
    del export_image, truth_density

    # ---- phase H: the host shell on the scene's Visualizer -------------------
    vis.render_mode = "univariate"
    set_view(vis, view)
    hlaunches, hsummary = phase_host_shell(vis, dev)

    # ---- phase 8: kernels --------------------------------------------------
    # launches per path, each counted from 0 just before its path ran
    paths = {**glaunches, **hlaunches, "export": launches,
             "export_catmull": claunches,
             "device_loader_export": dlaunches,
             "interactive": ilaunches, **mlaunches, **llaunches,
             **{f"surface_export_{k}": v for k, v in slaunches.items()},
             **{f"surface_interactive_{k}": v
                for k, v in si_launches.items()}}

    def by_path(name):
        counts = {p: c.get(name, 0) for p, c in paths.items()}
        return {p: n for p, n in counts.items() if n}

    def mode_times(kernel):
        """Phase M's timed calls of one kernel: (ms, plain ms, bound ms)
        keyed by call."""
        got = {k.replace(f"_{kernel}", ""): v for k, v in mtimes.items()
               if f"_{kernel}" in k}
        return {f"modes_{part}_by_call": {k: v[i] for k, v in got.items()}
                for i, part in enumerate(("ms", "plain_ms", "bound_ms"))}

    kernels = [
        {"name": "splat_feed", "route": "cuda",
         "source": "topsy_tpu_torch/csrc/splat_feed.cu",
         "replaces": "topsy_tpu/ops/splat_feed.py:207",
         "launches": sum(by_path("splat_feed").values()),
         "launches_by_path": by_path("splat_feed"),
         "max_abs_err": feed_err,
         "ms": feed_ms, "plain_ms": feed_plain_ms,
         "bound_ms": feed_bound[0], "bound_by": feed_bound[1],
         "library_ms": None,
         "device_ms": K1_CALLS["export_piece0"]["device_ms"],
         "host_us": K1_CALLS["export_piece0"]["host_us"],
         "by_call": K1_CALLS,
         **interactive_times(isummary["feed_t"]), **mode_times("K1")},
        {"name": "accumulate_groups", "route": "cuda",
         "source": "topsy_tpu_torch/csrc/splat_accum.cu",
         "replaces": "topsy_tpu/ops/splat_pallas.py:317",
         "launches": sum(by_path("accumulate_groups").values()),
         "launches_by_path": by_path("accumulate_groups"),
         "max_abs_err": accum_err,
         "ms": accum_ms["main"], "plain_ms": accum_plain_ms["main"],
         "bound_ms": accum_bound["main"][0],
         "bound_by": accum_bound["main"][1], "library_ms": None,
         "ms_by_shape": accum_ms, "plain_ms_by_shape": accum_plain_ms,
         "bound_ms_by_shape": {k: v[0] for k, v in accum_bound.items()},
         **interactive_times(isummary["accum_t"]), **mode_times("K2")},
        {"name": "accumulate_max_groups", "route": "cuda",
         "source": "topsy_tpu_torch/csrc/zsplat_accum.cu",
         "replaces": "topsy_tpu/ops/zsplat_pallas.py:203",
         "launches": sum(by_path("accumulate_max_groups").values()),
         "launches_by_path": by_path("accumulate_max_groups"),
         "plan_launches_by_path": by_path("zdeposit_plan"),
         "max_abs_err": k3_err, "ms": k3_ms["cut50_chunk0_main"],
         "plain_ms": k3_plain_ms["cut50_chunk0_main"],
         "bound_ms": k3_bound["cut50_chunk0_main"][0],
         "bound_by": k3_bound["cut50_chunk0_main"][1], "library_ms": None,
         "ms_by_shape": k3_ms, "plain_ms_by_shape": k3_plain_ms,
         "bound_ms_by_shape": {k: v[0] for k, v in k3_bound.items()}},
    ]
    # K2 on the block paths, one entry per path: its launches in the path's
    # run, its calls held and the first call of each shape timed
    for path, entry in {**lentries, **gentries}.items():
        kernels.append({"name": f"accumulate_groups[{path}]",
                        "route": "cuda",
                        "source": "topsy_tpu_torch/csrc/splat_accum.cu",
                        "replaces": "topsy_tpu/ops/splat_pallas.py:317",
                        **entry})
    interactive = {k: v for k, v in isummary.items()
                   if k not in ("feed_t", "accum_t")}
    log(f"summary: catmull {json.dumps(csummary)}; presort "
        f"{json.dumps(psummary)}; device loader "
        f"{json.dumps(dsummary)}; interactive {json.dumps(interactive)}; "
        f"modes {json.dumps(msummary)}; interactive surface "
        f"{json.dumps(si_summary)}; block paths {json.dumps(lsummary)}; "
        f"arrays {json.dumps(asummary)}; mesh {json.dumps(gsummary)}; "
        f"host shell {json.dumps(hsummary)}")
    log(f"card: {card}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
