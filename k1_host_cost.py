"""Host and device cost of kernel K1 (the feed) at every call shape the
port's additive paths give it.

    python3 k1_host_cost.py [ROOT] [--host-parts]

Imports ``topsy_tpu_torch`` from the checkout at ROOT (default: this
script's directory) and ``chip_smoke.py``'s helpers from this script's
directory, builds ``chip_smoke.py``'s scene (the seeded 2^24-particle
snapshot at 1024^2, presorted on the card) and, for each K1 call shape,
prints one JSON line: the call's time as ``chip_smoke.timed_ms`` gives it
(CUDA events around 20 calls back to back), the kernel's own device time
(``chip_smoke.k1_costs``: torch.profiler's kernel durations; beside it
``chip_smoke.queued_ms``, CUDA events around each call queued behind a
busy wait), the
wrapper's host time per call (``perf_counter`` around 20 calls enqueued
onto an idle card), and the call's bound (``chip_smoke.k1_bound``).  The
shapes: EXPORT pieces 0 and 1; the mip tier's CHANGE launch (all its
columns); the REFINE launch's columns [64, 512) of the main layout, piece
0; the depth pick's CHANGE launch (``DEPTH=1``); RGB's EXPORT piece 0
(``C_IN=3``); and mesh shard 0's call, as the main layout's first 16,800
groups (the shard's slab of a two-shard mesh has that many).  The wrapper
is ``splat_feed_cuda`` where ROOT has it, else ``splat_feed_triton``.
Where ROOT has ``csrc/splat_feed.cu`` the script builds it afresh and
prints ptxas' registers and spills per variant.
Beside the calls it times a copy of as many bytes (``Tensor.copy_``,
half of them read and half written), the card's practical rate for
this traffic.  ``--host-parts`` (a CUDA K1) prints the host time of
each part of one wrapper call of the mip-tier CHANGE shape, each part
alone, 2,000 times each: the input checks, the struct's cache lookup,
the two output allocations, the ten output views, the stream, the
pointers and the ``ctypes`` launch.
Comparing two checkouts on one card: unpack the other with ``git
archive`` into ``build/parent`` and run parent, change, change, parent in
one call.  Needs one CUDA device; exits 2 without one.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import time

CALLS = 20
MESH_SHARD_GROUPS = 16800


def main() -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    root = os.path.abspath(args[0] if args else here)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_helpers", os.path.join(here, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("k1_host_cost: no CUDA device available", file=sys.stderr)
        return 2
    import subprocess
    from topsy_tpu_torch.ops import splat_atlas, splat_feed
    from topsy_tpu_torch.ops.morton import min_slice_width
    from topsy_tpu_torch.render.sph import column_launches
    from topsy_tpu_torch.visualizer import DrawReason
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    wrapper = getattr(splat_feed, "splat_feed_cuda", None) or getattr(
        splat_feed, "splat_feed_triton")
    is_cuda = wrapper.__name__ == "splat_feed_cuda"
    if is_cuda:
        from topsy_tpu_torch.ops import cuda_build
        stem = cuda_build._stem("splat_feed", ())
        (cuda_build.BUILD_DIR / f"lib{stem}.so").unlink(missing_ok=True)
        t0 = time.perf_counter()
        cuda_build.build(["splat_feed"])
        print(f"k1_host_cost: csrc/splat_feed.cu built in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        for name, res in cs.ptxas_resources(
                cuda_build.build_logs["splat_feed"]):
            print(f"ptxas K1 {name}: {res}", flush=True)
    t0 = time.perf_counter()
    vis = cs.build_scene(torch.device("cuda"))
    torch.cuda.synchronize()
    scene_s = time.perf_counter() - t0
    sph, store = vis._sph, vis.store
    G = store.presorted_layout.pad_group
    res = cs.RESOLUTION

    def column_call(renderer, tier, col0, width):
        fields, vals, gb, msk, pieces, _ = column_launches(
            *cs.tier_arrays(store, renderer, tier), col0, width)
        return splat_atlas.feed_call(
            fields, vals, renderer._matrix().astype(np.float32), res,
            np.float32(renderer.scale), gb, mask=msk,
            depth_channel=renderer._depth_channel, piece=pieces[0],
            bucket_thresh=renderer._giant_bucket), width

    calls = {}
    pieces = sph.pieces()
    for i, piece in enumerate(pieces[:2]):
        calls[f"export_piece{i}"] = (cs.feed_args(vis, piece), G)
    calls["mesh_shard0"] = (cs.feed_args(vis, (0, MESH_SHARD_GROUPS)), G)
    tiers = store.ensure_column_mips()
    calls["change_tier0"] = column_call(sph, tiers[0], 0, G)
    q = min_slice_width(store.presorted_layout)
    calls["refine_piece0"] = column_call(sph, store.main_tier, q, G - q)
    # the pick: an interactive view, then a double-click, as phase M3
    vis.draw(DrawReason.CHANGE)
    vis.get_depth_image()
    dr = sph._get_depth_renderer()
    (c0, width), = dr.last_column_ranges
    pick_tier = dr.render_progression.last_block_tier
    tier = tiers[pick_tier] if pick_tier < len(tiers) else store.main_tier
    calls["pick_depth1"] = column_call(dr, tier, c0, width)
    vis.render_mode = "rgb"
    rgb = vis._sph
    calls["rgb_piece0"] = (cs.feed_args(vis, rgb.pieces()[0], rgb), G)

    out = {}
    for name, ((fargs, fkw), width) in calls.items():
        def fn():
            wrapper(*fargs, **fkw)
        call_ms = cs.timed_ms(fn, CALLS)
        device_ms, host_us, source = cs.k1_costs(fn, CALLS)
        bound_ms = cs.k1_bound(fkw, width)[0]
        extra = {"device_ms_events": cs.queued_ms(fn, CALLS)}
        out[name] = {"groups": fkw["piece_groups"], "G": width,
                     "C_in": fkw["C_in"],
                     "depth": int(fkw["depth_channel"]),
                     "mask": int(fkw["has_mask"]), "call_ms": call_ms,
                     "device_ms": device_ms, "device_by": source,
                     "host_us": host_us,
                     "bound_ms": bound_ms,
                     "share_of_call": bound_ms / call_ms,
                     "share_of_device": bound_ms / device_ms, **extra}
        print(f"k1_host_cost {name}: {json.dumps(out[name])}", flush=True)
    # the yardstick: a copy of EXPORT piece 0's bytes, half read, half
    # written
    total = int(out["export_piece0"]["bound_ms"] * 1e-3 * cs.HBM_BYTES_PER_S)
    src = torch.empty(total // 8, dtype=torch.float32, device="cuda")
    dst = torch.empty_like(src)
    copy_ms = cs.timed_ms(lambda: dst.copy_(src), CALLS)
    copy = {"bytes": total, "ms": copy_ms,
            "TB_per_s": total / copy_ms * 1e-9,
            "share_of_peak": total / copy_ms * 1e3 / cs.HBM_BYTES_PER_S}
    del src, dst
    print(f"k1_host_cost copy yardstick: {json.dumps(copy)}", flush=True)
    parts = None
    if "--host-parts" in sys.argv and is_cuda:
        parts = host_parts(splat_feed, *calls["change_tier0"][0])
        print(f"k1_host_cost host parts (us a call): {json.dumps(parts)}",
              flush=True)
    print(json.dumps({"k1_host_cost": root, "wrapper": wrapper.__name__,
                      "card": card, "scene_s": scene_s, "calls": out,
                      "copy": copy, "host_parts_us": parts}), flush=True)
    return 0


def host_parts(sf, fargs, fkw, reps=2000):
    """Microseconds of each part of one ``splat_feed_cuda`` call, each part
    run alone ``reps`` times (the card drained every 100 launches)."""
    import ctypes
    import numpy as np
    import torch
    fields, values, pergroup, params_f, sp_i, _ = fargs
    x = fields[0]
    index, (n_groups, G) = x.get_device(), x.shape
    pg, C = fkw["piece_groups"], fkw["C_in"] + int(fkw["depth_channel"])
    key = (np.asarray(params_f, np.float32).tobytes(),
           np.asarray(sp_i, np.int32).tobytes(), n_groups, G, fkw["C_in"],
           bool(fkw["depth_channel"]), fkw["resolution"], fkw["atlas_rows"],
           fkw["atlas_cols"], fkw["window_rows"], fkw["band"],
           fkw["col_pad"], fkw["foot"], pg, bool(fkw["ranged"]),
           bool(fkw["has_mask"]), fkw["sentinel_ay"], "lowrank")
    out = torch.empty((3 + 2 * C, pg, G), device=x.device)
    out_i = torch.empty((5, pg), dtype=torch.int32, device=x.device)
    scal = sf._scalars(*key)
    fn = sf._bind()
    tensors = (*fields, values, pergroup, out, out_i)
    ptrs = [t.data_ptr() for t in tensors]
    stream = torch._C._cuda_getCurrentRawStream(index)

    def checks():
        for t in (*fields, values, pergroup):
            (t.dtype is torch.float32, t.shape, t.is_contiguous(),
             t.get_device())

    def launch():
        fn(ctypes.byref(scal), *ptrs[:5], None, *ptrs[5:], stream)

    parts = {"call": lambda: sf.splat_feed_cuda(*fargs, **fkw),
             "checks": checks, "scalars": lambda: sf._scalars(*key),
             "empty x2": lambda: (
                 torch.empty((3 + 2 * C, pg, G), device=x.device),
                 torch.empty((5, pg), dtype=torch.int32, device=x.device)),
             "views x10": lambda: (out[:3].unbind(0), out[3:3 + C],
                                   out[3 + C:], out_i.unbind(0)),
             "stream": lambda: torch._C._cuda_getCurrentRawStream(index),
             "data_ptr x9": lambda: [t.data_ptr() for t in tensors],
             "ctypes launch": launch}
    got = {}
    for name, part in parts.items():
        torch.cuda.synchronize()
        total = 0.0
        for i in range(reps):
            t0 = time.perf_counter()
            part()
            total += time.perf_counter() - t0
            if i % 100 == 99:
                torch.cuda.synchronize()
        got[name] = total / reps * 1e6
    torch.cuda.synchronize()
    return got


if __name__ == "__main__":
    sys.exit(main())
