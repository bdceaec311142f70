"""Smoke run of the PyTorch/CUDA port (topsy_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's hand-written kernels from this checkout (the Triton feed
kernel K1 and the CUDA deposit kernel K2, into build/torch_kernels/), builds
the 2^24-particle synthetic snapshot at 1024x1024 with the (density,
mass * quantity) channels — the scene bench.py renders — through
``Visualizer(..., device="cuda")``, holds each kernel against its plain
PyTorch version on the card at the shapes the EXPORT path gives it (every
piece of the renderer's piece loop), drives the EXPORT path (warm-up and
timed frames, the SPH image and the presentation image), checks the image
against the port's scatter ground truth, and prints:

* the card's name and power limit (nvidia-smi);
* one ``{"kernels": [...]}`` JSON line: per kernel its launches during the
  EXPORT frames, its largest difference from the plain version, and the
  kernel's and the plain version's time at the first piece's shapes;
* last, ``{"ok": true, "device": {...}}``.

Every phase raises on failure, so the script exits nonzero and prints no
result; it also exits nonzero when no CUDA device is available.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

N_PARTICLES = 1 << 24
RESOLUTION = 1024
FRAMES = 5


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


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")

    import topsy_tpu_torch  # noqa: F401  (sets full-f32 matmuls)
    from topsy_tpu_torch.loaders import TestDataLoader
    from topsy_tpu_torch.ops import (cuda_build, splat, splat_accum,
                                     splat_atlas, splat_feed)
    from topsy_tpu_torch.visualizer import (DrawReason, OffscreenCanvas,
                                            Visualizer)

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
    cuda_build.library("splat_accum")
    # compile K1 on a two-group input
    tiny = torch.zeros((2, 512), device=dev)
    splat_feed.splat_feed_triton(
        (tiny, tiny, tiny, tiny), torch.zeros((2, 2, 512), device=dev),
        torch.ones((2, 8), device=dev), np.zeros(16, np.float32),
        np.zeros(4, np.int32), C_in=2, depth_channel=False,
        resolution=RESOLUTION, atlas_rows=1024, atlas_cols=1152,
        window_rows=96, band=8, col_pad=16.0, foot=8.0, piece_groups=2,
        ranged=False, has_mask=False, sentinel_ay=1000.0)
    torch.cuda.synchronize()
    log(f"phase build: {time.perf_counter() - t0:.2f} s "
        "(nvcc for csrc/*.cu, then Triton JIT)")

    # ---- phase 3: the scene ------------------------------------------------
    t0 = time.perf_counter()
    vis = Visualizer(data_loader_class=TestDataLoader,
                     data_loader_args=(N_PARTICLES,),
                     data_loader_kwargs={"seed": 1337},
                     render_resolution=RESOLUTION,
                     canvas_class=OffscreenCanvas, device=dev)
    vis.show_status = False
    vis.quantity_name = "test-quantity"
    vis.scale = 200.0
    sph = vis._sph
    sph.render(DrawReason.EXPORT)
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

    # ---- phases 4-5: each kernel against its plain version, every piece ----
    matrix = sph._matrix().astype(np.float32)
    scale = np.float32(sph.scale)
    fields = store.presorted_fields()
    values = store.presorted_values_cm_for(sph._buffer_name)
    pyramid = splat.default_pyramid(RESOLUTION)
    _, atlas_rows, atlas_cols = splat_atlas.atlas_layout(pyramid)
    feed_err, accum_err = 0.0, 0.0
    feed_ms = feed_plain_ms = None
    accum_ms, accum_plain_ms = {}, {}
    for i, piece in enumerate(pieces):
        # K1, exactly as the renderer feeds this piece
        fargs, fkw = splat_atlas.feed_call(
            fields, values, matrix, RESOLUTION, scale,
            store.presorted_group_buckets, mask=sph._feed_cull_mask(),
            piece=piece, bucket_thresh=sph._giant_bucket)
        out_k = splat_feed.splat_feed_triton(*fargs, **fkw)
        out_p = splat_feed.splat_feed_plain(*fargs, **fkw)
        err = 0.0
        for name, a, b in zip(("ay", "ax", "ih", "cfit", "cspill"),
                              out_k[:5], out_p[:5]):
            check(torch.isfinite(a).all(), f"K1 piece {piece} {name} not "
                  "finite")
            check(torch.allclose(a, b, rtol=1e-6, atol=0.0),
                  f"K1 piece {piece} {name} differs from the plain version "
                  f"beyond rtol 1e-6: max {(a - b).abs().max().item()}")
            err = max(err, (a - b).abs().max().item())
        for name, a, b in zip(("w0", "c0", "ce", "flags", "nspill"),
                              out_k[5:], out_p[5:]):
            n_diff = int((a != b).sum().item())
            check(n_diff == 0, f"K1 piece {piece} {name}: {n_diff} groups "
                  "differ")
        feed_err = max(feed_err, err)
        if i == 0:
            feed_ms = timed_ms(
                lambda: splat_feed.splat_feed_triton(*fargs, **fkw), 10)
            feed_plain_ms = timed_ms(
                lambda: splat_feed.splat_feed_plain(*fargs, **fkw), 3)
        kinds = torch.bincount((out_k[8] // 4).long(), minlength=5).tolist()
        log(f"phase K1 piece {piece}: ok; max abs diff {err:.3e}; groups by "
            f"kind [inactive, tiny, poly, mixed, masked] = {kinds}; spilled "
            f"particles {int(out_k[9].sum().item())}"
            + (f"; {feed_ms:.3f} ms (plain {feed_plain_ms:.3f} ms)"
               if i == 0 else ""))

        # K2 in the three call shapes that follow this feed
        main_kw, tier2_kw, tier3_kw, dropped = splat_atlas.deposit_calls(
            out_k, C=2, G=G, atlas_rows=atlas_rows, atlas_cols=atlas_cols)
        # When every spilled particle fits its tier-2 window, the scene's
        # tier-3 call deposits nothing.  A zero-row tier-2 window makes every
        # gathered spilled particle a straggler, so the one-particle shape is
        # also held against the plain version on real anchors.
        _, _, stragglers_kw, _ = splat_atlas.deposit_calls(
            out_k, C=2, G=G, atlas_rows=atlas_rows, atlas_cols=atlas_cols,
            window_rows=0)
        stragglers_kw["window_rows"] = splat_atlas.PRESORTED_WINDOW_ROWS
        for shape, kw in (("main", main_kw), ("tier2", tier2_kw),
                          ("tier3", tier3_kw),
                          ("tier3_stragglers", stragglers_kw)):
            a_k = splat_accum.accumulate_groups_cuda(**kw)
            a_p = splat_accum.accumulate_groups_plain(**kw)
            ref_max = a_p.abs().max().item()
            err = (a_k - a_p).abs().max().item()
            check(torch.isfinite(a_k).all(),
                  f"K2 piece {piece} {shape}: atlas not finite")
            check(err <= 1e-5 * ref_max, f"K2 piece {piece} {shape}: max "
                  f"abs diff {err} > 1e-5 * {ref_max}")
            accum_err = max(accum_err, err)
            active = int(((kw["flags"] // 4) > 0).sum().item())
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
                timing = (f"; {accum_ms[shape]:.3f} ms (plain "
                          f"{accum_plain_ms[shape]:.3f} ms)")
            log(f"phase K2 piece {piece} {shape}: ok; groups "
                f"{kw['flags'].shape[0]} of {kw['group']} (active {active}); "
                f"max|atlas| {ref_max:.4e}, max abs diff {err:.3e}{timing}")
        log(f"piece {piece} dropped {int(dropped.item())}")
        del out_k, out_p, a_k, a_p

    # ---- phase 6: the EXPORT path ------------------------------------------
    splat_feed.launches = 0
    splat_accum.launches = 0
    for _ in range(2):                      # warm-up frames
        sph.invalidate()
        sph.render(DrawReason.EXPORT)
    torch.cuda.synchronize()
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
    image = vis.get_sph_image()
    pres = vis.get_sph_presentation_image()
    launches = {"splat_feed": splat_feed.launches,
                "accumulate_groups": splat_accum.launches}
    med = statistics.median(frame_ms)
    log(f"phase EXPORT: {FRAMES} frames, median {med:.3f} ms/frame "
        f"(CUDA events; host wall median {statistics.median(wall_ms):.3f} "
        f"ms), {N_PARTICLES / (med / 1e3):.6e} splats/s, "
        f"last_dropped_splats {sph.last_dropped_splats}, frames ms "
        f"{[round(t, 3) for t in frame_ms]}")
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        f" GiB; launches during the EXPORT frames {launches}")
    check(launches["splat_feed"] > 0 and launches["accumulate_groups"] > 0,
          f"a kernel was not launched on the EXPORT path: {launches}")

    # ---- phase 7: the output is right --------------------------------------
    raw = sph.get_image()
    check(raw.shape == (RESOLUTION, RESOLUTION, 2), f"image shape {raw.shape}")
    check(np.isfinite(raw).all(), "image not finite")
    check(image.shape == (RESOLUTION, RESOLUTION), "SPH content shape")
    t0 = time.perf_counter()
    ps = torch.as_tensor(vis.data_loader.get_pos_smooth(), device=dev)
    vals = torch.as_tensor(store.host_values_for(sph._buffer_name),
                           device=dev)
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

    # ---- phase 8: kernels --------------------------------------------------
    kernels = [
        {"name": "splat_feed", "route": "triton",
         "source": "topsy_tpu_torch/ops/splat_feed.py",
         "replaces": "topsy_tpu/ops/splat_feed.py:207",
         "launches": launches["splat_feed"], "max_abs_err": feed_err,
         "ms": feed_ms, "plain_ms": feed_plain_ms},
        {"name": "accumulate_groups", "route": "cuda",
         "source": "topsy_tpu_torch/csrc/splat_accum.cu",
         "replaces": "topsy_tpu/ops/splat_pallas.py:317",
         "launches": launches["accumulate_groups"], "max_abs_err": accum_err,
         "ms": accum_ms["main"], "plain_ms": accum_plain_ms["main"],
         "ms_by_shape": accum_ms, "plain_ms_by_shape": accum_plain_ms},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
