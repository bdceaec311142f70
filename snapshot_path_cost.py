"""The user-facing times of the snapshot path for one checkout.

    python3 snapshot_path_cost.py [ROOT]

Imports ``topsy_tpu_torch`` from the checkout at ROOT (default: this
script's directory) and, on the seeded 2^24-particle TestDataLoader scene
at 1024^2 (``chip_smoke.py``'s), prints one JSON line with:

* ``first_image_s``: host wall time from ``Visualizer(...)`` to the first
  EXPORT image read back (the loader's host generation, the store, the
  first frame and the colormap's autorange), synchronised; the first
  frame renders what the checkout's EXPORT policy picks (since the lazy
  policy: the sorted block path, no presort; before it: the presort and
  the presorted frame);
* per interactive view (a 0.05 rad drag, then a CHANGE draw and the REFINE
  draws that complete it, seven views, the first two warm-ups) each
  frame's milliseconds by the frame clock (first launch to the end of the
  presentation readback) and the column ranges it rendered, with the
  medians over the five timed views of the first frame
  (``change_ms_median``) and of the view's frames summed, its time to a
  finished image (``completion_ms_median``);
* ``pick_ms``: ``vis.get_depth_image()`` after the last view, CUDA events
  around each pick (median of 3 after 1 warm-up).

Comparing two checkouts on one card: run it from each in turns in one
call (parent, change, change, parent); each process builds the kernels of
its checkout into that checkout's build directory.  Needs one CUDA device;
exits 2 without one.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

N_PARTICLES = 1 << 24
RESOLUTION = 1024
VIEWS = 7


def main() -> int:
    root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1
                           else os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("snapshot_path_cost: no CUDA device available", file=sys.stderr)
        return 2
    from topsy_tpu_torch.loaders import TestDataLoader
    from topsy_tpu_torch.visualizer import (DrawReason, OffscreenCanvas,
                                            Visualizer)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    # build the kernels (and their caches) before the clock starts
    warm = Visualizer(data_loader_class=TestDataLoader,
                      data_loader_args=(1 << 16,),
                      render_resolution=RESOLUTION,
                      canvas_class=OffscreenCanvas, device="cuda")
    warm.show_status = warm.show_colorbar = warm.show_scalebar = False
    warm.draw(DrawReason.CHANGE)
    warm.get_depth_image()
    del warm
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    vis = Visualizer(data_loader_class=TestDataLoader,
                     data_loader_args=(N_PARTICLES,),
                     data_loader_kwargs={"seed": 1337},
                     render_resolution=RESOLUTION,
                     canvas_class=OffscreenCanvas, device="cuda")
    vis._sph.get_image()
    first_image_s = time.perf_counter() - t0
    vis.show_status = vis.show_colorbar = vis.show_scalebar = False
    sph = vis._sph

    views = []
    for _ in range(VIEWS):
        vis.rotate(0.0, 0.05)
        vis.draw(DrawReason.CHANGE)
        frames = [(sph.frame_clock.seconds() * 1e3,
                   list(sph.last_column_ranges))]
        while sph.needs_refine():
            vis.draw(DrawReason.REFINE)
            frames.append((sph.frame_clock.seconds() * 1e3,
                           list(sph.last_column_ranges)))
        views.append(frames)

    def pick_ms():
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        vis.get_depth_image()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)

    pick_ms()
    picks = [pick_ms() for _ in range(3)]
    timed = views[2:]
    print(json.dumps({
        "root": root, "card": card, "first_image_s": first_image_s,
        "change_ms_median": statistics.median(v[0][0] for v in timed),
        "completion_ms_median": statistics.median(
            sum(f[0] for f in v) for v in timed),
        "frames_to_completion": [len(v) for v in timed],
        "views": views, "pick_ms": statistics.median(picks),
        "picks_ms": picks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
