"""Where the deposits' time goes: breakdown builds of kernel K2
(csrc/splat_accum.cu) and kernel K3 (csrc/zsplat_accum.cu), timed on the
card at the 2^24-particle scene of chip_smoke.py.

    python3 k2_variants.py

Builds each kernel as the port builds it ("whole") and variants with one
part switched off: K2 by ``-DK2_SKIP`` 1 the profile evaluation, 2 the
wgmma products (the accumulators then stay zero, so the flush, which skips
zero vectors, makes no reductions either), 3 the float4 flush; K3 by
``-DK3_SKIP`` 1 the fragment evaluation (no key is made, so the flush
makes no atomics either), 2 the global merge, 3 the per-hit merge into
shared memory (a lane keeps its hits' maximum and merges it once per
particle); one nvcc process each, all started together.  It prints each build's kernel time (CUDA events, mean
of 5 calls after one warm-up, each K3 call from its own starting atlas):
for K2 on the first piece's calls, as chip_smoke.py builds them, the main
pass, the main pass with one size class alone (the other groups' flags set
inactive) and spill tier 2; for K3 on the first column chunk's calls of a
surface frame at the lowest density cut, the main pass, its size classes
alone and spill tier 2.  Needs one CUDA device; exits 2 without one.
"""

from __future__ import annotations

import subprocess
import sys
import time

VARIANTS = {"whole": (), "no_eval": ("-DK2_SKIP=1",),
            "no_product": ("-DK2_SKIP=2",), "no_flush": ("-DK2_SKIP=3",)}
K3_VARIANTS = {"whole": (), "no_eval": ("-DK3_SKIP=1",),
               "no_merge": ("-DK3_SKIP=2",),
               "no_shared_merge": ("-DK3_SKIP=3",)}


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("k2_variants: no CUDA device available", file=sys.stderr)
        return 2
    import chip_smoke
    from topsy_tpu_torch.ops import cuda_build, splat, splat_atlas, splat_feed
    from topsy_tpu_torch.ops import splat_accum as sa
    from topsy_tpu_torch.ops import zsplat_accum as za
    from topsy_tpu_torch.render import surface
    from topsy_tpu_torch.visualizer import DrawReason

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    t0 = time.perf_counter()
    cuda_build.build([("splat_accum", d) for d in VARIANTS.values()]
                     + [("zsplat_accum", d) for d in K3_VARIANTS.values()])
    print(f"built {len(VARIANTS) + len(K3_VARIANTS)} builds in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    dev = torch.device("cuda")
    vis = chip_smoke.build_scene(dev)
    G = vis.store.presorted_layout.pad_group
    _, rows, cols = splat_atlas.atlas_layout(
        splat.default_pyramid(chip_smoke.RESOLUTION))
    fargs, fkw = chip_smoke.feed_args(vis, vis._sph.pieces()[0])
    calls, _ = chip_smoke.k2_calls(splat_feed.splat_feed(*fargs, **fkw), G,
                                   rows, cols)
    flags = calls["main"]["flags"]
    cases = {"main": calls["main"]}
    for c in range(len(sa.SIZE_CLASSES)):
        cases[f"main class {c}"] = dict(
            calls["main"], flags=torch.where(flags % 4 == c, flags, 0))
    cases["tier2"] = calls["tier2"]

    atlas = torch.zeros((2, rows, cols), device=dev)
    for case, kw in cases.items():
        rolled = kw.get("window_cols", sa.WINDOW_COLS) == sa.WINDOW_COLS
        _, class_off = sa.deposit_plan(kw["flags"], rolled)
        ms = {name: chip_smoke.timed_ms(
            lambda: sa.accumulate_groups_cuda(**kw, atlas0=atlas,
                                              build_defines=d), 5)
              for name, d in VARIANTS.items()}
        print(f"K2 {case}: {int(class_off[-1])} depositing groups; kernel ms "
              + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()), flush=True)

    # K3 on the first column chunk of a surface frame at the lowest cut
    vis.render_mode = "surface"
    ssph = vis._sph
    ssph.set_density_cut_percentile(0.0)
    ssph.invalidate()
    ssph.render(DrawReason.EXPORT)
    sl = surface.column_chunks(vis.store.pos_smooth_presorted.shape[0], G)[0]
    main_kw, t2_kw, _, _, shape = chip_smoke.surface_chunk_calls(
        vis, sl, np.float32(ssph._density_cut_value()),
        int(ssph._giant_bucket))
    flags = main_kw["flags"]
    cases = {"main": main_kw}
    for c in range(len(za.SIZE_CLASSES)):
        cases[f"main class {c}"] = dict(
            main_kw, flags=torch.where(flags % 4 == c, flags, 0))
    cases["tier2"] = t2_kw
    keys0 = za.pack_atlas(torch.zeros(shape, device=dev))
    keys = keys0.clone()
    for case, kw in cases.items():
        rolled = kw.get("window_cols", za.WINDOW_COLS) == za.WINDOW_COLS
        _, class_off = za.deposit_plan(kw["flags"], rolled)
        ms = {name: chip_smoke.timed_from_ms(
            lambda: za.accumulate_max_packed_cuda(keys, **kw,
                                                  build_defines=d),
            lambda: keys.copy_(keys0), 5)
              for name, d in K3_VARIANTS.items()}
        print(f"K3 {case}: {int(class_off[-1])} active groups; kernel ms "
              + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
