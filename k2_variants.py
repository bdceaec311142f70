"""Where kernel K2's time goes: breakdown builds of csrc/splat_accum.cu,
timed on the card at the 2^24-particle scene of chip_smoke.py.

    python3 k2_variants.py

Builds the kernel as the port builds it ("whole") and three variants with
one part switched off by ``-DK2_SKIP``: 1 the profile evaluation, 2 the
wgmma products (the accumulators then stay zero, so the flush, which skips
zero vectors, makes no reductions either), 3 the float4 flush; one nvcc
process each, all started together.  On the first piece's K2 calls, as
chip_smoke.py builds them, it prints each build's kernel time (CUDA
events, mean of 5 launches after one warm-up) for the main pass, for the
main pass with one size class alone (the other groups' flags set
inactive) and for spill tier 2.  Needs one CUDA device; exits 2 without
one.
"""

from __future__ import annotations

import subprocess
import sys
import time

VARIANTS = {"whole": (), "no_eval": ("-DK2_SKIP=1",),
            "no_product": ("-DK2_SKIP=2",), "no_flush": ("-DK2_SKIP=3",)}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("k2_variants: no CUDA device available", file=sys.stderr)
        return 2
    import chip_smoke
    from topsy_tpu_torch.ops import cuda_build, splat, splat_atlas, splat_feed
    from topsy_tpu_torch.ops import splat_accum as sa

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    t0 = time.perf_counter()
    cuda_build.build([("splat_accum", d) for d in VARIANTS.values()])
    print(f"built {len(VARIANTS)} builds in {time.perf_counter() - t0:.1f} s",
          flush=True)

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
        print(f"{case}: {int(class_off[-1])} depositing groups; kernel ms "
              + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
