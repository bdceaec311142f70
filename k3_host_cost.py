"""Host cost of one call of kernel K3 at the one-particle tier-3 shape.

    python3 k3_host_cost.py [ROOT]

Imports ``topsy_tpu_torch`` from the checkout at ROOT (default: this
script's directory), builds its K3, and on 4,096 seeded one-particle groups
(G = 1, the full class of a rolled window, 3,000 of them active, at the
surface atlas of a 1024^2 frame) prints: the host time of one call of
``accumulate_max_packed_cuda`` (perf_counter around the call, which only
enqueues; mean of 200 calls after 20 warm-up calls, the queue drained
every 20 calls) and the device time of one call (CUDA events around 200
calls).  Comparing two checkouts on one card: run it from each.  Needs one
CUDA device; exits 2 without one.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

CALLS = 200
GROUPS = 4096
ACTIVE = 3000
ATLAS = (2544, 1152)   # the atlas of a 1024^2 frame (rows, columns)


def main() -> int:
    root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1
                           else os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("k3_host_cost: no CUDA device available", file=sys.stderr)
        return 2
    from topsy_tpu_torch.ops import zsplat_accum as za
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    rng = np.random.RandomState(0)
    n = GROUPS
    w0 = (8 * rng.randint(0, (ATLAS[0] - 96) // 8, n)).astype(np.int32)
    c0 = (128 * rng.randint(0, (ATLAS[1] - 256) // 128 + 1, n)).astype(
        np.int32)
    ce = (c0 + rng.randint(0, 129, n)).astype(np.int32)
    ay = (w0 + rng.uniform(8, 88, n)).astype(np.float32)
    ax = (ce + rng.uniform(8, 120, n)).astype(np.float32)
    ih = np.where(np.arange(n) < ACTIVE, 1.0 / rng.uniform(0.71, 3.5, n),
                  -1.0).astype(np.float32)
    pay = np.stack([rng.uniform(0.2, 0.8, n), rng.uniform(1e-3, 3e-2, n),
                    rng.normal(0, 1, n)], 1).astype(np.float32)[:, :, None]
    flags = np.where(ih > 0, 4 * za.FLAG_ACTIVE + za.FULL_CLASS, 0).astype(
        np.int32)
    kw = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in
          dict(ay_g=ay.reshape(n, 1, 1), ax_g=ax.reshape(n, 1, 1),
               ih_g=ih.reshape(n, 1, 1), pay_g=pay, w0=w0, c0=c0, ce=ce,
               flags=flags).items()}
    keys = torch.zeros(ATLAS, dtype=torch.int64, device=dev)

    def call():
        za.accumulate_max_packed_cuda(keys, **kw, group=1, window_rows=96)

    for _ in range(20):
        call()
    torch.cuda.synchronize()
    host = 0.0
    for i in range(CALLS):
        t0 = time.perf_counter()
        call()
        host += time.perf_counter() - t0
        if i % 20 == 19:
            torch.cuda.synchronize()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(CALLS):
        call()
    end.record()
    torch.cuda.synchronize()
    print(f"k3_host_cost {root}: card {card}; tier-3 shape ({n} groups of 1, "
          f"{ACTIVE} active): host {host / CALLS * 1e3:.4f} ms per call, "
          f"device {start.elapsed_time(end) / CALLS:.4f} ms per call",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
