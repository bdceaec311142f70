"""Run one cell of the port's benchmark once and print its result.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout on a machine with the card(s) the cell
asks for.  The cell, its configuration and its traffic are found by name
through ``BENCHMARK.json`` at the root.  The last line of standard output
is one JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` also ``breakdown``, and last ``checks``:
each number the check compared beside its limit); the same numbers end
standard error.  With no card, too few cards, or a module of JAX or of the
JAX package loaded once the window has closed, it prints no result and
exits with a code other than 0.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "topsy_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell = next((w for w in bench["workloads"] if w["name"] == args.workload),
                None)
    if cell is None:
        print(f"run.py: no workload {args.workload!r}", file=sys.stderr)
        return 2

    import torch
    if not torch.cuda.is_available():
        print("run.py: no CUDA device", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell["chips"]:
        print(f"run.py: the cell needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 3

    from perfbench import harness, readers
    out = harness.run_cell(bench, args.workload, args.seed, args.seconds,
                           bool(args.trace), device="cuda", t_start=T_START)
    ctx = out["ctx"]
    bad = forbidden_modules()
    if bad:
        print(f"run.py: JAX or the JAX package is loaded: {bad}",
              file=sys.stderr)
        return 4
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"],
              "memory_peak_bytes": int(out["memory_peak_bytes"])}
    result = {"correct": out["correct"], "attempted": out["attempted"],
              "failed": out["failed"],
              "metrics": harness.metrics_for(bench, args.workload, ctx,
                                             bool(args.trace)),
              "device": device}
    if args.trace:
        tr = ctx.get("trace")
        if tr is None or tr["busy_s"] <= 0:
            print("run.py: the trace holds no device operation",
                  file=sys.stderr)
            return 5
        device["busy_s"] = tr["busy_s"]
        device["window_s"] = tr["window_s"]
        result["breakdown"] = tr["breakdown"]
    result["checks"] = out["checks"]
    lat = [x[-1] * 1e3 for x in ctx["latencies"]]
    q = [readers.percentile(lat, p) for p in (10, 50, 90)]
    thirds = [readers.percentile(lat[k * len(lat) // 3:
                                     (k + 1) * len(lat) // 3], 50)
              for k in range(3)]
    print(f"window: {ctx['steps']} steps, {readers.frames(ctx)} frames in "
          f"{ctx['window_s']:.3f} s; a step's last frame p10/p50/p90 "
          f"{q[0]:.3f} / {q[1]:.3f} / {q[2]:.3f} ms, median by thirds "
          f"{' / '.join(f'{t:.3f}' for t in thirds)} ms", file=sys.stderr)
    print(f"colormap range (vmin, vmax, log): {out['ranges']}",
          file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(f"check answers: {out['checked']} checked, {out['failed']} "
          f"outside a limit", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
