"""The control of the check: the reference put in the program's place and
computed in bfloat16, the precision below the float32 the configurations
state.  It must come out as not correct.

    python3 perfbench/control.py --workload <cell> --seeds <n> [<n> ...]

For each seed it renders, in bfloat16 and in float32, the views of the
first answers the cell's traffic asks for after its warm-up (as many as a
run checks), ranges the colormap at the starting view in each precision,
all through the configuration's check module (``check.module``), and
prints one JSON line: the cell, the seed, each number of the check
(the worst over the views) beside its limit, and whether the limits pass.
The benchmark's runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from perfbench import check, traffic  # noqa: E402
from perfbench.harness import load_json  # noqa: E402


def camera(rotation, scale):
    return {"rotation": rotation, "offset": np.zeros(3), "scale": scale}


def _x_rot(a):
    return np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                     [-np.sin(a), 0, np.cos(a)]])


def _y_rot(a):
    return np.array([[1, 0, 0], [0, np.cos(a), -np.sin(a)],
                     [0, np.sin(a), np.cos(a)]])


def traffic_views(config: dict, plan: traffic.Traffic):
    """(the starting view, the views of the first ``samples`` steps after
    the warm-up), the camera moved as ``Visualizer.rotate`` and ``scale``
    move it."""
    rot = np.eye(3)
    scale = config["scale"]
    setup = camera(rot.copy(), scale)
    rot = _x_rot(plan.start_turn) @ rot
    views = []
    for i in range(plan.warmup_steps + plan.samples):
        step = plan.step(i)
        if step.scale is not None:
            scale = step.scale
        rot = _x_rot(step.rotate[0]) @ _y_rot(step.rotate[1]) @ rot
        if i >= plan.warmup_steps:
            views.append(camera(rot.copy(), scale))
    return setup, views


def control(bench: dict, workload: str, seed: int, device,
            scale_down=None) -> dict:
    """The control's numbers for one seed, each the worst over the views."""
    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(os.path.join(ROOT, entry["file"])) as f:
        config = json.load(f)
    if scale_down:
        config = config | scale_down
    plan = traffic.Traffic(load_json("traffic", f"{cell['traffic']}.json"),
                           seed)
    setup, views = traffic_views(config, plan)
    judge = check.module(config)
    low = judge.Reference(config, seed, device, setup, dtype=torch.bfloat16)
    ref = judge.Reference(config, seed, device, setup)
    worst = {}
    for view in views:
        raw_low, raw = low.raw(view), ref.raw(view)
        got = judge.compare(raw_low.float(), raw, low.frame(raw_low),
                            ref.frame(raw))
        for k, v in got.items():
            worst[k] = max(worst.get(k, -np.inf), v)
    return {"workload": workload, "seed": seed, "numbers": worst,
            "checks": {k: {"value": worst[k], "limit": lim}
                       for k, lim in config["limits"].items()},
            "passes": check.within(worst, config["limits"])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    if not torch.cuda.is_available():
        print("control.py: no CUDA device", file=sys.stderr)
        return 3
    for seed in args.seeds:
        print(json.dumps(control(bench, args.workload, seed, "cuda")),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
