"""Where a cell's time goes by the port's own spans, and what tracing costs.

    python3 program_spans.py --workload <cell> --seed <n> --seconds <s>
    python3 program_spans.py --workload <cell> --seed <n> --seconds <s> \\
        --overhead <rounds>

Drives one cell of ``BENCHMARK.json`` as ``perfbench/run.py`` does (the
same snapshot, Visualizer, traffic and warm-up) with the port's tracing
(``performance.set_tracing``) on from the start, and prints one JSON line:

* ``setup``: seconds from the start to the window, per ``topsy.``
  interval of set-up (``topsy.kernels.load``, ``topsy.presort``,
  ``topsy.mips``, ``topsy.density_table``, ``topsy.autorange``,
  ``topsy.bands``, ...) its total and self seconds (self: less the
  intervals inside it), and ``counters``, ``performance.counters`` at the
  window's start (``band_bytes_uploaded``: 0 where the bands were
  adopted);
* ``setup_bands_s``: the ``topsy.bands`` total of set-up (the bands
  adopted or uploaded, and their presorted gather), None where no mode
  read them;
* ``window``: a ``torch.profiler`` trace of ``--seconds`` of the traffic
  (``performance.start_trace``) reduced by ``reduce_program``: per span a
  frame's host ms, self ms, device ms and device operations, each device
  operation given to the innermost span its launch was made in; the
  largest device operations with the spans that launched them; the idle
  gaps of the card summed by the span the host was in as each began;
* ``steps``, ``draws`` and ``counters``: the window's traffic steps, its
  ``Visualizer.draw`` calls and the changes of ``performance.counters``.

``--setup-trace`` also traces set-up with the profiler and reduces it the
same way (``setup.trace``).  ``--ab B`` instead times each step of the
traffic, untraced, in B pairs of blocks with the port's tracing off and
on, and one interval's host cost off, on and under the profiler.
``--overhead R`` instead runs the cell through ``perfbench.harness.run_cell``
R times in each of four ways, in turns: untraced and traced (the harness's
``pb.`` spans under the profiler), each with the port's tracing off and on,
and prints each run's metrics.  Needs one CUDA device; exits 2 without
one.  The JSON line is also written to
``build/program_spans/<cell>.<seed>[.overhead|.ab].json``.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402
import sys  # noqa: E402
from collections import defaultdict  # noqa: E402

ROOT = os.path.dirname(os.path.abspath(__file__))
WINDOW = "program_spans.window"
_NAME = re.compile(r"^(topsy\.[^#]*)(?:#(\d+))?$")


def _intervals_by_tid(events):
    """{tid: [(start, end, name, frame)]} of the ``topsy.`` ranges."""
    out = defaultdict(list)
    for ev in events:
        if (ev.get("ph") == "X" and ev.get("cat") in ("user_annotation",
                                                      "cpu_op")):
            m = _NAME.match(ev.get("name", ""))
            if m:
                ts = float(ev["ts"])
                out[ev.get("tid")].append(
                    (ts, ts + float(ev.get("dur", 0.0)), m.group(1),
                     int(m.group(2)) if m.group(2) else None))
    return out


def _nest(spans):
    """(each span's duration less its children's, the index of the span
    it lies in or -1), in the order of ``spans`` (spans of one thread
    nest)."""
    order = sorted(range(len(spans)),
                   key=lambda k: (spans[k][0], -spans[k][1]))
    own = [s[1] - s[0] for s in spans]
    parent = [-1] * len(spans)
    stack = []
    for k in order:
        s0, s1 = spans[k][:2]
        while stack and spans[stack[-1]][1] <= s0:
            stack.pop()
        if stack:
            own[stack[-1]] -= s1 - s0
            parent[k] = stack[-1]
        stack.append(k)
    return own, parent


def reduce_program(path: str) -> dict:
    """Reduce the Chrome trace at ``path`` by the port's ``topsy.`` spans.

    The window is the ``program_spans.window`` range, else the whole
    trace's device operations.  Returns ``{"window_s", "busy_s", "frames",
    "spans": {span: {"calls", "host_s", "self_s", "device_s", "ops",
    "device_in_s", "ops_in"}}, "device_ops": [[op, s, {span: s}]],
    "idle_by_span": {span: s}, "idle_gaps": [[span, s]], "runtime_calls":
    [[call, s, {span: s}]], "host_ops": [[op, s, {span: s}]]}`` (the
    host's CUDA runtime and driver calls, where it waits on the card, and
    its outermost PyTorch operators, by the span each was made in).  A
    device
    operation counts in ``device_s`` / ``ops`` of the innermost span its
    launch was made in and in ``device_in_s`` / ``ops_in`` of that span
    and every span around it; one launched outside every span goes to
    ``"-"``."""
    from perfbench.trace import DEVICE_CATS, _Stack, clip, merge
    with open(path) as f:
        events = json.load(f)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    window, launches, device, runtime = None, {}, [], []
    host_ops = defaultdict(list)
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        ts, dur = float(ev.get("ts", 0.0)), float(ev.get("dur", 0.0))
        corr = (ev.get("args") or {}).get("correlation")
        if cat in DEVICE_CATS:
            device.append((ts, ts + dur, name, corr))
        elif cat in ("cuda_runtime", "cuda_driver"):
            runtime.append((ev.get("tid"), ts, dur, name))
            if corr is not None:
                launches[corr] = (ev.get("tid"), ts)
        elif name == WINDOW:
            window = (ts, ts + dur, ev.get("tid"))
        elif cat == "cpu_op" and not _NAME.match(name):
            host_ops[ev.get("tid")].append((ts, ts + dur, name))
    by_tid = _intervals_by_tid(events)
    if window is None:
        ends = [x for d in device for x in d[:2]]
        if not ends:
            return None
        main = max(by_tid, key=lambda t: len(by_tid[t]), default=None)
        window = (min(ends), max(ends), main)
    w0, w1, wtid = window
    spans = defaultdict(lambda: {"calls": 0, "host_s": 0.0, "self_s": 0.0,
                                 "device_s": 0.0, "ops": 0,
                                 "device_in_s": 0.0, "ops_in": 0})
    frames, index, parents = set(), {}, {}
    for tid, ivs in by_tid.items():
        own, parents[tid] = _nest(ivs)
        for k, iv in enumerate(ivs):
            index[tid, iv] = k
            if iv[0] >= w0 and iv[1] <= w1:
                sp = spans[iv[2]]
                sp["calls"] += 1
                sp["host_s"] += (iv[1] - iv[0]) * 1e-6
                sp["self_s"] += own[k] * 1e-6
                if iv[3] is not None:
                    frames.add(iv[3])
    stacks = {tid: _Stack(ivs) for tid, ivs in by_tid.items()}
    pending = defaultdict(list)
    busy_iv, op_time = [], defaultdict(lambda: defaultdict(float))
    for d0, d1, name, corr in device:
        if d1 <= w0 or d0 >= w1:
            continue
        busy_iv.append((d0, d1))
        launch = launches.get(corr)
        if launch is not None and launch[0] in stacks:
            pending[launch[0]].append((launch[1], d1 - d0, name))
        else:
            op_time[name]["-"] += (d1 - d0) * 1e-6
    for tid, items in pending.items():
        owners = stacks[tid].owners([t for t, _, _ in items])
        ivs, up = by_tid[tid], parents[tid]
        for owner, (_, dur, name) in zip(owners, items):
            op_time[name][owner[2] if owner else "-"] += dur * 1e-6
            if owner is None:
                continue
            spans[owner[2]]["device_s"] += dur * 1e-6
            spans[owner[2]]["ops"] += 1
            k, seen = index[tid, owner], set()
            while k >= 0:
                if ivs[k][2] not in seen:
                    seen.add(ivs[k][2])
                    spans[ivs[k][2]]["device_in_s"] += dur * 1e-6
                    spans[ivs[k][2]]["ops_in"] += 1
                k = up[k]
    calls = defaultdict(lambda: defaultdict(float))
    runtime = [r for r in runtime if w0 <= r[1] < w1]
    for tid in {r[0] for r in runtime}:
        mine = [r for r in runtime if r[0] == tid]
        owners = (stacks[tid].owners([r[1] for r in mine]) if tid in stacks
                  else [None] * len(mine))
        for owner, (_, _, dur, name) in zip(owners, mine):
            calls[name][owner[2] if owner else "-"] += dur * 1e-6
    aten = defaultdict(lambda: defaultdict(float))
    for tid, ops in host_ops.items():
        ops = [o for o in ops if w0 <= o[0] < w1]
        top_ops = [o for o, up in zip(ops, _nest(ops)[1]) if up < 0]
        owners = (stacks[tid].owners([o[0] for o in top_ops])
                  if tid in stacks else [None] * len(top_ops))
        for owner, (o0, o1, name) in zip(owners, top_ops):
            aten[name][owner[2] if owner else "-"] += (o1 - o0) * 1e-6
    busy = clip(merge(busy_iv), w0, w1)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    host = stacks.get(wtid)
    names = (host.owners([a for a, _ in gaps]) if host is not None
             else [None] * len(gaps))
    idle = defaultdict(float)
    named = []
    for (a, b), o in zip(gaps, names):
        span = o[2] if o is not None else "-"
        idle[span] += (b - a) * 1e-6
        named.append([span, (b - a) * 1e-6])
    named.sort(key=lambda g: -g[1])
    def top(by_name):
        return [[n, sum(by.values()), dict(by)] for n, by in sorted(
            by_name.items(), key=lambda kv: -sum(kv[1].values()))[:10]]

    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": sum(e - s for s, e in busy) * 1e-6,
        "frames": len(frames),
        "spans": {k: dict(v) for k, v in sorted(spans.items())},
        "device_ops": top(op_time),
        "idle_by_span": dict(sorted(idle.items(), key=lambda kv: -kv[1])),
        "idle_gaps": named[:10],
        "runtime_calls": top(calls),
        "host_ops": top(aten),
    }


def setup_parts(intervals) -> dict:
    """{name: {"s", "self_s"}} over ``signposter.intervals`` (self: less
    the intervals inside it); open intervals (None) are left out."""
    out = defaultdict(lambda: {"s": 0.0, "self_s": 0.0})
    for iv in intervals:
        if iv is None:
            continue
        out[iv.name]["s"] += iv.seconds
        out[iv.name]["self_s"] += iv.seconds
        parent = intervals[iv.parent] if iv.parent >= 0 else None
        if parent is not None:
            out[parent.name]["self_s"] -= iv.seconds
    return {k: dict(v) for k, v in sorted(out.items())}


def _cell(workload: str):
    """(BENCHMARK.json, the cell's configuration, its traffic file)."""
    from perfbench import harness
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(os.path.join(ROOT, entry["file"])) as f:
        config = json.load(f)
    return bench, config, harness.load_json("traffic",
                                            f"{cell['traffic']}.json")


def _drive(workload: str, seed: int, device, scale_down):
    """The cell's Visualizer as ``perfbench/run.py`` builds it, warmed up,
    and its ``step(i)``: the i-th step of its traffic."""
    import torch
    from perfbench import check, harness, traffic
    from topsy_tpu_torch.drawreason import DrawReason
    _, config, params = _cell(workload)
    config = config | (scale_down or {})
    plan = traffic.Traffic(params, seed)
    snap = check.snapshot(config, seed, device)
    vis = harness.build(config, seed, device, snap)
    vis.rotate(plan.start_turn, 0.0)
    del snap

    def step(i):
        s = plan.step(i)
        if s.scale is not None:
            vis.scale = s.scale
        vis.rotate(*s.rotate)
        if plan.draw == "export":
            vis.draw(DrawReason.EXPORT)
            return
        vis.draw(DrawReason.CHANGE)
        while vis._sph.needs_refine():
            vis.draw(DrawReason.REFINE)

    for i in range(plan.warmup_steps):
        step(i)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return vis, plan, step


def breakdown(workload: str, seed: int, seconds: float, device="cuda",
              scale_down=None, setup_trace=False) -> dict:
    """Set-up parts and the traced window of one cell (module docstring);
    ``scale_down``: overrides of the configuration's sizes (CPU tests);
    ``setup_trace``: set-up under the profiler too, reduced as the window
    is (its times then include the profiler's cost)."""
    import torch
    from topsy_tpu_torch import performance
    performance.set_tracing(True)
    log_dir = os.path.join(ROOT, "build", "program_spans")
    if setup_trace:
        performance.start_trace(log_dir)
    vis, plan, step = _drive(workload, seed, device, scale_down)
    parts = setup_parts(performance.signposter.intervals)
    setup = {"s": time.perf_counter() - T_START, "parts": parts,
             "counters": dict(performance.counters)}
    if setup_trace:
        performance.stop_trace()
        setup["trace"] = reduce_program(performance.trace_file(log_dir))
    performance.signposter.clear()
    performance.start_trace(log_dir)
    c0 = dict(performance.counters)
    d0 = performance.signposter.draws
    steps, t0 = 0, time.perf_counter()
    with torch.profiler.record_function(WINDOW):
        while time.perf_counter() - t0 < seconds:
            step(plan.warmup_steps + steps)
            steps += 1
    performance.stop_trace()
    counts = {k: v - c0.get(k, 0) for k, v in performance.counters.items()}
    window = reduce_program(performance.trace_file(log_dir))
    os.remove(performance.trace_file(log_dir))
    return {"setup": setup,
            "setup_bands_s": parts.get("topsy.bands", {}).get("s"),
            "steps": steps,
            "draws": performance.signposter.draws - d0, "counters": counts,
            "window": window}


def interval_ns(n: int = 20000) -> float:
    """Host ns of one empty ``topsy.`` interval at the current setting."""
    from topsy_tpu_torch import performance
    use = performance.signposter.use_interval
    t0 = time.perf_counter_ns()
    for _ in range(n):
        with use("topsy.probe"):
            pass
    out = (time.perf_counter_ns() - t0) / n
    performance.signposter.clear()
    return out


def ab(workload: str, seed: int, blocks: int, block_steps: int = 5,
       device="cuda", scale_down=None) -> dict:
    """In one process, untraced: each step's host seconds in ``blocks``
    pairs of blocks of ``block_steps`` steps, the port's tracing off in
    one block and on in the other (which goes first alternates), the
    intervals a frame, and one interval's cost off, on, and on while a
    profiler records."""
    import statistics
    import torch
    from topsy_tpu_torch import performance
    vis, plan, step = _drive(workload, seed, device, scale_down)
    times = {False: [], True: []}
    frames = {False: 0, True: 0}
    intervals = 0
    i = plan.warmup_steps
    for b in range(blocks):
        for on in ((False, True) if b % 2 == 0 else (True, False)):
            performance.set_tracing(on)
            performance.signposter.clear()
            d0 = performance.signposter.draws
            for _ in range(block_steps):
                t0 = time.perf_counter()
                step(i)
                times[on].append(time.perf_counter() - t0)
                i += 1
            frames[on] += performance.signposter.draws - d0
            intervals += len(performance.signposter.intervals) if on else 0
    cost = {}
    for name, on in (("off", False), ("on", True)):
        performance.set_tracing(on)
        cost[name] = interval_ns()
    with performance.trace(os.path.join(ROOT, "build", "program_spans")):
        cost["on_under_profiler"] = interval_ns()
    performance.set_tracing(False)
    del vis
    return {"step_s": {k: statistics.median(v) for k, v in
                       (("off", times[False]), ("on", times[True]))},
            "steps": len(times[False]), "frames_per_step": {
                "off": frames[False] / len(times[False]),
                "on": frames[True] / len(times[True])},
            "intervals_per_frame": intervals / max(frames[True], 1),
            "interval_ns": cost, "all_step_s": {
                "off": times[False], "on": times[True]}}


def overhead(workload: str, seed: int, seconds: float, rounds: int,
             device="cuda", scale_down=None) -> list:
    """The cell's metrics in ``rounds`` turns of (untraced, traced) x (the
    port's tracing off, on), each a ``harness.run_cell``."""
    from perfbench import harness
    from topsy_tpu_torch import performance
    bench = _cell(workload)[0]
    out = []
    for r in range(rounds):
        for traced in (False, True):
            for on in ((False, True) if r % 2 == 0 else (True, False)):
                performance.set_tracing(on)
                performance.signposter.clear()
                res = harness.run_cell(bench, workload, seed + r, seconds,
                                       traced, device=device,
                                       scale_down=scale_down)
                out.append({"round": r, "traced": traced, "program": on,
                            "correct": res["correct"],
                            "metrics": harness.metrics_for(
                                bench, workload, res["ctx"], traced)})
    performance.set_tracing(False)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--overhead", type=int, default=0)
    ap.add_argument("--setup-trace", action="store_true")
    ap.add_argument("--ab", type=int, default=0)
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import subprocess
    import torch
    if not torch.cuda.is_available():
        print("program_spans: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[:1]
    result = {"workload": args.workload, "seed": args.seed, "card": card}
    if args.overhead:
        result["runs"] = overhead(args.workload, args.seed, args.seconds,
                                  args.overhead)
    elif args.ab:
        result["ab"] = ab(args.workload, args.seed, args.ab)
    else:
        result.update(breakdown(args.workload, args.seed, args.seconds,
                                setup_trace=args.setup_trace))
    line = json.dumps(result)
    out_dir = os.path.join(ROOT, "build", "program_spans")
    os.makedirs(out_dir, exist_ok=True)
    tag = ".overhead" if args.overhead else ".ab" if args.ab else ""
    with open(os.path.join(out_dir, f"{args.workload}.{args.seed}{tag}.json"),
              "w") as f:
        f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
