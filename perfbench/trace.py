"""Reading a ``torch.profiler`` Chrome trace of the measured window.

The harness marks the window and each call into the program's layers with
``torch.profiler.record_function`` ranges named ``pb.<span>#<call>``
(``pb.window`` for the window).  This module gives each device operation
(kernel, copy, fill) to the innermost span its launch was made in, through
the profiler's launch-to-operation correlation ids, with no synchronise
added, and reduces the trace to:

* the device's busy time: the union of its operations' intervals inside
  the window (frozen from ``trace_summary`` of ``chip_smoke.py``);
* each span's host time and device time, per call;
* a breakdown: the device operations that took most time, and the longest
  idle gaps named by the span the host was in when each began.
"""

from __future__ import annotations

import json
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
PREFIX = "pb."


def _span_name(name: str):
    """(span, call) of a harness range ``pb.<span>#<call>``, else None."""
    if not name.startswith(PREFIX):
        return None
    body = name[len(PREFIX):]
    span, _, call = body.partition("#")
    return span, int(call) if call else -1


def merge(intervals):
    """The union of (start, end) intervals, as sorted disjoint intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def clip(intervals, lo, hi):
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if min(e, hi) > max(s, lo)]


class _Stack:
    """The harness spans of one host thread (spans of one thread nest),
    for the innermost span at each of many times."""

    def __init__(self, spans):
        self.spans = sorted(spans, key=lambda s: (s[0], -s[1]))

    def owners(self, times):
        """The innermost span containing each time, or None: one sweep."""
        order = sorted(range(len(times)), key=times.__getitem__)
        out = [None] * len(times)
        stack, i = [], 0
        for k in order:
            t = times[k]
            while i < len(self.spans) and self.spans[i][0] <= t:
                while stack and stack[-1][1] < self.spans[i][0]:
                    stack.pop()
                stack.append(self.spans[i])
                i += 1
            while stack and stack[-1][1] <= t:
                stack.pop()
            out[k] = stack[-1] if stack else None
        return out


def reduce_trace(path: str) -> dict:
    """Reduce the Chrome trace at ``path`` to the harness's readings: a
    dict with ``window_s``, ``busy_s``, ``spans`` ({span: {call: {"host_s",
    "device_s"}}}) and ``breakdown``.  Returns None when the trace has no
    window range."""
    with open(path) as f:
        events = json.load(f)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    window = None
    spans_by_tid = defaultdict(list)
    launches = {}
    device = []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        name = ev.get("name", "")
        ts, dur = float(ev.get("ts", 0.0)), float(ev.get("dur", 0.0))
        args = ev.get("args") or {}
        if cat in DEVICE_CATS:
            device.append((ts, ts + dur, name, args.get("correlation")))
        elif cat in ("cuda_runtime", "cuda_driver"):
            corr = args.get("correlation")
            if corr is not None:
                launches[corr] = (ev.get("tid"), ts)
        elif cat in ("user_annotation", "cpu_op") and name.startswith(PREFIX):
            key = _span_name(name)
            if key[0] == "window":
                window = (ts, ts + dur, ev.get("tid"))
            else:
                spans_by_tid[ev.get("tid")].append((ts, ts + dur) + key)
    if window is None:
        return None
    w0, w1, wtid = window
    stacks = {tid: _Stack(s) for tid, s in spans_by_tid.items()}
    spans = defaultdict(lambda: defaultdict(lambda: {"host_s": 0.0,
                                                     "device_s": 0.0}))
    for tid, stack in stacks.items():
        for s0, s1, span, call in stack.spans:
            if s0 >= w0 and s1 <= w1:
                spans[span][call]["host_s"] += (s1 - s0) * 1e-6
    busy_iv = []
    by_name = defaultdict(float)
    pending = defaultdict(list)
    for d0, d1, name, corr in device:
        if d1 <= w0 or d0 >= w1:
            continue
        busy_iv.append((d0, d1))
        by_name[name] += (min(d1, w1) - max(d0, w0)) * 1e-6
        launch = launches.get(corr)
        if launch is not None and launch[0] in stacks:
            pending[launch[0]].append((launch[1], d1 - d0))
    for tid, items in pending.items():
        owners = stacks[tid].owners([t for t, _ in items])
        for owner, (_, dur) in zip(owners, items):
            if owner is not None:
                spans[owner[2]][owner[3]]["device_s"] += dur * 1e-6
    busy = clip(merge(busy_iv), w0, w1)
    busy_s = sum(e - s for s, e in busy) * 1e-6
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gap_iv = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    host = stacks.get(wtid)
    names = (host.owners([a for a, _ in gap_iv]) if host is not None
             else [None] * len(gap_iv))
    gaps = [(b - a, o[2] if o else "harness")
            for (a, b), o in zip(gap_iv, names)]
    gaps.sort(reverse=True)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": busy_s,
        "spans": {k: dict(v) for k, v in spans.items()},
        "breakdown": {
            "device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, g * 1e-6] for g, n in gaps[:10]],
        },
    }
