"""Arithmetic shared by the metric readers (``end_to_end/*.py``,
``metrics/*.py``).  Each reader's ``read(ctx)`` returns a number or None;
``ctx`` is the run's record: ``draw`` ("export" or "view"), ``steps``,
``window_s``, ``setup_s``, ``latencies`` (per step, the seconds from the
view change to each of its frames in host memory) and, in a traced run,
``trace`` (``trace.reduce_trace``) and ``work`` ({span: [(call, least
seconds)]})."""

from __future__ import annotations


def percentile(values, q: float):
    """The q-th percentile by linear interpolation between closest ranks
    (numpy's default), over all the values."""
    xs = sorted(values)
    if not xs:
        return None
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def frames(ctx) -> int:
    return sum(len(lat) for lat in ctx["latencies"])


def window_ms_per_frame(ctx):
    """The window's time over the frames it completed, in ms."""
    n = frames(ctx)
    return ctx["window_s"] / n * 1e3 if n else None


def view_tail_ms(ctx, q: float, first_frame: bool):
    """The q-th percentile over all views of the time from the view change
    to its first frame (``first_frame``) or to its last, in ms."""
    if ctx["draw"] != "view":
        return None
    return percentile([lat[0 if first_frame else -1] * 1e3
                       for lat in ctx["latencies"]], q)


def span_calls(ctx, span: str):
    tr = ctx.get("trace")
    if tr is None:
        return None
    return tr["spans"].get(span)


def host_ms_per_frame(ctx, span: str):
    """Host time inside ``span`` per frame of the traced window, in ms."""
    calls = span_calls(ctx, span)
    if not calls:
        return None
    return sum(c["host_s"] for c in calls.values()) / frames(ctx) * 1e3


def device_ms_per_frame(ctx, span: str):
    """Device time of the operations launched inside ``span`` per frame of
    the traced window, in ms; None when no operation was."""
    calls = span_calls(ctx, span)
    if not calls:
        return None
    total = sum(c["device_s"] for c in calls.values())
    return total / frames(ctx) * 1e3 if total > 0 else None


def roofline_pct(ctx, span: str):
    """Over the kept calls of ``span`` that ran on the device: the sum of
    their least times over the sum of their device times, in %."""
    calls = span_calls(ctx, span)
    kept = (ctx.get("work") or {}).get(span)
    if not calls or not kept:
        return None
    bound = dev = 0.0
    for call, least in kept:
        c = calls.get(call)
        if c is not None and c["device_s"] > 0:
            bound += least
            dev += c["device_s"]
    return 100.0 * bound / dev if dev > 0 else None


def idle_pct(ctx):
    """The share of the traced window in which the device ran nothing."""
    tr = ctx.get("trace")
    if tr is None or tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
