"""The port's spans and counters (``topsy_tpu_torch/performance.py``).

With tracing off a draw records nothing and opens no range; with it on
every draw records ``topsy.render`` and ``topsy.present`` with its three
parts, numbered by the draw, and the set-up parts outside any draw.  The
launch counters live in ``performance.counters``, and
``particles_deposited`` counts the particles of the progression's blocks.
``program_spans.reduce_program`` gives each device operation of a Chrome
trace to the innermost ``topsy.`` range its launch was made in, and the
benchmark's ``perfbench/trace.reduce_trace`` reads the same with and
without those ranges.  CPU only: the kernels' own launch counts are held
on the card by ``test_torch_splat_accum.py`` / ``test_torch_splat_feed.py``.
"""

from __future__ import annotations

import inspect
import json
import os
import sys

import pytest
import torch

import topsy_tpu_torch
from topsy_tpu_torch import config, performance
from topsy_tpu_torch.canvas import OffscreenCanvas
from topsy_tpu_torch.drawreason import DrawReason
from topsy_tpu_torch.ops import splat_accum, splat_feed, zsplat_accum

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import program_spans  # noqa: E402
from perfbench import trace as pb_trace  # noqa: E402

N, RES = 4000, 64
PRESENT_PARTS = ("topsy.present.colormap", "topsy.present.readback",
                 "topsy.present.host")


@pytest.fixture(autouse=True)
def _tracing_restored():
    """Each test starts with tracing off and nothing recorded, and leaves
    the switch as it found it."""
    was = performance.set_tracing(False)
    performance.signposter.clear()
    yield
    performance.set_tracing(was)
    performance.signposter.clear()


def _port(n=N, **kw):
    v = topsy_tpu_torch.test(n, render_resolution=RES, device="cpu",
                             canvas_class=OffscreenCanvas, **kw)
    v.show_status = v.show_colorbar = v.show_scalebar = False
    return v


@pytest.fixture(scope="module")
def vis():
    return _port()


def _view(v):
    """A drag: a CHANGE draw, then REFINE draws until the view is done;
    returns the draws."""
    v.rotate(0.05, 0.0)
    v.draw(DrawReason.CHANGE)
    n = 1
    while v._sph.needs_refine():
        v.draw(DrawReason.REFINE)
        n += 1
    return n


def test_tracing_off_records_nothing_and_opens_no_range(vis):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        vis.draw(DrawReason.EXPORT)
        _view(vis)
    assert performance.signposter.intervals == []
    assert not [e.name for e in prof.events()
                if e.name.startswith("topsy.")]
    assert performance.signposter.use_interval("x") is \
        performance.signposter.use_interval("y")


def test_draws_record_nested_spans_numbered_by_draw(vis):
    performance.set_tracing(True)
    first = performance.signposter.draws + 1
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        vis.draw(DrawReason.EXPORT)
        vis.draw(DrawReason.REFINE)
        draws = 2 + _view(vis)
    ivs = performance.signposter.intervals
    assert all(iv is not None for iv in ivs)
    frames = sorted({iv.frame for iv in ivs})
    assert frames == list(range(first, first + draws))
    for f in frames:
        mine = {iv.name: (k, iv) for k, iv in enumerate(ivs)
                if iv.frame == f}
        assert {"topsy.render", "topsy.present", *PRESENT_PARTS} <= set(mine)
        render, present = mine["topsy.render"], mine["topsy.present"]
        assert render[1].parent == -1 and present[1].parent == -1
        assert render[1].end_ns <= present[1].start_ns
        for part in PRESENT_PARTS:
            iv = mine[part][1]
            assert iv.parent == present[0]
            assert present[1].start_ns <= iv.start_ns <= iv.end_ns \
                <= present[1].end_ns
        # everything else of the frame lies inside the render
        for name, (k, iv) in mine.items():
            if name.startswith(("topsy.k", "topsy.giants")):
                while ivs[k].parent >= 0:
                    k = ivs[k].parent
                assert k == render[0], name
    colormap, readback, host = (mine[p][1] for p in PRESENT_PARTS)
    assert colormap.end_ns <= readback.start_ns <= readback.end_ns \
        <= host.start_ns
    names = {e.name for e in prof.events()}
    for f in frames:
        assert f"topsy.render#{f}" in names
        assert f"topsy.present.readback#{f}" in names
    assert "topsy.k2" not in names  # every kernel call ran in a draw


def test_setup_parts_are_spans_outside_any_draw(monkeypatch):
    performance.set_tracing(True)
    monkeypatch.setattr(config, "COLUMN_MIP_FLOOR_TARGET", 1000)
    v = _port(render_mode="surface")
    v.rotate(0.05, 0.0)
    v.draw(DrawReason.CHANGE)
    ivs = performance.signposter.intervals
    outside = {iv.name for iv in ivs if iv.frame is None}
    # the surface's first render builds the presort and its mip tiers
    assert {"topsy.density_table", "topsy.autorange", "topsy.render",
            "topsy.presort", "topsy.mips"} <= outside
    # the constructor's autorange holds its first render
    auto = next(k for k, iv in enumerate(ivs)
                if iv.name == "topsy.autorange")
    assert any(iv.name == "topsy.render" and iv.parent == auto
               for iv in ivs)
    inside = {iv.name for iv in ivs if iv.frame is not None}
    assert {"topsy.render", "topsy.k3", "topsy.present",
            "topsy.filter"} <= inside
    assert not {"topsy.presort", "topsy.mips",
                "topsy.density_table"} & inside


def test_set_tracing_and_trace_restore_the_switch(tmp_path):
    assert performance.set_tracing(True) is False
    assert performance.signposter.tracing
    assert performance.set_tracing(False) is True
    with performance.trace(str(tmp_path)):
        assert performance.signposter.tracing
        with performance.signposter.use_interval("topsy.probe"):
            pass
    assert not performance.signposter.tracing
    performance.set_tracing(True)
    performance.start_trace(str(tmp_path))
    performance.stop_trace()
    assert performance.signposter.tracing
    assert [iv.name for iv in performance.signposter.intervals] == [
        "topsy.probe"]


def test_intervals_survive_clear_and_their_cap(monkeypatch):
    sp = performance.signposter
    performance.set_tracing(True)
    with sp.use_interval("topsy.a"):
        with sp.use_interval("topsy.b"):
            sp.clear()
        with sp.use_interval("topsy.c"):
            pass
    (c,) = sp.intervals
    assert c.name == "topsy.c" and c.parent == -1 and c.end_ns >= c.start_ns
    monkeypatch.setattr(performance, "MAX_INTERVALS", 2)
    for name in "def":
        with sp.use_interval(f"topsy.{name}"):
            pass
    assert [iv.name for iv in sp.intervals] == ["topsy.c", "topsy.d"]


def test_launch_counters_live_in_the_registry():
    for mod in (splat_feed, splat_accum, zsplat_accum):
        assert not hasattr(mod, "launches")
        assert not hasattr(mod, "plan_launches")
    # the kernel front ends keep their names and signatures
    for fn in (splat_feed.splat_feed, splat_accum.accumulate_groups,
               zsplat_accum.accumulate_max_packed):
        assert inspect.signature(fn) == inspect.signature(fn.__wrapped__)
        assert fn.__name__ == fn.__wrapped__.__name__


def test_particles_deposited_counts_the_blocks(monkeypatch):
    monkeypatch.setattr(config, "COLUMN_MIP_FLOOR_TARGET", 1000)
    v = _port()
    c = performance.counters
    before = c["particles_deposited"]
    v.draw(DrawReason.EXPORT)  # the presort: every particle once
    assert c["particles_deposited"] - before == v.store.n
    for _ in range(3):  # a completed view renders every particle once
        before = c["particles_deposited"]
        _view(v)
        assert c["particles_deposited"] - before == v.store.n
    assert len(v.store.ensure_column_mips()) >= 1

    # the block path: the lengths the progression hands out
    monkeypatch.setattr(config, "INTERACTIVE_USE_PRESORTED", False)
    v = _port()
    prog = v._sph.render_progression
    lengths = []
    get_block = prog.get_block

    def recording(t):
        block = get_block(t)
        if block is not None:
            lengths.extend(l for l in block[1] if l > 0)
        return block

    monkeypatch.setattr(prog, "get_block", recording)
    before = c["particles_deposited"]
    for _ in range(2):
        _view(v)
    assert lengths and c["particles_deposited"] - before == sum(lengths)


def test_particles_deposited_over_a_mesh(monkeypatch):
    """A completed view deposits every particle once over the shards."""
    from topsy_tpu_torch.parallel import make_mesh
    monkeypatch.setattr(config, "COLUMN_MIP_FLOOR_TARGET", 1000)
    v = _port(mesh=make_mesh(2, devices=["cpu"] * 2))
    c = performance.counters
    for _ in range(2):
        before = c["particles_deposited"]
        _view(v)
        assert c["particles_deposited"] - before == v.store.n
        assert v._sph.last_column_ranges  # the column path


# -- the trace's reduction -------------------------------------------------------

def _fixture(program: bool):
    """A window with a harness span ``pb.present`` around the program's
    ``topsy.present`` and its colormap part; two kernels, one launched in
    the colormap part and one after it, and idle time in both."""
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "pb.window", "ts": 0,
         "dur": 100, "tid": 1},
        {"ph": "X", "cat": "user_annotation", "name": "pb.present#0",
         "ts": 10, "dur": 60, "tid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 16, "dur": 1, "tid": 1, "args": {"correlation": 7}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 30, "dur": 1, "tid": 1, "args": {"correlation": 8}},
        {"ph": "X", "cat": "kernel", "name": "gather", "ts": 20, "dur": 10,
         "tid": 9, "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel", "name": "other", "ts": 35, "dur": 5,
         "tid": 9, "args": {"correlation": 8}},
    ]
    if program:
        ev += [
            {"ph": "X", "cat": "user_annotation", "name": "topsy.present#3",
             "ts": 11, "dur": 58, "tid": 1},
            {"ph": "X", "cat": "user_annotation",
             "name": "topsy.present.colormap#3", "ts": 12, "dur": 8,
             "tid": 1},
            {"ph": "X", "cat": "user_annotation",
             "name": "topsy.present.readback#3", "ts": 40, "dur": 20,
             "tid": 1},
        ]
    return ev


def _write(tmp_path, events, name):
    path = tmp_path / name
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


def test_benchmark_readings_ignore_program_ranges(tmp_path):
    plain = pb_trace.reduce_trace(_write(tmp_path, _fixture(False), "a"))
    both = pb_trace.reduce_trace(_write(tmp_path, _fixture(True), "b"))
    assert both == plain


def test_program_ranges_get_device_time_and_ops(tmp_path):
    ev = _fixture(True) + [
        {"ph": "X", "cat": "user_annotation", "name": program_spans.WINDOW,
         "ts": 0, "dur": 100, "tid": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::index", "ts": 13,
         "dur": 6, "tid": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::empty", "ts": 14,
         "dur": 1, "tid": 1}]
    r = program_spans.reduce_program(_write(tmp_path, ev, "t"))
    spans = r["spans"]
    assert r["frames"] == 1
    assert r["window_s"] == pytest.approx(100e-6)
    assert r["busy_s"] == pytest.approx(15e-6)
    cm = spans["topsy.present.colormap"]
    assert cm["ops"] == 1 and cm["device_s"] == pytest.approx(10e-6)
    present = spans["topsy.present"]
    assert present["ops"] == 1 and present["device_s"] == pytest.approx(5e-6)
    assert present["ops_in"] == 2
    assert present["device_in_s"] == pytest.approx(15e-6)
    assert present["host_s"] == pytest.approx(58e-6)
    assert present["self_s"] == pytest.approx(30e-6)
    assert r["device_ops"][0] == ["gather", pytest.approx(10e-6),
                                  {"topsy.present.colormap":
                                   pytest.approx(10e-6)}]
    # the gaps: [0, 20) outside, [30, 35) in present, [40, 100): its
    # readback part began it
    assert r["idle_gaps"][0] == ["topsy.present.readback",
                                 pytest.approx(60e-6)]
    assert r["idle_by_span"]["topsy.present"] == pytest.approx(5e-6)
    assert r["idle_by_span"]["-"] == pytest.approx(20e-6)
    assert r["runtime_calls"] == [["cudaLaunchKernel", pytest.approx(2e-6),
                                   {"topsy.present.colormap":
                                    pytest.approx(1e-6),
                                    "topsy.present": pytest.approx(1e-6)}]]
    # outermost operators only, by the span they ran in
    assert r["host_ops"] == [["aten::index", pytest.approx(6e-6),
                              {"topsy.present.colormap":
                               pytest.approx(6e-6)}]]


def test_setup_parts_sum_and_self():
    Iv = performance.Interval
    ivs = [Iv("topsy.autorange", None, -1, 0, 10_000_000), None,
           Iv("topsy.presort", None, 0, 1_000_000, 4_000_000),
           Iv("topsy.presort", None, -1, 20_000_000, 21_000_000)]
    got = program_spans.setup_parts(ivs)
    assert got["topsy.autorange"]["s"] == pytest.approx(0.010)
    assert got["topsy.autorange"]["self_s"] == pytest.approx(0.007)
    assert got["topsy.presort"]["s"] == pytest.approx(0.004)
