"""CPU tests of the benchmark's harness: names resolve, the tail and rate
arithmetic, the work counts against a walk, and what the chip path and the
reference import.  Run from the repository root:

    python -m pytest perfbench -q
"""

from __future__ import annotations

import ast
import importlib
import json
import os
import statistics
import subprocess
import sys

import pytest
import torch

from perfbench import check, control, harness, readers, trace, traffic, work

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "perfbench")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_every_name_resolves():
    b = bench()
    names = {c["name"] for c in b["configs"]}
    for c in b["configs"]:
        cfg = json.load(open(os.path.join(ROOT, c["file"])))
        assert cfg["name"] == c["name"]
        assert cfg["limits"]
        for kind, key in (("snapshots", "snapshot"), ("checks", "check")):
            assert os.path.isfile(os.path.join(HERE, kind, f"{cfg[key]}.py"))
        assert callable(check.named("snapshots", cfg["snapshot"]).make)
        judge = check.module(cfg)
        assert callable(judge.Reference) and callable(judge.compare)
    for w in b["workloads"]:
        assert w["config"] in names
        plan = traffic.Traffic(harness.load_json("traffic",
                                                 f"{w['traffic']}.json"), 7)
        assert plan.samples > 0
    for m in b["end_to_end"]:
        assert callable(harness.load_reader("end_to_end", m["name"]))
    for m in b["per_layer"]:
        assert callable(harness.load_reader("metrics", m["name"]))
        for w in m.get("workloads", []):
            assert w in {x["name"] for x in b["workloads"]}


def test_every_span_target_exists():
    for name in harness.span_names():
        spec = harness.load_json("spans", f"{name}.json")
        for target in spec["targets"]:
            mod, _, path = target.partition(":")
            owner = importlib.import_module(mod)
            for part in path.split("."):
                owner = getattr(owner, part)
            assert callable(owner), target
        if "work" in spec:
            assert callable(getattr(work, spec["work"]))


def test_spans_wrap_and_unwrap():
    from topsy_tpu_torch.visualizer import VisualizerBase
    before = VisualizerBase.__dict__["render_sph"]
    spans = harness.Spans(["enqueue"])
    spans.install()
    assert VisualizerBase.__dict__["render_sph"] is not before
    spans.remove()
    assert VisualizerBase.__dict__["render_sph"] is before


def _sampled_calls(seed, n):
    """The calls of span ``k2`` kept when ``n`` calls are made."""
    spans = harness.Spans(["k2"], seed=seed)
    wrapped = spans._wrap("k2", lambda i: i)
    for i in range(n):
        wrapped(i)
    return [c for c, _, _ in spans.sampled("k2")]


def test_span_sample_is_drawn_from_the_whole_window():
    calls = _sampled_calls(11, 1000)
    assert len(calls) == harness.load_json("spans", "k2.json")["sample_calls"]
    assert calls == sorted(calls) and max(calls) >= 500
    assert calls == _sampled_calls(11, 1000)
    assert calls != _sampled_calls(12, 1000)


def test_zoom_sweep_reaches_its_ends():
    params = {"draw": "view", "zoom": {"factor": 1.25, "min": 50.0,
                                       "max": 250.0}}
    for seed in (1, 2, 3):
        plan = traffic.Traffic(params, seed)
        scales = [plan.step(i).scale for i in range(40)]
        assert min(scales) == pytest.approx(50.0)
        assert max(scales) == pytest.approx(250.0)
        assert all(1.0 < max(a, b) / min(a, b) <= 1.25 + 1e-9
                   for a, b in zip(scales, scales[1:]))


def _ctx(latencies, window_s):
    return {"draw": "view", "steps": len(latencies), "window_s": window_s,
            "setup_s": 1.0, "latencies": latencies}


def test_tail_over_all_views_sees_a_stall():
    # 100 views of 0.1 s; a stall makes 12 consecutive views 1 s each
    quiet = [[0.05, 0.1]] * 100
    stalled = [[0.05, 0.1]] * 88 + [[0.5, 1.0]] * 12
    assert readers.view_tail_ms(_ctx(quiet, 10.0), 90.0, False) == \
        pytest.approx(100.0)
    assert readers.view_tail_ms(_ctx(stalled, 20.8), 90.0, False) == \
        pytest.approx(1000.0)
    # a median of per-chunk p90s does not see it
    chunks = [stalled[i:i + 10] for i in range(0, 100, 10)]
    med = statistics.median(readers.percentile([v[-1] for v in c], 90)
                            for c in chunks)
    assert med == pytest.approx(0.1)
    assert readers.view_tail_ms(_ctx(stalled, 20.8), 90.0, True) == \
        pytest.approx(500.0)


def test_percentile_is_numpys_linear():
    import numpy as np
    xs = [3.0, 1.0, 4.0, 1.0, 5.0, 9.0, 2.0, 6.0]
    for q in (0, 10, 50, 90, 100):
        assert readers.percentile(xs, q) == pytest.approx(np.percentile(xs, q))


def test_window_rate_counts_every_frame():
    ctx = {"draw": "export", "steps": 4, "window_s": 2.0, "setup_s": 1.0,
           "latencies": [[0.5]] * 4}
    assert readers.window_ms_per_frame(ctx) == pytest.approx(500.0)
    ctx["latencies"] = [[0.1, 0.4]] * 4
    assert readers.window_ms_per_frame(ctx) == pytest.approx(250.0)


def _k2_walk(ay, ax, ih, coef, rows, cols):
    """(bf16 operations, float32 operations) by a walk over particles and
    atlas lines."""
    bf16 = f32 = 0
    C = coef.shape[0]
    for i in range(ay.numel()):
        if not bool((coef[:, i] != 0).any()):
            continue
        hat = float(ih[i]) < 0

        def covered(p, limit):
            n = 0
            for line in range(limit):
                d = line - float(p)
                if hat:
                    n += abs(d) < 1.0
                else:
                    n += (d * d * float(ih[i]) ** 2 < 4.0) and -8 < d <= 8
            return n

        ly, lx = covered(ay[i], rows), covered(ax[i], cols)
        bf16 += 2 * C * (1 if hat else 2) * ly * lx
        f32 += (3 if hat else 24) * (ly + lx)
    return bf16, f32


def test_k2_work_against_a_walk():
    g = torch.Generator().manual_seed(3)
    n, G, C, rows, cols = 4, 8, 2, 48, 40
    ay = torch.rand(n * G, generator=g) * 50 - 2
    ax = torch.rand(n * G, generator=g) * 44 - 2
    ih = 1.0 / (torch.rand(n * G, generator=g) * 5 + 0.3)
    ih[::5] = -1.0
    coef = torch.rand(C, n * G, generator=g)
    coef[:, ::7] = 0.0
    kw = dict(C=C, group=G, atlas_rows=rows, atlas_cols=cols)
    w0 = torch.zeros(n, dtype=torch.int32)
    bf16, f32 = _k2_walk(ay, ax, ih, coef, rows, cols)
    nbytes = n * G * (3 + C) * 4 + n * 16 + 2 * C * rows * cols * 4
    got = work.k2_counts((ay, ax, ih, coef, w0), kw)
    assert got == pytest.approx((nbytes, f32, bf16))
    assert bf16 > 0 and f32 > 0
    assert work.k2_call((ay, ax, ih, coef, w0), kw) == \
        pytest.approx(work.bound_s(nbytes, f32, bf16))


def test_k3_work_against_a_walk():
    g = torch.Generator().manual_seed(5)
    n, G, rows, cols = 3, 4, 30, 36
    ay = torch.rand(n * G, generator=g) * 34 - 2
    ax = torch.rand(n * G, generator=g) * 40 - 2
    ih = 1.0 / (torch.rand(n * G, generator=g) * 4 + 0.3)
    ih[::3] = -1.0
    flags = torch.tensor([4 * work.K3_FLAG_ACTIVE + 3, 0,
                          4 * work.K3_FLAG_ACTIVE], dtype=torch.int32)
    keys = torch.zeros((rows, cols), dtype=torch.int64)
    lines = frags = hits = 0
    hit_px = set()
    for i in range(n * G):
        if int(flags[i // G]) // 4 != work.K3_FLAG_ACTIVE or float(ih[i]) <= 0:
            continue
        ys = [y for y in range(rows) if -8 < y - float(ay[i]) <= 8]
        xs = [x for x in range(cols) if -8 < x - float(ax[i]) <= 8]
        lines += len(ys) + len(xs)
        frags += len(ys) * len(xs)
        for y in ys:
            for x in xs:
                t = 4.0 - ((y - float(ay[i])) ** 2 + (x - float(ax[i])) ** 2) \
                    * float(ih[i]) ** 2
                if t > 0:
                    hits += 1
                    hit_px.add((y, x))
    ops = 2 * lines + 4 * frags + 4 * hits
    nbytes = n * 4 + 2 * (G * 6 * 4 + 3 * 4) + len(hit_px) * 16
    got = work.k3_counts((keys,), dict(ay_g=ay, ax_g=ax, ih_g=ih,
                                       flags=flags, group=G))
    assert got == pytest.approx((nbytes, ops))
    assert hits > 0


def test_trace_gives_device_time_to_the_innermost_span(tmp_path):
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "pb.window", "ts": 0,
         "dur": 100, "tid": 1},
        {"ph": "X", "cat": "user_annotation", "name": "pb.enqueue#0",
         "ts": 10, "dur": 30, "tid": 1},
        {"ph": "X", "cat": "user_annotation", "name": "pb.k2#0", "ts": 15,
         "dur": 5, "tid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 16, "dur": 1, "tid": 1, "args": {"correlation": 7}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 30, "dur": 1, "tid": 1, "args": {"correlation": 8}},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 20, "dur": 10,
         "tid": 9, "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel", "name": "other", "ts": 35, "dur": 5,
         "tid": 9, "args": {"correlation": 8}},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    r = trace.reduce_trace(str(path))
    assert r["window_s"] == pytest.approx(100e-6)
    assert r["busy_s"] == pytest.approx(15e-6)
    assert r["spans"]["k2"][0]["device_s"] == pytest.approx(10e-6)
    assert r["spans"]["enqueue"][0]["device_s"] == pytest.approx(5e-6)
    assert r["spans"]["enqueue"][0]["host_s"] == pytest.approx(30e-6)
    assert r["breakdown"]["device_ops"][0] == ["k2", pytest.approx(10e-6)]
    # the longest gap, [40, 100), began outside every span
    assert r["breakdown"]["idle_gaps"][0] == ["harness", pytest.approx(60e-6)]


CHIP_PATH = ["run.py", "harness.py", "traffic.py", "trace.py", "work.py",
             "readers.py", "check.py", "reference.py"]


def _top_level_imports(path):
    tree = ast.parse(open(path).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def _sources():
    out = [os.path.join(HERE, f) for f in CHIP_PATH]
    for sub in ("end_to_end", "metrics", "snapshots", "checks"):
        d = os.path.join(HERE, sub)
        out += [os.path.join(d, f) for f in os.listdir(d) if f.endswith(".py")]
    return out


def test_chip_path_imports_no_jax():
    for path in _sources():
        bad = _top_level_imports(path) & {"jax", "jaxlib", "flax", "topsy_tpu"}
        assert not bad, (path, bad)


def test_reference_imports_nothing_of_the_program():
    names = _top_level_imports(os.path.join(HERE, "reference.py"))
    assert not names & {"topsy_tpu_torch", "topsy_tpu", "jax", "jaxlib"}
    code = ("import sys; sys.path.insert(0, %r); import perfbench.reference; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('topsy_tpu_torch', 'topsy_tpu', 'jax', 'jaxlib', 'flax')]; "
            "print(bad); sys.exit(1 if bad else 0)" % ROOT)
    assert subprocess.run([sys.executable, "-c", code]).returncode == 0


def test_run_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, os.path.join(HERE, "run.py"),
                        "--workload", "density.export", "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=ROOT)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_run_without_the_program_prints_no_result(tmp_path):
    import shutil
    shutil.copytree(HERE, tmp_path / "perfbench")
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    p = subprocess.run([sys.executable, str(tmp_path / "perfbench" / "run.py"),
                        "--workload", "density.export", "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""


# -- what a configuration names -------------------------------------------------------

SMALL = {"n_particles": 1 << 15, "resolution": 128, "canvas": [128, 128]}
SEED = 2 ** 31 + 12345


@pytest.mark.parametrize("key", ["check", "snapshot"])
def test_a_name_with_no_module_fails_with_that_name(key):
    with pytest.raises(ModuleNotFoundError, match="no_such_module"):
        harness.run_cell(bench(), "density.export", SEED, 1.0, False,
                         device="cpu", scale_down=SMALL | {key:
                                                           "no_such_module"})


def test_a_configuration_without_a_check_is_not_judged_as_additive():
    with pytest.raises(KeyError, match="check"):
        check.module({"render_mode": "univariate"})


def test_a_number_the_check_does_not_give_is_not_correct(monkeypatch):
    from perfbench.checks import additive
    full = additive.compare
    monkeypatch.setattr(additive, "compare", lambda *a: {
        k: v for k, v in full(*a).items() if k != "rgba_mean_abs"})
    torch.set_num_threads(4)
    out = harness.run_cell(bench(), "density.export", SEED, 1.0, False,
                           device="cpu", scale_down=SMALL)
    assert out["checked"] > 0
    assert out["checks"]["rgba_mean_abs"]["value"] is None
    assert out["checks"]["raw_max_rel"]["value"] is not None
    assert not out["correct"]


# check.run at SMALL and SEED on the commit before the checks moved into
# checks/ (b4e1b5e), over the first three answers of each cell's traffic
# rendered by the bfloat16 reference (the control's answers, on four
# threads): the moved arithmetic gives the same numbers to the last bit
PARENT_NUMBERS = {
    "density.export": {"raw_max_rel": 0.2204859248956181,
                       "rgba_mean_abs": 2.7191975911458335},
    "surface.interactive": {"depth_off_share": 0.9663865546218487,
                            "rgba_mean_abs": 0.2755940755208333,
                            "value_off_share": 0.6160714285714286},
}


@pytest.mark.parametrize("workload", sorted(PARENT_NUMBERS))
def test_check_numbers_are_the_parents(workload):
    torch.set_num_threads(4)
    b = bench()
    cell = next(w for w in b["workloads"] if w["name"] == workload)
    entry = next(c for c in b["configs"] if c["name"] == cell["config"])
    config = json.load(open(os.path.join(ROOT, entry["file"]))) | SMALL
    plan = traffic.Traffic(harness.load_json("traffic",
                                             f"{cell['traffic']}.json"), SEED)
    setup, views = control.traffic_views(config, plan)
    low = check.module(config).Reference(config, SEED, "cpu", setup,
                                         dtype=torch.bfloat16)
    samples = []
    for i, view in enumerate(views[:3]):
        raw = low.raw(view)
        samples.append((i, view, raw.float(), low.frame(raw)))
    numbers, failed, _ = check.run(config, SEED, "cpu", setup, samples)
    assert numbers == PARENT_NUMBERS[workload]
    assert failed == 3


PROBE_CONFIG = {
    "name": "probe", "n_particles": 1 << 12, "particle_mass": 1e-8,
    "snapshot": "probe_bands", "quantity": "test-quantity",
    "render_mode": "univariate", "check": "probe_check",
    "colormap": "twilight_shifted", "resolution": 64, "canvas": [64, 64],
    "scale": 200.0, "visualizer": {"periodic_tiling": True},
    "limits": {"probe_raw_max_rel": 1.0, "probe_rgba_mean_abs": 255.0}}

PROBE_SNAPSHOT = '''
import torch
from perfbench.snapshots import galaxy


def make(config, seed, device):
    snap = galaxy.make(config, seed, device)
    m = snap["mass"]
    snap["rgb"] = torch.stack([m, 2 * m, 3 * m], dim=1)
    snap["periodicity_scale"] = 100.0
    return snap
'''

PROBE_CHECK = '''
from perfbench.checks import additive

Reference = additive.Reference


def compare(raw, raw_ref, frame, frame_ref):
    got = additive.compare(raw, raw_ref, frame, frame_ref)
    return {"probe_" + k: v for k, v in got.items()}
'''

PROBE_RUN = '''
import json
import numpy as np
import torch
from perfbench import harness
from topsy_tpu_torch.render.periodic import PeriodicSPHRenderer

torch.set_num_threads(2)
bench = {"configs": [{"name": "probe", "file": "perfbench/configs/probe.json"}],
         "workloads": [{"name": "probe.export", "config": "probe",
                        "traffic": "turntable", "chips": 1}]}
seen = {}


def look(vis):
    m = vis.data_loader.get_mass()
    seen["bands"] = bool(np.array_equal(vis.data_loader.get_rgb_masses(),
                                        np.stack([m, 2 * m, 3 * m], 1)))
    seen["store_bands"] = bool(np.array_equal(vis.store.rgb.cpu().numpy(),
                                              np.stack([m, 2 * m, 3 * m], 1)))
    seen["scale"] = [vis.data_loader.get_periodicity_scale(),
                     vis.periodicity_scale]
    seen["periodic"] = isinstance(vis._sph, PeriodicSPHRenderer)


out = harness.run_cell(bench, "probe.export", 7, 1.0, False, device="cpu",
                       fault=look)
print(json.dumps({"harness": harness.__file__, "seen": seen,
                  "checked": out["checked"], "checks": out["checks"]}))
'''


def _hashes(root):
    import hashlib
    out = {}
    for d, dirs, files in os.walk(root):
        dirs[:] = [x for x in dirs if x != "__pycache__"]
        for f in files:
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = hashlib.sha256(
                open(p, "rb").read()).hexdigest()
    return out


def test_a_configuration_made_only_of_new_files_runs(tmp_path):
    import shutil
    shutil.copytree(HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(os.path.join(ROOT, "topsy_tpu_torch"),
               tmp_path / "topsy_tpu_torch")
    before = _hashes(tmp_path / "perfbench")
    added = {"configs/probe.json": json.dumps(PROBE_CONFIG),
             "snapshots/probe_bands.py": PROBE_SNAPSHOT,
             "checks/probe_check.py": PROBE_CHECK}
    assert not set(added) & set(before)
    for rel, text in added.items():
        (tmp_path / "perfbench" / rel).write_text(text)
    p = subprocess.run([sys.executable, "-c", PROBE_RUN], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-4000:]
    got = json.loads(p.stdout.strip().splitlines()[-1])
    assert got["harness"].startswith(str(tmp_path))
    assert got["seen"] == {"bands": True, "store_bands": True,
                           "scale": [100.0, 100.0], "periodic": True}
    assert got["checked"] > 0
    assert set(got["checks"]) == set(PROBE_CONFIG["limits"])
    assert all(isinstance(c["value"], float) for c in got["checks"].values())
    after = _hashes(tmp_path / "perfbench")
    assert {k: after[k] for k in before} == before
