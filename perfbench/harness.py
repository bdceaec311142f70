"""One run of one cell: set-up, the measured window, the traced readings
and the check of what the window produced.

Everything that belongs to a configuration, a traffic mix, a span or a
metric is read from its own file under this directory, found by the name
``BENCHMARK.json`` gives it:

* ``configs/<config>.json``: the deployment (snapshot size, view, mode,
  the check's limits), which names its snapshot module (``"snapshot"``)
  and its check module (``"check"``), and may give ``"visualizer"``, a
  dict of further keyword arguments of ``Visualizer`` (such as
  ``{"periodic_tiling": true}``);
* ``snapshots/<snapshot>.py``: ``make(config, seed, device)``, the seed's
  snapshot as a dict of device tensors (``check.py`` gives its keys);
* ``checks/<check>.py``: the reference renders and the numbers compared
  (``check.py`` gives the module's interface);
* ``traffic/<traffic>.json``: the parameters of the one generator
  (``traffic.py``);
* ``spans/<span>.json``: the program's functions a span wraps in a traced
  run, and whether its calls' arguments are kept for a work count;
* ``end_to_end/<metric>.py`` and ``metrics/<metric>.py``: one reader each,
  ``read(ctx)`` returning the metric's value or None.

The program is driven only through ``Visualizer`` (``draw``, ``rotate``,
``scale``), as a canvas drives it.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import os
import random
import time
from contextlib import nullcontext

import numpy as np
import torch

from . import check, trace, traffic, work

HERE = os.path.dirname(os.path.abspath(__file__))


def load_json(*parts):
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def load_reader(kind: str, name: str):
    """The ``read`` function of ``<kind>/<name>.py``."""
    path = os.path.join(HERE, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"perfbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# -- the deployment ---------------------------------------------------------------

def make_loader_class():
    """A loader that hands the program the benchmark's own snapshot on the
    device (``AbstractDataLoader`` with ``device_arrays``), served as the
    snapshot module gives it."""
    from topsy_tpu_torch.loaders import AbstractDataLoader

    class SnapshotLoader(AbstractDataLoader):
        def __init__(self, snap: dict):
            self._snap = snap

        def device_arrays(self):
            return self._snap

        def __len__(self):
            return self._snap["pos_smooth"].shape[0]

        def get_positions(self):
            return self._snap["pos_smooth"][:, :3].cpu().numpy()

        def get_smooth(self):
            return self._snap["pos_smooth"][:, 3].cpu().numpy()

        def get_mass(self):
            return self._snap["mass"].cpu().numpy()

        def get_named_quantity(self, name):
            return self._snap["quantities"][name].cpu().numpy()

        def get_quantity_names(self):
            return list(self._snap["quantities"])

        def get_quantity_label(self, quantity_name):
            return quantity_name or "density"

        def get_rgb_masses(self):
            if "rgb" in self._snap:
                return self._snap["rgb"].cpu().numpy()
            m = self._snap["mass"]
            return torch.stack([m, m, m], dim=1).cpu().numpy()

        def get_periodicity_scale(self):
            return self._snap.get("periodicity_scale")

        def get_position_units(self):
            return "kpc"

    return SnapshotLoader


def view_of(vis) -> dict:
    """The camera as plain numbers."""
    return {"rotation": np.array(vis.rotation_matrix, dtype=np.float64),
            "offset": np.array(vis.position_offset, dtype=np.float64),
            "scale": float(vis.scale)}


def build(config: dict, seed: int, device, snapshot):
    """The Visualizer of a deployment over the benchmark's snapshot (the
    dict of ``check.snapshot``), its quantity set (which ranges the
    colormap at the starting view), with the configuration's
    ``"visualizer"`` keyword arguments."""
    from topsy_tpu_torch.canvas import OffscreenCanvas
    from topsy_tpu_torch.visualizer import Visualizer
    if not isinstance(snapshot, dict):
        # program_spans.py at the root still hands reference.snapshot's
        # (pos_smooth, mass, quantity) tuple
        ps, mass, qty = snapshot
        snapshot = {"pos_smooth": ps, "mass": mass,
                    "quantities": {config["quantity"]: qty}}
    vis = Visualizer(data_loader_class=make_loader_class(),
                     data_loader_args=(snapshot,),
                     render_resolution=config["resolution"],
                     canvas_class=OffscreenCanvas,
                     render_mode=config["render_mode"],
                     colormap_name=config["colormap"], device=device,
                     **config.get("visualizer", {}))
    vis.canvas.resize_complete(*config["canvas"])
    vis.show_colorbar = vis.show_scalebar = vis.show_status = False
    vis.scale = config["scale"]
    vis.quantity_name = config["quantity"]
    return vis


# -- spans --------------------------------------------------------------------------

class Spans:
    """Wraps the program functions named by ``spans/*.json`` in
    ``record_function`` ranges ``pb.<span>#<call>`` for a traced run, and
    keeps the arguments of ``sample_calls`` of a span's calls, drawn
    uniformly from all of the window's by the seed, where its file asks for
    them (a kernel whose work the readers count)."""

    def __init__(self, names, seed=0):
        self.defs = {n: load_json("spans", f"{n}.json") for n in names}
        self.calls = {n: 0 for n in names}
        self.kept = {n: [None] * int(d.get("sample_calls", 0))
                     for n, d in self.defs.items()}
        self._take = {n: traffic.reservoir(random.Random(f"{seed}/{n}"),
                                           len(slots))
                      for n, slots in self.kept.items()}
        self._undo = []

    def sampled(self, name):
        """The kept calls of a span, (call, args, kwargs) in call order."""
        return sorted((c for c in self.kept[name] if c is not None),
                      key=lambda c: c[0])

    def _wrap(self, name, fn):
        spans = self
        take = self._take[name]

        def wrapper(*args, **kw):
            i = spans.calls[name]
            spans.calls[name] = i + 1
            slot = take(i)
            if slot is not None:
                spans.kept[name][slot] = (i, args, kw)
            with torch.profiler.record_function(f"{trace.PREFIX}{name}#{i}"):
                return fn(*args, **kw)

        return wrapper

    def install(self):
        for name, spec in self.defs.items():
            for target in spec["targets"]:
                mod_name, _, path = target.partition(":")
                owner = importlib.import_module(mod_name)
                *outer, attr = path.split(".")
                for part in outer:
                    owner = getattr(owner, part)
                fn = owner.__dict__[attr] if isinstance(owner, type) \
                    else getattr(owner, attr)
                self._undo.append((owner, attr, fn))
                setattr(owner, attr, self._wrap(name, fn))

    def remove(self):
        for owner, attr, fn in reversed(self._undo):
            setattr(owner, attr, fn)
        self._undo = []


# -- one run ---------------------------------------------------------------------------

def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_cell(bench: dict, workload: str, seed: int, seconds: float,
             traced: bool, device="cuda", t_start=None, scale_down=None,
             fault=None) -> dict:
    """Run one cell once; returns the result object (without ``device``'s
    card fields, which ``run.py`` adds).  ``scale_down``: overrides of the
    configuration's sizes for the CPU tests; ``fault``: a callable given
    the Visualizer after set-up, for the tests that break the timed path."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    cfg_entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.load(open(os.path.join(os.path.dirname(HERE),
                                         cfg_entry["file"])))
    if scale_down:
        config = config | scale_down
    plan = traffic.Traffic(load_json("traffic", f"{cell['traffic']}.json"),
                           seed)
    from topsy_tpu_torch.drawreason import DrawReason

    check.module(config)  # a check that has no module fails before set-up
    snap = check.snapshot(config, seed, device)
    vis = build(config, seed, device, snap)
    setup_view = view_of(vis)
    params = vis.colormap.get_parameters()
    program_range = {k: params[k] for k in ("vmin", "vmax", "log")}
    vis.rotate(plan.start_turn, 0.0)
    del snap

    def do_step(i):
        step = plan.step(i)
        t0 = time.perf_counter()
        if step.scale is not None:
            vis.scale = step.scale
        vis.rotate(*step.rotate)
        if plan.draw == "export":
            frame = vis.draw(DrawReason.EXPORT)
            return t0, [time.perf_counter()], frame
        frame = vis.draw(DrawReason.CHANGE)
        ends = [time.perf_counter()]
        while vis._sph.needs_refine():
            frame = vis.draw(DrawReason.REFINE)
            ends.append(time.perf_counter())
        return t0, ends, frame

    for i in range(plan.warmup_steps):
        do_step(i)
    _sync(device)
    if fault is not None:
        fault(vis)

    spans = Spans(span_names(), seed) if traced else None
    prof = None
    if traced:
        spans.install()
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    take = traffic.reservoir(plan.sample_rng, plan.samples)
    kept = [None] * plan.samples
    starts, ends_all = [], []
    t_window = time.perf_counter()
    setup_s = t_window - t_start
    i = plan.warmup_steps
    with (torch.profiler.record_function(f"{trace.PREFIX}window")
          if traced else nullcontext()):
        while True:
            t0, ends, frame = do_step(i)
            n = len(starts)
            starts.append(t0)
            ends_all.append(ends)
            slot = take(n)
            if slot is not None:
                kept[slot] = (n, view_of(vis),
                              vis._sph.get_output_image().detach().clone(),
                              frame)
            i += 1
            if ends[-1] - t_window >= seconds:
                break
    window_s = ends_all[-1][-1] - t_window
    _sync(device)
    ctx = {"config": config, "draw": plan.draw, "steps": len(starts),
           "window_s": window_s, "setup_s": setup_s,
           "latencies": [[e - t0 for e in ends]
                         for t0, ends in zip(starts, ends_all)]}
    if traced:
        prof.__exit__(None, None, None)
        spans.remove()
        trace_dir = os.path.join(os.path.dirname(HERE), "build", "perfbench")
        os.makedirs(trace_dir, exist_ok=True)
        path = os.path.join(trace_dir, f"{workload}.trace.json")
        prof.export_chrome_trace(path)
        del prof
        ctx["trace"] = trace.reduce_trace(path)
        os.remove(path)
        ctx["work"] = {name: [(i, work_of(name, a, kw))
                              for i, a, kw in spans.sampled(name)]
                       for name in spans.kept if spans.sampled(name)}
        spans.kept = None
    peak = (torch.cuda.max_memory_allocated()
            if torch.device(device).type == "cuda" else 0)
    samples = [(n, v, raw.cpu(), frame) for n, v, raw, frame
               in sorted(k for k in kept if k is not None)]
    del vis, kept
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    numbers, failed, ref_range = check.run(config, seed, device, setup_view,
                                           samples)
    checks = {k: {"value": numbers.get(k), "limit": lim}
              for k, lim in config["limits"].items()}
    correct = bool(samples) and check.within(numbers, config["limits"])
    return {"correct": correct, "attempted": len(starts), "failed": failed,
            "checked": len(samples), "checks": checks, "ctx": ctx,
            "ranges": {"program": program_range, "reference": ref_range},
            "memory_peak_bytes": peak}


def span_names():
    """Every span of ``spans/``."""
    return sorted(f[:-5] for f in os.listdir(os.path.join(HERE, "spans"))
                  if f.endswith(".json"))


def work_of(span: str, args, kw) -> float:
    """The least time (s) of one kept call of a span that counts work."""
    spec = load_json("spans", f"{span}.json")
    return getattr(work, spec["work"])(args, kw)


def metrics_for(bench: dict, workload: str, ctx: dict, traced: bool) -> dict:
    """The cell's metrics: its end-to-end metrics, or with a trace its
    per-layer ones; a reader that finds nothing is left out."""
    out = {}
    entries = bench["per_layer"] if traced else bench["end_to_end"]
    for m in entries:
        if "workloads" in m and workload not in m["workloads"]:
            continue
        read = load_reader("metrics" if traced else "end_to_end", m["name"])
        value = read(ctx)
        if value is None or not math.isfinite(value):
            continue
        out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
