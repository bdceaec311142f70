"""The port does all the reference does, name by name.

A census of ``topsy_tpu`` read from its source with ``ast`` (it imports
nothing of ``topsy_tpu`` and needs no JAX): every module; its public
top-level functions and classes; each class's public methods and
``__init__``; every parameter name of those; and every constant of
``config.py``.  Each must have a counterpart of the same name in the same
module of ``topsy_tpu_torch`` (a method defined in the port class's own
body where the reference class defines it in its own; a function's or a
method's parameters a superset of the reference's), or one entry in
``DEPARTURES``, from the reference's name to the reason the port goes
without it.  ``DEPARTURES`` is the single list of the port's departures,
and it may not go stale: each entry names something the reference has and
the port lacks.  Private names (``_name``) are out of the census unless an
entry names them.

Keys: ``module.py`` for a module, ``module.py::name`` for a top-level
function, class or constant, ``module.py::Class.method`` for a method, and
``...name(param=)`` for a parameter.
"""

from __future__ import annotations

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF = ROOT / "topsy_tpu"
PORT = ROOT / "topsy_tpu_torch"

_FEED_OFF = ("the feed-off path, which the reference keeps because off the "
             "TPU its feed kernel runs interpreted; the port's feed kernel "
             "runs on every device the port supports")

DEPARTURES = {
    # the Pallas kernels and their entry points, ported by hand for Hopper
    "ops/splat_pallas.py":
        "K2, ported as csrc/splat_accum.cu (CUDA C++, wgmma) behind "
        "ops/splat_accum.py",
    "ops/zsplat_pallas.py":
        "K3, ported as csrc/zsplat_accum.cu (CUDA C++) behind "
        "ops/zsplat_accum.py",
    "ops/splat_feed.py::splat_feed_pallas":
        "K1, ported in Triton as splat_feed_triton",
    # the feed-off paths and their options
    "config.py::EXPORT_USE_FEED":
        _FEED_OFF,
    "config.py::EXPORT_USE_PRESORTED":
        "always on: _use_presorted decides by backend and layout alone; off,"
        " the reference exports over power-of-two column widths to bound its"
        " jit compiles",
    "render/sph.py::SPHRenderer._use_feed":
        _FEED_OFF,
    "render/sph.py::_render_block_presorted":
        _FEED_OFF,
    "render/sph.py::_render_block_columns":
        _FEED_OFF,
    "parallel/render_step.py::DistributedSplatter._use_feed":
        _FEED_OFF,
    "parallel/render_step.py::DistributedSplatter._build_presorted_step":
        _FEED_OFF,
    "parallel/render_step.py::DistributedSplatter._build_columns_step":
        _FEED_OFF,
    "parallel/render_step.py::DistributedSplatter.__init__(backend=)":
        "the mesh's splat backend chose the feed-off steps; the port's "
        "splatter always feeds",
    "ops/splat_atlas.py::splat_atlas(engine=)":
        "the 'scan' engine is the reference's CPU stand-in for Pallas; K2's "
        "plain version plays that part",
    "ops/splat_atlas.py::splat_atlas_fields(engine=)":
        "as splat_atlas's engine=",
    "ops/splat_atlas.py::make_group_contribution":
        "the 'scan' engine's window deposit; K2's plain version replaces it",
    "ops/splat_atlas.py::spill_pass":
        "ported as spill_tiers, which returns the two tiers' deposit operands"
        " for K2",
    "ops/splat_atlas.py::splat_atlas(presorted_buckets=)":
        _FEED_OFF,
    "ops/splat_atlas.py::splat_atlas_fields(subgroups=)":
        "SUBGROUPS is a TPU schedule (VMEM windows); K2 has none",
    "ops/splat_atlas.py::splat_atlas_fields(_stop_after=)":
        "a profiling cut of the TPU pipeline; the port times each call by "
        "CUDA events",
    # timing: CUDA events, not wall time minus a calibration
    "util.py::sync_latency":
        "the port times with CUDA events (util.FrameClock), not wall time "
        "minus a calibrated readback",
    "visualizer.py::VisualizerBase._presentation_readback_cost":
        "as sync_latency",
    "render/sph.py::SPHRenderer.notify_presentation_barrier(t_effective=)":
        "the frame clock's CUDA events give the frame's span; no host "
        "timestamp is passed",
    # XLA only
    "util.py::enable_persistent_compile_cache":
        "XLA's compile cache; the port's kernels are built once into build/",
    "render/sph.py::default_backend":
        "names the JAX backend ('atlas'); the port's renderers default to "
        "'atlas' themselves",
    # host and jnp helpers the port does on the card or in plain torch
    "ops/morton.py::build_mip_host":
        "the reference mesh's host mip; the port builds every mip on the card"
        " (morton_device.build_mip_layout)",
    "ops/splat.py::kernel_radial_jnp":
        "ported as splat.kernel_radial (torch)",
    "ops/splat.py::lowrank_profiles_jnp":
        "ported as splat.lowrank_profiles (torch)",
    "ops/knn_device.py::_kth_smallest":
        "a two-stage top_k around XLA's slow wide rows; the port's _kth is "
        "one torch.topk",
    "ops/knn_device.py::_morton_order":
        "ported as morton_order",
    "config.py::KNN_DEVICE_MAX_N":
        "gates a TPU runtime crash (topsy_tpu/loaders.py:368-376); the port's"
        " device kNN has no such limit and raises on failure",
    # overrides the port's base class makes redundant
    "render/periodic.py::PeriodicSPHRenderer.render":
        "SPHRenderer.render already returns on PRESENTATION_CHANGE and runs "
        "_postprocess_frame",
    "render/periodic.py::PeriodicSPHRenderer._get_image_unscaled":
        "the inherited one reads get_output_image, the composite here",
}


def _params(fn: ast.FunctionDef) -> list[str]:
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    if a.vararg:
        names.append("*" + a.vararg.arg)
    if a.kwarg:
        names.append("**" + a.kwarg.arg)
    return [n for n in names if n not in ("self", "cls")]


def _targets(node) -> list[str]:
    targets = node.targets if isinstance(node, ast.Assign) else [node.target]
    return [x.id for t in targets for x in ast.walk(t)
            if isinstance(x, ast.Name)]


def _module(path: pathlib.Path) -> dict:
    """functions: name -> params; classes: name -> (methods: name ->
    params, base names, class attributes); names: every name the module
    binds at its top level (definitions, assignments, imports, and those
    inside a top-level ``if`` or ``try``)."""
    tree = ast.parse(path.read_text())
    funcs, classes, names = {}, {}, set()
    defs = (ast.FunctionDef, ast.AsyncFunctionDef)
    for node in tree.body:
        if isinstance(node, defs):
            funcs[node.name] = _params(node)
            names.add(node.name)
        elif isinstance(node, ast.ClassDef):
            methods = {n.name: _params(n) for n in node.body
                       if isinstance(n, defs)}
            attrs = {t for n in node.body
                     if isinstance(n, (ast.Assign, ast.AnnAssign))
                     for t in _targets(n)}
            bases = [ast.unparse(b).split(".")[-1] for b in node.bases]
            classes[node.name] = (methods, bases, attrs)
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            names.update(_targets(node))
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0]
                         for a in node.names)
        elif isinstance(node, (ast.If, ast.Try)):
            for x in ast.walk(node):
                if isinstance(x, defs + (ast.ClassDef,)):
                    names.add(x.name)
                elif isinstance(x, ast.Name) and isinstance(x.ctx, ast.Store):
                    names.add(x.id)
    return {"funcs": funcs, "classes": classes, "names": names}


def _package(root: pathlib.Path) -> dict:
    return {p.relative_to(root).as_posix(): _module(p)
            for p in sorted(root.rglob("*.py"))}


_REF = _package(REF)
_PORT = _package(PORT)
_PORT_CLASSES = {}
for _m in _PORT.values():
    for _name, _cls in _m["classes"].items():
        _PORT_CLASSES.setdefault(_name, []).append(_cls)


def _inherited(cls: str, member: str, seen=()) -> list[str] | None:
    """The params of ``member`` as a port class has it, through its own
    body or its bases (found by name anywhere in the port); [] for a class
    attribute, None where it has no such member."""
    for methods, bases, attrs in _PORT_CLASSES.get(cls, []):
        if member in methods:
            return methods[member]
        if member in attrs:
            return []
        for base in bases:
            if base not in seen:
                found = _inherited(base, member, seen + (base,))
                if found is not None:
                    return found
    return None


def _census(mod: str) -> list[tuple[str, bool]]:
    """(key, present in the port) for everything the census lists of one
    reference module."""
    ref, port = _REF[mod], _PORT.get(mod)
    if port is None:
        return [(mod, False)]
    out = []
    for name, params in ref["funcs"].items():
        if name.startswith("_"):
            continue
        key = f"{mod}::{name}"
        if name not in port["funcs"]:
            # a name the port binds another way (an import, an alias)
            out.append((key, name in port["names"]))
            continue
        out.append((key, True))
        out += [(f"{key}({p}=)", p in port["funcs"][name]) for p in params]
    for cname, (methods, _, _) in ref["classes"].items():
        if cname.startswith("_"):
            continue
        key = f"{mod}::{cname}"
        if cname not in port["classes"]:
            out.append((key, cname in port["names"]))
            continue
        out.append((key, True))
        own = port["classes"][cname][0]
        for meth, params in methods.items():
            if meth.startswith("_") and meth != "__init__":
                continue
            mkey = f"{key}.{meth}"
            out.append((mkey, meth in own))
            if meth in own:
                out += [(f"{mkey}({p}=)", p in own[meth]) for p in params]
    if mod == "config.py":
        out += [(f"{mod}::{n}", n in port["names"])
                for n in sorted(ref["names"]) if n.isupper()]
    return out


def _has(pkg: dict, key: str, port: bool) -> bool:
    """Whether ``pkg`` has the member ``key`` names (a port class's
    members through its bases too)."""
    mod, _, rest = key.partition("::")
    m = pkg.get(mod)
    if m is None or not rest:
        return m is not None
    name, _, param = rest.partition("(")
    param = param.removesuffix("=)")
    if "." not in name:
        if not param:
            return name in m["names"]
        return name in m["funcs"] and param in m["funcs"][name]
    cname, meth = name.split(".", 1)
    if cname not in m["classes"]:
        return False
    if port and not param:
        return meth in m["classes"][cname][0]
    params = (_inherited(cname, meth) if port
              else m["classes"][cname][0].get(meth))
    if params is None:
        return False
    return not param or param in params


@pytest.mark.parametrize("mod", sorted(_REF))
def test_reference_module_has_its_counterpart(mod):
    missing = [key for key, present in _census(mod)
               if not present and key not in DEPARTURES]
    assert not missing, (
        f"{len(missing)} members of topsy_tpu/{mod} have no counterpart in "
        f"topsy_tpu_torch and no entry in DEPARTURES: {missing}")


@pytest.mark.parametrize("key", sorted(DEPARTURES))
def test_departure_is_current(key):
    """Each entry gives a one-line reason and names a member the reference
    has and the port lacks."""
    reason = DEPARTURES[key]
    assert reason.strip() and "\n" not in reason, key
    assert _has(_REF, key, port=False), \
        f"{key}: the reference no longer has it; drop the entry"
    assert not _has(_PORT, key, port=True), \
        f"{key}: the port has it now; drop the entry"


def test_census_reads_both_packages():
    """The walk finds what it must: a gap it would miss would pass."""
    assert len(_REF) > 50 and set(_REF) - set(_PORT) == {
        "ops/splat_pallas.py", "ops/zsplat_pallas.py"}
    keys = {k for mod in _REF for k, _ in _census(mod)}
    assert {"camera.py::Camera.rotate", "render/sph.py::SPHRenderer.__init__"
            "(share_render_progression=)", "config.py::PYRAMID_COLLAPSE_FILTER",
            "ops/composite.py::upsample2x_catmull_cm"} <= keys
    assert len(keys) > 1000
