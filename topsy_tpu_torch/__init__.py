"""topsy_tpu_torch — the PyTorch/CUDA port of topsy_tpu.

The presorted renders on tensors, EXPORT and interactive frames, with
hand-written kernels for NVIDIA Hopper: the additive modes (univariate,
bivariate, RGB and RGB-HDR, the depth pick, periodic tiling: loader ->
presort on the device, ``ops/morton_device.py``, and its decimation-mip
tiers -> feed kernel K1, ``csrc/splat_feed.cu`` -> low-rank deposit
kernel K2, ``csrc/splat_accum.cu`` -> spill tiers -> pyramid collapse ->
giant layer -> lattice composite -> colormap) and the surface (z-buffered)
mode (the same presort -> plain front end -> front-most-fragment kernel K3,
``csrc/zsplat_accum.cu`` -> spill tiers -> max-composite collapse -> giant
layer -> bilateral filter and lighting).
Every mode also renders over a particle mesh of several cards, shards or
processes (``mesh=``, ``parallel/``, ``render/distributed.py``).
The package imports ``torch`` and never ``jax`` nor anything of
``topsy_tpu``: it keeps pinned copies of the jax-free modules it needs
(config, camera, drawreason, canvas with its Qt and Jupyter backends,
overlays, units, cells, progression, loaders, ops/kernels, ops/morton,
native, hdr_tiff, view_synchronizer, recorder, color/ui).  Its
``performance`` module traces with ``torch.profiler``.

Entry points mirror the reference, each returning a
:class:`~topsy_tpu_torch.visualizer.Visualizer`: ``test(n, ...)`` (the
seeded synthetic snapshot), ``load(filename, ...)`` (a snapshot file
through pynbody, or ``"test://N"``) and ``topsy(snapshot)`` (an open
pynbody snapshot).  The command line (``python -m topsy_tpu_torch FILE
[options] [+ FILE ...]``, ``main``) parses ``+``-separated window batches
as the reference's ``parse_args`` does and opens each through ``load`` on
the card.  Raw arrays go through ``loaders.ArrayDataLoader``
(``Visualizer(data_loader_class=ArrayDataLoader, data_loader_args=(pos,),
...)``), which computes missing smoothing lengths on the card.
"""

from __future__ import annotations

import argparse
import logging
import sys

import torch

from . import config

__version__ = "0.1.0"

logger = logging.getLogger(__name__)

# every float32 matmul of the port (pyramid collapse, giant layer) runs in
# full float32, as the reference runs them at HIGHEST precision
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def parse_args(args=None):
    """Parse CLI arguments into per-window batches separated by '+'."""
    argparser = argparse.ArgumentParser(
        description="Visualize an astrophysics simulation on the GPU. Multiple "
                    "windows can be opened by separating groups of arguments "
                    "with +.")
    argparser.add_argument("filename",
                           help="Path to a simulation file, or test://N for "
                                "synthetic data with N particles")
    argparser.add_argument("--resolution", "-r", type=int,
                           default=config.DEFAULT_RESOLUTION,
                           help="Resolution of the visualization")
    argparser.add_argument("--colormap", "-m", type=str,
                           default=config.DEFAULT_COLORMAP,
                           help="Matplotlib colormap to use")
    argparser.add_argument("--particle", "-p", type=str, default="dm",
                           help="Particle type to visualise")
    argparser.add_argument("--center", "-c", type=str, default="none",
                           help="Centering method: 'halo-<N>', 'all', 'zoom' "
                                "or 'none'")
    argparser.add_argument("--quantity", "-q", type=str, default=None,
                           help="Quantity to render instead of density")
    argparser.add_argument("--tile", "-t", action="store_true", default=False,
                           help="Wrap and tile the simulation box periodically")
    argparser.add_argument("--render-mode", dest="render_mode",
                           default="univariate",
                           choices=["univariate", "bivariate", "rgb", "rgb-hdr",
                                    "surface"],
                           help="Rendering mode")
    argparser.add_argument("--load-sphere", nargs="+", metavar="_", type=float,
                           default=None,
                           help="Load a sphere of particles: radius "
                                "[, cx cy cz] in simulation units")

    if args is None:
        args = sys.argv[1:]
    arg_batches = []
    while len(args) > 0:
        try:
            split_index = args.index("+")
        except ValueError:
            split_index = len(args)
        this_args = argparser.parse_args(args[:split_index])
        if this_args.load_sphere is not None and len(this_args.load_sphere) not in (1, 4):
            argparser.error("Invalid number of arguments for --load-sphere. "
                            "Must be 1 or 4.")
        arg_batches.append(this_args)
        args = args[split_index + 1:]
    return arg_batches


_logging_set_up = False


def setup_logging():
    """Log the package's DEBUG records to stderr (once per process)."""
    global _logging_set_up
    if _logging_set_up:
        return
    _logging_set_up = True
    logger.setLevel(logging.DEBUG)
    ch = logging.StreamHandler()
    ch.setLevel(logging.DEBUG)
    ch.setFormatter(logging.Formatter(
        "%(asctime)s - %(name)s - %(levelname)s - %(message)s"))
    logger.addHandler(ch)


def main():
    all_args = parse_args()
    visualizers = []
    for args in all_args:
        vis = load(args.filename, center=args.center, resolution=args.resolution,
                   particle=args.particle, tile=args.tile,
                   sphere_radius=(args.load_sphere[0]
                                  if args.load_sphere is not None else None),
                   sphere_center=(tuple(args.load_sphere[1:])
                                  if args.load_sphere is not None
                                  and len(args.load_sphere) == 4 else None),
                   render_mode=args.render_mode,
                   colormap_name=args.colormap)
        vis.quantity_name = args.quantity
        vis.canvas.show()
        visualizers.append(vis)

    from .canvas import run_event_loop
    run_event_loop(visualizers)


def test(nparticle=config.TEST_DATA_NUM_PARTICLES_DEFAULT, **kwargs):
    """Synthetic-data visualizer (the seeded Gaussian-mixture snapshot)."""
    from . import loaders, visualizer
    return visualizer.Visualizer(
        data_loader_class=loaders.TestDataLoader,
        data_loader_args=(nparticle,),
        data_loader_kwargs={"with_cells": kwargs.pop("with_cells", False),
                            "periodic": kwargs.get("periodic_tiling", False)},
        **kwargs)


def topsy(snapshot, quantity: str | None = None, **kwargs):
    """A visualizer for an already-loaded pynbody snapshot."""
    from . import loaders, visualizer
    vis = visualizer.Visualizer(data_loader_class=loaders.PynbodyDataInMemory,
                                data_loader_args=(snapshot,), **kwargs)
    vis.quantity_name = quantity
    return vis


def load(filename: str, center: str = "none", particle: str = "gas",
         resolution: int = config.DEFAULT_RESOLUTION, tile: bool = False,
         sphere_radius: float | None = None,
         sphere_center: tuple[float, float, float] | None = None,
         render_mode: str | None = None, **kwargs):
    """A visualizer for a simulation file (through pynbody: physical units,
    the ``particle`` family, ``center``ing, smoothing lengths cached beside
    the file, an optional ``sphere_radius`` region) or for ``test://N``
    synthetic data."""
    from . import loaders, visualizer
    setup_logging()
    if "test://" in filename:
        loader_class = loaders.TestDataLoader
        try:
            n_part = int(float(filename[7:]))
        except ValueError:
            n_part = config.TEST_DATA_NUM_PARTICLES_DEFAULT
        logger.info("Using test data with %d particles", n_part)
        loader_args = (n_part,)
    else:
        pynbody = loaders._import_pynbody()
        loader_class = loaders.PynbodyDataLoader
        if sphere_radius is not None:
            if sphere_center is not None:
                region = pynbody.filt.Sphere(sphere_radius, sphere_center)
            else:
                region = pynbody.filt.Sphere(sphere_radius)
            loader_args = (filename, center, particle, region)
        else:
            loader_args = (filename, center, particle)
    return visualizer.Visualizer(data_loader_class=loader_class,
                                 data_loader_args=loader_args,
                                 periodic_tiling=tile,
                                 render_resolution=resolution,
                                 render_mode=render_mode, **kwargs)


_force_is_jupyter = False


def is_jupyter():
    """Whether we are executing inside a Jupyter notebook/lab."""
    global _force_is_jupyter
    if _force_is_jupyter:
        return True
    from .util import is_jupyter as _isj
    return _isj()


def force_jupyter():
    """Force is_jupyter() to return True (used in testing)."""
    global _force_is_jupyter
    _force_is_jupyter = True
