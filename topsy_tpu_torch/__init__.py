"""topsy_tpu_torch — the PyTorch/CUDA port of topsy_tpu.

The presorted renders on tensors, EXPORT and interactive frames, with
hand-written kernels for NVIDIA Hopper: the additive modes (univariate,
bivariate, RGB and RGB-HDR, the depth pick, periodic tiling: loader ->
presort on the device, ``ops/morton_device.py``, and its decimation-mip
tiers -> feed kernel K1, ``ops/splat_feed.py``, Triton -> low-rank deposit
kernel K2, ``csrc/splat_accum.cu`` -> spill tiers -> pyramid collapse ->
giant layer -> lattice composite -> colormap) and the surface (z-buffered)
mode (the same presort -> plain front end -> front-most-fragment kernel K3,
``csrc/zsplat_accum.cu`` -> spill tiers -> max-composite collapse -> giant
layer -> bilateral filter and lighting).
Every mode also renders over a particle mesh of several cards, shards or
processes (``mesh=``, ``parallel/``, ``render/distributed.py``).
The package imports ``torch`` and never ``jax`` nor anything of
``topsy_tpu``: it keeps pinned copies of the jax-free modules it needs
(config, camera, drawreason, canvas, overlays, units, cells, progression,
loaders, ops/kernels, ops/morton, native).

Entry points mirror the reference, each returning a
:class:`~topsy_tpu_torch.visualizer.Visualizer`: ``test(n, ...)`` (the
seeded synthetic snapshot), ``load(filename, ...)`` (a snapshot file
through pynbody, or ``"test://N"``) and ``topsy(snapshot)`` (an open
pynbody snapshot).  Raw arrays go through ``loaders.ArrayDataLoader``
(``Visualizer(data_loader_class=ArrayDataLoader, data_loader_args=(pos,),
...)``), which computes missing smoothing lengths on the card.
"""

from __future__ import annotations

import logging

import torch

from . import config

__version__ = "0.1.0"

logger = logging.getLogger(__name__)

# every float32 matmul of the port (pyramid collapse, giant layer) runs in
# full float32, as the reference runs them at HIGHEST precision
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


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
