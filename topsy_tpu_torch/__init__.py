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
The package imports ``torch`` and never ``jax`` nor anything of
``topsy_tpu``: it keeps pinned copies of the jax-free modules it needs
(config, camera, drawreason, canvas, overlays, units, cells, progression,
loaders, ops/kernels, ops/morton, native).

Entry points mirror the reference: ``test(n, ...)`` and ``load("test://N")``
return a :class:`~topsy_tpu_torch.visualizer.Visualizer`.
"""

from __future__ import annotations

import torch

from . import config

__version__ = "0.1.0"

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


def load(filename: str, resolution: int = config.DEFAULT_RESOLUTION,
         **kwargs):
    """A visualizer for ``test://N`` synthetic data (snapshot files through
    pynbody are ROADMAP item M14)."""
    from . import loaders, visualizer
    if "test://" not in filename:
        raise NotImplementedError("the PyTorch port loads test://N only; "
                                  "snapshot files are ROADMAP item M14")
    try:
        n_part = int(float(filename[7:]))
    except ValueError:
        n_part = config.TEST_DATA_NUM_PARTICLES_DEFAULT
    return visualizer.Visualizer(data_loader_class=loaders.TestDataLoader,
                                 data_loader_args=(n_part,),
                                 render_resolution=resolution, **kwargs)
