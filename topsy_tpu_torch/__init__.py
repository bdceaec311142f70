"""topsy_tpu_torch — the PyTorch/CUDA port of topsy_tpu.

The presorted EXPORT render (loader -> host presort -> feed kernel ->
low-rank deposit kernel -> spill tiers -> pyramid collapse -> giant layer ->
colormap) on tensors, with hand-written kernels for NVIDIA Hopper
(``ops/splat_feed.py``: Triton; ``csrc/splat_accum.cu``: CUDA C++).  The
package imports ``torch`` and never ``jax``; it reuses the reference's
jax-free modules (config, camera, morton, kernels, loaders, overlays).

Entry points mirror the reference: ``test(n, ...)`` and ``load("test://N")``
return a :class:`~topsy_tpu_torch.visualizer.Visualizer`.
"""

from __future__ import annotations

import torch

from topsy_tpu import config

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
        data_loader_kwargs={"with_cells": kwargs.pop("with_cells", False)},
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
