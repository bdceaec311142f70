"""Periodic tiling: the rendered panel replicated over the box lattice.

Counterpart of ``PeriodicSPHRenderer`` in ``topsy_tpu/render/periodic.py``:
each frame renders the base panel once, then composites a (2*2+1)^3 lattice
of rotated box offsets as weighted bilinear-shifted copies
(``ops.composite.lattice_composite``); the weight fades from 1 to 0 for
|z offset| in [0.5, 1] box lengths.  The reference's own ``render`` and
``_get_image_unscaled`` are not restated: ``SPHRenderer.render`` already
returns on a PRESENTATION_CHANGE and ends every frame with
``_postprocess_frame`` (the composite), and the inherited
``_get_image_unscaled`` reads ``get_output_image``, which is the composite
here.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.composite import lattice_composite
from .sph import SPHRenderer


class PeriodicSPHRenderer(SPHRenderer):
    num_repetitions = 2

    def __init__(self, store, render_progression, resolution: int,
                 periodicity_scale: float | None = None,
                 backend: str | None = None, **kwargs):
        kwargs.setdefault("wrapping", True)
        super().__init__(store, render_progression, resolution,
                         backend=backend, **kwargs)
        self._periodicity_scale = periodicity_scale
        self._display_image = None

    def instance_offsets_and_weights(self):
        """Lattice offsets (clip units) and fade weights of the instances
        whose rotated z offset is under one box length."""
        offsets = []
        weights = []
        panel_scale = self._periodicity_scale / self.scale
        n = self.num_repetitions
        rot = np.asarray(self.rotation_matrix)
        for xoff in range(-n, n + 1):
            for yoff in range(-n, n + 1):
                for zoff in range(-n, n + 1):
                    off = rot @ np.array([xoff, yoff, zoff], dtype=np.float64)
                    if abs(off[2]) < 1.0:
                        z = abs(off[2])
                        weights.append(1.0 if z <= 0.5
                                       else 1.0 - 2.0 * (z - 0.5))
                        offsets.append(off[:2])
        return (np.asarray(offsets, dtype=np.float32) * panel_scale,
                np.asarray(weights, dtype=np.float32))

    def lattice_pixels(self):
        """(offsets (K, 2) as (dy, dx) pixels, weights (K,)): clip x moves
        columns right, clip y moves rows up."""
        offsets_clip, weights = self.instance_offsets_and_weights()
        res = self._resolution
        offsets_px = np.stack([-offsets_clip[:, 1] * res / 2.0,
                               offsets_clip[:, 0] * res / 2.0], axis=1)
        return offsets_px.astype(np.float32), weights

    def _postprocess_frame(self):
        # the base panel includes the dense giant layer (divided by the mass
        # scale, SPHRenderer.get_output_image), so giant wings tile over the
        # lattice like every other deposit
        offsets_px, weights = self.lattice_pixels()
        self._display_image = lattice_composite(
            SPHRenderer.get_output_image(self), offsets_px, weights)

    def get_output_image(self) -> torch.Tensor:
        return (self._display_image if self._display_image is not None
                else self._image)
