"""The check of an additive image (``render_mode`` univariate): the raw
(density, mass-weighted quantity) image and its univariate colormap.

* ``raw_max_rel``: the largest pixel difference of the raw image in either
  channel as a share of that channel's largest absolute reference value
  (infinite where the program's image is not finite);
* ``rgba_mean_abs``: the mean absolute difference of the presented 8-bit
  RGB, in levels.
"""

from __future__ import annotations

import torch

from perfbench import check, reference


class Reference:
    """The reference renders of the configuration over the seed's
    snapshot, in ``dtype`` (float32; bfloat16 for the control)."""

    def __init__(self, config, seed, device, setup_view, dtype=torch.float32):
        self.config = config
        self.dtype = dtype
        snap = check.snapshot(config, seed, device)
        self.ps, mass = snap["pos_smooth"], snap["mass"]
        self.values = torch.stack(
            [mass, mass * snap["quantities"][config["quantity"]]], dim=1)
        self.res = config["resolution"]
        self.lut = reference.lut(config["colormap"], device, dtype)
        self.cmap = reference.autorange(
            reference.weighted_content(self.raw(setup_view)))

    def raw(self, view):
        return reference.additive(self.ps, self.values, check.matrix(view),
                                  self.res, view["scale"], dtype=self.dtype)

    def frame(self, raw):
        w, h = self.config["canvas"]
        return reference.present(
            reference.univariate_rgba(raw, self.cmap, self.lut), w, h)


def compare(raw, raw_ref, frame, frame_ref) -> dict:
    """The numbers of one answer against its reference."""
    a = raw.double().cpu()
    b = raw_ref.double().cpu()
    rel = max(float((a[..., c] - b[..., c]).abs().max()
                    / max(float(b[..., c].abs().max()), 1e-300))
              for c in range(b.shape[-1]))
    if not bool(torch.isfinite(a).all()):
        rel = float("inf")
    return {"raw_max_rel": rel,
            "rgba_mean_abs": check.rgba_mean_abs(frame, frame_ref)}
