"""The check of a surface (``render_mode`` surface): the (winning value,
depth) image above the configuration's density cut, lit and filtered.

* ``depth_off_share``: the share of pixels covered by either image that
  the other does not cover or whose depth differs beyond rtol 1e-5 /
  atol 1e-4;
* ``value_off_share``: the share of pixels both cover whose winning value
  differs beyond rtol 1e-5 / atol 1e-6;
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
        self.ps, self.mass = snap["pos_smooth"], snap["mass"]
        self.qty = snap["quantities"][config["quantity"]]
        self.res = config["resolution"]
        self.cut = reference.density_cut(
            self.mass, self.ps[:, 3], config["density_cut_percentile"])
        self.lut = reference.lut(config["colormap"], device, dtype)
        self.cmap = reference.surface_autorange(self.raw(setup_view))

    def raw(self, view):
        return reference.surface(self.ps, self.mass, self.qty,
                                 check.matrix(view), self.res, view["scale"],
                                 self.cut, dtype=self.dtype)

    def frame(self, raw):
        w, h = self.config["canvas"]
        return reference.present(
            reference.surface_rgba(raw, self.cmap, self.lut), w, h)


def compare(raw, raw_ref, frame, frame_ref) -> dict:
    """The numbers of one answer against its reference."""
    a = raw.double().cpu()
    b = raw_ref.double().cpu()
    cov_a, cov_b = a[..., 1] > 0, b[..., 1] > 0
    either = cov_a | cov_b
    both = cov_a & cov_b
    d_ok = torch.isclose(a[..., 1], b[..., 1], rtol=1e-5, atol=1e-4) & both
    v_ok = torch.isclose(a[..., 0], b[..., 0], rtol=1e-5, atol=1e-6) & both
    n_either = max(int(either.sum()), 1)
    n_both = max(int(both.sum()), 1)
    return {"depth_off_share": float((either & ~d_ok).sum()) / n_either,
            "value_off_share": float((both & ~v_ok).sum()) / n_both,
            "rgba_mean_abs": check.rgba_mean_abs(frame, frame_ref)}
