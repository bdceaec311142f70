"""The comparison that decides ``correct``.

After the window has closed and the program's state is freed, the
reference (``reference.py``) renders, from the seed's snapshot made anew,
the views of the answers the harness kept (a seeded uniform sample of the
window's EXPORT frames or completed views), and the colormap's range at
the view where the program took it.  The numbers compared, each the worst
over the kept answers:

* an additive image (``render_mode`` univariate): ``raw_max_rel``, the
  largest pixel difference of the raw (density, mass-weighted quantity)
  image in either channel as a share of that channel's largest absolute
  reference value; ``rgba_mean_abs``, the mean absolute difference of the
  presented 8-bit RGB, in levels;
* a surface: ``depth_off_share``, the share of pixels covered by either
  image that the other does not cover or whose depth differs beyond
  rtol 1e-5 / atol 1e-4; ``value_off_share``, the share of pixels both
  cover whose winning value differs beyond rtol 1e-5 / atol 1e-6;
  ``rgba_mean_abs``.

Each number has its limit in the configuration's file (``limits``).
"""

from __future__ import annotations

import numpy as np
import torch

from . import reference


def _matrix(view):
    return reference.clip_matrix(view["rotation"], view["offset"],
                                 view["scale"])


class Reference:
    """The reference renders of one deployment over the seed's snapshot,
    in ``dtype`` (float32; bfloat16 for the control)."""

    def __init__(self, config, seed, device, setup_view, dtype=torch.float32):
        self.config = config
        self.dtype = dtype
        self.ps, self.mass, self.qty = reference.snapshot(
            config["n_particles"], seed, device, mass=config["particle_mass"])
        self.res = config["resolution"]
        self.surface = config["render_mode"] == "surface"
        if self.surface:
            self.cut = reference.density_cut(
                self.mass, self.ps[:, 3], config["density_cut_percentile"])
        else:
            self.values = torch.stack([self.mass, self.mass * self.qty], dim=1)
        self.lut = reference.lut(config["colormap"], device, dtype)
        raw0 = self.raw(setup_view)
        self.cmap = (reference.surface_autorange(raw0) if self.surface else
                     reference.autorange(reference.weighted_content(raw0)))

    def raw(self, view):
        if self.surface:
            return reference.surface(self.ps, self.mass, self.qty,
                                     _matrix(view), self.res, view["scale"],
                                     self.cut, dtype=self.dtype)
        return reference.additive(self.ps, self.values, _matrix(view),
                                  self.res, view["scale"], dtype=self.dtype)

    def frame(self, raw):
        w, h = self.config["canvas"]
        if self.surface:
            rgba = reference.surface_rgba(raw, self.cmap, self.lut)
        else:
            rgba = reference.univariate_rgba(raw, self.cmap, self.lut)
        return reference.present(rgba, w, h)


def compare(surface: bool, raw, raw_ref, frame, frame_ref) -> dict:
    """The numbers of one answer against its reference."""
    a = raw.double().cpu()
    b = raw_ref.double().cpu()
    rgba = float(np.abs(frame[..., :3].astype(np.int16)
                        - frame_ref[..., :3].astype(np.int16)).mean())
    if not surface:
        rel = max(float((a[..., c] - b[..., c]).abs().max()
                        / max(float(b[..., c].abs().max()), 1e-300))
                  for c in range(b.shape[-1]))
        if not bool(torch.isfinite(a).all()):
            rel = float("inf")
        return {"raw_max_rel": rel, "rgba_mean_abs": rgba}
    cov_a, cov_b = a[..., 1] > 0, b[..., 1] > 0
    either = cov_a | cov_b
    both = cov_a & cov_b
    d_ok = torch.isclose(a[..., 1], b[..., 1], rtol=1e-5, atol=1e-4) & both
    v_ok = torch.isclose(a[..., 0], b[..., 0], rtol=1e-5, atol=1e-6) & both
    n_either = max(int(either.sum()), 1)
    n_both = max(int(both.sum()), 1)
    return {"depth_off_share": float((either & ~d_ok).sum()) / n_either,
            "value_off_share": float((both & ~v_ok).sum()) / n_both,
            "rgba_mean_abs": rgba}


def within(numbers: dict, limits: dict) -> bool:
    return all(k in numbers and numbers[k] <= lim for k, lim in limits.items())


def run(config, seed, device, setup_view, samples):
    """(the worst of each number over the kept answers ``samples``, the
    count of those answers outside a limit, the reference's colormap
    range); ``samples``: (index in the window, view, raw image, presented
    frame) each."""
    if not samples:
        return {}, 0, None
    ref = Reference(config, seed, device, setup_view)
    worst, failed = {}, 0
    for _, view, raw, frame in samples:
        raw_ref = ref.raw(view)
        got = compare(ref.surface, raw, raw_ref, frame, ref.frame(raw_ref))
        failed += not within(got, config["limits"])
        for k, v in got.items():
            worst[k] = max(worst.get(k, -np.inf), v)
    return worst, failed, ref.cmap
