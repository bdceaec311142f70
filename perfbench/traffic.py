"""The one generator of the benchmark's traffic: a user's closed loop of
view changes, read from a traffic file of parameters and a seed.

A traffic file (``traffic/<name>.json``) holds:

* ``draw``: ``"export"`` (each step draws one EXPORT frame, as a movie or
  image export does) or ``"view"`` (each step is a view change followed by
  a CHANGE draw and REFINE draws until the view is complete);
* ``turn_rad``: a turn about the vertical axis per step (a turntable);
* ``drag_rad`` and ``drag_directions``: a drag of that angle per step,
  step i along the (i mod D)-th of D evenly spaced screen directions in
  an order shuffled by the seed, forward for D steps and then back along
  the same directions for D steps, so the view wanders at most a few
  drags from where it started and repeats only every 2D steps;
* ``zoom``: ``{"factor", "min", "max"}``, the scale stepped by ``factor``
  each step along a triangle sweep from ``min`` to ``max`` and back (the
  last step up to ``max`` may be shorter), starting at a seeded phase;
* ``warmup_steps``: steps drawn in set-up before the window, enough to
  reach every shape and cache the window uses;
* ``samples``: how many of the window's answers (frames or completed
  views) the check keeps, drawn uniformly from all of them by the seed.

The seed also sets the starting turn about the vertical axis.  Every seed
gets the same set of step sizes; only their order and the start differ.
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass


@dataclass(frozen=True)
class Step:
    """One user action: ``rotate`` (x_angle, y_angle) for
    ``Visualizer.rotate`` (x_angle turns about the vertical axis), and the
    scale to set first, or None."""

    rotate: tuple[float, float]
    scale: float | None


class Traffic:
    def __init__(self, params: dict, seed: int):
        self.params = params
        self.draw = params["draw"]
        if self.draw not in ("export", "view"):
            raise ValueError(f"unknown draw {self.draw!r}")
        self._rng = random.Random(int(seed))
        self.start_turn = self._rng.uniform(0.0, 2.0 * math.pi)
        n_dir = int(params.get("drag_directions", 0))
        self._directions = [2.0 * math.pi * k / n_dir for k in range(n_dir)]
        self._rng.shuffle(self._directions)
        zoom = params.get("zoom")
        self._scales = []
        if zoom:
            f, lo, hi = zoom["factor"], zoom["min"], zoom["max"]
            levels = int(math.floor(math.log(hi / lo) / math.log(f) + 1e-9))
            self._scales = [lo * f ** j for j in range(levels + 1)]
            if self._scales[-1] < hi * (1.0 - 1e-9):
                self._scales.append(hi)
                levels += 1
            period = max(1, 2 * levels)
            self._phase = self._rng.randrange(period)
        self.warmup_steps = int(params.get("warmup_steps", 0))
        self.samples = int(params.get("samples", 6))
        self.sample_rng = random.Random(int(seed) ^ 0x5EED)

    def _scale_at(self, i: int):
        if not self._scales:
            return None
        levels = len(self._scales) - 1
        k = (i + self._phase) % (2 * levels)
        return self._scales[k if k <= levels else 2 * levels - k]

    def step(self, i: int) -> Step:
        """The i-th step (warm-up steps first, then the window's)."""
        x = y = 0.0
        turn = self.params.get("turn_rad", 0.0)
        x += turn
        drag = self.params.get("drag_rad", 0.0)
        if drag and self._directions:
            d = len(self._directions)
            theta = self._directions[i % d]
            sign = 1.0 if (i // d) % 2 == 0 else -1.0
            x += sign * drag * math.cos(theta)
            y += sign * drag * math.sin(theta)
        return Step(rotate=(x, y), scale=self._scale_at(i))


def reservoir(rng: random.Random, k: int):
    """Uniform sampling of ``k`` items from a stream of unknown length:
    ``take(i)`` says into which slot the i-th item goes, or None."""

    def take(i: int):
        if i < k:
            return i
        j = rng.randrange(i + 1)
        return j if j < k else None

    return take
