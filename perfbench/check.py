"""The comparison that decides ``correct``.

After the window has closed and the program's state is freed, the
configuration's check renders, from the seed's snapshot made anew, the
views of the answers the harness kept (a seeded uniform sample of the
window's EXPORT frames or completed views), and the colormap's range at
the view where the program took it.  Each number compared is the worst
over the kept answers, and has its limit in the configuration's file
(``limits``).

A configuration names its parts by module (a Python identifier), each
found by that name:

* ``"snapshot"``: ``snapshots/<name>.py``, whose ``make(config, seed,
  device)`` returns the snapshot as a dict of tensors on ``device``:
  ``pos_smooth`` (n, 4), ``mass`` (n,), ``quantities`` {name: (n,)}, and
  optionally ``rgb`` (n, 3) band masses and ``periodicity_scale`` (a
  float).  The harness hands it to the program and the check makes it
  again for the reference.
* ``"check"``: ``checks/<name>.py``, with ``Reference(config, seed,
  device, setup_view, dtype=torch.float32)`` (``.cmap``, the colormap's
  range at the setup view; ``.raw(view)``, the raw image of a view;
  ``.frame(raw)``, the presented uint8 frame) and ``compare(raw, raw_ref,
  frame, frame_ref)``, the numbers of one answer under the names that the
  configuration's ``limits`` bound.  The control computes the same
  ``Reference`` in bfloat16.

A name that has no module fails the run; a number that ``compare`` does
not give fails the limit that bounds it.
"""

from __future__ import annotations

import importlib
import os

import numpy as np

from . import reference

HERE = os.path.dirname(os.path.abspath(__file__))


def named(kind: str, name: str):
    """The module ``<kind>/<name>.py`` (``snapshots``, ``checks``)."""
    if not os.path.isfile(os.path.join(HERE, kind, f"{name}.py")):
        raise ModuleNotFoundError(f"perfbench/{kind}/{name}.py: no {kind} "
                                  f"module named {name!r}")
    return importlib.import_module(f"{__package__}.{kind}.{name}")


def snapshot(config, seed, device) -> dict:
    """The seed's snapshot of the configuration's ``snapshot`` module."""
    return named("snapshots", config["snapshot"]).make(config, seed, device)


def module(config):
    """The configuration's ``check`` module."""
    return named("checks", config["check"])


def matrix(view):
    return reference.clip_matrix(view["rotation"], view["offset"],
                                 view["scale"])


def rgba_mean_abs(frame, frame_ref) -> float:
    """The mean absolute difference of the presented 8-bit RGB, in levels."""
    return float(np.abs(frame[..., :3].astype(np.int16)
                        - frame_ref[..., :3].astype(np.int16)).mean())


def within(numbers: dict, limits: dict) -> bool:
    return all(k in numbers and numbers[k] <= lim for k, lim in limits.items())


def run(config, seed, device, setup_view, samples):
    """(the worst of each number over the kept answers ``samples``, the
    count of those answers outside a limit, the reference's colormap
    range); ``samples``: (index in the window, view, raw image, presented
    frame) each."""
    judge = module(config)
    if not samples:
        return {}, 0, None
    ref = judge.Reference(config, seed, device, setup_view)
    worst, failed = {}, 0
    for _, view, raw, frame in samples:
        raw_ref = ref.raw(view)
        got = judge.compare(raw, raw_ref, frame, ref.frame(raw_ref))
        failed += not within(got, config["limits"])
        for k, v in got.items():
            worst[k] = max(worst.get(k, -np.inf), v)
    return worst, failed, ref.cmap
