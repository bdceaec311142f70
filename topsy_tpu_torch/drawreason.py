"""Reason a draw was requested; controls quality/laziness of each render.

A pinned copy of ``topsy_tpu/drawreason.py``.
"""

import enum


class DrawReason(enum.Enum):
    INITIAL_UPDATE = 1       # render from scratch
    CHANGE = 2               # a change occurred, possibly from the UI
    REFINE = 3               # continue progressive refinement of current view
    PRESENTATION_CHANGE = 4  # presentation-only change; do not re-render SPH
    EXPORT = 5               # full-quality render of every particle
