"""2-D overlays composited onto the presentation canvas.

A pinned copy of ``topsy_tpu/overlays/__init__.py``.

The reference composites overlays as textured quads with alpha blending on
the GPU (reference: src/topsy/overlay.py, shaders/overlay.wgsl).  Overlay
content here is still produced host-side (matplotlib text, colorbars); the
compositing is a numpy alpha blend onto the presentation image — overlays are
tiny and outside the TPU hot path.
"""

from __future__ import annotations

from abc import ABC, abstractmethod

import numpy as np


def alpha_blend(target: np.ndarray, src: np.ndarray, row0: int, col0: int,
                weight: float = 1.0, additive: bool = False):
    """Blend RGBA ``src`` over ``target`` (both float arrays) in place,
    clipping at target edges."""
    H, W = target.shape[:2]
    h, w = src.shape[:2]
    r0, c0 = max(row0, 0), max(col0, 0)
    r1, c1 = min(row0 + h, H), min(col0 + w, W)
    if r0 >= r1 or c0 >= c1:
        return
    sub = src[r0 - row0:r1 - row0, c0 - col0:c1 - col0]
    dst = target[r0:r1, c0:c1]
    if additive:
        dst[..., :3] += sub[..., :3] * weight
        return
    a = np.clip(sub[..., 3:4] * weight, 0.0, 1.0)
    dst[..., :3] = sub[..., :3] * a + dst[..., :3] * (1.0 - a)


def resize_rgba(src: np.ndarray, height: int, width: int) -> np.ndarray:
    import cv2
    if height <= 0 or width <= 0:
        return np.zeros((max(height, 1), max(width, 1), 4), dtype=np.float32)
    return cv2.resize(src, (width, height), interpolation=cv2.INTER_LINEAR)


class Overlay(ABC):
    """Base overlay: cached RGBA contents placed via clip-space coordinates
    (contract of reference Overlay.get_clipspace_coordinates /
    render_contents, reference: overlay.py:227-271)."""

    def __init__(self, visualizer):
        self._visualizer = visualizer
        self._contents: np.ndarray | None = None

    @abstractmethod
    def get_clipspace_coordinates(self, width, height) -> tuple[float, float, float, float]:
        """(x0, y0, w, h) of the quad in clip space; (x0, y0) = lower-left."""

    @abstractmethod
    def render_contents(self) -> np.ndarray:
        """RGBA float32 image content."""

    def get_contents(self) -> np.ndarray:
        if self._contents is None:
            self._contents = np.asarray(self.render_contents(), dtype=np.float32)
        return self._contents

    def update(self):
        self._contents = None

    def composite(self, target: np.ndarray):
        """Blend this overlay onto the (H, W, 4) float presentation image."""
        H, W = target.shape[:2]
        x0, y0, w, h = self.get_clipspace_coordinates(W, H)
        if w <= 0 or h <= 0:
            return
        col0 = int(round((x0 + 1.0) / 2.0 * W))
        row1 = int(round((1.0 - y0) / 2.0 * H))          # bottom edge
        pw = max(1, int(round(w / 2.0 * W)))
        ph = max(1, int(round(h / 2.0 * H)))
        row0 = row1 - ph
        src = self.get_contents()
        if src.shape[0] != ph or src.shape[1] != pw:
            src = resize_rgba(src, ph, pw)
        alpha_blend(target, src, row0, col0)
