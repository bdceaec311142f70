"""Screen-space line overlays: crosshairs and the periodic sim-cube wireframe.

A pinned copy of ``topsy_tpu/overlays/line.py``: lines are drawn with
anti-aliased cv2 strokes (``cv2`` imported where a line is drawn) onto a
transparent layer that is alpha-composited over the presentation image.
"""

from __future__ import annotations

import numpy as np

from ..camera import world_to_clip_matrix


class Line:
    """Polyline in clip space; NaN/sentinel points >10 in magnitude split
    segments (the reference uses an off-screen point the same way,
    reference: visualizer.py:88-93)."""

    def __init__(self, visualizer, points, color=(1, 1, 1, 1), width=10.0):
        self._visualizer = visualizer
        self.points = np.asarray(points, dtype=np.float64)
        self.color = color
        self.width = width

    def get_clipspace_points(self) -> np.ndarray:
        return self.points

    def composite(self, target: np.ndarray):
        import cv2
        H, W = target.shape[:2]
        pts = self.get_clipspace_points()
        layer = np.zeros((H, W, 4), dtype=np.float32)
        thickness = max(1, int(round(self.width * H / 2000.0)))
        color = tuple(float(c) for c in self.color[:3]) + (1.0,)

        def to_px(p):
            return (int(round((p[0] + 1.0) / 2.0 * W)),
                    int(round((1.0 - p[1]) / 2.0 * H)))

        for a, b in zip(pts[:-1], pts[1:]):
            if np.any(np.abs(a[:2]) > 10) or np.any(np.abs(b[:2]) > 10):
                continue  # segment break sentinel
            if len(a) > 3 and (a[3] > 10 or b[3] > 10):
                continue
            cv2.line(layer, to_px(a), to_px(b), color, thickness,
                     lineType=cv2.LINE_AA)
        alpha = layer[..., 3:4] * self.color[3]
        target[..., :3] = layer[..., :3] * alpha + target[..., :3] * (1 - alpha)


class SimCube(Line):
    """Wireframe of the periodic box, transformed by the current view matrix
    (reference: src/topsy/simcube.py)."""

    _corners = np.array([[x, y, z] for x in (0, 1) for y in (0, 1) for z in (0, 1)],
                        dtype=np.float64)
    _edges = [(0, 1), (0, 2), (0, 4), (1, 3), (1, 5), (2, 3), (2, 6),
              (3, 7), (4, 5), (4, 6), (5, 7), (6, 7)]

    def __init__(self, visualizer, color=(1, 1, 1, 0.3), width=10.0):
        super().__init__(visualizer, np.zeros((0, 4)), color, width)

    def get_clipspace_points(self) -> np.ndarray:
        vis = self._visualizer
        period = vis.periodicity_scale
        if period is None or not np.isfinite(period):
            return np.zeros((0, 4))
        m = world_to_clip_matrix(vis.rotation_matrix, vis.position_offset, vis.scale)
        corners_world = (self._corners - 0.5) * period
        h = np.concatenate([corners_world, np.ones((8, 1))], axis=1)
        clip = h @ m.T
        pts = []
        sentinel = np.array([100.0, 100.0, 0.0, 0.0])
        for a, b in self._edges:
            pts.extend([clip[a][:4], clip[b][:4], sentinel])
        return np.asarray(pts)

    def composite(self, target: np.ndarray):
        import cv2
        H, W = target.shape[:2]
        pts = self.get_clipspace_points()
        if len(pts) == 0:
            return
        layer = np.zeros((H, W, 4), dtype=np.float32)
        thickness = max(1, int(round(self.width * H / 2000.0)))

        def to_px(p):
            return (int(round((p[0] + 1.0) / 2.0 * W)),
                    int(round((1.0 - p[1]) / 2.0 * H)))

        i = 0
        while i + 1 < len(pts):
            a, b = pts[i], pts[i + 1]
            i += 3  # edge pairs separated by sentinels
            if np.any(np.abs(a[:2]) > 50) or np.any(np.abs(b[:2]) > 50):
                continue
            cv2.line(layer, to_px(a), to_px(b), (1.0, 1.0, 1.0, 1.0), thickness,
                     lineType=cv2.LINE_AA)
        alpha = layer[..., 3:4] * self.color[3]
        target[..., :3] = layer[..., :3] * alpha + target[..., :3] * (1 - alpha)
