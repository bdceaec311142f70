"""World-to-clip transform and the drag rotations.

A pinned copy of ``x_rotation_matrix``, ``y_rotation_matrix``,
``world_to_clip_matrix``, ``Camera`` and ``clip_to_pixel`` from
``topsy_tpu/camera.py``: a rotation about the
origin, uniform scaling by 1/scale, a model translation by
``position_offset`` applied first, and a final squash of the z axis into
[0, 1].  Image row 0 is the top of the scene.
"""

from __future__ import annotations

import numpy as np


def x_rotation_matrix(angle: float) -> np.ndarray:
    """Rotation used for horizontal drags (reference: visualizer.py:353-357)."""
    return np.array([[np.cos(angle), 0, np.sin(angle)],
                     [0, 1, 0],
                     [-np.sin(angle), 0, np.cos(angle)]])


def y_rotation_matrix(angle: float) -> np.ndarray:
    """Rotation used for vertical drags (reference: visualizer.py:347-351)."""
    return np.array([[1, 0, 0],
                     [0, np.cos(angle), -np.sin(angle)],
                     [0, np.sin(angle), np.cos(angle)]])


def world_to_clip_matrix(rotation_matrix: np.ndarray,
                         position_offset: np.ndarray,
                         scale: float) -> np.ndarray:
    """4x4 matrix taking world-space homogeneous positions to clip space.

    clip = C @ (R/s) @ T @ [x, y, z, 1] with T the position_offset translate,
    R/s the rotation-and-scale, and C the z->[0,1] squash.
    """
    model_displace = np.eye(4)
    model_displace[:3, 3] = np.asarray(position_offset, dtype=np.float64)

    clipcoord_displace = np.array([[1.0, 0, 0, 0.0],
                                   [0, 1.0, 0, 0.0],
                                   [0, 0, 0.5, 0.5],
                                   [0, 0, 0.0, 1.0]])

    rotation_and_scaling = np.zeros((4, 4))
    rotation_and_scaling[:3, :3] = np.asarray(rotation_matrix) / scale
    rotation_and_scaling[3, 3] = 1.0

    return (clipcoord_displace @ rotation_and_scaling
            @ model_displace).astype(np.float32)


class Camera:
    """Mutable view state: rotation matrix, position offset, and scale.

    ``scale`` is the viewport half-width in world units (the viewport spans
    [-scale, scale] in the rotated x and y axes).
    """

    def __init__(self, rotation_matrix=None, position_offset=None, scale=1.0):
        self.rotation_matrix = np.eye(3) if rotation_matrix is None else np.asarray(rotation_matrix, dtype=np.float64)
        self.position_offset = np.zeros(3) if position_offset is None else np.asarray(position_offset, dtype=np.float64)
        self.scale = float(scale)

    def matrix(self) -> np.ndarray:
        return world_to_clip_matrix(self.rotation_matrix, self.position_offset, self.scale)

    def rotate(self, x_angle: float, y_angle: float):
        """Apply an incremental drag rotation (reference: visualizer.py:194-197)."""
        self.rotation_matrix = (x_rotation_matrix(x_angle)
                                @ y_rotation_matrix(y_angle)
                                @ self.rotation_matrix)

    def copy(self) -> "Camera":
        return Camera(self.rotation_matrix.copy(), self.position_offset.copy(), self.scale)


def clip_to_pixel(clip_xy: np.ndarray, resolution: int) -> np.ndarray:
    """Map clip-space (x, y) to (col, row) pixel coordinates.

    Pixel (row i, col j) has its centre at clip
    x = (j + 0.5) / res * 2 - 1, y = 1 - (i + 0.5) / res * 2; this function
    returns fractional pixel coordinates in that convention (so a particle
    exactly at pixel centre (i, j) maps to col = j, row = i).
    """
    clip_xy = np.asarray(clip_xy)
    col = (clip_xy[..., 0] + 1.0) * (resolution / 2.0) - 0.5
    row = (1.0 - clip_xy[..., 1]) * (resolution / 2.0) - 0.5
    return np.stack([col, row], axis=-1)
