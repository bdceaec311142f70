"""World-to-clip transform and the drag rotations.

A pinned copy of ``x_rotation_matrix``, ``y_rotation_matrix`` and
``world_to_clip_matrix`` from ``topsy_tpu/camera.py``: a rotation about the
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
