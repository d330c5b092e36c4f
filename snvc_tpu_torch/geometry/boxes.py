"""3D box part geometry (the part of snvc_tpu/geometry/boxes.py the serving
paths use).  Boxes are [h, w, l, x, y, z, ry], bottom-centered, rect frame."""

from __future__ import annotations

import numpy as np

PART_X = np.array([0.0, 0.5, 0.5, 0.5, 0.5, -0.5, -0.5, -0.5, -0.5])
PART_Y = np.array([-0.5, -1.0, 0.0, -1.0, 0.0, -1.0, 0.0, -1.0, 0.0])
PART_Z = np.array([0.0, 0.5, 0.5, -0.5, -0.5, 0.5, 0.5, -0.5, -0.5])


def rot_y(ry) -> np.ndarray:
    """Rotation about the camera y axis, [..., 3, 3]."""
    ry = np.asarray(ry)
    c, s = np.cos(ry), np.sin(ry)
    zero, one = np.zeros_like(c), np.ones_like(c)
    return np.stack([np.stack([c, zero, s], axis=-1),
                     np.stack([zero, one, zero], axis=-1),
                     np.stack([-s, zero, c], axis=-1)], axis=-2)


def box_parts_cam(box3d) -> np.ndarray:
    """Camera-frame coordinates of the 9 parts (center + 8 corners),
    [..., 9, 3] (reference get_cam_cord, vernier.py:753-765)."""
    box3d = np.asarray(box3d)
    h, w, l = box3d[..., 0:1], box3d[..., 1:2], box3d[..., 2:3]
    pts = np.stack([l * PART_X, h * PART_Y, w * PART_Z], axis=-1)
    rotated = np.einsum("...ij,...nj->...ni", rot_y(box3d[..., 6]), pts)
    return rotated + box3d[..., None, 3:6]


def box_corners_cam(box3d) -> np.ndarray:
    """Only the 8 corners, [..., 8, 3]."""
    return box_parts_cam(box3d)[..., 1:, :]
