"""3D box part geometry (the part of snvc_tpu/geometry/boxes.py the serving
paths and the visualisations use).  Boxes are [h, w, l, x, y, z, ry],
bottom-centered, rect frame."""

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


# BEV 4-corner ordering of a (x, z, w, l, angle) box (JAX
# geometry/boxes.py:29-32, the reference's box2corners)
BEV_X = np.array([0.5, -0.5, -0.5, 0.5])
BEV_Y = np.array([0.5, 0.5, -0.5, -0.5])


def bev_box_corners(boxes) -> np.ndarray:
    """4 BEV corners [..., 4, 2] of (cx, cy, w, h, angle) boxes, the angle
    counter-clockwise-positive (JAX geometry/boxes.py:186-197)."""
    boxes = np.asarray(boxes)
    w, h = boxes[..., 2:3], boxes[..., 3:4]
    x4 = w * BEV_X
    y4 = h * BEV_Y
    c, s = np.cos(boxes[..., 4:5]), np.sin(boxes[..., 4:5])
    rx = x4 * c - y4 * s + boxes[..., 0:1]
    ry_ = x4 * s + y4 * c + boxes[..., 1:2]
    return np.stack([rx, ry_], axis=-1)


def box3d_to_bev(box3d) -> np.ndarray:
    """box3d [..., 7] -> BEV (x, z, w = the box's length, h = its width,
    angle) with the KITTI clockwise yaw flipped to counter-clockwise (JAX
    geometry/boxes.py:200-215)."""
    box3d = np.asarray(box3d)
    return np.stack([box3d[..., 3], box3d[..., 5], box3d[..., 2],
                     box3d[..., 1], -box3d[..., 6]], axis=-1)
