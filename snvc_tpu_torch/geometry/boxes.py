"""3D box geometry, host numpy (port of snvc_tpu/geometry/boxes.py, every
function with JAX's signature).  Boxes are [h, w, l, x, y, z, ry],
bottom-centered, rect frame; the 9 parts are the box center then the 8
corners, in the reference's order (vernier.py:740-751)."""

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


def parts_object_frame(box3d) -> np.ndarray:
    """The 9 part points in the object frame, [..., 9, 3]; only the dims
    of box3d [..., 7] are read."""
    box3d = np.asarray(box3d)
    h, w, l = box3d[..., 0:1], box3d[..., 1:2], box3d[..., 2:3]
    return np.stack([l * PART_X, h * PART_Y, w * PART_Z], axis=-1)


def box_parts_cam(box3d) -> np.ndarray:
    """Camera-frame coordinates of the 9 parts (center + 8 corners),
    [..., 9, 3] (reference get_cam_cord, vernier.py:753-765)."""
    box3d = np.asarray(box3d)
    rotated = np.einsum("...ij,...nj->...ni", rot_y(box3d[..., 6]),
                        parts_object_frame(box3d))
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


def object_basis(box3d) -> np.ndarray:
    """Basis of the object frame, [..., 3, 3]: columns are the w, h and l
    directions in the camera frame, rot_y(ry) @ B with B's columns
    [0, 0, -1], [0, 1, 0], [1, 0, 0] (reference vernier.py:596-612).
    Camera offsets map to object coordinates by ``offset @ basis``."""
    box3d = np.asarray(box3d)
    B = np.array([[0.0, 0.0, 1.0], [0.0, 1.0, 0.0], [-1.0, 0.0, 0.0]])
    return rot_y(box3d[..., 6]) @ B


def grid_to_cam(grid_local, box3d) -> np.ndarray:
    """Vernier-grid points [..., N, 3] (x: width, y: height, z: length of
    the object frame) -> camera frame: about the box *center*, turned by
    ry + pi / 2 (reference KITTIRefinement_dataset.py:828-846)."""
    box3d = np.asarray(box3d)
    R = rot_y(box3d[..., 6] + 0.5 * np.pi)
    center = np.concatenate([box3d[..., 3:4],
                             box3d[..., 4:5] - 0.5 * box3d[..., 0:1],
                             box3d[..., 5:6]], axis=-1)
    return (np.einsum("...ij,...nj->...ni", R, np.asarray(grid_local))
            + center[..., None, :])


# the six faces as (p1, p2, p3) indices into the 8 corners (parts 1..8):
# front (+x object), back, left (+z object), right, top, bottom; the
# normal (p2 - p1) x (p3 - p2) points outward
_FACES = np.array([[1, 0, 2], [7, 6, 4], [5, 4, 0], [3, 2, 6], [0, 4, 6],
                   [7, 5, 1]])


def cuboid_planes(corners8) -> np.ndarray:
    """Outward plane coefficients [..., 6, 4] of a cuboid from its 8
    corners [..., 8, 3]; a point p is inside iff [p, 1] . plane < 0 for
    all six (reference bounding_box.py:360-390)."""
    corners8 = np.asarray(corners8)
    p1 = corners8[..., _FACES[:, 0], :]
    p2 = corners8[..., _FACES[:, 1], :]
    p3 = corners8[..., _FACES[:, 2], :]
    n = np.cross(p2 - p1, p3 - p2)
    d = -np.sum(p1 * n, axis=-1, keepdims=True)
    return np.concatenate([n, d], axis=-1)


def points_in_cuboid(points, corners8) -> np.ndarray:
    """Boolean mask [..., N] of points [..., N, 3] inside the cuboid of
    corners8 [..., 8, 3]: the half-space test against its six planes."""
    planes = cuboid_planes(corners8)
    s = np.einsum("...nk,...fk->...nf", np.asarray(points), planes[..., :3])
    s = s + planes[..., None, :, 3]
    return np.all(s < 0, axis=-1)


def points_in_box3d(points, box3d, tol: float = 0.0) -> np.ndarray:
    """Mask of points inside an upright box3d: rotated into the object
    frame and compared with the half-dims grown by ``tol``."""
    box3d = np.asarray(box3d)
    pts = np.asarray(points)
    center = box3d[..., 3:6].copy()
    center[..., 1] -= 0.5 * box3d[..., 0]
    R = rot_y(box3d[..., 6])
    local = np.einsum("...ji,...nj->...ni", R, pts - center[..., None, :])
    hx = 0.5 * box3d[..., 2] + tol  # l along object x
    hy = 0.5 * box3d[..., 0] + tol
    hz = 0.5 * box3d[..., 1] + tol  # w along object z
    return ((np.abs(local[..., 0]) < hx) & (np.abs(local[..., 1]) < hy)
            & (np.abs(local[..., 2]) < hz))


def canonical_bev_parts(w, l) -> np.ndarray:
    """BEV (x, z) of the 9 parts of an unrotated box at the origin, [2, 9]
    (reference vernier.py:614-622)."""
    return np.stack([PART_X * l, PART_Z * w], axis=0)


def corners_to_dims(corners8):
    """(h, w, l) [..., 3] from 8 corners in the part order (reference
    numpy_utils.get_dimention_from_corners:42-61)."""
    corners8 = np.asarray(corners8)
    l = np.linalg.norm(corners8[..., 0, :] - corners8[..., 4, :], axis=-1)
    h = np.linalg.norm(corners8[..., 0, :] - corners8[..., 1, :], axis=-1)
    w = np.linalg.norm(corners8[..., 0, :] - corners8[..., 2, :], axis=-1)
    return np.stack([h, w, l], axis=-1)


def fcos_centerness(l, t, r, b):
    """FCOS centerness sqrt(min(l, r) / max(l, r) * min(t, b) / max(t, b))
    (reference torch_utils.compute_centerness_targets:100-105)."""
    lr = np.minimum(l, r) / np.maximum(np.maximum(l, r), 1e-9)
    tb = np.minimum(t, b) / np.maximum(np.maximum(t, b), 1e-9)
    return np.sqrt(np.clip(lr * tb, 0, None))


# --- quaternions (reference bounding_box.py:439-470) -----------------------


def quat_to_euler(qw, qx, qy, qz):
    """Quaternion -> (rx, ry, rz) Euler angles."""
    rx = np.arctan2(2.0 * (qw * qx + qy * qz),
                    1.0 - 2.0 * (qx * qx + qy * qy))
    ry = np.arcsin(np.clip(2.0 * (qw * qy - qz * qx), -1.0, 1.0))
    rz = np.arctan2(2.0 * (qw * qz + qx * qy),
                    1.0 - 2.0 * (qy * qy + qz * qz))
    return rx, ry, rz


def euler_to_quat(rx, ry, rz):
    """Euler (roll rx, pitch ry, yaw rz) -> quaternion (w, x, y, z)."""
    cy, sy = np.cos(rz * 0.5), np.sin(rz * 0.5)
    cp, sp = np.cos(ry * 0.5), np.sin(ry * 0.5)
    cr, sr = np.cos(rx * 0.5), np.sin(rx * 0.5)
    qw = cy * cp * cr + sy * sp * sr
    qx = cy * cp * sr - sy * sp * cr
    qy = sy * cp * sr + cy * sp * cr
    qz = sy * cp * cr - cy * sp * sr
    return qw, qx, qy, qz


def quat_to_rotation(q0, q1, q2, q3):
    """Quaternion -> 3x3 rotation matrix [..., 3, 3]."""
    return np.stack([
        np.stack([q0 * q0 + q1 * q1 - q2 * q2 - q3 * q3,
                  2 * (q1 * q2 - q0 * q3), 2 * (q0 * q2 + q1 * q3)], -1),
        np.stack([2 * (q1 * q2 + q0 * q3),
                  q0 * q0 - q1 * q1 + q2 * q2 - q3 * q3,
                  2 * (q2 * q3 - q0 * q1)], -1),
        np.stack([2 * (q1 * q3 - q0 * q2), 2 * (q0 * q1 + q2 * q3),
                  q0 * q0 - q1 * q1 - q2 * q2 + q3 * q3], -1),
    ], axis=-2)
