"""KITTI-like stereo geometry for the generated requests: the rectified
projections of a KITTI color pair, seeded car proposals in front of the
camera, and the refiner's ROI crop affines (a copy of the arithmetic of
``snvc_tpu_torch/data/pipeline.crop_transforms``, vectorized)."""

from __future__ import annotations

import numpy as np

# P2 / P3 of KITTI's calibration for the left / right color cameras
P_LEFT = np.array([[721.5377, 0.0, 609.5593, 44.85728],
                   [0.0, 721.5377, 172.854, 0.2163791],
                   [0.0, 0.0, 1.0, 0.002745884]], np.float32)
P_RIGHT = np.array([[721.5377, 0.0, 609.5593, -339.5242],
                    [0.0, 721.5377, 172.854, 2.199936],
                    [0.0, 0.0, 1.0, 0.002729905]], np.float32)

PART_X = np.array([0.0, 0.5, 0.5, 0.5, 0.5, -0.5, -0.5, -0.5, -0.5])
PART_Y = np.array([-0.5, -1.0, 0.0, -1.0, 0.0, -1.0, 0.0, -1.0, 0.0])
PART_Z = np.array([0.0, 0.5, 0.5, -0.5, -0.5, 0.5, 0.5, -0.5, -0.5])


def car_proposals(rng: np.random.Generator, n: int) -> np.ndarray:
    """[n, 7] (h, w, l, x, y, z, ry) cars 8-45 m ahead, within the view."""
    z = rng.uniform(8.0, 45.0, n)
    return np.stack([
        rng.normal(1.53, 0.07, n), rng.normal(1.63, 0.08, n),
        rng.normal(3.88, 0.30, n), z * rng.uniform(-0.35, 0.35, n),
        rng.normal(1.65, 0.10, n), z, rng.uniform(-np.pi, np.pi, n)],
        axis=1).astype(np.float32)


def _parts_cam(box):
    """[M, 9, 3] camera-frame parts (center + 8 corners) of boxes [M, 7]."""
    h, w, l = box[:, 0:1], box[:, 1:2], box[:, 2:3]
    px, py, pz = l * PART_X, h * PART_Y, w * PART_Z
    c, s = np.cos(box[:, 6:7]), np.sin(box[:, 6:7])
    return np.stack([c * px + s * pz + box[:, 3:4], py + box[:, 4:5],
                     -s * px + c * pz + box[:, 5:6]], axis=-1)


def crop_transforms(samples: np.ndarray, grid_range, resolution,
                    enlarge: float):
    """([M, 2, 3], [M, 2, 3]) float32 source->ROI affines of both views
    for proposals [M, 7]: the grid's cuboid around each proposal (its
    center kept), projected, boxed, enlarged and squared to the ROI's
    aspect, then scaled to the ROI."""
    box = samples.astype(np.float64).copy()
    center_y = box[:, 4] - 0.5 * box[:, 0]
    box[:, 0:3] = grid_range
    box[:, 4] = center_y + 0.5 * box[:, 0]
    pts = _parts_cam(box)
    hom = np.concatenate([pts, np.ones(pts.shape[:2] + (1,))], -1)
    out_h, out_w = resolution
    aspect = out_h / out_w
    res = []
    for P in (P_LEFT, P_RIGHT):
        uvw = hom @ P.astype(np.float64).T
        uv = uvw[..., :2] / uvw[..., 2:3]
        lo, hi = uv.min(1), uv.max(1)
        center = 0.5 * (lo + hi)
        w = (hi[:, 0] - lo[:, 0]) * enlarge
        h = (hi[:, 1] - lo[:, 1]) * enlarge
        tall = h / np.maximum(w, 1e-12) > aspect
        w = np.where(tall, h / aspect, w)
        k = out_w / w
        t = np.zeros((len(box), 2, 3))
        t[:, 0, 0] = t[:, 1, 1] = k
        t[:, 0, 2] = 0.5 * out_w - k * center[:, 0]
        t[:, 1, 2] = 0.5 * out_h - k * center[:, 1]
        res.append(t.astype(np.float32))
    return res[0], res[1]
