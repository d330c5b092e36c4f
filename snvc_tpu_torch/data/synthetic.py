"""Synthetic instance batches (the part of snvc_tpu/data/synthetic.py the
serving and training paths and the smoke run use): random car boxes in
front of the default stereo calibration, noisy proposals, random images
and LiDAR-like points on each car's surface.  The draws are the JAX
module's, in its order, so one seed gives the same arrays in both."""

from __future__ import annotations

from typing import Dict

import numpy as np

from snvc_tpu_torch.data.pipeline import crop_transforms, select_points
from snvc_tpu_torch.geometry.boxes import rot_y
from snvc_tpu_torch.geometry.calib import Calibration


def random_car_box(rng: np.random.Generator) -> np.ndarray:
    """[h, w, l, x, y, z, ry] bottom-centered car in front of the camera."""
    z = rng.uniform(12.0, 35.0)
    x = rng.uniform(-0.25, 0.25) * z * 0.5
    return np.array([rng.uniform(1.4, 1.7), rng.uniform(1.5, 1.8),
                     rng.uniform(3.3, 4.3), x, 1.65 + rng.normal() * 0.05, z,
                     rng.uniform(-np.pi, np.pi)], dtype=np.float32)


def surface_points(box: np.ndarray, rng, n: int = 400) -> np.ndarray:
    """LiDAR-like points on the camera-facing surfaces of a box, rect frame
    (JAX synthetic.py:206)."""
    h, w, l = box[0], box[1], box[2]
    u = rng.uniform(-0.5, 0.5, size=(n, 2))
    face = rng.integers(0, 3, size=n)
    pts = np.zeros((n, 3))
    # object frame: x along length, y from -h to 0, z along width
    pts[:, 0] = np.where(face == 0, -0.5 * l, u[:, 0] * l)
    pts[:, 2] = np.where(face == 1, -0.5 * w, u[:, 1] * w * 0.5)
    pts[:, 1] = np.where(face != 2, (u[:, 1] - 0.5) * h, -h)
    return (rot_y(box[6]) @ pts.T).T + box[3:6]


def synthetic_batch_arrays(cfg, seed: int = 0,
                           frames: int = 1) -> Dict[str, np.ndarray]:
    """A geometry-consistent instance batch as a dict of numpy arrays: the
    serving keys of ``InstanceBatch.arrays()`` plus the training keys
    ``gt_boxes`` [I, 7], ``points`` [I, 1024, 3] and ``points_valid``."""
    rng = np.random.default_rng(seed)
    I = cfg.max_instances
    img_h, img_w = cfg.image_size
    cl, cr = Calibration.default(), Calibration.default_right()
    images_left = rng.integers(0, 255, size=(frames, img_h, img_w, 3),
                               dtype=np.uint8)
    images_right = rng.integers(0, 255, size=(frames, img_h, img_w, 3),
                                dtype=np.uint8)
    samples = np.zeros((I, 7), np.float32)
    gt_boxes = np.zeros((I, 7), np.float32)
    trans_l = np.tile(np.eye(2, 3, dtype=np.float32), (I, 1, 1))
    trans_r = trans_l.copy()
    Np = 1024
    points = np.zeros((I, Np, 3), np.float32)
    points_valid = np.zeros((I, Np), bool)
    for k in range(I):
        gt = random_car_box(rng)
        prop = gt.copy()
        prop[3] += rng.normal() * 0.2
        prop[5] += rng.normal() * 0.2
        prop[6] += rng.normal() * 0.05
        gt_boxes[k] = gt
        samples[k] = prop
        trans_l[k], trans_r[k] = crop_transforms(prop, cl, cr, cfg)
        pc = surface_points(gt, rng, n=600).astype(np.float32)
        points[k], points_valid[k] = select_points(pc, prop, cfg, Np)
    return dict(
        images_left=images_left, images_right=images_right,
        P_left=np.tile(cl.as_array()[None], (frames, 1, 1)),
        P_right=np.tile(cr.as_array()[None], (frames, 1, 1)),
        image_idx=rng.integers(0, frames, size=I).astype(np.int32),
        trans_l=trans_l, trans_r=trans_r, samples=samples,
        valid=np.ones(I, bool), gt_boxes=gt_boxes, points=points,
        points_valid=points_valid)
