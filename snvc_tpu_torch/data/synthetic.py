"""Synthetic data (the part of snvc_tpu/data/synthetic.py the serving and
training paths, the smoke run and its KITTI tree use): random boxes in
front of the default stereo calibration, noisy proposals, random images,
LiDAR-like points on each car's surface, the KITTI calibration text and
a fake detector's proposal files.  The draws are the JAX module's, in its
order, so one seed gives the same arrays in both.  The renderer
(``render_scene`` / ``make_synthetic_kitti``) is not ported: it is built
on cv2's warps and fills."""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from snvc_tpu_torch.data.pipeline import crop_transforms, select_points
from snvc_tpu_torch.geometry.boxes import box_corners_cam, rot_y
from snvc_tpu_torch.geometry.calib import (
    Calibration,
    KittiLabel,
    format_label,
    ry_to_alpha,
)

IMG_H, IMG_W = 375, 1242  # KITTI's native frame


def calib_text() -> str:
    """The KITTI calib file of the default stereo pair (JAX
    ``_calib_text``, synthetic.py:33)."""
    P2 = "7.070493e+02 0.000000e+00 6.040814e+02 4.575831e+01 0.000000e+00 7.070493e+02 1.805066e+02 -3.454157e-01 0.000000e+00 0.000000e+00 1.000000e+00 4.981016e-03"
    P3 = "7.070493e+02 0.000000e+00 6.040814e+02 -3.372877e+02 0.000000e+00 7.070493e+02 1.805066e+02 2.199936e+00 0.000000e+00 0.000000e+00 1.000000e+00 2.729905e-03"
    V2C = "0.0 -1.0 0.0 0.0 0.0 0.0 -1.0 0.0 1.0 0.0 0.0 0.0"
    R0 = "1.0 0.0 0.0 0.0 1.0 0.0 0.0 0.0 1.0"
    P0 = "7.070493e+02 0.000000e+00 6.040814e+02 0.000000e+00 0.000000e+00 7.070493e+02 1.805066e+02 0.000000e+00 0.000000e+00 0.000000e+00 1.000000e+00 0.000000e+00"
    return (
        f"P0: {P0}\nP1: {P0}\nP2: {P2}\nP3: {P3}\n"
        f"R0_rect: {R0}\nTr_velo_to_cam: {V2C}\n"
    )


# per-class dimension priors [h, w, l] low/high
_DIM_PRIORS = {
    "Car": ((1.4, 1.5, 3.3), (1.7, 1.8, 4.3)),
    "Pedestrian": ((1.6, 0.5, 0.5), (1.9, 0.7, 0.8)),
    "Cyclist": ((1.6, 0.5, 1.6), (1.9, 0.7, 1.9)),
}


def random_box(rng: np.random.Generator, cls: str = "Car") -> np.ndarray:
    """[h, w, l, x, y, z, ry] bottom-centered, in front of the camera."""
    lo, hi = _DIM_PRIORS[cls]
    z = rng.uniform(12.0, 35.0)
    x = rng.uniform(-0.25, 0.25) * z * 0.5
    return np.array([rng.uniform(lo[0], hi[0]), rng.uniform(lo[1], hi[1]),
                     rng.uniform(lo[2], hi[2]), x, 1.65 + rng.normal() * 0.05,
                     z, rng.uniform(-np.pi, np.pi)], dtype=np.float32)


def box2d_of(box3d: np.ndarray, calib: Calibration) -> np.ndarray:
    """The image box [x1, y1, x2, y2] of a 3D box's projected corners,
    clipped to the KITTI frame."""
    uv = calib.rect_to_image(box_corners_cam(box3d))
    box2d = np.array([uv[:, 0].min(), uv[:, 1].min(), uv[:, 0].max(),
                      uv[:, 1].max()])
    return np.clip(box2d, 0, [IMG_W - 1, IMG_H - 1, IMG_W - 1, IMG_H - 1])


def write_predictions(out_dir: str, all_boxes: List[np.ndarray],
                      noise: float = 0.25, seed: int = 1) -> None:
    """Noisy copies of the GT as a fake detector's proposal files
    (JAX synthetic.py:421)."""
    rng = np.random.default_rng(seed)
    cl = Calibration.default()
    os.makedirs(out_dir, exist_ok=True)
    for fi, boxes in enumerate(all_boxes):
        lines = []
        for b in boxes:
            p = b.copy()
            p[3] += rng.normal() * noise
            p[5] += rng.normal() * noise
            p[6] += rng.normal() * 0.08
            lab = KittiLabel(
                type="Car", truncation=0.0, occlusion=0,
                alpha=ry_to_alpha(p[3], p[5], p[6]),
                box2d=box2d_of(p, cl).astype(np.float32), box3d=p,
                score=float(rng.uniform(0.5, 1.0)))
            lines.append(format_label(lab))
        with open(os.path.join(out_dir, f"{fi:06d}.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")


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
    """A geometry-consistent instance batch as a dict of numpy arrays, with
    the keys of ``InstanceBatch.arrays()`` (``points`` [I, 1024, 3])."""
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
        gt = random_box(rng)
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
