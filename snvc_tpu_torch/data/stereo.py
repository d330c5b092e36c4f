"""Stereo requests and training frames: image normalization, the host
checks on the projections, the LiDAR depth raster and a seeded synthetic
frame (the serving and training parts of snvc_tpu/data/stereo_pipeline.py
and snvc_tpu/training/train_stereo.py:35-41)."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from snvc_tpu_torch.config import StereoConfig
from snvc_tpu_torch.data.synthetic import random_box, surface_points
from snvc_tpu_torch.geometry.calib import Calibration
from snvc_tpu_torch.ops.augment import normalize

# KITTI's native image size, which a smaller input is downscaled from
KITTI_HW = (375, 1242)


def normalize_images(img_u8: torch.Tensor) -> torch.Tensor:
    """uint8 [..., 3] -> ImageNet-normalized float32."""
    return normalize(img_u8.float() / 255.0)


def check_stereo_projections(P_left, P_right) -> None:
    """Raises unless the host arrays P_left / P_right [N, 3, 4] are what
    the kernels take: rectified (P[:, 2, :2] == 0: the frustum resample
    K4 assumes it) and with a non-negative disparity, fu * baseline >= 0
    (the plane-sweep shifts of K3 must be >= 0).  Checked on the host
    copy, so the card is never asked for P or the shift table."""
    Pl, Pr = (np.asarray(P, np.float64) for P in (P_left, P_right))
    for k, P in (("P_left", Pl), ("P_right", Pr)):
        if np.any(P[:, 2, :2] != 0):
            raise ValueError(f"{k} must be rectified (P[:, 2, :2] == 0)")
    fu = Pl[:, 0, 0]
    baseline = Pr[:, 0, 3] / -Pr[:, 0, 0] - Pl[:, 0, 3] / -Pl[:, 0, 0]
    if not np.all(fu * baseline >= 0):
        raise ValueError("P_left/P_right give a negative disparity "
                         "(fu * baseline < 0): the plane-sweep shifts "
                         "must be >= 0")


def rasterize_depth(pc_rect: np.ndarray, P: np.ndarray, hw,
                    stride: int = 4) -> np.ndarray:
    """Sparse z-buffer of point depths at feature stride (JAX
    stereo_pipeline.py:46): the nearest point's z of each [H/stride,
    W/stride] cell, -1 where none lands.  P is the 3x4 rect -> image
    projection of the (possibly downscaled) image."""
    H, W = hw
    Hs, Ws = H // stride, W // stride
    uvw = pc_rect @ P[:, :3].T + P[:, 3]
    uv = uvw[:, :2] / uvw[:, 2:3]
    z = pc_rect[:, 2]
    u = np.floor(uv[:, 0] / stride).astype(np.int64)
    v = np.floor(uv[:, 1] / stride).astype(np.int64)
    ok = (z > 0.5) & (u >= 0) & (u < Ws) & (v >= 0) & (v < Hs)
    u, v, z = u[ok], v[ok], z[ok]
    depth = np.full(Hs * Ws, np.inf, np.float32)
    np.minimum.at(depth, v * Ws + u, z.astype(np.float32))
    depth[~np.isfinite(depth)] = -1.0
    return depth.reshape(Hs, Ws)


def synthetic_stereo_request(cfg: StereoConfig, seed: int = 0,
                             frames: int = 1, max_gt: int = 24,
                             boxes_per_frame: int = 0
                             ) -> Dict[str, np.ndarray]:
    """A stereo frame as numpy arrays, keyed like ``StereoBatch.arrays()``:
    uint8 images at ``cfg.input_size`` from ``np.random.default_rng(seed)``
    and the default KITTI stereo calibration.

    With ``boxes_per_frame`` 0 (serving) the ground truth is empty.  With
    more, the frame is a training frame as the JAX pipeline builds one:
    the projections are scaled to an input smaller than KITTI's 375 x 1242
    frame (diag(s, s, 1) @ P, as ``load_image_scaled`` does; no change at
    ``StereoConfig()``'s 384 x 1248), each frame gets that many random car
    boxes (``random_box``: 12-35 m ahead) and ``depth_gt`` rasterizes
    400 surface points of each box through P_left."""
    rng = np.random.default_rng(seed)
    H, W = cfg.input_size
    cl, cr = Calibration.default(), Calibration.default_right()
    out = dict(
        images_left=rng.integers(0, 255, size=(frames, H, W, 3),
                                 dtype=np.uint8),
        images_right=rng.integers(0, 255, size=(frames, H, W, 3),
                                  dtype=np.uint8),
        gt_boxes=np.zeros((frames, max_gt, 7), np.float32),
        gt_valid=np.zeros((frames, max_gt), bool),
        gt_classes=np.zeros((frames, max_gt), np.int32),
        depth_gt=np.full((frames, H // 4, W // 4), -1.0, np.float32))
    Pl, Pr = cl.as_array(), cr.as_array()
    if boxes_per_frame:
        if boxes_per_frame > max_gt:
            raise ValueError(f"boxes_per_frame {boxes_per_frame} > max_gt "
                             f"{max_gt}")
        s = min(1.0, H / KITTI_HW[0], W / KITTI_HW[1])
        S = np.diag([s, s, 1.0]).astype(np.float32)
        Pl, Pr = S @ Pl, S @ Pr
        for f in range(frames):
            pts = []
            for k in range(boxes_per_frame):
                box = random_box(rng)
                out["gt_boxes"][f, k] = box
                pts.append(surface_points(box, rng).astype(np.float32))
            out["gt_valid"][f, :boxes_per_frame] = True
            out["depth_gt"][f] = rasterize_depth(np.concatenate(pts), Pl,
                                                 (H, W))
    out["P_left"] = np.tile(Pl[None], (frames, 1, 1))
    out["P_right"] = np.tile(Pr[None], (frames, 1, 1))
    return out
