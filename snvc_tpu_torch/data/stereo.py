"""Stereo detection requests: image normalization and a seeded synthetic
request (the serving part of snvc_tpu/data/stereo_pipeline.py and
snvc_tpu/training/train_stereo.py:35-41)."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from snvc_tpu_torch.config import StereoConfig
from snvc_tpu_torch.geometry.calib import Calibration

IMG_MEAN = (0.485, 0.456, 0.406)
IMG_STD = (0.229, 0.224, 0.225)


def normalize_images(img_u8: torch.Tensor) -> torch.Tensor:
    """uint8 [..., 3] -> ImageNet-normalized float32."""
    mean = torch.tensor(IMG_MEAN, device=img_u8.device)
    std = torch.tensor(IMG_STD, device=img_u8.device)
    return (img_u8.float() / 255.0 - mean) / std


def synthetic_stereo_request(cfg: StereoConfig, seed: int = 0,
                             frames: int = 1,
                             max_gt: int = 24) -> Dict[str, np.ndarray]:
    """A stereo request as numpy arrays, keyed like ``StereoBatch.arrays()``:
    uint8 images at ``cfg.input_size`` from ``np.random.default_rng(seed)``,
    the default KITTI stereo calibration, and empty ground truth (serving
    reads none of it)."""
    rng = np.random.default_rng(seed)
    H, W = cfg.input_size
    cl, cr = Calibration.default(), Calibration.default_right()
    return dict(
        images_left=rng.integers(0, 255, size=(frames, H, W, 3),
                                 dtype=np.uint8),
        images_right=rng.integers(0, 255, size=(frames, H, W, 3),
                                  dtype=np.uint8),
        P_left=np.tile(cl.as_array()[None], (frames, 1, 1)),
        P_right=np.tile(cr.as_array()[None], (frames, 1, 1)),
        gt_boxes=np.zeros((frames, max_gt, 7), np.float32),
        gt_valid=np.zeros((frames, max_gt), bool),
        gt_classes=np.zeros((frames, max_gt), np.int32),
        depth_gt=np.full((frames, H // 4, W // 4), -1.0, np.float32))
