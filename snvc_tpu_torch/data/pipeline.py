"""Host-side batch construction for the instance path (the part of
snvc_tpu/data/pipeline.py the serving and training steps read): the
fixed-shape batch, the per-instance crop affines and the LiDAR points
near each instance."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np

from snvc_tpu_torch.config import VernierConfig
from snvc_tpu_torch.geometry import boxes as gbox
from snvc_tpu_torch.geometry import imgproc


@dataclass
class InstanceBatch:
    """One fixed-shape serving batch (numpy)."""

    images_left: np.ndarray  # [F, H, W, 3] uint8 (padded)
    images_right: np.ndarray
    P_left: np.ndarray  # [F, 3, 4]
    P_right: np.ndarray
    image_idx: np.ndarray  # [I] int32
    trans_l: np.ndarray  # [I, 2, 3]
    trans_r: np.ndarray
    samples: np.ndarray  # [I, 7] proposals
    valid: np.ndarray  # [I] bool

    def arrays(self) -> Dict[str, np.ndarray]:
        return dict(images_left=self.images_left,
                    images_right=self.images_right, P_left=self.P_left,
                    P_right=self.P_right, image_idx=self.image_idx,
                    trans_l=self.trans_l, trans_r=self.trans_r,
                    samples=self.samples, valid=self.valid)


def roi_box3d(sample: np.ndarray, cfg: VernierConfig) -> np.ndarray:
    """The refinement-space cuboid: the sample pose with the grid range as
    dims, re-anchored to keep the box center fixed."""
    box = np.array(sample)  # a copy in the sample's dtype, as in JAX
    old_center_y = box[4] - 0.5 * box[0]
    box[:3] = cfg.grid_range
    box[4] = old_center_y + 0.5 * box[0]
    return box


def crop_transforms(sample, calib_left, calib_right,
                    cfg: VernierConfig) -> Tuple[np.ndarray, np.ndarray]:
    """Per-instance 2x3 source->ROI affines for both views."""
    kpts3d = gbox.box_parts_cam(roi_box3d(sample, cfg))
    tl = imgproc.roi_crop_transform(calib_left.rect_to_image(kpts3d),
                                    cfg.resolution, cfg.roi_enlarge)
    tr = imgproc.roi_crop_transform(calib_right.rect_to_image(kpts3d),
                                    cfg.resolution, cfg.roi_enlarge)
    return tl.astype(np.float32), tr.astype(np.float32)


def select_points(pc_rect: np.ndarray, sample: np.ndarray,
                  cfg: VernierConfig,
                  max_points: int) -> Tuple[np.ndarray, np.ndarray]:
    """The points of ``pc_rect`` [P, 3] within 1.5x the grid's largest
    extent of the sample's center, strided down to at most ``max_points``
    and zero-padded: ([max_points, 3] float32, [max_points] bool)
    (JAX pipeline.py:94)."""
    center = sample[3:6]
    r = 1.5 * max(cfg.grid_range)
    near = ((np.abs(pc_rect[:, 0] - center[0]) < r)
            & (np.abs(pc_rect[:, 2] - center[2]) < r)
            & (np.abs(pc_rect[:, 1] - center[1]) < r))
    pts = pc_rect[near]
    if len(pts) > max_points:
        stride = int(np.ceil(len(pts) / max_points))
        pts = pts[::stride][:max_points]
    out = np.zeros((max_points, 3), np.float32)
    out[: len(pts)] = pts
    mask = np.zeros(max_points, bool)
    mask[: len(pts)] = True
    return out, mask
