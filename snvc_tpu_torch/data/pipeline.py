"""Host-side batch construction for the instance path (port of
snvc_tpu/data/pipeline.py): the fixed-shape batch, the per-instance crop
affines, the LiDAR points near each instance, and ``RefinementPipeline``,
which packs an instance DB into batches.

Every batch has static shapes: ``frames_per_batch`` image slots and
``max_instances`` instance slots with validity masks, LiDAR padded to
``max_points``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from snvc_tpu_torch.config import VernierConfig
from snvc_tpu_torch.data import native_loader
from snvc_tpu_torch.data.instance_db import InstanceRecord, perturb_box
from snvc_tpu_torch.geometry import boxes as gbox
from snvc_tpu_torch.geometry import imgproc


@dataclass
class InstanceBatch:
    """One fixed-shape batch (numpy)."""

    images_left: np.ndarray  # [F, H, W, 3] uint8 (padded)
    images_right: np.ndarray
    P_left: np.ndarray  # [F, 3, 4]
    P_right: np.ndarray
    image_idx: np.ndarray  # [I] int32
    trans_l: np.ndarray  # [I, 2, 3]
    trans_r: np.ndarray
    samples: np.ndarray  # [I, 7] proposals
    valid: np.ndarray  # [I] bool
    # training extras (zeros when not training)
    gt_boxes: np.ndarray  # [I, 7]
    points: np.ndarray  # [I, Np, 3] rect-frame LiDAR
    points_valid: np.ndarray  # [I, Np] bool
    # bookkeeping (host only)
    scene_names: List[Optional[str]] = None
    box2d: np.ndarray = None  # [I, 4]
    scores: np.ndarray = None  # [I]

    def arrays(self) -> Dict[str, np.ndarray]:
        return dict(images_left=self.images_left,
                    images_right=self.images_right, P_left=self.P_left,
                    P_right=self.P_right, image_idx=self.image_idx,
                    trans_l=self.trans_l, trans_r=self.trans_r,
                    samples=self.samples, valid=self.valid,
                    gt_boxes=self.gt_boxes, points=self.points,
                    points_valid=self.points_valid)


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


class RefinementPipeline:
    """Iterates fixed-shape InstanceBatches over an instance DB (JAX
    ``RefinementPipeline``; one seed gives JAX's perturbations)."""

    def __init__(self, db: Sequence[InstanceRecord], cfg: VernierConfig,
                 training: bool = False, max_points: int = 4096,
                 seed: int = 0, load_lidar: Optional[bool] = None,
                 noise_bank: Optional[np.ndarray] = None):
        self.db = list(db)
        self.cfg = cfg
        self.training = training
        self.max_points = max_points
        self.rng = np.random.default_rng(seed)
        self.load_lidar = training if load_lidar is None else load_lidar
        # [K, 7] measured proposal-minus-GT deltas: the perturbations are
        # drawn from them instead of iid gaussians (perturb_box)
        self.noise_bank = (None if noise_bank is None
                           else np.asarray(noise_bank))

    def __len__(self) -> int:
        return sum(1 for _ in self._frame_groups())

    def _frame_groups(self) -> Iterator[List[InstanceRecord]]:
        """Consecutive records packed into batches bounded by the instance
        budget and the image-slot budget (cfg.frames_per_batch)."""
        max_frames = max(1, self.cfg.frames_per_batch)
        cur: List[InstanceRecord] = []
        frames: List[int] = []
        for rec in self.db:
            new_frame = not frames or rec.scene.index != frames[-1]
            if cur and (len(cur) >= self.cfg.max_instances
                        or (new_frame and len(frames) >= max_frames)):
                yield cur
                cur, frames = [], []
                new_frame = True
            cur.append(rec)
            if new_frame:
                frames.append(rec.scene.index)
        if cur:
            yield cur

    def batches(self, shuffle: bool = False) -> Iterator[InstanceBatch]:
        groups = list(self._frame_groups())
        order = np.arange(len(groups))
        if shuffle:
            self.rng.shuffle(order)
        for gi in order:
            yield self.make_batch(groups[gi])

    def make_batch(self, records: Sequence[InstanceRecord]) -> InstanceBatch:
        cfg = self.cfg
        F = max(1, cfg.frames_per_batch)  # static image-slot count
        I = cfg.max_instances
        Np = self.max_points
        img_h, img_w = cfg.image_size

        # distinct frames of this group, in order
        frame_recs: List[InstanceRecord] = []
        frame_of: Dict[int, int] = {}
        for rec in records:
            if rec.scene.index not in frame_of:
                frame_of[rec.scene.index] = len(frame_recs)
                frame_recs.append(rec)
        if len(frame_recs) > F:
            raise ValueError(f"group of {len(frame_recs)} frames exceeds "
                             f"frames_per_batch={F}")

        # both views of every frame in one native batch decode into the
        # [2F] canvases (slots past the group's frames stay 0)
        pad = [None] * (F - len(frame_recs))
        images = native_loader.decode_batch_padded(
            [r.scene.left_image_path for r in frame_recs] + pad
            + [r.scene.right_image_path for r in frame_recs] + pad,
            (img_h, img_w))
        images_left, images_right = images[:F], images[F:]
        P_left = np.tile(np.eye(3, 4, dtype=np.float32), (F, 1, 1))
        P_right = P_left.copy()
        pc_rects = [None] * F
        for fi, rec in enumerate(frame_recs):
            scene = rec.scene
            P_left[fi] = rec.calib_left.as_array()
            P_right[fi] = rec.calib_right.as_array()
            if self.load_lidar:
                pc = scene.lidar()[:, :3]
                pc_rects[fi] = rec.calib_left.velo_to_rect(pc).astype(
                    np.float32)

        samples = np.zeros((I, 7), np.float32)
        gt_boxes = np.zeros((I, 7), np.float32)
        trans_l = np.tile(np.eye(2, 3, dtype=np.float32), (I, 1, 1))
        trans_r = trans_l.copy()
        valid = np.zeros(I, bool)
        image_idx = np.zeros(I, np.int32)
        box2d = np.zeros((I, 4), np.float32)
        scores = np.full(I, np.nan, np.float32)
        points = np.zeros((I, Np, 3), np.float32)
        points_valid = np.zeros((I, Np), bool)

        for k, rec in enumerate(records):
            image_idx[k] = frame_of[rec.scene.index]
            pc_rect = pc_rects[image_idx[k]]
            if rec.pred is not None:
                sample = rec.pred.copy()
            elif (self.training and cfg.augment) or cfg.sup_type == "synthetic":
                sample = perturb_box(
                    rec.label, cfg, self.rng, calib_left=rec.calib_left,
                    calib_right=rec.calib_right,
                    image_hw=(rec.scene.native_image_size()
                              if cfg.check_fov else None),
                    noise_bank=self.noise_bank)
            else:
                sample = rec.label.copy()
            samples[k] = sample
            if rec.label is not None:
                gt_boxes[k] = rec.label
            trans_l[k], trans_r[k] = crop_transforms(
                sample, rec.calib_left, rec.calib_right, cfg)
            valid[k] = True
            if rec.box2d is not None:
                box2d[k] = rec.box2d
            scores[k] = rec.score
            if pc_rect is not None:
                points[k], points_valid[k] = select_points(pc_rect, sample,
                                                           cfg, Np)

        return InstanceBatch(
            images_left=images_left, images_right=images_right,
            P_left=P_left, P_right=P_right, image_idx=image_idx,
            trans_l=trans_l, trans_r=trans_r, samples=samples, valid=valid,
            gt_boxes=gt_boxes, points=points, points_valid=points_valid,
            scene_names=([r.scene.name for r in records]
                         + [None] * (I - len(records))),
            box2d=box2d, scores=scores)
