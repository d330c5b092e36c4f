"""Per-instance database construction (port of
snvc_tpu/data/instance_db.py, host side, numpy).

Mirrors the reference's refinementDataset DB init
(snvc/dataset/KITTIRefinement_dataset.py:119-265): one record per object
instance, built either from ground truth (synthetic supervision: the
proposal is sampled around the GT with gaussian noise) or from a
detector's KITTI-format prediction files (model-agnostic refinement).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from snvc_tpu_torch.config import VernierConfig
from snvc_tpu_torch.data.kitti import KittiDataset, KittiScene
from snvc_tpu_torch.geometry.boxes import box_corners_cam
from snvc_tpu_torch.geometry.calib import (
    Calibration,
    filter_annotations,
    read_label,
)


@dataclass
class InstanceRecord:
    scene: KittiScene
    calib_left: Calibration
    calib_right: Calibration
    label: Optional[np.ndarray] = None  # [7] GT box (train/synthetic)
    pred: Optional[np.ndarray] = None  # [7] proposal box (inference/real)
    box2d: Optional[np.ndarray] = None  # [4] 2D box of the proposal
    score: float = float("nan")


def build_db_from_gt(
    dataset: KittiDataset, cfg: VernierConfig, indices: Optional[Sequence[int]] = None
) -> List[InstanceRecord]:
    """One record per GT instance (reference _init_db_from_gt:119-153).

    When training with augmentation, each instance appears
    ``cfg.augment_times`` times in the DB; every occurrence draws its own
    perturbation noise at batch-build time, so one epoch sees
    augment_times independent proposals per object (the reference's
    recovered augment_times semantics, SURVEY.md §5)."""
    repeats = (
        max(1, int(cfg.augment_times))
        if cfg.usage == "train" and cfg.augment
        else 1
    )
    db: List[InstanceRecord] = []
    for idx in indices if indices is not None else dataset.indices:
        scene = dataset.scene(idx)
        cl = scene.calibration("left")
        cr = scene.calibration("right")
        _, box3ds, _, _ = filter_annotations(
            scene.labels(),
            valid_classes=cfg.valid_classes,
            depth_range=cfg.depth_range,
            truncation_threshold=0.8,
        )
        for k in range(len(box3ds)):
            for _ in range(repeats):
                db.append(
                    InstanceRecord(
                        scene=scene, calib_left=cl, calib_right=cr, label=box3ds[k]
                    )
                )
    return db


def build_db_from_predictions(
    dataset: KittiDataset, cfg: VernierConfig, pred_dir: Optional[str] = None
) -> List[InstanceRecord]:
    """One record per predicted instance from a directory of KITTI-format
    txt files (reference _init_db_from_pred:193-242).  Proposals keep their
    2D boxes and scores for the output writer."""
    pred_dir = pred_dir or cfg.pred_dir
    db: List[InstanceRecord] = []
    for file_name in sorted(os.listdir(pred_dir)):
        if not file_name.endswith(".txt"):
            continue
        idx = int(file_name.split(".")[0])
        scene = dataset.scene(idx)
        cl = scene.calibration("left")
        cr = scene.calibration("right")
        labels = read_label(os.path.join(pred_dir, file_name))
        b2, b3, _, scores = filter_annotations(
            labels, valid_classes=cfg.valid_classes, ignore_truncation=False
        )
        for k in range(len(b3)):
            db.append(
                InstanceRecord(
                    scene=scene,
                    calib_left=cl,
                    calib_right=cr,
                    pred=b3[k],
                    box2d=b2[k],
                    score=float(scores[k]),
                )
            )
    return db


def in_fov(
    box: np.ndarray,
    calib_left: Calibration,
    calib_right: Calibration,
    image_hw,
) -> bool:
    """Is a 3D box visible to both cameras?

    The reference gates perturbation trials on a ``_check_fov`` predicate
    that is declared (KITTIRefinement_dataset.py:311-318, cfg.check_fov)
    but not released; this is our definition: every corner must have
    positive depth and the box center must project inside both image
    rectangles (a center-visible box yields usable stereo ROI crops).
    """
    H, W = image_hw
    corners = box_corners_cam(box)  # [8, 3]
    center = np.array([box[3], box[4] - 0.5 * box[0], box[5]], np.float32)
    if corners[:, 2].min() <= 0.1:
        return False
    for calib in (calib_left, calib_right):
        uv = calib.rect_to_image(center[None])[0]
        if not (0 <= uv[0] < W and 0 <= uv[1] < H):
            return False
    return True


def perturb_box(
    box: np.ndarray,
    cfg: VernierConfig,
    rng: np.random.Generator,
    calib_left: Optional[Calibration] = None,
    calib_right: Optional[Calibration] = None,
    max_trials: int = 10,
    image_hw=None,
    noise_bank: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Proposal noise around a GT box
    (reference _generate_noise/_purturb_3D_box:284-321).

    Independent Gaussian draws per component (the reference's scheme),
    gated by the rot/loc/dim_aug switches.  With ``noise_bank`` (a [K, 7]
    array of measured proposal-minus-GT deltas) a draw is one of its rows,
    picked at random, plus gaussians of 0.1x the configured stds, under
    the same switches: the correlated, biased errors of one detector's
    proposals (JAX instance_db.py:131).

    With cfg.check_fov (and calibrations provided), up to ``max_trials``
    noise draws are attempted until the perturbed box stays in both
    cameras' view; if every trial fails the unperturbed box is returned
    (the fixed-shape batch cannot drop the sample like the reference's
    dynamic list does).

    image_hw is the NATIVE image extent (scene.native_image_size()); the
    padded batch canvas (cfg.image_size) is only a fallback — its padding
    band contains no pixels, so gating on it would admit boxes that crop
    to black."""
    check = cfg.check_fov and calib_left is not None and calib_right is not None
    trials = max_trials if check else 1
    hw = image_hw if image_hw is not None else cfg.image_size
    for _ in range(trials):
        if noise_bank is not None and len(noise_bank) > 0:
            noise = np.asarray(noise_bank[int(rng.integers(len(noise_bank)))],
                               np.float64).copy()
            noise[6] += rng.normal() * 0.1 * float(cfg.std_rot) * np.pi / 180.0
            noise[3:6] += rng.normal(size=3) * 0.1 * np.asarray(cfg.std_loc)
            noise[:3] += rng.normal(size=3) * 0.1 * np.asarray(cfg.std_dim)
            if not cfg.rot_aug:
                noise[6] = 0.0
            if not cfg.loc_aug:
                noise[3:6] = 0.0
            if not cfg.dim_aug:
                noise[:3] = 0.0
        else:
            noise = np.zeros(7)
            if cfg.rot_aug:
                noise[6] = rng.normal() * float(cfg.std_rot) * np.pi / 180.0
            if cfg.loc_aug:
                noise[3:6] = rng.normal(size=3) * np.asarray(cfg.std_loc)
            if cfg.dim_aug:
                noise[:3] = rng.normal(size=3) * np.asarray(cfg.std_dim)
        sample = (box + noise).astype(np.float32)
        if not check or in_fov(sample, calib_left, calib_right, hw):
            return sample
    return box.astype(np.float32).copy()


def attach_nearest_gt(
    db: List[InstanceRecord], cfg: VernierConfig
) -> List[InstanceRecord]:
    """For proposal records on a labeled split, attach the nearest GT box
    (reference get_neighbor, KITTIRefinement_dataset.py:1014-1028) so val
    losses can be reported during model-agnostic inference."""
    cache = {}
    for rec in db:
        if rec.pred is None or rec.scene.label_dir is None:
            continue
        key = rec.scene.index
        if key not in cache:
            _, b3, _, _ = filter_annotations(
                rec.scene.labels(),
                valid_classes=cfg.valid_classes,
                truncation_threshold=0.8,
            )
            cache[key] = b3
        b3 = cache[key]
        if len(b3) == 0:
            continue
        d = np.linalg.norm(rec.pred[3:6][None] - b3[:, 3:6], axis=1)
        rec.label = b3[int(np.argmin(d))]
    return db
