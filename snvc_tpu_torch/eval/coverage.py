"""LiDAR coverage of proposals, by RoI-aware pooling (port of
snvc_tpu/eval/coverage.py).

A well-localized proposal cuboid captures about the same LiDAR point mass
as its matched GT cuboid; a drifted or shrunken one loses points.
``proposal_lidar_coverage`` measures that per proposal by pooling the
scene's point cloud into proposal-local voxel grids with
``ops.points_in_boxes.roiaware_pool3d`` (the reference's RoIAwarePool3d
extension, snvc/extension/roiaware_pool3d/roiaware_pool3d_utils.py:95-147).

JAX pins this diagnostic to its CPU backend; the port runs it on
``device`` like every other entry point (the card by default,
``device="cpu"`` for the plain PyTorch run).

A point on a box's face counts as inside or not by the last bit of its
float32 box-frame coordinate.  The synthetic LiDAR puts every point on a
face of its GT box (``data/synthetic.surface_points``), and the port's
float32 arithmetic rounds apart from XLA's (which fuses multiply-adds and
has its own sin / cos), so counts against GT boxes can differ from JAX's
by such face points; counts against proposals, whose faces hold no point,
agree (tests/test_torch_coverage.py).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from snvc_tpu_torch.ops.points_in_boxes import (
    points_in_cuboid,
    roiaware_pool3d,
)
from snvc_tpu_torch.utils.device import resolve_device, to_device


def _pool(points, valid, boxes, out_size):
    """Occupied-voxel fraction [B] of each box's max-pooled grid and the
    valid points inside each box [B]."""
    feats = torch.ones((points.shape[0], 1), dtype=torch.float32,
                       device=points.device)
    pooled = roiaware_pool3d(points, feats, valid, boxes, out_size,
                             mode="max")
    occ_frac = (pooled[..., 0] > 0).float().mean(dim=(1, 2, 3))
    counts = (points_in_cuboid(points, boxes) & valid).sum(dim=1)
    return occ_frac, counts


def coverage_counts(db: Sequence,
                    out_size: Tuple[int, int, int] = (6, 6, 6),
                    device="cuda") -> Tuple[List[float], List[float],
                                            List[float]]:
    """Per record with both ``pred`` and ``label``, grouped by scene in
    first-seen order as JAX groups them: the valid points inside the
    proposal, inside the GT box, and the occupied-voxel fraction of the
    proposal's max-pooled grid."""
    dev = resolve_device(device)
    by_scene: Dict[str, List] = {}
    for rec in db:
        if rec.pred is None or rec.label is None:
            continue
        by_scene.setdefault(rec.scene.name, []).append(rec)
    if not by_scene:
        return [], [], []

    clouds = {}
    for name, recs in by_scene.items():
        pc = recs[0].scene.lidar()[:, :3]
        clouds[name] = recs[0].calib_left.velo_to_rect(pc).astype(np.float32)

    # one padded size for every scene, as JAX's (it compiles once)
    p_max = max(c.shape[0] for c in clouds.values())
    p_max = int(np.ceil(p_max / 4096) * 4096)
    b_max = max(len(r) for r in by_scene.values())

    prop_counts, gt_counts, occ_fracs = [], [], []
    for name, recs in by_scene.items():
        pc = clouds[name]
        pts = np.ones((p_max, 3), dtype=np.float32)
        pts[: pc.shape[0]] = pc
        valid = np.zeros(p_max, dtype=bool)
        valid[: pc.shape[0]] = True
        # pred and GT boxes pooled in one call; padded slots get unit boxes
        boxes = np.ones((2 * b_max, 7), dtype=np.float32)
        for i, rec in enumerate(recs):
            boxes[i] = rec.pred
            boxes[b_max + i] = rec.label
        occ, counts = _pool(to_device(pts, dev), to_device(valid, dev),
                            to_device(boxes, dev), tuple(out_size))
        occ, counts = occ.cpu().numpy(), counts.cpu().numpy()
        for i in range(len(recs)):
            prop_counts.append(float(counts[i]))
            gt_counts.append(float(counts[b_max + i]))
            occ_fracs.append(float(occ[i]))
    return prop_counts, gt_counts, occ_fracs


def proposal_lidar_coverage(db: Sequence,
                            out_size: Tuple[int, int, int] = (6, 6, 6),
                            device="cuda") -> Dict[str, float]:
    """Median LiDAR coverage of proposals against their matched GT boxes.

    db: InstanceRecords with both ``pred`` and ``label`` set (after
    ``attach_nearest_gt``); records missing either are skipped.  Returns
    the medians of the points inside the proposal and inside the GT box,
    of their ratio (1.0 = the proposal captures the object's whole point
    mass) and of the occupied-voxel fraction of the proposal's pooled
    grid, rounded as JAX rounds them ({} when no record qualifies)."""
    prop_counts, gt_counts, occ_fracs = coverage_counts(db, out_size,
                                                        device)
    if not prop_counts:
        return {}
    ratios = [cp / max(cg, 1.0) for cp, cg in zip(prop_counts, gt_counts)]
    return {
        "pts_in_proposal_med": round(float(np.median(prop_counts)), 1),
        "pts_in_gt_med": round(float(np.median(gt_counts)), 1),
        "coverage_ratio_med": round(float(np.median(ratios)), 3),
        "occ_frac_med": round(float(np.median(occ_fracs)), 3),
    }
