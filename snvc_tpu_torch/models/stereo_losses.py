"""Losses and target assignment of the global stereo detector (port of
snvc_tpu/models/stereo_losses.py).

Assignment runs on the device, vectorised over the batch, the BEV
locations and the padded GT boxes (no loop over boxes):

  * a BEV location is positive for a GT iff it lies inside the GT's
    rotated footprint; ties go to the nearest GT center;
  * classification: a multi-target sigmoid focal loss over the angle x
    class bins, normalized by (num_pos + 10);
  * regression: smooth-L1 (beta 1/9) on the 24 corner offsets of the
    positives, weighted by centerness;
  * centerness: BCE with logits against exp(-center distance);
  * depth: masked smooth-L1 ('sl1', multi-stage over the stacked
    hourglasses) or Wasserstein-1 ('w1', with the optional per-plane
    offset).

With a process-group ``mesh`` (parallel/api.py) each normalizer
(``num_pos + 10``, the regression weights, the centerness and depth
masks) is the global batch's, so the global loss is the sum of the
ranks' losses.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from snvc_tpu_torch.config import StereoConfig
from snvc_tpu_torch.parallel.api import global_sum

_CORNER_X = (0.5, 0.5, -0.5, -0.5, 0.5, 0.5, -0.5, -0.5)  # * l
_CORNER_Z = (0.5, -0.5, -0.5, 0.5, 0.5, -0.5, -0.5, 0.5)  # * w
_CORNER_Y = (0.0, 0.0, 0.0, 0.0, -1.0, -1.0, -1.0, -1.0)  # * h
# the pi-rotated box's corner order (same footprint)
_HEADING_FLIP = (2, 3, 0, 1, 6, 7, 4, 5)


def gt_corners_24(gt_boxes):
    """box3d [..., 7] (h, w, l, x, y, z, ry) -> 8 corners [..., 8, 3]:
    bottom 4, then top 4, rotated by ry about y (JAX stereo_losses.py:38)."""
    def const(v):
        return torch.tensor(v, dtype=gt_boxes.dtype, device=gt_boxes.device)

    h, w, l = gt_boxes[..., 0:1], gt_boxes[..., 1:2], gt_boxes[..., 2:3]
    x = const(_CORNER_X) * l
    z = const(_CORNER_Z) * w
    y = const(_CORNER_Y) * h
    ry = gt_boxes[..., 6:7]
    c, s = torch.cos(ry), torch.sin(ry)
    cx = x * c + z * s + gt_boxes[..., 3:4]
    cz = -x * s + z * c + gt_boxes[..., 5:6]
    cy = y + gt_boxes[..., 4:5]
    return torch.stack([cx, cy, cz], dim=-1)


def assign_targets(locations, anchors_y, gt_boxes, gt_valid, gt_classes,
                   num_classes: int, anchor_angles=None,
                   norm_factor: float = 1.0):
    """BEV anchor-free assignment, angle-bin aware (JAX
    stereo_losses.py:53), for one frame or a batch.

    locations [L, 2] (x, z); anchors_y [1] or [num_classes]; gt_boxes
    [..., G, 7] padded; gt_valid [..., G] bool; gt_classes [..., G] int;
    anchor_angles [A] yaw anchors, or None for one bin.  A location
    inside a footprint is positive at the angle bin whose yaw is nearest
    (mod pi) to its GT's.  Returns labels [..., L, A, num_classes] in
    {0, 1}, reg_targets [..., L, num_classes, 24] and centerness [..., L]
    in [0, 1]."""
    L = locations.shape[0]
    dev = locations.device
    if anchor_angles is None:
        anchor_angles = torch.zeros(1, device=dev)
    A = anchor_angles.shape[0]
    b = gt_boxes[..., None, :, :]  # [..., 1, G, 7]
    dx = locations[:, 0:1] - b[..., 3]  # [..., L, G]
    dz = locations[:, 1:2] - b[..., 5]
    c, s = torch.cos(b[..., 6]), torch.sin(b[..., 6])
    lx = dx * c - dz * s  # along the length
    lz = dx * s + dz * c  # across
    inside = ((lx.abs() < b[..., 2] / 2) & (lz.abs() < b[..., 1] / 2)
              & gt_valid[..., None, :])
    dist = torch.sqrt(dx ** 2 + dz ** 2)
    dist_masked = torch.where(inside, dist, torch.full_like(dist, math.inf))
    best = torch.argmin(dist_masked, dim=-1)  # [..., L], first of ties
    pos = inside.any(dim=-1)
    best_dist = torch.take_along_dim(dist_masked, best[..., None], -1)[..., 0]
    centerness = torch.where(pos, torch.exp(-best_dist * norm_factor),
                             torch.zeros_like(best_dist))

    # nearest angle bin, mod pi
    best_ry = torch.take_along_dim(gt_boxes[..., 6], best, -1)
    ang_d = best_ry[..., None] - anchor_angles
    ang_d = (torch.remainder(ang_d + math.pi / 2, math.pi) - math.pi / 2).abs()
    best_angle = torch.argmin(ang_d, dim=-1)
    best_cls = torch.take_along_dim(gt_classes.long(), best, -1)
    labels = (F.one_hot(best_angle, A).float()[..., :, None]
              * F.one_hot(best_cls, num_classes).float()[..., None, :]
              * pos[..., None, None].float())

    # corner targets from the (location, anchor height) point
    ay = torch.as_tensor(anchors_y, dtype=torch.float32,
                         device=dev).expand(num_classes)
    corners = gt_corners_24(gt_boxes)  # [..., G, 8, 3]
    idx = best[..., None, None].expand(best.shape + (8, 3))
    tgt = torch.take_along_dim(corners, idx, -3)  # [..., L, 8, 3]
    anchor3d = torch.stack([locations[:, 0:1].expand(L, num_classes),
                            ay[None, :].expand(L, num_classes),
                            locations[:, 1:2].expand(L, num_classes)], dim=-1)
    reg = tgt[..., :, None, :, :] - anchor3d[:, :, None, :]
    return labels, reg.reshape(reg.shape[:-3] + (num_classes, 24)), \
        centerness


def sigmoid_focal_multi_target(logits, targets, gamma=2.0, alpha=0.25):
    """Multi-target sigmoid focal loss, summed (JAX stereo_losses.py:132)."""
    p = torch.sigmoid(logits)
    term1 = (1 - p) ** gamma * torch.log(p + 1e-7)
    term2 = p ** gamma * torch.log(1 - p + 1e-7)
    t = targets
    return (-t * term1 * alpha - (1 - t) * term2 * (1 - alpha)).sum()


def smooth_l1(x, y, beta=1.0 / 9):
    n = (x - y).abs()
    return torch.where(n < beta, 0.5 * n ** 2 / beta, n - 0.5 * beta)


def optax_sigmoid_bce(logits, targets):
    """optax.sigmoid_binary_cross_entropy."""
    return -(targets * F.logsigmoid(logits)
             + (1 - targets) * F.logsigmoid(-logits))


def rpn3d_loss(outputs: Dict, gt_boxes, gt_valid, gt_classes,
               cfg: StereoConfig, locations,
               mesh=None) -> Dict[str, torch.Tensor]:
    """The RPN loss of a batch (JAX stereo_losses.py:147).

    outputs: cls [N, Z, X, A*K], reg [N, Z, X, A*K*24], centerness
    [N, Z, X, A]; gt_* [N, G, ...] padded; locations [L, 2], L = Z*X.
    Returns total, cls, reg, centerness and num_pos, 0-d tensors: with a
    process-group ``mesh``, this rank's parts (its losses over the global
    normalizers, its own positives)."""
    A, K = cfg.num_angles, cfg.num_classes
    N = outputs["cls"].shape[0]
    L = locations.shape[0]
    dev = locations.device
    anchor_angles = torch.tensor(cfg.anchor_angles[:A], dtype=torch.float32,
                                 device=dev)
    labels, reg_t, ctr_t = assign_targets(locations, cfg.anchors_y, gt_boxes,
                                          gt_valid, gt_classes, K,
                                          anchor_angles)
    # [N, L, A, K], [N, L, K, 24], [N, L]
    cls = outputs["cls"].reshape(N, L, A, K)
    reg = outputs["reg"].reshape(N, L, A, K, 24)
    ctr = outputs["centerness"].reshape(N, L, A)

    num_pos = labels.sum()
    cls_loss = sigmoid_focal_multi_target(
        cls, labels, cfg.focal_gamma, cfg.focal_alpha) / (
            global_sum(num_pos, mesh) + 10.0)

    w = labels * ctr_t[:, :, None, None]
    per = smooth_l1(reg, reg_t[:, :, None].expand(reg.shape)).mean(-1)
    if cfg.reg_heading_sym:
        # score against the pi-rotated ordering too and keep the better
        # one per location
        alt = reg_t.reshape(N, L, K, 8, 3)[:, :, :, list(_HEADING_FLIP)]
        alt = alt.reshape(N, L, K, 24)[:, :, None].expand(reg.shape)
        per = torch.minimum(per, smooth_l1(reg, alt).mean(-1))
    reg_loss = (per * w).sum() / global_sum(w.sum(), mesh).clamp_min(1e-6)

    pos_a = (labels > 0).any(-1).float()  # [N, L, A]
    bce = optax_sigmoid_bce(ctr, ctr_t[:, :, None].expand(ctr.shape))
    ctr_loss = (bce * pos_a).sum() / global_sum(pos_a.sum(),
                                                mesh).clamp_min(1.0)

    total = cls_loss + reg_loss + ctr_loss
    return dict(total=total, cls=cls_loss, reg=reg_loss, centerness=ctr_loss,
                num_pos=num_pos)


def depth_sl1_loss(depth_pred, depth_gt, mask, mesh=None):
    """Masked smooth-L1 (beta 1) on the regressed depth map."""
    m = mask.to(depth_pred.dtype)
    loss = smooth_l1(depth_pred, depth_gt, beta=1.0)
    return (loss * m).sum() / global_sum(m.sum(), mesh).clamp_min(1.0)


def depth_multistage_sl1_loss(depth_preds, depth_gt, mask, mesh=None):
    """``depth_sl1_loss`` over the stacked hourglasses' depth outputs,
    weighted 0.5 / 0.7 / 1.0 for the last three stages and 0.5 for any
    earlier one (JAX stereo_losses.py:225)."""
    weights = (0.5, 0.7, 1.0)
    n = len(depth_preds)
    total = 0.0
    for i, pred in enumerate(depth_preds):
        total = total + weights[max(0, 3 - n + i)] * depth_sl1_loss(
            pred, depth_gt, mask, mesh)
    return total


def depth_w1_loss(prob, depth_levels, depth_gt, mask, offset=None,
                  mesh=None):
    """Wasserstein-1, E_prob |level (+ offset) - gt| over the masked
    pixels; prob [N, D, H, W], offset [N, D, H, W] or None (JAX
    stereo_losses.py:240)."""
    levels = depth_levels[None, :, None, None]
    if offset is not None:
        levels = levels + offset
    per_px = (prob * (levels - depth_gt[:, None]).abs()).sum(1)
    m = mask.to(per_px.dtype)
    return (per_px * m).sum() / global_sum(m.sum(), mesh).clamp_min(1.0)
