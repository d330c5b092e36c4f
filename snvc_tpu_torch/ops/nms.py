"""Rotated and axis-aligned NMS with fixed shapes (port of
snvc_tpu/ops/nms.py): one pairwise IoU matrix, then exact greedy
suppression in descending score order, as a fixed-size keep mask.

Sorts are stable, as ``jnp.argsort`` is, so tied scores order the same
way as in JAX.
"""

from __future__ import annotations

import torch

from snvc_tpu_torch.ops.rotated_iou import bev_iou


def nms_from_iou(iou, scores, valid, iou_threshold: float):
    """Greedy NMS from a pairwise IoU matrix.  iou [N, N], scores [N],
    valid [N] bool -> keep [N] bool.

    The JAX ``fori_loop`` is a Python loop over the N candidates (N is the
    decoder's pool, 4 x max_boxes)."""
    N = scores.shape[0]
    neg_inf = torch.full_like(scores, float("-inf"))
    order = torch.argsort(-torch.where(valid, scores, neg_inf), stable=True)
    iou_o = iou[order][:, order]
    valid_o = valid[order]
    later = torch.arange(N, device=scores.device)
    suppressed = torch.zeros(N, dtype=torch.bool, device=scores.device)
    for i in range(N):
        alive = valid_o[i] & ~suppressed[i]
        suppressed = suppressed | ((iou_o[i] > iou_threshold)
                                   & (later > i) & alive)
    keep = torch.zeros_like(valid)
    keep[order] = valid_o & ~suppressed
    return keep


def rotated_nms_bev(boxes_bev, scores, valid, iou_threshold: float = 0.7):
    """boxes_bev [N, 5] (cx, cz, w, h, angle) -> keep mask [N]."""
    return nms_from_iou(bev_iou(boxes_bev, boxes_bev), scores, valid,
                        iou_threshold)


def axis_aligned_iou(boxes):
    """Pairwise IoU [N, N] of axis-aligned BEV boxes [N, 4] (x1, z1, x2,
    z2) (JAX nms.py:52; reference nms_normal_gpu,
    iou3d_nms_kernel.cu:343-401)."""
    x1 = torch.maximum(boxes[:, None, 0], boxes[None, :, 0])
    z1 = torch.maximum(boxes[:, None, 1], boxes[None, :, 1])
    x2 = torch.minimum(boxes[:, None, 2], boxes[None, :, 2])
    z2 = torch.minimum(boxes[:, None, 3], boxes[None, :, 3])
    inter = (x2 - x1).clamp(min=0) * (z2 - z1).clamp(min=0)
    area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    union = area[:, None] + area[None, :] - inter
    return inter / union.clamp(min=1e-8)


def normal_nms(boxes, scores, valid, iou_threshold: float = 0.7):
    """Axis-aligned NMS (reference nms_normal_gpu): keep mask [N]."""
    return nms_from_iou(axis_aligned_iou(boxes), scores, valid,
                        iou_threshold)


def top_k_boxes(boxes, scores, keep, k: int):
    """The k highest-scoring kept boxes, padded to a static k: (boxes [k,
    ...], scores [k] (-inf where not kept), valid [k])."""
    masked = torch.where(keep, scores, torch.full_like(scores, float("-inf")))
    idx = torch.argsort(-masked, stable=True)[:k]
    return boxes[idx], masked[idx], keep[idx]
