"""Rotated BEV IoU, 3D IoU and the DIoU loss as fixed-shape masked math
(port of snvc_tpu/ops/rotated_iou.py).

Per box pair: 24 candidate vertices (the 8 corners that lie inside the
other box and the 16 edge-edge intersections), a masked angular sort
around their centroid, and the shoelace area.  No data-dependent control
flow, so every pair of a [N, M] set (or of two [N] lists) is computed at
once.

BEV box convention: (cx, cz, w = along the heading, h = across, angle),
angle counter-clockwise positive; ``bev_from_box3d`` converts KITTI boxes
(whose yaw is clockwise, so angle = -ry).
"""

from __future__ import annotations

import torch

from snvc_tpu_torch.utils.device import constant

_EPS = 1e-8

# corner offsets in the box frame
_CX = (0.5, -0.5, -0.5, 0.5)
_CY = (0.5, 0.5, -0.5, -0.5)


def bev_corners(boxes):
    """[..., 5] (cx, cy, w, h, angle) -> [..., 4, 2] corners (CCW)."""
    cx = constant(_CX, boxes.device, boxes.dtype)
    cy = constant(_CY, boxes.device, boxes.dtype)
    x4 = boxes[..., 2:3] * cx
    y4 = boxes[..., 3:4] * cy
    c = torch.cos(boxes[..., 4:5])
    s = torch.sin(boxes[..., 4:5])
    rx = x4 * c - y4 * s + boxes[..., 0:1]
    ry = x4 * s + y4 * c + boxes[..., 1:2]
    return torch.stack([rx, ry], dim=-1)


def bev_from_box3d(box3d):
    """box3d [..., 7] (h, w, l, x, y, z, ry) -> BEV (x, z, l, w, -ry)."""
    return torch.stack([box3d[..., 3], box3d[..., 5], box3d[..., 2],
                        box3d[..., 1], -box3d[..., 6]], dim=-1)


def _points_in_rect(pts, box):
    """pts [..., P, 2] inside the rotated rect box [..., 5] (inclusive,
    with eps)."""
    c = torch.cos(box[..., 4:5])
    s = torch.sin(box[..., 4:5])
    dx = pts[..., 0] - box[..., 0:1]
    dy = pts[..., 1] - box[..., 1:2]
    lx = dx * c + dy * s
    ly = -dx * s + dy * c
    return ((lx.abs() <= box[..., 2:3] / 2 + _EPS)
            & (ly.abs() <= box[..., 3:4] / 2 + _EPS))


def _edge_intersections(ca, cb):
    """The 16 edge-pair intersections of corners ca, cb [..., 4, 2]:
    points [..., 16, 2] and validity [..., 16]."""
    a1 = torch.roll(ca, -1, dims=-2)
    b1 = torch.roll(cb, -1, dims=-2)
    p = ca[..., :, None, :]  # [..., 4, 1, 2]
    r = (a1 - ca)[..., :, None, :]
    q = cb[..., None, :, :]  # [..., 1, 4, 2]
    s = (b1 - cb)[..., None, :, :]
    rxs = r[..., 0] * s[..., 1] - r[..., 1] * s[..., 0]  # [..., 4, 4]
    qp = q - p
    denom = torch.where(rxs.abs() < _EPS, torch.ones_like(rxs), rxs)
    t = (qp[..., 0] * s[..., 1] - qp[..., 1] * s[..., 0]) / denom
    u = (qp[..., 0] * r[..., 1] - qp[..., 1] * r[..., 0]) / denom
    valid = ((rxs.abs() >= _EPS) & (t >= -_EPS) & (t <= 1 + _EPS)
             & (u >= -_EPS) & (u <= 1 + _EPS))
    pts = p + t[..., None] * r  # [..., 4, 4, 2]
    shape = pts.shape[:-3]
    return pts.reshape(shape + (16, 2)), valid.reshape(shape + (16,))


def _masked_convex_area(pts, mask):
    """Area of the convex polygon of the masked points: angular sort around
    the masked centroid, then the shoelace formula.  pts [..., P, 2],
    mask [..., P] bool."""
    n = mask.sum(-1, keepdim=True)  # [..., 1]
    m = mask.to(pts.dtype)
    centroid = (pts * m[..., None]).sum(-2) / n.clamp(min=1).to(pts.dtype)
    ang = torch.atan2(pts[..., 1] - centroid[..., 1:2],
                      pts[..., 0] - centroid[..., 0:1])
    ang = torch.where(mask, ang, torch.full_like(ang, 1e9))  # invalid last
    order = torch.argsort(ang, dim=-1, stable=True)
    sp = torch.gather(pts, -2, order[..., None].expand(pts.shape))
    P = pts.shape[-2]
    idx = torch.arange(P, device=pts.device)
    nxt = torch.where(idx + 1 < n, idx + 1, torch.zeros_like(idx))
    sp_next = torch.gather(sp, -2, nxt[..., None].expand(sp.shape))
    cross = sp[..., 0] * sp_next[..., 1] - sp_next[..., 0] * sp[..., 1]
    cross = torch.where(idx < n, cross, torch.zeros_like(cross))
    return 0.5 * cross.sum(-1).abs()


def pair_overlap(boxes_a, boxes_b):
    """Intersection areas [...] of BEV boxes paired elementwise,
    [..., 5] x [..., 5] (JAX ``_pair_overlap``)."""
    ca, cb = bev_corners(boxes_a), bev_corners(boxes_b)
    ipts, ivalid = _edge_intersections(ca, cb)
    pts = torch.cat([ca, cb, ipts], dim=-2)  # [..., 24, 2]
    mask = torch.cat([_points_in_rect(ca, boxes_b),
                      _points_in_rect(cb, boxes_a), ivalid], dim=-1)
    area = _masked_convex_area(pts, mask)
    # fewer than 3 vertices -> no overlap
    return torch.where(mask.sum(-1) >= 3, area, torch.zeros_like(area))


def bev_overlap(boxes_a, boxes_b):
    """Pairwise intersection areas [N, M] of BEV boxes [N, 5] x [M, 5]."""
    N, M = boxes_a.shape[0], boxes_b.shape[0]
    return pair_overlap(boxes_a[:, None].expand(N, M, 5),
                        boxes_b[None, :].expand(N, M, 5))


def bev_iou(boxes_a, boxes_b):
    """Pairwise rotated IoU [N, M]."""
    inter = bev_overlap(boxes_a, boxes_b)
    area_a = (boxes_a[:, 2] * boxes_a[:, 3])[:, None]
    area_b = (boxes_b[:, 2] * boxes_b[:, 3])[None, :]
    return inter / (area_a + area_b - inter).clamp(min=_EPS)


def iou3d(boxes_a, boxes_b):
    """Pairwise 3D IoU [N, M] of box3d [N, 7] x [M, 7]: rotated BEV overlap
    x height overlap / volume union (JAX rotated_iou.py:152; reference
    iou3d_nms_utils.py:52-85).  y is the box's bottom, down: a box spans
    [y - h, y]."""
    inter_bev = bev_overlap(bev_from_box3d(boxes_a), bev_from_box3d(boxes_b))
    top_a, bot_a = boxes_a[:, 4] - boxes_a[:, 0], boxes_a[:, 4]
    top_b, bot_b = boxes_b[:, 4] - boxes_b[:, 0], boxes_b[:, 4]
    ymax = torch.minimum(bot_a[:, None], bot_b[None, :])
    ymin = torch.maximum(top_a[:, None], top_b[None, :])
    inter = inter_bev * (ymax - ymin).clamp(min=0.0)
    vol_a = (boxes_a[:, 0] * boxes_a[:, 1] * boxes_a[:, 2])[:, None]
    vol_b = (boxes_b[:, 0] * boxes_b[:, 1] * boxes_b[:, 2])[None, :]
    return inter / (vol_a + vol_b - inter).clamp(min=_EPS)


def diou_bev(pred, target):
    """Distance-IoU loss of BEV boxes paired elementwise, [N, 5] x [N, 5]
    (JAX rotated_iou.py:172).  Returns (loss [N], iou [N]); the distance
    term is over the diagonal of the axis-aligned box enclosing both."""
    inter = pair_overlap(pred, target)
    area_p = pred[:, 2] * pred[:, 3]
    area_t = target[:, 2] * target[:, 3]
    iou = inter / (area_p + area_t - inter).clamp(min=_EPS)
    allc = torch.cat([bev_corners(pred), bev_corners(target)], dim=1)
    wh = allc.amax(dim=1) - allc.amin(dim=1)
    c2 = (wh ** 2).sum(dim=1) + _EPS
    d2 = ((pred[:, :2] - target[:, :2]) ** 2).sum(dim=1)
    return 1.0 - iou + d2 / c2, iou
