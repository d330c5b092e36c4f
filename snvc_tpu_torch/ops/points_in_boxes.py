"""Point-in-box predicates, the occupancy targets of Vernier training and
RoI-aware pooling (port of snvc_tpu/ops/points_in_boxes.py:20-181),
batched over instances.

Boxes are [h, w, l, x, y, z, ry], bottom-centered, in the rect camera
frame.  The JAX functions take one instance and are vmapped; these take a
leading instance axis.  The per-voxel point count is a ``scatter_add_``
(JAX ``.at[flat].add``).  ``roiaware_pool3d`` is plain PyTorch, as JAX's
is plain XLA (``segment_max`` / ``segment_sum``, no Pallas kernel); it
runs on the device of its inputs.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch


def _local_coords(points, center, ry):
    """points [..., P, 3] minus center [..., 3], rotated into the object
    frame (x = w, y = h, z = l) of heading ry [...]."""
    off = points - center[..., None, :]
    c, s = torch.cos(ry)[..., None], torch.sin(ry)[..., None]
    x = -(off[..., 0] * s + off[..., 2] * c)
    y = off[..., 1]
    z = off[..., 0] * c - off[..., 2] * s
    return torch.stack([x, y, z], dim=-1)


def _box_center(box3d, h):
    """The box's center: its bottom y raised by half the height ``h``."""
    return torch.stack([box3d[..., 3], box3d[..., 4] - 0.5 * h,
                        box3d[..., 5]], dim=-1)


def points_in_cuboid(points, box3d, extra_dims=None):
    """[..., P] mask of points [..., P, 3] inside the upright box3d [..., 7].
    ``extra_dims`` (h, w, l) replaces the box's dims and keeps its bottom y
    (the ROI cuboid of the occupancy targets)."""
    if extra_dims is None:
        h, w, l = box3d[..., 0:1], box3d[..., 1:2], box3d[..., 2:3]
        center = _box_center(box3d, box3d[..., 0])
    else:
        h, w, l = extra_dims
        center = _box_center(box3d, h)
    local = _local_coords(points, center, box3d[..., 6])
    return ((local[..., 0].abs() < 0.5 * w) & (local[..., 1].abs() < 0.5 * h)
            & (local[..., 2].abs() < 0.5 * l))


def grid_to_cam(grid_local, box3d):
    """grid_local [G, 3] (x = w, y = h, z = l); box3d [B, 7] -> camera-frame
    points [B, G, 3].  The grid heads "front" before rotation, hence
    ry + pi/2."""
    ry = box3d[:, 6:7] + 0.5 * math.pi
    c, s = torch.cos(ry), torch.sin(ry)
    gx, gy, gz = (grid_local[None, :, i] for i in range(3))
    x = gx * c + gz * s + box3d[:, 3:4]
    y = gy + (box3d[:, 4:5] - 0.5 * box3d[:, 0:1])
    z = -gx * s + gz * c + box3d[:, 5:6]
    return torch.stack([x, y, z], dim=-1)


def occupancy_targets(points, points_valid, samples, gt_boxes, grid_local,
                      grid_resolution: Tuple[int, int, int],
                      grid_range: Tuple[float, float, float]):
    """Foreground / background / undefined occupancy of each instance's
    grid (JAX points_in_boxes.py:57).

    points [B, P, 3] (padded), points_valid [B, P] bool, samples and
    gt_boxes [B, 7], grid_local [G, 3].  Returns [B, nh, nw, nl] float32:
    1 where a valid point inside both the ROI cuboid and the GT box falls
    in the voxel, 0 where the voxel's center lies outside the GT box
    (background wins), -1 elsewhere."""
    nh, nw, nl = grid_resolution
    gh, gw, gl = grid_range
    B = samples.shape[0]
    spa = (gh / (nh - 1), gw / (nw - 1), gl / (nl - 1))
    in_roi = points_in_cuboid(points, samples, extra_dims=(gh, gw, gl))
    in_gt = points_in_cuboid(points, gt_boxes)
    fg = in_roi & in_gt & points_valid

    center = _box_center(samples, samples[:, 0])
    local = _local_coords(points, center, samples[:, 6])
    i = torch.floor(local[..., 1] / spa[0] + 0.5 * (nh - 1.0))
    j = torch.floor(local[..., 0] / spa[1] + 0.5 * (nw - 1.0))
    k = torch.floor(local[..., 2] / spa[2] + 0.5 * (nl - 1.0))
    i = i.clamp(0, nh - 1).long()
    j = j.clamp(0, nw - 1).long()
    k = k.clamp(0, nl - 1).long()
    flat = (i * nw + j) * nl + k
    counts = torch.zeros((B, nh * nw * nl), dtype=torch.int32,
                         device=points.device)
    counts.scatter_add_(1, flat, fg.to(torch.int32))
    fg_mask = (counts > 0).reshape(B, nh, nw, nl)

    inside_gt = points_in_cuboid(grid_to_cam(grid_local, samples),
                                 gt_boxes).reshape(B, nh, nw, nl)
    occ = torch.where(fg_mask, 1.0, -1.0)
    return torch.where(inside_gt, occ, torch.zeros_like(occ))


def roiaware_pool3d(points, features, points_valid, boxes,
                    out_size: Tuple[int, int, int], mode: str = "max"):
    """RoI-aware voxel pooling of point features into per-box grids (JAX
    points_in_boxes.py:130; the reference's RoIAwarePool3d,
    roiaware_pool3d_kernel.cu:111-232).

    points [P, 3], features [P, C], points_valid [P] bool, boxes [B, 7].
    out_size (ox, oy, oz): voxels along the box's (l, h, w) axes.
    Returns [B, ox, oy, oz, C]; empty voxels are 0.

    ``max``: ``scatter_reduce(..., "amax", include_self=False)`` into
    zeros, so an empty voxel keeps its 0.  ``avg``: the sums are not an
    ``index_add_``, whose float adds on CUDA come in a varying order; the
    points are sorted by voxel (a stable sort) and each voxel's sum taken
    by ``torch.segment_reduce``, which adds a voxel's points one after
    another in point order, so the result is the same from run to run, as
    JAX's segment sums are."""
    ox, oy, oz = out_size
    B = boxes.shape[0]
    P, C = features.shape
    nseg = B * ox * oy * oz
    inside = points_in_cuboid(points, boxes) & points_valid  # [B, P]
    center = _box_center(boxes, boxes[:, 0])
    local = _local_coords(points, center, boxes[:, 6])  # [B, P, (w, h, l)]

    def index(coord, extent, n):
        i = torch.floor((coord + 0.5 * extent[:, None]) / (extent / n)[:, None])
        return i.clamp(0, n - 1).long()

    ix = index(local[..., 2], boxes[:, 2], ox)
    iy = index(local[..., 1], boxes[:, 0], oy)
    iz = index(local[..., 0], boxes[:, 1], oz)
    b_idx = torch.arange(B, device=points.device)[:, None]
    seg = ((b_idx * ox + ix) * oy + iy) * oz + iz
    seg = torch.where(inside, seg, torch.full_like(seg, nseg)).reshape(-1)
    feats = features.repeat(B, 1)  # [B * P, C], box-major as seg
    if mode == "max":
        pooled = torch.zeros((nseg + 1, C), dtype=features.dtype,
                             device=features.device)
        pooled.scatter_reduce_(0, seg[:, None].expand(-1, C), feats, "amax",
                               include_self=False)
        pooled = torch.where(torch.isfinite(pooled), pooled,
                             torch.zeros_like(pooled))
    elif mode == "avg":
        order = torch.sort(seg, stable=True).indices
        lengths = torch.bincount(seg, minlength=nseg + 1)
        sums = torch.segment_reduce(feats[order], "sum", lengths=lengths,
                                    unsafe=True)
        pooled = sums / lengths.clamp(min=1).to(sums.dtype)[:, None]
    else:
        raise NotImplementedError(mode)
    return pooled[:-1].reshape(B, ox, oy, oz, C)
