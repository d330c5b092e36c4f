"""On-device batch assembly for the instance path (port of
snvc_tpu/ops/assemble.py): ROI resampling of both views, the projection of
the object-centric grid into each ROI, and the training targets (BEV part
heatmaps, occupancy, part offsets) of the 2D grid type."""

from __future__ import annotations

import numpy as np
import torch

from snvc_tpu_torch.config import VernierConfig
from snvc_tpu_torch.geometry.boxes import PART_X, PART_Y, PART_Z
from snvc_tpu_torch.ops.heatmaps import bev_part_heatmaps
from snvc_tpu_torch.ops.points_in_boxes import (
    _local_coords,
    grid_to_cam,
    occupancy_targets,
)
from snvc_tpu_torch.ops.warp import affine_resample_batch


def make_grid_local(cfg: VernierConfig) -> np.ndarray:
    """Object-frame grid points [nh*nw*nl, 3] (x=w, y=h, z=l) in h-major
    ravel order (reference _init_3d_grid)."""
    nh, nw, nl = cfg.grid_resolution
    ys = np.linspace(cfg.y_range[0], cfg.y_range[1], nh)
    xs = np.linspace(cfg.x_range[0], cfg.x_range[1], nw)
    zs = np.linspace(cfg.z_range[0], cfg.z_range[1], nl)
    gy, gx, gz = np.meshgrid(ys, xs, zs, indexing="ij")
    return np.stack([gx, gy, gz], axis=-1).reshape(-1, 3).astype(np.float32)


def grid_projections(samples, P, trans, grid_local):
    """Project each instance's grid into one view's ROI pixels.

    samples [B, 7]; P [B, 3, 4]; trans [B, 2, 3] source->ROI affines;
    grid_local [G, 3].  Returns [B, G, 2]."""
    cam = grid_to_cam(grid_local, samples)
    uvw = cam @ P[:, :, :3].transpose(1, 2) + P[:, None, :, 3]
    uv = uvw[..., :2] / uvw[..., 2:3]
    return uv @ trans[:, :, :2].transpose(1, 2) + trans[:, None, :, 2]


def assemble_instances(images_left, images_right, image_idx, trans_l,
                       trans_r, samples, P_left, P_right, grid_local,
                       cfg: VernierConfig):
    """Model inputs for a padded instance batch (JAX assemble.py:98).

    images_* [B_img, H, W, 3] uint8; image_idx [B] int; trans_* [B, 2, 3];
    samples [B, 7]; P_* [B_img, 3, 4].  Returns (left_rois, right_rois,
    grid_proj_l, grid_proj_r): ROIs [B, oh, ow, 3] float32 normalized,
    projections [B, G, 2] in ROI pixels."""
    if cfg.backbone.add_xy:
        raise NotImplementedError("add_xy ROI coordinate maps are not ported")
    mean = torch.tensor(cfg.img_mean, dtype=torch.float32,
                        device=images_left.device)
    std = torch.tensor(cfg.img_std, dtype=torch.float32,
                       device=images_left.device)
    idx = image_idx.long()

    def extract(images, trans):
        imgs = images[idx].float() / 255.0
        rois = affine_resample_batch(imgs, trans, cfg.resolution)
        return (rois - mean) / std

    left = extract(images_left, trans_l)
    right = extract(images_right, trans_r)
    gpl = grid_projections(samples, P_left[idx], trans_l, grid_local)
    gpr = grid_projections(samples, P_right[idx], trans_r, grid_local)
    return left, right, gpl, gpr


def part_centers_in_grid(samples, gt_boxes, cfg: VernierConfig):
    """The GT boxes' parts in each sample's grid (JAX assemble.py:143):
    ([B, P, 2] (x = w index, z = l index) voxel coordinates, [B, P, 3]
    metric offsets in the sample's object frame)."""
    P = cfg.num_parts
    nh, nw, nl = cfg.grid_resolution
    parts = torch.tensor(np.stack([PART_X, PART_Y, PART_Z])[:, :P],
                         dtype=torch.float32, device=samples.device)
    h, w, l = gt_boxes[:, 0:1], gt_boxes[:, 1:2], gt_boxes[:, 2:3]
    px, py, pz = parts[0] * l, parts[1] * h, parts[2] * w
    c, s = torch.cos(gt_boxes[:, 6:7]), torch.sin(gt_boxes[:, 6:7])
    cam = torch.stack([px * c + pz * s + gt_boxes[:, 3:4],
                       py + gt_boxes[:, 4:5],
                       -px * s + pz * c + gt_boxes[:, 5:6]], dim=-1)
    center = torch.stack([samples[:, 3], samples[:, 4] - 0.5 * samples[:, 0],
                          samples[:, 5]], dim=-1)
    local = _local_coords(cam, center, samples[:, 6])  # (w, h, l)
    spa_x = (cfg.x_range[1] - cfg.x_range[0]) / (nw - 1)
    spa_z = (cfg.z_range[1] - cfg.z_range[0]) / (nl - 1)
    jx = local[..., 0] / spa_x + 0.5 * (nw - 1)
    kz = local[..., 2] / spa_z + 0.5 * (nl - 1)
    return torch.stack([jx, kz], dim=-1), local


def make_targets(samples, gt_boxes, points, points_valid, grid_local,
                 cfg: VernierConfig):
    """Training targets (JAX assemble.py:180), grid type "2D": ncf
    [B, P, nl, nw] BEV gaussians, occupancy [B, nh, nw, nl] (1 / 0 / -1)
    and gt_corners_local [B, P, 3].  samples / gt_boxes [B, 7]; points
    [B, Np, 3]; points_valid [B, Np] bool; grid_local [G, 3]."""
    if cfg.grid_type != "2D":
        raise NotImplementedError(f"grid_type {cfg.grid_type!r} is not ported")
    if cfg.use_bbox_head or cfg.use_part_reg_head:
        raise NotImplementedError("the bbox / part-offset targets are not "
                                  "ported")
    nh, nw, nl = cfg.grid_resolution
    centers, local = part_centers_in_grid(samples, gt_boxes, cfg)
    ncf = bev_part_heatmaps(centers, (nw, nl), cfg.sigma,
                            quantize=not cfg.ncf_subvoxel)
    occ = occupancy_targets(points, points_valid, samples, gt_boxes,
                            grid_local, (nh, nw, nl), cfg.grid_range)
    return dict(ncf=ncf, occupancy=occ, gt_corners_local=local)
