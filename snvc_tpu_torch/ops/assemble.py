"""On-device batch assembly for the instance path (port of
snvc_tpu/ops/assemble.py): ROI resampling of both views (with
``add_xy``, each ROI's global-frame coordinate maps appended), the
projection of the object-centric grid into each ROI, and the training
targets (BEV part heatmaps or, with grid type "3D", 3D part fields;
occupancy; the bbox head's BEV box; part offsets)."""

from __future__ import annotations

import numpy as np
import torch

from snvc_tpu_torch.config import VernierConfig
from snvc_tpu_torch.geometry.boxes import PART_X, PART_Y, PART_Z
from snvc_tpu_torch.ops.heatmaps import bev_part_heatmaps, heatmaps_3d
from snvc_tpu_torch.ops.points_in_boxes import (
    _local_coords,
    grid_to_cam,
    occupancy_targets,
)
from snvc_tpu_torch.ops.warp import affine_resample_batch, invert_affine
from snvc_tpu_torch.utils.device import constant


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


def roi_xy_maps(trans, roi_hw, image_size):
    """Global-frame coordinate maps of each ROI's pixels (JAX
    assemble.py:72): trans [B, 2, 3] source->ROI crop affines (scale +
    translate), roi_hw = (oh, ow), image_size = (H, W) of the frame the
    affines act in.  Returns [B, oh, ow, 2]: x = 2 u / W - 1 and
    y = 2 v / H - 1 of each ROI pixel's source position (the reference's
    generate_xy_map)."""
    oh, ow = roi_hw
    gh, gw = image_size
    inv = invert_affine(trans.float())  # ROI -> source
    oy = torch.arange(oh, dtype=torch.float32, device=trans.device)
    ox = torch.arange(ow, dtype=torch.float32, device=trans.device)
    su = inv[:, 0, 0:1] * ox[None] + inv[:, 0, 2:3]  # [B, ow]
    sv = inv[:, 1, 1:2] * oy[None] + inv[:, 1, 2:3]  # [B, oh]
    B = trans.shape[0]
    xm = (2.0 * su / gw - 1.0)[:, None, :].expand(B, oh, ow)
    ym = (2.0 * sv / gh - 1.0)[:, :, None].expand(B, oh, ow)
    return torch.stack([xm, ym], dim=-1)


def assemble_instances(images_left, images_right, image_idx, trans_l,
                       trans_r, samples, P_left, P_right, grid_local,
                       cfg: VernierConfig):
    """Model inputs for a padded instance batch (JAX assemble.py:98).

    images_* [B_img, H, W, 3] uint8; image_idx [B] int; trans_* [B, 2, 3];
    samples [B, 7]; P_* [B_img, 3, 4].  Returns (left_rois, right_rois,
    grid_proj_l, grid_proj_r): ROIs [B, oh, ow, 3] float32 normalized
    (with ``cfg.backbone.add_xy``, [B, oh, ow, 5]: ``roi_xy_maps`` of the
    view's crop appended after the normalization), projections [B, G, 2]
    in ROI pixels."""
    mean = constant(cfg.img_mean, images_left.device)
    std = constant(cfg.img_std, images_left.device)
    idx = image_idx.long()

    def extract(images, trans):
        imgs = images[idx].float() / 255.0
        rois = affine_resample_batch(imgs, trans, cfg.resolution)
        return (rois - mean) / std

    left = extract(images_left, trans_l)
    right = extract(images_right, trans_r)
    if cfg.backbone.add_xy:
        left = torch.cat([left, roi_xy_maps(trans_l, cfg.resolution,
                                            cfg.image_size)], dim=-1)
        right = torch.cat([right, roi_xy_maps(trans_r, cfg.resolution,
                                              cfg.image_size)], dim=-1)
    gpl = grid_projections(samples, P_left[idx], trans_l, grid_local)
    gpr = grid_projections(samples, P_right[idx], trans_r, grid_local)
    return left, right, gpl, gpr


def part_centers_in_grid(samples, gt_boxes, cfg: VernierConfig):
    """The GT boxes' parts in each sample's grid (JAX assemble.py:143):
    ([B, P, 2] (x = w index, z = l index) voxel coordinates, [B, P, 3]
    metric offsets in the sample's object frame, [B, P, 3] (y, x, z)
    voxel coordinates)."""
    P = cfg.num_parts
    nh, nw, nl = cfg.grid_resolution
    parts = constant(np.stack([PART_X, PART_Y, PART_Z])[:, :P],
                     samples.device)
    h, w, l = gt_boxes[:, 0:1], gt_boxes[:, 1:2], gt_boxes[:, 2:3]
    px, py, pz = parts[0] * l, parts[1] * h, parts[2] * w
    c, s = torch.cos(gt_boxes[:, 6:7]), torch.sin(gt_boxes[:, 6:7])
    cam = torch.stack([px * c + pz * s + gt_boxes[:, 3:4],
                       py + gt_boxes[:, 4:5],
                       -px * s + pz * c + gt_boxes[:, 5:6]], dim=-1)
    center = torch.stack([samples[:, 3], samples[:, 4] - 0.5 * samples[:, 0],
                          samples[:, 5]], dim=-1)
    local = _local_coords(cam, center, samples[:, 6])  # (w, h, l)
    spa_y = (cfg.y_range[1] - cfg.y_range[0]) / (nh - 1)
    spa_x = (cfg.x_range[1] - cfg.x_range[0]) / (nw - 1)
    spa_z = (cfg.z_range[1] - cfg.z_range[0]) / (nl - 1)
    iy = local[..., 1] / spa_y + 0.5 * (nh - 1)
    jx = local[..., 0] / spa_x + 0.5 * (nw - 1)
    kz = local[..., 2] / spa_z + 0.5 * (nl - 1)
    return (torch.stack([jx, kz], dim=-1), local,
            torch.stack([iy, jx, kz], dim=-1))


def make_targets(samples, gt_boxes, points, points_valid, grid_local,
                 cfg: VernierConfig):
    """Training targets (JAX assemble.py:180): ncf [B, P, nl, nw] BEV
    gaussians (``cfg.grid_type`` "2D") or [B, P, nh, nw, nl] 3D gaussians
    ("3D", the targets of the ``3D`` head), occupancy [B, nh, nw, nl]
    (1 / 0 / -1)
    and gt_corners_local [B, P, 3]; with ``cfg.use_bbox_head``
    gt_box_local [B, 5], and with ``cfg.use_part_reg_head`` offset
    [B, 3, P, nh, nw, nl].  samples / gt_boxes [B, 7]; points [B, Np, 3];
    points_valid [B, Np] bool; grid_local [G, 3].

    gt_box_local is the 5-dof BEV target of the FC bbox head: the GT
    center in the sample's object frame, the GT l / w, and pi/2 - (sample
    ry - GT ry) (reference KITTIRefinement_dataset.py:744-749).  offset is
    each voxel's displacement to each GT part in the object frame's
    (w, h, l) axes over the grid's extent (reference offsets_local,
    :758-766)."""
    nh, nw, nl = cfg.grid_resolution
    centers, local, idx3 = part_centers_in_grid(samples, gt_boxes, cfg)
    quant = not cfg.ncf_subvoxel
    if cfg.grid_type == "3D":
        ncf = heatmaps_3d(idx3, (nh, nw, nl), cfg.sigma, quantize=quant)
    else:
        ncf = bev_part_heatmaps(centers, (nw, nl), cfg.sigma, quantize=quant)
    occ = occupancy_targets(points, points_valid, samples, gt_boxes,
                            grid_local, (nh, nw, nl), cfg.grid_range)
    out = dict(ncf=ncf, occupancy=occ, gt_corners_local=local)
    if cfg.use_bbox_head:
        out["gt_box_local"] = torch.stack(
            [local[:, 0, 0], local[:, 0, 2], gt_boxes[:, 2], gt_boxes[:, 1],
             0.5 * np.pi - (samples[:, 6] - gt_boxes[:, 6])], dim=1)
    if cfg.use_part_reg_head:
        B, P = local.shape[:2]
        gh, gw, gl = cfg.grid_range
        extent = constant((gw, gh, gl), samples.device)
        diff = (local[:, :, None, :] - grid_local[None, None]) / extent
        out["offset"] = diff.permute(0, 3, 1, 2).reshape(B, 3, P, nh, nw, nl)
    return out
