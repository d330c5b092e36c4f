"""Batched pose update from neural confidence fields (port of
snvc_tpu/ops/registration.py): the closed-form weighted 2D rigid fit and
``ncf_to_update`` with the Filter gate."""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from snvc_tpu_torch.ops.heatmaps import hard_argmax_2d, soft_argmax_2d_ref
from snvc_tpu_torch.utils.device import constant

# object-frame part coordinates of a unit box (reference vernier.py:744-751)
PART_X = (0.0, 0.5, 0.5, 0.5, 0.5, -0.5, -0.5, -0.5, -0.5)
PART_Z = (0.0, 0.5, 0.5, -0.5, -0.5, 0.5, 0.5, -0.5, -0.5)


def _rot2(R, pts):
    """[..., 2, 2] rotations applied to [..., 2, P] points, elementwise."""
    x = R[..., 0, 0:1] * pts[..., 0, :] + R[..., 0, 1:2] * pts[..., 1, :]
    y = R[..., 1, 0:1] * pts[..., 0, :] + R[..., 1, 1:2] * pts[..., 1, :]
    return torch.stack([x, y], dim=-2)


def rigid_transform_2d_batch(src, dst, weights=None):
    """Weighted 2D rigid fit: src, dst [..., 2, P]; weights [..., P].
    Returns (R [..., 2, 2], t [..., 2, 1]); theta = atan2(b, a)."""
    mu_s = src.mean(dim=-1, keepdim=True)
    mu_d = dst.mean(dim=-1, keepdim=True)
    xs = src - mu_s
    xd = dst - mu_d
    w = torch.ones_like(src[..., 0, :]) if weights is None else weights
    a = (w * (xs[..., 0, :] * xd[..., 0, :] + xs[..., 1, :] * xd[..., 1, :])).sum(-1)
    b = (w * (xs[..., 0, :] * xd[..., 1, :] - xs[..., 1, :] * xd[..., 0, :])).sum(-1)
    theta = torch.atan2(b, a)
    c, s = torch.cos(theta), torch.sin(theta)
    R = torch.stack([torch.stack([c, -s], dim=-1),
                     torch.stack([s, c], dim=-1)], dim=-2)
    t = mu_d - _rot2(R, mu_s)
    return R, t


class NcfUpdate(NamedTuple):
    one_part: torch.Tensor  # [N, 7]
    all_parts: torch.Tensor  # [N, 7]
    confidence: torch.Tensor  # [N, P]
    keep: torch.Tensor  # [N] bool


def ncf_to_update(ncf, samples, x_range: Tuple[float, float],
                  z_range: Tuple[float, float],
                  coordinates: Optional[torch.Tensor] = None,
                  filter_min: float = -1.0, filter_max: float = 2.0,
                  decode: str = "argmax") -> NcfUpdate:
    """NCF [N, P, nl, nw] + proposals [N, 7] -> refined boxes (JAX
    registration.py:69; decode "coordinates" | "argmax" | "soft-argmax";
    "coordinates" decodes by argmax when ``coordinates`` is None).  A 5-D
    NCF (the ``3D`` head's) raises ValueError, as JAX's 4-D unpack
    does."""
    if ncf.ndim != 4:
        raise ValueError(f"ncf must be [N, P, nl, nw] BEV maps, got "
                         f"{tuple(ncf.shape)}")
    N, P, nl, nw = ncf.shape
    dev = ncf.device
    flat = ncf.reshape(N, P, -1)
    confidence = flat.max(dim=-1).values
    keep = ((flat >= filter_min) & (flat <= filter_max)).all(dim=2).all(dim=1)

    x0, x1 = x_range
    z0, z1 = z_range
    if coordinates is not None and decode == "coordinates":
        off_x = x0 + coordinates[..., 0] * (x1 - x0)
        off_z = z0 + coordinates[..., 1] * (z1 - z0)
    else:
        if decode == "soft-argmax":
            xy, _ = soft_argmax_2d_ref(ncf)
        else:
            xy, _ = hard_argmax_2d(ncf)
        off_x = x0 + xy[..., 0] * (x1 - x0) / (nw - 1)
        off_z = z0 + xy[..., 1] * (z1 - z0) / (nl - 1)

    h, w, l = samples[:, 0], samples[:, 1], samples[:, 2]
    ry = samples[:, 6]
    c, s = torch.cos(ry), torch.sin(ry)
    cam_x = -off_x * s[:, None] + off_z * c[:, None]
    cam_z = -off_x * c[:, None] - off_z * s[:, None]
    center_x = samples[:, 3]
    center_z = samples[:, 5]

    one_part = samples.clone()
    one_part[:, 3] = center_x + cam_x[:, 0]
    one_part[:, 5] = center_z + cam_z[:, 0]

    px = constant(PART_X[:P], dev, samples.dtype)
    pz = constant(PART_Z[:P], dev, samples.dtype)
    src_x = px[None] * l[:, None]
    src_z = pz[None] * w[:, None]
    src_cam_x = src_x * c[:, None] + src_z * s[:, None] + center_x[:, None]
    src_cam_z = -src_x * s[:, None] + src_z * c[:, None] + center_z[:, None]
    src = torch.stack([src_cam_x, src_cam_z], dim=1)  # [N, 2, P]
    dst = torch.stack([center_x[:, None] + cam_x, center_z[:, None] + cam_z],
                      dim=1)
    R, t = rigid_transform_2d_batch(src, dst, weights=confidence)
    moved = _rot2(R, src) + t
    canon = torch.stack([src_x, src_z], dim=1)
    Rc, _ = rigid_transform_2d_batch(canon, moved)
    angle = torch.atan2(Rc[:, 1, 0], Rc[:, 0, 0])
    all_parts = samples.clone()
    all_parts[:, 3] = moved[:, 0, 0]
    all_parts[:, 5] = moved[:, 1, 0]
    all_parts[:, 6] = -angle

    keep_col = keep[:, None]
    one_part = torch.where(keep_col, one_part, samples)
    all_parts = torch.where(keep_col, all_parts, samples)
    return NcfUpdate(one_part, all_parts, confidence, keep)
