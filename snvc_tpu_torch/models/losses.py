"""Losses of the Vernier instance model (port of snvc_tpu/models/losses.py:
17-162, the terms the BEV_type3 head trains with): masked means over a
fixed-size padded batch with a per-instance validity mask.

The bbox and part-offset terms are not ported: their heads train only
with targets ``ops/assemble.make_targets`` does not build yet.
"""

from __future__ import annotations

from typing import Dict

import torch


def _masked_mean(x, mask):
    m = mask.to(x.dtype)
    return (x * m).sum() / m.sum().clamp_min(1.0)


def _per_instance(valid, like):
    """valid [B] broadcast to ``like``'s shape."""
    return valid.reshape((-1,) + (1,) * (like.ndim - 1)).expand(like.shape)


def voxel_mse_loss(ncf_pred, ncf_target, valid):
    """Part-heatmap MSE over the valid instances (JAX losses.py:22)."""
    err = (ncf_pred - ncf_target) ** 2
    return _masked_mean(err, _per_instance(valid, err))


def voxel_mse_loss_weighted(ncf_pred, ncf_target, valid):
    """MSE averaged apart over positive and zero targets, then halved and
    summed (JAX losses.py:151)."""
    err = (ncf_pred - ncf_target) ** 2
    v = _per_instance(valid, err)
    pos = (ncf_target > 0) & v
    neg = (ncf_target <= 0) & v
    return 0.5 * (_masked_mean(err, pos) + _masked_mean(err, neg))


def occupancy_loss(occ_pred, occ_target, valid, gamma=2.0, alpha=0.25):
    """Focal BCE on voxel foreground; target -1 is ignored (JAX
    losses.py:35)."""
    p = occ_pred.clamp(1e-7, 1.0 - 1e-7)
    t = occ_target
    term1 = (1.0 - p) ** gamma * torch.log(p)
    term2 = p ** gamma * torch.log(1.0 - p)
    pos = (t == 1.0).to(p.dtype)
    neg = (t == 0.0).to(p.dtype)
    loss = -pos * term1 * alpha - neg * term2 * (1.0 - alpha)
    mask = (t != -1.0) & _per_instance(valid, t)
    return _masked_mean(loss, mask)


def coordinate_loss(coords_pred, gt_corners_local, valid, x_range, z_range,
                    weight_l1: float = 1.0):
    """L1 between the sigmoid part coordinates [B, P, 2] and the GT parts'
    (x, z) offsets normalized into [0, 1] (JAX losses.py:68)."""
    gx = (gt_corners_local[..., 0] - x_range[0]) / (x_range[1] - x_range[0])
    gz = (gt_corners_local[..., 2] - z_range[0]) / (z_range[1] - z_range[0])
    err = (coords_pred - torch.stack([gx, gz], dim=-1)).abs()
    return weight_l1 * _masked_mean(err, _per_instance(valid, err))


def vernier_losses(outputs: Dict, targets: Dict, valid, cfg,
                   occupancy_weight: float = 1.0,
                   coordinate_weight: float = 0.1) -> Dict[str, torch.Tensor]:
    """ncf + w_occ * occupancy + w_coord * coordinates (JAX losses.py:103);
    ``cfg.ncf_loss`` picks the plain or the balanced heatmap MSE."""
    if cfg.ncf_loss not in ("mse", "mse_weighted"):
        raise ValueError(f"ncf_loss {cfg.ncf_loss!r}")
    ncf_fn = (voxel_mse_loss_weighted if cfg.ncf_loss == "mse_weighted"
              else voxel_mse_loss)
    total = ncf_fn(outputs["ncf"], targets["ncf"], valid)
    losses = {"ncf": total}
    if outputs.get("occupancy") is not None:
        lo = occupancy_loss(outputs["occupancy"], targets["occupancy"], valid)
        losses["occupancy"] = lo
        total = total + occupancy_weight * lo
    if outputs.get("coordinates") is not None:
        lc = coordinate_loss(outputs["coordinates"],
                             targets["gt_corners_local"], valid, cfg.x_range,
                             cfg.z_range)
        losses["coordinates"] = lc
        total = total + coordinate_weight * lc
    losses["total"] = total
    return losses
