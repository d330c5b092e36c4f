"""Losses of the Vernier instance model (port of snvc_tpu/models/losses.py):
masked means over a fixed-size padded batch with a per-instance validity
mask.  ``vernier_losses`` is what every Vernier head trains with: the
heatmap term (BEV maps or the ``3D`` head's fields: the masked means
take any rank), and the occupancy, coordinate, part-offset and FC bbox
terms of the heads that give those outputs.  The 3D bbox loss, its
approximate 3D IoU, the disentangled corner loss and the shape-code L1
are ported beside them; no training path of either package calls them.

With a process-group ``mesh`` (parallel/api.py) each masked mean divides
this rank's masked sum by the count of the global batch, so the global
loss is the sum of the data positions' losses.  Under a model axis the
occupancy and offset outputs are slabs of the length axis (models/
vernier.py, whole units of ``2^length_levels(cfg)`` lengths, even or
not): their targets are split alike, and their sums and counts are
summed over the model group, so every model position holds its data
position's whole loss.  The heatmap, coordinate and bbox outputs come
out whole on every model position (gathered in the head).
"""

from __future__ import annotations

from typing import Dict

import torch

from snvc_tpu_torch.models.stereo_losses import gt_corners_24
from snvc_tpu_torch.models.vernier import length_levels
from snvc_tpu_torch.ops.rotated_iou import pair_overlap
from snvc_tpu_torch.parallel.api import global_sum
from snvc_tpu_torch.parallel.tensor import model_sum, shard


def _split(mesh) -> bool:
    """Whether ``mesh`` has a model axis: the occupancy and offset outputs
    are slabs of the length axis."""
    return mesh is not None and mesh.n_model > 1


def _masked_mean(x, mask, mesh=None, slab: bool = False):
    """Masked mean over the global batch; ``slab``: ``x`` is this rank's
    slab under a model axis, whose sums are the model group's."""
    m = mask.to(x.dtype)
    num, count = (x * m).sum(), m.sum()
    if slab and _split(mesh):
        num, count = model_sum(torch.stack([num, count]), mesh).unbind()
    return num / global_sum(count, mesh).clamp_min(1.0)


def _per_instance(valid, like):
    """valid [B] broadcast to ``like``'s shape."""
    return valid.reshape((-1,) + (1,) * (like.ndim - 1)).expand(like.shape)


def voxel_mse_loss(ncf_pred, ncf_target, valid, mesh=None):
    """Part-heatmap MSE over the valid instances (JAX losses.py:22)."""
    err = (ncf_pred - ncf_target) ** 2
    return _masked_mean(err, _per_instance(valid, err), mesh)


def voxel_mse_loss_weighted(ncf_pred, ncf_target, valid, mesh=None):
    """MSE averaged apart over positive and zero targets, then halved and
    summed (JAX losses.py:151)."""
    err = (ncf_pred - ncf_target) ** 2
    v = _per_instance(valid, err)
    pos = (ncf_target > 0) & v
    neg = (ncf_target <= 0) & v
    return 0.5 * (_masked_mean(err, pos, mesh) + _masked_mean(err, neg, mesh))


def occupancy_loss(occ_pred, occ_target, valid, gamma=2.0, alpha=0.25,
                   mesh=None, unit: int = 1):
    """Focal BCE on voxel foreground; target -1 is ignored (JAX
    losses.py:35).  Under a model axis ``occ_pred`` is this position's
    slab of the length axis (3), in units of ``unit`` lengths, and
    ``occ_target`` whole."""
    p = occ_pred.clamp(1e-7, 1.0 - 1e-7)
    t = shard(occ_target, 3, mesh, unit) if _split(mesh) else occ_target
    term1 = (1.0 - p) ** gamma * torch.log(p)
    term2 = p ** gamma * torch.log(1.0 - p)
    pos = (t == 1.0).to(p.dtype)
    neg = (t == 0.0).to(p.dtype)
    loss = -pos * term1 * alpha - neg * term2 * (1.0 - alpha)
    mask = (t != -1.0) & _per_instance(valid, t)
    return _masked_mean(loss, mask, mesh, slab=True)


def offset_loss(offset_pred, offset_target, occupancy_target, valid,
                mesh=None, unit: int = 1):
    """L1 on the part offsets at the foreground voxels (JAX losses.py:51).
    offset_pred [B, 3*P, nh, nw, nl] (the head's 27 channels), reshaped to
    offset_target [B, 3, P, nh, nw, nl]; occupancy_target [B, nh, nw, nl].
    Under a model axis ``offset_pred`` is this position's slab of nl (in
    units of ``unit``) and the targets whole."""
    if _split(mesh):
        offset_target = shard(offset_target, 5, mesh, unit)
        occupancy_target = shard(occupancy_target, 3, mesh, unit)
    err = (offset_pred.reshape(offset_target.shape) - offset_target).abs()
    fg = (occupancy_target == 1.0)[:, None, None]
    mask = fg & _per_instance(valid, err)
    return _masked_mean(err, mask, mesh, slab=True)


def coordinate_loss(coords_pred, gt_corners_local, valid, x_range, z_range,
                    weight_l1: float = 1.0, mesh=None):
    """L1 between the sigmoid part coordinates [B, P, 2] and the GT parts'
    (x, z) offsets normalized into [0, 1] (JAX losses.py:68)."""
    gx = (gt_corners_local[..., 0] - x_range[0]) / (x_range[1] - x_range[0])
    gz = (gt_corners_local[..., 2] - z_range[0]) / (z_range[1] - z_range[0])
    err = (coords_pred - torch.stack([gx, gz], dim=-1)).abs()
    return weight_l1 * _masked_mean(err, _per_instance(valid, err), mesh)


def shape_loss(shape_pred, shape_target, valid, scaling: float = 1e4):
    """L1 on shape codes, the target divided by ``scaling`` (JAX
    losses.py:92, the reference's ShapeLoss, loss3d.py:603-612)."""
    err = (shape_pred - shape_target / scaling).abs()
    return _masked_mean(err, _per_instance(valid, err))


def vernier_losses(outputs: Dict, targets: Dict, valid, cfg,
                   occupancy_weight: float = 1.0,
                   coordinate_weight: float = 0.1,
                   mesh=None) -> Dict[str, torch.Tensor]:
    """ncf + w_occ * occupancy + w_coord * coordinates (JAX losses.py:103);
    ``cfg.ncf_loss`` picks the plain or the balanced heatmap MSE.  With a
    process-group ``mesh`` every term is this rank's part of the global
    batch's loss."""
    if cfg.ncf_loss not in ("mse", "mse_weighted"):
        raise ValueError(f"ncf_loss {cfg.ncf_loss!r}")
    ncf_fn = (voxel_mse_loss_weighted if cfg.ncf_loss == "mse_weighted"
              else voxel_mse_loss)
    total = ncf_fn(outputs["ncf"], targets["ncf"], valid, mesh)
    losses = {"ncf": total}
    unit = 2 ** length_levels(cfg)  # of the slabs under a model axis
    if outputs.get("occupancy") is not None:
        lo = occupancy_loss(outputs["occupancy"], targets["occupancy"], valid,
                            mesh=mesh, unit=unit)
        losses["occupancy"] = lo
        total = total + occupancy_weight * lo
    if outputs.get("offset") is not None and "offset" in targets:
        loff = offset_loss(outputs["offset"], targets["offset"],
                           targets["occupancy"], valid, mesh, unit)
        losses["offset"] = loff
        total = total + loff
    if outputs.get("coordinates") is not None:
        lc = coordinate_loss(outputs["coordinates"],
                             targets["gt_corners_local"], valid, cfg.x_range,
                             cfg.z_range, mesh=mesh)
        losses["coordinates"] = lc
        total = total + coordinate_weight * lc
    if outputs.get("bbox") is not None and "gt_box_local" in targets:
        lb = bbox_loss_2d(outputs["bbox"], targets["gt_box_local"],
                          valid, mesh)["l1"]
        losses["bbox"] = lb
        total = total + lb
    losses["total"] = total
    return losses


def _bev5_from_box3d(box3d):
    """box3d [..., 7] -> (cx, cz, l, w, -ry) center-height BEV box."""
    return torch.stack([box3d[..., 3], box3d[..., 5], box3d[..., 2],
                        box3d[..., 1], -box3d[..., 6]], dim=-1)


def approximated_iou3d(pred_box3d, gt_box3d):
    """Elementwise 3D IoU as BEV overlap x height overlap (JAX
    losses.py:178; reference approximated_3d_iou_pt).  [N, 7] x [N, 7]
    -> [N]."""
    ov_bev = pair_overlap(_bev5_from_box3d(pred_box3d),
                          _bev5_from_box3d(gt_box3d))
    top_p = pred_box3d[:, 4] - pred_box3d[:, 0]
    top_g = gt_box3d[:, 4] - gt_box3d[:, 0]
    ymax = torch.minimum(pred_box3d[:, 4], gt_box3d[:, 4])
    ymin = torch.maximum(top_p, top_g)
    inter = ov_bev * (ymax - ymin).clamp_min(0.0)
    vol_p = pred_box3d[:, 0] * pred_box3d[:, 1] * pred_box3d[:, 2]
    vol_g = gt_box3d[:, 0] * gt_box3d[:, 1] * gt_box3d[:, 2]
    return inter / (vol_p + vol_g - inter).clamp_min(1e-6)


def _smooth_l1(n, beta: float):
    return torch.where(n < beta, 0.5 * n ** 2 / beta, n - 0.5 * beta)


def bbox_loss_3d(pred_box3d, gt_box3d, valid, beta: float = 0.2):
    """Smooth-L1 on the 7 box parameters and 1 - IoU3D, over the valid
    instances (JAX losses.py:198)."""
    sl1 = _smooth_l1((pred_box3d - gt_box3d).abs(), beta).mean(dim=-1)
    iou = approximated_iou3d(pred_box3d, gt_box3d)
    m = valid.to(sl1.dtype)
    denom = m.sum().clamp_min(1.0)
    return {"sl1": 0.5 * (sl1 * m).sum() / denom,
            "IoU3D": ((1.0 - iou) * m).sum() / denom}


def bbox_loss_2d(pred_bev5, gt_bev5, valid, mesh=None):
    """Plain L1 on the BEV box over the valid instances (JAX
    losses.py:212; reference BboxLoss '2D' branch)."""
    err = (pred_bev5 - gt_bev5).abs()
    return {"l1": _masked_mean(err, _per_instance(valid, err), mesh)}


def disentangled_corner_loss(pred7, target7, weights):
    """Disentangled corner loss (JAX losses.py:220; reference
    disentangled_loss): one parameter group at a time (dxyz, dims, angle)
    of ``pred7`` swapped into ``target7``, each mapped to its 8 corners
    and held to the target's by smooth-L1, weighted per row.  pred7 /
    target7 [N, 7] = (dx, dy, dz, h, w, l, theta); weights [N]."""

    def corners(p):
        box3d = p[:, [3, 4, 5, 0, 1, 2, 6]]  # -> (h, w, l, x, y, z, ry)
        return gt_corners_24(box3d).reshape(p.shape[0], 24)

    gt_c = corners(target7)

    def sl1(a, b):
        per = _smooth_l1((a - b).abs(), 1.0 / 9).mean(dim=1)
        return (per * weights).sum() / weights.sum().clamp_min(1e-6)

    g1 = torch.cat([pred7[:, :3], target7[:, 3:]], dim=1)
    g2 = torch.cat([target7[:, :3], pred7[:, 3:6], target7[:, 6:]], dim=1)
    g3 = torch.cat([target7[:, :6], pred7[:, 6:]], dim=1)
    return (sl1(corners(g1), gt_c) + sl1(corners(g2), gt_c)
            + sl1(corners(g3), gt_c)) / 3.0
