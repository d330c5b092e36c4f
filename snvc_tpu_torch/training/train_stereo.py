"""Training step of the global stereo detector (port of
snvc_tpu/training/train_stereo.py), on one device or data-parallel over a
process group.

One step does what the JAX ``stereo_train_step`` does: the photometric
jitter (``cfg.photometric_aug``) and image normalization, the StereoNet forward in train mode (the plane sweep K3
and the frustum resample K4 with their backward kernels on the card;
BatchNorm statistics of the small backbones move inside the forward),
on-device RPN target assignment, depth supervision, the backward, and
the clip-by-global-norm AdamW update of ``training/train.py``.  The
depth loss weighs 1, as JAX's fused step has it (its ``depth_weight``
argument is set by no caller).

JAX also has ``make_stereo_train_step_split``: the same step as three
chained programs, which exists only to cut XLA's compile time, with the
fused step's gradients.  PyTorch runs eagerly and compiles nothing, so
the port has the fused step alone.

With the mesh of ``parallel.initialize_multihost`` every rank is given
the same global batch of ``n_data x per-rank`` frames and keeps its
frames (``shard_batch``); the BatchNorm stem and the loss normalizers
reduce over the global batch and the gradients are summed over the ranks,
as in ``training/train.py``.  The photometric jitter is one draw a step,
shared by the batch, so every rank draws it alike.  A mesh with a
"model" axis (``initialize_multihost(..., n_model)``) also splits the
plane-sweep volume on its depth axis over the model group, as JAX's
``_volume_sharding`` does: each rank holds D / n_model planes and a halo
through the 3D stack (models/stereonet.py); the outputs the losses read
come back whole on every model rank, so the losses are the data
position's (training/train.apply_gradients seeds the backward with
1 / n_model).  The one-process mesh of ``parallel.make_mesh(n_data,
devices, n_model > 1)`` runs every position in one call, as
``training/train.position_steps`` runs the Vernier step's.
"""

from __future__ import annotations

import functools
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from snvc_tpu_torch.config import StereoConfig, TrainConfig
from snvc_tpu_torch.data.stereo import check_stereo_projections
from snvc_tpu_torch.models.stereo_losses import (
    depth_multistage_sl1_loss,
    depth_sl1_loss,
    depth_w1_loss,
    rpn3d_loss,
)
from snvc_tpu_torch.models.layers import data_parallel, tensor_parallel
from snvc_tpu_torch.models.stereonet import StereoNet, bev_locations
from snvc_tpu_torch.ops.augment import color_jitter, draw_jitter, normalize
from snvc_tpu_torch.parallel.api import (
    Mesh,
    check_training_mesh,
    global_metrics,
    shard_batch,
)
from snvc_tpu_torch.training.train import (
    TrainState,
    apply_gradients,
    make_optimizer,
    position_steps,
)

STEREO_BATCH_KEYS = ("images_left", "images_right", "P_left", "P_right",
                     "gt_boxes", "gt_valid", "gt_classes", "depth_gt")


def augment_normalize(img_l_u8, img_r_u8, cfg: StereoConfig, step: int):
    """The photometric jitter when ``cfg.photometric_aug`` is set, then
    ImageNet normalization of both views (JAX train_stereo.py:44-63).

    Both views get the same draw, so appearance moves without corrupting
    the left / right comparison of the plane sweep; the draw is one per
    step, shared across the batch.  It comes from a generator seeded by
    ``step``, so a resumed run draws what an unbroken run draws.  JAX
    keys it by ``PRNGKey(step)``: the draws differ from JAX's (see
    ops/augment.py)."""
    left = img_l_u8.float() / 255.0
    right = img_r_u8.float() / 255.0
    if cfg.photometric_aug:
        jitter = draw_jitter(torch.Generator().manual_seed(step))
        left = color_jitter(left, jitter)
        right = color_jitter(right, jitter)
    return normalize(left), normalize(right)


def _depth_loss(out, depth_gt, cfg: StereoConfig, mesh=None):
    """'sl1': multi-stage smooth-L1 over the stacked hourglasses' depths;
    'w1': Wasserstein-1 over the final depth distribution, with the
    per-plane offset when the head has one."""
    mask = depth_gt > 0
    if cfg.depth_loss == "w1":
        return depth_w1_loss(out["depth_prob"], out["depth_levels"],
                             depth_gt, mask, offset=out.get("depth_offset"),
                             mesh=mesh)
    if cfg.depth_loss != "sl1":
        raise ValueError(f"unknown depth_loss {cfg.depth_loss!r}")
    preds = out["depth_preds"]
    if len(preds) == 1:
        return depth_sl1_loss(out["depth"], depth_gt, mask, mesh)
    return depth_multistage_sl1_loss(preds, depth_gt, mask, mesh)


def create_stereo_state(model: StereoNet, tc: TrainConfig) -> TrainState:
    """Puts ``model`` in train mode and pairs it with a new optimizer."""
    model.train()
    return TrainState(step=0, model=model,
                      optimizer=make_optimizer(model, tc))


def stereo_batch_to_device(batch: Mapping[str, np.ndarray],
                           device) -> Dict[str, torch.Tensor]:
    """The training keys of a stereo batch (``synthetic_stereo_request``
    or ``StereoBatch.arrays()``) as tensors on ``device``, after the host
    checks of its projections."""
    check_stereo_projections(batch["P_left"], batch["P_right"])
    return {k: torch.as_tensor(np.asarray(batch[k])).to(device)
            for k in STEREO_BATCH_KEYS}


def stereo_train_step(state: TrainState, batch: Mapping[str, torch.Tensor],
                      cfg: StereoConfig, tc: TrainConfig,
                      locations: torch.Tensor,
                      mesh: Optional[Mesh] = None
                      ) -> Dict[str, torch.Tensor]:
    """One step on ``batch`` (tensors on the model's device, from
    ``stereo_batch_to_device``): updates ``state`` in place and returns
    the losses (total, cls, reg, centerness, depth), num_pos and the
    gradients' global norm before clipping, as 0-d tensors.  With
    ``mesh``, ``batch`` is the global batch and the metrics are the
    global ones."""
    if mesh is not None and mesh.rank is None:
        return position_steps(state, batch,
                              functools.partial(_losses, cfg=cfg), tc, mesh,
                              locations=locations)
    with data_parallel(state.model, mesh), \
            tensor_parallel(state.model, mesh):
        losses, metrics = _losses(state.model, batch, state.step, mesh,
                                  cfg=cfg, locations=locations)
        metrics["grad_norm"] = apply_gradients(state, losses["total"], tc,
                                               mesh)
    return metrics


def _losses(model, batch, step: int, mesh, cfg: StereoConfig,
            locations: torch.Tensor):
    """The losses of ``model`` (the forward in train mode) on ``mesh``'s
    position's frames of the global ``batch`` (all of them without a
    mesh), their ``total``, and the global metrics (detached)."""
    if mesh is not None:
        batch = shard_batch(batch, mesh, mesh.data_index)
    left, right = augment_normalize(batch["images_left"],
                                    batch["images_right"], cfg, step)
    out = model(left, right, batch["P_left"].float(),
                batch["P_right"].float())
    losses = rpn3d_loss(out, batch["gt_boxes"], batch["gt_valid"],
                        batch["gt_classes"], cfg, locations, mesh)
    dloss = _depth_loss(out, batch["depth_gt"], cfg, mesh)
    total = losses["total"] + dloss
    metrics = {k: v.detach() for k, v in losses.items()}
    metrics.update(depth=dloss.detach(), total=total.detach())
    return dict(losses, total=total), global_metrics(metrics, mesh)


def make_stereo_train_step(cfg: StereoConfig, tc: TrainConfig, device,
                           mesh: Optional[Mesh] = None):
    """``stereo_train_step`` with the config and the BEV anchor locations
    bound: ``step(state, batch) -> metrics``.  ``mesh``: the process
    group's mesh (``parallel.initialize_multihost``) for a data-parallel
    step, or a one-process mesh with a model axis
    (``parallel.make_mesh``), the volume's depth split over its model
    axis; the batch's frames must split over its data axis."""
    check_training_mesh(mesh, device)
    locations = torch.from_numpy(bev_locations(cfg)).to(device)
    return functools.partial(stereo_train_step, cfg=cfg, tc=tc,
                             locations=locations, mesh=mesh)
