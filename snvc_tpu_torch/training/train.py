"""Vernier training step (port of snvc_tpu/training/train.py, one device,
no mesh).

One step does what the JAX ``train_step`` does: ``assemble_instances``
(ROI warps and grid projections), ``make_targets``, the model's forward in
train mode, ``vernier_losses``, the backward, the clip by global norm, an
AdamW update at the warmup-cosine rate, and BatchNorm's running-average
update (inside the forward).

The optimizer is written to optax's semantics (JAX train.py:44-55):

  * the rate is ``optax.warmup_cosine_decay_schedule(0, lr, warmup,
    max(total, warmup + 1))`` read at the count *before* the update, so
    step 0 has rate 0 (``learning_rate``);
  * gradients whose global norm is at least ``grad_clip`` are scaled by
    ``grad_clip / norm`` (``clip_by_global_norm``; not
    ``torch.nn.utils.clip_grad_norm_``, whose factor is
    ``max_norm / (norm + 1e-6)``);
  * ``torch.optim.AdamW`` with betas (0.9, 0.999), eps 1e-8 and decoupled
    decay of every parameter is ``optax.adamw``.

The model's parameters, BatchNorm statistics and the optimizer's moments
live in torch objects and are updated in place; ``TrainState`` holds them
with the step count.  Checkpoints are ``torch.save`` files with the
config's JSON beside them.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from snvc_tpu_torch.config import TrainConfig, VernierConfig
from snvc_tpu_torch.models.losses import vernier_losses
from snvc_tpu_torch.models.vernier import VernierScale
from snvc_tpu_torch.ops.assemble import (
    assemble_instances,
    make_grid_local,
    make_targets,
)

BATCH_KEYS = ("images_left", "images_right", "P_left", "P_right",
              "image_idx", "trans_l", "trans_r", "samples", "valid",
              "gt_boxes", "points", "points_valid")


def learning_rate(tc: TrainConfig, count: int) -> float:
    """``optax.warmup_cosine_decay_schedule(init_value=0, peak_value=lr,
    warmup_steps, decay_steps=max(total_steps, warmup_steps + 1))`` at
    ``count``: linear from 0 over the warm-up, then a cosine to 0 over the
    remaining decay steps."""
    warm = tc.warmup_steps
    decay = max(tc.total_steps, warm + 1) - warm
    if count < warm:
        return (0.0 - tc.lr) * (1.0 - count / warm) + tc.lr
    c = min(count - warm, decay)
    return tc.lr * 0.5 * (1.0 + math.cos(math.pi * c / decay))


def clip_by_global_norm(grads, max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm in place: when the global norm (float32
    sqrt of the sum of every element's square) is at least ``max_norm``,
    each gradient is scaled by ``max_norm / norm``.  Returns the norm
    before clipping."""
    norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    for g in grads:
        g.mul_(scale)
    return norm


@dataclasses.dataclass
class TrainState:
    """The step count, the model (parameters and BatchNorm statistics) and
    its optimizer."""

    step: int
    model: VernierScale
    optimizer: torch.optim.AdamW


def make_optimizer(model: VernierScale, tc: TrainConfig) -> torch.optim.AdamW:
    """AdamW over every parameter; ``train_step`` sets the rate per step."""
    return torch.optim.AdamW(model.parameters(), lr=0.0, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=tc.weight_decay)


def create_train_state(model: VernierScale, cfg: VernierConfig,
                       tc: TrainConfig) -> TrainState:
    """Puts ``model`` in train mode and pairs it with a new optimizer."""
    if cfg.use_bbox_head or cfg.use_part_reg_head:
        raise NotImplementedError("training the bbox / part-offset heads is "
                                  "not ported")
    model.train()
    return TrainState(step=0, model=model,
                      optimizer=make_optimizer(model, tc))


def batch_to_device(batch: Mapping[str, np.ndarray],
                    device) -> Dict[str, torch.Tensor]:
    """The training keys of a ``synthetic_batch_arrays`` dict as tensors on
    ``device``."""
    return {k: torch.as_tensor(np.asarray(batch[k])).to(device)
            for k in BATCH_KEYS}


def train_step(state: TrainState, batch: Mapping[str, torch.Tensor],
               cfg: VernierConfig, tc: TrainConfig,
               grid_local: torch.Tensor) -> Dict[str, torch.Tensor]:
    """One step on ``batch`` (tensors on the model's device): updates
    ``state`` in place and returns the losses and the gradients' global
    norm (before clipping), as 0-d tensors."""
    model, opt = state.model, state.optimizer
    left, right, gpl, gpr = assemble_instances(
        batch["images_left"], batch["images_right"], batch["image_idx"],
        batch["trans_l"], batch["trans_r"], batch["samples"],
        batch["P_left"], batch["P_right"], grid_local, cfg)
    targets = make_targets(batch["samples"], batch["gt_boxes"],
                           batch["points"], batch["points_valid"], grid_local,
                           cfg)
    outputs = model(left, right, gpl, gpr)
    losses = vernier_losses(outputs, targets, batch["valid"], cfg,
                            occupancy_weight=tc.occupancy_weight,
                            coordinate_weight=tc.coordinate_weight)
    opt.zero_grad(set_to_none=True)
    losses["total"].backward()
    # optax updates every parameter: one the loss does not reach (the
    # HRNet's unused low-resolution fusions) gets a zero gradient, so AdamW
    # still decays it
    for p in model.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grads = [p.grad for p in model.parameters()]
    norm = clip_by_global_norm(grads, tc.grad_clip)
    for group in opt.param_groups:
        group["lr"] = learning_rate(tc, state.step)
    opt.step()
    state.step += 1
    metrics = {k: v.detach() for k, v in losses.items()}
    metrics["grad_norm"] = norm
    return metrics


def make_train_step(cfg: VernierConfig, tc: TrainConfig, device):
    """``train_step`` with the config and the object grid bound:
    ``step(state, batch) -> metrics``."""
    grid_local = torch.from_numpy(make_grid_local(cfg)).to(device)
    return functools.partial(train_step, cfg=cfg, tc=tc,
                             grid_local=grid_local)


def save_checkpoint(ckpt_dir: str, state: TrainState, cfg: VernierConfig,
                    step: int) -> str:
    """``ckpt_dir/<step>.pt`` holding the parameters, BatchNorm statistics
    and optimizer state, and ``ckpt_dir/config.json``.  Returns the file."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"{step}.pt")
    torch.save(dict(step=state.step, model=state.model.state_dict(),
                    optimizer=state.optimizer.state_dict()), path)
    with open(os.path.join(ckpt_dir, "config.json"), "w") as fh:
        json.dump(dataclasses.asdict(cfg), fh, indent=2)
    return path


def load_checkpoint(ckpt_dir: str, state: Optional[TrainState] = None):
    """The latest checkpoint of ``ckpt_dir``: returns (tree, step), where
    tree holds ``model`` and ``optimizer`` state dicts; with ``state``,
    also restores them into it."""
    steps = [int(f[:-3]) for f in os.listdir(ckpt_dir)
             if f.endswith(".pt") and f[:-3].isdigit()]
    if not steps:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    step = max(steps)
    tree = torch.load(os.path.join(ckpt_dir, f"{step}.pt"),
                      map_location="cpu", weights_only=True)
    if state is not None:
        state.model.load_state_dict(tree["model"])
        state.optimizer.load_state_dict(tree["optimizer"])
        state.step = tree["step"]
    return tree, step
