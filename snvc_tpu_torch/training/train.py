"""Vernier training step (port of snvc_tpu/training/train.py), on one
device or data-parallel over a process group.

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
config's JSON beside them, for either model; rank 0 alone writes them.
The bbox head's dropout draws from a generator seeded per step
(``dropout_generator``).

With the mesh of ``parallel.initialize_multihost`` the step is JAX's step
over a "data" mesh: every rank is given the same global batch, keeps its
rows of the instance fields (``shard_instance_batch``), normalizes its
BatchNorms and losses by the global batch, draws the global dropout mask
and keeps its rows, and sums the gradients over the ranks in one flat
bucket after the backward (parallel/api.py).  A mesh with a "model" axis
also splits the object voxel on its length axis over the model group, as
JAX's ``voxel_sharding`` does (models/vernier.py).  Every model rank
computes its data position's whole loss: the outputs after the gather
are whole on each, and the occupancy and offset losses on the slabs sum
their numerators and counts over the model group.  So the backward is
seeded with 1 / n_model on every rank; the gathers' backward sums their
gradients over the model group, and the sum of the gradients over the
world is the global step's.  The gradients are summed
by hand, not by DistributedDataParallel: DDP averages (the losses here
are already global means), needs ``find_unused_parameters`` for the
HRNet's unused fusions, and would wrap the model whose state dict the
checkpoints hold.
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
from torch import nn

from snvc_tpu_torch.config import TrainConfig, VernierConfig
from snvc_tpu_torch.models.layers import data_parallel, tensor_parallel
from snvc_tpu_torch.models.losses import vernier_losses
from snvc_tpu_torch.models.vernier import VernierScale
from snvc_tpu_torch.ops.assemble import (
    assemble_instances,
    make_grid_local,
    make_targets,
)
from snvc_tpu_torch.parallel.api import (
    Mesh,
    check_training_mesh,
    global_metrics,
    process_index,
    reduce_gradients,
    shard_instance_batch,
)
from snvc_tpu_torch.parallel.local import replicas, run_positions

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
    its optimizer; the Vernier and the stereo steps share it."""

    step: int
    model: nn.Module
    optimizer: torch.optim.AdamW


def make_optimizer(model: nn.Module, tc: TrainConfig) -> torch.optim.AdamW:
    """AdamW over every parameter; the train steps set the rate per
    step."""
    return torch.optim.AdamW(model.parameters(), lr=0.0, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=tc.weight_decay)


def create_train_state(model: VernierScale, cfg: VernierConfig,
                       tc: TrainConfig) -> TrainState:
    """Puts ``model`` in train mode and pairs it with a new optimizer."""
    model.train()
    return TrainState(step=0, model=model,
                      optimizer=make_optimizer(model, tc))


def batch_to_device(batch: Mapping[str, np.ndarray],
                    device) -> Dict[str, torch.Tensor]:
    """The training keys of a ``synthetic_batch_arrays`` dict as tensors on
    ``device``."""
    return {k: torch.as_tensor(np.asarray(batch[k])).to(device)
            for k in BATCH_KEYS}


def dropout_generator(device, seed: int, step: int) -> torch.Generator:
    """The generator of the bbox head's dropout masks at ``step``, on
    ``device``: seeded by (seed, step), so a resumed run draws the masks
    an unbroken run draws.  (JAX splits a key per step in its CLI.)"""
    return torch.Generator(device=device).manual_seed(seed * 2 ** 32 + step)


def train_step(state: TrainState, batch: Mapping[str, torch.Tensor],
               cfg: VernierConfig, tc: TrainConfig,
               grid_local: torch.Tensor,
               mesh: Optional[Mesh] = None) -> Dict[str, torch.Tensor]:
    """One step on ``batch`` (tensors on the model's device): updates
    ``state`` in place and returns the losses and the gradients' global
    norm (before clipping), as 0-d tensors.  The bbox head's dropout,
    where the head has one, draws from ``dropout_generator(tc.seed,
    state.step)``; targets follow ``cfg.grid_type``.  With ``mesh``,
    ``batch`` is the global batch and the metrics are the global ones."""
    if mesh is not None and mesh.rank is None:
        return position_steps(state, batch,
                              functools.partial(_losses, cfg=cfg, tc=tc),
                              tc, mesh, grid_local=grid_local)
    # open through the backward: the rematerialized hourglass's recompute
    # runs its BatchNorms' reductions and its halo exchanges again, and
    # meets the other ranks' recomputes
    with data_parallel(state.model, mesh), \
            tensor_parallel(state.model, mesh):
        losses, metrics = _losses(state.model, batch, state.step, mesh,
                                  cfg=cfg, tc=tc, grid_local=grid_local)
        metrics["grad_norm"] = apply_gradients(state, losses["total"], tc,
                                               mesh)
    return metrics


def _losses(model, batch, step: int, mesh, cfg: VernierConfig,
            tc: TrainConfig, grid_local: torch.Tensor):
    """The losses of ``model`` (the forward in train mode) on ``mesh``'s
    position's part of the global ``batch`` (all of it without a mesh),
    and the global metrics (detached)."""
    if mesh is not None:
        batch = shard_instance_batch(batch, mesh, mesh.data_index)
    left, right, gpl, gpr = assemble_instances(
        batch["images_left"], batch["images_right"], batch["image_idx"],
        batch["trans_l"], batch["trans_r"], batch["samples"],
        batch["P_left"], batch["P_right"], grid_local, cfg)
    targets = make_targets(batch["samples"], batch["gt_boxes"],
                           batch["points"], batch["points_valid"], grid_local,
                           cfg)
    gen = (dropout_generator(grid_local.device, tc.seed, step)
           if model.head.has_bbox else None)
    outputs = model(left, right, gpl, gpr, dropout_generator=gen)
    losses = vernier_losses(outputs, targets, batch["valid"], cfg,
                            occupancy_weight=tc.occupancy_weight,
                            coordinate_weight=tc.coordinate_weight,
                            mesh=mesh)
    return losses, global_metrics({k: v.detach() for k, v in losses.items()},
                                  mesh)


def position_steps(state: TrainState, batch: Mapping[str, torch.Tensor],
                   losses_fn, tc: TrainConfig, mesh: Mesh,
                   **kw) -> Dict[str, torch.Tensor]:
    """The step of a one-process ``mesh`` (the module docstring):
    ``losses_fn(model, batch, step, position, **kw) -> (losses,
    metrics)`` on every position's replica in its thread, with the
    global batch and the tensors in ``kw`` on the position's device,
    then one backward of the positions' summed ``total`` losses over
    ``n_model`` and the update.  The positions' contexts close before
    that backward: a rematerialized block's recompute in it reopens them
    and replays its collectives (``layers.remat_contexts``).  Returns
    position 0's (global) metrics."""
    reps = replicas(state.model, mesh)

    def position(pos):
        dev = pos.devices[pos.rank]
        model = reps[pos.rank]
        with data_parallel(model, pos), tensor_parallel(model, pos):
            return losses_fn(model, {k: v.to(dev) for k, v in batch.items()},
                             state.step, pos,
                             **{k: v.to(dev) for k, v in kw.items()})

    results = run_positions(mesh, position)
    dev = mesh.devices[0]
    total = sum(losses["total"].to(dev) for losses, _ in results)
    metrics = results[0][1]
    metrics["grad_norm"] = apply_gradients(state, total / mesh.n_model, tc)
    return metrics


def apply_gradients(state: TrainState, loss: torch.Tensor,
                    tc: TrainConfig,
                    mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The backward of ``loss``, the sum of the gradients over ``mesh``'s
    ranks, the clip by global norm and the AdamW update at the step's
    rate; advances ``state.step``.  Returns the gradients' global norm
    before clipping.  Every model rank holds its data position's whole
    loss, so each seeds the backward with 1 / n_model (the module
    docstring)."""
    model, opt = state.model, state.optimizer
    opt.zero_grad(set_to_none=True)
    if mesh is not None and mesh.n_model > 1:
        loss = loss / mesh.n_model
    loss.backward()
    # optax updates every parameter: one the loss does not reach (the
    # HRNet's unused low-resolution fusions) gets a zero gradient, so AdamW
    # still decays it
    for p in model.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grads = [p.grad for p in model.parameters()]
    reduce_gradients(grads, mesh)
    norm = clip_by_global_norm(grads, tc.grad_clip)
    for group in opt.param_groups:
        group["lr"] = learning_rate(tc, state.step)
    opt.step()
    state.step += 1
    return norm


def make_train_step(cfg: VernierConfig, tc: TrainConfig, device,
                    mesh: Optional[Mesh] = None):
    """``train_step`` with the config and the object grid bound:
    ``step(state, batch) -> metrics``.  ``mesh``: the process group's
    mesh (``parallel.initialize_multihost``) for a data-parallel step,
    or a one-process mesh with a model axis (``parallel.make_mesh``),
    the voxel's length split over its model axis; ``cfg.max_instances``
    is the global batch and must split over its data axis."""
    check_training_mesh(mesh, device)
    grid_local = torch.from_numpy(make_grid_local(cfg)).to(device)
    return functools.partial(train_step, cfg=cfg, tc=tc,
                             grid_local=grid_local, mesh=mesh)


def save_checkpoint(ckpt_dir: str, state: TrainState, cfg,
                    step: int) -> str:
    """``ckpt_dir/<step>.pt`` holding the step count, the parameters,
    BatchNorm statistics and AdamW state (moments and per-parameter step
    counts), and ``ckpt_dir/config.json`` (``cfg``: a VernierConfig or a
    StereoConfig).  Returns the file, which process 0 alone writes (the
    ranks of a data-parallel run hold the same state)."""
    path = os.path.join(ckpt_dir, f"{step}.pt")
    if process_index() != 0:
        return path
    os.makedirs(ckpt_dir, exist_ok=True)
    torch.save(dict(step=state.step, model=state.model.state_dict(),
                    optimizer=state.optimizer.state_dict()), path)
    with open(os.path.join(ckpt_dir, "config.json"), "w") as fh:
        json.dump(dataclasses.asdict(cfg), fh, indent=2)
    return path


def load_checkpoint(ckpt_dir: str, state: Optional[TrainState] = None):
    """The latest checkpoint of ``ckpt_dir``: returns (tree, step), where
    tree holds the ``model`` state dict and, when the file was written by
    ``save_checkpoint``, the ``optimizer``'s; with ``state``, also
    restores them into it, bit for bit, with its step count (which sets
    the next step's rate).  A model-only file (a converted JAX checkpoint,
    scripts/convert_jax_checkpoint.py) leaves the optimizer as it is."""
    steps = [int(f[:-3]) for f in os.listdir(ckpt_dir)
             if f.endswith(".pt") and f[:-3].isdigit()]
    if not steps:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    step = max(steps)
    tree = torch.load(os.path.join(ckpt_dir, f"{step}.pt"),
                      map_location="cpu", weights_only=True)
    if state is not None:
        state.model.load_state_dict(tree["model"])
        if "optimizer" in tree:
            state.optimizer.load_state_dict(tree["optimizer"])
        state.step = tree["step"]
    return tree, step
