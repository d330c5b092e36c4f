"""What the three end-metric demos share (tools/demo_ap_lift.py,
demo_tracking.py, demo_two_stage.py): the Vernier training loop over a
KITTI tree with synthetic supervision, the refinement of a split's
proposal files and the AP readout."""

from __future__ import annotations

import os
from typing import Callable, Iterable, Mapping, Optional

import numpy as np

from snvc_tpu_torch.config import TrainConfig, VernierConfig
from snvc_tpu_torch.data.instance_db import (
    build_db_from_gt,
    build_db_from_predictions,
)
from snvc_tpu_torch.data.kitti import KittiDataset
from snvc_tpu_torch.data.pipeline import RefinementPipeline
from snvc_tpu_torch.inference.kitti_writer import PredictionWriter
from snvc_tpu_torch.inference.refine import RefineRunner
from snvc_tpu_torch.models.vernier import VernierScale
from snvc_tpu_torch.training.train import (
    TrainState,
    batch_to_device,
    create_train_state,
    make_train_step,
)
from snvc_tpu_torch.utils.seeding import reset_seed


def fit(state: TrainState, step_fn: Callable,
        epoch: Callable[[], Iterable[Mapping]], steps: int, log_every: int,
        log: Callable[[str], None], prefix: str = "step",
        after_step: Optional[Callable[[int], None]] = None) -> TrainState:
    """Steps ``state`` to ``steps`` over passes of ``epoch()`` (device
    batches), logging the metrics every ``log_every`` steps (JAX's line:
    ``<prefix> <step>: k=v, ...``, keys sorted); ``after_step(step)`` runs
    after each step."""
    while state.step < steps:
        for batch in epoch():
            metrics = step_fn(state, batch)
            if state.step % log_every == 0:
                log(f"{prefix} {state.step}: " + ", ".join(
                    f"{k}={float(v):.4f}" for k, v in sorted(metrics.items())))
            if after_step is not None:
                after_step(state.step)
            if state.step >= steps:
                break
    return state


def new_refiner(cfg: VernierConfig, tc: TrainConfig, seed: int,
                device) -> TrainState:
    """A Vernier model with weights drawn from ``seed``, on ``device``,
    in a new training state."""
    model = VernierScale(cfg, device=device, generator=reset_seed(seed))
    return create_train_state(model, cfg, tc)


def train_refiner(state: TrainState, cfg: VernierConfig, tc: TrainConfig,
                  train_root: str, seed: int, log_every: int,
                  log: Callable[[str], None], noise_bank=None,
                  prefix: str = "step", after_step=None) -> TrainState:
    """Trains ``state`` to ``tc.total_steps`` on the GT boxes of the
    ``train`` split of ``train_root``, proposals drawn around them (from
    ``noise_bank`` when given)."""
    db = build_db_from_gt(KittiDataset(train_root, "train"), cfg)
    pipe = RefinementPipeline(db, cfg, training=True, seed=seed,
                              noise_bank=noise_bank)
    dev = state.model.device
    step_fn = make_train_step(cfg, tc, dev)

    def epoch():
        for batch in pipe.batches(shuffle=True):
            yield batch_to_device(batch.arrays(), dev)

    return fit(state, step_fn, epoch, tc.total_steps, log_every, log,
               prefix=prefix, after_step=after_step)


def inference_config(cfg: VernierConfig, **kw) -> VernierConfig:
    """The serving config of a model trained under ``cfg``."""
    return cfg.replace(usage="inference", sup_type="real", augment=False,
                       **kw)


def refine_split(model: VernierScale, infer_cfg: VernierConfig,
                 val_root: str, pred_dir: str, out_dir: str, device):
    """Refines the proposal files of ``pred_dir`` on the ``val`` split of
    ``val_root`` into ``out_dir/<pred_type>/data``.  Returns (the split,
    its proposal records, the runner)."""
    vds = KittiDataset(val_root, "val")
    vdb = build_db_from_predictions(vds, infer_cfg, pred_dir)
    vpipe = RefinementPipeline(vdb, infer_cfg, training=False,
                               load_lidar=False)
    runner = RefineRunner(model, infer_cfg, device=device)
    writer = PredictionWriter(infer_cfg)
    runner.run(vpipe, writer=writer, progress=False)
    writer.write(out_dir)
    return vds, vdb, runner


def car_ap(scores: Mapping, metric: str = "detection_3d") -> list:
    """The car AP40 triple (easy, moderate, hard) of an evaluator dict."""
    return scores["car"][metric]["ap40"]


def center_errors(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Ground-plane (x, z) distances between box rows of ``a`` and ``b``."""
    return np.linalg.norm(a[:, (3, 5)] - b[:, (3, 5)], axis=1)


def copy_dir(src: str, dst: str) -> None:
    os.makedirs(dst, exist_ok=True)
    for f in os.listdir(src):
        with open(os.path.join(src, f)) as fi, \
                open(os.path.join(dst, f), "w") as fo:
            fo.write(fi.read())
