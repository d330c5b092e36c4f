"""The step loop of the two training CLIs (the loop of JAX
tools/train_vernier.py and tools/train_stereo.py): resume, log, write
metrics, checkpoint; and the data-parallel set-up they share."""

from __future__ import annotations

import os
import time
from typing import Callable, Iterable, Mapping, Optional, Tuple

import torch

from snvc_tpu_torch.config import TrainConfig
from snvc_tpu_torch.parallel.api import Mesh, initialize_multihost
from snvc_tpu_torch.training.train import (
    TrainState,
    load_checkpoint,
    save_checkpoint,
)
from snvc_tpu_torch.utils.logging import Experimenter


def join_data_group(device: str) -> Tuple[Optional[Mesh], str]:
    """(mesh, device) of this process.  Under a launcher (``torchrun``)
    every rank joins the data-parallel group, as JAX's CLIs put every
    local device on a mesh: NCCL when ``device`` is the card (each rank
    on ``cuda:LOCAL_RANK``), gloo for ``--device cpu``.  Without one:
    (None, ``device``), one process."""
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    mesh = initialize_multihost(backend, device)
    return mesh, device if mesh is None else mesh.devices[mesh.rank]


def train(exp: Experimenter, state: TrainState, cfg, tc: TrainConfig,
          step_fn: Callable, epoch: Callable[[int], Iterable[Mapping]],
          resume: bool, log_every: int) -> dict:
    """Steps ``state`` to ``tc.total_steps`` over ``epoch(step)`` (the
    device batches of one pass over the data, starting at ``step``),
    passes after passes.

    * ``resume``: restores the newest checkpoint of ``exp``'s
      ``checkpoints/`` first (step count, parameters, BatchNorm
      statistics, AdamW state), when that directory exists; every rank of
      a data-parallel run restores it.
    * Every ``log_every`` steps: the step's metrics go to the log and to
      ``metrics.jsonl`` (the only host sync the loop adds).
    * A checkpoint every ``tc.checkpoint_every`` steps and one at the end
      (rank 0 writes them, and alone logs).

    Returns {"start_step", "step", "step_s" (wall seconds of each step,
    batch building included, checkpoints not), "save_s" (seconds of
    each checkpoint), "metrics" (the logged dicts), "state"}."""
    log = exp.logger
    write_metrics = exp.metrics_writer()
    if resume and os.path.isdir(exp.checkpoint_dir):
        load_checkpoint(exp.checkpoint_dir, state)
        log.info("resumed from step %d", state.step)
    start = state.step
    log.info(f"training on {state.model.device} from step {start} to "
             f"{tc.total_steps}")
    step_s, save_s, logged = [], [], []

    def save():
        if state.model.device.type == "cuda":  # time the save alone
            torch.cuda.synchronize(state.model.device)
        t = time.perf_counter()
        save_checkpoint(exp.checkpoint_dir, state, cfg, state.step)
        save_s.append(time.perf_counter() - t)
        log.info(f"checkpoint @ {state.step}")

    while state.step < tc.total_steps:
        t = time.perf_counter()
        stepped = False
        for batch in epoch(state.step):
            metrics = step_fn(state, batch)
            stepped = True
            step = state.step
            if step % log_every == 0:
                vals = {k: float(v) for k, v in metrics.items()}
                write_metrics(step, vals)
                logged.append(vals)
                log.info("step %d: %s", step, ", ".join(
                    f"{k}={v:.4f}" for k, v in vals.items()))
            step_s.append(time.perf_counter() - t)
            if step >= tc.total_steps:
                break
            if step % tc.checkpoint_every == 0:
                save()
            t = time.perf_counter()
        if not stepped:
            raise ValueError("the training data gave no batch")
    save()
    log.info("done")
    return dict(start_step=start, step=state.step, step_s=step_s,
                save_s=save_s, metrics=logged, state=state)
