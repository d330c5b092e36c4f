"""A model directory of the port, in either of two layouts:

* an experiment directory, as the training CLIs write it (JAX's
  ``Experimenter`` layout, ``utils/logging.Experimenter``):
  ``config.json`` beside ``checkpoints/<step>.pt``;
* a flat one: ``<step>.pt`` and ``config.json`` together
  (``training/train.save_checkpoint`` into the directory itself, or
  ``scripts/convert_jax_checkpoint.py`` from a JAX checkpoint).

A ``<step>.pt`` file with ``config.json`` beside it names one checkpoint
of a flat directory.
"""

from __future__ import annotations

import os
from typing import Tuple, Type, TypeVar

import torch

from snvc_tpu_torch.config import load_config
from snvc_tpu_torch.training.train import load_checkpoint

C = TypeVar("C")


def read_model_dir(path: str, cfg_cls: Type[C]) -> Tuple[C, dict, int]:
    """(config, checkpoint tree, step) of the latest checkpoint of the
    model directory ``path``, or of the ``<step>.pt`` file ``path``.  A
    directory with no ``.pt`` (a JAX Orbax checkpoint) raises
    FileNotFoundError naming the converter."""
    if os.path.isfile(path):
        cfg = load_config(os.path.join(os.path.dirname(path) or ".",
                                       "config.json"), cfg_cls)
        tree = torch.load(path, map_location="cpu", weights_only=True)
        return cfg, tree, int(tree["step"])
    cfg = load_config(os.path.join(path, "config.json"), cfg_cls)
    ckpt_dir = os.path.join(path, "checkpoints")
    try:
        tree, step = load_checkpoint(ckpt_dir if os.path.isdir(ckpt_dir)
                                     else path)
    except FileNotFoundError as e:
        raise FileNotFoundError(
            f"{path} holds no <step>.pt of the port; a JAX (Orbax) "
            "checkpoint is converted first: python "
            f"scripts/convert_jax_checkpoint.py {path} <out_dir>") from e
    return cfg, tree, step


def load_model(model_dir: str, cfg_cls: Type[C], model_cls, device
               ) -> Tuple[C, object, int]:
    """(config, model with the latest checkpoint's weights on ``device``,
    step).  The weights load with ``strict=True``."""
    cfg, tree, step = read_model_dir(model_dir, cfg_cls)
    model = model_cls(cfg, device=device)
    model.load_state_dict(tree["model"], strict=True)
    return cfg, model, step
