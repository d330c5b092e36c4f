"""A model directory of the port, in either of two layouts:

* an experiment directory, as the training CLIs write it (JAX's
  ``Experimenter`` layout, ``utils/logging.Experimenter``):
  ``config.json`` beside ``checkpoints/<step>.pt``;
* a flat one: ``<step>.pt`` and ``config.json`` together
  (``training/train.save_checkpoint`` into the directory itself, or
  ``scripts/convert_jax_checkpoint.py`` from a JAX checkpoint).
"""

from __future__ import annotations

import os
from typing import Tuple, Type, TypeVar

from snvc_tpu_torch.config import load_config
from snvc_tpu_torch.training.train import load_checkpoint

C = TypeVar("C")


def load_model(model_dir: str, cfg_cls: Type[C], model_cls, device
               ) -> Tuple[C, object, int]:
    """(config, model with the latest checkpoint's weights on ``device``,
    step).  The weights load with ``strict=True``."""
    cfg = load_config(os.path.join(model_dir, "config.json"), cfg_cls)
    ckpt_dir = os.path.join(model_dir, "checkpoints")
    tree, step = load_checkpoint(ckpt_dir if os.path.isdir(ckpt_dir)
                                 else model_dir)
    model = model_cls(cfg, device=device)
    model.load_state_dict(tree["model"], strict=True)
    return cfg, model, step
