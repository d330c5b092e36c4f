"""A model directory of the port: ``<step>.pt`` and ``config.json``
(``training/train.save_checkpoint``, or
``scripts/convert_jax_checkpoint.py`` from a JAX checkpoint)."""

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
    tree, step = load_checkpoint(model_dir)
    model = model_cls(cfg, device=device)
    model.load_state_dict(tree["model"], strict=True)
    return cfg, model, step
