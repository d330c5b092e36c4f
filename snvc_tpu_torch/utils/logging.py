"""Logging and the experiment directory of the training CLIs (port of
snvc_tpu/utils/logging.py: ``get_logger`` and ``Experimenter``)."""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import sys
from typing import Callable, Dict, Optional

from snvc_tpu_torch.config import VernierConfig, load_config
from snvc_tpu_torch.parallel.api import process_index

_FORMAT = "[%(asctime)s] %(levelname)s %(message)s"
_ROOT = "snvc_tpu_torch"


def get_logger(name: str = _ROOT,
               log_file: Optional[str] = None) -> logging.Logger:
    """A logger that writes INFO and above to standard output (one handler
    on the package's logger, however often it is asked for; loggers named
    under it reach it).  With ``log_file`` the logger also writes there,
    in place of any file it wrote before."""
    root = logging.getLogger(_ROOT)
    if not root.handlers:
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(logging.Formatter(_FORMAT, "%H:%M:%S"))
        root.addHandler(handler)
        root.setLevel(logging.INFO)
        root.propagate = False
    logger = logging.getLogger(name)
    if log_file is not None:
        for h in [h for h in logger.handlers
                  if isinstance(h, logging.FileHandler)]:
            logger.removeHandler(h)
            h.close()
        os.makedirs(os.path.dirname(os.path.abspath(log_file)),
                    exist_ok=True)
        fh = logging.FileHandler(log_file)
        fh.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(fh)
        logger.setLevel(logging.INFO)
    return logger


class Experimenter:
    """An experiment directory, laid out as JAX's: ``config.json`` (the
    model's config, so it travels with the weights), ``training.log``,
    ``checkpoints/`` (``training/train.save_checkpoint``) and
    ``metrics.jsonl``.  Without ``config`` the directory's
    ``config.json`` is read as a VernierConfig (a file of either package,
    through ``config.load_config``).  Process 0 alone writes the directory
    and logs: in a data-parallel run (parallel/api.py) the other ranks'
    logger is disabled and their metrics writer writes nothing."""

    def __init__(self, model_dir: str, config=None):
        self.model_dir = os.path.abspath(model_dir)
        self.primary = process_index() == 0
        cfg_path = os.path.join(self.model_dir, "config.json")
        if config is not None:
            if self.primary:
                os.makedirs(self.model_dir, exist_ok=True)
                with open(cfg_path, "w") as fh:
                    json.dump(dataclasses.asdict(config), fh, indent=2)
            self.config = config
        elif os.path.exists(cfg_path):
            self.config = load_config(cfg_path, VernierConfig)
        else:
            raise FileNotFoundError(f"no config.json in {self.model_dir}")
        if self.primary:
            self.logger = get_logger(
                f"{_ROOT}.experiment",
                os.path.join(self.model_dir, "training.log"))
        else:
            self.logger = logging.getLogger(f"{_ROOT}.experiment.silent")
            self.logger.disabled = True

    @property
    def checkpoint_dir(self) -> str:
        return os.path.join(self.model_dir, "checkpoints")

    def metrics_writer(self) -> Callable[[int, Dict[str, float]], None]:
        """A callable(step, dict) that appends ``{"step": step, ...}`` as
        one JSON line to ``metrics.jsonl``."""
        path = os.path.join(self.model_dir, "metrics.jsonl")

        def write(step: int, metrics: Dict[str, float]) -> None:
            if not self.primary:
                return
            with open(path, "a") as fh:
                fh.write(json.dumps({"step": step, **metrics}) + "\n")

        return write
