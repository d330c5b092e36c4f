"""The CLIs' logger: a stand-in for the JAX package's ``Experimenter``
logger (snvc_tpu/utils/logging.py:50), to standard output only."""

from __future__ import annotations

import logging
import sys

_FORMAT = "[%(asctime)s] %(levelname)s %(message)s"


def get_logger(name: str = "snvc_tpu_torch") -> logging.Logger:
    """A logger that writes INFO and above to standard output (one
    handler, however often it is asked for)."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(logging.Formatter(_FORMAT, "%H:%M:%S"))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger
