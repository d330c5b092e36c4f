"""Seeding (port of snvc_tpu/utils/seeding.py; reference
mis_utils.reset_seed).

The port's random draws come from explicit ``torch.Generator``s, so this
pins the host-side Python and numpy state that the data pipelines read
and hands back a CPU generator seeded the same way (where JAX hands back
a root PRNG key).
"""

from __future__ import annotations

import random

import numpy as np
import torch


def reset_seed(seed: int = 0) -> torch.Generator:
    random.seed(seed)
    np.random.seed(seed)
    return torch.Generator().manual_seed(seed)
