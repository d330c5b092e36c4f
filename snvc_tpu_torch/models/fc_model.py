"""Fully-connected residual model (port of snvc_tpu/models/fc_model.py).

Maps the 9 BEV part coordinates (18-d) to a 5-d box refinement when used
as the optional bbox head.  In train mode each dropout draws its mask
from the ``generator`` passed to ``forward`` (flax ``nn.Dropout``: keep
with probability 1 - p, kept values scaled by 1 / (1 - p)); in eval mode
dropout is the identity.  JAX draws its masks from the ``dropout`` rng
stream, so the two packages' masks differ.  Under a data-parallel mesh
(``models/layers.data_parallel``) each rank draws the global batch's mask
and keeps its own rows, so the ranks together draw the one-process mask.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from snvc_tpu_torch.models.layers import BatchNorm
from snvc_tpu_torch.parallel.api import global_rows


def dropout(x, p: float, training: bool,
            generator: Optional[torch.Generator], mesh=None):
    """flax ``nn.Dropout(p)``: the identity unless ``training``; then
    each element is kept with probability 1 - p, drawn from
    ``generator`` (on ``x``'s device), and scaled by 1 / (1 - p).  With
    a process-group ``mesh`` the mask is drawn for the global batch and
    this rank's rows of it are kept."""
    if not training or p == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in train mode needs a generator")
    n, start = global_rows(x.shape[0], mesh)
    keep = torch.rand((n,) + x.shape[1:], generator=generator,
                      device=x.device)[start:start + x.shape[0]] < 1.0 - p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


class ResidualBlock(nn.Module):
    def __init__(self, num_neurons: int, p_dropout: float = 0.5):
        super().__init__()
        self.p_dropout = p_dropout
        self.mesh = None  # see models/layers.data_parallel
        self.Dense_0 = nn.Linear(num_neurons, num_neurons)
        self.BatchNorm_0 = BatchNorm(num_neurons)
        self.Dense_1 = nn.Linear(num_neurons, num_neurons)
        self.BatchNorm_1 = BatchNorm(num_neurons)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        y = F.relu(self.BatchNorm_0(_dense(x, self.Dense_0)))
        y = dropout(y, self.p_dropout, self.training, generator, self.mesh)
        y = F.relu(self.BatchNorm_1(_dense(y, self.Dense_1)))
        y = dropout(y, self.p_dropout, self.training, generator, self.mesh)
        return x + y


def _dense(x, lin: nn.Linear):
    return F.linear(x, lin.weight.to(x.dtype), lin.bias.to(x.dtype))


class FCModel(nn.Module):
    def __init__(self, in_features: int, num_neurons: int = 1024,
                 num_blocks: int = 2, output_size: int = 64,
                 p_dropout: float = 0.5):
        super().__init__()
        self.p_dropout = p_dropout
        self.mesh = None  # see models/layers.data_parallel
        self.Dense_0 = nn.Linear(in_features, num_neurons)
        self.BatchNorm_0 = BatchNorm(num_neurons)
        for i in range(num_blocks):
            self.add_module(f"ResidualBlock_{i}",
                            ResidualBlock(num_neurons, p_dropout))
        self.Dense_1 = nn.Linear(num_neurons, output_size)
        self.num_blocks = num_blocks

    def forward(self, x, generator: Optional[torch.Generator] = None):
        """``generator`` draws the dropout masks in train mode (required
        there when ``p_dropout > 0``)."""
        y = F.relu(self.BatchNorm_0(_dense(x, self.Dense_0)))
        y = dropout(y, self.p_dropout, self.training, generator, self.mesh)
        for i in range(self.num_blocks):
            y = getattr(self, f"ResidualBlock_{i}")(y, generator)
        return _dense(y, self.Dense_1)
